"""K1 backward in the PyTorch port against the JAX package's LIF gradients.

``lif_bwd_reference`` (the backward kernel's plain version), autograd
through the port's ``lif_scan`` and through ``lif_multi_step`` (K1's
autograd function, which on the CPU takes the plain versions) are held
against ``jax.vjp`` of ``snn.neuron.lif_scan`` and of
``ops.pallas_lif.lif_fused`` in Pallas interpret mode, on the same numpy
inputs and spike cotangent. Spikes must be equal; dX and dV0 agree within
rtol 1e-5, atol 1e-6, the JAX package's own tolerance for the fused LIF
gradient (tests/test_pallas_lif.py). The backward kernel itself is held
against its plain version on the card in tests/test_torch_kernels_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spiking_diffusion_tpu.ops import pallas_lif
from spiking_diffusion_tpu.snn import NeuronParams as JaxParams
from spiking_diffusion_tpu.snn import lif_scan as jax_lif_scan
from spiking_diffusion_tpu.snn import surrogate as jax_surrogate
from spiking_diffusion_tpu_torch.ops import lif as port_lif
from spiking_diffusion_tpu_torch.snn import surrogate
from spiking_diffusion_tpu_torch.snn.neuron import NeuronParams, lif_multi_step, lif_scan

RTOL, ATOL = 1e-5, 1e-6

PARAMS = {
    "default": {},
    "soft_reset": {"hard_reset": False},
    "no_decay_input": {"decay_input": False},
    "soft_no_decay_input": {"hard_reset": False, "decay_input": False},
    "tau4_vth07_vreset01": {"tau": 4.0, "v_threshold": 0.7, "v_reset": 0.1},
    "detach_reset": {"detach_reset": True},
    "soft_detach_reset": {"hard_reset": False, "detach_reset": True},
    "sigmoid": {"surrogate": "sigmoid"},
}


@pytest.fixture(autouse=True)
def setup():
    torch.set_num_threads(1)
    old = pallas_lif._INTERPRET
    pallas_lif._INTERPRET = True
    yield
    pallas_lif._INTERPRET = old


def _params(name):
    kw = dict(PARAMS[name])
    family = kw.pop("surrogate", "atan")
    alpha = 2.0 if family == "atan" else 4.0
    return (JaxParams(**kw, surrogate=jax_surrogate.get_surrogate(family, alpha)),
            NeuronParams(**kw, surrogate=surrogate.get_surrogate(family, alpha)))


def _inputs(shape, seed):
    rs = np.random.RandomState(seed)
    x = rs.uniform(-1.0, 3.0, shape).astype(np.float32)
    v0 = rs.uniform(0.0, 0.9, shape[1:]).astype(np.float32)
    g = rs.normal(size=shape).astype(np.float32)
    return x, v0, g


def _jax_vjp(fn, x, v0, g):
    s, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(v0))
    dx, dv = vjp(jnp.asarray(g))
    return np.asarray(s), np.asarray(dx), np.asarray(dv)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", sorted(PARAMS))
@pytest.mark.parametrize("shape", [(5, 3, 41), (16, 2, 7, 7, 4)], ids=["ragged123", "T16"])
def test_backward_matches_jax(name, shape):
    jp, pp = _params(name)
    x, v0, g = _inputs(shape, seed=1)
    s_scan, dx_scan, dv_scan = _jax_vjp(lambda a, b: jax_lif_scan(a, b, jp)[0], x, v0, g)
    s_pal, dx_pal, dv_pal = _jax_vjp(lambda a, b: pallas_lif.lif_fused(a, b, jp), x, v0, g)
    dx, dv = port_lif.lif_bwd_reference(torch.from_numpy(x), torch.from_numpy(v0),
                                        torch.from_numpy(g), pp)
    assert dx.shape == x.shape and dv.shape == v0.shape and dx.dtype == torch.float32
    assert np.abs(dx_scan).max() > 0.1
    _close(dx, dx_scan)
    _close(dv, dv_scan)
    _close(dx, dx_pal)
    _close(dv, dv_pal)
    # autograd through the port's differentiable loop and through K1's
    # autograd function (plain versions on the CPU)
    for fn in (lambda a, b: lif_scan(a, b, pp)[0],
               lambda a, b: lif_multi_step(a, b, pp, backend="auto")):
        xt = torch.from_numpy(x).requires_grad_()
        vt = torch.from_numpy(v0).requires_grad_()
        s = fn(xt, vt)
        np.testing.assert_array_equal(s.detach().numpy(), s_scan)
        np.testing.assert_array_equal(s.detach().numpy(), s_pal)
        s.backward(torch.from_numpy(g))
        _close(xt.grad, dx_scan)
        _close(vt.grad, dv_scan)


def test_autograd_function_is_the_plain_backward():
    """On the CPU, K1's autograd function returns exactly the plain
    backward's dX and dV0, and launches nothing."""
    _, pp = _params("default")
    x, v0, g = _inputs((6, 2, 33), seed=2)
    before = (port_lif.LAUNCHES, port_lif.LAUNCHES_BWD)
    xt = torch.from_numpy(x).requires_grad_()
    vt = torch.from_numpy(v0).requires_grad_()
    lif_multi_step(xt, vt, pp).backward(torch.from_numpy(g))
    dx, dv = port_lif.lif_bwd(torch.from_numpy(x), torch.from_numpy(v0),
                              torch.from_numpy(g), pp)
    assert torch.equal(xt.grad, dx) and torch.equal(vt.grad, dv)
    assert (port_lif.LAUNCHES, port_lif.LAUNCHES_BWD) == before


def test_v_init_without_grad_gets_none_and_bf16_grad_comes_back_bf16():
    _, pp = _params("default")
    x, v0, g = _inputs((4, 50), seed=3)
    xt = torch.from_numpy(x).requires_grad_()
    vt = torch.from_numpy(v0)
    lif_multi_step(xt, vt, pp).backward(torch.from_numpy(g))
    assert vt.grad is None and xt.grad is not None
    xb = torch.from_numpy(x).bfloat16().requires_grad_()
    s = lif_multi_step(xb, params=pp)
    assert s.dtype == torch.bfloat16
    s.backward(torch.from_numpy(g).bfloat16())
    assert xb.grad.dtype == torch.bfloat16
    dx, _ = port_lif.lif_bwd_reference(xb.detach().float(), None,
                                       torch.from_numpy(g).bfloat16().float(), pp)
    assert torch.equal(xb.grad, dx.bfloat16())


def test_backward_without_v_init_or_dv0():
    """No v_init is an initial membrane of v_reset; ``need_dv0=False``
    drops dV0 and leaves dX as it was."""
    _, pp = _params("tau4_vth07_vreset01")
    x, _, g = _inputs((5, 3, 17), seed=5)
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    dx_full, dv_full = port_lif.lif_bwd(xt, torch.full((3, 17), pp.v_reset), gt, pp)
    dx_none, dv_none = port_lif.lif_bwd(xt, None, gt, pp)
    dx_skip, dv_skip = port_lif.lif_bwd(xt, None, gt, pp, need_dv0=False)
    assert torch.equal(dx_none, dx_full) and torch.equal(dv_none, dv_full)
    assert torch.equal(dx_skip, dx_full) and dv_skip is None
    xr = xt.clone().requires_grad_()
    lif_multi_step(xr, None, pp).backward(gt)
    assert torch.equal(xr.grad, dx_full)


def test_surrogate_grads_match_jax_formulas():
    x = np.random.RandomState(4).uniform(-3.0, 3.0, 4096).astype(np.float32)
    for family, alpha in (("atan", 2.0), ("sigmoid", 4.0), ("atan", 0.5)):
        want = np.asarray(jax_surrogate.get_surrogate(family, alpha).grad(jnp.asarray(x)))
        got = surrogate.get_surrogate(family, alpha).grad(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    xt = torch.from_numpy(x).requires_grad_()
    s = surrogate.atan(xt)
    assert torch.equal(s, (xt >= 0).float())
    s.backward(torch.ones_like(xt))
    assert torch.equal(xt.grad, surrogate.atan.grad(torch.from_numpy(x)))


def test_backward_wrapper_rejects_bad_inputs():
    _, pp = _params("default")
    with pytest.raises(TypeError):
        port_lif.lif_bwd(torch.zeros(2, 3, dtype=torch.float64), None, torch.zeros(2, 3), pp)
    with pytest.raises(ValueError, match="shape"):
        port_lif.lif_bwd(torch.zeros(2, 3), None, torch.zeros(2, 4), pp)
    with pytest.raises(ValueError, match="surrogate"):
        port_lif.neuron_args(NeuronParams(surrogate=surrogate.SurrogateFn("erf", 2.0)))
