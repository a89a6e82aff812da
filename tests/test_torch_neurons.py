"""The port's neurons and encoders against the JAX package's
``snn/neuron.py`` and ``snn/encoding.py``.

On the same numpy inputs, (T, N, F) = (8, 3, 16) drives that fire
10-70 % of the time, from a given and the default initial membrane:

* IF, PLIF (with the gradient of its learnable ``w``), QIF, EIF and
  Izhikevich (with its recovery current): spikes exactly, final
  membranes and the gradients of a loss on spikes and membranes within
  1e-5.
* ``lif_multi_step``'s route on the CPU for every surrogate family: atan
  and sigmoid through K1's plain versions, any other through
  ``lif_scan`` (``neuron.ROUTES``), the spikes exactly JAX's
  ``lif_multi_step`` ones and the gradients within 1e-5; an unknown
  backend raises.
* ``periodic_encode``, ``weighted_phase_encode`` and ``latency_encode``
  exactly JAX's; ``poisson_encode`` from a seeded ``torch.Generator`` by
  its statistics: each element's rate over 512 steps within 4 sigma of
  its intensity, the same seed giving the same train.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spiking_diffusion_tpu.snn import encoding as jax_encoding
from spiking_diffusion_tpu.snn import neuron as jax_neuron
from spiking_diffusion_tpu.snn import surrogate as jax_surrogate
from spiking_diffusion_tpu_torch.snn import encoding, neuron, surrogate

ATOL = 1e-5
SHAPE = (8, 3, 16)
PARAMS = {
    "default": {},
    "soft_no_decay_input": {"hard_reset": False, "decay_input": False},
    "detach_tau3_vreset01": {"detach_reset": True, "tau": 3.0, "v_reset": 0.1},
}
# scan name -> (extra keyword arguments, whether it returns a recovery current)
SCANS = {
    "if_scan": ({}, False),
    "qif_scan": ({"a0": 0.7, "v_c": 0.6}, False),
    "eif_scan": ({"delta_t": 0.8, "theta_rh": 0.7}, False),
    "izhikevich_scan": ({"a": 0.05, "b": 0.3, "tau_w": 3.0}, True),
}


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _params(name, family="atan"):
    kw = PARAMS[name]
    return (jax_neuron.NeuronParams(**kw, surrogate=jax_surrogate.get_surrogate(family, 2.0)),
            neuron.NeuronParams(**kw, surrogate=surrogate.get_surrogate(family, 2.0)))


def _inputs(seed):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-0.5, 2.0, SHAPE).astype(np.float32)
    v0 = rng.uniform(0.0, 0.8, SHAPE[1:]).astype(np.float32)
    gs = rng.randn(*SHAPE).astype(np.float32)
    gv = rng.randn(*SHAPE[1:]).astype(np.float32)
    return x, v0, gs, gv


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


def _run_pair(jax_fn, port_fn, x, v0, gs, gv, extra=()):
    """Forward and a VJP of (spikes, v_T[, extra outputs]) through both;
    ``extra`` are further differentiable inputs (PLIF's w)."""
    jax_args = [jnp.asarray(x), jnp.asarray(v0), *[jnp.asarray(e) for e in extra]]
    outs, vjp = jax.vjp(jax_fn, *jax_args)
    cot = (jnp.asarray(gs), jnp.asarray(gv)) + tuple(jnp.ones_like(o) for o in outs[2:])
    jax_grads = vjp(cot)
    port_args = [torch.from_numpy(a).requires_grad_() for a in (x, v0, *extra)]
    pouts = port_fn(*port_args)
    loss = (pouts[0] * torch.from_numpy(gs)).sum() + (pouts[1] * torch.from_numpy(gv)).sum()
    for o in pouts[2:]:
        loss = loss + o.sum()
    loss.backward()
    np.testing.assert_array_equal(pouts[0].detach().numpy(), np.asarray(outs[0]))
    assert 0.1 < float(np.asarray(outs[0]).mean()) < 0.7
    for got, want in zip(pouts[1:], outs[1:]):
        _close(got.detach(), want)
    for a, want in zip(port_args, jax_grads):
        _close(a.grad, want)
    return port_args


@pytest.mark.parametrize("pname", sorted(PARAMS))
@pytest.mark.parametrize("scan", sorted(SCANS))
def test_scans_match_jax(scan, pname):
    kw, _ = SCANS[scan]
    jp, tp = _params(pname)
    x, v0, gs, gv = _inputs(1)
    jax_fn = getattr(jax_neuron, scan)
    port_fn = getattr(neuron, scan)
    _run_pair(lambda a, v: jax_fn(a, v, params=jp, **kw),
              lambda a, v: port_fn(a, v, params=tp, **kw), x, v0, gs, gv)
    # the default initial membrane (v_reset; Izhikevich's w at w_rest)
    got = port_fn(torch.from_numpy(x), params=tp, **kw)
    want = jax_fn(jnp.asarray(x), params=jp, **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        _close(g, w)


@pytest.mark.parametrize("pname", sorted(PARAMS))
def test_plif_matches_jax_with_the_gradient_of_w(pname):
    jp, tp = _params(pname)
    x, v0, gs, gv = _inputs(2)
    w = np.asarray(0.3, np.float32)
    args = _run_pair(lambda a, v, ww: jax_neuron.plif_scan(a, ww, v, params=jp),
                     lambda a, v, ww: neuron.plif_scan(a, ww, v, params=tp),
                     x, v0, gs, gv, extra=(w,))
    assert abs(float(args[2].grad)) > 1e-3


def test_if_step_matches_jax():
    jp, tp = _params("default")
    x, v0, _, _ = _inputs(3)
    v_j, s_j = jax_neuron.if_step(jnp.asarray(v0), jnp.asarray(x[0]), jp)
    v_t, s_t = neuron.if_step(torch.from_numpy(v0), torch.from_numpy(x[0]), tp)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    _close(v_t, v_j)


@pytest.mark.parametrize("family", sorted(surrogate.FAMILIES))
def test_lif_multi_step_routes_by_family(family):
    jp, tp = _params("default", family)
    x, _, gs, _ = _inputs(4)
    kernel = family in ("atan", "sigmoid")
    for backend in ("auto", "torch"):
        before = dict(neuron.ROUTES)
        xt = torch.from_numpy(x).requires_grad_()
        s = neuron.lif_multi_step(xt, params=tp, backend=backend)
        s.backward(torch.from_numpy(gs))
        moved = {k: neuron.ROUTES[k] - before[k] for k in before}
        assert moved == ({"kernel": 1, "scan": 0} if kernel else {"kernel": 0, "scan": 1})
        want, vjp = jax.vjp(lambda a: jax_neuron.lif_multi_step(a, params=jp, backend="scan"),
                            jnp.asarray(x))
        np.testing.assert_array_equal(s.detach().numpy(), np.asarray(want))
        _close(xt.grad, vjp(jnp.asarray(gs))[0])
    assert neuron.kernel_route(tp) == kernel
    with pytest.raises(ValueError, match="unknown LIF backend"):
        neuron.lif_multi_step(torch.from_numpy(x), params=tp, backend="scan")
    with pytest.raises(ValueError, match="CUDA"):
        neuron.lif_multi_step(torch.from_numpy(x), params=tp, backend="cuda")


def test_deterministic_encoders_match_jax():
    rng = np.random.RandomState(5)
    x = rng.rand(3, 5, 4).astype(np.float32)
    x[0, 0, :2] = (0.0, 1.0)
    pattern = (rng.rand(3, 2, 4) < 0.4).astype(np.float32)
    for steps in (2, 7, 9):
        np.testing.assert_array_equal(
            encoding.periodic_encode(torch.from_numpy(pattern), steps).numpy(),
            np.asarray(jax_encoding.periodic_encode(jnp.asarray(pattern), steps)))
        np.testing.assert_array_equal(
            encoding.latency_encode(torch.from_numpy(x), steps).numpy(),
            np.asarray(jax_encoding.latency_encode(jnp.asarray(x), steps)))
    xq = x * (1.0 - 2.0 ** -6)
    np.testing.assert_array_equal(
        encoding.weighted_phase_encode(torch.from_numpy(xq), 6).numpy(),
        np.asarray(jax_encoding.weighted_phase_encode(jnp.asarray(xq), 6)))
    np.testing.assert_array_equal(
        encoding.direct_encode(torch.from_numpy(x), 4).numpy(),
        np.asarray(jax_encoding.direct_encode(jnp.asarray(x), 4)))


def test_poisson_encode_statistics():
    steps = 512
    x = torch.from_numpy(np.random.RandomState(6).uniform(0.05, 0.95, (4, 16)).astype(np.float32))
    s = encoding.poisson_encode(torch.Generator().manual_seed(0), x, steps)
    assert s.shape == (steps, 4, 16) and s.dtype == torch.float32
    assert set(np.unique(s.numpy())) <= {0.0, 1.0}
    sigma = torch.sqrt(x * (1 - x) / steps)
    assert bool(((s.mean(0) - x).abs() <= 4 * sigma).all())
    again = encoding.poisson_encode(torch.Generator().manual_seed(0), x, steps)
    assert torch.equal(s, again)
    edge = encoding.poisson_encode(None, torch.tensor([0.0, 1.0]), 64)
    assert edge[:, 0].sum() == 0 and edge[:, 1].sum() == 64
