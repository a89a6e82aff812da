"""K3 (fused BN-apply + LIF) in the PyTorch port against the JAX package's.

``bn_lif_fwd_reference`` and ``bn_lif_bwd_reference`` (the kernels' plain
versions) and autograd through the port's ``bn_lif`` are held against
``ops.bn_lif.bn_lif`` and ``jax.vjp`` of it in Pallas interpret mode, on
the same numpy inputs: T_in = T, T_in = 1 broadcast to ``t_out``, a
ragged N, y in fp32 and bf16. The JAX side takes (T, N, H, W, C), the
port (T, N, C, H, W); the tests transpose between them.

fp32: spikes equal; dy, dscale and dshift within rtol 1e-5, atol 1e-5
(the JAX package's own K3 gradient tolerance, tests/test_bn_lif.py: the
sums run in another order). bf16: spikes equal, since both threshold the
same fp32 numbers made from the same bf16 values; dy comes back in bf16
within rtol 1e-2, atol 1e-3 (a bf16 rounding of sums taken in another
order), dscale and dshift in fp32 at the fp32 tolerance. The kernels
themselves are held against their plain versions on the card in
tests/test_torch_kernels_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spiking_diffusion_tpu.ops import bn_lif as jax_bn_lif
from spiking_diffusion_tpu.snn import NeuronParams as JaxParams
from spiking_diffusion_tpu_torch.ops import bn_lif as port_bn_lif
from spiking_diffusion_tpu_torch.snn.neuron import NeuronParams

CASES = {
    # (T_in, t_out, N)
    "T4": (4, 4, 4),
    "broadcast_T1_to_6": (1, 6, 4),
    "ragged_N5": (4, 4, 5),
}
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
C, H, W = 8, 3, 3


@pytest.fixture(autouse=True)
def setup():
    torch.set_num_threads(1)
    old = jax_bn_lif._INTERPRET
    jax_bn_lif._INTERPRET = True
    yield
    jax_bn_lif._INTERPRET = old


def _inputs(t_in, t_out, n, seed):
    rs = np.random.RandomState(seed)
    y = (rs.normal(size=(t_in, n, H, W, C)) * 2.0).astype(np.float32)
    g = rs.normal(size=(t_out, n, H, W, C)).astype(np.float32)
    scale = np.linspace(0.5, 1.5, C).astype(np.float32)
    shift = np.linspace(-0.3, 0.3, C).astype(np.float32)
    return y, g, scale, shift


def _to_port(a: np.ndarray, dtype) -> torch.Tensor:
    """(T, N, H, W, C) -> (T, N, C, H, W)."""
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 1, 4, 2, 3))).to(dtype)


def _to_jax_layout(t: torch.Tensor) -> np.ndarray:
    return t.float().permute(0, 1, 3, 4, 2).numpy()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_jax(case, dtype):
    t_in, t_out, n = CASES[case]
    jdt, tdt = DTYPES[dtype]
    y, g, scale, shift = _inputs(t_in, t_out, n, seed=len(case))
    yj, gj = jnp.asarray(y).astype(jdt), jnp.asarray(g).astype(jdt)
    s_j, vjp = jax.vjp(lambda a, b, c: jax_bn_lif.bn_lif(a, b, c, JaxParams(), t_out=t_out),
                       yj, jnp.asarray(scale), jnp.asarray(shift))
    dy_j, dsc_j, dsh_j = (np.asarray(a.astype(jnp.float32)) for a in vjp(gj))
    s_j = np.asarray(s_j.astype(jnp.float32))

    # the same (bf16-rounded) values on both sides
    yp = _to_port(np.asarray(yj.astype(jnp.float32)), tdt)
    gp = _to_port(np.asarray(gj.astype(jnp.float32)), tdt)
    sc, sh = torch.from_numpy(scale), torch.from_numpy(shift)
    s = port_bn_lif.bn_lif_fwd_reference(yp, sc, sh, NeuronParams(), t_out)
    dy, dsc, dsh = port_bn_lif.bn_lif_bwd_reference(yp, sc, sh, gp, NeuronParams(), t_out)
    assert s.dtype == dy.dtype == tdt and dsc.dtype == torch.float32
    assert s.shape == (t_out, n, C, H, W) and dy.shape == yp.shape
    assert 0.05 < s_j.mean() < 0.95
    np.testing.assert_array_equal(_to_jax_layout(s), s_j)
    dy_tol = dict(rtol=1e-5, atol=1e-5) if dtype == "fp32" else dict(rtol=1e-2, atol=1e-3)
    np.testing.assert_allclose(_to_jax_layout(dy), dy_j, **dy_tol)
    np.testing.assert_allclose(dsc.numpy(), dsc_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dsh.numpy(), dsh_j, rtol=1e-5, atol=1e-5)

    # the autograd function gives exactly the plain versions' results
    ya = yp.clone().requires_grad_()
    sca, sha = sc.clone().requires_grad_(), sh.clone().requires_grad_()
    before = (port_bn_lif.LAUNCHES_FWD, port_bn_lif.LAUNCHES_BWD)
    out = port_bn_lif.bn_lif(ya, sca, sha, NeuronParams(), t_out=t_out)
    assert torch.equal(out, s)
    out.backward(gp)
    assert torch.equal(ya.grad, dy) and torch.equal(sca.grad, dsc) and torch.equal(sha.grad, dsh)
    assert (port_bn_lif.LAUNCHES_FWD, port_bn_lif.LAUNCHES_BWD) == before


def test_channel_sums_order():
    """The plain channel reduction is the sum, in the kernel's block order."""
    acc = torch.from_numpy(np.random.RandomState(5).normal(size=(9, 3, 49)).astype(np.float32))
    got = port_bn_lif.channel_sums(acc)
    np.testing.assert_allclose(got.numpy(), acc.double().sum((0, 2)).numpy(), rtol=1e-6)


def test_wrappers_reject_bad_inputs():
    y = torch.zeros(4, 2, 3, 5)
    sc, sh = torch.ones(3), torch.zeros(3)
    with pytest.raises(ValueError, match="t_out"):
        port_bn_lif.bn_lif_fwd(y, sc, sh, t_out=6)
    with pytest.raises(TypeError):
        port_bn_lif.bn_lif_fwd(y.double(), sc, sh)
    with pytest.raises(ValueError, match="scale"):
        port_bn_lif.bn_lif_fwd(y, torch.ones(4), sh)
    with pytest.raises(ValueError, match="cotangent"):
        port_bn_lif.bn_lif_bwd(y, sc, sh, torch.zeros(4, 2, 3, 5).bfloat16())
