"""K3's row-then-n sum order and its plain backward at the row map's shapes.

The backward kernel (``csrc/bn_lif.cu``) reduces dscale and dshift in a
fixed order: one partial per (n, c) row, then a channel's N partials in n
order. A row of at most 256 values is padded with zeros to the next power
of two and halved in a tree (a[j] + a[j + half]); a longer row is summed
by 256 threads, thread k over hw = k, k + 256, .. in order, and the 256
thread sums are halved so. ``channel_sums`` must equal, bitwise, a numpy
float32 loop written from that order, at the denoiser's 7x7 and 5x5 rows
and stage 1's 14x14 and 28x28 ones, at the rows' edges (1, 256, 257), and
with a ragged N.

``bn_lif_bwd_reference`` at those shapes is held against the JAX package's
``ops.bn_lif.bn_lif`` and its VJP in Pallas interpret mode, on the same
numpy inputs, at the JAX package's tolerances: spikes equal; fp32 dy
within rtol 1e-5, atol 1e-5; bf16 dy within rtol 1e-2, atol 1e-3 (a bf16
rounding of sums taken in another order). dscale and dshift (fp32 in both
dtypes) are sums of up to 9,408 terms that cancel, which the JAX kernel
adds in another order: they are held at rtol 1e-5, atol 1e-5 widened by
1e-6 of the sum of their terms' absolute values, the repo's rule for sums
in another order (chip_smoke.py K4_SUM_SHARE), and the port's own sum to
within 1e-7 of that magnitude of the fp64 sum of the same terms. (At 28x28
the JAX kernel's dshift lies 1.4e-5 from that fp64 sum, the port's 1.1e-6.)
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

THREADS = 256
SUM_SHAPES = [(hw, c) for hw in (49, 25, 196, 784) for c in (16, 24, 64)]
SUM_SHAPES += [(1, 16), (256, 16), (257, 24)]
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
JAX_SHAPES = [(49, 64), (25, 24), (196, 16), (784, 32)]  # (HW, C)
T, N = 4, 3
SUM_SHARE = 1e-6  # sums in another order: this share of the sum of |terms|
OWN_SUM_SHARE = 1e-7  # the port's sum against the fp64 sum of its terms


@pytest.fixture(autouse=True)
def setup():
    torch.set_num_threads(1)
    old = jax_bn_lif._INTERPRET
    jax_bn_lif._INTERPRET = True
    yield
    jax_bn_lif._INTERPRET = old


def _tree(a: np.ndarray) -> np.ndarray:
    """Halve the last axis, a power of two long, in place: a[j] + a[j + half]."""
    half = a.shape[-1] // 2
    while half > 0:
        for j in range(half):
            a[..., j] = a[..., j] + a[..., j + half]
        half //= 2
    return a[..., 0]


def numpy_channel_sums(acc: np.ndarray) -> np.ndarray:
    """(N, C, HW) float32 -> (C,), one float32 addition at a time in K3's order."""
    n, c, hw = acc.shape
    if hw <= THREADS:
        width = 1
        while width < hw:
            width *= 2
        rows = np.zeros((n, c, width), np.float32)
        rows[..., :hw] = acc
        part = _tree(rows)
    else:
        threads = np.zeros((n, c, THREADS), np.float32)
        for k in range(THREADS):
            for j in range(k, hw, THREADS):
                threads[..., k] = threads[..., k] + acc[..., j]
        part = _tree(threads)
    total = np.zeros(c, np.float32)
    for i in range(n):
        total = total + part[i]
    return total


@pytest.mark.parametrize("n", [5, 2])
@pytest.mark.parametrize("hw,c", SUM_SHAPES, ids=[f"HW{hw}_C{c}" for hw, c in SUM_SHAPES])
def test_channel_sums_row_then_n_order(hw, c, n):
    rs = np.random.RandomState(hw * 100 + c + n)
    acc = (rs.normal(size=(n, c, hw)) * rs.uniform(0.1, 10.0, size=(n, c, 1))).astype(np.float32)
    got = port_bn_lif.channel_sums(torch.from_numpy(acc))
    want = numpy_channel_sums(acc)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def _inputs(t_in, hw, c, seed):
    rs = np.random.RandomState(seed)
    side = int(round(hw ** 0.5))
    y = (rs.normal(size=(t_in, N, side, side, c)) * 2.0).astype(np.float32)
    g = rs.normal(size=(T, N, side, side, c)).astype(np.float32)
    scale = np.linspace(0.5, 1.5, c).astype(np.float32)
    shift = np.linspace(-0.3, 0.3, c).astype(np.float32)
    return y, g, scale, shift


def _to_port(a: np.ndarray, dtype) -> torch.Tensor:
    """(T, N, H, W, C) -> (T, N, C, H, W)."""
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 1, 4, 2, 3))).to(dtype)


def _to_jax_layout(t: torch.Tensor) -> np.ndarray:
    return t.float().permute(0, 1, 3, 4, 2).numpy()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("t_in", [T, 1], ids=["T_in_T", "T_in_1"])
@pytest.mark.parametrize("hw,c", JAX_SHAPES, ids=[f"HW{hw}_C{c}" for hw, c in JAX_SHAPES])
def test_backward_reference_matches_jax(hw, c, t_in, dtype, monkeypatch):
    jdt, tdt = DTYPES[dtype]
    accs = []  # the per-element sums that channel_sums reduces: dscale's, dshift's
    channel_sums = port_bn_lif.channel_sums
    monkeypatch.setattr(port_bn_lif, "channel_sums",
                        lambda acc: accs.append(acc) or channel_sums(acc))
    y, g, scale, shift = _inputs(t_in, hw, c, seed=hw + c + t_in)
    yj, gj = jnp.asarray(y).astype(jdt), jnp.asarray(g).astype(jdt)
    s_j, vjp = jax.vjp(lambda a, b, d: jax_bn_lif.bn_lif(a, b, d, JaxParams(), t_out=T),
                       yj, jnp.asarray(scale), jnp.asarray(shift))
    dy_j, dsc_j, dsh_j = (np.asarray(a.astype(jnp.float32)) for a in vjp(gj))

    yp = _to_port(np.asarray(yj.astype(jnp.float32)), tdt)
    gp = _to_port(np.asarray(gj.astype(jnp.float32)), tdt)
    sc, sh = torch.from_numpy(scale), torch.from_numpy(shift)
    s = port_bn_lif.bn_lif_fwd_reference(yp, sc, sh, NeuronParams(), T)
    dy, dsc, dsh = port_bn_lif.bn_lif_bwd_reference(yp, sc, sh, gp, NeuronParams(), T)
    assert 0.05 < float(s.float().mean()) < 0.95
    np.testing.assert_array_equal(_to_jax_layout(s), np.asarray(s_j.astype(jnp.float32)))
    dy_tol = dict(rtol=1e-5, atol=1e-5) if dtype == "fp32" else dict(rtol=1e-2, atol=1e-3)
    assert dy.dtype == tdt and dy.shape == yp.shape
    np.testing.assert_allclose(_to_jax_layout(dy), dy_j, **dy_tol)
    assert len(accs) == 2
    for got, want, acc in ((dsc, dsc_j, accs[0]), (dsh, dsh_j, accs[1])):
        abs_sum = acc.double().abs().sum((0, 2)).numpy()
        exact = acc.double().sum((0, 2)).numpy()
        assert np.all(np.abs(got.numpy() - exact) <= OWN_SUM_SHARE * abs_sum)
        np.testing.assert_array_less(np.abs(got.numpy() - want),
                                     1e-5 + 1e-5 * np.abs(want) + SUM_SHARE * abs_sum)
