"""The operand contract of K4's fp32 backward on the tensor cores, on the CPU.

The fp32 backward in ``csrc/spike_conv.cu`` writes g = gy + (gs1 + 2 *
gs2 * y) as three bf16 planes whose fp32 sum is g (``bf16_planes``),
channels-last (``grad_planes_cl``). dW contracts the im2col rows of x's
bf16 copy once per g plane, smallest first (G2, G1, G0); it takes the
tensor cores when x is exact in bf16 and every g is finite. dx contracts
the im2col rows of the g planes against the flipped weight's planes
(``dx_weight_planes``) over the six products Gi . Wj with i + j <= 2, in
the order of ``DX_TERMS`` (the weight side stacked by
``dx_weight_terms``); it takes the tensor cores when every g is finite
(``bf16_planes_finite``). Here those helpers are checked for exactness
and layout, the six-term product for its error bound, and both products,
emulated with fp32 matmuls in the kernels' index order, against the port's
plain version (``spike_conv3x3_bwd_reference``) and against the JAX
package's ``spike_conv3x3`` VJP (Pallas in interpret mode) on the same
numpy inputs.

Tolerances: the splits are exact, so equal, bitwise. The six-term product
is within 4 * 2^-24 * sum |g| |W| of an fp64 reference, plus the error that
fp32 accumulation alone gives (the plain fp32 product's, measured); without
the term (0, 2) it is not. dx, dW and db within 1e-4, the JAX package's
tolerance for its kernel against XLA's conv (tests/test_spike_conv.py),
since the sums run in other orders, widened, as on the card
(chip_smoke.py K4_SUM_SHARE), by 1e-6 of the sum of each element's terms'
absolute values: with block 0's token ids (up to 128) dW's terms reach 100
and cancel, and two fp32 sums of them in other orders differ by more than
1e-4 where they do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from spiking_diffusion_tpu.ops import spike_conv as jax_spike_conv
from spiking_diffusion_tpu_torch.ops import spike_conv as sc

GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
SUM_SHARE = 1e-6  # of the sum of |terms|: sums in other orders (chip_smoke.py K4_SUM_SHARE)
SMALLEST_NORMAL = 2.0**-126
EXACT_FROM = 2.0**-110  # below, a plane would need bits under bf16's least subnormal
ULP = 2.0**-24  # fp32's unit roundoff
DX_BOUND_ULPS = 4  # the six terms' bound, in units of ULP * sum |g| |W|


@pytest.fixture(autouse=True)
def setup():
    torch.set_num_threads(1)
    old = jax_spike_conv._INTERPRET
    jax_spike_conv._INTERPRET = True
    yield
    jax_spike_conv._INTERPRET = old


def _values(kind: str, size: int = 8 * 7 * 7 * 12) -> np.ndarray:
    """fp32 values over the weight-plane tests' magnitude ranges."""
    rs = np.random.RandomState(21)
    if kind.startswith("normal_"):
        return (rs.normal(size=size) * float(kind.split("_")[1])).astype(np.float32)
    if kind == "zeros":
        return np.zeros(size, np.float32)
    if kind == "near_smallest_normal":  # multiples of 2^-133 around 2^-126, both signs
        v = SMALLEST_NORMAL + (np.arange(size) - size // 2) * 2.0**-133
        return (v * rs.choice([-1, 1], size)).astype(np.float32)
    # "from_2e-110": magnitudes from where the split is exact, up
    return (EXACT_FROM * np.exp2(rs.uniform(0.0, 30.0, size=size))
            * rs.choice([-1, 1], size)).astype(np.float32)


@pytest.mark.parametrize("kind", ["normal_1e-3", "normal_0.1", "normal_1", "normal_10",
                                  "zeros", "near_smallest_normal", "from_2e-110"])
def test_grad_planes_sum_to_g(kind):
    """g's planes as the g pass writes them (channels-last, 12 channels
    padded to 16) add up to g bitwise in either order; G0 is bf16(g), each
    plane is at most 2^-8 of the one before, the padding is zero."""
    g = torch.from_numpy(_values(kind).reshape(8, 12, 7, 7))
    planes = sc.grad_planes_cl(g, 16)
    assert planes.dtype == torch.bfloat16 and planes.shape == (3, 8 * 49, 16)
    g0, g1, g2 = planes.float()
    want = sc.channels_last(g, 16)
    assert torch.equal(g0, sc.channels_last(g.to(torch.bfloat16), 16).float())
    assert torch.equal((g2 + g1) + g0, want)
    assert torch.equal((g0 + g1) + g2, want)
    assert bool((g1.abs() <= g0.abs() * 2.0**-8).all())
    assert bool((g2.abs() <= g1.abs() * 2.0**-8).all())
    assert float(planes[:, :, 12:].float().abs().sum()) == 0.0
    assert sc.bf16_planes_finite(g)


@pytest.mark.parametrize("kind,want", [
    ("normal", True), ("bf16_max", True), ("nan", False), ("inf", False),
    ("minus_inf", False), ("rounds_to_inf", False)])
def test_bf16_planes_finite(kind, want):
    """The plain version of the g pass's flag: every first plane finite.
    NaN and +-inf are not, nor an fp32 value that bf16 rounds to inf (its
    planes would be inf and -inf); bf16's largest finite value is."""
    bf16_max = float(torch.finfo(torch.bfloat16).max)
    v = {"normal": [0.5, -3.0, 1e30], "bf16_max": [bf16_max, -bf16_max], "nan": [1.0, np.nan],
         "inf": [0.0, np.inf], "minus_inf": [-np.inf, 2.0],
         "rounds_to_inf": [float(np.finfo(np.float32).max)]}[kind]
    g = torch.tensor(v, dtype=torch.float32)
    assert sc.bf16_planes_finite(g) is want
    if want:
        g0, g1, g2 = (p.float() for p in sc.bf16_planes(g))
        assert torch.equal((g2 + g1) + g0, g)


def test_dx_terms_are_the_six_largest_smallest_first():
    """DX_TERMS holds each (g plane, weight plane) with i + j <= 2 once,
    smallest first (i + j falling), and plane_code packs a column of it
    two bits a term, as the kernels unpack it."""
    assert sorted(sc.DX_TERMS) == sorted((i, j) for i in range(3) for j in range(3)
                                         if i + j <= 2)
    sizes = [i + j for i, j in sc.DX_TERMS]
    assert sizes == sorted(sizes, reverse=True)
    for col in (0, 1):
        code = sc.plane_code(t[col] for t in sc.DX_TERMS)
        assert [(code >> (2 * t)) & 3 for t in range(6)] == [t[col] for t in sc.DX_TERMS]


@pytest.mark.parametrize("cin,cout", [(2, 12), (6, 10), (130, 140)])
def test_dx_weight_planes_layout(cin, cout):
    """Three (9 * Cp_out, Cp_in) blocks W0, W1, W2, each laid out as
    ``dx_weight_cl`` (padding zero), adding up in fp32 to the fp32 dx
    matrix; ``dx_weight_terms`` stacks them in DX_TERMS' order."""
    rs = np.random.RandomState(22)
    w = torch.from_numpy((rs.normal(size=(cout, cin, 3, 3)) * 0.2).astype(np.float32))
    cpi, cpo = sc.padded_channels(cin), sc.padded_channels(cout)
    planes = sc.dx_weight_planes(w)
    assert planes.dtype == torch.bfloat16 and planes.shape == (3 * 9 * cpo, cpi)
    blocks = planes.split(9 * cpo)
    for block, plane in zip(blocks, sc.bf16_planes(w)):
        assert torch.equal(block, sc.dx_weight_cl(plane, torch.bfloat16))
        assert float(block.reshape(9, cpo, cpi)[:, cout:].float().abs().sum()
                     + block[:, cin:].float().abs().sum()) == 0.0
    w0, w1, w2 = (b.float() for b in blocks)
    assert torch.equal((w2 + w1) + w0, sc.dx_weight_cl(w, torch.float32))
    terms = sc.dx_weight_terms(w)
    assert terms.shape == (6 * 9 * cpo, cpi)
    for block, (_, j) in zip(terms.split(9 * cpo), sc.DX_TERMS):
        assert torch.equal(block, blocks[j])


def _dx_products(g, w, terms):
    """(sum of Gi . Wj over ``terms`` with fp32 matmuls, in that order; the
    same sum in fp64)."""
    gp, wp = sc.bf16_planes(g), sc.bf16_planes(w)
    out32 = torch.zeros((g.shape[0], w.shape[1]))
    out64 = torch.zeros((g.shape[0], w.shape[1]), dtype=torch.float64)
    for i, j in terms:
        out32 = out32 + gp[i].float() @ wp[j].float()
        out64 = out64 + gp[i].double() @ wp[j].double()
    return out32, out64


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_six_term_dx_error_bound(seed):
    """The six plane products, in DX_TERMS order with fp32 matmuls, are
    within 4 * 2^-24 * sum |g| |W| of the fp64 product, plus the error of
    fp32 accumulation alone (the plain fp32 product's, as a share of sum
    |g| |W|); their truncation alone, in fp64, is within the first term.
    Dropping (0, 2), the largest of the three size-2^-16 terms' weight
    side, breaks the bound: so six are kept. A dx-shaped product: 200 rows
    of g against 9 taps x 16 channels of weight."""
    rs = np.random.RandomState(30 + seed)
    g = torch.from_numpy(rs.normal(size=(200, 9 * 16)).astype(np.float32))
    w = torch.from_numpy((rs.normal(size=(9 * 16, 24)) * 0.2).astype(np.float32))
    ref = g.double() @ w.double()
    abs_sum = g.double().abs() @ w.double().abs()
    acc_ulps = float(((g @ w).double() - ref).abs().div(abs_sum).max()) / ULP
    bound = (DX_BOUND_ULPS + acc_ulps) * ULP * abs_sum

    six32, six64 = _dx_products(g, w, sc.DX_TERMS)
    assert bool(((six64 - ref).abs() <= DX_BOUND_ULPS * ULP * abs_sum).all())
    assert bool(((six32.double() - ref).abs() <= bound).all())
    five32, _ = _dx_products(g, w, [t for t in sc.DX_TERMS if t != (0, 2)])
    assert not bool(((five32.double() - ref).abs() <= bound).all())


# (T, N, H = W, Cin, Cout, x): spikes at several widths, including channels
# that are not a multiple of 8 and a 4 x 4 grid, and block 0's token ids
# and timesteps over its two channels
CASES = {
    "tokens_2to12": (2, 3, 7, 2, 12, "tokens"),
    "spikes_6to10": (1, 13, 7, 6, 10, "spikes"),
    "spikes_130to140": (1, 2, 7, 130, 140, "spikes"),
    "spikes_hw4_3to5": (2, 3, 4, 3, 5, "spikes"),
}


def _data(case, seed):
    """numpy (x (T, N, H, W, Cin), kernel (3, 3, Cin, Cout), bias, gy, gs1,
    gs2) and the port's (x, OIHW weight, bias, gy, gs1, gs2)."""
    t, n, hw, cin, cout, kind = CASES[case]
    rs = np.random.RandomState(seed)
    if kind == "tokens":
        tok = rs.randint(0, 129, size=(t, n, hw, hw, 1))
        steps = np.broadcast_to(rs.randint(1, 50, size=(t, n, 1, 1, 1)), (t, n, hw, hw, 1))
        x = np.concatenate([tok, steps], -1).astype(np.float32)
    else:
        x = (rs.uniform(size=(t, n, hw, hw, cin)) < 0.3).astype(np.float32)
    kernel = (rs.normal(size=(3, 3, cin, cout)) * 0.2).astype(np.float32)
    bias = (rs.normal(size=(cout,)) * 0.1).astype(np.float32)
    gy = rs.normal(size=(t, n, hw, hw, cout)).astype(np.float32)
    gs1 = rs.normal(size=(cout,)).astype(np.float32)
    gs2 = (rs.normal(size=(cout,)) * 0.1).astype(np.float32)
    nchw = lambda a: torch.from_numpy(np.ascontiguousarray(  # noqa: E731
        a.reshape(t * n, hw, hw, a.shape[-1]).transpose(0, 3, 1, 2)))
    port = (nchw(x), torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()),
            torch.from_numpy(bias), nchw(gy), torch.from_numpy(gs1), torch.from_numpy(gs2))
    return (x, kernel, bias, gy, gs1, gs2), port


def _im2col(a_cl: torch.Tensor, n: int, h: int, w: int) -> torch.Tensor:
    """(N * H * W, Cp) channels-last -> (N * H * W, 9 * Cp), column tap * Cp
    + c, zero off the edge."""
    cp = a_cl.shape[1]
    pad = F.pad(a_cl.reshape(n, h, w, cp), (0, 0, 1, 1, 1, 1))
    taps = [pad[:, kh:kh + h, kw:kw + w] for kh in range(3) for kw in range(3)]
    return torch.cat(taps, dim=3).reshape(n * h * w, 9 * cp)


def planes_bwd(x, weight, y, gy, gs1, gs2, with_moments):
    """The fp32 tensor-core backward's products in fp32, in the kernels'
    index order: (dx, dW, db). dW: the g planes G2, G1, G0 stacked along
    the contraction against x's im2col rows once per plane; dx: for each
    term of DX_TERMS the im2col of its g plane against its weight plane,
    stacked along the contraction (K' = 6 * 9 * Cp_out)."""
    n, cin, h, w = x.shape
    cout = weight.shape[0]
    cpi, cpo = sc.padded_channels(cin), sc.padded_channels(cout)
    assert sc.bf16_exact(x)
    g = sc.grad_out(y, gy, gs1, gs2, with_moments)
    assert sc.bf16_planes_finite(g)
    planes = sc.grad_planes_cl(g, cpo).float()
    a = _im2col(sc.channels_last(x.to(torch.bfloat16), cpi).float(), n, h, w)
    dwm = torch.cat([planes[2], planes[1], planes[0]]).t() @ a.repeat(3, 1)
    a_dx = torch.cat([_im2col(planes[i], n, h, w) for i, _ in sc.DX_TERMS], 1)
    dx = (a_dx @ sc.dx_weight_terms(weight).float())[:, :cin]
    dx = dx.reshape(n, h, w, cin).permute(0, 3, 1, 2).contiguous()
    return dx, sc.dw_from_cl(dwm[:cout], cin), g.sum((0, 2, 3))


def _abs_sums(x, w, y, gy, gs1, gs2, with_moments):
    """(dx, dW, db) of the same contractions over absolute values: each
    element's sum of |terms|."""
    g = sc.grad_out(y, gy, gs1, gs2, with_moments).abs()
    zeros = torch.zeros_like(gs1)
    return sc.spike_conv3x3_bwd_reference(x.abs(), w.abs(), y, g, zeros, zeros, False)


def _assert_near(got, want, abs_sum):
    allowed = GRAD_TOL["atol"] + GRAD_TOL["rtol"] * want.abs() + SUM_SHARE * abs_sum
    excess = float(((got - want).abs() - allowed).max())
    assert excess <= 0.0, f"|d| exceeds its tolerance by {excess:.3g}"


@pytest.mark.parametrize("with_moments", [True, False], ids=["moments", "no_moments"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_planes_backward_matches_plain_version(case, with_moments):
    _, (x, w, b, gy, gs1, gs2) = _data(case, seed=23)
    y = sc.spike_conv3x3_fwd_reference(x, w, b)[0]
    args = (x, w, y, gy, gs1, gs2, with_moments)
    got = planes_bwd(*args)
    want = sc.spike_conv3x3_bwd_reference(*args)
    assert got[0].dtype == got[1].dtype == torch.float32 and got[1].shape == want[1].shape
    for a, a_ref, abs_sum in zip(got, want, _abs_sums(*args)):
        _assert_near(a, a_ref, abs_sum)


@pytest.mark.parametrize("case", sorted(CASES))
def test_planes_backward_matches_jax(case):
    """The VJP of the JAX package's kernel (fp32, interpret mode) against
    the planes' products on the same numpy inputs."""
    t = CASES[case][0]
    (x_np, kernel, bias, gy_np, gs1_np, gs2_np), (x, w, b, gy, gs1, gs2) = _data(case, seed=24)
    _, vjp = jax.vjp(lambda a, k, c: jax_spike_conv.spike_conv3x3(a, k, c),
                     jnp.asarray(x_np), jnp.asarray(kernel), jnp.asarray(bias))
    dx_j, dk_j, db_j = vjp((jnp.asarray(gy_np), jnp.asarray(gs1_np), jnp.asarray(gs2_np)))
    y = sc.spike_conv3x3_fwd_reference(x, w, b)[0]
    dx, dw, db = planes_bwd(x, w, y, gy, gs1, gs2, True)
    tn, cin, h, hw = dx.shape
    dx_j = torch.tensor(np.asarray(dx_j)).reshape(tn, h, hw, cin).permute(0, 3, 1, 2)
    dk_j = torch.tensor(np.asarray(dk_j)).permute(3, 2, 0, 1)
    abs_sums = _abs_sums(x, w, y, gy, gs1, gs2, True)
    for a, a_j, abs_sum in zip((dx, dw, db), (dx_j, dk_j, torch.tensor(np.asarray(db_j))),
                               abs_sums):
        _assert_near(a, a_j, abs_sum)
