"""The operand contract of K4's bf16 route, on the CPU.

The bf16 kernels in ``csrc/spike_conv.cu`` take channels-last operands:
x (and g) as (N * H * W, Cp) with Cp = C rounded up to a multiple of 8,
the padding zero; the forward and dx weights as (9 * Cp, Cp') matrices
with row tap * Cp + channel (tap = kh * 3 + kw); and they give dW as
(Cout, 9 * Cp_in). Here the wrapper's plain layout helpers
(``channels_last``, ``kernel_weight_cl``, ``dx_weight_cl``,
``dw_from_cl``) are composed with a plain fp32 im2col product in that
index order, which is what the kernels compute, and held against the
port's plain versions (``spike_conv3x3_{fwd,bwd}_reference``) and against
the JAX package's ``spike_conv3x3`` and its VJP (Pallas in interpret mode)
on the same numpy inputs.

Tolerances: those of tests/test_torch_spike_conv.py, the JAX package's own
for its kernel against XLA's conv, since the sums run in other orders: y
within 1e-5 (bf16 2e-2, a bf16 rounding step), s1 and s2 within rtol
1e-4, atol 1e-3 (bf16 rtol 2e-2, atol 0.5), dx, dW and db within 1e-4
(bf16 dx 2e-2).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from spiking_diffusion_tpu.ops import spike_conv as jax_spike_conv
from spiking_diffusion_tpu_torch.ops import spike_conv as sc

CASES = {
    # (T, N, H = W, Cin, Cout): block 0's two input channels, channels that
    # are not a multiple of 8 (padded 6 -> 8, 10 -> 16, 130 -> 136, 140 ->
    # 144), a 4 x 4 grid, and row counts that fill no 128-row tile
    "cin2_2to12": (2, 3, 7, 2, 12),
    "ragged_6to10": (1, 13, 7, 6, 10),
    "wide_130to140": (1, 2, 7, 130, 140),
    "hw4_3to5": (2, 3, 4, 3, 5),
}
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
Y_TOL = {"fp32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}
MOMENT_TOL = {"fp32": dict(rtol=1e-4, atol=1e-3), "bf16": dict(rtol=2e-2, atol=0.5)}
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def setup():
    torch.set_num_threads(1)
    old = jax_spike_conv._INTERPRET
    jax_spike_conv._INTERPRET = True
    yield
    jax_spike_conv._INTERPRET = old


def _im2col(a_cl: torch.Tensor, n: int, h: int, w: int) -> torch.Tensor:
    """(N * H * W, Cp) channels-last -> (N * H * W, 9 * Cp), column tap * Cp
    + c, zero off the edge: the A operand of the bf16 forward and dx."""
    cp = a_cl.shape[1]
    pad = F.pad(a_cl.reshape(n, h, w, cp), (0, 0, 1, 1, 1, 1))
    taps = [pad[:, kh:kh + h, kw:kw + w] for kh in range(3) for kw in range(3)]
    return torch.cat(taps, dim=3).reshape(n * h * w, 9 * cp)


def layout_fwd(x, weight, bias):
    """The bf16 forward's GEMM in fp32: (y, s1, s2)."""
    n, cin, h, w = x.shape
    cout = weight.shape[0]
    a = _im2col(sc.channels_last(x, sc.padded_channels(cin)).float(), n, h, w)
    acc = (a @ sc.kernel_weight_cl(weight, x.dtype).float())[:, :cout] + bias
    y = acc.to(x.dtype).reshape(n, h, w, cout).permute(0, 3, 1, 2).contiguous()
    yf = y.float()
    return y, yf.sum((0, 2, 3)), (yf * yf).sum((0, 2, 3))


def layout_bwd(x, weight, y, gy, gs1, gs2, with_moments):
    """The bf16 backward's three products in fp32: (dx, dW, db)."""
    n, cin, h, w = x.shape
    cout = weight.shape[0]
    g = sc.grad_out(y, gy, gs1, gs2, with_moments)
    db = g.sum((0, 2, 3))
    g_cl = sc.channels_last(g.to(x.dtype), sc.padded_channels(cout)).float()
    a = _im2col(sc.channels_last(x, sc.padded_channels(cin)).float(), n, h, w)
    dw = sc.dw_from_cl((g_cl.t() @ a)[:cout], cin)
    dx = (_im2col(g_cl, n, h, w) @ sc.dx_weight_cl(weight, x.dtype).float())[:, :cin]
    dx = dx.to(x.dtype).reshape(n, h, w, cin).permute(0, 3, 1, 2).contiguous()
    return dx, dw, db


def _data(case, dname, seed):
    t, n, hw, cin, cout = CASES[case]
    rs = np.random.RandomState(seed)
    x = (rs.uniform(size=(t, n, hw, hw, cin)) < 0.3).astype(np.float32)
    kernel = (rs.normal(size=(3, 3, cin, cout)) * 0.2).astype(np.float32)
    bias = (rs.normal(size=(cout,)) * 0.1).astype(np.float32)
    gy = rs.normal(size=(t, n, hw, hw, cout)).astype(np.float32)
    gs1 = rs.normal(size=(cout,)).astype(np.float32)
    gs2 = (rs.normal(size=(cout,)) * 0.1).astype(np.float32)
    tdt = DTYPES[dname][1]
    port = dict(x=_to_port(x, tdt), weight=torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()),
                bias=torch.from_numpy(bias), gy=_to_port(gy, tdt),
                gs1=torch.from_numpy(gs1), gs2=torch.from_numpy(gs2))
    return (x, kernel, bias, gy, gs1, gs2), port


def _to_port(a: np.ndarray, dtype) -> torch.Tensor:
    """(T, N, H, W, C) -> (T * N, C, H, W)."""
    t, n, h, w, c = a.shape
    return torch.from_numpy(np.ascontiguousarray(
        a.reshape(t * n, h, w, c).transpose(0, 3, 1, 2))).to(dtype)


def _to_jax_layout(a: torch.Tensor, t: int) -> np.ndarray:
    tn, c, h, w = a.shape
    return a.detach().float().permute(0, 2, 3, 1).reshape(t, tn // t, h, w, c).numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_operands_are_padded_channels_last(case):
    """The copies the kernels read: zero padding, (tap, channel) rows, and
    dW's unpacking inverts the packing of an OIHW tensor."""
    _, n, hw, cin, cout = CASES[case]
    _, p = _data(case, "fp32", seed=1)
    cpi, cpo = sc.padded_channels(cin), sc.padded_channels(cout)
    assert cpi % sc.CHANNEL_ALIGN == 0 and cpi - cin < sc.CHANNEL_ALIGN
    x_cl = sc.channels_last(p["x"], cpi)
    assert x_cl.shape == (p["x"].shape[0] * hw * hw, cpi) and x_cl.is_contiguous()
    assert torch.equal(x_cl[:, :cin], p["x"].permute(0, 2, 3, 1).reshape(-1, cin))
    assert float(x_cl[:, cin:].abs().sum()) == 0.0
    wk = sc.kernel_weight_cl(p["weight"], torch.float32)
    w2 = sc.dx_weight_cl(p["weight"], torch.float32)
    assert wk.shape == (9 * cpi, cpo) and w2.shape == (9 * cpo, cpi)
    for kh in range(3):
        for kw in range(3):
            tap = kh * 3 + kw
            assert torch.equal(wk[tap * cpi:tap * cpi + cin, :cout], p["weight"][:, :, kh, kw].t())
            assert torch.equal(w2[tap * cpo:tap * cpo + cout, :cin],
                               p["weight"][:, :, 2 - kh, 2 - kw])
    assert float(wk.reshape(9, cpi, cpo)[:, cin:].abs().sum() + wk[:, cout:].abs().sum()) == 0.0
    assert float(w2.reshape(9, cpo, cpi)[:, cout:].abs().sum() + w2[:, cin:].abs().sum()) == 0.0
    packed = F.pad(p["weight"].permute(0, 2, 3, 1), (0, cpi - cin)).reshape(cout, 9 * cpi)
    assert torch.equal(sc.dw_from_cl(packed, cin), p["weight"])


@pytest.mark.parametrize("dname", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_layout_forward_matches_plain_version(case, dname):
    _, p = _data(case, dname, seed=2)
    y, s1, s2 = layout_fwd(p["x"], p["weight"], p["bias"])
    y_ref, s1_ref, s2_ref = sc.spike_conv3x3_fwd_reference(p["x"], p["weight"], p["bias"])
    assert y.dtype == y_ref.dtype and y.shape == y_ref.shape
    torch.testing.assert_close(y.float(), y_ref.float(), **Y_TOL[dname])
    torch.testing.assert_close(s1, s1_ref, **MOMENT_TOL[dname])
    torch.testing.assert_close(s2, s2_ref, **MOMENT_TOL[dname])


@pytest.mark.parametrize("with_moments", [True, False], ids=["moments", "no_moments"])
@pytest.mark.parametrize("dname", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_layout_backward_matches_plain_version(case, dname, with_moments):
    _, p = _data(case, dname, seed=3)
    y = sc.spike_conv3x3_fwd_reference(p["x"], p["weight"], p["bias"])[0]
    args = (p["x"], p["weight"], y, p["gy"], p["gs1"], p["gs2"], with_moments)
    dx, dw, db = layout_bwd(*args)
    dx_ref, dw_ref, db_ref = sc.spike_conv3x3_bwd_reference(*args)
    assert dx.dtype == dx_ref.dtype and dw.shape == dw_ref.shape
    torch.testing.assert_close(dx.float(), dx_ref.float(),
                               **(GRAD_TOL if dname == "fp32" else Y_TOL[dname]))
    torch.testing.assert_close(dw, dw_ref, **GRAD_TOL)
    torch.testing.assert_close(db, db_ref, **GRAD_TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_layout_matches_jax(case):
    """Forward and VJP of the JAX package's kernel (fp32, interpret mode)
    against the layout's products on the same numpy inputs."""
    t = CASES[case][0]
    (x, kernel, bias, gy, gs1, gs2), p = _data(case, "fp32", seed=4)
    out, vjp = jax.vjp(lambda a, k, b: jax_spike_conv.spike_conv3x3(a, k, b),
                       jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias))
    dx_j, dk_j, db_j = vjp((jnp.asarray(gy), jnp.asarray(gs1), jnp.asarray(gs2)))
    y, s1, s2 = layout_fwd(p["x"], p["weight"], p["bias"])
    np.testing.assert_allclose(_to_jax_layout(y, t), np.asarray(out[0]), **Y_TOL["fp32"])
    np.testing.assert_allclose(s1.numpy(), np.asarray(out[1]), **MOMENT_TOL["fp32"])
    np.testing.assert_allclose(s2.numpy(), np.asarray(out[2]), **MOMENT_TOL["fp32"])
    dx, dw, db = layout_bwd(p["x"], p["weight"], y, p["gy"], p["gs1"], p["gs2"], True)
    np.testing.assert_allclose(_to_jax_layout(dx, t), np.asarray(dx_j), **GRAD_TOL)
    np.testing.assert_allclose(dw.permute(2, 3, 1, 0).numpy(), np.asarray(dk_j), **GRAD_TOL)
    np.testing.assert_allclose(db.numpy(), np.asarray(db_j), **GRAD_TOL)


def test_wgrad_splits_fill_whole_waves():
    """The bf16 route's dW split (``fill``): at most ``WGRAD_BLOCKS`` blocks
    of 128 x 128 tiles over the padded Cin, every row covered, one split
    fewer than the fp32 route's at least-that-many where that overshoots."""
    for rows, cin, cout in ((200704, 256, 512), (200704, 64, 128), (200704, 320, 128),
                            (12544, 2, 64), (637, 6, 10)):
        cp = sc.padded_channels(cin)
        tiles = math.ceil(cout / 128) * math.ceil(9 * cp / 128)
        splits, per = sc.wgrad_splits(rows, cp, cout, fill=True)
        assert splits * per >= rows > (splits - 1) * per
        assert splits == 1 or splits * tiles <= sc.WGRAD_BLOCKS
        assert splits <= sc.wgrad_splits(rows, cp, cout)[0]
    assert sc.wgrad_splits(200704, 256, 512, fill=True) == (7, 28672)
    assert sc.wgrad_splits(200704, 256, 512) == (8, 25088)
