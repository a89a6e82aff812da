"""K4: the 3x3 SAME stride-1 training convolution with in-kernel BatchNorm
moments, forward and backward, and their plain PyTorch versions.

Counterpart of ``spiking_diffusion_tpu/ops/spike_conv.py``
``spike_conv3x3`` and its ``custom_vjp``: ``y = conv3x3(x, W) + b`` over
a time-folded stack, with the per-channel ``s1 = sum(y)`` and ``s2 =
sum(y * y)`` of the rounded y in fp32, so that BatchNorm takes its batch
statistics from the conv (``SeqBatchNorm(moments=...)``) and never
re-reads y. The port's layout is PyTorch's: x (T * N, Cin, H, W), the
weight OIHW (Cout, Cin, 3, 3) and y (T * N, Cout, H, W), which is the
(T_in, N, C, HW) view that K3 (``ops/bn_lif.py``) reads, so the pair
chains with no layout copy. The JAX package's (HW, T, N, C) view and its
sublane padding of N are TPU artefacts and have no counterpart.

x and y are fp32 or bf16; the fp32 weight and bias are cast to x's dtype
(the bias is added in fp32 before y is rounded, as the TPU kernel adds
it); every product is summed in fp32. The backward takes the cotangents
``(gy, gs1, gs2)``, forms ``g = gy + (gs1 + 2 * gs2 * y)`` in fp32
(without moments, ``g = gy``), ``db`` as the sum of g, rounds g to x's
dtype, and returns dx in x's dtype and dW (OIHW), db in fp32.

:func:`spike_conv3x3_fwd` and :func:`spike_conv3x3_bwd` launch the
hand-written CUDA kernels (``csrc/spike_conv.cu``) for tensors on a CUDA
device and take their plain versions (:func:`spike_conv3x3_fwd_reference`,
:func:`spike_conv3x3_bwd_reference`: the nine taps as shifted,
edge-masked copies of x through ``torch.matmul`` in a fixed tap order)
only for tensors on the CPU; :func:`spike_conv3x3` puts the two behind one
``torch.autograd.Function``. ``LAUNCHES_FWD`` and ``LAUNCHES_BWD`` count
the kernels' launches.

bf16 runs on the tensor cores through channels-last operands: the kernels
copy x (and write the backward's g) as (N * H * W, Cp) with Cp = C rounded
up to ``CHANNEL_ALIGN``, the padding zero (plain version:
:func:`channels_last`), the wrapper lays the weight out as (9 * Cp_in,
Cp_out) and (9 * Cp_out, Cp_in) matrices with row tap * Cp + channel
(:func:`kernel_weight_cl`, :func:`dx_weight_cl`) and unpacks dW from
(Cout, 9 * Cp_in) (:func:`dw_from_cl`, for every route and dtype); y, dx
and the interface stay NCHW.

The fp32 forward takes one of two routes, chosen on the card per call
with no host synchronisation. The kernel copies x to bf16 channels-last
and flags whether any element changed or is not finite (plain version:
:func:`bf16_exact`). An x that bf16 holds exactly meets the weight's three
bf16 planes, whose fp32 sum is the weight (:func:`bf16_planes`, stacked
by :func:`kernel_weight_planes`), on the tensor cores: every product is
exact and is summed in fp32. Every x of the model's path is such an x
(spikes, token ids up to ``mask_id``, timesteps) while ``mask_id`` and the
number of timesteps are at most 256. Any other x, and any call of more
than ``MAX_ROWS`` rows, takes the CUDA cores over the NCHW x and the fp32
weight. :func:`fp32_route_counts` reads how many fp32 calls took each
route since :func:`reset_fp32_route_counts`.

The fp32 backward splits g = gy + (gs1 + 2 * gs2 * y) into its three
bf16 planes too (:func:`bf16_planes`, written channels-last by the g
pass: :func:`grad_planes_cl`), and each pass picks its route on the card
in the same way. dW = g^T . im2col(x) over the three g planes (exact
products, fp32 sums) takes the tensor cores when x is exact in bf16 and
every g is finite (:func:`bf16_planes_finite`). dx = the sum over taps of
g . W flipped takes them when every g is finite, over the six plane
products Gi . Wj with i + j <= 2, in the order of ``DX_TERMS`` (the
flipped weight's planes: :func:`dx_weight_planes`, stacked per term by
:func:`dx_weight_terms`); the three dropped terms add up to at most one
fp32 rounding of each product. Other operands, and calls of more than
``MAX_ROWS`` rows, take the CUDA cores over NCHW operands. db stays the
fp32 sum of the unrounded g. :func:`fp32_bwd_route_counts` reads the
routes of both passes.

The kernel and the plain version sum in different orders: y agrees
within about 1e-5 in fp32 on either route (a bf16 rounding step in bf16), s1 and s2
within rtol 1e-4, and dx, dW, db within 1e-4, the JAX package's own
tolerances for its kernel against XLA's conv (tests/test_spike_conv.py).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from spiking_diffusion_tpu_torch.ops import _build

SOURCE = "spike_conv"
LAUNCHES_FWD = 0
LAUNCHES_BWD = 0
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE_ROWS = 128  # rows of a forward block (csrc/spike_conv.cu kBM, tc::kBM)
CHANNEL_ALIGN = 8  # bf16: channels padded to whole 16-byte copies (tc::kAlign)
MAX_ROWS = 2**31 - 1  # the tensor-core kernels: N * H * W is a 32-bit index
RED_THREADS = 256  # elements of one channel per block of the g pass
WGRAD_BLOCKS = 4 * 132  # dW's row split aims at this many blocks (132 SMs)
WGRAD_MIN_ROWS = 64  # rows a split covers at least
WGRAD_PARTIAL_BYTES = 256 * 2**20  # at most this much fp32 dW partials

# dx's six plane products (g plane, weight plane), smallest first: the
# three of size about 2^-16 |g W|, then the two of 2^-8, then G0 W0. The
# dx kernel and its weight matrix follow this order.
DX_TERMS = ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))

_FNS = {}
# fp32 passes by route since the last reset, each (tensor cores, CUDA cores):
# the forward, dW, dx
_ROUTE_TALLY = {}  # device -> int32 (6,)


def _kernel(name: str):
    if name not in _FNS:
        fn = getattr(_build.load(SOURCE), name)
        if name == "spike_conv_fwd":
            fn.argtypes = [*(ctypes.c_void_p,) * 12, ctypes.c_longlong,
                           *(ctypes.c_int,) * 6, ctypes.c_void_p]
        elif name == "spike_conv_weight_f32":
            fn.argtypes = [*(ctypes.c_void_p,) * 4, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        elif name == "spike_conv_dx_weight_f32":
            fn.argtypes = [*(ctypes.c_void_p,) * 4, *(ctypes.c_int,) * 4, ctypes.c_void_p]
        else:
            fn.argtypes = [*(ctypes.c_void_p,) * 16, ctypes.c_longlong,
                           *(ctypes.c_int,) * 7, ctypes.c_longlong,
                           *(ctypes.c_int,) * 3, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return _FNS[name]


def _check(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None):
    """(N, Cin, Cout, H, W) of a valid call, or raise."""
    if x.ndim != 4 or x.numel() == 0:
        raise ValueError(f"need a non-empty (N, Cin, H, W) input, got {tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise TypeError(f"spike_conv3x3 takes float32 or bfloat16, got {x.dtype}")
    n, cin, h, w = x.shape
    if weight.ndim != 4 or tuple(weight.shape[1:]) != (cin, 3, 3):
        raise ValueError(f"3x3 kernels over {cin} channels only, got {tuple(weight.shape)}")
    cout = weight.shape[0]
    if weight.dtype != torch.float32:
        raise TypeError(f"the weight must be float32, got {weight.dtype}")
    if bias is not None and (bias.shape != (cout,) or bias.dtype != torch.float32):
        raise ValueError(f"bias must be ({cout},) float32, got {tuple(bias.shape)} {bias.dtype}")
    for name, t in (("weight", weight), ("bias", bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} and x lie on different devices")
    return n, cin, cout, h, w


def _taps(a: torch.Tensor):
    """The nine (kh, kw) shifts of a (N, C, H, W) fp32 stack as (N, H, W, C)
    copies, zero where the shift leaves the image, in tap order."""
    _, _, h, w = a.shape
    padded = F.pad(a, (1, 1, 1, 1))
    for kh in range(3):
        for kw in range(3):
            yield kh, kw, padded[:, :, kh:kh + h, kw:kw + w].permute(0, 2, 3, 1)


def spike_conv3x3_fwd_reference(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    with_moments: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel: (y in x's dtype, s1, s2
    fp32; zeros without moments). The nine taps through ``torch.matmul`` in
    fp32 on the dtype-rounded values, plus the fp32 bias, rounded to x's
    dtype, then the fp32 sums of the rounded y."""
    n, cin, cout, h, w = _check(x, weight, bias)
    wf = weight.to(x.dtype).float()
    acc = torch.zeros((n * h * w, cout), dtype=torch.float32, device=x.device)
    for kh, kw, xs in _taps(x.float()):
        acc = acc + torch.matmul(xs.reshape(-1, cin), wf[:, :, kh, kw].t())
    y = (acc + bias).to(x.dtype).reshape(n, h, w, cout).permute(0, 3, 1, 2).contiguous()
    if not with_moments:
        zeros = torch.zeros(cout, dtype=torch.float32, device=x.device)
        return y, zeros, zeros.clone()
    yf = y.float()
    return y, yf.sum((0, 2, 3)), (yf * yf).sum((0, 2, 3))


def grad_out(y, gy, gs1, gs2, with_moments):
    """The cotangent of y with the moments' folded in: g = gy + (gs1 + 2 *
    gs2 * y) in fp32 (g = gy without moments), the kernel's operations in
    its order."""
    g = gy.float()
    if with_moments:
        shape = (1, -1, 1, 1)
        g = g + (gs1.reshape(shape) + 2.0 * gs2.reshape(shape) * y.float())
    return g


def _check_grads(x, y, gy, gs1, gs2, cout):
    want = (x.shape[0], cout) + tuple(x.shape[2:])
    for name, t in (("y", y), ("gy", gy)):
        if tuple(t.shape) != want or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{name} must be {want} {x.dtype} on {x.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    for name, t in (("gs1", gs1), ("gs2", gs2)):
        if t.shape != (cout,) or t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"{name} must be ({cout},) float32 on {x.device}")


def spike_conv3x3_bwd_reference(
    x: torch.Tensor,
    weight: torch.Tensor,
    y: torch.Tensor,
    gy: torch.Tensor,
    gs1: torch.Tensor,
    gs2: torch.Tensor,
    with_moments: bool = True,
    need_dx: bool = True,
) -> Tuple[Optional[torch.Tensor], torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernel: (dx in x's dtype or
    None without ``need_dx``, dW (Cout, Cin, 3, 3) fp32, db fp32).

    The transposes of the forward's taps, as the TPU kernel writes them:
    db sums the fp32 g; g rounded to x's dtype gives dW[:, :, kh, kw] =
    g^T . tap(x) and dx = the sum over taps of g . W[:, :, kh, kw],
    shifted back."""
    n, cin, cout, h, w = _check(x, weight, None)
    _check_grads(x, y, gy, gs1, gs2, cout)
    g = grad_out(y, gy, gs1, gs2, with_moments)
    db = g.sum((0, 2, 3))
    gq = g.to(x.dtype).float().permute(0, 2, 3, 1).reshape(-1, cout)  # (M, Cout)
    wf = weight.to(x.dtype).float()
    dw = torch.empty((cout, cin, 3, 3), dtype=torch.float32, device=x.device)
    for kh, kw, xs in _taps(x.float()):
        dw[:, :, kh, kw] = torch.matmul(gq.t(), xs.reshape(-1, cin))
    if not need_dx:
        return None, dw, db
    dpad = torch.zeros((n, cin, h + 2, w + 2), dtype=torch.float32, device=x.device)
    for kh in range(3):
        for kw in range(3):
            part = torch.matmul(gq, wf[:, :, kh, kw]).reshape(n, h, w, cin)
            dpad[:, :, kh:kh + h, kw:kw + w] += part.permute(0, 3, 1, 2)
    dx = dpad[:, :, 1:h + 1, 1:w + 1].to(x.dtype).contiguous()
    return dx, dw, db


def kernel_weight(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """OIHW -> the forward kernel's (Cin * 9, Cout) matrix in ``dtype``,
    row ci * 9 + kh * 3 + kw."""
    cout = weight.shape[0]
    return weight.to(dtype).reshape(cout, -1).t().contiguous()


def dx_weight(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """OIHW -> the dx pass's (Cout * 9, Cin) matrix in ``dtype``: row
    co * 9 + t holds W[co, :, 8 - t], the flipped, transposed kernel."""
    cout, cin = weight.shape[:2]
    flipped = weight.to(dtype).flip((2, 3)).reshape(cout, cin, 9)
    return flipped.permute(0, 2, 1).reshape(cout * 9, cin).contiguous()


def padded_channels(c: int) -> int:
    """C rounded up to a multiple of ``CHANNEL_ALIGN``."""
    return -(-c // CHANNEL_ALIGN) * CHANNEL_ALIGN


def channels_last(a: torch.Tensor, cp: int) -> torch.Tensor:
    """(N, C, H, W) -> the (N * H * W, cp) channels-last copy that the bf16
    kernels make of x (and write of g), row (n, h, w), channels C.. cp
    zero: their plain version."""
    n, c, h, w = a.shape
    out = a.new_empty((n, h, w, cp))
    out[..., :c] = a.permute(0, 2, 3, 1)
    out[..., c:] = 0
    return out.reshape(n * h * w, cp)


def kernel_weight_cl(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """OIHW -> the bf16 forward's (9 * Cp_in, Cp_out) matrix in ``dtype``: row
    tap * Cp_in + ci (tap = kh * 3 + kw), column co, zero in the padding."""
    cout, cin = weight.shape[:2]
    cpi, cpo = padded_channels(cin), padded_channels(cout)
    w = F.pad(weight.to(dtype).permute(2, 3, 1, 0), (0, cpo - cout, 0, cpi - cin))
    return w.reshape(9 * cpi, cpo).contiguous()


def dx_weight_cl(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """OIHW -> the bf16 dx pass's (9 * Cp_out, Cp_in) matrix in ``dtype``: row
    tap * Cp_out + co holds W[co, :, 8 - tap], the flipped, transposed
    kernel, zero in the padding."""
    cout, cin = weight.shape[:2]
    cpi, cpo = padded_channels(cin), padded_channels(cout)
    w = F.pad(weight.to(dtype).flip((2, 3)).permute(2, 3, 0, 1), (0, cpi - cin, 0, cpo - cout))
    return w.reshape(9 * cpo, cpi).contiguous()


def bf16_planes(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(T0, T1, T2): three bf16 tensors whose fp32 sum is the fp32 t, T0 =
    bf16(t), T1 = bf16(t - T0), T2 = bf16(t - T0 - T1), each taking 8 of
    fp32's 24 significant bits. Exact for every finite |t| >= 2^-110 (and
    0) that bf16 does not round to inf (:func:`bf16_planes_finite`); below
    2^-110, within 2^-134, half bf16's least subnormal."""
    t0 = t.to(torch.bfloat16)
    rest = t - t0.float()
    t1 = rest.to(torch.bfloat16)
    return t0, t1, (rest - t1.float()).to(torch.bfloat16)


def bf16_planes_finite(t: torch.Tensor) -> bool:
    """True if every first plane bf16(t) is finite, so that the planes sum
    to t: the plain version of the flag by which the fp32 backward's g
    picks the tensor cores (a plane of +-inf holds inf - inf = NaN)."""
    return bool(torch.isfinite(t.to(torch.bfloat16)).all())


def plane_code(planes) -> int:
    """Plane indices (0..2), two bits each, the first lowest: how the
    kernels take the columns of ``DX_TERMS``."""
    return sum(p << (2 * i) for i, p in enumerate(planes))


def kernel_weight_planes(weight: torch.Tensor) -> torch.Tensor:
    """OIHW fp32 -> the fp32 forward's tensor-core matrix: the planes of
    :func:`bf16_planes` laid out as :func:`kernel_weight_cl` and stacked
    smallest first (W2, W1, W0), (3 * 9 * Cp_in, Cp_out) bf16."""
    planes = reversed(bf16_planes(weight))
    return torch.cat([kernel_weight_cl(p, torch.bfloat16) for p in planes])


def dx_weight_planes(weight: torch.Tensor) -> torch.Tensor:
    """OIHW fp32 -> the three bf16 planes of the flipped, transposed weight
    (:func:`bf16_planes`), each laid out as :func:`dx_weight_cl`, stacked
    W0, W1, W2: (3 * 9 * Cp_out, Cp_in) bf16."""
    return torch.cat([dx_weight_cl(p, torch.bfloat16) for p in bf16_planes(weight)])


def dx_weight_terms(weight: torch.Tensor) -> torch.Tensor:
    """OIHW fp32 -> the fp32 dx pass's tensor-core matrix: for each term of
    ``DX_TERMS`` in turn, its weight plane of :func:`dx_weight_planes`,
    (6 * 9 * Cp_out, Cp_in) bf16."""
    planes = dx_weight_planes(weight).chunk(3)
    return torch.cat([planes[j] for _, j in DX_TERMS])


def grad_planes_cl(g: torch.Tensor, cp: int) -> torch.Tensor:
    """(N, C, H, W) fp32 g -> its three bf16 planes (:func:`bf16_planes`)
    as the fp32 g pass writes them: (3, N * H * W, cp), G0, G1, G2, each
    as :func:`channels_last`, channels C.. cp zero."""
    return torch.stack([channels_last(p, cp) for p in bf16_planes(g)])


def bf16_exact(x: torch.Tensor) -> bool:
    """True if every element of x is finite and exact in bf16: the plain
    version of the flag by which the fp32 forward picks the tensor cores."""
    return bool(torch.isfinite(x).all()) and torch.equal(x.to(torch.bfloat16).to(x.dtype), x)


def dw_from_cl(dwm: torch.Tensor, cin: int) -> torch.Tensor:
    """The bf16 dW pass's (Cout, 9 * Cp_in) matrix, column tap * Cp_in + ci
    -> OIHW (Cout, Cin, 3, 3), the padding dropped."""
    cout = dwm.shape[0]
    return dwm.reshape(cout, 3, 3, -1)[..., :cin].permute(0, 3, 1, 2).contiguous()


def wgrad_splits(rows: int, cin: int, cout: int, fill: bool = False) -> Tuple[int, int]:
    """(splits, rows per split) of dW's contraction over ``rows``: about
    ``WGRAD_BLOCKS`` blocks of 128 x 128 dW tiles, at least that many, or
    with ``fill`` at most that many (the tensor-core route, two blocks per
    SM: two whole waves, no ragged last one); each split at least
    ``WGRAD_MIN_ROWS`` rows, their fp32 partials at most
    ``WGRAD_PARTIAL_BYTES``. Depends on the shapes only, so dW's sum order
    is the same from run to run. The tensor-core route passes its padded
    Cin and ``fill``, the fp32 CUDA-core route Cin."""
    tiles = math.ceil(cout / 128) * math.ceil(9 * cin / 128)
    aim = WGRAD_BLOCKS // tiles if fill else math.ceil(WGRAD_BLOCKS / tiles)
    splits = max(1, min(aim, rows // WGRAD_MIN_ROWS,
                        WGRAD_PARTIAL_BYTES // (4 * cout * 9 * cin)))
    per_split = math.ceil(rows / splits)
    return math.ceil(rows / per_split), per_split


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check_cuda(*tensors, max_rows: bool = True):
    x = tensors[0]
    if x.device.type != "cuda":
        raise ValueError(f"spike_conv3x3 runs on CUDA or CPU, not {x.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("spike_conv3x3 needs contiguous inputs")
    rows = x.shape[0] * x.shape[2] * x.shape[3]
    if max_rows and rows > MAX_ROWS:
        raise ValueError(f"the tensor-core kernels take at most {MAX_ROWS} rows N * H * W, "
                         f"got {rows}")


def _route_tally(device: torch.device) -> torch.Tensor:
    if device not in _ROUTE_TALLY:
        _ROUTE_TALLY[device] = torch.zeros(6, dtype=torch.int32, device=device)
    return _ROUTE_TALLY[device]


def fp32_weights(weight: torch.Tensor, stream: int) -> Tuple[torch.Tensor, ...]:
    """The fp32 forward's operands from a contiguous OIHW fp32 weight on the
    card, by one kernel on ``stream``: (the planes' matrix, as
    :func:`kernel_weight_planes`; the CUDA cores' matrix, as
    :func:`kernel_weight`; the route flag, a one-element int32 0)."""
    cout, cin = weight.shape[:2]
    dev = weight.device
    wk = torch.empty((27 * padded_channels(cin), padded_channels(cout)), dtype=torch.bfloat16,
                     device=dev)
    wk_cc = torch.empty((9 * cin, cout), dtype=torch.float32, device=dev)
    inexact = torch.empty(1, dtype=torch.int32, device=dev)
    rc = _kernel("spike_conv_weight_f32")(weight.data_ptr(), wk.data_ptr(), wk_cc.data_ptr(),
                                          inexact.data_ptr(), cin, cout, stream)
    if rc != 0:
        raise RuntimeError(f"spike_conv_weight_f32 launch failed: CUDA error {rc}")
    return wk, wk_cc, inexact


def fp32_dx_weights(weight: torch.Tensor, need_dx: bool, force_cc: bool,
                    stream: int) -> Tuple[Optional[torch.Tensor], ...]:
    """The fp32 backward's operands from a contiguous OIHW fp32 weight on
    the card, by one kernel on ``stream``: (the six terms' matrix, as
    :func:`dx_weight_terms`; the CUDA cores' matrix, as :func:`dx_weight`;
    both None without ``need_dx``; the two route flags, int32, both
    ``force_cc``)."""
    cout, cin = weight.shape[:2]
    dev = weight.device
    w2 = w2_cc = None
    if need_dx:
        w2 = torch.empty((len(DX_TERMS) * 9 * padded_channels(cout), padded_channels(cin)),
                         dtype=torch.bfloat16, device=dev)
        w2_cc = torch.empty((cout * 9, cin), dtype=torch.float32, device=dev)
    flags = torch.empty(2, dtype=torch.int32, device=dev)
    rc = _kernel("spike_conv_dx_weight_f32")(
        weight.data_ptr(), _ptr(w2), _ptr(w2_cc), flags.data_ptr(), cin, cout,
        plane_code(j for _, j in DX_TERMS), int(force_cc), stream)
    if rc != 0:
        raise RuntimeError(f"spike_conv_dx_weight_f32 launch failed: CUDA error {rc}")
    return w2, w2_cc, flags


def _route_counts(lo: int, hi: int) -> Tuple[int, ...]:
    counts = [t.tolist() for t in _ROUTE_TALLY.values()]
    return tuple(sum(c[i] for c in counts) for i in range(lo, hi))


def fp32_route_counts() -> Tuple[int, int]:
    """(tensor cores, CUDA cores): the fp32 forwards that took each route
    since the last :func:`reset_fp32_route_counts`, over every device.
    Synchronises with the card."""
    return _route_counts(0, 2)


def fp32_bwd_route_counts() -> Tuple[int, int, int, int]:
    """(dW on the tensor cores, dW on the CUDA cores, dx on the tensor
    cores, dx on the CUDA cores): the fp32 backward passes by route since
    the last :func:`reset_fp32_route_counts`, over every device.
    Synchronises with the card."""
    return _route_counts(2, 6)


def reset_fp32_route_counts() -> None:
    for tally in _ROUTE_TALLY.values():
        tally.zero_()


def spike_conv3x3_fwd(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    with_moments: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forward of the training conv: (y, s1, s2). A CPU tensor takes
    :func:`spike_conv3x3_fwd_reference`; a CUDA tensor launches the kernel
    or raises."""
    global LAUNCHES_FWD
    n, cin, cout, h, w = _check(x, weight, bias)
    if x.device.type == "cpu":
        return spike_conv3x3_fwd_reference(x, weight, bias, with_moments)
    fp32 = x.dtype == torch.float32
    _check_cuda(x, weight, bias, max_rows=not fp32)
    dev = x.device
    # the kernel copies x to bf16 channels-last into xcl (fp32 beyond
    # MAX_ROWS rows: the CUDA cores read x as it lies)
    xcl = (torch.empty((n * h * w, padded_channels(cin)), dtype=torch.bfloat16, device=dev)
           if n * h * w <= MAX_ROWS else None)
    y = torch.empty((n, cout, h, w), dtype=x.dtype, device=dev)
    sums = torch.zeros((2, cout), dtype=torch.float32, device=dev)
    parts = (torch.empty((2, math.ceil(n * h * w / TILE_ROWS), cout), dtype=torch.float32,
                         device=dev) if with_moments else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if fp32:  # both routes' weights; the route flag, 0 until the copy sets it
            (wk, wk_cc, inexact), tally = fp32_weights(weight, stream), _route_tally(dev)
        else:
            wk, wk_cc, inexact, tally = kernel_weight_cl(weight, x.dtype), None, None, None
        rc = _kernel("spike_conv_fwd")(
            x.data_ptr(), _ptr(xcl), wk.data_ptr(), _ptr(wk_cc), bias.data_ptr(),
            y.data_ptr(),
            *((parts[0].data_ptr(), parts[1].data_ptr()) if with_moments else (None, None)),
            sums[0].data_ptr(), sums[1].data_ptr(), _ptr(inexact), _ptr(tally), n, cin, cout,
            h, w, int(with_moments), DTYPES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"spike_conv_fwd launch failed: CUDA error {rc}")
    LAUNCHES_FWD += 1
    return y, sums[0], sums[1]


def spike_conv3x3_bwd(
    x: torch.Tensor,
    weight: torch.Tensor,
    y: torch.Tensor,
    gy: torch.Tensor,
    gs1: torch.Tensor,
    gs2: torch.Tensor,
    with_moments: bool = True,
    need_dx: bool = True,
) -> Tuple[Optional[torch.Tensor], torch.Tensor, torch.Tensor]:
    """Backward of the training conv: (dx or None, dW, db). A CPU tensor
    takes :func:`spike_conv3x3_bwd_reference`; a CUDA tensor launches the
    kernels or raises."""
    global LAUNCHES_BWD
    n, cin, cout, h, w = _check(x, weight, None)
    if x.device.type == "cpu":
        return spike_conv3x3_bwd_reference(x, weight, y, gy, gs1, gs2, with_moments,
                                           need_dx)
    _check_grads(x, y, gy, gs1, gs2, cout)
    _check_cuda(x, weight, y, gy, gs1, gs2, max_rows=x.dtype == torch.bfloat16)
    dev = x.device
    rows = n * h * w
    fp32 = x.dtype == torch.float32
    tc = rows <= MAX_ROWS  # else (fp32 only) the CUDA cores over NCHW operands
    cpi, cpo = padded_channels(cin), padded_channels(cout)
    # channels-last scratch: x's bf16 copy and g (fp32: its three planes)
    xcl = torch.empty((rows, cpi), dtype=torch.bfloat16, device=dev) if tc else None
    g = (torch.empty((3 if fp32 else 1, rows, cpo), dtype=torch.bfloat16, device=dev)
         if tc else None)
    splits, per_split = wgrad_splits(rows, cpi, cout, fill=True) if tc else (0, 0)
    splits_cc, per_split_cc = wgrad_splits(rows, cin, cout) if fp32 else (0, 0)
    part_db = torch.empty((math.ceil(rows / RED_THREADS), cout), dtype=torch.float32,
                          device=dev)
    db = torch.empty(cout, dtype=torch.float32, device=dev)
    dx = torch.empty_like(x) if need_dx else None
    part_dw = torch.empty(max(splits * cout * 9 * cpi, splits_cc * cout * 9 * cin),
                          dtype=torch.float32, device=dev)
    dwm = torch.empty((cout, 9 * cpi), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if fp32:  # both routes' dx weights; the route flags, cleared (forced beyond MAX_ROWS)
            w2, w2_cc, flags = fp32_dx_weights(weight, need_dx, not tc, stream)
            tally = _route_tally(dev)[2:]
        else:
            w2, w2_cc, flags, tally = (dx_weight_cl(weight, x.dtype) if need_dx else None,
                                       None, None, None)
        rc = _kernel("spike_conv_bwd")(
            x.data_ptr(), _ptr(xcl), _ptr(w2), _ptr(w2_cc), y.data_ptr(), gy.data_ptr(),
            gs1.data_ptr(), gs2.data_ptr(), _ptr(g), part_db.data_ptr(), db.data_ptr(),
            _ptr(dx), part_dw.data_ptr(), dwm.data_ptr(), _ptr(flags), _ptr(tally), n, cin,
            cout, h, w, splits, per_split, splits_cc, per_split_cc, int(with_moments),
            plane_code(i for i, _ in DX_TERMS), DTYPES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"spike_conv_bwd launch failed: CUDA error {rc}")
    LAUNCHES_BWD += 1
    return dx, dw_from_cl(dwm, cin), db


class _SpikeConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, with_moments, reference):
        fwd = spike_conv3x3_fwd_reference if reference else spike_conv3x3_fwd
        y, s1, s2 = fwd(x, weight, bias, with_moments)
        ctx.save_for_backward(x, weight, y)
        ctx.with_moments, ctx.reference = with_moments, reference
        ctx.set_materialize_grads(False)
        return y, s1, s2

    @staticmethod
    def backward(ctx, gy, gs1, gs2):
        x, weight, y = ctx.saved_tensors
        cout = weight.shape[0]
        zeros = lambda: torch.zeros(cout, dtype=torch.float32, device=x.device)  # noqa: E731
        gy = torch.zeros_like(y) if gy is None else gy.to(y.dtype).contiguous()
        gs1 = zeros() if gs1 is None else gs1.float().contiguous()
        gs2 = zeros() if gs2 is None else gs2.float().contiguous()
        bwd = spike_conv3x3_bwd_reference if ctx.reference else spike_conv3x3_bwd
        dx, dw, db = bwd(x, weight, y, gy, gs1, gs2, ctx.with_moments,
                         need_dx=ctx.needs_input_grad[0])
        return dx, dw, db, None, None


def spike_conv3x3(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    with_moments: bool = True,
    reference: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Differentiable 3x3 SAME stride-1 conv with BN moments.

    x: (N, Cin, H, W) fp32 or bf16 (T folded into N); weight: (Cout, Cin,
    3, 3) fp32; bias: (Cout,) fp32. Returns (y (N, Cout, H, W) in
    x's dtype, s1, s2 (Cout,) fp32), s1 and s2 zeros without
    ``with_moments``; the count behind the moments is N * H * W. The
    forward is :func:`spike_conv3x3_fwd`, the gradient
    :func:`spike_conv3x3_bwd`; with ``reference`` their plain versions on
    either device. A ``None`` cotangent counts as zero.
    """
    _check(x, weight, bias)
    return _SpikeConv.apply(x.contiguous(), weight.contiguous(), bias.contiguous(),
                            with_moments, reference)
