"""K2: the spiking denoiser on the tensor cores, a few launches per call (fused sampler).

Counterpart of ``spiking_diffusion_tpu/ops/fused_denoiser.py``. The
denoiser's BatchNorms are folded into its convolutions
(:func:`fold_denoiser_weights`); the first conv runs once per call on the
constant (token, t) map (:func:`first_preactivation`); then
:func:`fused_denoise` runs the T-step loop of every LIF layer, the skip
concat and the firing-rate readout through the hand-written CUDA kernels
of ``csrc/fused_denoiser.cu`` for a tensor on a CUDA device, and takes
:func:`fused_denoise_reference`, its plain PyTorch version, only for a
tensor on the CPU. ``LAUNCHES`` counts the calls that launch K2.

Weights come in fp32, bf16 (rounded to nearest even) or int8 (symmetric,
one scale per kernel row and output channel, the JAX package's default
``SD_INT8_SCALES=row`` with an int8 readout). Membranes, biases and logits
are fp32. Every conv is three kernel-row partial sums combined in the
order centre, top, bottom, then bias (int8: each partial times its
scale), the JAX mirror's int8 order; in int8 the partials are exact
integers, so kernel and plain version agree bitwise.

The kernel runs layer by layer over all T steps at once: each conv is one
tensor-core GEMM over N * P * T bf16 spike rows ordered (n, p, t),
channels-last and padded to a multiple of 8 channels, against a bf16
matrix built per call from the folded weights
(:func:`kernel_matrix`: three exact bf16 planes for fp32), and the LIF
scan over t runs in the GEMM's epilogue.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import warnings
from typing import Tuple

import torch
import torch.nn.functional as F

from spiking_diffusion_tpu_torch.config import DiffusionConfig
from spiking_diffusion_tpu_torch.models.diffusion import DenoiseFn
from spiking_diffusion_tpu_torch.ops import _build
from spiking_diffusion_tpu_torch.ops.spike_conv import bf16_planes, padded_channels
from spiking_diffusion_tpu_torch.snn.functional import fuse_conv_bn
from spiking_diffusion_tpu_torch.snn.neuron import lif_step

SOURCE = "fused_denoiser"
LAUNCHES = 0
# weight dtype -> the kernel's template selector
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
MAX_LAYERS = 8  # LIF conv blocks the kernel takes
MAX_STEPS = 128  # T: a 128-row tile holds whole T-step sequences (tc::kBM)
MAX_ROWS = 2**31 - 1  # N * P * T: the kernels' 32-bit row index
STAGE_DEPTH = 64  # a kernel row's contraction is padded to whole stages (tc::kBK)
ROW_ORDER = (1, 0, 2)  # kernel rows dy in the kernel's contraction: centre, top, bottom
# The precision of the first conv's folded kernel for each sampler dtype
# (the conv runs outside K2, once per call; the token map is exact in bf16,
# so the kernel is its only operand a rounding moves). bf16 and int8 take
# it in bf16: the arithmetic of the JAX package's records of these
# samplers, run on a TPU, whose default precision rounds a conv's fp32
# operands to bf16, and of the port's own bf16 denoiser, whose convs take
# bf16 operands. fp32 keeps it exact: every fp32 path of the port runs
# without TF32 or any other operand rounding, and the fp32 sampler is held
# to the layerwise fp32 denoiser logit for logit; the port reproduces no
# TPU rounding in fp32, here or in any other conv.
FIRST_CONV_DTYPES = {torch.float32: torch.float32, torch.bfloat16: torch.bfloat16,
                     torch.int8: torch.bfloat16}

_FN = None


def _kernel():
    global _FN
    if _FN is None:
        fn = _build.load(SOURCE).fused_denoiser_fwd
        fn.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


@dataclasses.dataclass(frozen=True)
class FoldedDenoiser:
    """BN-folded weights of a ``SpikingDenoiser`` for the fused sampler.

    ``k1`` (C1, 2, 3, 3) and ``b1`` (C1,): the first conv, fp32 tensors;
    ``k1`` holds values of ``FIRST_CONV_DTYPES[dtype]``. Then one entry per
    conv of the kernel, blocks 2..L and the readout last:
    ``weights[i]`` (3, 3 * Cin, Cout) in ``dtype``, rows grouped by kernel
    row dy and then (dx, cin); ``biases[i]`` (1, Cout) fp32, or for int8
    (4, Cout): the bias and one dequant scale per kernel row.
    """

    k1: torch.Tensor
    b1: torch.Tensor
    weights: Tuple[torch.Tensor, ...]
    biases: Tuple[torch.Tensor, ...]
    dtype: torch.dtype


@contextlib.contextmanager
def _full_fp32():
    """fp32 convolutions and matrix products without TF32, whatever the
    caller's global setting (cuDNN's default is TF32 on)."""
    old = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


def _quantize_rows(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 with one scale per kernel row and output channel.

    ``s = max(amax / 127, 1e-12)`` over each (kw, cin) group, then
    ``clip(round(w / s), -127, 127)``; ``torch.round`` rounds half to even
    as ``jnp.round`` does. Returns (int8 weights, (3, Cout) scales).
    """
    amax = w.abs().amax(dim=1)  # (3, Cout)
    s = torch.clamp(amax / 127.0, min=1e-12)
    wq = torch.clamp(torch.round(w / s[:, None, :]), -127, 127).to(torch.int8)
    return wq, s


def _kernel_rows(weight: torch.Tensor) -> torch.Tensor:
    """torch (Cout, Cin, 3, 3) -> (3, 3 * Cin, Cout), rows (dy; dx, cin)."""
    cout, cin = weight.shape[:2]
    return weight.permute(2, 3, 1, 0).reshape(3, 3 * cin, cout).contiguous()


@torch.no_grad()
def fold_denoiser_weights(denoiser, dtype=torch.float32) -> FoldedDenoiser:
    """Fold the BN of convs 1..L into them and cast or quantize for K2.

    Counterpart of the JAX ``_extract_folded_weights`` with
    ``folded_conv_params``. The readout conv has no BN and is not folded;
    it is cast or quantized like the others. The first conv stays outside
    the kernel, its weight rounded to ``FIRST_CONV_DTYPES[dtype]``.
    """
    if dtype not in DTYPES:
        raise TypeError(f"fused sampler dtype must be one of {list(DTYPES)}, got {dtype}")
    folded = [fuse_conv_bn(conv.weight, conv.bias, bn.scale, bn.bias, bn.mean,
                           bn.var, bn.eps)
              for conv, bn in zip(denoiser.convs, denoiser.bns)]
    folded.append((denoiser.readout.weight.detach().float(),
                   denoiser.readout.bias.detach().float()))
    k1, b1 = folded[0]
    k1 = k1.to(FIRST_CONV_DTYPES[dtype]).float()
    weights, biases = [], []
    for w, b in folded[1:]:
        w = _kernel_rows(w)
        b = b.reshape(1, -1)
        if dtype == torch.int8:
            w, s = _quantize_rows(w)
            b = torch.cat([b, s], dim=0)
        weights.append(w.to(dtype).contiguous())
        biases.append(b.contiguous())
    return FoldedDenoiser(k1.contiguous(), b1.contiguous(), tuple(weights),
                          tuple(biases), dtype)


def first_preactivation(tokens: torch.Tensor, t: torch.Tensor,
                        k1: torch.Tensor, b1: torch.Tensor) -> torch.Tensor:
    """The folded first conv on the direct-coded (token, t) map: (N, h*w, C1).

    Runs once per call; its output is the LIF-1 current at every step.
    Counterpart of the JAX ``_first_preactivation`` (conv, then + b1).
    """
    x = tokens.float().unsqueeze(1)
    x = torch.cat([x, t.float().reshape(-1, 1, 1, 1).expand_as(x)], dim=1)
    with _full_fp32():
        a1 = F.conv2d(x, k1, None, 1, 1) + b1.reshape(1, -1, 1, 1)
    n, c = a1.shape[:2]
    return a1.reshape(n, c, -1).transpose(1, 2).contiguous()


def denoiser_cost(cfg: DiffusionConfig, n: int, itemsize: int = 2,
                  useful_only: bool = False) -> Tuple[float, float]:
    """(flops, device-memory bytes) of one fused denoiser call at batch n.

    Flops: the T-step matrix work of every conv block and the readout,
    plus the first conv once; ``useful_only`` counts only the taps inside
    the grid (361 of 441 at 7x7), else all 9 taps at every position.
    Bytes: a1 in, logits out, the weights once at ``itemsize`` bytes each.
    """
    hw = cfg.latent_size
    hw2 = hw * hw
    ch = tuple(cfg.denoiser_channels)
    k = cfg.num_embeddings
    r = n * hw2
    tap = 1.0
    if useful_only:
        valid = sum((hw - abs(dy)) * (hw - abs(dx))
                    for dy in (-1, 0, 1) for dx in (-1, 0, 1))
        tap = valid / (9.0 * hw2)
    flops = tap * 2.0 * r * 9 * 2 * ch[0]
    per_t = sum(2.0 * r * 9 * ch[i - 1] * ch[i] for i in range(1, len(ch)))
    per_t += 2.0 * r * 9 * (ch[-1] + ch[0]) * k
    flops += tap * per_t * cfg.num_steps
    w_elems = sum(9 * ch[i - 1] * ch[i] for i in range(1, len(ch)))
    w_elems += 9 * (ch[-1] + ch[0]) * k
    return flops, r * ch[0] * 4.0 + r * k * 4.0 + w_elems * float(itemsize)


# --- the plain version -------------------------------------------------------


def _conv_rows(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, n: int,
               hw: int) -> torch.Tensor:
    """3x3 SAME conv of (n*hw*hw, Cin) spikes as three kernel-row products.

    Each partial is one fp32 product of the zero-padded, x-shifted spikes
    (n*hw*hw, 3 * Cin) with ``w[dy]``; they combine centre, top, bottom,
    then bias (each times its scale when ``b`` has 4 rows).
    """
    cin = x.shape[1]
    xp = F.pad(x.reshape(n, hw, hw, cin), (0, 0, 1, 1, 1, 1))
    wf = w.float()
    parts = []
    for dy in range(3):
        big = torch.cat([xp[:, dy:dy + hw, dx:dx + hw] for dx in range(3)], dim=-1)
        parts.append(big.reshape(n * hw * hw, 3 * cin) @ wf[dy])
    if b.shape[0] == 4:
        out = parts[1] * b[2]
        out = out + parts[0] * b[1]
        out = out + parts[2] * b[3]
    else:
        out = parts[1] + parts[0]
        out = out + parts[2]
    return out + b[0]


def fused_denoise_reference(a1: torch.Tensor, folded: FoldedDenoiser,
                            cfg: DiffusionConfig) -> torch.Tensor:
    """Plain PyTorch version of K2: (N, h*w, C1) a1 -> (N, h*w, K) logits.

    Counterpart of the JAX ``mirror_denoise_fn`` after the first conv:
    the same folded computation, fp32 membranes and logits, spikes as
    exact 0/1 fp32, TF32 off.
    """
    n, hw2, c1 = a1.shape
    hw = cfg.latent_size
    p = cfg.lif.to_params()
    x1 = a1.reshape(n * hw2, c1).float()
    chans = [c1] + [w.shape[2] for w in folded.weights[:-1]]
    vs = [torch.full((n * hw2, c), p.v_reset, dtype=torch.float32,
                     device=a1.device) for c in chans]
    acc = torch.zeros((n * hw2, folded.weights[-1].shape[2]),
                      dtype=torch.float32, device=a1.device)
    with _full_fp32():
        for _ in range(cfg.num_steps):
            vs[0], s1 = lif_step(vs[0], x1, p)
            x = s1
            for i in range(1, len(chans)):
                z = _conv_rows(x, folded.weights[i - 1], folded.biases[i - 1], n, hw)
                vs[i], x = lif_step(vs[i], z, p)
            cat = torch.cat([x, s1], dim=-1)
            acc = acc + _conv_rows(cat, folded.weights[-1], folded.biases[-1], n, hw)
    return (acc / cfg.num_steps).reshape(n, hw2, -1)


# --- the kernel's operand layout ----------------------------------------------


def planes_of(dtype: torch.dtype) -> int:
    """bf16 planes of a weight of ``dtype``: fp32 three, bf16 and int8 one."""
    return 3 if dtype == torch.float32 else 1


def kernel_row_depth(planes: int, cp: int) -> int:
    """Kr: one kernel row's contraction over (plane, dx, channel) of a
    ``cp``-channel operand, rounded up to whole stages."""
    return -(-planes * 3 * cp // STAGE_DEPTH) * STAGE_DEPTH


def conv_segments(chans: Tuple[int, ...]) -> Tuple[Tuple[int, ...], ...]:
    """The input channels of each conv of the kernel, as the parts of its
    spike operand: blocks 2..L one part each, the readout (x_L, s1)."""
    return tuple((c,) for c in chans[:-1]) + ((chans[-1], chans[0]),)


def kernel_matrix(w: torch.Tensor, segments: Tuple[int, ...]) -> torch.Tensor:
    """A folded (3, 3 * Cin, Cout) weight -> the kernel's bf16 B matrix.

    (3 * Kr, Cp(Cout)): the kernel rows in :data:`ROW_ORDER`, each a range
    of Kr rows (:func:`kernel_row_depth`, zero below its products), row
    plane * 3 * Cp_in + dx * Cp_in + c within it, where Cp_in lays the
    input channels out as ``segments``, each part padded to a multiple of
    8 (:func:`padded_channels`, zero), as the spike operand holds them. fp32
    weights are three bf16 planes (:func:`bf16_planes`, exact), smallest
    first; bf16 weights one plane; int8 weights one plane of their
    integers, exact in bf16 (their scales stay in the bias pack).
    """
    cin, cout = w.shape[1] // 3, w.shape[2]
    if sum(segments) != cin:
        raise ValueError(f"segments {segments} do not add up to {cin} channels")
    w4 = w.reshape(3, 3, cin, cout)
    if w.dtype == torch.float32:
        planes = list(reversed(bf16_planes(w4)))
    else:
        planes = [w4.to(torch.bfloat16)]
    stacked = torch.stack(planes, 1)  # (dy, plane, dx, Cin, Cout)
    parts, start = [], 0
    for c in segments:
        parts.append(F.pad(stacked[..., start:start + c, :],
                           (0, padded_channels(cout) - cout, 0, padded_channels(c) - c)))
        start += c
    m = torch.cat(parts, dim=-2)  # (3, planes, 3, Cp_in, Np)
    depth = m.shape[1] * 3 * m.shape[3]
    m = F.pad(m.reshape(3, depth, m.shape[-1]),
              (0, 0, 0, kernel_row_depth(m.shape[1], m.shape[3]) - depth))
    return m[list(ROW_ORDER)].reshape(-1, m.shape[-1]).contiguous()


def buffer_channels(chans: Tuple[int, ...]) -> Tuple[int, int, int]:
    """Channels of the kernel's three spike buffers: the concat (x_L | s1),
    ping (blocks 2, 4, ..) and pong (blocks 3, 5, ..), blocks below L; 0
    for a buffer no block uses."""
    mid = [padded_channels(c) for c in chans[1:-1]]
    return (padded_channels(chans[-1]) + padded_channels(chans[0]),
            max(mid[0::2], default=0), max(mid[1::2], default=0))


# --- the kernel's wrapper ----------------------------------------------------


def _on_card(t: torch.Tensor) -> bool:
    return t.is_cuda


def _check(a1: torch.Tensor, folded: FoldedDenoiser, cfg: DiffusionConfig):
    """Raise on inputs that neither K2 nor its plain version takes."""
    chans = tuple(cfg.denoiser_channels)
    hw2 = cfg.latent_size ** 2
    if a1.dtype != torch.float32:
        raise TypeError(f"a1 must be float32, got {a1.dtype}")
    if a1.ndim != 3 or a1.shape[0] < 1 or tuple(a1.shape[1:]) != (hw2, chans[0]):
        raise ValueError(f"a1 must be (N >= 1, {hw2}, {chans[0]}), got "
                         f"{tuple(a1.shape)}")
    if folded.dtype not in DTYPES:
        raise TypeError(f"weights must be one of {list(DTYPES)}, got {folded.dtype}")
    if not 2 <= len(chans) <= MAX_LAYERS:
        raise ValueError(f"K2 takes 2..{MAX_LAYERS} conv blocks, got {len(chans)}")
    cins = chans[:-1] + (chans[-1] + chans[0],)
    couts = chans[1:] + (cfg.num_embeddings,)
    bias_rows = 4 if folded.dtype == torch.int8 else 1
    if len(folded.weights) != len(couts) or len(folded.biases) != len(couts):
        raise ValueError(f"need {len(couts)} weights and biases")
    for w, b, cin, cout in zip(folded.weights, folded.biases, cins, couts):
        if w.dtype != folded.dtype or b.dtype != torch.float32:
            raise TypeError(f"weights {w.dtype} / bias {b.dtype}: need "
                            f"{folded.dtype} / float32")
        if tuple(w.shape) != (3, 3 * cin, cout) or tuple(b.shape) != (bias_rows, cout):
            raise ValueError(f"weight {tuple(w.shape)} / bias {tuple(b.shape)}: "
                             f"need (3, {3 * cin}, {cout}) / ({bias_rows}, {cout})")
    for x in folded.weights + folded.biases:
        if x.device != a1.device:
            raise ValueError(f"a1 on {a1.device}, weights on {x.device}")


def _check_card(a1: torch.Tensor, cfg: DiffusionConfig):
    """Raise on inputs that K2's plain version takes and the kernel does not."""
    steps = cfg.num_steps
    if steps > MAX_STEPS:
        raise ValueError(f"K2 takes T <= {MAX_STEPS} steps, got {steps}: a row tile "
                         "holds whole T-step sequences")
    if a1.shape[0] * a1.shape[1] * steps > MAX_ROWS:
        raise ValueError(f"K2 takes N * P * T <= {MAX_ROWS} rows, got "
                         f"{a1.shape[0]} * {a1.shape[1]} * {steps}")


def fused_denoise(a1: torch.Tensor, folded: FoldedDenoiser,
                  cfg: DiffusionConfig) -> torch.Tensor:
    """The denoiser after its first conv: (N, h*w, C1) a1 -> (N, h*w, K).

    A CPU tensor takes :func:`fused_denoise_reference`; a CUDA tensor
    launches K2 (its L + 1 kernels), or raises.
    """
    global LAUNCHES
    _check(a1, folded, cfg)
    if a1.device.type == "cpu":
        return fused_denoise_reference(a1, folded, cfg)
    if not _on_card(a1):
        raise ValueError(f"fused_denoise runs on CUDA or CPU, not {a1.device}")
    tensors = (a1,) + folded.weights + folded.biases
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("fused_denoise needs contiguous a1, weights and biases")
    _check_card(a1, cfg)
    chans = tuple(cfg.denoiser_channels)
    n, hw2 = a1.shape[:2]
    rows = n * hw2 * cfg.num_steps
    p = cfg.lif.to_params()
    mats = [kernel_matrix(w, seg) for w, seg in zip(folded.weights, conv_segments(chans))]
    cat_c, ping_c, pong_c = buffer_channels(chans)
    cat = torch.empty((rows, cat_c), dtype=torch.bfloat16, device=a1.device)
    ping = torch.empty((rows * ping_c,), dtype=torch.bfloat16, device=a1.device)
    pong = torch.empty((rows * pong_c,), dtype=torch.bfloat16, device=a1.device)
    out = torch.empty((n, hw2, cfg.num_embeddings), dtype=torch.float32,
                      device=a1.device)
    n_l = len(chans)
    c_chans = (ctypes.c_int * n_l)(*chans)
    w_ptrs = (ctypes.c_longlong * n_l)(*[m.data_ptr() for m in mats])
    b_ptrs = (ctypes.c_longlong * n_l)(*[b.data_ptr() for b in folded.biases])
    fn = _kernel()
    with torch.cuda.device(a1.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(DTYPES[folded.dtype], n, cfg.latent_size, n_l, c_chans,
                cfg.num_embeddings, cfg.num_steps, a1.data_ptr(), w_ptrs,
                b_ptrs, cat.data_ptr(), ping.data_ptr(), pong.data_ptr(),
                out.data_ptr(), p.decay, p.v_threshold, p.v_reset,
                int(p.decay_input), int(p.hard_reset), stream)
    if rc != 0:
        raise RuntimeError(f"fused_denoiser launch failed: code {rc}")
    LAUNCHES += 1
    return out


# --- the sampler's denoise functions ----------------------------------------


def make_fused_denoise_fn(denoiser, cfg: DiffusionConfig,
                          dtype=torch.float32) -> DenoiseFn:
    """(tokens (N, h, w), t (N,)) -> (N, h, w, K) logits through K2.

    Folds the weights on every call, as the JAX package does, so the
    function follows the module's current weights.
    """
    if dtype not in DTYPES:
        raise TypeError(f"fused sampler dtype must be one of {list(DTYPES)}, got {dtype}")
    hw, k = cfg.latent_size, cfg.num_embeddings

    @torch.no_grad()
    def denoise(tokens: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        folded = fold_denoiser_weights(denoiser, dtype)
        a1 = first_preactivation(tokens, t, folded.k1, folded.b1)
        return fused_denoise(a1, folded, cfg).reshape(tokens.shape[0], hw, hw, k)

    return denoise


def make_denoise_fn(denoiser, cfg: DiffusionConfig, fused="auto",
                    dtype=torch.float32) -> DenoiseFn:
    """The one place that picks the sampler's denoiser.

    ``fused``: True (K2, or its plain version for a denoiser on the CPU),
    False (the layerwise ``SpikingDenoiser``) or "auto" (K2 when the
    denoiser lies on a CUDA device). The layerwise path runs fp32 and
    warns when ``dtype`` asks for another type.
    """
    if fused not in (True, False, "auto"):
        raise ValueError(f"fused must be True, False or 'auto', got {fused!r}")
    on_card = next(denoiser.parameters()).is_cuda
    if fused is True or (fused == "auto" and on_card):
        return make_fused_denoise_fn(denoiser, cfg, dtype)
    if dtype != torch.float32:
        warnings.warn(
            f"sampler dtype {dtype} needs the fused sampler (fused=True, or "
            "'auto' on a CUDA device); the layerwise path runs fp32 and the "
            "dtype has no effect here.", stacklevel=2)
    return denoiser
