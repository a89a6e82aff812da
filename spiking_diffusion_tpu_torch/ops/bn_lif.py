"""K3: the fused BatchNorm-apply + LIF kernels, forward and backward, and
their plain PyTorch versions.

Counterpart of ``spiking_diffusion_tpu/ops/bn_lif.py`` ``bn_lif``: the
spikes of ``LIF(y * scale + shift)`` over the time axis, with ``scale``
and ``shift`` the per-channel BN factors (``SeqBatchNorm(...,
return_affine=True)``), so the normalised stack never reaches device
memory. The port's layout is PyTorch's: y is a time-major sequence
(T_in, N, C, ...) with channels on axis 2, a view of the conv output
(T_in * N, C, H, W). With T_in = 1 and ``t_out`` > 1 the input is
broadcast over time inside the kernel (the denoiser's first block) and
its gradient summed over the steps.

:func:`bn_lif_fwd` and :func:`bn_lif_bwd` launch the hand-written CUDA
kernels (``csrc/bn_lif.cu``) for tensors on a CUDA device and take their
plain versions (:func:`bn_lif_fwd_reference`,
:func:`bn_lif_bwd_reference`) only for tensors on the CPU;
:func:`bn_lif` puts the two behind one ``torch.autograd.Function``.
``LAUNCHES_FWD`` and ``LAUNCHES_BWD`` count the kernels' launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from spiking_diffusion_tpu_torch.ops import _build
from spiking_diffusion_tpu_torch.ops.lif import (
    NEURON_ARG_TYPES, bptt_step, data_ptr, membranes, neuron_args, register_steps)
from spiking_diffusion_tpu_torch.snn.neuron import NeuronParams

SOURCE = "bn_lif"
LAUNCHES_FWD = 0
LAUNCHES_BWD = 0
THREADS = 256  # a block's elements: whole rows of at most this many, or one longer row
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_FNS = {}


def _kernel(name: str):
    if name not in _FNS:
        fn = getattr(_build.load(SOURCE), name)
        n_ptr = 4 if name == "bn_lif_fwd" else 10
        fn.argtypes = [
            *(ctypes.c_void_p,) * n_ptr, *(ctypes.c_longlong,) * 3,
            *(ctypes.c_int,) * 3, *NEURON_ARG_TYPES, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return _FNS[name]


def _shape(y: torch.Tensor, t_out: Optional[int]) -> Tuple[int, int, int, int, int]:
    """(T_in, N, C, HW, t_out) of a (T_in, N, C, ...) input."""
    if y.ndim < 3 or y.numel() == 0:
        raise ValueError(f"need a non-empty (T_in, N, C, ...) input, got {tuple(y.shape)}")
    if y.dtype not in DTYPES:
        raise TypeError(f"bn_lif takes float32 or bfloat16, got {y.dtype}")
    t_in, n, c = y.shape[:3]
    t_out = t_in if t_out is None else int(t_out)
    if t_in != 1 and t_out != t_in:
        raise ValueError(f"t_out={t_out} needs T_in == 1 or T_in == t_out, T_in={t_in}")
    return t_in, n, c, math.prod(y.shape[3:]), t_out


def _affine(y, scale, shift, c):
    for name, a in (("scale", scale), ("shift", shift)):
        if a.shape != (c,) or a.dtype != torch.float32:
            raise ValueError(f"{name} must be ({c},) float32, got {tuple(a.shape)} {a.dtype}")
        if a.device != y.device:
            raise ValueError(f"{name} and y lie on different devices")
    return scale.reshape(1, c, 1), shift.reshape(1, c, 1)


def _membranes(y3, sc, sh, t_in, t_out, p: NeuronParams):
    """The pre-reset membranes H[t] of the forward, each (N, C, HW) fp32:
    K1's recurrence from v_reset on z = y * scale + shift (formed once
    when T_in = 1)."""
    z0 = y3[0].float() * sc + sh
    v = torch.full(z0.shape, p.v_reset, dtype=torch.float32, device=y3.device)
    z = (lambda t: z0) if t_in == 1 else (lambda t: y3[t].float() * sc + sh)
    return membranes(z, v, t_out, p)[0]


def bn_lif_fwd_reference(
    y: torch.Tensor,
    scale: torch.Tensor,
    shift: torch.Tensor,
    params: NeuronParams = NeuronParams(),
    t_out: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel: (t_out, N, C, ...)
    spikes in y's dtype, the kernel's fp32 operations in its order."""
    t_in, n, c, hw, t_out = _shape(y, t_out)
    sc, sh = _affine(y, scale, shift, c)
    y3 = y.reshape(t_in, n, c, hw)
    hs = _membranes(y3, sc, sh, t_in, t_out, params)
    s = torch.stack([(h >= params.v_threshold).float() for h in hs])
    return s.to(y.dtype).reshape((t_out,) + tuple(y.shape[1:]))


def channel_sums(acc: torch.Tensor) -> torch.Tensor:
    """(N, C, HW) per-element sums -> (C,), in the kernel's order: one
    partial per (n, c) row, then the N partials of a channel added in n
    order. A row of at most ``THREADS`` values is padded with zeros to the
    next power of two and halved in a tree (a[j] + a[j + half]); for a
    longer row each of ``THREADS`` threads first sums its values hw = k,
    k + ``THREADS``, .. in order and the thread sums are halved so."""
    n, c, hw = acc.shape
    if hw <= THREADS:
        a = torch.nn.functional.pad(acc, (0, (1 << (hw - 1).bit_length()) - hw))
    else:
        a = torch.zeros((n, c, THREADS), dtype=torch.float32, device=acc.device)
        for start in range(0, hw, THREADS):
            chunk = acc[:, :, start:start + THREADS]
            width = chunk.shape[2]
            a = torch.cat([a[..., :width] + chunk, a[..., width:]], dim=2)
    while a.shape[2] > 1:
        half = a.shape[2] // 2
        a = a[..., :half] + a[..., half:]
    total = torch.zeros(c, dtype=torch.float32, device=acc.device)
    for i in range(n):
        total = total + a[i, :, 0]
    return total


def bn_lif_bwd_reference(
    y: torch.Tensor,
    scale: torch.Tensor,
    shift: torch.Tensor,
    grad_spikes: torch.Tensor,
    params: NeuronParams = NeuronParams(),
    t_out: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernel: (dy in y's dtype,
    dscale, dshift fp32).

    Recomputes H[t], runs K1's backward step (``ops/lif.py``
    ``bptt_step``) with a zero v_T cotangent, and forms gz = dL/dz per
    step: dy = gz * scale (with T_in = 1, the sum of gz over the steps,
    backwards, times scale); dscale and dshift are the sums of gz * y and
    gz, per element over the steps and then per channel in
    :func:`channel_sums`' order. The spike cotangent comes in y's dtype.
    """
    t_in, n, c, hw, t_out = _shape(y, t_out)
    sc, sh = _affine(y, scale, shift, c)
    if grad_spikes.shape != (t_out,) + tuple(y.shape[1:]) or grad_spikes.dtype != y.dtype:
        raise ValueError(f"spike cotangent must be {(t_out,) + tuple(y.shape[1:])} "
                         f"{y.dtype}, got {tuple(grad_spikes.shape)} {grad_spikes.dtype}")
    p = params
    y3 = y.reshape(t_in, n, c, hw)
    gs = grad_spikes.reshape(t_out, n, c, hw)
    hs = _membranes(y3, sc, sh, t_in, t_out, p)
    dh_dv = 1.0 - p.decay
    zeros = torch.zeros((n, c, hw), dtype=torch.float32, device=y.device)
    gh_next, gy_acc, acc_scale, acc_shift = zeros, zeros, zeros, zeros
    gy = [None] * t_in
    for t in range(t_out - 1, -1, -1):
        gh = bptt_step(hs[t], gh_next * dh_dv, gs[t].float(), p)
        gz = gh * p.decay if p.decay_input else gh
        yt = y3[0 if t_in == 1 else t].float()
        acc_scale = acc_scale + gz * yt
        acc_shift = acc_shift + gz
        if t_in == 1:
            gy_acc = gy_acc + gz
        else:
            gy[t] = (gz * sc).to(y.dtype)
        gh_next = gh
    if t_in == 1:
        gy[0] = (gy_acc * sc).to(y.dtype)
    dy = torch.stack(gy).reshape(y.shape)
    return dy, channel_sums(acc_scale), channel_sums(acc_shift)


def _check_cuda(*tensors):
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"bn_lif runs on CUDA or CPU, not {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("bn_lif needs contiguous inputs")


def bn_lif_fwd(
    y: torch.Tensor,
    scale: torch.Tensor,
    shift: torch.Tensor,
    params: NeuronParams = NeuronParams(),
    t_out: Optional[int] = None,
) -> torch.Tensor:
    """Forward of the fused BN-apply + LIF: (t_out, N, C, ...) spikes in
    y's dtype. A CPU tensor takes :func:`bn_lif_fwd_reference`; a CUDA
    tensor launches the kernel or raises."""
    global LAUNCHES_FWD
    t_in, n, c, hw, t_out = _shape(y, t_out)
    _affine(y, scale, shift, c)
    if y.device.type == "cpu":
        return bn_lif_fwd_reference(y, scale, shift, params, t_out)
    _check_cuda(y, scale, shift)
    args = neuron_args(params)
    s = torch.empty((t_out,) + tuple(y.shape[1:]), dtype=y.dtype, device=y.device)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel("bn_lif_fwd")(
            y.data_ptr(), scale.data_ptr(), shift.data_ptr(), s.data_ptr(),
            n, c, hw, t_in, t_out, DTYPES[y.dtype], *args, stream)
    if rc != 0:
        raise RuntimeError(f"bn_lif_fwd launch failed: CUDA error {rc}")
    LAUNCHES_FWD += 1
    return s


def bn_lif_bwd(
    y: torch.Tensor,
    scale: torch.Tensor,
    shift: torch.Tensor,
    grad_spikes: torch.Tensor,
    params: NeuronParams = NeuronParams(),
    t_out: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward of the fused BN-apply + LIF: (dy, dscale, dshift). A CPU
    tensor takes :func:`bn_lif_bwd_reference`; a CUDA tensor launches the
    kernel or raises."""
    global LAUNCHES_BWD
    t_in, n, c, hw, t_out = _shape(y, t_out)
    _affine(y, scale, shift, c)
    if y.device.type == "cpu":
        return bn_lif_bwd_reference(y, scale, shift, grad_spikes, params, t_out)
    if grad_spikes.shape != (t_out,) + tuple(y.shape[1:]) or grad_spikes.dtype != y.dtype:
        raise ValueError(f"spike cotangent must be {(t_out,) + tuple(y.shape[1:])} "
                         f"{y.dtype}, got {tuple(grad_spikes.shape)} {grad_spikes.dtype}")
    _check_cuda(y, scale, shift, grad_spikes)
    args = neuron_args(params)
    dev = y.device
    dy = torch.empty_like(y)
    parts = torch.empty((2, n, c), dtype=torch.float32, device=dev)  # one partial per row
    sums = torch.empty((2, c), dtype=torch.float32, device=dev)
    hs = (torch.empty((t_out, n * c * hw), dtype=torch.float32, device=dev)
          if t_out > register_steps(SOURCE) else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel("bn_lif_bwd")(
            y.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            grad_spikes.data_ptr(), dy.data_ptr(), parts[0].data_ptr(),
            parts[1].data_ptr(), data_ptr(hs),
            sums[0].data_ptr(), sums[1].data_ptr(), n, c, hw, t_in, t_out,
            DTYPES[y.dtype], *args, stream)
    if rc != 0:
        raise RuntimeError(f"bn_lif_bwd launch failed: CUDA error {rc}")
    LAUNCHES_BWD += 1
    return dy, sums[0], sums[1]


class _BNLIF(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, scale, shift, params, t_out, reference):
        fwd = bn_lif_fwd_reference if reference else bn_lif_fwd
        ctx.save_for_backward(y, scale, shift)
        ctx.params, ctx.t_out, ctx.reference = params, t_out, reference
        return fwd(y, scale, shift, params, t_out)

    @staticmethod
    def backward(ctx, grad_s):
        y, scale, shift = ctx.saved_tensors
        bwd = bn_lif_bwd_reference if ctx.reference else bn_lif_bwd
        dy, dscale, dshift = bwd(y, scale, shift,
                                 grad_s.to(y.dtype).contiguous(), ctx.params,
                                 ctx.t_out)
        return dy, dscale, dshift, None, None, None


def bn_lif(
    y: torch.Tensor,
    scale: torch.Tensor,
    shift: torch.Tensor,
    params: NeuronParams = NeuronParams(),
    t_out: Optional[int] = None,
    reference: bool = False,
) -> torch.Tensor:
    """Differentiable fused ``LIF(y * scale + shift)`` over the time axis.

    y: (T_in, N, C, ...) in fp32 or bf16; scale, shift: (C,), taken in
    fp32. ``t_out`` defaults to T_in; with T_in == 1 the input is
    broadcast to ``t_out`` steps. Returns (t_out, N, C, ...) spikes in y's
    dtype. The forward is :func:`bn_lif_fwd`, the gradient
    :func:`bn_lif_bwd`; with ``reference`` their plain versions on either
    device.
    """
    t_out = _shape(y, t_out)[4]
    return _BNLIF.apply(y.contiguous(), scale.float().contiguous(),
                        shift.float().contiguous(), params, t_out, reference)
