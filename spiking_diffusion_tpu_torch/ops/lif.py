"""K1 forward: the multi-step LIF kernel and its plain PyTorch version.

Counterpart of ``spiking_diffusion_tpu/ops/pallas_lif.py`` ``lif_fused``.
:func:`lif_fwd` launches the hand-written CUDA kernel
(``csrc/lif_fwd.cu``) for a tensor on a CUDA device and takes
:func:`lif_fwd_reference` only for a tensor on the CPU. ``LAUNCHES``
counts the kernel's launches, so a run can show that its path went
through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from spiking_diffusion_tpu_torch.ops import _build
from spiking_diffusion_tpu_torch.snn.neuron import NeuronParams

SOURCE = "lif_fwd"
LAUNCHES = 0

_FN = None


def _kernel():
    global _FN
    if _FN is None:
        fn = _build.load(SOURCE).lif_fwd_f32
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _initial_membrane(x_seq, v_init, params: NeuronParams) -> torch.Tensor:
    m = x_seq[0].numel()
    if v_init is None:
        return torch.full((m,), params.v_reset, dtype=torch.float32,
                          device=x_seq.device)
    if tuple(v_init.shape) != tuple(x_seq.shape[1:]):
        raise ValueError(
            f"v_init shape {tuple(v_init.shape)} != {tuple(x_seq.shape[1:])}")
    if v_init.device != x_seq.device:
        raise ValueError("v_init and x_seq lie on different devices")
    return v_init.reshape(m).float()


def lif_fwd_reference(
    x_seq: torch.Tensor,
    v_init: Optional[torch.Tensor] = None,
    params: NeuronParams = NeuronParams(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: (T, ...) -> (spikes, v_T).

    A loop over T with the kernel's fp32 operations in the kernel's order.
    Spikes come back in the input dtype, v_T in fp32 with shape
    ``x_seq.shape[1:]``.
    """
    p = params
    t_steps = x_seq.shape[0]
    x2d = x_seq.reshape(t_steps, -1).float()
    v = _initial_membrane(x_seq, v_init, p)
    spikes = []
    for t in range(t_steps):
        if p.decay_input:
            h = v + (x2d[t] - (v - p.v_reset)) * p.decay
        else:
            h = v - (v - p.v_reset) * p.decay + x2d[t]
        s = (h >= p.v_threshold).float()
        spikes.append(s)
        if p.hard_reset:
            v = (1.0 - s) * h + s * p.v_reset
        else:
            v = h - s * p.v_threshold
    s_seq = torch.stack(spikes).reshape(x_seq.shape).to(x_seq.dtype)
    return s_seq, v.reshape(x_seq.shape[1:])


def lif_fwd(
    x_seq: torch.Tensor,
    v_init: Optional[torch.Tensor] = None,
    params: NeuronParams = NeuronParams(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-step LIF forward: (T, ...) -> (spikes, v_T).

    fp32 or bf16 input, contiguous; bf16 is cast up to fp32 before the
    kernel (membranes are fp32) and the spikes come back in the input
    dtype. A CPU tensor takes :func:`lif_fwd_reference`; a CUDA tensor
    launches the kernel or raises.
    """
    global LAUNCHES
    if x_seq.ndim < 1 or x_seq.numel() == 0:
        raise ValueError(f"need a non-empty (T, ...) input, got {tuple(x_seq.shape)}")
    if x_seq.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"lif_fwd takes float32 or bfloat16, got {x_seq.dtype}")
    if x_seq.device.type == "cpu":
        return lif_fwd_reference(x_seq, v_init, params)
    if not x_seq.is_cuda:
        raise ValueError(f"lif_fwd runs on CUDA or CPU, not {x_seq.device}")
    if not x_seq.is_contiguous():
        raise ValueError("lif_fwd needs a contiguous input")
    t_steps = x_seq.shape[0]
    m = x_seq[0].numel()
    x2d = x_seq.reshape(t_steps, m).float()
    v0 = _initial_membrane(x_seq, v_init, params).contiguous()
    s = torch.empty((t_steps, m), dtype=torch.float32, device=x_seq.device)
    v_t = torch.empty((m,), dtype=torch.float32, device=x_seq.device)
    fn = _kernel()
    with torch.cuda.device(x_seq.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x2d.data_ptr(), v0.data_ptr(), s.data_ptr(), v_t.data_ptr(),
                t_steps, m, params.decay, params.v_threshold, params.v_reset,
                int(params.decay_input), int(params.hard_reset), stream)
    if rc != 0:
        raise RuntimeError(f"lif_fwd_f32 launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return s.reshape(x_seq.shape).to(x_seq.dtype), v_t.reshape(x_seq.shape[1:])
