"""K1: the multi-step LIF kernels, forward and backward, and their plain
PyTorch versions.

Counterpart of ``spiking_diffusion_tpu/ops/pallas_lif.py`` ``lif_fused``.
:func:`lif_fwd` launches the hand-written CUDA kernel
(``csrc/lif_fwd.cu``) and :func:`lif_bwd` the BPTT kernel
(``csrc/lif_bwd.cu``) for tensors on a CUDA device; each takes its plain
version (:func:`lif_fwd_reference`, :func:`lif_bwd_reference`) only for
tensors on the CPU. :func:`lif` puts the two behind one
``torch.autograd.Function``: the backward recomputes the membranes from
the saved input and initial membrane instead of storing them, as the
TPU kernel does. ``LAUNCHES`` and ``LAUNCHES_BWD`` count the kernels'
launches, so a run can show that its path went through them.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from spiking_diffusion_tpu_torch.ops import _build
from spiking_diffusion_tpu_torch.snn.neuron import NeuronParams, charge, reset
from spiking_diffusion_tpu_torch.snn.surrogate import atan_constants

SOURCE = "lif_fwd"
SOURCE_BWD = "lif_bwd"
LAUNCHES = 0
LAUNCHES_BWD = 0
# surrogate family -> the backward kernels' selector
SURROGATES = {"atan": 0, "sigmoid": 1}
# ctypes of :func:`neuron_args`, in order
NEURON_ARG_TYPES = (ctypes.c_float,) * 4 + (ctypes.c_int,) * 4 + (ctypes.c_float,) * 2

_FN = None
_FN_BWD = None


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


def _kernel_bwd():
    global _FN_BWD
    if _FN_BWD is None:
        fn = _build.load(SOURCE_BWD).lif_bwd_f32
        fn.argtypes = [
            *(ctypes.c_void_p,) * 6, ctypes.c_longlong, ctypes.c_longlong,
            *NEURON_ARG_TYPES, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _FN_BWD = fn
    return _FN_BWD


def data_ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """A tensor's device address for ctypes, or None (NULL) for no tensor."""
    return None if t is None else t.data_ptr()


def register_steps(source: str) -> int:
    """The longest T whose membranes the backward kernels of ``source``
    keep in registers (``csrc/lif_neuron.cuh``); a longer T needs a
    (T, M) fp32 scratch from the caller."""
    return _build.load(source).lif_register_steps()


def neuron_args(params: NeuronParams):
    """The neuron constants as the backward kernels take them: decay,
    v_th, v_reset, 1 - decay (the Python float JAX forms), decay_input,
    hard_reset, detach_reset, the surrogate's selector and its two
    factors (atan: pi/2 * alpha and alpha/2; sigmoid: alpha, unused).

    Raises for a surrogate family the kernels do not have."""
    p, sg = params, params.surrogate
    if sg.name not in SURROGATES:
        raise ValueError(f"the LIF kernels take the {sorted(SURROGATES)} "
                         f"surrogates, not {sg.name!r}")
    factors = atan_constants(sg.alpha) if sg.name == "atan" else (sg.alpha, 0.0)
    return (p.decay, p.v_threshold, p.v_reset, 1.0 - p.decay,
            int(p.decay_input), int(p.hard_reset), int(p.detach_reset),
            SURROGATES[sg.name], *factors)


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


def membranes(inputs, v: torch.Tensor, t_steps: int, p: NeuronParams):
    """The pre-reset membranes [H[0], .., H[T-1]] and V[T-1] of a run from
    membrane ``v``, with ``inputs(t)`` step t's fp32 input: the forward
    recurrence every plain version here and in ``ops/bn_lif.py`` shares."""
    hs = []
    for t in range(t_steps):
        h = charge(v, inputs(t), p)
        hs.append(h)
        v = reset(h, (h >= p.v_threshold).float(), p)
    return hs, v


def bptt_step(h: torch.Tensor, gv: torch.Tensor, g_s: torch.Tensor,
              p: NeuronParams) -> torch.Tensor:
    """One reverse-time step of BPTT, ``csrc/lif_neuron.cuh``'s
    ``bptt_step`` in its fp32 operations and order: dL/dH[t] from H[t],
    the membrane cotangent ``gv`` flowing in from step t + 1 and the spike
    cotangent ``g_s``, with the surrogate gradient at H[t] - v_th."""
    s = (h >= p.v_threshold).float()
    surr = p.surrogate.grad(h - p.v_threshold)
    if p.hard_reset:
        dv_dh = 1.0 - s
        reset_term = (p.v_reset - h) * surr
    else:
        dv_dh = 1.0
        reset_term = -p.v_threshold * surr
    if p.detach_reset:
        return gv * dv_dh + g_s * surr
    return gv * (dv_dh + reset_term) + g_s * surr


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
    hs, v = membranes(lambda t: x2d[t], _initial_membrane(x_seq, v_init, p), t_steps, p)
    spikes = [(h >= p.v_threshold).float() for h in hs]
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
    # no v_init: the kernel starts from v_reset and reads no v0
    v0 = None if v_init is None else _initial_membrane(x_seq, v_init, params).contiguous()
    s = torch.empty((t_steps, m), dtype=torch.float32, device=x_seq.device)
    v_t = torch.empty((m,), dtype=torch.float32, device=x_seq.device)
    fn = _kernel()
    with torch.cuda.device(x_seq.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x2d.data_ptr(), data_ptr(v0), s.data_ptr(), v_t.data_ptr(),
                t_steps, m, params.decay, params.v_threshold, params.v_reset,
                int(params.decay_input), int(params.hard_reset), stream)
    if rc != 0:
        raise RuntimeError(f"lif_fwd_f32 launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return s.reshape(x_seq.shape).to(x_seq.dtype), v_t.reshape(x_seq.shape[1:])


def _bwd_shapes(x_seq, grad_spikes):
    if x_seq.ndim < 1 or x_seq.numel() == 0:
        raise ValueError(f"need a non-empty (T, ...) input, got {tuple(x_seq.shape)}")
    if x_seq.dtype != torch.float32 or grad_spikes.dtype != torch.float32:
        raise TypeError("the LIF backward takes float32 input and spike "
                        f"cotangent, got {x_seq.dtype} and {grad_spikes.dtype}")
    if grad_spikes.shape != x_seq.shape:
        raise ValueError(f"spike cotangent shape {tuple(grad_spikes.shape)} "
                         f"!= input shape {tuple(x_seq.shape)}")
    if grad_spikes.device != x_seq.device:
        raise ValueError("input and spike cotangent lie on different devices")


def lif_bwd_reference(
    x_seq: torch.Tensor,
    v_init: Optional[torch.Tensor],
    grad_spikes: torch.Tensor,
    params: NeuronParams = NeuronParams(),
    need_dv0: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of the backward kernel: (dX, dV0).

    Pass 1 recomputes the pre-reset membranes H[t] from ``x_seq`` and the
    initial membrane (:func:`membranes`); pass 2 runs back in time through
    :func:`bptt_step`, in the kernel's (and JAX ``_bwd_kernel``'s) fp32
    operations and order. The cotangent of v_T is zero. dX has the
    input's shape, dV0 the shape ``x_seq.shape[1:]`` (None unless
    ``need_dv0``); both fp32.
    """
    _bwd_shapes(x_seq, grad_spikes)
    p = params
    t_steps = x_seq.shape[0]
    x2d = x_seq.reshape(t_steps, -1)
    gs = grad_spikes.reshape(t_steps, -1)
    hs, _ = membranes(lambda t: x2d[t], _initial_membrane(x_seq, v_init, p), t_steps, p)
    dh_dv = 1.0 - p.decay
    gh_next = torch.zeros_like(hs[0])
    gv_carry = torch.zeros_like(hs[0])  # the cotangent of v_T
    gx = [None] * t_steps
    for t in range(t_steps - 1, -1, -1):
        gh = bptt_step(hs[t], gv_carry + gh_next * dh_dv, gs[t], p)
        gx[t] = gh * p.decay if p.decay_input else gh
        gh_next = gh
    dx = torch.stack(gx).reshape(x_seq.shape)
    return dx, (gh_next * dh_dv).reshape(x_seq.shape[1:]) if need_dv0 else None


def lif_bwd(
    x_seq: torch.Tensor,
    v_init: Optional[torch.Tensor],
    grad_spikes: torch.Tensor,
    params: NeuronParams = NeuronParams(),
    need_dv0: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Multi-step LIF backward: (x, v_init, dL/dspikes) -> (dX, dV0).

    fp32, contiguous. dV0 is None unless ``need_dv0``. Without ``v_init``
    the kernel starts from v_reset and reads no initial membrane, and
    without ``need_dv0`` it writes no dV0. A CPU tensor takes
    :func:`lif_bwd_reference`; a CUDA tensor launches the kernel or
    raises (also for a surrogate family other than atan and sigmoid).
    """
    global LAUNCHES_BWD
    _bwd_shapes(x_seq, grad_spikes)
    if x_seq.device.type == "cpu":
        return lif_bwd_reference(x_seq, v_init, grad_spikes, params, need_dv0)
    if not x_seq.is_cuda:
        raise ValueError(f"lif_bwd runs on CUDA or CPU, not {x_seq.device}")
    if not (x_seq.is_contiguous() and grad_spikes.is_contiguous()):
        raise ValueError("lif_bwd needs contiguous inputs")
    args = neuron_args(params)
    t_steps = x_seq.shape[0]
    m = x_seq[0].numel()
    dev = x_seq.device
    v0 = None if v_init is None else _initial_membrane(x_seq, v_init, params).contiguous()
    gx = torch.empty_like(x_seq)
    gv0 = torch.empty((m,), dtype=torch.float32, device=dev) if need_dv0 else None
    hs = (torch.empty((t_steps, m), dtype=torch.float32, device=dev)
          if t_steps > register_steps(SOURCE_BWD) else None)
    fn = _kernel_bwd()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x_seq.data_ptr(), data_ptr(v0), grad_spikes.data_ptr(), gx.data_ptr(),
                data_ptr(gv0), data_ptr(hs), t_steps, m, *args, stream)
    if rc != 0:
        raise RuntimeError(f"lif_bwd_f32 launch failed: CUDA error {rc}")
    LAUNCHES_BWD += 1
    return gx, None if gv0 is None else gv0.reshape(x_seq.shape[1:])


class _LIF(torch.autograd.Function):
    """(T, M) fp32 input and (M,) initial membrane or None (v_reset) ->
    (T, M) spikes, with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, x2d, v0, params, reference):
        fwd = lif_fwd_reference if reference else lif_fwd
        s, _ = fwd(x2d, v0, params)
        ctx.save_for_backward(x2d, v0)
        ctx.params, ctx.reference = params, reference
        return s

    @staticmethod
    def backward(ctx, grad_s):
        x2d, v0 = ctx.saved_tensors
        bwd = lif_bwd_reference if ctx.reference else lif_bwd
        gx, gv0 = bwd(x2d, v0, grad_s.contiguous(), ctx.params,
                      need_dv0=ctx.needs_input_grad[1])
        return gx, gv0, None, None


def lif(
    x_seq: torch.Tensor,
    v_init: Optional[torch.Tensor] = None,
    params: NeuronParams = NeuronParams(),
    reference: bool = False,
) -> torch.Tensor:
    """Differentiable multi-step LIF: (T, ...) -> spikes in the input dtype.

    The forward is :func:`lif_fwd`, the gradient :func:`lif_bwd`; with
    ``reference`` their plain versions on either device. bf16 input is
    cast up to fp32 before the kernel and its gradient cast back, as JAX
    ``lif_fused`` does outside its ``custom_vjp``. A ``v_init`` that
    needs no gradient gets none.
    """
    if x_seq.ndim < 1 or x_seq.numel() == 0:
        raise ValueError(f"need a non-empty (T, ...) input, got {tuple(x_seq.shape)}")
    if x_seq.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"lif takes float32 or bfloat16, got {x_seq.dtype}")
    t_steps = x_seq.shape[0]
    x2d = x_seq.reshape(t_steps, -1).float().contiguous()
    v0 = None if v_init is None else _initial_membrane(x_seq, v_init, params).contiguous()
    s = _LIF.apply(x2d, v0, params, reference)
    return s.reshape(x_seq.shape).to(x_seq.dtype)
