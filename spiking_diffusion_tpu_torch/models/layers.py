"""Step-aware layers over time-folded (T*N, C, H, W) tensors.

Counterparts of ``spiking_diffusion_tpu/models/layers.py``. The JAX
package keeps (T, N, H, W, C) and folds T into the batch around each
stateless layer (``seq_apply``); the port keeps T folded all the way,
in PyTorch's NCHW, so row t*N + n holds step t of sample n. Convolutions
are ``conv2d``/``conv_transpose2d`` with torch padding semantics.
BatchNorm has the JAX package's arithmetic, ``(x - mean) * (rsqrt(var +
eps) * scale) + bias`` in fp32, which ``nn.BatchNorm2d`` does not
promise, and the JAX package's training statistics (fast variance, the
biased variance in the running update), which ``nn.BatchNorm2d`` does
not have.

``dtype`` (None or ``torch.bfloat16``) has the JAX package's meaning: a
conv casts its input and its fp32 parameters to it; BatchNorm computes in
fp32 and casts only its normalised output.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from spiking_diffusion_tpu_torch.ops.spike_conv import spike_conv3x3
from spiking_diffusion_tpu_torch.snn.neuron import NeuronParams, lif_multi_step


class SeqConv(nn.Module):
    """Conv2d over a time-folded sequence; weight (Cout, Cin, kH, kW).

    With ``dtype`` the input, weight and bias are cast to it and the bias
    is added to the conv's rounded output, as flax's ``nn.Conv(dtype=)``
    does. ``fused_train=True`` (3x3, stride 1, padding 1 only) runs the
    conv through K4 (``ops/spike_conv.py``; its plain versions with
    ``reference``) and returns ``(y, s1, s2)``, the per-channel BN moments
    of y, for ``SeqBatchNorm(moments=...)``; the parameters are the same
    under the same names, so a state dict serves either path.
    """

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 stride: int = 1, padding: int = 0,
                 dtype: Optional[torch.dtype] = None, fused_train: bool = False,
                 reference: bool = False):
        super().__init__()
        if fused_train and (kernel_size, stride, padding) != (3, 1, 1):
            raise ValueError("fused_train supports 3x3 / stride 1 / pad 1 only")
        self.stride = stride
        self.padding = padding
        self.dtype = dtype
        self.fused_train = fused_train
        self.reference = reference
        self.weight = nn.Parameter(
            torch.zeros(out_ch, in_ch, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_ch))

    def forward(self, x: torch.Tensor, with_moments: bool = True):
        if self.dtype is not None:
            x = x.to(self.dtype)
        if self.fused_train:
            return spike_conv3x3(x, self.weight, self.bias, with_moments,
                                 self.reference)
        if self.dtype is None:
            return F.conv2d(x, self.weight, self.bias, self.stride, self.padding)
        y = F.conv2d(x, self.weight.to(self.dtype), None, self.stride, self.padding)
        return y + self.bias.to(self.dtype).reshape(1, -1, 1, 1)


class SeqConvTranspose(nn.Module):
    """ConvTranspose2d over a time-folded sequence; weight (Cin, Cout, kH, kW).

    Output size (H - 1) * stride - 2 * padding + kernel + output_padding.
    """

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, output_padding: int = 0):
        super().__init__()
        self.stride = stride
        self.padding = padding
        self.output_padding = output_padding
        self.weight = nn.Parameter(
            torch.zeros(in_ch, out_ch, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.weight, self.bias, self.stride,
                                  self.padding, self.output_padding)


class SeqBatchNorm(nn.Module):
    """BatchNorm over channel axis 1 of (T*N, C, H, W).

    Counterpart of JAX ``models/layers.py`` ``SeqBatchNorm`` and its
    ``BatchNorm``. In training mode the statistics are those of the batch,
    over T*N*H*W jointly per channel, in fp32: the mean and the fast
    variance ``max(0, E[x^2] - E[x]^2)``, left in the autograd graph so
    that gradients reach x through them; the running statistics move to
    ``0.9 * running + 0.1 * batch`` with the biased variance. In eval mode
    the running statistics are used.

    ``return_affine=True`` returns the per-channel ``(scale_eff,
    shift_eff) = (scale * rsqrt(var + eps), bias - mean * scale_eff)``
    instead of the normalised tensor, for the fused BN-apply + LIF kernel
    (``ops/bn_lif.py``), in fp32. ``moments=(s1, s2, count)`` in training
    mode takes the statistics from a producer's per-channel sums (K4,
    ``ops/spike_conv.py``): mean = s1 / count, E[x^2] = s2 / count, kept in
    the autograd graph so that their gradients reach the producer. With
    ``dtype`` the normalised output is cast to it.
    """

    momentum = 0.9  # flax's convention: running = momentum * running + (1 - momentum) * batch

    def __init__(self, channels: int, eps: float = 1e-5,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def _statistics(self, x: torch.Tensor, moments=None):
        if not self.training:
            return self.mean, self.var
        if moments is not None:
            s1, s2, count = moments
            mean = s1.float() / count
            msq = s2.float() / count
        else:
            xf = x.float()
            dims = [d for d in range(x.ndim) if d != 1]
            mean = xf.mean(dims)
            msq = torch.mean(xf * xf, dims)
        var = torch.clamp(msq - mean * mean, min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.mean.copy_(m * self.mean + (1.0 - m) * mean)
            self.var.copy_(m * self.var + (1.0 - m) * var)
        return mean, var

    def forward(self, x: torch.Tensor, return_affine: bool = False, moments=None):
        mean, var = self._statistics(x, moments)
        if return_affine:
            scale_eff = self.scale * torch.rsqrt(var + self.eps)
            return scale_eff, self.bias - mean * scale_eff
        shape = (1, -1) + (1,) * (x.ndim - 2)
        mul = torch.rsqrt(var + self.eps) * self.scale
        y = (x - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)
        return y if self.dtype is None else y.to(self.dtype)


class LIF(nn.Module):
    """LIF spiking activation over a time-folded (T*N, ...) sequence.

    Stateless: the membrane starts at v_reset on every call.
    """

    def __init__(self, params: NeuronParams, num_steps: int,
                 backend: str = "auto"):
        super().__init__()
        self.params = params
        self.num_steps = num_steps
        self.backend = backend

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_seq = x.reshape((self.num_steps, -1) + tuple(x.shape[1:]))
        s_seq = lif_multi_step(x_seq, params=self.params, backend=self.backend)
        return s_seq.reshape(x.shape)
