"""Conv-BN folding for inference.

Counterpart of ``spiking_diffusion_tpu/snn/functional.py`` ``fuse_conv_bn``,
kept as the port's own copy.
"""

from __future__ import annotations

from typing import Tuple

import torch


def fuse_conv_bn(
    weight: torch.Tensor,
    bias: torch.Tensor,
    bn_scale: torch.Tensor,
    bn_bias: torch.Tensor,
    bn_mean: torch.Tensor,
    bn_var: torch.Tensor,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold eval-mode BN(conv(x)) into one conv, in fp32.

    ``weight`` is (Cout, Cin, kh, kw), the BN tensors are per Cout.
    ``s = gamma / sqrt(var + eps)``, ``w' = w * s``, ``b' = (b - mean) * s
    + beta``: the JAX package's operations in its order. The square root
    is taken in fp64 and rounded to fp32, which is the correctly rounded
    fp32 root (XLA's); PyTorch's fp32 ``sqrt`` on the CPU is not always.
    """
    s = bn_scale.float() / torch.sqrt((bn_var.float() + eps).double()).float()
    w = weight.float() * s.reshape((-1,) + (1,) * (weight.ndim - 1))
    return w, (bias.float() - bn_mean.float()) * s + bn_bias.float()
