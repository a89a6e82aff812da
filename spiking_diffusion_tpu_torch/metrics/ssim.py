"""Structural similarity (SSIM) with a Gaussian window.

Counterpart of ``spiking_diffusion_tpu/metrics/ssim.py``: window 11, sigma
1.5, a depthwise correlation with zero padding of size // 2, C1 = 0.01^2,
C2 = 0.03^2, the mean over the map. Operates on (N, H, W, C) tensors on
any device, in fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _gaussian_window(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - size // 2
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)  # (size, size)


def _depthwise_filter(img: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Depthwise 2-D correlation of (N, C, H, W) with same-padding (size // 2)."""
    c, k = img.shape[1], window.shape[0]
    kern = window.expand(c, 1, k, k)
    return F.conv2d(img, kern, padding=k // 2, groups=c)


def ssim(
    img1: torch.Tensor,
    img2: torch.Tensor,
    window_size: int = 11,
    sigma: float = 1.5,
) -> torch.Tensor:
    """Mean SSIM between two (N, H, W, C) image batches (a 0-d tensor)."""
    x1 = img1.float().permute(0, 3, 1, 2)
    x2 = img2.float().permute(0, 3, 1, 2)
    w = _gaussian_window(window_size, sigma, x1.device)
    mu1 = _depthwise_filter(x1, w)
    mu2 = _depthwise_filter(x2, w)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _depthwise_filter(x1 * x1, w) - mu1_sq
    sigma2_sq = _depthwise_filter(x2 * x2, w) - mu2_sq
    sigma12 = _depthwise_filter(x1 * x2, w) - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    return torch.mean(ssim_map)
