"""Attention blocks for spike trains (spikingjelly ``layer.py``).

Counterparts of ``spiking_diffusion_tpu/models/attention.py``:
``TemporalWiseAttention`` (Yao et al.) squeezes every feature axis per
timestep by mean and max, passes both through one bias-free bottleneck
(``fc1``, ``fc2``) and gates each step by the sigmoid of their sum;
``MultiDimensionalAttention`` (MA-SNN) applies that gating along T, then
the channels (``ca_fc1``, ``ca_fc2``), then space (``sa_conv``, a k x k
bias-free conv on the stacked channel mean and max). Inputs are JAX's
(T, N, ...) and (T, N, H, W, C); weights are PyTorch's (Linear (out,
in), Conv (O, I, kh, kw)).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class TemporalWiseAttention(nn.Module):
    """(T, N, ...) -> (T, N, ...) with per-timestep sigmoid gates."""

    def __init__(self, num_steps: int, reduction: int = 16):
        super().__init__()
        hidden = max(num_steps // reduction, 1)
        self.fc1 = nn.Linear(num_steps, hidden, bias=False)
        self.fc2 = nn.Linear(hidden, num_steps, bias=False)

    def _mlp(self, v: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.relu(self.fc1(v)))

    def forward(self, x_seq: torch.Tensor) -> torch.Tensor:
        t, n = x_seq.shape[:2]
        flat = x_seq.reshape(t, n, -1)
        avg, mx = flat.mean(-1), flat.amax(-1)  # (T, N)
        scores = torch.sigmoid(self._mlp(avg.T) + self._mlp(mx.T))  # (N, T)
        return x_seq * scores.T.reshape((t, n) + (1,) * (x_seq.ndim - 2))


class MultiDimensionalAttention(nn.Module):
    """Temporal, channel and spatial attention (MA-SNN) of (T, N, H, W, C)
    spike trains."""

    def __init__(self, num_steps: int, channels: int, reduction_t: int = 16,
                 reduction_c: int = 16, kernel_size: int = 3):
        super().__init__()
        self.ta = TemporalWiseAttention(num_steps, reduction_t)
        hidden = max(channels // reduction_c, 1)
        self.ca_fc1 = nn.Linear(channels, hidden, bias=False)
        self.ca_fc2 = nn.Linear(hidden, channels, bias=False)
        self.sa_conv = nn.Conv2d(2, 1, kernel_size, padding=kernel_size // 2, bias=False)

    def forward(self, x_seq: torch.Tensor) -> torch.Tensor:
        x_seq = self.ta(x_seq)
        avg_c, max_c = x_seq.mean((0, 2, 3)), x_seq.amax((0, 2, 3))  # (N, C)
        ca = torch.sigmoid(self.ca_fc2(F.relu(self.ca_fc1(avg_c)))
                           + self.ca_fc2(F.relu(self.ca_fc1(max_c))))
        x_seq = x_seq * ca[None, :, None, None, :]
        sa_in = torch.stack([x_seq.mean((0, 4)), x_seq.amax((0, 4))], dim=1)  # (N, 2, H, W)
        sa = torch.sigmoid(self.sa_conv(sa_in)).permute(0, 2, 3, 1)  # (N, H, W, 1)
        return x_seq * sa[None]
