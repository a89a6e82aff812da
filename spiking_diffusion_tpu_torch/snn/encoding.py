"""Spike encoders: analog input -> (T, ...) input train."""

from __future__ import annotations

import torch


def direct_encode(x: torch.Tensor, num_steps: int) -> torch.Tensor:
    """Repeat the analog input T times along a new leading axis.

    Returns a broadcast view (stride 0 on T); a consumer that needs the
    T copies in memory calls ``.contiguous()``.
    """
    return x.unsqueeze(0).expand((num_steps,) + tuple(x.shape))
