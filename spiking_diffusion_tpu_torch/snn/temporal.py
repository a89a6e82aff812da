"""Membrane readout over the leading T axis.

``membrane_output`` is the leaky readout out = sum_t decay^(T-1-t) * x[t]
(reference ``snn_model/snn_layers.py:28-41``).
"""

from __future__ import annotations

import torch


def membrane_output_coef(
    num_steps: int, decay: float = 0.8, dtype=torch.float32, device=None
) -> torch.Tensor:
    """(T,) readout weights decay^(T-1-t)."""
    arr = torch.arange(num_steps - 1, -1, -1, dtype=dtype, device=device)
    return torch.pow(torch.tensor(decay, dtype=dtype, device=device), arr)


def membrane_output(x_seq: torch.Tensor, decay: float = 0.8) -> torch.Tensor:
    """Leaky membrane readout of a (T, ...) tensor, summed over axis 0."""
    coef = membrane_output_coef(x_seq.shape[0], decay, x_seq.dtype,
                                x_seq.device)
    coef = coef.reshape((-1,) + (1,) * (x_seq.ndim - 1))
    return torch.sum(x_seq * coef, dim=0)
