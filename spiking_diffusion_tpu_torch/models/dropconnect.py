"""DropConnect linear layer (spikingjelly ``layer.DropConnectLinear``).

Counterpart of ``spiking_diffusion_tpu/models/dropconnect.py``: in
training the weight and the bias are masked by Bernoulli(1 - p) draws,
two masks from an explicit ``torch.Generator`` (or given), the raw
masked weights used; in eval the keep share (1 - p) scales them, the
expected weight. Weight (out, in), as flax's kernel transposed.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn


class DropConnectLinear(nn.Linear):
    def __init__(self, in_features: int, out_features: int, p: float = 0.5,
                 use_bias: bool = True):
        super().__init__(in_features, out_features, bias=use_bias)
        self.p = p

    def masks(self, generator: Optional[torch.Generator] = None):
        """One draw of the (weight, bias) masks, each Bernoulli(1 - p)."""
        keep = 1.0 - self.p
        draw = lambda t: torch.bernoulli(torch.full_like(t, keep), generator=generator)  # noqa: E731
        return draw(self.weight), None if self.bias is None else draw(self.bias)

    def forward(self, x: torch.Tensor, masks: Optional[Tuple] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        keep = 1.0 - self.p
        if not self.training:
            w = self.weight * keep
            b = None if self.bias is None else self.bias * keep
        else:
            mw, mb = masks if masks is not None else self.masks(generator)
            w = self.weight * mw
            b = None if self.bias is None else self.bias * mb
        y = x @ w.T
        return y if b is None else y + b
