"""Spike function and the surrogate families the neurons carry.

The forward pass is the exact Heaviside step at ``x >= 0`` (spikingjelly
``surrogate.heaviside``). Generation is inference, so only the forward is
ported; ``SurrogateFn`` keeps the family's name and shape parameter, which
the training slices need for the backward pass.
"""

from __future__ import annotations

import dataclasses

import torch

FAMILIES = ("atan", "sigmoid")


def heaviside(x: torch.Tensor) -> torch.Tensor:
    """1 where x >= 0, else 0, in the dtype of ``x``."""
    return (x >= 0).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class SurrogateFn:
    """A named surrogate family with its shape parameter."""

    name: str = "atan"
    alpha: float = 2.0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return heaviside(x)


atan = SurrogateFn("atan", 2.0)
sigmoid = SurrogateFn("sigmoid", 4.0)


def get_surrogate(name: str, alpha: float) -> SurrogateFn:
    if name not in FAMILIES:
        raise ValueError(f"unknown surrogate {name!r}; have {list(FAMILIES)}")
    return SurrogateFn(name, float(alpha))
