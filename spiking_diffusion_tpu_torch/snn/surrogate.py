"""Spike function and the surrogate families the neurons carry.

The forward pass is the exact Heaviside step at ``x >= 0`` (spikingjelly
``surrogate.heaviside``); the backward pass is ``g * grad(x)``, the
family's smooth derivative (JAX ``snn/surrogate.py`` ``spike_fn``).
``SurrogateFn.grad`` is the one source of that derivative: the spike
function's backward, the LIF kernels' plain versions and the constants
handed to the CUDA kernels all follow it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

FAMILIES = ("atan", "sigmoid")


def heaviside(x: torch.Tensor) -> torch.Tensor:
    """1 where x >= 0, else 0, in the dtype of ``x``."""
    return (x >= 0).to(x.dtype)


def atan_constants(alpha: float) -> Tuple[float, float]:
    """The two Python-float factors of :func:`atan_grad`, formed before
    they meet the tensor (as JAX forms them): (pi/2 * alpha, alpha/2)."""
    return (math.pi / 2.0) * alpha, alpha / 2.0


def atan_grad(x: torch.Tensor, alpha: float = 2.0) -> torch.Tensor:
    """d/dx of (1/pi) * arctan(pi/2 * alpha * x) + 1/2, in JAX's order:
    ``u = (pi/2 * alpha) * x``, then ``(alpha/2) / (1 + u*u)``."""
    c_u, c_g = atan_constants(alpha)
    u = c_u * x
    # a 0-dim numerator: ``float / tensor`` is ``reciprocal * float`` in
    # PyTorch, one rounding more than the IEEE division the kernels do
    return torch.tensor(c_g, dtype=x.dtype, device=x.device) / (1.0 + u * u)


def sigmoid_grad(x: torch.Tensor, alpha: float = 4.0) -> torch.Tensor:
    """Derivative of sigmoid(alpha*x): ``alpha * s * (1 - s)``."""
    s = torch.sigmoid(alpha * x)
    return alpha * s * (1.0 - s)


_GRADS = {"atan": atan_grad, "sigmoid": sigmoid_grad}


class _Spike(torch.autograd.Function):
    """Heaviside forward, surrogate-gradient backward."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.save_for_backward(x)
        ctx.fn = fn
        return heaviside(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * ctx.fn.grad(x), None


@dataclasses.dataclass(frozen=True)
class SurrogateFn:
    """A named surrogate family with its shape parameter.

    Calling it gives the spike with the surrogate gradient attached;
    ``grad`` is the raw derivative formula.
    """

    name: str = "atan"
    alpha: float = 2.0

    def grad(self, x: torch.Tensor) -> torch.Tensor:
        return _GRADS[self.name](x, self.alpha)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return _Spike.apply(x, self)


atan = SurrogateFn("atan", 2.0)
sigmoid = SurrogateFn("sigmoid", 4.0)


def get_surrogate(name: str, alpha: float) -> SurrogateFn:
    if name not in FAMILIES:
        raise ValueError(f"unknown surrogate {name!r}; have {list(FAMILIES)}")
    return SurrogateFn(name, float(alpha))
