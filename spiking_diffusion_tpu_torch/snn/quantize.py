"""Straight-through quantization ops (spikingjelly ``quantize.py``).

Counterpart of ``spiking_diffusion_tpu/snn/quantize.py``: round, ceil and
floor with an identity gradient, clamp with the gradient passed only
inside the window, and k-bit quantization built on them, each a
``torch.autograd.Function`` where JAX has a ``custom_vjp``.
"""

from __future__ import annotations

import torch


def _ste(fwd_fn):
    class _Ste(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return fwd_fn(x)

        @staticmethod
        def backward(ctx, g):
            return g

    return _Ste.apply


round_ste = _ste(torch.round)
ceil_ste = _ste(torch.ceil)
floor_ste = _ste(torch.floor)


class _ClampSte(torch.autograd.Function):
    """clamp(x, lo, hi); the gradient passes where lo <= x <= hi."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.lo, ctx.hi = lo, hi
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * ((x >= ctx.lo) & (x <= ctx.hi)).to(g.dtype), None, None


def clamp_ste(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    return _ClampSte.apply(x, lo, hi)


def k_bit_quantize(x: torch.Tensor, k: int) -> torch.Tensor:
    """x in [0, 1] to 2^k - 1 levels, straight-through."""
    levels = float(2 ** k - 1)
    return round_ste(x * levels) / levels


def affine_quantize(x: torch.Tensor, k: int, lo: float, hi: float) -> torch.Tensor:
    """x in [lo, hi] to k bits: normalise, quantize, denormalise."""
    xn = (clamp_ste(x, lo, hi) - lo) / (hi - lo)
    return k_bit_quantize(xn, k) * (hi - lo) + lo
