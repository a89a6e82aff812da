"""Spike function and the surrogate families the neurons carry.

The forward pass is the exact Heaviside step at ``x >= 0`` (spikingjelly
``surrogate.heaviside``); the backward pass is ``g * grad(x)``, the
family's smooth derivative (JAX ``snn/surrogate.py`` ``spike_fn``).
``SurrogateFn.grad`` is the one source of that derivative: the spike
function's backward, the LIF kernels' plain versions and the constants
handed to the CUDA kernels all follow it. ``SurrogateFn.primitive`` is
the smooth function a derivative comes from (the finite-difference
self-check :func:`check_surrogate_grad`).

The fourteen families and their formulas are the JAX package's, two of
its quirks included: ``piecewise_leaky_relu``'s primitive has half the
slope of its gradient inside the band, and ``fake_numerical_gradient``
has no primitive. K1 and K3 take ``KERNEL_FAMILIES`` only (atan and
sigmoid); a neuron with another family runs the plain scan.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

# the families the LIF kernels (K1, K3) compute in their backward
KERNEL_FAMILIES = ("atan", "sigmoid")


def heaviside(x: torch.Tensor) -> torch.Tensor:
    """1 where x >= 0, else 0, in the dtype of ``x``."""
    return (x >= 0).to(x.dtype)


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim tensor: ``float / tensor`` is ``reciprocal * float`` in
    PyTorch, one rounding more than the IEEE division JAX does."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


# --- surrogate derivative formulas ---------------------------------------


def atan_constants(alpha: float) -> Tuple[float, float]:
    """The two Python-float factors of :func:`atan_grad`, formed before
    they meet the tensor (as JAX forms them): (pi/2 * alpha, alpha/2)."""
    return (math.pi / 2.0) * alpha, alpha / 2.0


def atan_grad(x: torch.Tensor, alpha: float = 2.0) -> torch.Tensor:
    """d/dx of (1/pi) * arctan(pi/2 * alpha * x) + 1/2, in JAX's order:
    ``u = (pi/2 * alpha) * x``, then ``(alpha/2) / (1 + u*u)``."""
    c_u, c_g = atan_constants(alpha)
    u = c_u * x
    return _scalar(c_g, x) / (1.0 + u * u)


def sigmoid_grad(x: torch.Tensor, alpha: float = 4.0) -> torch.Tensor:
    """Derivative of sigmoid(alpha*x): ``alpha * s * (1 - s)``."""
    s = torch.sigmoid(alpha * x)
    return alpha * s * (1.0 - s)


def piecewise_quadratic_grad(x: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """Triangle-shaped derivative: max(0, -alpha^2*|x| + alpha)."""
    return torch.clamp(-(alpha * alpha) * torch.abs(x) + alpha, min=0.0)


def soft_sign_grad(x: torch.Tensor, alpha: float = 2.0) -> torch.Tensor:
    """alpha / (2 * (1 + alpha|x|)^2)."""
    d = 1.0 + alpha * torch.abs(x)
    return _scalar(alpha, x) / (2.0 * d * d)


def erf_grad(x: torch.Tensor, alpha: float = 2.0) -> torch.Tensor:
    """Derivative of the Gaussian-error-function surrogate."""
    return (alpha / math.sqrt(math.pi)) * torch.exp(-((alpha * x) ** 2))


def leaky_k_relu_grad(x: torch.Tensor, alpha: float = 0.0, k: float = 1.0) -> torch.Tensor:
    """k where x >= 0 else leak (= alpha)."""
    return torch.where(x >= 0, _scalar(k, x), _scalar(alpha, x))


def piecewise_exp_grad(x: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """(alpha/2) * exp(-alpha|x|)."""
    return (alpha / 2.0) * torch.exp(-alpha * torch.abs(x))


def nonzero_sign_log_abs_grad(x: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """1 / (1/alpha + |x|)."""
    return _scalar(1.0, x) / (1.0 / alpha + torch.abs(x))


def piecewise_leaky_relu_grad(x: torch.Tensor, alpha: float = 1.0,
                              beta: float = 0.01) -> torch.Tensor:
    """1/w inside |x| < w (= alpha), c (= beta) outside."""
    w, c = alpha, beta
    return torch.where(torch.abs(x) < w, _scalar(1.0 / w, x), _scalar(c, x))


def squarewave_fourier_series_grad(x: torch.Tensor, alpha: float = 2.0,
                                   beta: float = 8.0) -> torch.Tensor:
    """4/T * sum_{i=1}^{n-1} cos((2i-1) * 2pi/T * x), n = alpha, T = beta."""
    n, t_period = int(alpha), beta
    w = 2.0 * math.pi / t_period
    acc = torch.zeros_like(x)
    for i in range(1, n):
        acc = acc + torch.cos((2 * i - 1.0) * w * x)
    return acc * (4.0 / t_period)


def s2nn_grad(x: torch.Tensor, alpha: float = 4.0, beta: float = 1.0) -> torch.Tensor:
    """alpha*sg*(1-sg) for x < 0, else beta/(x+1)."""
    sg = torch.sigmoid(alpha * x)
    safe = torch.where(x < 0.0, torch.zeros_like(x), x)
    return torch.where(x < 0.0, alpha * sg * (1.0 - sg), _scalar(beta, x) / (safe + 1.0))


def q_pseudo_spike_grad(x: torch.Tensor, alpha: float = 2.0) -> torch.Tensor:
    """(1 + 2|x|/(alpha-1))^(-alpha)."""
    return torch.pow(1.0 + 2.0 / (alpha - 1.0) * torch.abs(x), -alpha)


def fake_numerical_gradient_grad(x: torch.Tensor, alpha: float = 0.3) -> torch.Tensor:
    """min(sign(x)/x, alpha) with sign(0) = +1; no primitive exists."""
    sign = torch.where(x >= 0.0, _scalar(1.0, x), _scalar(-1.0, x))
    return torch.clamp(sign / x, max=alpha)


def log_tailed_relu_grad(x: torch.Tensor, alpha: float = 0.0) -> torch.Tensor:
    """alpha for x <= 0; 1 for 0 < x <= 1; 1/x beyond."""
    safe = torch.clamp(x, min=1.0)
    one = _scalar(1.0, x)
    return torch.where(x <= 0.0, _scalar(alpha, x), torch.where(x > 1.0, one / safe, one))


_GRADS: Dict[str, Callable[..., torch.Tensor]] = {
    "atan": atan_grad,
    "sigmoid": sigmoid_grad,
    "piecewise_quadratic": piecewise_quadratic_grad,
    "soft_sign": soft_sign_grad,
    "erf": erf_grad,
    "leaky_k_relu": leaky_k_relu_grad,
    "piecewise_exp": piecewise_exp_grad,
    "nonzero_sign_log_abs": nonzero_sign_log_abs_grad,
    "piecewise_leaky_relu": piecewise_leaky_relu_grad,
    "squarewave_fourier_series": squarewave_fourier_series_grad,
    "s2nn": s2nn_grad,
    "q_pseudo_spike": q_pseudo_spike_grad,
    "fake_numerical_gradient": fake_numerical_gradient_grad,
    "log_tailed_relu": log_tailed_relu_grad,
}
FAMILIES = tuple(_GRADS)

# families whose gradient takes a second shape parameter, and its default
_TWO_PARAM = {"leaky_k_relu": 1.0, "piecewise_leaky_relu": 0.01,
              "squarewave_fourier_series": 8.0, "s2nn": 1.0}


# --- primitives: the smooth functions the derivatives come from ----------


def _sign01(x):
    return heaviside(x) * 2.0 - 1.0  # +1 for x >= 0 else -1


def _soft_sign(x: torch.Tensor) -> torch.Tensor:
    """x / (1 + |x|), as ``jax.nn.soft_sign``."""
    return x / (torch.abs(x) + 1.0)


_PRIMS: Dict[str, Callable[..., torch.Tensor]] = {
    "atan": lambda x, a: torch.arctan(math.pi / 2 * a * x) / math.pi + 0.5,
    "sigmoid": lambda x, a: torch.sigmoid(a * x),
    "piecewise_quadratic": lambda x, a: (
        (x > 1.0 / a).to(x.dtype)
        + (torch.abs(x) <= 1.0 / a)
        * (-(a ** 2) / 2 * torch.square(x) * torch.sign(x) + a * x + 0.5)),
    "soft_sign": lambda x, a: (_soft_sign(a * x) + 1.0) / 2.0,
    "erf": lambda x, a: torch.special.erfc(-a * x) / 2.0,
    "leaky_k_relu": lambda x, leak, k: torch.where(
        x >= 0, _scalar(k, x), _scalar(leak, x)) * x,
    "piecewise_exp": lambda x, a: (
        heaviside(x) - _sign01(x) * torch.exp(-_sign01(x) * x * a) / 2.0),
    "nonzero_sign_log_abs": lambda x, a: _sign01(x) * torch.log(a * _sign01(x) * x + 1.0),
    # half the gradient's slope inside the band, as JAX's (and the
    # reference's) primitive has it
    "piecewise_leaky_relu": lambda x, w, c: (
        (x < -w) * (c * x + c * w)
        + (x > w) * (c * x - c * w + 1.0)
        + (torch.abs(x) <= w) * (x / (2.0 * w) + 0.5)),
    "squarewave_fourier_series": lambda x, n, t: 0.5 + (2.0 / math.pi) * sum(
        torch.sin((2 * i - 1.0) * (2.0 * math.pi / t) * x) / (2 * i - 1.0)
        for i in range(1, int(n))),
    "s2nn": lambda x, a, b: torch.where(
        x < 0.0, torch.sigmoid(a * x),
        b * torch.log(torch.abs(torch.where(x < 0.0, torch.zeros_like(x), x) + 1.0) + 1e-5)
        + 0.5),
    "q_pseudo_spike": lambda x, a: (
        heaviside(x) - _sign01(x) * 0.5
        * torch.pow(1.0 + 2.0 / (a - 1.0) * x * _sign01(x), 1.0 - a)),
    "log_tailed_relu": lambda x, a: torch.where(
        x > 1.0, torch.log(torch.clamp(x, min=1.0)) + 1.0, torch.where(x > 0.0, x, a * x)),
    # fake_numerical_gradient: numerical only, no primitive
}


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
    """A named surrogate family with its shape parameter(s).

    Calling it gives the spike with the surrogate gradient attached;
    ``grad`` is the raw derivative formula, ``primitive`` the smooth
    function it derives from. ``beta`` is the second parameter of the
    two-parameter families (k, c, T_period or beta in the reference's
    naming).
    """

    name: str = "atan"
    alpha: float = 2.0
    beta: Optional[float] = None

    def _args(self) -> Tuple[float, ...]:
        return (self.alpha,) if self.beta is None else (self.alpha, self.beta)

    def grad(self, x: torch.Tensor) -> torch.Tensor:
        return _GRADS[self.name](x, *self._args())

    def primitive(self, x: torch.Tensor) -> torch.Tensor:
        if self.name not in _PRIMS:
            raise ValueError(f"{self.name} has no primitive (numerical-only family)")
        return _PRIMS[self.name](x, *self._args())

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return _Spike.apply(x, self)


def spike_fn(x: torch.Tensor, name: str = "atan", alpha: float = 2.0,
             beta: Optional[float] = None) -> torch.Tensor:
    """Heaviside forward / surrogate backward spike of family ``name``."""
    return SurrogateFn(name, float(alpha), None if beta is None else float(beta))(x)


# instances with the reference's default parameters
atan = SurrogateFn("atan", 2.0)
sigmoid = SurrogateFn("sigmoid", 4.0)
piecewise_quadratic = SurrogateFn("piecewise_quadratic", 1.0)
soft_sign = SurrogateFn("soft_sign", 2.0)
erf = SurrogateFn("erf", 2.0)
leaky_k_relu = SurrogateFn("leaky_k_relu", 0.0, 1.0)  # (leak, k)
piecewise_exp = SurrogateFn("piecewise_exp", 1.0)
nonzero_sign_log_abs = SurrogateFn("nonzero_sign_log_abs", 1.0)
piecewise_leaky_relu = SurrogateFn("piecewise_leaky_relu", 1.0, 0.01)  # (w, c)
squarewave_fourier_series = SurrogateFn("squarewave_fourier_series", 2.0, 8.0)  # (n, T)
s2nn = SurrogateFn("s2nn", 4.0, 1.0)
q_pseudo_spike = SurrogateFn("q_pseudo_spike", 2.0)
fake_numerical_gradient = SurrogateFn("fake_numerical_gradient", 0.3)
log_tailed_relu = SurrogateFn("log_tailed_relu", 0.0)


def get_surrogate(name: str, alpha: float, beta: Optional[float] = None) -> SurrogateFn:
    """The family ``name``; a two-parameter family without ``beta`` takes
    the reference's default second parameter."""
    if name not in _GRADS:
        raise ValueError(f"unknown surrogate {name!r}; have {sorted(_GRADS)}")
    if beta is None and name in _TWO_PARAM:
        beta = _TWO_PARAM[name]
    return SurrogateFn(name, float(alpha), None if beta is None else float(beta))


def check_surrogate_grad(fn: SurrogateFn, lo: float = -2.0, hi: float = 2.0,
                         n: int = 1024) -> Tuple[float, float]:
    """Finite self-check of a family's gradient against autograd through
    its primitive on the reference's 1024-point grid
    (``check_manual_grad``): returns (max abs error, x where it occurs);
    the caller asserts."""
    xs = torch.from_numpy(np.arange(lo, hi, (hi - lo) / n, dtype=np.float32))
    xg = xs.clone().requires_grad_()
    (auto,) = torch.autograd.grad(fn.primitive(xg).sum(), xg)
    err = torch.abs(fn.grad(xs) - auto)
    idx = int(torch.argmax(err))
    return float(err[idx]), float(xs[idx])
