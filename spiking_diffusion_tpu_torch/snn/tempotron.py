"""Timing-based (latency-coding) SNN pieces (spikingjelly ``timing_based/``).

Counterparts of ``spiking_diffusion_tpu/snn/tempotron.py``: the Tempotron's
double-exponential PSP kernel, a Gaussian tuning-curve latency encoder,
the membrane trace on a time grid and the peak-membrane classifier.
"""

from __future__ import annotations

from typing import Tuple

import torch


def psp_kernel(t: torch.Tensor, t_spike: torch.Tensor, tau: float = 15.0,
               tau_s: float = 15.0 / 4) -> torch.Tensor:
    """v0 (exp(-dt/tau) - exp(-dt/tau_s)) for dt = t - t_spike >= 0, else 0,
    v0 normalising the peak to 1."""
    dt = t - t_spike
    v0 = 1.0 / ((tau_s / tau) ** (tau_s / (tau - tau_s))
                - (tau_s / tau) ** (tau / (tau - tau_s)))
    k = v0 * (torch.exp(-dt / tau) - torch.exp(-dt / tau_s))
    return torch.where(dt >= 0, k, torch.zeros_like(k))


def gaussian_tuning_encode(x: torch.Tensor, n_neurons: int, t_max: float, x_min: float,
                           x_max: float) -> torch.Tensor:
    """Each feature of (..., F) drives ``n_neurons`` Gaussian tuning curves
    with centres over [x_min, x_max]; a response r in [0, 1] spikes at
    t_max (1 - r). Returns spike times (..., F, n_neurons)."""
    if n_neurons <= 2:
        raise ValueError(
            f"gaussian_tuning_encode needs n_neurons > 2 (got {n_neurons}): "
            "the reference tuning-curve spacing divides by (m - 2)")
    i = torch.arange(1, n_neurons + 1, dtype=torch.float32, device=x.device)
    mu = x_min + (2 * i - 3) / 2 * (x_max - x_min) / (n_neurons - 2)
    sigma = (x_max - x_min) / (1.5 * (n_neurons - 2))
    r = torch.exp(-((x[..., None] - mu) ** 2) / (2 * sigma ** 2))
    return t_max * (1.0 - r)


def tempotron_v(weights: torch.Tensor, t_spikes: torch.Tensor, t_grid: torch.Tensor,
                tau: float = 15.0) -> torch.Tensor:
    """Membrane trace v(t) = sum_i w_i K(t - t_i) on a (n_t,) time grid."""
    return psp_kernel(t_grid[:, None], t_spikes[None, :], tau) @ weights


def tempotron_classify(weights: torch.Tensor, t_spikes: torch.Tensor, t_grid: torch.Tensor,
                       v_threshold: float = 1.0,
                       tau: float = 15.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Peak membrane per class of (classes, n_in) weights on (batch, n_in)
    spike times: (v_peak (batch, classes), argmax predictions (batch,))."""
    k = psp_kernel(t_grid[None, :, None], t_spikes[:, None, :], tau)  # (B, n_t, n_in)
    v_peak = torch.einsum("btn,cn->btc", k, weights).amax(dim=1)
    return v_peak, torch.argmax(v_peak, dim=1)
