"""Spike encoders: analog input -> (T, ...) input train.

Counterparts of ``spiking_diffusion_tpu/snn/encoding.py`` (spikingjelly
``activation_based/encoding.py``): ``direct_encode`` repeats the analog
input (what the app uses); ``poisson_encode`` draws Bernoulli(x) per step
from an explicit ``torch.Generator`` (its bits are not ``jax.random``'s);
``periodic_encode``, ``weighted_phase_encode`` and ``latency_encode`` are
deterministic and equal JAX's.
"""

from __future__ import annotations

from typing import Optional

import torch


def direct_encode(x: torch.Tensor, num_steps: int) -> torch.Tensor:
    """Repeat the analog input T times along a new leading axis.

    Returns a broadcast view (stride 0 on T); a consumer that needs the
    T copies in memory calls ``.contiguous()``.
    """
    return x.unsqueeze(0).expand((num_steps,) + tuple(x.shape))


def poisson_encode(generator: Optional[torch.Generator], x: torch.Tensor,
                   num_steps: int) -> torch.Tensor:
    """Rate coding: spike[t] ~ Bernoulli(x) i.i.d. per step, x in [0, 1];
    the uniform draws come from ``generator`` on x's device."""
    u = torch.rand((num_steps,) + tuple(x.shape), generator=generator, dtype=x.dtype,
                   device=x.device)
    return (u < x).to(x.dtype)


def periodic_encode(spike_pattern: torch.Tensor, num_steps: int) -> torch.Tensor:
    """Tile a fixed (T0, ...) spike pattern periodically to T steps
    (spikingjelly ``PeriodicEncoder``)."""
    reps = -(-num_steps // spike_pattern.shape[0])
    return spike_pattern.repeat((reps,) + (1,) * (spike_pattern.ndim - 1))[:num_steps]


def weighted_phase_encode(x: torch.Tensor, num_phases: int) -> torch.Tensor:
    """Weighted phase coding (spikingjelly ``WeightedPhaseEncoder``): x in
    [0, 1 - 2^-K] in binary over K phases, phase k weighing 2^-(k+1).
    Returns (K, ...) spikes."""
    spikes = []
    rest = x
    for k in range(num_phases):
        w = 2.0 ** (-(k + 1))
        s = (rest >= w).to(x.dtype)
        rest = rest - s * w
        spikes.append(s)
    return torch.stack(spikes)


def latency_encode(x: torch.Tensor, num_steps: int) -> torch.Tensor:
    """Latency coding: intensity x spikes once, at t = round((T-1)(1-x))
    (half to even, as ``jnp.round``)."""
    t_spike = torch.round((num_steps - 1) * (1.0 - x)).to(torch.int32)
    t_axis = torch.arange(num_steps, dtype=torch.int32, device=x.device).reshape(
        (-1,) + (1,) * x.ndim)
    return (t_axis == t_spike[None]).to(x.dtype)
