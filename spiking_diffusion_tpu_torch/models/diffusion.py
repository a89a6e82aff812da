"""Reverse sampler of the absorbing discrete diffusion prior.

Counterpart of ``spiking_diffusion_tpu/models/diffusion.py`` ``sample``,
with the mask token ``cfg.mask_id`` (by default K itself, the CLI's
``--mask codebook_size``). Starting from an all-mask grid, each step
runs the denoiser, draws a token per position and reveals a subset of
the still-masked positions.

The random draws are injectable, so the sampler can be held against the
JAX one fed the same numbers: a step takes ``u`` (N, h, w), uniform in
[0, 1), and ``g`` (N, h, w, K), standard Gumbel. ``jax.random.categorical``
is ``argmax(logits + gumbel)``, so the draw here is
``argmax(logits / temperature + g)``; the random reveal is ``u < p``.
"""

from __future__ import annotations

from typing import Callable, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from spiking_diffusion_tpu_torch.config import DiffusionConfig
from spiking_diffusion_tpu_torch.device import resolve_device

# denoise_fn: (tokens (N, h, w) int, t (N,) int) -> logits (N, h, w, K)
DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
StepNoise = Tuple[torch.Tensor, torch.Tensor]  # (u, g) of one step

UNMASK_MODES = ("random", "confidence")
SPACINGS = ("linear", "cosine")


def schedule(
    cfg: DiffusionConfig,
    sample_steps: Optional[int] = None,
    spacing: str = "linear",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(t_input int32, p_unmask float32, n_reveal int32), one entry per step.

    ``sample_steps < num_timesteps`` visits a strided subset of the
    timesteps with renormalised unmask probabilities; with the full count
    p is exactly 1/t at input t.
    """
    if spacing not in SPACINGS:
        raise ValueError(f"unknown spacing {spacing!r}")
    h = cfg.latent_size
    big_t = cfg.num_timesteps
    steps = big_t if sample_steps is None else min(int(sample_steps), big_t)
    if steps >= 2:
        u = np.linspace(0.0, 1.0, steps)
        frac = np.cos(0.5 * np.pi * u) if spacing == "cosine" else 1.0 - u
        ts = np.unique(
            np.round(1.0 + frac * (big_t - 1.0)).astype(np.int64))[::-1]
        ts[-1] = 1
    else:
        ts = np.asarray([1], np.int64)
    prev = np.concatenate([[big_t + 1], ts[:-1]])
    t_input = (prev - 1).astype(np.int64)
    p_unmask = (t_input - ts + 1).astype(np.float32) / t_input.astype(np.float32)
    d = h * h
    tgt = np.round(d * (ts - 1) / big_t).astype(np.int64)
    n_reveal = np.concatenate([[d], tgt[:-1]]) - tgt
    return (t_input.astype(np.int32), p_unmask.astype(np.float32),
            n_reveal.astype(np.int32))


def draw_noise(
    cfg: DiffusionConfig,
    n_samples: int,
    steps: int,
    generator: torch.Generator,
    device,
) -> Iterator[StepNoise]:
    """Yield ``steps`` pairs (u, g) drawn from ``generator`` on ``device``."""
    h = cfg.latent_size
    tiny = torch.finfo(torch.float32).tiny
    for _ in range(steps):
        u = torch.rand((n_samples, h, h), generator=generator, device=device)
        ug = torch.rand((n_samples, h, h, cfg.num_embeddings),
                        generator=generator, device=device)
        yield u, -torch.log(-torch.log(ug.clamp_(min=tiny)))


def sample(
    denoise_fn: DenoiseFn,
    cfg: DiffusionConfig,
    n_samples: int,
    noise: Iterable[StepNoise],
    temperature: float = 1.0,
    sample_steps: Optional[int] = None,
    unmask_mode: str = "random",
    choice_temperature: float = 1.0,
    spacing: str = "linear",
    device="cuda",
) -> torch.Tensor:
    """All-mask start, progressive unmasking; returns (N, h, w) int32 codes.

    Runs on the card unless ``device="cpu"`` is passed. ``noise`` yields
    one (u, g) pair per step of :func:`schedule`. In
    'confidence' mode, u feeds the Gumbel noise of the reveal order
    (the JAX sampler's ``uniform(minval=1e-20)`` of the same bits).
    """
    if unmask_mode not in UNMASK_MODES:
        raise ValueError(f"unknown unmask_mode {unmask_mode!r}")
    device = resolve_device(device)
    h = cfg.latent_size
    big_t = cfg.num_timesteps
    t_input, p_unmask, n_reveal = schedule(cfg, sample_steps, spacing)
    x_t = torch.full((n_samples, h, h), cfg.mask_id, dtype=torch.int32,
                     device=device)
    unmasked = torch.zeros((n_samples, h, h), dtype=torch.bool, device=device)
    noise = iter(noise)
    for t_in, p, n_rev in zip(t_input, p_unmask, n_reveal):
        u, g = next(noise)
        t_vec = torch.full((n_samples,), int(t_in), dtype=torch.int32,
                           device=device)
        logits = denoise_fn(x_t, t_vec) / temperature
        x_0_hat = torch.argmax(g + logits, dim=-1).to(torch.int32)
        if unmask_mode == "random":
            changes = (u < float(p)) & ~unmasked
        else:
            logp = torch.log_softmax(logits, dim=-1)
            tok_logp = torch.gather(logp, -1, x_0_hat.long()[..., None])[..., 0]
            uc = torch.clamp(u + 1e-20, min=1e-20)
            gumbel = -torch.log(-torch.log(uc))
            anneal = float(np.float32(choice_temperature)
                           * (np.float32(t_in) / np.float32(big_t)))
            conf = tok_logp + anneal * gumbel
            conf = torch.where(unmasked, -torch.inf, conf)
            order = torch.argsort(-conf.reshape(n_samples, -1), dim=-1,
                                  stable=True)
            rank = torch.argsort(order, dim=-1, stable=True)
            changes = (rank < int(n_rev)).reshape(n_samples, h, h)
        unmasked = unmasked | changes
        x_t = torch.where(changes, x_0_hat, x_t)
    return x_t
