"""Absorbing discrete diffusion over the VQ code grid: training loss and
reverse sampler.

Counterpart of ``spiking_diffusion_tpu/models/diffusion.py``, with the
mask token ``cfg.mask_id`` (by default K itself, the CLI's ``--mask
codebook_size``; :func:`pick_mask_id` has the other modes).

Training (:func:`train_loss`): draw t uniform in {1..T} per sample, mask
each token with probability t/T, and score the denoiser's logits at the
masked positions by the reweighted ELBO (or the ELBO). Sampling
(:func:`sample`): starting from an all-mask grid, each step runs the
denoiser, draws a token per position and reveals a subset of the
still-masked positions.

The random draws are injectable, so both can be held against the JAX
functions fed the same numbers. :func:`q_sample` takes its uniforms ``u``
(N, h, w); the training step can take a whole drawn corruption. A sampler
step takes ``u`` (N, h, w), uniform in [0, 1), and ``g`` (N, h, w, K),
standard Gumbel. ``jax.random.categorical`` is ``argmax(logits +
gumbel)``, so the draw here is ``argmax(logits / temperature + g)``; the
random reveal is ``u < p``.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from spiking_diffusion_tpu_torch.config import DiffusionConfig
from spiking_diffusion_tpu_torch.device import resolve_device

# denoise_fn: (tokens (N, h, w) int, t (N,) int) -> logits (N, h, w, K)
DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
StepNoise = Tuple[torch.Tensor, torch.Tensor]  # (u, g) of one step

# (x_t, t, pt, x_0_ignore) of one batch
Corruption = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

UNMASK_MODES = ("random", "confidence")
SPACINGS = ("linear", "cosine")
LOSS_TYPES = ("reweighted_elbo", "elbo")
MASK_MODES = ("codebook_size", "max", "min")


def sample_time(batch: int, num_timesteps: int, generator: torch.Generator,
                device) -> Tuple[torch.Tensor, torch.Tensor]:
    """t ~ Uniform{1..T} per sample (int32) and pt = 1/T (fp32)."""
    t = torch.randint(1, num_timesteps + 1, (batch,), generator=generator,
                      device=device, dtype=torch.int32)
    pt = torch.full((batch,), 1.0 / num_timesteps, dtype=torch.float32,
                    device=device)
    return t, pt


def q_sample(x_0: torch.Tensor, t: torch.Tensor, mask_id: int,
             num_timesteps: int, u: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Mask each token of x_0 (N, h, w) where ``u < t/T`` (u uniform in
    [0, 1), (N, h, w)); returns (x_t, x_0_ignore, mask), the targets of
    unmasked positions set to -1."""
    prob = (t.float() / num_timesteps)[:, None, None]
    mask = u < prob
    x_t = torch.where(mask, torch.full_like(x_0, mask_id), x_0)
    x_0_ignore = torch.where(mask, x_0, torch.full_like(x_0, -1))
    return x_t, x_0_ignore, mask


def masked_cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-sample sum of token cross-entropy over (h, w), ignoring
    targets == -1. logits (N, h, w, K); targets (N, h, w) in [-1, K)."""
    valid = targets >= 0
    safe = torch.clamp(targets, min=0).long()
    logp = torch.log_softmax(logits, dim=-1)
    tok_ce = -torch.gather(logp, -1, safe[..., None])[..., 0]
    tok_ce = torch.where(valid, tok_ce, torch.zeros_like(tok_ce))
    return torch.sum(tok_ce, dim=(1, 2))


def corrupt(x_0: torch.Tensor, cfg: DiffusionConfig,
            generator: torch.Generator) -> Corruption:
    """Draw the training corruption of a batch: (x_t, t, pt, x_0_ignore),
    t and the masking uniforms from ``generator`` (on x_0's device)."""
    t, pt = sample_time(x_0.shape[0], cfg.num_timesteps, generator, x_0.device)
    u = torch.rand(x_0.shape, generator=generator, device=x_0.device)
    x_t, x_0_ignore, _ = q_sample(x_0, t, cfg.mask_id, cfg.num_timesteps, u)
    return x_t, t, pt, x_0_ignore


def per_sample_loss(denoise_fn: DenoiseFn, x_t: torch.Tensor, t: torch.Tensor,
                    pt: torch.Tensor, x_0_ignore: torch.Tensor,
                    cfg: DiffusionConfig) -> torch.Tensor:
    """(N,) loss of a drawn corruption: 'reweighted_elbo' is
    (1 - t/T) * CE / (ln 2 * D), 'elbo' CE / t / pt / (ln 2 * D), with D
    the positions of a grid."""
    if cfg.loss_type not in LOSS_TYPES:
        raise ValueError(f"unknown loss_type {cfg.loss_type!r}")
    d = x_t.shape[1] * x_t.shape[2]
    ce = masked_cross_entropy(denoise_fn(x_t, t), x_0_ignore)
    tf = t.float()
    if cfg.loss_type == "elbo":
        return ce / tf / pt / (math.log(2) * d)
    return (1.0 - tf / cfg.num_timesteps) * ce / (math.log(2) * d)


def train_loss(denoise_fn: DenoiseFn, x_0: torch.Tensor, cfg: DiffusionConfig,
               generator: Optional[torch.Generator] = None,
               corruption: Optional[Corruption] = None) -> torch.Tensor:
    """Scalar training loss of a batch of code grids (N, h, w): the mean
    of :func:`per_sample_loss` over a corruption drawn from ``generator``,
    or the given ``corruption``."""
    if corruption is None:
        if generator is None:
            raise ValueError("pass a torch.Generator or a drawn corruption")
        corruption = corrupt(x_0, cfg, generator)
    return torch.mean(per_sample_loss(denoise_fn, *corruption, cfg))


def pick_mask_id(mode: str, num_embeddings: int, first_batch: torch.Tensor) -> int:
    """The mask token: 'codebook_size' K itself; 'max' the most common
    code of ``first_batch``; 'min' the least common code that occurs in
    it (the JAX package's reading of the reference's 'min'). Ties go to
    the smallest code."""
    if mode not in MASK_MODES:
        raise ValueError(f"unknown mask mode {mode!r}")
    if mode == "codebook_size":
        return int(num_embeddings)
    counts = torch.bincount(first_batch.reshape(-1).long(),
                            minlength=num_embeddings)[:num_embeddings]
    if mode == "max":
        return int(torch.argmax(counts))
    big = torch.iinfo(torch.int64).max
    return int(torch.argmin(torch.where(counts > 0, counts, torch.full_like(counts, big))))


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
