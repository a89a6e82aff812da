"""Generation: sample code grids with the diffusion prior, then decode them.

Counterpart of the JAX package's single-device generation
(``train/stage2.py`` ``sample_codes``, and the CLI's ``gen_chunk``:
``diffusion.sample`` then ``SNNVQVAE.decode_indices``). ``fused=True``
runs each reverse step as one launch of K2, the whole-denoiser kernel
(``ops/fused_denoiser.py``), with fp32, bf16 or int8 weights; the default
is the layerwise denoiser in fp32.
Both entry points run on the card unless ``device="cpu"`` is passed.
Randomness comes from an explicit ``torch.Generator`` on the run's device,
or from per-step noise passed in.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import torch

from spiking_diffusion_tpu_torch.config import DiffusionConfig
from spiking_diffusion_tpu_torch.device import resolve_device
from spiking_diffusion_tpu_torch.models import diffusion
from spiking_diffusion_tpu_torch.models.denoiser import SpikingDenoiser
from spiking_diffusion_tpu_torch.models.vqvae import SNNVQVAE
from spiking_diffusion_tpu_torch.ops.fused_denoiser import make_denoise_fn


@torch.no_grad()
def sample_codes(
    denoiser: SpikingDenoiser,
    cfg: DiffusionConfig,
    n_samples: int = 16,
    temperature: float = 1.0,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Iterable[diffusion.StepNoise]] = None,
    sample_steps: Optional[int] = None,
    unmask_mode: str = "random",
    choice_temperature: float = 1.0,
    spacing: str = "linear",
    device="cuda",
    fused=False,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """(n_samples, h, w) int32 code grids from the reverse sampler.

    Give either ``generator`` (on ``device``) or ``noise``, one (u, g) pair
    per step of :func:`diffusion.schedule`. ``fused`` and ``dtype`` pick
    the denoiser as :func:`ops.fused_denoiser.make_denoise_fn` does. The
    denoiser samples in eval mode (BN from its running statistics, as the
    JAX sampler applies it with ``train=False``), also when it comes
    straight from training; its mode is restored afterwards.
    """
    dev = resolve_device(device)
    if noise is None:
        if generator is None:
            raise ValueError("pass a torch.Generator or the per-step noise")
        steps = len(diffusion.schedule(cfg, sample_steps, spacing)[0])
        noise = diffusion.draw_noise(cfg, n_samples, steps, generator, dev)
    was_training = denoiser.training
    denoiser.eval()
    try:
        denoise_fn = make_denoise_fn(denoiser, cfg, fused, dtype)
        return diffusion.sample(
            denoise_fn, cfg, n_samples, noise, temperature=temperature,
            sample_steps=sample_steps, unmask_mode=unmask_mode,
            choice_temperature=choice_temperature, spacing=spacing, device=dev)
    finally:
        denoiser.train(was_training)


@torch.no_grad()
def generate(
    denoiser: SpikingDenoiser,
    vqvae: SNNVQVAE,
    cfg: DiffusionConfig,
    n_samples: int = 16,
    temperature: float = 1.0,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Iterable[diffusion.StepNoise]] = None,
    device="cuda",
    fused=False,
    dtype: torch.dtype = torch.float32,
    **sampler_options,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample then decode: ((N, h, w) codes, (N, H, W, C) images in [-1, 1])."""
    codes = sample_codes(denoiser, cfg, n_samples, temperature, generator,
                         noise, device=device, fused=fused, dtype=dtype,
                         **sampler_options)
    return codes, vqvae.decode_indices(codes)
