"""Configuration of the PyTorch port.

The same frozen dataclasses, fields and defaults as
``spiking_diffusion_tpu/config.py`` (``LIFConfig``, ``VQVAEConfig``,
``DiffusionConfig``, ``SNNVAEConfig``, ``TrainConfig``, ``ExperimentConfig``),
kept as a copy so that the port imports nothing of the JAX package. The defaults are the MNIST flagship: a T=16 spiking
VQ-VAE with a 7x7 latent and K=128 codes, and a 49-step absorbing
diffusion prior with denoiser channels 64-128-256-512-256.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class LIFConfig:
    """Leaky-integrate-and-fire neuron constants (spikingjelly ``LIFNode``
    defaults: tau=2, v_th=1, v_reset=0, decay_input, hard reset, ATan)."""

    tau: float = 2.0
    v_threshold: float = 1.0
    v_reset: float = 0.0
    decay_input: bool = True
    hard_reset: bool = True
    detach_reset: bool = False
    surrogate: str = "atan"
    surrogate_alpha: float = 2.0

    def to_params(self):
        """Build the runtime :class:`~spiking_diffusion_tpu_torch.snn.neuron.NeuronParams`."""
        from spiking_diffusion_tpu_torch.snn.neuron import NeuronParams
        from spiking_diffusion_tpu_torch.snn.surrogate import get_surrogate

        return NeuronParams(
            tau=self.tau,
            v_threshold=self.v_threshold,
            v_reset=self.v_reset,
            decay_input=self.decay_input,
            hard_reset=self.hard_reset,
            detach_reset=self.detach_reset,
            surrogate=get_surrogate(self.surrogate, self.surrogate_alpha),
        )


@dataclasses.dataclass(frozen=True)
class VQVAEConfig:
    """Stage-1 spiking VQ-VAE."""

    in_channels: int = 1
    image_size: int = 28
    latent_size: int = 7
    embedding_dim: int = 16
    num_embeddings: int = 128
    commitment_cost: float = 0.25
    usage_loss_weight: float = 0.0
    num_steps: int = 16  # T, the SNN time window
    enc_channels: Tuple[int, ...] = (32, 64)
    dec_channels: Tuple[int, ...] = (64, 32)
    memout_decay: float = 0.8  # membrane readout coefficient base
    psp_tau_s: float = 2.0
    lif: LIFConfig = dataclasses.field(default_factory=LIFConfig)


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    """Stage-2 absorbing discrete diffusion prior."""

    num_timesteps: int = 49
    latent_size: int = 7
    num_embeddings: int = 128
    mask_id: int = 128  # == num_embeddings ("codebook_size" mode)
    loss_type: str = "reweighted_elbo"
    num_steps: int = 16  # SNN time window of the denoiser
    denoiser_channels: Tuple[int, ...] = (64, 128, 256, 512, 256)
    lif: LIFConfig = dataclasses.field(default_factory=LIFConfig)


@dataclasses.dataclass(frozen=True)
class SNNVAEConfig:
    """FSVAE-style autoregressive-Bernoulli SNN-VAE baseline
    (``--model snn-vae``): a latent of ``latent_dim`` binary units per
    step, each drawn from one of ``k`` Bernoulli channels."""

    latent_dim: int = 56  # 28*2
    k: int = 20
    num_steps: int = 16
    scheduled_start: float = 0.1
    scheduled_end: float = 0.3
    lif: LIFConfig = dataclasses.field(default_factory=LIFConfig)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimiser and loop settings (AdamW of the reference's ``main.py``)."""

    batch_size: int = 32
    learning_rate: float = 1e-3
    weight_decay: float = 1e-3
    betas: Tuple[float, float] = (0.9, 0.999)
    epochs: int = 100
    seed: int = 42
    # compute dtype for conv/matmul activations; membranes always fp32
    compute_dtype: str = "float32"
    # the denoiser's branch: 'auto' (layerwise, K1), 'bnlif' (K3) or
    # 'bnlifconv' (K4 and K3)
    lif_backend: str = "auto"
    # data-parallel device count; 1 = single card
    data_parallel: int = 1


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """One experiment: dataset, model and every sub-configuration."""

    dataset: str = "MNIST"
    model: str = "snn-vq-vae"  # snn-vq-vae | snn-vae | vq-vae
    data_path: Optional[str] = None
    vqvae: VQVAEConfig = dataclasses.field(default_factory=VQVAEConfig)
    diffusion: DiffusionConfig = dataclasses.field(default_factory=DiffusionConfig)
    snn_vae: SNNVAEConfig = dataclasses.field(default_factory=SNNVAEConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    result_dir: str = "./result"
    sample_dir: str = "./sample"
