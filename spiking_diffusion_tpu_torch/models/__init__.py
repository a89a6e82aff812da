"""Models of the port: the spiking VQ-VAE, the diffusion denoiser, the ANN
VQ-VAE and SNN-VAE baselines, the sequence layers they are built of, the
classifier zoo and the SNN library's layers (ANN -> SNN, attention,
DropConnect, recurrent containers), export (deploy, lava_export), over
the port's time-folded (T*N, C, H, W) layout."""

from spiking_diffusion_tpu_torch.models.layers import (
    LIF,
    SeqBatchNorm,
    SeqConv,
    SeqConvTranspose,
    SeqLinear,
)
from spiking_diffusion_tpu_torch.models.vqvae import (
    Decoder,
    Encoder,
    SNNVQVAE,
    VectorQuantizer,
)
from spiking_diffusion_tpu_torch.models.denoiser import SpikingDenoiser
from spiking_diffusion_tpu_torch.models.ann_vqvae import ANNVQVAE
from spiking_diffusion_tpu_torch.models.snn_vae import SNNVAE
from spiking_diffusion_tpu_torch.models import (
    ann2snn,
    attention,
    deploy,
    diffusion,
    dropconnect,
    lava_export,
    recurrent,
    zoo,
)

__all__ = ["ann2snn", "attention", "deploy", "lava_export", "diffusion", "dropconnect",
           "recurrent", "zoo", "LIF", "SeqBatchNorm", "SeqConv", "SeqConvTranspose",
           "SeqLinear", "Decoder", "Encoder", "SNNVQVAE", "VectorQuantizer",
           "SpikingDenoiser", "ANNVQVAE", "SNNVAE"]
