"""The non-spiking (ANN) VQ-VAE baseline, the CLI's ``--model vq-vae``.

Counterpart of ``spiking_diffusion_tpu/models/ann_vqvae.py``
(``ANNVQVAE``): a plain Conv/ReLU VQ-VAE with the spiking model's
geometry (28x28 -> 7x7, codebook K, dim D) and one analog VQ loss. Public
layouts are the JAX package's: images (N, H, W, C) in [-0.5, 0.5], code
grids (N, h, w), flat indices in (N, h, w) row-major order; inside,
NCHW. It has no BatchNorm and no LIF layer, so it runs no kernel of the
port and has no training-mode state: ``train`` only picks the outputs.
Its convs are plain ``nn.Conv2d`` / ``nn.ConvTranspose2d``, which the
op/energy profiler does not count, as the JAX module sows no counters.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from spiking_diffusion_tpu_torch.config import VQVAEConfig


def _conv(cin: int, cout: int, k: int, s: int, p: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=s, padding=p)


def _deconv(cin: int, cout: int, k: int, s: int, p: int, op: int) -> nn.ConvTranspose2d:
    return nn.ConvTranspose2d(cin, cout, k, stride=s, padding=p, output_padding=op)


class ANNVQVAE(nn.Module):
    """Conv/ReLU encoder, L2-nearest codebook lookup with the
    straight-through estimator, Conv/ReLU transposed decoder."""

    def __init__(self, cfg: VQVAEConfig = VQVAEConfig()):
        super().__init__()
        self.cfg = cfg
        c1, c2 = cfg.enc_channels
        d1, d2 = cfg.dec_channels
        self.enc1 = _conv(cfg.in_channels, c1, 3, 2, 1)
        self.enc2 = _conv(c1, c2, 3, 2, 1)
        self.enc3 = _conv(c2, cfg.embedding_dim, 1, 1, 0)
        self.dec1 = _deconv(cfg.embedding_dim, d1, 3, 2, 1, 1)
        self.dec2 = _deconv(d1, d2, 3, 2, 1, 1)
        self.dec3 = _deconv(d2, cfg.in_channels, 3, 1, 1, 0)
        self.embeddings = nn.Parameter(torch.zeros(cfg.num_embeddings, cfg.embedding_dim))

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """(N, C, H, W) -> (N, D, h, w)."""
        return self.enc3(F.relu(self.enc2(F.relu(self.enc1(x)))))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """(N, D, h, w) -> (N, C, H, W)."""
        return self.dec3(F.relu(self.dec2(F.relu(self.dec1(z)))))

    def get_code_indices(self, flat_x: torch.Tensor) -> torch.Tensor:
        """L2-nearest codebook entry of each row of (M, D), the distances
        in fp32; the first index among ties."""
        e = self.embeddings
        d = (torch.sum(flat_x ** 2, dim=1, keepdim=True) + torch.sum(e ** 2, dim=1)
             - 2.0 * (flat_x @ e.T))
        return torch.argmin(d, dim=1)

    def quantize(self, indices: torch.Tensor) -> torch.Tensor:
        """indices (...,) -> codebook vectors (..., D)."""
        return self.embeddings[indices]

    def _codes(self, image: torch.Tensor):
        z = self.encode(image.permute(0, 3, 1, 2))
        z = z.permute(0, 2, 3, 1)  # (N, h, w, D), as the JAX module's
        return z, self.get_code_indices(z.reshape(-1, z.shape[-1]))

    def forward(self, image: torch.Tensor, train: Optional[bool] = None,
                data_variance: float = 1.0) -> Dict[str, torch.Tensor]:
        """Images (N, H, W, C) in [-0.5, 0.5].

        In training (``train``, else the module's mode): ``vq_loss``,
        ``recon_loss`` (the MSE over ``data_variance``), ``real_recon_loss``
        and ``recon`` (N, H, W, C). In eval: ``recon`` and ``indices``
        (N*h*w,), without autograd.
        """
        train = self.training if train is None else train
        if not train:
            with torch.no_grad():
                z, indices = self._codes(image)
                recon = self.decode(self.quantize(indices).reshape(z.shape).permute(0, 3, 1, 2))
                return {"recon": recon.permute(0, 2, 3, 1), "indices": indices}
        z, indices = self._codes(image)
        quantized = self.quantize(indices).reshape(z.shape)
        q_latent = torch.mean((quantized - z.detach()) ** 2)
        e_latent = torch.mean((z - quantized.detach()) ** 2)
        vq_loss = q_latent + self.cfg.commitment_cost * e_latent
        quantized = z + (quantized - z).detach()  # straight-through
        recon = self.decode(quantized.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        real_recon_loss = torch.mean((recon - image) ** 2)
        return {"vq_loss": vq_loss, "recon_loss": real_recon_loss / data_variance,
                "real_recon_loss": real_recon_loss, "recon": recon}

    @torch.no_grad()
    def encode_indices(self, image: torch.Tensor) -> torch.Tensor:
        """Images (N, H, W, C) in [-0.5, 0.5] -> (N, h, w) int32 code grids."""
        z, indices = self._codes(image)
        return indices.reshape(z.shape[:3]).to(torch.int32)

    @torch.no_grad()
    def decode_indices(self, indices: torch.Tensor) -> torch.Tensor:
        """(N, h, w) code indices -> images (N, H, W, C)."""
        q = self.quantize(indices.long()).permute(0, 3, 1, 2)
        return self.decode(q).permute(0, 2, 3, 1)
