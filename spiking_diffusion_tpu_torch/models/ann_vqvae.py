"""The non-spiking (ANN) VQ-VAE baseline, the CLI's ``--model vq-vae``.

Counterpart of ``spiking_diffusion_tpu/models/ann_vqvae.py``
(``ANNVQVAE``): a plain Conv/ReLU VQ-VAE with the spiking model's
geometry (28x28 -> 7x7, codebook K, dim D) and one analog VQ loss. Public
layouts are the JAX package's: images (N, H, W, C) in [-0.5, 0.5], code
grids (N, h, w), flat indices in (N, h, w) row-major order; inside,
NCHW. It has no BatchNorm and no LIF layer, so it runs no kernel of the
port and has no training-mode state: ``train`` only picks the outputs.
Its convs are ``nn.Conv2d`` / ``nn.ConvTranspose2d``, which the
op/energy profiler does not count, as the JAX module sows no counters.

Tensor parallel (``parallel.shard_state_tp``, JAX's ``shard_state_tp`` on
this model): each conv whose output channels are sharded takes its input
through ``parallel.copy_to_model``, computes this rank's channels and
gathers every rank's (``gather_channels``) before the next layer; the
codebook's rows are sharded and gathered (``gather_rows``) once per
forward, so distances, codes and lookups are one process's.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from spiking_diffusion_tpu_torch.config import VQVAEConfig
from spiking_diffusion_tpu_torch.parallel.mesh import Mesh
from spiking_diffusion_tpu_torch.parallel.tp import copy_to_model, gather_channels, gather_rows


class _Gathered:
    """A conv whose output channels may be sharded: with ``model_mesh`` (set
    by ``parallel.shard_state_tp``) it computes this rank's and gathers
    every rank's."""

    model_mesh: Optional[Mesh] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(copy_to_model(x, self.model_mesh))
        return gather_channels(y, self.model_mesh)


class _Conv2d(_Gathered, nn.Conv2d):
    pass


class _ConvTranspose2d(_Gathered, nn.ConvTranspose2d):
    pass


def _conv(cin: int, cout: int, k: int, s: int, p: int) -> nn.Conv2d:
    return _Conv2d(cin, cout, k, stride=s, padding=p)


def _deconv(cin: int, cout: int, k: int, s: int, p: int, op: int) -> nn.ConvTranspose2d:
    return _ConvTranspose2d(cin, cout, k, stride=s, padding=p, output_padding=op)


class ANNVQVAE(nn.Module):
    """Conv/ReLU encoder, L2-nearest codebook lookup with the
    straight-through estimator, Conv/ReLU transposed decoder. ``model_mesh``:
    the codebook's, under tensor parallelism."""

    def __init__(self, cfg: VQVAEConfig = VQVAEConfig()):
        super().__init__()
        self.cfg = cfg
        self.model_mesh: Optional[Mesh] = None
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

    def codebook(self) -> torch.Tensor:
        """The whole (K, D) codebook."""
        return gather_rows(self.embeddings, self.model_mesh)

    def get_code_indices(self, flat_x: torch.Tensor,
                         e: Optional[torch.Tensor] = None) -> torch.Tensor:
        """L2-nearest codebook entry of each row of (M, D), the distances
        in fp32; the first index among ties. ``e``: the codebook, if the
        caller has it."""
        e = self.codebook() if e is None else e
        d = (torch.sum(flat_x ** 2, dim=1, keepdim=True) + torch.sum(e ** 2, dim=1)
             - 2.0 * (flat_x @ e.T))
        return torch.argmin(d, dim=1)

    def quantize(self, indices: torch.Tensor, e: Optional[torch.Tensor] = None) -> torch.Tensor:
        """indices (...,) -> codebook vectors (..., D)."""
        return (self.codebook() if e is None else e)[indices]

    def _codes(self, image: torch.Tensor, e: torch.Tensor):
        z = self.encode(image.permute(0, 3, 1, 2))
        z = z.permute(0, 2, 3, 1)  # (N, h, w, D), as the JAX module's
        return z, self.get_code_indices(z.reshape(-1, z.shape[-1]), e)

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
                e = self.codebook()
                z, indices = self._codes(image, e)
                recon = self.decode(self.quantize(indices, e).reshape(z.shape).permute(0, 3, 1, 2))
                return {"recon": recon.permute(0, 2, 3, 1), "indices": indices}
        e = self.codebook()
        z, indices = self._codes(image, e)
        quantized = self.quantize(indices, e).reshape(z.shape)
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
        z, indices = self._codes(image, self.codebook())
        return indices.reshape(z.shape[:3]).to(torch.int32)

    @torch.no_grad()
    def decode_indices(self, indices: torch.Tensor) -> torch.Tensor:
        """(N, h, w) code indices -> images (N, H, W, C)."""
        q = self.quantize(indices.long()).permute(0, 3, 1, 2)
        return self.decode(q).permute(0, 2, 3, 1)
