"""Decode half of the spiking VQ-VAE: code indices -> images.

Counterpart of ``spiking_diffusion_tpu/models/vqvae.py`` (``quantize``,
``respike``, ``Decoder``, ``_decode_spikes``, ``decode_indices``). Public
layouts are the JAX package's: code grids (N, h, w) int, images
(N, H, W, C); the flat code order is (N, h, w) row-major. Inside, tensors
are NCHW with T folded into the batch, (T*N, C, H, W).
"""

from __future__ import annotations

import torch
from torch import nn

from spiking_diffusion_tpu_torch.config import VQVAEConfig
from spiking_diffusion_tpu_torch.models.layers import (
    LIF,
    SeqBatchNorm,
    SeqConv,
    SeqConvTranspose,
)
from spiking_diffusion_tpu_torch.snn.encoding import direct_encode
from spiking_diffusion_tpu_torch.snn.temporal import membrane_output


class VectorQuantizer(nn.Module):
    """Codebook lookup and the adaptive spike generator (Conv1x1+BN+LIF)."""

    def __init__(self, cfg: VQVAEConfig, lif_backend: str = "auto"):
        super().__init__()
        self.cfg = cfg
        d = cfg.embedding_dim
        self.embeddings = nn.Parameter(torch.zeros(cfg.num_embeddings, d))
        self.poisson_conv = SeqConv(d, d, 1)
        self.poisson_bn = SeqBatchNorm(d)
        self.poisson_lif = LIF(cfg.lif.to_params(), cfg.num_steps, lif_backend)

    def quantize(self, indices: torch.Tensor) -> torch.Tensor:
        """indices (...,) -> codebook vectors (..., D)."""
        return self.embeddings[indices]

    def respike(self, q: torch.Tensor) -> torch.Tensor:
        """Analog (N, D, h, w) -> spikes (T*N, D, h, w).

        The input is the same at every step, so Conv1x1 + BN run once on
        the N rows and are repeated T times into the LIF.
        """
        y = self.poisson_bn(self.poisson_conv(q))
        y = direct_encode(y, self.cfg.num_steps)
        return self.poisson_lif(y.reshape((-1,) + tuple(q.shape[1:])))


class Decoder(nn.Module):
    """2 x (deconv stride 2 + BN + LIF), then a bare stride-1 deconv."""

    def __init__(self, cfg: VQVAEConfig, lif_backend: str = "auto"):
        super().__init__()
        d1, d2 = cfg.dec_channels
        params = cfg.lif.to_params()
        self.deconvs = nn.ModuleList([
            SeqConvTranspose(cfg.embedding_dim, d1, 3, stride=2, padding=1,
                             output_padding=1),
            SeqConvTranspose(d1, d2, 3, stride=2, padding=1, output_padding=1),
            SeqConvTranspose(d2, cfg.in_channels, 3, stride=1, padding=1),
        ])
        self.bns = nn.ModuleList([SeqBatchNorm(d1), SeqBatchNorm(d2)])
        self.lifs = nn.ModuleList(
            [LIF(params, cfg.num_steps, lif_backend) for _ in range(2)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for deconv, bn, lif in zip(self.deconvs, self.bns, self.lifs):
            x = lif(bn(deconv(x)))
        return self.deconvs[-1](x)


class SNNVQVAE(nn.Module):
    """The decoding side of the VQ-SVAE: quantize, re-spike, decode, read out."""

    def __init__(self, cfg: VQVAEConfig = VQVAEConfig(),
                 lif_backend: str = "auto"):
        super().__init__()
        self.cfg = cfg
        self.vq_layer = VectorQuantizer(cfg, lif_backend)
        self.decoder = Decoder(cfg, lif_backend)

    def decode_spikes(self, spikes: torch.Tensor) -> torch.Tensor:
        """Spikes (T*N, D, h, w) -> images (N, C, H, W), tanh of the
        decay^(T-1-t) membrane readout."""
        x = self.decoder(spikes)
        x_seq = x.reshape((self.cfg.num_steps, -1) + tuple(x.shape[1:]))
        return torch.tanh(membrane_output(x_seq, self.cfg.memout_decay))

    @torch.no_grad()
    def decode_indices(self, indices: torch.Tensor) -> torch.Tensor:
        """(N, h, w) code indices -> images (N, H, W, C)."""
        q = self.vq_layer.quantize(indices.long()).permute(0, 3, 1, 2)
        spikes = self.vq_layer.respike(q.contiguous())
        return self.decode_spikes(spikes).permute(0, 2, 3, 1)
