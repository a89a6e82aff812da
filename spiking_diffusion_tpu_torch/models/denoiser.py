"""Spiking conv denoiser of the absorbing diffusion prior (inference).

Counterpart of ``spiking_diffusion_tpu/models/denoiser.py``
``SpikingDenoiser`` on its layerwise (non-``bnlif``) branch: the (N, h, w)
token map as float (the mask id included) and the timestep broadcast as a
second channel; five Conv3x3 + BN + LIF blocks (2 -> 64 -> 128 -> 256 ->
512 -> 256 at full width); the skip cat(x5, x1) on channels; a 3x3 conv to
K logits; the firing-rate mean over T. The input is the same at every
step, so the first Conv + BN runs once on the N rows and is repeated T
times into the first LIF.
"""

from __future__ import annotations

import torch
from torch import nn

from spiking_diffusion_tpu_torch.config import DiffusionConfig
from spiking_diffusion_tpu_torch.models.layers import LIF, SeqBatchNorm, SeqConv
from spiking_diffusion_tpu_torch.snn.encoding import direct_encode


class SpikingDenoiser(nn.Module):
    """(N, h, w) tokens + (N,) timesteps -> (N, h, w, K) logits."""

    def __init__(self, cfg: DiffusionConfig = DiffusionConfig(),
                 lif_backend: str = "auto"):
        super().__init__()
        self.cfg = cfg
        chans = tuple(cfg.denoiser_channels)
        params = cfg.lif.to_params()
        self.convs = nn.ModuleList(
            [SeqConv(cin, cout, 3, padding=1)
             for cin, cout in zip((2,) + chans[:-1], chans)])
        self.bns = nn.ModuleList([SeqBatchNorm(c) for c in chans])
        self.lifs = nn.ModuleList(
            [LIF(params, cfg.num_steps, lif_backend) for _ in chans])
        self.readout = SeqConv(chans[-1] + chans[0], cfg.num_embeddings, 3,
                               padding=1)

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        t_steps = self.cfg.num_steps
        x = tokens.float().unsqueeze(1)  # (N, 1, h, w)
        x = torch.cat([x, t.float().reshape(-1, 1, 1, 1).expand_as(x)], dim=1)
        feats = []
        h = x
        for i, (conv, bn, lif) in enumerate(zip(self.convs, self.bns, self.lifs)):
            h = bn(conv(h))
            if i == 0:
                h = direct_encode(h, t_steps).reshape((-1,) + tuple(h.shape[1:]))
            h = lif(h)
            feats.append(h)
        h = self.readout(torch.cat([feats[-1], feats[0]], dim=1))
        h = h.reshape((t_steps, -1) + tuple(h.shape[1:]))
        logits = torch.sum(h, dim=0) / t_steps  # (N, K, h, w)
        return logits.permute(0, 2, 3, 1)
