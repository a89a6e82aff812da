"""Spiking conv denoiser of the absorbing diffusion prior.

Counterpart of ``spiking_diffusion_tpu/models/denoiser.py``
``SpikingDenoiser``: the (N, h, w) token map as float (the mask id
included) and the timestep broadcast as a second channel; five Conv3x3 +
BN + LIF blocks (2 -> 64 -> 128 -> 256 -> 512 -> 256 at full width); the
skip cat(x5, x1) on channels; a 3x3 conv to K logits; the firing-rate
mean over T. The input is the same at every step, so the first conv runs
once on the N rows (a length-1 time axis) and is repeated T times into
the first LIF.

``lif_backend`` picks the branch. Layerwise ('auto', 'cuda', 'torch'):
BN, then the LIF layer (``snn.neuron.lif_multi_step``, K1). Fused
('bnlif', 'bnlif_torch'): BN only forms its per-channel affine and
``ops.bn_lif.bn_lif`` (K3) applies it inside the LIF recurrence,
broadcasting block 0 over time itself; 'bnlif_torch' takes K3's plain
versions on either device, as 'torch' takes K1's. In training mode
(``module.train()``) BN uses and updates the batch statistics and the
forward is differentiable; in eval mode it runs without autograd from the
running statistics.
"""

from __future__ import annotations

import torch
from torch import nn

from spiking_diffusion_tpu_torch.config import DiffusionConfig
from spiking_diffusion_tpu_torch.models.layers import LIF, SeqBatchNorm, SeqConv
from spiking_diffusion_tpu_torch.ops.bn_lif import bn_lif
from spiking_diffusion_tpu_torch.snn.encoding import direct_encode
from spiking_diffusion_tpu_torch.snn.neuron import BACKENDS

# fused BN-apply + LIF branch -> the LIF backend its plain/kernel choice matches
BNLIF_BACKENDS = {"bnlif": "auto", "bnlif_torch": "torch"}


class SpikingDenoiser(nn.Module):
    """(N, h, w) tokens + (N,) timesteps -> (N, h, w, K) logits."""

    def __init__(self, cfg: DiffusionConfig = DiffusionConfig(),
                 lif_backend: str = "auto"):
        super().__init__()
        if lif_backend not in BACKENDS + tuple(BNLIF_BACKENDS):
            raise ValueError(f"unknown denoiser backend {lif_backend!r}; have "
                             f"{BACKENDS + tuple(BNLIF_BACKENDS)}")
        self.cfg = cfg
        self.lif_backend = lif_backend
        chans = tuple(cfg.denoiser_channels)
        params = cfg.lif.to_params()
        self.params = params
        lif_backend = BNLIF_BACKENDS.get(lif_backend, lif_backend)
        self.convs = nn.ModuleList(
            [SeqConv(cin, cout, 3, padding=1)
             for cin, cout in zip((2,) + chans[:-1], chans)])
        self.bns = nn.ModuleList([SeqBatchNorm(c) for c in chans])
        self.lifs = nn.ModuleList(
            [LIF(params, cfg.num_steps, lif_backend) for _ in chans])
        self.readout = SeqConv(chans[-1] + chans[0], cfg.num_embeddings, 3,
                               padding=1)

    def forward(self, tokens: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        if self.training:
            return self._forward(tokens, t)
        with torch.no_grad():
            return self._forward(tokens, t)

    def _forward(self, tokens: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        t_steps = self.cfg.num_steps
        x = tokens.float().unsqueeze(1)  # (N, 1, h, w)
        x = torch.cat([x, t.float().reshape(-1, 1, 1, 1).expand_as(x)], dim=1)
        feats = []
        h = x
        for i, (conv, bn, lif) in enumerate(zip(self.convs, self.bns, self.lifs)):
            y = conv(h)
            if self.lif_backend in BNLIF_BACKENDS:
                scale, shift = bn(y, return_affine=True)
                y_seq = y.reshape((1 if i == 0 else t_steps, -1) + tuple(y.shape[1:]))
                s = bn_lif(y_seq, scale, shift, self.params, t_out=t_steps,
                           reference=self.lif_backend == "bnlif_torch")
                h = s.reshape((-1,) + tuple(y.shape[1:]))
            else:
                h = bn(y)
                if i == 0:
                    h = direct_encode(h, t_steps).reshape((-1,) + tuple(h.shape[1:]))
                h = lif(h)
            feats.append(h)
        h = self.readout(torch.cat([feats[-1], feats[0]], dim=1))
        h = h.reshape((t_steps, -1) + tuple(h.shape[1:]))
        logits = torch.sum(h, dim=0) / t_steps  # (N, K, h, w)
        return logits.permute(0, 2, 3, 1)
