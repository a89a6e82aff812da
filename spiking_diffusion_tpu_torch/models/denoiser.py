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
versions on either device, as 'torch' takes K1's. Fully fused
('bnlifconv', 'bnlifconv_torch'): as 'bnlif', and every 3x3 conv, the
readout's too, runs through K4 (``ops.spike_conv.spike_conv3x3``), which
in training also hands BN its batch moments (the readout's and eval's
convs skip them); 'bnlifconv_torch' takes K4's and K3's plain versions.
The parameters are the same on every branch. In training mode
(``module.train()``) BN uses and updates the batch statistics and the
forward is differentiable; in eval mode it runs without autograd from the
running statistics.

``dtype`` (None or ``torch.bfloat16``), on every branch, as the JAX
package's ``SpikingDenoiser(dtype=)``: the input is cast after the concat
with the timestep map, the convs run in it, BN computes in fp32 and
casts its output, spikes are in it; the firing-rate sum over T is taken
on the stack in it, and the logits are cast to fp32.

``bn_mesh`` (a ``parallel.Mesh``) has the meaning of the JAX package's
``bn_axis_name``: the BN statistics are synced over it (SyncBN,
``parallel.sync_batchnorm``), and a data-parallel trainer refuses a mesh
of another process group.

Tensor parallel (``parallel.shard_state_tp``): each sharded conv computes
this rank's output channels, its BN and neuron (K1, K3, K4's moments) run
on them, and the block's spikes are gathered from every rank; the skip
concatenation takes the gathered trains, and the readout's logits (sharded
on K) are gathered after the firing-rate mean.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from spiking_diffusion_tpu_torch.config import DiffusionConfig
from spiking_diffusion_tpu_torch.models.layers import LIF, SeqBatchNorm, SeqConv
from spiking_diffusion_tpu_torch.ops.bn_lif import bn_lif
from spiking_diffusion_tpu_torch.parallel.mesh import Mesh
from spiking_diffusion_tpu_torch.parallel.tp import gather_channels
from spiking_diffusion_tpu_torch.profiling import syops
from spiking_diffusion_tpu_torch.snn.encoding import direct_encode
from spiking_diffusion_tpu_torch.snn.neuron import BACKENDS

# fused BN-apply + LIF branch -> the LIF backend its plain/kernel choice matches
BNLIF_BACKENDS = {"bnlif": "auto", "bnlif_torch": "torch",
                  "bnlifconv": "auto", "bnlifconv_torch": "torch"}
PLAIN_BACKENDS = ("torch", "bnlif_torch", "bnlifconv_torch")


class SpikingDenoiser(nn.Module):
    """(N, h, w) tokens + (N,) timesteps -> (N, h, w, K) logits."""

    def __init__(self, cfg: DiffusionConfig = DiffusionConfig(),
                 lif_backend: str = "auto", dtype: Optional[torch.dtype] = None,
                 bn_mesh: Optional[Mesh] = None):
        super().__init__()
        if lif_backend not in BACKENDS + tuple(BNLIF_BACKENDS):
            raise ValueError(f"unknown denoiser backend {lif_backend!r}; have "
                             f"{BACKENDS + tuple(BNLIF_BACKENDS)}")
        if dtype not in (None, torch.bfloat16):
            raise TypeError(f"the denoiser's dtype is None or bfloat16, not {dtype}")
        self.cfg = cfg
        self.lif_backend = lif_backend
        self.dtype = dtype
        chans = tuple(cfg.denoiser_channels)
        params = cfg.lif.to_params()
        self.params = params
        self.fused_conv = lif_backend.startswith("bnlifconv")
        conv = dict(dtype=dtype, fused_train=self.fused_conv,
                    reference=lif_backend in PLAIN_BACKENDS)
        lif_backend = BNLIF_BACKENDS.get(lif_backend, lif_backend)
        self.convs = nn.ModuleList(
            [SeqConv(cin, cout, 3, padding=1, **conv)
             for cin, cout in zip((2,) + chans[:-1], chans)])
        self.bns = nn.ModuleList([SeqBatchNorm(c, dtype=dtype, mesh=bn_mesh) for c in chans])
        self.lifs = nn.ModuleList(
            [LIF(params, cfg.num_steps, lif_backend) for _ in chans])
        self.readout = SeqConv(chans[-1] + chans[0], cfg.num_embeddings, 3,
                               padding=1, **conv)

    def forward(self, tokens: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        if self.training:
            return self._forward(tokens, t)
        with torch.no_grad():
            return self._forward(tokens, t)

    def _forward(self, tokens: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        t_steps = self.cfg.num_steps
        x = tokens.float().unsqueeze(1)  # (N, 1, h, w)
        x = torch.cat([x, t.float().reshape(-1, 1, 1, 1).expand_as(x)], dim=1)
        if self.dtype is not None:
            x = x.to(self.dtype)
        feats = []
        h = x
        for i, (conv, bn, lif) in enumerate(zip(self.convs, self.bns, self.lifs)):
            moments = None
            if self.fused_conv:
                y, s1, s2 = conv(h, with_moments=self.training)
                if self.training:  # block 0's count is over its length-1 time axis
                    moments = (s1, s2, y.numel() // y.shape[1])
            else:
                y = conv(h)
            if self.lif_backend in BNLIF_BACKENDS:
                scale, shift = bn(y, return_affine=True, moments=moments)
                y_seq = y.reshape((1 if i == 0 else t_steps, -1) + tuple(y.shape[1:]))
                s = bn_lif(y_seq, scale, shift, self.params, t_out=t_steps,
                           reference=self.lif_backend in PLAIN_BACKENDS)
                syops.record_fused(lif, s)
                h = s.reshape((-1,) + tuple(y.shape[1:]))
            else:
                h = bn(y)
                if i == 0:
                    h = direct_encode(h, t_steps).reshape((-1,) + tuple(h.shape[1:]))
                h = lif(h)
            h = gather_channels(h, conv.model_mesh)
            feats.append(h)
        h = torch.cat([feats[-1], feats[0]], dim=1)
        h = self.readout(h, with_moments=False)[0] if self.fused_conv else self.readout(h)
        h = h.reshape((t_steps, -1) + tuple(h.shape[1:]))
        logits = (torch.sum(h, dim=0) / t_steps).float()  # (N, K, h, w)
        return gather_channels(logits, self.readout.model_mesh).permute(0, 2, 3, 1)
