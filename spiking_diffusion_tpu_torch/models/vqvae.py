"""The spiking VQ-VAE (VQ-SVAE): LIF conv encoder, spiking vector
quantizer, LIF deconv decoder with the leaky membrane readout.

Counterpart of ``spiking_diffusion_tpu/models/vqvae.py`` (``Encoder``,
``VectorQuantizer``, ``Decoder``, ``SNNVQVAE``). Public layouts are the JAX
package's: images (N, H, W, C) in [-0.5, 0.5], code grids (N, h, w) int,
spike trains (T, N, h, w, D); the flat code order is (N, h, w) row-major.
Inside, tensors are NCHW with T folded into the batch, (T*N, C, H, W).

``lif_backend`` picks the branch. Layerwise ('auto', 'cuda', 'torch'): BN,
then the LIF layer (``snn.neuron.lif_multi_step``, K1 forward and
backward). Fused ('bnlif', 'bnlif_torch'): BN only forms its per-channel
affine and ``ops.bn_lif.bn_lif`` (K3) applies it inside the LIF
recurrence, in the encoder's and decoder's blocks and the quantizer's
re-spike; 'bnlif_torch' takes K3's plain versions on either device, as
'torch' takes K1's. The parameters are the same on every branch. The
encoder's first block and the re-spike see an input that is the same at
every step: their conv and BN run once on the N rows (BN statistics over
N equal those over T*N repeated rows) and the result is repeated T times
into the LIF, or broadcast inside K3.

In training mode (``module.train()``) BN uses and updates the batch
statistics and the forward is differentiable; in eval mode it runs without
autograd from the running statistics. ``dtype`` (None or
``torch.bfloat16``) has the JAX module's meaning: the encoder's and
decoder's convs run in it, BN casts its output to it, their spikes are in
it; the quantizer stays fp32 and the decoder's output is cast to fp32.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from spiking_diffusion_tpu_torch.config import VQVAEConfig
from spiking_diffusion_tpu_torch.models.layers import (
    LIF,
    SeqBatchNorm,
    SeqConv,
    SeqConvTranspose,
)
from spiking_diffusion_tpu_torch.ops.bn_lif import bn_lif
from spiking_diffusion_tpu_torch.parallel.mesh import Mesh, all_reduce_mean
from spiking_diffusion_tpu_torch.parallel.tp import gather_channels, gather_rows
from spiking_diffusion_tpu_torch.profiling import syops
from spiking_diffusion_tpu_torch.snn.encoding import direct_encode
from spiking_diffusion_tpu_torch.snn.neuron import BACKENDS
from spiking_diffusion_tpu_torch.snn.temporal import membrane_output, psp

# fused BN-apply + LIF branch -> the LIF backend its plain/kernel choice matches
BNLIF_BACKENDS = {"bnlif": "auto", "bnlif_torch": "torch"}


def _lif_backend(backend: str) -> str:
    if backend not in BACKENDS + tuple(BNLIF_BACKENDS):
        raise ValueError(f"unknown VQ-VAE backend {backend!r}; have "
                         f"{BACKENDS + tuple(BNLIF_BACKENDS)}")
    return BNLIF_BACKENDS.get(backend, backend)


def bn_spikes(y: torch.Tensor, bn: SeqBatchNorm, lif: LIF, t_in: int,
              backend: str, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """BN then LIF of a conv output (t_in*N, C, H, W) -> spikes (T*N, C, H,
    W); with t_in = 1 the normalised input is repeated over the T steps.
    On the fused branches K3 applies BN's affine inside the recurrence, and
    a profile counting ``lif`` counts that neuron layer here. Tensor
    parallel (``mesh``, the conv's ``model_mesh``): y holds this rank's
    channels, and the spikes of every rank's are returned."""
    t_steps = lif.num_steps
    if backend in BNLIF_BACKENDS:
        scale, shift = bn(y, return_affine=True)
        y_seq = y.reshape((t_in, -1) + tuple(y.shape[1:]))
        s = bn_lif(y_seq, scale, shift, lif.params, t_out=t_steps,
                   reference=backend == "bnlif_torch")
        syops.record_fused(lif, s)
        return gather_channels(s.reshape((-1,) + tuple(y.shape[1:])), mesh)
    h = bn(y)
    if t_in == 1:
        h = direct_encode(h, t_steps).reshape((-1,) + tuple(h.shape[1:]))
    return gather_channels(lif(h), mesh)


@contextlib.contextmanager
def _mode(module: nn.Module, train: bool):
    """Run ``module`` in training or eval mode, restoring its mode after."""
    was = module.training
    module.train(train)
    try:
        with contextlib.nullcontext() if train else torch.no_grad():
            yield
    finally:
        module.train(was)


class Encoder(nn.Module):
    """3 x {Conv, BN, LIF}: 3x3 stride 2, 3x3 stride 2, 1x1; 28x28xC ->
    a 7x7xD spike train."""

    def __init__(self, cfg: VQVAEConfig, lif_backend: str = "auto",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.backend = lif_backend
        self.dtype = dtype
        c1, c2 = cfg.enc_channels
        specs = ((cfg.in_channels, c1, 3, 2, 1), (c1, c2, 3, 2, 1),
                 (c2, cfg.embedding_dim, 1, 1, 0))
        params = cfg.lif.to_params()
        self.convs = nn.ModuleList(
            [SeqConv(cin, cout, k, s, p, dtype=dtype) for cin, cout, k, s, p in specs])
        self.bns = nn.ModuleList([SeqBatchNorm(spec[1], dtype=dtype) for spec in specs])
        self.lifs = nn.ModuleList(
            [LIF(params, cfg.num_steps, _lif_backend(lif_backend)) for _ in specs])

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        """(N, C, H, W), the input of every step -> spikes (T*N, D, h, w)."""
        h = image if self.dtype is None else image.to(self.dtype)
        t_in = 1
        for conv, bn, lif in zip(self.convs, self.bns, self.lifs):
            h = bn_spikes(conv(h), bn, lif, t_in, self.backend, conv.model_mesh)
            t_in = lif.num_steps
        return h


class VectorQuantizer(nn.Module):
    """Hybrid time-collapse readout, L2-nearest codebook lookup,
    straight-through estimator, the analog and PSP commitment losses, and
    the adaptive spike generator (Conv1x1 + BN + LIF) that re-spikes the
    quantized vectors.

    Under data parallelism (``mesh``, set by ``parallel.sync_batchnorm``)
    the batch mean of the soft codebook usage of ``usage_loss_weight`` is
    averaged over the ranks before its log; the other terms are means
    over equal shards, which the gradient all-reduce averages. Tensor
    parallel (``model_mesh``, set by ``parallel.shard_state_tp``): each
    rank holds rows of the codebook, and the distances, the argmin and the
    lookup run on the whole codebook gathered from every rank, so that the
    codes are one process's."""

    def __init__(self, cfg: VQVAEConfig, lif_backend: str = "auto"):
        super().__init__()
        self.cfg = cfg
        self.backend = lif_backend
        self.mesh = None
        self.model_mesh: Optional[Mesh] = None
        d = cfg.embedding_dim
        self.embeddings = nn.Parameter(torch.zeros(cfg.num_embeddings, d))
        self.alpha = nn.Parameter(torch.tensor(0.5))
        self.poisson_conv = SeqConv(d, d, 1)
        self.poisson_bn = SeqBatchNorm(d)
        self.poisson_lif = LIF(cfg.lif.to_params(), cfg.num_steps,
                               _lif_backend(lif_backend))

    def readout(self, z_seq: torch.Tensor) -> torch.Tensor:
        """Spikes (T*N, D, h, w) -> (N, D, h, w) fp32: (1 - alpha) times the
        membrane readout plus alpha times the rate, each taken in the
        spikes' dtype."""
        t_steps = self.cfg.num_steps
        z = z_seq.reshape((t_steps, -1) + tuple(z_seq.shape[1:]))
        rate = torch.sum(z, dim=0) / t_steps
        memout = membrane_output(z, self.cfg.memout_decay)
        return (1.0 - self.alpha) * memout.float() + self.alpha * rate.float()

    def codebook(self) -> torch.Tensor:
        """The whole (K, D) codebook."""
        return gather_rows(self.embeddings, self.model_mesh)

    @staticmethod
    def _distances(flat_x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
        return (torch.sum(flat_x ** 2, dim=1, keepdim=True) + torch.sum(e ** 2, dim=1)
                - 2.0 * (flat_x @ e.T))

    def get_code_indices(self, flat_x: torch.Tensor,
                         e: Optional[torch.Tensor] = None) -> torch.Tensor:
        """L2-nearest codebook entry of each row of (M, D); the first index
        among ties. ``e``: the codebook, if the caller has it."""
        return torch.argmin(self._distances(flat_x, self.codebook() if e is None else e), dim=1)

    def quantize(self, indices: torch.Tensor, e: Optional[torch.Tensor] = None) -> torch.Tensor:
        """indices (...,) -> codebook vectors (..., D)."""
        return (self.codebook() if e is None else e)[indices]

    def respike(self, q: torch.Tensor) -> torch.Tensor:
        """Analog (N, D, h, w) -> spikes (T*N, D, h, w): Conv1x1 + BN once
        on the N rows, repeated over the T steps into the LIF (or K3)."""
        return bn_spikes(self.poisson_conv(q), self.poisson_bn, self.poisson_lif, 1,
                         self.backend, self.poisson_conv.model_mesh)

    def forward(self, z_seq: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Encoder spikes (T*N, D, h, w) -> (re-spiked quantized train, the
        loss) in training mode, (the train, indices (N*h*w,)) in eval."""
        c = self.cfg
        x_bar = self.readout(z_seq)  # (N, D, h, w)
        n, d, h, w = x_bar.shape
        flat = x_bar.permute(0, 2, 3, 1).reshape(-1, d)
        e = self.codebook()
        indices = self.get_code_indices(flat, e)
        quantized = self.quantize(indices, e).reshape(n, h, w, d).permute(0, 3, 1, 2)
        if not self.training:
            return self.respike(quantized), indices

        # the analog codebook and commitment loss
        q_latent = torch.mean((quantized - x_bar.detach()) ** 2)
        e_latent = torch.mean((x_bar - quantized.detach()) ** 2)
        loss_1 = q_latent + c.commitment_cost * e_latent
        if c.usage_loss_weight > 0.0:
            # KL(soft codebook usage over the batch || uniform)
            usage = torch.mean(torch.softmax(-self._distances(flat, e), dim=1), dim=0)
            usage = all_reduce_mean(usage, self.mesh)
            kl_uniform = torch.sum(
                usage * (torch.log(usage + 1e-12) + math.log(c.num_embeddings)))
            loss_1 = loss_1 + c.usage_loss_weight * kl_uniform

        quantized = x_bar + (quantized - x_bar).detach()  # straight-through
        spikes = self.respike(quantized)

        # the PSP commitment pair in one pass: psp is linear, so
        # mean((psp(q) - sg psp(z))^2) + beta * mean((sg psp(q) - psp(z))^2)
        # is v = mean(psp(q - z)^2) with the gradient toward z scaled by beta
        beta = c.commitment_cost
        diff = spikes - (beta * z_seq + (1.0 - beta) * z_seq.detach())
        diff = diff.reshape((c.num_steps, -1) + tuple(diff.shape[1:]))
        v = torch.mean(psp(diff, c.psp_tau_s) ** 2)
        return spikes, loss_1 + v + (beta * v).detach()


class Decoder(nn.Module):
    """2 x (deconv stride 2 + BN + LIF), then a bare stride-1 deconv whose
    fp32 output feeds the membrane readout."""

    def __init__(self, cfg: VQVAEConfig, lif_backend: str = "auto",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.backend = lif_backend
        self.dtype = dtype
        d1, d2 = cfg.dec_channels
        params = cfg.lif.to_params()
        self.deconvs = nn.ModuleList([
            SeqConvTranspose(cfg.embedding_dim, d1, 3, stride=2, padding=1,
                             output_padding=1, dtype=dtype),
            SeqConvTranspose(d1, d2, 3, stride=2, padding=1, output_padding=1,
                             dtype=dtype),
            SeqConvTranspose(d2, cfg.in_channels, 3, stride=1, padding=1, dtype=dtype),
        ])
        self.bns = nn.ModuleList([SeqBatchNorm(d1, dtype=dtype),
                                  SeqBatchNorm(d2, dtype=dtype)])
        self.lifs = nn.ModuleList(
            [LIF(params, cfg.num_steps, _lif_backend(lif_backend)) for _ in range(2)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        for deconv, bn, lif in zip(self.deconvs, self.bns, self.lifs):
            x = bn_spikes(deconv(x), bn, lif, lif.num_steps, self.backend, deconv.model_mesh)
        last = self.deconvs[-1]
        return gather_channels(last(x), last.model_mesh).float()


class SNNVQVAE(nn.Module):
    """Encoder -> spiking quantizer -> decoder -> tanh(membrane readout)."""

    def __init__(self, cfg: VQVAEConfig = VQVAEConfig(),
                 lif_backend: str = "auto", dtype: Optional[torch.dtype] = None):
        super().__init__()
        _lif_backend(lif_backend)
        if dtype not in (None, torch.bfloat16):
            raise TypeError(f"the VQ-VAE's dtype is None or bfloat16, not {dtype}")
        self.cfg = cfg
        self.lif_backend = lif_backend
        self.dtype = dtype
        self.encoder = Encoder(cfg, lif_backend, dtype)
        self.vq_layer = VectorQuantizer(cfg, lif_backend)
        self.decoder = Decoder(cfg, lif_backend, dtype)

    def forward(self, image: torch.Tensor, train: Optional[bool] = None,
                data_variance: float = 1.0) -> Dict[str, torch.Tensor]:
        """Images (N, H, W, C) in [-0.5, 0.5], the same at every step.

        In training mode (``train``, else the module's mode): ``vq_loss``,
        ``recon_loss`` (the MSE over ``data_variance``), ``real_recon_loss``
        and ``recon`` (N, H, W, C). In eval mode: ``recon``, ``indices``
        (N*h*w,) and the re-spiked ``spikes`` (T, N, h, w, D).
        """
        train = self.training if train is None else train
        with _mode(self, train):
            z_seq = self.encoder(image.permute(0, 3, 1, 2))
            e_seq, second = self.vq_layer(z_seq)
            recon = self.decode_spikes(e_seq).permute(0, 2, 3, 1)
            if not train:
                t_steps = self.cfg.num_steps
                spikes = e_seq.reshape((t_steps, -1) + tuple(e_seq.shape[1:]))
                return {"recon": recon, "indices": second,
                        "spikes": spikes.permute(0, 1, 3, 4, 2)}
            real_recon_loss = torch.mean((recon - image) ** 2)
            return {"vq_loss": second, "recon_loss": real_recon_loss / data_variance,
                    "real_recon_loss": real_recon_loss, "recon": recon}

    def decode_spikes(self, spikes: torch.Tensor) -> torch.Tensor:
        """Spikes (T*N, D, h, w) -> images (N, C, H, W), tanh of the
        decay^(T-1-t) membrane readout."""
        x = self.decoder(spikes)
        x_seq = x.reshape((self.cfg.num_steps, -1) + tuple(x.shape[1:]))
        return torch.tanh(membrane_output(x_seq, self.cfg.memout_decay))

    def encode_indices(self, image: torch.Tensor) -> torch.Tensor:
        """Images (N, H, W, C) in [-0.5, 0.5] -> (N, h, w) int32 code grids,
        in eval mode."""
        with _mode(self, False):
            z_seq = self.encoder(image.permute(0, 3, 1, 2))
            x_bar = self.vq_layer.readout(z_seq)
            n, d, h, w = x_bar.shape
            flat = x_bar.permute(0, 2, 3, 1).reshape(-1, d)
            return self.vq_layer.get_code_indices(flat).reshape(n, h, w).to(torch.int32)

    def decode_indices(self, indices: torch.Tensor) -> torch.Tensor:
        """(N, h, w) code indices -> images (N, H, W, C), in eval mode."""
        with _mode(self, False):
            q = self.vq_layer.quantize(indices.long()).permute(0, 3, 1, 2)
            spikes = self.vq_layer.respike(q.contiguous())
            return self.decode_spikes(spikes).permute(0, 2, 3, 1)
