"""The SNN-VAE baseline (FSVAE-style), the CLI's ``--model snn-vae``.

Counterpart of ``spiking_diffusion_tpu/models/snn_vae.py`` (``_CausalMLP``,
``PosteriorBernoulli``, ``PriorBernoulli``, ``SNNVAE``): the spiking
VQ-VAE's encoder -> Linear + LIF to a ``latent_dim``-wide spike train ->
the posterior q(z_t | x_<=t, z_<t) draws binary z_t (one of ``k``
Bernoulli channels picked at random) -> the prior p(z_t | z_<t), with
scheduled sampling -> Linear + LIF to a (T, N, 7, 7, 16) spike train ->
the VQ-VAE's decoder -> tanh of the membrane readout; a PSP-space MMD
loss between the posterior's and the prior's Bernoulli means.

The posterior and prior are causal 3-layer Linear + LIF cells stepped
once per timestep, carrying each layer's membrane and z_{t-1}: one pass
over T (O(T)), as the JAX package's ``lax.scan``. They feed z_{t-1} back,
so they are a per-step loop of the plain ``lif_step``; the latent head
and the decoder input see inputs known for every step, so they run
through ``lif_multi_step`` with the model's backend (K1 on the card). The
encoder and decoder are ``models/vqvae.py``'s: their LIF layers run on K1
('auto') or, with BatchNorm's affine, on K3 ('bnlif').

Launches on the card per training step: 'auto' 7 K1 forward and 7 K1
backward (3 encoder, the head, the decoder input, 2 decoder); 'bnlif'
5 + 5 K3 and 2 + 2 K1. A ``sample`` call: 3 K1 forward (the decoder input
and the decoder) on either branch, or 1 K1 and 2 K3 on 'bnlif'.

Randomness comes from an explicit ``torch.Generator`` on the images'
device, and every draw can be passed in instead: the posterior's channel
``choice`` (T, B, C) in [0, k), the prior's scheduled-sampling
``coin_draws`` (T,) uniform in [0, 1) (step t takes the prior's own
sample when t >= 5 and its draw is below ``p_scheduled``) and its
``noise`` (T, B, C), N(0, 1), which the prior scales by 1e-3, and
``sample``'s ``choice``. Images are (N, H, W, C) in [-0.5, 0.5]; latents (T, B, C).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from spiking_diffusion_tpu_torch.config import SNNVAEConfig, VQVAEConfig
from spiking_diffusion_tpu_torch.models.vqvae import Decoder, Encoder, _lif_backend, _mode
from spiking_diffusion_tpu_torch.snn.neuron import NeuronParams, lif_multi_step, lif_step
from spiking_diffusion_tpu_torch.snn.temporal import membrane_output, psp

SCHEDULED_FROM = 5  # the first step that scheduled sampling may touch
NOISE_SCALE = 1e-3  # the prior's jitter on its own Bernoulli mean
PSP_TAU_S = 2.0  # the MMD loss's PSP filter


class _CausalMLP(nn.Module):
    """3 x (Linear + LIF) stepped one timestep at a time; the carry holds
    the three membranes."""

    def __init__(self, in_features: int, features: Tuple[int, ...], params: NeuronParams):
        super().__init__()
        widths = (in_features,) + tuple(features)
        self.denses = nn.ModuleList(
            [nn.Linear(i, o) for i, o in zip(widths[:-1], widths[1:])])
        self.params = params

    def init_carry(self, batch: int, device) -> List[torch.Tensor]:
        return [torch.zeros((batch, d.out_features), device=device) for d in self.denses]

    def step(self, carry: List[torch.Tensor], x_t: torch.Tensor):
        """(membranes, input (B, in)) -> (new membranes, spikes (B, out))."""
        new_carry = []
        h = x_t
        for dense, v in zip(self.denses, carry):
            v, h = lif_step(v, dense(h), self.params)
            new_carry.append(v)
        return new_carry, h


def _pick(p_t: torch.Tensor, choice_t: torch.Tensor) -> torch.Tensor:
    """(B, C, k) channel outputs, (B, C) channel picks -> (B, C)."""
    return torch.gather(p_t, -1, choice_t.long().unsqueeze(-1)).squeeze(-1)


class PosteriorBernoulli(nn.Module):
    """q(z_t | x_<=t, z_<t): q_z (T, B, C, k) and the binary latents z
    (T, B, C) picked from it by ``choice``."""

    def __init__(self, cfg: SNNVAEConfig):
        super().__init__()
        c = cfg.latent_dim
        self.k = cfg.k
        self.mlp = _CausalMLP(2 * c, (2 * c, 4 * c, c * cfg.k), cfg.lif.to_params())

    def forward(self, latent_x: torch.Tensor, choice: torch.Tensor):
        """latent_x: (T, B, C) spikes of the encoder head -> (z, q_z)."""
        t_steps, batch, c = latent_x.shape
        carry = self.mlp.init_carry(batch, latent_x.device)
        z_prev = torch.zeros((batch, c), device=latent_x.device)
        zs, qs = [], []
        for t in range(t_steps):
            carry, out = self.mlp.step(carry, torch.cat([latent_x[t], z_prev], dim=-1))
            q_t = out.reshape(batch, c, self.k)
            z_t = _pick(q_t, choice[t])
            # z_<t feeding the next step is observed, not differentiated through
            z_prev = z_t.detach()
            zs.append(z_t)
            qs.append(q_t)
        return torch.stack(zs), torch.stack(qs)


class PriorBernoulli(nn.Module):
    """p(z_t | z_<t) with scheduled sampling; also ancestral ``sample``."""

    def __init__(self, cfg: SNNVAEConfig):
        super().__init__()
        c = cfg.latent_dim
        self.cfg = cfg
        self.mlp = _CausalMLP(c, (2 * c, 4 * c, c * cfg.k), cfg.lif.to_params())

    def forward(self, z: torch.Tensor, p_scheduled: float = 0.0,
                coin_draws: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """z: (T, B, C) posterior samples -> p_z (T, B, C, k).

        The input of step t is z_{t-1} (zero at t = 0). With ``coin_draws``
        (scheduled sampling), a step t >= 5 whose draw is below
        ``p_scheduled`` takes instead the prior's own previous sample, its
        Bernoulli mean plus 1e-3 times ``noise`` (T, B, C) thresholded at
        0.5."""
        t_steps, batch, c = z.shape
        z = z.detach()
        carry = self.mlp.init_carry(batch, z.device)
        z_self = torch.zeros((batch, c), device=z.device)
        use_self = None
        if coin_draws is not None:
            steps = torch.arange(t_steps, device=z.device)
            use_self = (coin_draws < p_scheduled) & (steps >= SCHEDULED_FROM)
        out_z = []
        for t in range(t_steps):
            z_in = z[t - 1] if t > 0 else torch.zeros_like(z_self)
            if use_self is not None:
                z_in = torch.where(use_self[t], z_self, z_in)
            carry, out = self.mlp.step(carry, z_in)
            p_t = out.reshape(batch, c, self.cfg.k)
            if use_self is not None:
                z_self = (torch.mean(p_t, dim=-1) + NOISE_SCALE * noise[t] > 0.5).float()
            out_z.append(p_t)
        return torch.stack(out_z)

    def sample(self, choice: torch.Tensor) -> torch.Tensor:
        """Ancestral generation: z_t picked by ``choice`` (T, B, C) from
        the k channels of p(z_t | z_<t); returns z (T, B, C)."""
        t_steps, batch, c = choice.shape
        carry = self.mlp.init_carry(batch, choice.device)
        z_prev = torch.zeros((batch, c), device=choice.device)
        zs = []
        for t in range(t_steps):
            carry, out = self.mlp.step(carry, z_prev)
            z_prev = _pick(out.reshape(batch, c, self.cfg.k), choice[t])
            zs.append(z_prev)
        return torch.stack(zs)


class SNNVAE(nn.Module):
    """Encode -> posterior and prior -> decode; the MMD and recon losses.

    ``lif_backend``: 'auto' or 'torch' (layerwise, K1 or its plain
    versions) or 'bnlif' / 'bnlif_torch' (the encoder's and decoder's
    BN + LIF on K3); the heads take K1 ('auto') or its plain versions
    ('torch'), as ``models/vqvae.py`` maps them. fp32.
    """

    def __init__(self, cfg: SNNVAEConfig = SNNVAEConfig(),
                 vq_cfg: VQVAEConfig = VQVAEConfig(), lif_backend: str = "auto"):
        super().__init__()
        self.cfg = cfg
        self.vq_cfg = vq_cfg
        self.lif_backend = lif_backend
        self.head_backend = _lif_backend(lif_backend)
        self.neuron = cfg.lif.to_params()
        self.grid = (vq_cfg.embedding_dim, vq_cfg.latent_size, vq_cfg.latent_size)
        flat = vq_cfg.embedding_dim * vq_cfg.latent_size ** 2
        self.encoder = Encoder(vq_cfg, lif_backend)
        self.before_latent = nn.Linear(flat, cfg.latent_dim)
        self.posterior = PosteriorBernoulli(cfg)
        self.prior = PriorBernoulli(cfg)
        self.decoder_input = nn.Linear(cfg.latent_dim, flat)
        self.decoder = Decoder(vq_cfg, lif_backend)

    def _draws(self, shape, device, generator, choice, coin_draws, noise, scheduled):
        """The draws of one forward, each taken from ``generator`` unless
        given."""
        if choice is None:
            choice = torch.randint(0, self.cfg.k, shape, generator=generator, device=device)
        if not scheduled:
            return choice, None, None
        if coin_draws is None:
            coin_draws = torch.rand((shape[0],), generator=generator, device=device)
        if noise is None:
            noise = torch.randn(shape, generator=generator, device=device)
        return choice, coin_draws, noise

    def encode(self, image: torch.Tensor, generator: Optional[torch.Generator] = None,
               p_scheduled: float = 0.1, choice: Optional[torch.Tensor] = None,
               coin_draws: Optional[torch.Tensor] = None,
               noise: Optional[torch.Tensor] = None):
        """Images (N, H, W, C) -> (z (T, N, C), q_z, p_z (T, N, C, k)),
        in the module's mode; scheduled sampling in training only."""
        t_steps = self.cfg.num_steps
        z_seq = self.encoder(image.permute(0, 3, 1, 2))  # (T*N, D, h, w)
        z_seq = z_seq.reshape((t_steps, -1) + self.grid).permute(0, 1, 3, 4, 2)
        flat = z_seq.reshape(t_steps, z_seq.shape[1], -1)  # (T, N, h*w*D), flax's order
        latent_x = lif_multi_step(self.before_latent(flat), params=self.neuron,
                                  backend=self.head_backend)
        choice, coin_draws, noise = self._draws(
            latent_x.shape, image.device, generator, choice, coin_draws, noise,
            self.training)
        z, q_z = self.posterior(latent_x, choice)
        p_z = self.prior(z, p_scheduled, coin_draws, noise)
        return z, q_z, p_z

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Binary latents (T, B, C) -> images (B, H, W, C), in the
        module's mode."""
        t_steps, batch = z.shape[:2]
        spikes = lif_multi_step(self.decoder_input(z), params=self.neuron,
                                backend=self.head_backend)
        d, h, w = self.grid
        grid = spikes.reshape(t_steps, batch, h, w, d).permute(0, 1, 4, 2, 3)
        x = self.decoder(grid.reshape(t_steps * batch, d, h, w))
        x_seq = x.reshape((t_steps, batch) + tuple(x.shape[1:]))
        return torch.tanh(membrane_output(x_seq, self.vq_cfg.memout_decay)).permute(0, 2, 3, 1)

    def forward(self, image: torch.Tensor, generator: Optional[torch.Generator] = None,
                train: Optional[bool] = None, p_scheduled: float = 0.1,
                choice: Optional[torch.Tensor] = None,
                coin_draws: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """In training (``train``, else the module's mode): ``recon``,
        ``recon_loss`` (MSE), ``mmd_loss`` and ``z``; in eval ``recon`` and
        ``z``, without autograd."""
        train = self.training if train is None else train
        with _mode(self, train):
            z, q_z, p_z = self.encode(image, generator, p_scheduled, choice, coin_draws,
                                      noise)
            recon = self.decode(z)
            if not train:
                return {"recon": recon, "z": z}
            q_ber = torch.mean(q_z, dim=-1)
            p_ber = torch.mean(p_z, dim=-1)
            mmd_loss = torch.mean((psp(q_ber, PSP_TAU_S) - psp(p_ber, PSP_TAU_S)) ** 2)
            return {"recon": recon, "recon_loss": torch.mean((recon - image) ** 2),
                    "mmd_loss": mmd_loss, "z": z}

    def sample(self, batch: int = 64, generator: Optional[torch.Generator] = None,
               choice: Optional[torch.Tensor] = None):
        """Ancestral sampling from the prior, in eval mode: (images (B, H,
        W, C), z (T, B, C)). ``choice`` defaults to uniform draws from
        ``generator`` on the model's device."""
        if choice is None:
            choice = torch.randint(0, self.cfg.k, (self.cfg.num_steps, batch, self.cfg.latent_dim),
                                   generator=generator, device=next(self.parameters()).device)
        with _mode(self, False):
            z = self.prior.sample(choice)
            return self.decode(z), z
