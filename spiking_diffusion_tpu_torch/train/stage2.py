"""Stage 2: train the absorbing-diffusion prior over VQ code grids.

Counterpart of ``spiking_diffusion_tpu/train/stage2.py``
(``make_train_step_diffusion``, ``train_diffusion``): one step draws the
corruption, runs the denoiser's training forward, takes the mean
per-sample loss (reweighted ELBO by default), backpropagates through
time and applies AdamW; the forward moves the BN running statistics.
On the card the denoiser's LIF layers run K1 forward and backward
('auto'), its BN-apply + LIF blocks run K3 ('bnlif'), or its convs also
run K4 ('bnlifconv'); a bf16 denoiser trains the same way. Single device;
randomness from an explicit ``torch.Generator`` on the run's device.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from spiking_diffusion_tpu_torch.config import DiffusionConfig
from spiking_diffusion_tpu_torch.device import resolve_device
from spiking_diffusion_tpu_torch.models import diffusion
from spiking_diffusion_tpu_torch.train.state import TrainState, create_train_state

TrainStep = Callable[..., Dict[str, torch.Tensor]]


def make_train_step_diffusion(cfg: DiffusionConfig) -> TrainStep:
    """A step ``(state, x0 (N, h, w) int, generator=None, corruption=None)
    -> {"loss": scalar}`` that updates ``state`` in place.

    The corruption is drawn from ``generator`` (on x0's device) unless a
    drawn ``(x_t, t, pt, x_0_ignore)`` is given. The gradients stay in the
    parameters' ``.grad`` until the next step.
    """

    def train_step(state: TrainState, x0: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   corruption: Optional[diffusion.Corruption] = None):
        model = state.model
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss = diffusion.train_loss(model, x0, cfg, generator, corruption)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return {"loss": loss.detach()}

    return train_step


def train_diffusion(
    denoiser: torch.nn.Module,
    cfg: DiffusionConfig,
    indices,
    epochs: int = 1,
    batch_size: int = 32,
    learning_rate: float = 1e-3,
    weight_decay: float = 1e-3,
    seed: int = 42,
    log_every: int = 20,
    log_fn: Optional[Callable[[str], None]] = print,
    epoch_callback: Optional[Callable[[int, TrainState], None]] = None,
    data_parallel: int = 1,
    device="cuda",
) -> TrainState:
    """Full stage-2 loop over (N, h, w) code grids with an initialised
    denoiser; returns the train state.

    Runs on the card unless ``device="cpu"`` is passed. The code grids
    stay on the device and each batch is gathered there; the epoch's
    order is ``np.random.RandomState(seed * 7919 + epoch)``'s shuffle, as
    in the JAX loop, and the corruption comes from a ``torch.Generator``
    seeded with ``seed``. ``epoch_callback(epoch, state)`` runs after each
    epoch. One card only: ``data_parallel > 1`` raises.
    """
    if data_parallel > 1:
        raise NotImplementedError("stage-2 data parallel is not ported; train on one card")
    dev = resolve_device(device)
    state = create_train_state(denoiser.to(dev), learning_rate, weight_decay)
    step_fn = make_train_step_diffusion(cfg)
    generator = torch.Generator(device=dev).manual_seed(seed)
    data = torch.as_tensor(indices, dtype=torch.int32).to(dev)
    n = data.shape[0]
    steps_per_epoch = n // batch_size
    for epoch in range(epochs):
        t_start = time.time()
        order = np.arange(n)
        np.random.RandomState(seed * 7919 + epoch).shuffle(order)
        for i in range(steps_per_epoch):
            sel = torch.as_tensor(order[i * batch_size:(i + 1) * batch_size], device=dev)
            metrics = step_fn(state, data[sel], generator)
            if log_fn and ((i + 1) % log_every == 0 or i + 1 == steps_per_epoch):
                log_fn(f"[{epoch}/{epochs}][{i}/{steps_per_epoch}]: "
                       f"loss {float(metrics['loss']):.3f}")
        if log_fn:
            log_fn(f"diff epoch {epoch} done in {time.time() - t_start:.1f}s")
        if epoch_callback:
            epoch_callback(epoch, state)
    return state
