"""Stage 1: train the spiking VQ-VAE on images, then hand its codes to
stage 2.

Counterpart of ``spiking_diffusion_tpu/train/stage1.py``
(``make_train_step_vqvae``, ``eval_step_vqvae``, ``extract_code_indices``,
``train_vqvae``): one step runs the VQ-VAE's training forward, takes
loss = vq_loss + recon_loss (the MSE over the data variance),
backpropagates through time and applies AdamW; the forward moves the BN
running statistics. On the card the layerwise branch ('auto') runs every
LIF layer on K1 forward and backward, six of each per step; 'bnlif' runs
every BN-apply + LIF on K3, six forward and six backward. Single device.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from spiking_diffusion_tpu_torch.device import resolve_device
from spiking_diffusion_tpu_torch.models.vqvae import SNNVQVAE
from spiking_diffusion_tpu_torch.train.state import TrainState, create_train_state

TrainStep = Callable[[TrainState, torch.Tensor], Dict[str, torch.Tensor]]


def make_train_step_vqvae(data_variance: float) -> TrainStep:
    """A step ``(state, images (N, H, W, C) in [-0.5, 0.5]) -> {"loss",
    "vq_loss", "recon_loss", "real_recon_loss"}`` that updates ``state``
    in place. The gradients stay in the parameters' ``.grad`` until the
    next step."""

    def train_step(state: TrainState, images: torch.Tensor):
        model = state.model
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        out = model(images, data_variance=data_variance)
        loss = out["vq_loss"] + out["recon_loss"]
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return {"loss": loss.detach(), "vq_loss": out["vq_loss"].detach(),
                "recon_loss": out["recon_loss"].detach(),
                "real_recon_loss": out["real_recon_loss"].detach()}

    return train_step


def eval_step_vqvae(model: SNNVQVAE, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval forward: (recon images (N, H, W, C), code indices (N*h*w,))."""
    out = model(images, train=False)
    return out["recon"], out["indices"]


def extract_code_indices(model: SNNVQVAE, images: np.ndarray, batch_size: int = 256,
                         device="cuda") -> np.ndarray:
    """(N, h, w) int32 code grids of raw [0, 1] images (N, H, W, C) for
    stage-2 training, the remainder batch included.

    Runs on the card unless ``device="cpu"`` is passed; the model is moved
    there and runs in eval mode (each row is independent, so the JAX
    loop's zero padding of the remainder batch changes nothing).
    """
    dev = resolve_device(device)
    model.to(dev)
    chunks = []
    for i in range(0, images.shape[0], batch_size):
        batch = torch.as_tensor(images[i:i + batch_size], dtype=torch.float32).to(dev)
        chunks.append(model.encode_indices(batch - 0.5).cpu().numpy())
    return np.concatenate(chunks, axis=0).astype(np.int32)


def train_vqvae(
    model: SNNVQVAE,
    images: np.ndarray,
    data_variance: float,
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
    """Full stage-1 loop over raw [0, 1] images (N, H, W, C) with an
    initialised VQ-VAE; returns the train state.

    Runs on the card unless ``device="cpu"`` is passed. The images stay on
    the device, each batch is gathered there and shifted by -0.5; the
    epoch's order is ``np.random.RandomState(seed * 100003 + epoch)``'s
    shuffle, as in the JAX loop, and the remainder is dropped.
    ``epoch_callback(epoch, state)`` runs after each epoch. One card only:
    ``data_parallel > 1`` raises.
    """
    if data_parallel > 1:
        raise NotImplementedError("stage-1 data parallel is not ported; train on one card")
    dev = resolve_device(device)
    state = create_train_state(model.to(dev), learning_rate, weight_decay)
    step_fn = make_train_step_vqvae(data_variance)
    data = torch.as_tensor(images, dtype=torch.float32).to(dev)
    n = data.shape[0]
    steps_per_epoch = n // batch_size
    for epoch in range(epochs):
        t_start = time.time()
        order = np.arange(n)
        np.random.RandomState(seed * 100003 + epoch).shuffle(order)
        for i in range(steps_per_epoch):
            sel = torch.as_tensor(order[i * batch_size:(i + 1) * batch_size], device=dev)
            metrics = step_fn(state, data[sel] - 0.5)
            if log_fn and ((i + 1) % log_every == 0 or i + 1 == steps_per_epoch):
                log_fn(f"[{epoch}/{epochs}][{i}/{steps_per_epoch}]: "
                       f"loss {float(metrics['loss']):.3f} "
                       f"loss_eq {float(metrics['vq_loss']):.3f} "
                       f"loss_rec {float(metrics['real_recon_loss']):.3f}")
        if log_fn:
            seconds = time.time() - t_start
            log_fn(f"epoch {epoch} done in {seconds:.1f}s "
                   f"({steps_per_epoch / max(seconds, 1e-9):.1f} it/s)")
        if epoch_callback:
            epoch_callback(epoch, state)
    return state
