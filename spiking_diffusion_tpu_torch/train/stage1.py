"""Stage 1: train the VQ-VAE on images, then hand its codes to stage 2.

Counterpart of ``spiking_diffusion_tpu/train/stage1.py``
(``make_train_step_vqvae``, ``eval_step_vqvae``, ``extract_code_indices``,
``train_vqvae``): one step runs the VQ-VAE's training forward, takes
loss = vq_loss + recon_loss (the MSE over the data variance),
backpropagates through time and applies AdamW; the forward moves the BN
running statistics. Any stage-1 model serves whose training forward
``model(images, data_variance=...)`` returns the VQ-VAE's keys
(``vq_loss``, ``recon_loss``, ``real_recon_loss``), whose eval forward
``model(images, train=False)`` returns ``recon`` and ``indices``, and
which has ``encode_indices``: the spiking ``SNNVQVAE`` (``--model
snn-vq-vae``) and the ANN ``ANNVQVAE`` (``--model vq-vae``, no kernel).
On the card the spiking model's layerwise branch ('auto') runs every
LIF layer on K1 forward and backward, six of each per step; 'bnlif' runs
every BN-apply + LIF on K3, six forward and six backward.

Data parallel (``make_train_step_vqvae_dp``, ``train_vqvae(data_parallel=
n)``; JAX ``train/stage1.py:141-215``): one process per rank
(``parallel``), each with a full replica; a step takes the global batch,
runs this rank's rows with SyncBN (and the codebook-usage mean of
``snn-vq-vae-uni`` synced), and averages the loss and the gradients over
the ranks before AdamW, so every rank takes the same update: the
single-device step on the global batch, up to the order of its sums.

Tensor parallel (``make_train_step_vqvae_tp``; JAX ``parallel/tp.py`` with
``make_train_step_vqvae``): over a ``parallel.Mesh2D`` the model holds this
rank's output channels (``parallel.shard_state_tp``) and gathers them
itself; the step is the data-parallel step over the mesh's data group.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from spiking_diffusion_tpu_torch import parallel
from spiking_diffusion_tpu_torch.device import resolve_device
from spiking_diffusion_tpu_torch.train.state import TrainState, create_train_state

TrainStep = Callable[[TrainState, torch.Tensor], Dict[str, torch.Tensor]]


def make_train_step_vqvae(data_variance: float) -> TrainStep:
    """A step ``(state, images (N, H, W, C) in [-0.5, 0.5]) -> {"loss",
    "vq_loss", "recon_loss", "real_recon_loss"}`` that updates ``state``
    in place. The gradients stay in the parameters' ``.grad`` until the
    next step."""
    return _make_step(data_variance, None)


def make_train_step_vqvae_dp(data_variance: float, mesh: parallel.Mesh) -> TrainStep:
    """:func:`make_train_step_vqvae` over ``mesh``'s ranks: each rank
    passes the same global batch and runs its rows of it; the metrics and
    the gradients are averaged over the ranks. The model must be a replica
    (``parallel.replicate``) with its statistics synced
    (``parallel.sync_batchnorm``)."""
    return _make_step(data_variance, mesh)


def make_train_step_vqvae_tp(data_variance: float, mesh: parallel.Mesh2D,
                              device="cuda") -> TrainStep:
    """:func:`make_train_step_vqvae` over ``mesh``'s (data x model) ranks:
    each rank passes the same global batch and runs its data row's rows of
    it on its channels; the metrics and the gradients are averaged over the
    data group. The model must be a replica (``parallel.replicate`` over
    ``mesh.world``) synced over ``mesh.data`` (``parallel.sync_batchnorm``)
    in a state sharded by ``parallel.shard_state_tp``. Runs on the card
    unless ``device="cpu"`` is passed (the mesh's device)."""
    parallel.tp.check_device(mesh, device)
    return _make_step(data_variance, mesh.data if mesh.dp > 1 else None)


def _make_step(data_variance: float, mesh: Optional[parallel.Mesh]) -> TrainStep:
    def train_step(state: TrainState, images: torch.Tensor):
        model = state.model
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        if mesh is not None:
            images = parallel.shard_batch(images, mesh)
        out = model(images, data_variance=data_variance)
        loss = out["vq_loss"] + out["recon_loss"]
        loss.backward()
        metrics = (loss, out["vq_loss"], out["recon_loss"], out["real_recon_loss"])
        if mesh is not None:
            metrics = parallel.all_reduce_gradients(model.parameters(), mesh, *metrics)
        state.optimizer.step()
        state.step += 1
        return dict(zip(("loss", "vq_loss", "recon_loss", "real_recon_loss"),
                        (m.detach() for m in metrics)))

    return train_step


def eval_step_vqvae(model: nn.Module, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval forward: (recon images (N, H, W, C), code indices (N*h*w,))."""
    out = model(images, train=False)
    return out["recon"], out["indices"]


def extract_code_indices(model: nn.Module, images: np.ndarray, batch_size: int = 256,
                         device="cuda", data_parallel: int = 1) -> np.ndarray:
    """(N, h, w) int32 code grids of raw [0, 1] images (N, H, W, C) for
    stage-2 training, the remainder batch included.

    Runs on the card unless ``device="cpu"`` is passed; the model is moved
    there and runs in eval mode (each row is independent, so the JAX
    loop's zero padding of the remainder batch changes nothing). With
    ``data_parallel > 1`` rank 0 computes the codes and broadcasts them,
    so that every rank trains stage 2 on the same grids.
    """
    mesh = parallel.make_mesh(data_parallel, device=device) if data_parallel > 1 else None
    codes = None
    if mesh is None or mesh.rank == 0:
        dev = mesh.device if mesh else resolve_device(device)
        model.to(dev)
        chunks = []
        for i in range(0, images.shape[0], batch_size):
            batch = torch.as_tensor(images[i:i + batch_size], dtype=torch.float32).to(dev)
            chunks.append(model.encode_indices(batch - 0.5).cpu().numpy())
        codes = np.concatenate(chunks, axis=0).astype(np.int32)
    return codes if mesh is None else parallel.broadcast_object(codes, mesh)


def train_vqvae(
    model: nn.Module,
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
    initialised stage-1 model; returns the train state.

    Runs on the card unless ``device="cpu"`` is passed. The images stay on
    the device, each batch is gathered there and shifted by -0.5; the
    epoch's order is ``np.random.RandomState(seed * 100003 + epoch)``'s
    shuffle, as in the JAX loop (its ``batch_iterator``), and the
    remainder is dropped. ``epoch_callback(epoch, state)`` runs after each
    epoch, on every rank that passes one.

    ``data_parallel > 1``: this process is one of that many ranks
    (``parallel.launch`` or ``torchrun``); the model is replicated from
    rank 0 and synced (``parallel.sync_batchnorm``), and each step is
    :func:`make_train_step_vqvae_dp` on the global batch. ``batch_size``
    must divide by ``data_parallel``.
    """
    if data_parallel > 1:
        if batch_size % data_parallel:
            raise ValueError("batch_size must divide by data_parallel")
        mesh = parallel.make_mesh(data_parallel, device=device)
        dev = mesh.device
        parallel.replicate(parallel.sync_batchnorm(model.to(dev), mesh), mesh)
        step_fn = make_train_step_vqvae_dp(data_variance, mesh)
    else:
        dev = resolve_device(device)
        step_fn = make_train_step_vqvae(data_variance)
    state = create_train_state(model.to(dev), learning_rate, weight_decay)
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
