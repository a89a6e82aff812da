"""Stage 2: train the absorbing-diffusion prior over VQ code grids.

Counterpart of ``spiking_diffusion_tpu/train/stage2.py``
(``make_train_step_diffusion``, ``train_diffusion``): one step draws the
corruption, runs the denoiser's training forward, takes the mean
per-sample loss (reweighted ELBO by default), backpropagates through
time and applies AdamW; the forward moves the BN running statistics.
On the card the denoiser's LIF layers run K1 forward and backward
('auto'), its BN-apply + LIF blocks run K3 ('bnlif'), or its convs also
run K4 ('bnlifconv'); a bf16 denoiser trains the same way. Randomness
comes from an explicit ``torch.Generator`` on the run's device.

Data parallel (``make_train_step_diffusion_dp``, ``train_diffusion(
data_parallel=n)``; JAX ``train/stage2.py:60-125``, ``:160-187``): one
process per rank (``parallel``), each with a full replica. The corruption
is drawn on the global batch from a generator seeded alike on every rank,
as JAX draws it outside its ``shard_map``, then sliced; each rank runs its
rows with SyncBN on every branch (its kernels on its shard), and the loss
and the gradients are averaged over the ranks before AdamW: the
single-device step on the global batch, draw for draw, up to the order of
its sums.

Tensor parallel (``make_train_step_diffusion_tp``; JAX ``parallel/tp.py``
with ``make_train_step_diffusion``): over a ``parallel.Mesh2D`` the
denoiser holds this rank's output channels (``parallel.shard_state_tp``),
its logits sharded on K and gathered by the model; the corruption is drawn
on the global batch and sliced by data row, and the step is the
data-parallel step over the mesh's data group.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from spiking_diffusion_tpu_torch import parallel
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
    return _make_step(cfg, None)


def make_train_step_diffusion_dp(cfg: DiffusionConfig, mesh: parallel.Mesh) -> TrainStep:
    """:func:`make_train_step_diffusion` over ``mesh``'s ranks: each rank
    passes the same global batch and the same generator state (or the
    same drawn corruption of the global batch), runs its rows, and the
    loss and the gradients are averaged over the ranks. The denoiser must
    be a replica (``parallel.replicate``) with its BN synced
    (``parallel.sync_batchnorm``)."""
    return _make_step(cfg, mesh)


def make_train_step_diffusion_tp(cfg: DiffusionConfig, mesh: parallel.Mesh2D,
                                  device="cuda") -> TrainStep:
    """:func:`make_train_step_diffusion` over ``mesh``'s (data x model)
    ranks: each rank passes the same global batch and generator state (or
    drawn corruption) and runs its data row's rows on its channels; the
    loss and the gradients are averaged over the data group. The denoiser
    must be a replica (``parallel.replicate`` over ``mesh.world``) with its
    BN synced over ``mesh.data`` (``parallel.sync_batchnorm``) in a state
    sharded by ``parallel.shard_state_tp``. Runs on the card unless
    ``device="cpu"`` is passed (the mesh's device)."""
    parallel.tp.check_device(mesh, device)
    return _make_step(cfg, mesh.data if mesh.dp > 1 else None)


def _make_step(cfg: DiffusionConfig, mesh: Optional[parallel.Mesh]) -> TrainStep:
    def train_step(state: TrainState, x0: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   corruption: Optional[diffusion.Corruption] = None):
        model = state.model
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        if mesh is not None:
            if corruption is None:
                if generator is None:
                    raise ValueError("pass a torch.Generator or a drawn corruption")
                corruption = diffusion.corrupt(x0, cfg, generator)
            corruption = tuple(parallel.shard_batch(c, mesh) for c in corruption)
        loss = diffusion.train_loss(model, x0, cfg, generator, corruption)
        loss.backward()
        if mesh is not None:
            (loss,) = parallel.all_reduce_gradients(model.parameters(), mesh, loss)
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
    epoch, on every rank that passes one.

    ``data_parallel > 1``: this process is one of that many ranks
    (``parallel.launch`` or ``torchrun``); the denoiser is replicated from
    rank 0 and its BN synced (a denoiser synced over another process
    group raises ``ValueError``), and each step is
    :func:`make_train_step_diffusion_dp` on the global batch, the
    generator seeded alike on every rank. ``batch_size`` must divide by
    ``data_parallel``.
    """
    if data_parallel > 1:
        if batch_size % data_parallel:
            raise ValueError("batch_size must divide by data_parallel")
        mesh = parallel.make_mesh(data_parallel, device=device)
        dev = mesh.device
        parallel.replicate(parallel.sync_batchnorm(denoiser.to(dev), mesh), mesh)
        step_fn = make_train_step_diffusion_dp(cfg, mesh)
    else:
        dev = resolve_device(device)
        step_fn = make_train_step_diffusion(cfg)
    state = create_train_state(denoiser.to(dev), learning_rate, weight_decay)
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
