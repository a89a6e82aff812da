"""Checkpoints of a train state: step, model state dict (parameters and
BN running statistics) and optimizer state dict, in one ``torch.save``
file ``<ckpt_dir>/<name>.pt``.

The port's own format, beside the JAX package's orbax trees, which it
neither reads nor writes (``models/weights.py`` carries JAX variables
across).
"""

from __future__ import annotations

import os

import torch

from spiking_diffusion_tpu_torch.train.state import TrainState


def checkpoint_path(ckpt_dir: str, name: str = "model") -> str:
    return os.path.abspath(os.path.join(ckpt_dir, f"{name}.pt"))


def save_checkpoint(state: TrainState, ckpt_dir: str, name: str = "model") -> str:
    """Write ``state`` to ``<ckpt_dir>/<name>.pt`` (replacing it whole);
    returns the path."""
    path = checkpoint_path(ckpt_dir, name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"step": state.step, "model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict()}, tmp)
    os.replace(tmp, path)
    return path


def restore_checkpoint(state: TrainState, ckpt_dir: str, name: str = "model") -> TrainState:
    """Load a checkpoint into ``state`` (same model and optimizer layout),
    onto the model's device; returns ``state``."""
    device = next(state.model.parameters()).device
    ckpt = torch.load(checkpoint_path(ckpt_dir, name), map_location=device,
                      weights_only=True)
    state.model.load_state_dict(ckpt["model"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = int(ckpt["step"])
    return state


def checkpoint_exists(ckpt_dir: str, name: str = "model") -> bool:
    return os.path.isfile(checkpoint_path(ckpt_dir, name))
