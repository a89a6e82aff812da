"""Train state: the model, its AdamW optimizer and the step count.

Counterpart of ``spiking_diffusion_tpu/train/state.py``. The optimizer is
AdamW(lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-3), as in
the reference's ``main.py``: decoupled weight decay on every parameter,
BatchNorm's scale and bias included, as ``optax.adamw`` applies it. The
BN running statistics are buffers of the model, updated by its training
forward. Unlike the JAX state the object is updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_adamw(
    params: Iterable[torch.Tensor],
    learning_rate: float = 1e-3,
    weight_decay: float = 1e-3,
    b1: float = 0.9,
    b2: float = 0.999,
) -> torch.optim.AdamW:
    return torch.optim.AdamW(params, lr=learning_rate, betas=(b1, b2), eps=1e-8,
                             weight_decay=weight_decay)


def create_train_state(
    model: nn.Module,
    learning_rate: float = 1e-3,
    weight_decay: float = 1e-3,
    b1: float = 0.9,
    b2: float = 0.999,
) -> TrainState:
    """Put ``model`` in training mode with a fresh AdamW over all its
    parameters."""
    model.train()
    return TrainState(model, make_adamw(model.parameters(), learning_rate,
                                        weight_decay, b1, b2))
