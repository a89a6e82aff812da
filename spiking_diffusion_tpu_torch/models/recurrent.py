"""Stateful layer extras: NeuNorm, SynapseFilter, the recurrent
containers and threshold-dependent BatchNorm (spikingjelly ``layer.py``).

Counterparts of ``spiking_diffusion_tpu/models/recurrent.py``. Each
layer takes a (T, ...) sequence in JAX's layout (NeuNorm's spikes are
(T, N, H, W, C), its weight (1, H, W, C) as JAX's) and loops over T in
plain PyTorch on either device: they are ``lax.scan``s without a kernel
in JAX. The containers wrap a :class:`Cell`, ``(state, x_t) -> (state,
y_t)``, the functional analogue of a wrapped module.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch import nn

from spiking_diffusion_tpu_torch.models.layers import SeqBatchNorm
from spiking_diffusion_tpu_torch.snn.neuron import NeuronParams, lif_step


class Cell:
    """A stateful per-step cell: ``init_state(shape, device) -> state``
    and ``(state, x_t) -> (state, y_t)``."""

    def __init__(self, step_fn, init_fn):
        self._step = step_fn
        self._init = init_fn

    def init_state(self, shape, device=None):
        return self._init(shape, device)

    def __call__(self, state, x):
        return self._step(state, x)


def lif_cell(params: NeuronParams = NeuronParams()) -> Cell:
    """The LIF neuron as a container cell (v carried)."""
    return Cell(step_fn=lambda v, x: lif_step(v, x, params),
                init_fn=lambda shape, device: torch.full(shape, params.v_reset,
                                                         device=device))


def stateless_cell(fn: Callable[[torch.Tensor], torch.Tensor] = lambda x: x) -> Cell:
    """A stateless function as a container cell."""
    return Cell(step_fn=lambda s, x: (s, fn(x)),
                init_fn=lambda shape, device: torch.zeros((), device=device))


class NeuNorm(nn.Module):
    """Neuron normalisation (``layer.py:961-1045``; Wu et al. 2019) of
    (T, N, H, W, C) spike trains: aux[t] = k0 aux[t-1] + k1 sum_c s[t],
    out[t] = s[t] - w aux[t], k1 = (1 - k0) / C^2."""

    def __init__(self, height: int, width: int, channels: int, k: float = 0.9,
                 shared_across_channels: bool = False):
        super().__init__()
        self.k, self.channels = k, channels
        c = 1 if shared_across_channels else channels
        self.w = nn.Parameter(torch.zeros(1, height, width, c))

    def forward(self, s_seq: torch.Tensor) -> torch.Tensor:
        k0, k1 = self.k, (1.0 - self.k) / (self.channels ** 2)
        aux = torch.zeros(s_seq.shape[1:4] + (1,), device=s_seq.device)
        out = []
        for s in s_seq:
            aux = k0 * aux + k1 * torch.sum(s, dim=-1, keepdim=True)
            out.append(s - self.w * aux)
        return torch.stack(out)


class SynapseFilter(nn.Module):
    """Synaptic current low-pass (``layer.py:1182+``):
    I[t] = I[t-1] - (1 - S[t]) I[t-1] / tau + S[t]; with ``learnable``
    tau = 1 + exp(w), w from log(tau - 1)."""

    def __init__(self, tau: float = 100.0, learnable: bool = False):
        super().__init__()
        self.tau, self.learnable = tau, learnable
        if learnable:
            self.w = nn.Parameter(torch.tensor(math.log(tau - 1.0)))

    def forward(self, s_seq: torch.Tensor) -> torch.Tensor:
        tau = 1.0 + torch.exp(self.w) if self.learnable else self.tau
        i = torch.zeros(s_seq.shape[1:], device=s_seq.device)
        out = []
        for s in s_seq:
            i = i - (1.0 - s) * i / tau + s
            out.append(i)
        return torch.stack(out)


def element_wise_recurrent(cell: Cell, f: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                           x_seq: torch.Tensor) -> torch.Tensor:
    """ElementWiseRecurrentContainer: y[t] = cell(f(x[t], y[t-1]))."""
    y = torch.zeros(x_seq.shape[1:], device=x_seq.device)
    state = cell.init_state(tuple(x_seq.shape[1:]), x_seq.device)
    out = []
    for x in x_seq:
        state, y = cell(state, f(x, y))
        out.append(y)
    return torch.stack(out)


class LinearRecurrentContainer(nn.Module):
    """LinearRecurrentContainer: y[t] = cell(W [x[t]; y[t-1]] + b), W of
    (in, in + out) (``rc``, flax Dense's kernel transposed);
    ``out_features`` is the cell's output width."""

    def __init__(self, in_features: int, out_features: int, use_bias: bool = True):
        super().__init__()
        self.out_features = out_features
        self.rc = nn.Linear(in_features + out_features, in_features, bias=use_bias)

    def forward(self, x_seq: torch.Tensor, cell: Cell) -> torch.Tensor:
        lead = tuple(x_seq.shape[1:-1])
        y = torch.zeros(lead + (self.out_features,), device=x_seq.device)
        state = cell.init_state(lead + (x_seq.shape[-1],), x_seq.device)
        out = []
        for x in x_seq:
            state, y = cell(state, self.rc(torch.cat([x, y], dim=-1)))
            out.append(y)
        return torch.stack(out)


class ThresholdDependentBatchNorm(SeqBatchNorm):
    """tdBN (``ThresholdDependentBatchNorm2d``; Zheng et al. 2021) of a
    (T, N, ..., C) sequence: BatchNorm over every axis but the last, the
    scale starting at alpha * v_threshold. The port's ``SeqBatchNorm``
    arithmetic is flax ``nn.BatchNorm``'s: momentum 0.9, the biased
    (fast) batch variance in the running update."""

    def __init__(self, channels: int, alpha: float = 1.0, v_threshold: float = 1.0,
                 mesh=None):
        super().__init__(channels, mesh=mesh)
        with torch.no_grad():
            self.scale.fill_(alpha * v_threshold)

    def forward(self, x_seq: torch.Tensor) -> torch.Tensor:
        return super().forward(x_seq.reshape(-1, x_seq.shape[-1])).reshape(x_seq.shape)
