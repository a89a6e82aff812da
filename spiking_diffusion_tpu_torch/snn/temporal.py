"""Temporal primitives over the leading T axis: time-folded apply, PSP
filter and membrane readout.

``seq_apply`` runs a stateless layer once over (T*N, ...) (spikingjelly
``functional.seq_to_ann_forward``); ``psp`` is the first-order synaptic
low-pass, syn[t] = syn[t-1] + (x[t] - syn[t-1]) / tau_s from syn = 0,
returned for every t (reference ``snn_model/snn_layers.py:6-26``);
``membrane_output`` is the leaky readout out = sum_t decay^(T-1-t) * x[t]
(``snn_layers.py:28-41``).
"""

from __future__ import annotations

from typing import Callable

import torch


def seq_apply(fn: Callable[[torch.Tensor], torch.Tensor],
              x_seq: torch.Tensor) -> torch.Tensor:
    """Apply a stateless function over a (T, N, ...) sequence by folding
    time into batch: (T, N, ...) -> (T*N, ...) -> fn -> (T, N, ...)."""
    t, n = x_seq.shape[0], x_seq.shape[1]
    y = fn(x_seq.reshape((t * n,) + tuple(x_seq.shape[2:])))
    return y.reshape((t, n) + tuple(y.shape[1:]))


def psp(x_seq: torch.Tensor, tau_s: float = 2.0) -> torch.Tensor:
    """PSP filter of a (T, ...) tensor: the (T, ...) filtered sequence,
    in the JAX scan's operation order."""
    syn = torch.zeros(x_seq.shape[1:], dtype=x_seq.dtype, device=x_seq.device)
    out = []
    for t in range(x_seq.shape[0]):
        syn = syn + (x_seq[t] - syn) / tau_s
        out.append(syn)
    return torch.stack(out)


def membrane_output_coef(
    num_steps: int, decay: float = 0.8, dtype=torch.float32, device=None
) -> torch.Tensor:
    """(T,) readout weights decay^(T-1-t)."""
    arr = torch.arange(num_steps - 1, -1, -1, dtype=dtype, device=device)
    return torch.pow(torch.tensor(decay, dtype=dtype, device=device), arr)


def membrane_output(x_seq: torch.Tensor, decay: float = 0.8) -> torch.Tensor:
    """Leaky membrane readout of a (T, ...) tensor, summed over axis 0."""
    coef = membrane_output_coef(x_seq.shape[0], decay, x_seq.dtype,
                                x_seq.device)
    coef = coef.reshape((-1,) + (1,) * (x_seq.ndim - 1))
    return torch.sum(x_seq * coef, dim=0)
