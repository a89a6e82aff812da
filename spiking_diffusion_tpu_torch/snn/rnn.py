"""Spiking recurrent networks (spikingjelly ``rnn.py``).

Counterpart of ``spiking_diffusion_tpu/snn/rnn.py``: LSTM, GRU and Elman
cells whose every nonlinearity is a Heaviside spike with a surrogate
gradient, so the hidden states are binary; ``SpikingRNN`` loops a cell
over (T, N, F), and a second cell over the reversed sequence when
bidirectional. Linear layers hold PyTorch's (out, in) weights under
JAX's names (``ih``, ``hh``; the GRU's ``ih_zr``, ``hh_zr``, ``ih_n``,
``hh_n``), the input-to-hidden ones with a bias; gates split in JAX's
order (LSTM: i, f, g, o; GRU: z, r). Plain PyTorch on either device: a
``lax.scan`` without a kernel in JAX.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from spiking_diffusion_tpu_torch.snn.surrogate import SurrogateFn, atan


class SpikingLSTMCell(nn.Module):
    """i, f, g, o = Theta(W x + U h + b); c' = f c + i g, clamped to 1 with
    a straight-through gradient (the reference clamps under no_grad);
    h' = o c'."""

    def __init__(self, in_features: int, hidden: int, surrogate: SurrogateFn = atan):
        super().__init__()
        self.hidden, self.surrogate = hidden, surrogate
        self.ih = nn.Linear(in_features, 4 * hidden)
        self.hh = nn.Linear(hidden, 4 * hidden, bias=False)

    def forward(self, carry, x):
        h, c = carry
        gates = self.ih(x) + self.hh(h)
        i, f, g, o = (self.surrogate(v) for v in torch.chunk(gates, 4, dim=-1))
        c_raw = f * c + i * g  # can reach 2
        c_next = c_raw + (torch.clamp(c_raw, max=1.0) - c_raw).detach()
        h_next = o * c_next
        return (h_next, c_next), h_next

    def init_carry(self, batch: int, device=None):
        z = torch.zeros((batch, self.hidden), device=device)
        return (z, z)


class SpikingGRUCell(nn.Module):
    """z, r = Theta(W x + U h + b); n = Theta(W_n x + b_n + r * U_n h);
    h' = (1 - z) n + z h."""

    def __init__(self, in_features: int, hidden: int, surrogate: SurrogateFn = atan):
        super().__init__()
        self.hidden, self.surrogate = hidden, surrogate
        self.ih_zr = nn.Linear(in_features, 2 * hidden)
        self.hh_zr = nn.Linear(hidden, 2 * hidden, bias=False)
        self.ih_n = nn.Linear(in_features, hidden)
        self.hh_n = nn.Linear(hidden, hidden, bias=False)

    def forward(self, carry, x):
        (h,) = carry
        z, r = torch.chunk(self.ih_zr(x) + self.hh_zr(h), 2, dim=-1)
        z, r = self.surrogate(z), self.surrogate(r)
        n = self.surrogate(self.ih_n(x) + r * self.hh_n(h))
        h_next = (1.0 - z) * n + z * h
        return (h_next,), h_next

    def init_carry(self, batch: int, device=None):
        return (torch.zeros((batch, self.hidden), device=device),)


class SpikingVanillaRNNCell(nn.Module):
    """Elman cell: h' = Theta(W x + U h + b)."""

    def __init__(self, in_features: int, hidden: int, surrogate: SurrogateFn = atan):
        super().__init__()
        self.hidden, self.surrogate = hidden, surrogate
        self.ih = nn.Linear(in_features, hidden)
        self.hh = nn.Linear(hidden, hidden, bias=False)

    def forward(self, carry, x):
        (h,) = carry
        h_next = self.surrogate(self.ih(x) + self.hh(h))
        return (h_next,), h_next

    def init_carry(self, batch: int, device=None):
        return (torch.zeros((batch, self.hidden), device=device),)


CELLS = {"lstm": SpikingLSTMCell, "gru": SpikingGRUCell, "vanilla": SpikingVanillaRNNCell}


class SpikingRNN(nn.Module):
    """Multi-step (optionally bidirectional) spiking RNN over (T, N, F):
    (T, N, H) spike trains ((T, N, 2H) when bidirectional) and the final
    carry (a pair of carries when bidirectional)."""

    def __init__(self, in_features: int, hidden: int, cell_type: str = "lstm",
                 bidirectional: bool = False, surrogate: SurrogateFn = atan):
        super().__init__()
        if cell_type not in CELLS:
            raise ValueError(f"unknown cell_type {cell_type!r}")
        self.bidirectional = bidirectional
        self.fwd = CELLS[cell_type](in_features, hidden, surrogate)
        if bidirectional:
            self.bwd = CELLS[cell_type](in_features, hidden, surrogate)

    @staticmethod
    def _run(cell, x_seq) -> Tuple:
        carry = cell.init_carry(x_seq.shape[1], x_seq.device)
        ys = []
        for x in x_seq:
            carry, y = cell(carry, x)
            ys.append(y)
        return carry, torch.stack(ys)

    def forward(self, x_seq: torch.Tensor):
        carry_f, ys_f = self._run(self.fwd, x_seq)
        if not self.bidirectional:
            return ys_f, carry_f
        carry_b, ys_b = self._run(self.bwd, torch.flip(x_seq, [0]))
        return torch.cat([ys_f, torch.flip(ys_b, [0])], dim=-1), (carry_f, carry_b)
