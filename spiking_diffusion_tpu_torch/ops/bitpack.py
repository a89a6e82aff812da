"""Spike bit-packing: 8 spikes per uint8 byte.

Counterpart of ``spiking_diffusion_tpu/ops/bitpack.py``, with the same
bytes: the spikes flattened, zero-padded to a byte, packed LSB-first. It
is jnp there and no Pallas kernel, so here it is plain PyTorch on the
tensor's own device: shifts and a sum over uint8. A packed spike train
takes 1/8 of the bytes of a uint8 one and 1/32 of an fp32 one.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _shifts(device) -> torch.Tensor:
    return torch.arange(8, dtype=torch.uint8, device=device)


def pack_spikes(spikes: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """(…) float/bool spike tensor -> (ceil(n/8),) uint8 + original shape."""
    shape = tuple(spikes.shape)
    flat = spikes.reshape(-1).to(torch.uint8)
    pad = (-flat.numel()) % 8
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    bits = flat.reshape(-1, 8) << _shifts(flat.device)
    return bits.sum(dim=1).to(torch.uint8), shape


def unpack_spikes(packed: torch.Tensor, shape: Tuple[int, ...],
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`pack_spikes`, on ``packed``'s device."""
    bits = (packed[:, None] >> _shifts(packed.device)) & 1
    n = 1
    for d in shape:
        n *= int(d)
    return bits.reshape(-1)[:n].reshape(shape).to(dtype)
