"""Device choice of the port's entry points.

Entry points run on the card unless the caller names the CPU: their
``device`` defaults to ``"cuda"``, and without a card that raises
instead of running on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the port runs on 'cuda' or 'cpu', not {dev}")
    return dev
