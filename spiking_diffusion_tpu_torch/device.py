"""Device choice of the port's entry points.

Entry points run on the card unless the caller names the CPU: their
``device`` defaults to ``"cuda"``, and without a card that raises
instead of running on the CPU.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the port runs on 'cuda' or 'cpu', not {dev}")
    return dev


@contextlib.contextmanager
def full_fp32():
    """fp32 convolutions and matrix products without TF32, whatever the
    caller's global setting (cuDNN's default is TF32 on)."""
    old = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old
