"""Event-stream representation transforms of the port — ``spikingjelly.zip!
datasets/to_x_rep.py`` (tonic-style slicers + frame/voxel/bina-rep
conversions); counterpart of ``spiking_diffusion_tpu/data/transforms.py``,
host numpy.

The reference operates on structured numpy arrays with ``t/x/y/p`` dtype
names; here events are the ``{'t','x','y','p'}`` dict the rest of
``data/`` uses. Frames are NHWC (``(..., H, W, 2)``) like
:mod:`data.neuromorphic`; the reference's channel-first view is a
transpose.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np

from spiking_diffusion_tpu_torch.data.events import events_to_voxel_grid
from spiking_diffusion_tpu_torch.data.neuromorphic import (
    Events,
    integrate_by_fixed_frames,
)

__all__ = [
    "Compose",
    "slice_by_time_bins",
    "slice_by_event_count",
    "to_frame",
    "to_bina_rep",
    "to_voxel_grid",
    "to_image",
]


class Compose:
    """Chain transforms left-to-right (``to_x_rep.py:24-49``)."""

    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = list(transforms)

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x

    def __repr__(self) -> str:
        inner = ", ".join(repr(t) for t in self.transforms)
        return f"Compose([{inner}])"


def _take(events: Events, lo: int, hi: int) -> Events:
    return {k: v[lo:hi] for k, v in events.items()}


def slice_by_time_bins(
    events: Events, bin_count: int, overlap: float = 0.0
) -> List[Events]:
    """Fixed number of (optionally overlapping) time windows — parity with
    ``SliceByTimeBins`` (``to_x_rep.py:53-96``): window length =
    ``span // bin_count * (1 + overlap)``, stride = ``window *
    (1 - overlap)``; event indices via searchsorted."""
    if not overlap < 1:
        raise ValueError("overlap must be < 1")
    t = np.asarray(events["t"])
    window = (t[-1] - t[0]) // bin_count * (1 + overlap)
    stride = window * (1 - overlap)
    starts = np.arange(bin_count) * stride + t[0]
    ends = starts + window
    i0 = np.searchsorted(t, starts)
    i1 = np.searchsorted(t, ends)
    return [_take(events, lo, hi) for lo, hi in zip(i0, i1)]


def slice_by_event_count(
    events: Events,
    event_count: int,
    overlap: int = 0,
    include_incomplete: bool = False,
) -> List[Events]:
    """Fixed-event-count windows with integer overlap — parity with
    ``SliceByEventCount`` (``to_x_rep.py:98-141``)."""
    n = int(np.asarray(events["t"]).size)
    count = min(event_count, n)
    stride = event_count - overlap
    if stride <= 0:
        raise ValueError("stride (event_count - overlap) must be > 0")
    rounder = np.ceil if include_incomplete else np.floor
    n_slices = int(rounder((n - count) / stride) + 1)
    starts = (np.arange(n_slices) * stride).astype(int)
    return [_take(events, lo, lo + count) for lo in starts]


def to_frame(
    H: int, W: int, frames_num: int, split_by: str = "time"
) -> Callable[[Events], np.ndarray]:
    """``ToFrame`` factory: events -> ``(frames_num, H, W, 2)`` counts."""

    def apply(events: Events) -> np.ndarray:
        return integrate_by_fixed_frames(events, split_by, frames_num, H, W)

    return apply


def to_bina_rep(
    event_frames: np.ndarray, n_frames: int = 1, n_bits: int = 8
) -> np.ndarray:
    """Bina-Rep (Barchid et al. 2022): ``n_frames * n_bits`` binary frames
    -> ``n_frames`` frames of N-bit numbers in [0, 1]. Parity with
    ``to_bina_rep_numpy`` (``to_x_rep.py:301-357``), vectorized: bit i
    (MSB-first) weighs ``2^(n_bits-1-i) / (2^n_bits - 1)``. Accepts any
    frame layout with time leading: (T*B, ...) -> (T, ...)."""
    if n_frames < 1 or n_bits < 2:
        raise ValueError("need n_frames >= 1 and n_bits >= 2")
    if event_frames.shape[0] != n_frames * n_bits:
        raise ValueError(
            f"got {event_frames.shape[0]} frames, expected "
            f"{n_frames} x {n_bits} = {n_frames * n_bits}"
        )
    binary = (event_frames > 0).astype(np.float32)
    binary = binary.reshape((n_frames, n_bits) + event_frames.shape[1:])
    weights = 2.0 ** np.arange(n_bits - 1, -1, -1, dtype=np.float32)
    weights = weights.reshape((1, n_bits) + (1,) * (binary.ndim - 2))
    return (binary * weights).sum(axis=1) / (2.0 ** n_bits - 1.0)


def to_voxel_grid(
    H: int, W: int, n_time_bins: int = 10
) -> Callable[[Events], np.ndarray]:
    """``ToVoxelGrid`` factory: bilinear-in-time polarity voxel grid
    (``to_x_rep.py:389-461``; math in :func:`data.events
    .events_to_voxel_grid`)."""

    def apply(events: Events) -> np.ndarray:
        return events_to_voxel_grid(events, H, W, n_time_bins)

    return apply


def to_image(H: int, W: int) -> Callable[[Events], np.ndarray]:
    """``ToImage``: collapse a stream to one 2-channel count image."""

    def apply(events: Events) -> np.ndarray:
        return integrate_by_fixed_frames(events, "number", 1, H, W)[0]

    return apply
