"""Event-stream (neuromorphic/DVS) utilities of the port, host numpy:
``spikingjelly/datasets/``'s core, counterpart of
``spiking_diffusion_tpu/data/events.py`` with bitwise the same results.

An event stream (t, x, y, p) becomes count frames by equal time or equal
event-count bins (``integrate_events_to_frames``, the C++ loop of
:mod:`spiking_diffusion_tpu_torch.native` unless ``use_native=False``), or
a bilinear-in-time voxel grid (``events_to_voxel_grid``). Frames are NHWC
(T, H, W, 2); they go to the card as whole batches.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def integrate_events_to_frames(
    events: Dict[str, np.ndarray],
    H: int,
    W: int,
    num_frames: int,
    split_by: str = "time",
    use_native: bool = True,
) -> np.ndarray:
    """(t, x, y, p) event stream -> (num_frames, H, W, 2) count frames.

    ``split_by``: 'time' slices the recording into equal-duration bins;
    'number' into equal-event-count bins (parity with the reference's two
    integrators). The frame of event i is ``(t_i - t_0) * F // (span + 1)``
    ('time', span = max(t_last - t_0, 1)) or ``i * F // n`` ('number'),
    clamped to F - 1. ``use_native`` takes the C++ loop
    (:mod:`spiking_diffusion_tpu_torch.native`, built at first use; a failed
    build raises): np.add.at is a serial scatter and this is the per-sample
    hot loop of event datasets. ``use_native=False`` is the plain numpy
    version, the same frames bitwise. Any nonzero polarity counts in channel
    1. A coordinate outside the frame, or ('time') an event before t_0,
    raises ValueError on either route.
    """
    if use_native:
        from spiking_diffusion_tpu_torch import native

        return native.integrate_events_to_frames(events, H, W, num_frames, split_by)
    t = np.asarray(events["t"], np.int64)
    x = np.asarray(events["x"], np.int64)
    y = np.asarray(events["y"], np.int64)
    p = np.asarray(events["p"], np.int64)
    n = t.shape[0]
    frames = np.zeros((num_frames, H, W, 2), np.float32)
    if n == 0:
        return frames

    if split_by == "time":
        t0, t1 = t[0], t[-1]
        span = max(int(t1 - t0), 1)
        idx = np.minimum(
            ((t - t0) * num_frames) // (span + 1), num_frames - 1
        )
    elif split_by == "number":
        idx = np.minimum(np.arange(n) * num_frames // n, num_frames - 1)
    else:
        raise ValueError(f"unknown split_by {split_by!r}")
    # the C++ loop's checks: numpy would wrap a negative index around
    early = split_by == "time" and bool((t < t[0]).any())
    if early or (x < 0).any() or (x >= W).any() or (y < 0).any() or (y >= H).any():
        raise ValueError("event coordinates out of bounds")
    np.add.at(frames, (idx, y, x, (p != 0).astype(np.int64)), 1.0)
    return frames


def events_to_voxel_grid(
    events: Dict[str, np.ndarray], H: int, W: int, num_bins: int
) -> np.ndarray:
    """Bilinear-in-time voxel grid (num_bins, H, W) with polarity ±1 —
    the common DVS representation for analog-input SNNs."""
    t = np.asarray(events["t"], np.float64)
    x = np.asarray(events["x"], np.int64)
    y = np.asarray(events["y"], np.int64)
    pol = np.asarray(events["p"], np.float32) * 2.0 - 1.0
    grid = np.zeros((num_bins, H, W), np.float32)
    if t.size == 0:
        return grid
    t0, t1 = t[0], t[-1]
    tau = (t - t0) / max(t1 - t0, 1e-9) * (num_bins - 1)
    lo = np.floor(tau).astype(np.int64)
    frac = (tau - lo).astype(np.float32)
    hi = np.minimum(lo + 1, num_bins - 1)
    np.add.at(grid, (lo, y, x), pol * (1 - frac))
    np.add.at(grid, (hi, y, x), pol * frac)
    return grid


def random_temporal_delete(
    frames: np.ndarray, keep: int, rng: np.random.RandomState
) -> np.ndarray:
    """Temporal augmentation: keep a random contiguous window of ``keep``
    frames (spikingjelly ``RandomTemporalDelete``)."""
    t = frames.shape[0]
    if keep >= t:
        return frames
    start = rng.randint(0, t - keep + 1)
    return frames[start : start + keep]
