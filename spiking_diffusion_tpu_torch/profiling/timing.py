"""Timing harness: counterpart of
``spiking_diffusion_tpu/profiling/timing.py``.

:func:`benchmark` warms a function up, then times each call: with CUDA
events on the card when its output lies there (the events wait for the
device, not the enqueue), with the host clock on the CPU. :func:`trace`
wraps ``torch.profiler`` and writes a Chrome trace (perfetto, chrome://
tracing).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict, Iterator

import torch

TRACE_FILE = "trace.json"


def _device_of(out: Any) -> torch.device:
    """The device of ``out`` (a tensor, or a dict, list or tuple of them):
    that of its first tensor off the CPU, else the CPU."""
    if isinstance(out, torch.Tensor):
        return out.device
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for value in out:
            dev = _device_of(value)
            if dev.type != "cpu":
                return dev
    return torch.device("cpu")


def benchmark(
    fn: Callable[..., Any],
    *args: Any,
    iters: int = 50,
    warmup: int = 2,
    **kwargs: Any,
) -> Dict[str, float]:
    """Time ``fn(*args, **kwargs)``: mean and min ms per call, calls/s."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args, **kwargs)
    dev = _device_of(out)
    times = []
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            torch.cuda.synchronize()
            for _ in range(iters):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn(*args, **kwargs)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) / 1e3)
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(*args, **kwargs)
            times.append(time.perf_counter() - t0)
    mean_s = sum(times) / len(times)
    return {
        "mean_ms": mean_s * 1e3,
        "min_ms": min(times) * 1e3,
        "calls_per_sec": 1.0 / mean_s,
        "iters": float(iters),
    }


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[str]:
    """Profile the block (the CPU, and the card where there is one) and
    write its Chrome trace to ``<log_dir>/trace.json``; yields ``log_dir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
