"""Activation, membrane, gradient and device-memory monitors: counterpart
of ``spiking_diffusion_tpu/profiling/monitor.py`` (spikingjelly's
``monitor.py``).

  * :func:`capture_outputs`: every module's output of one call, by forward
    hooks (spikingjelly's OutputMonitor), keyed by the path the JAX
    package's ``capture_outputs`` gives the same module
    ('encoder/LIF_0'); the values are the port's tensors, in its layout
    (time folded into the batch, channels first).
  * :func:`spike_rates`: the firing rate of every LIF layer's output.
  * :func:`membrane_traces`: spikingjelly's AttributeMonitor('v') for one
    LIF layer: spikes, the membrane after each step and the last.
  * :func:`grad_norms`: per-parameter gradient L2 norms, keyed by the JAX
    package's parameter path.
  * :class:`DeviceMonitor`: a thread that samples the card's memory.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from spiking_diffusion_tpu_torch.profiling.syops import (
    flax_param_path,
    flax_path,
    n_block_convs,
)
from spiking_diffusion_tpu_torch.snn.neuron import NeuronParams, lif_scan


def capture_outputs(
    model: nn.Module,
    *args: Any,
    filter_fn: Optional[Callable[[str], bool]] = None,
    method: Optional[str] = None,
    **kwargs: Any,
) -> Dict[str, Any]:
    """Run ``model(*args, **kwargs)``, or its ``method``, without autograd,
    capturing every module's output, the model's own under ''.
    ``filter_fn`` takes the JAX path (e.g. 'encoder/LIF_0') and selects
    which to keep."""
    outs: Dict[str, Any] = {}
    n_convs = n_block_convs(model)
    handles = []
    try:
        for name, module in model.named_modules():
            if isinstance(module, nn.ModuleList):
                continue
            key = flax_path(name, n_convs)
            handles.append(module.register_forward_hook(
                lambda _m, _args, out, key=key: outs.__setitem__(key, out)))
        with torch.no_grad():
            (model if method is None else getattr(model, method))(*args, **kwargs)
    finally:
        for handle in handles:
            handle.remove()
    if filter_fn is not None:
        outs = {k: v for k, v in outs.items() if filter_fn(k)}
    return outs


def spike_rates(model: nn.Module, *args: Any, **kwargs: Any) -> Dict[str, float]:
    """Firing rate of every LIF layer's output spike train."""
    outs = capture_outputs(
        model, *args,
        filter_fn=lambda k: "/LIF" in k or k.endswith("LIF_0") or "lif" in k.lower(),
        **kwargs,
    )
    rates = {}
    for k, v in outs.items():
        if isinstance(v, torch.Tensor):
            vf = v.float()
            if len(torch.unique(vf)) <= 2 and vf.min() >= 0 and vf.max() <= 1:
                rates[k] = float(vf.mean())
    return rates


def membrane_traces(x_seq: torch.Tensor,
                    params: NeuronParams = NeuronParams()) -> Dict[str, torch.Tensor]:
    """One LIF layer over its input (T, ...): the spikes, the membrane after
    each step (T, ...) and the last membrane."""
    s_seq, v_seq, v_last = lif_scan(x_seq, params=params, return_v_seq=True)
    return {"spikes": s_seq, "v_seq": v_seq, "v_last": v_last}


def grad_norms(named_grads: Iterable[Tuple[str, Optional[torch.Tensor]]]) -> Dict[str, float]:
    """Per-parameter gradient L2 norms, keyed by the JAX package's
    parameter path ('encoder/SeqConv_0/Conv_0/kernel'). ``named_grads``:
    (name, gradient) of every parameter of a model, as ``((n, p.grad) for
    n, p in model.named_parameters())`` gives them; a parameter without a
    gradient is left out. A norm does not depend on the kernel's layout."""
    named = [(n, g) for n, g in named_grads if g is not None]
    if not named:
        return {}
    n_convs = len({n.split(".")[1] for n, _ in named if n.startswith("convs.")})
    norms = torch.stack([torch.linalg.vector_norm(g.float()) for _, g in named]).tolist()
    return {flax_param_path(n, n_convs): v for (n, _), v in zip(named, norms)}


class DeviceMonitor:
    """The GPUMonitor of spikingjelly's ``monitor.py``: a daemon thread
    samples each card's allocated and peak allocated bytes
    (``torch.cuda.memory_allocated``, ``max_memory_allocated``) every
    ``interval`` seconds. ``stop()`` returns the time series and
    ``summary()`` reduces it. Prints each sample when ``verbose``.

    A host with no card gives samples with the time only rather than
    failing: the monitor observes, it never stops a run.

        dm = DeviceMonitor(interval=1.0)
        ... work ...
        print(dm.stop_and_summary())
    """

    def __init__(self, interval: float = 10.0, devices=None,
                 start_now: bool = True, verbose: bool = False):
        self.interval = interval
        self.verbose = verbose
        self._devices = devices
        self._stop = threading.Event()
        self.records: list = []
        self._thread = threading.Thread(target=self._loop, daemon=True)
        if start_now:
            self.start()

    def _loop(self) -> None:
        devs = self._devices
        if devs is None:
            devs = list(range(torch.cuda.device_count())) if torch.cuda.is_available() else []
        while not self._stop.is_set():
            sample = {"t": time.time()}
            for d in devs:
                sample[str(d)] = {
                    "bytes_in_use": torch.cuda.memory_allocated(d),
                    "peak_bytes_in_use": torch.cuda.max_memory_allocated(d),
                }
            self.records.append(sample)
            if self.verbose:
                print(f"[device-monitor] {sample}")
            self._stop.wait(self.interval)

    def start(self) -> None:
        if not self._thread.is_alive():
            self._thread.start()

    def stop(self) -> list:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=self.interval + 1.0)
        return self.records

    def summary(self) -> Dict[str, Any]:
        per_dev: Dict[str, list] = {}
        for rec in self.records:
            for dev_id, stats in rec.items():
                if dev_id == "t":
                    continue
                b = stats.get("bytes_in_use")
                if b is not None:
                    per_dev.setdefault(dev_id, []).append(b)
        return {
            dev_id: {
                "samples": len(vals),
                "mean_bytes_in_use": int(np.mean(vals)),
                "max_bytes_in_use": int(np.max(vals)),
            }
            for dev_id, vals in per_dev.items()
        }

    def stop_and_summary(self) -> Dict[str, Any]:
        self.stop()
        return self.summary()
