"""ANN -> SNN conversion (spikingjelly ``ann2snn/``).

Counterpart of ``spiking_diffusion_tpu/models/ann2snn.py``. A network is a
sequential spec, as in JAX::

    specs = [("conv", {"stride": 1, "padding": 1}), ("relu",), ("pool", 2),
             ("flatten",), ("dense", {}), ("relu",), ("dense", {})]

with one parameter dict (or None) per layer in the port's layouts: a
conv's ``weight`` (Cout, Cin, kh, kw), a dense's ``weight`` (out, in),
each with an optional ``bias`` (``weights.ann2snn_params`` converts
flax's). Inputs are (N, H, W, C), as JAX's; inside the port runs NCHW,
and ``flatten`` takes JAX's (H, W, C) order. ``collect_scales`` takes
each ReLU's max or percentile on the host with numpy, as JAX does;
``snn_forward`` replaces each ReLU by scale -> IF -> scale over T steps
(``if_scan``, plain PyTorch on either device: no kernel in JAX either).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from spiking_diffusion_tpu_torch.snn.neuron import NeuronParams, if_scan

Params = List[Optional[Dict[str, torch.Tensor]]]


def _apply_layer(spec, params, x: torch.Tensor) -> torch.Tensor:
    kind = spec[0]
    if kind == "conv":
        cfg = spec[1]
        return F.conv2d(x, params["weight"], params.get("bias"), cfg.get("stride", 1),
                        cfg.get("padding", 0))
    if kind == "dense":
        return F.linear(x, params["weight"], params.get("bias"))
    if kind == "relu":
        # jnp.maximum's gradient: half to each side at x == 0 (clamp passes it whole)
        return torch.maximum(x, x.new_zeros(()))
    if kind == "pool":
        return F.avg_pool2d(x, spec[1])
    if kind == "flatten":
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    raise ValueError(f"unknown spec {kind!r}")


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2) if x.ndim == 4 else x


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1) if x.ndim == 4 else x


def ann_forward(specs: Sequence[Tuple], params: Params, x: torch.Tensor) -> torch.Tensor:
    """Run the ANN described by ``specs`` on (N, H, W, C) input."""
    h = _nchw(x)
    for spec, p in zip(specs, params):
        h = _apply_layer(spec, p, h)
    return _nhwc(h)


def collect_scales(specs: Sequence[Tuple], params: Params, calibration: torch.Tensor,
                   mode: str = "max", percentile: float = 99.9) -> List[Optional[float]]:
    """Each ReLU's voltage scale on the calibration data, None for every
    other layer: its max (``mode='max'``) or ``percentile``-th percentile,
    taken with numpy on the host and at least 1e-6 (``VoltageHook``)."""
    scales: List[Optional[float]] = []
    h = _nchw(calibration)
    for spec, p in zip(specs, params):
        h = _apply_layer(spec, p, h)
        if spec[0] == "relu":
            arr = h.detach().cpu().numpy()
            s = float(arr.max()) if mode == "max" else float(np.percentile(arr, percentile))
            scales.append(max(s, 1e-6))
        else:
            scales.append(None)
    return scales


def snn_forward(specs: Sequence[Tuple], params: Params, scales: List[Optional[float]],
                x: torch.Tensor, num_steps: int = 32) -> torch.Tensor:
    """The converted SNN on (N, H, W, C) input repeated for T steps: every
    ReLU is scale -> IF (soft reset, v_th 1) -> scale, each IF layer one
    scan over the whole sequence; returns the rate-decoded last layer."""
    t = num_steps
    h = _nchw(x)
    h_seq = h.unsqueeze(0).expand((t,) + tuple(h.shape))
    p_if = NeuronParams(v_threshold=1.0, v_reset=0.0, hard_reset=False)
    for spec, p, s in zip(specs, params, scales):
        if spec[0] == "relu":
            spikes, _ = if_scan(h_seq / s, params=p_if)
            h_seq = spikes * s
        else:
            flat = h_seq.reshape((t * h_seq.shape[1],) + tuple(h_seq.shape[2:]))
            out = _apply_layer(spec, p, flat)
            h_seq = out.reshape((t, h_seq.shape[1]) + tuple(out.shape[1:]))
    return _nhwc(h_seq.mean(0))


def convert(specs: Sequence[Tuple], params: Params, calibration: torch.Tensor,
            mode: str = "max", num_steps: int = 32):
    """Returns ``snn_fn(x) -> rate-decoded outputs`` and the scales
    (``ann2snn.Converter.__call__``)."""
    scales = collect_scales(specs, params, calibration, mode)

    def snn_fn(x):
        return snn_forward(specs, params, scales, x, num_steps)

    return snn_fn, scales
