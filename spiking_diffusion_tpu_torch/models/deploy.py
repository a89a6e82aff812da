"""Deployment export: the runtime-neutral netlist and the Lynxi exchange.

Counterpart of ``spiking_diffusion_tpu/models/deploy.py``, writing the
same files: a file the port writes equals the one the JAX package writes
for the same weights (the manifest after ``json.load``, every npz array
bitwise), so a consumer written against the format cannot tell which
package wrote it.

* ``export_netlist`` walks flax-layout variables (numpy trees, from
  ``models/weights.py``'s ``*_variables`` of a port module) into
  ``<path>.json`` (format version, LIF constants, tensor shapes and
  dtypes, meta) and ``<path>.npz`` (the arrays, keyed by their tree
  path); ``import_netlist`` reads them back as numpy trees, which the
  ``weights.load_*`` functions turn into port modules.
* ``lynxi_layers_from_vgg`` and ``export_lynxi`` write a trained
  ``SpikingVGG`` in the Lynxi op vocabulary (spikingjelly
  ``lynxi_exchange.py``: Conv2d, BatchNorm2d, pools, Flatten, Linear,
  IF/LIF nodes; T folded into the batch; torch weight layouts; tensors at
  most 4-D). ``lynxi_reference_forward`` executes such a manifest with
  PyTorch on the card (or the CPU), reading only the two files: the
  ground truth a Lynxi backend must reproduce.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from spiking_diffusion_tpu_torch.device import full_fp32, resolve_device
from spiking_diffusion_tpu_torch.snn.neuron import NeuronParams

FORMAT_VERSION = 1


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    if hasattr(tree, "items"):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for k, v in flat.items():
        parts = k.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def export_netlist(
    variables: Dict[str, Any],
    path: str,
    neuron_params: NeuronParams = NeuronParams(),
    meta: Dict[str, Any] | None = None,
    collections: Tuple[str, ...] = ("params", "batch_stats"),
) -> Tuple[str, str]:
    """Write <path>.json (topology + neuron constants) and <path>.npz
    (arrays) of the ``collections`` of ``variables``. Returns the two
    file paths."""
    arrays = {}
    for coll, tree in variables.items():
        if coll in collections:
            arrays.update(_flatten(tree, f"{coll}/"))
    npz_path = path + ".npz"
    json_path = path + ".json"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(npz_path, **arrays)
    manifest = {
        "format_version": FORMAT_VERSION,
        "neuron": {
            "model": "LIF",
            "tau": neuron_params.tau,
            "v_threshold": neuron_params.v_threshold,
            "v_reset": neuron_params.v_reset,
            "decay_input": neuron_params.decay_input,
            "hard_reset": neuron_params.hard_reset,
            "surrogate": neuron_params.surrogate.name,
            "surrogate_alpha": neuron_params.surrogate.alpha,
        },
        "tensors": {
            k: {"shape": list(v.shape), "dtype": str(v.dtype)}
            for k, v in arrays.items()
        },
        "meta": meta or {},
    }
    with open(json_path, "w") as f:
        json.dump(manifest, f, indent=2)
    return json_path, npz_path


def import_netlist(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Read back (variables as numpy trees, manifest) from an exported
    netlist."""
    with open(path + ".json") as f:
        manifest = json.load(f)
    if manifest["format_version"] > FORMAT_VERSION:
        raise ValueError("netlist from a newer format version")
    with np.load(path + ".npz") as data:
        flat = {k: data[k] for k in data.files}
    return _unflatten(flat), manifest


# ---------------------------------------------------------------------------
# Lynxi exchange (spikingjelly ``activation_based/lynxi_exchange.py:1-226``)
# ---------------------------------------------------------------------------

LYNXI_SUPPORTED = {
    "Conv2d", "BatchNorm2d", "MaxPool2d", "AvgPool2d",
    "AdaptiveAvgPool2d", "Flatten", "Linear", "IFNode", "LIFNode",
}
LYNXI_FORMAT_VERSION = 1


def lynxi_layers_from_vgg(
    cfg: Tuple, num_classes: int,
    neuron_params: NeuronParams = NeuronParams(),
) -> list:
    """Layer list for a trained ``models.zoo.SpikingVGG`` in the Lynxi
    vocabulary, with ``params`` refs into the flax variable tree. The
    conv trunk maps 1:1; the rate decode (mean over T) happens host-side
    after inference and is declared in the manifest."""
    if not (neuron_params.hard_reset and neuron_params.v_reset == 0.0):
        raise ValueError(
            "lynxi BaseNode supports hard reset to v_reset only "
            "(lynxi_exchange.py:38-45)"
        )
    layers = []
    conv_i = 0
    for v in cfg:
        if v == "M":
            layers.append({"type": "MaxPool2d",
                           "attrs": {"kernel_size": 2, "stride": 2}})
        else:
            layers.append({
                "type": "Conv2d",
                "attrs": {"out_channels": int(v), "kernel_size": 3,
                          "stride": 1, "padding": 1, "bias": True},
                "params": f"SeqConv_{conv_i}/Conv_0",
            })
            layers.append({
                "type": "BatchNorm2d",
                "attrs": {"num_features": int(v), "eps": 1e-5},
                "params": f"SeqBatchNorm_{conv_i}/BatchNorm_0",
            })
            layers.append({
                "type": "LIFNode",
                "attrs": {
                    "tau": neuron_params.tau,
                    "v_threshold": neuron_params.v_threshold,
                    "v_reset": neuron_params.v_reset,
                    "decay_input": neuron_params.decay_input,
                },
            })
            conv_i += 1
    layers.append({"type": "Flatten", "attrs": {}})
    layers.append({
        "type": "Linear",
        "attrs": {"out_features": int(num_classes), "bias": True},
        "params": "SeqLinear_0/Dense_0",
    })
    return layers


def _get_path(tree: Dict[str, Any], path: str) -> Dict[str, Any]:
    node = tree
    for p in path.split("/"):
        node = node[p]
    return node


def export_lynxi(
    layers: list,
    variables: Dict[str, Any],
    path: str,
    T: int,
    meta: Dict[str, Any] | None = None,
) -> Tuple[str, str]:
    """Write ``<path>.lynxi.json`` + ``<path>.lynxi.npz``.

    Weight layouts follow torch (what ``lyngor`` loads): conv kernels
    OIHW (transposed from flax HWIO), linear weights ``(out, in)``.
    Activations stay NHWC with HWC flatten order, declared in the
    manifest. Validates every layer type against the Lynxi-supported set
    and that no exported tensor exceeds 4-D (chip constraint,
    ``lynxi_exchange.py:17``).
    """
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    arrays: Dict[str, np.ndarray] = {}
    out_layers = []
    for i, layer in enumerate(layers):
        kind = layer["type"]
        if kind not in LYNXI_SUPPORTED:
            raise ValueError(
                f"layer {i}: {kind!r} is not Lynxi-supported "
                f"(supported: {sorted(LYNXI_SUPPORTED)})"
            )
        entry = {"type": kind, "attrs": dict(layer["attrs"]), "tensors": {}}

        def put(name: str, value: np.ndarray) -> None:
            value = np.asarray(value)
            if value.ndim > 4:
                raise ValueError(
                    f"layer {i} tensor {name}: {value.ndim}-D exceeds the "
                    "Lynxi 4-D limit"
                )
            key = f"layer{i}_{name}"
            arrays[key] = value
            entry["tensors"][name] = key

        if kind == "Conv2d":
            p = _get_path(params, layer["params"])
            put("weight", np.transpose(p["kernel"], (3, 2, 0, 1)))  # OIHW
            if "bias" in p:
                put("bias", p["bias"])
        elif kind == "Linear":
            p = _get_path(params, layer["params"])
            put("weight", np.transpose(p["kernel"], (1, 0)))  # (out, in)
            if "bias" in p:
                put("bias", p["bias"])
        elif kind == "BatchNorm2d":
            p = _get_path(params, layer["params"])
            s = _get_path(stats, layer["params"])
            put("weight", p["scale"])
            put("bias", p["bias"])
            put("running_mean", s["mean"])
            put("running_var", s["var"])
        out_layers.append(entry)

    json_path = path + ".lynxi.json"
    npz_path = path + ".lynxi.npz"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(npz_path, **arrays)
    manifest = {
        "format": "lynxi",
        "format_version": LYNXI_FORMAT_VERSION,
        "T": int(T),
        "step_mode": "m",
        "input_convention": "(T*N, H, W, C) — T folded into batch "
                            "(lynxi BaseNode step_mode='m')",
        "activation_layout": "NHWC",
        "flatten_order": "HWC",
        "readout": "rate (mean over the T axis, host-side)",
        "layers": out_layers,
        "meta": meta or {},
    }
    with open(json_path, "w") as f:
        json.dump(manifest, f, indent=2)
    return json_path, npz_path


def _nchw(fn, h: torch.Tensor) -> torch.Tensor:
    """Apply an NCHW operation to NHWC activations."""
    return fn(h.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _lif_node(h: torch.Tensor, kind: str, attrs: Dict[str, Any], t_steps: int) -> torch.Tensor:
    """The lynxi node over T folded into the batch: charge -> fire ->
    hard reset per step (``BaseNode.multi_step_forward``), JAX's
    operations in its order."""
    th = attrs.get("v_threshold", 1.0)
    vr = attrs.get("v_reset", 0.0)
    seq = h.reshape(t_steps, h.shape[0] // t_steps, -1)
    v = torch.zeros_like(seq[0])
    spikes = []
    for xt in seq:
        if kind == "LIFNode":
            decay = 1.0 / attrs["tau"]
            v = (1.0 - decay) * (v - vr)
            v = v + (xt * decay if attrs["decay_input"] else xt)
        else:
            v = v + xt
        s = (v >= th).to(xt.dtype)
        v = (1.0 - s) * v + s * vr
        spikes.append(s)
    return torch.stack(spikes).reshape(h.shape)


@torch.no_grad()
def lynxi_reference_forward(json_path: str, npz_path: str, x, device="cuda") -> torch.Tensor:
    """Execute an exported Lynxi manifest on ``(T*N, H, W, C)`` input
    (numpy or a tensor) on ``device``, reading only the two files: NHWC
    activations, HWC flatten order, the lynxi nodes' per-step loop, fp32
    convs and products without TF32. Returns ``(T*N, num_classes)``
    logits on ``device`` (the rate decode is the consumer's job, as on the
    chip). Runs on the card unless ``device="cpu"`` is passed."""
    dev = resolve_device(device)
    with open(json_path) as f:
        manifest = json.load(f)
    with np.load(npz_path) as data:
        arrays = {k: torch.from_numpy(data[k]).to(dev) for k in data.files}
    t_steps = manifest["T"]
    h = torch.as_tensor(x, dtype=torch.float32, device=dev)

    def tensor(entry, name):
        return arrays[entry["tensors"][name]]

    with full_fp32():
        for entry in manifest["layers"]:
            kind, attrs = entry["type"], entry["attrs"]
            if kind == "Conv2d":
                w = tensor(entry, "weight")  # OIHW
                h = _nchw(lambda a: F.conv2d(a, w, None, attrs["stride"], attrs["padding"]), h)
                if "bias" in entry["tensors"]:
                    h = h + tensor(entry, "bias")
            elif kind == "BatchNorm2d":
                var = tensor(entry, "running_var")
                # the correctly rounded fp32 root, XLA's
                root = torch.sqrt((var + attrs["eps"]).double()).float()
                h = (h - tensor(entry, "running_mean")) / root
                h = h * tensor(entry, "weight") + tensor(entry, "bias")
            elif kind in ("IFNode", "LIFNode"):
                h = _lif_node(h, kind, attrs, t_steps)
            elif kind == "MaxPool2d":
                h = _nchw(lambda a: F.max_pool2d(a, attrs["kernel_size"], attrs["stride"]), h)
            elif kind == "AvgPool2d":
                h = _nchw(lambda a: F.avg_pool2d(a, attrs["kernel_size"], attrs["stride"]), h)
            elif kind == "Flatten":
                h = h.reshape(h.shape[0], -1)
            elif kind == "Linear":
                h = h @ tensor(entry, "weight").T
                if "bias" in entry["tensors"]:
                    h = h + tensor(entry, "bias")
            else:
                raise ValueError(f"unhandled layer type {kind!r}")
    return h
