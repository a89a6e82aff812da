"""The frozen metric feature space: committed LeNet weights and the
reference statistics they were pinned with.

Counterpart of ``spiking_diffusion_tpu/metrics/frozen.py`` on a byte copy
of its assets (``assets/``)::

    assets/lenet_<name>.npz   flat flax params + meta (the SPACE)
    assets/stats_<name>.npz   mu/sigma of the canonical real set
                              + sha of the images they came from

Every eval loads the space instead of retraining it and stamps its hash
(:func:`space_hash`, the same sha as the JAX package's) into
``metrics.json``, so FID/IS/KID compare across runs and with the JAX
package's records. The stats are a verification anchor: when an eval's
real set has the committed ``data_sha``, its recomputed stats must equal
them (the CLI checks this).

The spaces were made by the JAX package on a TPU, whose default precision
rounds the operands of every conv and matrix product to bf16 and sums in
fp32. Their stats reproduce only in that arithmetic: on the canonical
MNIST set, fp32 operands move the features' mean by up to 0.025 and miss
the check, bf16 operands meet it (mean within 4.4e-6). So a frozen space
runs with ``operand_dtype=FROZEN_OPERAND_DTYPE``; a retrained one
(``mode="off"``) runs in fp32. Making new spaces (the JAX package's
``freeze_feature_space``) is not ported.
"""

from __future__ import annotations

import hashlib
import os
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from spiking_diffusion_tpu_torch.metrics.features import (
    FeatureFn,
    LeNet,
    lenet_feature_fn,
    train_lenet,
)

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")
FROZEN_OPERAND_DTYPE = torch.bfloat16
MODES = ("auto", "on", "off")


def space_hash(params: Mapping[str, np.ndarray]) -> str:
    """sha256 over the sorted names and contiguous fp32 bytes of flat
    flax-layout parameters: the identity of the feature space."""
    h = hashlib.sha256()
    for k in sorted(params):
        h.update(k.encode())
        h.update(np.ascontiguousarray(params[k], np.float32).tobytes())
    return h.hexdigest()


def data_hash(images: np.ndarray) -> str:
    return hashlib.sha256(
        np.ascontiguousarray(images, np.float32).tobytes()
    ).hexdigest()


def load_frozen_lenet(
    name: str, root: str = ASSETS
) -> Optional[Tuple[LeNet, Dict[str, np.ndarray], Dict[str, Any]]]:
    """(model, flat params, info) of a committed space, or None if absent.
    The model is on the CPU, in the frozen spaces' arithmetic."""
    path = os.path.join(root, f"lenet_{name}.npz")
    if not os.path.exists(path):
        return None
    with np.load(path) as data:
        params = {k[len("param:"):]: data[k] for k in data.files if k.startswith("param:")}
        info = {k[len("meta:"):]: data[k].item() for k in data.files if k.startswith("meta:")}
    if isinstance(info.get("space_sha"), bytes):
        info["space_sha"] = info["space_sha"].decode()
    side = int(np.sqrt(params["Dense_0/kernel"].shape[0] // 16))
    model = LeNet(int(info["num_classes"]), int(info["in_channels"]), (2 * side + 4) * 2,
                  operand_dtype=FROZEN_OPERAND_DTYPE).load_params(params)
    return model, params, info


def load_frozen_stats(
    name: str, root: str = ASSETS
) -> Optional[Dict[str, Any]]:
    path = os.path.join(root, f"stats_{name}.npz")
    if not os.path.exists(path):
        return None
    with np.load(path) as d:
        return {
            "mu": d["mu"], "sigma": d["sigma"], "n": int(d["n"]),
            "data_sha": bytes(d["data_sha"]).decode(),
            "space_sha": bytes(d["space_sha"]).decode(),
        }


def get_feature_space(
    name: str,
    train_images: np.ndarray,
    train_labels: np.ndarray,
    num_classes: int,
    mode: str = "auto",
    root: str = ASSETS,
    log_fn: Optional[Callable[[str], None]] = print,
    device="cuda",
) -> Tuple[FeatureFn, Dict[str, Any]]:
    """The eval-time entry point: the committed frozen space when one
    exists and matches the data's classes and channels (``mode="auto"``),
    else a LeNet trained on the data for 3 epochs with a warning;
    ``"on"`` requires the frozen space, ``"off"`` always retrains.

    Returns (feature_fn on ``device``, info); info carries ``frozen``,
    ``name``, ``space_sha`` and ``num_classes`` for the metrics.json stamp.
    """
    if mode not in MODES:
        raise ValueError(f"mode must be auto|on|off, got {mode!r}")
    if mode != "off":
        loaded = load_frozen_lenet(name, root=root)
        compatible = (
            loaded is not None
            and int(loaded[2]["num_classes"]) == int(num_classes)
            and int(loaded[2]["in_channels"]) == int(train_images.shape[-1])
        )
        if compatible:
            model, params, info = loaded
            sha = info.get("space_sha") or space_hash(params)
            if log_fn:
                log_fn(f"frozen feature space {name}: sha={sha[:16]}")
            return lenet_feature_fn(model, device), {
                "frozen": True, "name": name, "space_sha": sha,
                "num_classes": int(info["num_classes"]),
            }
        if mode == "on":
            raise FileNotFoundError(
                f"no compatible frozen feature space for {name!r} under {root}"
            )
        if log_fn and loaded is not None:
            log_fn(f"frozen space for {name} incompatible with this data "
                   "(classes/channels) — retraining")
    if log_fn:
        log_fn("WARNING: UNFROZEN feature space (retrained this eval) — "
               "FID/IS/KID not comparable across runs")
    model, params = train_lenet(train_images, train_labels, num_classes, epochs=3,
                                device=device)
    return lenet_feature_fn(model, device), {
        "frozen": False, "name": name,
        "space_sha": space_hash(params), "num_classes": int(num_classes),
    }
