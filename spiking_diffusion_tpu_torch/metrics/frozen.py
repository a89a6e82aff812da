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
them (:func:`verify_stats`, which the CLI applies).

The committed spaces were made by the JAX package on a TPU, whose
default precision rounds the operands of every conv and matrix product
to bf16 and sums in fp32. Their stats reproduce only in that arithmetic:
on the canonical MNIST set, fp32 operands move the features' mean by up
to 0.025 and miss the check, bf16 operands meet it (mean within 4.4e-6).
So a frozen space runs with ``operand_dtype=FROZEN_OPERAND_DTYPE``; a
retrained one (``mode="off"``) runs in fp32.

The freeze protocol (:func:`freeze_feature_space`, the JAX package's
canonical one: ``train_lenet`` for ``FREEZE_EPOCHS`` epochs from
``FREEZE_SEED``, stats of the first ``CANONICAL_REF_N`` test images)
makes a new space in the same files, which the JAX package's
``load_frozen_lenet`` reads with the same ``space_hash``. The LeNet
trains in fp32, but the space's stats are computed as every eval will
recompute them, by the frozen space's own feature function with bf16
operands: stats pinned in fp32 would fail this module's own
``get_feature_space(mode="on")`` check on the space just written. The
writers take their ``root`` from the caller; ``scripts/freeze_metric_space_torch.py``
writes over the committed ``assets/`` only when asked to.
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

# the canonical freeze protocol: any change makes spaces that differ from
# the committed ones, so change it deliberately
FREEZE_SEED = 20260817
FREEZE_EPOCHS = 5
CANONICAL_REF_N = 8192  # reference-set size of a space's stats


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


def _lenet_path(name: str, root: str) -> str:
    return os.path.join(root, f"lenet_{name}.npz")


def _stats_path(name: str, root: str) -> str:
    return os.path.join(root, f"stats_{name}.npz")


def save_frozen_lenet(name: str, params: Mapping[str, np.ndarray], num_classes: int,
                      in_channels: int, *, root: str,
                      meta: Optional[Mapping[str, Any]] = None) -> str:
    """Write a space's flat flax-layout parameters (fp32) and meta,
    ``space_sha`` among them, to ``<root>/lenet_<name>.npz``; returns the
    path."""
    os.makedirs(root, exist_ok=True)
    flat = {f"param:{k}": np.asarray(v, np.float32) for k, v in sorted(params.items())}
    flat["meta:num_classes"] = np.int64(num_classes)
    flat["meta:in_channels"] = np.int64(in_channels)
    flat["meta:space_sha"] = np.bytes_(space_hash(params))
    for k, v in (meta or {}).items():
        flat[f"meta:{k}"] = np.asarray(v)
    path = _lenet_path(name, root)
    np.savez(path, **flat)
    return path


def save_frozen_stats(name: str, feature_fn: FeatureFn, images: np.ndarray, space_sha: str,
                      *, root: str) -> str:
    """Write mu and sigma of ``feature_fn(images)``, their count, the
    images' ``data_hash`` and the space's sha to ``<root>/stats_<name>.npz``;
    returns the path."""
    os.makedirs(root, exist_ok=True)
    feats, _ = feature_fn(images)
    path = _stats_path(name, root)
    np.savez(path, mu=np.mean(feats, axis=0), sigma=np.cov(feats, rowvar=False),
             n=images.shape[0], data_sha=np.bytes_(data_hash(images)),
             space_sha=np.bytes_(space_sha))
    return path


def freeze_feature_space(
    name: str,
    train_images: np.ndarray,
    train_labels: np.ndarray,
    test_images: np.ndarray,
    num_classes: int,
    *,
    root: str,
    epochs: int = FREEZE_EPOCHS,
    seed: int = FREEZE_SEED,
    log_fn: Optional[Callable[[str], None]] = print,
    device="cuda",
) -> Dict[str, Any]:
    """Train and write a dataset's frozen space under ``root``: the LeNet
    (``train_lenet`` from ``seed``, ``epochs`` epochs, on ``device``) and
    the stats of the first ``CANONICAL_REF_N`` test images, computed by
    the written space's own feature function (bf16 operands). Returns
    ``space_sha`` and the two paths."""
    _, params = train_lenet(train_images, train_labels, num_classes, epochs=epochs,
                            seed=seed, log_fn=log_fn, device=device)
    sha = space_hash(params)
    in_ch = int(train_images.shape[-1]) if train_images.ndim == 4 else 1
    wpath = save_frozen_lenet(
        name, params, num_classes, in_ch, root=root,
        meta={"seed": np.int64(seed), "epochs": np.int64(epochs),
              "n_train": np.int64(train_images.shape[0]),
              "train_data_sha": np.bytes_(data_hash(train_images))})
    frozen, _, _ = load_frozen_lenet(name, root=root)
    spath = save_frozen_stats(name, lenet_feature_fn(frozen, device),
                              test_images[:CANONICAL_REF_N], sha, root=root)
    if log_fn:
        log_fn(f"frozen space {name}: sha={sha[:16]} -> {wpath}, {spath}")
    return {"space_sha": sha, "weights": wpath, "stats": spath}


def load_frozen_lenet(
    name: str, root: str = ASSETS
) -> Optional[Tuple[LeNet, Dict[str, np.ndarray], Dict[str, Any]]]:
    """(model, flat params, info) of a committed space, or None if absent.
    The model is on the CPU, in the frozen spaces' arithmetic."""
    path = _lenet_path(name, root)
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
    path = _stats_path(name, root)
    if not os.path.exists(path):
        return None
    with np.load(path) as d:
        return {
            "mu": d["mu"], "sigma": d["sigma"], "n": int(d["n"]),
            "data_sha": bytes(d["data_sha"]).decode(),
            "space_sha": bytes(d["space_sha"]).decode(),
        }


def verify_stats(stats: Optional[Mapping[str, Any]], images: np.ndarray,
                 feats: np.ndarray) -> Optional[bool]:
    """Whether ``feats``, the features of ``images``, reproduce the pinned
    ``stats``: None when there are none or they were pinned from other
    images (another ``data_sha``), else whether the mean (rtol and atol
    1e-4) and the covariance (rtol 1e-3, atol 1e-4) both match."""
    if stats is None or stats["data_sha"] != data_hash(images):
        return None
    return bool(np.allclose(np.mean(feats, axis=0), stats["mu"], rtol=1e-4, atol=1e-4)
                and np.allclose(np.cov(feats, rowvar=False), stats["sigma"], rtol=1e-3,
                                atol=1e-4))


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
