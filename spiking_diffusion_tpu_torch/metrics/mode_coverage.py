"""Mode coverage: classify generated samples, histogram the predicted
classes, and report KL(uniform || histogram); per-class sample grids and
the one-per-class montage.

The port's copy of ``spiking_diffusion_tpu/metrics/mode_coverage.py`` on
the port's grids (numpy; the classifier is a ``FeatureFn``).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from spiking_diffusion_tpu_torch.metrics.features import FeatureFn
from spiking_diffusion_tpu_torch.utils.grids import save_image_grid


def class_histogram(
    feature_fn: FeatureFn, images: np.ndarray, num_classes: int
) -> np.ndarray:
    """Predicted-class counts over generated images."""
    _, probs = feature_fn(images)
    preds = probs.argmax(axis=1)
    return np.bincount(preds, minlength=num_classes).astype(np.float64)


def per_class_grids(
    feature_fn: FeatureFn,
    images: np.ndarray,
    num_classes: int,
    out_dir: str,
    max_per_class: int = 32,
) -> Dict[int, str]:
    """One sample grid per predicted class, ``<out_dir>/class_<c>.png``,
    8 wide; returns {class: png_path} for the classes with a sample."""
    _, probs = feature_fn(images)
    preds = probs.argmax(axis=1)
    paths: Dict[int, str] = {}
    os.makedirs(out_dir, exist_ok=True)
    for c in range(num_classes):
        members = images[preds == c][:max_per_class]
        if len(members) == 0:
            continue
        rows = max(1, -(-len(members) // 8))
        path = os.path.join(out_dir, f"class_{c}.png")
        # images arrive in [0, 1]; the grid saver expects [-0.5, 0.5]
        save_image_grid(members - 0.5, path, rows=rows, cols=8)
        paths[c] = path
    return paths


def paper_montage(
    feature_fn: FeatureFn,
    images: np.ndarray,
    num_classes: int,
    out_path: str,
    per_class: int = 1,
) -> str:
    """A 5-wide montage of the classifier's ``per_class`` most confident
    samples of each class."""
    _, probs = feature_fn(images)
    chosen = []
    for c in range(num_classes):
        order = np.argsort(-probs[:, c])[:per_class]
        chosen.append(images[order])
    montage = np.concatenate(chosen, axis=0)
    rows = max(1, -(-len(montage) // 5))
    # images arrive in [0, 1]; the grid saver expects [-0.5, 0.5]
    save_image_grid(montage - 0.5, out_path, rows=rows, cols=5)
    return out_path


def mode_coverage_kl(
    feature_fn: FeatureFn, images: np.ndarray, num_classes: int
) -> Dict[str, object]:
    """KL(uniform || empirical class histogram), the histogram and the
    number of classes that occur: the histogram normalised to
    probabilities, KL = sum_c (1/C) log((1/C) / p_c)."""
    hist = class_histogram(feature_fn, images, num_classes)
    p = hist / max(hist.sum(), 1.0)
    u = 1.0 / num_classes
    kl = float(np.sum(u * (np.log(u) - np.log(np.maximum(p, 1e-12)))))
    covered = int((hist > 0).sum())
    return {"kl": kl, "histogram": hist, "covered_modes": covered}
