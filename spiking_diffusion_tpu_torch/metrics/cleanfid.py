"""clean-fid-equivalent scoring: an antialiased resize and named stats.

Counterpart of ``spiking_diffusion_tpu/metrics/cleanfid.py``: what the
reference's vendored (and unwired) clean-fid package exists to provide,

1. an antialiased float resize to 299x299 before feature extraction
   (:func:`clean_resize`, Lanczos-3 as ``jax.image.resize`` computes it,
   ``inception.resize``);
2. an InceptionV3 feature space (:func:`make_clean_feature_fn`, the FID
   configuration of ``metrics/inception.py``);
3. named reference statistics pinned to local files (:func:`save_stats`,
   :func:`load_stats`, :func:`list_stats`): ``<root>/cleanfid_stats_<name>.npz``
   with ``mu``, ``sigma`` and ``n``, the JAX package's format.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from spiking_diffusion_tpu_torch.device import resolve_device
from spiking_diffusion_tpu_torch.metrics.inception import InceptionV3, resize
from spiking_diffusion_tpu_torch.metrics.scores import frechet_distance, gaussian_stats

FeatureFn = Callable[[np.ndarray], np.ndarray]
STATS_ROOT = "./cleanfid_stats"


def clean_resize(images, size: int = 299, device="cuda") -> torch.Tensor:
    """(N, H, W[, 1|3]) uint8 or [0, 1] float (numpy or a tensor) -> (N,
    size, size, 3) fp32 in [0, 1] on ``device`` (a tensor's own device):
    Lanczos-3 with antialiasing, clipped."""
    x = images if torch.is_tensor(images) else torch.as_tensor(
        np.asarray(images, np.float32), device=resolve_device(device))
    x = x.float()
    if x.ndim == 3:
        x = x[..., None]
    if x.numel() and float(x.max()) > 1.5:
        x = x / 255.0
    if x.shape[-1] == 1:
        x = x.repeat(1, 1, 1, 3)
    return torch.clamp(resize(x, size, "lanczos3"), 0.0, 1.0)


def make_clean_feature_fn(model: Optional[InceptionV3] = None, batch_size: int = 64,
                          device="cuda") -> FeatureFn:
    """images -> (N, 2048) numpy Inception features of
    :func:`clean_resize`d images (``x * 2 - 1``, ``transform_input``), on
    ``device``. ``model`` comes from ``inception.load_torch_weights_npz`` or
    ``load_converted_weights`` (the weights are not in the repository)."""
    if model is None:
        raise ValueError("pass an InceptionV3 from metrics.inception.load_torch_weights_npz "
                         "or load_converted_weights")
    dev = resolve_device(device)
    model = model.to(dev).eval()

    @torch.no_grad()
    def fn(images: np.ndarray) -> np.ndarray:
        out = []
        for i in range(0, images.shape[0], batch_size):
            xb = clean_resize(images[i:i + batch_size], device=dev)
            feats, _ = model(xb * 2.0 - 1.0, transform_input=True)
            out.append(feats.cpu().numpy())
        return np.concatenate(out)

    return fn


def compute_fid(images1: Optional[np.ndarray] = None, images2: Optional[np.ndarray] = None,
                feature_fn: Optional[FeatureFn] = None,
                stats1: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                stats2: Optional[Tuple[np.ndarray, np.ndarray]] = None) -> float:
    """clean-fid's ``compute_fid``: each side an image array (through
    ``feature_fn``) or precomputed (mu, sigma), e.g. from :func:`load_stats`."""

    def side(images, stats):
        if stats is not None:
            return stats
        if images is None:
            raise ValueError("need images or stats for each side")
        if feature_fn is None:
            raise ValueError("feature_fn required when passing images")
        return gaussian_stats(feature_fn(images))

    mu1, s1 = side(images1, stats1)
    mu2, s2 = side(images2, stats2)
    return float(frechet_distance(mu1, s1, mu2, s2))


def _stats_path(root: str, name: str) -> str:
    return os.path.join(root, f"cleanfid_stats_{name}.npz")


def save_stats(images: np.ndarray, feature_fn: FeatureFn, name: str,
               root: str = STATS_ROOT) -> str:
    """Compute and pin named reference statistics (mu, sigma); returns the
    file's path."""
    os.makedirs(root, exist_ok=True)
    mu, sigma = gaussian_stats(feature_fn(images))
    path = _stats_path(root, name)
    np.savez(path, mu=mu, sigma=sigma, n=images.shape[0])
    return path


def load_stats(name: str, root: str = STATS_ROOT) -> Tuple[np.ndarray, np.ndarray]:
    with np.load(_stats_path(root, name)) as data:
        return data["mu"], data["sigma"]


def list_stats(root: str = STATS_ROOT):
    """The names of the statistics pinned under ``root``, sorted."""
    if not os.path.isdir(root):
        return []
    pre, suf = "cleanfid_stats_", ".npz"
    return sorted(f[len(pre):-len(suf)] for f in os.listdir(root)
                  if f.startswith(pre) and f.endswith(suf))
