"""MNIST-family dataset loading: IDX readers and the synthetic fallback.

The port's own copy of ``spiking_diffusion_tpu/data/datasets.py`` (numpy
only; the port imports nothing of the JAX package): ``Dataset``, the IDX
readers, ``synthetic_dataset``, ``load_dataset``, ``data_variance`` and
``batch_iterator``, with the same arithmetic, so the same seed gives the
same images. ``load_dataset`` also reaches CIFAR10 and CIFAR10-BW through
the port's copy of ``extra_datasets.load_cifar10``.

Images are float32 in [0, 1], shaped (N, 28, 28, 1) channels-last
((N, 28, 28, 3) for CIFAR10). The training shift (x - 0.5) happens in the
trainer (``train/stage1.py``).
"""

from __future__ import annotations

import dataclasses
import gzip
import os
import struct
from typing import Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Dataset:
    name: str
    train_images: np.ndarray  # (N, H, W, 1) float32 in [0,1]
    train_labels: np.ndarray  # (N,) int32
    test_images: np.ndarray
    test_labels: np.ndarray
    num_classes: int
    synthetic: bool = False


# Standard IDX file basenames per dataset (torchvision raw layout).
_IDX_FILES = {
    "MNIST": ("train-images-idx3-ubyte", "train-labels-idx1-ubyte",
              "t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
    "FMNIST": ("train-images-idx3-ubyte", "train-labels-idx1-ubyte",
               "t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
    "KMNIST": ("train-images-idx3-ubyte", "train-labels-idx1-ubyte",
               "t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
    "Letters": ("emnist-letters-train-images-idx3-ubyte",
                "emnist-letters-train-labels-idx1-ubyte",
                "emnist-letters-test-images-idx3-ubyte",
                "emnist-letters-test-labels-idx1-ubyte"),
}

_SUBDIRS = {
    "MNIST": ("MNIST/raw", "mnist", "."),
    "FMNIST": ("FashionMNIST/raw", "fashion-mnist", "fmnist", "."),
    "KMNIST": ("KMNIST/raw", "kmnist", "."),
    "Letters": ("EMNIST/raw", "emnist", "letters", "."),
}

_NUM_CLASSES = {"MNIST": 10, "FMNIST": 10, "KMNIST": 10, "Letters": 26}


def _read_idx(path: str) -> np.ndarray:
    """Parse an IDX (u)byte file, transparently handling .gz."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


def _find_idx(data_path: str, name: str, base: str) -> Optional[str]:
    for sub in _SUBDIRS[name]:
        for suffix in ("", ".gz"):
            p = os.path.join(data_path, sub, base + suffix)
            if os.path.exists(p):
                return p
    return None


def _load_idx_dataset(data_path: str, name: str) -> Optional[Dataset]:
    paths = []
    for base in _IDX_FILES[name]:
        p = _find_idx(data_path, name, base)
        if p is None:
            return None
        paths.append(p)
    tri, trl, tei, tel = (_read_idx(p) for p in paths)

    def prep(images: np.ndarray) -> np.ndarray:
        x = images.astype(np.float32) / 255.0
        if name == "Letters":
            # EMNIST raw images are transposed; the reference fixes this
            # with RandomRotation((-90,-90)) + RandomHorizontalFlip(p=1)
            # (``load_dataset_snn.py:249-258``), which == transpose.
            x = np.transpose(x, (0, 2, 1))
        return x[..., None]

    trl = trl.astype(np.int32)
    tel = tel.astype(np.int32)
    if name == "Letters":
        # labels are 1..26 -> 0..25 (``load_dataset_snn.py:269,284``)
        trl = trl - 1
        tel = tel - 1
    return Dataset(
        name=name,
        train_images=prep(tri),
        train_labels=trl,
        test_images=prep(tei),
        test_labels=tel,
        num_classes=_NUM_CLASSES[name],
    )


_SYNTHETIC_CHUNK = 4096  # images made at once by synthetic_dataset


def synthetic_dataset(
    name: str = "MNIST",
    n_train: int = 2048,
    n_test: int = 512,
    num_classes: int = 10,
    seed: int = 0,
    image_size: int = 28,
) -> Dataset:
    """Deterministic digit-like images: per-class blob patterns + noise.

    Shapes/dtypes/value ranges match real MNIST so every downstream stage
    (training, index extraction, diffusion, metrics) exercises identically.
    """
    # fold the dataset name into the seed so the KMNIST/FMNIST/... stand-ins
    # are distinct datasets (deterministic per name) rather than replicas
    name_seed = sum(ord(c) * (i + 1) for i, c in enumerate(name)) % 100003
    rng = np.random.RandomState(seed + name_seed)
    h = w = image_size
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)

    # a few fixed stroke centers per class
    protos = []
    prng = np.random.RandomState(1234 + name_seed)
    for c in range(num_classes):
        k = 3 + c % 3
        centers = prng.uniform(5, image_size - 5, size=(k, 2))
        radii = prng.uniform(1.5, 3.5, size=(k,))
        protos.append((centers, radii))

    def make(n: int, rng: np.random.RandomState):
        # one image at a time, each blob added in turn and then the image's
        # noise, but over all images of a class at once: the same values
        # and the same draws from ``rng`` in the same order
        labels = rng.randint(0, num_classes, size=n).astype(np.int32)
        imgs = np.zeros((n, h, w), np.float32)
        jitter = rng.uniform(-1.5, 1.5, size=(n, 2)).astype(np.float32)
        for start in range(0, n, _SYNTHETIC_CHUNK):
            part = slice(start, min(start + _SYNTHETIC_CHUNK, n))
            acc = imgs[part]
            for c, (centers, radii) in enumerate(protos):
                idx = np.flatnonzero(labels[part] == c)
                jy, jx = (jitter[part][idx, k, None, None] for k in (0, 1))
                blobs = np.zeros((len(idx), h, w), np.float32)
                for (cy, cx), r in zip(centers, radii):
                    d2 = (yy[:, :1] - cy - jy) ** 2 + (xx[:1] - cx - jx) ** 2
                    blobs += np.exp(-d2 / (2 * r * r))
                acc[idx] = blobs
            acc += rng.normal(0, 0.05, size=acc.shape).astype(np.float32)
            np.clip(acc, 0.0, 1.0, out=acc)
        return imgs[..., None], labels

    tri, trl = make(n_train, rng)
    tei, tel = make(n_test, rng)
    return Dataset(
        name=name,
        train_images=tri,
        train_labels=trl,
        test_images=tei,
        test_labels=tel,
        num_classes=num_classes,
        synthetic=True,
    )


def load_dataset(
    name: str,
    data_path: Optional[str] = None,
    synthetic_ok: bool = True,
    synthetic_size: Tuple[int, int] = (2048, 512),
) -> Dataset:
    """Load a dataset by reference CLI name:
    MNIST|FMNIST|KMNIST|Letters|CIFAR10|CIFAR10-BW.

    The IDX files (CIFAR10: ``cifar-10-batches-py``) are looked for under
    ``data_path``, ``./datasets`` and ``~/datasets``; without them, and
    with ``synthetic_ok``, the deterministic ``synthetic_dataset`` of that
    name stands in (CIFAR10's repeated to 3 channels).
    """
    if name in ("CIFAR10", "CIFAR10-BW"):
        from spiking_diffusion_tpu_torch.data.extra_datasets import load_cifar10

        return load_cifar10(
            data_path, grayscale=(name == "CIFAR10-BW"),
            synthetic_ok=synthetic_ok, synthetic_size=synthetic_size,
        )
    if name not in _IDX_FILES:
        raise ValueError(
            f"unknown dataset {name!r}; have "
            f"{sorted(_IDX_FILES) + ['CIFAR10', 'CIFAR10-BW']}"
        )
    if data_path:
        ds = _load_idx_dataset(data_path, name)
        if ds is not None:
            return ds
    for candidate in ("./datasets", os.path.expanduser("~/datasets")):
        ds = _load_idx_dataset(candidate, name)
        if ds is not None:
            return ds
    if not synthetic_ok:
        raise FileNotFoundError(
            f"IDX files for {name} not found under {data_path!r}"
        )
    return synthetic_dataset(
        name,
        n_train=synthetic_size[0],
        n_test=synthetic_size[1],
        num_classes=_NUM_CLASSES[name],
    )


def data_variance(images: np.ndarray) -> float:
    """Variance of the whole training set, used to normalize the MSE loss
    (``main.py:90-95``). Note: the reference computes it on the raw [0,1]
    images, before the -0.5 shift — variance is shift-invariant anyway."""
    return float(np.var(images))


def batch_iterator(
    images: np.ndarray,
    batch_size: int,
    seed: int = 0,
    shuffle: bool = True,
    drop_remainder: bool = True,
    epoch: int = 0,
) -> Iterator[np.ndarray]:
    """Yield (B, H, W, 1) batches; deterministic per (seed, epoch)."""
    n = images.shape[0]
    order = np.arange(n)
    if shuffle:
        np.random.RandomState(seed * 100003 + epoch).shuffle(order)
    stop = (n // batch_size) * batch_size if drop_remainder else n
    for i in range(0, stop, batch_size):
        yield images[order[i : i + batch_size]]
