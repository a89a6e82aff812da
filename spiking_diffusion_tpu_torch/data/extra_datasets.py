"""Additional dataset loaders — full ``load_dataset_snn.py`` surface.

The port's own copy of ``spiking_diffusion_tpu/data/extra_datasets.py``
(numpy only; the port imports nothing of the JAX package), with the same
arithmetic, so the same files or seed give the same bytes. Beyond the four
MNIST-family sets wired into the reference CLI, the reference ships
loaders for CIFAR10 (resized to 28, ``:69-94``), CelebA (``:96-126``), a
synthetic MNIST-square OOD set (``:162-206``), CIFAR10-BW (``:209-237``),
notMNIST (custom folder-of-PNGs dataset, ``:295-376``) and MNIST-C (folder
of .npy corruption arrays, ``:378-436``). All are pure-numpy readers with
the same output contract as :mod:`spiking_diffusion_tpu_torch.data.datasets`:
float32 images in [0, 1], channels-last, plus int32 labels. PIL is imported
only inside ``load_celeba`` and ``load_notmnist`` when they read image
folders; no path of the CLI reaches them.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional, Tuple

import numpy as np

from spiking_diffusion_tpu_torch.data.datasets import Dataset, synthetic_dataset


def _bilinear_resize(images: np.ndarray, size: int) -> np.ndarray:
    """(N, H, W, C) -> (N, size, size, C) bilinear, numpy-only."""
    n, h, w, c = images.shape
    if h == size and w == size:
        return images
    ys = (np.arange(size) + 0.5) * h / size - 0.5
    xs = (np.arange(size) + 0.5) * w / size - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0, 1)[None, :, None, None]
    wx = np.clip(xs - x0, 0, 1)[None, None, :, None]
    a = images[:, y0][:, :, x0]
    b = images[:, y0][:, :, x1]
    cc = images[:, y1][:, :, x0]
    d = images[:, y1][:, :, x1]
    top = a * (1 - wx) + b * wx
    bot = cc * (1 - wx) + d * wx
    return (top * (1 - wy) + bot * wy).astype(np.float32)


def load_cifar10(
    data_path: Optional[str] = None,
    image_size: int = 28,
    grayscale: bool = False,
    synthetic_ok: bool = True,
    synthetic_size: Tuple[int, int] = (2048, 512),
) -> Dataset:
    """CIFAR-10 from the python pickle batches, resized to 28x28
    (``load_dataset_snn.py:69-94``); ``grayscale=True`` gives the BW
    variant (``:209-237``)."""
    name = "CIFAR10-BW" if grayscale else "CIFAR10"
    batches_dir = None
    for root in filter(None, [data_path, "./datasets", os.path.expanduser("~/datasets")]):
        cand = os.path.join(root, "cifar-10-batches-py")
        if os.path.isdir(cand):
            batches_dir = cand
            break
    if batches_dir is None:
        if not synthetic_ok:
            raise FileNotFoundError("cifar-10-batches-py not found")
        ch = 1 if grayscale else 3
        ds = synthetic_dataset(name, n_train=synthetic_size[0],
                               n_test=synthetic_size[1], num_classes=10,
                               image_size=image_size)
        if ch == 3:
            tri = np.repeat(ds.train_images, 3, axis=-1)
            tei = np.repeat(ds.test_images, 3, axis=-1)
            ds = Dataset(name, tri, ds.train_labels, tei, ds.test_labels,
                         10, synthetic=True)
        return ds

    def read_batch(fname):
        with open(os.path.join(batches_dir, fname), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        x = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return x.astype(np.float32) / 255.0, np.asarray(d[b"labels"], np.int32)

    xs, ys = zip(*[read_batch(f"data_batch_{i}") for i in range(1, 6)])
    tri, trl = np.concatenate(xs), np.concatenate(ys)
    tei, tel = read_batch("test_batch")
    tri = _bilinear_resize(tri, image_size)
    tei = _bilinear_resize(tei, image_size)
    if grayscale:
        w = np.array([0.299, 0.587, 0.114], np.float32)
        tri = (tri @ w)[..., None]
        tei = (tei @ w)[..., None]
    return Dataset(name, tri, trl, tei, tel, 10)


def load_celeba(
    data_path: Optional[str] = None,
    image_size: int = 64,
    max_images: Optional[int] = None,
    synthetic_ok: bool = True,
) -> Dataset:
    """CelebA faces from the standard ``img_align_celeba`` jpg folder
    (``load_dataset_snn.py:96-126``): center-crop to square, resize.

    Labels are zeros (the reference uses CelebA unconditionally).
    """
    root = None
    for base in filter(None, [data_path, "./datasets", os.path.expanduser("~/datasets")]):
        for sub in ("celeba/img_align_celeba", "img_align_celeba", "CelebA"):
            cand = os.path.join(base, sub)
            if os.path.isdir(cand):
                root = cand
                break
        if root:
            break
    if root is None:
        if not synthetic_ok:
            raise FileNotFoundError("img_align_celeba not found")
        ds = synthetic_dataset("CelebA", n_train=1024, n_test=256,
                              num_classes=1, image_size=image_size)
        tri = np.repeat(ds.train_images, 3, axis=-1)
        tei = np.repeat(ds.test_images, 3, axis=-1)
        return Dataset("CelebA", tri, ds.train_labels, tei, ds.test_labels,
                       1, synthetic=True)

    from PIL import Image

    files = sorted(f for f in os.listdir(root) if f.endswith((".jpg", ".png")))
    if max_images:
        files = files[:max_images]
    images = []
    for fname in files:
        img = Image.open(os.path.join(root, fname)).convert("RGB")
        w, h = img.size
        s = min(w, h)
        img = img.crop(((w - s) // 2, (h - s) // 2,
                        (w + s) // 2, (h + s) // 2))
        img = img.resize((image_size, image_size), Image.BILINEAR)
        images.append(np.asarray(img, np.float32) / 255.0)
    images = np.stack(images)
    labels = np.zeros((len(images),), np.int32)
    cut = int(len(images) * 0.9)
    return Dataset("CelebA", images[:cut], labels[:cut],
                   images[cut:], labels[cut:], 1)


def mnist_square(
    n_train: int = 2048,
    n_test: int = 512,
    image_size: int = 28,
    seed: int = 0,
) -> Dataset:
    """Synthetic white-square OOD set (``load_dataset_snn.py:162-206``):
    random axis-aligned bright squares on black background."""
    rng = np.random.RandomState(seed)

    def make(n):
        imgs = np.zeros((n, image_size, image_size, 1), np.float32)
        labels = np.zeros((n,), np.int32)
        for i in range(n):
            s = rng.randint(6, 15)
            y = rng.randint(0, image_size - s)
            x = rng.randint(0, image_size - s)
            imgs[i, y : y + s, x : x + s, 0] = 1.0
        return imgs, labels

    tri, trl = make(n_train)
    tei, tel = make(n_test)
    return Dataset("MNIST-square", tri, trl, tei, tel, 1, synthetic=True)


def load_notmnist(
    data_path: Optional[str] = None, synthetic_ok: bool = True
) -> Dataset:
    """notMNIST (letters A-J as fonts): folder-of-PNGs layout
    <root>/notMNIST_small/<A..J>/*.png (``load_dataset_snn.py:295-376``)."""
    root = None
    for base in filter(None, [data_path, "./datasets", os.path.expanduser("~/datasets")]):
        for sub in ("notMNIST_small", "notMNIST"):
            cand = os.path.join(base, sub)
            if os.path.isdir(cand):
                root = cand
                break
        if root:
            break
    if root is None:
        if not synthetic_ok:
            raise FileNotFoundError("notMNIST folder not found")
        return synthetic_dataset("notMNIST", n_train=2048, n_test=512,
                                 num_classes=10)
    from PIL import Image

    images, labels = [], []
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    for ci, cname in enumerate(classes):
        cdir = os.path.join(root, cname)
        for fname in sorted(os.listdir(cdir)):
            if not fname.endswith(".png"):
                continue
            try:
                img = np.asarray(
                    Image.open(os.path.join(cdir, fname)).convert("L"),
                    np.float32,
                ) / 255.0
            except OSError:  # some notMNIST files are corrupt
                continue
            images.append(img[..., None])
            labels.append(ci)
    images = np.stack(images)
    labels = np.asarray(labels, np.int32)
    # 90/10 split, deterministic
    n = len(images)
    order = np.random.RandomState(0).permutation(n)
    cut = int(n * 0.9)
    return Dataset(
        "notMNIST",
        images[order[:cut]], labels[order[:cut]],
        images[order[cut:]], labels[order[cut:]],
        len(classes),
    )


def load_mnist_c(
    corruption: str = "identity",
    data_path: Optional[str] = None,
    synthetic_ok: bool = True,
) -> Dataset:
    """MNIST-C: <root>/mnist_c/<corruption>/{train,test}_{images,labels}.npy
    (``load_dataset_snn.py:378-436``)."""
    root = None
    for base in filter(None, [data_path, "./datasets", os.path.expanduser("~/datasets")]):
        cand = os.path.join(base, "mnist_c", corruption)
        if os.path.isdir(cand):
            root = cand
            break
    if root is None:
        if not synthetic_ok:
            raise FileNotFoundError(f"mnist_c/{corruption} not found")
        return synthetic_dataset(f"MNIST-C/{corruption}", n_train=2048,
                                 n_test=512, num_classes=10)
    tri = np.load(os.path.join(root, "train_images.npy")).astype(np.float32) / 255.0
    trl = np.load(os.path.join(root, "train_labels.npy")).astype(np.int32)
    tei = np.load(os.path.join(root, "test_images.npy")).astype(np.float32) / 255.0
    tel = np.load(os.path.join(root, "test_labels.npy")).astype(np.int32)
    if tri.ndim == 3:
        tri, tei = tri[..., None], tei[..., None]
    return Dataset(f"MNIST-C/{corruption}", tri, trl, tei, tel, 10)
