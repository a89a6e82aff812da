"""The port's ``data/extra_datasets.py`` against the JAX package's, byte for
byte, on the same inputs.

* ``synthetic_dataset``, which the port makes a class of images at a
  time, at several sizes, seeds and image sizes.
* Each loader's synthetic fallback (no data folder anywhere): CIFAR10 in
  RGB (the synthetic set repeated to 3 channels) and in BW, notMNIST,
  MNIST-C and CelebA, and ``load_dataset("CIFAR10")`` /
  ``load_dataset("CIFAR10-BW")`` through each package's dispatch.
* ``mnist_square`` per seed, and ``_bilinear_resize`` down, up and at the
  same size.
* The readers of real files, written tiny to a temporary directory: the
  six ``cifar-10-batches-py`` pickles (through ``load_cifar10`` and
  ``load_dataset``, RGB and BW), MNIST-C's ``.npy`` arrays (with and
  without a channel axis), notMNIST's folder of PNGs (a corrupt file
  among them) and CelebA's folder of JPEGs (cropped, resized, capped by
  ``max_images``).

Every field of the two ``Dataset``s must be equal: the name, the class
count, the synthetic flag, and each array's dtype, shape and bytes.
"""

import pickle

import numpy as np
import pytest
import torch

from spiking_diffusion_tpu.data import datasets as jax_datasets
from spiking_diffusion_tpu.data import extra_datasets as jax_extra
from spiking_diffusion_tpu_torch.data import datasets, extra_datasets

CIFAR_IMAGES = 8  # images per pickle batch
SIZE = (24, 12)  # synthetic_size of the CIFAR10 fallback


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def nowhere(tmp_path, monkeypatch):
    """An empty data_path, with ./datasets and ~/datasets absent too."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HOME", str(tmp_path))
    empty = tmp_path / "empty"
    empty.mkdir()
    return str(empty)


def assert_same(ours, theirs):
    assert ours.name == theirs.name
    assert ours.num_classes == theirs.num_classes
    assert ours.synthetic == theirs.synthetic
    for field in ("train_images", "train_labels", "test_images", "test_labels"):
        a, b = getattr(ours, field), getattr(theirs, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert np.array_equal(a, b), field


# (name, n_train, n_test, classes, seed, image_size): both sides of the
# port's chunk of 4,096 images, an empty set, another seed and size
SYNTHETIC = [("MNIST", 4100, 7, 10, 0, 28), ("Letters", 300, 40, 26, 0, 28),
             ("CIFAR10", 0, 9, 10, 3, 32), ("FMNIST", 1, 1, 10, 1, 28)]


@pytest.mark.parametrize("args", SYNTHETIC, ids=lambda a: "-".join(map(str, a)))
def test_synthetic_dataset_equals_jax(args):
    assert_same(datasets.synthetic_dataset(*args), jax_datasets.synthetic_dataset(*args))


FALLBACKS = {
    "cifar10-rgb": lambda m, p: m.load_cifar10(p, synthetic_size=SIZE),
    "cifar10-bw": lambda m, p: m.load_cifar10(p, grayscale=True, synthetic_size=SIZE),
    "cifar10-rgb-size16": lambda m, p: m.load_cifar10(p, image_size=16, synthetic_size=SIZE),
    "notmnist": lambda m, p: m.load_notmnist(p),
    "mnist-c": lambda m, p: m.load_mnist_c("fog", p),
    "celeba": lambda m, p: m.load_celeba(p, image_size=16),
}


@pytest.mark.parametrize("loader", sorted(FALLBACKS))
def test_synthetic_fallback_equals_jax(nowhere, loader):
    ours = FALLBACKS[loader](extra_datasets, nowhere)
    theirs = FALLBACKS[loader](jax_extra, nowhere)
    assert ours.synthetic
    assert_same(ours, theirs)


@pytest.mark.parametrize("name,channels", [("CIFAR10", 3), ("CIFAR10-BW", 1)])
def test_load_dataset_cifar_fallback_equals_jax(nowhere, name, channels):
    ours = datasets.load_dataset(name, nowhere, synthetic_size=SIZE)
    assert ours.train_images.shape == (SIZE[0], 28, 28, channels)
    assert_same(ours, jax_datasets.load_dataset(name, nowhere, synthetic_size=SIZE))


def test_load_dataset_unknown_name_raises_as_jax(nowhere):
    with pytest.raises(ValueError) as ours:
        datasets.load_dataset("CIFAR-100", nowhere)
    with pytest.raises(ValueError) as theirs:
        jax_datasets.load_dataset("CIFAR-100", nowhere)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("seed", [0, 3])
def test_mnist_square_equals_jax(seed):
    assert_same(extra_datasets.mnist_square(40, 12, seed=seed),
                jax_extra.mnist_square(40, 12, seed=seed))


@pytest.mark.parametrize("shape,size", [((3, 32, 32, 3), 28), ((2, 20, 24, 1), 28),
                                        ((2, 28, 28, 3), 28), ((1, 7, 9, 2), 4)])
def test_bilinear_resize_equals_jax(shape, size):
    x = np.random.RandomState(sum(shape)).uniform(0, 1, shape).astype(np.float32)
    ours = extra_datasets._bilinear_resize(x, size)
    theirs = jax_extra._bilinear_resize(x, size)
    assert ours.dtype == theirs.dtype and ours.shape == (shape[0], size, size, shape[3])
    assert np.array_equal(ours, theirs)


def _write_cifar(root):
    """Six tiny pickle batches in the layout of cifar-10-batches-py."""
    batches = root / "cifar-10-batches-py"
    batches.mkdir(parents=True)
    rng = np.random.RandomState(5)
    for fname in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        data = rng.randint(0, 256, (CIFAR_IMAGES, 3 * 32 * 32)).astype(np.uint8)
        labels = [int(v) for v in rng.randint(0, 10, CIFAR_IMAGES)]
        with open(batches / fname, "wb") as f:
            pickle.dump({b"data": data, b"labels": labels, b"batch_label": fname.encode()}, f)
    return str(root)


@pytest.mark.parametrize("grayscale", [False, True], ids=["rgb", "bw"])
def test_load_cifar10_pickles_equal_jax(tmp_path, grayscale):
    path = _write_cifar(tmp_path / "data")
    ours = extra_datasets.load_cifar10(path, grayscale=grayscale, synthetic_ok=False)
    assert not ours.synthetic
    assert ours.train_images.shape == (5 * CIFAR_IMAGES, 28, 28, 1 if grayscale else 3)
    assert_same(ours, jax_extra.load_cifar10(path, grayscale=grayscale, synthetic_ok=False))
    name = "CIFAR10-BW" if grayscale else "CIFAR10"
    assert_same(datasets.load_dataset(name, path), jax_datasets.load_dataset(name, path))


@pytest.mark.parametrize("channel_axis", [False, True], ids=["nhw", "nhwc"])
def test_load_mnist_c_arrays_equal_jax(tmp_path, channel_axis):
    root = tmp_path / "data" / "mnist_c" / "shot_noise"
    root.mkdir(parents=True)
    rng = np.random.RandomState(7)
    shape = (6, 28, 28, 1) if channel_axis else (6, 28, 28)
    for split in ("train", "test"):
        np.save(root / f"{split}_images.npy", rng.randint(0, 256, shape).astype(np.uint8))
        np.save(root / f"{split}_labels.npy", rng.randint(0, 10, 6).astype(np.int64))
    path = str(tmp_path / "data")
    ours = extra_datasets.load_mnist_c("shot_noise", path, synthetic_ok=False)
    assert ours.train_images.shape == (6, 28, 28, 1)
    assert_same(ours, jax_extra.load_mnist_c("shot_noise", path, synthetic_ok=False))


def test_load_notmnist_pngs_equal_jax(tmp_path):
    image = pytest.importorskip("PIL.Image")
    root = tmp_path / "data" / "notMNIST_small"
    rng = np.random.RandomState(9)
    for letter in "ABC":
        (root / letter).mkdir(parents=True)
        for i in range(4):
            pixels = rng.randint(0, 256, (28, 28)).astype(np.uint8)
            image.fromarray(pixels).save(root / letter / f"{i}.png")
    (root / "B" / "corrupt.png").write_bytes(b"not a png")
    (root / "C" / "notes.txt").write_text("skipped")
    path = str(tmp_path / "data")
    ours = extra_datasets.load_notmnist(path, synthetic_ok=False)
    assert ours.num_classes == 3 and len(ours.train_images) + len(ours.test_images) == 12
    assert_same(ours, jax_extra.load_notmnist(path, synthetic_ok=False))


@pytest.mark.parametrize("max_images", [None, 5])
def test_load_celeba_jpegs_equal_jax(tmp_path, max_images):
    image = pytest.importorskip("PIL.Image")
    root = tmp_path / "data" / "img_align_celeba"
    root.mkdir(parents=True)
    rng = np.random.RandomState(11)
    for i, (h, w) in enumerate([(30, 24), (24, 30), (20, 20), (26, 22), (22, 28), (32, 32)]):
        pixels = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        image.fromarray(pixels).save(root / f"{i:06d}.jpg")
    path = str(tmp_path / "data")
    ours = extra_datasets.load_celeba(path, image_size=16, max_images=max_images,
                                      synthetic_ok=False)
    assert ours.train_images.shape[1:] == (16, 16, 3)
    assert_same(ours, jax_extra.load_celeba(path, image_size=16, max_images=max_images,
                                            synthetic_ok=False))


@pytest.mark.parametrize("loader", ["cifar10", "notmnist", "mnist_c", "celeba"])
def test_missing_folder_without_fallback_raises(nowhere, loader):
    call = {"cifar10": lambda: extra_datasets.load_cifar10(nowhere, synthetic_ok=False),
            "notmnist": lambda: extra_datasets.load_notmnist(nowhere, synthetic_ok=False),
            "mnist_c": lambda: extra_datasets.load_mnist_c("fog", nowhere, synthetic_ok=False),
            "celeba": lambda: extra_datasets.load_celeba(nowhere, synthetic_ok=False)}[loader]
    with pytest.raises(FileNotFoundError):
        call()

