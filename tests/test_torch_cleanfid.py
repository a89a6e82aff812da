"""The port's clean-fid scoring against the JAX package's
``metrics/cleanfid.py``.

* ``clean_resize`` of uint8 (N, H, W) and float (N, H, W, 1) images, at
  299 and at a downscale, equals JAX's within 1e-5.
* ``make_clean_feature_fn`` is the InceptionV3 FID pipeline on
  ``clean_resize``d images (a seeded network at 299 on the port; the
  network itself is held to JAX in tests/test_torch_inception.py), and
  with both networks replaced by that file's stand-in it equals JAX's,
  batching included.
* ``compute_fid`` from images or stats, and the stats registry
  (``save_stats``, ``load_stats``, ``list_stats``): the same numbers and
  files as JAX's, each package reading what the other wrote.
"""

import numpy as np
import pytest
import torch

from spiking_diffusion_tpu.metrics import cleanfid as jax_cleanfid
from spiking_diffusion_tpu_torch.metrics import cleanfid, inception
from tests.test_torch_inception import JaxStandIn, TorchStandIn

RESIZE_ATOL = 1e-5
FID_RTOL = 1e-9


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("size", [299, 19])
def test_clean_resize_equals_jax(size):
    rng = np.random.RandomState(0)
    for images in (rng.randint(0, 256, (2, 28, 28)).astype(np.uint8),
                   rng.rand(2, 28, 28, 1).astype(np.float32)):
        want = np.asarray(jax_cleanfid.clean_resize(images, size))
        got = cleanfid.clean_resize(images, size, device="cpu")
        assert got.shape == (2, size, size, 3)
        assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=RESIZE_ATOL)


def test_clean_feature_fn_is_the_fid_pipeline():
    model = inception.seeded_inception(0, torch.rand(2, 75, 75, 3,
                                                     generator=torch.Generator().manual_seed(1)))
    images = np.random.RandomState(1).rand(3, 28, 28, 1).astype(np.float32)
    feats = cleanfid.make_clean_feature_fn(model, batch_size=2, device="cpu")(images)
    with torch.no_grad():
        want, _ = model(cleanfid.clean_resize(images, device="cpu") * 2.0 - 1.0,
                        transform_input=True)
    assert feats.shape == (3, 2048)
    np.testing.assert_allclose(feats, want.numpy(), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        cleanfid.make_clean_feature_fn(None, device="cpu")


@pytest.mark.parametrize("images", [
    np.random.RandomState(3).randint(0, 256, (3, 28, 28)).astype(np.uint8),
    np.random.RandomState(4).rand(3, 28, 28, 1).astype(np.float32)], ids=["uint8", "float"])
def test_clean_feature_fn_glue_equals_jax(images):
    want = jax_cleanfid.make_clean_feature_fn(JaxStandIn(), {}, batch_size=2)(images)
    got = cleanfid.make_clean_feature_fn(TorchStandIn(), batch_size=2, device="cpu")(images)
    assert got.shape == (3, 6)
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_ATOL)


def _features(images):
    return np.asarray(images, np.float64).reshape(images.shape[0], -1)[:, :6]


def test_compute_fid_and_stats_registry_equal_jax(tmp_path):
    rng = np.random.RandomState(2)
    a = rng.rand(40, 4, 4).astype(np.float32)
    b = (rng.rand(40, 4, 4) * 0.8 + 0.1).astype(np.float32)
    want = jax_cleanfid.compute_fid(a, b, feature_fn=_features)
    got = cleanfid.compute_fid(a, b, feature_fn=_features)
    assert got == pytest.approx(want, rel=FID_RTOL) and got > 0
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    cleanfid.save_stats(a, _features, "a", root=ours)
    jax_cleanfid.save_stats(b, _features, "b", root=theirs)
    for name, root in (("a", ours), ("b", theirs)):
        for load in (cleanfid.load_stats, jax_cleanfid.load_stats):
            mu, sigma = load(name, root=root)
            want_mu, want_sigma = jax_cleanfid.load_stats(name, root=root)
            np.testing.assert_array_equal(mu, want_mu)
            np.testing.assert_array_equal(sigma, want_sigma)
    with np.load(tmp_path / "ours" / "cleanfid_stats_a.npz") as data:
        assert sorted(data.files) == ["mu", "n", "sigma"] and int(data["n"]) == 40
    assert cleanfid.list_stats(ours) == jax_cleanfid.list_stats(ours) == ["a"]
    assert cleanfid.list_stats(str(tmp_path / "none")) == []
    stats_a = cleanfid.load_stats("a", root=ours)
    stats_b = jax_cleanfid.load_stats("b", root=theirs)
    assert cleanfid.compute_fid(stats1=stats_a, stats2=stats_b) == pytest.approx(
        jax_cleanfid.compute_fid(stats1=stats_a, stats2=stats_b), rel=FID_RTOL)
    assert cleanfid.compute_fid(a, stats2=stats_b, feature_fn=_features) == pytest.approx(
        want, rel=FID_RTOL)
    with pytest.raises(ValueError):
        cleanfid.compute_fid(a, None, feature_fn=_features)
