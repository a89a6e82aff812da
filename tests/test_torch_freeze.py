"""The port's freeze protocol (``metrics/frozen.py`` ``freeze_feature_space``,
``save_frozen_lenet``, ``save_frozen_stats``) against the JAX package's
reader.

A space frozen by the port at a small size (320 training and 300 test
images, 1 epoch, on the CPU, into a temporary root):

* loads in the JAX package's ``load_frozen_lenet`` with the port's
  ``space_sha``, which is also JAX's ``space_hash`` of the loaded
  parameters, and the protocol's meta (seed, epochs, training-set size and
  sha); JAX's ``load_frozen_stats`` reads the port's stats file as the
  port does, pinned to the test images' ``data_hash``;
* verifies on read-back: ``get_feature_space(mode="on")`` on that root
  recomputes the stats within the CLI's check, ``verify_stats`` (mu
  rtol/atol 1e-4, sigma rtol 1e-3, atol 1e-4, whose edges a test holds),
  since both run in the frozen spaces' bf16 operands;
* ``scripts/freeze_metric_space_torch.py`` refuses the committed
  ``assets/`` as its root unless told to overwrite them.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from spiking_diffusion_tpu.metrics import frozen as jax_frozen
from spiking_diffusion_tpu_torch.data import synthetic_dataset
from spiking_diffusion_tpu_torch.metrics import frozen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = "MNIST"


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def space(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("spaces"))
    ds = synthetic_dataset(NAME, 320, 300)
    out = frozen.freeze_feature_space(NAME, ds.train_images, ds.train_labels, ds.test_images,
                                      ds.num_classes, root=root, epochs=1, log_fn=None,
                                      device="cpu")
    return root, ds, out


def test_jax_reads_the_frozen_space(space):
    root, ds, out = space
    assert os.path.basename(out["weights"]) == f"lenet_{NAME}.npz"
    _, params, info = jax_frozen.load_frozen_lenet(NAME, root=root)
    assert info["space_sha"] == out["space_sha"] == jax_frozen.space_hash(params)
    assert int(info["num_classes"]) == 10 and int(info["in_channels"]) == 1
    assert int(info["seed"]) == frozen.FREEZE_SEED and int(info["epochs"]) == 1
    assert int(info["n_train"]) == 320
    assert info["train_data_sha"].decode() == frozen.data_hash(ds.train_images)
    _, port_params, port_info = frozen.load_frozen_lenet(NAME, root=root)
    assert frozen.space_hash(port_params) == out["space_sha"]
    assert port_info["space_sha"] == out["space_sha"]
    want, got = jax_frozen.load_frozen_stats(NAME, root=root), frozen.load_frozen_stats(
        NAME, root=root)
    assert got["data_sha"] == want["data_sha"] == frozen.data_hash(ds.test_images[:8192])
    assert got["space_sha"] == want["space_sha"] == out["space_sha"]
    assert got["n"] == want["n"] == 300
    np.testing.assert_array_equal(got["mu"], want["mu"])
    np.testing.assert_array_equal(got["sigma"], want["sigma"])


def test_space_verifies_on_read_back(space):
    root, ds, out = space
    feature_fn, info = frozen.get_feature_space(NAME, ds.train_images, ds.train_labels, 10,
                                                mode="on", root=root, log_fn=None,
                                                device="cpu")
    assert info["frozen"] and info["space_sha"] == out["space_sha"]
    stats = frozen.load_frozen_stats(NAME, root=root)
    real = ds.test_images[:frozen.CANONICAL_REF_N]
    assert stats["data_sha"] == frozen.data_hash(real)
    feats, _ = feature_fn(real)
    assert frozen.verify_stats(stats, real, feats) is True
    assert float(np.max(np.abs(stats["mu"]))) > 0.1


def test_verify_stats_rule(space):
    """The CLI's rule: no verdict without stats or for other images, a
    miss when the mean or the covariance moves past its tolerance."""
    root, ds, _ = space
    stats = frozen.load_frozen_stats(NAME, root=root)
    real = ds.test_images[:frozen.CANONICAL_REF_N]
    feats = np.random.RandomState(0).randn(len(real), 6)
    exact = dict(stats, mu=np.mean(feats, axis=0), sigma=np.cov(feats, rowvar=False))
    assert frozen.verify_stats(exact, real, feats) is True
    assert frozen.verify_stats(None, real, feats) is None
    assert frozen.verify_stats(exact, real[:-1], feats[:-1]) is None
    for key, where in (("mu", (0,)), ("sigma", (1, 2))):
        moved = dict(exact, **{key: exact[key].copy()})
        moved[key][where] += 1e-4 * (1 + abs(moved[key][where])) * 0.5
        assert frozen.verify_stats(moved, real, feats) is True
        moved[key][where] += 2e-3 * (1 + abs(moved[key][where]))
        assert frozen.verify_stats(moved, real, feats) is False


def test_script_refuses_the_committed_assets(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "freeze_metric_space_torch",
        os.path.join(REPO, "scripts", "freeze_metric_space_torch.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    with pytest.raises(SystemExit) as refused:
        script.main(["--root", frozen.ASSETS, NAME])
    assert refused.value.code == 2
    with pytest.raises(TypeError):  # the writers take no default root
        frozen.save_frozen_stats(NAME, None, np.zeros((1, 28, 28, 1)), "")
