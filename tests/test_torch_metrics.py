"""The port's metrics against the JAX package's on the CPU, on the same
numpy inputs.

* LeNet: features and probabilities of the committed frozen MNIST space
  on 256 synthetic images, in fp32 operands against JAX on the CPU, and in
  bf16 operands (the arithmetic of the JAX package's default precision on
  a TPU, where the frozen spaces were made) against the JAX LeNet with its
  conv and dense operands rounded to bf16. fp32 at atol/rtol 1e-5; bf16
  operands with at least 99 % of elements within 1e-5 and all within 1e-2
  (the frameworks sum in another order, and a sum that lands on the other
  side of a bf16 rounding boundary moves the next layer's operand by one
  bf16 step, 2^-8 of it).
* The 12 assets are byte copies with the JAX package's ``space_hash``;
  the committed MNIST stats verify on the canonical real set in bf16
  operands (and miss in fp32), with the null FID of the JAX record.
* ``get_feature_space`` in 'auto', 'on' and 'off'.
* ``train_lenet`` from the same initial parameters to ``optax.adam``'s
  parameters at 1e-5.
* FID, IS, KID (unit-normalised) and mode-coverage KL on the same
  features at 1e-9 relative (both numpy); SSIM at 1e-6.
"""

import filecmp
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from spiking_diffusion_tpu.metrics import frozen as jax_frozen
from spiking_diffusion_tpu.metrics import mode_coverage as jax_mode
from spiking_diffusion_tpu.metrics import scores as jax_scores
from spiking_diffusion_tpu.metrics.features import LeNet as JaxLeNet
from spiking_diffusion_tpu.metrics.features import lenet_feature_fn as jax_lenet_feature_fn
from spiking_diffusion_tpu.metrics.ssim import ssim as jax_ssim
from spiking_diffusion_tpu_torch.data import synthetic_dataset
from spiking_diffusion_tpu_torch.metrics import frozen, mode_coverage, scores
from spiking_diffusion_tpu_torch.metrics.features import (
    lenet_feature_fn,
    lenet_params,
    train_lenet,
)
from spiking_diffusion_tpu_torch.metrics.ssim import ssim

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_NEAR_SHARE = 0.99  # bf16 operands: share of elements within TOL
BF16_ATOL = 1e-2  # and every element within this
SCORE_RTOL = 1e-9
SSIM_ATOL = 1e-6
ASSET_NAMES = ("MNIST", "FMNIST", "KMNIST", "Letters", "CIFAR10", "CIFAR10-BW")
MNIST_SHA = "fa7286439409571c"
RECORD_NULL_FID = 12.676  # sample_r5_e60/MNIST/snn-vq-vae/metrics.json
NULL_FID_ATOL = 0.01


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def images():
    return synthetic_dataset("MNIST", n_train=256, n_test=8, seed=3).train_images


def _nested(flat):
    tree = {}
    for key, value in flat.items():
        layer, leaf = key.split("/")
        tree.setdefault(layer, {})[leaf] = jnp.asarray(value)
    return tree


def _bf16(x):
    return jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)


def _jax_tpu_arithmetic(params, x):
    """The JAX LeNet with every conv and dense operand rounded to bf16 and
    fp32 sums: kernels rounded up front, inputs by an interceptor."""

    def round_inputs(next_fun, args, kwargs, context):
        if isinstance(context.module, (fnn.Conv, fnn.Dense)) and context.method_name == "__call__":
            args = (_bf16(args[0]),) + tuple(args[1:])
        return next_fun(*args, **kwargs)

    rounded = {k: (_bf16(v) if k.endswith("kernel") else v) for k, v in params.items()}
    with fnn.intercept_methods(round_inputs):
        logits, feats = JaxLeNet(10).apply({"params": _nested(rounded)}, jnp.asarray(x),
                                           return_features=True)
    return np.asarray(feats), np.asarray(jax.nn.softmax(logits, axis=-1))


def test_lenet_fp32_equals_jax(images):
    model, params, _ = frozen.load_frozen_lenet("MNIST")
    for key, value in lenet_params(model).items():
        np.testing.assert_array_equal(value, params[key], err_msg=key)
    model.operand_dtype = None
    feats, probs = lenet_feature_fn(model, device="cpu")(images)
    jm, jp, _ = jax_frozen.load_frozen_lenet("MNIST")
    want_f, want_p = jax_lenet_feature_fn(jm, jp)(images)
    assert feats.shape == (256, 84) and probs.shape == (256, 10)
    np.testing.assert_allclose(feats, want_f, **TOL)
    np.testing.assert_allclose(probs, want_p, **TOL)


def test_lenet_frozen_arithmetic_equals_jax_bf16_operands(images):
    model, params, _ = frozen.load_frozen_lenet("MNIST")
    assert model.operand_dtype == torch.bfloat16
    feats, probs = lenet_feature_fn(model, device="cpu")(images)
    want_f, want_p = _jax_tpu_arithmetic(params, images)
    for got, want in ((feats, want_f), (probs, want_p)):
        near = np.isclose(got, want, **TOL)
        assert near.mean() >= BF16_NEAR_SHARE, near.mean()
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ATOL)


def test_feature_fn_uint8_and_3dim(images):
    model, _, _ = frozen.load_frozen_lenet("MNIST")
    fn = lenet_feature_fn(model, device="cpu")
    u8 = (images[:20] * 255).astype(np.uint8)
    f1, p1 = fn(u8[..., 0], batch_size=8)
    f2, p2 = fn(u8.astype(np.float32) / 255.0)
    np.testing.assert_array_equal(f1, f2)
    np.testing.assert_array_equal(p1, p2)


@pytest.mark.parametrize("kind", ["lenet", "stats"])
@pytest.mark.parametrize("name", ASSET_NAMES)
def test_assets_are_byte_copies(kind, name):
    fname = f"{kind}_{name}.npz"
    assert filecmp.cmp(os.path.join(frozen.ASSETS, fname),
                       os.path.join(jax_frozen.ASSETS, fname), shallow=False)
    if kind == "lenet":
        _, params, info = frozen.load_frozen_lenet(name)
        _, jparams, jinfo = jax_frozen.load_frozen_lenet(name)
        assert frozen.space_hash(params) == jax_frozen.space_hash(jparams) == info["space_sha"]
        assert info == jinfo


def test_mnist_space_sha():
    _, params, _ = frozen.load_frozen_lenet("MNIST")
    assert frozen.space_hash(params).startswith(MNIST_SHA)


def test_frozen_stats_verify_on_canonical_set():
    ds = synthetic_dataset("MNIST", n_train=60000, n_test=10240)
    real, held = ds.test_images[:8192], ds.test_images[8192:]
    stats = frozen.load_frozen_stats("MNIST")
    assert stats["data_sha"] == frozen.data_hash(real) == jax_frozen.data_hash(real)
    model, _, _ = frozen.load_frozen_lenet("MNIST")
    fn = lenet_feature_fn(model, device="cpu")
    feats, _ = fn(real)
    mu, sigma = np.mean(feats, axis=0), np.cov(feats, rowvar=False)
    # the CLI's drift check
    np.testing.assert_allclose(mu, stats["mu"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(sigma, stats["sigma"], rtol=1e-3, atol=1e-4)
    held_feats, _ = fn(held)
    assert abs(scores.fid_from_features(feats, held_feats) - RECORD_NULL_FID) <= NULL_FID_ATOL
    # fp32 operands do not reproduce the stats
    model.operand_dtype = None
    feats32, _ = lenet_feature_fn(model, device="cpu")(real)
    assert np.abs(np.mean(feats32, axis=0) - stats["mu"]).max() > 1e-2


def test_get_feature_space_modes(tmp_path):
    ds = synthetic_dataset("MNIST", n_train=128, n_test=8)
    args = (ds.train_images, ds.train_labels, 10)
    fn, info = frozen.get_feature_space("MNIST", *args, mode="auto", log_fn=None, device="cpu")
    assert info["frozen"] and info["space_sha"].startswith(MNIST_SHA)
    _, on_info = frozen.get_feature_space("MNIST", *args, mode="on", log_fn=None, device="cpu")
    assert on_info == info
    with pytest.raises(FileNotFoundError):
        frozen.get_feature_space("MNIST", *args, mode="on", root=str(tmp_path), log_fn=None,
                                 device="cpu")
    with pytest.raises(ValueError):
        frozen.get_feature_space("MNIST", *args, mode="sometimes", device="cpu")
    off_fn, off_info = frozen.get_feature_space("MNIST", *args, mode="off", log_fn=None,
                                                device="cpu")
    assert not off_info["frozen"] and off_info["space_sha"] != info["space_sha"]
    # auto without a compatible space retrains, as 'off' does
    auto_fn, auto_info = frozen.get_feature_space("MNIST", *args, mode="auto",
                                                  root=str(tmp_path), log_fn=None, device="cpu")
    assert auto_info == off_info
    feats, probs = auto_fn(ds.test_images)
    np.testing.assert_array_equal(feats, off_fn(ds.test_images)[0])
    assert feats.shape == (8, 84) and np.allclose(probs.sum(axis=1), 1.0, atol=1e-6)


def test_train_lenet_equals_optax_adam():
    ds = synthetic_dataset("MNIST", n_train=200, n_test=8, seed=5)
    x, y = ds.train_images, ds.train_labels
    jmodel = JaxLeNet(10)
    init = jmodel.init(jax.random.PRNGKey(7), jnp.zeros((1, 28, 28, 1)))["params"]
    flat = {f"{layer}/{leaf}": np.asarray(v) for layer, d in init.items() for leaf, v in d.items()}
    epochs, batch = 2, 64
    _, params = train_lenet(x, y, 10, epochs=epochs, batch_size=batch, seed=3, params=flat,
                            device="cpu")

    tx = optax.adam(1e-3)
    jparams, opt_state = init, tx.init(init)

    @jax.jit
    def step(p, s, xb, yb):
        def loss_fn(p):
            logits = jmodel.apply({"params": p}, xb)
            return optax.softmax_cross_entropy_with_integer_labels(logits, yb).mean()
        grads = jax.grad(loss_fn)(p)
        updates, s = tx.update(grads, s)
        return optax.apply_updates(p, updates), s

    for epoch in range(epochs):
        order = np.random.RandomState(3 + epoch).permutation(len(x))
        for i in range(0, len(x) - len(x) % batch, batch):
            idx = order[i:i + batch]
            jparams, opt_state = step(jparams, opt_state, jnp.asarray(x[idx]), jnp.asarray(y[idx]))
    for key, value in params.items():
        layer, leaf = key.split("/")
        np.testing.assert_allclose(value, np.asarray(jparams[layer][leaf]), **TOL, err_msg=key)
        assert not np.array_equal(value, flat[key]), key  # it trained


@pytest.mark.parametrize("seed", [0, 1])
def test_scores_equal_jax(seed):
    rng = np.random.RandomState(seed)
    real = rng.normal(0.0, 3.0, (600, 84)).astype(np.float32)
    fake = (rng.normal(0.5, 2.5, (520, 84)) + real[:520] * 0.3).astype(np.float32)
    logits = rng.normal(0.0, 2.0, (520, 10))
    probs = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(np.float32)
    np.testing.assert_allclose(scores.fid_from_features(fake, real),
                               jax_scores.fid_from_features(fake, real), rtol=SCORE_RTOL)
    np.testing.assert_allclose(scores.inception_score_from_probs(probs, splits=4),
                               jax_scores.inception_score_from_probs(probs, splits=4),
                               rtol=SCORE_RTOL)
    for normalize in ("unit", "none"):
        np.testing.assert_allclose(
            scores.kid_from_features(real, fake, subsets=10, subset_size=500, normalize=normalize),
            jax_scores.kid_from_features(real, fake, subsets=10, subset_size=500,
                                         normalize=normalize), rtol=SCORE_RTOL)
    mu, sigma = scores.gaussian_stats(real)
    jmu, jsigma = jax_scores.gaussian_stats(real)
    np.testing.assert_array_equal(mu, jmu)
    np.testing.assert_array_equal(sigma, jsigma)

    def fn(images):
        return fake[:len(images)], probs[:len(images)]

    imgs = np.zeros((520, 28, 28, 1), np.float32)
    got = mode_coverage.mode_coverage_kl(fn, imgs, 10)
    want = jax_mode.mode_coverage_kl(fn, imgs, 10)
    np.testing.assert_allclose(got["kl"], want["kl"], rtol=SCORE_RTOL)
    np.testing.assert_array_equal(got["histogram"], want["histogram"])
    assert got["covered_modes"] == want["covered_modes"]


@pytest.mark.parametrize("channels", [1, 3])
def test_ssim_equals_jax(channels):
    rng = np.random.RandomState(channels)
    a = rng.uniform(-0.5, 0.5, (6, 28, 28, channels)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), -0.5, 0.5).astype(np.float32)
    got = float(ssim(torch.from_numpy(a), torch.from_numpy(b)))
    want = float(jax_ssim(jnp.asarray(a), jnp.asarray(b)))
    assert abs(got - want) <= SSIM_ATOL
    assert abs(float(ssim(torch.from_numpy(a), torch.from_numpy(a))) - 1.0) <= SSIM_ATOL
