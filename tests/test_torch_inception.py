"""The port's InceptionV3 and its resizes against the JAX package's
``metrics/inception.py``.

The port's modules carry seeded random weights (``seeded_inception``: BN
statistics from one calibration batch, so activations stay of order
one); their ``state_dict()`` goes through JAX's
``convert_torchvision_state_dict`` into the flax modules, whose every
parameter and BN statistic it must fill with the right shape (held
against ``jax.eval_shape`` of ``InceptionV3.init``): the port's names are
torchvision's. Then:

* each block (InceptionA-E) at a small spatial size and narrow input,
  and the whole network at its smallest legal input, 75x75 at batch 1,
  in both pipelines (features of ``x*2-1`` with ``transform_input``,
  logits of raw x), equal JAX's within 1e-4 of the output's largest
  magnitude;
* ``inception_feature_fn``'s pipelines equal the network's on the
  resized batch (at 299 on the port only: JAX's network at 299 is too
  slow here), and its glue (the uint8 detection, the zero-padded last
  batch, which pipeline feeds which output) equals JAX's with both
  networks replaced by one cheap stand-in;
* ``load_converted_weights`` / ``load_torch_weights_npz`` of JAX's
  converted mapping give back the port's tensors;
* ``resize_for_inception`` (bilinear, and Lanczos-3 with antialiasing)
  equals JAX's at the upscale 28 -> 299, and ``resize`` equals
  ``jax.image.resize`` at a downscale 28 -> 20 and 28 -> 11, within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spiking_diffusion_tpu.metrics import inception as jax_inception
from spiking_diffusion_tpu_torch.metrics import inception

TOL = 1e-4  # of the output's largest magnitude
RESIZE_ATOL = 1e-5
# block -> (port constructor, the JAX module, input channels, spatial size)
BLOCKS = {
    "A": (lambda c: inception.InceptionA(c, 8), lambda: jax_inception.InceptionA(8), 16, 7),
    "B": (inception.InceptionB, jax_inception.InceptionB, 16, 7),
    "C": (lambda c: inception.InceptionC(c, 8), lambda: jax_inception.InceptionC(8), 16, 5),
    "D": (inception.InceptionD, jax_inception.InceptionD, 16, 7),
    "E": (inception.InceptionE, jax_inception.InceptionE, 16, 3),
}


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _jax_variables(state_dict):
    """Port state dict -> JAX's converted flat mapping -> nested flax
    {"params", "batch_stats"}."""
    flat = jax_inception.convert_torchvision_state_dict(
        {k: v.numpy() for k, v in state_dict.items()})
    params, stats = {}, {}
    for key, value in flat.items():
        *path, leaf = key.replace(".", "/").split("/")
        node = stats if leaf in ("mean", "var") else params
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(value)
    return {"params": params, "batch_stats": stats}


def _shapes(tree):
    return {jax.tree_util.keystr(p): tuple(v.shape)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _calibrated(module, x):
    """``module`` with BN running statistics from its batch on ``x``."""
    module.train()
    for m in module.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = None
            m.reset_running_stats()
    with torch.no_grad():
        module(x)
    return module.eval()


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_equals_jax(name):
    make, make_jax, cin, hw = BLOCKS[name]
    torch.manual_seed(0)
    x = np.random.RandomState(1).rand(2, hw, hw, cin).astype(np.float32)
    block = _calibrated(make(cin), torch.from_numpy(x).permute(0, 3, 1, 2))
    variables = _jax_variables(block.state_dict())
    jmodel = make_jax()
    init = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.asarray(x))
    assert _shapes(variables) == _shapes(init)
    want = jmodel.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = block(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got.numpy(), want)


@pytest.fixture(scope="module")
def network():
    gen = torch.Generator().manual_seed(1)
    model = inception.seeded_inception(0, torch.rand(4, 75, 75, 3, generator=gen))
    return model, _jax_variables(model.state_dict())


def test_state_dict_has_torchvision_names(network):
    model, variables = network
    sd = model.state_dict()
    assert len(sd) == 580  # torchvision inception_v3 with its aux classifier
    for key in ("Conv2d_1a_3x3.conv.weight", "Mixed_5b.branch1x1.bn.running_mean",
                "Mixed_6e.branch7x7dbl_5.bn.num_batches_tracked", "Mixed_7c.branch3x3_2b.conv.weight",
                "AuxLogits.conv0.conv.weight", "AuxLogits.conv1.bn.running_var",
                "AuxLogits.fc.weight", "fc.weight", "fc.bias"):
        assert key in sd, key
    assert tuple(sd["fc.weight"].shape) == (1000, 2048)
    init = jax.eval_shape(jax_inception.InceptionV3().init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 75, 75, 3)))
    assert _shapes(variables) == _shapes(init)
    fresh = inception.InceptionV3()
    fresh.load_state_dict(sd, strict=True)


def test_network_at_75_equals_jax(network):
    model, variables = network
    x = np.random.RandomState(2).rand(1, 75, 75, 3).astype(np.float32)
    jmodel = jax_inception.InceptionV3()
    fwd = jax.jit(lambda v, xx: (jmodel.apply(v, xx * 2.0 - 1.0, transform_input=True)[0],
                                 jmodel.apply(v, xx)[1]))
    want_feats, want_logits = fwd(variables, jnp.asarray(x))
    with torch.no_grad():
        feats, _ = model(torch.from_numpy(x) * 2.0 - 1.0, transform_input=True)
        _, logits = model(torch.from_numpy(x))
    assert float(np.abs(np.asarray(want_feats)).max()) > 0.1
    _close(feats.numpy(), want_feats)
    _close(logits.numpy(), want_logits)


def test_feature_fn_runs_both_pipelines(network):
    model, _ = network
    images = np.random.RandomState(3).randint(0, 256, (3, 28, 28, 1)).astype(np.uint8)
    feats, probs = inception.inception_feature_fn(model, batch_size=2, device="cpu")(images)
    assert feats.shape == (3, 2048) and probs.shape == (3, 1000)
    x = inception.resize_for_inception(images[:2].astype(np.float32) / 255.0, device="cpu")
    with torch.no_grad():
        want_feats, _ = model(x * 2.0 - 1.0, transform_input=True)
        _, logits = model(x)
    np.testing.assert_allclose(feats[:2], want_feats.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(probs[:2], torch.softmax(logits, -1).numpy(), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, rtol=1e-5)


# the stand-in network of the glue tests: per-channel means and mean
# squares of its NHWC input, which ``transform_input`` moves per channel
# as the real network's rescale does, and logits linear in them
STAND_IN_SHIFT = np.array([0.3, -0.2, 0.1], np.float32)
STAND_IN_W = np.random.RandomState(9).randn(6, 5).astype(np.float32)


class JaxStandIn:
    """Duck-types the flax network's ``apply`` for the JAX feature fns."""

    def apply(self, variables, x, train=False, transform_input=False):
        if transform_input:
            x = x * 0.5 + STAND_IN_SHIFT
        f = jnp.concatenate([x.mean((1, 2)), (x * x).mean((1, 2))], axis=-1)
        return f, f @ STAND_IN_W


class TorchStandIn(torch.nn.Module):
    """The same stand-in as an ``nn.Module`` for the port's feature fns."""

    def forward(self, x, transform_input=False):
        if transform_input:
            x = x * 0.5 + torch.from_numpy(STAND_IN_SHIFT)
        f = torch.cat([x.mean((1, 2)), (x * x).mean((1, 2))], dim=-1)
        return f, f @ torch.from_numpy(STAND_IN_W)


@pytest.mark.parametrize("kind,n", [("uint8", 3), ("float", 3), ("rgb", 4)])
def test_feature_fn_glue_equals_jax(kind, n):
    rng = np.random.RandomState(6)
    images = {"uint8": lambda: rng.randint(0, 256, (n, 28, 28, 1)).astype(np.uint8),
              "float": lambda: rng.rand(n, 28, 28, 1).astype(np.float32),
              "rgb": lambda: rng.rand(n, 20, 20, 3).astype(np.float32)}[kind]()
    want_feats, want_probs = jax_inception.inception_feature_fn(JaxStandIn(), {}, 2)(images)
    feats, probs = inception.inception_feature_fn(TorchStandIn(), batch_size=2,
                                                  device="cpu")(images)
    assert feats.shape == (n, 6) and probs.shape == (n, 5)
    np.testing.assert_allclose(feats, want_feats, rtol=0, atol=RESIZE_ATOL)
    np.testing.assert_allclose(probs, want_probs, rtol=0, atol=RESIZE_ATOL)


def test_load_converted_weights_round_trip(network, tmp_path):
    model, _ = network
    flat = jax_inception.convert_torchvision_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()})
    path = tmp_path / "inception_v3.npz"
    np.savez(path, **flat)
    for loaded in (inception.load_converted_weights(flat, device="cpu"),
                   inception.load_torch_weights_npz(str(path), device="cpu")):
        assert not loaded.training
        for key, value in loaded.state_dict().items():
            if not key.startswith("AuxLogits") and not key.endswith("num_batches_tracked"):
                assert torch.equal(value, model.state_dict()[key]), key
    del flat["Mixed_7c.branch_pool/bn/var"]
    with pytest.raises(ValueError, match="not in the weights"):
        inception.load_converted_weights(flat, device="cpu")


@pytest.mark.parametrize("antialias", [False, True])
def test_resize_for_inception_equals_jax(antialias):
    images = np.random.RandomState(4).rand(2, 28, 28, 1).astype(np.float32)
    want = np.asarray(jax_inception.resize_for_inception(images, antialias=antialias))
    got = inception.resize_for_inception(images, antialias=antialias, device="cpu")
    assert got.shape == (2, 299, 299, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=RESIZE_ATOL)


@pytest.mark.parametrize("method", ["bilinear", "lanczos3"])
@pytest.mark.parametrize("size", [20, 11])
def test_downscale_equals_jax(method, size):
    x = np.random.RandomState(5).rand(2, 28, 28, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, size, size, 3), method=method,
                                       antialias=True))
    got = inception.resize(torch.from_numpy(x), size, method)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=RESIZE_ATOL)
