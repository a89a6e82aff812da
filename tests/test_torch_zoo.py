"""The port's classifier zoo, its layers, its trainer and ANN -> SNN
conversion against the JAX package's ``models/zoo.py``,
``models/layers.py`` and ``models/ann2snn.py``.

Each model is initialised by JAX ``model.init`` (BN scales and biases
moved off identity and Dense kernels scaled, so that every LIF and PLIF
layer fires at these widths; running statistics at the batch's) and
carried into the port by ``weights.load_zoo_model``; both run the same
numpy input, T = 4 and batch 3:

* the layers: max and average pools, ``SeqLinear`` (flax ``Dense``),
  ``VotingLayer`` and a bias-free ``SeqConv`` within 1e-6; ``SeqDropout``
  fed the mask JAX drew (read off its output) gives JAX's output
  exactly, one mask for every step, and its own draw from a seeded
  generator keeps 1 - rate within 4 sigma; eval is the identity.
* SpikingVGG (a 3x3 map at the flatten, so the (H, W, C) order shows),
  SpikingResNet, SEW-ResNet with ADD, AND and IAND, and PLIFNet: in
  eval and in training mode, every LIF and PLIF layer's spikes exactly
  JAX's, the logits within 1e-5; after one training forward the BN
  running statistics within 1e-5; the gradients of one step's
  cross-entropy within 1e-5 relative to each tensor's largest.
* ``train_classifier`` on 256 synthetic MNIST images takes a small VGG
  above chance (accuracy > 0.2, as JAX's ``test_train_classifier_learns``).
* ANN -> SNN ``convert`` in max and percentile mode: the conv ReLU's
  scale exactly JAX's, the dense ReLU's within 1e-6 (a sum of 196
  products in another order than XLA's dot), the ANN's and the SNN's
  outputs within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from spiking_diffusion_tpu.models import ann2snn as jax_ann2snn
from spiking_diffusion_tpu.models import layers as jax_layers
from spiking_diffusion_tpu.models import zoo as jax_zoo
from spiking_diffusion_tpu_torch.data import synthetic_dataset
from spiking_diffusion_tpu_torch.models import ann2snn, layers, weights, zoo

T, N = 4, 3
ATOL = 1e-5
GRAD_RTOL = 1e-5
# name -> (JAX module, port kind, port kwargs, input (H, W, C))
MODELS = {
    "vgg": (jax_zoo.SpikingVGG(cfg=(4, "M", 8, "M"), num_classes=5, backend="scan"), "vgg",
            dict(cfg=(4, "M", 8, "M"), num_classes=5, input_shape=(12, 12, 3)), (12, 12, 3)),
    "resnet": (jax_zoo.SpikingResNet(stages=(1, 1), width=4, num_classes=5, backend="scan"),
               "resnet", dict(stages=(1, 1), width=4, num_classes=5), (8, 8, 3)),
    **{f"sew_{g}": (jax_zoo.SEWResNet(stages=(1, 1), width=4, num_classes=5, backend="scan",
                                      sew=g.upper()),
                    "sew", dict(stages=(1, 1), width=4, num_classes=5, sew=g.upper()), (8, 8, 3))
       for g in ("add", "and", "iand")},
    "plif": (jax_zoo.PLIFNet(channels=4, num_classes=5, voting_size=2), "plif",
             dict(channels=4, num_classes=5, voting_size=2, input_shape=(12, 12, 1)),
             (12, 12, 1)),
}


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _widen(tree, rng):
    """BN scales and biases off identity, Dense kernels 8x: every LIF and
    PLIF layer fires at these widths."""
    for key, node in tree.items():
        if key == "BatchNorm_0":
            node["scale"] = rng.uniform(1.5, 2.5, node["scale"].shape).astype(np.float32)
            node["bias"] = rng.uniform(-0.2, 0.4, node["bias"].shape).astype(np.float32)
        elif key == "Dense_0":
            node["kernel"] = node["kernel"] * np.float32(8.0)
        elif isinstance(node, dict):
            _widen(node, rng)


def _setup(name, seed=0):
    jmodel, kind, kw, hwc = MODELS[name]
    rng = np.random.RandomState(seed)
    x = rng.uniform(0.0, 1.0, (T, N) + hwc).astype(np.float32)
    labels = rng.randint(0, 5, N).astype(np.int32)
    variables = _np(jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(x), train=True))
    variables = {"params": variables["params"], "batch_stats": variables["batch_stats"]}
    _widen(variables["params"], rng)
    # running statistics at this batch's, so that eval fires as training does
    _, mut = jmodel.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    variables["batch_stats"] = jax.tree.map(lambda new, old: (new - 0.9 * old) / 0.1,
                                            _np(mut["batch_stats"]), variables["batch_stats"])
    return jmodel, kind, kw, variables, x, labels


class _Recorder:
    """Records every LIF and PLIF spike train of a forward, in call order."""

    def __init__(self, monkeypatch, module, names):
        self.trains = []
        for name in names:
            fn = getattr(module, name)

            def wrapped(*args, _fn=fn, **kwargs):
                out = _fn(*args, **kwargs)
                s = out[0] if isinstance(out, tuple) else out
                if isinstance(s, torch.Tensor):
                    self.trains.append(s.detach().numpy().copy())
                elif not isinstance(s, jax.core.Tracer):
                    self.trains.append(np.array(s))
                return out

            monkeypatch.setattr(module, name, wrapped)


def _spikes_equal(port, jax_trains):
    assert len(port) == len(jax_trains) > 0
    for i, (got, want) in enumerate(zip(port, jax_trains)):
        if want.ndim == 5:  # (T, N, H, W, C) -> the port's (T, N, C, H, W)
            want = want.transpose(0, 1, 4, 2, 3)
        np.testing.assert_array_equal(got, want, err_msg=f"spike train {i}")
        assert 0.0 < want.mean() < 1.0, f"spike train {i} is silent or saturated"


def _jax_run(jmodel, variables, x, labels, train):
    def loss_fn(params):
        out = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                           jnp.asarray(x), train=train,
                           mutable=["batch_stats"] if train else False)
        logits, stats = out if train else (out, None)
        loss = optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(labels)).mean()
        return loss, (logits, stats)

    return loss_fn


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_zoo_model_matches_jax(monkeypatch, name, train):
    jmodel, kind, kw, variables, x, labels = _setup(name)
    rec_jax = _Recorder(monkeypatch, jax_layers, ["lif_multi_step"])
    rec_jax_plif = _Recorder(monkeypatch, jax_zoo, ["plif_scan"])
    loss_fn = _jax_run(jmodel, variables, x, labels, train)
    jparams = jax.tree.map(jnp.asarray, variables["params"])
    loss_j, (logits_j, stats_j) = loss_fn(jparams)
    jax_trains = rec_jax.trains + rec_jax_plif.trains

    model = weights.load_zoo_model(kind, variables["params"], variables["batch_stats"],
                                   device="cpu", train=train, **kw)
    rec = _Recorder(monkeypatch, zoo, ["lif_multi_step", "plif_scan"])
    logits = model(torch.from_numpy(x))
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(labels).long())
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_j), rtol=0, atol=ATOL)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=0, atol=ATOL)
    _spikes_equal(rec.trains, jax_trains)
    if not train:
        return
    want = weights.zoo_state_dict(variables["params"], _np(stats_j["batch_stats"]))
    stats = {k: v for k, v in model.state_dict().items() if k.endswith((".mean", ".var"))}
    assert stats
    for key, value in stats.items():
        np.testing.assert_allclose(value.numpy(), want[key], rtol=1e-5, atol=ATOL, err_msg=key)
    loss.backward()
    grads_j = jax.grad(lambda p: loss_fn(p)[0])(jparams)
    want = weights.zoo_state_dict(_np(grads_j), variables["batch_stats"])
    largest = max(float(np.abs(g).max()) for g in want.values())
    for key, p in model.named_parameters():
        # a conv bias ahead of a training BN has no gradient (BN takes the
        # batch mean out): both sides hold rounding, held at the model's scale
        zero = ".convs." in f".{key}" and key.endswith(".bias")
        scale = largest if zero else float(np.abs(want[key]).max())
        assert scale > 0.0, key
        np.testing.assert_allclose(p.grad.numpy(), want[key], rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=key)


def test_layers_match_jax():
    rng = np.random.RandomState(1)
    x = rng.rand(2, 3, 8, 8, 4).astype(np.float32)
    folded = torch.from_numpy(x).permute(0, 1, 4, 2, 3).reshape(6, 4, 8, 8)
    for jl, pl in ((jax_layers.SeqMaxPool(2), layers.SeqMaxPool(2)),
                   (jax_layers.SeqAvgPool(2), layers.SeqAvgPool(2))):
        want = np.asarray(jl.apply({}, jnp.asarray(x))).transpose(0, 1, 4, 2, 3)
        np.testing.assert_allclose(pl(folded).reshape(2, 3, 4, 4, 4).numpy(), want,
                                   rtol=0, atol=1e-6)
    dense = jax_layers.SeqLinear(5)
    v = _np(dense.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    lin = layers.SeqLinear(4, 5)
    lin.load_state_dict({k.replace("linear.", ""): torch.from_numpy(a) for k, a in
                         weights.zoo_state_dict({"SeqLinear_0": v["params"]},
                                                {}).items()})
    np.testing.assert_allclose(lin(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(dense.apply(v, jnp.asarray(x))), rtol=0, atol=1e-6)
    votes = layers.VotingLayer(10)(torch.arange(20.0).reshape(1, 20))
    np.testing.assert_array_equal(
        votes.numpy(),
        np.asarray(jax_layers.VotingLayer(10).apply({}, jnp.arange(20.0).reshape(1, 20))))
    conv = jax_layers.SeqConv(6, 3, 1, 1, use_bias=False)
    cv = _np(conv.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    assert set(cv["params"]["Conv_0"]) == {"kernel"}
    pconv = layers.SeqConv(4, 6, 3, 1, 1, use_bias=False)
    assert pconv.bias is None
    pconv.weight.data = torch.from_numpy(weights.conv_weight(cv["params"]["Conv_0"]["kernel"]))
    want = np.asarray(conv.apply(cv, jnp.asarray(x))).transpose(0, 1, 4, 2, 3)
    np.testing.assert_allclose(pconv(folded).reshape(2, 3, 6, 8, 8).detach().numpy(), want,
                               rtol=0, atol=1e-6)


def test_seq_dropout_matches_jax():
    rng = np.random.RandomState(2)
    x = rng.uniform(0.5, 1.5, (4, 2, 16)).astype(np.float32)
    y_jax = np.asarray(jax_layers.SeqDropout(rate=0.3).apply(
        {}, jnp.asarray(x), deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)}))
    mask = torch.from_numpy((y_jax[0] != 0).astype(np.float32))
    drop = layers.SeqDropout(rate=0.3).train()
    np.testing.assert_array_equal(drop(torch.from_numpy(x), mask=mask).numpy(), y_jax)
    # its own draw: one mask of shape x.shape[1:] for every step
    big = torch.ones((3, 64, 64))
    y = drop(big, generator=torch.Generator().manual_seed(0))
    for t in range(1, 3):
        assert torch.equal(y[t], y[0])
    keep = float((y[0] != 0).float().mean())
    assert abs(keep - 0.7) <= 4 * (0.7 * 0.3 / y[0].numel()) ** 0.5
    assert set(np.unique(y[0].numpy())) == {0.0, np.float32(1.0) / np.float32(0.7)}
    assert torch.equal(drop.eval()(big), big)


def test_train_classifier_learns():
    ds = synthetic_dataset("MNIST", n_train=256, n_test=64, seed=1)
    kw = dict(cfg=(8, "M", 8, "M"), num_classes=10, input_shape=(28, 28, 1))
    model = weights.load_zoo_model(
        "vgg", *weights.init_zoo_variables("vgg", torch.Generator().manual_seed(0), **kw),
        device="cpu", **kw)
    trained, acc = zoo.train_classifier(model, ds.train_images, ds.train_labels, num_steps=2,
                                        epochs=6, batch_size=64, device="cpu")
    assert trained is model and model.training
    assert acc > 0.2, acc  # well above 0.1 chance


ANN_SPECS = [("conv", {"stride": 1, "padding": 1}), ("relu",), ("pool", 2), ("flatten",),
             ("dense", {}), ("relu",), ("dense", {})]


@pytest.mark.parametrize("mode", ["max", "percentile"])
def test_ann2snn_conversion_matches_jax(mode):
    rng = np.random.RandomState(0)
    params = [
        {"kernel": rng.randn(3, 3, 1, 4).astype(np.float32) * 0.3,
         "bias": rng.randn(4).astype(np.float32) * 0.1},
        None, None, None,
        {"kernel": rng.randn(4 * 7 * 7, 16).astype(np.float32) * 0.1,
         "bias": np.zeros(16, np.float32)},
        None,
        {"kernel": rng.randn(16, 5).astype(np.float32) * 0.3, "bias": np.zeros(5, np.float32)},
    ]
    x = rng.rand(8, 14, 14, 1).astype(np.float32)
    jparams = [None if p is None else {k: jnp.asarray(v) for k, v in p.items()} for p in params]
    tparams = weights.ann2snn_params(ANN_SPECS, params)
    np.testing.assert_allclose(
        ann2snn.ann_forward(ANN_SPECS, tparams, torch.from_numpy(x)).numpy(),
        np.asarray(jax_ann2snn.ann_forward(ANN_SPECS, jparams, jnp.asarray(x))),
        rtol=0, atol=ATOL)
    snn_j, scales_j = jax_ann2snn.convert(ANN_SPECS, jparams, jnp.asarray(x), mode=mode,
                                          num_steps=64)
    snn, scales = ann2snn.convert(ANN_SPECS, tparams, torch.from_numpy(x), mode=mode,
                                  num_steps=64)
    assert [s is None for s in scales] == [s is None for s in scales_j]
    assert sum(s is not None for s in scales) == 2
    # the conv's ReLU exactly; the dense layer's within 1e-6 (its sum of 196
    # products runs in another order than XLA's dot: 2 ulps at the max)
    assert scales[1] == scales_j[1]
    np.testing.assert_allclose(scales[5], scales_j[5], rtol=1e-6)
    np.testing.assert_allclose(snn(torch.from_numpy(x)).numpy(),
                               np.asarray(snn_j(jnp.asarray(x))), rtol=0, atol=ATOL)
