"""The port's ``snn/functional.py``, ``snn/temporal.py`` ``seq_apply`` and
``snn/quantize.py`` against the JAX package's.

* ``fuse_model_conv_bn`` and ``folded_conv_params`` on a zoo model's
  state dict (a SpikingVGG with running statistics off identity, carried
  over from JAX by ``weights.zoo_state_dict``): the folded convs and the
  identity BNs equal JAX's folded variables within 1e-6, and the folded
  port model's eval logits equal the unfolded one's and JAX's folded
  model's within 1e-5 (spikes of every layer equal).
* ``temporal_efficient_loss`` within 1e-5 (``tests/test_functional.py``).
* ``chunked_scan`` of a LIF step: outputs and carry equal the unchunked
  scan's exactly and its gradients equal it exactly, both JAX's within
  ``tests/test_fptt.py``'s tolerances (1e-6; rtol 1e-5, atol 1e-6).
* ``delay`` and ``seq_apply`` exactly; the straight-through quantizers
  (round, ceil, floor, clamp, k-bit, affine): values and gradients
  exactly JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spiking_diffusion_tpu.models import zoo as jax_zoo
from spiking_diffusion_tpu.snn import functional as jax_functional
from spiking_diffusion_tpu.snn import neuron as jax_neuron
from spiking_diffusion_tpu.snn import quantize as jax_quantize
from spiking_diffusion_tpu.snn import temporal as jax_temporal
from spiking_diffusion_tpu_torch.models import weights
from spiking_diffusion_tpu_torch.snn import functional, neuron, quantize, temporal

VGG_CFG = (4, "M", 8, "M")


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _trained_vgg():
    """A small JAX SpikingVGG on 12x12x3 whose BN statistics moved off
    identity through three training forwards, and its eval input."""
    model = jax_zoo.SpikingVGG(cfg=VGG_CFG, num_classes=5, backend="scan")
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.uniform(0.0, 1.0, (4, 3, 12, 12, 3)).astype(np.float32))
    variables = model.init(jax.random.PRNGKey(0), x, train=True)
    variables = {"params": variables["params"], "batch_stats": variables["batch_stats"]}
    for i in range(3):
        _, mut = model.apply(variables, x * (1.0 + 0.5 * i), train=True,
                             mutable=["batch_stats"])
        variables = {**variables, "batch_stats": mut["batch_stats"]}
    return model, _np_tree(variables), x


def test_fuse_model_conv_bn_on_a_zoo_model():
    model, variables, x = _trained_vgg()
    fused_jax = _np_tree(jax_functional.fuse_model_conv_bn(variables))
    sd = {k: torch.from_numpy(np.array(v)) for k, v in
          weights.zoo_state_dict(variables["params"], variables["batch_stats"]).items()}
    fused = functional.fuse_model_conv_bn(sd)
    want = weights.zoo_state_dict(fused_jax["params"], fused_jax["batch_stats"])
    assert set(fused) == set(want)
    for key, value in want.items():
        np.testing.assert_allclose(fused[key].numpy(), value, rtol=1e-6, atol=1e-7,
                                   err_msg=key)
    for (w, b), (kj, bj) in zip(functional.folded_conv_params(sd, 2),
                                jax_functional.folded_conv_params(variables, 2)):
        np.testing.assert_allclose(w.numpy(), weights.conv_weight(kj), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(b.numpy(), np.asarray(bj), rtol=1e-6, atol=1e-7)
    # the folded model in eval: the unfolded port model's and JAX's folded logits
    kw = dict(cfg=VGG_CFG, num_classes=5, input_shape=(12, 12, 3))
    plain = weights.load_zoo_model("vgg", variables["params"], variables["batch_stats"],
                                   device="cpu", **kw)
    folded = weights.load_zoo_model("vgg", fused_jax["params"], fused_jax["batch_stats"],
                                    device="cpu", **kw)
    folded.load_state_dict(fused)
    xt = torch.from_numpy(np.array(x))
    with torch.no_grad():
        got, ref = folded(xt), plain(xt)
    want = np.asarray(model.apply(fused_jax, x, train=False))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-5)


def test_fuse_pairs_only_convs_with_their_batchnorm():
    sd = {"convs.0.weight": torch.ones(2, 1, 1, 1), "bns.0.scale": torch.full((2,), 2.0),
          "bns.0.bias": torch.zeros(2), "bns.0.mean": torch.ones(2), "bns.0.var": torch.ones(2),
          "deconvs.0.weight": torch.ones(1, 2, 1, 1), "readout.weight": torch.ones(2, 1, 1, 1)}
    fused = functional.fuse_model_conv_bn(sd, eps=0.0)
    assert torch.equal(fused["convs.0.weight"], torch.full((2, 1, 1, 1), 2.0))
    assert torch.equal(fused["convs.0.bias"], torch.full((2,), -2.0))  # bias-free conv gains one
    assert torch.equal(fused["bns.0.scale"], torch.ones(2))
    assert torch.equal(fused["bns.0.mean"], torch.zeros(2))
    assert fused["deconvs.0.weight"] is sd["deconvs.0.weight"]
    assert "deconvs.0.bias" not in fused and "readout.bias" not in fused


def test_temporal_efficient_loss_matches_jax():
    rng = np.random.RandomState(1)
    logits = rng.randn(4, 6, 5).astype(np.float32) * 3.0
    labels = rng.randint(0, 5, 6).astype(np.int32)
    want = float(jax_functional.temporal_efficient_loss(jnp.asarray(logits), jnp.asarray(labels)))
    got = functional.temporal_efficient_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    mse = lambda lg, lb: ((lg - 1.0) ** 2).mean()  # noqa: E731
    np.testing.assert_allclose(
        float(functional.temporal_efficient_loss(torch.from_numpy(logits), None, mse)),
        float(jax_functional.temporal_efficient_loss(jnp.asarray(logits), None, mse)), rtol=1e-5)


@pytest.mark.parametrize("chunk", [2, 4])
def test_chunked_scan_matches_the_plain_scan_and_jax(chunk):
    rng = np.random.RandomState(2)
    x = rng.uniform(-1, 3, (8, 3, 5)).astype(np.float32)
    w = rng.randn(8, 3, 5).astype(np.float32)
    p, jp = neuron.NeuronParams(), jax_neuron.NeuronParams()

    def step(v, xt):
        return neuron.lif_step(v, xt, p)

    def plain(v, xs):
        ys = []
        for xt in xs:
            v, y = step(v, xt)
            ys.append(y)
        return v, torch.stack(ys)

    runs = []
    for fn in (plain, lambda v, xs: functional.chunked_scan(step, v, xs, chunk)):
        xt = torch.from_numpy(x).requires_grad_()
        v, s = fn(torch.zeros(3, 5), xt)
        ((s * torch.from_numpy(w)).sum() + v.sum()).backward()
        runs.append((v.detach(), s.detach(), xt.grad))
    for got, want in zip(runs[1], runs[0]):
        assert torch.equal(got, want)
    jstep = lambda v, xt: jax_neuron.lif_step(v, xt, jp)  # noqa: E731

    def jloss(xs):
        v, s = jax_functional.chunked_scan(jstep, jnp.zeros((3, 5)), xs, chunk)
        return jnp.sum(s * w) + jnp.sum(v), (v, s)

    (_, (v_j, s_j)), g_j = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(x))
    v, s, g = runs[1]
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), atol=1e-6)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j), atol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="not divisible"):
        functional.chunked_scan(step, torch.zeros(3, 5), torch.from_numpy(x), 3)


def test_delay_and_seq_apply_match_jax():
    x = np.random.RandomState(3).randn(5, 2, 3).astype(np.float32)
    for steps in (0, 1, 3):
        np.testing.assert_array_equal(functional.delay(torch.from_numpy(x), steps).numpy(),
                                      np.asarray(jax_functional.delay(jnp.asarray(x), steps)))
    y = temporal.seq_apply(lambda a: a.sum(-1, keepdim=True) * 2.0, torch.from_numpy(x))
    want = jax_temporal.seq_apply(lambda a: a.sum(-1, keepdims=True) * 2.0, jnp.asarray(x))
    np.testing.assert_array_equal(y.numpy(), np.asarray(want))


QUANTIZERS = {
    "round_ste": lambda q, x: q.round_ste(x * 3.0),
    "ceil_ste": lambda q, x: q.ceil_ste(x * 3.0),
    "floor_ste": lambda q, x: q.floor_ste(x * 3.0),
    "clamp_ste": lambda q, x: q.clamp_ste(x, -0.5, 0.75),
    "k_bit_quantize": lambda q, x: q.k_bit_quantize(x * 0.5 + 0.5, 3),
    "affine_quantize": lambda q, x: q.affine_quantize(x, 4, -0.8, 0.6),
}


@pytest.mark.parametrize("name", sorted(QUANTIZERS))
def test_quantizers_match_jax(name):
    rng = np.random.RandomState(4)
    x = np.concatenate([rng.uniform(-1.2, 1.2, 200), [-0.5, 0.75, 0.5, -1.0]]).astype(np.float32)
    g = rng.randn(x.size).astype(np.float32)
    fn = QUANTIZERS[name]
    want, vjp = jax.vjp(lambda a: fn(jax_quantize, a), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = fn(quantize, xt)
    got.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))
