"""The port's deployment export against ``spiking_diffusion_tpu.models.deploy``,
and the weights' way back to JAX's trees.

* ``weights.{vqvae,denoiser,zoo}_variables`` of a port module loaded from
  JAX's ``model.init`` variables give those variables back: the same
  keys, shapes and dtypes, bitwise.
* The netlist the port writes equals JAX's for the same variables (the
  manifest after ``json.load``, every npz array bitwise); each package
  reads the other's; a VQ-VAE reloaded from a netlist gives the
  original's forward.
* The Lynxi layer list and files equal JAX's; the port's reference
  forward on JAX's files matches JAX's (spikes exact, logits within
  1e-5); JAX's three rejections stand.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spiking_diffusion_tpu.config import DiffusionConfig as JaxDiffusionConfig
from spiking_diffusion_tpu.config import VQVAEConfig as JaxVQVAEConfig
from spiking_diffusion_tpu.models import SNNVQVAE as JaxSNNVQVAE
from spiking_diffusion_tpu.models import SpikingDenoiser as JaxDenoiser
from spiking_diffusion_tpu.models import deploy as jax_deploy
from spiking_diffusion_tpu.models import zoo as jax_zoo
from spiking_diffusion_tpu_torch.config import DiffusionConfig, VQVAEConfig
from spiking_diffusion_tpu_torch.models import deploy, weights
from spiking_diffusion_tpu_torch.snn.neuron import NeuronParams

LOGIT_ATOL = 1e-5
VQ = dict(num_steps=2, embedding_dim=4, num_embeddings=8, enc_channels=(4, 8),
          dec_channels=(8, 4))
DIFF = dict(denoiser_channels=(4, 8, 8, 8, 4), num_embeddings=16, mask_id=16, num_steps=4)
VGG_CFG = (4, "M", 8)
T, N, HW, C, CLASSES = 3, 2, 8, 1, 5


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _numpy_tree(tree, rng=None):
    """A flax tree as numpy; with ``rng`` its BN variances and means moved
    off their init values, so the round trip is held on varied values."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _numpy_tree(v, rng)
        else:
            a = np.array(v)
            if rng is not None and k in ("mean", "var"):
                a = (a + rng.uniform(0.1, 0.5, a.shape)).astype(a.dtype)
            out[k] = a
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_trees_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.fixture(scope="module")
def jax_vqvae():
    model = JaxSNNVQVAE(JaxVQVAEConfig(**VQ), backend="scan")
    v = jax.jit(lambda k: model.init(k, jnp.zeros((1, 28, 28, 1)), train=True))(
        jax.random.PRNGKey(0))
    rng = np.random.RandomState(1)
    return model, {"params": _numpy_tree(v["params"]),
                   "batch_stats": _numpy_tree(v["batch_stats"], rng)}


@pytest.fixture(scope="module")
def jax_vgg():
    model = jax_zoo.SpikingVGG(cfg=VGG_CFG, num_classes=CLASSES, backend="scan")
    v = jax.jit(lambda k: model.init(k, jnp.zeros((T, N, HW, HW, C)), train=True))(
        jax.random.PRNGKey(0))
    stats = _numpy_tree(v["batch_stats"])
    rng = np.random.RandomState(6)
    for node in stats.values():  # running statistics that make every layer fire
        bn = node["BatchNorm_0"]
        bn["mean"] = rng.uniform(-0.2, 0.2, bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(0.01, 0.05, bn["var"].shape).astype(np.float32)
    return model, {"params": _numpy_tree(v["params"]), "batch_stats": stats}


def _port_vgg(variables):
    return weights.load_zoo_model("vgg", variables["params"], variables["batch_stats"],
                                  device="cpu", cfg=VGG_CFG, num_classes=CLASSES,
                                  input_shape=(HW, HW, C))


def test_vqvae_variables_give_jax_tree_back(jax_vqvae):
    _, want = jax_vqvae
    vq = weights.load_vqvae(want["params"], want["batch_stats"], VQVAEConfig(**VQ),
                            device="cpu")
    _assert_trees_equal(weights.vqvae_variables(vq), want)


def test_denoiser_variables_give_jax_tree_back():
    model = JaxDenoiser(JaxDiffusionConfig(**DIFF), backend="scan")
    v = jax.jit(lambda k: model.init(k, jnp.zeros((2, 7, 7), jnp.int32),
                                     jnp.ones((2,), jnp.int32), train=True))(
        jax.random.PRNGKey(3))
    want = {"params": _numpy_tree(v["params"]),
            "batch_stats": _numpy_tree(v["batch_stats"], np.random.RandomState(4))}
    den = weights.load_denoiser(want["params"], want["batch_stats"], DiffusionConfig(**DIFF),
                                device="cpu")
    _assert_trees_equal(weights.denoiser_variables(den), want)


def test_zoo_variables_give_jax_tree_back(jax_vgg):
    _, want = jax_vgg
    _assert_trees_equal(weights.zoo_variables(_port_vgg(want)), want)


def _read_netlist(path):
    with open(path + ".json") as f:
        manifest = json.load(f)
    with np.load(path + ".npz") as data:
        return manifest, {k: data[k] for k in data.files}


def test_netlist_files_equal_jax_and_read_across(tmp_path, jax_vqvae):
    model, variables = jax_vqvae
    cfg = VQVAEConfig(**VQ)
    vq = weights.load_vqvae(variables["params"], variables["batch_stats"], cfg, device="cpu")
    meta = {"model": "snn-vq-vae", "T": VQ["num_steps"]}
    jax_deploy.export_netlist(dict(variables), str(tmp_path / "jax"),
                              neuron_params=JaxVQVAEConfig(**VQ).lif.to_params(), meta=meta)
    jp, npzp = deploy.export_netlist(weights.vqvae_variables(vq), str(tmp_path / "port"),
                                     neuron_params=cfg.lif.to_params(), meta=meta)
    assert (jp, npzp) == (str(tmp_path / "port.json"), str(tmp_path / "port.npz"))
    (m_jax, a_jax), (m_port, a_port) = (_read_netlist(str(tmp_path / n))
                                        for n in ("jax", "port"))
    assert m_port == m_jax
    assert sorted(a_port) == sorted(a_jax)
    for k, want in a_jax.items():
        assert a_port[k].dtype == want.dtype and a_port[k].shape == want.shape, k
        np.testing.assert_array_equal(a_port[k], want, err_msg=k)

    # each package reads the other's files
    port_read, manifest = deploy.import_netlist(str(tmp_path / "jax"))
    assert manifest == m_jax
    jax_read, _ = jax_deploy.import_netlist(str(tmp_path / "port"))
    _assert_trees_equal(port_read, {k: variables[k] for k in ("params", "batch_stats")})
    _assert_trees_equal(jax.tree.map(np.asarray, jax_read), port_read)

    # the module reloaded from the netlist runs the original's forward
    again = weights.load_vqvae(port_read["params"], port_read["batch_stats"], cfg,
                               device="cpu")
    images = torch.from_numpy(np.random.RandomState(2).rand(2, 28, 28, 1).astype(np.float32)
                              - 0.5)
    with torch.no_grad():
        want, got = vq(images, train=False), again(images, train=False)
    for key in ("recon", "indices", "spikes"):
        assert torch.equal(got[key], want[key]), key


def test_lynxi_layers_and_files_equal_jax(tmp_path, jax_vgg):
    _, variables = jax_vgg
    layers = deploy.lynxi_layers_from_vgg(VGG_CFG, num_classes=CLASSES)
    assert layers == jax_deploy.lynxi_layers_from_vgg(VGG_CFG, num_classes=CLASSES)
    jax_deploy.export_lynxi(layers, variables, str(tmp_path / "jax"), T=T, meta={"a": 1})
    port_vars = weights.zoo_variables(_port_vgg(variables))
    jp, npzp = deploy.export_lynxi(layers, port_vars, str(tmp_path / "port"), T=T,
                                   meta={"a": 1})
    with open(jp) as f, open(tmp_path / "jax.lynxi.json") as g:
        assert json.load(f) == json.load(g)
    with np.load(npzp) as a, np.load(tmp_path / "jax.lynxi.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _truncated(json_path, n_layers, out):
    """The manifest's first ``n_layers`` layers, then Flatten: its
    output is the activations after them."""
    with open(json_path) as f:
        manifest = json.load(f)
    manifest["layers"] = manifest["layers"][:n_layers] + [{"type": "Flatten", "attrs": {},
                                                          "tensors": {}}]
    with open(out, "w") as f:
        json.dump(manifest, f)
    return out


def test_lynxi_reference_forward_matches_jax(tmp_path, jax_vgg):
    model, variables = jax_vgg
    layers = deploy.lynxi_layers_from_vgg(VGG_CFG, num_classes=CLASSES)
    json_path, npz_path = jax_deploy.export_lynxi(layers, variables, str(tmp_path / "vgg"),
                                                  T=T)
    x = np.random.RandomState(5).rand(T * N, HW, HW, C).astype(np.float32)
    want = jax_deploy.lynxi_reference_forward(json_path, npz_path, x)
    got = deploy.lynxi_reference_forward(json_path, npz_path, x, device="cpu")
    assert got.shape == (T * N, CLASSES) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_ATOL, rtol=0)

    # every LIF node's spikes exact: the manifest cut after each
    lifs = [i for i, e in enumerate(layers) if e["type"] == "LIFNode"]
    for i in lifs:
        cut = _truncated(json_path, i + 1, str(tmp_path / f"cut{i}.json"))
        s_port = deploy.lynxi_reference_forward(cut, npz_path, x, device="cpu").numpy()
        s_jax = jax_deploy.lynxi_reference_forward(cut, npz_path, x)
        assert 0.0 < s_port.mean() < 1.0
        np.testing.assert_array_equal(s_port, s_jax)

    # the rate decode of the export is the port's framework model's logits
    vgg = _port_vgg(variables).eval()
    with torch.no_grad():
        fw = vgg(torch.from_numpy(x.reshape(T, N, HW, HW, C)))
    np.testing.assert_allclose(got.reshape(T, N, CLASSES).mean(0).numpy(), fw.numpy(),
                               atol=LOGIT_ATOL, rtol=0)


def test_lynxi_rejections_kept(tmp_path):
    with pytest.raises(ValueError, match="not Lynxi-supported"):
        deploy.export_lynxi([{"type": "Dropout", "attrs": {}}], {"params": {}},
                            str(tmp_path / "x"), T=2)
    five_d = np.zeros((1, 1, 1, 1, 2), np.float32)
    bn = {"type": "BatchNorm2d", "attrs": {"num_features": 2, "eps": 1e-5}, "params": "bn"}
    with pytest.raises(ValueError, match="exceeds the Lynxi 4-D limit"):
        deploy.export_lynxi([bn], {"params": {"bn": {"scale": five_d, "bias": five_d}},
                                   "batch_stats": {"bn": {"mean": five_d, "var": five_d}}},
                            str(tmp_path / "x"), T=2)
    with pytest.raises(ValueError, match="hard reset"):
        deploy.lynxi_layers_from_vgg((4,), 2, NeuronParams(hard_reset=False))
