"""The committed trained weights of the port (``result_torch/``) against a
live conversion of the JAX package's orbax trees: the flagship
(``result_r5_e60``) and the two baselines of ``result_r3`` (``vq-vae``,
the ANN VQ-VAE and its denoiser; ``snn-vae``).

``scripts/export_torch_weights.py`` wrote them; here the same conversion
runs again and every tensor of the committed files must equal it. The
files load with ``weights_only=True`` into the full-width modules with
``strict=True``, carry the orbax step, and restore into a train state
through the port's ``restore_checkpoint``. The baselines' stage-1 models
on 4 synthetic test images equal the JAX package's on the orbax trees:
the ANN VQ-VAE's codes exactly and recon within 1e-5, the SNN-VAE's
eval forward (JAX's channel draws) z exactly and recon within 1e-5.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from spiking_diffusion_tpu.config import SNNVAEConfig as JaxSNNVAEConfig
from spiking_diffusion_tpu.config import VQVAEConfig as JaxVQVAEConfig
from spiking_diffusion_tpu.models.ann_vqvae import ANNVQVAE as JaxANNVQVAE
from spiking_diffusion_tpu.models.snn_vae import SNNVAE as JaxSNNVAE
from spiking_diffusion_tpu.train.checkpoint import load_variables
from spiking_diffusion_tpu_torch.config import DiffusionConfig, SNNVAEConfig, VQVAEConfig
from spiking_diffusion_tpu_torch.data import synthetic_dataset
from spiking_diffusion_tpu_torch.models.ann_vqvae import ANNVQVAE
from spiking_diffusion_tpu_torch.models.denoiser import SpikingDenoiser
from spiking_diffusion_tpu_torch.models.snn_vae import SNNVAE
from spiking_diffusion_tpu_torch.models.vqvae import SNNVQVAE
from spiking_diffusion_tpu_torch.train.checkpoint import checkpoint_path, restore_checkpoint
from spiking_diffusion_tpu_torch.train.state import create_train_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORBAX = os.path.join(REPO, "result_r5_e60", "MNIST", "snn-vq-vae")
EXPORTED = os.path.join(REPO, "result_torch", "MNIST", "snn-vq-vae")
# name -> (subdirectory, the full-width module)
FILES = {"model": ("", lambda: SNNVQVAE(VQVAEConfig())),
         "diff_model": ("diff_result", lambda: SpikingDenoiser(DiffusionConfig()))}
# the baselines: (model, tree) -> (subdirectory, the full-width module)
BASELINES = {
    ("vq-vae", "model"): ("", lambda: ANNVQVAE(VQVAEConfig())),
    ("vq-vae", "diff_model"): ("diff_result", lambda: SpikingDenoiser(DiffusionConfig())),
    ("snn-vae", "model"): ("", lambda: SNNVAE(SNNVAEConfig(), VQVAEConfig())),
}
BASELINE_IDS = [f"{m}-{n}" for m, n in BASELINES]
IMAGES = 4
ATOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def live():
    spec = importlib.util.spec_from_file_location(
        "export_torch_weights", os.path.join(REPO, "scripts", "export_torch_weights.py"))
    export = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(export)
    return export.convert(ORBAX)


def _committed(name):
    sub, _ = FILES[name]
    return torch.load(checkpoint_path(os.path.join(EXPORTED, sub), name), map_location="cpu",
                      weights_only=True)


@pytest.mark.parametrize("name", sorted(FILES))
def test_committed_equal_live_conversion(live, name):
    ckpt = _committed(name)
    want = live[name].model.state_dict()
    assert sorted(ckpt["model"]) == sorted(want)
    for key, value in want.items():
        got = ckpt["model"][key]
        assert got.dtype == value.dtype == torch.float32, key
        assert torch.equal(got, value), key
    assert ckpt["step"] == live[name].step


@pytest.mark.parametrize("name", sorted(FILES))
def test_step_is_the_orbax_step(name):
    sub, _ = FILES[name]
    tree = ocp.StandardCheckpointer().restore(os.path.join(ORBAX, sub, name))
    assert _committed(name)["step"] == int(tree["step"]) > 0


@pytest.mark.parametrize("name", sorted(FILES))
def test_load_strict_into_full_width_modules(name):
    _, make = FILES[name]
    module = make()
    module.load_state_dict(_committed(name)["model"], strict=True)
    ckpt = _committed(name)
    assert ckpt["optimizer"]["state"] == {}  # a fresh AdamW: no moments carried over
    state = restore_checkpoint(create_train_state(make()),
                               os.path.join(EXPORTED, FILES[name][0]), name)
    assert state.step == ckpt["step"]
    for key, value in module.state_dict().items():
        assert torch.equal(state.model.state_dict()[key], value), key


def _export_module():
    spec = importlib.util.spec_from_file_location(
        "export_torch_weights", os.path.join(REPO, "scripts", "export_torch_weights.py"))
    export = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(export)
    return export


def _baseline_file(model, name):
    sub, _ = BASELINES[(model, name)]
    return torch.load(checkpoint_path(os.path.join(REPO, "result_torch", "MNIST", model, sub),
                                      name), map_location="cpu", weights_only=True)


@pytest.mark.parametrize("model,name", list(BASELINES), ids=BASELINE_IDS)
def test_baseline_committed_equal_live_conversion(model, name):
    export = _export_module()
    source = export.MODELS[model][0]
    live = export.convert(source, model)[name]
    ckpt = _baseline_file(model, name)
    want = live.model.state_dict()
    assert sorted(ckpt["model"]) == sorted(want)
    for key, value in want.items():
        assert ckpt["model"][key].dtype == value.dtype == torch.float32, key
        assert torch.equal(ckpt["model"][key], value), key
    tree = ocp.StandardCheckpointer().restore(os.path.join(source, BASELINES[(model, name)][0],
                                                           name))
    assert ckpt["step"] == live.step == int(tree["step"]) > 0
    module = BASELINES[(model, name)][1]()
    module.load_state_dict(ckpt["model"], strict=True)
    assert ckpt["optimizer"]["state"] == {}


def _test_images():
    return synthetic_dataset("MNIST", 8, IMAGES).test_images[:IMAGES] - 0.5


def test_vq_vae_baseline_equals_jax():
    params, _ = load_variables(os.path.join(REPO, "result_r3", "MNIST", "vq-vae"), "model")
    x = _test_images()
    jmodel = JaxANNVQVAE(JaxVQVAEConfig())
    jout = jax.jit(lambda p, xx: jmodel.apply({"params": p}, xx, train=False))(
        params, jnp.asarray(x))
    port = ANNVQVAE(VQVAEConfig())
    port.load_state_dict(_baseline_file("vq-vae", "model")["model"], strict=True)
    out = port(torch.from_numpy(x), train=False)
    assert len(np.unique(np.asarray(jout["indices"]))) > 4
    np.testing.assert_array_equal(out["indices"].numpy(), np.asarray(jout["indices"]))
    np.testing.assert_allclose(out["recon"].numpy(), np.asarray(jout["recon"]), rtol=0,
                               atol=ATOL)


def test_snn_vae_baseline_equals_jax():
    params, stats = load_variables(os.path.join(REPO, "result_r3", "MNIST", "snn-vae"), "model")
    x = _test_images()
    cfg = SNNVAEConfig()
    jmodel = JaxSNNVAE(JaxSNNVAEConfig(), vq_cfg=JaxVQVAEConfig(), backend="scan")
    key = jax.random.PRNGKey(0)
    jout = jax.jit(lambda v, xx, kk: jmodel.apply(v, xx, kk, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), key)
    k1, _ = jax.random.split(key)
    choice = np.array(jax.random.randint(k1, (cfg.num_steps, IMAGES, cfg.latent_dim), 0,
                                           cfg.k))
    port = SNNVAE(cfg, VQVAEConfig())
    port.load_state_dict(_baseline_file("snn-vae", "model")["model"], strict=True)
    out = port(torch.from_numpy(x), train=False, choice=torch.from_numpy(choice))
    assert 0.01 < float(np.mean(np.asarray(jout["z"]))) < 0.99
    np.testing.assert_array_equal(out["z"].numpy(), np.asarray(jout["z"]))
    np.testing.assert_allclose(out["recon"].numpy(), np.asarray(jout["recon"]), rtol=0,
                               atol=ATOL)
