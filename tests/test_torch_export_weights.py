"""The committed trained weights of the port (``result_torch/``) against a
live conversion of the JAX package's orbax trees (``result_r5_e60``).

``scripts/export_torch_weights.py`` wrote them; here the same conversion
runs again and every tensor of the committed files must equal it. The
files load with ``weights_only=True`` into the full-width modules with
``strict=True``, carry the orbax step, and restore into a train state
through the port's ``restore_checkpoint``.
"""

import importlib.util
import os

import orbax.checkpoint as ocp
import pytest
import torch

from spiking_diffusion_tpu_torch.config import DiffusionConfig, VQVAEConfig
from spiking_diffusion_tpu_torch.models.denoiser import SpikingDenoiser
from spiking_diffusion_tpu_torch.models.vqvae import SNNVQVAE
from spiking_diffusion_tpu_torch.train.checkpoint import checkpoint_path, restore_checkpoint
from spiking_diffusion_tpu_torch.train.state import create_train_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORBAX = os.path.join(REPO, "result_r5_e60", "MNIST", "snn-vq-vae")
EXPORTED = os.path.join(REPO, "result_torch", "MNIST", "snn-vq-vae")
# name -> (subdirectory, the full-width module)
FILES = {"model": ("", lambda: SNNVQVAE(VQVAEConfig())),
         "diff_model": ("diff_result", lambda: SpikingDenoiser(DiffusionConfig()))}


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
