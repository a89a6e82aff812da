"""The PyTorch port stands alone and runs on the card unless told otherwise.

* Importing every module of ``spiking_diffusion_tpu_torch`` and
  ``chip_smoke.py`` loads neither ``jax`` nor any module of the JAX
  package ``spiking_diffusion_tpu``.
* The entry points' device defaults to ``"cuda"`` (the sampler's, the
  fused sampler's, the stage-1 and stage-2 trainers',
  ``extract_code_indices``'s, the CLI's ``main``, the LeNet feature
  space's, the baselines' loaders, InceptionV3's, clean-fid's and the
  freeze's too): with no card they raise instead of running on the CPU.
* ``chip_smoke.py`` exits non-zero, without its result line, when there is
  no CUDA device or when it stands alone without the port.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from spiking_diffusion_tpu_torch import cli, generate
from spiking_diffusion_tpu_torch.config import DiffusionConfig, SNNVAEConfig, VQVAEConfig
from spiking_diffusion_tpu_torch.metrics import cleanfid, features, frozen, inception
from spiking_diffusion_tpu_torch.models import diffusion, weights
from spiking_diffusion_tpu_torch.train import stage1, stage2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

IMPORT_ALL = """
import importlib, pkgutil, sys
import spiking_diffusion_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
for name in ("cli", "metrics.features", "metrics.frozen", "metrics.mode_coverage",
             "metrics.scores", "metrics.ssim", "utils.grids", "profiling.syops",
             "profiling.timing", "profiling.monitor", "models.ann_vqvae", "models.snn_vae",
             "metrics.inception", "metrics.cleanfid"):
    assert pkg.__name__ + "." + name in names, name
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.") or k == "spiking_diffusion_tpu"
             or k.startswith("spiking_diffusion_tpu."))
print(len(names), "modules;", "leaked:", bad)
sys.exit(1 if bad else 0)
"""


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _run(args, cwd, **env):
    full_env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    full_env.update(env)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=full_env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_no_jax():
    out = _run(["-c", IMPORT_ALL], REPO)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "leaked: []" in out.stdout
    assert int(out.stdout.split()[0]) >= 25  # every module was imported


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dcfg = DiffusionConfig(denoiser_channels=(4, 4, 4, 4, 4), num_steps=2)
    vcfg = VQVAEConfig(dec_channels=(4, 4), num_steps=2)
    gen = torch.Generator().manual_seed(0)
    dvars = weights.init_denoiser_variables(dcfg, gen)
    vvars = weights.init_vqvae_variables(vcfg, gen)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        weights.load_denoiser(*dvars, dcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        weights.load_vqvae(*vvars, vcfg)
    den = weights.load_denoiser(*dvars, dcfg, device="cpu")
    vq = weights.load_vqvae(*vvars, vcfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate.sample_codes(den, dcfg, 2, generator=gen)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate.generate(den, vq, dcfg, 2, generator=gen)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate.sample_codes(den, dcfg, 2, generator=gen, fused=True,
                              dtype=torch.int8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        diffusion.sample(den, dcfg, 2, noise=[])
    for backend in ("auto", "bnlif"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            weights.load_denoiser(*dvars, dcfg, lif_backend=backend, train=True)
    codes = torch.zeros((4, 7, 7), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stage2.train_diffusion(den, dcfg, codes, batch_size=2, log_fn=None)
    for backend in ("auto", "bnlif"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            weights.load_vqvae(*vvars, vcfg, lif_backend=backend, train=True)
    images = np.zeros((4, 28, 28, 1), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stage1.train_vqvae(vq, images, 0.1, batch_size=2, log_fn=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stage1.extract_code_indices(vq, images)


def test_cli_and_metrics_default_to_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dirs = ["--result_dir", str(tmp_path / "r"), "--sample_dir", str(tmp_path / "s")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(dirs)
    model, _, _ = frozen.load_frozen_lenet("MNIST")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        features.lenet_feature_fn(model)
    images = np.zeros((4, 28, 28, 1), np.float32)
    labels = np.zeros((4,), np.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        features.train_lenet(images, labels, 10, epochs=1)
    for mode in ("auto", "off"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            frozen.get_feature_space("MNIST", images, labels, 10, mode=mode, log_fn=None)


def test_baselines_and_metrics_default_to_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    vcfg, cfg = VQVAEConfig(num_steps=2), SNNVAEConfig(num_steps=2)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        weights.load_ann_vqvae(weights.init_ann_vqvae_variables(vcfg, gen), vcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        weights.load_snn_vae(*weights.init_snn_vae_variables(cfg, vcfg, gen), cfg, vcfg)
    model = inception.InceptionV3(num_classes=10)
    images = np.zeros((2, 28, 28, 1), np.float32)
    for call in (lambda: inception.inception_feature_fn(model),
                 lambda: inception.resize_for_inception(images),
                 lambda: inception.load_converted_weights({}),
                 lambda: cleanfid.clean_resize(images),
                 lambda: cleanfid.make_clean_feature_fn(model),
                 lambda: frozen.freeze_feature_space("MNIST", images, np.zeros(2, np.int32),
                                                     images, 10, root=str(tmp_path),
                                                     log_fn=None)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_chip_smoke_fails_without_card():
    out = _run(["chip_smoke.py"], REPO, CUDA_VISIBLE_DEVICES="")
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run(["chip_smoke.py"], str(tmp_path))
    assert out.returncode != 0
    assert "spiking_diffusion_tpu_torch" in out.stderr
    assert '"ok": true' not in out.stdout
