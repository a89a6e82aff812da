"""The PyTorch port stands alone and runs on the card unless told otherwise.

* Importing every module of ``spiking_diffusion_tpu_torch`` and
  ``chip_smoke.py`` loads neither ``jax`` nor any module of the JAX
  package ``spiking_diffusion_tpu``.
* The entry points' device defaults to ``"cuda"`` (the sampler's, the
  fused sampler's, the stage-1 and stage-2 trainers',
  ``extract_code_indices``'s, the CLI's ``main``, the LeNet feature
  space's, the baselines' loaders, InceptionV3's, clean-fid's, the
  freeze's, the classifier zoo's loader and trainer, the server's
  ``Generator``, ``lynxi_reference_forward`` and the ``--device`` of the
  four ``examples/*_torch.py`` scripts too): with no card they raise
  instead of running on the CPU.
  So do ``parallel.make_mesh``, ``parallel.make_mesh_2d`` and
  ``parallel.launch``: a rank runs on the card unless the CPU is named (the
  DP trainers and sampler on a rank: tests/test_torch_parallel.py; the TP
  step builders: tests/test_torch_tensor_parallel.py).
* The ``examples/*_torch.py`` scripts load neither either (the four of
  serving and export, and the thirteen of the data and tools path, each of
  whose ``main`` runs on the card unless ``--device cpu`` is passed), and
  ``models/lava_export``, ``data/neuromorphic``, ``utils/visualizing`` and
  every example import without ``h5py`` and ``matplotlib`` (the card's
  machine has neither).
* ``chip_smoke.py`` exits non-zero, without its result line, when there is
  no CUDA device or when it stands alone without the port.
"""

import importlib.util
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from spiking_diffusion_tpu_torch import cli, generate, parallel
from spiking_diffusion_tpu_torch.config import DiffusionConfig, SNNVAEConfig, VQVAEConfig
from spiking_diffusion_tpu_torch.metrics import cleanfid, features, frozen, inception
from spiking_diffusion_tpu_torch.models import deploy, diffusion, weights, zoo
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
             "metrics.inception", "metrics.cleanfid", "data.extra_datasets",
             "parallel.mesh", "parallel.launch", "parallel.tp", "snn.surrogate",
             "snn.neuron", "snn.encoding", "snn.functional", "snn.temporal",
             "snn.quantize", "snn.rnn", "snn.learning", "snn.fptt", "snn.tempotron",
             "models.zoo", "models.ann2snn", "models.recurrent", "models.attention",
             "models.dropconnect", "models.deploy", "models.lava_export", "ops.bitpack",
             "native", "data.events", "data.neuromorphic", "data.transforms", "data.audio",
             "utils.visualizing"):
    assert pkg.__name__ + "." + name in names, name
import importlib.util
for name in EXAMPLES:
    spec = importlib.util.spec_from_file_location(name, "examples/" + name + ".py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.") or k == "spiking_diffusion_tpu"
             or k.startswith("spiking_diffusion_tpu."))
print(len(names), "modules;", "leaked:", bad)
sys.exit(1 if bad else 0)
"""


EXAMPLES = ("serve_torch", "generate_torch", "deploy_netx_torch", "lynxi_infer_torch")
# the data and tools path: each runs on the card unless --device cpu
DATA_EXAMPLES = ("dvs_classify_torch", "classify_mnist_torch", "speechcommands_kws_torch",
                 "ann2snn_cnn_mnist_torch", "tempotron_mnist_torch", "stdp_trace_torch",
                 "fptt_online_torch", "rsnn_sequential_fmnist_torch",
                 "spiking_lstm_mnist_torch", "spiking_lstm_text_torch",
                 "rl_cartpole_dqn_torch", "rl_cartpole_a2c_torch", "rl_cartpole_ppo_torch")
NO_H5PY = """
import sys
sys.modules["h5py"] = None  # importing it raises
sys.modules["matplotlib"] = None
from spiking_diffusion_tpu_torch.models import lava_export
try:
    lava_export.export_netx_hdf5("never.net", [])
except ImportError:
    print("needs h5py only to write")
from spiking_diffusion_tpu_torch.data import neuromorphic
from spiking_diffusion_tpu_torch.utils import visualizing
try:
    neuromorphic.SpikingHeidelbergDigits("never")
except ImportError:
    print("SHD needs h5py only to read")
try:
    visualizing.plot_1d_spikes([[0.0]])
except ImportError:
    print("plots need matplotlib only to draw")
import importlib.util
for name in EXAMPLES:
    spec = importlib.util.spec_from_file_location(name, "examples/" + name + ".py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print("examples import")
"""


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_isolation", os.path.join(REPO, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _run(args, cwd, **env):
    full_env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    full_env.update(env)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=full_env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_no_jax():
    out = _run(["-c", f"EXAMPLES = {EXAMPLES + DATA_EXAMPLES!r}\n" + IMPORT_ALL], REPO)
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


def _rank_of_cuda_world():
    """A rank of ``parallel.launch``'s default device (never reached
    without a card)."""
    return parallel.make_mesh(2)


def test_parallel_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")  # the spawned ranks' view too
    for n in (None, 1):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            parallel.make_mesh(n)
    with pytest.raises(Exception, match="no CUDA device"):
        parallel.launch(_rank_of_cuda_world, 2)


def test_tensor_parallel_defaults_to_cuda(monkeypatch):
    """``make_mesh_2d`` without a device raises on a process with no card,
    as ``make_mesh`` does, and so do the TP step builders, the SNN-VAE's
    included (on a rank: tests/test_torch_tensor_parallel.py)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.make_mesh_2d(1, 1)
    mesh = parallel.make_mesh_2d(1, 1, device="cpu")
    assert (mesh.dp, mesh.tp, mesh.world.world_size, str(mesh.device)) == (1, 1, 1, "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stage2.make_train_step_diffusion_tp(DiffusionConfig(), mesh)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.make_train_step_snn_vae_tp(mesh)


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


def test_zoo_defaults_to_cuda(monkeypatch):
    """The classifier zoo's trainer and loader run on the card unless the
    CPU is named."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = dict(cfg=(4, "M"), num_classes=10, input_shape=(4, 4, 1))
    variables = weights.init_zoo_variables("vgg", torch.Generator().manual_seed(0), **kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        weights.load_zoo_model("vgg", *variables, **kw)
    model = weights.load_zoo_model("vgg", *variables, device="cpu", **kw)
    images = np.zeros((4, 4, 4, 1), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        zoo.train_classifier(model, images, np.zeros((4,), np.int32), batch_size=2)


def test_lava_export_imports_without_h5py():
    """Without h5py and matplotlib (the card's machine has neither) the
    port and every example import; only writing netx, reading SHD / SSC
    and drawing a plot need them."""
    out = _run(["-c", f"EXAMPLES = {EXAMPLES + DATA_EXAMPLES!r}\n" + NO_H5PY], REPO)
    assert out.returncode == 0, out.stdout + out.stderr
    for line in ("needs h5py only to write", "SHD needs h5py only to read",
                 "plots need matplotlib only to draw", "examples import"):
        assert line in out.stdout


@pytest.mark.parametrize("name", DATA_EXAMPLES)
def test_data_examples_default_to_cuda(name, monkeypatch):
    """Each example of the data and tools path runs on the card unless
    ``--device cpu`` is passed: with no card its ``main`` raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example(name).main([])



def test_serving_and_export_default_to_cuda(monkeypatch, tmp_path):
    """The server's Generator, the Lynxi executor and the four scripts run
    on the card unless the CPU is named."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    serve = _example("serve_torch")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.Generator(str(tmp_path), 4, 2, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deploy.lynxi_reference_forward("never.json", "never.npz", np.zeros((1, 4, 4, 1)))
    ckpt = ["--checkpoint", str(tmp_path)]
    for name, argv in (("serve_torch", ckpt + ["--bench", "1"]), ("generate_torch", ckpt),
                       ("deploy_netx_torch", ckpt), ("lynxi_infer_torch", [])):
        monkeypatch.setattr(sys, "argv", [name] + argv)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _example(name).main()


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
