"""The port's command-line interface against the JAX package's.

* The parser: every flag of ``spiking_diffusion_tpu.cli.parse_args`` with
  the same option strings, default, choices, type and action, and no
  other flag.
* The choices the port does not run raise.
* ``--syops`` prints ``format_report`` of ``profile_apply`` on the trained
  stage-1 model and the first ``--batch_size`` test images, and JAX's
  three summary lines.
* A tiny two-stage run on the CPU (the denoiser narrowed to 8-16 channels
  by monkeypatching the CLI's ``DiffusionConfig``, T = 2, K = 8) writes
  the JAX CLI's artifact tree, ``.pt`` files in place of the orbax
  directories, and a ``metrics.json`` with the keys of the JAX record.
* ``--checkpoint result_torch/MNIST/snn-vq-vae`` on the CPU in fp32, at
  full width: the recon MSE and 1 - SSIM equal the same loop run with the
  JAX package's ``SNNVQVAE`` and ``metrics.ssim`` on the orbax tree,
  within 1e-5.
* ``train_diffusion``'s ``epoch_callback`` runs once per epoch with the
  state; ``data_parallel > 1`` raises.
"""

import argparse
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spiking_diffusion_tpu import cli as jax_cli
from spiking_diffusion_tpu.config import VQVAEConfig as JaxVQVAEConfig
from spiking_diffusion_tpu.data import batch_iterator as jax_batch_iterator
from spiking_diffusion_tpu.data import synthetic_dataset as jax_synthetic_dataset
from spiking_diffusion_tpu.metrics import ssim as jax_ssim
from spiking_diffusion_tpu.models.vqvae import SNNVQVAE as JaxSNNVQVAE
from spiking_diffusion_tpu.train.checkpoint import load_variables
from spiking_diffusion_tpu_torch import cli
from spiking_diffusion_tpu_torch.config import DiffusionConfig, VQVAEConfig
from spiking_diffusion_tpu_torch.data import synthetic_dataset
from spiking_diffusion_tpu_torch.models import weights
from spiking_diffusion_tpu_torch.profiling import syops
from spiking_diffusion_tpu_torch.train import stage2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPORTED = os.path.join(REPO, "result_torch", "MNIST", "snn-vq-vae")
ORBAX = os.path.join(REPO, "result_r5_e60", "MNIST", "snn-vq-vae")
RECORD = os.path.join(REPO, "sample_r5_e60", "MNIST", "snn-vq-vae", "metrics.json")
RECON_ATOL = 1e-5
TINY_CHANNELS = (8, 16, 16, 16, 8)
TINY_FLAGS = ["--epochs", "1", "--num_steps", "2", "--codebook_size", "8",
              "--batch_size", "16", "--synthetic_train", "128", "--synthetic_test", "64",
              "--sample_batches", "2", "--grid_batches", "1", "--temperatures", "0.5,1.0",
              "--frozen_metrics", "on"]
CKPT_FLAGS = ["--checkpoint", EXPORTED, "--sample_steps", "1", "--sample_batches", "1",
              "--temperatures", "1.0", "--synthetic_train", "64", "--synthetic_test", "64"]


def _actions(parser: argparse.ArgumentParser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def _parser(module):
    captured = {}
    real = argparse.ArgumentParser.parse_args

    def capture(self, argv=None, namespace=None):
        captured["parser"] = self
        return real(self, argv, namespace)

    argparse.ArgumentParser.parse_args = capture
    try:
        module.parse_args([])
    finally:
        argparse.ArgumentParser.parse_args = real
    return captured["parser"]


JAX_FLAGS = sorted(_actions(_parser(jax_cli)))


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _dirs(tmp_path):
    return ["--result_dir", str(tmp_path / "result"), "--sample_dir", str(tmp_path / "sample")]


def test_parser_has_the_same_flags():
    assert sorted(_actions(_parser(cli))) == JAX_FLAGS


@pytest.mark.parametrize("dest", JAX_FLAGS)
def test_parser_flag_equals_jax(dest):
    ours, theirs = _actions(_parser(cli))[dest], _actions(_parser(jax_cli))[dest]
    assert ours.option_strings == theirs.option_strings
    assert ours.default == theirs.default
    assert ours.choices == theirs.choices
    assert ours.type == theirs.type
    assert type(ours) is type(theirs)
    assert vars(cli.parse_args([]))[dest] == vars(jax_cli.parse_args([]))[dest]


@pytest.mark.parametrize("flags,error", [
    (["--model", "snn-vae"], NotImplementedError),
    (["--model", "vq-vae"], NotImplementedError),
    (["--data_parallel", "2"], NotImplementedError),
    (["--dataset_name", "CIFAR10"], ValueError),
    (["--dataset_name", "CIFAR10-BW"], ValueError),
])
def test_refusals_raise(tmp_path, flags, error):
    with pytest.raises(error):
        cli.main(flags + _dirs(tmp_path), device="cpu")


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_tiny_run_writes_the_jax_artifact_tree(tmp_path, monkeypatch):
    monkeypatch.setattr(cli, "DiffusionConfig",
                        functools.partial(DiffusionConfig, denoiser_channels=TINY_CHANNELS))
    out = cli.main(TINY_FLAGS + _dirs(tmp_path), device="cpu")
    res = tmp_path / "result" / "MNIST" / "snn-vq-vae"
    assert _tree(res) == ["diff_result/diff_model.pt", "diff_result/epoch=0_test.png",
                          "epoch=0_test.png", "model.pt"]
    smp = tmp_path / "sample" / "MNIST" / "snn-vq-vae"
    tree = _tree(smp)
    assert {"0.5/image_0.5_0.png", "1.0/image_1.0_0.png", "metrics.json",
            "paper_image.png"} <= set(tree)
    classes = [p for p in tree if p.startswith("classes/")]
    assert classes and all(p.startswith("classes/class_") for p in classes)
    assert len(tree) == 4 + len(classes)
    metrics = json.load(open(smp / "metrics.json"))
    record = json.load(open(RECORD))
    assert set(metrics) == {"0.5", "1.0", "null_FID", "feature_space"}
    for temp in ("0.5", "1.0"):
        assert set(metrics[temp]) == set(record["0.8"])
        assert all(np.isfinite(v) for v in metrics[temp].values())
    assert set(metrics["feature_space"]) == set(record["feature_space"])
    assert metrics["feature_space"]["frozen"] and metrics["feature_space"]["sha256"] == \
        record["feature_space"]["sha256"]
    assert out["metrics"]["null_FID"] == metrics["null_FID"]
    assert np.isfinite(out["recon_mse"]) and 0.0 <= out["recon_ssim_loss"] <= 2.0
    assert set(out["seconds"]) == {"stage1", "codes", "stage2", "recon", "generation"}


def test_syops_prints_the_report(tmp_path, monkeypatch, capsys):
    """``--syops`` prints the report of the trained stage-1 model on the
    first ``--batch_size`` test images, and the three summary lines."""
    monkeypatch.setattr(cli, "DiffusionConfig",
                        functools.partial(DiffusionConfig, denoiser_channels=TINY_CHANNELS))
    flags = TINY_FLAGS + ["--syops"]
    cli.main(flags + _dirs(tmp_path), device="cpu")
    printed = capsys.readouterr().out
    args = cli.parse_args(flags)
    vq_cfg = VQVAEConfig(num_steps=args.num_steps, num_embeddings=args.codebook_size)
    model = weights.load_vqvae(*weights.init_vqvae_variables(vq_cfg, torch.Generator()),
                               vq_cfg, device="cpu")
    saved = torch.load(tmp_path / "result" / "MNIST" / "snn-vq-vae" / "model.pt",
                       weights_only=True)
    model.load_state_dict(saved["model"])
    ds = synthetic_dataset("MNIST", args.synthetic_train, args.synthetic_test)
    images = torch.from_numpy(ds.test_images[:args.batch_size] - 0.5)
    _, per_layer, total = syops.profile_apply(model, images, train=False)
    n_params = syops.count_params(model)
    report = syops.format_report(per_layer, total, n_params)
    assert report in printed and len(report.splitlines()) == 19 + 4
    assert "\n".join([
        "{:<30}  {:.3e}".format("Computational complexity ACs:", total["acs"]),
        "{:<30}  {:.3e}".format("Computational complexity MACs:", total["macs"]),
        "{:<30}  {:,}".format("Number of parameters: ", n_params)]) in printed


def test_checkpoint_recon_equals_jax(tmp_path):
    out = cli.main(CKPT_FLAGS + _dirs(tmp_path), device="cpu")
    ds = jax_synthetic_dataset("MNIST", n_train=64, n_test=64)
    params, stats = load_variables(ORBAX, "model")
    model = JaxSNNVQVAE(JaxVQVAEConfig(), backend="scan")
    fwd = jax.jit(lambda v, x: model.apply(v, x, train=False))
    mses, ssims = [], []
    for batch in jax_batch_iterator(ds.test_images, 32, shuffle=False):
        x = jnp.asarray(batch - 0.5)
        recon = fwd({"params": params, "batch_stats": stats}, x)["recon"]
        mses.append(float(jnp.mean((recon - x) ** 2)))
        ssims.append(1.0 - float(jax_ssim(recon, x)))
    assert abs(out["recon_mse"] - float(np.mean(mses))) <= RECON_ATOL
    assert abs(out["recon_ssim_loss"] - float(np.mean(ssims))) <= RECON_ATOL
    assert out["recon_mse"] < 0.01  # the trained model reconstructs
    metrics = out["metrics"]
    assert metrics["feature_space"]["frozen"] and set(metrics) == {1.0, "null_FID",
                                                                   "feature_space"}


def test_train_diffusion_epoch_callback():
    cfg = DiffusionConfig(denoiser_channels=(4, 4, 4, 4, 4), num_steps=2, num_embeddings=8,
                          mask_id=8)
    den = weights.load_denoiser(*weights.init_denoiser_variables(
        cfg, torch.Generator().manual_seed(0)), cfg, device="cpu", train=True)
    codes = np.random.RandomState(0).randint(0, 8, (16, 7, 7)).astype(np.int32)
    calls = []
    state = stage2.train_diffusion(den, cfg, codes, epochs=3, batch_size=8, log_fn=None,
                                   epoch_callback=lambda e, st: calls.append((e, st, st.step)),
                                   device="cpu")
    assert [(e, s) for e, _, s in calls] == [(0, 2), (1, 4), (2, 6)]
    assert all(st is state for _, st, _ in calls)
    with pytest.raises(NotImplementedError):
        stage2.train_diffusion(den, cfg, codes, batch_size=8, data_parallel=2, device="cpu")
