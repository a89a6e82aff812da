"""Export the committed checkpoints for the PyTorch port.

Reads the JAX package's orbax trees, converts them with the port's
``models/weights.py`` and writes them with the port's
``train/checkpoint.save_checkpoint`` in the port CLI's own layout:

    <orbax run>/{model, diff_result/diff_model}
        -> result_torch/<dataset>/<model>/{model.pt, diff_result/diff_model.pt}

for each run of ``EXPORTS``: the spiking VQ-VAE (``snn-vq-vae``) of every
dataset the CLI offers (MNIST's 60 + 120 epoch flagship ``result_r5_e60``,
FMNIST's 60 + 120 ``result_r5_f60``, the 30 + 60 epoch round-3 runs of
CIFAR10, CIFAR10-BW, KMNIST and Letters) and the paper's two MNIST
baselines of ``result_r3`` (``vq-vae``, the ANN VQ-VAE and its denoiser;
``snn-vae``, stage 1 alone). So ``python -m spiking_diffusion_tpu_torch.cli
--dataset_name <dataset> --model <model> --checkpoint
result_torch/<dataset>/<model>`` evaluates each trained run. The stage-1
config takes ``in_channels`` from the tree's first conv (3 for CIFAR10),
the rest from ``VQVAEConfig()``, ``DiffusionConfig()`` and
``SNNVAEConfig()``. Each file holds the orbax step, the model's state dict
(parameters and BN running statistics, fp32) and a fresh AdamW state:
Adam's moments are not carried over, since the CLI restores a checkpoint
only to skip training.

Needs JAX and orbax (the JAX package reads the trees); run from the repo
root, for every run of ``EXPORTS`` or the ones named:

    python scripts/export_torch_weights.py [CIFAR10/snn-vq-vae ...]

Any other orbax run of the JAX CLI (its last directory names the model),
into a directory of your choice:

    python scripts/export_torch_weights.py --source result_r5_s44/Letters/snn-vq-vae \\
        --target <dir>
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import orbax.checkpoint as ocp  # noqa: E402

from spiking_diffusion_tpu.train.checkpoint import load_variables  # noqa: E402
from spiking_diffusion_tpu_torch.config import (  # noqa: E402
    DiffusionConfig,
    SNNVAEConfig,
    VQVAEConfig,
)
from spiking_diffusion_tpu_torch.models import weights  # noqa: E402
from spiking_diffusion_tpu_torch.train.checkpoint import save_checkpoint  # noqa: E402
from spiking_diffusion_tpu_torch.train.state import create_train_state  # noqa: E402

# the committed exports: the port's run under result_torch/ -> the orbax run
EXPORTS = {
    "MNIST/snn-vq-vae": "result_r5_e60/MNIST/snn-vq-vae",
    "CIFAR10/snn-vq-vae": "result_r3/CIFAR10/snn-vq-vae",
    "CIFAR10-BW/snn-vq-vae": "result_r3/CIFAR10-BW/snn-vq-vae",
    "FMNIST/snn-vq-vae": "result_r5_f60/FMNIST/snn-vq-vae",
    "KMNIST/snn-vq-vae": "result_r3/KMNIST/snn-vq-vae",
    "Letters/snn-vq-vae": "result_r3/Letters/snn-vq-vae",
    "MNIST/vq-vae": "result_r3/MNIST/vq-vae",
    "MNIST/snn-vae": "result_r3/MNIST/snn-vae",
}
# (orbax subdirectory, name): stage 1 beside, stage 2 under diff_result/
TREES = (("", "model"), ("diff_result", "diff_model"))


def source_of(run: str) -> str:
    """The orbax run of a committed export, as an absolute path."""
    return os.path.join(REPO, EXPORTS[run])


def target_of(run: str) -> str:
    """Where a committed export lives."""
    return os.path.join(REPO, "result_torch", run)


def trees_of(model: str) -> tuple:
    """The trees of a ``model``'s run: the SNN-VAE has no stage 2."""
    return TREES[:1] if model == "snn-vae" else TREES


def orbax_step(ckpt_dir: str, name: str) -> int:
    """The train step stored in an orbax tree."""
    tree = ocp.StandardCheckpointer().restore(os.path.join(os.path.abspath(ckpt_dir), name))
    return int(tree["step"])


def _module(model: str, name: str, params, stats):
    """The port's module of ``model``'s tree ``name`` on the CPU."""
    if name == "diff_model":
        return weights.load_denoiser(params, stats, DiffusionConfig(), device="cpu")
    if model == "vq-vae":
        return weights.load_ann_vqvae(params, VQVAEConfig(), device="cpu")
    if model == "snn-vae":
        return weights.load_snn_vae(params, stats, SNNVAEConfig(), VQVAEConfig(), device="cpu")
    in_channels = int(params["encoder"]["SeqConv_0"]["Conv_0"]["kernel"].shape[2])
    return weights.load_vqvae(params, stats, VQVAEConfig(in_channels=in_channels), device="cpu")


def convert(source: str, model: str = None):
    """{name: train state} of the port on the CPU, from the orbax trees of
    the run ``source`` (``model`` by default its last directory): the
    converted model in training mode, a fresh AdamW, the orbax step."""
    model = model or os.path.basename(os.path.normpath(source))
    states = {}
    for sub, name in trees_of(model):
        ckpt_dir = os.path.join(source, sub)
        params, stats = load_variables(ckpt_dir, name)
        state = create_train_state(_module(model, name, params, stats))
        state.step = orbax_step(ckpt_dir, name)
        states[name] = state
    return states


def export(source: str, target: str) -> None:
    """Convert the orbax run ``source`` and write it under ``target``."""
    model = os.path.basename(os.path.normpath(source))
    for (sub, name), state in zip(trees_of(model), convert(source, model).values()):
        path = save_checkpoint(state, os.path.join(target, sub), name)
        print(f"{source} {name}: step {state.step} -> {path} "
              f"({os.path.getsize(path)} bytes)")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("runs", nargs="*",
                   help=f"committed exports to write, of {', '.join(EXPORTS)} (default: all)")
    p.add_argument("--source", help="any other orbax run of the JAX CLI")
    p.add_argument("--target", help="where --source's export goes")
    args = p.parse_args(argv)
    if args.source:
        if args.runs or not args.target:
            p.error("--source takes --target and no run names")
        export(os.path.abspath(args.source), os.path.abspath(args.target))
        return
    unknown = sorted(set(args.runs) - set(EXPORTS))
    if unknown:
        p.error(f"no committed export named {', '.join(unknown)}")
    for run in args.runs or EXPORTS:
        export(source_of(run), target_of(run))


if __name__ == "__main__":
    main()
