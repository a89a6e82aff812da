"""Export the committed MNIST checkpoints for the PyTorch port.

Reads the JAX package's orbax trees, converts them with the port's
``models/weights.py`` and writes them with the port's
``train/checkpoint.save_checkpoint`` in the port CLI's own layout:

    result_r5_e60/MNIST/snn-vq-vae/{model, diff_result/diff_model}
        -> result_torch/MNIST/snn-vq-vae/{model.pt, diff_result/diff_model.pt}
           (the 60 + 120 epoch flagship, ``VQVAEConfig()`` / ``DiffusionConfig()``)
    result_r3/MNIST/vq-vae/{model, diff_result/diff_model}
        -> result_torch/MNIST/vq-vae/{model.pt, diff_result/diff_model.pt}
           (the ANN VQ-VAE baseline, 30 + 60 epochs)
    result_r3/MNIST/snn-vae/model
        -> result_torch/MNIST/snn-vae/model.pt
           (the SNN-VAE baseline, 30 epochs, ``SNNVAEConfig()``)

so ``python -m spiking_diffusion_tpu_torch.cli --model <model>
--checkpoint result_torch/MNIST/<model>`` evaluates each trained run.
Each file holds the orbax step, the model's state dict (parameters and BN
running statistics, fp32) and a fresh AdamW state: Adam's moments are not
carried over, since the CLI restores a checkpoint only to skip training.

Needs JAX and orbax (the JAX package reads the trees); run from the repo
root (every model, or the ones named):

    python scripts/export_torch_weights.py [snn-vq-vae] [vq-vae] [snn-vae]
"""

from __future__ import annotations

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

SOURCE = os.path.join(REPO, "result_r5_e60", "MNIST", "snn-vq-vae")
TARGET = os.path.join(REPO, "result_torch", "MNIST", "snn-vq-vae")
# (orbax subdirectory, name): stage 1 beside, stage 2 under diff_result/
TREES = (("", "model"), ("diff_result", "diff_model"))
# model -> (orbax run, the port's run, its trees)
MODELS = {
    "snn-vq-vae": (SOURCE, TARGET, TREES),
    "vq-vae": (os.path.join(REPO, "result_r3", "MNIST", "vq-vae"),
               os.path.join(REPO, "result_torch", "MNIST", "vq-vae"), TREES),
    "snn-vae": (os.path.join(REPO, "result_r3", "MNIST", "snn-vae"),
                os.path.join(REPO, "result_torch", "MNIST", "snn-vae"), TREES[:1]),
}


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
    return weights.load_vqvae(params, stats, VQVAEConfig(), device="cpu")


def convert(source: str = SOURCE, model: str = "snn-vq-vae"):
    """{name: train state} of the port on the CPU, from ``model``'s orbax
    trees under ``source``: the converted model in training mode, a fresh
    AdamW, the orbax step."""
    states = {}
    for sub, name in MODELS[model][2]:
        ckpt_dir = os.path.join(source, sub)
        params, stats = load_variables(ckpt_dir, name)
        state = create_train_state(_module(model, name, params, stats))
        state.step = orbax_step(ckpt_dir, name)
        states[name] = state
    return states


def main(models=tuple(MODELS)) -> None:
    for model in models:
        source, target, trees = MODELS[model]
        for (sub, name), state in zip(trees, convert(source, model).values()):
            path = save_checkpoint(state, os.path.join(target, sub), name)
            print(f"{model} {name}: step {state.step} -> {path} "
                  f"({os.path.getsize(path)} bytes)")


if __name__ == "__main__":
    main(sys.argv[1:] or tuple(MODELS))
