"""Export the committed MNIST flagship checkpoint for the PyTorch port.

Reads the JAX package's orbax trees ``result_r5_e60/MNIST/snn-vq-vae/
{model, diff_result/diff_model}`` (the 60 + 120 epoch run of the flagship
``VQVAEConfig()`` / ``DiffusionConfig()``), converts them with the port's
``models/weights.py`` and writes them with the port's
``train/checkpoint.save_checkpoint`` as

    result_torch/MNIST/snn-vq-vae/model.pt
    result_torch/MNIST/snn-vq-vae/diff_result/diff_model.pt

the port CLI's own layout, so ``python -m spiking_diffusion_tpu_torch.cli
--checkpoint result_torch/MNIST/snn-vq-vae`` evaluates the trained run.
Each file holds the orbax step, the model's state dict (parameters and BN
running statistics, fp32) and a fresh AdamW state: Adam's moments are not
carried over, since the CLI restores a checkpoint only to skip training.

Needs JAX and orbax (the JAX package reads the trees); run from the repo
root:

    python scripts/export_torch_weights.py
"""

from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import orbax.checkpoint as ocp  # noqa: E402

from spiking_diffusion_tpu.train.checkpoint import load_variables  # noqa: E402
from spiking_diffusion_tpu_torch.config import DiffusionConfig, VQVAEConfig  # noqa: E402
from spiking_diffusion_tpu_torch.models import weights  # noqa: E402
from spiking_diffusion_tpu_torch.train.checkpoint import save_checkpoint  # noqa: E402
from spiking_diffusion_tpu_torch.train.state import create_train_state  # noqa: E402

SOURCE = os.path.join(REPO, "result_r5_e60", "MNIST", "snn-vq-vae")
TARGET = os.path.join(REPO, "result_torch", "MNIST", "snn-vq-vae")
# (orbax subdirectory, name): stage 1 beside, stage 2 under diff_result/
TREES = (("", "model"), ("diff_result", "diff_model"))


def orbax_step(ckpt_dir: str, name: str) -> int:
    """The train step stored in an orbax tree."""
    tree = ocp.StandardCheckpointer().restore(os.path.join(os.path.abspath(ckpt_dir), name))
    return int(tree["step"])


def convert(source: str = SOURCE):
    """{name: train state} of the port on the CPU, from the orbax trees:
    the converted model in training mode, a fresh AdamW, the orbax step."""
    states = {}
    for sub, name in TREES:
        ckpt_dir = os.path.join(source, sub)
        params, stats = load_variables(ckpt_dir, name)
        if name == "model":
            model = weights.load_vqvae(params, stats, VQVAEConfig(), device="cpu")
        else:
            model = weights.load_denoiser(params, stats, DiffusionConfig(), device="cpu")
        state = create_train_state(model)
        state.step = orbax_step(ckpt_dir, name)
        states[name] = state
    return states


def main(source: str = SOURCE, target: str = TARGET) -> None:
    for (sub, name), state in zip(TREES, convert(source).values()):
        path = save_checkpoint(state, os.path.join(target, sub), name)
        print(f"{name}: step {state.step} -> {path} ({os.path.getsize(path)} bytes)")


if __name__ == "__main__":
    main()
