"""Training of the port: train state, the stage-1 (VQ-VAE) and stage-2
(diffusion prior) steps and loops, checkpoints."""

from spiking_diffusion_tpu_torch.train.state import TrainState, create_train_state
from spiking_diffusion_tpu_torch.train.stage1 import (
    eval_step_vqvae,
    extract_code_indices,
    make_train_step_vqvae,
    train_vqvae,
)
from spiking_diffusion_tpu_torch.train.stage2 import (
    make_train_step_diffusion,
    train_diffusion,
)

__all__ = ["TrainState", "create_train_state", "eval_step_vqvae", "extract_code_indices",
           "make_train_step_vqvae", "train_vqvae", "make_train_step_diffusion",
           "train_diffusion"]
