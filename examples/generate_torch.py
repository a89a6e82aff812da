"""Example: generate images from a two-stage checkpoint of the PyTorch port.

The port's counterpart of ``examples/generate.py``: the layerwise
sampler (every LIF layer on K1) then the VQ-VAE decode, on the card
unless ``--device cpu`` is passed; the checkpoint in the port's artifact
layout (``<checkpoint>/model.pt``, ``<checkpoint>/diff_result/diff_model.pt``).

    python examples/generate_torch.py --checkpoint result_torch/MNIST/snn-vq-vae \\
        --n 64 --temperature 0.65 --out samples.png
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse

import torch

from spiking_diffusion_tpu_torch import generate
from spiking_diffusion_tpu_torch.config import DiffusionConfig, VQVAEConfig
from spiking_diffusion_tpu_torch.device import resolve_device
from spiking_diffusion_tpu_torch.train.checkpoint import restore_two_stage
from spiking_diffusion_tpu_torch.utils import save_image_grid


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--n", type=int, default=64)
    p.add_argument("--temperature", type=float, default=0.65)
    p.add_argument("--codebook_size", type=int, default=128)
    p.add_argument("--num_steps", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="samples.png")
    p.add_argument("--device", default="cuda")
    args = p.parse_args()

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        # full fp32 convs and matmuls, not TF32, as the CLI
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    vq_cfg = VQVAEConfig(num_steps=args.num_steps, num_embeddings=args.codebook_size)
    d_cfg = DiffusionConfig(num_embeddings=args.codebook_size, mask_id=args.codebook_size,
                            num_steps=args.num_steps)
    vqvae, denoiser = restore_two_stage(args.checkpoint, vq_cfg, d_cfg, dev)
    _, images = generate.generate(
        denoiser, vqvae, d_cfg, args.n, temperature=args.temperature,
        generator=torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    rows = -(-args.n // 8)
    save_image_grid(images.cpu().numpy(), args.out, rows=rows, cols=8)
    print(f"wrote {args.n} samples to {args.out}")


if __name__ == "__main__":
    main()
