"""Example: export a two-stage model of the PyTorch port for neuromorphic
deployment, in both portable formats.

The port's counterpart of ``examples/deploy_netx.py``:

    python examples/deploy_netx_torch.py --checkpoint result_torch/MNIST/snn-vq-vae \\
        --out ./deploy

Writes:
  deploy/denoiser.net, deploy/encoder.net: Lava-DL netx HDF5 (CUBA
      neurons, BN folded, the decay_input LIF as the 1/tau weight fold)
  deploy/svae.{json,npz}: the runtime-neutral netlist of the VQ-VAE
      (topology, neuron constants, weights in the JAX package's layout)

The netx files need ``h5py``, so the script runs on a host that has it
(the card's machine has none): with ``--device cpu``, or on the card's
host if it has one. Without ``--checkpoint`` it exports a model of
seeded random weights (a schema demo).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse

import torch

from spiking_diffusion_tpu_torch.config import DiffusionConfig, VQVAEConfig
from spiking_diffusion_tpu_torch.device import resolve_device
from spiking_diffusion_tpu_torch.models import deploy, lava_export, weights
from spiking_diffusion_tpu_torch.train.checkpoint import restore_two_stage


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", default=None,
                   help="result dir of a trained run (optional)")
    p.add_argument("--out", default="./deploy")
    p.add_argument("--codebook_size", type=int, default=128)
    p.add_argument("--num_steps", type=int, default=16)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()

    dev = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    vq_cfg = VQVAEConfig(num_steps=args.num_steps, num_embeddings=args.codebook_size)
    d_cfg = DiffusionConfig(num_steps=args.num_steps, num_embeddings=args.codebook_size,
                            mask_id=args.codebook_size)
    if args.checkpoint:
        vqvae, denoiser = restore_two_stage(args.checkpoint, vq_cfg, d_cfg, dev)
        print(f"loaded checkpoints from {args.checkpoint}")
    else:
        init = torch.Generator().manual_seed(0)
        vqvae = weights.load_vqvae(*weights.init_vqvae_variables(vq_cfg, init), vq_cfg,
                                   device=dev)
        denoiser = weights.load_denoiser(*weights.init_denoiser_variables(d_cfg, init),
                                         d_cfg, device=dev)

    dn = lava_export.denoiser_to_netx(denoiser, d_cfg, os.path.join(args.out, "denoiser.net"))
    en = lava_export.encoder_to_netx(vqvae, vq_cfg, os.path.join(args.out, "encoder.net"))
    jp, np_ = deploy.export_netlist(
        weights.vqvae_variables(vqvae), os.path.join(args.out, "svae"),
        neuron_params=vq_cfg.lif.to_params(),
        meta={"model": "snn-vq-vae", "T": args.num_steps},
    )
    print("wrote:", dn)
    print("wrote:", en)
    print("wrote:", jp, "+", np_)


if __name__ == "__main__":
    main()
