"""Example: FPTT online learning on a temporal task, on the PyTorch port.

The port's counterpart of ``examples/fptt_online.py``: a Linear + LIF cell
learns to reproduce a target pattern with Forward Propagation Through
Time (``snn/fptt.py``): the parameters move at every timestep on the
instantaneous loss plus a running-average anchor, with no BPTT over the
window. The weights, inputs and targets are the JAX example's numpy
draws. Plain PyTorch (``lif_step``), on the card unless ``--device cpu``.

    python examples/fptt_online_torch.py [--epochs 20] [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse

import numpy as np
import torch

from spiking_diffusion_tpu_torch.device import resolve_device
from spiking_diffusion_tpu_torch.snn.fptt import fptt_online_training
from spiking_diffusion_tpu_torch.snn.neuron import NeuronParams, lif_step

T, N, D_IN, D_H, D_OUT = 32, 16, 8, 32, 4
LR, ALPHA = 0.05, 0.5


def cell_apply(params, v, x_t):
    h = x_t @ params["w1"] + params["b1"]
    v, s = lif_step(v, h, NeuronParams())
    return v, s @ params["w2"]


def f_loss(y, target):
    return torch.mean((y - target) ** 2)


def make_problem(device):
    """(params, x_seq, target, state0): the JAX example's draws from
    ``np.random.RandomState(0)``."""
    rng = np.random.RandomState(0)
    as_t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)  # noqa: E731
    params = {"w1": as_t(rng.randn(D_IN, D_H).astype(np.float32) * 0.4),
              "b1": as_t(np.zeros(D_H)),
              "w2": as_t(rng.randn(D_H, D_OUT).astype(np.float32) * 0.4)}
    x_seq = as_t(rng.rand(T, N, D_IN).astype(np.float32) * 2)
    target = as_t(rng.rand(T, N, D_OUT).astype(np.float32))
    return params, x_seq, target, torch.zeros((N, D_H), device=device)


def epoch(params, x_seq, target, state0):
    """One FPTT pass over the window: (new parameters, per-step losses)."""
    return fptt_online_training(cell_apply, params, state0, x_seq, target, f_loss,
                                lr=LR, alpha=ALPHA)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    params, x_seq, target, state0 = make_problem(resolve_device(args.device))
    means = []
    for e in range(args.epochs):
        params, losses = epoch(params, x_seq, target, state0)
        means.append(float(losses.mean()))
        if e % 5 == 0 or e == args.epochs - 1:
            print(f"epoch {e}: mean step loss {means[-1]:.4f}")
    return {"losses": means}


if __name__ == "__main__":
    main()
