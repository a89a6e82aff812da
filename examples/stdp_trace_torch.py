"""Example: trace-based STDP on a Linear + IF layer with online weight
updates, on the PyTorch port.

The port's counterpart of ``examples/stdp_trace.py`` (spikingjelly's
``stdp_trace.py`` and ``mstdp.py`` / ``mstdpet.py``): a 4 -> 3 synapse
driven by random input spikes, an IF neuron on top, and the local STDP
rule (``snn/learning.stdp_step``) updating the weights at every step,
which changes the next step's post-synaptic spikes. Then the
reward-modulated variants (``mstdp_scan``, ``mstdpet_scan``) on fixed
spike trains: a -1 reward stream flips the sign of the +1 stream's
update exactly. The JAX keys become seeded ``torch.Generator``s (on the
host, so a run draws the same trains on either device). Plain PyTorch,
on the card unless ``--device cpu``.

    python examples/stdp_trace_torch.py [--T 128] [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse

import numpy as np
import torch

from spiking_diffusion_tpu_torch.device import resolve_device
from spiking_diffusion_tpu_torch.snn import learning
from spiking_diffusion_tpu_torch.snn.neuron import NeuronParams, if_step

SEED = 0


def spike_trains(seed, shape, p_silent, device):
    """(uniform > p_silent) spikes of ``shape`` from ``torch.Generator(seed)``."""
    u = torch.rand(shape, generator=torch.Generator().manual_seed(seed))
    return (u > p_silent).float().to(device)


def run_online_stdp(in_spikes, n_out=3, lr=0.01, w_init=0.4, w_min=-1.0, w_max=1.0):
    """Forward one step -> STDP update -> clamp, over (T, batch, n_in)
    input spikes: (final weights, (T, n_in, n_out) weights, (T, batch,
    n_out) output spikes)."""
    _, batch, n_in = in_spikes.shape
    dev = in_spikes.device
    p = NeuronParams()
    w = torch.full((n_in, n_out), w_init, device=dev)
    v = torch.zeros((batch, n_out), device=dev)
    st = learning.init_state(n_in, n_out, batch, device=dev)
    w_traj, out = [], []
    for s_pre in in_spikes:
        v, s_post = if_step(v, s_pre @ w, p)
        st, dw = learning.stdp_step(st, s_pre, s_post)
        w = torch.clamp(w + lr * dw, w_min, w_max)
        w_traj.append(w)
        out.append(s_post)
    return w, torch.stack(w_traj), torch.stack(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--T", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    in_spikes = spike_trains(SEED, (args.T, 2, 4), 0.7, dev)
    w_final, w_traj, out_spikes = run_online_stdp(in_spikes, lr=args.lr)
    print(f"input rate {float(in_spikes.mean()):.3f}, "
          f"output rate {float(out_spikes.mean()):.3f}")
    print("final weights:\n", np.round(w_final.cpu().numpy(), 4))
    drift = float((w_traj[-1] - 0.4).abs().mean())
    print(f"mean |w - w_init| after T={args.T}: {drift:.4f}")

    # reward-modulated variants on fixed spike trains: a +1 reward stream
    # potentiates where a -1 stream depresses (sign flip)
    s_pre = spike_trains(SEED + 1, (args.T, 2, 4), 0.7, dev)
    s_post = spike_trains(SEED + 2, (args.T, 2, 3), 0.8, dev)
    ones = torch.ones((args.T,), device=dev)
    plus = learning.mstdp_scan(s_pre, s_post, ones)
    minus = learning.mstdp_scan(s_pre, s_post, -ones)
    torch.testing.assert_close(plus, -minus, rtol=1e-6, atol=0)
    et = learning.mstdpet_scan(s_pre, s_post, ones)
    print(f"MSTDP total |dw| {float(plus.abs().sum()):.3f} "
          f"(reward sign flips it exactly); "
          f"MSTDP-ET |dw| {float(et.abs().sum()):.3f}")
    return {"drift": drift, "w_final": w_final.cpu().numpy(),
            "mstdp": float(plus.abs().sum()), "mstdpet": float(et.abs().sum())}


if __name__ == "__main__":
    main()
