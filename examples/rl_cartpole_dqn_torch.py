"""Example: spiking DQN on CartPole, on the PyTorch port.

The port's counterpart of ``examples/rl_cartpole_dqn.py`` (spikingjelly's
``DQN_state.py``), self-contained: a numpy CartPole (classic Barto-Sutton
dynamics, no gym), a spiking Q-network (state -> Linear -> LIF over T
direct-coded steps -> rate -> Linear), epsilon-greedy actions, a replay
buffer and a target network. The Q-network's Linear layers take
``nn.Linear``'s own initialisation from a seeded ``torch.Generator``
(JAX's ``torch_kernel_init`` is that law); the JAX net's parameter dict
carries across with ``weights.mlp_state_dict(params, LAYERS)``. The
environment, the exploration and the replay draws are the JAX example's
numpy ones. ``CartPole`` here is the one the A2C and PPO examples use.
Plain PyTorch, on the card unless ``--device cpu``.

    python examples/rl_cartpole_dqn_torch.py [--episodes 60] [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import math
from collections import deque

import numpy as np
import torch
from torch import nn

from spiking_diffusion_tpu_torch.device import resolve_device
from spiking_diffusion_tpu_torch.snn.encoding import direct_encode
from spiking_diffusion_tpu_torch.snn.neuron import NeuronParams, lif_step

T_STEPS = 8
HIDDEN = 64
# CartPole states are O(0.05-0.2); without a drive gain the LIF layer
# never crosses threshold and the Q-net is silent
STATE_GAIN = 8.0
SEED = 0
LAYERS = {"fc1": ("w1", "b1"), "fc2": ("w2", "b2")}  # Linear <- the JAX dict's keys


class CartPole:
    """Classic CartPole-v1 dynamics (termination at |x|>2.4, |theta|>12deg,
    500-step cap)."""

    def __init__(self, seed=0):
        self.rng = np.random.RandomState(seed)
        self.state = None
        self.steps = 0

    def reset(self):
        self.state = self.rng.uniform(-0.05, 0.05, 4)
        self.steps = 0
        return self.state.copy()

    def step(self, action):
        x, x_dot, th, th_dot = self.state
        force = 10.0 if action == 1 else -10.0
        costh, sinth = np.cos(th), np.sin(th)
        temp = (force + 0.05 * th_dot**2 * sinth) / 1.1
        th_acc = (9.8 * sinth - costh * temp) / (
            0.5 * (4.0 / 3.0 - 0.1 * costh**2 / 1.1)
        )
        x_acc = temp - 0.05 * th_acc * costh / 1.1
        tau = 0.02
        self.state = np.array([
            x + tau * x_dot, x_dot + tau * x_acc,
            th + tau * th_dot, th_dot + tau * th_acc,
        ])
        self.steps += 1
        done = (abs(self.state[0]) > 2.4 or abs(self.state[2]) > 0.2094
                or self.steps >= 500)
        return self.state.copy(), 1.0, done


def seeded_linear(fan_in, fan_out, gen):
    """``nn.Linear`` initialised by its own law (kaiming-uniform weight,
    a = sqrt(5); bias uniform +-1/sqrt(fan_in)) from ``gen``."""
    layer = nn.Linear(fan_in, fan_out)
    with torch.no_grad():
        nn.init.kaiming_uniform_(layer.weight, a=math.sqrt(5), generator=gen)
        bound = 1.0 / math.sqrt(fan_in)
        layer.bias.uniform_(-bound, bound, generator=gen)
    return layer


class QNet(nn.Module):
    """Spiking Q-net: (B, 4) -> (B, 2) rate-decoded Q-values."""

    def __init__(self, gen):
        super().__init__()
        self.fc1 = seeded_linear(4, HIDDEN, gen)
        self.fc2 = seeded_linear(HIDDEN, 2, gen)

    def forward(self, state_batch):
        x = self.fc1(STATE_GAIN * state_batch)
        v = torch.zeros_like(x)
        spikes = []
        for xt in direct_encode(x, T_STEPS):
            v, s = lif_step(v, xt, NeuronParams())
            spikes.append(s)
        return self.fc2(torch.stack(spikes).mean(0))


def dqn_loss(q_net, target_net, s, a, r, s2, done, gamma):
    """Mean squared TD error against the target net's bootstrapped value."""
    q_sa = q_net(s).gather(1, a.long()[:, None])[:, 0]
    with torch.no_grad():
        y = r + gamma * target_net(s2).amax(1) * (1.0 - done)
    return torch.mean((q_sa - y) ** 2)


def train_step(q_net, target_net, optimizer, batch, gamma):
    optimizer.zero_grad(set_to_none=True)
    loss = dqn_loss(q_net, target_net, *batch, gamma)
    loss.backward()
    optimizer.step()
    return loss.detach()


def replay_batch(buf, idx, device):
    """(s, a, r, s2, done) tensors of the replay entries ``idx``."""
    batch = [buf[i] for i in idx]
    cols = (np.stack([b[0] for b in batch]), np.asarray([b[1] for b in batch], np.int64),
            np.asarray([b[2] for b in batch]), np.stack([b[3] for b in batch]),
            np.asarray([b[4] for b in batch]))
    return tuple(torch.from_numpy(np.asarray(c, np.int64 if i == 1 else np.float32)).to(device)
                 for i, c in enumerate(cols))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--episodes", type=int, default=60)
    ap.add_argument("--gamma", type=float, default=0.99)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False

    q_net = QNet(torch.Generator().manual_seed(SEED)).to(dev)
    target = QNet(torch.Generator().manual_seed(SEED)).to(dev)
    target.load_state_dict(q_net.state_dict())
    optimizer = torch.optim.Adam(q_net.parameters(), lr=args.lr, eps=1e-8)

    env = CartPole(seed=0)
    buf = deque(maxlen=10_000)
    rng = np.random.RandomState(1)
    eps, eps_min, eps_decay = 1.0, 0.05, 0.97
    returns = []
    for ep in range(args.episodes):
        s = env.reset()
        total, done = 0.0, False
        while not done:
            if rng.rand() < eps:
                a = rng.randint(2)
            else:
                with torch.no_grad():
                    q = q_net(torch.from_numpy(s[None].astype(np.float32)).to(dev))
                a = int(q.argmax())
            s2, r, done = env.step(a)
            buf.append((s, a, r, s2, float(done)))
            s = s2
            total += r
            if len(buf) >= 128:
                idx = rng.choice(len(buf), 64, replace=False)
                train_step(q_net, target, optimizer, replay_batch(buf, idx, dev), args.gamma)
        returns.append(total)
        eps = max(eps_min, eps * eps_decay)
        if (ep + 1) % 10 == 0:
            target.load_state_dict(q_net.state_dict())
            print(f"episode {ep + 1}: return {total:.0f} "
                  f"(mean last 10: {np.mean(returns[-10:]):.1f}, eps {eps:.2f})")

    early, late = np.mean(returns[:10]), np.mean(returns[-10:])
    print(f"mean return: first 10 eps {early:.1f} -> last 10 eps {late:.1f}")
    return {"returns": returns}


if __name__ == "__main__":
    main()
