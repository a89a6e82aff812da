"""Example: spiking A2C (synchronous advantage actor-critic) on CartPole,
on the PyTorch port.

The port's counterpart of ``examples/rl_cartpole_a2c.py`` (spikingjelly's
``Spiking_A2C.py``): actor and critic are each Linear -> IF -> Linear ->
non-spiking LIF, run for T steps on a constant (direct-coded) state; the
readout is the non-spiking LIF's final membrane (charge only, tau = 2),
so gradients flow through the hidden layer's surrogate spikes. Textbook
synchronous A2C: 4 vectorized envs (``rl_cartpole_dqn_torch.CartPole``),
n-step rollouts, bootstrapped discounted returns, advantage-weighted
log-prob loss + value MSE - entropy bonus (Adam). The weights are drawn
unit-normal over sqrt(fan-in) with zero biases from a seeded
``torch.Generator``, the actions from another on the device (JAX draws
both from keys); the JAX example's parameter dict carries across with
``weights.mlp_state_dict(params[head], rl_cartpole_dqn_torch.LAYERS)``
per head. Plain PyTorch, on the card unless
``--device cpu``.

    python examples/rl_cartpole_a2c_torch.py [--updates 300] [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from examples.rl_cartpole_dqn_torch import CartPole
from spiking_diffusion_tpu_torch.device import resolve_device
from spiking_diffusion_tpu_torch.snn.neuron import NeuronParams, if_step

T_STEPS = 16  # reference T (Spiking_A2C.py:143)
HIDDEN = 128
STATE_GAIN = 8.0  # CartPole states are O(0.1); drive the IF layer
SEED = 0


class SpikingHead(nn.Module):
    """Linear -> IF (T steps) -> Linear -> non-spiking LIF readout: the
    readout's membrane after T charge steps, v <- v + (x - v) / 2, never
    firing (the reference's NonSpikingLIFNode, Spiking_A2C.py:37-54)."""

    def __init__(self, n_out, hidden, gen):
        super().__init__()
        self.fc1, self.fc2 = nn.Linear(4, hidden), nn.Linear(hidden, n_out)
        with torch.no_grad():
            for layer in (self.fc1, self.fc2):
                fan_in = layer.in_features
                layer.weight.copy_(torch.randn(layer.in_features, layer.out_features,
                                               generator=gen).T / np.sqrt(fan_in))
                layer.bias.zero_()

    def forward(self, state):
        drive = self.fc1(STATE_GAIN * state)
        v_hid = torch.zeros_like(drive)
        v_out = torch.zeros(state.shape[:1] + (self.fc2.out_features,), device=state.device)
        for _ in range(T_STEPS):
            v_hid, s = if_step(v_hid, drive, NeuronParams())
            v_out = v_out + (self.fc2(s) - v_out) / 2.0
        return v_out


class ActorCritic(nn.Module):
    """(B, 4) -> (logits (B, 2), value (B,)): separate actor and critic
    heads as the reference ActorCritic (Spiking_A2C.py:57-85)."""

    def __init__(self, hidden=HIDDEN, seed=SEED):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.actor = SpikingHead(2, hidden, gen)
        self.critic = SpikingHead(1, hidden, gen)

    def forward(self, state):
        return self.actor(state), self.critic(state)[:, 0]


def a2c_loss(model, states_b, actions_b, returns_b, value_coef, entropy_coef):
    """(loss, entropy) of a rollout: states (S, N, 4), actions and
    bootstrapped returns (S, N)."""
    logits, values = model(states_b.reshape(-1, 4))
    logp = F.log_softmax(logits, -1)
    act_logp = logp.gather(1, actions_b.reshape(-1, 1).long())[:, 0]
    adv = returns_b.reshape(-1) - values
    actor_loss = -(act_logp * adv.detach()).mean()
    critic_loss = (adv ** 2).mean()
    entropy = -(F.softmax(logits, -1) * logp).sum(-1).mean()
    return actor_loss + value_coef * critic_loss - entropy_coef * entropy, entropy


def update(model, optimizer, states_b, actions_b, returns_b, value_coef, entropy_coef):
    optimizer.zero_grad(set_to_none=True)
    loss, ent = a2c_loss(model, states_b, actions_b, returns_b, value_coef, entropy_coef)
    loss.backward()
    optimizer.step()
    return loss.detach(), ent.detach()


def sample_actions(logits, gen):
    """One categorical draw per row of ``logits`` from ``gen``."""
    return torch.multinomial(F.softmax(logits, -1), 1, generator=gen)[:, 0]


def step_envs(envs, states, actions):
    """Each env one step (reset when done): (next states, rewards, masks)."""
    rewards, masks = np.zeros(len(envs)), np.ones(len(envs))
    next_states = states.copy()
    for i, env in enumerate(envs):
        s2, r, done = env.step(int(actions[i]))
        rewards[i] = r
        if done:
            masks[i] = 0.0
            s2 = env.reset()
        next_states[i] = s2
    return next_states, rewards, masks


def eval_episode(model, device, seed=123):
    """A greedy episode's return."""
    env = CartPole(seed=seed)
    s, total, done = env.reset(), 0.0, False
    while not done:
        with torch.no_grad():
            logits, _ = model(torch.from_numpy(s[None].astype(np.float32)).to(device))
        s, r, done = env.step(int(logits[0].argmax()))
        total += r
    return total


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--updates", type=int, default=300)
    p.add_argument("--n_envs", type=int, default=4)
    p.add_argument("--n_steps", type=int, default=5)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--gamma", type=float, default=0.99)
    p.add_argument("--entropy_coef", type=float, default=0.001)
    p.add_argument("--value_coef", type=float, default=0.5)
    p.add_argument("--eval_every", type=int, default=50)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False

    envs = [CartPole(seed=i) for i in range(args.n_envs)]
    states = np.stack([e.reset() for e in envs])
    model = ActorCritic().to(dev)
    optimizer = torch.optim.Adam(model.parameters(), lr=args.lr, eps=1e-8)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    as_t = lambda a, dtype=torch.float32: torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)  # noqa: E731

    for upd_i in range(args.updates):
        roll_s, roll_a, roll_r, roll_m = [], [], [], []
        for _ in range(args.n_steps):
            with torch.no_grad():
                logits, _ = model(as_t(states))
            actions = sample_actions(logits, gen).cpu().numpy()
            roll_s.append(states.copy())
            roll_a.append(actions)
            states, step_r, step_m = step_envs(envs, states, actions)
            roll_r.append(step_r)
            roll_m.append(step_m)
        # bootstrapped discounted returns (compute_returns)
        with torch.no_grad():
            R = model(as_t(states))[1].cpu().numpy().astype(np.float64)
        returns = np.zeros((args.n_steps, args.n_envs))
        for t in reversed(range(args.n_steps)):
            R = roll_r[t] + args.gamma * R * roll_m[t]
            returns[t] = R
        loss, ent = update(model, optimizer, as_t(np.stack(roll_s)),
                           as_t(np.stack(roll_a), torch.int64), as_t(returns),
                           args.value_coef, args.entropy_coef)
        if (upd_i + 1) % args.eval_every == 0:
            print(f"update {upd_i + 1}: loss {float(loss):.3f} "
                  f"entropy {float(ent):.3f} eval reward {eval_episode(model, dev):.0f}")

    final = eval_episode(model, dev)
    print(f"final eval reward: {final:.0f} (CartPole solves at 500)")
    return {"final_reward": final}


if __name__ == "__main__":
    main()
