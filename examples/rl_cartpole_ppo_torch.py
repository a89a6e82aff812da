"""Example: spiking PPO on CartPole, on the PyTorch port.

The port's counterpart of ``examples/rl_cartpole_ppo.py`` (spikingjelly's
``Spiking_PPO.py``): the spiking actor-critic of
``rl_cartpole_a2c_torch`` (Linear -> IF -> Linear -> non-spiking LIF
readout, T = 16) with a categorical policy, vectorized CartPole envs,
GAE(lambda) returns, normalised advantages and clipped-ratio minibatch
updates (Adam) over several epochs of each rollout. The actions are drawn
from a seeded ``torch.Generator`` on the device (JAX draws them from
keys); the minibatch shuffles are the JAX example's
``np.random.default_rng(0)``. Plain PyTorch, on the card unless
``--device cpu``.

    python examples/rl_cartpole_ppo_torch.py [--rollouts 40] [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from examples.rl_cartpole_a2c_torch import (
    SEED,
    ActorCritic,
    eval_episode,
    sample_actions,
    step_envs,
)
from examples.rl_cartpole_dqn_torch import CartPole
from spiking_diffusion_tpu_torch.device import resolve_device


def compute_gae(rewards, masks, values, next_value, gamma=0.99, lam=0.95):
    """Bootstrapped GAE(lambda) returns, reference compute_gae
    (``Spiking_PPO.py:126-134``). All args numpy, shapes (S, N) except
    next_value (N,). Returns (returns, advantages), both (S, N)."""
    S = rewards.shape[0]
    values_ext = np.concatenate([values, next_value[None]], axis=0)
    gae = np.zeros_like(next_value)
    returns = np.zeros_like(rewards)
    for t in reversed(range(S)):
        delta = rewards[t] + gamma * values_ext[t + 1] * masks[t] - values_ext[t]
        gae = delta + gamma * lam * masks[t] * gae
        returns[t] = gae + values_ext[t]
    return returns, returns - values


def ppo_loss(model, s, a, old_logp, ret, adv, clip, value_coef, entropy_coef):
    """(loss, entropy) of one clipped-PPO minibatch (``ppo_update``,
    Spiking_PPO.py:146-166)."""
    logits, values = model(s)
    logp_all = F.log_softmax(logits, -1)
    logp = logp_all.gather(1, a.long()[:, None])[:, 0]
    ratio = torch.exp(logp - old_logp)
    surr1 = ratio * adv
    surr2 = torch.clamp(ratio, 1.0 - clip, 1.0 + clip) * adv
    actor_loss = -torch.minimum(surr1, surr2).mean()
    critic_loss = ((ret - values) ** 2).mean()
    entropy = -(F.softmax(logits, -1) * logp_all).sum(-1).mean()
    return actor_loss + value_coef * critic_loss - entropy_coef * entropy, entropy


def minibatch_update(model, optimizer, batch, clip, value_coef, entropy_coef):
    optimizer.zero_grad(set_to_none=True)
    loss, ent = ppo_loss(model, *batch, clip, value_coef, entropy_coef)
    loss.backward()
    optimizer.step()
    return loss.detach(), ent.detach()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--rollouts", type=int, default=40)
    p.add_argument("--n_envs", type=int, default=4)
    p.add_argument("--n_steps", type=int, default=64)
    p.add_argument("--ppo_epochs", type=int, default=4)
    p.add_argument("--minibatch", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--gamma", type=float, default=0.99)
    p.add_argument("--gae_lambda", type=float, default=0.95)
    p.add_argument("--clip", type=float, default=0.2)
    p.add_argument("--entropy_coef", type=float, default=0.001)
    p.add_argument("--value_coef", type=float, default=0.5)
    p.add_argument("--eval_every", type=int, default=10)
    p.add_argument("--hidden", type=int, default=128)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False

    envs = [CartPole(seed=i) for i in range(args.n_envs)]
    states = np.stack([e.reset() for e in envs])
    model = ActorCritic(hidden=args.hidden).to(dev)
    optimizer = torch.optim.Adam(model.parameters(), lr=args.lr, eps=1e-8)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    as_t = lambda a, dtype=torch.float32: torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)  # noqa: E731

    rng = np.random.default_rng(0)
    for rollout_i in range(args.rollouts):
        roll = {k: [] for k in ("s", "a", "logp", "v", "r", "m")}
        for _ in range(args.n_steps):
            with torch.no_grad():
                logits, value = model(as_t(states))
                actions = sample_actions(logits, gen)
                logp = F.log_softmax(logits, -1).gather(1, actions[:, None])[:, 0]
            actions = actions.cpu().numpy()
            roll["s"].append(states.copy())
            roll["a"].append(actions)
            roll["logp"].append(logp.cpu().numpy())
            roll["v"].append(value.cpu().numpy())
            states, step_r, step_m = step_envs(envs, states, actions)
            roll["r"].append(step_r)
            roll["m"].append(step_m)
        with torch.no_grad():
            next_value = model(as_t(states))[1].cpu().numpy()
        returns, adv = compute_gae(np.stack(roll["r"]), np.stack(roll["m"]), np.stack(roll["v"]),
                                   next_value, args.gamma, args.gae_lambda)
        adv = (adv - adv.mean()) / (adv.std() + 1e-8)

        flat = lambda x: np.stack(x).reshape(-1, *np.asarray(x[0]).shape[1:])  # noqa: E731
        buf = (as_t(flat(roll["s"])), as_t(flat(roll["a"]), torch.int64),
               as_t(flat(roll["logp"])), as_t(returns.reshape(-1)), as_t(adv.reshape(-1)))
        B = buf[0].shape[0]
        for _ in range(args.ppo_epochs):
            ids = rng.permutation(B)
            n_mb = max(1, B // args.minibatch)
            for mb in np.array_split(ids[:n_mb * args.minibatch], n_mb):
                mb = torch.from_numpy(mb).to(dev)
                loss, ent = minibatch_update(model, optimizer, tuple(t[mb] for t in buf),
                                             args.clip, args.value_coef, args.entropy_coef)
        if (rollout_i + 1) % args.eval_every == 0:
            print(f"rollout {rollout_i + 1}: loss {float(loss):.3f} "
                  f"entropy {float(ent):.3f} eval reward {eval_episode(model, dev):.0f}")

    final = eval_episode(model, dev)
    print(f"final eval reward: {final:.0f} (CartPole solves at 500)")
    return {"final_reward": final}


if __name__ == "__main__":
    main()
