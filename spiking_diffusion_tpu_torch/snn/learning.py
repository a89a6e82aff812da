"""Trace-based STDP learners (spikingjelly ``learning.py``).

Counterparts of ``spiking_diffusion_tpu/snn/learning.py``: pure functions
over explicit trace state, looped over the spike trains::

    trace_pre[t]  = trace_pre[t-1]  - trace_pre[t-1] / tau_pre   + s_pre[t]
    trace_post[t] = trace_post[t-1] - trace_post[t-1] / tau_post + s_post[t]
    dw[t] = f_post * outer(trace_pre[t], s_post[t]) - f_pre * outer(s_pre[t], trace_post[t])

summed over the batch; MSTDP scales dw[t] by a reward, MSTDPET by a
reward times an eligibility trace. Plain PyTorch on either device.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class STDPState(NamedTuple):
    trace_pre: torch.Tensor  # (B, n_pre)
    trace_post: torch.Tensor  # (B, n_post)


def init_state(n_pre: int, n_post: int, batch: int = 1, device=None) -> STDPState:
    return STDPState(torch.zeros((batch, n_pre), device=device),
                     torch.zeros((batch, n_post), device=device))


def stdp_step(state: STDPState, s_pre: torch.Tensor, s_post: torch.Tensor,
              tau_pre: float = 2.0, tau_post: float = 2.0, f_pre: float = 1.0,
              f_post: float = 1.0) -> Tuple[STDPState, torch.Tensor]:
    """One STDP step: (new state, dw (n_pre, n_post)) summed over the batch."""
    trace_pre = state.trace_pre - state.trace_pre / tau_pre + s_pre
    trace_post = state.trace_post - state.trace_post / tau_post + s_post
    dw_pot = f_post * torch.einsum("bi,bj->ij", trace_pre, s_post)
    dw_dep = f_pre * torch.einsum("bi,bj->ij", s_pre, trace_post)
    return STDPState(trace_pre, trace_post), dw_pot - dw_dep


def _init(s_pre_seq, s_post_seq):
    b, n_pre = s_pre_seq.shape[1], s_pre_seq.shape[2]
    n_post = s_post_seq.shape[2]
    zero = torch.zeros((n_pre, n_post), device=s_pre_seq.device)
    return init_state(n_pre, n_post, b, s_pre_seq.device), zero


def stdp_scan(s_pre_seq: torch.Tensor, s_post_seq: torch.Tensor, tau_pre: float = 2.0,
              tau_post: float = 2.0, f_pre: float = 1.0, f_post: float = 1.0) -> torch.Tensor:
    """Total STDP update of (T, B, n_pre) and (T, B, n_post) spike trains."""
    st, acc = _init(s_pre_seq, s_post_seq)
    for sp, spo in zip(s_pre_seq, s_post_seq):
        st, dw = stdp_step(st, sp, spo, tau_pre, tau_post, f_pre, f_post)
        acc = acc + dw
    return acc


def mstdp_scan(s_pre_seq: torch.Tensor, s_post_seq: torch.Tensor, reward_seq: torch.Tensor,
               tau_pre: float = 2.0, tau_post: float = 2.0) -> torch.Tensor:
    """Reward-modulated STDP: dw[t] scaled by reward[t] (T,)."""
    st, acc = _init(s_pre_seq, s_post_seq)
    for sp, spo, r in zip(s_pre_seq, s_post_seq, reward_seq):
        st, dw = stdp_step(st, sp, spo, tau_pre, tau_post)
        acc = acc + r * dw
    return acc


def mstdpet_scan(s_pre_seq: torch.Tensor, s_post_seq: torch.Tensor, reward_seq: torch.Tensor,
                 tau_pre: float = 2.0, tau_post: float = 2.0, tau_e: float = 5.0) -> torch.Tensor:
    """MSTDP with an eligibility trace: e[t] = e[t-1] - e[t-1] / tau_e + dw[t],
    the update reward[t] * e[t]."""
    st, acc = _init(s_pre_seq, s_post_seq)
    elig = acc
    for sp, spo, r in zip(s_pre_seq, s_post_seq, reward_seq):
        st, dw = stdp_step(st, sp, spo, tau_pre, tau_post)
        elig = elig - elig / tau_e + dw
        acc = acc + r * elig
    return acc
