"""Forward Propagation Through Time (FPTT) online training.

Counterpart of ``spiking_diffusion_tpu/snn/fptt.py`` (spikingjelly
``functional.py:1162-1280``; Kag & Saligrama 2021): the parameters move at
every timestep on the instantaneous loss plus a running-average anchor::

    L_t(w)  = f(y_t(w), target_t) + (alpha/2) ||w - a_t||^2,  a_t = w_ra + g_last / (2 alpha)
    w      <- w - lr dL_t/dw
    g_last <- d f(y_t(w_new)) / dw   (the bare loss at the new parameters, same pre-step state)
    w_ra   <- (w_ra + w_new) / 2 - g_last / (2 alpha)

Parameters are a dict of tensors; each step's two gradients are
``torch.autograd.grad``s. ``cell_apply(params, state, x_t) -> (state,
y_t)`` is the stateful model step; the state carried to the next step is
detached, as the reference's per-step optimiser steps cut the graph.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

CellApply = Callable[[Dict[str, torch.Tensor], Any, torch.Tensor], Tuple[Any, torch.Tensor]]


def _detach(state):
    if isinstance(state, torch.Tensor):
        return state.detach()
    if isinstance(state, (tuple, list)):
        return type(state)(_detach(s) for s in state)
    return state


def fptt_online_training(
    cell_apply: CellApply,
    params: Dict[str, torch.Tensor],
    state0: Any,
    x_seq: torch.Tensor,
    target_seq: torch.Tensor,
    f_loss: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    lr: float = 0.1,
    alpha: float = 0.1,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """FPTT over (T, ...) inputs and targets; returns (new parameters,
    the (T,) per-step losses)."""
    names = list(params)
    p = {k: v.detach() for k, v in params.items()}
    w_ra = dict(p)
    g_last = {k: torch.zeros_like(v) for k, v in p.items()}
    state = state0
    losses = []
    for x_t, tgt_t in zip(x_seq, target_seq):
        anchor = {k: w_ra[k] + g_last[k] / (2.0 * alpha) for k in names}
        pp = {k: v.clone().requires_grad_() for k, v in p.items()}
        new_state, y = cell_apply(pp, state, x_t)
        reg = sum(torch.sum((pp[k] - anchor[k]) ** 2) for k in names)
        loss_t = f_loss(y, tgt_t) + 0.5 * alpha * reg
        grads = torch.autograd.grad(loss_t, [pp[k] for k in names])
        p_new = {k: p[k] - lr * g for k, g in zip(names, grads)}
        # the bare loss's gradient at the new parameters, from the same
        # pre-step state
        pn = {k: v.clone().requires_grad_() for k, v in p_new.items()}
        _, y_new = cell_apply(pn, state, x_t)
        g_bare = torch.autograd.grad(f_loss(y_new, tgt_t), [pn[k] for k in names])
        g_last = dict(zip(names, g_bare))
        w_ra = {k: (w_ra[k] + p_new[k]) / 2.0 - g_last[k] / (2.0 * alpha) for k in names}
        p, state = p_new, _detach(new_state)
        losses.append(loss_t.detach())
    return p, torch.stack(losses)
