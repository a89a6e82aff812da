"""LIF neuron dynamics over explicit state.

Dynamics (spikingjelly ``LIFNode``), the same fp32 operations in the same
order as ``spiking_diffusion_tpu/snn/neuron.py``:

    charge (decay_input=True):  H[t] = V[t-1] + (X[t] - (V[t-1] - v_reset)) * decay
    charge (decay_input=False): H[t] = V[t-1] - (V[t-1] - v_reset) * decay + X[t]
    fire:                       S[t] = Theta(H[t] - v_th)
    hard reset:                 V[t] = (1 - S[t]) * H[t] + S[t] * v_reset
    soft reset:                 V[t] = H[t] - S[t] * v_th

with decay = 1/tau. The spike carries the surrogate gradient
(``snn/surrogate.py``), so ``lif_step`` and ``lif_scan``, a plain Python
loop over T, are differentiable by autograd; ``detach_reset`` keeps the
reset out of the gradient, as JAX's ``_reset`` does. ``lif_multi_step``
runs K1, the hand-written CUDA forward and backward kernels behind one
``torch.autograd.Function`` (:mod:`spiking_diffusion_tpu_torch.ops.lif`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from spiking_diffusion_tpu_torch.snn.surrogate import SurrogateFn, atan

BACKENDS = ("auto", "torch", "cuda")


@dataclasses.dataclass(frozen=True)
class NeuronParams:
    """Static neuron constants."""

    tau: float = 2.0
    v_threshold: float = 1.0
    v_reset: float = 0.0
    decay_input: bool = True
    hard_reset: bool = True
    detach_reset: bool = False
    surrogate: SurrogateFn = atan

    @property
    def decay(self) -> float:
        """1/tau, the decay factor the fused kernel uses."""
        return 1.0 / self.tau


def charge(v: torch.Tensor, x: torch.Tensor, p: NeuronParams) -> torch.Tensor:
    """The pre-reset membrane H[t] from V[t-1] and X[t]."""
    if p.decay_input:
        return v + (x - (v - p.v_reset)) * p.decay
    return v - (v - p.v_reset) * p.decay + x


def reset(h: torch.Tensor, s: torch.Tensor, p: NeuronParams) -> torch.Tensor:
    """V[t] from H[t] and the spike S[t]."""
    if p.hard_reset:
        return (1.0 - s) * h + s * p.v_reset
    return h - s * p.v_threshold


def lif_step(
    v: torch.Tensor, x: torch.Tensor, params: NeuronParams = NeuronParams()
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LIF timestep: (v, x) -> (v_next, spike)."""
    p = params
    h = charge(v, x, p)
    s = p.surrogate(h - p.v_threshold)
    return reset(h, s.detach() if p.detach_reset else s, p), s


def lif_scan(
    x_seq: torch.Tensor,
    v_init: Optional[torch.Tensor] = None,
    params: NeuronParams = NeuronParams(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """LIF over a (T, ...) input; returns (spikes in the input dtype, v_T).

    Membranes are fp32 whatever the input dtype.
    """
    xt = x_seq.float()
    if v_init is None:
        v = torch.full(x_seq.shape[1:], params.v_reset, dtype=torch.float32,
                       device=x_seq.device)
    else:
        v = v_init.float()
    spikes = []
    for t in range(xt.shape[0]):
        v, s = lif_step(v, xt[t], params)
        spikes.append(s)
    return torch.stack(spikes).to(x_seq.dtype), v


def lif_multi_step(
    x_seq: torch.Tensor,
    v_init: Optional[torch.Tensor] = None,
    params: NeuronParams = NeuronParams(),
    backend: str = "auto",
) -> torch.Tensor:
    """Multi-step LIF, differentiable; returns the (T, ...) spike train.

    ``backend``: 'cuda' (K1's forward and backward kernels; the tensor
    must lie on a CUDA device), 'auto' (K1 for a CUDA tensor, its plain
    versions for a CPU tensor) or 'torch' (K1's plain versions on either
    device).
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown LIF backend {backend!r}; have {BACKENDS}")
    if backend == "cuda" and not x_seq.is_cuda:
        raise ValueError("LIF backend 'cuda' needs a tensor on a CUDA device")
    # imported here: ops.lif imports this module for NeuronParams
    from spiking_diffusion_tpu_torch.ops.lif import lif

    return lif(x_seq, v_init, params, reference=backend == "torch")
