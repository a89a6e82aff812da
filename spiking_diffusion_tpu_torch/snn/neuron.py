"""Spiking neuron dynamics over explicit state.

Dynamics (spikingjelly ``LIFNode``), the same fp32 operations in the same
order as ``spiking_diffusion_tpu/snn/neuron.py``:

    charge (decay_input=True):  H[t] = V[t-1] + (X[t] - (V[t-1] - v_reset)) * decay
    charge (decay_input=False): H[t] = V[t-1] - (V[t-1] - v_reset) * decay + X[t]
    fire:                       S[t] = Theta(H[t] - v_th)
    hard reset:                 V[t] = (1 - S[t]) * H[t] + S[t] * v_reset
    soft reset:                 V[t] = H[t] - S[t] * v_th

with decay = 1/tau. The spike carries the surrogate gradient
(``snn/surrogate.py``), so the steps and the scans, plain Python loops
over T, are differentiable by autograd; ``detach_reset`` keeps the reset
out of the gradient, as JAX's ``_reset`` does. The IF, PLIF, QIF, EIF
and Izhikevich neurons change only the charge (``if_scan`` ..
``izhikevich_scan``); they are plain PyTorch on either device, as they
are ``lax.scan``s without a kernel in JAX.

``lif_multi_step`` runs K1, the hand-written CUDA forward and backward
kernels behind one ``torch.autograd.Function``
(:mod:`spiking_diffusion_tpu_torch.ops.lif`), for the surrogate families
K1 computes (atan, sigmoid), and ``lif_scan`` for any other, as JAX's
``_pallas_ok`` routes; ``ROUTES`` counts the calls of each route.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from spiking_diffusion_tpu_torch.snn.surrogate import KERNEL_FAMILIES, SurrogateFn, atan

BACKENDS = ("auto", "torch", "cuda")
# calls of ``lif_multi_step`` by route: "kernel" (K1 on a CUDA tensor, its
# plain versions on a CPU tensor or with backend 'torch') and "scan"
# (``lif_scan``, for a surrogate family K1 does not compute)
ROUTES = {"kernel": 0, "scan": 0}


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


def fire_and_reset(h: torch.Tensor, p: NeuronParams) -> Tuple[torch.Tensor, torch.Tensor]:
    """(V[t], S[t]) from the pre-reset membrane H[t]."""
    s = p.surrogate(h - p.v_threshold)
    return reset(h, s.detach() if p.detach_reset else s, p), s


def lif_step(
    v: torch.Tensor, x: torch.Tensor, params: NeuronParams = NeuronParams()
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LIF timestep: (v, x) -> (v_next, spike)."""
    return fire_and_reset(charge(v, x, params), params)


def if_step(
    v: torch.Tensor, x: torch.Tensor, params: NeuronParams = NeuronParams()
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One IF timestep (no leak): H[t] = V[t-1] + X[t]."""
    return fire_and_reset(v + x, params)


def _initial(x_seq: torch.Tensor, v_init: Optional[torch.Tensor], fill: float):
    if v_init is None:
        return torch.full(x_seq.shape[1:], fill, dtype=torch.float32, device=x_seq.device)
    return v_init.float()


def _scan(x_seq, v_init, params: NeuronParams, charge_fn):
    """Spikes (in the input dtype) and v_T of the neuron whose H[t] is
    ``charge_fn(v, x_t)``."""
    xt = x_seq.float()
    v = _initial(x_seq, v_init, params.v_reset)
    spikes = []
    for t in range(xt.shape[0]):
        v, s = fire_and_reset(charge_fn(v, xt[t]), params)
        spikes.append(s)
    return torch.stack(spikes).to(x_seq.dtype), v


def lif_scan(
    x_seq: torch.Tensor,
    v_init: Optional[torch.Tensor] = None,
    params: NeuronParams = NeuronParams(),
    return_v_seq: bool = False,
):
    """LIF over a (T, ...) input; returns (spikes in the input dtype, v_T),
    or with ``return_v_seq`` (spikes, the membrane after each step (T, ...),
    v_T).

    Membranes are fp32 whatever the input dtype.
    """
    xt = x_seq.float()
    v = _initial(x_seq, v_init, params.v_reset)
    spikes, v_seq = [], []
    for t in range(xt.shape[0]):
        v, s = lif_step(v, xt[t], params)
        spikes.append(s)
        if return_v_seq:
            v_seq.append(v)
    s_seq = torch.stack(spikes).to(x_seq.dtype)
    if return_v_seq:
        return s_seq, torch.stack(v_seq), v
    return s_seq, v


def if_scan(
    x_seq: torch.Tensor,
    v_init: Optional[torch.Tensor] = None,
    params: NeuronParams = NeuronParams(),
):
    """IF neuron over (T, ...) input: (spikes, v_T)."""
    return _scan(x_seq, v_init, params, lambda v, x: v + x)


def plif_scan(
    x_seq: torch.Tensor,
    w: torch.Tensor,
    v_init: Optional[torch.Tensor] = None,
    params: NeuronParams = NeuronParams(),
):
    """Parametric LIF over (T, ...) input (spikingjelly
    ``ParametricLIFNode``): the decay is the tensor ``sigmoid(w)``, so the
    learnable ``w`` gets a gradient. Returns (spikes, v_T)."""
    decay = torch.sigmoid(w)
    p = params
    if p.decay_input:
        return _scan(x_seq, v_init, p, lambda v, x: v + (x - (v - p.v_reset)) * decay)
    return _scan(x_seq, v_init, p, lambda v, x: v - (v - p.v_reset) * decay + x)


def qif_scan(
    x_seq: torch.Tensor,
    v_init: Optional[torch.Tensor] = None,
    params: NeuronParams = NeuronParams(),
    a0: float = 1.0,
    v_c: float = 0.8,
):
    """Quadratic integrate-and-fire (spikingjelly ``QIFNode``):
    H = V + (X + a0 (V - v_reset)(V - v_c)) / tau. Returns (spikes, v_T)."""
    p = params
    return _scan(x_seq, v_init, p,
                 lambda v, x: v + (x + a0 * (v - p.v_reset) * (v - v_c)) * p.decay)


def eif_scan(
    x_seq: torch.Tensor,
    v_init: Optional[torch.Tensor] = None,
    params: NeuronParams = NeuronParams(),
    delta_t: float = 1.0,
    theta_rh: float = 0.8,
):
    """Exponential integrate-and-fire (spikingjelly ``EIFNode``):
    H = V + (X - (V - v_rest) + dT exp((V - theta_rh)/dT)) / tau. Returns
    (spikes, v_T)."""
    p = params
    return _scan(x_seq, v_init, p, lambda v, x: v + (
        x - (v - p.v_reset) + delta_t * torch.exp((v - theta_rh) / delta_t)) * p.decay)


def izhikevich_scan(
    x_seq: torch.Tensor,
    v_init: Optional[torch.Tensor] = None,
    w_init: Optional[torch.Tensor] = None,
    params: NeuronParams = NeuronParams(),
    a: float = 0.02,
    b: float = 0.2,
    v_rest: float = -0.1,
    w_rest: float = 0.0,
    tau_w: float = 2.0,
    a0: float = 1.0,
    v_c: float = 0.8,
):
    """Izhikevich neuron (spikingjelly ``IzhikevichNode``): a quadratic
    membrane with a recovery current w. Returns (spikes, v_T, w_T)."""
    p = params
    xt = x_seq.float()
    v = _initial(x_seq, v_init, p.v_reset)
    w = _initial(x_seq, w_init, w_rest)
    spikes = []
    for t in range(xt.shape[0]):
        h = v + (xt[t] + a0 * (v - v_rest) * (v - v_c) - w) * p.decay
        v, s = fire_and_reset(h, p)
        w = w + (a * (b * (v - v_rest)) - w + w_rest) / tau_w
        spikes.append(s)
    return torch.stack(spikes).to(x_seq.dtype), v, w


def kernel_route(params: NeuronParams) -> bool:
    """Whether ``lif_multi_step`` takes K1 for ``params``: its surrogate
    family is one the kernel computes."""
    return params.surrogate.name in KERNEL_FAMILIES


def lif_multi_step(
    x_seq: torch.Tensor,
    v_init: Optional[torch.Tensor] = None,
    params: NeuronParams = NeuronParams(),
    backend: str = "auto",
) -> torch.Tensor:
    """Multi-step LIF, differentiable; returns the (T, ...) spike train.

    For the atan and sigmoid surrogates, ``backend``: 'cuda' (K1's
    forward and backward kernels; the tensor must lie on a CUDA device),
    'auto' (K1 for a CUDA tensor, its plain versions for a CPU tensor) or
    'torch' (K1's plain versions on either device). Any other family
    takes ``lif_scan`` under 'auto' and 'torch', and raises under 'cuda':
    the route is chosen from ``params`` before anything is launched.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown LIF backend {backend!r}; have {BACKENDS}")
    if backend == "cuda" and not x_seq.is_cuda:
        raise ValueError("LIF backend 'cuda' needs a tensor on a CUDA device")
    if not kernel_route(params):
        if backend == "cuda":
            raise ValueError(f"the LIF kernels take the {list(KERNEL_FAMILIES)} "
                             f"surrogates, not {params.surrogate.name!r}")
        ROUTES["scan"] += 1
        return lif_scan(x_seq, v_init, params)[0]
    # imported here: ops.lif imports this module for NeuronParams
    from spiking_diffusion_tpu_torch.ops.lif import lif

    ROUTES["kernel"] += 1
    return lif(x_seq, v_init, params, reference=backend == "torch")
