"""Graph-wide SNN utilities: conv-BN folding, the TET loss, the chunked
scan and the delay.

Counterparts of ``spiking_diffusion_tpu/snn/functional.py``
(spikingjelly ``functional.py``). The folding works on a port module's
state dict, whose conv -> BN pairs follow one naming rule: ``P.convs.i``
with ``P.bns.i`` (the VQ-VAE's encoder, the denoiser, the classifier
zoo) and ``P.poisson_conv`` with ``P.poisson_bn`` (the quantizer's
re-spike), as the JAX package pairs ``SeqConv_i`` with ``SeqBatchNorm_i``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def fuse_conv_bn(
    weight: torch.Tensor,
    bias: torch.Tensor,
    bn_scale: torch.Tensor,
    bn_bias: torch.Tensor,
    bn_mean: torch.Tensor,
    bn_var: torch.Tensor,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold eval-mode BN(conv(x)) into one conv, in fp32.

    ``weight`` is (Cout, Cin, kh, kw), the BN tensors are per Cout.
    ``s = gamma / sqrt(var + eps)``, ``w' = w * s``, ``b' = (b - mean) * s
    + beta``: the JAX package's operations in its order. The square root
    is taken in fp64 and rounded to fp32, which is the correctly rounded
    fp32 root (XLA's); PyTorch's fp32 ``sqrt`` on the CPU is not always.
    """
    s = bn_scale.float() / torch.sqrt((bn_var.float() + eps).double()).float()
    w = weight.float() * s.reshape((-1,) + (1,) * (weight.ndim - 1))
    return w, (bias.float() - bn_mean.float()) * s + bn_bias.float()


def _bn_of(conv: str) -> Optional[str]:
    """The BN prefix paired with conv prefix ``conv``, or None."""
    parts = conv.split(".")
    if len(parts) >= 2 and parts[-2] == "convs":
        return ".".join(parts[:-2] + ["bns", parts[-1]])
    if parts[-1] == "poisson_conv":
        return ".".join(parts[:-1] + ["poisson_bn"])
    return None


def fuse_model_conv_bn(state_dict: Mapping[str, torch.Tensor],
                       eps: float = 1e-5) -> Dict[str, torch.Tensor]:
    """Fold every conv -> BN pair of a port module's state dict for
    inference.

    Returns a new state dict in which each folded conv holds the BN (a
    bias-free conv gains ``.bias``, as the JAX package's fold adds one)
    and the BN is the identity (scale 1, bias 0, mean 0, var 1).
    """
    out = dict(state_dict)
    for key, weight in state_dict.items():
        if not key.endswith(".weight"):
            continue
        conv = key[: -len(".weight")]
        bn = _bn_of(conv)
        if bn is None or f"{bn}.scale" not in state_dict:
            continue
        bias = state_dict.get(f"{conv}.bias", torch.zeros(weight.shape[0], device=weight.device))
        out[key], out[f"{conv}.bias"] = fuse_conv_bn(
            weight, bias, *(state_dict[f"{bn}.{k}"] for k in ("scale", "bias", "mean", "var")),
            eps)
        for k, fill in (("scale", 1.0), ("bias", 0.0), ("mean", 0.0), ("var", 1.0)):
            out[f"{bn}.{k}"] = torch.full_like(state_dict[f"{bn}.{k}"], fill)
    return out


def folded_conv_params(state_dict: Mapping[str, torch.Tensor],
                       n_blocks: int) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """BN-folded (weight (Cout, Cin, kh, kw), bias) of ``convs.i``, i in
    [0, n_blocks), from :func:`fuse_model_conv_bn`."""
    fused = fuse_model_conv_bn(state_dict)
    out = []
    for i in range(n_blocks):
        w = fused[f"convs.{i}.weight"]
        b = fused.get(f"convs.{i}.bias", torch.zeros(w.shape[0], device=w.device))
        out.append((w, b))
    return out


def temporal_efficient_loss(
    logits_seq: torch.Tensor,
    labels: torch.Tensor,
    loss_fn: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    """TET loss: the mean over T of the per-step loss on (T, N, C) outputs
    (``functional.py:1129-1160``); the default loss is the mean softmax
    cross-entropy over integer labels."""
    if loss_fn is None:
        loss_fn = lambda lg, lb: F.cross_entropy(lg, lb.long())  # noqa: E731
    return torch.stack([loss_fn(lg, labels) for lg in logits_seq]).mean()


def chunked_scan(
    step_fn: Callable[[Any, torch.Tensor], Tuple[Any, torch.Tensor]],
    init: Any,
    x_seq: torch.Tensor,
    chunk: int,
) -> Tuple[Any, torch.Tensor]:
    """Scan ``step_fn(carry, x_t) -> (carry, y_t)`` over T in chunks of
    ``chunk`` steps (``functional.chunk_multi_step_forward``): each chunk
    runs under ``torch.utils.checkpoint``, so the backward recomputes its
    steps instead of keeping them and only the carry crosses chunks.
    Returns (final carry, (T, ...) outputs); the gradients are the plain
    scan's."""
    t = x_seq.shape[0]
    if t % chunk:
        raise ValueError(f"T={t} not divisible by chunk={chunk}")

    def run_chunk(carry, x_chunk):
        ys = []
        for x in x_chunk:
            carry, y = step_fn(carry, x)
            ys.append(y)
        return carry, torch.stack(ys)

    carry, outs = init, []
    for c in range(0, t, chunk):
        carry, ys = checkpoint(run_chunk, carry, x_seq[c:c + chunk], use_reentrant=False)
        outs.append(ys)
    return carry, torch.cat(outs)


def delay(x_seq: torch.Tensor, steps: int) -> torch.Tensor:
    """Shift a (T, ...) sequence ``steps`` later, zeros in front
    (spikingjelly ``layer.Delay``)."""
    if steps == 0:
        return x_seq
    pad = torch.zeros((steps,) + tuple(x_seq.shape[1:]), dtype=x_seq.dtype,
                      device=x_seq.device)
    return torch.cat([pad, x_seq[:-steps]])
