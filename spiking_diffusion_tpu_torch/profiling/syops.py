"""Spike-aware op/energy accounting: counterpart of
``spiking_diffusion_tpu/profiling/syops.py`` (the reference's ``syops``
package).

Per-layer counters classify a layer's traffic as ACs (accumulate-only,
spike-driven) or MACs (multiply-accumulate, analog) by whether its input
is a spike train, beside spike rates, parameter counts and the 0.9 pJ /
4.6 pJ energy model. The counting rules are the JAX package's:

  * conv:    ops = out_elems * k*k*Cin (+ out_elems for the bias), over the
             time steps the conv actually runs (the first encoder conv and
             the denoiser's first conv run once, on a length-1 time axis)
  * BN:      ops = 2 * in_elems
  * LIF:     ops = in_elems, all ACs (membrane adds); rate from the output
  * an input is a spike train if every element is 0 or 1; then
    ACs = ops * rate, else MACs = ops. rate = mean(input).

The JAX modules ``sow`` their counters into a ``syops`` collection. The
port counts the same layers with forward hooks, which
:func:`profile_apply` puts on the model's ``SeqConv``,
``SeqConvTranspose``, ``SeqBatchNorm`` and ``LIF`` modules for one call
and removes again. The neurons that K3 runs in place of a ``LIF`` call
(the 'bnlif' branches' fused BN-apply + LIF) are counted where they run,
by :func:`record_fused`, which does nothing unless a profile is counting
that layer. While profiling, the entries stay on the model's device as
fp32 scalar tensors; :func:`collect` brings them to the host at once.
Each entry has the key the JAX package's ``collect`` gives the same layer
(:data:`FLAX_NAMES`), so reports and records compare key for key.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from spiking_diffusion_tpu_torch.models.layers import (
    LIF,
    SeqBatchNorm,
    SeqConv,
    SeqConvTranspose,
)

# energy per op, picojoules (45 nm CMOS, the convention of the syops-counter
# README and the Spiking-Diffusion paper's energy table)
E_AC_PJ = 0.9
E_MAC_PJ = 4.6

FIELDS = ("ops", "acs", "macs", "rate")
Entry = Dict[str, torch.Tensor]

# the port's layer attributes and module lists -> the name flax gives the
# same layer in the JAX package's modules; "{}" takes the list index, and
# for the denoiser's readout the number of its block convs
FLAX_NAMES = {"convs": "SeqConv_{}", "deconvs": "SeqConvTranspose_{}",
              "bns": "SeqBatchNorm_{}", "lifs": "LIF_{}", "poisson_lif": "asg_lif",
              "readout": "SeqConv_{}"}
# the flax submodule that holds a layer's parameters; flax's name of a
# parameter where it is not the port's
FLAX_VARIABLES = {"convs": "Conv_0", "readout": "Conv_0", "poisson_conv": "Conv_0",
                  "deconvs": "ConvTranspose_0", "bns": "BatchNorm_0",
                  "poisson_bn": "BatchNorm_0"}
FLAX_LEAVES = {"weight": "kernel"}
# where K3 runs a LIF layer the JAX module sows the neuron's counters
# itself, as ``<parent>/counters`` (``counters/i`` when it sows several)
FUSED_COUNTERS = "counters"


def flax_path(name: str, n_convs: int = 0) -> str:
    """The JAX package's module path ('encoder/SeqConv_0') of the port's
    module ``name`` ('encoder.convs.0'); ``n_convs``: the denoiser's block
    convs, whose count names its readout."""
    parts = name.split(".") if name else []
    out, i = [], 0
    while i < len(parts):
        fmt = FLAX_NAMES.get(parts[i], parts[i])
        if parts[i] == "readout":
            out.append(fmt.format(n_convs))
        elif "{}" in fmt:
            i += 1
            out.append(fmt.format(parts[i]))
        else:
            out.append(fmt)
        i += 1
    return "/".join(out)


def flax_param_path(name: str, n_convs: int = 0) -> str:
    """The JAX package's parameter path ('encoder/SeqConv_0/Conv_0/kernel')
    of the port's parameter ``name`` ('encoder.convs.0.weight'): the
    inverse of ``models/weights.py``'s conversion."""
    module, _, leaf = name.rpartition(".")
    parts = module.split(".")
    kind = parts[-2] if parts[-1].isdigit() else parts[-1]
    return "/".join(p for p in (flax_path(module, n_convs), FLAX_VARIABLES.get(kind),
                                FLAX_LEAVES.get(leaf, leaf)) if p)


def n_block_convs(model: nn.Module) -> int:
    """The denoiser's block convs (0 for a model without them)."""
    return len(getattr(model, "convs", ()))


def spike_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(is_spike, rate): is_spike = every element in {0, 1}; rate = the
    mean (the share of ones) if a spike train, else 1.0."""
    xf = x.float()
    is_spike = torch.all((xf == 0.0) | (xf == 1.0))
    return is_spike, torch.where(is_spike, xf.mean(), 1.0)


def _scalar(value: float, device) -> torch.Tensor:
    """An fp32 scalar on ``device``, rounded to fp32 as ``jnp.float32``."""
    return torch.full((), float(np.float32(value)), dtype=torch.float32, device=device)


def classify(ops: float, x_in: torch.Tensor) -> Entry:
    """Split a static op count into ACs and MACs by the input's spike-ness."""
    is_spike, rate = spike_stats(x_in)
    ops_t = _scalar(ops, x_in.device)
    zero = torch.zeros_like(ops_t)
    return {"ops": ops_t, "acs": torch.where(is_spike, ops_t * rate, zero),
            "macs": torch.where(is_spike, zero, ops_t), "rate": rate}


def neuron_entry(x_in: torch.Tensor, s_out: torch.Tensor) -> Entry:
    """LIF accounting: in_elems membrane adds, all ACs; the rate of the
    output spike train."""
    ops = _scalar(x_in.numel(), x_in.device)
    _, rate = spike_stats(s_out)
    return {"ops": ops, "acs": ops, "macs": torch.zeros_like(ops), "rate": rate}


class Profile:
    """The counters of one profiled call of ``model``, by JAX key, one
    entry per call of the layer, in call order."""

    def __init__(self, model: nn.Module):
        n_convs = n_block_convs(model)
        self.names = {m: flax_path(name, n_convs) for name, m in model.named_modules()
                      if not isinstance(m, nn.ModuleList)}
        self.entries: Dict[str, List[Entry]] = {}

    def add(self, key: str, entry: Entry) -> None:
        self.entries.setdefault(key, []).append(entry)

    def count(self, module: nn.Module, args, out) -> None:
        """Forward hook of a counted layer."""
        x = args[0]
        if isinstance(module, LIF):
            entry = neuron_entry(x, out)
        elif isinstance(module, SeqBatchNorm):
            entry = classify(2.0 * x.numel(), x)  # affine BN: 2 ops per element
        else:
            y = out[0] if isinstance(out, tuple) else out  # K4 also returns BN moments
            w = module.weight  # conv (Cout, Cin, k, k); transposed (Cin, Cout, k, k)
            in_ch = w.shape[0] if isinstance(module, SeqConvTranspose) else w.shape[1]
            n = float(y.numel())
            entry = classify(n * w.shape[2] * w.shape[3] * in_ch + n, x)
        self.add(f"{self.names[module]}/counters", entry)


COUNTED = (SeqConv, SeqConvTranspose, SeqBatchNorm, LIF)


def record_fused(lif: LIF, spikes: torch.Tensor) -> None:
    """Count the neuron layer that K3 ran in place of ``lif``, with its
    output spike train, under its parent's ``counters``: nothing unless a
    profile is counting ``lif``'s model."""
    profile = lif.profile
    if profile is None:
        return
    parent = profile.names[lif].rpartition("/")[0]
    key = f"{parent}/{FUSED_COUNTERS}" if parent else FUSED_COUNTERS
    profile.add(key, neuron_entry(spikes, spikes))


def collect(profile: Profile) -> Dict[str, Dict[str, float]]:
    """The profile's entries on the host, in one transfer: {JAX key:
    {ops, acs, macs, rate}}, in flax's key order; a key counted more than
    once gets one entry per call, ``key/i``, as flax's ``sow`` gives."""
    flat = {}
    for key, entries in profile.entries.items():
        if len(entries) == 1:
            flat[key] = entries[0]
        else:
            flat.update((f"{key}/{i}", e) for i, e in enumerate(entries))
    keys = sorted(flat, key=lambda k: k.split("/"))
    if not keys:
        return {}
    values = torch.stack([flat[k][f] for k in keys for f in FIELDS]).cpu().tolist()
    return {k: dict(zip(FIELDS, values[i * len(FIELDS):(i + 1) * len(FIELDS)]))
            for i, k in enumerate(keys)}


def totals(per_layer: Dict[str, Dict[str, float]]) -> Dict[str, float]:
    ops = sum(e["ops"] for e in per_layer.values())
    acs = sum(e["acs"] for e in per_layer.values())
    macs = sum(e["macs"] for e in per_layer.values())
    rates = [e["rate"] for e in per_layer.values()]
    return {
        "ops": ops,
        "acs": acs,
        "macs": macs,
        "mean_spike_rate": float(np.mean(rates)) if rates else 1.0,
        "energy_mJ": (acs * E_AC_PJ + macs * E_MAC_PJ) * 1e-9,
    }


def count_params(model: nn.Module) -> int:
    """The model's parameters, what flax counts as ``params`` (BN's running
    statistics are buffers)."""
    return int(sum(p.numel() for p in model.parameters()))


def profile_apply(model: nn.Module, *args: Any, method: Optional[str] = None,
                  **kwargs: Any):
    """Run ``model(*args, **kwargs)``, or its ``method``, without autograd,
    counting every layer. Returns (output, per_layer, totals). The model's
    own hooks and every module's train/eval mode are left as they were."""
    profile = Profile(model)
    modes = {m: m.training for m in model.modules()}
    handles = []
    try:
        for m in model.modules():
            if isinstance(m, COUNTED):
                handles.append(m.register_forward_hook(profile.count))
            if isinstance(m, LIF):
                m.profile = profile
        fn = model if method is None else getattr(model, method)
        with torch.no_grad():
            out = fn(*args, **kwargs)
    finally:
        for handle in handles:
            handle.remove()
        for m, training in modes.items():
            m.training = training
            if isinstance(m, LIF):
                m.profile = None
    per_layer = collect(profile)
    return out, per_layer, totals(per_layer)


def profile_dataset(model: nn.Module, batches: Iterable[Any], **kwargs: Any):
    """Average the counters over a loader, the reference's protocol (accrue
    per batch, divide by the batch count). Each batch is the first
    positional argument of :func:`profile_apply`, which takes ``kwargs``.
    Returns (per_layer averaged, totals averaged)."""
    acc: Dict[str, Dict[str, float]] = {}
    n = 0
    for batch in batches:
        _, per_layer, _ = profile_apply(model, batch, **kwargs)
        for k, e in per_layer.items():
            slot = acc.setdefault(k, {kk: 0.0 for kk in e})
            for kk, v in e.items():
                slot[kk] += v
        n += 1
    if n == 0:
        return {}, totals({})
    per_layer = {k: {kk: v / n for kk, v in e.items()} for k, e in acc.items()}
    return per_layer, totals(per_layer)


def format_report(
    per_layer: Dict[str, Dict[str, float]],
    total: Dict[str, float],
    n_params: int,
) -> str:
    """Per-layer table, the JAX package's (``syops/engine.py:104-165``)."""
    lines = [
        f"{'layer':60s} {'Ops':>14s} {'ACs':>14s} {'MACs':>14s} {'rate%':>7s}"
    ]
    for name, e in sorted(per_layer.items()):
        lines.append(
            f"{name:60s} {e['ops']:14.3e} {e['acs']:14.3e} "
            f"{e['macs']:14.3e} {e['rate'] * 100:6.2f}%"
        )
    lines.append("-" * 112)
    lines.append(
        f"{'TOTAL':60s} {total['ops']:14.3e} {total['acs']:14.3e} "
        f"{total['macs']:14.3e} {total['mean_spike_rate'] * 100:6.2f}%"
    )
    lines.append(
        f"params: {n_params:,}   estimated energy: "
        f"{total['energy_mJ']:.4f} mJ  (ACs*{E_AC_PJ} + MACs*{E_MAC_PJ} pJ)"
    )
    return "\n".join(lines)


def default_probe_steps(d_cfg) -> Tuple[int, ...]:
    """5 probes spread over the schedule, from the config (a fixed list
    would probe t > num_timesteps on a shorter schedule)."""
    t_max = d_cfg.num_timesteps
    return tuple(sorted({max(1, round(t_max * f)) for f in (1.0, 0.75, 0.5, 0.25, 0.02)},
                        reverse=True))


def generation_energy(denoiser, model, d_cfg, generator: torch.Generator,
                      n_samples: int = 64, probe_steps: Optional[Sequence[int]] = None,
                      device="cuda") -> Dict[str, float]:
    """Spike-aware op/energy estimate of ONE generated image through the
    whole pipeline: ``num_timesteps`` denoiser forwards and the VQ decode.

    Samples ``n_samples`` code grids with the layerwise sampler at
    temperature 0.8, re-corrupts them at the probe timesteps (the
    sampler's state at step t is "codes masked with probability t/T"),
    both from ``generator``, then :func:`probe_energy`. Runs on the card
    unless ``device="cpu"`` is passed; the models lie on that device.
    """
    from spiking_diffusion_tpu_torch.device import resolve_device
    from spiking_diffusion_tpu_torch.generate import sample_codes
    from spiking_diffusion_tpu_torch.models import diffusion

    dev = resolve_device(device)
    if probe_steps is None:
        probe_steps = default_probe_steps(d_cfg)
    codes = sample_codes(denoiser, d_cfg, n_samples, temperature=0.8, generator=generator,
                         device=dev)
    probes = []
    for t in probe_steps:
        t_vec = torch.full((n_samples,), t, dtype=torch.int32, device=dev)
        u = torch.rand(codes.shape, generator=generator, device=dev)
        x_t, _, _ = diffusion.q_sample(codes, t_vec, d_cfg.mask_id, d_cfg.num_timesteps, u)
        probes.append((x_t, t_vec))
    return probe_energy(denoiser, model, d_cfg, codes, probes)


def probe_energy(denoiser, model, d_cfg, codes: torch.Tensor,
                 probes: Sequence[Tuple[torch.Tensor, torch.Tensor]]) -> Dict[str, float]:
    """The energy estimate from sampled ``codes`` (N, h, w) and the probe
    states ``(x_t, t)``: the denoiser's counters (in eval) averaged over
    the probes and scaled by ``num_timesteps``, plus one
    ``decode_indices`` of the codes, per image. Returns ``acs_per_img``,
    ``macs_per_img``, ``energy_uJ_per_img`` and ``denoiser_spike_rate``."""
    den_tot = {"ops": 0.0, "acs": 0.0, "macs": 0.0, "rate": 0.0}
    was = denoiser.training
    denoiser.eval()
    try:
        for x_t, t_vec in probes:
            _, _, tot = profile_apply(denoiser, x_t, t_vec)
            den_tot["ops"] += tot["ops"]
            den_tot["acs"] += tot["acs"]
            den_tot["macs"] += tot["macs"]
            den_tot["rate"] += tot["mean_spike_rate"]
    finally:
        denoiser.train(was)
    n_probe = len(probes)
    for k in den_tot:
        den_tot[k] /= n_probe

    _, _, dec_tot = profile_apply(model, codes, method="decode_indices")

    n_samples = codes.shape[0]
    steps = d_cfg.num_timesteps
    acs = (den_tot["acs"] * steps + dec_tot["acs"]) / n_samples
    macs = (den_tot["macs"] * steps + dec_tot["macs"]) / n_samples
    return {
        "acs_per_img": acs,
        "macs_per_img": macs,
        "energy_uJ_per_img": (acs * E_AC_PJ + macs * E_MAC_PJ) * 1e-6,
        "denoiser_spike_rate": den_tot["rate"],
    }
