"""Lava-DL netx-format HDF5 export (neuromorphic deployment).

Counterpart of ``spiking_diffusion_tpu/models/lava_export.py``
(spikingjelly ``activation_based/lava_exchange.py``), writing the same
schema from the port's modules: ``/layer/<i>/`` groups with ``type``,
``shape``, ``weight``, ``bias``, the conv or dense attributes and a
``neuron`` group, loadable by ``lava.lib.dl.netx.hdf5.Network`` on a host
that has Lava.

The app's LIF (v_reset = 0, hard reset) maps to a Lava CUBA neuron with
``current_decay = 1`` and ``voltage_decay = 1/tau``; its ``decay_input``
charge ``H = V + (X - V)/tau = (1 - 1/tau) V + X/tau`` is a
non-decay-input charge on synapse weights scaled by 1/tau, which the
writer folds in (where the reference rejects ``decay_input=True``).
Device parameters follow lava-dl's CUBA fixed point (p_scale 1 << 12 for
the decay mantissas, w_scale 1 << 6 for the threshold's). BatchNorm is
folded into the preceding conv (eval semantics) by
``snn/functional.folded_conv_params``, whose (Cout, Cin, kh, kw) weights
are netx's layout already; the datasets agree with JAX's to the fold's
fp32 rounding.

``h5py`` is imported only inside the writing functions: the module
imports without it, and the writers run on a host that has it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spiking_diffusion_tpu_torch.snn.functional import folded_conv_params
from spiking_diffusion_tpu_torch.snn.neuron import NeuronParams

P_SCALE = 1 << 12  # decay mantissa scale (lava_exchange.py:345-348)
W_SCALE = 1 << 6  # threshold mantissa scale (lava_exchange.py:335-343)


@dataclasses.dataclass
class NetxLayer:
    """One netx layer: a synapse (conv/dense/input) + optional CUBA neuron."""

    kind: str  # 'input' | 'conv' | 'dense'
    shape: Tuple[int, ...]  # output neuron shape (H, W, C) or (F,)
    weight: Optional[np.ndarray] = None  # conv: (out,in,kh,kw); dense: (out,in)
    bias: Optional[np.ndarray] = None
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (0, 0)
    dilation: Tuple[int, int] = (1, 1)
    groups: int = 1
    neuron: Optional[NeuronParams] = None


def cuba_device_params(p: NeuronParams) -> Dict[str, Any]:
    """LIF -> Lava CUBA fixed-point device params (see module docstring)."""
    if p.v_reset != 0.0:
        raise ValueError("lava only supports v_reset == 0 "
                         "(lava_exchange.py:578-579)")
    if not p.hard_reset:
        raise ValueError("Lava CUBA resets to 0 on spike (hard reset); "
                         "soft-reset neurons cannot be exported")
    return {
        "type": "CUBA",
        "iDecay": int(round(1.0 * P_SCALE)),  # current_decay = 1
        "vDecay": int(round((1.0 / p.tau) * P_SCALE)),
        "vThMant": int(round(p.v_threshold * W_SCALE)),
        "refDelay": 1,
        "gradedSpike": False,
    }


def input_weight_scale(p: NeuronParams) -> float:
    """The 1/tau synapse-weight fold that converts decay_input=True into
    Lava's (decay_input=False) CUBA charge equation exactly."""
    return (1.0 / p.tau) if p.decay_input else 1.0


def export_netx_hdf5(path: str, layers: Sequence[NetxLayer]) -> str:
    """Write ``layers`` to ``path`` in the netx HDF5 schema; returns path."""
    import h5py

    with h5py.File(path, "w") as f:
        root = f.create_group("layer")
        for i, layer in enumerate(layers):
            g = root.create_group(str(i))
            g.create_dataset("type", data=np.bytes_(layer.kind))
            g.create_dataset("shape", data=np.asarray(layer.shape, np.int64))
            if layer.weight is not None:
                w = np.asarray(layer.weight, np.float32)
                if layer.neuron is not None:
                    w = w * input_weight_scale(layer.neuron)
                g.create_dataset("weight", data=w)
            if layer.bias is not None:
                b = np.asarray(layer.bias, np.float32)
                if layer.neuron is not None:
                    b = b * input_weight_scale(layer.neuron)
                g.create_dataset("bias", data=b)
            if layer.kind == "conv":
                g.create_dataset("stride", data=np.asarray(layer.stride, np.int64))
                g.create_dataset("padding", data=np.asarray(layer.padding, np.int64))
                g.create_dataset("dilation", data=np.asarray(layer.dilation, np.int64))
                g.create_dataset("groups", data=np.int64(layer.groups))
            if layer.kind == "dense" and layer.weight is not None:
                g.create_dataset("inFeatures", data=np.int64(layer.weight.shape[1]))
                g.create_dataset("outFeatures", data=np.int64(layer.weight.shape[0]))
            if layer.neuron is not None:
                ng = g.create_group("neuron")
                for k, v in cuba_device_params(layer.neuron).items():
                    if isinstance(v, str):
                        ng.create_dataset(k, data=np.bytes_(v))
                    else:
                        ng.create_dataset(k, data=v)
    return path


def _folded_conv_blocks(module: torch.nn.Module,
                        n_blocks: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """(weight (Cout, Cin, kh, kw), bias) of ``convs.i`` with ``bns.i``
    folded in, as fp32 numpy."""
    state = {k: v.detach().cpu() for k, v in module.state_dict().items()}
    return [(w.numpy().astype(np.float32), b.numpy().astype(np.float32))
            for w, b in folded_conv_params(state, n_blocks)]


def denoiser_to_netx(denoiser: torch.nn.Module, cfg, path: str) -> str:
    """Export a trained port ``SpikingDenoiser`` to netx HDF5.

    Emits input + the conv/CUBA blocks + the readout conv (no neuron),
    whose BN-free weight goes as it is. The U-Net skip concat is not
    representable in the sequential netx schema: the readout's weight
    keeps both halves, and the skip topology is the root group's ``skip``
    attribute, with a ``note`` in the file saying so.
    """
    import h5py

    hw = cfg.latent_size
    p = cfg.lif.to_params()
    channels = tuple(cfg.denoiser_channels)
    blocks = _folded_conv_blocks(denoiser, len(channels))
    layers = [NetxLayer("input", (hw, hw, 2))]
    for (k, b), ch in zip(blocks, channels):
        layers.append(NetxLayer("conv", (hw, hw, ch), weight=k, bias=b,
                                stride=(1, 1), padding=(1, 1), neuron=p))
    kf = denoiser.readout.weight.detach().cpu().numpy().astype(np.float32)
    bf = denoiser.readout.bias.detach().cpu().numpy().astype(np.float32)
    layers.append(NetxLayer("conv", (hw, hw, kf.shape[0]), weight=kf, bias=bf,
                            stride=(1, 1), padding=(1, 1), neuron=None))
    export_netx_hdf5(path, layers)
    with h5py.File(path, "a") as f:
        # concat(layer len(channels) out, layer 1 out) feeds the readout
        f["layer"].attrs["skip"] = np.asarray([len(channels), 1], np.int64)
        f.attrs["note"] = np.bytes_(
            "final conv consumes concat(layer%d, layer1) per the root "
            "'skip' attr; sequential netx loaders without lateral-wiring "
            "support cannot load the last layer (in-channel mismatch)."
            % len(channels)
        )
    return path


def encoder_to_netx(vqvae: torch.nn.Module, cfg, path: str) -> str:
    """Export a port ``SNNVQVAE``'s encoder (3 strided Conv+BN+LIF blocks,
    ``vae_model.py:101-129``) to netx HDF5."""
    p = cfg.lif.to_params()
    specs = [  # (stride, padding, out hw): 28 -> 14 -> 7 -> 7
        ((2, 2), (1, 1), 14),
        ((2, 2), (1, 1), 7),
        ((1, 1), (0, 0), 7),
    ]
    chs = tuple(cfg.enc_channels) + (cfg.embedding_dim,)
    blocks = _folded_conv_blocks(vqvae.encoder, len(chs))
    layers = [NetxLayer("input", (28, 28, 1))]
    for i, ((k, b), ch) in enumerate(zip(blocks, chs)):
        stride, pad, out_hw = specs[min(i, len(specs) - 1)]
        layers.append(NetxLayer("conv", (out_hw, out_hw, ch), weight=k, bias=b,
                                stride=stride, padding=pad, neuron=p))
    return export_netx_hdf5(path, layers)
