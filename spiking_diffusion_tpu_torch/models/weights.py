"""Weights between the JAX package's variable trees and the port's modules.

The JAX package stores flax ``params`` / ``batch_stats`` trees (as numpy
from ``train/checkpoint.py`` ``load_variables``). The layout rules:

* Conv: flax (H, W, Cin, Cout) -> torch (Cout, Cin, H, W).
* ConvTranspose: flax (H, W, Cin, Cout) -> torch (Cin, Cout, H, W),
  spatially flipped: flax's explicit-padding ``conv_transpose`` does not
  mirror the kernel, torch's transposed convolution does.
* BatchNorm: ``scale``/``bias``/``mean``/``var`` as they are.
* Codebook: (K, D) as it is.

``init_*_variables`` make seeded random trees in the flax layout with
the JAX package's initialisers (``utils/init.py``: torch-default kaiming
uniform kernels, uniform +-1/sqrt(fan_in) biases, N(0, 1) codebook, BN
at identity), so a random model goes through the same conversion as a
trained one.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from spiking_diffusion_tpu_torch.config import DiffusionConfig, VQVAEConfig
from spiking_diffusion_tpu_torch.device import resolve_device
from spiking_diffusion_tpu_torch.models.denoiser import SpikingDenoiser
from spiking_diffusion_tpu_torch.models.layers import SeqBatchNorm
from spiking_diffusion_tpu_torch.models.vqvae import SNNVQVAE

Tree = Mapping[str, Any]


def conv_weight(kernel) -> np.ndarray:
    """flax Conv kernel (H, W, Cin, Cout) -> torch (Cout, Cin, H, W)."""
    return np.ascontiguousarray(
        np.transpose(np.asarray(kernel, np.float32), (3, 2, 0, 1)))


def deconv_weight(kernel) -> np.ndarray:
    """flax ConvTranspose kernel (H, W, Cin, Cout) -> torch
    (Cin, Cout, H, W), spatially flipped."""
    k = np.transpose(np.asarray(kernel, np.float32), (2, 3, 0, 1))
    return np.ascontiguousarray(k[:, :, ::-1, ::-1])


def _conv(prefix: str, node: Tree, deconv: bool = False) -> Dict[str, np.ndarray]:
    to_torch = deconv_weight if deconv else conv_weight
    return {f"{prefix}.weight": to_torch(node["kernel"]),
            f"{prefix}.bias": np.asarray(node["bias"], np.float32)}


def _bn(prefix: str, params: Tree, stats: Tree) -> Dict[str, np.ndarray]:
    return {f"{prefix}.scale": np.asarray(params["scale"], np.float32),
            f"{prefix}.bias": np.asarray(params["bias"], np.float32),
            f"{prefix}.mean": np.asarray(stats["mean"], np.float32),
            f"{prefix}.var": np.asarray(stats["var"], np.float32)}


def denoiser_state_dict(params: Tree, batch_stats: Tree,
                        cfg: DiffusionConfig) -> Dict[str, np.ndarray]:
    """flax ``SpikingDenoiser`` variables -> the port's state dict."""
    n = len(cfg.denoiser_channels)
    sd = {}
    for i in range(n):
        sd.update(_conv(f"convs.{i}", params[f"SeqConv_{i}"]["Conv_0"]))
        bn = f"SeqBatchNorm_{i}"
        sd.update(_bn(f"bns.{i}", params[bn]["BatchNorm_0"],
                      batch_stats[bn]["BatchNorm_0"]))
    sd.update(_conv("readout", params[f"SeqConv_{n}"]["Conv_0"]))
    return sd


def vqvae_decode_state_dict(params: Tree,
                            batch_stats: Tree) -> Dict[str, np.ndarray]:
    """flax ``SNNVQVAE`` variables -> the port's decode-half state dict.

    The encoder's variables are not read."""
    vq, vq_stats = params["vq_layer"], batch_stats["vq_layer"]
    dec, dec_stats = params["decoder"], batch_stats["decoder"]
    sd = {"vq_layer.embeddings": np.asarray(vq["embeddings"], np.float32)}
    sd.update(_conv("vq_layer.poisson_conv", vq["poisson_conv"]["Conv_0"]))
    sd.update(_bn("vq_layer.poisson_bn", vq["poisson_bn"]["BatchNorm_0"],
                  vq_stats["poisson_bn"]["BatchNorm_0"]))
    for j in range(3):
        sd.update(_conv(f"decoder.deconvs.{j}",
                        dec[f"SeqConvTranspose_{j}"]["ConvTranspose_0"],
                        deconv=True))
    for j in range(2):
        bn = f"SeqBatchNorm_{j}"
        sd.update(_bn(f"decoder.bns.{j}", dec[bn]["BatchNorm_0"],
                      dec_stats[bn]["BatchNorm_0"]))
    return sd


def _load(module: torch.nn.Module, sd: Dict[str, np.ndarray], device,
          train: bool = False):
    module.load_state_dict({k: torch.from_numpy(np.array(v))
                            for k, v in sd.items()}, strict=True)
    return module.to(resolve_device(device)).train(train)


def load_denoiser(params: Tree, batch_stats: Tree,
                  cfg: DiffusionConfig = DiffusionConfig(), device="cuda",
                  lif_backend: str = "auto", train: bool = False,
                  dtype: Optional[torch.dtype] = None) -> SpikingDenoiser:
    """The port's denoiser on ``device`` from flax variables, in eval mode
    or, with ``train``, in training mode. ``lif_backend`` picks the branch
    (``SpikingDenoiser``): layerwise 'auto', fused 'bnlif' or 'bnlifconv';
    ``dtype`` None or ``torch.bfloat16`` its compute type. The parameters
    stay fp32 and convert alike on every branch."""
    return _load(SpikingDenoiser(cfg, lif_backend, dtype),
                 denoiser_state_dict(params, batch_stats, cfg), device, train)


def load_vqvae(params: Tree, batch_stats: Tree,
               cfg: VQVAEConfig = VQVAEConfig(), device="cuda",
               lif_backend: str = "auto") -> SNNVQVAE:
    """The port's VQ-VAE decode half, in eval mode on ``device``."""
    return _load(SNNVQVAE(cfg, lif_backend),
                 vqvae_decode_state_dict(params, batch_stats), device)


@torch.no_grad()
def calibrate_batchnorm(module: torch.nn.Module, run) -> None:
    """Set each BatchNorm's running statistics to those of its own input
    during one call of ``run()``, as a training pass's batch statistics
    would be: each layer sees the output of the layers set before it.
    Keeps the LIF layers of a random init firing."""

    def set_stats(bn, args):
        x = args[0].float()
        dims = [d for d in range(x.ndim) if d != 1]
        bn.mean.copy_(x.mean(dims))
        bn.var.copy_(x.var(dims, unbiased=False))

    handles = [m.register_forward_pre_hook(set_stats) for m in module.modules()
               if isinstance(m, SeqBatchNorm)]
    try:
        run()
    finally:
        for handle in handles:
            handle.remove()


# --- seeded random variables in the flax layout ---------------------------


def _uniform(g: torch.Generator, shape, bound: float) -> np.ndarray:
    u = torch.rand(shape, generator=g, dtype=torch.float32)
    return ((u * 2.0 - 1.0) * bound).numpy()


def _conv_vars(g, k: int, cin: int, cout: int, bias_fan_in: int) -> Dict:
    return {"kernel": _uniform(g, (k, k, cin, cout), math.sqrt(1.0 / (k * k * cin))),
            "bias": _uniform(g, (cout,), 1.0 / math.sqrt(bias_fan_in))}


def _bn_vars(c: int) -> Tuple[Dict, Dict]:
    return ({"BatchNorm_0": {"scale": np.ones(c, np.float32),
                             "bias": np.zeros(c, np.float32)}},
            {"BatchNorm_0": {"mean": np.zeros(c, np.float32),
                             "var": np.ones(c, np.float32)}})


def init_denoiser_variables(cfg: DiffusionConfig,
                            generator: torch.Generator) -> Tuple[Dict, Dict]:
    """Random flax-layout (params, batch_stats) of a ``SpikingDenoiser``."""
    chans = tuple(cfg.denoiser_channels)
    params, stats = {}, {}
    for i, (cin, cout) in enumerate(zip((2,) + chans[:-1], chans)):
        params[f"SeqConv_{i}"] = {
            "Conv_0": _conv_vars(generator, 3, cin, cout, 9 * cin)}
        params[f"SeqBatchNorm_{i}"], stats[f"SeqBatchNorm_{i}"] = _bn_vars(cout)
    cin = chans[-1] + chans[0]
    params[f"SeqConv_{len(chans)}"] = {"Conv_0": _conv_vars(
        generator, 3, cin, cfg.num_embeddings, 9 * cin)}
    return params, stats


def init_vqvae_decode_variables(cfg: VQVAEConfig,
                                generator: torch.Generator) -> Tuple[Dict, Dict]:
    """Random flax-layout variables of the ``SNNVQVAE`` decode half."""
    d = cfg.embedding_dim
    emb = torch.randn((cfg.num_embeddings, d), generator=generator).numpy()
    pbn, pbn_stats = _bn_vars(d)
    vq = {"embeddings": emb,
          "poisson_conv": {"Conv_0": _conv_vars(generator, 1, d, d, d)},
          "poisson_bn": pbn}
    dec, dec_stats = {}, {}
    chans = (d,) + tuple(cfg.dec_channels) + (cfg.in_channels,)
    for j, (cin, cout) in enumerate(zip(chans[:-1], chans[1:])):
        # torch ConvTranspose2d's bias fan-in is Cout * k * k
        dec[f"SeqConvTranspose_{j}"] = {
            "ConvTranspose_0": _conv_vars(generator, 3, cin, cout, 9 * cout)}
        if j < 2:
            dec[f"SeqBatchNorm_{j}"], dec_stats[f"SeqBatchNorm_{j}"] = _bn_vars(cout)
    return ({"vq_layer": vq, "decoder": dec},
            {"vq_layer": {"poisson_bn": pbn_stats}, "decoder": dec_stats})
