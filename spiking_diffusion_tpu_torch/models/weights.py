"""Weights between the JAX package's variable trees and the port's modules.

The JAX package stores flax ``params`` / ``batch_stats`` trees (as numpy
from ``train/checkpoint.py`` ``load_variables``). The layout rules:

* Conv: flax (H, W, Cin, Cout) -> torch (Cout, Cin, H, W).
* ConvTranspose: flax (H, W, Cin, Cout) -> torch (Cin, Cout, H, W),
  spatially flipped: flax's explicit-padding ``conv_transpose`` does not
  mirror the kernel, torch's transposed convolution does.
* Dense: flax (in, out) -> ``nn.Linear`` (out, in).
* BatchNorm: ``scale``/``bias``/``mean``/``var`` as they are.
* Codebook: (K, D) as it is; the readout blend ``alpha`` a 0-d scalar.

Models: the spiking VQ-VAE (``vqvae_*``), the denoiser (``denoiser_*``)
and the two baselines of the CLI's ``--model``, the ANN VQ-VAE
(``ann_vqvae_*``, no BatchNorm) and the SNN-VAE (``snn_vae_*``, the
VQ-VAE's encoder and decoder around Dense heads and the posterior's and
prior's 3-layer Dense stacks).

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

from spiking_diffusion_tpu_torch.config import DiffusionConfig, SNNVAEConfig, VQVAEConfig
from spiking_diffusion_tpu_torch.device import resolve_device
from spiking_diffusion_tpu_torch.models.ann_vqvae import ANNVQVAE
from spiking_diffusion_tpu_torch.models.denoiser import SpikingDenoiser
from spiking_diffusion_tpu_torch.models.layers import SeqBatchNorm
from spiking_diffusion_tpu_torch.models.snn_vae import SNNVAE
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


def _dense(prefix: str, node: Tree) -> Dict[str, np.ndarray]:
    return {f"{prefix}.weight": np.ascontiguousarray(np.asarray(node["kernel"], np.float32).T),
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


def _encoder_state_dict(enc: Tree, enc_stats: Tree) -> Dict[str, np.ndarray]:
    sd = {}
    for i in range(3):
        sd.update(_conv(f"encoder.convs.{i}", enc[f"SeqConv_{i}"]["Conv_0"]))
        bn = f"SeqBatchNorm_{i}"
        sd.update(_bn(f"encoder.bns.{i}", enc[bn]["BatchNorm_0"],
                      enc_stats[bn]["BatchNorm_0"]))
    return sd


def _decoder_state_dict(dec: Tree, dec_stats: Tree) -> Dict[str, np.ndarray]:
    sd = {}
    for j in range(3):
        sd.update(_conv(f"decoder.deconvs.{j}",
                        dec[f"SeqConvTranspose_{j}"]["ConvTranspose_0"],
                        deconv=True))
    for j in range(2):
        bn = f"SeqBatchNorm_{j}"
        sd.update(_bn(f"decoder.bns.{j}", dec[bn]["BatchNorm_0"],
                      dec_stats[bn]["BatchNorm_0"]))
    return sd


def vqvae_state_dict(params: Tree, batch_stats: Tree) -> Dict[str, np.ndarray]:
    """flax ``SNNVQVAE`` variables -> the port's state dict: the encoder,
    the quantizer (codebook, readout blend ``alpha``, re-spike) and the
    decoder."""
    vq, vq_stats = params["vq_layer"], batch_stats["vq_layer"]
    sd = _encoder_state_dict(params["encoder"], batch_stats["encoder"])
    sd["vq_layer.embeddings"] = np.asarray(vq["embeddings"], np.float32)
    sd["vq_layer.alpha"] = np.asarray(vq["alpha"], np.float32).reshape(())
    sd.update(_conv("vq_layer.poisson_conv", vq["poisson_conv"]["Conv_0"]))
    sd.update(_bn("vq_layer.poisson_bn", vq["poisson_bn"]["BatchNorm_0"],
                  vq_stats["poisson_bn"]["BatchNorm_0"]))
    sd.update(_decoder_state_dict(params["decoder"], batch_stats["decoder"]))
    return sd


def ann_vqvae_state_dict(params: Tree) -> Dict[str, np.ndarray]:
    """flax ``ANNVQVAE`` parameters (it has no batch statistics) -> the
    port's state dict."""
    sd = {"embeddings": np.asarray(params["embeddings"], np.float32)}
    for name in ("enc1", "enc2", "enc3"):
        sd.update(_conv(name, params[name]))
    for name in ("dec1", "dec2", "dec3"):
        sd.update(_conv(name, params[name], deconv=True))
    return sd


def snn_vae_state_dict(params: Tree, batch_stats: Tree) -> Dict[str, np.ndarray]:
    """flax ``SNNVAE`` variables -> the port's state dict: the encoder,
    the Dense heads, the posterior's and prior's Dense stacks and the
    decoder."""
    sd = _encoder_state_dict(params["encoder"], batch_stats["encoder"])
    sd.update(_decoder_state_dict(params["decoder"], batch_stats["decoder"]))
    for name in ("before_latent", "decoder_input"):
        sd.update(_dense(name, params[name]))
    for cell in ("posterior", "prior"):
        for i in range(3):
            sd.update(_dense(f"{cell}.mlp.denses.{i}", params[cell]["mlp"][f"dense_{i}"]))
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
               lif_backend: str = "auto", train: bool = False,
               dtype: Optional[torch.dtype] = None) -> SNNVQVAE:
    """The port's whole VQ-VAE on ``device`` from flax variables, in eval
    mode or, with ``train``, in training mode. ``lif_backend`` picks the
    branch (``SNNVQVAE``): layerwise 'auto' or fused 'bnlif'; ``dtype``
    None or ``torch.bfloat16`` the encoder's and decoder's compute type.
    The parameters stay fp32 and convert alike on every branch."""
    return _load(SNNVQVAE(cfg, lif_backend, dtype),
                 vqvae_state_dict(params, batch_stats), device, train)


def load_ann_vqvae(params: Tree, cfg: VQVAEConfig = VQVAEConfig(), device="cuda",
                   train: bool = False) -> ANNVQVAE:
    """The port's ANN VQ-VAE on ``device`` from flax parameters, in eval
    mode or, with ``train``, in training mode; fp32."""
    return _load(ANNVQVAE(cfg), ann_vqvae_state_dict(params), device, train)


def load_snn_vae(params: Tree, batch_stats: Tree, cfg: SNNVAEConfig = SNNVAEConfig(),
                 vq_cfg: VQVAEConfig = VQVAEConfig(), device="cuda",
                 lif_backend: str = "auto", train: bool = False) -> SNNVAE:
    """The port's SNN-VAE on ``device`` from flax variables, in eval mode
    or, with ``train``, in training mode. ``lif_backend`` picks the
    encoder's and decoder's branch (``SNNVAE``): layerwise 'auto' or fused
    'bnlif'; fp32."""
    return _load(SNNVAE(cfg, vq_cfg, lif_backend), snn_vae_state_dict(params, batch_stats),
                 device, train)


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


def _dense_vars(g, fan_in: int, out: int, bias_fan_in: int) -> Dict:
    return {"kernel": _uniform(g, (fan_in, out), math.sqrt(1.0 / fan_in)),
            "bias": _uniform(g, (out,), 1.0 / math.sqrt(bias_fan_in))}


def _decoder_vars(cfg: VQVAEConfig, generator: torch.Generator) -> Tuple[Dict, Dict]:
    dec, dec_stats = {}, {}
    chans = (cfg.embedding_dim,) + tuple(cfg.dec_channels) + (cfg.in_channels,)
    for j, (cin, cout) in enumerate(zip(chans[:-1], chans[1:])):
        # torch ConvTranspose2d's bias fan-in is Cout * k * k
        dec[f"SeqConvTranspose_{j}"] = {
            "ConvTranspose_0": _conv_vars(generator, 3, cin, cout, 9 * cout)}
        if j < 2:
            dec[f"SeqBatchNorm_{j}"], dec_stats[f"SeqBatchNorm_{j}"] = _bn_vars(cout)
    return dec, dec_stats


def _encoder_vars(cfg: VQVAEConfig, generator: torch.Generator) -> Tuple[Dict, Dict]:
    enc, enc_stats = {}, {}
    chans = (cfg.in_channels,) + tuple(cfg.enc_channels) + (cfg.embedding_dim,)
    for i, (cin, cout) in enumerate(zip(chans[:-1], chans[1:])):
        k = 1 if i == 2 else 3
        enc[f"SeqConv_{i}"] = {"Conv_0": _conv_vars(generator, k, cin, cout, k * k * cin)}
        enc[f"SeqBatchNorm_{i}"], enc_stats[f"SeqBatchNorm_{i}"] = _bn_vars(cout)
    return enc, enc_stats


def init_vqvae_variables(cfg: VQVAEConfig,
                         generator: torch.Generator) -> Tuple[Dict, Dict]:
    """Random flax-layout (params, batch_stats) of a whole ``SNNVQVAE``:
    the decode half's draws first, then the encoder's."""
    d = cfg.embedding_dim
    emb = torch.randn((cfg.num_embeddings, d), generator=generator).numpy()
    pbn, pbn_stats = _bn_vars(d)
    vq = {"embeddings": emb, "alpha": np.asarray(0.5, np.float32),
          "poisson_conv": {"Conv_0": _conv_vars(generator, 1, d, d, d)},
          "poisson_bn": pbn}
    dec, dec_stats = _decoder_vars(cfg, generator)
    enc, enc_stats = _encoder_vars(cfg, generator)
    return ({"vq_layer": vq, "decoder": dec, "encoder": enc},
            {"vq_layer": {"poisson_bn": pbn_stats}, "decoder": dec_stats,
             "encoder": enc_stats})


def init_ann_vqvae_variables(cfg: VQVAEConfig, generator: torch.Generator) -> Dict:
    """Random flax-layout parameters of an ``ANNVQVAE`` (no batch
    statistics)."""
    c1, c2 = cfg.enc_channels
    d1, d2 = cfg.dec_channels
    d = cfg.embedding_dim
    params = {"embeddings": torch.randn((cfg.num_embeddings, d), generator=generator).numpy()}
    for name, k, cin, cout in (("enc1", 3, cfg.in_channels, c1), ("enc2", 3, c1, c2),
                               ("enc3", 1, c2, d)):
        params[name] = _conv_vars(generator, k, cin, cout, k * k * cin)
    for name, cin, cout in (("dec1", d, d1), ("dec2", d1, d2), ("dec3", d2, cfg.in_channels)):
        params[name] = _conv_vars(generator, 3, cin, cout, 9 * cout)
    return params


def init_snn_vae_variables(cfg: SNNVAEConfig, vq_cfg: VQVAEConfig,
                           generator: torch.Generator) -> Tuple[Dict, Dict]:
    """Random flax-layout (params, batch_stats) of an ``SNNVAE``."""
    c, k = cfg.latent_dim, cfg.k
    flat = vq_cfg.embedding_dim * vq_cfg.latent_size ** 2
    enc, enc_stats = _encoder_vars(vq_cfg, generator)
    dec, dec_stats = _decoder_vars(vq_cfg, generator)
    params = {"encoder": enc, "decoder": dec,
              "before_latent": _dense_vars(generator, flat, c, flat),
              "decoder_input": _dense_vars(generator, c, flat, c)}
    for cell, c_in in (("posterior", 2 * c), ("prior", c)):
        widths = ((c_in, 2 * c, c_in), (2 * c, 4 * c, 2 * c), (4 * c, c * k, 4 * c))
        params[cell] = {"mlp": {f"dense_{i}": _dense_vars(generator, *w)
                                for i, w in enumerate(widths)}}
    return params, {"encoder": enc_stats, "decoder": dec_stats}
