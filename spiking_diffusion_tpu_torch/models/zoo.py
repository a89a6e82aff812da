"""The spiking classifier zoo (spikingjelly ``model/``) and its trainer.

Counterparts of ``spiking_diffusion_tpu/models/zoo.py``:

* :class:`SpikingVGG` (``spiking_vgg.py``): VGG convs, each Conv + BN + LIF.
* :class:`SpikingResNet` (``spiking_resnet.py``): basic blocks of
  bias-free convs, the residual added before the block's last LIF.
* :func:`SEWResNet` (``sew_resnet.py``): both branches spike and combine by
  g in {ADD, AND, IAND}.
* :class:`PLIFNet` (``parametric_lif_net.py``): {Conv + BN + PLIF +
  MaxPool} x 2, FC + PLIF, FC into a voting readout.

A model takes a (T, N, H, W, C) sequence, as JAX's, and returns the
rate-decoded logits (N, classes), the mean over T. Inside it runs the
port's time-folded (T*N, C, H, W); a flatten puts the features in JAX's
(H, W, C) order first, so a flax Dense kernel carries over as it is. The
LIF layers go through ``lif_multi_step`` with the model's backend: K1
forward and backward on the card (``ops/lif.py``), one launch each per
LIF layer; PLIF is the plain ``plif_scan`` on either device, as it is a
``lax.scan`` in JAX. BatchNorm is the port's ``SeqBatchNorm``: JAX's
arithmetic, batch statistics in ``model.train()``, running ones in
``model.eval()``.

Parameters cross from the JAX package, or are drawn from a seed, through
``models/weights.py`` (``load_zoo_model``, ``init_zoo_variables``); a
module's own initial parameters are placeholders. Submodule names follow
the conv -> BN pairing of ``snn/functional.py``: ``convs.i`` with
``bns.i``.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from spiking_diffusion_tpu_torch.device import resolve_device
from spiking_diffusion_tpu_torch.models.layers import (
    SeqBatchNorm,
    SeqConv,
    SeqLinear,
    SeqMaxPool,
    VotingLayer,
)
from spiking_diffusion_tpu_torch.snn.encoding import direct_encode
from spiking_diffusion_tpu_torch.snn.neuron import NeuronParams, lif_multi_step, plif_scan
from spiking_diffusion_tpu_torch.train.state import make_adamw

VGG_CFGS = {
    "vgg11": (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "vgg13": (64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
              512, 512, "M"),
}
SEW_FUNCTIONS = ("ADD", "AND", "IAND")


def fold(x_seq: torch.Tensor) -> torch.Tensor:
    """(T, N, H, W, C) -> the port's (T*N, C, H, W)."""
    t, n, h, w, c = x_seq.shape
    return x_seq.permute(0, 1, 4, 2, 3).reshape(t * n, c, h, w)


def flatten_hwc(h: torch.Tensor, t: int) -> torch.Tensor:
    """(T*N, C, H, W) -> (T, N, H*W*C) in JAX's channels-last order."""
    return h.permute(0, 2, 3, 1).reshape(t, h.shape[0] // t, -1)


def spike(h: torch.Tensor, t: int, params: NeuronParams, backend: str) -> torch.Tensor:
    """LIF over a time-folded (T*N, ...) tensor: one ``lif_multi_step``."""
    s = lif_multi_step(h.reshape((t, -1) + tuple(h.shape[1:])), params=params, backend=backend)
    return s.reshape(h.shape)


class SpikingVGG(nn.Module):
    """VGG backbone of Conv + BN + LIF blocks, rate-decoded classifier.

    ``input_shape`` (H, W, C) sizes the first conv and the classifier;
    each "M" halves H and W (floor), so VGG11's five pools need H, W >= 32.
    """

    def __init__(self, cfg: Sequence = VGG_CFGS["vgg11"], num_classes: int = 10,
                 params_lif: NeuronParams = NeuronParams(), backend: str = "auto",
                 input_shape: Tuple[int, int, int] = (32, 32, 3)):
        super().__init__()
        self.cfg, self.params_lif, self.backend = tuple(cfg), params_lif, backend
        h, w, c = input_shape
        convs, bns = [], []
        for v in self.cfg:
            if v == "M":
                h, w = h // 2, w // 2
            else:
                convs.append(SeqConv(c, int(v), 3, 1, 1))
                bns.append(SeqBatchNorm(int(v)))
                c = int(v)
        if h < 1 or w < 1:
            raise ValueError(f"input {input_shape} pools down to nothing under {self.cfg}")
        self.convs, self.bns = nn.ModuleList(convs), nn.ModuleList(bns)
        self.pool = SeqMaxPool(2)
        self.linear = SeqLinear(h * w * c, num_classes)

    def forward(self, x_seq: torch.Tensor) -> torch.Tensor:
        t = x_seq.shape[0]
        h = fold(x_seq)
        i = 0
        for v in self.cfg:
            if v == "M":
                h = self.pool(h)
            else:
                h = spike(self.bns[i](self.convs[i](h)), t, self.params_lif, self.backend)
                i += 1
        return self.linear(flatten_hwc(h, t)).mean(0)


class BasicBlock(nn.Module):
    """ResNet basic block of bias-free convs: conv -> BN -> LIF -> conv
    -> BN, a 1x1 conv + BN on the identity where the stride or width
    changes; then LIF(h + identity), or with ``sew`` LIF(h) combined with
    the (spiking) identity."""

    def __init__(self, in_features: int, features: int, strides: int = 1,
                 params_lif: NeuronParams = NeuronParams(), backend: str = "auto",
                 sew: Optional[str] = None):
        super().__init__()
        if sew is not None and sew not in SEW_FUNCTIONS:
            raise ValueError(f"unknown SEW function {sew!r}")
        self.params_lif, self.backend, self.sew = params_lif, backend, sew
        self.downsample = strides != 1 or in_features != features
        convs = [SeqConv(in_features, features, 3, strides, 1, use_bias=False),
                 SeqConv(features, features, 3, 1, 1, use_bias=False)]
        if self.downsample:
            convs.append(SeqConv(in_features, features, 1, strides, 0, use_bias=False))
        self.convs = nn.ModuleList(convs)
        self.bns = nn.ModuleList(SeqBatchNorm(features) for _ in convs)

    def forward(self, x: torch.Tensor, t: int) -> torch.Tensor:
        p, b = self.params_lif, self.backend
        identity = x
        h = spike(self.bns[0](self.convs[0](x)), t, p, b)
        h = self.bns[1](self.convs[1](h))
        if self.downsample:
            identity = self.bns[2](self.convs[2](identity))
            if self.sew is not None:
                identity = spike(identity, t, p, b)
        if self.sew is None:
            return spike(h + identity, t, p, b)
        s = spike(h, t, p, b)
        if self.sew == "ADD":
            return s + identity
        if self.sew == "AND":
            return s * identity
        return (1.0 - s) * identity


class SpikingResNet(nn.Module):
    """ResNet-style spiking classifier (resnet18-like at stages=(2, 2, 2, 2)):
    a stem Conv + BN + LIF, the stages of basic blocks (stride 2 at each
    later stage's first block, width doubling), a global average pool."""

    def __init__(self, stages: Sequence[int] = (2, 2), width: int = 64,
                 num_classes: int = 10, params_lif: NeuronParams = NeuronParams(),
                 backend: str = "auto", sew: Optional[str] = None, in_channels: int = 3):
        super().__init__()
        self.params_lif, self.backend = params_lif, backend
        self.convs = nn.ModuleList([SeqConv(in_channels, width, 3, 1, 1, use_bias=False)])
        self.bns = nn.ModuleList([SeqBatchNorm(width)])
        blocks, c_in, feats = [], width, width
        for i, n_blocks in enumerate(stages):
            for k in range(n_blocks):
                blocks.append(BasicBlock(c_in, feats, 2 if (i > 0 and k == 0) else 1,
                                         params_lif, backend, sew))
                c_in = feats
            feats *= 2
        self.blocks = nn.ModuleList(blocks)
        self.linear = SeqLinear(c_in, num_classes)

    def forward(self, x_seq: torch.Tensor) -> torch.Tensor:
        t = x_seq.shape[0]
        h = spike(self.bns[0](self.convs[0](fold(x_seq))), t, self.params_lif, self.backend)
        for block in self.blocks:
            h = block(h, t)
        h = h.mean((2, 3)).reshape(t, -1, h.shape[1])  # global average pool
        return self.linear(h).mean(0)


def SEWResNet(*args, sew: str = "ADD", **kwargs) -> SpikingResNet:
    """Spike-Element-Wise ResNet (``sew_resnet.py``)."""
    return SpikingResNet(*args, sew=sew, **kwargs)


class PLIFNet(nn.Module):
    """Parametric-LIF MNIST net (``parametric_lif_net.py``): {Conv3x3 + BN
    + PLIF + MaxPool} x 2 -> flatten -> FC + PLIF -> FC -> voting. Each
    PLIF layer learns its decay ``sigmoid(plif_w_i)``, from 1 / init_tau."""

    def __init__(self, channels: int = 128, num_classes: int = 10, voting_size: int = 10,
                 init_tau: float = 2.0, input_shape: Tuple[int, int, int] = (28, 28, 1)):
        super().__init__()
        h, w, c = input_shape
        self.convs = nn.ModuleList([SeqConv(c, channels, 3, 1, 1),
                                    SeqConv(channels, channels, 3, 1, 1)])
        self.bns = nn.ModuleList([SeqBatchNorm(channels), SeqBatchNorm(channels)])
        self.pool = SeqMaxPool(2)
        self.linear = SeqLinear((h // 4) * (w // 4) * channels, num_classes * voting_size)
        self.voting = VotingLayer(voting_size)
        # sigmoid(w) = 1 / tau  =>  w = -log(tau - 1)
        w_init = -float(np.log(init_tau - 1.0))
        for i in range(3):
            self.register_parameter(f"plif_w_{i}", nn.Parameter(torch.tensor(w_init)))

    def _plif(self, h_seq: torch.Tensor, i: int) -> torch.Tensor:
        return plif_scan(h_seq, getattr(self, f"plif_w_{i}"))[0]

    def forward(self, x_seq: torch.Tensor) -> torch.Tensor:
        t = x_seq.shape[0]
        h = fold(x_seq)
        for i in range(2):
            y = self.bns[i](self.convs[i](h))
            h = self.pool(self._plif(y.reshape((t, -1) + tuple(y.shape[1:])), i).reshape(y.shape))
        h = self._plif(self.linear(flatten_hwc(h, t)), 2)
        return self.voting(h).mean(0)


def loss_and_accuracy(model: nn.Module, images: torch.Tensor, labels: torch.Tensor,
                      num_steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax cross-entropy of the rate-decoded logits of direct-coded
    (N, H, W, C) images, and the batch's accuracy."""
    logits = model(direct_encode(images, num_steps))
    loss = F.cross_entropy(logits, labels.long())
    return loss, (logits.argmax(-1) == labels).float().mean()


def train_step(model: nn.Module, optimizer: torch.optim.Optimizer, images: torch.Tensor,
               labels: torch.Tensor, num_steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One AdamW step of ``train_classifier``; returns (loss, accuracy)."""
    optimizer.zero_grad(set_to_none=True)
    loss, acc = loss_and_accuracy(model, images, labels, num_steps)
    loss.backward()
    optimizer.step()
    return loss.detach(), acc


def train_classifier(
    model: nn.Module,
    images: np.ndarray,
    labels: np.ndarray,
    num_steps: int = 4,
    epochs: int = 1,
    batch_size: int = 64,
    learning_rate: float = 1e-3,
    seed: int = 0,
    log_fn: Optional[Callable[[str], None]] = None,
    device="cuda",
):
    """Train a zoo model (``train_classify.py``'s analogue): direct-coded
    input, cross-entropy on the rate-decoded logits, AdamW with
    ``optax.adamw``'s defaults (weight decay 1e-4). Each epoch shuffles
    with ``np.random.RandomState(seed + epoch)`` and drops the last
    partial batch, as JAX's. The model trains in place from the
    parameters it holds (JAX's draws its own from ``seed``; here
    ``weights.init_zoo_variables`` draws them). Returns (model, the last
    batch's accuracy)."""
    dev = resolve_device(device)
    model.to(dev).train()
    optimizer = make_adamw(model.parameters(), learning_rate, weight_decay=1e-4)
    n = images.shape[0]
    loss = acc = torch.zeros(())
    for epoch in range(epochs):
        order = np.random.RandomState(seed + epoch).permutation(n)
        for i in range(0, n - n % batch_size, batch_size):
            idx = order[i:i + batch_size]
            loss, acc = train_step(model, optimizer,
                                   torch.from_numpy(np.ascontiguousarray(images[idx])).to(dev),
                                   torch.from_numpy(np.asarray(labels[idx])).to(dev), num_steps)
        if log_fn:
            log_fn(f"epoch {epoch}: loss {float(loss):.4f} acc {float(acc):.3f}")
    return model, float(acc)
