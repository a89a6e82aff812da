"""The LeNet feature space of the generative metrics.

Counterpart of ``spiking_diffusion_tpu/metrics/features.py``: the
reference's mode-coverage classifier (conv 5x5 pad 2 -> ReLU -> avg-pool 2
-> conv 5x5 valid -> ReLU -> avg-pool 2 -> 120 -> 84 -> classes), whose
84-wide penultimate layer is the FID/KID feature space and whose softmax
is the IS class distribution; ``train_lenet`` (Adam 1e-3, cross-entropy)
and ``lenet_feature_fn``, which wraps a model as a ``FeatureFn``.

Parameters travel in the JAX package's flat flax layout, ``{"Conv_0/kernel":
(5, 5, Cin, 6), ..., "Dense_2/bias": (classes,)}`` (:func:`lenet_params`,
:meth:`LeNet.load_params`), so a space has one identity in both packages
(``frozen.space_hash``). The model runs NCHW and flattens (h, w, c) as
flax's NHWC does, so ``Dense_0``'s rows need no permutation.

``operand_dtype=torch.bfloat16`` rounds the operands of every conv and
matrix product to bf16 and sums in fp32: the arithmetic of the JAX
package's default precision on a TPU, in which the committed frozen
spaces were made (``frozen.py``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from spiking_diffusion_tpu_torch.device import resolve_device

# (images uint8 or float (N, H, W[, C])) -> (features (N, 84), probs (N, classes))
FeatureFn = Callable[[np.ndarray], Tuple[np.ndarray, np.ndarray]]

# flax module name -> the port's attribute
LAYERS = {"Conv_0": "conv0", "Conv_1": "conv1", "Dense_0": "dense0",
          "Dense_1": "dense1", "Dense_2": "dense2"}


class LeNet(nn.Module):
    """LeNet-5 over (N, H, W, C) images in [0, 1]."""

    def __init__(self, num_classes: int = 10, in_channels: int = 1,
                 image_size: int = 28, operand_dtype: Optional[torch.dtype] = None):
        super().__init__()
        side = (image_size // 2 - 4) // 2
        self.conv0 = nn.Conv2d(in_channels, 6, 5, padding=2)
        self.conv1 = nn.Conv2d(6, 16, 5)
        self.dense0 = nn.Linear(16 * side * side, 120)
        self.dense1 = nn.Linear(120, 84)
        self.dense2 = nn.Linear(84, num_classes)
        self.operand_dtype = operand_dtype

    def _round(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.operand_dtype is None else x.to(self.operand_dtype).float()

    def _conv(self, conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(self._round(x), self._round(conv.weight), conv.bias,
                        padding=conv.padding)

    def _dense(self, dense: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        return F.linear(self._round(x), self._round(dense.weight), dense.bias)

    def forward(self, x: torch.Tensor, return_features: bool = False):
        """Logits (N, classes), and with ``return_features`` also the 84
        features before the last ReLU."""
        x = x.permute(0, 3, 1, 2)
        x = F.avg_pool2d(F.relu(self._conv(self.conv0, x)), 2)
        x = F.avg_pool2d(F.relu(self._conv(self.conv1, x)), 2)
        x = x.permute(0, 2, 3, 1).flatten(1)  # (h, w, c), as flax flattens NHWC
        x = F.relu(self._dense(self.dense0, x))
        feats = self._dense(self.dense1, x)
        logits = self._dense(self.dense2, F.relu(feats))
        if return_features:
            return logits, feats
        return logits

    @torch.no_grad()
    def load_params(self, params: Mapping[str, np.ndarray]) -> "LeNet":
        """Copy flat flax-layout parameters in: conv kernels (H, W, Cin,
        Cout) -> (Cout, Cin, H, W), dense kernels (in, out) -> (out, in)."""
        for flax_name, attr in LAYERS.items():
            layer = getattr(self, attr)
            kernel = torch.from_numpy(np.array(params[f"{flax_name}/kernel"], np.float32))
            kernel = kernel.permute(3, 2, 0, 1) if kernel.ndim == 4 else kernel.T
            layer.weight.copy_(kernel)
            layer.bias.copy_(torch.from_numpy(np.array(params[f"{flax_name}/bias"], np.float32)))
        return self


@torch.no_grad()
def lenet_params(model: LeNet) -> Dict[str, np.ndarray]:
    """The model's parameters in the flat flax layout (fp32 numpy)."""
    params = {}
    for flax_name, attr in LAYERS.items():
        layer = getattr(model, attr)
        w = layer.weight.detach().float().cpu()
        params[f"{flax_name}/kernel"] = (w.permute(2, 3, 1, 0) if w.ndim == 4 else w.T).numpy().copy()
        params[f"{flax_name}/bias"] = layer.bias.detach().float().cpu().numpy().copy()
    return params


def init_lenet_params(num_classes: int, in_channels: int, image_size: int,
                      generator: torch.Generator) -> Dict[str, np.ndarray]:
    """Seeded flat flax-layout parameters with torch's default
    initialisers (kernels and biases uniform in +-1/sqrt(fan_in))."""
    side = (image_size // 2 - 4) // 2
    shapes = {"Conv_0": (5, 5, in_channels, 6), "Conv_1": (5, 5, 6, 16),
              "Dense_0": (16 * side * side, 120), "Dense_1": (120, 84),
              "Dense_2": (84, num_classes)}
    params = {}
    for name, shape in shapes.items():
        bound = 1.0 / math.sqrt(math.prod(shape[:-1]))
        for key, s in (("kernel", shape), ("bias", shape[-1:])):
            u = torch.rand(s, generator=generator, dtype=torch.float32)
            params[f"{name}/{key}"] = ((u * 2.0 - 1.0) * bound).numpy()
    return params


def train_lenet(
    images: np.ndarray,
    labels: np.ndarray,
    num_classes: int,
    epochs: int = 3,
    batch_size: int = 64,
    learning_rate: float = 1e-3,
    seed: int = 0,
    log_fn: Optional[Callable[[str], None]] = None,
    params: Optional[Mapping[str, np.ndarray]] = None,
    device="cuda",
) -> Tuple[LeNet, Dict[str, np.ndarray]]:
    """Train a LeNet classifier (Adam, cross-entropy) on (N, H, W, C)
    images in [0, 1]; returns (model, flat flax-layout params).

    Starts from ``params`` when given, else from :func:`init_lenet_params`
    seeded with ``seed``. The images stay on the device; epoch e visits
    them in ``np.random.RandomState(seed + e)``'s permutation, the
    remainder dropped, as the JAX loop does. Runs on the card unless
    ``device="cpu"`` is passed, in fp32 operands.
    """
    dev = resolve_device(device)
    _, h, _, c = images.shape
    if params is None:
        params = init_lenet_params(num_classes, c, h, torch.Generator().manual_seed(seed))
    model = LeNet(num_classes, c, h).load_params(params).to(dev).train()
    opt = torch.optim.Adam(model.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    data = torch.as_tensor(images, dtype=torch.float32).to(dev)
    targets = torch.as_tensor(labels, dtype=torch.int64).to(dev)
    n = images.shape[0]
    batch_size = min(batch_size, max(n, 1))
    loss = torch.zeros(())
    for epoch in range(epochs):
        order = np.random.RandomState(seed + epoch).permutation(n)
        for i in range(0, n - n % batch_size, batch_size):
            idx = torch.as_tensor(order[i:i + batch_size], device=dev)
            opt.zero_grad(set_to_none=True)
            loss = F.cross_entropy(model(data[idx]), targets[idx])
            loss.backward()
            opt.step()
        if log_fn:
            log_fn(f"lenet epoch {epoch}: loss {float(loss):.4f}")
    return model.eval(), lenet_params(model)


def lenet_feature_fn(model: LeNet, device="cuda") -> FeatureFn:
    """Wrap a LeNet as a ``FeatureFn`` on the card (or ``device="cpu"``):
    uint8-range images are scaled to [0, 1], (N, H, W) gains a channel,
    and the images run in zero-padded batches of ``batch_size``; returns
    numpy (features, softmax probabilities)."""
    dev = resolve_device(device)
    model = model.to(dev).eval()

    @torch.no_grad()
    def fn(images: np.ndarray, batch_size: int = 512):
        x = np.asarray(images, np.float32)
        if x.max() > 1.5:  # uint8 range
            x = x / 255.0
        if x.ndim == 3:
            x = x[..., None]
        n = x.shape[0]
        pad = (-n) % batch_size
        if pad:
            x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
        feats, probs = [], []
        for i in range(0, x.shape[0], batch_size):
            logits, f = model(torch.from_numpy(x[i:i + batch_size]).to(dev),
                              return_features=True)
            feats.append(f.cpu().numpy())
            probs.append(torch.softmax(logits, dim=-1).cpu().numpy())
        return np.concatenate(feats)[:n], np.concatenate(probs)[:n]

    return fn
