"""InceptionV3 for paper-comparable FID/IS/KID.

Counterpart of ``spiking_diffusion_tpu/metrics/inception.py``: torchvision's
``inception_v3`` topology, whose pooled Mixed_7c activations (2048-d) are
the reference's FID features and whose class logits its IS
probabilities. The submodules carry torchvision's names
(``Conv2d_1a_3x3.conv.weight``, ``Mixed_5b.branch1x1.bn.running_mean``,
..., ``AuxLogits.fc.weight``), so a torchvision ``IMAGENET1K_V1`` state
dict loads with ``load_state_dict(strict=True)``. The auxiliary
classifier exists for that only: the metrics run in eval, where neither
torchvision nor the JAX package uses it. :func:`load_converted_weights`
reads the flax-layout ``.npz`` that ``scripts/convert_inception_weights.py``
writes. No pretrained weights are in the repository; a model of seeded
random weights (:func:`seeded_inception`) exercises the code.

Public layouts are the JAX package's: images (N, H, W, C); inside, NCHW.
The two pipelines of :func:`inception_feature_fn` are the reference's:
FID features from ``x * 2 - 1`` with ``transform_input=True``, IS
probabilities from raw [0, 1] images without it.

:func:`resize_for_inception` and ``cleanfid.clean_resize`` compute
``jax.image.resize``: separable weight matrices over the half-centred
sample positions, the kernel widened by the downscale factor when
antialiasing (``jax.image.resize`` always antialiases a downscale; a
bilinear upscale is plain interpolation), each output's weights
renormalised to sum to one and zero for a sample outside the input; then
one matrix product per axis. On the card, fp32 parity needs TF32 off
(``torch.backends.cudnn.allow_tf32``, ``torch.backends.cuda.matmul.allow_tf32``),
as the CLI sets it.
"""

from __future__ import annotations

from typing import Callable, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from spiking_diffusion_tpu_torch.device import resolve_device

INCEPTION_SIZE = 299
LANCZOS_RADIUS = 3.0


class BasicConv2d(nn.Module):
    """Conv (no bias) + BatchNorm (eps 1e-3) + ReLU."""

    def __init__(self, cin: int, cout: int, kernel_size, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size, stride=stride, padding=padding,
                              bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=0.001)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg_pool(x: torch.Tensor) -> torch.Tensor:
    # 3x3, stride 1, zero padding counted in the mean, as flax's avg_pool
    return F.avg_pool2d(x, 3, stride=1, padding=1)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_avg_pool(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, channels_7x7: int):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for layer in (self.branch7x7dbl_1, self.branch7x7dbl_2, self.branch7x7dbl_3,
                      self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = layer(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg_pool(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for layer in (self.branch7x7x3_1, self.branch7x7x3_2, self.branch7x7x3_3,
                      self.branch7x7x3_4):
            b7 = layer(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(_avg_pool(x))], 1)


class InceptionAux(nn.Module):
    """torchvision's auxiliary classifier on Mixed_6e: parameters only,
    so that torchvision's state dict loads strictly."""

    def __init__(self, cin: int, num_classes: int):
        super().__init__()
        self.conv0 = BasicConv2d(cin, 128, 1)
        self.conv1 = BasicConv2d(128, 768, 5)
        self.fc = nn.Linear(768, num_classes)


class InceptionV3(nn.Module):
    """torchvision-topology InceptionV3 on (N, H, W, 3) images (at least
    75x75); ``forward`` returns (features (N, 2048), logits (N, classes)).

    With ``transform_input`` torchvision's per-channel ImageNet rescale of
    an input in [-1, 1] comes first (what ``inception_v3(pretrained=True)``
    does, hence the reference FID)."""

    def __init__(self, num_classes: int = 1000):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.AuxLogits = InceptionAux(768, num_classes)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)
        self.fc = nn.Linear(2048, num_classes)

    def forward(self, x: torch.Tensor, transform_input: bool = False):
        x = x.permute(0, 3, 1, 2)
        if transform_input:
            # torchvision's Inception3._transform_input
            x = torch.cat([x[:, 0:1] * (0.229 / 0.5) + (0.485 - 0.5) / 0.5,
                           x[:, 1:2] * (0.224 / 0.5) + (0.456 - 0.5) / 0.5,
                           x[:, 2:3] * (0.225 / 0.5) + (0.406 - 0.5) / 0.5], 1)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a,
                      self.Mixed_6b, self.Mixed_6c, self.Mixed_6d, self.Mixed_6e,
                      self.Mixed_7a, self.Mixed_7b, self.Mixed_7c):
            x = block(x)
        feats = torch.mean(x, dim=(2, 3))
        return feats, self.fc(feats)


@torch.no_grad()
def seeded_inception(seed: int, calibration: torch.Tensor,
                     num_classes: int = 1000) -> InceptionV3:
    """An InceptionV3 of seeded random weights (PyTorch's initialisers)
    whose BN running statistics are each layer's batch statistics on
    ``calibration`` (N, H, W, 3), so that its activations stay of order
    one through the network; in eval mode, on ``calibration``'s device."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = InceptionV3(num_classes)
    model = model.to(calibration.device).train()
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.momentum = None  # the running statistics average this one batch
            m.reset_running_stats()
    model(calibration)
    return model.eval()


def _load_target(key: str) -> Tuple[str, Callable[[np.ndarray], np.ndarray]]:
    """A flat flax-layout key ('Mixed_5b/branch1x1/conv/kernel') -> the
    port's state-dict key and the array's layout change."""
    path, leaf = key.replace(".", "/").rsplit("/", 1)
    name = path.replace("/", ".")
    if leaf == "kernel" and name == "fc":
        return "fc.weight", lambda a: a.T
    if leaf == "kernel":
        return f"{name}.weight", lambda a: a.transpose(3, 2, 0, 1)
    bn = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
    return f"{name}.{bn[leaf]}", lambda a: a


def load_converted_weights(data: Mapping[str, np.ndarray], num_classes: int = 1000,
                           device="cuda") -> InceptionV3:
    """An InceptionV3 on ``device``, in eval mode, from a flat flax-layout
    mapping (the JAX package's ``convert_torchvision_state_dict`` output
    or the ``.npz`` it was saved to). Every parameter and BN statistic
    outside ``AuxLogits`` must be in it with its shape; raises otherwise."""
    dev = resolve_device(device)
    model = InceptionV3(num_classes)
    want = {k: v for k, v in model.state_dict().items()
            if not k.startswith("AuxLogits") and not k.endswith("num_batches_tracked")}
    keys = data.files if hasattr(data, "files") else data.keys()
    loaded = {}
    for key in keys:
        name, layout = _load_target(key)
        if name not in want:
            raise ValueError(f"{key!r}: no parameter {name!r} in InceptionV3")
        value = torch.from_numpy(np.ascontiguousarray(layout(np.asarray(data[key], np.float32))))
        if value.shape != want[name].shape:
            raise ValueError(f"{key!r}: shape {tuple(value.shape)} != "
                             f"{tuple(want[name].shape)}")
        loaded[name] = value
    missing = sorted(set(want) - set(loaded))
    if missing:
        raise ValueError(f"{len(missing)} parameters not in the weights: {missing[:5]}")
    model.load_state_dict(loaded, strict=False)
    return model.to(dev).eval()


def load_torch_weights_npz(npz_path: str, num_classes: int = 1000,
                           device="cuda") -> InceptionV3:
    """:func:`load_converted_weights` of a converted-weights ``.npz``."""
    with np.load(npz_path) as data:
        return load_converted_weights(data, num_classes, device)


def _lanczos3(x: np.ndarray) -> np.ndarray:
    r = LANCZOS_RADIUS
    y = r * np.sin(np.pi * x) * np.sin(np.pi * x / r)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(x > 1e-3, y / np.where(x != 0, np.pi ** 2 * x ** 2, 1), 1.0)
    return np.where(x > r, 0.0, out)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


KERNELS = {"bilinear": _triangle, "lanczos3": _lanczos3}


def resize_weights(in_size: int, out_size: int, method: str,
                   antialias: bool = True) -> np.ndarray:
    """(out_size, in_size) fp32 resampling weights of one axis, those of
    ``jax.image.resize(..., method, antialias)``."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
    sample = (np.arange(out_size, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float64)[:, None]) / kernel_scale
    w = KERNELS[method](x)
    total = np.sum(w, axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0.0).T.astype(np.float32)


def resize(x: torch.Tensor, size: int, method: str, antialias: bool = True) -> torch.Tensor:
    """(N, H, W, C) -> (N, size, size, C) fp32 by :func:`resize_weights`
    along H, then W."""
    n, h, w, c = x.shape
    wh = torch.from_numpy(resize_weights(h, size, method, antialias)).to(x.device)
    ww = torch.from_numpy(resize_weights(w, size, method, antialias)).to(x.device)
    y = torch.matmul(wh, x.float().permute(0, 3, 1, 2))  # (N, C, size, W)
    return torch.matmul(y, ww.T).permute(0, 2, 3, 1)


def resize_for_inception(images, antialias: bool = False, device="cuda") -> torch.Tensor:
    """(N, H, W, 1|3) in [0, 1] (numpy or a tensor) -> (N, 299, 299, 3)
    on ``device`` (a tensor's own device): bilinear, the reference's
    ``nn.Upsample(size=(299, 299), mode='bilinear')`` with the channel
    repeated, or with ``antialias`` Lanczos-3 with antialiasing."""
    x = images if torch.is_tensor(images) else torch.as_tensor(
        np.asarray(images, np.float32), device=resolve_device(device))
    x = x.float()
    if x.shape[-1] == 1:
        x = x.repeat(1, 1, 1, 3)
    return resize(x, INCEPTION_SIZE, "lanczos3" if antialias else "bilinear")


def inception_feature_fn(model: InceptionV3, batch_size: int = 64, device="cuda"):
    """Wrap ``model`` as a metrics ``FeatureFn`` on the card (or
    ``device="cpu"``): images (N, H, W, C), uint8-range ones scaled to
    [0, 1], in zero-padded batches of ``batch_size`` -> numpy (2048-d
    features, softmax class probabilities), the two reference pipelines:
    features of ``x * 2 - 1`` with ``transform_input``, probabilities of
    raw x without it."""
    dev = resolve_device(device)
    model = model.to(dev).eval()

    @torch.no_grad()
    def fn(images: np.ndarray):
        x = np.asarray(images, np.float32)
        if x.max() > 1.5:
            x = x / 255.0
        n = x.shape[0]
        pad = (-n) % batch_size
        if pad:
            x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
        feats, probs = [], []
        for i in range(0, x.shape[0], batch_size):
            xb = resize_for_inception(x[i:i + batch_size], device=dev)
            f, _ = model(xb * 2.0 - 1.0, transform_input=True)
            _, logits = model(xb)
            feats.append(f.cpu().numpy())
            probs.append(torch.softmax(logits, dim=-1).cpu().numpy())
        return np.concatenate(feats)[:n], np.concatenate(probs)[:n]

    return fn

