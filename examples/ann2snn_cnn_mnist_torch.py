"""Example: ANN -> SNN conversion on MNIST, on the PyTorch port.

The port's counterpart of ``examples/ann2snn_cnn_mnist.py`` (spikingjelly's
``ann2snn/examples/cnn_mnist.py``): train a small Conv/ReLU/Pool CNN as a
plain ANN with Adam, convert every ReLU into a scale -> IF -> scale block
calibrated on training data (``models/ann2snn.convert``), then sweep the
simulation length T and report how the rate-coded SNN's accuracy
approaches the ANN's. The kernels are drawn He-normal (truncated, as
``jax.nn.initializers.he_normal``) in JAX's layout from a seeded
``torch.Generator`` and carried by ``weights.ann2snn_params``. cuDNN
convs and plain PyTorch IF neurons, on the card unless ``--device cpu``.

    python examples/ann2snn_cnn_mnist_torch.py [--epochs 2] [--mode max|percentile]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from spiking_diffusion_tpu_torch.data import load_dataset
from spiking_diffusion_tpu_torch.device import resolve_device
from spiking_diffusion_tpu_torch.models import ann2snn, weights

SPECS = [
    ("conv", {"stride": 1, "padding": 1}),
    ("relu",),
    ("pool", 2),
    ("conv", {"stride": 1, "padding": 1}),
    ("relu",),
    ("pool", 2),
    ("flatten",),
    ("dense", {}),
]
SEED = 0
# the standard deviation of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def he_normal(gen, shape, fan_in):
    """``jax.nn.initializers.he_normal``'s law: a normal truncated to +-2
    sigma, scaled to variance 2 / fan_in."""
    std = np.sqrt(2.0 / fan_in) / _TRUNC_STD
    t = torch.empty(shape)
    torch.nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=gen)
    return t.numpy()


def init_params(channels=(16, 32), num_classes=10, seed=SEED):
    """The CNN's parameters in JAX's layout (HWIO kernels, (in, out) dense),
    None where a layer has none."""
    gen = torch.Generator().manual_seed(seed)
    c1, c2 = channels
    return [
        {"kernel": he_normal(gen, (3, 3, 1, c1), 9), "bias": np.zeros(c1, np.float32)},
        None, None,
        {"kernel": he_normal(gen, (3, 3, c1, c2), 9 * c1), "bias": np.zeros(c2, np.float32)},
        None, None, None,
        {"kernel": he_normal(gen, (7 * 7 * c2, num_classes), 7 * 7 * c2),
         "bias": np.zeros(num_classes, np.float32)},
    ]


def to_device(params, device):
    """JAX-layout parameters -> the port's (``weights.ann2snn_params``), on
    ``device``, each trainable."""
    return [None if p is None else {k: v.to(device).requires_grad_(True) for k, v in p.items()}
            for p in weights.ann2snn_params(SPECS, params)]


def trainable(params):
    return [v for p in params if p is not None for v in p.values()]


def loss_fn(params, x, y):
    return F.cross_entropy(ann2snn.ann_forward(SPECS, params, x), y.long())


def train_step(params, optimizer, x, y):
    """One Adam step on the ANN; the loss."""
    optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(params, x, y)
    loss.backward()
    optimizer.step()
    return loss.detach()


def batched_accuracy(predict, x_test, y_test, device, bs=256):
    correct = 0
    with torch.no_grad():
        for s in range(0, len(x_test), bs):
            pred = predict(torch.from_numpy(x_test[s:s + bs]).to(device)).cpu().numpy()
            correct += int((pred == y_test[s:s + bs]).sum())
    return correct / len(x_test)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--data_path", default=None)
    p.add_argument("--mode", default="max", choices=["max", "percentile"],
                   help="VoltageHook scale mode (Converter(mode='max'|99.9))")
    p.add_argument("--steps", default="8,16,32,64",
                   help="comma-separated simulation lengths T to sweep")
    p.add_argument("--calib_size", type=int, default=256)
    p.add_argument("--eval_size", type=int, default=2048)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    ds = load_dataset("MNIST", args.data_path)
    print(f"dataset: {ds.name} (synthetic={ds.synthetic})")
    x_train = np.asarray(ds.train_images, np.float32)
    y_train = np.asarray(ds.train_labels, np.int64)
    x_test = np.asarray(ds.test_images, np.float32)[:args.eval_size]
    y_test = np.asarray(ds.test_labels)[:args.eval_size]

    params = to_device(init_params(num_classes=ds.num_classes), dev)
    optimizer = torch.optim.Adam(trainable(params), lr=1e-3, eps=1e-8)
    n = x_train.shape[0] - x_train.shape[0] % args.batch_size
    rng = np.random.RandomState(0)
    for epoch in range(args.epochs):
        perm = rng.permutation(x_train.shape[0])[:n]
        losses = []
        for s in range(0, n, args.batch_size):
            idx = perm[s:s + args.batch_size]
            losses.append(float(train_step(params, optimizer, torch.from_numpy(x_train[idx]).to(dev),
                                           torch.from_numpy(y_train[idx]).to(dev))))
        print(f"epoch {epoch}: ANN train loss {np.mean(losses):.4f}")
    params = [None if q is None else {k: v.detach() for k, v in q.items()} for q in params]

    ann_acc = batched_accuracy(lambda x: ann2snn.ann_forward(SPECS, params, x).argmax(-1),
                               x_test, y_test, dev)
    print(f"ANN test accuracy: {ann_acc:.4f}")
    calib = torch.from_numpy(x_train[:args.calib_size]).to(dev)
    rows = {}
    for t in [int(s) for s in args.steps.split(",")]:
        snn_fn, scales = ann2snn.convert(SPECS, params, calib, mode=args.mode, num_steps=t)
        acc = batched_accuracy(lambda x, f=snn_fn: f(x).argmax(-1), x_test, y_test, dev)
        rows[t] = acc
        print(f"SNN T={t:3d}: test accuracy {acc:.4f} (gap {ann_acc - acc:+.4f})")
    print("scales:", [round(s, 3) for s in scales if s is not None])
    return {"ann_accuracy": ann_acc, "snn_accuracy": rows, "scales": scales}


if __name__ == "__main__":
    main()
