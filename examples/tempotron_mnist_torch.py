"""Example: timing-based (latency-coded) MNIST with a Tempotron layer, on
the PyTorch port.

The port's counterpart of ``examples/tempotron_mnist.py`` (spikingjelly's
``timing_based/examples/tempotron_mnist.py``): each pixel of a 2x2
mean-pooled 14x14 image is encoded by ``m`` Gaussian tuning-curve neurons
into spike times (``snn/tempotron.gaussian_tuning_encode``); one layer of
Tempotron neurons classifies by peak membrane voltage on a T-point grid
(``tempotron_classify``), trained with the reference's Tempotron MSE rule
(only the wrongly fired or silent output neurons get a squared ``v_max -
v_threshold`` penalty) and plain SGD. The (classes, inputs) weight matrix
is drawn from a seeded ``torch.Generator`` (JAX draws it from a key);
the shuffle is the JAX example's ``np.random.default_rng(0)``. Plain
PyTorch, on the card unless ``--device cpu``.

    python examples/tempotron_mnist_torch.py [--epochs 2] [--device cpu]
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
from spiking_diffusion_tpu_torch.snn.tempotron import gaussian_tuning_encode, tempotron_classify

SEED = 0


def pool14(x):
    """(N, 28, 28[, 1]) in [0, 1] -> (N, 196) 2x2 means."""
    x = np.asarray(x, np.float32).reshape(len(x), 28, 28)
    return x.reshape(len(x), 14, 2, 14, 2).mean(axis=(2, 4)).reshape(len(x), -1)


def encode(x, m, t_max):
    """(B, 196) -> spike times (B, 196 * m)."""
    return gaussian_tuning_encode(x, m, t_max, 0.0, 1.0).reshape(x.shape[0], -1)


def loss_and_accuracy(weights, x, y, m, t_grid, v_threshold):
    """The Tempotron MSE loss (``timing_based/neuron.py:43-53``) and the
    batch's accuracy."""
    v_peak, _ = tempotron_classify(weights, encode(x, m, float(t_grid.shape[0])), t_grid,
                                   v_threshold)
    fired = (v_peak >= v_threshold).float()
    wrong = (fired != F.one_hot(y.long(), weights.shape[0]).float()).float()
    loss = torch.sum(((v_peak - v_threshold) * wrong) ** 2) / y.shape[0]
    return loss, (v_peak.argmax(-1) == y).float().mean()


def train_step(weights, x, y, m, t_grid, v_threshold, lr):
    """One SGD step (``optax.sgd``): (new weights, loss, accuracy)."""
    w = weights.detach().requires_grad_(True)
    loss, acc = loss_and_accuracy(w, x, y, m, t_grid, v_threshold)
    (g,) = torch.autograd.grad(loss, [w])
    return (w - lr * g).detach(), loss.detach(), acc


def predict(weights, x, m, t_grid, v_threshold):
    with torch.no_grad():
        return tempotron_classify(weights, encode(x, m, float(t_grid.shape[0])), t_grid,
                                  v_threshold)[1]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--data_path", default=None)
    p.add_argument("--dataset_name", default="MNIST")
    p.add_argument("-m", type=int, default=4,
                   help="tuning neurons per pixel (reference default 16)")
    p.add_argument("-T", type=int, default=32,
                   help="simulation grid points (reference default 100)")
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--train_size", type=int, default=4096)
    p.add_argument("--test_size", type=int, default=1024)
    p.add_argument("--v_threshold", type=float, default=1.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    ds = load_dataset(args.dataset_name, args.data_path)
    print(f"dataset: {ds.name} (synthetic={ds.synthetic})")
    tr_x = pool14(ds.train_images[:args.train_size])
    tr_y = np.asarray(ds.train_labels[:args.train_size], np.int64)
    te_x = pool14(ds.test_images[:args.test_size])
    te_y = np.asarray(ds.test_labels[:args.test_size], np.int64)
    t_grid = torch.arange(args.T, dtype=torch.float32, device=dev)
    n_in = tr_x.shape[1] * args.m
    weights = (torch.randn((ds.num_classes, n_in), generator=torch.Generator().manual_seed(SEED))
               * 0.01).to(dev)

    bs = args.batch_size
    n_train = len(tr_x) - len(tr_x) % bs
    n_eval = len(te_x) - len(te_x) % bs
    rng = np.random.default_rng(0)
    for epoch in range(args.epochs):
        perm = rng.permutation(len(tr_x))[:n_train]
        losses, accs = [], []
        for i in range(0, n_train, bs):
            idx = perm[i:i + bs]
            weights, loss, acc = train_step(
                weights, torch.from_numpy(tr_x[idx]).to(dev), torch.from_numpy(tr_y[idx]).to(dev),
                args.m, t_grid, args.v_threshold, args.lr)
            losses.append(float(loss))
            accs.append(float(acc))
        preds = [predict(weights, torch.from_numpy(te_x[i:i + bs]).to(dev), args.m, t_grid,
                         args.v_threshold).cpu().numpy() for i in range(0, n_eval, bs)]
        test_acc = float((np.concatenate(preds) == te_y[:n_eval]).mean())
        print(f"epoch {epoch}: loss {np.mean(losses):.4f} "
              f"train_acc {np.mean(accs):.4f} test_acc {test_acc:.4f}")
    return {"test_accuracy": test_acc, "weights": weights}


if __name__ == "__main__":
    main()
