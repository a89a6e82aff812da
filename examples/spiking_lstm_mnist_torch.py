"""Example: spiking-LSTM sequential-MNIST classification, on the PyTorch
port.

The port's counterpart of ``examples/spiking_lstm_mnist.py``
(spikingjelly's ``spiking_lstm_sequential_mnist.py``): each 28x28 image is
fed row by row (28 steps of 28 features) into ``snn/rnn.SpikingRNN`` (an
LSTM cell whose gates spike), and the last step's hidden spikes are read
out linearly to 10 logits, trained with MSE against one-hot targets as
the reference does (Adam). ``Net``'s attributes take the JAX net's flax
scopes through ``weights.scoped_state_dict(params, SCOPES)``; its own
initial weights are ``nn.Linear``'s, drawn after ``torch.manual_seed(0)``.
Plain PyTorch, on the card unless ``--device cpu``.

    python examples/spiking_lstm_mnist_torch.py [--epochs 3] [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from spiking_diffusion_tpu_torch.data import load_dataset
from spiking_diffusion_tpu_torch.device import resolve_device
from spiking_diffusion_tpu_torch.snn.rnn import SpikingRNN

SEED = 0
SCOPES = {"SpikingRNN_0": "rnn", "Dense_0": "head"}  # the JAX net's flax scopes


class Net(nn.Module):
    """SpikingLSTM(in -> hidden) + Linear(hidden -> classes) on the last
    step's spikes (reference Net, spiking_lstm_sequential_mnist.py:12-20)."""

    def __init__(self, in_features: int, hidden: int, classes: int):
        super().__init__()
        self.rnn = SpikingRNN(in_features, hidden, cell_type="lstm")
        self.head = nn.Linear(hidden, classes)

    def forward(self, seq):  # (T, N, F)
        ys, _ = self.rnn(seq)
        return self.head(ys[-1])


def loss_fn(model, x, y):
    """MSE of the logits against one-hot targets of (N, 28, 28) rows, and
    the logits."""
    logits = model(x.permute(1, 0, 2))
    return torch.mean((logits - F.one_hot(y.long(), 10).float()) ** 2), logits


def train_step(model, optimizer, x, y):
    """One Adam step: (loss, accuracy)."""
    optimizer.zero_grad(set_to_none=True)
    loss, logits = loss_fn(model, x, y)
    loss.backward()
    optimizer.step()
    return loss.detach(), (logits.argmax(-1) == y).float().mean()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--n_train", type=int, default=1024)
    p.add_argument("--n_test", type=int, default=256)
    p.add_argument("--hidden", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--data_path", default="./data")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False

    ds = load_dataset("MNIST", args.data_path, synthetic_ok=True)
    x_train = ds.train_images[:args.n_train].reshape(-1, 28, 28)
    y_train = ds.train_labels[:args.n_train].astype(np.int64)
    x_test = ds.test_images[:args.n_test].reshape(-1, 28, 28)
    y_test = ds.test_labels[:args.n_test].astype(np.int64)

    torch.manual_seed(SEED)
    model = Net(28, args.hidden, 10).to(dev)
    optimizer = torch.optim.Adam(model.parameters(), lr=args.lr, eps=1e-8)
    bsz, n = args.batch_size, len(x_train)
    for epoch in range(args.epochs):
        order = np.random.RandomState(epoch).permutation(n)
        accs = []
        for i in range(0, n - n % bsz, bsz):
            idx = order[i:i + bsz]
            loss, acc = train_step(model, optimizer, torch.from_numpy(x_train[idx]).to(dev),
                                   torch.from_numpy(y_train[idx]).to(dev))
            accs.append(float(acc))
        print(f"epoch {epoch}: loss {float(loss):.4f} train acc {np.mean(accs):.3f}")

    with torch.no_grad():
        preds = model(torch.from_numpy(x_test).to(dev).permute(1, 0, 2)).argmax(-1)
    acc = float((preds.cpu().numpy() == y_test).mean())
    print(f"test accuracy: {acc:.3f} (chance 0.10)")
    return {"accuracy": acc}


if __name__ == "__main__":
    main()
