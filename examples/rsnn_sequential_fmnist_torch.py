"""Example: recurrent-SNN variants on sequential FashionMNIST, on the
PyTorch port.

The port's counterpart of ``examples/rsnn_sequential_fmnist.py``
(spikingjelly's ``rsnn_sequential_fmnist.py``): each 28x28 image is
presented row by row (T = 28 steps of 28 features) to three architectures
that differ only in their temporal machinery:

* ``plain``:    Linear -> IF -> Linear -> IF
* ``synapse``:  adds a learnable ``SynapseFilter`` between the layers
* ``feedback``: the hidden IF inside a ``LinearRecurrentContainer``
                (y[t-1] fed back through the linear map)

each trained with cross-entropy on the rate-decoded logits (Adam); the
stateful variants should match or beat plain. ``Net``'s attributes take
the JAX net's flax scopes through ``weights.scoped_state_dict(params,
SCOPES[kind])``; its own initial weights are ``nn.Linear``'s, drawn after
``torch.manual_seed(0)``. Plain PyTorch, on the card unless ``--device
cpu``.

    python examples/rsnn_sequential_fmnist_torch.py [--epochs 2] [--device cpu]
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
from spiking_diffusion_tpu_torch.models.recurrent import (
    LinearRecurrentContainer,
    SynapseFilter,
    lif_cell,
)
from spiking_diffusion_tpu_torch.snn.neuron import NeuronParams, if_scan

P_IF = NeuronParams(tau=1e9, decay_input=False)  # IF through the LIF cell
SEED = 0
# the JAX net's flax scopes -> Net's attributes, by kind
SCOPES = {
    "plain": {"Dense_0": "fc1", "Dense_1": "fc2"},
    "synapse": {"Dense_0": "fc1", "SynapseFilter_0": "synapse", "Dense_1": "fc2"},
    "feedback": {"Dense_0": "fc1", "LinearRecurrentContainer_0": "container",
                 "Dense_1": "fc2"},
}


class Net(nn.Module):
    """rows (T, N, 28) -> rate-decoded logits (N, 10)."""

    def __init__(self, kind: str, hidden: int):
        super().__init__()
        self.kind = kind
        self.fc1 = nn.Linear(28, hidden)
        if kind == "feedback":
            self.container = LinearRecurrentContainer(hidden, hidden)
        if kind == "synapse":
            self.synapse = SynapseFilter(tau=2.0, learnable=True)
        self.fc2 = nn.Linear(hidden, 10)

    def forward(self, rows):
        h = self.fc1(rows)
        s = self.container(h, lif_cell(P_IF)) if self.kind == "feedback" else if_scan(h)[0]
        if self.kind == "synapse":
            s = self.synapse(s)
        return if_scan(self.fc2(s))[0].mean(0)


def loss_fn(model, x, y):
    """Cross-entropy of 28 x the rates of (N, 28, 28) images read row by row."""
    return F.cross_entropy(model(x.permute(1, 0, 2)) * 28.0, y.long())


def train_step(model, optimizer, x, y):
    optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(model, x, y)
    loss.backward()
    optimizer.step()
    return loss.detach()


def train_one(kind, args, data, dev):
    x_train, y_train, x_test, y_test = data
    torch.manual_seed(SEED)
    model = Net(kind, args.hidden).to(dev)
    optimizer = torch.optim.Adam(model.parameters(), lr=args.lr, eps=1e-8)
    bsz, n = args.batch_size, len(x_train)
    for epoch in range(args.epochs):
        order = np.random.RandomState(epoch).permutation(n)
        for i in range(0, n - n % bsz, bsz):
            idx = order[i:i + bsz]
            loss = train_step(model, optimizer, torch.from_numpy(x_train[idx]).to(dev),
                              torch.from_numpy(y_train[idx]).to(dev))
    with torch.no_grad():
        preds = model(torch.from_numpy(x_test).to(dev).permute(1, 0, 2)).argmax(-1)
    return float((preds.cpu().numpy() == y_test).mean()), float(loss)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--n_train", type=int, default=1024)
    ap.add_argument("--n_test", type=int, default=256)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--data_path", default="./data")
    ap.add_argument("--nets", default="plain,synapse,feedback")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False

    ds = load_dataset("FMNIST", args.data_path, synthetic_ok=True)
    data = (ds.train_images[:args.n_train].reshape(-1, 28, 28),
            ds.train_labels[:args.n_train].astype(np.int64),
            ds.test_images[:args.n_test].reshape(-1, 28, 28),
            ds.test_labels[:args.n_test].astype(np.int64))
    results = {}
    for kind in args.nets.split(","):
        acc, loss = train_one(kind, args, data, dev)
        results[kind] = acc
        print(f"{kind:9s}: test acc {acc:.3f} (final loss {loss:.4f})")
    print("(stateful variants should match or beat 'plain' on sequential input)")
    return results


if __name__ == "__main__":
    main()
