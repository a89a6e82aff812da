"""Example: character-level text classification with a spiking LSTM, on
the PyTorch port.

The port's counterpart of ``examples/spiking_lstm_text.py`` (spikingjelly's
``spiking_lstm_text.py``, the name -> language tutorial): names are
one-hot character sequences, one character a step, front-padded to 12;
the last step's hidden spikes of ``snn/rnn.SpikingRNN`` are read out to a
language logit (cross-entropy, Adam). Names are synthesized with
language-specific morphology, the JAX example's numpy draws; pass
``--names_dir`` at a directory of ``<Language>.txt`` lists for real data.
The net is ``spiking_lstm_mnist_torch.Net`` (its attributes take the JAX
net's flax scopes through ``weights.scoped_state_dict``), drawn after
``torch.manual_seed(0)``. Plain PyTorch, on the card unless ``--device
cpu``.

    python examples/spiking_lstm_text_torch.py [--iters 1500] [--device cpu]
"""

import os
import string
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from examples.spiking_lstm_mnist_torch import Net
from spiking_diffusion_tpu_torch.device import resolve_device

ALL_LETTERS = string.ascii_letters + " .,;'-"
N_LETTERS = len(ALL_LETTERS)
MAX_LEN = 12
SEED = 0

SYNTH_LANGS = {
    "slavic": (("mir", "slav", "bor", "rad", "vlad"), ("ov", "ev", "ski")),
    "italic": (("gio", "mar", "lu", "pa", "ro"), ("elli", "ini", "etti")),
    "nordic": (("bj", "sig", "thor", "ing", "ragn"), ("sson", "sen", "vik")),
}


def synth_name(rng, lang):
    stems, sufs = SYNTH_LANGS[lang]
    name = rng.choice(stems) + rng.choice(("a", "e", "o", "u"))
    if rng.rand() < 0.5:
        name += rng.choice(("l", "n", "r", "k"))
    return (name + rng.choice(sufs))[:MAX_LEN]


def encode(name):
    """One-hot (MAX_LEN, N_LETTERS), zero-padded at the front."""
    x = np.zeros((MAX_LEN, N_LETTERS), np.float32)
    for i, ch in enumerate(name[-MAX_LEN:]):
        x[MAX_LEN - len(name) + i, ALL_LETTERS.index(ch)] = 1.0
    return x


def load_names(names_dir):
    cats, samples = [], []
    for fname in sorted(os.listdir(names_dir)):
        if not fname.endswith(".txt"):
            continue
        cats.append(os.path.splitext(fname)[0])
        with open(os.path.join(names_dir, fname), encoding="utf-8") as f:
            for line in f:
                line = "".join(c for c in line.strip() if c in ALL_LETTERS)
                if line:
                    samples.append((line, len(cats) - 1))
    return cats, samples


def make_samples(rng, names_dir=None):
    """(languages, train, test) in the JAX example's order of draws."""
    if names_dir:
        cats, samples = load_names(names_dir)
    else:
        cats = sorted(SYNTH_LANGS)
        samples = [(synth_name(rng, lang), i) for i, lang in enumerate(cats) for _ in range(1500)]
    rng.shuffle(samples)
    n_test = max(64, len(samples) // 10)
    return cats, samples[n_test:], samples[:n_test]


def loss_fn(model, x, y):
    """Cross-entropy of (N, MAX_LEN, N_LETTERS) names, and the logits."""
    logits = model(x.permute(1, 0, 2))
    return F.cross_entropy(logits, y.long()), logits


def train_step(model, optimizer, x, y):
    """One Adam step: (loss, batch accuracy)."""
    optimizer.zero_grad(set_to_none=True)
    loss, logits = loss_fn(model, x, y)
    loss.backward()
    optimizer.step()
    return loss.detach(), (logits.argmax(-1) == y).float().mean()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=1500)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--names_dir", default=None,
                   help="directory of <Language>.txt name lists (synthetic otherwise)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False

    rng = np.random.RandomState(0)
    cats, train, test = make_samples(rng, args.names_dir)
    print(f"{len(cats)} languages, {len(train)} train / {len(test)} test")
    torch.manual_seed(SEED)
    model = Net(N_LETTERS, args.hidden, len(cats)).to(dev)
    optimizer = torch.optim.Adam(model.parameters(), lr=args.lr, eps=1e-8)

    xs = np.stack([encode(n) for n, _ in train])
    ys = np.asarray([c for _, c in train], np.int64)
    for it in range(args.iters):
        idx = rng.randint(0, len(train), args.batch_size)
        loss, acc = train_step(model, optimizer, torch.from_numpy(xs[idx]).to(dev),
                               torch.from_numpy(ys[idx]).to(dev))
        if (it + 1) % max(args.iters // 5, 1) == 0:
            print(f"iter {it + 1}: loss {float(loss):.4f} batch acc {float(acc):.3f}")

    xt = torch.from_numpy(np.stack([encode(n) for n, _ in test])).to(dev)
    yt = np.asarray([c for _, c in test])
    with torch.no_grad():
        preds = model(xt.permute(1, 0, 2)).argmax(-1).cpu().numpy()
    acc = float((preds == yt).mean())
    print(f"test accuracy: {acc:.3f} (chance {1 / len(cats):.2f})")
    return {"accuracy": acc}


if __name__ == "__main__":
    main()
