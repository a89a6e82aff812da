"""Example: event-stream (DVS-style) classification on the PyTorch port.

The port's counterpart of ``examples/dvs_classify.py`` (spikingjelly's
DVS128-Gesture / N-MNIST examples). Two data paths:

* default: seeded synthetic event streams (a moving dot per class; the
  temporal structure is the signal; the JAX example's numpy draws),
  integrated into frames on the host by the port's C++ integrator
  (``spiking_diffusion_tpu_torch/native``, built with ``g++`` at first use).
* ``--dataset nmnist --root <dir>``: the on-disk pipeline
  (``data/neuromorphic.py``): an ``events_np/{train,test}/<class>/*.npz``
  tree (built from the downloaded archives by
  ``NMNIST.create_events_np_files``, or synthesized here when absent),
  integrated to frames with the reference's fixed-frames-number semantics
  and cached under ``root/frames_number_{T}_split_by_number/``.

The frames go to the device as (T, N, H, W, 2) batches of a
``SpikingVGG((16, "M", 32, "M"))``; each of its two LIF layers launches
K1's forward and, in training, K1's backward on the card. AdamW at
``optax.adamw(1e-3)``'s defaults; 5 epochs of batch 64, shuffled with
``np.random.RandomState(epoch)``; then one prediction pass over the test
set.

    python examples/dvs_classify_torch.py [--epochs 5] [--device cpu]
    python examples/dvs_classify_torch.py --dataset nmnist --root DIR

Runs on the card unless ``--device cpu`` is passed, with TF32 off (a TF32
conv can flip a spike at the threshold).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import tempfile

import numpy as np
import torch
import torch.nn.functional as F

from spiking_diffusion_tpu_torch.data.events import integrate_events_to_frames
from spiking_diffusion_tpu_torch.device import resolve_device
from spiking_diffusion_tpu_torch.models import weights
from spiking_diffusion_tpu_torch.train.state import make_adamw

H = W = 16
T_FRAMES = 8
CLASSES = 4  # four movement directions
DIRS = [(1, 0), (-1, 0), (0, 1), (0, -1)]
CFG = (16, "M", 32, "M")
BATCH = 64
SEED = 0  # of the model's initial weights


def make_event_sample(rng, cls):
    """A dot moving in direction DIRS[cls], 200 noisy events."""
    n = 200
    dy, dx = DIRS[cls]
    t = np.sort(rng.randint(0, 10_000, n)).astype(np.int64)
    frac = t / 10_000.0
    y0, x0 = rng.randint(4, 12, 2)
    y = np.clip(y0 + (frac * 10 * dy) + rng.randn(n), 0, H - 1)
    x = np.clip(x0 + (frac * 10 * dx) + rng.randn(n), 0, W - 1)
    p = rng.randint(0, 2, n)
    return {
        "t": t,
        "x": x.astype(np.int64),
        "y": y.astype(np.int64),
        "p": p.astype(np.int64),
    }


def make_events(n_per_class, seed):
    """The synthetic streams, class by class, their labels and the
    shuffle's order, in the JAX example's order of draws."""
    rng = np.random.RandomState(seed)
    events, labels = [], []
    for cls in range(CLASSES):
        for _ in range(n_per_class):
            events.append(make_event_sample(rng, cls))
            labels.append(cls)
    return events, np.asarray(labels, np.int32), rng.permutation(len(events))


def make_dataset(n_per_class, seed):
    """(N, T, H, W, 2) float32 frames clipped to {0, 1}, (N,) int32 labels."""
    events, labels, order = make_events(n_per_class, seed)
    frames = [np.clip(integrate_events_to_frames(ev, H, W, T_FRAMES, "time"), 0, 1)
              for ev in events]
    return np.stack(frames)[order].astype(np.float32), labels[order]


def load_folder_dataset(name, root, t_frames):
    """The file-layout path: events_np tree -> cached frames."""
    from spiking_diffusion_tpu_torch.data import neuromorphic as nm

    cls = {"nmnist": nm.NMNIST, "dvs128": nm.DVS128Gesture}[name]
    if not os.path.isdir(os.path.join(root, "events_np")):
        print(f"no events_np under {root}; synthesizing a tree "
              "(real runs: put the extracted archives there and call "
              f"{cls.__name__}.create_events_np_files)")
        cls.synthesize(root, per_class=24 if name == "nmnist" else 8)
    kw = dict(data_type="frame", frames_number=t_frames, split_by="number")
    train = cls(root, train=True, **kw)
    test = cls(root, train=False, **kw)
    x_tr, y_tr = train.as_arrays()
    x_te, y_te = test.as_arrays()
    # count frames -> {0,1} spike-like input, as the spikingjelly
    # examples do via their frame transforms
    return (np.clip(x_tr, 0, 1), y_tr.astype(np.int32),
            np.clip(x_te, 0, 1), y_te.astype(np.int32), len(train.classes))


def build_model(classes, input_shape, device):
    """The SpikingVGG on seeded flax-layout weights (SEED), in training
    mode, with AdamW at ``optax.adamw(1e-3)``'s defaults (weight decay
    1e-4)."""
    kw = dict(cfg=CFG, num_classes=classes, input_shape=input_shape)
    variables = weights.init_zoo_variables("vgg", torch.Generator().manual_seed(SEED), **kw)
    model = weights.load_zoo_model("vgg", *variables, device=device, train=True, **kw)
    return model, make_adamw(model.parameters(), 1e-3, weight_decay=1e-4)


def to_model(x: torch.Tensor) -> torch.Tensor:
    """(N, T, H, W, C) frames -> the zoo's (T, N, H, W, C)."""
    return x.permute(1, 0, 2, 3, 4)


def loss_fn(model, x, y):
    """Softmax cross-entropy of the rate-decoded logits of frames x."""
    return F.cross_entropy(model(to_model(x)), y.long())


def train_step(model, optimizer, x, y):
    """One AdamW step on a batch of frames; the loss."""
    optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(model, x, y)
    loss.backward()
    optimizer.step()
    return loss.detach()


def predict(model, x):
    """Class predictions of frames x, the model in eval mode."""
    model.eval()
    with torch.no_grad():
        return model(to_model(x)).argmax(-1)


def run(epochs=5, n_per_class=128, dataset="synthetic", root=None, device="cuda"):
    """Train and test (``root``: the folder datasets' root); the figures:
    ``losses`` (the last batch's of each epoch), ``accuracy``, ``classes``,
    ``steps``, ``train_shape``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    if dataset == "synthetic":
        classes = CLASSES
        x_train, y_train = make_dataset(n_per_class, seed=0)
        x_test, y_test = make_dataset(32, seed=1)
    else:
        x_train, y_train, x_test, y_test, classes = load_folder_dataset(
            dataset, os.path.join(root, dataset), T_FRAMES)
    print(f"train {x_train.shape} (T,H,W,2 frames per sample), {classes} classes")

    model, optimizer = build_model(classes, x_train.shape[2:], dev)
    n, losses, steps = len(x_train), [], 0
    for epoch in range(epochs):
        order = np.random.RandomState(epoch).permutation(n)
        for i in range(0, n - n % BATCH, BATCH):
            idx = order[i:i + BATCH]
            loss = train_step(model, optimizer, torch.from_numpy(x_train[idx]).to(dev),
                              torch.from_numpy(y_train[idx]).to(dev))
            steps += 1
        losses.append(float(loss))
        print(f"epoch {epoch}: loss {losses[-1]:.4f}")

    preds = predict(model, torch.from_numpy(x_test).to(dev)).cpu().numpy()
    acc = float((preds == y_test).mean())
    print(f"test accuracy: {acc:.3f} (chance {1 / classes:.2f})")
    return {"losses": losses, "accuracy": acc, "classes": classes, "steps": steps,
            "train_shape": x_train.shape}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--n_per_class", type=int, default=128)
    p.add_argument("--dataset", default="synthetic",
                   choices=["synthetic", "nmnist", "dvs128"])
    p.add_argument("--root", default=os.path.join(tempfile.gettempdir(), "neuromorphic_root"),
                   help="dataset root holding <dataset>/events_np/ (nmnist/dvs128)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    return run(args.epochs, args.n_per_class, args.dataset, args.root, args.device)


if __name__ == "__main__":
    main()
