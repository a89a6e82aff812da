"""Whether the frozen LeNet spaces' features depend on the process's state
or on the conv algorithm.

Each committed frozen space (``spiking_diffusion_tpu_torch/metrics/assets``)
is run on its canonical real set (the first 8,192 of 10,240 synthetic test
images after 60,000 training ones) in child processes on the card, one
for each (state, route) of ``CHILDREN``:

  * state ``fresh``: the LeNet is the process's first work on the card;
    ``after``: the caching allocator first holds a free block of
    ``--free_gib`` GiB, as it does after a run of other work;
  * route: how the convs run: ``heuristic`` (cuDNN's heuristics, the
    default), ``benchmark`` (cuDNN times its algorithms), ``deterministic``
    (cuDNN's deterministic ones only) or ``native`` (cuDNN off).

Each child computes the features in two arithmetics, both with bf16
operands: ``fp32-sum``, a conv and matrix product of the rounded operands
in fp32 (TF32 off, as the CLI sets it), and ``fp64-sum``, the LeNet's own
(``metrics/features.py``). For each it prints the largest excess of the
mean and covariance over ``frozen.verify_stats``' tolerance (negative:
within it), the number of covariance entries past it, and the verdict.
The parent then compares each arithmetic's features of every child with
those of (fresh, heuristic), and ``fp64-sum``'s on the card with the
CPU's.

Usage, from the repository root, on a machine with a card::

    python scripts/frozen_stats_process_state.py [--free_gib 8] [NAME ...]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from spiking_diffusion_tpu_torch.data import load_dataset  # noqa: E402
from spiking_diffusion_tpu_torch.metrics import frozen  # noqa: E402
from spiking_diffusion_tpu_torch.metrics.features import lenet_feature_fn  # noqa: E402

NAMES = ["MNIST", "FMNIST", "KMNIST", "Letters", "CIFAR10", "CIFAR10-BW"]
CHILDREN = [("fresh", "heuristic"), ("after", "heuristic"), ("fresh", "benchmark"),
            ("fresh", "deterministic"), ("fresh", "native")]
CANONICAL_SIZES = (60000, 10240)


def canonical_real(name: str) -> np.ndarray:
    return load_dataset(name, synthetic_size=CANONICAL_SIZES).test_images[:frozen.CANONICAL_REF_N]


def fp32_sum_features(model, images: np.ndarray, batch: int = 512) -> np.ndarray:
    """The features with bf16 operands summed in fp32 by cuDNN and cuBLAS."""
    r = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    feats = []
    for i in range(0, len(images), batch):
        x = torch.from_numpy(images[i:i + batch]).cuda().permute(0, 3, 1, 2)
        with torch.no_grad():
            for conv in (model.conv0, model.conv1):
                x = F.avg_pool2d(F.relu(F.conv2d(r(x), r(conv.weight), conv.bias,
                                                 padding=conv.padding)), 2)
            x = x.permute(0, 2, 3, 1).flatten(1)
            x = F.relu(F.linear(r(x), r(model.dense0.weight), model.dense0.bias))
            feats.append(F.linear(r(x), r(model.dense1.weight), model.dense1.bias).cpu())
    return torch.cat(feats).numpy()


def excess(stats, feats: np.ndarray) -> dict:
    """The largest excess over verify_stats' tolerance of the mean and the
    covariance, and the covariance entries past it."""
    mu, sigma = np.mean(feats, axis=0), np.cov(feats, rowvar=False)
    over_mu = np.abs(mu - stats["mu"]) - (1e-4 + 1e-4 * np.abs(stats["mu"]))
    over_sigma = np.abs(sigma - stats["sigma"]) - (1e-4 + 1e-3 * np.abs(stats["sigma"]))
    return {"mu": float(over_mu.max()), "sigma": float(over_sigma.max()),
            "sigma_entries": int((over_sigma > 0).sum())}


def child(state: str, route: str, names: list, free_gib: float, out: str) -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.enabled = route != "native"
    torch.backends.cudnn.benchmark = route == "benchmark"
    torch.backends.cudnn.deterministic = route == "deterministic"
    if state == "after":
        block = torch.empty(int(free_gib * 2**30), dtype=torch.uint8, device="cuda")
        del block
    rows = {}
    for name in names:
        real = canonical_real(name)
        model, _, _ = frozen.load_frozen_lenet(name)
        stats = frozen.load_frozen_stats(name)
        fn = lenet_feature_fn(model, "cuda")
        feats = {"fp32-sum": fp32_sum_features(model.cuda(), real), "fp64-sum": fn(real)[0]}
        rows[name] = {k: {**excess(stats, f), "verified": frozen.verify_stats(stats, real, f)}
                      for k, f in feats.items()}
        np.savez(os.path.join(out, f"{state}_{route}_{name}.npz"), **feats)
        print(json.dumps({"state": state, "route": route, "name": name, **rows[name]}),
              flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("names", nargs="*", default=NAMES)
    p.add_argument("--free_gib", type=float, default=8.0)
    p.add_argument("--child", nargs=2, help=argparse.SUPPRESS)
    p.add_argument("--out", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child:
        child(*args.child, args.names, args.free_gib, args.out)
        return 0
    if not torch.cuda.is_available():
        print("frozen_stats_process_state: needs a card", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as out:
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), *args.names,
                                   "--free_gib", str(args.free_gib), "--child", state, route,
                                   "--out", out]) for state, route in CHILDREN]
        codes = [proc.wait() for proc in procs]
        if any(codes):
            print(f"children exited {codes}", file=sys.stderr)
            return 1
        for name in args.names:
            feats = {c: np.load(os.path.join(out, "{}_{}_{}.npz".format(*c, name)))
                     for c in CHILDREN}
            first = feats[CHILDREN[0]]
            model, _, _ = frozen.load_frozen_lenet(name)
            cpu = lenet_feature_fn(model, "cpu")(canonical_real(name))[0]
            print(json.dumps({
                "name": name,
                "max_abs_vs_fresh_heuristic": {
                    "/".join(c): {k: float(np.abs(f[k] - first[k]).max()) for k in f.files}
                    for c, f in feats.items() if c != CHILDREN[0]},
                "max_abs_fp64_sum_card_vs_cpu": float(np.abs(first["fp64-sum"] - cpu).max())}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
