"""Freeze LeNet metric feature spaces with the PyTorch port.

The port's counterpart of ``scripts/freeze_metric_space.py``, under the
same canonical protocol (``spiking_diffusion_tpu_torch/metrics/frozen.py``):

  * each dataset at canonical sizes, 60,000 train / 10,240 test (IDX files
    under ``--data_path`` when present, else the deterministic synthetic
    fallback the flagship runs train on);
  * LeNet trained ``FREEZE_EPOCHS`` epochs (Adam 1e-3) from ``FREEZE_SEED``;
  * written under ``--root``: ``lenet_<name>.npz`` (the space) and
    ``stats_<name>.npz`` (mu/sigma of the first 8,192 test images, computed
    with the frozen spaces' bf16 operands, and the images' sha).

The files are the JAX package's format. ``--root`` is required, and the
committed ``spiking_diffusion_tpu_torch/metrics/assets/`` is refused unless
``--overwrite_assets`` is given. Runs on the card unless ``--device cpu``.

Usage, from the repository root::

    python scripts/freeze_metric_space_torch.py --root /tmp/spaces MNIST
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from spiking_diffusion_tpu_torch.data import load_dataset  # noqa: E402
from spiking_diffusion_tpu_torch.metrics import frozen  # noqa: E402

CANONICAL_SIZES = (60000, 10240)
DATASETS = ["MNIST", "KMNIST", "FMNIST", "Letters"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("datasets", nargs="*", default=DATASETS)
    p.add_argument("--root", required=True, help="directory the spaces are written to")
    p.add_argument("--overwrite_assets", action="store_true",
                   help="allow --root to be the committed metrics/assets/")
    p.add_argument("--data_path", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if (os.path.realpath(args.root) == os.path.realpath(frozen.ASSETS)
            and not args.overwrite_assets):
        p.error("--root is the committed assets/; pass --overwrite_assets to replace them")
    for name in args.datasets:
        ds = load_dataset(name, args.data_path, synthetic_size=CANONICAL_SIZES)
        print(f"freezing {name}: train={ds.train_images.shape} synthetic={ds.synthetic} "
              f"classes={ds.num_classes}")
        t0 = time.perf_counter()
        out = frozen.freeze_feature_space(name, ds.train_images, ds.train_labels,
                                          ds.test_images, ds.num_classes, root=args.root,
                                          device=args.device)
        print(f"  -> {out['space_sha'][:16]} in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
