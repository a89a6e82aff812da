"""Write the JAX package's op/energy record of the MNIST flagship for the
PyTorch port's card check.

Runs the JAX package's ``profiling.syops.profile_apply`` on the committed
60 + 120 epoch MNIST weights (``result_r5_e60/MNIST/snn-vq-vae/model``),
in fp32 on the CPU, on the first 32 test images as the CLI loads them
(``synthetic_dataset("MNIST")`` at the CLI's default sizes, minus 0.5),
in eval, with the variables stripped to ``params`` and ``batch_stats``
(the tree from ``init`` also carries a ``syops`` collection, to which
``sow`` would append). Two branches: 'auto' (the LIF layers through the
scan oracle) and 'bnlif' (the fused BN-apply + LIF kernel in Pallas's
interpret mode). It writes

    spiking_diffusion_tpu_torch/profiling/assets/syops_e60_jax.json

with each branch's per-layer entries, totals and parameter count.
``chip_smoke.py`` holds the port's counts on the card to this file, since
the card's machine has no JAX; ``tests/test_torch_syops.py`` regenerates
it and requires it unchanged. Needs JAX; run from the repo root:

    python scripts/syops_jax_record.py
"""

from __future__ import annotations

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from spiking_diffusion_tpu.config import VQVAEConfig  # noqa: E402
from spiking_diffusion_tpu.data import synthetic_dataset  # noqa: E402
from spiking_diffusion_tpu.models.vqvae import SNNVQVAE  # noqa: E402
from spiking_diffusion_tpu.ops import bn_lif  # noqa: E402
from spiking_diffusion_tpu.profiling import syops  # noqa: E402
from spiking_diffusion_tpu.train.checkpoint import load_variables  # noqa: E402

CKPT = os.path.join(REPO, "result_r5_e60", "MNIST", "snn-vq-vae")
RECORD = os.path.join(REPO, "spiking_diffusion_tpu_torch", "profiling", "assets",
                      "syops_e60_jax.json")
N_IMAGES = 32  # the CLI's default --batch_size
DATA_SIZES = (2048, 512)  # the CLI's default --synthetic_train, --synthetic_test
# the port's branch -> the JAX package's backend for it
BRANCHES = {"auto": "scan", "bnlif": "bnlif"}


def make_record() -> dict:
    params, stats = load_variables(CKPT, "model")
    variables = {"params": params, "batch_stats": stats}
    images = synthetic_dataset("MNIST", *DATA_SIZES).test_images[:N_IMAGES] - 0.5
    old, bn_lif._INTERPRET = bn_lif._INTERPRET, True
    try:
        record = {"checkpoint": os.path.relpath(CKPT, REPO), "images": N_IMAGES,
                  "data_sizes": list(DATA_SIZES)}
        for branch, backend in BRANCHES.items():
            model = SNNVQVAE(VQVAEConfig(), backend=backend)
            _, per_layer, total = syops.profile_apply(
                model, variables, jnp.asarray(images), train=False)
            record[branch] = {"per_layer": per_layer, "totals": total,
                              "count_params": syops.count_params(params)}
    finally:
        bn_lif._INTERPRET = old
    return record


def main() -> None:
    os.makedirs(os.path.dirname(RECORD), exist_ok=True)
    with open(RECORD, "w") as f:
        json.dump(make_record(), f, indent=1, sort_keys=True)
        f.write("\n")
    print("wrote", os.path.relpath(RECORD, REPO))


if __name__ == "__main__":
    main()
