"""The port's CLI on the CPU with its denoiser narrowed, as a script:

    python tests/torch_cli_dp.py <flags>

for tests/test_torch_cli.py's ``--data_parallel`` run. The narrowing is
made when this file is imported, so that the ranks that ``--data_parallel
N`` spawns, which import it as their main module, narrow it too. Prints
``RESULT <json>`` of ``cli.main``'s return. Imports no JAX.
"""

import functools
import json
import sys

import torch

from spiking_diffusion_tpu_torch import cli
from spiking_diffusion_tpu_torch.config import DiffusionConfig

TINY_CHANNELS = (8, 16, 16, 16, 8)

torch.set_num_threads(1)
cli.DiffusionConfig = functools.partial(DiffusionConfig, denoiser_channels=TINY_CHANNELS)

if __name__ == "__main__":
    out = cli.main(sys.argv[1:], device="cpu")
    print("RESULT " + json.dumps(out, default=str))
