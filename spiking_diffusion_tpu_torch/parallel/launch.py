"""Start the ranks of a data-parallel run: one process each.

JAX needs no launcher (one process drives every device); PyTorch runs a
process per rank. :func:`launch` spawns them with the ``spawn`` start
method (CUDA forbids ``fork`` once it is initialised), joins each to a
process group on a free localhost port and returns rank 0's result. A
rank that raises or dies makes :func:`launch` raise, with the rank's
traceback, after the other ranks are stopped. Under ``torchrun`` no launcher is needed:
``parallel.make_mesh`` joins the group its environment names.
"""

from __future__ import annotations

import glob
import os
import pickle
import socket
import tempfile
import traceback
from typing import Callable, Optional

import torch.distributed as dist
import torch.multiprocessing as mp

from spiking_diffusion_tpu_torch.parallel.mesh import init_process_group

RESULT = "rank0.pkl"


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world_size: int, port: int, backend: Optional[str], device,
               fn: Callable, args: tuple, kwargs: dict, out_dir: str) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world_size),
                      LOCAL_WORLD_SIZE=str(world_size))
    init_process_group(rank, world_size, port, backend, device)
    try:
        result = fn(*args, **kwargs)
    except BaseException:
        # leave at once: tearing down a process group whose other ranks
        # wait in a collective can block (NCCL), and the launcher stops them
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)
    if rank == 0:
        with open(os.path.join(out_dir, RESULT), "wb") as f:
            pickle.dump(result, f)
    dist.barrier()
    dist.destroy_process_group()


def launch(fn: Callable, world_size: int, args: tuple = (), kwargs: Optional[dict] = None,
           backend: Optional[str] = None, device="cuda"):
    """``fn(*args, **kwargs)`` on ``world_size`` ranks; rank 0's return.

    ``fn`` and its arguments are pickled (a module-level function). Each
    rank joins the process group before ``fn`` runs, on ``device`` ('cuda':
    rank r on ``cuda:(r % cards)``; 'cpu'), with ``backend`` or the one
    ``parallel.mesh.choose_backend`` picks.
    """
    if world_size < 1:
        raise ValueError(f"world_size must be at least 1, not {world_size}")
    with tempfile.TemporaryDirectory() as out_dir:
        ranks = mp.spawn(_rank_main, nprocs=world_size, join=False,
                         args=(world_size, free_port(), backend, device, fn, tuple(args),
                               dict(kwargs or {}), out_dir))
        try:
            while not ranks.join():  # raises, the other ranks stopped, if one fails
                pass
        except BaseException as exc:  # also an interrupt or a timeout of the caller's
            for process in ranks.processes:
                if process.is_alive():
                    process.terminate()
                process.join()
            failed = sorted(glob.glob(os.path.join(out_dir, "rank*.err")))
            if failed:
                with open(failed[0]) as f:
                    name = os.path.basename(failed[0])[:-len(".err")]
                    raise RuntimeError(f"{name} failed:\n{f.read()}") from exc
            raise
        with open(os.path.join(out_dir, RESULT), "rb") as f:
            return pickle.load(f)
