"""This rank's view of a data-parallel world, and its collectives.

Counterpart of ``spiking_diffusion_tpu/parallel/mesh.py``. JAX is
single-controller: one process drives a 1-D device mesh and XLA inserts
the collectives from sharding annotations. PyTorch runs one process per
rank, so a :class:`Mesh` here is one rank's view: its rank, the world
size, its device, the process group and the group's backend. Each rank
holds a full replica of the model (:func:`replicate`), takes rows
``[r * B / W, (r + 1) * B / W)`` of the global batch (:func:`shard_batch`,
JAX's contiguous axis-0 shards) and averages its gradients with the
others (:func:`all_reduce_gradients`). Every batch-global statistic is an
explicit, differentiable all-reduce (:func:`all_reduce_mean`): BatchNorm's
moments (``models/layers.SeqBatchNorm``) and the VQ codebook usage
(``models/vqvae.VectorQuantizer``), which :func:`sync_batchnorm` turns on.

``shard_map_compat`` has no counterpart: the port's DP steps are written
in the explicit form that ``shard_map`` expresses in JAX (shard, run each
shard, all-reduce).

Backend: NCCL when every rank has a card of its own; gloo when ranks share
a card (NCCL refuses two ranks on one GPU) and on the CPU. gloo runs on
CUDA tensors only ``broadcast`` and ``all_reduce``, so every collective
here is built on those two. The choice is printed; a backend asked for
that fails raises.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Iterable, List, Optional

import torch
import torch.distributed as dist
from torch import nn

from spiking_diffusion_tpu_torch.device import resolve_device


@dataclasses.dataclass
class CollectiveStats:
    """Collectives a mesh ran: ``calls`` and ``bytes`` always; ``seconds``
    of host clock around each, the card synchronised before and after it,
    while ``timed`` is set (off by default: the synchronisation stalls the
    queue)."""

    calls: int = 0
    bytes: int = 0
    seconds: float = 0.0
    timed: bool = False


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """One rank of a 1-D data-parallel world. ``group`` is None in a world
    of one process."""

    rank: int
    world_size: int
    device: torch.device
    group: Optional[object] = None
    backend: Optional[str] = None
    stats: CollectiveStats = dataclasses.field(default_factory=CollectiveStats)


def choose_backend(world_size: int, device: torch.device) -> str:
    """'nccl' when each of the host's ranks has a card of its own, else 'gloo'."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    if device.type == "cuda" and local <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device, local_rank: int) -> torch.device:
    """Rank ``local_rank``'s device: ``cuda:(local_rank % cards)`` for a
    bare 'cuda', else ``device`` as given."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def in_process_group() -> bool:
    """Whether this process is a rank: a process group exists, or
    ``torchrun``'s environment names one."""
    return dist.is_initialized() or ("WORLD_SIZE" in os.environ
                                     and "MASTER_ADDR" in os.environ)


def init_process_group(rank: int, world_size: int, port: Optional[int] = None,
                       backend: Optional[str] = None, device="cuda") -> str:
    """Join a world of ``world_size`` ranks as ``rank``: through
    ``tcp://localhost:<port>``, or ``torchrun``'s environment when
    ``port`` is None. ``backend`` None picks it (:func:`choose_backend`);
    rank 0 prints the choice. Returns the backend."""
    local = int(os.environ.get("LOCAL_RANK", rank))
    dev = rank_device(device, local)
    asked = backend
    backend = backend or choose_backend(world_size, dev)
    init = "env://" if port is None else f"tcp://localhost:{port}"
    dist.init_process_group(backend, init_method=init, rank=rank, world_size=world_size)
    if rank == 0:
        why = ("asked for" if asked else "a card per rank" if backend == "nccl"
               else "ranks share a card" if dev.type == "cuda" else "on the CPU")
        print(f"data parallel: {world_size} ranks, backend {backend} ({why})", flush=True)
    return backend


def make_mesh(n_devices: Optional[int] = None, backend: Optional[str] = None,
              device="cuda") -> Mesh:
    """This rank's view of a world of ``n_devices`` ranks (all of the
    process group's by default).

    Under ``torchrun`` the process group is made from its environment on
    first use. Without a process group a world of one process is returned
    for ``n_devices`` None or 1; any other count raises ``ValueError``, as
    JAX's ``make_mesh`` does when it cannot have n devices, and so does a
    count or a backend other than the group's.
    """
    if not dist.is_initialized():
        if in_process_group():
            init_process_group(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                               backend=backend, device=device)
        elif n_devices in (None, 1):
            return Mesh(0, 1, resolve_device(device))
        else:
            raise ValueError(
                f"need {n_devices} ranks, have 1 process: start them with "
                "spiking_diffusion_tpu_torch.parallel.launch or torchrun")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"need {n_devices} ranks, the process group has {world}")
    have = dist.get_backend()
    if backend is not None and backend != have:
        raise ValueError(f"asked for backend {backend!r}, the process group has {have!r}")
    rank = dist.get_rank()
    dev = rank_device(device, int(os.environ.get("LOCAL_RANK", rank)))
    return Mesh(rank, world, dev, dist.group.WORLD, have)


def _all_reduce(t: torch.Tensor, mesh: Mesh, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over the ranks in place."""
    stats = mesh.stats
    stats.calls += 1
    stats.bytes += t.numel() * t.element_size()
    if not stats.timed:
        dist.all_reduce(t, op=op, group=mesh.group)
        return t
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    start = time.perf_counter()
    dist.all_reduce(t, op=op, group=mesh.group)
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    stats.seconds += time.perf_counter() - start
    return t


def _mean(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _all_reduce(t.contiguous().clone(), mesh).div_(mesh.world_size)


class _AllReduceMean(torch.autograd.Function):
    """The mean over the ranks; its backward is the mean of the cotangents
    (the transpose of JAX's ``pmean``), so that the gradient of a
    batch-global statistic reaches every rank's shard."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _mean(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _mean(g, ctx.mesh), None


def all_reduce_mean(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """``x`` averaged over the ranks, differentiably; ``x`` itself in a
    world of one."""
    if mesh is None or mesh.world_size == 1:
        return x
    return _AllReduceMean.apply(x, mesh)


def all_reduce_gradients(parameters: Iterable[torch.Tensor], mesh: Mesh,
                         *scalars: torch.Tensor) -> List[torch.Tensor]:
    """Average every parameter's ``.grad`` over the ranks in place, and the
    ``scalars`` (a step's loss and metrics) in the same all-reduce; returns
    the averaged scalars. Shards are of equal size, so the mean of the
    ranks' gradients of their shard's mean loss is the gradient of the
    global batch's."""
    grads = [p.grad for p in parameters if p.grad is not None]
    flat = torch.cat([g.reshape(-1).float() for g in grads]
                     + [s.detach().float().reshape(1) for s in scalars])
    _all_reduce(flat, mesh).div_(mesh.world_size)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    return list(flat[offset:].unbind())


def shard_batch(batch, mesh: Mesh):
    """This rank's rows ``[r * B / W, (r + 1) * B / W)`` of a global batch
    (a tensor or numpy array)."""
    n = batch.shape[0]
    if n % mesh.world_size:
        raise ValueError(f"a batch of {n} does not split over {mesh.world_size} ranks")
    per = n // mesh.world_size
    return batch[mesh.rank * per:(mesh.rank + 1) * per]


def all_gather_rows(local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's equal shard, stacked in rank order on every rank: the
    inverse of :func:`shard_batch` (an all-reduce of zero-padded shards,
    exact for any dtype, since gloo gathers no CUDA tensor)."""
    if mesh.world_size == 1:
        return local
    per = local.shape[0]
    out = torch.zeros((per * mesh.world_size,) + tuple(local.shape[1:]),
                      dtype=local.dtype, device=local.device)
    out[mesh.rank * per:(mesh.rank + 1) * per] = local
    return _all_reduce(out, mesh)


def first_rank(mesh: Mesh) -> int:
    """The global rank of the group's first rank: ``torch.distributed``
    reads a ``src`` as a global rank, also on a group without rank 0."""
    return dist.get_global_rank(mesh.group, 0)


def broadcast_object(obj, mesh: Mesh):
    """The group's first rank's ``obj`` (any picklable value) on every rank."""
    if mesh.world_size == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=first_rank(mesh), group=mesh.group,
                               device=mesh.device if mesh.backend == "nccl" else None)
    return box[0]


def replicate(module: nn.Module, mesh: Mesh) -> nn.Module:
    """Broadcast ``module``'s parameters and buffers from the group's first
    rank, in place."""
    if mesh.world_size > 1:
        src = first_rank(mesh)
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src=src, group=mesh.group)
    return module


def tensors_equal(tensors: List[torch.Tensor], mesh: Mesh) -> bool:
    """Whether every rank holds bitwise the same ``tensors`` (a collective:
    every rank calls it)."""
    if mesh.world_size == 1 or not tensors:
        return True
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    high = _all_reduce(flat.clone(), mesh, dist.ReduceOp.MAX)
    low = _all_reduce(flat.clone(), mesh, dist.ReduceOp.MIN)
    return bool(torch.equal(high, low))


def replicas_equal(module: nn.Module, mesh: Mesh) -> bool:
    """Whether every rank holds bitwise the same parameters and buffers."""
    return tensors_equal(list(module.parameters()) + list(module.buffers()), mesh)


def sync_batchnorm(module: nn.Module, mesh: Mesh) -> nn.Module:
    """Turn every batch-global statistic of ``module`` over ``mesh``: each
    ``SeqBatchNorm``'s moments and each ``VectorQuantizer``'s codebook
    usage (modules with a ``mesh`` attribute), as
    ``nn.SyncBatchNorm.convert_sync_batchnorm`` does. A module already
    synced over another process group raises ``ValueError``, as JAX's
    trainer refuses a denoiser whose ``bn_axis_name`` is not the mesh's."""
    for name, m in module.named_modules():
        if not hasattr(m, "mesh"):
            continue
        if m.mesh is not None and m.mesh.group is not mesh.group:
            raise ValueError(f"{name or type(m).__name__} syncs its statistics over "
                             "another process group than the mesh's")
        m.mesh = mesh
    return module
