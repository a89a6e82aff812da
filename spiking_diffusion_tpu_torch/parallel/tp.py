"""Tensor parallelism on ``torch.distributed``: a 2-D (data x model) mesh.

Counterpart of ``spiking_diffusion_tpu/parallel/tp.py``. JAX annotates
the variables with output-channel shardings and GSPMD inserts every
collective; here one process runs each rank and the collectives are
written out, with their backward passes, as ``torch.autograd.Function``s
over the ``model`` group (Megatron's column-parallel layer with a gathered
output):

- a sharded conv or ``Linear`` (the baselines' heads and causal cells)
  takes :func:`copy_to_model` of its input (the identity;
  its backward sums the ranks' partial input gradients) and computes only
  its own output channels; its bias, its BatchNorm (scale, bias, running
  statistics) and its neuron (K1, or K3 on the shard's scale and shift, or
  K4's moments) run on that shard, since each is per channel;
- the block's spikes leave through :func:`gather_channels` (all ranks'
  channels in rank order; the backward keeps this rank's slice), a
  ``Linear``'s spikes through :func:`gather_features`;
- everything after a gather is computed alike on every model rank from
  the same tensors: the quantizer's readout and its distances and argmin
  over the codebook from :func:`gather_rows` (the same codes as one
  process), the losses, the denoiser's skip concatenation, an unsharded
  conv (the decoder's 32 -> 1). The gradients of the unsharded parameters
  are therefore whole on every model rank and take no model-group sum.

The rule (:func:`param_spec`) is JAX's ``_param_spec`` on the port's
layouts: a conv weight (Cout, Cin, kh, kw) and a ``Linear``'s (out, in)
are sharded on dim 0, a transposed conv's (Cin, Cout, kh, kw) on dim 1,
the codebook (K, D) on its
rows, every 1-D tensor (biases, BN parameters and running statistics) on
dim 0; everything else, and a dimension that does not divide by ``tp`` or
is smaller than ``MIN_SIZE * tp``, is replicated. AdamW's moments are
sharded like their parameters (:func:`shard_state_tp`), its step count
kept.

Data parallelism composes as in JAX's step, which syncs no BN axis and so
takes the global batch's statistics: each rank takes its data row's slice
of the global batch (:func:`shard_batch_2d`), the BN moments and the
``snn-vq-vae-uni`` codebook usage are averaged over the ``data`` group
(``parallel.sync_batchnorm(model, mesh.data)``), and every gradient over
it (``all_reduce_gradients``). Every collective is an all-reduce or a
broadcast, as in ``mesh.py``, so one code path serves gloo and NCCL.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import torch
import torch.distributed as dist
from torch import nn

from spiking_diffusion_tpu_torch.device import resolve_device
from spiking_diffusion_tpu_torch.parallel.mesh import (
    Mesh,
    _all_reduce,
    make_mesh,
    shard_batch,
    tensors_equal,
)

Plan = Dict[str, Optional[int]]
MIN_SIZE = 2  # JAX's min_size: a shard of fewer channels replicates the tensor


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh2D:
    """One rank of a (dp x tp) world: global rank ``d * tp + m`` sits at
    data index d and model index m. ``data`` spans the ranks of this
    rank's model index (rank d of dp), ``model`` those of its data index
    (rank m of tp); ``world`` all of them. Each keeps its own
    ``CollectiveStats``."""

    dp: int
    tp: int
    world: Mesh
    data: Mesh
    model: Mesh

    @property
    def device(self) -> torch.device:
        return self.world.device


def make_mesh_2d(dp: int, tp: int, backend: Optional[str] = None, device="cuda") -> Mesh2D:
    """This rank's view of a (dp x tp) mesh over the process group's ranks
    (``parallel.launch`` or ``torchrun``), on the card unless ``device``
    says otherwise. The world must hold exactly ``dp * tp`` ranks, else
    ``ValueError``; every group is made on every rank in the same order."""
    if dp < 1 or tp < 1:
        raise ValueError(f"a mesh of {dp} x {tp} ranks")
    world = make_mesh(dp * tp, backend=backend, device=device)
    d, m = divmod(world.rank, tp)
    data_group = model_group = None
    if world.group is not None:
        for j in range(tp):
            group = dist.new_group([i * tp + j for i in range(dp)])
            data_group = group if j == m else data_group
        for i in range(dp):
            group = dist.new_group([i * tp + j for j in range(tp)])
            model_group = group if i == d else model_group
    return Mesh2D(dp, tp, world, Mesh(d, dp, world.device, data_group, world.backend),
                  Mesh(m, tp, world.device, model_group, world.backend))


def shard_batch_2d(batch, mesh: Mesh2D):
    """This rank's rows of a global batch: its data index's slice; the
    model ranks of a data row see the same rows."""
    return shard_batch(batch, mesh.data)


def check_device(mesh: Mesh2D, device) -> None:
    """Raise unless ``device`` (the card unless 'cpu' is passed; a rank
    with no card raises) is the mesh's kind of device."""
    if resolve_device(device).type != mesh.device.type:
        raise ValueError(f"the mesh's ranks are on {mesh.device}, not {device}")


# --- the collectives over the model group ------------------------------------


def _gather(x: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """Every rank's equal slice of dim ``dim``, in rank order: an all-reduce
    of zero-padded slices, exact (a half-precision slice travels as fp32)."""
    if mesh.world_size == 1:
        return x
    per = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = per * mesh.world_size
    wire = torch.float32 if x.dtype in (torch.bfloat16, torch.float16) else x.dtype
    out = torch.zeros(shape, dtype=wire, device=x.device)
    out.narrow(dim, mesh.rank * per, per).copy_(x)
    return _all_reduce(out, mesh).to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    """The identity; the backward sums the model ranks' cotangents, in fp32
    and rounded once to the cotangent's dtype."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        total = g.to(torch.float32, memory_format=torch.contiguous_format, copy=True)
        return _all_reduce(total, ctx.mesh).to(g.dtype), None


class _Gather(torch.autograd.Function):
    """All ranks' slices of ``dim`` in rank order; the backward keeps this
    rank's slice of the (replicated) cotangent."""

    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh, ctx.per = dim, mesh, x.shape[dim]
        return _gather(x, dim, mesh)

    @staticmethod
    def backward(ctx, g):
        own = g.narrow(ctx.dim, ctx.mesh.rank * ctx.per, ctx.per)
        return own.contiguous(), None, None


def _sharded(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.world_size > 1


def copy_to_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The input of a sharded layer: ``x`` itself, whose gradient is summed
    over the model ranks (``mesh``; None or one rank: ``x``)."""
    return _CopyToModel.apply(x, mesh) if _sharded(mesh) else x


def gather_channels(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """(B, C / tp, ...) on each model rank -> (B, C, ...) on every one."""
    return _Gather.apply(x, 1, mesh) if _sharded(mesh) else x


def gather_rows(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """(K / tp, ...) on each model rank -> (K, ...) on every one."""
    return _Gather.apply(x, 0, mesh) if _sharded(mesh) else x


def gather_features(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """(..., F / tp) on each model rank -> (..., F) on every one: a
    column-parallel ``Linear``'s features."""
    return _Gather.apply(x, x.ndim - 1, mesh) if _sharded(mesh) else x


# --- the sharding plan ---------------------------------------------------------


def param_spec(name: str, shape, tp: int, transposed: bool = False) -> Optional[int]:
    """The dim of tensor ``name`` (of ``shape``) sharded over ``tp`` model
    ranks, or None (replicated): JAX's ``_param_spec`` and its divisibility
    rule on the port's layouts (``transposed``: a transposed conv's
    (Cin, Cout, kh, kw) weight)."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "weight" and len(shape) >= 2:
        dim = 1 if transposed else 0
    elif leaf == "embeddings" and len(shape) == 2:
        dim = 0
    elif len(shape) == 1:
        dim = 0
    else:
        return None
    size = shape[dim]
    return None if size % tp or size < MIN_SIZE * tp else dim


def shard_plan(model: nn.Module, tp: int) -> Plan:
    """:func:`param_spec` of every entry of ``model.state_dict()``."""
    transposed = {f"{n}.weight" if n else "weight" for n, m in model.named_modules()
                  if getattr(m, "transposed", False) is True}
    return {name: param_spec(name, tuple(t.shape), tp, name in transposed)
            for name, t in model.state_dict().items()}


def shard_tensor(t: torch.Tensor, dim: Optional[int], mesh: Mesh2D) -> torch.Tensor:
    """This rank's slice of ``t`` on ``dim`` (a view; ``t`` for None)."""
    if dim is None:
        return t
    per = t.shape[dim] // mesh.tp
    return t.narrow(dim, mesh.model.rank * per, per)


def shard_variables_tp(state_dict: Mapping[str, torch.Tensor], mesh: Mesh2D,
                       plan: Plan) -> Dict[str, torch.Tensor]:
    """This rank's slices of a full state dict under ``plan``."""
    return {k: shard_tensor(v, plan[k], mesh) for k, v in state_dict.items()}


def shard_state_tp(state, mesh: Mesh2D):
    """Shard ``state`` (a ``train.state.TrainState``) in place: the model's
    parameters and buffers and AdamW's ``exp_avg`` / ``exp_avg_sq`` by
    :func:`shard_plan`, the step count kept; each sharded conv and the
    quantizer's codebook gathers over ``mesh.model`` from then on. The plan
    is kept as ``model.tp_plan``. Every model of the port has the forms:
    the VQ-VAE, the denoiser, the ANN VQ-VAE and the SNN-VAE. Shard a
    replica (``parallel.replicate``);
    its statistics are synced over ``mesh.data`` by
    ``parallel.sync_batchnorm(model, mesh.data)``."""
    model = state.model
    if getattr(model, "tp_plan", None) is not None:
        raise ValueError("the model is sharded already")
    plan = shard_plan(model, mesh.tp)
    layers = {}  # a sharded weight or codebook -> the module that gathers it
    for name, m in model.named_modules():
        if hasattr(m, "model_mesh"):
            leaf = "embeddings" if hasattr(m, "embeddings") else "weight"
            layers[f"{name}.{leaf}" if name else leaf] = m
    for name, dim in plan.items():
        if dim is not None and name.endswith((".weight", "embeddings")) and name not in layers:
            raise ValueError(f"{name} would be sharded, and its layer has no tensor-parallel form")
    tensors = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    with torch.no_grad():
        for name, t in tensors.items():
            dim = plan.get(name)
            if dim is None:
                continue
            t.data = shard_tensor(t.data, dim, mesh).clone()
            t.grad = None
            moments = state.optimizer.state.get(t, {})
            for key in ("exp_avg", "exp_avg_sq"):
                if key in moments:
                    moments[key] = shard_tensor(moments[key], dim, mesh).clone()
    for name, m in layers.items():
        if plan[name] is not None:
            m.model_mesh = mesh.model
    model.tp_plan = plan
    return state


def unshard_tensors(tensors: Mapping[str, torch.Tensor], plan: Plan,
                    mesh: Mesh2D) -> Dict[str, torch.Tensor]:
    """The whole tensors of this rank's slices (a collective over
    ``mesh.model``: every rank calls it with the same names)."""
    return {n: t if plan[n] is None else _gather(t.detach().contiguous(), plan[n], mesh.model)
            for n, t in tensors.items()}


def unshard_state_dict(model: nn.Module, mesh: Mesh2D) -> Dict[str, torch.Tensor]:
    """The whole state dict of a model sharded by :func:`shard_state_tp`,
    on every rank."""
    return unshard_tensors(model.state_dict(), model.tp_plan, mesh)


def replicas_equal_tp(model: nn.Module, mesh: Mesh2D) -> bool:
    """Whether every tensor of ``model`` is bitwise equal over the data
    group and every replicated one over the model group."""
    tensors = list(model.state_dict().items())
    replicated = [t for n, t in tensors if model.tp_plan[n] is None]
    # both are collectives: every rank takes both
    over_data = tensors_equal([t for _, t in tensors], mesh.data)
    over_model = tensors_equal(replicated, mesh.model)
    return over_data and over_model
