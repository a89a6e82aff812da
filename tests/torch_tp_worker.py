"""The ranks' side of tests/test_torch_tensor_parallel.py: every tensor-parallel
case on each rank of a 2 x 2 (data x model) mesh over gloo on the CPU, in
one spawn of four ranks (``parallel.launch``), and the 1 x 2 mesh's steps
in a spawn of two. Imports no JAX: the JAX references and the
single-process steps are computed in the test's own process, and the
inputs come in as numpy arrays.
"""

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from spiking_diffusion_tpu_torch import cli, parallel
from spiking_diffusion_tpu_torch.config import DiffusionConfig, SNNVAEConfig, VQVAEConfig
from spiking_diffusion_tpu_torch.models import weights
from spiking_diffusion_tpu_torch.train import stage1, stage2
from spiking_diffusion_tpu_torch.train.state import create_train_state

MESHES = {"2x2": (2, 2), "1x2": (1, 2)}
DTYPES = {"fp32": None, "bf16": torch.bfloat16}
# (stage, branch, dtype) of the steps held against one process; the fp32
# layerwise ones also against JAX
STAGE1_CASES = [("auto", "fp32"), ("auto", "bf16"), ("bnlif", "fp32"), ("bnlif", "bf16")]
STAGE2_CASES = [(b, d) for b in ("torch", "bnlif_torch", "bnlifconv_torch")
                for d in ("fp32", "bf16")]
FD_SHAPE = (2, 3, 2)  # each model rank's slice in the finite-difference checks
BASELINES = ("ann_vqvae", "snn_vae")  # the baselines' TP steps on the 2 x 2 mesh


def fd_inputs(m: int):
    """(x, w) of model rank ``m``: x its slice (or, for ``copy_to_model``,
    the replicated input), w a weight of its loss."""
    rng = np.random.RandomState(20 + m)
    return torch.from_numpy(rng.randn(*FD_SHAPE)), torch.from_numpy(rng.randn(*FD_SHAPE))


def fd_loss(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A loss nonlinear in y."""
    return (w * torch.sin(y)).sum() + 0.5 * (y * y).sum()


def fd_gather_weight(dim: int, tp: int) -> torch.Tensor:
    """The replicated weight of the loss of a gathered tensor."""
    shape = list(FD_SHAPE)
    shape[dim] *= tp
    return torch.from_numpy(np.random.RandomState(7).randn(*shape))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy().copy()


def _codes_recorder(model):
    """Record the codes of the quantizer's training forward (this rank's
    rows)."""
    vq = getattr(model, "vq_layer", model)  # the ANN VQ-VAE is its own quantizer
    seen = []
    inner = vq.get_code_indices

    def record(flat, e=None):
        out = inner(flat, e)
        seen.append(out.detach().clone())
        return out

    vq.get_code_indices = record
    return seen


def _record(state, metrics, mesh, collectives) -> dict:
    """The step's metrics and the whole new state dict and gradients (a
    collective); the replica checks and the collectives a step ran by
    group."""
    model = state.model
    plan = model.tp_plan
    grads = parallel.unshard_tensors({n: p.grad for n, p in model.named_parameters()},
                                     plan, mesh)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "state": {k: _np(v) for k, v in parallel.unshard_state_dict(model, mesh).items()},
            "grads": {k: _np(v) for k, v in grads.items()},
            "replicas_equal": parallel.replicas_equal_tp(model, mesh),
            "collectives": collectives}


def _counted(mesh, run):
    """(run(), the collectives it ran over the model and the data group)."""
    before = (mesh.model.stats.calls, mesh.data.stats.calls)
    out = run()
    return out, {"model": mesh.model.stats.calls - before[0],
                 "data": mesh.data.stats.calls - before[1]}


def _tp_state(model, mesh):
    model = parallel.replicate(parallel.sync_batchnorm(model, mesh.data), mesh.world)
    return parallel.shard_state_tp(create_train_state(model), mesh)


def _stage1_case(mesh, inp, backend="auto", dtype="fp32", encode=False) -> dict:
    cfg = VQVAEConfig(**inp["cfg"])
    vq = weights.load_vqvae(inp["params"], inp["batch_stats"], cfg, device="cpu",
                            lif_backend=backend, train=True, dtype=DTYPES[dtype])
    state = _tp_state(vq, mesh)
    images = torch.from_numpy(inp["images"])
    codes = state.model.encode_indices(images).numpy() if encode else None
    seen = _codes_recorder(state.model)
    step = stage1.make_train_step_vqvae_tp(inp["variance"], mesh, device="cpu")
    metrics, collectives = _counted(mesh, lambda: step(state, images))
    rec = _record(state, metrics, mesh, collectives)
    rec["codes"] = parallel.all_gather_rows(seen[0], mesh.data).numpy()
    rec["eval_codes"] = codes
    return rec


def _stage2_case(mesh, inp, backend="torch", dtype="fp32") -> dict:
    cfg = DiffusionConfig(**inp["cfg"])
    den = weights.load_denoiser(inp["params"], inp["batch_stats"], cfg, device="cpu",
                                lif_backend=backend, train=True, dtype=DTYPES[dtype])
    state = _tp_state(den, mesh)
    step = stage2.make_train_step_diffusion_tp(cfg, mesh, device="cpu")
    corruption = tuple(torch.from_numpy(a) for a in inp["corruption"])
    metrics, collectives = _counted(
        mesh, lambda: step(state, torch.from_numpy(inp["x0"]), corruption=corruption))
    return _record(state, metrics, mesh, collectives)


def snn_vae_model(inp, device="cpu", train=True):
    """The SNN-VAE of ``inp`` on the CPU (layerwise, fp32)."""
    return weights.load_snn_vae(inp["params"], inp["batch_stats"],
                                SNNVAEConfig(**inp["cfg"]), VQVAEConfig(**inp["vq_cfg"]),
                                device=device, train=train)


def snn_vae_draws(inp) -> tuple:
    """The step's (choice, coin draws, noise) of the global batch."""
    return tuple(torch.from_numpy(a) for a in inp["draws"])


def _ann_case(mesh, inp) -> dict:
    """The ANN VQ-VAE's stage-1 TP step: its eval codes before the step (the
    sharded model's, every row), its training codes, the record."""
    cfg = VQVAEConfig(**inp["cfg"])
    state = _tp_state(weights.load_ann_vqvae(inp["params"], cfg, device="cpu", train=True),
                      mesh)
    images = torch.from_numpy(inp["images"])
    codes = state.model.encode_indices(images).numpy()
    seen = _codes_recorder(state.model)
    step = stage1.make_train_step_vqvae_tp(inp["variance"], mesh, device="cpu")
    metrics, collectives = _counted(mesh, lambda: step(state, images))
    rec = _record(state, metrics, mesh, collectives)
    rec["codes"] = parallel.all_gather_rows(seen[0], mesh.data).numpy()
    rec["eval_codes"] = codes
    return rec


def _snn_vae_case(mesh, inp) -> dict:
    """The SNN-VAE's TP step on the given draws: the eval forward's binary
    latents before the step (this data row's rows, gathered), the record."""
    state = _tp_state(snn_vae_model(inp), mesh)
    images = torch.from_numpy(inp["images"])
    choice, coins, noise = snn_vae_draws(inp)
    with torch.no_grad():
        rows = parallel.shard_batch_2d(images, mesh)
        mine = parallel.shard_batch(choice.transpose(0, 1), mesh.data).transpose(0, 1)
        z = state.model(rows, train=False, choice=mine)["z"]
    step = cli.make_train_step_snn_vae_tp(mesh, device="cpu")
    metrics, collectives = _counted(mesh, lambda: step(
        state, images, None, inp["p_scheduled"], draws=(choice, coins, noise)))
    rec = _record(state, metrics, mesh, collectives)
    rec["eval_codes"] = parallel.all_gather_rows(z.transpose(0, 1).contiguous(),
                                                 mesh.data).transpose(0, 1).numpy()
    return rec


def _resumed_case(mesh, inp) -> dict:
    """One single-process step on the whole model (the same on every rank),
    then ``shard_state_tp`` of that state, AdamW's moments included, and a
    TP step: the moments' slices, and the record of the second step."""
    cfg = DiffusionConfig(**inp["cfg"])
    den = weights.load_denoiser(inp["params"], inp["batch_stats"], cfg, device="cpu",
                                lif_backend="torch", train=True)
    state = create_train_state(den)
    x0 = torch.from_numpy(inp["x0"])
    corruptions = [tuple(torch.from_numpy(a) for a in c) for c in inp["corruptions"]]
    stage2.make_train_step_diffusion(cfg)(state, x0, corruption=corruptions[0])
    parallel.sync_batchnorm(den, mesh.data)
    names = dict(den.named_parameters())
    full = {n: {k: state.optimizer.state[p][k].clone() for k in ("exp_avg", "exp_avg_sq")}
            for n, p in names.items()}
    step_before = {n: float(state.optimizer.state[p]["step"]) for n, p in names.items()}
    parallel.shard_state_tp(state, mesh)
    plan = den.tp_plan
    sliced = all(torch.equal(state.optimizer.state[p][k],
                             parallel.tp.shard_tensor(full[n][k], plan[n], mesh))
                 for n, p in names.items() for k in ("exp_avg", "exp_avg_sq"))
    kept = all(float(state.optimizer.state[p]["step"]) == step_before[n]
               for n, p in names.items())
    metrics = stage2.make_train_step_diffusion_tp(cfg, mesh, device="cpu")(
        state, x0, corruption=corruptions[1])
    rec = _record(state, metrics, mesh, {})
    rec.update(moments_sliced=sliced, step_kept=kept)
    return rec


def _mesh_case(mesh) -> dict:
    """This rank's coordinates and groups; the round trip of a state dict
    through ``shard_variables_tp`` and ``unshard_tensors``."""
    sd = {"w": torch.arange(24.0).reshape(4, 6), "v": torch.arange(6.0), "s": torch.tensor(2.0)}
    plan = {"w": 0, "v": 0, "s": None}
    back = parallel.unshard_tensors(parallel.shard_variables_tp(sd, mesh, plan), plan, mesh)
    rows = parallel.all_gather_rows(torch.tensor(
        [[dist.get_rank(), mesh.data.rank, mesh.model.rank]
         + dist.get_process_group_ranks(mesh.data.group)
         + dist.get_process_group_ranks(mesh.model.group)]), mesh.world)
    return {"ranks": rows.tolist(), "round_trip": all(torch.equal(sd[k], back[k]) for k in sd),
            "batch_rows": parallel.shard_batch_2d(np.arange(8), mesh).tolist(),
            "device": str(mesh.device), "backend": mesh.world.backend}


def _subgroup_case(mesh) -> dict:
    """``replicate`` and ``broadcast_object`` over each model group, one of
    which lacks rank 0: every rank's weights and object after them."""
    torch.manual_seed(dist.get_rank())  # different weights on each rank
    lin = parallel.replicate(nn.Linear(3, 2), mesh.model)
    obj = parallel.broadcast_object(dist.get_rank(), mesh.model)
    row = torch.cat([torch.tensor([float(obj)]), lin.weight.detach().reshape(-1)])
    return {"rows": parallel.all_gather_rows(row[None], mesh.world).numpy()}


def _fd_case(mesh) -> dict:
    """The three Functions in fp64 on the model group: values, and each
    rank's gradient, gathered in rank order."""
    m, tp = mesh.model.rank, mesh.tp
    out = {}
    x, w = fd_inputs(m)
    x0 = fd_inputs(0)[0].clone().requires_grad_(True)  # copy_to_model's input is replicated
    y = parallel.copy_to_model(x0, mesh.model)
    fd_loss(y, w).backward()
    out["copy"] = {"value": y.detach().numpy().copy(), "grad": x0.grad.numpy().copy()}
    for name, fn, dim in (("channels", parallel.gather_channels, 1),
                          ("rows", parallel.gather_rows, 0)):
        xs = x.clone().requires_grad_(True)
        full = fn(xs, mesh.model)
        fd_loss(full, fd_gather_weight(dim, tp)).backward()
        out[name] = {"value": full.detach().numpy().copy(),
                     "grad": parallel.all_gather_rows(xs.grad[None], mesh.model).numpy()}
    return out


def _errors_case(inputs) -> dict:
    """``make_mesh_2d``'s errors for a world that is not dp x tp, a model
    whose sharded layer has no tensor-parallel form, and, on a rank with no
    card, the mesh and the TP step builders called without a device."""
    out = {}
    dcfg = DiffusionConfig(**inputs["stage2"]["cfg"])
    mesh = parallel.make_mesh_2d(2, 2, device="cpu")
    plain = nn.Sequential(nn.Linear(4, 8))  # a layer the port gives no tensor-parallel form
    for name, call in (("world_1x2", lambda: parallel.make_mesh_2d(1, 2, device="cpu")),
                       ("world_4x2", lambda: parallel.make_mesh_2d(4, 2, device="cpu")),
                       ("no_tp_form", lambda: parallel.shard_state_tp(
                           create_train_state(plain), mesh))):
        try:
            call()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    available = torch.cuda.is_available
    torch.cuda.is_available = lambda: False
    try:
        for name, call in (
                ("make_mesh_2d", lambda: parallel.make_mesh_2d(2, 2)),
                ("stage1", lambda: stage1.make_train_step_vqvae_tp(0.1, mesh)),
                ("stage2", lambda: stage2.make_train_step_diffusion_tp(dcfg, mesh)),
                ("snn_vae", lambda: cli.make_train_step_snn_vae_tp(mesh))):
            try:
                call()
                out[name] = None
            except RuntimeError as e:
                out[name] = str(e)
    finally:
        torch.cuda.is_available = available
    return out


def run_cases(inputs: dict) -> dict:
    """Every case of the 2 x 2 mesh on this rank; rank 0's dict is the
    launch's result."""
    torch.set_num_threads(1)
    mesh = parallel.make_mesh_2d(2, 2, device="cpu")
    out = {"mesh": _mesh_case(mesh), "subgroup": _subgroup_case(mesh), "fd": _fd_case(mesh),
           "errors": _errors_case(inputs),
           "stage1_uni": _stage1_case(mesh, inputs["stage1_uni"]),
           "stage2_resumed": _resumed_case(mesh, inputs["stage2"])}
    for backend, dtype in STAGE1_CASES:
        out[f"stage1_{backend}_{dtype}"] = _stage1_case(
            mesh, inputs["stage1"], backend, dtype, encode=(backend, dtype) == ("auto", "fp32"))
    for backend, dtype in STAGE2_CASES:
        out[f"stage2_{backend}_{dtype}"] = _stage2_case(mesh, inputs["stage2"], backend, dtype)
    out["ann_vqvae"] = _ann_case(mesh, inputs["ann_vqvae"])
    out["snn_vae"] = _snn_vae_case(mesh, inputs["snn_vae"])
    return out


def run_cases_1x2(inputs: dict) -> dict:
    """The 1 x 2 mesh's steps that are held against JAX."""
    torch.set_num_threads(1)
    mesh = parallel.make_mesh_2d(1, 2, device="cpu")
    return {"stage1": _stage1_case(mesh, inputs["stage1"], encode=True),
            "stage1_uni": _stage1_case(mesh, inputs["stage1_uni"]),
            "stage2": _stage2_case(mesh, inputs["stage2"])}
