"""The ranks' side of tests/test_torch_parallel.py: every data-parallel case
on each of two ranks over gloo on the CPU, in one spawn
(``parallel.launch``). Imports no JAX: the JAX references are computed in
the test's own process and the inputs come in as numpy arrays.
"""

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from spiking_diffusion_tpu_torch import parallel
from spiking_diffusion_tpu_torch.config import DiffusionConfig, VQVAEConfig
from spiking_diffusion_tpu_torch.generate import sample_codes
from spiking_diffusion_tpu_torch.models import weights
from spiking_diffusion_tpu_torch.models.denoiser import SpikingDenoiser
from spiking_diffusion_tpu_torch.train import stage1, stage2
from spiking_diffusion_tpu_torch.train.state import create_train_state

WORLD = 2
FD_SIZE = 5  # elements of each rank's input to the finite-difference check


def fd_inputs(rank: int):
    """(x, w) of ``rank`` for the gradient check of ``all_reduce_mean``."""
    rng = np.random.RandomState(10 + rank)
    return (torch.from_numpy(rng.randn(FD_SIZE)), torch.from_numpy(rng.randn(FD_SIZE)))


def fd_loss(x: torch.Tensor, w: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
    """A rank's loss of the ranks' mean: nonlinear in it, and in x itself."""
    return (w * torch.sin(mean)).sum() + (x * mean).sum()


def _record(state, metrics) -> dict:
    """The step's metrics, new state dict and gradients, as numpy."""
    model = state.model
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "state": {k: v.detach().numpy().copy() for k, v in model.state_dict().items()},
            "grads": {n: p.grad.numpy().copy() for n, p in model.named_parameters()
                      if p.grad is not None}}


def _mesh_case(mesh) -> dict:
    rows = parallel.all_gather_rows(torch.from_numpy(
        parallel.shard_batch(np.arange(8, dtype=np.int64), mesh)), mesh)
    raised = {}
    for name, call in (
            ("shard_uneven", lambda: parallel.shard_batch(np.arange(5), mesh)),
            ("world_mismatch", lambda: parallel.make_mesh(3, device="cpu")),
            ("backend_mismatch", lambda: parallel.make_mesh(2, backend="nccl", device="cpu"))):
        try:
            call()
            raised[name] = None
        except ValueError as e:
            raised[name] = str(e)
    torch.manual_seed(mesh.rank)  # different weights on each rank
    lin = nn.Linear(3, 2)
    before = parallel.replicas_equal(lin, mesh)
    after = parallel.replicas_equal(parallel.replicate(lin, mesh), mesh)
    return {"rank": mesh.rank, "world": mesh.world_size, "device": str(mesh.device),
            "backend": mesh.backend, "rows": rows.tolist(), "raised": raised,
            "equal_before": before, "equal_after": after,
            "weight": lin.weight.detach().numpy().copy()}


def _uneven_case(mesh, inputs) -> dict:
    """The trainers' and the sampler's errors on a split that is not even,
    and a model synced over another process group."""
    vcfg = VQVAEConfig(**inputs["stage1"]["cfg"])
    dcfg = DiffusionConfig(**inputs["stage2"]["cfg"])
    gen = torch.Generator().manual_seed(0)
    vq = weights.load_vqvae(*weights.init_vqvae_variables(vcfg, gen), vcfg, device="cpu")
    den = weights.load_denoiser(*weights.init_denoiser_variables(dcfg, gen), dcfg,
                                device="cpu")
    images = np.zeros((6,) + inputs["stage1"]["images"].shape[1:], np.float32)
    codes = np.zeros((6, 7, 7), np.int32)
    other = parallel.Mesh(mesh.rank, mesh.world_size, mesh.device, dist.new_group([0, 1]),
                          mesh.backend)
    synced = SpikingDenoiser(dcfg, bn_mesh=other)  # JAX's bn_axis_name of another axis
    out = {}
    for name, call in (
            ("train_vqvae", lambda: stage1.train_vqvae(vq, images, 0.1, batch_size=3,
                                                       log_fn=None, data_parallel=2,
                                                       device="cpu")),
            ("train_diffusion", lambda: stage2.train_diffusion(den, dcfg, codes, batch_size=3,
                                                               log_fn=None, data_parallel=2,
                                                               device="cpu")),
            ("sample_codes", lambda: sample_codes(den, dcfg, 3, generator=gen, device="cpu",
                                                  data_parallel=2)),
            ("other_group", lambda: stage2.train_diffusion(synced, dcfg, codes, batch_size=2,
                                                           log_fn=None, data_parallel=2,
                                                           device="cpu"))):
        try:
            call()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def _cuda_default_case(mesh, inputs) -> dict:
    """The DP entry points on a rank, called without a device and with no
    card: each raises instead of running on the CPU."""
    vcfg = VQVAEConfig(**inputs["stage1"]["cfg"])
    dcfg = DiffusionConfig(**inputs["stage2"]["cfg"])
    gen = torch.Generator().manual_seed(0)
    vq = weights.load_vqvae(*weights.init_vqvae_variables(vcfg, gen), vcfg, device="cpu")
    den = weights.load_denoiser(*weights.init_denoiser_variables(dcfg, gen), dcfg,
                                device="cpu")
    images = np.zeros((4,) + inputs["stage1"]["images"].shape[1:], np.float32)
    codes = np.zeros((4, 7, 7), np.int32)
    out = {}
    available = torch.cuda.is_available
    torch.cuda.is_available = lambda: False
    try:
        for name, call in (
                ("make_mesh", lambda: parallel.make_mesh(2)),
                ("train_vqvae", lambda: stage1.train_vqvae(vq, images, 0.1, batch_size=2,
                                                           log_fn=None, data_parallel=2)),
                ("extract_code_indices", lambda: stage1.extract_code_indices(
                    vq, images, data_parallel=2)),
                ("train_diffusion", lambda: stage2.train_diffusion(
                    den, dcfg, codes, batch_size=2, log_fn=None, data_parallel=2)),
                ("sample_codes", lambda: sample_codes(den, dcfg, 2, generator=gen,
                                                      data_parallel=2))):
            try:
                call()
                out[name] = None
            except RuntimeError as e:
                out[name] = str(e)
    finally:
        torch.cuda.is_available = available
    return out


def _fd_case(mesh) -> dict:
    x, w = fd_inputs(mesh.rank)
    x.requires_grad_(True)
    mean = parallel.all_reduce_mean(x, mesh)
    fd_loss(x, w, mean).backward()
    return {"mean": mean.detach().numpy().copy(),
            "grads": parallel.all_gather_rows(x.grad[None], mesh).numpy()}


def _stage1_case(mesh, inp) -> dict:
    cfg = VQVAEConfig(**inp["cfg"])
    vq = weights.load_vqvae(inp["params"], inp["batch_stats"], cfg, device="cpu",
                            lif_backend="auto", train=True)
    state = create_train_state(parallel.replicate(parallel.sync_batchnorm(vq, mesh), mesh))
    step = stage1.make_train_step_vqvae_dp(inp["variance"], mesh)
    rec = _record(state, step(state, torch.from_numpy(inp["images"])))
    rec["replicas_equal"] = parallel.replicas_equal(state.model, mesh)
    return rec


def _stage2_case(mesh, inp, backend: str) -> dict:
    cfg = DiffusionConfig(**inp["cfg"])
    den = weights.load_denoiser(inp["params"], inp["batch_stats"], cfg, device="cpu",
                                lif_backend=backend, train=True)
    state = create_train_state(parallel.replicate(parallel.sync_batchnorm(den, mesh), mesh))
    step = stage2.make_train_step_diffusion_dp(cfg, mesh)
    calls = mesh.stats.calls
    corruption = tuple(torch.from_numpy(a) for a in inp["corruption"])
    rec = _record(state, step(state, torch.from_numpy(inp["x0"]), corruption=corruption))
    rec["collectives"] = mesh.stats.calls - calls
    rec["replicas_equal"] = parallel.replicas_equal(state.model, mesh)
    return rec


def _sampler_case(mesh, inp, fused, dtype) -> np.ndarray:
    cfg = DiffusionConfig(**inp["cfg"])
    den = weights.load_denoiser(inp["params"], inp["batch_stats"], cfg, device="cpu")
    gen = torch.Generator().manual_seed(inp["seed"])
    return sample_codes(den, cfg, inp["n"], generator=gen, device="cpu", fused=fused,
                        dtype=dtype, data_parallel=WORLD).numpy()


def run_cases(inputs: dict) -> dict:
    """Every case on this rank; rank 0's dict is the launch's result."""
    torch.set_num_threads(1)
    mesh = parallel.make_mesh(WORLD, device="cpu")
    out = {"mesh": _mesh_case(mesh), "uneven": _uneven_case(mesh, inputs),
           "cuda_default": _cuda_default_case(mesh, inputs),
           "fd": _fd_case(mesh), "stage1": _stage1_case(mesh, inputs["stage1"]),
           "stage1_uni": _stage1_case(mesh, inputs["stage1_uni"])}
    for backend in ("bnlif_torch", "torch", "bnlifconv_torch"):
        out[f"stage2_{backend}"] = _stage2_case(mesh, inputs["stage2"], backend)
    for name, fused, dtype in (("layerwise", False, torch.float32),
                               ("fused_fp32", True, torch.float32),
                               ("fused_int8", True, torch.int8)):
        out[f"sampler_{name}"] = _sampler_case(mesh, inputs["sampler"], fused, dtype)
    return out
