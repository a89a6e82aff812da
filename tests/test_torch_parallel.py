"""Data parallelism of the port (``spiking_diffusion_tpu_torch.parallel``)
against the JAX package's mesh steps and the port's own single-process
steps.

Two ranks over gloo on the CPU, spawned once for the module through
``parallel.launch``; every case runs in that one spawn
(``tests/torch_parallel_worker.py``, which imports no JAX) and each is a
test here:

* the mesh helpers: ``make_mesh``'s rank, world, device and backend, and
  its ``ValueError`` for a count or a backend that is not the group's;
  ``shard_batch``'s contiguous rows and its error on an uneven split;
  ``replicate`` (rank 0's weights on both ranks, bitwise); the trainers'
  and the sampler's errors on an uneven split, and a denoiser built with
  ``bn_mesh`` of another process group refused, as JAX's trainer refuses
  a ``bn_axis_name`` that is not the mesh's; on a rank with no card, the DP
  trainers, ``extract_code_indices`` and the sampler called without a
  device raise instead of running on the CPU;
* ``all_reduce_mean``'s value and gradient against central finite
  differences of the summed losses, in fp64;
* the DP stage-1 step (layerwise, K1's plain versions, fp32) against
  JAX's ``make_train_step_vqvae`` over ``make_mesh(2)`` (the 8 virtual
  CPU devices of tests/conftest.py), for ``snn-vq-vae`` and for
  ``snn-vq-vae-uni``, whose codebook-usage KL is a log of a batch mean;
* the DP stage-2 step on 'bnlif_torch' (K3's plain versions) against
  JAX's ``make_train_step_diffusion_dp`` with ``bn_axis_name="data"`` and
  the Pallas kernel in interpret mode, fed JAX's drawn corruption; on
  'torch' and 'bnlifconv_torch' (K4's moments through SyncBN) against the
  port's single-process step on the global batch; each step runs
  2 x 5 BN + 1 gradient all-reduces;
* after each step the two ranks' parameters and buffers are bitwise equal;
* the DP sampler (layerwise, and K2's plain version in fp32 and int8)
  gives the single-process codes on the same noise, row for row.

Tolerances are the JAX package's own (tests/test_bnlif_dp.py): the loss
rtol 1e-5; the updated parameters rtol 1e-4, atol 1e-5, or atol 5e-3 for
a tensor whose gradient is below 1e-5 everywhere (a conv bias ahead of a
training-mode BN holds only rounding noise, which AdamW scales to
+-lr; the gradient is the DP step's, which the loss and the other
parameters hold to the reference); the BN statistics rtol 1e-4, atol 1e-5.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as worker
from spiking_diffusion_tpu.config import DiffusionConfig as JaxDiffusionConfig
from spiking_diffusion_tpu.config import VQVAEConfig as JaxVQVAEConfig
from spiking_diffusion_tpu.models import diffusion as jax_diffusion
from spiking_diffusion_tpu.models.denoiser import SpikingDenoiser as JaxDenoiser
from spiking_diffusion_tpu.models.vqvae import SNNVQVAE as JaxSNNVQVAE
from spiking_diffusion_tpu.ops import bn_lif as jax_bn_lif
from spiking_diffusion_tpu.parallel import make_mesh as jax_make_mesh
from spiking_diffusion_tpu.parallel import replicate as jax_replicate
from spiking_diffusion_tpu.parallel import shard_batch as jax_shard_batch
from spiking_diffusion_tpu.train import stage1 as jax_stage1
from spiking_diffusion_tpu.train import stage2 as jax_stage2
from spiking_diffusion_tpu.train import state as jax_state
from spiking_diffusion_tpu_torch import parallel
from spiking_diffusion_tpu_torch.config import DiffusionConfig
from spiking_diffusion_tpu_torch.data import data_variance, synthetic_dataset
from spiking_diffusion_tpu_torch.generate import sample_codes
from spiking_diffusion_tpu_torch.models import weights
from spiking_diffusion_tpu_torch.train import stage2
from spiking_diffusion_tpu_torch.train.state import create_train_state

VQ_KW = dict(num_steps=2, image_size=12, latent_size=3, enc_channels=(4, 8),
             embedding_dim=4, num_embeddings=8, dec_channels=(8, 4))
DEN_KW = dict(num_timesteps=8, denoiser_channels=(4, 8, 8, 8, 4), num_embeddings=8,
              mask_id=8, num_steps=2)
BATCH = 8  # the global batch: 4 rows a rank
SAMPLES = 6
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
NOISE_PARAM_ATOL = 5e-3
NOISE_GRAD = 1e-5
STATS_TOL = dict(rtol=1e-4, atol=1e-5)
FD_EPS = 1e-6
FD_TOL = dict(rtol=1e-6, atol=1e-8)
STEPS = ("stage1", "stage1_uni", "stage2_bnlif_torch", "stage2_torch",
         "stage2_bnlifconv_torch")
N_BN = len(DEN_KW["denoiser_channels"])
RANKS_TIMEOUT_S = 300


def _widened(variables, seed):
    """JAX variables as numpy, each BN's scale and bias moved off identity
    so that the LIF layers fire often at T = 2."""
    variables = jax.tree_util.tree_map(np.array, jax.device_get(variables))
    rng = np.random.RandomState(seed)

    def widen(tree):
        for key, node in tree.items():
            if key.startswith(("BatchNorm", "SeqBatchNorm")) and "scale" in node:
                node["scale"] = rng.uniform(1.5, 2.5, node["scale"].shape).astype(np.float32)
                node["bias"] = rng.uniform(-0.2, 0.4, node["bias"].shape).astype(np.float32)
            elif isinstance(node, dict):
                widen(node)

    widen(variables["params"])
    return {"params": variables["params"], "batch_stats": variables["batch_stats"]}


def _stage1_inputs():
    """The stage-1 inputs of 'snn-vq-vae' and of 'snn-vq-vae-uni' (the same
    images and variables; the usage weight adds no parameter)."""
    ds = synthetic_dataset("MNIST", n_train=16, n_test=4, image_size=VQ_KW["image_size"])
    images = ds.train_images[:BATCH] - 0.5
    init = JaxSNNVQVAE(JaxVQVAEConfig(**VQ_KW), backend="scan").init
    variables = _widened(jax.jit(lambda k, x: init(k, x, train=True))(
        jax.random.PRNGKey(0), jnp.asarray(images)), 2)
    return [{"cfg": dict(VQ_KW, usage_loss_weight=weight), "images": images,
             "variance": data_variance(ds.train_images), **variables}
            for weight in (0.0, 0.1)]


@pytest.fixture(scope="module")
def problem():
    """(the inputs, the JAX references, rank 0's results)."""
    torch.set_num_threads(1)
    jcfg = JaxDiffusionConfig(**DEN_KW)
    x0 = np.random.RandomState(0).randint(0, 8, (BATCH, 7, 7)).astype(np.int32)
    init = JaxDenoiser(jcfg, backend="scan").init
    den_vars = _widened(jax.jit(lambda k, x, t: init(k, x, t, train=True))(
        jax.random.PRNGKey(1), jnp.asarray(x0), jnp.ones((BATCH,), jnp.int32)), 3)
    key = jax.random.PRNGKey(4)
    corruption = [np.array(a) for a in jax_diffusion.corrupt(key, jnp.asarray(x0), jcfg)]
    vq, vq_uni = _stage1_inputs()
    inputs = {"stage1": vq, "stage1_uni": vq_uni,
              "stage2": {"cfg": DEN_KW, "x0": x0, "corruption": corruption, **den_vars},
              "sampler": {"cfg": DEN_KW, "n": SAMPLES, "seed": 5, **den_vars}}
    # the ranks run while this process computes the references
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(parallel.launch, worker.run_cases, worker.WORLD, args=(inputs,),
                            device="cpu")
        refs = {"stage1": _jax_stage1(inputs["stage1"]),
                "stage1_uni": _jax_stage1(inputs["stage1_uni"]),
                "stage2_bnlif_torch": _jax_stage2_dp(jcfg, den_vars, x0, key)}
        for backend in ("torch", "bnlifconv_torch"):
            refs[f"stage2_{backend}"] = _port_stage2(inputs["stage2"], backend)
        results = ranks.result(timeout=RANKS_TIMEOUT_S)
    return inputs, refs, results


def _jax_stage1(inp):
    """JAX's stage-1 step over ``make_mesh(2)``: (loss, the port's names ->
    new parameters and statistics)."""
    jcfg = JaxVQVAEConfig(**inp["cfg"])
    mesh = jax_make_mesh(worker.WORLD)
    state = jax_replicate(jax_state.create_train_state(
        JaxSNNVQVAE(jcfg, backend="scan"),
        {"params": inp["params"], "batch_stats": inp["batch_stats"]}), mesh)
    new, metrics = jax_stage1.make_train_step_vqvae(inp["variance"], donate=False)(
        state, jax_shard_batch(jnp.asarray(inp["images"]), mesh))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, jax.device_get(t))  # noqa: E731
    return float(metrics["loss"]), weights.vqvae_state_dict(to_np(new.params),
                                                            to_np(new.batch_stats))


def _jax_stage2_dp(jcfg, variables, x0, key):
    """JAX's ``make_train_step_diffusion_dp`` on 'bnlif' (SyncBN over
    'data', the kernel in interpret mode) over ``make_mesh(2)``."""
    old = jax_bn_lif._INTERPRET
    jax_bn_lif._INTERPRET = True
    try:
        mesh = jax_make_mesh(worker.WORLD)
        state = jax_replicate(jax_state.create_train_state(
            JaxDenoiser(jcfg, backend="bnlif", bn_axis_name="data"), variables), mesh)
        new, metrics = jax_stage2.make_train_step_diffusion_dp(jcfg, mesh, donate=False)(
            state, jax_shard_batch(jnp.asarray(x0), mesh), key)
    finally:
        jax_bn_lif._INTERPRET = old
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, jax.device_get(t))  # noqa: E731
    return float(metrics["loss"]), weights.denoiser_state_dict(
        to_np(new.params), to_np(new.batch_stats), DiffusionConfig(**DEN_KW))


def _port_stage2(inp, backend):
    """The port's single-process step on the global batch."""
    cfg = DiffusionConfig(**inp["cfg"])
    state = create_train_state(weights.load_denoiser(
        inp["params"], inp["batch_stats"], cfg, device="cpu", lif_backend=backend,
        train=True))
    corruption = tuple(torch.from_numpy(a) for a in inp["corruption"])
    loss = stage2.make_train_step_diffusion(cfg)(state, torch.from_numpy(inp["x0"]),
                                                 corruption=corruption)["loss"]
    return float(loss), {k: v.numpy() for k, v in state.model.state_dict().items()}


def test_make_mesh_and_shard_batch(problem):
    mesh = problem[2]["mesh"]
    assert (mesh["rank"], mesh["world"], mesh["device"], mesh["backend"]) == (
        0, 2, "cpu", "gloo")
    assert mesh["rows"] == list(range(8))  # rank r holds rows [4r, 4r + 4)
    raised = mesh["raised"]
    assert "does not split over 2 ranks" in raised["shard_uneven"]
    assert "need 3 ranks, the process group has 2" in raised["world_mismatch"]
    assert "the process group has 'gloo'" in raised["backend_mismatch"]


def test_make_mesh_without_a_process_group():
    mesh = parallel.make_mesh(1, device="cpu")
    assert (mesh.rank, mesh.world_size, mesh.group) == (0, 1, None)
    assert parallel.make_mesh(device="cpu").world_size == 1
    with pytest.raises(ValueError, match="need 2 ranks, have 1 process"):
        parallel.make_mesh(2, device="cpu")
    x = torch.arange(4.0, requires_grad=True)
    assert parallel.all_reduce_mean(x, mesh) is x
    assert parallel.all_reduce_mean(x, None) is x


def test_replicate_broadcasts_rank0(problem):
    mesh = problem[2]["mesh"]
    assert not mesh["equal_before"] and mesh["equal_after"]
    torch.manual_seed(0)
    np.testing.assert_array_equal(mesh["weight"], torch.nn.Linear(3, 2).weight.detach().numpy())


@pytest.mark.parametrize("name,message", [
    ("train_vqvae", "batch_size must divide by data_parallel"),
    ("train_diffusion", "batch_size must divide by data_parallel"),
    ("sample_codes", "n_samples must divide by data_parallel"),
    ("other_group", "another process group than the mesh's"),
])
def test_uneven_split_and_other_group_raise(problem, name, message):
    assert message in problem[2]["uneven"][name]


@pytest.mark.parametrize("name", ["make_mesh", "train_vqvae", "extract_code_indices",
                                  "train_diffusion", "sample_codes"])
def test_dp_entry_points_default_to_cuda(problem, name):
    """On a rank with no card, each DP entry point called without a device
    raises instead of running on the CPU."""
    assert "no CUDA device" in problem[2]["cuda_default"][name]


def test_all_reduce_mean_gradient_matches_finite_differences(problem):
    fd = problem[2]["fd"]
    xs = [worker.fd_inputs(r)[0] for r in range(worker.WORLD)]
    ws = [worker.fd_inputs(r)[1] for r in range(worker.WORLD)]

    def total(xs):
        mean = sum(xs) / worker.WORLD
        return float(sum(worker.fd_loss(x, w, mean) for x, w in zip(xs, ws)))

    np.testing.assert_allclose(fd["mean"], (sum(xs) / worker.WORLD).numpy(), rtol=1e-15)
    want = np.zeros((worker.WORLD, worker.FD_SIZE))
    for r in range(worker.WORLD):
        for i in range(worker.FD_SIZE):
            up = [x.clone() for x in xs]
            down = [x.clone() for x in xs]
            up[r][i] += FD_EPS
            down[r][i] -= FD_EPS
            want[r, i] = (total(up) - total(down)) / (2 * FD_EPS)
    np.testing.assert_allclose(fd["grads"], want, **FD_TOL)


def _hold_step(got, want_loss, want_state):
    assert got["metrics"]["loss"] == pytest.approx(want_loss, rel=LOSS_RTOL)
    grads = got["grads"]
    for name, value in got["state"].items():
        if name.endswith((".mean", ".var")):
            np.testing.assert_allclose(value, want_state[name], err_msg=name, **STATS_TOL)
        elif np.abs(grads[name]).max() < NOISE_GRAD:
            np.testing.assert_allclose(value, want_state[name], rtol=PARAM_TOL["rtol"],
                                       atol=NOISE_PARAM_ATOL, err_msg=name)
        else:
            np.testing.assert_allclose(value, want_state[name], err_msg=name, **PARAM_TOL)


@pytest.mark.parametrize("case", ["stage1", "stage1_uni"])
def test_dp_stage1_step_matches_jax_mesh_step(problem, case):
    _, refs, results = problem
    _hold_step(results[case], *refs[case])


def test_usage_kl_is_synced(problem):
    """The usage KL moves the loss: the two models' losses differ by more
    than the tolerance, so the synced mean is what holds 'stage1_uni'."""
    _, refs, _ = problem
    assert abs(refs["stage1_uni"][0] - refs["stage1"][0]) > 100 * LOSS_RTOL


@pytest.mark.parametrize("case", ["stage2_bnlif_torch", "stage2_torch",
                                  "stage2_bnlifconv_torch"])
def test_dp_stage2_step(problem, case):
    """'bnlif_torch' against JAX's DP step, the others against the port's
    single-process step on the global batch; one all-reduce for each BN's
    moments forward and backward and one for the gradients and loss."""
    _, refs, results = problem
    _hold_step(results[case], *refs[case])
    assert results[case]["collectives"] == 2 * N_BN + 1


@pytest.mark.parametrize("case", STEPS)
def test_replicas_stay_bitwise_equal(problem, case):
    assert problem[2][case]["replicas_equal"]


@pytest.mark.parametrize("name,fused,dtype", [("layerwise", False, torch.float32),
                                              ("fused_fp32", True, torch.float32),
                                              ("fused_int8", True, torch.int8)])
def test_dp_sampler_equals_single_process(problem, name, fused, dtype):
    inp = problem[0]["sampler"]
    cfg = DiffusionConfig(**inp["cfg"])
    den = weights.load_denoiser(inp["params"], inp["batch_stats"], cfg, device="cpu")
    want = sample_codes(den, cfg, inp["n"], generator=torch.Generator().manual_seed(inp["seed"]),
                        device="cpu", fused=fused, dtype=dtype).numpy()
    np.testing.assert_array_equal(problem[2][f"sampler_{name}"], want)
