"""Tensor parallelism of the port (``spiking_diffusion_tpu_torch.parallel.tp``)
against the JAX package's ``parallel/tp.py`` and the port's own
single-process steps.

Four ranks over gloo on the CPU form a 2 x 2 (data x model) mesh, spawned
once for the module through ``parallel.launch``, and two ranks a 1 x 2
mesh; every case runs in those spawns (``tests/torch_tp_worker.py``, which
imports no JAX) and each is a test here:

* the plan: ``param_spec`` / ``shard_plan`` shard the same tensors on the
  same (translated) dims as JAX's ``shard_variables_tp`` for every leaf of
  the VQ-VAE, the denoiser, the ANN VQ-VAE and the SNN-VAE at the flagship
  widths (``jax.eval_shape``), at tp 2 and 4; each rank (d, m)'s slices
  (``shard_variables_tp``) are JAX's ``addressable_shards`` on device
  d * tp + m, after the layout translation of ``models/weights.py``; shard
  then unshard is bitwise the whole; ``shard_state_tp`` slices AdamW's moments and keeps its step;
* the mesh: each rank's coordinates and groups, the ``ValueError`` for a
  world that is not dp x tp and for a model whose sharded layer has no
  tensor-parallel form; on a rank with no card, ``make_mesh_2d`` and the
  TP step builders called without a device raise; ``replicate`` and
  ``broadcast_object`` on a model group that lacks rank 0 take its first
  rank's values;
* the collectives ``copy_to_model``, ``gather_channels``, ``gather_rows``:
  value and gradient against central finite differences in fp64;
* the TP steps against JAX's ``make_train_step_vqvae`` (``snn-vq-vae`` and
  ``snn-vq-vae-uni``) and ``make_train_step_diffusion`` over
  ``make_mesh_2d(2, 2)`` and ``make_mesh_2d(1, 2)`` (layerwise, fp32, fed
  JAX's drawn corruption): JAX's own tolerances (tests/test_tensor_parallel.py),
  the codes of the sharded model equal to JAX's;
* the baselines' TP steps on the 2 x 2 mesh against JAX's over
  ``make_mesh_2d(2, 2)``: the ANN VQ-VAE's stage-1 step and the SNN-VAE's
  step (JAX's CLI step, fed JAX's draws, on tests/test_torch_snn_vae.py's
  problem), at JAX's tolerances, the ANN's codes and the SNN-VAE's binary
  latents equal to JAX's;
* the TP steps against the port's single-process step on the global batch
  on every branch in fp32 and bf16 (stage 1 'auto' and 'bnlif', stage 2
  'torch', 'bnlif_torch', 'bnlifconv_torch', the kernels' plain versions
  on the CPU): the training codes equal, the first-step gradients and the
  BN statistics within the tolerances below; after each step every tensor
  bitwise equal over the data group and every replicated one over the
  model group; the collectives of a stage-2 step by group.
"""

import types
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_snn_vae as snn_vae_test
import torch_tp_worker as worker
from spiking_diffusion_tpu.config import DiffusionConfig as JaxDiffusionConfig
from spiking_diffusion_tpu.config import SNNVAEConfig as JaxSNNVAEConfig
from spiking_diffusion_tpu.config import VQVAEConfig as JaxVQVAEConfig
from spiking_diffusion_tpu.models import diffusion as jax_diffusion
from spiking_diffusion_tpu.models.ann_vqvae import ANNVQVAE as JaxANNVQVAE
from spiking_diffusion_tpu.models.denoiser import SpikingDenoiser as JaxDenoiser
from spiking_diffusion_tpu.models.snn_vae import SNNVAE as JaxSNNVAE
from spiking_diffusion_tpu.models.vqvae import SNNVQVAE as JaxSNNVQVAE
from spiking_diffusion_tpu.parallel import tp as jax_tp
from spiking_diffusion_tpu.train import stage1 as jax_stage1
from spiking_diffusion_tpu.train import stage2 as jax_stage2
from spiking_diffusion_tpu.train import state as jax_state
from spiking_diffusion_tpu_torch import cli, parallel
from spiking_diffusion_tpu_torch.config import DiffusionConfig, SNNVAEConfig, VQVAEConfig
from spiking_diffusion_tpu_torch.data import data_variance, synthetic_dataset
from spiking_diffusion_tpu_torch.models import weights
from spiking_diffusion_tpu_torch.models.ann_vqvae import ANNVQVAE
from spiking_diffusion_tpu_torch.models.denoiser import SpikingDenoiser
from spiking_diffusion_tpu_torch.models.snn_vae import SNNVAE
from spiking_diffusion_tpu_torch.models.vqvae import SNNVQVAE
from spiking_diffusion_tpu_torch.train import stage1, stage2
from spiking_diffusion_tpu_torch.train.state import create_train_state

# tests/test_tensor_parallel.py's widths
VQ_KW = dict(num_steps=2, embedding_dim=4, num_embeddings=8, enc_channels=(8, 8),
             dec_channels=(8, 8))
DEN_KW = dict(num_timesteps=4, num_embeddings=8, mask_id=8, num_steps=2,
              denoiser_channels=(8, 16, 8))
# the SNN-VAE problem of tests/test_torch_snn_vae.py, whose step the port
# matches JAX's on (its decoder input fixes the 7 x 7 x 16 grid): T = 4,
# its widened variables, 4 images (2 a data rank), scheduled sampling on,
# its training forward's key
SNN_VQ_KW = dict(snn_vae_test.VQ_KW, num_steps=snn_vae_test.T_MODEL)
SNN_KW = dict(snn_vae_test.VAE_KW, num_steps=snn_vae_test.T_MODEL)
BATCH = 8  # the global batch: 4 rows a data rank on the 2 x 2 mesh
# JAX's TP tolerances (tests/test_tensor_parallel.py)
JAX_LOSS_RTOL = 1e-5
JAX_PARAM_TOL = dict(rtol=1e-4, atol=5e-3)
# against the single-process step on the global batch: the loss, the
# gradients, the BN running statistics. fp32 gradients within 1e-5. bf16:
# a sharded conv's input gradient is the sum of the model ranks' partial
# products, each rounded to bf16 (and a data rank's weight gradient is
# rounded before the ranks' mean), so a gradient parts from one process's
# by up to an ulp of its tensor's largest element: rtol 2^-7, atol 2^-7 of
# the tensor's largest |gradient|. A conv bias ahead of a training-mode BN
# has a true gradient of 0 (BN removes the mean; the fp32 step's is below
# NOISE_GRAD everywhere), so its bf16 gradient is rounding noise, 30-200
# such ulps apart on this problem: it is held, as in
# tests/test_torch_parallel.py, by the parameter after the step, which
# AdamW moves by about lr whatever the noise's sign, within 5e-3.
LOSS_RTOL = 1e-5
GRAD_TOL_FP32 = dict(rtol=1e-5, atol=1e-5)
BF16_ULP = 2 ** -7
NOISE_GRAD = 1e-5
NOISE_PARAM_ATOL = 5e-3
STATS_TOL = dict(rtol=1e-4, atol=1e-5)
FD_EPS = 1e-6
FD_TOL = dict(rtol=1e-6, atol=1e-8)
RANKS_TIMEOUT_S = 300
STAGE1_CASES = [f"stage1_{b}_{d}" for b, d in worker.STAGE1_CASES]
STAGE2_CASES = [f"stage2_{b}_{d}" for b, d in worker.STAGE2_CASES]
N_BN = len(DEN_KW["denoiser_channels"])


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


def _snn_vae_draws(key, batch):
    """The draws of JAX ``SNNVAE.__call__(image, key, train=True)``."""
    shape = (SNN_KW["num_steps"], batch, SNN_KW["latent_dim"])
    k1, k2 = jax.random.split(key)
    c1, c2 = jax.random.split(k2)
    return tuple(np.array(a) for a in (jax.random.randint(k1, shape, 0, SNN_KW["k"]),
                                       jax.random.uniform(c1, (shape[0],)),
                                       jax.random.normal(c2, shape)))


def _baseline_inputs(images, variance):
    """The ANN VQ-VAE's and the SNN-VAE's JAX variables (numpy) and their
    step's inputs."""
    ann = JaxANNVQVAE(JaxVQVAEConfig(**VQ_KW))
    ann_params = _to_np(jax.jit(lambda k, x: ann.init(k, x, train=True))(
        jax.random.PRNGKey(6), jnp.asarray(images))["params"])
    # the codebook drawn from the encoder's outputs, so that the codes vary
    z = np.asarray(ann.apply({"params": ann_params}, jnp.asarray(images), method=ann.encode))
    z = z.reshape(-1, z.shape[-1])
    rows = np.random.RandomState(11).choice(len(z), ann_params["embeddings"].shape[0],
                                            replace=False)
    ann_params["embeddings"] = z[rows].astype(np.float32)
    _, vae_vars, _, _ = snn_vae_test._problem(snn_vae_test.T_MODEL)
    vae_images = snn_vae_test._images()
    key = jax.random.PRNGKey(9)
    return {"ann_vqvae": {"cfg": VQ_KW, "images": images, "variance": variance,
                          "params": ann_params},
            "snn_vae": {"cfg": SNN_KW, "vq_cfg": SNN_VQ_KW, "images": vae_images,
                        "params": vae_vars["params"], "batch_stats": vae_vars["batch_stats"],
                        "p_scheduled": snn_vae_test.P_SCHEDULED, "key": key,
                        "draws": _snn_vae_draws(key, len(vae_images))}}


def _inputs():
    ds = synthetic_dataset("MNIST", n_train=16, n_test=4)
    images = ds.train_images[:BATCH] - 0.5
    init = JaxSNNVQVAE(JaxVQVAEConfig(**VQ_KW), backend="scan").init
    vq_vars = _widened(jax.jit(lambda k, x: init(k, x, train=True))(
        jax.random.PRNGKey(0), jnp.asarray(images)), 2)
    vq, vq_uni = [{"cfg": dict(VQ_KW, usage_loss_weight=weight), "images": images,
                   "variance": data_variance(ds.train_images), **vq_vars}
                  for weight in (0.0, 0.1)]
    jcfg = JaxDiffusionConfig(**DEN_KW)
    x0 = np.random.RandomState(0).randint(0, 8, (BATCH, 7, 7)).astype(np.int32)
    init = JaxDenoiser(jcfg, backend="scan").init
    den_vars = _widened(jax.jit(lambda k, x, t: init(k, x, t, train=True))(
        jax.random.PRNGKey(1), jnp.asarray(x0), jnp.ones((BATCH,), jnp.int32)), 3)
    keys = [jax.random.PRNGKey(4), jax.random.PRNGKey(5)]
    corruptions = [[np.array(a) for a in jax_diffusion.corrupt(k, jnp.asarray(x0), jcfg)]
                   for k in keys]
    return {"stage1": vq, "stage1_uni": vq_uni,
            "stage2": {"cfg": DEN_KW, "x0": x0, "corruption": corruptions[0],
                       "corruptions": corruptions, **den_vars},
            **_baseline_inputs(images, data_variance(ds.train_images))}, keys[0]


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _jax_stage1(inp, dp, tp):
    """JAX's stage-1 step over ``make_mesh_2d(dp, tp)``: (loss, the port's
    names -> new parameters and statistics, the codes of the variables)."""
    model = JaxSNNVQVAE(JaxVQVAEConfig(**inp["cfg"]), backend="scan")
    variables = {"params": inp["params"], "batch_stats": inp["batch_stats"]}
    mesh = jax_tp.make_mesh_2d(dp, tp)
    state = jax_tp.shard_state_tp(jax_state.create_train_state(model, variables), mesh)
    new, metrics = jax_stage1.make_train_step_vqvae(inp["variance"], donate=False)(
        state, jax_tp.shard_batch_2d(jnp.asarray(inp["images"]), mesh))
    codes = jax.jit(lambda v, x: model.apply(v, x, method=model.encode_indices))(
        variables, jnp.asarray(inp["images"]))
    return (float(metrics["loss"]),
            weights.vqvae_state_dict(_to_np(new.params), _to_np(new.batch_stats)),
            np.asarray(codes))


def _jax_stage2(inp, key, dp, tp):
    """JAX's stage-2 step (layerwise) over ``make_mesh_2d(dp, tp)``."""
    jcfg = JaxDiffusionConfig(**inp["cfg"])
    variables = {"params": inp["params"], "batch_stats": inp["batch_stats"]}
    mesh = jax_tp.make_mesh_2d(dp, tp)
    state = jax_tp.shard_state_tp(jax_state.create_train_state(
        JaxDenoiser(jcfg, backend="scan"), variables), mesh)
    new, metrics = jax_stage2.make_train_step_diffusion(jcfg, donate=False)(
        state, jax_tp.shard_batch_2d(jnp.asarray(inp["x0"]), mesh), key)
    return (float(metrics["loss"]), weights.denoiser_state_dict(
        _to_np(new.params), _to_np(new.batch_stats), DiffusionConfig(**inp["cfg"])), None)


def _jax_ann(inp, dp, tp):
    """JAX's stage-1 step of the ANN VQ-VAE over ``make_mesh_2d(dp, tp)``."""
    model = JaxANNVQVAE(JaxVQVAEConfig(**inp["cfg"]))
    variables = {"params": inp["params"]}
    mesh = jax_tp.make_mesh_2d(dp, tp)
    state = jax_tp.shard_state_tp(jax_state.create_train_state(model, variables), mesh)
    new, metrics = jax_stage1.make_train_step_vqvae(inp["variance"], donate=False)(
        state, jax_tp.shard_batch_2d(jnp.asarray(inp["images"]), mesh))
    codes = jax.jit(lambda v, x: model.apply(v, x, method=model.encode_indices))(
        variables, jnp.asarray(inp["images"]))
    return (float(metrics["loss"]), weights.ann_vqvae_state_dict(_to_np(new.params)),
            np.asarray(codes))


def _jax_snn_vae(inp, dp, tp):
    """JAX's SNN-VAE step (``cli._run_snn_vae``'s) over ``make_mesh_2d(dp,
    tp)``, and the eval forward's binary latents before it."""
    model = JaxSNNVAE(JaxSNNVAEConfig(**inp["cfg"]), vq_cfg=JaxVQVAEConfig(**inp["vq_cfg"]))
    variables = {"params": inp["params"], "batch_stats": inp["batch_stats"]}
    mesh = jax_tp.make_mesh_2d(dp, tp)
    state = jax_tp.shard_state_tp(jax_state.create_train_state(model, variables), mesh)
    images = jax_tp.shard_batch_2d(jnp.asarray(inp["images"]), mesh)

    @jax.jit
    def step(state, batch, key):
        def loss_fn(params, bs):
            out, mut = model.apply({"params": params, "batch_stats": bs}, batch, key,
                                   train=True, p_scheduled=inp["p_scheduled"],
                                   mutable=["batch_stats"])
            return out["mmd_loss"] + out["recon_loss"], mut
        (loss, mut), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params, state.batch_stats)
        return state.apply_gradients(grads, new_batch_stats=mut["batch_stats"]), loss

    z = jax.jit(lambda v, x, k: model.apply(v, x, k, train=False)["z"])(
        variables, jnp.asarray(inp["images"]), inp["key"])
    new, loss = step(state, images, inp["key"])
    return (float(loss), weights.snn_vae_state_dict(_to_np(new.params),
                                                    _to_np(new.batch_stats)), np.asarray(z))


def _single_record(state, metrics, codes=None) -> dict:
    model = state.model
    return {"loss": float(metrics["loss"]),
            "state": {k: v.float().numpy().copy() for k, v in model.state_dict().items()},
            "grads": {n: p.grad.float().numpy().copy() for n, p in model.named_parameters()},
            "codes": None if codes is None else codes[0].numpy()}


def _single_stage1(inp, backend, dtype):
    """The port's single-process stage-1 step on the global batch."""
    cfg = VQVAEConfig(**inp["cfg"])
    state = create_train_state(weights.load_vqvae(
        inp["params"], inp["batch_stats"], cfg, device="cpu", lif_backend=backend,
        train=True, dtype=worker.DTYPES[dtype]))
    codes = worker._codes_recorder(state.model)
    metrics = stage1.make_train_step_vqvae(inp["variance"])(state, torch.from_numpy(inp["images"]))
    return _single_record(state, metrics, codes)


def _single_stage2(inp, backend, dtype, steps=1):
    """The port's single-process stage-2 step(s) on the global batch."""
    cfg = DiffusionConfig(**inp["cfg"])
    state = create_train_state(weights.load_denoiser(
        inp["params"], inp["batch_stats"], cfg, device="cpu", lif_backend=backend,
        train=True, dtype=worker.DTYPES[dtype]))
    step = stage2.make_train_step_diffusion(cfg)
    for corruption in inp["corruptions"][:steps]:
        metrics = step(state, torch.from_numpy(inp["x0"]),
                       corruption=tuple(torch.from_numpy(a) for a in corruption))
    return _single_record(state, metrics)


def _single_ann(inp):
    """The port's single-process stage-1 step of the ANN VQ-VAE."""
    cfg = VQVAEConfig(**inp["cfg"])
    state = create_train_state(weights.load_ann_vqvae(inp["params"], cfg, device="cpu",
                                                      train=True))
    codes = worker._codes_recorder(state.model)
    metrics = stage1.make_train_step_vqvae(inp["variance"])(state, torch.from_numpy(inp["images"]))
    return _single_record(state, metrics, codes)


def _single_snn_vae(inp):
    """The port's single-process SNN-VAE step on the given draws."""
    state = create_train_state(worker.snn_vae_model(inp))
    metrics = cli.make_train_step_snn_vae()(state, torch.from_numpy(inp["images"]), None,
                                            inp["p_scheduled"], draws=worker.snn_vae_draws(inp))
    return _single_record(state, metrics)


@pytest.fixture(scope="module")
def problem():
    """(the inputs, the references, the 2 x 2 ranks' results, the 1 x 2's)."""
    torch.set_num_threads(1)
    inputs, key = _inputs()
    with ThreadPoolExecutor(2) as pool:
        ranks = pool.submit(parallel.launch, worker.run_cases, 4, args=(inputs,), device="cpu")
        ranks_1x2 = pool.submit(parallel.launch, worker.run_cases_1x2, 2, args=(inputs,),
                                device="cpu")
        refs = {"jax": {}, "single": {}}
        for mesh, (dp, tp) in worker.MESHES.items():
            for case in ("stage1", "stage1_uni"):
                refs["jax"][mesh, case] = _jax_stage1(inputs[case], dp, tp)
            refs["jax"][mesh, "stage2"] = _jax_stage2(inputs["stage2"], key, dp, tp)
        for backend, dtype in worker.STAGE1_CASES:
            refs["single"][f"stage1_{backend}_{dtype}"] = _single_stage1(
                inputs["stage1"], backend, dtype)
        refs["single"]["stage1_uni"] = _single_stage1(inputs["stage1_uni"], "auto", "fp32")
        for backend, dtype in worker.STAGE2_CASES:
            refs["single"][f"stage2_{backend}_{dtype}"] = _single_stage2(
                inputs["stage2"], backend, dtype)
        refs["single"]["stage2_resumed"] = _single_stage2(inputs["stage2"], "torch", "fp32", 2)
        refs["jax"]["2x2", "ann_vqvae"] = _jax_ann(inputs["ann_vqvae"], 2, 2)
        refs["jax"]["2x2", "snn_vae"] = _jax_snn_vae(inputs["snn_vae"], 2, 2)
        refs["single"]["ann_vqvae"] = _single_ann(inputs["ann_vqvae"])
        refs["single"]["snn_vae"] = _single_snn_vae(inputs["snn_vae"])
        results = ranks.result(timeout=RANKS_TIMEOUT_S)
        results_1x2 = ranks_1x2.result(timeout=RANKS_TIMEOUT_S)
    return inputs, refs, results, results_1x2


# --- the plan ---------------------------------------------------------------------


MODELS = ["vqvae", "denoiser", "ann_vqvae", "snn_vae"]


def _jax_flagship(model_name):
    """(the JAX module, its variables' shapes at the flagship widths)."""
    images = jnp.zeros((2, 28, 28, 1))
    if model_name == "vqvae":
        model, args = JaxSNNVQVAE(JaxVQVAEConfig(), backend="scan"), (images,)
    elif model_name == "ann_vqvae":
        model, args = JaxANNVQVAE(JaxVQVAEConfig()), (images,)
    elif model_name == "snn_vae":
        model = JaxSNNVAE(JaxSNNVAEConfig(), vq_cfg=JaxVQVAEConfig())
        args = (images, jax.random.PRNGKey(1))
    else:
        model = JaxDenoiser(JaxDiffusionConfig(), backend="scan")
        args = (jnp.zeros((2, 7, 7), jnp.int32), jnp.ones((2,), jnp.int32))
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *args, train=True))
    return {"params": shapes["params"], "batch_stats": shapes.get("batch_stats", {})}


def _port_names(model_name, params, stats, dcfg=DiffusionConfig()):
    if model_name == "vqvae":
        return weights.vqvae_state_dict(params, stats)
    if model_name == "ann_vqvae":
        return weights.ann_vqvae_state_dict(params)
    if model_name == "snn_vae":
        return weights.snn_vae_state_dict(params, stats)
    return weights.denoiser_state_dict(params, stats, dcfg)


def _port_flagship(model_name):
    return {"vqvae": lambda: SNNVQVAE(VQVAEConfig()),
            "denoiser": lambda: SpikingDenoiser(DiffusionConfig()),
            "ann_vqvae": lambda: ANNVQVAE(VQVAEConfig()),
            "snn_vae": lambda: SNNVAE(SNNVAEConfig(), VQVAEConfig())}[model_name]()


def _sharded_dims(tree):
    """Each JAX leaf's spec as an array of its shape: the index along the
    sharded dim, or -1 everywhere for a replicated leaf."""
    def encode(leaf):
        spec = list(leaf.sharding.spec) + [None] * leaf.ndim
        if "model" not in spec[:leaf.ndim]:
            return np.full(leaf.shape, -1.0, np.float32)
        dim = spec.index("model")
        index = np.arange(leaf.shape[dim], dtype=np.float32).reshape(
            [-1 if i == dim else 1 for i in range(leaf.ndim)])
        return np.broadcast_to(index, leaf.shape).copy()

    return jax.tree_util.tree_map(encode, tree)


def _varying_dim(a: np.ndarray):
    """The one dim along which ``a`` varies, or None if it is -1 throughout."""
    if a.size and (a == -1).all():
        return None
    dims = [d for d in range(a.ndim) if a.shape[d] > 1 and (np.diff(a, axis=d) != 0).any()]
    assert len(dims) == 1, dims
    return dims[0]


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("model_name", MODELS)
def test_param_spec_matches_jax_at_flagship_widths(model_name, tp):
    shapes = _jax_flagship(model_name)
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    mesh = jax_tp.make_mesh_2d(1, tp)
    want = _port_names(model_name,
                       *(_sharded_dims(jax_tp.shard_variables_tp(zeros[c], mesh))
                         for c in ("params", "batch_stats")))
    plan = parallel.shard_plan(_port_flagship(model_name), tp)
    assert set(plan) == set(want)
    assert {n: plan[n] for n in plan} == {n: _varying_dim(a) for n, a in want.items()}
    assert any(d is not None for d in plan.values())
    if model_name == "vqvae" and tp == 2:  # what stays whole: alpha and the 32 -> 1 deconv
        assert [n for n, d in plan.items() if d is None] == [
            "vq_layer.alpha", "decoder.deconvs.2.weight", "decoder.deconvs.2.bias"]
    if model_name == "denoiser":  # every tensor, the readout's too (logits sharded on K)
        assert all(d is not None for d in plan.values())
    if model_name == "ann_vqvae":  # what stays whole: the 32 -> 1 deconv
        assert [n for n, d in plan.items() if d is None] == ["dec3.weight", "dec3.bias"]
    if model_name == "snn_vae":  # the heads' and cells' Linears are sharded on their rows
        assert plan["before_latent.weight"] == plan["posterior.mlp.denses.2.weight"] == 0


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("model_name", MODELS)
def test_rank_slices_equal_jax_device_shards(model_name, tp):
    """Each rank (d, m)'s slices of the same variables equal JAX's shards on
    device d * tp + m of ``make_mesh_2d(2, tp)``."""
    torch.manual_seed(0)
    gen = torch.Generator().manual_seed(1)
    dcfg = DiffusionConfig(**DEN_KW)
    if model_name == "vqvae":
        cfg = VQVAEConfig(**VQ_KW)
        params, stats = weights.init_vqvae_variables(cfg, gen)
        port = SNNVQVAE(cfg)
    elif model_name == "ann_vqvae":
        cfg = VQVAEConfig(**VQ_KW)
        params, stats = weights.init_ann_vqvae_variables(cfg, gen), {}
        port = ANNVQVAE(cfg)
    elif model_name == "snn_vae":
        cfg, vcfg = SNNVAEConfig(**SNN_KW), VQVAEConfig(**SNN_VQ_KW)
        params, stats = weights.init_snn_vae_variables(cfg, vcfg, gen)
        port = SNNVAE(cfg, vcfg)
    else:
        params, stats = weights.init_denoiser_variables(dcfg, gen)
        port = SpikingDenoiser(dcfg)
    names = lambda p, s: _port_names(model_name, p, s, dcfg)  # noqa: E731
    plan = parallel.shard_plan(port, tp)
    full = {k: torch.from_numpy(v) for k, v in names(params, stats).items()}
    mesh = jax_tp.make_mesh_2d(2, tp)
    sharded = [jax_tp.shard_variables_tp(t, mesh) for t in (params, stats)]
    for d in range(2):
        for m in range(tp):
            device = mesh.devices[d, m]
            shard = [jax.tree_util.tree_map(
                lambda leaf: np.asarray(next(s.data for s in leaf.addressable_shards
                                             if s.device == device)), t) for t in sharded]
            want = names(*shard)
            rank = types.SimpleNamespace(tp=tp, model=types.SimpleNamespace(rank=m))
            got = parallel.shard_variables_tp(full, rank, plan)
            assert set(got) == set(want)
            for n in got:
                np.testing.assert_array_equal(got[n].numpy(), want[n], err_msg=f"{n} ({d}, {m})")


def test_unshard_of_shard_is_bitwise_whole(problem):
    assert problem[2]["mesh"]["round_trip"]


def test_shard_state_tp_slices_adamw_moments(problem):
    got = problem[2]["stage2_resumed"]
    assert got["moments_sliced"] and got["step_kept"]


def test_resumed_tp_step_matches_two_single_process_steps(problem):
    """A state that took one single-process step, sharded with its AdamW
    moments, then a TP step: the single process's second step."""
    _, refs, results, _ = problem
    _hold_jax_tolerance(results["stage2_resumed"], refs["single"]["stage2_resumed"]["loss"],
                        refs["single"]["stage2_resumed"]["state"])


# --- the mesh and its errors ---------------------------------------------------------


def test_make_mesh_2d_coordinates_and_groups(problem):
    mesh = problem[2]["mesh"]
    assert (mesh["device"], mesh["backend"]) == ("cpu", "gloo")
    # global rank, data index, model index, the data group, the model group
    assert mesh["ranks"] == [[0, 0, 0, 0, 2, 0, 1], [1, 0, 1, 1, 3, 0, 1],
                             [2, 1, 0, 0, 2, 2, 3], [3, 1, 1, 1, 3, 2, 3]]
    assert mesh["batch_rows"] == [0, 1, 2, 3]  # rank 0: data index 0's half of the batch


@pytest.mark.parametrize("name,message", [
    ("world_1x2", "need 2 ranks, the process group has 4"),
    ("world_4x2", "need 8 ranks, the process group has 4"),
    ("no_tp_form", "has no tensor-parallel form"),
])
def test_mesh_and_model_errors(problem, name, message):
    assert message in problem[2]["errors"][name]


@pytest.mark.parametrize("name", ["make_mesh_2d", "stage1", "stage2", "snn_vae"])
def test_tp_entry_points_default_to_cuda(problem, name):
    """On a rank with no card, the mesh and the TP step builders called
    without a device raise instead of running on the CPU."""
    assert "no CUDA device" in problem[2]["errors"][name]


def test_replicate_and_broadcast_on_a_group_without_rank0(problem):
    """Over the model groups {0, 1} and {2, 3}: each takes its first rank's
    object and weights."""
    rows = problem[2]["subgroup"]["rows"]
    for rank in range(4):
        first = rank - rank % 2
        torch.manual_seed(first)
        want = torch.nn.Linear(3, 2).weight.detach().reshape(-1).numpy()
        assert rows[rank, 0] == first
        np.testing.assert_array_equal(rows[rank, 1:], want)


# --- the collectives -------------------------------------------------------------------


def _fd(total, xs):
    """Central differences of ``total(xs)`` with respect to every element
    of every array of ``xs``."""
    grads = []
    for r, x in enumerate(xs):
        g = np.zeros(x.shape)
        for i in np.ndindex(x.shape):
            up = [a.clone() for a in xs]
            down = [a.clone() for a in xs]
            up[r][i] += FD_EPS
            down[r][i] -= FD_EPS
            g[i] = (total(up) - total(down)) / (2 * FD_EPS)
        grads.append(g)
    return np.stack(grads)


@pytest.mark.parametrize("name", ["copy", "channels", "rows"])
def test_collective_matches_finite_differences(problem, name):
    """``copy_to_model``: each model rank's loss of the replicated input,
    the gradient of their sum on every rank; the gathers: one replicated
    loss of the gathered tensor, each rank's slice of its gradient."""
    got = problem[2]["fd"][name]
    tp = 2
    inputs = [worker.fd_inputs(m) for m in range(tp)]
    if name == "copy":
        x0 = inputs[0][0]
        np.testing.assert_array_equal(got["value"], x0.numpy())

        def total(xs):
            return float(sum(worker.fd_loss(xs[0], w) for _, w in inputs))

        want = _fd(total, [x0])[0]
    else:
        dim = 1 if name == "channels" else 0
        w = worker.fd_gather_weight(dim, tp)
        xs = [x for x, _ in inputs]
        np.testing.assert_array_equal(got["value"], torch.cat(xs, dim).numpy())

        def total(xs):
            return float(worker.fd_loss(torch.cat(xs, dim), w))

        want = _fd(total, xs)
    np.testing.assert_allclose(got["grad"], want, **FD_TOL)


# --- the steps ---------------------------------------------------------------------------


def _hold_jax_tolerance(got, want_loss, want_state):
    assert got["metrics"]["loss"] == pytest.approx(want_loss, rel=JAX_LOSS_RTOL)
    assert set(got["state"]) == set(want_state)
    for name, value in got["state"].items():
        np.testing.assert_allclose(value, want_state[name], err_msg=name, **JAX_PARAM_TOL)


@pytest.mark.parametrize("case", ["stage1", "stage1_uni", "stage2"])
@pytest.mark.parametrize("mesh", list(worker.MESHES))
def test_tp_step_matches_jax_mesh_step(problem, mesh, case):
    _, refs, results, results_1x2 = problem
    if mesh == "2x2":
        got = results[{"stage1": "stage1_auto_fp32", "stage2": "stage2_torch_fp32"}.get(case, case)]
    else:
        got = results_1x2[case]
    loss, state, codes = refs["jax"][mesh, case]
    _hold_jax_tolerance(got, loss, state)
    if codes is not None and got["eval_codes"] is not None:
        np.testing.assert_array_equal(got["eval_codes"], codes)
    assert got["replicas_equal"]


@pytest.mark.parametrize("case", list(worker.BASELINES))
def test_baseline_tp_step_matches_jax_mesh_step(problem, case):
    """The ANN VQ-VAE's and the SNN-VAE's TP step on the 2 x 2 mesh against
    JAX's on ``make_mesh_2d(2, 2)``; the ANN's codes and the SNN-VAE's
    binary latents (its eval forward on JAX's draws) equal JAX's."""
    _, refs, results, _ = problem
    got = results[case]
    loss, state, codes = refs["jax"]["2x2", case]
    _hold_jax_tolerance(got, loss, state)
    assert 0.05 < float(np.mean(codes)) < 0.95 if case == "snn_vae" else len(np.unique(codes)) > 1
    np.testing.assert_array_equal(got["eval_codes"], codes)
    assert got["replicas_equal"]


@pytest.mark.parametrize("case", STAGE1_CASES + ["stage1_uni"] + STAGE2_CASES
                         + list(worker.BASELINES))
def test_tp_step_matches_single_process(problem, case):
    _, refs, results, _ = problem
    got, want = results[case], refs["single"][case]
    dtype = "bf16" if case.endswith("bf16") else "fp32"
    assert got["metrics"]["loss"] == pytest.approx(want["loss"], rel=LOSS_RTOL)
    if want["codes"] is not None:
        np.testing.assert_array_equal(got["codes"], want["codes"])
    assert set(got["grads"]) == set(want["grads"])
    fp32 = refs["single"][case.replace("bf16", "fp32")]["grads"]
    for name, g in got["grads"].items():
        w = want["grads"][name]
        if dtype == "fp32":
            np.testing.assert_allclose(g, w, err_msg=name, **GRAD_TOL_FP32)
        elif np.abs(fp32[name]).max() < NOISE_GRAD:
            np.testing.assert_allclose(got["state"][name], want["state"][name], rtol=1e-4,
                                       atol=NOISE_PARAM_ATOL, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=BF16_ULP, atol=BF16_ULP * np.abs(w).max(),
                                       err_msg=name)
    for name, value in got["state"].items():
        if name.endswith((".mean", ".var")):
            np.testing.assert_allclose(value, want["state"][name], err_msg=name, **STATS_TOL)


@pytest.mark.parametrize("case", STAGE1_CASES + ["stage1_uni"] + STAGE2_CASES
                         + ["stage2_resumed"] + list(worker.BASELINES))
def test_replicas_stay_bitwise_equal(problem, case):
    """Every tensor equal over the data group, every replicated one over the
    model group."""
    assert problem[2][case]["replicas_equal"]


@pytest.mark.parametrize("case", STAGE2_CASES)
def test_stage2_collectives_by_group(problem, case):
    """Over the model group: a gather after each block and of the logits,
    a sum of the input gradient of each conv but the first; over the data
    group: each BN's moments forward and backward, and one all-reduce of
    the gradients and the loss."""
    assert problem[2][case]["collectives"] == {"model": 2 * N_BN + 1, "data": 2 * N_BN + 1}
