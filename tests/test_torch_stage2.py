"""One stage-2 training step of the port against the JAX package's.

A tiny denoiser (T=4, channels 8-16-16-32-16, K=16, 7x7 codes, 8
timesteps, batch 4) is initialised by JAX ``SpikingDenoiser.init(...,
train=True)`` and carried into the port by ``models/weights.py``. The
JAX step is the package's own ``make_train_step_diffusion(cfg,
donate=False)(state, x0, key)``; the port's step gets the corruption that
JAX ``diffusion.corrupt`` draws from the same key. Branches: layerwise
(JAX 'scan' and 'pallas' in interpret mode against the port's 'auto', K1
plain versions here), fused (both 'bnlif', K3) and fully fused (both
'bnlifconv', K4 and K3). After one step:

* the loss within 1e-5;
* the gradients within rtol 2e-3, atol 2e-4, the JAX package's own
  tolerance between its branches (tests/test_denoiser_bnlif.py);
* the new BN running statistics within rtol 1e-5, atol 1e-6: the batch
  moments are fp32 sums of up to T*N*H*W values, which XLA on the CPU
  adds in sequence and PyTorch in another order, and block 0's input is
  the raw token map, whose E[x^2] is large against its variance;
* the parameters after AdamW within 1e-6 of optax's. The conv biases
  ahead of a training-mode BN are the exception: BN subtracts the batch
  mean, so their gradient is zero in exact arithmetic and both sides
  hold rounding noise (below 1e-7) that AdamW scales towards +-lr. For
  them the test checks that the noise is that small on both sides and
  that neither moved further than AdamW can move a parameter. The port's
  AdamW fed JAX's gradients is held within 1e-6 of optax on every
  parameter, those biases included.

One bf16 step per branch (layerwise, 'bnlif', 'bnlifconv') against
JAX's bf16 step (``SpikingDenoiser(dtype=bfloat16)``): finite, the loss
within 5 % of JAX's (the JAX package's bf16 bound, tests/test_bf16.py)
and nearer JAX's bf16 loss than the port's own fp32 loss of the same
corruption, every conv's input (the spikes) and output in bf16, fp32
parameters and gradients.

Also: three steps of ``train_diffusion`` lower the loss of a fixed
corruption, the trained denoiser samples in eval mode (as JAX samples
with ``train=False``) and stays in training mode, and a checkpoint round
trip restores identical tensors and step.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spiking_diffusion_tpu.config import DiffusionConfig as JaxDiffusionConfig
from spiking_diffusion_tpu.models import diffusion as jax_diffusion
from spiking_diffusion_tpu.models.denoiser import SpikingDenoiser as JaxDenoiser
from spiking_diffusion_tpu.ops import bn_lif as jax_bn_lif
from spiking_diffusion_tpu.ops import pallas_lif
from spiking_diffusion_tpu.ops import spike_conv as jax_spike_conv
from spiking_diffusion_tpu.train import state as jax_state
from spiking_diffusion_tpu.train.stage2 import make_train_step_diffusion as jax_make_step
from spiking_diffusion_tpu_torch import generate
from spiking_diffusion_tpu_torch.config import DiffusionConfig
from spiking_diffusion_tpu_torch.models import diffusion, weights
from spiking_diffusion_tpu_torch.models.layers import SeqConv
from spiking_diffusion_tpu_torch.train import checkpoint, stage2
from spiking_diffusion_tpu_torch.train.state import create_train_state

KW = dict(num_timesteps=8, denoiser_channels=(8, 16, 16, 32, 16), num_embeddings=16,
          mask_id=16, num_steps=4)
JCFG, CFG = JaxDiffusionConfig(**KW), DiffusionConfig(**KW)
BATCH = 4
LR = 1e-3
TRAIN_LR = 1e-2  # three steps at 1e-3 move this tiny model's loss by ~1e-5
BRANCHES = {  # JAX backend -> the port's
    "layerwise_scan": ("scan", "auto"),
    "layerwise_pallas": ("pallas", "auto"),
    "bnlif": ("bnlif", "bnlif"),
    "bnlifconv": ("bnlifconv", "bnlifconv"),
}
BF16_LOSS_RTOL = 0.05  # tests/test_bf16.py: bf16 loss within 5 % of fp32
LOSS_ATOL = 1e-5
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)
STATS_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_ATOL = 1e-6
NOISE_GRAD = 1e-7  # |gradient| below this counts as rounding noise around 0
# conv biases whose gradient BN cancels: every conv but the readout
BN_CANCELLED = tuple(f"convs.{i}.bias" for i in range(len(KW["denoiser_channels"])))


@pytest.fixture(autouse=True)
def setup():
    torch.set_num_threads(1)
    old = pallas_lif._INTERPRET, jax_bn_lif._INTERPRET, jax_spike_conv._INTERPRET
    pallas_lif._INTERPRET = jax_bn_lif._INTERPRET = jax_spike_conv._INTERPRET = True
    yield
    pallas_lif._INTERPRET, jax_bn_lif._INTERPRET, jax_spike_conv._INTERPRET = old


@pytest.fixture(scope="module")
def problem():
    """(x0, key, JAX variables as numpy, the corruption JAX draws)."""
    x0 = np.random.RandomState(0).randint(0, 16, (BATCH, 7, 7)).astype(np.int32)
    init = JaxDenoiser(JCFG, backend="scan").init
    variables = jax.jit(lambda k, x, t: init(k, x, t, train=True))(
        jax.random.PRNGKey(0), jnp.asarray(x0), jnp.ones((BATCH,), jnp.int32))
    variables = jax.tree_util.tree_map(np.asarray, jax.device_get(variables))
    key = jax.random.PRNGKey(3)
    corruption = [np.array(a) for a in jax_diffusion.corrupt(key, jnp.asarray(x0), JCFG)]
    return x0, key, variables, corruption


def _jax_step(backend, x0, key, variables):
    """(loss, grads, new params, new batch stats) of the JAX step, all numpy;
    the grads from ``jax.value_and_grad`` of the step's own loss."""
    model = JaxDenoiser(JCFG, backend=backend)
    params, stats = variables["params"], variables["batch_stats"]

    def loss_fn(p):
        def denoise(x_t, t):
            return model.apply({"params": p, "batch_stats": stats}, x_t, t, train=True,
                               mutable=["batch_stats"])[0]
        return jax_diffusion.train_loss(key, denoise, jnp.asarray(x0), JCFG)

    grads = jax.jit(jax.grad(loss_fn))(params)
    state = jax_state.create_train_state(model, variables)
    new_state, metrics = jax_make_step(JCFG, donate=False)(state, jnp.asarray(x0), key)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return (float(metrics["loss"]), to_np(grads), to_np(new_state.params),
            to_np(new_state.batch_stats), state)


def _port_state(variables, backend, dtype=None):
    den = weights.load_denoiser(variables["params"], variables["batch_stats"], CFG,
                                device="cpu", lif_backend=backend, train=True, dtype=dtype)
    return create_train_state(den)


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_one_step_matches_jax(problem, branch):
    x0, key, variables, corruption = problem
    jax_backend, port_backend = BRANCHES[branch]
    loss_j, grads_j, params_j, stats_j, jstate = _jax_step(jax_backend, x0, key, variables)

    state = _port_state(variables, port_backend)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    metrics = stage2.make_train_step_diffusion(CFG)(
        state, torch.from_numpy(x0), corruption=tuple(torch.from_numpy(a) for a in corruption))
    assert state.step == 1
    assert abs(float(metrics["loss"]) - loss_j) <= LOSS_ATOL

    grads = weights.denoiser_state_dict(grads_j, variables["batch_stats"], CFG)
    new = weights.denoiser_state_dict(params_j, stats_j, CFG)
    after = state.model.state_dict()
    largest = 0.0
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[name], err_msg=name, **GRAD_TOL)
        diff = float(np.abs(after[name].numpy() - new[name]).max())
        if name in BN_CANCELLED:
            assert np.abs(grads[name]).max() < NOISE_GRAD and p.grad.abs().max() < NOISE_GRAD
            bound = LR * (1.0 + 1e-3 * before[name].abs()) + 1e-7
            for moved in (after[name] - before[name], torch.tensor(new[name]) - before[name]):
                assert (moved.abs() <= bound).all(), name
        else:
            assert diff <= PARAM_ATOL, (name, diff)
            largest = max(largest, diff)
    print(f"{branch}: largest |param difference| after AdamW {largest:.3g}")
    for name in after:
        if name.endswith((".mean", ".var")):
            np.testing.assert_allclose(after[name].numpy(), new[name], err_msg=name, **STATS_TOL)

    # the port's AdamW fed JAX's gradients against optax, every parameter
    optax_params = weights.denoiser_state_dict(
        jax.tree_util.tree_map(np.asarray, jstate.apply_gradients(
            jax.tree_util.tree_map(jnp.asarray, grads_j)).params),
        variables["batch_stats"], CFG)
    state = _port_state(variables, port_backend)
    for name, p in state.model.named_parameters():
        p.grad = torch.from_numpy(grads[name].copy())
    state.optimizer.step()
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), optax_params[name], rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)


def _conv_dtypes(model, run):
    """(every dtype that a conv of ``model`` took in or gave out, run())."""
    seen = set()

    def hook(module, args, out):
        seen.update((args[0].dtype, (out[0] if isinstance(out, tuple) else out).dtype))

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, SeqConv)]
    try:
        return seen, run()
    finally:
        for h in handles:
            h.remove()


@pytest.mark.parametrize("branch", ["layerwise_scan", "bnlif", "bnlifconv"])
def test_one_bf16_step_matches_jax(problem, branch):
    """The bf16 denoiser's step against JAX's bf16 step on the same
    corruption: finite, within 5 % of JAX's loss (the JAX package's own
    bf16-against-fp32 bound) and nearer it than the fp32 loss, bf16 convs
    and spikes, every parameter moved to finite values."""
    x0, key, variables, corruption = problem
    jax_backend, port_backend = BRANCHES[branch]
    jstate = jax_state.create_train_state(
        JaxDenoiser(JCFG, backend=jax_backend, dtype=jnp.bfloat16), variables)
    loss_j = float(jax_make_step(JCFG, donate=False)(jstate, jnp.asarray(x0), key)[1]["loss"])
    corruption = tuple(torch.from_numpy(a) for a in corruption)
    loss_fp32 = _fixed_loss(_port_state(variables, port_backend).model, torch.from_numpy(x0),
                            corruption)
    state = _port_state(variables, port_backend, torch.bfloat16)
    dtypes, metrics = _conv_dtypes(state.model, lambda: stage2.make_train_step_diffusion(CFG)(
        state, torch.from_numpy(x0), corruption=corruption))
    loss = float(metrics["loss"])
    assert dtypes == {torch.bfloat16}, dtypes
    assert np.isfinite(loss) and np.isfinite(loss_j)
    assert abs(loss - loss_j) <= BF16_LOSS_RTOL * abs(loss_j), (loss, loss_j)
    assert abs(loss - loss_j) < abs(loss - loss_fp32), (loss, loss_j, loss_fp32)
    for name, p in state.model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, name
        assert bool(torch.isfinite(p).all()), name


def _fixed_loss(model, x0, corruption):
    """Training-mode loss of a fixed corruption, on a copy of ``model``."""
    probe = copy.deepcopy(model).train()
    with torch.no_grad():
        return float(diffusion.train_loss(probe, x0, CFG, corruption=corruption))


@pytest.mark.parametrize("backend", ["auto", "bnlif", "bnlifconv"])
def test_train_diffusion_lowers_the_loss(problem, backend):
    x0, _, variables, corruption = problem
    corruption = tuple(torch.from_numpy(a) for a in corruption)
    den = weights.load_denoiser(variables["params"], variables["batch_stats"], CFG,
                                device="cpu", lif_backend=backend, train=True)
    before = _fixed_loss(den, torch.from_numpy(x0), corruption)
    logged = []
    state = stage2.train_diffusion(den, CFG, x0, epochs=3, batch_size=BATCH,
                                   learning_rate=TRAIN_LR, seed=1, log_every=1,
                                   log_fn=logged.append, device="cpu")
    after = _fixed_loss(state.model, torch.from_numpy(x0), corruption)
    losses = [float(line.split("loss ")[1]) for line in logged if "loss" in line]
    assert state.step == 3 and len(losses) == 3 and np.isfinite(losses).all()
    assert np.isfinite(after) and after < before, (before, after)

    # sampling right after training uses the running statistics
    stats = {k: v.clone() for k, v in state.model.state_dict().items()}
    codes = generate.sample_codes(state.model, CFG, 3, generator=torch.Generator().manual_seed(5),
                                  device="cpu")
    assert state.model.training
    assert all(torch.equal(stats[k], v) for k, v in state.model.state_dict().items())
    eval_model = copy.deepcopy(state.model).eval()
    want = generate.sample_codes(eval_model, CFG, 3, generator=torch.Generator().manual_seed(5),
                                 device="cpu")
    assert torch.equal(codes, want) and int(codes.max()) < CFG.num_embeddings


def test_checkpoint_round_trip(problem, tmp_path):
    x0, key, variables, corruption = problem
    state = _port_state(variables, "auto")
    step = stage2.make_train_step_diffusion(CFG)
    gen = torch.Generator().manual_seed(0)
    step(state, torch.from_numpy(x0), gen)
    assert not checkpoint.checkpoint_exists(str(tmp_path))
    path = checkpoint.save_checkpoint(state, str(tmp_path))
    assert checkpoint.checkpoint_exists(str(tmp_path)) and path.endswith("model.pt")
    saved_model = {k: v.clone() for k, v in state.model.state_dict().items()}
    saved_opt = copy.deepcopy(state.optimizer.state_dict())
    step(state, torch.from_numpy(x0), gen)  # move everything on
    assert state.step == 2
    fresh = _port_state(variables, "auto")
    for restored in (checkpoint.restore_checkpoint(state, str(tmp_path)),
                     checkpoint.restore_checkpoint(fresh, str(tmp_path))):
        assert restored.step == 1
        for k, v in restored.model.state_dict().items():
            assert torch.equal(v, saved_model[k]), k
        opt = restored.optimizer.state_dict()
        assert opt["param_groups"] == saved_opt["param_groups"]
        for i, s in saved_opt["state"].items():
            for k, v in s.items():
                assert torch.equal(opt["state"][i][k], v), (i, k)
