"""The port's fully fused denoiser ('bnlifconv': every 3x3 conv on K4, BN
moments from K4, BN-apply + LIF on K3) against the JAX package's
``SpikingDenoiser(backend="bnlifconv")`` on the same converted weights.

Both sides run on the CPU: the JAX package's Pallas kernels in interpret
mode, the port's kernels through their plain versions. The tolerances are
the JAX package's own between its fused and layerwise denoisers
(tests/test_denoiser_fusedconv.py), since K4's sums (conv and moments) run
in another order on each side: logits within rtol 1e-4, atol 1e-4; the
new BN running statistics within rtol 1e-5, atol 1e-5; parameter
gradients within rtol 2e-3, atol 2e-4; bf16 logits in fp32, finite,
within rtol 0.1, atol 0.15 of the fp32 logits and within 1e-3 of JAX's
bf16 logits, from which the fp32 logits stand further off, with every
conv's input (the spikes) and output in bf16.
The state dict is the same, key for key and shape for shape, on every
branch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spiking_diffusion_tpu.config import DiffusionConfig as JaxDiffusionConfig
from spiking_diffusion_tpu.models.denoiser import SpikingDenoiser as JaxDenoiser
from spiking_diffusion_tpu.ops import bn_lif as jax_bn_lif
from spiking_diffusion_tpu.ops import spike_conv as jax_spike_conv
from spiking_diffusion_tpu_torch.config import DiffusionConfig
from spiking_diffusion_tpu_torch.models import weights
from spiking_diffusion_tpu_torch.models.layers import SeqConv

KW = dict(num_timesteps=8, denoiser_channels=(6, 10), num_embeddings=12, mask_id=12,
          num_steps=4)
JCFG, CFG = JaxDiffusionConfig(**KW), DiffusionConfig(**KW)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
STATS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)
BF16_TOL = dict(rtol=0.1, atol=0.15)
BF16_JAX_ATOL = 1e-3  # bf16 against bf16: the same roundings on both sides


@pytest.fixture(autouse=True)
def setup():
    torch.set_num_threads(1)
    old = jax_spike_conv._INTERPRET, jax_bn_lif._INTERPRET
    jax_spike_conv._INTERPRET = jax_bn_lif._INTERPRET = True
    yield
    jax_spike_conv._INTERPRET, jax_bn_lif._INTERPRET = old


@pytest.fixture(scope="module")
def problem():
    """(tokens, t, numpy variables): JAX's init, 1-D parameters moved off
    their identity values as the JAX package's own test does."""
    rs = np.random.RandomState(0)
    x = rs.randint(0, CFG.num_embeddings + 1, (4, 7, 7)).astype(np.int32)
    t = np.asarray([1, 3, 5, 7], np.int32)
    init = JaxDenoiser(JCFG, backend="scan").init
    variables = jax.jit(lambda k, x, t: init(k, x, t, train=True))(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t))
    variables = jax.tree_util.tree_map(np.asarray, jax.device_get(variables))
    params = jax.tree_util.tree_map(lambda a: a + 0.05 if a.ndim == 1 else a,
                                    variables["params"])
    return x, t, {"params": params, "batch_stats": variables["batch_stats"]}


def _jax_apply(variables, x, t, train, dtype=None):
    model = JaxDenoiser(JCFG, backend="bnlifconv", dtype=dtype)
    out = jax.jit(lambda v, x, t: model.apply(v, x, t, train=train,
                                              mutable=["batch_stats"] if train else False)
                  )(variables, jnp.asarray(x), jnp.asarray(t))
    return jax.tree_util.tree_map(np.asarray, out)


def _port(variables, backend="bnlifconv", train=True, dtype=None):
    return weights.load_denoiser(variables["params"], variables["batch_stats"], CFG,
                                 device="cpu", lif_backend=backend, train=train, dtype=dtype)


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_logits_and_running_statistics_match_jax(problem, mode):
    x, t, variables = problem
    train = mode == "train"
    out = _jax_apply(variables, x, t, train)
    logits_j = out[0] if train else out
    den = _port(variables, train=train)
    logits = den(torch.from_numpy(x), torch.from_numpy(t)).detach()
    assert logits.dtype == torch.float32 and logits.shape == logits_j.shape
    assert float(logits.std()) > 0.0
    np.testing.assert_allclose(logits.numpy(), logits_j, **LOGIT_TOL)
    new = weights.denoiser_state_dict(
        variables["params"], out[1]["batch_stats"] if train else variables["batch_stats"],
        CFG)
    for name, value in den.state_dict().items():
        if name.endswith((".mean", ".var")):
            np.testing.assert_allclose(value.numpy(), new[name], err_msg=name, **STATS_TOL)


def test_parameter_gradients_match_jax(problem):
    x, t, variables = problem
    model = JaxDenoiser(JCFG, backend="bnlifconv")

    def loss(params):
        y, _ = model.apply({**variables, "params": params}, jnp.asarray(x), jnp.asarray(t),
                           train=True, mutable=["batch_stats"])
        w = jnp.sin(jnp.arange(y.size, dtype=jnp.float32))
        return jnp.sum(y.reshape(-1) * w) / y.size

    grads_j = weights.denoiser_state_dict(
        jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss))(variables["params"])),
        variables["batch_stats"], CFG)
    den = _port(variables)
    y = den(torch.from_numpy(x), torch.from_numpy(t))
    w = torch.sin(torch.arange(y.numel(), dtype=torch.float32))
    (torch.sum(y.reshape(-1) * w) / y.numel()).backward()
    for name, p in den.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads_j[name], err_msg=name, **GRAD_TOL)


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


def test_bf16_logits_fp32_and_track_fp32(problem):
    x, t, variables = problem
    logits, dtypes = {}, {}
    for name, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        den = _port(variables, dtype=dtype)
        dtypes[name], out = _conv_dtypes(
            den, lambda: den(torch.from_numpy(x), torch.from_numpy(t)))
        logits[name] = out.detach()
    assert dtypes == {"fp32": {torch.float32}, "bf16": {torch.bfloat16}}
    logits_j = _jax_apply(variables, x, t, True, jnp.bfloat16)[0]
    assert logits["bf16"].dtype == torch.float32 and logits_j.dtype == np.float32
    assert bool(torch.isfinite(logits["bf16"]).all())
    np.testing.assert_allclose(logits["bf16"].numpy(), logits["fp32"].numpy(), **BF16_TOL)
    np.testing.assert_allclose(logits["bf16"].numpy(), logits_j, rtol=0, atol=BF16_JAX_ATOL)
    # the bound tells bf16 from fp32: the fp32 logits lie outside it
    assert float(np.abs(logits["fp32"].numpy() - logits_j).max()) > 10 * BF16_JAX_ATOL


def test_state_dict_is_the_same_on_every_branch(problem):
    _, _, variables = problem
    dicts = {b: _port(variables, backend=b).state_dict()
             for b in ("auto", "bnlif", "bnlifconv", "bnlifconv_torch")}
    want = {k: tuple(v.shape) for k, v in dicts["auto"].items()}
    for backend, sd in dicts.items():
        assert {k: tuple(v.shape) for k, v in sd.items()} == want, backend
        assert all(torch.equal(v, dicts["auto"][k]) for k, v in sd.items()), backend
