"""The port's SNN-VAE (``--model snn-vae``) against the JAX package's
``SNNVAE``.

A narrow model (28x28x1 images, encoder 4-8, D=16 on the 7x7 grid the
JAX decoder input fixes, decoder 8-4, latent C=8, k=4, batch 4) is
initialised by JAX ``SNNVAE.init`` and carried into the port by
``models/weights.py``, with BN and the Dense layers moved off their
initialisation so that every LIF layer fires at these widths. Every draw
of the port is fed JAX's own, recomputed from the same key splits: the
posterior's channel ``choice``, the prior's scheduled-sampling coins and
its N(0, 1) jitter, and the sampler's ``choice``.

* At T = 8 (scheduled sampling acts from t = 5): the posterior's z and
  the prior's and sampler's latents equal JAX's exactly, q_z and p_z
  within 1e-6, with the coins on (some step takes the prior's own
  sample, which changes p_z) and off.
* At T = 4 on the layerwise ('auto' against JAX 'scan') and fused
  ('bnlif', K3's plain versions, against JAX 'bnlif' in interpret mode)
  branches: the training forward's z exactly, recon, the MSE and the MMD
  loss within 1e-5, the gradients of loss = mmd + recon within 1e-5 and
  the new BN running statistics within rtol 1e-5, atol 1e-6; the eval
  forward and ``sample`` (z exactly, images within 1e-5); the CLI's
  train step and ``--vae_scheduled_p`` schedule.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spiking_diffusion_tpu.config import SNNVAEConfig as JaxSNNVAEConfig
from spiking_diffusion_tpu.config import VQVAEConfig as JaxVQVAEConfig
from spiking_diffusion_tpu.models.snn_vae import SNNVAE as JaxSNNVAE
from spiking_diffusion_tpu.ops import bn_lif as jax_bn_lif
from spiking_diffusion_tpu.ops import pallas_lif
from spiking_diffusion_tpu_torch import cli
from spiking_diffusion_tpu_torch.config import SNNVAEConfig, VQVAEConfig
from spiking_diffusion_tpu_torch.data import synthetic_dataset
from spiking_diffusion_tpu_torch.models import weights
from spiking_diffusion_tpu_torch.train.state import create_train_state

VQ_KW = dict(enc_channels=(4, 8), dec_channels=(8, 4))
VAE_KW = dict(latent_dim=8, k=4)
BATCH = 4
T_CELLS = 8  # the cells' tests: scheduled sampling acts from t = 5
T_MODEL = 4
BRANCHES = {"layerwise": ("scan", "auto"), "bnlif": ("bnlif", "bnlif")}
P_SCHEDULED = 0.9
ATOL = 1e-5
CELL_ATOL = 1e-6
STATS_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def setup():
    torch.set_num_threads(1)
    old = pallas_lif._INTERPRET, jax_bn_lif._INTERPRET
    pallas_lif._INTERPRET = jax_bn_lif._INTERPRET = True
    yield
    pallas_lif._INTERPRET, jax_bn_lif._INTERPRET = old


def _configs(t_steps):
    return (JaxSNNVAEConfig(num_steps=t_steps, **VAE_KW),
            JaxVQVAEConfig(num_steps=t_steps, **VQ_KW),
            SNNVAEConfig(num_steps=t_steps, **VAE_KW), VQVAEConfig(num_steps=t_steps, **VQ_KW))


def _widen(tree, rng):
    """BN scale and bias, and Dense kernels and biases, off their
    initialisation: the LIF layers fire at 10-60 % at these widths."""
    for key, node in tree.items():
        if key == "BatchNorm_0":
            node["scale"] = rng.uniform(1.5, 2.5, node["scale"].shape).astype(np.float32)
            node["bias"] = rng.uniform(-0.2, 0.4, node["bias"].shape).astype(np.float32)
        elif isinstance(node, dict) and "kernel" in node and node["kernel"].ndim == 2:
            fan_in = node["kernel"].shape[0]
            node["kernel"] = rng.normal(0, 3 / np.sqrt(fan_in), node["kernel"].shape
                                        ).astype(np.float32)
            node["bias"] = rng.uniform(0.5, 1.5, node["bias"].shape).astype(np.float32)
        elif isinstance(node, dict):
            _widen(node, rng)


def _images():
    return synthetic_dataset("MNIST", 8, 4).train_images[:BATCH] - 0.5


@functools.lru_cache(maxsize=None)
def _problem(t_steps, backend="scan"):
    """(JAX model, widened numpy variables, port configs); callers copy
    nothing out of it and change nothing in it."""
    jcfg, jvq, cfg, vq = _configs(t_steps)
    model = JaxSNNVAE(jcfg, vq_cfg=jvq, backend=backend)
    variables = jax.jit(lambda k1, x, k2: model.init(k1, x, k2, train=True))(
        jax.random.PRNGKey(0), jnp.asarray(_images()), jax.random.PRNGKey(1))
    variables = jax.tree_util.tree_map(np.array, jax.device_get(variables))
    _widen(variables["params"], np.random.RandomState(2))
    stats = variables["batch_stats"]
    rng = np.random.RandomState(3)
    for node in jax.tree_util.tree_leaves(stats, is_leaf=lambda n: "mean" in n):
        node["mean"] = rng.uniform(-0.2, 0.2, node["mean"].shape).astype(np.float32)
        node["var"] = rng.uniform(0.5, 1.5, node["var"].shape).astype(np.float32)
    return model, variables, cfg, vq


@pytest.fixture(scope="module")
def cells():
    return _problem(T_CELLS)


def _port(variables, cfg, vq, backend="auto", train=True):
    return weights.load_snn_vae(variables["params"], variables["batch_stats"], cfg, vq,
                                device="cpu", lif_backend=backend, train=train)


def _t(a):
    return torch.from_numpy(np.array(a))


def _binary(shape, seed):
    return (np.random.RandomState(seed).rand(*shape) < 0.4).astype(np.float32)


def test_posterior_equals_jax(cells):
    model, variables, cfg, vq = cells
    c, k = cfg.latent_dim, cfg.k
    latent = _binary((T_CELLS, BATCH, c), 4)
    key = jax.random.PRNGKey(5)
    z, q_z = model.apply(variables, jnp.asarray(latent), key,
                         method=lambda m, x, kk: m.posterior(x, kk))
    choice = jax.random.randint(key, (T_CELLS, BATCH, c), 0, k)
    port = _port(variables, cfg, vq)
    pz, pq = port.posterior(_t(latent), _t(choice))
    assert 0.1 < float(np.mean(np.asarray(q_z))) < 0.9
    np.testing.assert_array_equal(pz.detach().numpy(), np.asarray(z))
    np.testing.assert_allclose(pq.detach().numpy(), np.asarray(q_z), rtol=0, atol=CELL_ATOL)


@pytest.mark.parametrize("scheduled", [True, False])
def test_prior_equals_jax(cells, scheduled):
    model, variables, cfg, vq = cells
    c = cfg.latent_dim
    z = _binary((T_CELLS, BATCH, c), 6)
    key = jax.random.PRNGKey(7)

    def prior(sched):
        return np.asarray(model.apply(
            variables, jnp.asarray(z), key, P_SCHEDULED, sched,
            method=lambda m, zz, kk, p, s: m.prior(zz, kk, p, scheduled=s)))

    want = prior(scheduled)
    port = _port(variables, cfg, vq)
    if scheduled:
        k1, k2 = jax.random.split(key)
        draws = np.asarray(jax.random.uniform(k1, (T_CELLS,)))
        noise = np.asarray(jax.random.normal(k2, (T_CELLS, BATCH, c)))
        got = port.prior(_t(z), P_SCHEDULED, _t(draws), _t(noise))
        # some step t >= 5 took the prior's own sample, and that moved p_z
        assert np.any(draws[5:] < P_SCHEDULED)
        assert not np.array_equal(want, prior(False))
    else:
        got = port.prior(_t(z))
    assert 0.1 < float(np.mean(want)) < 0.9
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=CELL_ATOL)


def test_prior_sample_equals_jax(cells):
    model, variables, cfg, vq = cells
    choice = np.random.RandomState(8).randint(0, cfg.k, (T_CELLS, BATCH, cfg.latent_dim))
    want = model.apply(variables, jax.random.PRNGKey(0), BATCH, jnp.asarray(choice),
                       method=lambda m, kk, b, ch: m.prior.sample(kk, b, choice=ch))
    got = _port(variables, cfg, vq).prior.sample(_t(choice))
    assert 0.05 < float(np.mean(np.asarray(want))) < 0.95
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))


def _jax_draws(key, cfg):
    """The draws of JAX ``SNNVAE.__call__(image, key, train=True)``."""
    shape = (cfg.num_steps, BATCH, cfg.latent_dim)
    k1, k2 = jax.random.split(key)
    choice = jax.random.randint(k1, shape, 0, cfg.k)
    c1, c2 = jax.random.split(k2)
    return (_t(choice), _t(jax.random.uniform(c1, (cfg.num_steps,))),
            _t(jax.random.normal(c2, shape)))


def _grads_sd(grads, stats):
    sd = weights.snn_vae_state_dict(grads, stats)
    return {k: v for k, v in sd.items() if not k.endswith((".mean", ".var"))}


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_training_forward_and_gradients_equal_jax(branch):
    jax_backend, backend = BRANCHES[branch]
    model, variables, cfg, vq = _problem(T_MODEL, jax_backend)
    x = _images()
    key = jax.random.PRNGKey(9)
    stats = variables["batch_stats"]

    def loss_fn(p):
        out, mut = model.apply({"params": p, "batch_stats": stats}, jnp.asarray(x), key,
                               train=True, p_scheduled=P_SCHEDULED, mutable=["batch_stats"])
        return out["mmd_loss"] + out["recon_loss"], (out, mut["batch_stats"])

    (_, (jout, jstats)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    jout, jgrads, jstats = jax.tree_util.tree_map(np.asarray, (jout, jgrads, jstats))
    port = _port(variables, cfg, vq, backend)
    choice, draws, noise = _jax_draws(key, cfg)
    out = port(_t(x), p_scheduled=P_SCHEDULED, choice=choice, coin_draws=draws, noise=noise)
    assert 0.05 < float(np.mean(jout["z"])) < 0.95
    np.testing.assert_array_equal(out["z"].detach().numpy(), jout["z"])
    np.testing.assert_allclose(out["recon"].detach().numpy(), jout["recon"], rtol=0,
                               atol=ATOL)
    for key_ in ("recon_loss", "mmd_loss"):
        assert abs(float(out[key_].detach()) - float(jout[key_])) <= ATOL, key_
    assert float(jout["mmd_loss"]) > 0
    (out["mmd_loss"] + out["recon_loss"]).backward()
    got = dict(port.named_parameters())
    want = _grads_sd(jgrads, stats)
    assert sorted(got) == sorted(want)
    for name, g in want.items():
        np.testing.assert_allclose(got[name].grad.numpy(), g, rtol=ATOL, atol=ATOL,
                                   err_msg=name)
    new_stats = weights.snn_vae_state_dict(variables["params"], jstats)
    for name, value in port.state_dict().items():
        if name.endswith((".mean", ".var")):
            np.testing.assert_allclose(value.numpy(), new_stats[name], **STATS_TOL,
                                       err_msg=name)


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_eval_forward_and_sample_equal_jax(branch):
    jax_backend, backend = BRANCHES[branch]
    model, variables, cfg, vq = _problem(T_MODEL, jax_backend)
    x = _images()
    key = jax.random.PRNGKey(10)
    jout = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda v, xx, kk: model.apply(v, xx, kk, train=False))(variables, jnp.asarray(x), key))
    port = _port(variables, cfg, vq, backend, train=False)
    choice, _, _ = _jax_draws(key, cfg)
    out = port(_t(x), choice=choice)
    np.testing.assert_array_equal(out["z"].numpy(), jout["z"])
    np.testing.assert_allclose(out["recon"].numpy(), jout["recon"], rtol=0, atol=ATOL)
    skey = jax.random.PRNGKey(11)
    jx, jz = jax.jit(lambda v, kk: model.apply(v, kk, BATCH, method="sample"))(variables, skey)
    schoice = jax.random.randint(skey, (T_MODEL, BATCH, cfg.latent_dim), 0, cfg.k)
    px, pz = port.sample(BATCH, choice=_t(schoice))
    assert not port.training and px.shape == (BATCH, 28, 28, 1)
    np.testing.assert_array_equal(pz.numpy(), np.asarray(jz))
    np.testing.assert_allclose(px.numpy(), np.asarray(jx), rtol=0, atol=ATOL)


def test_cli_train_step_and_schedule():
    """The CLI's step is one AdamW step on mmd + recon; ``--vae_scheduled_p``
    anneals 0.1 -> 0.3, 'off' is 0, a number is itself."""
    model, variables, cfg, vq = _problem(T_MODEL, "scan")
    state = create_train_state(_port(variables, cfg, vq))
    x = torch.from_numpy(_images())
    gen = torch.Generator().manual_seed(0)
    first = cli.make_train_step_snn_vae()(state, x, gen, 0.2)
    assert state.step == 1 and set(first) == {"loss", "mmd", "rec"}
    assert float(first["loss"]) == pytest.approx(float(first["mmd"] + first["rec"]))
    assert cli.scheduled_p("anneal", 0, 10) == pytest.approx(0.1)
    assert cli.scheduled_p("anneal", 5, 10) == pytest.approx(0.2)
    assert cli.scheduled_p("off", 3, 10) == 0.0
    assert cli.scheduled_p("0.25", 3, 10) == 0.25
