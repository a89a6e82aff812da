"""The port's spiking denoiser against the JAX package's ``SpikingDenoiser``.

Same weights (a small random init, and the committed full-width MNIST
denoiser ``result_r5_e60/.../diff_model``) and the same token maps and
timesteps go through both. The JAX side runs its LIF layers through the
Pallas kernel in interpret mode. Logits agree to 5e-5, the JAX package's
own bridge tolerance (tests/test_fullmodel_bridge.py): fp32 sums of
T=16 firing-rate readouts, taken in another order.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spiking_diffusion_tpu.config import DiffusionConfig as JaxDiffusionConfig
from spiking_diffusion_tpu.models.denoiser import SpikingDenoiser as JaxDenoiser
from spiking_diffusion_tpu.ops import pallas_lif
from spiking_diffusion_tpu.train.checkpoint import load_variables
from spiking_diffusion_tpu_torch.config import DiffusionConfig
from spiking_diffusion_tpu_torch.models import weights

LOGIT_ATOL = 5e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "result_r5_e60", "MNIST", "snn-vq-vae", "diff_result")


@pytest.fixture(autouse=True)
def setup():
    torch.set_num_threads(1)
    old = pallas_lif._INTERPRET
    pallas_lif._INTERPRET = True
    yield
    pallas_lif._INTERPRET = old


def _inputs(cfg, n, seed):
    rng = np.random.default_rng(seed)
    h = cfg.latent_size
    tokens = rng.integers(0, cfg.num_embeddings + 1, (n, h, h)).astype(np.int32)
    tokens[0, :3] = cfg.mask_id  # the mask token itself is an input value
    t = rng.integers(1, cfg.num_timesteps + 1, (n,)).astype(np.int32)
    return tokens, t


def _check(jcfg, cfg, params, batch_stats, n, seed):
    tokens, t = _inputs(cfg, n, seed)
    model = JaxDenoiser(jcfg, backend="pallas")
    logits_jax = np.asarray(jax.jit(
        lambda v, x, s: model.apply(v, x, s, train=False))(
            {"params": params, "batch_stats": batch_stats},
            jnp.asarray(tokens), jnp.asarray(t)))
    den = weights.load_denoiser(params, batch_stats, cfg, device="cpu")
    logits = den(torch.from_numpy(tokens), torch.from_numpy(t)).numpy()
    h = cfg.latent_size
    assert logits.shape == logits_jax.shape == (n, h, h, cfg.num_embeddings)
    assert logits.dtype == np.float32
    np.testing.assert_allclose(logits, logits_jax, atol=LOGIT_ATOL, rtol=0)
    return logits


def test_denoiser_random_init():
    kw = dict(denoiser_channels=(8, 8, 16, 16, 8), num_embeddings=16,
              mask_id=16, num_steps=8)
    jcfg, cfg = JaxDiffusionConfig(**kw), DiffusionConfig(**kw)
    h = cfg.latent_size
    init = JaxDenoiser(jcfg, backend="scan").init
    variables = jax.jit(lambda k, x, t: init(k, x, t, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((2, h, h), jnp.int32),
        jnp.ones((2,), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    logits = _check(jcfg, cfg, params, stats, n=3, seed=1)
    assert logits.std() > 0


def test_denoiser_flagship_checkpoint():
    params, stats = load_variables(CKPT, "diff_model")
    logits = _check(JaxDiffusionConfig(), DiffusionConfig(), params, stats,
                    n=2, seed=2)
    assert logits.std() > 0.1
