"""The port's reverse sampler against ``spiking_diffusion_tpu.models.diffusion``.

The schedule arrays must equal the JAX sampler's. The whole sampler, at
a tiny denoiser width, is fed JAX's own noise: the test splits the key as
the JAX sampler does at every step and hands the port
``jax.random.uniform(k_change)`` and ``jax.random.gumbel(k_cat)``, which
``jax.random.categorical`` adds to the logits. The final code grids must
be identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spiking_diffusion_tpu.config import DiffusionConfig as JaxDiffusionConfig
from spiking_diffusion_tpu.models import diffusion as jax_diffusion
from spiking_diffusion_tpu.models.denoiser import SpikingDenoiser as JaxDenoiser
from spiking_diffusion_tpu.ops import pallas_lif
from spiking_diffusion_tpu_torch.config import DiffusionConfig
from spiking_diffusion_tpu_torch.models import diffusion, weights

TINY = dict(denoiser_channels=(4, 8, 8, 8, 4), num_embeddings=16, mask_id=16,
            num_steps=4)


@pytest.fixture(autouse=True)
def setup():
    torch.set_num_threads(1)
    old = pallas_lif._INTERPRET
    pallas_lif._INTERPRET = True
    yield
    pallas_lif._INTERPRET = old


def _jax_schedule(monkeypatch, cfg, sample_steps, spacing):
    """The (t_input, p_unmask, n_reveal) arrays the JAX sampler scans over."""
    seen = {}

    def fake_scan(body, init, xs):
        seen["xs"] = xs
        return init, None

    monkeypatch.setattr(jax.lax, "scan", fake_scan)
    jax_diffusion.sample(jax.random.PRNGKey(0), None, cfg, 1,
                         sample_steps=sample_steps, spacing=spacing)
    monkeypatch.undo()
    return [np.asarray(a) for a in seen["xs"]]


@pytest.mark.parametrize("spacing", ["linear", "cosine"])
@pytest.mark.parametrize("sample_steps", [None, 49, 10, 1])
def test_schedule_matches_jax(monkeypatch, sample_steps, spacing):
    want = _jax_schedule(monkeypatch, JaxDiffusionConfig(), sample_steps, spacing)
    got = diffusion.schedule(DiffusionConfig(), sample_steps, spacing)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    if sample_steps in (None, 49) and spacing == "linear":
        t_in, p, _ = got
        np.testing.assert_array_equal(t_in, np.arange(49, 0, -1))
        np.testing.assert_array_equal(p, (1.0 / t_in.astype(np.float32)))


def _jax_noise(key, cfg, n, steps):
    """Per-step (u, g) exactly as the JAX sampler draws them."""
    h, out = cfg.latent_size, []
    for _ in range(steps):
        key, k_change, k_cat = jax.random.split(key, 3)
        u = jax.random.uniform(k_change, (n, h, h))
        g = jax.random.gumbel(k_cat, (n, h, h, cfg.num_embeddings), jnp.float32)
        out.append((torch.from_numpy(np.array(u)), torch.from_numpy(np.array(g))))
    return out


def _tiny_models(seed):
    jcfg, cfg = JaxDiffusionConfig(**TINY), DiffusionConfig(**TINY)
    params, stats = weights.init_denoiser_variables(
        cfg, torch.Generator().manual_seed(seed))
    variables = {"params": params, "batch_stats": stats}
    model = JaxDenoiser(jcfg, backend="pallas")

    def jax_denoise(x, t):
        return model.apply(variables, x, t, train=False)

    return jcfg, cfg, jax_denoise, weights.load_denoiser(params, stats, cfg,
                                                         device="cpu")


@pytest.mark.parametrize("mode,steps,spacing,temperature", [
    ("random", None, "linear", 1.0),
    ("confidence", 10, "cosine", 0.7),
])
def test_sampler_matches_jax_fed_same_noise(mode, steps, spacing, temperature):
    jcfg, cfg, jax_denoise, den = _tiny_models(seed=3)
    n = 3
    key = jax.random.PRNGKey(11)
    codes_jax = np.asarray(jax.jit(lambda k: jax_diffusion.sample(
        k, jax_denoise, jcfg, n, temperature=temperature, sample_steps=steps,
        unmask_mode=mode, spacing=spacing))(key))
    n_steps = len(diffusion.schedule(cfg, steps, spacing)[0])
    codes = diffusion.sample(
        den, cfg, n, _jax_noise(key, jcfg, n, n_steps), temperature=temperature,
        sample_steps=steps, unmask_mode=mode, spacing=spacing).numpy()
    assert codes.dtype == np.int32
    assert codes.min() >= 0 and codes.max() < cfg.num_embeddings
    assert len(np.unique(codes)) > 1
    np.testing.assert_array_equal(codes, codes_jax)
