"""The JAX package's fused-sampler first conv in a TPU's default precision,
for the port's tests, and the checks that this emulation is only that.

On a TPU, JAX's default precision rounds a conv's fp32 operands to bf16; on
the CPU, where these tests run, JAX computes the conv in fp32. The port's
bf16 and int8 fused samplers take the first conv's folded kernel in bf16
(``ops/fused_denoiser.py`` ``FIRST_CONV_DTYPES``): the arithmetic of the
JAX package's records of those samplers, which ran on a TPU. A port test
that holds those samplers to the JAX package on the CPU runs JAX's
``_first_preactivation`` through :func:`tpu_first_conv`. That is a
deviation from the JAX package as it runs on the CPU, and each test that
takes it names it. The fp32 sampler stays exact on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spiking_diffusion_tpu.ops import fused_denoiser as jfd
from spiking_diffusion_tpu_torch.config import DiffusionConfig
from spiking_diffusion_tpu_torch.models import weights
from spiking_diffusion_tpu_torch.ops import fused_denoiser as fd

TINY = dict(num_timesteps=6, latent_size=7, num_embeddings=10, mask_id=10,
            num_steps=4, denoiser_channels=(4, 8, 8, 8, 4))
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


def tpu_kernel(k1) -> jnp.ndarray:
    """A fp32 conv kernel rounded to bf16, as a TPU's default precision
    takes it."""
    return jnp.asarray(k1).astype(jnp.bfloat16).astype(jnp.float32)


def rounds_first_conv(dtype: torch.dtype) -> bool:
    """Whether the port's sampler of weight type ``dtype`` takes the first
    conv's kernel in bf16."""
    return fd.FIRST_CONV_DTYPES[dtype] == torch.bfloat16


def tpu_first_conv(monkeypatch, dtype: torch.dtype) -> None:
    """For a port sampler dtype that rounds the first conv, JAX's
    ``_first_preactivation`` with its kernel rounded as a TPU's default
    precision rounds it (the token map is exact in bf16); else nothing."""
    if not rounds_first_conv(dtype):
        return
    first = jfd._first_preactivation
    monkeypatch.setattr(jfd, "_first_preactivation", lambda x, t, k1, b1, hw: first(
        x, t, tpu_kernel(k1), b1, hw))


def test_token_map_is_exact_in_bf16():
    """Every token id and time step of the flagship is a bf16 value, so the
    kernel is the only operand of the first conv a TPU rounds; and only the
    bf16 and int8 samplers round it."""
    cfg = DiffusionConfig()
    values = np.arange(max(cfg.num_embeddings, cfg.num_timesteps) + 1, dtype=np.float32)
    rounded = np.asarray(jnp.asarray(values).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(rounded, values)
    assert {d: rounds_first_conv(t) for d, t in DTYPES.items()} == {
        "fp32": False, "bf16": True, "int8": True}


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_port_first_conv_matches_jax_in_tpu_precision(dtype, monkeypatch):
    """The port's folded first conv for the bf16 and int8 samplers against
    JAX's ``_first_preactivation`` through :func:`tpu_first_conv` (the fp32
    one against JAX's own: tests/test_torch_fused_denoiser.py)."""
    tdt = DTYPES[dtype]
    tpu_first_conv(monkeypatch, tdt)
    cfg = DiffusionConfig(**TINY)
    params, stats = weights.init_denoiser_variables(cfg, torch.Generator().manual_seed(1))
    den = weights.load_denoiser(params, stats, cfg, device="cpu")
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, cfg.num_embeddings + 1, (5, 7, 7)).astype(np.int32)
    t = rng.integers(1, cfg.num_timesteps + 1, (5,)).astype(np.int32)
    k1, b1, *_ = jfd._extract_folded_weights(
        {"params": params, "batch_stats": stats}, len(cfg.denoiser_channels),
        jnp.float32, conv_mode="taps")
    want = np.asarray(jfd._first_preactivation(
        jnp.asarray(tokens), jnp.asarray(t), k1, b1, cfg.latent_size))
    tokens, t = torch.from_numpy(tokens), torch.from_numpy(t)
    folded = fd.fold_denoiser_weights(den, tdt)
    got = fd.first_preactivation(tokens, t, folded.k1, folded.b1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # the rounding moves the result, so the comparison tells the two apart
    exact = fd.fold_denoiser_weights(den)
    exact = fd.first_preactivation(tokens, t, exact.k1, exact.b1).numpy()
    assert np.abs(got - exact).max() > 1e-4
