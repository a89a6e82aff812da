"""The port's fused sampler (K2's plain version and the modules around it)
against the JAX package's ``ops/fused_denoiser.py``.

The same numpy weights (a small random init with non-identity BN
statistics, and the committed full-width MNIST denoiser
``result_r5_e60/.../diff_model``) and the same token maps go through both.
The JAX side runs its Pallas megakernel in interpret mode. Logits agree to
atol 1e-5 / rtol 1e-5, the JAX package's own kernel-vs-mirror tolerance
(tests/test_fused_denoiser.py, tests/test_fused_denoiser_int8.py): fp32
sums taken in another order. Folded weights agree to 1e-7 and int8
weights are identical.

The bf16 and int8 samplers take the first conv's kernel in bf16, the
arithmetic of the JAX package's records of them on a TPU
(``FIRST_CONV_DTYPES``); on the CPU the JAX side computes that conv in
fp32. So the tests of those samplers run the JAX side through
``test_torch_tpu_precision.tpu_first_conv``, a deviation from the JAX
package as it runs on the CPU that each such test names.
"""

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spiking_diffusion_tpu.config import DiffusionConfig as JaxDiffusionConfig
from spiking_diffusion_tpu.models import diffusion as jax_diffusion
from spiking_diffusion_tpu.ops import fused_denoiser as jfd
from spiking_diffusion_tpu.train.checkpoint import load_variables
from spiking_diffusion_tpu_torch import generate
from spiking_diffusion_tpu_torch.config import DiffusionConfig
from spiking_diffusion_tpu_torch.ops import fused_denoiser as fd
from spiking_diffusion_tpu_torch.models import weights
from test_torch_tpu_precision import rounds_first_conv, tpu_first_conv, tpu_kernel

ATOL = RTOL = 1e-5
FOLD_ATOL = 1e-7
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "result_r5_e60", "MNIST", "snn-vq-vae", "diff_result")
TINY = dict(num_timesteps=6, latent_size=7, num_embeddings=10, mask_id=10,
            num_steps=4, denoiser_channels=(4, 8, 8, 8, 4))
DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16),
          "int8": (torch.int8, jnp.int8)}


@pytest.fixture(autouse=True)
def setup():
    torch.set_num_threads(1)
    old = jfd._INTERPRET
    jfd._INTERPRET = True
    yield
    jfd._INTERPRET = old


def _tiny_variables(seed):
    """Seeded random flax-layout variables with non-identity BN."""
    cfg = DiffusionConfig(**TINY)
    params, stats = weights.init_denoiser_variables(
        cfg, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    for i, c in enumerate(cfg.denoiser_channels):
        bn = params[f"SeqBatchNorm_{i}"]["BatchNorm_0"]
        bn["scale"] = rng.uniform(0.8, 1.6, c).astype(np.float32)
        bn["bias"] = rng.normal(0.3, 0.3, c).astype(np.float32)
        st = stats[f"SeqBatchNorm_{i}"]["BatchNorm_0"]
        st["mean"] = rng.normal(0.0, 0.2, c).astype(np.float32)
        st["var"] = rng.uniform(0.05, 0.5, c).astype(np.float32)
    return params, stats


def _models(which, seed=0):
    """(jax cfg, port cfg, variables, port denoiser on the CPU)."""
    if which == "tiny":
        jcfg, cfg = JaxDiffusionConfig(**TINY), DiffusionConfig(**TINY)
        params, stats = _tiny_variables(seed)
    else:
        jcfg, cfg = JaxDiffusionConfig(), DiffusionConfig()
        params, stats = load_variables(CKPT, "diff_model")
    den = weights.load_denoiser(params, stats, cfg, device="cpu")
    return jcfg, cfg, {"params": params, "batch_stats": stats}, den


def _inputs(cfg, n, seed):
    rng = np.random.default_rng(seed)
    h = cfg.latent_size
    tokens = rng.integers(0, cfg.num_embeddings + 1, (n, h, h)).astype(np.int32)
    tokens[0, :3] = cfg.mask_id
    t = rng.integers(1, cfg.num_timesteps + 1, (n,)).astype(np.int32)
    return tokens, t


def _port_logits(den, cfg, tokens, t, dtype):
    fn = fd.make_fused_denoise_fn(den, cfg, dtype)
    return fn(torch.from_numpy(tokens), torch.from_numpy(t)).numpy()


@pytest.mark.parametrize("which", ["tiny", "flagship"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_folded_weights_match_jax(which, dtype):
    """The port's folded weights against JAX's ``_extract_folded_weights``.
    Deviation from the JAX package on the CPU: for bf16 and int8 JAX's
    first-conv kernel is rounded by ``tpu_kernel`` (a TPU's default
    precision), as the port's is."""
    tdt, jdt = DTYPES[dtype]
    jcfg, cfg, variables, den = _models(which)
    n_l = len(cfg.denoiser_channels)
    k1, b1, ws, bs, kf, bf = jfd._extract_folded_weights(
        variables, n_l, jdt, conv_mode="taps")
    folded = fd.fold_denoiser_weights(den, tdt)
    # k1: torch (C1, 2, 3, 3) against flax (3, 3, 2, C1)
    if rounds_first_conv(tdt):
        k1 = tpu_kernel(k1)
    np.testing.assert_allclose(folded.k1.permute(2, 3, 1, 0).numpy(),
                               np.asarray(k1), atol=FOLD_ATOL, rtol=0)
    np.testing.assert_allclose(folded.b1.numpy(), np.asarray(b1),
                               atol=FOLD_ATOL, rtol=0)
    assert len(folded.weights) == len(ws) + 1
    for w, b, jw, jb in zip(folded.weights, folded.biases, ws + [kf], bs + [bf]):
        assert w.dtype == tdt and b.dtype == torch.float32
        jw = np.asarray(jw.astype(jnp.float32)).reshape(w.shape)  # taps (9, Cin, Cout)
        if dtype == "int8":
            np.testing.assert_array_equal(w.numpy(), jw)
            np.testing.assert_array_equal(b[1:].numpy(), np.asarray(jb)[1:])
            assert int(np.abs(jw).max()) == 127
        else:
            np.testing.assert_allclose(w.float().numpy(), jw, atol=FOLD_ATOL, rtol=0)
        np.testing.assert_allclose(b[:1].numpy(), np.asarray(jb)[:1],
                                   atol=FOLD_ATOL, rtol=0)


def test_first_preactivation_matches_jax():
    jcfg, cfg, variables, den = _models("tiny", seed=1)
    tokens, t = _inputs(cfg, 5, seed=2)
    k1, b1, *_ = jfd._extract_folded_weights(variables, 5, jnp.float32,
                                             conv_mode="taps")
    want = np.asarray(jfd._first_preactivation(
        jnp.asarray(tokens), jnp.asarray(t), k1, b1, cfg.latent_size))
    folded = fd.fold_denoiser_weights(den)
    got = fd.first_preactivation(torch.from_numpy(tokens), torch.from_numpy(t),
                                 folded.k1, folded.b1).numpy()
    assert got.shape == want.shape == (5, 49, 4)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("n", [6, 8])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_matches_jax_mirror_and_kernel(dtype, n, monkeypatch):
    """The plain version against JAX's mirror and its interpreted kernel.
    Deviation from the JAX package on the CPU: the JAX side's first conv
    runs through ``tpu_first_conv`` (for bf16 and int8)."""
    tdt, jdt = DTYPES[dtype]
    tpu_first_conv(monkeypatch, tdt)
    jcfg, cfg, variables, den = _models("tiny", seed=3)
    tokens, t = _inputs(cfg, n, seed=4 + n)
    mirror = np.asarray(jax.jit(jfd.mirror_denoise_fn(variables, jcfg, jdt))(
        jnp.asarray(tokens), jnp.asarray(t)))
    kernel = np.asarray(jax.jit(jfd.make_fused_denoise_fn(
        variables, jcfg, dtype=jdt, block_n=4))(jnp.asarray(tokens), jnp.asarray(t)))
    got = _port_logits(den, cfg, tokens, t, tdt)
    assert got.shape == mirror.shape == (n, 7, 7, 10) and got.dtype == np.float32
    assert got.std() > 0.1
    np.testing.assert_allclose(got, mirror, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, kernel, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("dtype", ["fp32", "int8"])
def test_plain_matches_jax_mirror_flagship(dtype, monkeypatch):
    """The plain version against JAX's mirror on the committed flagship.
    Deviation from the JAX package on the CPU: the JAX side's first conv
    runs through ``tpu_first_conv`` (for int8)."""
    tdt, jdt = DTYPES[dtype]
    tpu_first_conv(monkeypatch, tdt)
    jcfg, cfg, variables, den = _models("flagship")
    tokens, t = _inputs(cfg, 2, seed=5)
    # op by op: at full width this is ~3x faster than compiling the jit
    mirror = np.asarray(jfd.mirror_denoise_fn(variables, jcfg, jdt)(
        jnp.asarray(tokens), jnp.asarray(t)))
    got = _port_logits(den, cfg, tokens, t, tdt)
    assert got.shape == (2, 7, 7, 128) and got.std() > 0.1
    np.testing.assert_allclose(got, mirror, atol=ATOL, rtol=RTOL)


def _jax_noise(key, cfg, n, steps):
    """Per-step (u, g) exactly as the JAX sampler draws them."""
    h, out = cfg.latent_size, []
    for _ in range(steps):
        key, k_change, k_cat = jax.random.split(key, 3)
        u = jax.random.uniform(k_change, (n, h, h))
        g = jax.random.gumbel(k_cat, (n, h, h, cfg.num_embeddings), jnp.float32)
        out.append((torch.from_numpy(np.array(u)), torch.from_numpy(np.array(g))))
    return out


@pytest.mark.parametrize("dtype", ["fp32", "int8"])
def test_fused_sampler_matches_jax(dtype, monkeypatch):
    """The port's fused sampler against JAX's on the same noise, code for
    code. Deviation from the JAX package on the CPU: the JAX side's first
    conv runs through ``tpu_first_conv`` (for int8)."""
    tdt, jdt = DTYPES[dtype]
    tpu_first_conv(monkeypatch, tdt)
    jcfg, cfg, variables, den = _models("tiny", seed=6)
    n, key = 5, jax.random.PRNGKey(12)
    fused = jfd.make_fused_denoise_fn(variables, jcfg, dtype=jdt, block_n=4)
    want = np.asarray(jax.jit(lambda k: jax_diffusion.sample(
        k, fused, jcfg, n, temperature=0.9))(key))
    before = fd.LAUNCHES
    got = generate.sample_codes(
        den, cfg, n, temperature=0.9,
        noise=_jax_noise(key, jcfg, n, cfg.num_timesteps), device="cpu",
        fused=True, dtype=tdt).numpy()
    assert fd.LAUNCHES == before
    assert got.dtype == np.int32 and len(np.unique(got)) > 1
    assert got.min() >= 0 and got.max() < cfg.num_embeddings
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [16, 256])
def test_denoiser_cost_matches_jax(n):
    for itemsize in (1, 2, 4):
        assert fd.denoiser_cost(DiffusionConfig(), n, itemsize, useful_only=True) == \
            jfd.denoiser_cost(JaxDiffusionConfig(), n, itemsize, useful_only=True)
    flops, nbytes = fd.denoiser_cost(DiffusionConfig(), n, 4)
    useful, _ = fd.denoiser_cost(DiffusionConfig(), n, 4, useful_only=True)
    assert useful / flops == pytest.approx(361 / 441)
    assert nbytes == n * 49 * (64 + 128) * 4 + 4 * 9 * (
        64 * 128 + 128 * 256 + 256 * 512 + 512 * 256 + 320 * 128)


def test_make_denoise_fn_on_cpu_takes_plain_version():
    _, cfg, _, den = _models("tiny", seed=7)
    tokens, t = (torch.from_numpy(a) for a in _inputs(cfg, 3, seed=8))
    before = fd.LAUNCHES
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        fused = fd.make_denoise_fn(den, cfg, fused=True, dtype=torch.bfloat16)
        assert fd.make_denoise_fn(den, cfg) is den  # 'auto' on the CPU
        assert fd.make_denoise_fn(den, cfg, fused=False) is den
    out = fused(tokens, t)
    folded = fd.fold_denoiser_weights(den, torch.bfloat16)
    a1 = fd.first_preactivation(tokens, t, folded.k1, folded.b1)
    ref = fd.fused_denoise_reference(a1, folded, cfg).reshape(3, 7, 7, 10)
    assert torch.equal(out, ref)
    assert fd.LAUNCHES == before
    for fused_opt in (False, "auto"):
        with pytest.warns(UserWarning, match="no effect"):
            assert fd.make_denoise_fn(den, cfg, fused_opt, torch.int8) is den
    with pytest.raises(ValueError, match="fused"):
        fd.make_denoise_fn(den, cfg, fused="yes")
    with pytest.raises(TypeError):
        fd.make_denoise_fn(den, cfg, fused=True, dtype=torch.float16)


def test_wrapper_rejects_what_the_kernel_does_not_take(monkeypatch):
    """The checks a CUDA tensor meets before K2 launches, with meta tensors
    standing in for the card's."""
    monkeypatch.setattr(fd, "_on_card", lambda t: True)
    _, cfg, _, den = _models("tiny", seed=9)
    folded = fd.fold_denoiser_weights(den, torch.int8)
    meta = fd.FoldedDenoiser(
        folded.k1, folded.b1, tuple(w.to("meta") for w in folded.weights),
        tuple(b.to("meta") for b in folded.biases), torch.int8)
    a1 = torch.empty((13, 49, 4), device="meta")
    with pytest.raises(TypeError, match="float32"):
        fd.fused_denoise(a1.double(), meta, cfg)
    with pytest.raises(ValueError, match="a1 must be"):
        fd.fused_denoise(a1[:, :48], meta, cfg)
    with pytest.raises(ValueError, match="a1 must be"):
        fd.fused_denoise(a1[:0], meta, cfg)
    with pytest.raises(ValueError, match="contiguous"):
        fd.fused_denoise(torch.empty((13, 4, 49), device="meta").transpose(1, 2),
                         meta, cfg)
    with pytest.raises(ValueError, match="weights on"):
        fd.fused_denoise(a1, folded, cfg)  # weights on the CPU
    bad = fd.FoldedDenoiser(meta.k1, meta.b1, meta.weights,
                            tuple(b[:1] for b in meta.biases), torch.int8)
    with pytest.raises(ValueError, match="bias"):
        fd.fused_denoise(a1, bad, cfg)
    bad = fd.FoldedDenoiser(meta.k1, meta.b1, tuple(w.float() for w in meta.weights),
                            meta.biases, torch.int8)
    with pytest.raises(TypeError, match="need"):
        fd.fused_denoise(a1, bad, cfg)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        monkeypatch.setattr(fd, "_on_card", lambda t: False)
        fd.fused_denoise(a1, meta, cfg)
