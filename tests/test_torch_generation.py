"""The port's generation slice end to end against the JAX pipeline.

At tiny widths, the same weights and the same noise go through the JAX
package's ``diffusion.sample`` followed by ``SNNVQVAE.decode_indices``
(the CLI's ``gen_chunk`` with ``--fused_sampler off --lif_backend
pallas``, Pallas in interpret mode) and through the port's
``generate.generate``. Codes must be identical; images agree to 1e-5
(fp32 convolutions summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spiking_diffusion_tpu.config import DiffusionConfig as JaxDiffusionConfig
from spiking_diffusion_tpu.config import VQVAEConfig as JaxVQVAEConfig
from spiking_diffusion_tpu.models import diffusion as jax_diffusion
from spiking_diffusion_tpu.models.denoiser import SpikingDenoiser as JaxDenoiser
from spiking_diffusion_tpu.models.vqvae import SNNVQVAE as JaxSNNVQVAE
from spiking_diffusion_tpu.ops import pallas_lif
from spiking_diffusion_tpu_torch import generate
from spiking_diffusion_tpu_torch.config import DiffusionConfig, VQVAEConfig
from spiking_diffusion_tpu_torch.models import weights

IMAGE_ATOL = 1e-5
DIFF = dict(denoiser_channels=(4, 8, 8, 8, 4), num_embeddings=16, mask_id=16,
            num_steps=4)
VQ = dict(embedding_dim=8, num_embeddings=16, dec_channels=(8, 4), num_steps=4)


@pytest.fixture(autouse=True)
def setup():
    torch.set_num_threads(1)
    old = pallas_lif._INTERPRET
    pallas_lif._INTERPRET = True
    yield
    pallas_lif._INTERPRET = old


def _amplify_bn(stats, rng):
    """Running statistics that scale activations up, so every LIF fires."""
    for key, node in stats.items():
        if key == "BatchNorm_0":
            node["mean"] = rng.uniform(-0.2, 0.2, node["mean"].shape).astype(np.float32)
            node["var"] = rng.uniform(0.01, 0.05, node["var"].shape).astype(np.float32)
        else:
            _amplify_bn(node, rng)


def _jax_noise(key, n, h, k, steps):
    out = []
    for _ in range(steps):
        key, k_change, k_cat = jax.random.split(key, 3)
        u = np.array(jax.random.uniform(k_change, (n, h, h)))
        g = np.array(jax.random.gumbel(k_cat, (n, h, h, k), jnp.float32))
        out.append((torch.from_numpy(u), torch.from_numpy(g)))
    return out


def test_generation_matches_jax_pipeline():
    dcfg, vcfg = DiffusionConfig(**DIFF), VQVAEConfig(**VQ)
    jdcfg, jvcfg = JaxDiffusionConfig(**DIFF), JaxVQVAEConfig(**VQ)
    gen, rng = torch.Generator().manual_seed(5), np.random.RandomState(6)
    dparams, dstats = weights.init_denoiser_variables(dcfg, gen)
    vparams, vstats = weights.init_vqvae_decode_variables(vcfg, gen)
    _amplify_bn(dstats, rng)
    _amplify_bn(vstats, rng)
    n = 4
    dvars = {"params": dparams, "batch_stats": dstats}
    vvars = {"params": {**vparams, "vq_layer": {**vparams["vq_layer"],
                                                "alpha": np.float32(0.5)}},
             "batch_stats": vstats}
    den_model = JaxDenoiser(jdcfg, backend="pallas")
    vq_model = JaxSNNVQVAE(jvcfg, backend="pallas")

    @jax.jit
    def gen_chunk(key):
        codes = jax_diffusion.sample(
            key, lambda x, t: den_model.apply(dvars, x, t, train=False), jdcfg, n)
        return codes, vq_model.apply(vvars, codes, method="decode_indices")

    key = jax.random.PRNGKey(7)
    codes_jax, images_jax = (np.asarray(a) for a in gen_chunk(key))

    den = weights.load_denoiser(dparams, dstats, dcfg, device="cpu")
    vq = weights.load_vqvae(vparams, vstats, vcfg, device="cpu")
    noise = _jax_noise(key, n, dcfg.latent_size, dcfg.num_embeddings,
                       dcfg.num_timesteps)
    codes, images = generate.generate(den, vq, dcfg, n, noise=noise, device="cpu")
    codes, images = codes.numpy(), images.numpy()
    assert codes.shape == (n, 7, 7) and images.shape == (n, 28, 28, 1)
    assert codes.max() < dcfg.num_embeddings and len(np.unique(codes)) > 1
    np.testing.assert_array_equal(codes, codes_jax)
    np.testing.assert_allclose(images, images_jax, atol=IMAGE_ATOL, rtol=0)
    assert np.all(np.isfinite(images)) and np.all(np.abs(images) <= 1.0)
    assert images.std() > 0


def test_generator_path_is_seeded_and_valid():
    dcfg, vcfg = DiffusionConfig(**DIFF), VQVAEConfig(**VQ)
    gen = torch.Generator().manual_seed(8)
    den = weights.load_denoiser(*weights.init_denoiser_variables(dcfg, gen),
                                dcfg, device="cpu")
    vq = weights.load_vqvae(*weights.init_vqvae_decode_variables(vcfg, gen),
                            vcfg, device="cpu")
    runs = [generate.generate(den, vq, dcfg, 3, temperature=0.8, device="cpu",
                              generator=torch.Generator().manual_seed(9))
            for _ in range(2)]
    (codes, images), (codes2, images2) = runs
    assert torch.equal(codes, codes2) and torch.equal(images, images2)
    assert codes.dtype == torch.int32
    assert int(codes.min()) >= 0 and int(codes.max()) < dcfg.num_embeddings
    with pytest.raises(ValueError, match="Generator"):
        generate.sample_codes(den, dcfg, 3, device="cpu")


def test_calibrate_batchnorm_sets_input_statistics():
    dcfg = DiffusionConfig(**DIFF)
    den = weights.load_denoiser(
        *weights.init_denoiser_variables(dcfg, torch.Generator().manual_seed(1)),
        dcfg, device="cpu")
    tokens = torch.randint(0, 17, (6, 7, 7), generator=torch.Generator().manual_seed(2))
    t = torch.randint(1, 50, (6,), generator=torch.Generator().manual_seed(3))
    seen = []
    den.bns[2].register_forward_pre_hook(lambda m, a: seen.append(a[0].clone()))
    weights.calibrate_batchnorm(den, lambda: den(tokens, t))
    x = seen[0]
    torch.testing.assert_close(den.bns[2].mean, x.mean((0, 2, 3)))
    torch.testing.assert_close(den.bns[2].var, x.var((0, 2, 3), unbiased=False))
    rates = []
    for lif in den.lifs:
        lif.register_forward_hook(lambda m, a, out: rates.append(float(out.mean())))
    den(tokens, t)
    assert all(0.01 < r < 0.99 for r in rates), rates
