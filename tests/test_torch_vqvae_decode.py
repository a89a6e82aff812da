"""The port's VQ-VAE decode half against the JAX package's ``SNNVQVAE``.

Same weights (a small random init, and the committed MNIST flagship
checkpoint ``result_r5_e60``) and the same code grids go through
``decode_indices`` in both frameworks. The JAX side runs its LIF layers
through the Pallas kernel in interpret mode. Images agree to 1e-5 (fp32;
the frameworks sum the convolutions in another order); re-spike trains
must be equal.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spiking_diffusion_tpu.config import VQVAEConfig as JaxVQVAEConfig
from spiking_diffusion_tpu.models.vqvae import SNNVQVAE as JaxSNNVQVAE
from spiking_diffusion_tpu.ops import pallas_lif
from spiking_diffusion_tpu.train.checkpoint import load_variables
from spiking_diffusion_tpu_torch.config import VQVAEConfig
from spiking_diffusion_tpu_torch.models import weights

IMAGE_ATOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "result_r5_e60", "MNIST", "snn-vq-vae")


@pytest.fixture(autouse=True)
def setup():
    torch.set_num_threads(1)
    old = pallas_lif._INTERPRET
    pallas_lif._INTERPRET = True
    yield
    pallas_lif._INTERPRET = old


def _jax_decode(cfg, variables, codes):
    model = JaxSNNVQVAE(cfg, backend="pallas")
    return np.asarray(jax.jit(
        lambda v, c: model.apply(v, c, method="decode_indices"))(variables, codes))


def _jax_respike(cfg, variables, codes):
    model = JaxSNNVQVAE(cfg, backend="pallas")

    def respike(m, c):
        return m.vq_layer.respike(m.vq_layer.quantize(c), train=False)

    return np.asarray(jax.jit(
        lambda v, c: model.apply(v, c, method=respike))(variables, codes))


def _codes(n, cfg, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.num_embeddings,
                        (n, cfg.latent_size, cfg.latent_size)).astype(np.int32)


def _check(jcfg, cfg, params, batch_stats, n, seed):
    codes = _codes(n, cfg, seed)
    variables = {"params": params, "batch_stats": batch_stats}
    img_jax = _jax_decode(jcfg, variables, jnp.asarray(codes))
    spk_jax = _jax_respike(jcfg, variables, jnp.asarray(codes))
    vq = weights.load_vqvae(params, batch_stats, cfg, device="cpu")
    img = vq.decode_indices(torch.from_numpy(codes)).numpy()
    q = vq.vq_layer.quantize(torch.from_numpy(codes).long()).permute(0, 3, 1, 2)
    spk = vq.vq_layer.respike(q.contiguous()).detach().numpy()
    t = cfg.num_steps
    spk = spk.reshape((t, n) + spk.shape[1:]).transpose(0, 1, 3, 4, 2)
    assert img.shape == img_jax.shape == (n, cfg.image_size, cfg.image_size,
                                          cfg.in_channels)
    assert 0.0 < spk.mean() < 1.0
    np.testing.assert_array_equal(spk, spk_jax)
    np.testing.assert_allclose(img, img_jax, atol=IMAGE_ATOL, rtol=0)
    assert np.all(np.abs(img) <= 1.0)
    return img


def test_decode_random_init():
    kw = dict(embedding_dim=8, num_embeddings=16, dec_channels=(8, 4),
              num_steps=8)
    jcfg, cfg = JaxVQVAEConfig(**kw), VQVAEConfig(**kw)
    init = JaxSNNVQVAE(jcfg, backend="scan").init
    variables = jax.jit(lambda k, x: init(k, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((2, 28, 28, 1)))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    # running statistics away from identity, so every LIF layer fires
    rng = np.random.RandomState(1)
    for node in (stats["decoder"]["SeqBatchNorm_0"]["BatchNorm_0"],
                 stats["decoder"]["SeqBatchNorm_1"]["BatchNorm_0"],
                 stats["vq_layer"]["poisson_bn"]["BatchNorm_0"]):
        node["mean"] = rng.uniform(-0.2, 0.2, node["mean"].shape).astype(np.float32)
        node["var"] = rng.uniform(0.01, 0.05, node["var"].shape).astype(np.float32)
    img = _check(jcfg, cfg, params, stats, n=3, seed=2)
    assert img.std() > 0


def test_decode_flagship_checkpoint():
    params, stats = load_variables(CKPT, "model")
    img = _check(JaxVQVAEConfig(), VQVAEConfig(), params, stats, n=2, seed=3)
    assert img.std() > 0.1
