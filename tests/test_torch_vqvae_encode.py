"""The port's VQ-VAE encode path against the JAX package's on the
committed MNIST flagship checkpoint (``result_r5_e60``), at full width.

The weights are read with the JAX package's ``load_variables`` and
carried into the port by ``models/weights.py``; the images are the port's
``synthetic_dataset`` (the CLI's offline fallback), which is bitwise the
JAX package's for the same seed, as is ``data_variance``. The JAX side
runs its LIF layers through the scan oracle. ``encode_indices`` gives
identical code grids; the eval forward's images agree to 1e-5 (fp32; the
frameworks sum the convolutions in another order) with identical indices
and re-spike trains.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spiking_diffusion_tpu.config import VQVAEConfig as JaxVQVAEConfig
from spiking_diffusion_tpu.data import data_variance as jax_data_variance
from spiking_diffusion_tpu.data import synthetic_dataset as jax_synthetic_dataset
from spiking_diffusion_tpu.models.vqvae import SNNVQVAE as JaxSNNVQVAE
from spiking_diffusion_tpu.train.checkpoint import load_variables
from spiking_diffusion_tpu_torch.config import VQVAEConfig
from spiking_diffusion_tpu_torch.data import data_variance, synthetic_dataset
from spiking_diffusion_tpu_torch.models import weights

IMAGE_ATOL = 1e-5
N_IMAGES = 16
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "result_r5_e60", "MNIST", "snn-vq-vae")


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def flagship():
    """(JAX variables, the port's VQ-VAE on the CPU, 16 images in [-0.5, 0.5])."""
    params, stats = load_variables(CKPT, "model")
    vq = weights.load_vqvae(params, stats, VQVAEConfig(), device="cpu")
    images = synthetic_dataset("MNIST", n_train=N_IMAGES, n_test=1, seed=11).train_images
    return {"params": params, "batch_stats": stats}, vq, images - 0.5


@pytest.mark.parametrize("seed", [0, 11])
def test_synthetic_data_is_the_jax_packages(seed):
    ours = synthetic_dataset("MNIST", n_train=32, n_test=8, seed=seed)
    theirs = jax_synthetic_dataset("MNIST", n_train=32, n_test=8, seed=seed)
    for field in ("train_images", "train_labels", "test_images", "test_labels"):
        a, b = getattr(ours, field), getattr(theirs, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert data_variance(ours.train_images) == jax_data_variance(theirs.train_images)


def test_encode_indices_equal_jax(flagship):
    variables, vq, images = flagship
    model = JaxSNNVQVAE(JaxVQVAEConfig(), backend="scan")
    want = np.asarray(jax.jit(lambda v, x: model.apply(v, x, method="encode_indices"))(
        variables, jnp.asarray(images)))
    codes = vq.encode_indices(torch.from_numpy(images))
    assert codes.shape == (N_IMAGES, 7, 7) and codes.dtype == torch.int32
    np.testing.assert_array_equal(codes.numpy(), want)
    assert len(np.unique(want)) > 5


def test_eval_forward_matches_jax(flagship):
    variables, vq, images = flagship
    model = JaxSNNVQVAE(JaxVQVAEConfig(), backend="scan")
    out_j = jax.jit(lambda v, x: model.apply(v, x, train=False))(variables, jnp.asarray(images))
    out = vq(torch.from_numpy(images))
    np.testing.assert_array_equal(out["indices"].numpy(), np.asarray(out_j["indices"]))
    np.testing.assert_array_equal(out["spikes"].numpy(), np.asarray(out_j["spikes"]))
    np.testing.assert_allclose(out["recon"].numpy(), np.asarray(out_j["recon"]),
                               atol=IMAGE_ATOL, rtol=0)
    recon = out["recon"].numpy()
    assert recon.shape == (N_IMAGES, 28, 28, 1) and np.abs(recon).max() <= 1.0
    # a trained model reconstructs its input better than a constant image
    assert np.mean((recon - images) ** 2) < np.mean((images - images.mean()) ** 2)
