"""The port's ANN VQ-VAE (``--model vq-vae``) against the JAX package's
``ANNVQVAE``.

A narrow model (12x12x1 images, encoder 8-16, D=8, K=16, decoder 16-8,
batch 4) is initialised by JAX ``ANNVQVAE.init`` and carried into the port
by ``models/weights.py``, with the codebook moved onto encoder outputs of
other images so that the batch takes many codes; the images come from
the port's ``synthetic_dataset``. The training forward's losses and recon within
1e-5; the gradients of one step within 1e-5; one step of each package's
own ``make_train_step_vqvae`` (AdamW) gives parameters within 1e-6; the
eval forward's indices, ``encode_indices`` and ``extract_code_indices``
equal JAX's exactly and its recon and ``decode_indices`` within 1e-5. The
codebook lookup takes the first index among ties, as ``jnp.argmin``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spiking_diffusion_tpu.config import VQVAEConfig as JaxVQVAEConfig
from spiking_diffusion_tpu.models.ann_vqvae import ANNVQVAE as JaxANNVQVAE
from spiking_diffusion_tpu.train import stage1 as jax_stage1
from spiking_diffusion_tpu.train import state as jax_state
from spiking_diffusion_tpu_torch.config import VQVAEConfig
from spiking_diffusion_tpu_torch.data import data_variance, synthetic_dataset
from spiking_diffusion_tpu_torch.models import weights
from spiking_diffusion_tpu_torch.train import stage1
from spiking_diffusion_tpu_torch.train.state import create_train_state

KW = dict(image_size=12, latent_size=3, enc_channels=(8, 16), embedding_dim=8,
          num_embeddings=16, dec_channels=(16, 8))
JCFG, CFG = JaxVQVAEConfig(**KW), VQVAEConfig(**KW)
BATCH = 4
ATOL = 1e-5
PARAM_ATOL = 1e-6
LOSSES = ("vq_loss", "recon_loss", "real_recon_loss")


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    ds = synthetic_dataset("MNIST", 24, 8)
    images = ds.train_images[:, 8:20, 8:20, :]  # 12x12 crops of the digits
    x = images[:BATCH] - 0.5
    model = JaxANNVQVAE(JCFG)
    variables = jax.device_get(model.init(jax.random.PRNGKey(0), jnp.asarray(x), train=True))
    params = jax.tree_util.tree_map(np.array, variables["params"])
    z = np.asarray(model.apply({"params": params}, jnp.asarray(images[8:16] - 0.5),
                               method="encode")).reshape(-1, JCFG.embedding_dim)
    rng = np.random.RandomState(0)
    params["embeddings"] = (z[rng.choice(len(z), JCFG.num_embeddings, replace=False)]
                            + 0.01 * rng.randn(JCFG.num_embeddings, JCFG.embedding_dim)
                            ).astype(np.float32)
    codes = model.apply({"params": params}, jnp.asarray(x), method="encode_indices")
    assert len(np.unique(np.asarray(codes))) >= 6
    return model, params, images, x


def _port(params, train=True):
    return weights.load_ann_vqvae(params, CFG, device="cpu", train=train)


def _grads_sd(grads):
    return {k: torch.from_numpy(np.array(v)) for k, v in
            weights.ann_vqvae_state_dict(grads).items()}


def test_training_forward_and_gradients_equal_jax(setup):
    model, params, images, x = setup
    var = float(data_variance(images))

    def loss_fn(p):
        out = model.apply({"params": p}, jnp.asarray(x), train=True, data_variance=var)
        return out["vq_loss"] + out["recon_loss"], out

    (loss, jout), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    port = _port(params)
    out = port(torch.from_numpy(x), data_variance=var)
    for key in LOSSES:
        assert abs(float(out[key].detach()) - float(jout[key])) <= ATOL, key
    np.testing.assert_allclose(out["recon"].detach().numpy(), np.asarray(jout["recon"]),
                               rtol=0, atol=ATOL)
    (out["vq_loss"] + out["recon_loss"]).backward()
    want = _grads_sd(jax.device_get(jgrads))
    got = dict(port.named_parameters())
    assert sorted(got) == sorted(want)
    for key, g in want.items():
        np.testing.assert_allclose(got[key].grad.numpy(), g.numpy(), rtol=ATOL, atol=ATOL,
                                   err_msg=key)


def test_one_train_step_equals_optax(setup):
    model, params, images, x = setup
    var = float(data_variance(images))
    jstate = jax_state.create_train_state(model, {"params": params})
    jstate, jm = jax_stage1.make_train_step_vqvae(var, donate=False)(jstate, jnp.asarray(x))
    state = create_train_state(_port(params))
    m = stage1.make_train_step_vqvae(var)(state, torch.from_numpy(x))
    assert abs(float(m["loss"]) - float(jm["loss"])) <= ATOL
    want = weights.ann_vqvae_state_dict(jax.device_get(jstate.params))
    for key, value in state.model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[key], rtol=0, atol=PARAM_ATOL,
                                   err_msg=key)


def test_eval_codes_and_decode_equal_jax(setup):
    model, params, images, x = setup
    v = {"params": params}
    jout = model.apply(v, jnp.asarray(x), train=False)
    port = _port(params, train=False)
    out = port(torch.from_numpy(x))
    np.testing.assert_array_equal(out["indices"].numpy(), np.asarray(jout["indices"]))
    np.testing.assert_allclose(out["recon"].numpy(), np.asarray(jout["recon"]), rtol=0,
                               atol=ATOL)
    codes = port.encode_indices(torch.from_numpy(x))
    jcodes = model.apply(v, jnp.asarray(x), method="encode_indices")
    assert codes.dtype == torch.int32 and codes.shape == (BATCH, 3, 3)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_allclose(
        port.decode_indices(codes).numpy(),
        np.asarray(model.apply(v, jcodes, method="decode_indices")), rtol=0, atol=ATOL)
    jstate = jax_state.create_train_state(model, v)
    np.testing.assert_array_equal(
        stage1.extract_code_indices(port, images[:7], batch_size=4, device="cpu"),
        jax_stage1.extract_code_indices(jstate, images[:7], batch_size=4))


def test_ties_take_the_first_index():
    port = weights.load_ann_vqvae(weights.init_ann_vqvae_variables(
        CFG, torch.Generator().manual_seed(0)), CFG, device="cpu")
    with torch.no_grad():
        port.embeddings.zero_()
        port.embeddings[3] = 1.0
        port.embeddings[5] = 1.0
    flat = torch.ones((2, CFG.embedding_dim))
    assert port.get_code_indices(flat).tolist() == [3, 3]
