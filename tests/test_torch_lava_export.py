"""The port's netx HDF5 export against ``spiking_diffusion_tpu.models.lava_export``.

The CUBA device parameters equal JAX's. The port writes ``denoiser.net``
and ``encoder.net`` from modules loaded from the variables JAX writes
them from: the same groups, datasets and attributes; every integer or
byte dataset and every attribute equal, every float dataset within 1e-6
relative (the BN fold's fp32 operations).
"""

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spiking_diffusion_tpu.config import DiffusionConfig as JaxDiffusionConfig
from spiking_diffusion_tpu.config import VQVAEConfig as JaxVQVAEConfig
from spiking_diffusion_tpu.models import SNNVQVAE as JaxSNNVQVAE
from spiking_diffusion_tpu.models import SpikingDenoiser as JaxDenoiser
from spiking_diffusion_tpu.models import lava_export as jax_lava
from spiking_diffusion_tpu.snn.neuron import NeuronParams as JaxNeuronParams
from spiking_diffusion_tpu_torch.config import DiffusionConfig, VQVAEConfig
from spiking_diffusion_tpu_torch.models import lava_export, weights
from spiking_diffusion_tpu_torch.snn.neuron import NeuronParams

FOLD_RTOL = 1e-6
DIFF = dict(num_timesteps=4, latent_size=7, num_embeddings=6, mask_id=6, num_steps=3,
            denoiser_channels=(4, 8, 4, 4, 4))
VQ = dict(num_steps=3, embedding_dim=4, num_embeddings=8, enc_channels=(4, 8),
          dec_channels=(8, 4))
NEURONS = [dict(), dict(tau=4.0, v_threshold=0.5), dict(decay_input=False, tau=3.0),
           dict(v_threshold=1.3, tau=1.5)]


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("kw", NEURONS)
def test_cuba_device_params_equal_jax(kw):
    assert lava_export.cuba_device_params(NeuronParams(**kw)) == \
        jax_lava.cuba_device_params(JaxNeuronParams(**kw))
    assert lava_export.input_weight_scale(NeuronParams(**kw)) == \
        jax_lava.input_weight_scale(JaxNeuronParams(**kw))


def test_cuba_rejections_kept():
    for kw in (dict(v_reset=0.5), dict(hard_reset=False)):
        with pytest.raises(ValueError):
            jax_lava.cuba_device_params(JaxNeuronParams(**kw))
        with pytest.raises(ValueError):
            lava_export.cuba_device_params(NeuronParams(**kw))


def _with_stats(v, seed):
    """numpy variables, the BN statistics moved off identity."""
    rng = np.random.RandomState(seed)
    tree = jax.tree.map(np.array, {k: v[k] for k in ("params", "batch_stats")})

    def move(node):
        for k, x in node.items():
            if hasattr(x, "items"):
                move(x)
            elif k == "mean":
                node[k] = rng.uniform(-0.3, 0.3, x.shape).astype(np.float32)
            elif k == "var":
                node[k] = rng.uniform(0.2, 2.0, x.shape).astype(np.float32)

    move(tree["batch_stats"])
    return tree


def _contents(path):
    """{name: (kind, value)} of every dataset and attribute in a file."""
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            for k, a in obj.attrs.items():
                out[f"{name}@{k}"] = np.asarray(a)
            if isinstance(obj, h5py.Dataset):
                out[name] = np.asarray(obj[()])

        for k, a in f.attrs.items():
            out[f"@{k}"] = np.asarray(a)
        f.visititems(visit)
    return out


def _assert_files_match(got_path, want_path):
    got, want = _contents(got_path), _contents(want_path)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype, w.dtype)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=FOLD_RTOL, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def test_denoiser_netx_matches_jax(tmp_path):
    model = JaxDenoiser(JaxDiffusionConfig(**DIFF), backend="scan")
    v = jax.jit(lambda k: model.init(k, jnp.zeros((2, 7, 7), jnp.int32),
                                     jnp.ones((2,), jnp.int32), train=True))(
        jax.random.PRNGKey(0))
    variables = _with_stats(v, 1)
    jax_lava.denoiser_to_netx(variables, JaxDiffusionConfig(**DIFF), str(tmp_path / "jax.net"))
    cfg = DiffusionConfig(**DIFF)
    den = weights.load_denoiser(variables["params"], variables["batch_stats"], cfg,
                                device="cpu")
    out = lava_export.denoiser_to_netx(den, cfg, str(tmp_path / "port.net"))
    assert out == str(tmp_path / "port.net")
    _assert_files_match(out, str(tmp_path / "jax.net"))
    with h5py.File(out, "r") as f:
        n = len(DIFF["denoiser_channels"])
        assert list(f["layer"].attrs["skip"]) == [n, 1]
        assert "neuron" not in f["layer"][str(n + 1)]


def test_encoder_netx_matches_jax(tmp_path):
    model = JaxSNNVQVAE(JaxVQVAEConfig(**VQ), backend="scan")
    v = jax.jit(lambda k: model.init(k, jnp.zeros((2, 28, 28, 1)), train=True))(
        jax.random.PRNGKey(1))
    variables = _with_stats(v, 2)
    jax_lava.encoder_to_netx(variables, JaxVQVAEConfig(**VQ), str(tmp_path / "jax.net"))
    cfg = VQVAEConfig(**VQ)
    vq = weights.load_vqvae(variables["params"], variables["batch_stats"], cfg, device="cpu")
    out = lava_export.encoder_to_netx(vq, cfg, str(tmp_path / "port.net"))
    _assert_files_match(out, str(tmp_path / "jax.net"))
