"""The port's diffusion training loss against the JAX package's.

``q_sample`` fed JAX's own uniforms (and ``corrupt``'s t) masks the same
positions; ``masked_cross_entropy`` and ``per_sample_loss`` in both loss
modes agree with JAX's at rtol 1e-6, atol 1e-6 on the same logits;
``pick_mask_id`` gives JAX's id in the three modes, ties included.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spiking_diffusion_tpu.config import DiffusionConfig as JaxDiffusionConfig
from spiking_diffusion_tpu.models import diffusion as jax_diffusion
from spiking_diffusion_tpu_torch.config import DiffusionConfig
from spiking_diffusion_tpu_torch.models import diffusion

TOL = dict(rtol=1e-6, atol=1e-6)
KW = dict(num_timesteps=8, num_embeddings=16, mask_id=16)


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _codes(n, seed, k=16):
    return np.random.RandomState(seed).randint(0, k, (n, 7, 7)).astype(np.int32)


def test_q_sample_and_corrupt_fed_jax_draws():
    x0 = _codes(6, seed=0)
    key = jax.random.PRNGKey(7)
    t = np.asarray([1, 2, 4, 6, 7, 8], np.int32)
    want = jax_diffusion.q_sample(key, jnp.asarray(x0), jnp.asarray(t), 16, 8)
    u = np.array(jax.random.uniform(key, x0.shape))
    got = diffusion.q_sample(torch.from_numpy(x0), torch.from_numpy(t), 16, 8,
                             torch.from_numpy(u))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert 0 < int(got[2].sum()) < x0.size
    # corrupt = sample_time on the first key half, q_sample on the second
    x_t, t_j, pt_j, ign = jax_diffusion.corrupt(key, jnp.asarray(x0), JaxDiffusionConfig(**KW))
    _, km = jax.random.split(key)
    u = np.array(jax.random.uniform(km, x0.shape))
    got = diffusion.q_sample(torch.from_numpy(x0), torch.from_numpy(np.array(t_j)), 16, 8,
                             torch.from_numpy(u))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(x_t))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ign))
    gen = torch.Generator().manual_seed(0)
    t_p, pt_p = diffusion.sample_time(6, 8, gen, "cpu")
    assert t_p.dtype == torch.int32 and int(t_p.min()) >= 1 and int(t_p.max()) <= 8
    np.testing.assert_array_equal(pt_p.numpy(), np.asarray(pt_j))


@pytest.mark.parametrize("loss_type", ["reweighted_elbo", "elbo"])
def test_per_sample_loss_matches_jax(loss_type):
    rs = np.random.RandomState(1)
    n = 5
    x0 = _codes(n, seed=2)
    t = np.asarray([1, 3, 5, 7, 8], np.int32)
    u = rs.uniform(size=x0.shape).astype(np.float32)
    x_t, ign, _ = (a.numpy() for a in diffusion.q_sample(
        torch.from_numpy(x0), torch.from_numpy(t), 16, 8, torch.from_numpy(u)))
    pt = np.full((n,), 1.0 / 8, np.float32)
    logits = (rs.normal(size=(n, 7, 7, 16)) * 3.0).astype(np.float32)
    jcfg = JaxDiffusionConfig(**KW, loss_type=loss_type)
    cfg = DiffusionConfig(**KW, loss_type=loss_type)

    def jax_fn(x, tt):
        return jnp.asarray(logits)

    def port_fn(x, tt):
        assert torch.equal(x, torch.from_numpy(x_t)) and torch.equal(tt, torch.from_numpy(t))
        return torch.from_numpy(logits)

    ce_j = jax_diffusion._masked_cross_entropy(jnp.asarray(logits), jnp.asarray(ign))
    ce = diffusion.masked_cross_entropy(torch.from_numpy(logits), torch.from_numpy(ign))
    np.testing.assert_allclose(ce.numpy(), np.asarray(ce_j), **TOL)
    want = jax_diffusion.per_sample_loss(jax_fn, jnp.asarray(x_t), jnp.asarray(t),
                                         jnp.asarray(pt), jnp.asarray(ign), jcfg)
    corruption = tuple(torch.from_numpy(a) for a in (x_t, t, pt, ign))
    got = diffusion.per_sample_loss(port_fn, *corruption, cfg)
    assert got.shape == (n,) and float(got.min()) >= 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    mean = diffusion.train_loss(port_fn, torch.from_numpy(x0), cfg, corruption=corruption)
    np.testing.assert_allclose(float(mean), float(jnp.mean(want)), **TOL)
    with pytest.raises(ValueError, match="loss_type"):
        diffusion.per_sample_loss(port_fn, *corruption, dataclasses.replace(cfg, loss_type="x"))


@pytest.mark.parametrize("mode", ["codebook_size", "max", "min"])
def test_pick_mask_id_matches_jax(mode):
    batches = [_codes(8, seed=3),
               np.zeros((2, 7, 7), np.int32),  # one code only
               np.tile(np.arange(7, dtype=np.int32), (2, 7, 1))]  # ties everywhere
    batches[0][0, 0, :5] = 9  # an unambiguous most common code
    for batch in batches:
        want = jax_diffusion.pick_mask_id(mode, 16, jnp.asarray(batch))
        assert diffusion.pick_mask_id(mode, 16, torch.from_numpy(batch)) == want
    with pytest.raises(ValueError, match="mask mode"):
        diffusion.pick_mask_id("median", 16, torch.from_numpy(batches[0]))
