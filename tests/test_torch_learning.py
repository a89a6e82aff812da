"""The port's STDP learners, FPTT and Tempotron against the JAX package's
``snn/learning.py``, ``snn/fptt.py`` and ``snn/tempotron.py``.

* ``stdp_step``, ``stdp_scan``, ``mstdp_scan`` and ``mstdpet_scan`` on the
  same random spike trains and rewards: within 1e-6
  (``tests/test_rnn_learning.py``'s tolerance), the causal sign of a
  pre-then-post pair kept.
* ``fptt_online_training`` of a Linear -> LIF -> Linear cell
  (``tests/test_fptt.py``'s) over T = 6 steps: the parameters after the
  last step and the per-step losses within 1e-5.
* ``psp_kernel``, ``gaussian_tuning_encode``, ``tempotron_v`` and
  ``tempotron_classify``: within 1e-6 (and 1e-6 relative: spike times
  reach 20), the predictions equal.

Every comparison also allows 1e-6 of the value's size.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spiking_diffusion_tpu.snn import fptt as jax_fptt
from spiking_diffusion_tpu.snn import learning as jax_learning
from spiking_diffusion_tpu.snn import neuron as jax_neuron
from spiking_diffusion_tpu.snn import tempotron as jax_tempotron
from spiking_diffusion_tpu_torch.snn import fptt, learning, neuron, tempotron

TOL = 1e-6


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _close(got, want, atol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL, atol=atol)


def _trains(seed, t=7, b=3, n_pre=5, n_post=4):
    rng = np.random.RandomState(seed)
    pre = (rng.rand(t, b, n_pre) < 0.4).astype(np.float32)
    post = (rng.rand(t, b, n_post) < 0.4).astype(np.float32)
    reward = rng.randn(t).astype(np.float32)
    return pre, post, reward


def test_stdp_learners_match_jax():
    pre, post, reward = _trains(0)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    j = jnp.asarray
    _close(learning.stdp_scan(t(pre), t(post), 3.0, 2.5, 0.7, 1.3),
           jax_learning.stdp_scan(j(pre), j(post), 3.0, 2.5, 0.7, 1.3))
    _close(learning.mstdp_scan(t(pre), t(post), t(reward), 2.0, 4.0),
           jax_learning.mstdp_scan(j(pre), j(post), j(reward), 2.0, 4.0))
    _close(learning.mstdpet_scan(t(pre), t(post), t(reward), 2.0, 2.0, 3.0),
           jax_learning.mstdpet_scan(j(pre), j(post), j(reward), 2.0, 2.0, 3.0))
    st, dw = learning.stdp_step(learning.init_state(5, 4, 3), t(pre[0]), t(post[0]))
    st_j, dw_j = jax_learning.stdp_step(jax_learning.init_state(5, 4, 3), j(pre[0]), j(post[0]))
    _close(dw, dw_j)
    _close(st.trace_pre, st_j.trace_pre)
    _close(st.trace_post, st_j.trace_post)
    # pre at t = 0, post at t = 1: potentiation; the other way round: depression
    a = np.zeros((4, 1, 1), np.float32)
    b = np.zeros((4, 1, 1), np.float32)
    a[0], b[1] = 1.0, 1.0
    assert float(learning.stdp_scan(t(a), t(b))[0, 0]) > 0
    assert float(learning.stdp_scan(t(b), t(a))[0, 0]) < 0


def _cell_jax(params, state, x_t):
    h = x_t @ params["w1"] + params["b1"]
    v, s = jax_neuron.lif_step(state, h, jax_neuron.NeuronParams())
    return v, s @ params["w2"]


def _cell_port(params, state, x_t):
    h = x_t @ params["w1"] + params["b1"]
    v, s = neuron.lif_step(state, h, neuron.NeuronParams())
    return v, s @ params["w2"]


def test_fptt_matches_jax():
    rng = np.random.RandomState(1)
    params = {"w1": rng.randn(4, 8).astype(np.float32) * 0.8,
              "b1": rng.randn(8).astype(np.float32) * 0.3,
              "w2": rng.randn(8, 2).astype(np.float32) * 0.5}
    t_steps, n = 6, 5
    x = (rng.rand(t_steps, n, 4) * 2).astype(np.float32)
    tgt = rng.rand(t_steps, n, 2).astype(np.float32)
    f_loss_j = lambda y, tg: jnp.mean((y - tg) ** 2)  # noqa: E731
    f_loss = lambda y, tg: torch.mean((y - tg) ** 2)  # noqa: E731
    p_j, losses_j = jax_fptt.fptt_online_training(
        _cell_jax, {k: jnp.asarray(v) for k, v in params.items()}, jnp.zeros((n, 8)),
        jnp.asarray(x), jnp.asarray(tgt), f_loss_j, lr=0.05, alpha=0.5)
    p, losses = fptt.fptt_online_training(
        _cell_port, {k: torch.from_numpy(v) for k, v in params.items()}, torch.zeros((n, 8)),
        torch.from_numpy(x), torch.from_numpy(tgt), f_loss, lr=0.05, alpha=0.5)
    assert set(p) == set(params)
    for k in params:
        assert not np.allclose(p[k].numpy(), params[k])
        _close(p[k], p_j[k], 1e-5)
    _close(losses, losses_j, 1e-5)


def test_tempotron_matches_jax():
    rng = np.random.RandomState(2)
    t_grid = np.linspace(0, 50, 101).astype(np.float32)
    t_spikes = rng.uniform(0, 45, (4, 6)).astype(np.float32)
    w = rng.randn(3, 6).astype(np.float32)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    j = jnp.asarray
    _close(tempotron.psp_kernel(t(t_grid[:, None]), t(t_spikes[0][None, :])),
           jax_tempotron.psp_kernel(j(t_grid[:, None]), j(t_spikes[0][None, :])))
    _close(tempotron.tempotron_v(t(w[0]), t(t_spikes[0]), t(t_grid), tau=12.0),
           jax_tempotron.tempotron_v(j(w[0]), j(t_spikes[0]), j(t_grid), tau=12.0))
    v_peak, pred = tempotron.tempotron_classify(t(w), t(t_spikes), t(t_grid))
    v_peak_j, pred_j = jax_tempotron.tempotron_classify(j(w), j(t_spikes), j(t_grid))
    _close(v_peak, v_peak_j)
    np.testing.assert_array_equal(pred.numpy(), np.asarray(pred_j))
    feats = rng.rand(2, 3).astype(np.float32)
    _close(tempotron.gaussian_tuning_encode(t(feats), 8, 20.0, 0.0, 1.0),
           jax_tempotron.gaussian_tuning_encode(j(feats), 8, 20.0, 0.0, 1.0))
    with pytest.raises(ValueError, match="n_neurons > 2"):
        tempotron.gaussian_tuning_encode(t(feats), 2, 20.0, 0.0, 1.0)
