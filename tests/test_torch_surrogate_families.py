"""The port's fourteen surrogate families against the JAX package's
``snn/surrogate.py``.

On the same float32 points (a uniform grid over [-3, 3] with the kinks
0, +-0.5, +-1, +-2 among them), for each family at the reference's
default parameters and at a second setting: ``grad``, ``primitive`` and
the backward of ``spike_fn`` equal JAX's within 1e-6 relative to the
largest |value| on the points (``torch.sigmoid`` and XLA's logistic part
by 2 ulps near 1, which ``1 - s`` lifts to 3e-6 of a small gradient;
a sum of cosines cancels to zero), the spikes exactly;
``check_surrogate_grad`` gives JAX's largest error within 1e-6 and, where
that error is a real gap and not a rounding (above 1e-6), at the same x;
``piecewise_leaky_relu``'s primitive keeps JAX's half slope inside the
band and ``fake_numerical_gradient`` has no primitive, as in JAX;
``get_surrogate`` fills JAX's second parameters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spiking_diffusion_tpu.snn import surrogate as jax_surrogate
from spiking_diffusion_tpu_torch.snn import surrogate

SETTINGS = {  # family -> (alpha, beta) pairs: the default, then another
    "atan": [(2.0, None), (0.5, None)],
    "sigmoid": [(4.0, None), (1.5, None)],
    "piecewise_quadratic": [(1.0, None), (2.0, None)],
    "soft_sign": [(2.0, None), (0.7, None)],
    "erf": [(2.0, None), (1.3, None)],
    "leaky_k_relu": [(0.0, 1.0), (0.1, 0.5)],
    "piecewise_exp": [(1.0, None), (3.0, None)],
    "nonzero_sign_log_abs": [(1.0, None), (2.5, None)],
    "piecewise_leaky_relu": [(1.0, 0.01), (0.5, 0.1)],
    "squarewave_fourier_series": [(2.0, 8.0), (5.0, 6.0)],
    "s2nn": [(4.0, 1.0), (2.0, 0.5)],
    "q_pseudo_spike": [(2.0, None), (3.5, None)],
    "fake_numerical_gradient": [(0.3, None), (0.6, None)],
    "log_tailed_relu": [(0.0, None), (0.05, None)],
}
CASES = [(name, i) for name in sorted(SETTINGS) for i in range(2)]
RTOL = 1e-6


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _points() -> np.ndarray:
    grid = np.linspace(-3.0, 3.0, 2001, dtype=np.float32)
    kinks = np.array([0.0, 0.5, -0.5, 1.0, -1.0, 2.0, -2.0], np.float32)
    return np.concatenate([grid, kinks])


def _close(got, want) -> None:
    want = np.asarray(want)
    scale = float(np.max(np.abs(want[np.isfinite(want)])))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale)


def _pair(name, i):
    alpha, beta = SETTINGS[name][i]
    return (jax_surrogate.SurrogateFn(name, alpha, beta),
            surrogate.SurrogateFn(name, alpha, beta))


def test_every_jax_family_is_ported():
    assert set(surrogate.FAMILIES) == set(jax_surrogate._GRADS) == set(SETTINGS)
    assert set(surrogate._PRIMS) == set(jax_surrogate._PRIMS)
    assert surrogate.KERNEL_FAMILIES == ("atan", "sigmoid")


@pytest.mark.parametrize("name,i", CASES)
def test_grad_and_primitive_match_jax(name, i):
    jf, tf = _pair(name, i)
    x = _points()
    _close(tf.grad(torch.from_numpy(x)).numpy(), jf.grad(jnp.asarray(x)))
    if name == "fake_numerical_gradient":
        for fn, arg in ((jf, jnp.asarray(x)), (tf, torch.from_numpy(x))):
            with pytest.raises(ValueError, match="no primitive"):
                fn.primitive(arg)
        return
    _close(tf.primitive(torch.from_numpy(x)).numpy(), jf.primitive(jnp.asarray(x)))


@pytest.mark.parametrize("name,i", CASES)
def test_spike_fn_backward_matches_jax(name, i):
    jf, _ = _pair(name, i)
    alpha, beta = SETTINGS[name][i]
    x = _points()
    g = np.random.RandomState(3).randn(x.size).astype(np.float32)
    s_jax, vjp = jax.vjp(lambda v: jax_surrogate.spike_fn(v, name, alpha, beta), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    s = surrogate.spike_fn(xt, name, alpha, beta)
    s.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(s.detach().numpy(), np.asarray(s_jax))
    _close(xt.grad.numpy(), vjp(jnp.asarray(g))[0])


@pytest.mark.parametrize("name,i", CASES)
def test_check_surrogate_grad_matches_jax(name, i):
    jf, tf = _pair(name, i)
    if name == "fake_numerical_gradient":
        with pytest.raises(ValueError, match="no primitive"):
            surrogate.check_surrogate_grad(tf)
        return
    err_jax, x_jax = jax_surrogate.check_surrogate_grad(jf)
    err, x = surrogate.check_surrogate_grad(tf)
    assert abs(err - err_jax) <= 1e-6, (err, err_jax)
    if err_jax > 1e-6:
        assert x == x_jax, (x, x_jax)


def test_piecewise_leaky_relu_keeps_the_half_slope():
    fn = surrogate.piecewise_leaky_relu
    err, x = surrogate.check_surrogate_grad(fn)
    assert err == pytest.approx(0.5) and abs(x) < 1.0  # 1/w against 1/(2w)


def test_get_surrogate_defaults_match_jax():
    for name in sorted(SETTINGS):
        want = jax_surrogate.get_surrogate(name, 1.5)
        got = surrogate.get_surrogate(name, 1.5)
        assert (got.name, got.alpha, got.beta) == (want.name, want.alpha, want.beta)
    with pytest.raises(ValueError, match="unknown surrogate"):
        surrogate.get_surrogate("relu", 1.0)
    for inst in ("atan", "sigmoid", "erf", "s2nn", "squarewave_fourier_series",
                 "fake_numerical_gradient", "log_tailed_relu", "leaky_k_relu"):
        want, got = getattr(jax_surrogate, inst, None), getattr(surrogate, inst)
        if want is not None:
            assert (got.name, got.alpha, got.beta) == (want.name, want.alpha, want.beta)
