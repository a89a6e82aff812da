"""K4 (the training conv with BN moments) in the PyTorch port against the
JAX package's.

The port's ``spike_conv3x3`` on the CPU (its plain versions,
``spike_conv3x3_fwd_reference`` and ``spike_conv3x3_bwd_reference``, and
autograd through the ``torch.autograd.Function``) is held against
``ops.spike_conv.spike_conv3x3`` and ``jax.vjp`` of it in Pallas interpret
mode, on the same numpy inputs. The JAX side takes (T, N, H, W, C) and an
HWIO kernel, the port (T * N, C, H, W) and OIHW; the tests transpose
between them.

Tolerances are those of the JAX package's own test of its kernel against
XLA's conv (tests/test_spike_conv.py), since the two sum in different
orders: y within 1e-5, s1 and s2 within rtol 1e-4, atol 1e-3, dx, dW and
db within 1e-4; in bf16, y within 2e-2 (a bf16 rounding step) and s1, s2
within rtol 2e-2, atol 0.5 (sums of those y). The kernels themselves are
held against their plain versions on the card in
tests/test_torch_kernels_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spiking_diffusion_tpu.ops import spike_conv as jax_spike_conv
from spiking_diffusion_tpu_torch.ops import spike_conv as port_spike_conv

FWD_CASES = {
    # (T, N, H=W, Cin, Cout, dtype, with_moments)
    "hw7_6to10": (3, 5, 7, 6, 10, "fp32", True),
    "hw4_3to5": (2, 4, 4, 3, 5, "fp32", True),
    "odd_n3": (3, 3, 7, 6, 10, "fp32", True),
    "bf16": (3, 5, 7, 6, 10, "bf16", True),
    "no_moments": (3, 5, 7, 6, 10, "fp32", False),
}
BWD_CASES = {
    # (gs1/gs2 scale, with_moments, need_dx)
    "moment_cotangents": (1.0, True, True),
    "zero_moment_cotangents": (0.0, True, True),
    "no_moments": (1.0, False, True),
    "no_dx": (1.0, True, False),
}
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
Y_TOL = {"fp32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}
MOMENT_TOL = {"fp32": dict(rtol=1e-4, atol=1e-3), "bf16": dict(rtol=2e-2, atol=0.5)}
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def setup():
    torch.set_num_threads(1)
    old = jax_spike_conv._INTERPRET
    jax_spike_conv._INTERPRET = True
    yield
    jax_spike_conv._INTERPRET = old


def _data(t, n, hw, cin, cout, seed):
    rs = np.random.RandomState(seed)
    x = rs.normal(size=(t, n, hw, hw, cin)).astype(np.float32)
    kernel = (rs.normal(size=(3, 3, cin, cout)) * 0.2).astype(np.float32)
    bias = (rs.normal(size=(cout,)) * 0.1).astype(np.float32)
    return x, kernel, bias


def _to_port(a: np.ndarray, dtype) -> torch.Tensor:
    """(T, N, H, W, C) -> (T * N, C, H, W)."""
    t, n, h, w, c = a.shape
    return torch.from_numpy(np.ascontiguousarray(
        a.reshape(t * n, h, w, c).transpose(0, 3, 1, 2))).to(dtype)


def _to_jax_layout(a: torch.Tensor, t: int) -> np.ndarray:
    tn, c, h, w = a.shape
    return a.detach().float().permute(0, 2, 3, 1).reshape(t, tn // t, h, w, c).numpy()


def _oihw(kernel: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_forward_matches_jax(case):
    t, n, hw, cin, cout, dname, moments = FWD_CASES[case]
    jdt, tdt = DTYPES[dname]
    x, kernel, bias = _data(t, n, hw, cin, cout, seed=len(case))
    y_j, s1_j, s2_j = jax.jit(lambda a, k, b: jax_spike_conv.spike_conv3x3(
        a, k, b, with_moments=moments))(jnp.asarray(x).astype(jdt), jnp.asarray(kernel),
                                        jnp.asarray(bias))
    y, s1, s2 = port_spike_conv.spike_conv3x3(_to_port(x, tdt), _oihw(kernel),
                                              torch.from_numpy(bias), with_moments=moments)
    assert y.dtype == tdt and y.shape == (t * n, cout, hw, hw)
    assert s1.dtype == s2.dtype == torch.float32
    np.testing.assert_allclose(_to_jax_layout(y, t), np.asarray(y_j.astype(jnp.float32)),
                               **Y_TOL[dname])
    if moments:
        np.testing.assert_allclose(s1.numpy(), np.asarray(s1_j), **MOMENT_TOL[dname])
        np.testing.assert_allclose(s2.numpy(), np.asarray(s2_j), **MOMENT_TOL[dname])
    else:
        assert float(s1.abs().sum()) == float(s2.abs().sum()) == 0.0
        assert float(jnp.abs(s1_j).sum()) == 0.0


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_backward_matches_jax_vjp(case):
    scale, moments, need_dx = BWD_CASES[case]
    t, n, hw, cin, cout = 3, 5, 7, 6, 10
    x, kernel, bias = _data(t, n, hw, cin, cout, seed=20 + len(case))
    rs = np.random.RandomState(7)
    gy = rs.normal(size=(t, n, hw, hw, cout)).astype(np.float32)
    gs1 = (rs.normal(size=(cout,)) * scale).astype(np.float32)
    gs2 = (rs.normal(size=(cout,)) * 0.1 * scale).astype(np.float32)

    _, vjp = jax.vjp(lambda a, k, b: jax_spike_conv.spike_conv3x3(a, k, b, with_moments=moments),
                     jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias))
    dx_j, dk_j, db_j = (np.asarray(a) for a in vjp((jnp.asarray(gy), jnp.asarray(gs1),
                                                      jnp.asarray(gs2))))

    xt = _to_port(x, torch.float32).requires_grad_(need_dx)
    w = _oihw(kernel).requires_grad_(True)
    b = torch.from_numpy(bias).requires_grad_(True)
    y, s1, s2 = port_spike_conv.spike_conv3x3(xt, w, b, with_moments=moments)
    torch.autograd.backward((y, s1, s2), (_to_port(gy, torch.float32),
                                          torch.from_numpy(gs1), torch.from_numpy(gs2)))
    np.testing.assert_allclose(w.grad.permute(2, 3, 1, 0).numpy(), dk_j, **GRAD_TOL)
    np.testing.assert_allclose(b.grad.numpy(), db_j, **GRAD_TOL)
    if need_dx:
        np.testing.assert_allclose(_to_jax_layout(xt.grad, t), dx_j, **GRAD_TOL)
    else:
        assert xt.grad is None


def test_backward_bf16_and_none_cotangents():
    """bf16: dx in bf16, dW and db in fp32, against JAX's bf16 vjp; a
    cotangent that never arrives (s1, s2 unused) counts as zero."""
    t, n, hw, cin, cout = 2, 3, 7, 4, 6
    x, kernel, bias = _data(t, n, hw, cin, cout, seed=31)
    gy = np.random.RandomState(8).normal(size=(t, n, hw, hw, cout)).astype(np.float32)
    zeros = jnp.zeros((cout,), jnp.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    _, vjp = jax.vjp(lambda a, k, b: jax_spike_conv.spike_conv3x3(a, k, b),
                     xb, jnp.asarray(kernel), jnp.asarray(bias))
    dx_j, dk_j, db_j = vjp((jnp.asarray(gy).astype(jnp.bfloat16), zeros, zeros))

    xt = _to_port(x, torch.bfloat16).requires_grad_(True)
    w = _oihw(kernel).requires_grad_(True)
    b = torch.from_numpy(bias).requires_grad_(True)
    y, _, _ = port_spike_conv.spike_conv3x3(xt, w, b)
    y.backward(_to_port(gy, torch.bfloat16))
    assert xt.grad.dtype == torch.bfloat16 and w.grad.dtype == b.grad.dtype == torch.float32
    np.testing.assert_allclose(_to_jax_layout(xt.grad, t),
                               np.asarray(dx_j.astype(jnp.float32)), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(w.grad.permute(2, 3, 1, 0).numpy(), np.asarray(dk_j),
                               **GRAD_TOL)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(db_j), **GRAD_TOL)


def test_plain_versions_take_the_cpu_and_reject_what_they_do_not_take():
    x = torch.zeros((2, 3, 5, 5))
    w = torch.zeros((4, 3, 3, 3))
    b = torch.zeros(4)
    before = (port_spike_conv.LAUNCHES_FWD, port_spike_conv.LAUNCHES_BWD)
    port_spike_conv.spike_conv3x3_fwd(x, w, b)
    assert (port_spike_conv.LAUNCHES_FWD, port_spike_conv.LAUNCHES_BWD) == before
    with pytest.raises(ValueError):
        port_spike_conv.spike_conv3x3(x, torch.zeros((4, 3, 1, 1)), b)
    with pytest.raises(ValueError):
        port_spike_conv.spike_conv3x3(x, w, torch.zeros(5))
    with pytest.raises(TypeError):
        port_spike_conv.spike_conv3x3(x.half(), w, b)
    with pytest.raises(TypeError):
        port_spike_conv.spike_conv3x3(x, w.double(), b)
    assert port_spike_conv.wgrad_splits(200704, 256, 512) == (8, 25088)
    splits, per = port_spike_conv.wgrad_splits(12544, 2, 64)
    assert splits * per >= 12544 > (splits - 1) * per
