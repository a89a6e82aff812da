"""The port's training-mode ``SeqBatchNorm`` against the JAX package's.

The same (T, N, H, W, C) numpy sequence and the same scale and bias go
through JAX ``models.layers.SeqBatchNorm`` in training mode and through
the port's on (T*N, C, H, W). Held at rtol 1e-6, atol 1e-6 (the JAX
package's tolerance for BN statistics, tests/test_denoiser_bnlif.py): the
normalised output, the new running mean and (biased) variance, the
``return_affine`` factors, and the gradient into x of a fixed weighted
sum of the output. The gradients into scale and bias are per-channel
fp32 sums of T*N*H*W = 300 products, which XLA on the CPU adds in
sequence and PyTorch in another order; against an fp64 sum either side
is off by up to ~1.5e-5 here. They are held within 1e-6 of the sum of
the products' magnitudes, the scale of an fp32 sum's rounding. Eval mode
is checked to stay the running-statistics formula.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spiking_diffusion_tpu.models.layers import SeqBatchNorm as JaxSeqBatchNorm
from spiking_diffusion_tpu_torch.models.layers import SeqBatchNorm

TOL = dict(rtol=1e-6, atol=1e-6)
T, N, H, W, C = 4, 3, 5, 5, 6


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _setup(seed=0):
    rs = np.random.RandomState(seed)
    x = (rs.normal(size=(T, N, H, W, C)) * 1.5 + 0.5).astype(np.float32)
    w = rs.normal(size=x.shape).astype(np.float32)
    gamma = rs.uniform(0.5, 1.5, C).astype(np.float32)
    beta = rs.uniform(-0.3, 0.3, C).astype(np.float32)
    ra_mean = rs.normal(size=C).astype(np.float32) * 0.1
    ra_var = rs.uniform(0.5, 2.0, C).astype(np.float32)
    variables = {"params": {"BatchNorm_0": {"scale": gamma, "bias": beta}},
                 "batch_stats": {"BatchNorm_0": {"mean": ra_mean, "var": ra_var}}}
    bn = SeqBatchNorm(C)
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(gamma))
        bn.bias.copy_(torch.from_numpy(beta))
        bn.mean.copy_(torch.from_numpy(ra_mean))
        bn.var.copy_(torch.from_numpy(ra_var))
    return x, w, variables, bn


def _port(a: np.ndarray) -> torch.Tensor:
    """(T, N, H, W, C) -> (T*N, C, H, W)."""
    return torch.from_numpy(np.ascontiguousarray(
        a.reshape(T * N, H, W, C).transpose(0, 3, 1, 2)))


def _jax_layout(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).reshape(T, N, H, W, C).numpy()


def test_training_forward_backward_and_running_stats():
    x, w, variables, bn = _setup()
    model = JaxSeqBatchNorm(use_running_average=False)

    def loss(params, xx):
        y, mut = model.apply({**variables, "params": params}, xx, mutable=["batch_stats"])
        return jnp.sum(y * jnp.asarray(w)), (y, mut["batch_stats"])

    (_, (y_j, stats_j)), (gp_j, gx_j) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(variables["params"], jnp.asarray(x))
    xt = _port(x).requires_grad_()
    bn.train()
    y = bn(xt)
    (y * _port(w)).sum().backward()
    np.testing.assert_allclose(_jax_layout(y), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(bn.mean.numpy(), np.asarray(stats_j["BatchNorm_0"]["mean"]), **TOL)
    np.testing.assert_allclose(bn.var.numpy(), np.asarray(stats_j["BatchNorm_0"]["var"]), **TOL)
    np.testing.assert_allclose(_jax_layout(xt.grad), np.asarray(gx_j), **TOL)
    # the magnitudes of the summed products, per channel
    xt64 = _port(x).double()
    xhat = (xt64 - xt64.mean((0, 2, 3), keepdim=True)) / xt64.std(
        (0, 2, 3), correction=0, keepdim=True)
    w64 = _port(w).double()
    for grad, want, terms in ((bn.scale.grad, gp_j["BatchNorm_0"]["scale"], w64 * xhat),
                              (bn.bias.grad, gp_j["BatchNorm_0"]["bias"], w64)):
        bound = 1e-6 * terms.abs().sum((0, 2, 3)).numpy()
        assert (np.abs(grad.numpy() - np.asarray(want)) <= bound).all()


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_return_affine(train):
    x, _, variables, bn = _setup(seed=1)
    model = JaxSeqBatchNorm(use_running_average=not train)
    (sc_j, sh_j), mut = jax.jit(lambda v, xx: model.apply(
        v, xx, return_affine=True, mutable=["batch_stats"]))(variables, jnp.asarray(x))
    stats_j = mut["batch_stats"] if train else variables["batch_stats"]
    bn.train(train)
    sc, sh = bn(_port(x), return_affine=True)
    np.testing.assert_allclose(sc.detach().numpy(), np.asarray(sc_j), **TOL)
    np.testing.assert_allclose(sh.detach().numpy(), np.asarray(sh_j), **TOL)
    np.testing.assert_allclose(bn.mean.numpy(), np.asarray(stats_j["BatchNorm_0"]["mean"]), **TOL)
    np.testing.assert_allclose(bn.var.numpy(), np.asarray(stats_j["BatchNorm_0"]["var"]), **TOL)
    # the folded factors applied to x give the unfused training output
    bn.load_state_dict(_setup(seed=1)[3].state_dict())
    y = bn(_port(x))
    folded = _port(x) * sc.reshape(1, -1, 1, 1) + sh.reshape(1, -1, 1, 1)
    np.testing.assert_allclose(folded.detach().numpy(), y.detach().numpy(), rtol=1e-5, atol=1e-5)


def test_eval_mode_uses_running_statistics_unchanged():
    x, _, variables, bn = _setup(seed=2)
    bn.eval()
    before = {k: v.clone() for k, v in bn.state_dict().items()}
    y = bn(_port(x))
    shape = (1, -1, 1, 1)
    want = ((_port(x) - bn.mean.reshape(shape))
            * (torch.rsqrt(bn.var + bn.eps) * bn.scale).reshape(shape) + bn.bias.reshape(shape))
    assert torch.equal(y, want)
    assert all(torch.equal(before[k], v) for k, v in bn.state_dict().items())
