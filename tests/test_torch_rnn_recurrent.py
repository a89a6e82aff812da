"""The port's spiking RNNs, recurrent layers, attentions and DropConnect
against the JAX package's ``snn/rnn.py``, ``models/recurrent.py``,
``models/attention.py`` and ``models/dropconnect.py``.

Each layer is initialised by JAX ``init`` and carried over by
``weights.library_state_dict``; both run the same numpy input:

* the LSTM, GRU and Elman cells through ``SpikingRNN``, one way and
  bidirectional: spikes exactly, the final carry within 1e-5 and the
  gradients of a loss on the spikes (inputs and every parameter) within
  1e-5 of each tensor's largest (absolute below 1), as every gradient
  below;
* NeuNorm, SynapseFilter (fixed and learnable tau), the element-wise and
  linear recurrent containers around a LIF cell: outputs and gradients
  within 1e-5 (``tests/test_recurrent.py``'s own checks hold at 1e-5 and
  1e-6);
* tdBN in training mode (output, running statistics, gradients) and in
  eval mode within 1e-5, its scale starting at alpha * v_threshold;
* TemporalWiseAttention on (T, N, F) and (T, N, H, W, C) and
  MultiDimensionalAttention: outputs and gradients within 1e-5;
* DropConnectLinear in eval mode (the keep share of the weights) within
  1e-5 and, in training, the masks given or drawn from a seeded
  generator (keep share within 4 sigma).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spiking_diffusion_tpu.models import attention as jax_attention
from spiking_diffusion_tpu.models import dropconnect as jax_dropconnect
from spiking_diffusion_tpu.models import recurrent as jax_recurrent
from spiking_diffusion_tpu.snn import neuron as jax_neuron
from spiking_diffusion_tpu.snn import rnn as jax_rnn
from spiking_diffusion_tpu_torch.models import attention, dropconnect, recurrent, weights
from spiking_diffusion_tpu_torch.snn import neuron, rnn

ATOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _load(module, variables):
    sd = weights.library_state_dict(variables.get("params", {}), variables.get("batch_stats"))
    module.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return module


def _close(got, want, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol,
                               err_msg=what)


def _close_grad(got, want, what=""):
    """Within 1e-5 of the tensor's largest |gradient| (1e-5 below 1): a
    parameter's gradient sums over every element of the batch."""
    want = np.asarray(want)
    _close(got, want, ATOL * max(1.0, float(np.abs(want).max())), what)


def _hold(jax_fn, variables, port, port_fn, inputs, cot, extra=()):
    """Outputs and the VJP of ``cot`` against every parameter and input,
    JAX (``jax_fn(params, *inputs)``) against the port; returns the
    port's output."""
    params = jax.tree.map(jnp.asarray, variables["params"])
    out_j, vjp = jax.vjp(jax_fn, params, *[jnp.asarray(a) for a in inputs])
    grads_j = vjp(jnp.asarray(cot))
    xs = [torch.from_numpy(a).requires_grad_() for a in inputs]
    out = port_fn(*xs)
    out.backward(torch.from_numpy(cot))
    _close(out.detach(), out_j, what="output")
    want = weights.library_state_dict(_np(grads_j[0]), variables.get("batch_stats"))
    for key, p in port.named_parameters():
        _close_grad(p.grad, want[key], what=key)
    for x, g in zip(xs, grads_j[1:]):
        _close_grad(x.grad, g, what="input")
    return out


@pytest.mark.parametrize("bidirectional", [False, True], ids=["one_way", "bidirectional"])
@pytest.mark.parametrize("cell", ["lstm", "gru", "vanilla"])
def test_spiking_rnn_matches_jax(cell, bidirectional):
    rng = np.random.RandomState(0)
    x = rng.randn(6, 3, 5).astype(np.float32)
    m = jax_rnn.SpikingRNN(hidden=8, cell_type=cell, bidirectional=bidirectional)
    variables = _np(m.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    port = _load(rnn.SpikingRNN(5, 8, cell, bidirectional), variables)
    width = 16 if bidirectional else 8
    cot = rng.randn(6, 3, width).astype(np.float32)
    ys, carry = port(torch.from_numpy(x))
    ys_j, carry_j = m.apply(variables, jnp.asarray(x))
    np.testing.assert_array_equal(ys.detach().numpy(), np.asarray(ys_j))
    assert 0.05 < float(ys.detach().mean()) < 0.95
    for got, want in zip(jax.tree.leaves(jax.tree.map(np.asarray, carry_j)),
                         [c.detach().numpy() for c in _flat(carry)]):
        _close(want, got)
    _hold(lambda p, a: m.apply({"params": p}, a)[0], variables, port,
          lambda a: port(a)[0], [x], cot)


def _flat(carry):
    if isinstance(carry, torch.Tensor):
        return [carry]
    return [t for c in carry for t in _flat(c)]


def test_neunorm_matches_jax():
    rng = np.random.RandomState(1)
    s = (rng.rand(4, 2, 5, 5, 3) < 0.4).astype(np.float32)
    cot = rng.randn(*s.shape).astype(np.float32)
    for shared in (False, True):
        m = jax_recurrent.NeuNorm(k=0.8, shared_across_channels=shared)
        variables = _np(m.init(jax.random.PRNGKey(0), jnp.asarray(s)))
        port = _load(recurrent.NeuNorm(5, 5, 3, k=0.8, shared_across_channels=shared), variables)
        _hold(lambda p, a: m.apply({"params": p}, a), variables, port, port, [s], cot)


def test_synapse_filter_matches_jax():
    rng = np.random.RandomState(2)
    s = (rng.rand(6, 2, 7) < 0.5).astype(np.float32)
    cot = rng.randn(*s.shape).astype(np.float32)
    fixed = jax_recurrent.SynapseFilter(tau=3.0)
    out = recurrent.SynapseFilter(tau=3.0)(torch.from_numpy(s))
    _close(out, fixed.apply({}, jnp.asarray(s)))
    m = jax_recurrent.SynapseFilter(tau=5.0, learnable=True)
    variables = _np(m.init(jax.random.PRNGKey(0), jnp.asarray(s)))
    port = _load(recurrent.SynapseFilter(tau=5.0, learnable=True), variables)
    _hold(lambda p, a: m.apply({"params": p}, a), variables, port, port, [s], cot)
    assert abs(float(port.w.grad)) > 0


def test_recurrent_containers_match_jax():
    rng = np.random.RandomState(3)
    x = rng.uniform(0.0, 3.5, (6, 2, 4)).astype(np.float32)
    cot = rng.randn(6, 2, 4).astype(np.float32)
    # element-wise: y[t] = LIF(x[t] + 0.5 y[t-1])
    f_j = lambda a, y: a + 0.5 * y  # noqa: E731
    want, vjp = jax.vjp(lambda a: jax_recurrent.element_wise_recurrent(
        jax_recurrent.lif_cell(jax_neuron.NeuronParams()), f_j, a), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = recurrent.element_wise_recurrent(recurrent.lif_cell(neuron.NeuronParams()),
                                           lambda a, y: a + 0.5 * y, xt)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    assert 0.05 < float(got.detach().mean()) < 0.95
    _close(xt.grad, vjp(jnp.asarray(cot))[0])
    # stateless identity feedback: the running sum (tests/test_recurrent.py)
    ones = torch.ones((4, 3))
    np.testing.assert_allclose(
        recurrent.element_wise_recurrent(recurrent.stateless_cell(), lambda a, y: a + y,
                                         ones).numpy(), np.cumsum(np.ones((4, 3)), 0), rtol=1e-6)
    # linear container: y[t] = LIF(W [x[t]; y[t-1]] + b)
    m = jax_recurrent.LinearRecurrentContainer(out_features=4)
    cell_j = jax_recurrent.lif_cell(jax_neuron.NeuronParams())
    variables = _np(m.init(jax.random.PRNGKey(1), jnp.asarray(x), cell_j))
    for node in variables["params"]["Dense_0"].values():
        node *= 3.0  # fire at this width
    port = _load(recurrent.LinearRecurrentContainer(4, 4), variables)
    cell = recurrent.lif_cell(neuron.NeuronParams())
    out = _hold(lambda p, a: m.apply({"params": p}, a, cell_j), variables, port,
                lambda a: port(a, cell), [x], cot)
    assert 0.05 < float(out.detach().mean()) < 0.95


def test_threshold_dependent_batchnorm_matches_jax():
    rng = np.random.RandomState(4)
    x = rng.randn(3, 4, 5, 5, 6).astype(np.float32) * 2.0 + 0.5
    cot = rng.randn(*x.shape).astype(np.float32)
    m = jax_recurrent.ThresholdDependentBatchNorm(alpha=0.7, v_threshold=1.5)
    variables = _np(m.init(jax.random.PRNGKey(0), jnp.asarray(x), use_running_average=False))
    port = recurrent.ThresholdDependentBatchNorm(6, alpha=0.7, v_threshold=1.5)
    np.testing.assert_array_equal(port.scale.detach().numpy(),
                                  variables["params"]["BatchNorm_0"]["scale"])
    _load(port, variables).train()

    def jax_fn(p, a):
        return m.apply({"params": p, "batch_stats": variables["batch_stats"]}, a,
                       use_running_average=False, mutable=["batch_stats"])

    _hold(lambda p, a: jax_fn(p, a)[0], variables, port, port, [x], cot)
    stats = _np(jax_fn(jax.tree.map(jnp.asarray, variables["params"]),
                       jnp.asarray(x))[1]["batch_stats"])["BatchNorm_0"]
    _close(port.mean, stats["mean"], what="mean")
    _close(port.var, stats["var"], what="var")
    moved = {"params": variables["params"], "batch_stats": {"BatchNorm_0": stats}}
    port.eval()
    _close(port(torch.from_numpy(x)).detach(),
           m.apply(moved, jnp.asarray(x), use_running_average=True), what="eval")


@pytest.mark.parametrize("shape", [(8, 3, 10), (8, 2, 4, 4, 5)], ids=["TNF", "TNHWC"])
def test_temporal_wise_attention_matches_jax(shape):
    rng = np.random.RandomState(5)
    x = (rng.rand(*shape) < 0.4).astype(np.float32)
    cot = rng.randn(*shape).astype(np.float32)
    m = jax_attention.TemporalWiseAttention(reduction=4)
    variables = _np(m.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    port = _load(attention.TemporalWiseAttention(8, reduction=4), variables)
    _hold(lambda p, a: m.apply({"params": p}, a), variables, port, port, [x], cot)


def test_multi_dimensional_attention_matches_jax():
    rng = np.random.RandomState(6)
    x = (rng.rand(4, 2, 6, 6, 8) < 0.4).astype(np.float32)
    cot = rng.randn(*x.shape).astype(np.float32)
    m = jax_attention.MultiDimensionalAttention(reduction_t=2, reduction_c=4)
    variables = _np(m.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    port = _load(attention.MultiDimensionalAttention(4, 8, reduction_t=2, reduction_c=4),
                 variables)
    _hold(lambda p, a: m.apply({"params": p}, a), variables, port, port, [x], cot)


def test_dropconnect_matches_jax():
    rng = np.random.RandomState(7)
    x = rng.randn(5, 6).astype(np.float32)
    cot = rng.randn(5, 3).astype(np.float32)
    m = jax_dropconnect.DropConnectLinear(3, p=0.3)
    variables = _np(m.init(jax.random.PRNGKey(0), jnp.asarray(x), deterministic=True))
    port = _load(dropconnect.DropConnectLinear(6, 3, p=0.3), variables).eval()
    _hold(lambda p, a: m.apply({"params": p}, a, deterministic=True), variables, port, port,
          [x], cot)
    port.train()
    mw = (rng.rand(3, 6) < 0.7).astype(np.float32)
    mb = (rng.rand(3) < 0.7).astype(np.float32)
    got = port(torch.from_numpy(x), masks=(torch.from_numpy(mw), torch.from_numpy(mb)))
    w = weights.dense_weight(variables["params"]["kernel"])
    _close(got.detach(), x @ (w * mw).T + variables["params"]["bias"] * mb)
    big = dropconnect.DropConnectLinear(64, 64, p=0.3)
    w_mask, b_mask = big.masks(torch.Generator().manual_seed(0))
    keep = float(w_mask.mean())
    assert abs(keep - 0.7) <= 4 * (0.7 * 0.3 / w_mask.numel()) ** 0.5
    assert b_mask.shape == (64,)
    again, _ = big.masks(torch.Generator().manual_seed(0))
    assert torch.equal(w_mask, again)
