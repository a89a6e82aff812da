"""The port's monitors (``profiling/monitor.py``) against the JAX package's
``profiling/monitor.py``, on the same numpy inputs and weights (a tiny
VQ-VAE whose BN parameters make every LIF layer fire; the JAX side's LIF
layers through the scan oracle, its variables stripped to ``params`` and
``batch_stats``).

* ``capture_outputs``: every key the port gives is one of JAX's, and each
  tensor equals JAX's in JAX's layout within 1e-5 (the convolutions sum
  in another order); the spike trains exactly.
* ``spike_rates``: the same layers, the rates within 1e-6.
* ``membrane_traces``: exactly JAX's, in fp32 and bf16.
* ``grad_norms``: the same parameter paths, the norms within rtol 1e-5;
  those of the conv biases ahead of a training-mode BN, whose gradient is
  zero but for round-off, under 1e-6 on both sides.
* ``DeviceMonitor``: on a host without a card, samples of the time only
  and JAX's empty summary; stopping twice is safe.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spiking_diffusion_tpu.config import VQVAEConfig as JaxVQVAEConfig
from spiking_diffusion_tpu.models.vqvae import SNNVQVAE as JaxSNNVQVAE
from spiking_diffusion_tpu.profiling import monitor as jax_monitor
from spiking_diffusion_tpu_torch.config import VQVAEConfig
from spiking_diffusion_tpu_torch.models import weights
from spiking_diffusion_tpu_torch.profiling import monitor

KW = dict(num_steps=4, embedding_dim=4, num_embeddings=12, enc_channels=(4, 8),
          dec_channels=(8, 4))
OUT_TOL = dict(rtol=1e-5, atol=1e-5)
RATE_ATOL = 1e-6
GRAD_RTOL = 1e-5
ZERO_GRAD = 1e-6  # the norm of a gradient that is zero but for round-off


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def problem():
    """(JAX model, numpy variables, images); BN scale in [2, 5] and shift
    in [0.5, 1.5] per channel, so that every LIF layer fires."""
    rs = np.random.RandomState(0)
    images = (rs.uniform(0, 1, (2, 28, 28, 1)) - 0.5).astype(np.float32)
    model = JaxSNNVQVAE(JaxVQVAEConfig(**KW), backend="scan")
    variables = jax.jit(lambda k, x: model.init(k, x, train=True))(
        jax.random.PRNGKey(1), jnp.asarray(images))
    variables = {k: jax.tree_util.tree_map(np.asarray, variables[k])
                 for k in ("params", "batch_stats")}

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if "BatchNorm_0" in path and path[-1] in ("scale", "bias"):
            lo, hi = (2.0, 5.0) if path[-1] == "scale" else (0.5, 1.5)
            return rs.uniform(lo, hi, node.shape).astype(np.float32)
        return node

    variables["params"] = walk(variables["params"], ())
    return model, variables, images


def _port(variables, train=False):
    return weights.load_vqvae(variables["params"], variables["batch_stats"],
                              VQVAEConfig(**KW), device="cpu", train=train)


def _jax_layout(x: torch.Tensor, shape) -> np.ndarray:
    """The port's (t*N, C, H, W) as JAX's (t, N, H, W, C)."""
    t, n, h, w, c = shape
    return x.reshape(t, n, c, h, w).permute(0, 1, 3, 4, 2).numpy()


def test_capture_outputs_equals_jax(problem):
    model, variables, images = problem
    want = jax_monitor.capture_outputs(model, variables, jnp.asarray(images), train=False)
    got = monitor.capture_outputs(_port(variables), torch.from_numpy(images), train=False)
    assert set(got) <= set(want)
    assert {"encoder/SeqConv_0", "encoder/LIF_2", "vq_layer/asg_lif", "decoder/LIF_1",
            "encoder", "decoder", ""} <= set(got)
    compared = 0
    for key, value in got.items():
        if isinstance(value, torch.Tensor) and value.ndim == 4:
            ours, theirs = _jax_layout(value, want[key].shape), np.asarray(want[key])
            if "LIF" in key or "lif" in key:
                np.testing.assert_array_equal(ours, theirs, err_msg=key)
            else:
                np.testing.assert_allclose(ours, theirs, err_msg=key, **OUT_TOL)
            compared += 1
    assert compared == 21
    np.testing.assert_allclose(got[""]["recon"].numpy(), np.asarray(want[""]["recon"]),
                               **OUT_TOL)
    only = monitor.capture_outputs(_port(variables), torch.from_numpy(images),
                                   filter_fn=lambda k: k.startswith("decoder/"), train=False)
    assert set(only) == {k for k in got if k.startswith("decoder/")}


def test_capture_outputs_of_a_method(problem):
    _, variables, _ = problem
    codes = torch.from_numpy(np.random.RandomState(1).randint(0, 12, (2, 7, 7)))
    got = monitor.capture_outputs(_port(variables), codes, method="decode_indices")
    assert "encoder/LIF_0" not in got and "decoder/LIF_1" in got and "" not in got


def test_spike_rates_equal_jax(problem):
    model, variables, images = problem
    want = jax_monitor.spike_rates(model, variables, jnp.asarray(images), train=False)
    got = monitor.spike_rates(_port(variables), torch.from_numpy(images), train=False)
    assert list(got) == list(want) and len(got) == 6
    for key in want:
        assert abs(got[key] - want[key]) <= RATE_ATOL, key
    assert all(0.0 < r < 1.0 for r in got.values())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_membrane_traces_equal_jax(dtype):
    x = np.random.RandomState(2).uniform(0, 2, (6, 3, 5)).astype(np.float32)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = jax_monitor.membrane_traces(jnp.asarray(x).astype(jdt))
    got = monitor.membrane_traces(torch.from_numpy(x).to(tdt))
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == (tdt if key == "spikes" else torch.float32), key
        np.testing.assert_array_equal(got[key].float().numpy(),
                                      np.asarray(want[key]).astype(np.float32), err_msg=key)
    v, s = got["v_seq"].numpy(), got["spikes"].float().numpy()
    assert (v[s == 1.0] == 0.0).all() and 0 < s.mean() < 1


def test_grad_norms_equal_jax(problem):
    model, variables, images = problem

    def loss(params):
        out, _ = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                             jnp.asarray(images), train=True, mutable=["batch_stats"])
        return out["vq_loss"] + out["recon_loss"]

    want = jax_monitor.grad_norms(jax.jit(jax.grad(loss))(variables["params"]))
    vq = _port(variables, train=True)
    out = vq(torch.from_numpy(images))
    (out["vq_loss"] + out["recon_loss"]).backward()
    got = monitor.grad_norms((n, p.grad) for n, p in vq.named_parameters())
    assert set(got) == set(want) and len(got) == 28
    # a conv bias that a training-mode BN follows has no gradient (BN takes
    # the batch mean out): both norms are round-off, ~1e-7 beside ~0.3
    zero = {k for k in want if k.endswith(("Conv_0/bias", "ConvTranspose_0/bias"))
            and "SeqConvTranspose_2" not in k}
    assert len(zero) == 6
    for key in want:
        if key in zero:
            assert got[key] < ZERO_GRAD and want[key] < ZERO_GRAD, key
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=GRAD_RTOL, atol=0,
                                       err_msg=key)
    assert any(v > 0 for v in got.values())
    assert monitor.grad_norms([("vq_layer.alpha", None)]) == {}


def test_device_monitor_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dm = monitor.DeviceMonitor(interval=0.05)
    time.sleep(0.2)
    records = dm.stop()
    assert not dm._thread.is_alive()
    assert len(records) >= 2 and all(set(r) == {"t"} for r in records)
    jdm = jax_monitor.DeviceMonitor(interval=0.05, devices=jax.devices("cpu"))
    time.sleep(0.1)
    assert dm.summary() == jdm.stop_and_summary() == {}
    assert dm.stop() is records  # stopping twice is safe
    late = monitor.DeviceMonitor(interval=0.05, start_now=False)
    assert late.stop_and_summary() == {} and late.records == []
