"""The port's step-aware layers against the flax modules.

Weights are made by the flax module's own init and carried into the port
through ``models/weights.py``; inputs are numpy from a seed. The flax
side is (T, N, H, W, C), the port's (T*N, C, H, W). fp32 activations
agree to 1e-5 (the two frameworks sum the convolutions in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spiking_diffusion_tpu.models import layers as jl
from spiking_diffusion_tpu.snn import lif_scan as jax_lif_scan
from spiking_diffusion_tpu_torch.models import layers as tl
from spiking_diffusion_tpu_torch.models import weights
from spiking_diffusion_tpu_torch.snn.neuron import NeuronParams

ATOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _to_port(x):  # (T, N, H, W, C) -> (T*N, C, H, W)
    t, n = x.shape[:2]
    return torch.from_numpy(
        np.ascontiguousarray(x.reshape((t * n,) + x.shape[2:]).transpose(0, 3, 1, 2)))


def _from_port(y, t):  # (T*N, C, H, W) -> (T, N, H, W, C)
    y = y.detach().numpy().transpose(0, 2, 3, 1)
    return y.reshape((t, -1) + y.shape[1:])


def _seq(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("k,stride,pad,cin,cout", [
    (3, 1, 1, 5, 7), (3, 2, 1, 4, 6), (1, 1, 0, 6, 3)])
def test_seq_conv(k, stride, pad, cin, cout):
    x = _seq((3, 2, 9, 9, cin), seed=k + stride)
    mod = jl.SeqConv(cout, kernel_size=k, strides=stride, padding=pad)
    variables = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    y_jax = np.asarray(mod.apply(variables, jnp.asarray(x)))
    conv = tl.SeqConv(cin, cout, k, stride, pad)
    node = variables["params"]["Conv_0"]
    conv.load_state_dict({"weight": torch.from_numpy(weights.conv_weight(node["kernel"])),
                          "bias": torch.from_numpy(np.array(node["bias"]))})
    y = _from_port(conv(_to_port(x)), 3)
    assert y.shape == y_jax.shape
    np.testing.assert_allclose(y, y_jax, atol=ATOL, rtol=0)


@pytest.mark.parametrize("stride,pad,out_pad,cin,cout", [
    (2, 1, 1, 4, 6), (1, 1, 0, 5, 1), (2, 1, 1, 16, 8)])
def test_seq_conv_transpose(stride, pad, out_pad, cin, cout):
    x = _seq((2, 3, 7, 7, cin), seed=stride + cin)
    mod = jl.SeqConvTranspose(cout, kernel_size=3, strides=stride,
                              padding=pad, output_padding=out_pad)
    variables = mod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    y_jax = np.asarray(mod.apply(variables, jnp.asarray(x)))
    deconv = tl.SeqConvTranspose(cin, cout, 3, stride, pad, out_pad)
    node = variables["params"]["ConvTranspose_0"]
    deconv.load_state_dict({"weight": torch.from_numpy(weights.deconv_weight(node["kernel"])),
                            "bias": torch.from_numpy(np.array(node["bias"]))})
    y = _from_port(deconv(_to_port(x)), 2)
    assert y.shape == y_jax.shape == (2, 3, (7 - 1) * stride - 2 * pad + 3 + out_pad,
                                      (7 - 1) * stride - 2 * pad + 3 + out_pad, cout)
    np.testing.assert_allclose(y, y_jax, atol=ATOL, rtol=0)


def test_seq_batchnorm_eval():
    c = 6
    rng = np.random.RandomState(2)
    x = _seq((4, 3, 5, 5, c), seed=3) * 3.0 + 1.0
    mod = jl.SeqBatchNorm(use_running_average=True)
    bn_params = {"scale": rng.uniform(0.5, 2, c).astype(np.float32),
                 "bias": rng.randn(c).astype(np.float32)}
    bn_stats = {"mean": rng.randn(c).astype(np.float32),
                "var": rng.uniform(0.1, 4, c).astype(np.float32)}
    variables = {"params": {"BatchNorm_0": bn_params},
                 "batch_stats": {"BatchNorm_0": bn_stats}}
    y_jax = np.asarray(mod.apply(variables, jnp.asarray(x)))
    bn = tl.SeqBatchNorm(c).eval()
    bn.load_state_dict({k: torch.from_numpy(v)
                        for k, v in {**bn_params, **bn_stats}.items()})
    y = _from_port(bn(_to_port(x)), 4)
    np.testing.assert_allclose(y, y_jax, atol=ATOL, rtol=0)


def test_lif_layer_folds_time():
    x = _seq((16, 2, 3, 3, 4), seed=4) + 0.8
    s_jax, _ = jax_lif_scan(jnp.asarray(x))
    s = _from_port(tl.LIF(NeuronParams(), 16)(_to_port(x)), 16)
    np.testing.assert_array_equal(s, np.asarray(s_jax))


@pytest.mark.parametrize("kind,stride", [("conv", 2), ("conv", 1), ("deconv", 2),
                                         ("deconv", 1)])
def test_bf16_bias_added_to_the_rounded_output(kind, stride):
    """bf16 convs and deconvs (the VQ-VAE's stride-2 ones too) add the bias
    to the rounded bf16 output, as flax's ``dtype=`` modules do: spike
    inputs and weights on a 1/64 grid make every sum exact in fp32, so the two
    frameworks round the same values and must agree bitwise. JAX is
    compiled without XLA's excess precision, which on the CPU may skip
    the rounding ahead of the bias add."""
    cin, cout = 6, 5
    rng = np.random.RandomState(stride + len(kind))
    x = (rng.rand(2, 3, 7, 7, cin) < 0.5).astype(np.float32)
    kernel = rng.randint(-64, 65, (3, 3, cin, cout)).astype(np.float32) / 64.0
    bias = np.asarray(jnp.asarray(rng.uniform(-1, 1, cout), jnp.bfloat16), np.float32)
    pad, out_pad = 1, stride - 1
    if kind == "conv":
        mod = jl.SeqConv(cout, kernel_size=3, strides=stride, padding=pad, dtype=jnp.bfloat16)
        port, fp32 = (tl.SeqConv(cin, cout, 3, stride, pad, dtype=d)
                      for d in (torch.bfloat16, None))
        node, to_port = "Conv_0", weights.conv_weight
    else:
        mod = jl.SeqConvTranspose(cout, kernel_size=3, strides=stride, padding=pad,
                                  output_padding=out_pad, dtype=jnp.bfloat16)
        port, fp32 = (tl.SeqConvTranspose(cin, cout, 3, stride, pad, out_pad, dtype=d)
                      for d in (torch.bfloat16, None))
        node, to_port = "ConvTranspose_0", weights.deconv_weight
    variables = {"params": {node: {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}}}
    xj = jnp.asarray(x, jnp.bfloat16)
    compiled = jax.jit(mod.apply).lower(variables, xj).compile(
        {"xla_allow_excess_precision": False})
    y_jax = np.asarray(compiled(variables, xj).astype(jnp.float32))
    state = {"weight": torch.from_numpy(to_port(kernel)), "bias": torch.from_numpy(bias)}
    port.load_state_dict(state)
    fp32.load_state_dict(state)
    y = port(_to_port(x).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16
    y = _from_port(y.float(), 2)
    np.testing.assert_array_equal(y, y_jax)
    # the order shows: adding the bias before the rounding gives other values
    exact = _from_port(fp32(_to_port(x)), 2)
    before = torch.from_numpy(exact).to(torch.bfloat16).float().numpy()
    assert not np.array_equal(before, y_jax)
