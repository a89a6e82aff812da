"""K1 forward in the PyTorch port against the JAX package's LIF.

``lif_fwd_reference`` (the kernel's plain version) and the port's
``lif_scan`` are held against ``snn.neuron.lif_scan`` and against
``ops.pallas_lif.lif_fused`` in Pallas interpret mode, on the same numpy
inputs. Spikes must be equal; final membranes agree to 1e-6 (fp32, the
same operations in the same order). On the CPU the wrapper takes the
plain version and launches nothing (the kernel itself is held against the
plain version on the card in tests/test_torch_kernels_gpu.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spiking_diffusion_tpu.ops import pallas_lif
from spiking_diffusion_tpu.snn import NeuronParams as JaxParams
from spiking_diffusion_tpu.snn import lif_scan as jax_lif_scan
from spiking_diffusion_tpu_torch.ops import lif as port_lif
from spiking_diffusion_tpu_torch.snn.neuron import (
    NeuronParams,
    lif_multi_step,
    lif_scan,
)

V_ATOL = 1e-6

PARAMS = {
    "default": {},
    "soft_reset": {"hard_reset": False},
    "no_decay_input": {"decay_input": False},
    "soft_no_decay_input": {"hard_reset": False, "decay_input": False},
    "tau4_vth07_vreset01": {"tau": 4.0, "v_threshold": 0.7, "v_reset": 0.1},
}


@pytest.fixture(autouse=True)
def setup():
    torch.set_num_threads(1)
    old = pallas_lif._INTERPRET
    pallas_lif._INTERPRET = True
    yield
    pallas_lif._INTERPRET = old


def _x(shape, seed, lo=-1.0, hi=3.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(np.float32)


@pytest.mark.parametrize("name", sorted(PARAMS))
@pytest.mark.parametrize("shape", [(5, 3, 41), (16, 2, 7, 7, 4)],
                         ids=["ragged123", "T16"])
def test_reference_matches_jax(name, shape):
    kw = PARAMS[name]
    x = _x(shape, seed=1)
    s_ref, v_ref = port_lif.lif_fwd_reference(torch.from_numpy(x),
                                              params=NeuronParams(**kw))
    s_scan, v_scan = lif_scan(torch.from_numpy(x), params=NeuronParams(**kw))
    s_jax, v_jax = jax_lif_scan(jnp.asarray(x), params=JaxParams(**kw))
    s_pallas = pallas_lif.lif_fused(jnp.asarray(x), params=JaxParams(**kw))
    assert 0.05 < float(s_ref.mean()) < 0.95
    np.testing.assert_array_equal(s_ref.numpy(), np.asarray(s_jax))
    np.testing.assert_array_equal(s_ref.numpy(), np.asarray(s_pallas))
    np.testing.assert_array_equal(s_ref.numpy(), s_scan.numpy())
    np.testing.assert_allclose(v_ref.numpy(), np.asarray(v_jax), atol=V_ATOL, rtol=0)
    np.testing.assert_array_equal(v_ref.numpy(), v_scan.numpy())


@pytest.mark.parametrize("name", ["default", "soft_reset"])
def test_reference_with_v_init(name):
    kw = PARAMS[name]
    x = _x((4, 2, 33), seed=3)
    v0 = _x((2, 33), seed=4, lo=0.0, hi=0.9)
    s_ref, v_ref = port_lif.lif_fwd_reference(
        torch.from_numpy(x), torch.from_numpy(v0), NeuronParams(**kw))
    s_jax, v_jax = jax_lif_scan(jnp.asarray(x), jnp.asarray(v0), JaxParams(**kw))
    s_pallas = pallas_lif.lif_fused(jnp.asarray(x), jnp.asarray(v0), JaxParams(**kw))
    np.testing.assert_array_equal(s_ref.numpy(), np.asarray(s_jax))
    np.testing.assert_array_equal(s_ref.numpy(), np.asarray(s_pallas))
    np.testing.assert_allclose(v_ref.numpy(), np.asarray(v_jax), atol=V_ATOL, rtol=0)


def test_bf16_input_gives_bf16_spikes():
    x = torch.from_numpy(_x((6, 50), seed=5)).bfloat16()
    s, v = port_lif.lif_fwd(x)
    s32, v32 = port_lif.lif_fwd(x.float())
    assert s.dtype == torch.bfloat16 and v.dtype == torch.float32
    np.testing.assert_array_equal(s.float().numpy(), s32.numpy())
    np.testing.assert_array_equal(v.numpy(), v32.numpy())


def test_cpu_wrapper_takes_plain_version_and_launches_nothing():
    x = torch.from_numpy(_x((5, 3, 41), seed=6))
    before = port_lif.LAUNCHES
    s, v = port_lif.lif_fwd(x)
    s_ref, v_ref = port_lif.lif_fwd_reference(x)
    assert port_lif.LAUNCHES == before
    assert torch.equal(s, s_ref) and torch.equal(v, v_ref)
    for backend in ("auto", "torch"):
        assert torch.equal(lif_multi_step(x, backend=backend), s_ref)
    assert port_lif.LAUNCHES == before


def test_wrapper_rejects_bad_inputs():
    with pytest.raises(ValueError, match="cuda"):
        lif_multi_step(torch.zeros(2, 3), backend="cuda")
    with pytest.raises(ValueError, match="backend"):
        lif_multi_step(torch.zeros(2, 3), backend="scan")
    with pytest.raises(TypeError):
        port_lif.lif_fwd(torch.zeros(2, 3, dtype=torch.float64))
    with pytest.raises(ValueError, match="v_init"):
        port_lif.lif_fwd(torch.zeros(2, 3), torch.zeros(4))
