"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports neither JAX nor the JAX package, so it also runs where JAX is not
installed. Without a CUDA device every test skips with a reason. On a
machine with the card, from the root of a checkout:

    python -m pytest tests/test_torch_kernels_gpu.py -q --noconftest -p no:cacheprovider

(``--noconftest`` because tests/conftest.py imports JAX.)
"""

import pytest
import torch

from spiking_diffusion_tpu_torch.ops import lif as port_lif
from spiking_diffusion_tpu_torch.snn.neuron import NeuronParams

PARAMS = {
    "default": {},
    "soft_reset": {"hard_reset": False},
    "no_decay_input": {"decay_input": False},
    "soft_no_decay_input": {"hard_reset": False, "decay_input": False},
    "tau4_vth07_vreset01": {"tau": 4.0, "v_threshold": 0.7, "v_reset": 0.1},
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(PARAMS))
@pytest.mark.parametrize("m", [3 * 49 * 64, 3 * 49 * 64 + 5], ids=["M9408", "M9413"])
def test_lif_kernel_matches_reference(cuda_device, name, m):
    params = NeuronParams(**PARAMS[name])
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    x = torch.rand((16, m), generator=gen, device=cuda_device) * 4.0 - 1.0
    v0 = torch.rand((m,), generator=gen, device=cuda_device) * 0.9
    before = port_lif.LAUNCHES
    for v_init in (None, v0):
        s, v = port_lif.lif_fwd(x, v_init, params)
        s_ref, v_ref = port_lif.lif_fwd_reference(x, v_init, params)
        torch.cuda.synchronize()
        assert 0.05 < float(s_ref.mean()) < 0.95
        assert torch.equal(s, s_ref) and torch.equal(v, v_ref)
    assert port_lif.LAUNCHES == before + 2


@pytest.mark.gpu
def test_lif_kernel_bf16_and_shapes(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    x = (torch.rand((16, 4, 7, 7, 32), generator=gen, device=cuda_device) * 4.0 - 1.0)
    s, v = port_lif.lif_fwd(x.bfloat16())
    s_ref, v_ref = port_lif.lif_fwd_reference(x.bfloat16())
    torch.cuda.synchronize()
    assert s.dtype == torch.bfloat16 and s.shape == x.shape and v.shape == x.shape[1:]
    assert torch.equal(s, s_ref) and torch.equal(v, v_ref)


@pytest.mark.gpu
def test_lif_kernel_rejects_what_it_does_not_take(cuda_device):
    x = torch.zeros((16, 8, 8), device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        port_lif.lif_fwd(x.transpose(1, 2))
    with pytest.raises(TypeError):
        port_lif.lif_fwd(x.double())
