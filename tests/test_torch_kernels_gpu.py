"""The port's CUDA kernels against their plain PyTorch versions, on the card.

K1 (LIF forward) must agree bitwise. K2 (the fused denoiser) must agree
bitwise in int8, where every partial sum is an exact integer; in fp32 and
bf16 its sums run in another order than cuBLAS's, so a membrane one
rounding from threshold may flip a spike: at least 99 % of the logits lie
within 1e-4 and the median |difference| is at most 1e-6.

Imports neither JAX nor the JAX package, so it also runs where JAX is not
installed. Without a CUDA device every test skips with a reason. On a
machine with the card, from the root of a checkout:

    python -m pytest tests/test_torch_kernels_gpu.py -q --noconftest -p no:cacheprovider

(``--noconftest`` because tests/conftest.py imports JAX.)
"""

import pytest
import torch

from spiking_diffusion_tpu_torch.config import DiffusionConfig
from spiking_diffusion_tpu_torch.models import weights
from spiking_diffusion_tpu_torch.ops import fused_denoiser as fd
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


# --- K2 ----------------------------------------------------------------------

K2_WIDTHS = {
    # 24 is not a multiple of the kernel's 16-channel tiles, 16 < its
    # 128-channel output tile
    "small": dict(denoiser_channels=(8, 16, 24, 32, 16), num_embeddings=16,
                  mask_id=16, num_steps=4),
    "full": {},
}
K2_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


def _k2_setup(width, n, device, seed=0):
    """A seeded denoiser with BN statistics set from one batch, and the a1
    of a random token map."""
    cfg = DiffusionConfig(**K2_WIDTHS[width])
    den = weights.load_denoiser(*weights.init_denoiser_variables(
        cfg, torch.Generator().manual_seed(seed)), cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    h = cfg.latent_size
    tokens = torch.randint(0, cfg.num_embeddings + 1, (max(n, 16), h, h),
                           generator=gen, device=device)
    t = torch.randint(1, cfg.num_timesteps + 1, (max(n, 16),), generator=gen,
                      device=device)
    weights.calibrate_batchnorm(den, lambda: den(tokens, t))
    return cfg, den, tokens[:n], t[:n]


def _k2_pair(cfg, den, tokens, t, dtype):
    folded = fd.fold_denoiser_weights(den, dtype)
    a1 = fd.first_preactivation(tokens, t, folded.k1, folded.b1)
    before = fd.LAUNCHES
    out = fd.fused_denoise(a1, folded, cfg)
    assert fd.LAUNCHES == before + 1
    ref = fd.fused_denoise_reference(a1, folded, cfg)
    torch.cuda.synchronize()
    return out, ref


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 13, 256])
@pytest.mark.parametrize("width", sorted(K2_WIDTHS))
@pytest.mark.parametrize("dtype", sorted(K2_DTYPES))
def test_fused_denoiser_kernel_matches_reference(cuda_device, dtype, width, n):
    cfg, den, tokens, t = _k2_setup(width, n, cuda_device)
    out, ref = _k2_pair(cfg, den, tokens, t, K2_DTYPES[dtype])
    h = cfg.latent_size
    assert out.shape == ref.shape == (n, h * h, cfg.num_embeddings)
    assert bool(torch.isfinite(out).all()) and float(ref.std()) > 0.01
    diff = (out - ref).abs()
    if dtype == "int8":
        assert float(diff.max()) == 0.0
    else:
        assert float((diff <= 1e-4).float().mean()) >= 0.99
        assert float(diff.median()) <= 1e-6


@pytest.mark.gpu
def test_fused_denoiser_int8_rows_are_independent(cuda_device):
    """An image's logits do not depend on the other images of its batch."""
    cfg, den, tokens, t = _k2_setup("small", 13, cuda_device, seed=3)
    whole, _ = _k2_pair(cfg, den, tokens, t, torch.int8)
    part, _ = _k2_pair(cfg, den, tokens[5:9], t[5:9], torch.int8)
    assert torch.equal(whole[5:9], part)


@pytest.mark.gpu
def test_fused_denoiser_rejects_what_it_does_not_take(cuda_device):
    cfg, den, tokens, t = _k2_setup("small", 4, cuda_device)
    folded = fd.fold_denoiser_weights(den, torch.bfloat16)
    a1 = fd.first_preactivation(tokens, t, folded.k1, folded.b1)
    with pytest.raises(TypeError, match="float32"):
        fd.fused_denoise(a1.double(), folded, cfg)
    with pytest.raises(ValueError, match="a1 must be"):
        fd.fused_denoise(a1[:, :48], folded, cfg)
    with pytest.raises(ValueError, match="weights on"):
        fd.fused_denoise(a1.cpu(), folded, cfg)
    with pytest.raises(ValueError, match="contiguous"):
        fd.fused_denoise(a1.transpose(1, 2).contiguous().transpose(1, 2),
                         folded, cfg)
    with pytest.raises(TypeError):
        fd.make_fused_denoise_fn(den, cfg, torch.float16)
