"""The port's CUDA kernels against their plain PyTorch versions, on the card.

K1 (LIF forward) must agree bitwise, also at the classifier zoo's T = 4
shapes, where ``lif_multi_step`` launches it for the atan and sigmoid
surrogates only (any other family takes the plain scan, and
``backend='cuda'`` refuses it). K1's backward must agree bitwise with
the atan surrogate; with sigmoid the kernel's ``expf`` and PyTorch's exp
may differ by an ulp, so dX and dV0 agree within rtol 1e-5, atol 1e-6.
K3 (fused BN-apply + LIF): spikes, dy, dscale and dshift bitwise in fp32
and bf16 (the sums run in the plain version's order) and equal from
launch to launch, on the denoiser's route (its neuron, T = 16), on the
routes of any other neuron or T, and where a divisor of the surrogate
leaves the range of the path's fast division. A small training step through the kernels gives exactly the
loss, gradients and BN statistics of the same step through the plain
versions on the layerwise and 'bnlif' branches; on 'bnlifconv' (K4, whose
sums run in another order than its plain version's) within the CPU
tests' tolerances; a bf16 step on each branch launches what the fp32 step
does, runs its convs and spikes in bf16, and its loss is within 5 % of the
fp32 loss. A full-width stage-1 (VQ-VAE) step through K1 or K3, in fp32
and bf16, equals the plain versions' step with exactly six forward and
six backward launches, and K1 is bitwise at stage 1's six LIF shapes. K4 (the training conv)
agrees with its plain version at the JAX package's tolerances for its
kernel against XLA's conv: y within 1e-5 (bf16 2e-2), s1 and s2 within
rtol 1e-4, atol 1e-3, dx, dW, db within 1e-4 (bf16 dx 2e-2), and s1, s2,
dW, db equal from launch to launch; its fp32 forward takes the tensor
cores for an x exact in bf16 and the CUDA cores for any other (an inf
included, and from 2^31 rows on), at the same tolerances, and its weight
split is bitwise its plain version; its fp32 backward takes the tensor
cores for dW when x is exact in bf16 and g finite, for dx when g is
finite, and the CUDA cores otherwise, at the same tolerances (with inf and
NaN where the plain version has them), equal from launch to launch, and
its dx weight split is bitwise its plain version. K2 (the fused denoiser) must agree
bitwise in int8, where every partial sum is an exact integer, with per-row
or per-cout scales and with percentile clips; in fp32 and bf16, and for an
int8 sampler's bf16 readout, its sums run in another
order than cuBLAS's, so a membrane one rounding from threshold may flip a
spike: at least 99 % of the logits lie within 1e-4 and the median
|difference| is at most 1e-6; each roofline ablation agrees with the plain
version of its mode at the same bounds; its conv and readout kernels run on the
tensor cores (HMMA in their SASS), and it refuses T > 128. The op/energy
counters (``profiling/syops.py``) of a full-width VQ-VAE and denoiser
forward through K1 or K3 equal those through the plain versions.

Imports neither JAX nor the JAX package, so it also runs where JAX is not
installed. Without a CUDA device every test skips with a reason. On a
machine with the card, from the root of a checkout:

    python -m pytest tests/test_torch_kernels_gpu.py -q --noconftest -p no:cacheprovider

(``--noconftest`` because tests/conftest.py imports JAX.)
"""

import subprocess
from pathlib import Path

import pytest
import torch

from spiking_diffusion_tpu_torch.config import DiffusionConfig, VQVAEConfig
from spiking_diffusion_tpu_torch.models import diffusion, weights
from spiking_diffusion_tpu_torch.models.layers import SeqConv
from spiking_diffusion_tpu_torch.ops import _build
from spiking_diffusion_tpu_torch.ops import bn_lif as port_bn_lif
from spiking_diffusion_tpu_torch.ops import fused_denoiser as fd
from spiking_diffusion_tpu_torch.ops import lif as port_lif
from spiking_diffusion_tpu_torch.ops import spike_conv as port_spike_conv
from spiking_diffusion_tpu_torch.snn import neuron, surrogate
from spiking_diffusion_tpu_torch.snn.neuron import NeuronParams
from spiking_diffusion_tpu_torch.train import stage1, stage2
from spiking_diffusion_tpu_torch.train.state import create_train_state

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


# --- K1 backward ---------------------------------------------------------------

BWD_PARAMS = {
    **PARAMS,
    "detach_reset": {"detach_reset": True},
    "sigmoid": {"surrogate": surrogate.sigmoid},
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(BWD_PARAMS))
@pytest.mark.parametrize("t_steps,m", [(16, 3 * 49 * 64), (16, 3 * 49 * 64 + 5), (20, 1001)],
                         ids=["T16_M9408", "T16_M9413", "T20_M1001"])
def test_lif_bwd_kernel_matches_reference(cuda_device, name, t_steps, m):
    params = NeuronParams(**BWD_PARAMS[name])
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    x = torch.rand((t_steps, m), generator=gen, device=cuda_device) * 4.0 - 1.0
    v0 = torch.rand((m,), generator=gen, device=cuda_device) * 0.9
    gs = torch.randn((t_steps, m), generator=gen, device=cuda_device)
    before = port_lif.LAUNCHES_BWD
    # the training path's call (no v0 read, no dV0 written), then with dV0
    for v_init, need_dv0 in ((None, False), (None, True), (v0, True)):
        dx, dv = port_lif.lif_bwd(x, v_init, gs, params, need_dv0)
        dx_ref, dv_ref = port_lif.lif_bwd_reference(x, v_init, gs, params, need_dv0)
        torch.cuda.synchronize()
        assert float(dx_ref.abs().max()) > 0.1
        assert (dv is None) == (dv_ref is None) == (not need_dv0)
        pairs = [(dx, dx_ref)] + ([(dv, dv_ref)] if need_dv0 else [])
        for got, want in pairs:
            if name == "sigmoid":
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
            else:
                assert torch.equal(got, want)
    assert port_lif.LAUNCHES_BWD == before + 3


@pytest.mark.gpu
def test_lif_autograd_launches_both_kernels(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(10)
    x = (torch.rand((16, 4, 7, 7, 32), generator=gen, device=cuda_device) * 4.0 - 1.0)
    g = torch.randn(x.shape, generator=gen, device=cuda_device)
    grads = []
    for reference in (False, True):
        xr = x.clone().requires_grad_()
        before = (port_lif.LAUNCHES, port_lif.LAUNCHES_BWD)
        port_lif.lif(xr, reference=reference).backward(g)
        launched = (port_lif.LAUNCHES - before[0], port_lif.LAUNCHES_BWD - before[1])
        assert launched == ((0, 0) if reference else (1, 1))
        grads.append(xr.grad)
    assert torch.equal(grads[0], grads[1])
    with pytest.raises(ValueError, match="surrogate"):
        port_lif.lif_bwd(x.reshape(16, -1), None, g.reshape(16, -1),
                         NeuronParams(surrogate=surrogate.SurrogateFn("erf", 2.0)))


# stage 1's six LIF layers at batch 256, T = 16: (name, M = N * C * H * W)
STAGE1_LIF_SHAPES = {
    "encoder0_C32_14x14": 256 * 32 * 196, "encoder1_C64_7x7": 256 * 64 * 49,
    "encoder2_D16_7x7": 256 * 16 * 49, "respike_D16_7x7": 256 * 16 * 49,
    "decoder0_C64_14x14": 256 * 64 * 196, "decoder1_C32_28x28": 256 * 32 * 784,
}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(STAGE1_LIF_SHAPES))
def test_lif_kernels_at_stage1_shapes(cuda_device, shape):
    """K1 forward and backward bitwise their plain versions at the M of each
    stage-1 LIF layer, as the training path calls them (no v_init, no dV0)."""
    m = STAGE1_LIF_SHAPES[shape]
    gen = torch.Generator(device=cuda_device).manual_seed(17)
    x = torch.rand((16, m), generator=gen, device=cuda_device) * 4.0 - 1.0
    gs = torch.randn((16, m), generator=gen, device=cuda_device)
    s, v = port_lif.lif_fwd(x)
    s_ref, v_ref = port_lif.lif_fwd_reference(x)
    dx, _ = port_lif.lif_bwd(x, None, gs, NeuronParams(), False)
    dx_ref, _ = port_lif.lif_bwd_reference(x, None, gs, NeuronParams(), False)
    torch.cuda.synchronize()
    assert 0.05 < float(s_ref.mean()) < 0.95
    assert torch.equal(s, s_ref) and torch.equal(v, v_ref) and torch.equal(dx, dx_ref)


# the classifier zoo's LIF layers at T = 4, batch 64, as (T, M = N * C * H * W)
ZOO_LIF_SHAPES = {
    "vgg11_first_C64_32x32": 64 * 64 * 32 * 32,
    "resnet_stage2_C128_16x16": 64 * 128 * 16 * 16,
    "vgg11_last_C512_2x2": 64 * 512 * 2 * 2,
}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(ZOO_LIF_SHAPES))
def test_lif_kernels_at_zoo_shapes(cuda_device, shape):
    """K1 forward and backward bitwise their plain versions at T = 4 and the
    M of the zoo's LIF layers, as its training step calls them."""
    m = ZOO_LIF_SHAPES[shape]
    gen = torch.Generator(device=cuda_device).manual_seed(23)
    x = torch.rand((4, m), generator=gen, device=cuda_device) * 4.0 - 1.0
    gs = torch.randn((4, m), generator=gen, device=cuda_device)
    s, v = port_lif.lif_fwd(x)
    s_ref, v_ref = port_lif.lif_fwd_reference(x)
    dx, _ = port_lif.lif_bwd(x, None, gs, NeuronParams(), False)
    dx_ref, _ = port_lif.lif_bwd_reference(x, None, gs, NeuronParams(), False)
    torch.cuda.synchronize()
    assert 0.05 < float(s_ref.mean()) < 0.95
    assert torch.equal(s, s_ref) and torch.equal(v, v_ref) and torch.equal(dx, dx_ref)


@pytest.mark.gpu
@pytest.mark.parametrize("family", sorted(surrogate.FAMILIES))
def test_lif_multi_step_routes_by_family(cuda_device, family):
    """On a CUDA tensor 'auto' launches K1 forward and backward for atan
    and sigmoid and takes the plain scan for any other family, which
    'cuda' refuses before anything is launched."""
    params = NeuronParams(surrogate=surrogate.get_surrogate(family, 2.0))
    gen = torch.Generator(device=cuda_device).manual_seed(24)
    x = (torch.rand((4, 64, 40), generator=gen, device=cuda_device) * 3.0).requires_grad_()
    before = (port_lif.LAUNCHES, port_lif.LAUNCHES_BWD, dict(neuron.ROUTES))
    neuron.lif_multi_step(x, params=params, backend="auto").sum().backward()
    torch.cuda.synchronize()
    launched = (port_lif.LAUNCHES - before[0], port_lif.LAUNCHES_BWD - before[1])
    routes = {k: neuron.ROUTES[k] - before[2][k] for k in before[2]}
    kernel = family in surrogate.KERNEL_FAMILIES
    assert launched == ((1, 1) if kernel else (0, 0))
    assert routes == ({"kernel": 1, "scan": 0} if kernel else {"kernel": 0, "scan": 1})
    if not kernel:
        with pytest.raises(ValueError, match="surrogates"):
            neuron.lif_multi_step(x, params=params, backend="cuda")
        assert (port_lif.LAUNCHES, port_lif.LAUNCHES_BWD) == (before[0], before[1])


# --- K3 ----------------------------------------------------------------------

K3_CASES = {  # (T_in, t_out, N, C, HW)
    "T16": (16, 16, 8, 64, 49),
    "broadcast_T1_to_16": (1, 16, 8, 64, 49),
    "ragged_N13_C24": (16, 16, 13, 24, 49),
    "T20_scratch": (20, 20, 3, 8, 25),
    # stage 1's 14x14 and 28x28 layers: rows of more than 256 elements take
    # a block each, shorter ones floor(256 / HW) a block
    "stage1_14x14_C16": (16, 16, 4, 16, 196),
    "stage1_14x14_C32": (16, 16, 4, 32, 196),
    "stage1_28x28_C16": (16, 16, 2, 16, 784),
    "stage1_28x28_C32_T1": (1, 16, 2, 32, 784),
    "T20_scratch_28x28": (20, 20, 1, 3, 784),
    # 21 rows of 25: the last block of 10 rows holds one
    "rows_not_multiple_of_R": (16, 16, 3, 7, 25),
}
K3_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(K3_DTYPES))
@pytest.mark.parametrize("case", sorted(K3_CASES))
def test_bn_lif_kernels_match_reference(cuda_device, case, dtype):
    t_in, t_out, n, c, hw = K3_CASES[case]
    dt = K3_DTYPES[dtype]
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    y = (torch.randn((t_in, n, c, 7, hw // 7) if hw % 7 == 0 else (t_in, n, c, hw),
                     generator=gen, device=cuda_device) * 2.0).to(dt)
    scale = torch.rand((c,), generator=gen, device=cuda_device) + 0.5
    shift = torch.rand((c,), generator=gen, device=cuda_device) * 0.6 - 0.3
    gs = torch.randn((t_out,) + tuple(y.shape[1:]), generator=gen, device=cuda_device).to(dt)
    params = NeuronParams()
    before = (port_bn_lif.LAUNCHES_FWD, port_bn_lif.LAUNCHES_BWD)
    s = port_bn_lif.bn_lif_fwd(y, scale, shift, params, t_out)
    s_ref = port_bn_lif.bn_lif_fwd_reference(y, scale, shift, params, t_out)
    out = port_bn_lif.bn_lif_bwd(y, scale, shift, gs, params, t_out)
    again = port_bn_lif.bn_lif_bwd(y, scale, shift, gs, params, t_out)
    ref = port_bn_lif.bn_lif_bwd_reference(y, scale, shift, gs, params, t_out)
    torch.cuda.synchronize()
    assert (port_bn_lif.LAUNCHES_FWD - before[0], port_bn_lif.LAUNCHES_BWD - before[1]) == (1, 2)
    assert s.dtype == dt and 0.05 < float(s_ref.float().mean()) < 0.95
    assert torch.equal(s, s_ref)
    assert out[0].dtype == dt and torch.equal(out[0], ref[0])
    for got, second, want in zip(out[1:], again[1:], ref[1:]):
        assert torch.equal(got, second)
        assert torch.equal(got, want)


def _k3_inputs(t_in, t_out, n, c, hw, dt, gen, device):
    y = (torch.randn((t_in, n, c, hw), generator=gen, device=device) * 2.0).to(dt)
    scale = torch.rand((c,), generator=gen, device=device) + 0.5
    shift = torch.rand((c,), generator=gen, device=device) * 0.6 - 0.3
    gs = torch.randn((t_out, n, c, hw), generator=gen, device=device).to(dt)
    return y, scale, shift, gs


def _k3_check(y, scale, shift, gs, params, t_out):
    """Spikes, dy, dscale and dshift bitwise the plain version's."""
    s = port_bn_lif.bn_lif_fwd(y, scale, shift, params, t_out)
    out = port_bn_lif.bn_lif_bwd(y, scale, shift, gs, params, t_out)
    ref_s = port_bn_lif.bn_lif_fwd_reference(y, scale, shift, params, t_out)
    ref = port_bn_lif.bn_lif_bwd_reference(y, scale, shift, gs, params, t_out)
    torch.cuda.synchronize()
    assert torch.equal(s, ref_s)
    for got, want in zip(out, ref):
        assert torch.equal(got, want)


# neurons and step counts off the denoiser's route (its neuron at T = 16)
K3_ROUTES = {
    "T6": (NeuronParams(), 6),
    "soft_reset_no_decay_input_detached": (
        NeuronParams(hard_reset=False, decay_input=False, detach_reset=True), 16),
    "vreset_neg": (NeuronParams(tau=4.0, v_threshold=0.7, v_reset=-0.2), 16),
    "sigmoid": (NeuronParams(surrogate=surrogate.sigmoid), 16),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(K3_DTYPES))
@pytest.mark.parametrize("hw", [49, 784])
@pytest.mark.parametrize("t_in", ["T", "1"])
@pytest.mark.parametrize("route", sorted(K3_ROUTES))
def test_bn_lif_kernels_other_routes(cuda_device, route, t_in, hw, dtype):
    params, t_out = K3_ROUTES[route]
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    inputs = _k3_inputs(t_out if t_in == "T" else 1, t_out, 3, 6, hw, K3_DTYPES[dtype], gen,
                        cuda_device)
    if params.surrogate.name == "sigmoid":
        # the kernel's expf against PyTorch's exp may differ by an fp32 ulp,
        # and then dy's bf16 rounding by one bf16 ulp (2^-8)
        y, scale, shift, gs = inputs
        assert torch.equal(port_bn_lif.bn_lif_fwd(y, scale, shift, params, t_out),
                           port_bn_lif.bn_lif_fwd_reference(y, scale, shift, params, t_out))
        out = port_bn_lif.bn_lif_bwd(y, scale, shift, gs, params, t_out)
        ref = port_bn_lif.bn_lif_bwd_reference(y, scale, shift, gs, params, t_out)
        dy_tol = dict(rtol=2**-8, atol=1e-6) if dtype == "bf16" else dict(rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(out[0].float(), ref[0].float(), **dy_tol)
        for got, want in zip(out[1:], ref[1:]):
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        return
    _k3_check(*inputs, params, t_out)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(K3_DTYPES))
@pytest.mark.parametrize("hw", [49, 784])
@pytest.mark.parametrize("t_in", [16, 1])
def test_bn_lif_backward_outside_fast_division(cuda_device, t_in, hw, dtype):
    """Inputs of 1e12 put the surrogate's divisor past the range of the
    path's fast division: those elements are redone with the full one."""
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    y, scale, shift, gs = _k3_inputs(t_in, 16, 2, 5, hw, K3_DTYPES[dtype], gen, cuda_device)
    y.view(-1)[::7] = 1e12
    y.view(-1)[3::11] = -1e12
    _k3_check(y, scale, shift, gs, NeuronParams(), 16)


# --- a training step through the kernels ------------------------------------

TRAIN_WIDTH = dict(denoiser_channels=(8, 16, 24, 32, 16), num_embeddings=16, mask_id=16,
                   num_steps=4, num_timesteps=8)


@pytest.fixture
def deterministic_cudnn():
    """cuDNN's deterministic algorithms for one test, restored after."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = before


def _counts():
    return (port_lif.LAUNCHES, port_lif.LAUNCHES_BWD, port_bn_lif.LAUNCHES_FWD,
            port_bn_lif.LAUNCHES_BWD, port_spike_conv.LAUNCHES_FWD,
            port_spike_conv.LAUNCHES_BWD)


# launches per step: K1 fwd, K1 bwd, K3 fwd, K3 bwd, K4 fwd, K4 bwd
STEP_LAUNCHES = {"auto": (5, 5, 0, 0, 0, 0), "bnlif": (0, 0, 5, 5, 0, 0),
                 "bnlifconv": (0, 0, 5, 5, 6, 6)}


def _train_step(cfg, variables, backend, x0, corruption, device, dtype=None):
    """(loss, gradients, BN statistics, launches, the dtypes that the convs
    took in and gave out) of one step."""
    state = create_train_state(weights.load_denoiser(
        *variables, cfg, device=device, lif_backend=backend, train=True, dtype=dtype))
    seen = set()

    def hook(module, args, out):
        seen.update((args[0].dtype, (out[0] if isinstance(out, tuple) else out).dtype))

    handles = [m.register_forward_hook(hook) for m in state.model.modules()
               if isinstance(m, SeqConv)]
    before = _counts()
    loss = stage2.make_train_step_diffusion(cfg)(state, x0, corruption=corruption)["loss"]
    launched = tuple(now - then for now, then in zip(_counts(), before))
    for h in handles:
        h.remove()
    return (float(loss), {n: p.grad for n, p in state.model.named_parameters()},
            {k: v for k, v in state.model.state_dict().items()
             if k.endswith((".mean", ".var"))}, launched, seen)


@pytest.mark.gpu
@pytest.mark.parametrize("backend,plain", [("auto", "torch"), ("bnlif", "bnlif_torch"),
                                           ("bnlifconv", "bnlifconv_torch")])
def test_train_step_kernels_match_plain(cuda_device, deterministic_cudnn, backend, plain):
    """The kernels' step against the plain versions' step: equal where the
    kernels are bitwise their plain versions (K1, K3); with K4, whose sums
    run in another order, at the CPU tests' tolerances (loss 1e-5,
    gradients rtol 2e-3, atol 2e-4, BN statistics rtol 1e-5, atol 1e-6)."""
    cfg = DiffusionConfig(**TRAIN_WIDTH)
    variables = weights.init_denoiser_variables(cfg, torch.Generator().manual_seed(0))
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    x0 = torch.randint(0, 16, (8, 7, 7), generator=gen, device=cuda_device, dtype=torch.int32)
    corruption = diffusion.corrupt(x0, cfg, gen)
    (loss_k, grads_k, stats_k, launched_k, _), (loss_p, grads_p, stats_p, launched_p, _) = (
        _train_step(cfg, variables, b, x0, corruption, cuda_device) for b in (backend, plain))
    assert launched_k == STEP_LAUNCHES[backend] and launched_p == (0,) * 6
    if backend != "bnlifconv":
        # the same operations on the same card, the kernels bitwise their
        # plain versions: the steps are equal, not merely close
        assert loss_k == loss_p
        for name in grads_k:
            assert torch.equal(grads_k[name], grads_p[name]), name
        for name in stats_k:
            assert torch.equal(stats_k[name], stats_p[name]), name
        return
    assert abs(loss_k - loss_p) <= 1e-5
    for name in grads_k:
        torch.testing.assert_close(grads_k[name], grads_p[name], rtol=2e-3, atol=2e-4)
    for name in stats_k:
        torch.testing.assert_close(stats_k[name], stats_p[name], rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("backend", sorted(STEP_LAUNCHES))
def test_train_step_bf16(cuda_device, backend):
    """A bf16 step on each branch launches what the fp32 step does, its
    convs take in spikes and give out values in bf16, and its loss is
    finite and within 5 % of the fp32 loss (tests/test_bf16.py)."""
    cfg = DiffusionConfig(**TRAIN_WIDTH)
    variables = weights.init_denoiser_variables(cfg, torch.Generator().manual_seed(1))
    gen = torch.Generator(device=cuda_device).manual_seed(15)
    x0 = torch.randint(0, 16, (8, 7, 7), generator=gen, device=cuda_device, dtype=torch.int32)
    corruption = diffusion.corrupt(x0, cfg, gen)
    loss32 = _train_step(cfg, variables, backend, x0, corruption, cuda_device)[0]
    loss16, grads, _, launched, dtypes = _train_step(cfg, variables, backend, x0, corruption,
                                                     cuda_device, torch.bfloat16)
    assert launched == STEP_LAUNCHES[backend]
    assert dtypes == {torch.bfloat16}, dtypes
    assert all(g.dtype == torch.float32 and bool(torch.isfinite(g).all())
               for g in grads.values())
    assert abs(loss16 - loss32) <= 0.05 * abs(loss32), (loss16, loss32)


# --- a stage-1 training step through the kernels ----------------------------

# launches per stage-1 step: K1 fwd, K1 bwd, K3 fwd, K3 bwd, K4 fwd, K4 bwd
# (3 encoder blocks, the re-spike, 2 decoder blocks)
STAGE1_LAUNCHES = {"auto": (6, 6, 0, 0, 0, 0), "bnlif": (0, 0, 6, 6, 0, 0)}
STAGE1_ENCODE_LAUNCHES = {"auto": (3, 0, 0, 0, 0, 0), "bnlif": (0, 0, 3, 0, 0, 0)}


def _stage1_step(variables, backend, images, device, dtype):
    """(metrics, gradients, BN statistics, launches) of one stage-1 step of
    the flagship VQ-VAE."""
    state = create_train_state(weights.load_vqvae(
        *variables, VQVAEConfig(), device=device, lif_backend=backend, train=True,
        dtype=dtype))
    before = _counts()
    metrics = stage1.make_train_step_vqvae(0.05)(state, images)
    launched = tuple(now - then for now, then in zip(_counts(), before))
    return ({k: float(v) for k, v in metrics.items()},
            {n: p.grad for n, p in state.model.named_parameters()},
            {k: v for k, v in state.model.state_dict().items()
             if k.endswith((".mean", ".var"))}, launched, state.model)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("backend,plain", [("auto", "torch"), ("bnlif", "bnlif_torch")])
def test_stage1_train_step_kernels_match_plain(cuda_device, deterministic_cudnn, backend,
                                               plain, dtype):
    """A full-width stage-1 step (batch 8) through K1 or K3 equals the same
    step through their plain versions, the kernels being bitwise theirs;
    exactly six forward and six backward launches a step, and three
    forward launches for ``encode_indices``, whose codes are the plain
    versions'."""
    dt = {"fp32": None, "bf16": torch.bfloat16}[dtype]
    variables = weights.init_vqvae_variables(VQVAEConfig(), torch.Generator().manual_seed(0))
    gen = torch.Generator(device=cuda_device).manual_seed(18)
    images = torch.rand((8, 28, 28, 1), generator=gen, device=cuda_device) - 0.5
    (m_k, grads_k, stats_k, launched_k, model_k), (m_p, grads_p, stats_p, launched_p, model_p) = (
        _stage1_step(variables, b, images, cuda_device, dt) for b in (backend, plain))
    assert launched_k == STAGE1_LAUNCHES[backend] and launched_p == (0,) * 6
    assert m_k == m_p and all(v == v for v in m_k.values())  # equal and not NaN
    for name in grads_k:
        assert torch.equal(grads_k[name], grads_p[name]), name
    for name in stats_k:
        assert torch.equal(stats_k[name], stats_p[name]), name
    before = _counts()
    codes = model_k.encode_indices(images)
    assert tuple(a - b for a, b in zip(_counts(), before)) == STAGE1_ENCODE_LAUNCHES[backend]
    assert torch.equal(codes, model_p.encode_indices(images))
    assert codes.shape == (8, 7, 7) and codes.dtype == torch.int32


# --- the op/energy counters through K1 and K3 -------------------------------

# launches of one eval forward: K1 fwd, K1 bwd, K3 fwd, K3 bwd, K4 fwd, K4 bwd
PROFILE_LAUNCHES = {("vqvae", "auto"): (6, 0, 0, 0, 0, 0),
                    ("vqvae", "bnlif"): (0, 0, 6, 0, 0, 0),
                    ("denoiser", "auto"): (5, 0, 0, 0, 0, 0),
                    ("denoiser", "bnlif"): (0, 0, 5, 0, 0, 0)}


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["vqvae", "denoiser"])
@pytest.mark.parametrize("backend,plain", [("auto", "torch"), ("bnlif", "bnlif_torch")])
def test_profile_counters_match_plain(cuda_device, deterministic_cudnn, model, backend,
                                      plain):
    """The counters of a full-width eval forward through K1 ('auto') or K3
    ('bnlif') equal those through their plain versions, the kernels being
    bitwise theirs, with the forward's launches and none while not
    profiling beyond the forward's own."""
    from spiking_diffusion_tpu_torch.profiling import syops

    gen = torch.Generator(device=cuda_device).manual_seed(21)
    if model == "vqvae":
        cfg = VQVAEConfig()
        variables = weights.init_vqvae_variables(cfg, torch.Generator().manual_seed(2))
        load = weights.load_vqvae
        args = (torch.rand((8, 28, 28, 1), generator=gen, device=cuda_device) - 0.5,)
    else:
        cfg = DiffusionConfig()
        variables = weights.init_denoiser_variables(cfg, torch.Generator().manual_seed(2))
        load = weights.load_denoiser
        args = (torch.randint(0, 129, (8, 7, 7), generator=gen, device=cuda_device),
                torch.randint(1, 50, (8,), generator=gen, device=cuda_device))
    kernel, ref = (load(*variables, cfg, device=cuda_device, lif_backend=b)
                   for b in (backend, plain))
    weights.calibrate_batchnorm(kernel, lambda: kernel(*args))  # the LIF layers fire
    ref.load_state_dict(kernel.state_dict())
    before = _counts()
    kernel(*args)
    assert tuple(a - b for a, b in zip(_counts(), before)) == PROFILE_LAUNCHES[model, backend]
    before = _counts()
    _, per_layer, total = syops.profile_apply(kernel, *args)
    assert tuple(a - b for a, b in zip(_counts(), before)) == PROFILE_LAUNCHES[model, backend]
    _, per_layer_p, total_p = syops.profile_apply(ref, *args)
    assert per_layer == per_layer_p and total == total_p
    assert 0.0 < total["acs"] and 0.0 < total["mean_spike_rate"] < 1.0


# --- K2 ----------------------------------------------------------------------

K2_WIDTHS = {
    # 3 * 24 channels is no whole number of 64-deep stages, 16 < the
    # 128-column output tile; T = 3 leaves 2 of a tile's 128 rows unused
    # (42 sequences of 3)
    "small": dict(denoiser_channels=(8, 16, 24, 32, 16), num_embeddings=16,
                  mask_id=16, num_steps=4),
    "small_t3": dict(denoiser_channels=(8, 16, 24, 32, 16), num_embeddings=16,
                     mask_id=16, num_steps=3),
    # batch 13: 637 positions, 80 row tiles of 8 sequences, the last ragged
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


def _k2_pair(cfg, den, tokens, t, dtype, ablate="", **options):
    folded = fd.fold_denoiser_weights(den, dtype, **options)
    a1 = fd.first_preactivation(tokens, t, folded.k1, folded.b1)
    before = fd.LAUNCHES
    out = fd.fused_denoise(a1, folded, cfg, ablate)
    assert fd.LAUNCHES == before + 1
    ref = fd.fused_denoise_reference(a1, folded, cfg, ablate)
    torch.cuda.synchronize()
    return out, ref


def _hold_k2(out, ref, exact: bool) -> None:
    """int8 bitwise; fp32 and bf16 (sums in the tensor cores' order) with
    99 % of the logits within 1e-4 and the median |difference| at most 1e-6."""
    assert out.shape == ref.shape
    assert bool(torch.isfinite(out).all()) and float(ref.std()) > 0.01
    diff = (out - ref).abs()
    if exact:
        assert float(diff.max()) == 0.0
    else:
        assert float((diff <= 1e-4).float().mean()) >= 0.99
        assert float(diff.median()) <= 1e-6


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
@pytest.mark.parametrize("width", ["small", "full"])
def test_fused_denoiser_int8_rows_are_independent(cuda_device, width):
    """An image's logits do not depend on the other images of its batch."""
    cfg, den, tokens, t = _k2_setup(width, 13, cuda_device, seed=3)
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
    long_cfg = DiffusionConfig(**dict(K2_WIDTHS["small"], num_steps=129))
    with pytest.raises(ValueError, match="T <= 128"):
        fd.fused_denoise(a1, folded, long_cfg)


@pytest.mark.gpu
def test_fused_denoiser_kernels_reach_the_tensor_cores(cuda_device):
    """K2's conv and readout kernels, for each weight type, hold HMMA
    (tensor-core) instructions in the built library's SASS."""
    (built,) = _build.build([fd.SOURCE])
    cuobjdump = str(Path(_build.nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([cuobjdump, "-sass", str(built.path)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            counts[name] = 0
        elif name is not None and "HMMA" in line:
            counts[name] += 1
    for kernel in ("conv_lif_kernel", "readout_kernel"):
        # each weight type, with and without the noshift ablation
        found = {k: v for k, v in counts.items() if kernel in k}
        assert len(found) == 6 and all(v > 0 for v in found.values()), found


K2_OPTIONS = {"cout": dict(scales="cout"), "clip99.9": dict(clip_pct=99.9),
              "clip99.9_cout": dict(scales="cout", clip_pct=99.9),
              "bf16_logits": dict(logits="bf16")}


@pytest.mark.gpu
@pytest.mark.parametrize("n", [13, 256])
@pytest.mark.parametrize("width", ["small", "full"])
@pytest.mark.parametrize("option", sorted(K2_OPTIONS))
def test_fused_denoiser_int8_options_match_reference(cuda_device, option, width, n):
    """The int8 sampler's options: per-cout scales and percentile clips
    bitwise (exact integer sums, one dequant); a bf16 readout at the bf16
    sampler's bound."""
    cfg, den, tokens, t = _k2_setup(width, n, cuda_device, seed=5)
    out, ref = _k2_pair(cfg, den, tokens, t, torch.int8, **K2_OPTIONS[option])
    _hold_k2(out, ref, exact=option != "bf16_logits")


@pytest.mark.gpu
@pytest.mark.parametrize("ablate", ["nolif", "noshift", "matmul"])
@pytest.mark.parametrize("dtype", sorted(K2_DTYPES))
def test_fused_denoiser_ablations_match_reference(cuda_device, dtype, ablate):
    """Each roofline ablation against the plain version of the same mode, at
    the unablated mode's bound (int8 bitwise), and unlike the unablated
    output."""
    cfg, den, tokens, t = _k2_setup("small", 13, cuda_device, seed=6)
    out, ref = _k2_pair(cfg, den, tokens, t, K2_DTYPES[dtype], ablate)
    _hold_k2(out, ref, exact=dtype == "int8")
    plain, _ = _k2_pair(cfg, den, tokens, t, K2_DTYPES[dtype])
    assert not torch.equal(out, plain)


# --- K4 ----------------------------------------------------------------------

K4_CASES = {  # (N images, Cin, Cout, H = W)
    "block0_2to64": (24, 2, 64, 7),
    "ragged_13_6to10": (13, 6, 10, 7),
    "tiles_130to140": (40, 130, 140, 7),
    "hw4_3to5": (6, 3, 5, 4),
}
K4_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
# also across several 128 x 128 tiles in M (37), N and the contraction
# (2304, 2880; fp32's three planes 6912, 8640) at the path's channel
# counts, dW over several row splits
K4_TILE_CASES = {
    "tiles_96_256to512": (96, 256, 512, 7),
    "tiles_96_320to128": (96, 320, 128, 7),
}
K4_RUNS = [pytest.param(case, dtype, id=f"{case}-{dtype}")
           for case in sorted({**K4_CASES, **K4_TILE_CASES}) for dtype in sorted(K4_DTYPES)]
K4_Y_TOL = {"fp32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}
K4_MOMENT_TOL = dict(rtol=1e-4, atol=1e-3)
K4_GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("moments", [True, False], ids=["moments", "no_moments"])
@pytest.mark.parametrize("case,dtype", K4_RUNS)
def test_spike_conv_kernels_match_reference(cuda_device, case, dtype, moments):
    """K4 forward and backward against their plain versions: y within 1e-5
    (bf16 2e-2), s1 and s2 within rtol 1e-4, atol 1e-3, dx, dW and db
    within 1e-4 (dx in bf16 2e-2), the JAX package's tolerances for its
    kernel against XLA's conv; s1, s2, dW and db equal from launch to
    launch (fixed sum orders). fp32 spikes take the tensor-core route."""
    n, cin, cout, hw = {**K4_CASES, **K4_TILE_CASES}[case]
    dt = K4_DTYPES[dtype]
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    x = (torch.rand((n, cin, hw, hw), generator=gen, device=cuda_device) < 0.3).to(dt)
    w = torch.randn((cout, cin, 3, 3), generator=gen, device=cuda_device) * 0.2
    b = torch.randn((cout,), generator=gen, device=cuda_device) * 0.1
    gy = torch.randn((n, cout, hw, hw), generator=gen, device=cuda_device).to(dt)
    gs1 = torch.randn((cout,), generator=gen, device=cuda_device)
    gs2 = torch.randn((cout,), generator=gen, device=cuda_device) * 0.1
    before = (port_spike_conv.LAUNCHES_FWD, port_spike_conv.LAUNCHES_BWD)
    port_spike_conv.reset_fp32_route_counts()
    y, s1, s2 = port_spike_conv.spike_conv3x3_fwd(x, w, b, moments)
    _, s1b, s2b = port_spike_conv.spike_conv3x3_fwd(x, w, b, moments)
    y_ref, s1_ref, s2_ref = port_spike_conv.spike_conv3x3_fwd_reference(x, w, b, moments)
    grads = port_spike_conv.spike_conv3x3_bwd(x, w, y_ref, gy, gs1, gs2, moments)
    again = port_spike_conv.spike_conv3x3_bwd(x, w, y_ref, gy, gs1, gs2, moments)
    no_dx = port_spike_conv.spike_conv3x3_bwd(x, w, y_ref, gy, gs1, gs2, moments,
                                              need_dx=False)
    ref = port_spike_conv.spike_conv3x3_bwd_reference(x, w, y_ref, gy, gs1, gs2, moments)
    torch.cuda.synchronize()
    assert (port_spike_conv.LAUNCHES_FWD - before[0],
            port_spike_conv.LAUNCHES_BWD - before[1]) == (2, 3)
    assert port_spike_conv.fp32_route_counts() == ((2, 0) if dtype == "fp32" else (0, 0))
    # three backward calls, two with dx: all on the tensor cores
    assert port_spike_conv.fp32_bwd_route_counts() == (
        (3, 0, 2, 0) if dtype == "fp32" else (0, 0, 0, 0))
    assert y.dtype == dt and float(y_ref.float().std()) > 0.1
    torch.testing.assert_close(y.float(), y_ref.float(), **K4_Y_TOL[dtype])
    if moments:
        for got, second, want in ((s1, s1b, s1_ref), (s2, s2b, s2_ref)):
            assert torch.equal(got, second)
            torch.testing.assert_close(got, want, **K4_MOMENT_TOL)
    else:
        assert float(s1.abs().sum()) == float(s2.abs().sum()) == 0.0
    (dx, dw, db), (dx2, dw2, db2), (dx_ref, dw_ref, db_ref) = grads, again, ref
    assert dx.dtype == dt and dw.dtype == db.dtype == torch.float32
    assert no_dx[0] is None and torch.equal(no_dx[1], dw) and torch.equal(no_dx[2], db)
    assert torch.equal(dw, dw2) and torch.equal(db, db2) and torch.equal(dx, dx2)
    torch.testing.assert_close(dx.float(), dx_ref.float(),
                               **(K4_GRAD_TOL if dtype == "fp32" else K4_Y_TOL[dtype]))
    torch.testing.assert_close(dw, dw_ref, **K4_GRAD_TOL)
    torch.testing.assert_close(db, db_ref, **K4_GRAD_TOL)


def _k4_x(kind, n, cin, hw, gen, device):
    """fp32 x of one kind: spikes, spikes with one +inf and one -inf, block
    0's token ids (<= 128) and timesteps (<= 49), or normal values."""
    if kind in ("spikes", "inf"):
        x = (torch.rand((n, cin, hw, hw), generator=gen, device=device) < 0.3).float()
        if kind == "inf":
            x[0, 0, 3, 3], x[1, 5, 0, 0] = float("inf"), -float("inf")
        return x
    if kind == "tokens":
        tok = torch.randint(0, 129, (n, 1, hw, hw), generator=gen, device=device)
        t = torch.randint(1, 50, (n, 1, 1, 1), generator=gen, device=device)
        return torch.cat([tok, t.expand(n, 1, hw, hw)], 1).float()
    return torch.randn((n, cin, hw, hw), generator=gen, device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,cin,route", [("spikes", 64, 0), ("tokens", 2, 0),
                                            ("normal", 64, 1), ("inf", 64, 1)])
def test_spike_conv_fp32_forward_routes(cuda_device, kind, cin, route):
    """The fp32 forward takes the tensor cores for an x exact in bf16
    (spikes, token ids and timesteps) and the CUDA cores for any other,
    an x with an inf included (its y is then the plain version's +-inf, not
    the NaN of inf times a zero plane): the route counts say which, y is
    within 1e-5 and s1, s2 within rtol 1e-4, atol 1e-3 of the plain
    version on both, and s1, s2 are equal from launch to launch."""
    gen = torch.Generator(device=cuda_device).manual_seed(16)
    n, cout = 40, 128
    x = _k4_x(kind, n, cin, 7, gen, cuda_device)
    w = torch.randn((cout, cin, 3, 3), generator=gen, device=cuda_device) * 0.2 / cin ** 0.5
    b = torch.randn((cout,), generator=gen, device=cuda_device) * 0.1
    assert port_spike_conv.bf16_exact(x) == (route == 0)
    port_spike_conv.reset_fp32_route_counts()
    y, s1, s2 = port_spike_conv.spike_conv3x3_fwd(x, w, b)
    _, s1b, s2b = port_spike_conv.spike_conv3x3_fwd(x, w, b)
    assert port_spike_conv.fp32_route_counts() == ((2, 0) if route == 0 else (0, 2))
    y_ref, s1_ref, s2_ref = port_spike_conv.spike_conv3x3_fwd_reference(x, w, b)
    finite = y_ref.isfinite()
    assert float(y_ref[finite].std()) > 0.1
    assert int((~finite).sum()) == (13 * cout if kind == "inf" else 0)  # 9 + 4 pixels
    assert not y_ref.isnan().any()
    torch.testing.assert_close(y, y_ref, **K4_Y_TOL["fp32"])
    for got, second, want in ((s1, s1b, s1_ref), (s2, s2b, s2_ref)):
        torch.testing.assert_close(got, second, rtol=0, atol=0, equal_nan=True)
        torch.testing.assert_close(got, want, **K4_MOMENT_TOL, equal_nan=True)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,routes", [("spikes", (1, 0, 1, 0)), ("normal", (0, 1, 1, 0)),
                                         ("g_inf", (0, 1, 0, 1))])
def test_spike_conv_fp32_backward_routes(cuda_device, kind, routes):
    """The fp32 backward's routes, by the tally (dW tensor cores, dW CUDA
    cores, dx tensor cores, dx CUDA cores) of each of two launches: spikes
    and a finite g take the tensor cores for both; an x off bf16's grid
    sends dW to the CUDA cores; a g with one inf sends both (the planes of
    inf hold NaN). dx, dW and db are within 1e-4 of the plain version, with
    inf and NaN where it has them, and equal from launch to launch."""
    gen = torch.Generator(device=cuda_device).manual_seed(19)
    n, cin, cout = 40, 64, 128
    x = _k4_x("normal" if kind == "normal" else "spikes", n, cin, 7, gen, cuda_device)
    w = torch.randn((cout, cin, 3, 3), generator=gen, device=cuda_device) * 0.2 / cin ** 0.5
    b = torch.randn((cout,), generator=gen, device=cuda_device) * 0.1
    gy = torch.randn((n, cout, 7, 7), generator=gen, device=cuda_device)
    if kind == "g_inf":
        gy[3, 7, 2, 5] = float("inf")
    gs1 = torch.randn((cout,), generator=gen, device=cuda_device) * 1e-2
    gs2 = torch.randn((cout,), generator=gen, device=cuda_device) * 1e-3
    y = port_spike_conv.spike_conv3x3_fwd_reference(x, w, b)[0]
    args = (x, w, y, gy, gs1, gs2)
    g = port_spike_conv.grad_out(y, gy, gs1, gs2, True)
    assert port_spike_conv.bf16_exact(x) == (kind != "normal")
    assert port_spike_conv.bf16_planes_finite(g) == (kind != "g_inf")
    port_spike_conv.reset_fp32_route_counts()
    got = port_spike_conv.spike_conv3x3_bwd(*args)
    again = port_spike_conv.spike_conv3x3_bwd(*args)
    assert port_spike_conv.fp32_bwd_route_counts() == tuple(2 * r for r in routes)
    assert port_spike_conv.fp32_route_counts() == (0, 0)
    want = port_spike_conv.spike_conv3x3_bwd_reference(*args)
    for name, a, a2, a_ref in zip(("dx", "dW", "db"), got, again, want):
        torch.testing.assert_close(a, a2, rtol=0, atol=0, equal_nan=True, msg=name)
        torch.testing.assert_close(a, a_ref, **K4_GRAD_TOL, equal_nan=True, msg=name)
        # the inf reaches every output; finite g, finite outputs
        assert bool(a_ref.isfinite().all()) == (kind != "g_inf"), name


@pytest.mark.gpu
@pytest.mark.parametrize("cin,cout", [(2, 64), (6, 10), (256, 512), (64, 128)])
@pytest.mark.parametrize("force", [False, True], ids=["cleared", "forced"])
def test_spike_conv_fp32_dx_weights_match_plain(cuda_device, cin, cout, force):
    """The fp32 backward's weight kernel gives the six terms' matrix and
    the CUDA cores' dx matrix bitwise as their plain versions do, and sets
    both route flags to the forced value; without dx it writes only the
    flags."""
    gen = torch.Generator(device=cuda_device).manual_seed(20)
    w = torch.randn((cout, cin, 3, 3), generator=gen, device=cuda_device) * 0.2
    stream = torch.cuda.current_stream().cuda_stream
    w2, w2_cc, flags = port_spike_conv.fp32_dx_weights(w, True, force, stream)
    none_w2, none_cc, flags_no_dx = port_spike_conv.fp32_dx_weights(w, False, force, stream)
    torch.cuda.synchronize()
    assert torch.equal(w2, port_spike_conv.dx_weight_terms(w))
    assert torch.equal(w2_cc, port_spike_conv.dx_weight(w, torch.float32))
    assert none_w2 is None and none_cc is None
    assert flags.tolist() == flags_no_dx.tolist() == [int(force)] * 2


@pytest.mark.gpu
@pytest.mark.parametrize("cin,cout", [(2, 64), (6, 10), (256, 512), (320, 128)])
def test_spike_conv_fp32_weights_match_plain(cuda_device, cin, cout):
    """The fp32 forward's weight kernel gives the planes' matrix and the
    CUDA cores' matrix bitwise as their plain versions do, and a cleared
    route flag."""
    gen = torch.Generator(device=cuda_device).manual_seed(17)
    w = torch.randn((cout, cin, 3, 3), generator=gen, device=cuda_device) * 0.2
    wk, wk_cc, inexact = port_spike_conv.fp32_weights(w, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert torch.equal(wk, port_spike_conv.kernel_weight_planes(w))
    assert torch.equal(wk_cc, port_spike_conv.kernel_weight(w, torch.float32))
    assert int(inexact) == 0


@pytest.mark.gpu
def test_spike_conv_fp32_forward_beyond_32bit_rows(cuda_device):
    """An fp32 forward of more rows than the tensor-core loop's 32-bit
    index runs on the CUDA cores: with x zero but for its first and last
    two images and a zero bias, y is zero between them and within 1e-5 of
    the plain version on them, and s1, s2 are the plain version's over
    those four images within rtol 1e-4, atol 1e-3."""
    gen = torch.Generator(device=cuda_device).manual_seed(18)
    n = port_spike_conv.MAX_ROWS // 49 + 2
    ends = torch.randn((4, 1, 7, 7), generator=gen, device=cuda_device)
    w = torch.randn((1, 1, 3, 3), generator=gen, device=cuda_device)
    b = torch.zeros(1, device=cuda_device)
    x = torch.zeros((n, 1, 7, 7), device=cuda_device)
    x[:2], x[-2:] = ends[:2], ends[2:]
    port_spike_conv.reset_fp32_route_counts()
    y, s1, s2 = port_spike_conv.spike_conv3x3_fwd(x, w, b)
    assert port_spike_conv.fp32_route_counts() == (0, 1)
    del x
    y_ref, s1_ref, s2_ref = port_spike_conv.spike_conv3x3_fwd_reference(ends, w, b)
    torch.testing.assert_close(torch.cat([y[:2], y[-2:]]), y_ref, **K4_Y_TOL["fp32"])
    assert int(torch.count_nonzero(y[2:-2])) == 0
    torch.testing.assert_close(s1, s1_ref, **K4_MOMENT_TOL)
    torch.testing.assert_close(s2, s2_ref, **K4_MOMENT_TOL)


@pytest.mark.gpu
def test_spike_conv_autograd_and_rejects(cuda_device):
    """Autograd through K4 launches one forward and one backward; a
    non-contiguous input or a half tensor is refused."""
    gen = torch.Generator(device=cuda_device).manual_seed(14)
    x = (torch.rand((8, 16, 7, 7), generator=gen, device=cuda_device) < 0.3).float()
    w = (torch.randn((32, 16, 3, 3), generator=gen, device=cuda_device) * 0.2).requires_grad_()
    b = torch.zeros(32, device=cuda_device, requires_grad=True)
    before = (port_spike_conv.LAUNCHES_FWD, port_spike_conv.LAUNCHES_BWD)
    y, s1, s2 = port_spike_conv.spike_conv3x3(x.requires_grad_(), w, b)
    (y.sum() + s1.sum() + s2.sum()).backward()
    assert (port_spike_conv.LAUNCHES_FWD - before[0],
            port_spike_conv.LAUNCHES_BWD - before[1]) == (1, 1)
    assert x.grad.shape == x.shape and w.grad.shape == w.shape
    with pytest.raises(ValueError, match="contiguous"):
        port_spike_conv.spike_conv3x3_fwd(x.detach().transpose(2, 3), w.detach(), b.detach())
    with pytest.raises(TypeError):
        port_spike_conv.spike_conv3x3_fwd(x.detach().half(), w.detach(), b.detach())


@pytest.mark.gpu
def test_spike_conv_bf16_rejects_what_it_does_not_take(cuda_device):
    """The bf16 route raises rather than runs: more rows than its 32-bit
    index, a bf16 weight, a non-contiguous input, a cotangent in another
    dtype; nothing launches."""
    gen = torch.Generator(device=cuda_device).manual_seed(15)
    x = (torch.rand((4, 8, 7, 7), generator=gen, device=cuda_device) < 0.3).bfloat16()
    w = torch.randn((16, 8, 3, 3), generator=gen, device=cuda_device) * 0.2
    b = torch.zeros(16, device=cuda_device)
    y = port_spike_conv.spike_conv3x3_fwd(x, w, b)[0]
    zeros = torch.zeros(16, device=cuda_device)
    before = (port_spike_conv.LAUNCHES_FWD, port_spike_conv.LAUNCHES_BWD)
    big = torch.empty((port_spike_conv.MAX_ROWS // 49 + 1, 1, 7, 7), dtype=torch.bfloat16,
                      device=cuda_device)
    with pytest.raises(ValueError, match="rows"):
        port_spike_conv.spike_conv3x3_fwd(big, w[:, :1].contiguous(), b)
    del big
    with pytest.raises(TypeError, match="float32"):
        port_spike_conv.spike_conv3x3_fwd(x, w.bfloat16(), b)
    with pytest.raises(ValueError, match="contiguous"):
        port_spike_conv.spike_conv3x3_fwd(x.transpose(2, 3), w, b)
    with pytest.raises(ValueError, match="gy must be"):
        port_spike_conv.spike_conv3x3_bwd(x, w, y, y.float(), zeros, zeros)
    assert (port_spike_conv.LAUNCHES_FWD, port_spike_conv.LAUNCHES_BWD) == before
