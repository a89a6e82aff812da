"""The operand contract of K2's tensor-core kernels, on the CPU.

The kernels in ``csrc/fused_denoiser.cu`` run the denoiser layer by layer
over all T steps: each conv is one GEMM over N * P * T spike rows ordered
(n, p, t), t fastest, channels-last in bf16 with each part of the operand
padded to 8 channels (``_spike_rows``; the readout's operand is (x_L | s1)),
against the bf16 matrix ``kernel_matrix`` builds from the folded weight
(kernel rows in the order centre, top, bottom, each padded to whole
64-deep stages; fp32 as three bf16 planes). The loop's hook folds each
kernel row's sum into the output in the plain version's order (int8 times
its scale), the epilogue adds the bias and scans the LIF over t, and the
readout sums over t in order and divides by T.

Here that contract is emulated in PyTorch: the kernel's im2col, from the
(n, p, t) rows by its index map (neighbour of row (n, p, t) under a tap is
row ((n * P + p') * T + t), zero off the grid and in the padding), times
the packed matrix in fp32, then the fold. It must give ``_conv_rows``, the
plain version's conv, for every step's rows, and the layer-outer order must
give ``fused_denoise_reference``'s logits.

Tolerances. Spikes are 0 or 1, so every product is exact. int8 kernel-row
sums are integers below 2^24, exact in any order: bitwise. bf16 and fp32
weights on a dyadic grid (bf16: k / 2^10, |k| < 2^8; fp32: k / 2^19,
|k| < 2^17, which needs all three planes) keep every sum exact at these
widths, so the layout is held bitwise there too; the folded fp32 and bf16
weights themselves within fp32 rounding of sums taken in another order
(rtol 1e-6, atol 1e-6). Against the JAX package's mirror
(``mirror_denoise_fn``) at its own kernel-vs-mirror tolerance, atol and
rtol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from spiking_diffusion_tpu.config import DiffusionConfig as JaxDiffusionConfig
from spiking_diffusion_tpu.ops import fused_denoiser as jfd
from spiking_diffusion_tpu_torch.config import DiffusionConfig
from spiking_diffusion_tpu_torch.models import weights
from spiking_diffusion_tpu_torch.ops import fused_denoiser as fd
from spiking_diffusion_tpu_torch.snn.neuron import lif_step

# channels that are not multiples of 8, so every part of every operand is
# padded, and a readout of 9 classes
SMALL = dict(num_timesteps=6, latent_size=7, num_embeddings=9, mask_id=9,
             denoiser_channels=(4, 12, 6, 10, 5))
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
FP32_TOL = dict(rtol=1e-6, atol=1e-6)
# csrc/fused_denoiser.cu: the kernel row dy of the loop's kernel rows 0, 1, 2
KERNEL_ROWS = (1, 0, 2)


@pytest.fixture(autouse=True)
def setup():
    torch.set_num_threads(1)


def _model(steps, seed=0):
    cfg = DiffusionConfig(num_steps=steps, **SMALL)
    params, stats = weights.init_denoiser_variables(cfg, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    for i, c in enumerate(cfg.denoiser_channels):  # non-identity BN
        bn = params[f"SeqBatchNorm_{i}"]["BatchNorm_0"]
        bn["scale"] = rng.uniform(0.8, 1.6, c).astype(np.float32)
        bn["bias"] = rng.normal(0.3, 0.3, c).astype(np.float32)
        st = stats[f"SeqBatchNorm_{i}"]["BatchNorm_0"]
        st["mean"] = rng.normal(0.0, 0.2, c).astype(np.float32)
        st["var"] = rng.uniform(0.05, 0.5, c).astype(np.float32)
    den = weights.load_denoiser(params, stats, cfg, device="cpu")
    return cfg, den, {"params": params, "batch_stats": stats}


def _tokens(cfg, n, seed):
    rng = np.random.default_rng(seed)
    h = cfg.latent_size
    tokens = rng.integers(0, cfg.num_embeddings + 1, (n, h, h)).astype(np.int32)
    t = rng.integers(1, cfg.num_timesteps + 1, (n,)).astype(np.int32)
    return tokens, t


def _dyadic(folded: fd.FoldedDenoiser, seed: int) -> fd.FoldedDenoiser:
    """The folded weights replaced by seeded values on a grid on which every
    kernel-row sum of these widths is exact in fp32 (fp32 and bf16 only)."""
    if folded.dtype == torch.int8:
        return folded
    bits, span = (19, 2**17) if folded.dtype == torch.float32 else (10, 2**8)
    rng = np.random.default_rng(seed)
    ws = tuple(torch.from_numpy(rng.integers(-span + 1, span, w.shape).astype(np.float32)
                                / 2.0**bits).to(folded.dtype) for w in folded.weights)
    return dataclasses.replace(folded, weights=ws)


def _folded(den, dtype, dyadic, seed=11):
    folded = fd.fold_denoiser_weights(den, dtype)
    return _dyadic(folded, seed) if dyadic else folded


def _spike_rows(x: torch.Tensor) -> torch.Tensor:
    """Spikes (T, N, P, C) -> the kernel's operand rows: (N * P * T, Cp),
    row (n * P + p) * T + t, bf16, the padding channels zero."""
    t, n, p, c = x.shape
    out = F.pad(x.to(torch.bfloat16).permute(1, 2, 0, 3), (0, fd.padded_channels(c) - c))
    return out.reshape(n * p * t, -1)


def _neighbours(n: int, hw: int, steps: int, dy: int, dx: int) -> torch.Tensor:
    """The row each (n, p, t) row reads under tap (dy, dx), -1 off the grid."""
    y, x = torch.meshgrid(torch.arange(hw), torch.arange(hw), indexing="ij")
    yy, xx = y + dy - 1, x + dx - 1
    ok = (yy >= 0) & (yy < hw) & (xx >= 0) & (xx < hw)
    p2 = torch.where(ok, yy * hw + xx, -1).reshape(1, hw * hw, 1)
    img = torch.arange(n).reshape(n, 1, 1)
    t = torch.arange(steps).reshape(1, 1, steps)
    rows = (img * hw * hw + p2) * steps + t
    return torch.where(p2 >= 0, rows, -1).reshape(-1)


def _kernel_conv(rows: torch.Tensor, mat: torch.Tensor, bias: torch.Tensor,
                 planes: int, n: int, hw: int, steps: int) -> torch.Tensor:
    """What conv_tile computes: (M, Cp) operand rows and the (3 * Kr, Np) B
    -> z (M, Np) fp32, one kernel row at a time in the matrix's order, each
    row's sum folded as the hook does, then the bias."""
    m, cp = rows.shape
    kr = fd.kernel_row_depth(planes, cp)
    assert mat.shape[0] == 3 * kr and kr % fd.STAGE_DEPTH == 0
    padded = torch.cat([rows, rows.new_zeros((1, cp))])  # row -1: zeros
    out = None
    for i, dy in enumerate(KERNEL_ROWS):
        taps = [padded[_neighbours(n, hw, steps, dy, dx)] for dx in range(3)]
        a = torch.cat(taps * planes, dim=1)  # column plane * 3 * cp + dx * cp + c
        a = torch.cat([a, a.new_zeros((m, kr - a.shape[1]))], dim=1)
        part = a.float() @ mat[i * kr:(i + 1) * kr].float()
        if bias.shape[0] == 4:
            scale = torch.cat([bias[1 + dy], bias.new_ones(mat.shape[1] - bias.shape[1])])
            part = part * scale
        out = part if out is None else out + part
    return out + torch.cat([bias[0], bias.new_zeros(mat.shape[1] - bias.shape[1])])


def _kernel_forward(a1: torch.Tensor, folded: fd.FoldedDenoiser,
                    cfg: DiffusionConfig) -> torch.Tensor:
    """K2's layer-outer order: lif1 for all t, each block's conv for all
    (n, p, t) rows then its LIF scan over t, the readout then its sum over
    t in order, / T."""
    n, hw2, c1 = a1.shape
    steps, hw = cfg.num_steps, cfg.latent_size
    p = cfg.lif.to_params()
    chans = tuple(cfg.denoiser_channels)
    planes = fd.planes_of(folded.dtype)

    def scan(z):  # (N, P, T, C) -> spikes (T, N, P, C)
        v = torch.full(z.shape[:2] + z.shape[3:], p.v_reset)
        spikes = []
        for t in range(steps):
            v, s = lif_step(v, z[:, :, t], p)
            spikes.append(s)
        return torch.stack(spikes)

    s1 = scan(a1.unsqueeze(2).expand(n, hw2, steps, c1))
    x = s1
    for w, b, seg in zip(folded.weights[:-1], folded.biases[:-1], fd.conv_segments(chans)):
        z = _kernel_conv(_spike_rows(x), fd.kernel_matrix(w, seg), b, planes, n, hw, steps)
        x = scan(z[:, :w.shape[2]].reshape(n, hw2, steps, -1))
    rows = torch.cat([_spike_rows(x), _spike_rows(s1)], dim=1)
    z = _kernel_conv(rows, fd.kernel_matrix(folded.weights[-1], fd.conv_segments(chans)[-1]),
                     folded.biases[-1], planes, n, hw, steps)
    z = z[:, :cfg.num_embeddings].reshape(n, hw2, steps, -1)
    acc = torch.zeros((n, hw2, cfg.num_embeddings))
    for t in range(steps):
        acc = acc + z[:, :, t]
    return acc / steps


def _spikes(shape, seed, rate=0.4):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.random(shape) < rate).astype(np.float32))


def _assert_same(got, want, exact):
    if exact:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, **FP32_TOL)


@pytest.mark.parametrize("steps", [3, 4])
@pytest.mark.parametrize("dtype, dyadic", [("fp32", True), ("fp32", False), ("bf16", True),
                                           ("bf16", False), ("int8", False)])
def test_kernel_rows_reproduce_conv_rows(dtype, dyadic, steps):
    """Each conv of the kernel, on (n, p, t) rows, gives ``_conv_rows`` of
    every step's rows: the blocks (one operand part) and the readout (x_L |
    s1, both padded). Bitwise where every sum is exact (int8, the dyadic
    grid), else within fp32 rounding."""
    cfg, den, _ = _model(steps)
    folded = _folded(den, DTYPES[dtype], dyadic)
    n, hw = 3, cfg.latent_size
    hw2 = hw * hw
    planes = fd.planes_of(folded.dtype)
    chans = tuple(cfg.denoiser_channels)
    for i, (w, b, seg) in enumerate(zip(folded.weights, folded.biases,
                                        fd.conv_segments(chans))):
        parts = [_spikes((steps, n, hw2, c), seed=10 * i + j) for j, c in enumerate(seg)]
        rows = torch.cat([_spike_rows(x) for x in parts], dim=1)
        mat = fd.kernel_matrix(w, seg)
        assert mat.dtype == torch.bfloat16
        assert mat.shape == (3 * fd.kernel_row_depth(planes, rows.shape[1]),
                             fd.padded_channels(w.shape[2]))
        z = _kernel_conv(rows, mat, b, planes, n, hw, steps)
        assert not z[:, w.shape[2]:].any()  # the padding columns
        z = z[:, :w.shape[2]].reshape(n, hw2, steps, -1)
        for t in range(steps):
            x_t = torch.cat([x[t] for x in parts], dim=-1).reshape(n * hw2, -1)
            want = fd._conv_rows(x_t, w, b, n, hw).reshape(n, hw2, -1)
            _assert_same(z[:, :, t], want, exact=dyadic or dtype == "int8")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kernel_matrix_layout(dtype):
    """B's rows: kernel rows centre, top, bottom, each plane * 3 * Cp + dx *
    Cp + c, the fp32 planes summing exactly to the weight, zero in every
    padding (channels of each operand part, columns, the stage padding)."""
    cfg, den, _ = _model(4)
    folded = fd.fold_denoiser_weights(den, DTYPES[dtype])
    chans = tuple(cfg.denoiser_channels)
    planes = fd.planes_of(folded.dtype)
    for w, seg in zip(folded.weights, fd.conv_segments(chans)):
        mat = fd.kernel_matrix(w, seg).float()
        cout = w.shape[2]
        cp = sum(fd.padded_channels(c) for c in seg)
        kr = fd.kernel_row_depth(planes, cp)
        assert kr % fd.STAGE_DEPTH == 0 and kr - planes * 3 * cp < fd.STAGE_DEPTH
        assert not mat[:, cout:].any()
        assert fd.ROW_ORDER == KERNEL_ROWS
        for i, dy in enumerate(KERNEL_ROWS):
            block = mat[i * kr:(i + 1) * kr]
            assert not block[planes * 3 * cp:].any()
            summed = block[:planes * 3 * cp].reshape(planes, 3, cp, -1).sum(0)
            want = w[dy].float().reshape(3, -1, cout)
            start = pos = 0
            for c in seg:
                assert torch.equal(summed[:, pos:pos + c, :cout], want[:, start:start + c])
                assert not summed[:, pos + c:pos + fd.padded_channels(c)].any()
                start, pos = start + c, pos + fd.padded_channels(c)
        if planes == 3:  # smallest plane first: each a rounding of the rest
            p2, p1, p0 = mat[:9 * cp].reshape(3, 3 * cp, -1)
            assert (p2.abs() <= p1.abs()).all() and (p1.abs() <= p0.abs()).all()
            assert p1.any() and p2.any()


def test_layout_helpers():
    x = _spikes((3, 2, 49, 5), seed=1)
    rows = _spike_rows(x)
    assert rows.shape == (2 * 49 * 3, 8) and rows.dtype == torch.bfloat16
    assert torch.equal(rows.reshape(2, 49, 3, 8)[..., :5].permute(2, 0, 1, 3).float(), x)
    assert not rows[:, 5:].any()
    assert fd.buffer_channels((64, 128, 256, 512, 256)) == (320, 512, 256)
    assert fd.buffer_channels((4, 12, 6, 10, 5)) == (16, 16, 8)
    assert fd.buffer_channels((8, 16)) == (24, 0, 0)
    assert fd.conv_segments((8, 16, 24)) == ((8,), (16,), (24, 8))
    assert fd.kernel_row_depth(3, 320) == 2880 and fd.kernel_row_depth(1, 24) == 128
    with pytest.raises(ValueError, match="segments"):
        fd.kernel_matrix(torch.zeros(3, 3 * 12, 4), (8, 8))


@pytest.mark.parametrize("steps", [3, 4, 16])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_layer_outer_order_equals_plain_version(dtype, steps):
    """All T of a layer, then the LIF scan, then the T-ordered readout sum:
    the plain version's logits, bitwise (int8 folded, fp32 and bf16 on the
    dyadic grid)."""
    cfg, den, _ = _model(steps, seed=2)
    folded = _folded(den, DTYPES[dtype], dyadic=True, seed=12)
    tokens, t = (torch.from_numpy(a) for a in _tokens(cfg, 3, seed=steps))
    a1 = fd.first_preactivation(tokens, t, folded.k1, folded.b1)
    got = _kernel_forward(a1, folded, cfg)
    want = fd.fused_denoise_reference(a1, folded, cfg)
    assert got.shape == want.shape == (3, 49, cfg.num_embeddings)
    assert float(want.std()) > 0.01
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_layer_outer_order_matches_jax_mirror(dtype):
    """The emulated kernel on the folded weights against the JAX package's
    mirror on the same numpy inputs."""
    jdt = {"fp32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8}[dtype]
    cfg, den, variables = _model(4, seed=3)
    jcfg = JaxDiffusionConfig(num_steps=4, **SMALL)
    tokens, t = _tokens(cfg, 4, seed=5)
    mirror = np.asarray(jfd.mirror_denoise_fn(variables, jcfg, jdt)(
        jnp.asarray(tokens), jnp.asarray(t)))
    folded = fd.fold_denoiser_weights(den, DTYPES[dtype])
    a1 = fd.first_preactivation(torch.from_numpy(tokens), torch.from_numpy(t),
                                folded.k1, folded.b1)
    got = _kernel_forward(a1, folded, cfg).reshape(mirror.shape).numpy()
    assert got.std() > 0.1
    np.testing.assert_allclose(got, mirror, atol=1e-5, rtol=1e-5)


def test_card_checks_refuse_what_the_kernel_does_not_take(monkeypatch):
    """The card-only limits, met before anything is allocated: T <= 128
    (a row tile holds whole sequences) and N * P * T below 2^31; the plain
    version takes both."""
    monkeypatch.setattr(fd, "_on_card", lambda t: True)
    cfg, den, _ = _model(129)
    folded = fd.fold_denoiser_weights(den, torch.int8)
    meta = fd.FoldedDenoiser(folded.k1, folded.b1,
                             tuple(w.to("meta") for w in folded.weights),
                             tuple(b.to("meta") for b in folded.biases), torch.int8)
    with pytest.raises(ValueError, match="T <= 128"):
        fd.fused_denoise(torch.empty((2, 49, 4), device="meta"), meta, cfg)
    cfg = DiffusionConfig(num_steps=128, **SMALL)
    with pytest.raises(ValueError, match="rows"):
        fd.fused_denoise(torch.empty((2**31 // (49 * 128) + 1, 49, 4), device="meta"),
                         meta, cfg)
    monkeypatch.undo()
    cfg = DiffusionConfig(num_steps=129, **SMALL)
    tokens, t = (torch.from_numpy(a) for a in _tokens(cfg, 1, seed=0))
    a1 = fd.first_preactivation(tokens, t, folded.k1, folded.b1)
    assert fd.fused_denoise(a1, folded, cfg).shape == (1, 49, 9)
