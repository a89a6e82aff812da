"""The operand contract of K4's fp32 tensor-core route, on the CPU.

The fp32 forward in ``csrc/spike_conv.cu`` takes the tensor cores when
every element of x is finite and exact in bf16 (``bf16_exact``): x is
copied to bf16 channels-last, and the fp32 weight becomes three bf16
planes whose fp32 sum is the weight (``bf16_planes``), stacked smallest
first as one (3 * 9 * Cp_in, Cp_out) matrix (``kernel_weight_planes``)
against which the im2col rows of x are contracted three times. Here those
helpers are checked for exactness, and composed with an fp32 im2col
product in the kernel's index order on spike-valued and token/timestep x,
which is what the kernel computes, and held against the port's plain version
(``spike_conv3x3_fwd_reference``) and against the JAX package's
``spike_conv3x3`` (Pallas in interpret mode) on the same numpy inputs.

Tolerances: those of tests/test_torch_spike_conv.py, the JAX package's own
for its kernel against XLA's conv, since the sums run in other orders: y
within 1e-5, s1 and s2 within rtol 1e-4, atol 1e-3. The splits are exact:
equal, bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from spiking_diffusion_tpu.ops import spike_conv as jax_spike_conv
from spiking_diffusion_tpu_torch.ops import spike_conv as sc

Y_TOL = dict(rtol=1e-5, atol=1e-5)
MOMENT_TOL = dict(rtol=1e-4, atol=1e-3)
SMALLEST_NORMAL = 2.0**-126
EXACT_FROM = 2.0**-110  # below, a plane would need bits under bf16's least subnormal


@pytest.fixture(autouse=True)
def setup():
    torch.set_num_threads(1)
    old = jax_spike_conv._INTERPRET
    jax_spike_conv._INTERPRET = True
    yield
    jax_spike_conv._INTERPRET = old


def _weights(kind: str) -> torch.Tensor:
    rs = np.random.RandomState(5)
    if kind.startswith("normal_"):
        w = rs.normal(size=20000) * float(kind.split("_")[1])
    elif kind.startswith("init_cin"):  # the conv init's uniform +-1 / sqrt(9 * Cin)
        w = rs.uniform(-1.0, 1.0, size=20000) / np.sqrt(9 * int(kind[len("init_cin"):]))
    elif kind == "zeros":
        w = np.zeros(100)
    elif kind == "near_smallest_normal":  # every multiple of 2^-133 around 2^-126
        w = SMALLEST_NORMAL + np.arange(-4096, 4096) * 2.0**-133
        w = np.concatenate([w, -w])
    else:  # "from_2e-110": magnitudes from where the split is exact, up
        w = EXACT_FROM * np.exp2(rs.uniform(0.0, 30.0, size=20000)) * rs.choice([-1, 1], 20000)
    return torch.from_numpy(w.astype(np.float32))


@pytest.mark.parametrize("kind", ["normal_1e-3", "normal_0.1", "normal_1", "normal_10",
                                  "init_cin2", "init_cin64", "init_cin512", "zeros",
                                  "near_smallest_normal", "from_2e-110"])
def test_weight_planes_sum_to_the_weight(kind):
    """W0 + W1 + W2 in fp32 is W bitwise, in either order of summation;
    W0 is bf16(W), and each plane is at most 2^-8 of the one before."""
    w = _weights(kind)
    w0, w1, w2 = sc.bf16_planes(w)
    assert w0.dtype == w1.dtype == w2.dtype == torch.bfloat16
    assert torch.equal(w0, w.to(torch.bfloat16))
    assert torch.equal((w2.float() + w1.float()) + w0.float(), w)
    assert torch.equal((w0.float() + w1.float()) + w2.float(), w)
    assert bool((w1.float().abs() <= w0.float().abs() * 2.0**-8).all())
    assert bool((w2.float().abs() <= w1.float().abs() * 2.0**-8).all())


def test_weight_planes_below_exact_range_lose_at_most_half_a_subnormal():
    """Under 2^-110 the planes cannot hold fp32's last bits: the sum is
    within 2^-134, half bf16's least subnormal."""
    rs = np.random.RandomState(6)
    w = torch.from_numpy((rs.normal(size=20000) * 2.0**-118).astype(np.float32))
    w0, w1, w2 = sc.bf16_planes(w)
    err = ((w2.float() + w1.float()) + w0.float() - w).abs()
    assert float(err.max()) <= 2.0**-134


@pytest.mark.parametrize("kind,want", [
    ("spikes", True), ("ints_0_to_256", True), ("token_ids_and_timesteps", True),
    ("bf16_tensor", True), ("257", False), ("normal", False), ("nan", False),
    ("inf", False), ("minus_inf", False), ("spikes_and_one_third", False)])
def test_bf16_exact(kind, want):
    """The plain version of the route's flag: spikes and integers up to 256
    are exact in bf16; 257, normal values, NaN, +-inf (which bf16 holds,
    but inf times a zero plane is NaN) and a single 1/3 are not."""
    rs = np.random.RandomState(7)
    x = {
        "spikes": lambda: (rs.uniform(size=(4, 8, 7, 7)) < 0.3).astype(np.float32),
        "ints_0_to_256": lambda: np.arange(257, dtype=np.float32),
        "token_ids_and_timesteps": lambda: np.stack(
            [rs.randint(0, 129, (4, 7, 7)), np.broadcast_to(rs.randint(1, 50, (4, 1, 1)),
                                                            (4, 7, 7))], 1).astype(np.float32),
        "bf16_tensor": lambda: rs.normal(size=64).astype(np.float32),
        "257": lambda: np.array([257.0], np.float32),
        "normal": lambda: rs.normal(size=64).astype(np.float32),
        "nan": lambda: np.array([0.0, np.nan], np.float32),
        "inf": lambda: np.array([0.0, 1.0, np.inf], np.float32),
        "minus_inf": lambda: np.array([-np.inf, 1.0, 0.0], np.float32),
        "spikes_and_one_third": lambda: np.concatenate(
            [(rs.uniform(size=64) < 0.3).astype(np.float32), [1.0 / 3.0]]).astype(np.float32),
    }[kind]()
    t = torch.from_numpy(np.ascontiguousarray(x))
    if kind == "bf16_tensor":
        t = t.to(torch.bfloat16)
    assert sc.bf16_exact(t) is want


@pytest.mark.parametrize("cin,cout", [(2, 12), (6, 10), (130, 140)])
def test_kernel_weight_planes_layout(cin, cout):
    """Three (9 * Cp_in, Cp_out) blocks, W2 then W1 then W0, each laid out
    as ``kernel_weight_cl``; in fp32 they add up to the fp32 matrix."""
    rs = np.random.RandomState(8)
    w = torch.from_numpy((rs.normal(size=(cout, cin, 3, 3)) * 0.2).astype(np.float32))
    m = sc.kernel_weight_planes(w)
    k = 9 * sc.padded_channels(cin)
    assert m.dtype == torch.bfloat16 and m.shape == (3 * k, sc.padded_channels(cout))
    for block, plane in zip(m.split(k), reversed(sc.bf16_planes(w))):
        assert torch.equal(block, sc.kernel_weight_cl(plane, torch.bfloat16))
    w2, w1, w0 = (b.float() for b in m.split(k))
    assert torch.equal((w2 + w1) + w0, sc.kernel_weight_cl(w, torch.float32))


# (T, N, H = W, Cin, Cout, x): spikes at several widths, including channels
# that are not a multiple of 8 and a 4 x 4 grid, and block 0's token ids
# and timesteps over its two channels
CASES = {
    "tokens_2to12": (2, 3, 7, 2, 12, "tokens"),
    "spikes_6to10": (1, 13, 7, 6, 10, "spikes"),
    "spikes_130to140": (1, 2, 7, 130, 140, "spikes"),
    "spikes_hw4_3to5": (2, 3, 4, 3, 5, "spikes"),
}


def _data(case, seed):
    """numpy (x (T, N, H, W, Cin), kernel (3, 3, Cin, Cout), bias) with x of
    the case's kind, and the port's (x, OIHW weight, bias)."""
    t, n, hw, cin, cout, kind = CASES[case]
    rs = np.random.RandomState(seed)
    if kind == "tokens":
        tok = rs.randint(0, 129, size=(t, n, hw, hw, 1))
        steps = np.broadcast_to(rs.randint(1, 50, size=(t, n, 1, 1, 1)), (t, n, hw, hw, 1))
        x = np.concatenate([tok, steps], -1).astype(np.float32)
    else:
        x = (rs.uniform(size=(t, n, hw, hw, cin)) < 0.3).astype(np.float32)
    kernel = (rs.normal(size=(3, 3, cin, cout)) * 0.2).astype(np.float32)
    bias = (rs.normal(size=(cout,)) * 0.1).astype(np.float32)
    xt = torch.from_numpy(np.ascontiguousarray(
        x.reshape(t * n, hw, hw, cin).transpose(0, 3, 1, 2)))
    return (x, kernel, bias), (xt, torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()),
                               torch.from_numpy(bias))


def planes_fwd(x, weight, bias):
    """The fp32 tensor-core route's GEMM in fp32: the im2col rows of x's
    bf16 channels-last copy, read once per plane (column k' mod 9 * Cp),
    against the stacked planes; (y, s1, s2)."""
    n, cin, h, w = x.shape
    cout, cp = weight.shape[0], sc.padded_channels(cin)
    assert sc.bf16_exact(x)
    pad = F.pad(sc.channels_last(x.to(torch.bfloat16), cp).float().reshape(n, h, w, cp),
                (0, 0, 1, 1, 1, 1))
    a = torch.cat([pad[:, kh:kh + h, kw:kw + w] for kh in range(3) for kw in range(3)], 3)
    a = a.reshape(n * h * w, 9 * cp).repeat(1, 3)
    y = (a @ sc.kernel_weight_planes(weight).float())[:, :cout] + bias
    y = y.reshape(n, h, w, cout).permute(0, 3, 1, 2).contiguous()
    return y, y.sum((0, 2, 3)), (y * y).sum((0, 2, 3))


@pytest.mark.parametrize("case", sorted(CASES))
def test_planes_forward_matches_plain_version(case):
    _, (x, w, b) = _data(case, seed=9)
    y, s1, s2 = planes_fwd(x, w, b)
    y_ref, s1_ref, s2_ref = sc.spike_conv3x3_fwd_reference(x, w, b)
    assert y.dtype == y_ref.dtype == torch.float32 and y.shape == y_ref.shape
    torch.testing.assert_close(y, y_ref, **Y_TOL)
    torch.testing.assert_close(s1, s1_ref, **MOMENT_TOL)
    torch.testing.assert_close(s2, s2_ref, **MOMENT_TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_planes_forward_matches_jax(case):
    """The JAX package's kernel (fp32, interpret mode) against the planes'
    product on the same numpy inputs."""
    t = CASES[case][0]
    (x_np, kernel, bias), (x, w, b) = _data(case, seed=10)
    y_j, s1_j, s2_j = jax_spike_conv.spike_conv3x3(jnp.asarray(x_np), jnp.asarray(kernel),
                                                   jnp.asarray(bias))
    y, s1, s2 = planes_fwd(x, w, b)
    tn, cout, h, hw = y.shape
    y_jax_layout = y.permute(0, 2, 3, 1).reshape(t, tn // t, h, hw, cout).numpy()
    np.testing.assert_allclose(y_jax_layout, np.asarray(y_j), **Y_TOL)
    np.testing.assert_allclose(s1.numpy(), np.asarray(s1_j), **MOMENT_TOL)
    np.testing.assert_allclose(s2.numpy(), np.asarray(s2_j), **MOMENT_TOL)
