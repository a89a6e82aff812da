"""K2's int8 quantizer options and roofline ablations (``ops/fused_denoiser.py``)
against the JAX package's fused sampler.

JAX's knobs are module globals read at import (``_INT8_SCALES``,
``_INT8_CLIP_PCT``, ``_INT8_LOGITS``, ``_ABLATE``); they are set here with
``monkeypatch.setattr``, its kernel runs in interpret mode, and the port
reads the same settings from JAX's environment variables (or takes them as
arguments). The model is ``tests/test_fused_denoiser.py``'s small ``CFG``
with its trained variables.

* The folded weights against ``_extract_folded_weights`` for per-cout
  scales, a 99.0 percentile clip (per row and per cout) and a bf16
  readout: the int8 weights exactly; the scales bitwise for cout and the
  bf16 readout, and within SCALE_ULPS for the clip, whose weights a scale
  that many ulps apart would move are counted (none may move).
* The plain version against JAX's interpreted kernel and its mirror at
  JAX's own tolerances (tests/test_fused_denoiser_int8.py): 1e-5 for cout
  and clip, 2e-2 for the bf16 readout, which must change the output.
* Each ablation against JAX's interpreted kernel under the same
  ``_ABLATE`` (int8, per-row scales, where both sum in one order). No mode
  depends on JAX's row layout: ``noshift`` reads each row's own spikes at
  every tap, which any row order gives alike.
* Per-row scales never worse than per-cout ones (JAX's
  ``test_int8_row_scales_reduce_weight_error``).
* The environment read at call time, arguments over it, a bad value's
  ``ValueError``, the ablation's warning, and the bias packs ``_check``
  takes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spiking_diffusion_tpu.ops import fused_denoiser as jfd
from spiking_diffusion_tpu_torch.config import DiffusionConfig
from spiking_diffusion_tpu_torch.models import weights
from spiking_diffusion_tpu_torch.ops import fused_denoiser as fd
from test_torch_tpu_precision import tpu_first_conv
from tests.test_fused_denoiser import CFG, _batch, _trained_variables

TIGHT = dict(atol=1e-5, rtol=1e-5)  # JAX's int8 kernel-against-mirror tolerance
BF16_LOGITS = dict(atol=2e-2, rtol=2e-2)  # JAX's, for the bf16 readout
ENV = ("SD_INT8_SCALES", "SD_INT8_CLIP_PCT", "SD_INT8_LOGITS", "SD_FUSED_ABLATE")
# the quantizer options: (port arguments, JAX's globals)
OPTIONS = {
    "cout": (dict(scales="cout"), dict(_INT8_SCALES="cout")),
    "clip99": (dict(clip_pct=99.0), dict(_INT8_CLIP_PCT=99.0)),
    "clip99_cout": (dict(scales="cout", clip_pct=99.0),
                    dict(_INT8_SCALES="cout", _INT8_CLIP_PCT=99.0)),
    "bf16_logits": (dict(logits="bf16"), dict(_INT8_LOGITS="bf16")),
}
ENV_OF = {"scales": "SD_INT8_SCALES", "clip_pct": "SD_INT8_CLIP_PCT",
          "logits": "SD_INT8_LOGITS"}
# A clipped scale against JAX's: ``torch.quantile`` interpolates with lerp
# after q = pct / 100, while XLA on the CPU folds q * (n - 1) into a
# constant whose rounding depends on n and fuses the interpolation's
# multiply-add, so the two part by up to 6 ulps on this model (1.9e-7 of a
# scale, far below the 1/127 of a rounding step).
SCALE_ULPS = 8


@pytest.fixture(autouse=True)
def setup(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setattr(jfd, "_INTERPRET", True)
    for name in ENV:
        monkeypatch.delenv(name, raising=False)


def _jax_knobs(monkeypatch, **knobs):
    for name, value in knobs.items():
        monkeypatch.setattr(jfd, name, value)


@functools.lru_cache(maxsize=None)
def _variables(seed):
    """JAX's trained small-CFG variables as numpy."""
    _, variables = _trained_variables(seed=seed)
    return jax.tree_util.tree_map(np.asarray, jax.device_get(variables))


def _port(seed):
    """(port cfg, the port's denoiser on the CPU) of ``_variables(seed)``."""
    cfg = DiffusionConfig(**{k: getattr(CFG, k) for k in (
        "num_timesteps", "latent_size", "num_embeddings", "mask_id", "num_steps",
        "denoiser_channels")})
    v = _variables(seed)
    return cfg, weights.load_denoiser(v["params"], v["batch_stats"], cfg, device="cpu")


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|a - b| in ulps of fp32 (both positive)."""
    return np.abs(a.astype(np.float32).view(np.int32).astype(np.int64)
                  - b.astype(np.float32).view(np.int32).astype(np.int64))


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_folded_weights_match_jax(option, monkeypatch):
    """The int8 weights exactly; each scale bitwise JAX's, or with a clip
    within SCALE_ULPS, and the weights that its distance would move
    (``round(w / s)`` on the two scales) counted: none."""
    args, knobs = OPTIONS[option]
    _jax_knobs(monkeypatch, **knobs)
    cfg, den = _port(1)
    n_l = len(cfg.denoiser_channels)
    _, _, ws, bs, kf, bf = jfd._extract_folded_weights(_variables(1), n_l, jnp.int8,
                                                        conv_mode="taps")
    folded = fd.fold_denoiser_weights(den, torch.int8, **args)
    fp32 = fd.fold_denoiser_weights(den, torch.float32)
    rows = 2 if args.get("scales") == "cout" else 4
    scale_ulps, moved = [], 0
    for i, (w, b, jw, jb) in enumerate(zip(folded.weights, folded.biases, ws + [kf],
                                           bs + [bf])):
        jw = np.asarray(jw.astype(jnp.float32)).reshape(w.shape)
        jb = np.asarray(jb)
        readout_bf16 = option == "bf16_logits" and i == n_l - 1
        assert w.dtype == (torch.bfloat16 if readout_bf16 else torch.int8)
        np.testing.assert_array_equal(w.float().numpy(), jw)
        assert tuple(b.shape) == ((1 if readout_bf16 else rows), w.shape[2])
        assert b.shape == jb.shape
        np.testing.assert_array_equal(b[:1].numpy(), jb[:1])
        if readout_bf16:
            continue
        s, js = b[1:].numpy(), jb[1:]
        d = _ulps(s, js)
        scale_ulps.append(int(d.max()))
        if d.any():  # the weights that the other scale rounds elsewhere
            wf = fp32.weights[i].numpy()
            groups = np.repeat(js, 3 // js.shape[0], axis=0)[:, None, :]
            mine = np.repeat(s, 3 // s.shape[0], axis=0)[:, None, :]
            q = lambda sc: np.clip(np.round(wf / sc), -127, 127)  # noqa: E731
            moved += int((q(groups) != q(mine)).sum())
    assert max(scale_ulps) <= (SCALE_ULPS if "clip" in option else 0), scale_ulps
    assert moved == 0, f"{moved} weights moved by scales {scale_ulps} ulps apart"


def _port_logits(den, cfg, tokens, t, monkeypatch, env) -> np.ndarray:
    """The port's int8 sampler with JAX's settings in the environment."""
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    fn = fd.make_fused_denoise_fn(den, cfg, torch.int8)
    return fn(torch.from_numpy(np.array(tokens)), torch.from_numpy(np.array(t))).numpy()


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_plain_matches_jax_kernel_and_mirror(option, monkeypatch):
    """Deviation from the JAX package on the CPU: JAX's first conv runs
    through ``tpu_first_conv``, as for the default int8 sampler."""
    args, knobs = OPTIONS[option]
    _jax_knobs(monkeypatch, **knobs)
    tpu_first_conv(monkeypatch, torch.int8)
    cfg, den = _port(2)
    variables = _variables(2)
    x, t = _batch(n=8, seed=17)
    mirror = np.asarray(jax.jit(jfd.mirror_denoise_fn(variables, CFG, jnp.int8))(x, t))
    kernel = np.asarray(jax.jit(jfd.make_fused_denoise_fn(
        variables, CFG, dtype=jnp.int8, block_n=4))(x, t))
    env = {ENV_OF[k]: str(v) for k, v in args.items()}
    got = _port_logits(den, cfg, x, t, monkeypatch, env)
    assert got.shape == mirror.shape == (8, 7, 7, 10) and got.std() > 0.1
    tol = BF16_LOGITS if option == "bf16_logits" else TIGHT
    np.testing.assert_allclose(got, mirror, **tol)
    np.testing.assert_allclose(got, kernel, **tol)
    for name in env:
        monkeypatch.delenv(name)
    default = _port_logits(den, cfg, x, t, monkeypatch, {})
    assert not np.allclose(got, default, atol=1e-7), f"{option} did not change the output"


@pytest.mark.parametrize("ablate", ["nolif", "noshift", "matmul"])
def test_ablation_matches_jax_kernel(ablate, monkeypatch):
    """The port's plain version under ``SD_FUSED_ABLATE`` against JAX's
    interpreted kernel under ``_ABLATE`` (int8, per-row scales), and against
    the port's own unablated output, which it must differ from."""
    _jax_knobs(monkeypatch, _ABLATE=ablate)
    tpu_first_conv(monkeypatch, torch.int8)
    cfg, den = _port(3)
    x, t = _batch(n=8, seed=23)
    kernel = np.asarray(jax.jit(jfd.make_fused_denoise_fn(
        _variables(3), CFG, dtype=jnp.int8, block_n=4))(x, t))
    got = _port_logits(den, cfg, x, t, monkeypatch, {"SD_FUSED_ABLATE": ablate})
    assert got.shape == kernel.shape == (8, 7, 7, 10) and got.std() > 0.1
    np.testing.assert_allclose(got, kernel, **TIGHT)
    monkeypatch.delenv("SD_FUSED_ABLATE")
    assert not np.allclose(got, _port_logits(den, cfg, x, t, monkeypatch, {}), atol=1e-7)


def test_row_scales_never_worse_than_cout():
    """The relative weight error of the dequantized int8 weights, summed
    over the convs: per-row scales refine per-cout ones."""
    _, den = _port(4)
    exact = fd.fold_denoiser_weights(den, torch.float32).weights
    errs = {}
    for scales in fd.SCALES:
        folded = fd.fold_denoiser_weights(den, torch.int8, scales=scales)
        tot = 0.0
        for wq, b, w in zip(folded.weights, folded.biases, exact):
            s = b[1:]
            deq = wq.float() * s.repeat_interleave(3 // s.shape[0], 0)[:, None, :]
            tot += float(torch.linalg.norm(deq - w) / torch.linalg.norm(w))
        errs[scales] = tot
    assert errs["row"] <= errs["cout"] * (1 + 1e-6), errs


def test_clip_at_100_is_the_max_and_saturates_below():
    """The 100th percentile is the largest |w| (the unclipped scale); a
    lower one saturates the weights above it at +-127."""
    w = torch.from_numpy(np.random.default_rng(5).normal(size=(3, 36, 8)).astype(np.float32))
    for scales in fd.SCALES:
        full, s_full = fd.quantize(w, scales)
        at100, s100 = fd.quantize(w, scales, 100.0)
        assert torch.equal(full, at100) and torch.equal(s_full, s100)
        clipped, s_clip = fd.quantize(w, scales, 90.0)
        assert bool((s_clip < s_full).all())
        assert int((clipped.abs() == 127).sum()) > int((full.abs() == 127).sum())


def test_environment_is_read_at_call_time(monkeypatch, capsys):
    """A variable set after the sampler is built still acts on the next
    fold; an argument wins over its variable; an ablation warns as it is
    built and at each call, and is the plain version's ablated output."""
    cfg, den = _port(6)
    x, t = (torch.from_numpy(np.array(a)) for a in _batch(n=2, seed=29))
    fn = fd.make_fused_denoise_fn(den, cfg, torch.int8)
    assert [tuple(b.shape)[0] for b in fd.fold_denoiser_weights(den, torch.int8).biases] == [4] * 5
    before = fn(x, t)
    monkeypatch.setenv("SD_INT8_SCALES", "cout")
    monkeypatch.setenv("SD_INT8_LOGITS", "bf16")
    folded = fd.fold_denoiser_weights(den, torch.int8)
    assert [tuple(b.shape)[0] for b in folded.biases] == [2, 2, 2, 2, 1]
    assert folded.weights[-1].dtype == torch.bfloat16
    assert not torch.equal(fn(x, t), before)
    assert fd.fold_denoiser_weights(den, torch.int8, scales="row").biases[0].shape[0] == 4
    monkeypatch.setenv("SD_INT8_CLIP_PCT", "99.5")
    assert fd.sampler_options() == fd.SamplerOptions("cout", 99.5, "bf16", "")
    assert fd.sampler_options(clip_pct=None).clip_pct is None
    monkeypatch.setenv("SD_FUSED_ABLATE", "nolif")
    capsys.readouterr()
    ablated = fd.make_fused_denoise_fn(den, cfg, torch.int8)
    assert capsys.readouterr().err.count("SD_FUSED_ABLATE=nolif") == 1
    out = ablated(x, t)
    assert capsys.readouterr().err.count("ROOFLINE MODE") == 1
    folded = fd.fold_denoiser_weights(den, torch.int8)
    a1 = fd.first_preactivation(x, t, folded.k1, folded.b1)
    want = fd.fused_denoise_reference(a1, folded, cfg, "nolif")
    assert torch.equal(out.reshape(want.shape), want)
    monkeypatch.delenv("SD_FUSED_ABLATE")
    fd.make_fused_denoise_fn(den, cfg, torch.int8)(x, t)
    assert capsys.readouterr().err == ""


@pytest.mark.parametrize("name,value", [("SD_INT8_SCALES", "channel"),
                                        ("SD_INT8_CLIP_PCT", "high"),
                                        ("SD_INT8_CLIP_PCT", "120"),
                                        ("SD_INT8_LOGITS", "fp8"),
                                        ("SD_FUSED_ABLATE", "noconv")])
def test_bad_value_raises(name, value, monkeypatch):
    cfg, den = _port(6)
    monkeypatch.setenv(name, value)
    with pytest.raises(ValueError):
        fd.fold_denoiser_weights(den, torch.int8)
    with pytest.raises(ValueError):
        fd.make_fused_denoise_fn(den, cfg, torch.int8)(
            torch.zeros((1, 7, 7), dtype=torch.int32), torch.ones((1,), dtype=torch.int32))


def test_check_takes_jax_bias_packs():
    """(4, Cout) row and (2, Cout) cout packs for int8, (1, Cout) for a
    bf16 readout of an int8 sampler; no other pack or readout type."""
    cfg, den = _port(7)
    a1 = torch.zeros((1, 49, cfg.denoiser_channels[0]))
    for scales in fd.SCALES:
        for logits in fd.LOGITS:
            folded = fd.fold_denoiser_weights(den, torch.int8, scales=scales, logits=logits)
            assert fd.fused_denoise(a1, folded, cfg).shape == (1, 49, 10)
    folded = fd.fold_denoiser_weights(den, torch.int8, scales="cout")
    bad = fd.FoldedDenoiser(folded.k1, folded.b1, folded.weights,
                            folded.biases[:-1] + (torch.cat([folded.biases[-1]] * 2)[:3],),
                            torch.int8)
    with pytest.raises(ValueError, match="bias"):
        fd.fused_denoise(a1, bad, cfg)
    fp32 = fd.fold_denoiser_weights(den, torch.float32)
    bad = fd.FoldedDenoiser(folded.k1, folded.b1, folded.weights[:-1] + fp32.weights[-1:],
                            folded.biases[:-1] + fp32.biases[-1:], torch.int8)
    with pytest.raises(TypeError, match="need"):
        fd.fused_denoise(a1, bad, cfg)
    bf16 = fd.fold_denoiser_weights(den, torch.bfloat16)
    bad = fd.FoldedDenoiser(bf16.k1, bf16.b1, bf16.weights[:-1] + (
        bf16.weights[-1].float(),), bf16.biases, torch.bfloat16)
    with pytest.raises(TypeError, match="need"):
        fd.fused_denoise(a1, bad, cfg)
