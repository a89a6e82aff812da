#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``spiking_diffusion_tpu_torch``) on one GPU.

Usage, from the root of a checkout, on a machine with an NVIDIA H100 and
the CUDA toolkit (``nvcc`` under ``$CUDA_HOME``, default /usr/local/cuda):

    python3 chip_smoke.py

Phases, each between a flushed ``phase <name> start`` / ``done in <s>`` line:

0. device: needs a CUDA device (exits non-zero without one); prints the
   card's name and power limit; turns TF32 off and cuDNN deterministic on,
   so that the kernel and plain runs compute the same convolutions.
1. build: compiles every CUDA source of the port with ``nvcc`` (into
   ``build/``), all at once, and prints the build times and ``-Xptxas -v``
   lines.
2. models: the full-width MNIST flagship (49-step sampler, T=16 denoiser
   64-128-256-512-256, K=128, then the VQ-VAE decode) with seeded random
   weights whose BN statistics are set from one batch; the card's logits
   and images are held against the same model on the CPU.
3. kernels: every kernel against its plain PyTorch version on the card, at
   the shapes its path gives it at batch 256, and timed beside the
   kernel's bound on an H100 (CUDA events, L2 flushed, each launch queued
   behind a spin kernel). K1 (LIF forward): bitwise, median of 20. K2 (the
   fused denoiser) in fp32, bf16 and int8: int8 bitwise; fp32 and bf16 at
   least 99 % of logits within 1e-4 and a median |difference| of at most
   1e-6 (sums in another order can flip a spike at threshold); median of
   5; and a ragged batch of 13.
4. generation: the layerwise sampler, three requests at batch 16 and one
   at batch 256, each twice on the same noise, through K1 and through the
   plain LIF: codes and images identical, codes valid, images finite in
   [-1, 1], exactly 248 K1 launches per generated batch.
5. generation_fused: the fused sampler (``sample_codes(fused=True)``) in
   each dtype, one request at batch 256 and two at batch 16 on the noise of
   the layerwise requests: exactly 49 K2 and 3 K1 launches per generated
   batch, valid codes and images; in int8 the same requests through K2's
   plain version give identical codes and equal images. The share of codes
   that agree with the layerwise fp32 run is reported, not bounded (BN
   folding moves the logits by one fp32 rounding).

The last lines are a JSON line of per-kernel numbers, the card's
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": ...}``.
Any failure prints its traceback and exits non-zero without that line.
"""

from __future__ import annotations

import json
import signal
import statistics
import subprocess
import sys
import time
import traceback

import torch

from spiking_diffusion_tpu_torch.config import DiffusionConfig, VQVAEConfig
from spiking_diffusion_tpu_torch.generate import sample_codes
from spiking_diffusion_tpu_torch.models import diffusion, weights
from spiking_diffusion_tpu_torch.models.denoiser import SpikingDenoiser
from spiking_diffusion_tpu_torch.models.layers import LIF
from spiking_diffusion_tpu_torch.models.vqvae import SNNVQVAE
from spiking_diffusion_tpu_torch.ops import _build
from spiking_diffusion_tpu_torch.ops import fused_denoiser as fd
from spiking_diffusion_tpu_torch.ops import lif as lif_op
from spiking_diffusion_tpu_torch.snn.neuron import NeuronParams

BUDGET_S = 900  # the whole run, the build included
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
BATCH = 256  # batch of the kernel shapes and of the large request
REQUESTS = (16, 16, 16, 256)  # 16 is the reference's per-call batch
FUSED_REQUESTS = (3, 0, 1)  # indices into REQUESTS: batch 256, 16, 16
T = 16
TIMING_REPS = 20
K2_TIMING_REPS = 5
K2_RAGGED = 13
# peak rate of the work's type on an H100 SXM (NVIDIA data sheet, dense):
# fp32 on the CUDA cores, bf16 and int8 on the tensor cores
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12, torch.int8: 1979e12}
K2_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
K2_STEP_LAUNCHES = 49  # one per reverse step
K1_DECODE_LAUNCHES = 3
K2_NEAR = 1e-4  # fp32/bf16: at least K2_NEAR_SHARE of logits within this
K2_NEAR_SHARE = 0.99
K2_MEDIAN = 1e-6
SPIN_CYCLES = 2_000_000  # ~1 ms of device time at the H100's clock
LIF_LAUNCHES_PER_BATCH = 5 * 49 + 3  # 5 LIF layers x 49 steps + 3 in decode
K1_REPLACES = "spiking_diffusion_tpu/ops/pallas_lif.py:58"
K2_REPLACES = "spiking_diffusion_tpu/ops/fused_denoiser.py:828"
LOGIT_ATOL = 5e-5  # card vs CPU: fp32 convolutions summed in another order
IMAGE_ATOL = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        log(f"phase {self.name} start")

    def __exit__(self, exc_type, exc, tb):
        state = "done" if exc_type is None else "FAILED"
        log(f"phase {self.name} {state} in {time.perf_counter() - self.t0:.2f} s")
        return False


def over_budget(_signum, _frame):
    raise TimeoutError(f"chip_smoke ran past its {BUDGET_S} s budget")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, flush: torch.Tensor, reps: int = TIMING_REPS) -> float:
    """Median device time in ms of one call of ``fn`` (CUDA events).

    Before each call ``flush`` (larger than L2) is rewritten and a spin
    kernel holds the stream, so the host has queued the call before its
    start event fires: the time is the device's, not the host's launch
    overhead (a call that launches more kernels than the spin covers, like
    the plain LIF loop, still waits on the host)."""
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# --- phase 2: kernel against plain version ---------------------------------


def k1_path_shapes():
    """(name, M, launches per generated batch) of K1 on the generation path."""
    h = 7
    shapes = [(f"denoiser_lif{i + 1}_C{c}", BATCH * h * h * c, 49)
              for i, c in enumerate(DiffusionConfig().denoiser_channels)]
    d, (c1, c2) = VQVAEConfig().embedding_dim, VQVAEConfig().dec_channels
    shapes += [("decode_respike_D16", BATCH * 49 * d, 1),
               ("decode_lif1_C64", BATCH * 196 * c1, 1),
               ("decode_lif2_C32", BATCH * 784 * c2, 1)]
    return shapes


def lif_input(m: int, gen: torch.Generator) -> torch.Tensor:
    return torch.rand((T, m), generator=gen, device="cuda") * 4.0 - 1.0


def compare_lif(x, v_init, params) -> float:
    s, v = lif_op.lif_fwd(x, v_init, params)
    s_ref, v_ref = lif_op.lif_fwd_reference(x, v_init, params)
    torch.cuda.synchronize()
    rate = float(s_ref.mean())
    check(0.05 < rate < 0.95, f"firing rate {rate} outside (0.05, 0.95)")
    check(torch.equal(s, s_ref), "K1 spikes differ from the plain version")
    check(torch.equal(v, v_ref), "K1 v_T differs from the plain version")
    return max(float((s - s_ref).abs().max()), float((v - v_ref).abs().max()))


def phase_k1(gen: torch.Generator, flush: torch.Tensor) -> dict:
    params = NeuronParams()
    max_err = 0.0
    rows = []
    for name, m, per_batch in k1_path_shapes():
        x = lif_input(m, gen)
        max_err = max(max_err, compare_lif(x, None, params))
        ms = cuda_ms(lambda: lif_op.lif_fwd(x, None, params), flush)
        plain = cuda_ms(lambda: lif_op.lif_fwd_reference(x, None, params), flush)
        bound = (2 * T + 2) * m * 4 / HBM_BYTES_PER_S * 1e3
        rows.append({"shape": name, "T": T, "M": m, "per_batch": per_batch,
                     "ms": ms, "plain_ms": plain, "bound_ms": bound})
        log(f"  K1 {name:22s} T={T} M={m:9d}: kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, bound {bound:.4f} ms (bytes), kernel at "
            f"{bound / ms:.1%} of bound, bitwise equal")
    # the other neuron settings, an explicit v_init and a ragged M
    m = BATCH * 49 * 64 + 7
    x = lif_input(m, gen)
    v0 = torch.rand((m,), generator=gen, device="cuda") * 0.9
    variants = {
        "soft_reset": NeuronParams(hard_reset=False),
        "no_decay_input": NeuronParams(decay_input=False),
        "soft_no_decay_input": NeuronParams(hard_reset=False, decay_input=False),
        "tau4_vth07_vreset01": NeuronParams(tau=4.0, v_threshold=0.7, v_reset=0.1),
        "default": params,
    }
    for name, p in variants.items():
        for v_init in (None, v0):
            max_err = max(max_err, compare_lif(x, v_init, p))
        log(f"  K1 {name} (M={m}, v_init none and given): bitwise equal")
    per_batch = lambda key: sum(r[key] * r["per_batch"] for r in rows)  # noqa: E731
    return {"rows": rows, "max_abs_err": max_err, "ms": per_batch("ms"),
            "plain_ms": per_batch("plain_ms"), "bound_ms": per_batch("bound_ms")}


def k2_inputs(den, dcfg, dtype, n, gen):
    """Folded weights and the a1 of a random token map at batch n."""
    h = dcfg.latent_size
    tokens = torch.randint(0, dcfg.num_embeddings + 1, (n, h, h), generator=gen,
                           device="cuda")
    t = torch.randint(1, dcfg.num_timesteps + 1, (n,), generator=gen, device="cuda")
    folded = fd.fold_denoiser_weights(den, dtype)
    return folded, fd.first_preactivation(tokens, t, folded.k1, folded.b1)


def compare_k2(name, folded, a1, dcfg) -> float:
    """K2 against its plain version on the same inputs; max |d logits|."""
    out = fd.fused_denoise(a1, folded, dcfg)
    ref = fd.fused_denoise_reference(a1, folded, dcfg)
    torch.cuda.synchronize()
    diff = (out - ref).abs()
    max_d, med = float(diff.max()), float(diff.median())
    near = float((diff <= K2_NEAR).float().mean())
    log(f"  K2 {name} N={a1.shape[0]}: max|d logits| {max_d:.3g}, median "
        f"{med:.3g}, share within {K2_NEAR:g} {near:.6f}; logits std "
        f"{float(ref.std()):.4f}")
    check(bool(torch.isfinite(out).all()), "K2 logits not finite")
    check(float(ref.std()) > 0.01, "constant reference logits")
    if folded.dtype == torch.int8:
        check(max_d == 0.0, "K2 int8 logits differ from the plain version")
    else:
        check(near >= K2_NEAR_SHARE,
              f"only {near:.4f} of K2 logits within {K2_NEAR:g} of the plain version")
        check(med <= K2_MEDIAN, f"K2 median |d logits| {med:.3g} > {K2_MEDIAN:g}")
    return max_d


def phase_k2(den, dcfg, gen: torch.Generator, flush: torch.Tensor, card: str) -> dict:
    rows = {}
    for name, dtype in K2_DTYPES.items():
        folded, a1 = k2_inputs(den, dcfg, dtype, BATCH, gen)
        max_err = compare_k2(name, folded, a1, dcfg)
        folded_r, a1_r = k2_inputs(den, dcfg, dtype, K2_RAGGED, gen)
        max_err = max(max_err, compare_k2(name, folded_r, a1_r, dcfg))
        ms = cuda_ms(lambda: fd.fused_denoise(a1, folded, dcfg), flush, K2_TIMING_REPS)
        plain = cuda_ms(lambda: fd.fused_denoise_reference(a1, folded, dcfg), flush,
                        K2_TIMING_REPS)
        itemsize = folded.weights[0].element_size()
        useful, nbytes = fd.denoiser_cost(dcfg, BATCH, itemsize, useful_only=True)
        executed, _ = fd.denoiser_cost(dcfg, BATCH, itemsize)
        ops_ms = useful / PEAK_OPS[dtype] * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        bound = max(ops_ms, bytes_ms)
        rows[name] = {"ms": ms, "plain_ms": plain, "bound_ms": bound,
                      "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                      "max_abs_err": max_err, "useful_tflop": useful / 1e12,
                      "tflops": useful / ms / 1e9, "share_of_bound": bound / ms}
        log(f"  K2 {name} batch {BATCH}: kernel {ms:.3f} ms, plain {plain:.3f} ms, "
            f"bound {bound:.3f} ms ({rows[name]['bound_by']}: {useful / 1e12:.4f} "
            f"TFLOP useful at {PEAK_OPS[dtype] / 1e12:g} TFLOP/s; {nbytes / 1e6:.1f} "
            f"MB at 3.35 TB/s = {bytes_ms:.4f} ms), kernel at {bound / ms:.2%} of "
            f"bound, {useful / ms / 1e9:.2f} TFLOP/s useful ({executed / ms / 1e9:.2f} "
            f"counting all 9 taps); per generated batch (49 calls) {49 * ms:.1f} ms, "
            f"bound {49 * bound:.1f} ms [{card}]")
    return rows


# --- phase 3: generation at full width ---------------------------------------


def build_models(dcfg, vcfg):
    """Seeded random full-width models, BN statistics set from one batch, as
    kernel-path and plain-path copies with the same weights."""
    gen = torch.Generator().manual_seed(0)
    den = weights.load_denoiser(*weights.init_denoiser_variables(dcfg, gen),
                                dcfg, device="cuda")
    vq = weights.load_vqvae(*weights.init_vqvae_decode_variables(vcfg, gen),
                            vcfg, device="cuda")
    cal = torch.Generator(device="cuda").manual_seed(1)
    h = dcfg.latent_size
    tokens = torch.randint(0, dcfg.num_embeddings + 1, (BATCH, h, h),
                           generator=cal, device="cuda")
    t = torch.randint(1, dcfg.num_timesteps + 1, (BATCH,), generator=cal,
                      device="cuda")
    codes = torch.randint(0, vcfg.num_embeddings, (BATCH, h, h), generator=cal,
                          device="cuda")
    weights.calibrate_batchnorm(den, lambda: den(tokens, t))
    weights.calibrate_batchnorm(vq, lambda: vq.decode_indices(codes))
    den_plain = SpikingDenoiser(dcfg, lif_backend="torch").cuda().eval()
    den_plain.load_state_dict(den.state_dict())
    vq_plain = SNNVQVAE(vcfg, lif_backend="torch").cuda().eval()
    vq_plain.load_state_dict(vq.state_dict())
    return den, vq, den_plain, vq_plain


def check_against_cpu(den, vq, dcfg, vcfg):
    """The card's logits and images against the same model on the CPU."""
    gen = torch.Generator().manual_seed(2)
    h = dcfg.latent_size
    tokens = torch.randint(0, dcfg.num_embeddings + 1, (2, h, h), generator=gen)
    t = torch.randint(1, dcfg.num_timesteps + 1, (2,), generator=gen)
    codes = torch.randint(0, vcfg.num_embeddings, (2, h, h), generator=gen)
    den_cpu = SpikingDenoiser(dcfg).eval()
    den_cpu.load_state_dict({k: v.cpu() for k, v in den.state_dict().items()})
    vq_cpu = SNNVQVAE(vcfg).eval()
    vq_cpu.load_state_dict({k: v.cpu() for k, v in vq.state_dict().items()})
    d_logits = (den(tokens.cuda(), t.cuda()).cpu() - den_cpu(tokens, t)).abs().max()
    d_img = (vq.decode_indices(codes.cuda()).cpu() - vq_cpu.decode_indices(codes)).abs().max()
    log(f"  card vs CPU: max|d logits| {float(d_logits):.3g} (tol {LOGIT_ATOL}), "
        f"max|d images| {float(d_img):.3g} (tol {IMAGE_ATOL})")
    check(float(d_logits) <= LOGIT_ATOL, "card logits disagree with the CPU")
    check(float(d_img) <= IMAGE_ATOL, "card images disagree with the CPU")


class FiringRates:
    """Mean firing rate of every LIF layer, gathered by forward hooks."""

    def __init__(self, named_modules):
        self.sums, self.counts, self.handles = {}, {}, []
        for name, mod in named_modules:
            if isinstance(mod, LIF):
                self.handles.append(mod.register_forward_hook(self._hook(name)))

    def _hook(self, name):
        def hook(_mod, _args, out):
            self.sums[name] = self.sums.get(name, 0.0) + out.float().sum()
            self.counts[name] = self.counts.get(name, 0) + out.numel()
        return hook

    def report(self):
        return {k: float(self.sums[k]) / self.counts[k] for k in self.sums}

    def close(self):
        for handle in self.handles:
            handle.remove()


def run_request(den, vq, dcfg, n, noise, sample=None, **options):
    """One request: (codes, images, sampler ms, decode ms).

    ``sample`` (a zero-argument callable) replaces ``sample_codes``."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    if sample is None:
        codes = sample_codes(den, dcfg, n, noise=noise, device="cuda", **options)
    else:
        codes = sample()
    ev[1].record()
    images = vq.decode_indices(codes)
    ev[2].record()
    ev[2].synchronize()
    return codes, images, ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])


def request_noise(dcfg, i: int, steps: int):
    """The seeded per-step noise of request i of REQUESTS."""
    gen = torch.Generator(device="cuda").manual_seed(100 + i)
    return list(diffusion.draw_noise(dcfg, REQUESTS[i], steps, gen, "cuda"))


def check_outputs(codes, images, n, dcfg) -> None:
    check(codes.shape == (n, 7, 7) and codes.dtype == torch.int32, "code shape")
    check(int(codes.min()) >= 0 and int(codes.max()) < dcfg.num_embeddings,
          "codes outside [0, K) or mask id left")
    check(images.shape == (n, 28, 28, 1), f"image shape {tuple(images.shape)}")
    check(bool(torch.isfinite(images).all()), "non-finite images")
    check(float(images.abs().max()) <= 1.0, "images outside [-1, 1]")
    check(float(images.std()) > 0.0, "constant images")


def phase_generation(models, dcfg, card: str):
    """The layerwise path: (K1 launches, {request: (codes, sampler ms,
    decode ms)})."""
    den, vq, den_plain, vq_plain = models
    steps = len(diffusion.schedule(dcfg)[0])
    check(steps == 49, f"{steps} reverse steps, expected 49")
    total_launches = 0
    results = {}
    for i, n in enumerate(REQUESTS):
        noise = request_noise(dcfg, i, steps)
        lif_op.LAUNCHES = 0
        fd.LAUNCHES = 0
        codes, images, sample_ms, decode_ms = run_request(den, vq, dcfg, n, noise)
        launches = lif_op.LAUNCHES
        check(fd.LAUNCHES == 0, "the layerwise path launched K2")
        # the firing rates are read by hooks on the plain run, whose spikes
        # are the kernel run's, so that the timed kernel run has no hooks
        rates = FiringRates(list(den_plain.named_modules(prefix="denoiser"))
                            + list(vq_plain.named_modules(prefix="vqvae")))
        codes_p, images_p, plain_sample_ms, plain_decode_ms = run_request(
            den_plain, vq_plain, dcfg, n, noise)
        rates.close()
        check(lif_op.LAUNCHES == launches, "the plain run launched K1")
        total_launches += launches
        results[i] = (codes, sample_ms, decode_ms)
        d_img = float((images - images_p).abs().max())
        log(f"  request {i} batch {n}: K1 launches {launches}, "
            f"sampler {sample_ms:.1f} ms ({sample_ms / steps:.3f} ms/step), "
            f"decode {decode_ms:.2f} ms, {n / ((sample_ms + decode_ms) / 1e3):.1f} "
            f"images/s; plain LIF: sampler {plain_sample_ms:.1f} ms, decode "
            f"{plain_decode_ms:.2f} ms; max|d images| kernel vs plain {d_img} "
            f"[{card}]")
        log("  firing rates: " + ", ".join(
            f"{k} {v:.4f}" for k, v in rates.report().items()))
        check(launches == LIF_LAUNCHES_PER_BATCH,
              f"{launches} K1 launches, expected {LIF_LAUNCHES_PER_BATCH}")
        check(torch.equal(codes, codes_p), "codes differ between kernel and plain LIF")
        check(d_img == 0.0, "images differ between kernel and plain LIF")
        check_outputs(codes, images, n, dcfg)
    return total_launches, results


def plain_fused_sampler(den, dcfg, dtype, n, noise):
    """The fused sampler with K2's plain version in K2's place."""
    def denoise(tokens, t):
        folded = fd.fold_denoiser_weights(den, dtype)
        a1 = fd.first_preactivation(tokens, t, folded.k1, folded.b1)
        return fd.fused_denoise_reference(a1, folded, dcfg).reshape(
            n, dcfg.latent_size, dcfg.latent_size, dcfg.num_embeddings)
    return lambda: diffusion.sample(denoise, dcfg, n, noise, device="cuda")


def phase_generation_fused(models, dcfg, layerwise, card: str) -> dict:
    """The fused path in each dtype: {dtype: (K2 launches, K1 launches)}."""
    den, vq = models[:2]
    steps = len(diffusion.schedule(dcfg)[0])
    launches = {}
    for name, dtype in K2_DTYPES.items():
        k2_total = k1_total = 0
        for i in FUSED_REQUESTS:
            n = REQUESTS[i]
            noise = request_noise(dcfg, i, steps)
            lif_op.LAUNCHES = 0
            fd.LAUNCHES = 0
            codes, images, sample_ms, decode_ms = run_request(
                den, vq, dcfg, n, noise, fused=True, dtype=dtype)
            k2, k1 = fd.LAUNCHES, lif_op.LAUNCHES
            k2_total += k2
            k1_total += k1
            lw_codes, lw_sample_ms, lw_decode_ms = layerwise[i]
            agree = float((codes == lw_codes).float().mean())
            log(f"  fused {name} request {i} batch {n}: K2 launches {k2}, K1 "
                f"launches {k1}, sampler {sample_ms:.1f} ms "
                f"({sample_ms / steps:.3f} ms/step), decode {decode_ms:.2f} ms, "
                f"{n / ((sample_ms + decode_ms) / 1e3):.1f} images/s; layerwise "
                f"fp32 same run: {lw_sample_ms / steps:.3f} ms/step, "
                f"{n / ((lw_sample_ms + lw_decode_ms) / 1e3):.1f} images/s; "
                f"codes agreeing with layerwise fp32 {agree:.4f} [{card}]")
            check(k2 == K2_STEP_LAUNCHES,
                  f"{k2} K2 launches, expected {K2_STEP_LAUNCHES}")
            check(k1 == K1_DECODE_LAUNCHES,
                  f"{k1} K1 launches, expected {K1_DECODE_LAUNCHES}")
            check_outputs(codes, images, n, dcfg)
            if dtype == torch.int8:
                fd.LAUNCHES = 0
                codes_p, images_p, plain_ms, _ = run_request(
                    den, vq, dcfg, n, noise,
                    sample=plain_fused_sampler(den, dcfg, dtype, n, noise))
                check(fd.LAUNCHES == 0, "the plain fused run launched K2")
                d_img = float((images - images_p).abs().max())
                log(f"  fused int8 request {i} through K2's plain version: "
                    f"sampler {plain_ms:.1f} ms, codes identical "
                    f"{bool(torch.equal(codes, codes_p))}, max|d images| {d_img}")
                check(torch.equal(codes, codes_p), "int8 codes differ from the plain version")
                check(d_img == 0.0, "int8 images differ from the plain version")
        launches[name] = (k2_total, k1_total)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU", file=sys.stderr)
        return 2
    signal.signal(signal.SIGALRM, over_budget)
    signal.alarm(BUDGET_S)
    t_start = time.perf_counter()
    try:
        with Phase("device"):
            smi = nvidia_smi()
            kind = torch.cuda.get_device_name(0)
            log(f"  {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.deterministic = True
            torch.backends.cudnn.benchmark = False
            log("  cudnn.allow_tf32=False cuda.matmul.allow_tf32=False "
                "cudnn.deterministic=True cudnn.benchmark=False")
        with Phase("build"):
            for built in _build.build([lif_op.SOURCE, fd.SOURCE]):
                log(f"  {built.name}: {built.seconds:.1f} s -> {built.path.name}")
                for line in built.log.splitlines():
                    log(f"    {line}")
        with Phase("models"):
            dcfg, vcfg = DiffusionConfig(), VQVAEConfig()
            models = build_models(dcfg, vcfg)
            check_against_cpu(*models[:2], dcfg, vcfg)
        with Phase("kernels"):
            gen = torch.Generator(device="cuda").manual_seed(0)
            flush = torch.empty(64 * 2**20 // 4, device="cuda")  # 64 MiB > 50 MB L2
            k1 = phase_k1(gen, flush)
            k2 = phase_k2(models[0], dcfg, gen, flush, smi)
            del flush
        with Phase("generation"):
            launches, layerwise = phase_generation(models, dcfg, smi)
        with Phase("generation_fused"):
            fused_launches = phase_generation_fused(models, dcfg, layerwise, smi)
        log(f"total {time.perf_counter() - t_start:.1f} s")
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        signal.alarm(0)
    kernels = [{
        "name": "K1 lif_fwd", "route": "cuda",
        "source": "spiking_diffusion_tpu_torch/csrc/lif_fwd.cu",
        "replaces": K1_REPLACES, "launches": launches,
        "max_abs_err": k1["max_abs_err"],
        # times of the 248 launches of one generated batch of 256
        "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        # K1 launches on the fused path (3 per generated batch, the decode)
        "launches_fused_path": {k: v[1] for k, v in fused_launches.items()},
        "shapes": k1["rows"],
    }]
    for name, row in k2.items():
        kernels.append({
            "name": f"K2 fused_denoiser {name}", "route": "cuda",
            "source": "spiking_diffusion_tpu_torch/csrc/fused_denoiser.cu",
            "replaces": K2_REPLACES, "launches": fused_launches[name][0],
            # one call at batch 256; no single PyTorch call is the denoiser
            "library_ms": None, **row,
        })
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
