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
   ``build/``) and prints the build time and ``-Xptxas -v`` lines.
2. kernels: every kernel against its plain PyTorch version on the card, at
   the shapes the generation path gives it at batch 256, bitwise; times
   both (CUDA events, median of 20, L2 flushed and the launch queued
   behind a spin kernel) beside the kernel's bound on an H100.
3. generation: the full-width MNIST flagship (49-step sampler, T=16
   denoiser 64-128-256-512-256, K=128, then the VQ-VAE decode) with seeded
   random weights, for three requests at batch 16 and one at batch 256.
   Each request runs twice on the same noise, through the kernels and
   through the plain LIF; codes and images must be identical, codes valid,
   images finite in [-1, 1], and each kernel run must launch K1 exactly
   248 times per generated batch. The card's logits and images are also
   held against the same model on the CPU.

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
from spiking_diffusion_tpu_torch.ops import lif as lif_op
from spiking_diffusion_tpu_torch.snn.neuron import NeuronParams

BUDGET_S = 900  # the whole run, the build included
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
BATCH = 256  # batch of the kernel shapes and of the large request
REQUESTS = (16, 16, 16, 256)  # 16 is the reference's per-call batch
T = 16
TIMING_REPS = 20
SPIN_CYCLES = 2_000_000  # ~1 ms of device time at the H100's clock
LIF_LAUNCHES_PER_BATCH = 5 * 49 + 3  # 5 LIF layers x 49 steps + 3 in decode
K1_REPLACES = "spiking_diffusion_tpu/ops/pallas_lif.py:58"
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


def phase_kernels(gen: torch.Generator) -> dict:
    flush = torch.empty(64 * 2**20 // 4, device="cuda")  # 64 MiB > 50 MB L2
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


def run_request(den, vq, dcfg, n, noise):
    """One request: (codes, images, sampler ms, decode ms)."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    codes = sample_codes(den, dcfg, n, noise=noise, device="cuda")
    ev[1].record()
    images = vq.decode_indices(codes)
    ev[2].record()
    ev[2].synchronize()
    return codes, images, ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])


def phase_generation(card: str) -> int:
    dcfg, vcfg = DiffusionConfig(), VQVAEConfig()
    den, vq, den_plain, vq_plain = build_models(dcfg, vcfg)
    check_against_cpu(den, vq, dcfg, vcfg)
    steps = len(diffusion.schedule(dcfg)[0])
    check(steps == 49, f"{steps} reverse steps, expected 49")
    total_launches = 0
    for i, n in enumerate(REQUESTS):
        gen = torch.Generator(device="cuda").manual_seed(100 + i)
        noise = list(diffusion.draw_noise(dcfg, n, steps, gen, "cuda"))
        lif_op.LAUNCHES = 0
        codes, images, sample_ms, decode_ms = run_request(den, vq, dcfg, n, noise)
        launches = lif_op.LAUNCHES
        # the firing rates are read by hooks on the plain run, whose spikes
        # are the kernel run's, so that the timed kernel run has no hooks
        rates = FiringRates(list(den_plain.named_modules(prefix="denoiser"))
                            + list(vq_plain.named_modules(prefix="vqvae")))
        codes_p, images_p, plain_sample_ms, plain_decode_ms = run_request(
            den_plain, vq_plain, dcfg, n, noise)
        rates.close()
        check(lif_op.LAUNCHES == launches, "the plain run launched K1")
        total_launches += launches
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
        check(codes.shape == (n, 7, 7) and codes.dtype == torch.int32, "code shape")
        check(int(codes.min()) >= 0 and int(codes.max()) < dcfg.num_embeddings,
              "codes outside [0, K) or mask id left")
        check(images.shape == (n, 28, 28, 1), f"image shape {tuple(images.shape)}")
        check(bool(torch.isfinite(images).all()), "non-finite images")
        check(float(images.abs().max()) <= 1.0, "images outside [-1, 1]")
        check(float(images.std()) > 0.0, "constant images")
    return total_launches


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
            for built in _build.build([lif_op.SOURCE]):
                log(f"  {built.name}: {built.seconds:.1f} s -> {built.path.name}")
                for line in built.log.splitlines():
                    log(f"    {line}")
        with Phase("kernels"):
            k1 = phase_kernels(torch.Generator(device="cuda").manual_seed(0))
        with Phase("generation"):
            launches = phase_generation(smi)
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
        "shapes": k1["rows"],
    }]
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
