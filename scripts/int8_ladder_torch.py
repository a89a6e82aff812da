"""K2's int8 ladder on the card: the quantizer's options and the roofline ablations.

The port's counterpart of ``scripts/bench_int8_ladder.py``. On the
committed e60 denoiser (``result_torch/MNIST/snn-vq-vae``), for a seeded
token map at each batch, it times one K2 call (``ops/fused_denoiser.py``
``fused_denoise``, CUDA events, the median of ``--reps`` calls after a
warm-up call) of

* the bf16 sampler, the yardstick of the argmax agreement;
* the int8 sampler with per-row scales (the default), per-cout scales, a
  99.9 percentile clip and a bf16 readout;
* the default int8 sampler under each roofline ablation (``nolif``,
  ``noshift``, ``matmul``), whose output is wrong on purpose,

and prints for each the ms per call, its share of the default int8 call,
and the share of the (N, 49) logit vectors whose argmax agrees with the
bf16 call's. The last line of the output is one JSON object of the rows,
also written to ``--out``. On a machine with the card, from the root of a
checkout::

    python3 scripts/int8_ladder_torch.py [--batches 256,2048] [--reps 10] \\
        [--out int8_ladder.json]

It needs the card and exits with 2 without one.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from spiking_diffusion_tpu_torch.config import DiffusionConfig  # noqa: E402
from spiking_diffusion_tpu_torch.models.denoiser import SpikingDenoiser  # noqa: E402
from spiking_diffusion_tpu_torch.ops import fused_denoiser as fd  # noqa: E402

WEIGHTS = (Path(__file__).resolve().parents[1] / "result_torch" / "MNIST" / "snn-vq-vae"
           / "diff_result" / "diff_model.pt")
# (name, sampler dtype, fold options, ablation)
ARMS = [
    ("bf16", torch.bfloat16, {}, ""),
    ("int8 row", torch.int8, dict(scales="row", clip_pct=None, logits="int8"), ""),
    ("int8 cout", torch.int8, dict(scales="cout", clip_pct=None, logits="int8"), ""),
    ("int8 clip 99.9", torch.int8, dict(scales="row", clip_pct=99.9, logits="int8"), ""),
    ("int8 bf16 logits", torch.int8, dict(scales="row", clip_pct=None, logits="bf16"), ""),
    ("int8 row, nolif", torch.int8, dict(scales="row", clip_pct=None, logits="int8"), "nolif"),
    ("int8 row, noshift", torch.int8, dict(scales="row", clip_pct=None, logits="int8"),
     "noshift"),
    ("int8 row, matmul", torch.int8, dict(scales="row", clip_pct=None, logits="int8"),
     "matmul"),
]
BASE = "int8 row"
FLUSH_BYTES = 64 * 2**20  # > the H100's 50 MB L2


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def load_denoiser(cfg: DiffusionConfig) -> SpikingDenoiser:
    den = SpikingDenoiser(cfg, lif_backend="bnlif")
    ckpt = torch.load(WEIGHTS, map_location="cuda", weights_only=True)
    den.load_state_dict(ckpt["model"], strict=True)
    return den.cuda().eval()


def call_ms(fn, reps: int, flush: torch.Tensor) -> float:
    """Median device ms of one call of ``fn`` (CUDA events), L2 flushed
    before each, after a warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def ladder(den, cfg: DiffusionConfig, n: int, reps: int, seed: int) -> dict:
    """Every arm at batch n on one token map: {name: row}."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    h = cfg.latent_size
    tokens = torch.randint(0, cfg.num_embeddings + 1, (n, h, h), generator=gen, device="cuda")
    t = torch.randint(1, cfg.num_timesteps + 1, (n,), generator=gen, device="cuda")
    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")
    rows, ref = {}, None
    for name, dtype, options, ablate in ARMS:
        folded = fd.fold_denoiser_weights(den, dtype, **options)
        a1 = fd.first_preactivation(tokens, t, folded.k1, folded.b1)
        out = fd.fused_denoise(a1, folded, cfg, ablate)
        top = out.argmax(-1)
        ref = top if ref is None else ref
        ms = call_ms(lambda: fd.fused_denoise(a1, folded, cfg, ablate), reps, flush)
        rows[name] = {"ms": ms, "argmax_agrees_with_bf16": float((top == ref).float().mean()),
                      "finite": bool(torch.isfinite(out).all())}
        del folded, a1, out
        torch.cuda.empty_cache()
    for row in rows.values():
        row["share_of_int8_row"] = row["ms"] / rows[BASE]["ms"]
    return rows


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batches", default="256,2048")
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="write the JSON rows here")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("int8_ladder_torch: no CUDA device; this script times K2 on the card",
              file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = card()
    cfg = DiffusionConfig()
    den = load_denoiser(cfg)
    result = {"card": smi, "weights": str(WEIGHTS.relative_to(WEIGHTS.parents[4])),
              "reps": args.reps, "batches": {}}
    for n in (int(b) for b in args.batches.split(",")):
        rows = ladder(den, cfg, n, args.reps, args.seed)
        result["batches"][n] = rows
        for name, row in rows.items():
            print(f"batch {n:5d}  {name:20s} {row['ms']:9.3f} ms  "
                  f"{row['share_of_int8_row']:7.2%} of int8 row  argmax agrees with bf16 "
                  f"{row['argmax_agrees_with_bf16']:.4f}  [{smi}]", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
