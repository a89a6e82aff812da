"""Data and tensor parallel over one card per rank (NCCL), against one card.

On each of ``--ranks`` ranks (``parallel.launch``: rank r on card r, NCCL,
as ``parallel.mesh.choose_backend`` picks it for a card per rank), at the
full-width MNIST flagship on seeded weights (``chip_smoke.py``'s):

* stage 1 (layerwise, K1) in fp32 and stage 2 on 'bnlif' (K3) in fp32 and
  bf16, at a global batch of ``--batch``: first ``--steps`` steps in one
  process on rank 0's card while the other ranks wait, then ``--steps``
  DP steps on every rank, ``--batch / ranks`` rows each. Rank 0 compares
  the first DP step with the single one at ``chip_smoke.py``'s bounds
  (``hold_dp_run``; a step beyond them is reported, with stage 1's
  spikes that differ on rank 0's rows, and the run goes on); every
  rank's launches must be exact and the replicas bitwise equal;
* the fused bf16 sampler (K2): ``--batch`` images on rank 0's card alone,
  then ``--batch`` images on every rank of a global batch of ``--batch``
  x ranks, rank 0's codes equal to the single card's on the same noise.

``--tp N``: the ranks form a (ranks / N) x N data x model mesh
(``parallel.make_mesh_2d``) and the training steps are the TP steps
(``make_train_step_*_tp`` on a state sharded by ``parallel.shard_state_tp``,
chip_smoke.py's ``tp_state``), held alike; the replicas bitwise equal over
the data group and the replicated tensors over the model group; the
collectives of one more step by group. No sampler: the JAX package has no
tensor-parallel one.

With more ranks than cards the ranks share them over gloo
(``--ranks 4`` on one card: four ranks of 64 rows each). Prints the ms
per step on one card and over the ranks (CUDA events,
medians of steps 2 on), the speedup, the all-reduces of one more DP step
with each collective timed (count, MiB, ms), the sampler's images/s, the
card's name and power limit, then a JSON line of the figures.

Usage, from the repository root, on a machine with one card per rank::

    python scripts/dp_scaling_torch.py [--ranks N] [--tp 1] [--batch 256] [--steps 6]

(``--ranks 4 --tp 2``: the 2 x 2 mesh on four cards.)
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as smoke  # noqa: E402
from spiking_diffusion_tpu_torch import parallel  # noqa: E402
from spiking_diffusion_tpu_torch.config import DiffusionConfig, VQVAEConfig  # noqa: E402
from spiking_diffusion_tpu_torch.generate import sample_codes  # noqa: E402
from spiking_diffusion_tpu_torch.models import diffusion, weights  # noqa: E402
from spiking_diffusion_tpu_torch.ops import _build  # noqa: E402
from spiking_diffusion_tpu_torch.train import stage1, stage2  # noqa: E402
from spiking_diffusion_tpu_torch.train.state import create_train_state  # noqa: E402


def step_runs(mesh, batch: int, steps: int, stage1_inputs, codes):
    """(name, bounds, launches a step, a function that makes the model, the
    single and the parallel (DP, or TP on a ``Mesh2D``) step, the batches,
    their corruptions) of each training step."""
    vcfg, dcfg = VQVAEConfig(), DiffusionConfig()
    images, var, sd = stage1_inputs
    if isinstance(mesh, parallel.Mesh2D):
        step1 = stage1.make_train_step_vqvae_tp(var, mesh)
        step2 = stage2.make_train_step_diffusion_tp(dcfg, mesh)
    else:
        step1 = stage1.make_train_step_vqvae_dp(var, mesh)
        step2 = stage2.make_train_step_diffusion_dp(dcfg, mesh)
    data = torch.from_numpy(images).to(mesh.device)
    batches1 = [data[(torch.arange(batch, device=mesh.device) + i * batch) % len(data)] - 0.5
                for i in range(steps)]
    variables = weights.init_denoiser_variables(dcfg, torch.Generator().manual_seed(3))
    gen = torch.Generator(device=mesh.device).manual_seed(batch)
    codes = torch.from_numpy(codes).to(mesh.device)
    batches2 = [codes[(torch.arange(batch, device=mesh.device) + i * batch) % len(codes)]
                for i in range(steps)]
    corruptions = [diffusion.corrupt(x0, dcfg, gen) for x0 in batches2]
    runs = [("stage 1, layerwise fp32", STAGE1_BOUNDS, smoke.STAGE1_STEP_LAUNCHES["layerwise"],
             lambda: smoke.stage1_model(vcfg, sd, "auto", mesh.device),
             stage1.make_train_step_vqvae(var), step1, batches1, None)]
    for name, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        runs.append((f"stage 2, 'bnlif' {name}", STAGE2_BOUNDS[name], smoke.STEP_LAUNCHES["bnlif"],
                     lambda dtype=dtype: weights.load_denoiser(
                         *variables, dcfg, device=mesh.device, lif_backend="bnlif", train=True,
                         dtype=dtype),
                     stage2.make_train_step_diffusion(dcfg), step2, batches2, corruptions))
    return runs


# (loss atol, statistics tolerance, gradient tolerance), chip_smoke.py's
STAGE1_BOUNDS = (smoke.STAGE1_CPU_LOSS_ATOL, smoke.STATS_TOL, smoke.STAGE1_CPU_GRAD_TOL)
STAGE2_BOUNDS = {"fp32": (smoke.CONV_LOSS_ATOL, smoke.CONV_STATS_TOL, smoke.GRAD_TOL),
                 "bf16": (smoke.CONV_LOSS_ATOL, smoke.CONV_STATS_TOL, smoke.DP_BF16_GRAD_TOL)}


def train_figures(mesh, args, inputs) -> dict:
    out = {}
    tp = isinstance(mesh, parallel.Mesh2D)
    world, rows = (mesh.world, mesh.data) if tp else (mesh, mesh)
    runs = step_runs(mesh, args.batch, args.steps, inputs["stage1"], inputs["codes"])
    for what, bounds, launches, build, single_step, dp_step, batches, corruptions in runs:
        single = None
        spikes = corruptions is None  # stage 1
        if world.rank == 0:
            single = smoke.stepwise(create_train_state(build()), single_step, batches,
                                    corruptions, spikes)
            single["spikes"] = [smoke.rank_rows(x, rows).clone() for x in single["spikes"]]
        torch.cuda.synchronize()
        smoke.rank_values([0], world)  # the other ranks wait for rank 0's single run
        if tp:
            state = smoke.tp_state(build(), mesh)
        else:
            state = create_train_state(parallel.replicate(parallel.sync_batchnorm(build(), mesh),
                                                          mesh))
        dp = smoke.stepwise(state, dp_step, batches, corruptions, spikes)
        step = ((lambda: dp_step(state, batches[0])) if corruptions is None
                else (lambda: dp_step(state, batches[0], corruption=corruptions[0])))
        if tp:
            smoke.unshard_run(dp, state, mesh)
            smoke.hold_tp_rank(what, mesh, dp, state, launches)
            timed = smoke.timed_tp_step(mesh, step)
        else:
            smoke.hold_dp_rank(what, mesh, dp, state, launches)
            timed = smoke.timed_dp_step(mesh, step)
        ranks = smoke.rank_values([statistics.median(dp["ms"])] + list(timed), world)
        if world.rank == 0:
            pairs = list(zip(single.pop("spikes"), dp.pop("spikes")))
            flips = [sum(int((a != b.reshape(a.shape)).sum()) for a, b in pairs),
                     sum(a.numel() for a, _ in pairs)]
            del pairs
            try:
                smoke.hold_dp_run(what, single, dp, smoke.state_lr(state), *bounds)
                held = True
            except AssertionError as e:
                held = False
                smoke.log(f"  {what}: the first DP step is beyond the smoke's bounds: {e}")
            if spikes:
                smoke.log(f"  {what}: {flips[0]} of {flips[1]} spikes of the first step differ "
                          "from one card's on rank 0's rows")
            one = statistics.median(single["ms"])
            dp_ms = max(r[0] for r in ranks)
            # the collectives of the timed step: (ms on each rank, count, bytes) by group
            groups = {"model": (1, 2, 3), "data": (4, 5, 6)} if tp else {"all-reduce": (1, 2, 3)}
            coll = {g: {"ms": [r[i + 1] for r in ranks], "count": int(ranks[0][c + 1]),
                        "bytes": int(ranks[0][b + 1])} for g, (i, c, b) in groups.items()}
            smoke.log(f"  {what} at {args.batch}: one card {one:.2f} ms a step, "
                      f"{world.world_size} cards {dp_ms:.2f} ms (the slowest rank's median), "
                      f"speedup {one / dp_ms:.2f}; a timed step {ranks[0][1]:.2f} ms (host "
                      "clock); " + "; ".join(
                          f"{g} group {c['count']} collectives of {c['bytes'] / 2**20:.2f} MiB "
                          "in " + ", ".join(f"{x:.2f}" for x in c["ms"]) + " ms on the ranks"
                          for g, c in coll.items()))
            out[what] = {"within_bounds": held, "spikes_differing": flips,
                         "one_card_ms": one, "parallel_ms": [r[0] for r in ranks],
                         "timed_step_ms": [r[1] for r in ranks], "collectives": coll}
        torch.cuda.empty_cache()
    return out


def sampler_figures(mesh, args) -> dict:
    dcfg = DiffusionConfig()
    den = smoke.exported_denoiser("MNIST/snn-vq-vae", dtype=torch.bfloat16)
    total = args.batch * mesh.world_size
    gen = torch.Generator(device=mesh.device).manual_seed(smoke.DP_NOISE_SEED)
    noise = list(diffusion.draw_noise(dcfg, total, dcfg.num_timesteps, gen, mesh.device))
    options = dict(device=mesh.device, fused=True, dtype=torch.bfloat16)

    def timed(run):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    single_ms = None
    if mesh.rank == 0:
        rows = [(u[:args.batch], g[:args.batch]) for u, g in noise]
        sample_codes(den, dcfg, args.batch, noise=rows, **options)  # warm
        single, single_ms = timed(lambda: sample_codes(den, dcfg, args.batch, noise=rows,
                                                       **options))
    smoke.rank_values([0], mesh)
    sample_codes(den, dcfg, total, noise=noise, data_parallel=mesh.world_size, **options)
    smoke.reset_launch_counts()
    codes, ms = timed(lambda: sample_codes(den, dcfg, total, noise=noise,
                                           data_parallel=mesh.world_size, **options))
    counts = smoke.launch_counts()
    smoke.check(counts == (0, 0, 0, 0, smoke.K2_STEP_LAUNCHES, 0, 0),
                f"DP sampler: rank {mesh.rank} launches {counts}")
    ranks = smoke.rank_values([ms], mesh)
    if mesh.rank != 0:
        return {}
    agree = float((codes[:args.batch] == single).float().mean())
    smoke.check(agree == 1.0, f"DP sampler: rank 0's codes {agree:.6f} equal to one card's")
    dp_ms = max(r[0] for r in ranks)
    smoke.log(f"  fused bf16 sampler: one card {args.batch} images in {single_ms:.1f} ms "
              f"({args.batch / single_ms * 1e3:.1f} images/s); {mesh.world_size} cards {total} "
              f"in {dp_ms:.1f} ms ({total / dp_ms * 1e3:.1f} images/s, host clock, the "
              f"slowest rank); rank 0's codes equal to one card's")
    return {"one_card_ms": single_ms, "one_card_images_per_s": args.batch / single_ms * 1e3,
            "dp_ms": [r[0] for r in ranks], "images_per_s": total / dp_ms * 1e3}


def rank_main(args, inputs) -> dict:
    smoke.pin_arithmetic()
    if args.tp > 1:
        mesh = parallel.make_mesh_2d(args.ranks // args.tp, args.tp)
        return {"backend": mesh.world.backend, "train": train_figures(mesh, args, inputs)}
    mesh = parallel.make_mesh(args.ranks)
    return {"backend": mesh.backend, "train": train_figures(mesh, args, inputs),
            "sampler": sampler_figures(mesh, args)}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ranks", type=int, default=None, help="default: every card")
    p.add_argument("--tp", type=int, default=1,
                   help="model ranks of a (ranks / tp) x tp mesh; 1: data parallel")
    p.add_argument("--batch", type=int, default=smoke.DP_BATCH)
    p.add_argument("--steps", type=int, default=6)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("dp_scaling_torch: needs CUDA cards", file=sys.stderr)
        return 2
    args.ranks = args.ranks or torch.cuda.device_count()
    if args.tp < 1 or args.ranks % args.tp:
        p.error(f"--tp {args.tp} does not divide {args.ranks} ranks")
    card = smoke.nvidia_smi()
    smoke.log(f"{args.ranks} ranks on {torch.cuda.device_count()} cards: {card}")
    _build.build([smoke.lif_op.SOURCE, smoke.lif_op.SOURCE_BWD, smoke.fd.SOURCE,
                  smoke.bnl.SOURCE])
    images, var, sd = smoke.stage1_setup(VQVAEConfig())
    vq = smoke.stage1_model(VQVAEConfig(), sd, "auto", "cuda")
    codes = stage1.extract_code_indices(vq, images[:args.batch], batch_size=args.batch)
    inputs = {"stage1": (images, var, {k: v.cpu() for k, v in sd.items()}), "codes": codes}
    del vq
    out = parallel.launch(rank_main, args.ranks, args=(args, inputs), device="cuda")
    smoke.log(card)
    smoke.log(json.dumps({"ranks": args.ranks, "tp": args.tp, "batch": args.batch, "card": card,
                          **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
