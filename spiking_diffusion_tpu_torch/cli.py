"""Command-line interface of the port: the JAX package's ``cli.py`` on one
NVIDIA GPU.

The two-stage models (``--model snn-vq-vae``, ``snn-vq-vae-uni`` and the
ANN baseline ``vq-vae``) train stage 1 (the VQ-VAE), extract the code
grids, train stage 2 (the diffusion prior), then evaluate: reconstruction
MSE and 1 - SSIM over the test set, and a temperature sweep of generated
images scored by IS, FID, KID and mode coverage in the LeNet feature
space (the committed frozen one by default). The SNN-VAE baseline
(``--model snn-vae``) trains alone, samples 40 x ``--batch_size`` images
from its prior and prints their IS, KID and FID. Same flags, defaults and
choices as the JAX CLI, and the same artifact tree, with ``.pt`` files in
place of the orbax directories::

    <result_dir>/<dataset>/<model>/epoch=<e>_test.png, model.pt
    <result_dir>/<dataset>/<model>/diff_result/epoch=<e>_test.png, diff_model.pt
    <sample_dir>/<dataset>/<model>/<temp>/image_<temp>_<g>.png
    <sample_dir>/<dataset>/<model>/classes/class_<c>.png, paper_image.png
    <sample_dir>/<dataset>/<model>/metrics.json
    <result_dir>/<dataset>/snn-vae/model.pt; <sample_dir>/<dataset>/snn-vae/image.png

On the card the spiking stage 1 runs its LIF layers on K1 (forward and
BPTT; the ANN VQ-VAE runs none), stage 2 with ``--lif_backend auto`` on
the fused BN + LIF kernel K3 ('bnlif'), and the sweep on the fused
sampler K2 (``--fused_sampler auto``); the SNN-VAE's encoder, heads and
decoder run on K1. ``main`` runs on the card unless the caller passes
``device="cpu"``.

What the port maps or refuses:
  * ``--lif_backend auto|pallas|scan|unroll`` all run the spiking stage 1
    and the SNN-VAE on K1 (the LIF's plain version serves only the CPU);
    only ``auto`` puts stage 2 on 'bnlif' on the card, as the JAX CLI does
    on its accelerator.
  * ``--bf16`` reaches the stage-1 model only for the spiking VQ-VAE: the
    ANN VQ-VAE and the SNN-VAE stay fp32, as in the JAX CLI; the denoiser
    and the sampler follow it for every two-stage model.
  * ``--syops`` prints the spike-aware op/energy report of the stage-1
    model after stage 1, as the JAX CLI does (``profiling/syops.py``; the
    ANN VQ-VAE has no counted layer).
  * ``--data_parallel`` above 1 (ROADMAP.md queue 1, item 2) raises
    ``NotImplementedError``; CIFAR10 and CIFAR10-BW raise from
    ``load_dataset``.

Usage:
    python -m spiking_diffusion_tpu_torch.cli --dataset_name MNIST \\
        --model snn-vq-vae --epochs 100
    python -m spiking_diffusion_tpu_torch.cli \\
        --checkpoint result_torch/MNIST/snn-vq-vae --bf16 --batch_size 256
    python -m spiking_diffusion_tpu_torch.cli --model snn-vae \\
        --checkpoint result_torch/MNIST/snn-vae --batch_size 256
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from spiking_diffusion_tpu_torch.config import DiffusionConfig, SNNVAEConfig, VQVAEConfig
from spiking_diffusion_tpu_torch.data import batch_iterator, data_variance, load_dataset
from spiking_diffusion_tpu_torch.device import resolve_device
from spiking_diffusion_tpu_torch.generate import sample_codes
from spiking_diffusion_tpu_torch.metrics import (
    fid_from_features,
    get_feature_space,
    inception_score_from_probs,
    kid_from_features,
    load_frozen_stats,
    mode_coverage_kl,
    paper_montage,
    per_class_grids,
    ssim,
    verify_stats,
)
from spiking_diffusion_tpu_torch.models import diffusion, weights
from spiking_diffusion_tpu_torch.profiling import syops
from spiking_diffusion_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from spiking_diffusion_tpu_torch.train.stage1 import extract_code_indices, train_vqvae
from spiking_diffusion_tpu_torch.train.stage2 import train_diffusion
from spiking_diffusion_tpu_torch.train.state import TrainState, create_train_state
from spiking_diffusion_tpu_torch.utils import save_image_grid, save_recon_grid

TEMPERATURES = [0.001, 0.01, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0]
SAMPLER_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
FUSED = {"auto": "auto", "on": True, "off": False}
SNN_VAE_SAMPLE_CALLS = 40  # the SNN-VAE's sample calls of --batch_size images scored


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", default=None,
                   help="result dir of a trained run to evaluate")
    p.add_argument("--dataset_name", default="MNIST",
                   choices=["MNIST", "KMNIST", "FMNIST", "Letters",
                            "CIFAR10", "CIFAR10-BW"],
                   help="CIFAR10 and CIFAR10-BW raise: their reader is not ported")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--model", default="snn-vq-vae",
                   choices=["snn-vq-vae", "snn-vq-vae-uni", "snn-vae",
                            "vq-vae"])
    p.add_argument("--data_path", default=None)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--metric", default=None,
                   choices=[None, "IS", "KID", "FID", "MODE"])
    p.add_argument("--ready", default=None,
                   help="stage-1 checkpoint dir: skip stage-1 training")
    p.add_argument("--mask", default="codebook_size",
                   choices=["codebook_size", "max", "min"])
    p.add_argument("--codebook_size", type=int, default=128)
    # extensions over the reference surface
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--num_steps", type=int, default=16, help="SNN T")
    p.add_argument("--lif_backend", default="auto",
                   choices=["auto", "scan", "pallas", "unroll"],
                   help="every choice runs the spiking stage 1 and the "
                        "SNN-VAE on the LIF kernel K1; "
                        "auto also trains stage 2 on the fused BN+LIF "
                        "kernel K3 on the card")
    p.add_argument("--sample_batches", type=int, default=80,
                   help="16-image batches per temperature for metrics")
    p.add_argument("--grid_batches", type=int, default=4,
                   help="sample grids saved per temperature")
    p.add_argument("--result_dir", default="./result")
    p.add_argument("--sample_dir", default="./sample")
    p.add_argument("--data_parallel", type=int, default=1,
                   help="above 1 raises: one card only")
    p.add_argument("--synthetic_train", type=int, default=2048,
                   help="synthetic-fallback train set size (no IDX files)")
    p.add_argument("--synthetic_test", type=int, default=512,
                   help="synthetic-fallback test set size")
    p.add_argument("--sample_steps", type=int, default=None,
                   help="reverse-diffusion steps for generation (default: "
                        "num_timesteps=49, the reference's fixed count); "
                        "fewer steps trade quality for throughput")
    p.add_argument("--unmask_mode", default="random",
                   choices=["random", "confidence"],
                   help="which masked positions each reverse step reveals: "
                        "'random' (the reference's uniform subset) or "
                        "'confidence' (MaskGIT-style highest-confidence "
                        "tokens first)")
    p.add_argument("--sample_spacing", default="linear",
                   choices=["linear", "cosine"],
                   help="t-schedule spacing for --sample_steps < 49")
    p.add_argument("--choice_temperature", type=float, default=1.0,
                   help="Gumbel noise scale for --unmask_mode confidence "
                        "(annealed to 0 over the schedule)")
    p.add_argument("--temperatures", default=None,
                   help="comma-separated sampling temperatures for the "
                        "eval sweep (default: the reference's 12-point "
                        "sweep)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 conv activations/spikes (membranes stay "
                        "fp32)")
    p.add_argument("--fused_sampler", default="auto",
                   choices=["auto", "on", "off"],
                   help="the whole-denoiser kernel K2 for generation "
                        "(auto: when the denoiser is on the card)")
    p.add_argument("--sampler_dtype", default="auto",
                   choices=["auto", "fp32", "bf16", "int8"],
                   help="K2's compute dtype for the eval sweep "
                        "(auto: follow --bf16; int8: per-channel weight "
                        "quantization, spikes exact)")
    p.add_argument("--frozen_metrics", default="auto",
                   choices=["auto", "on", "off"],
                   help="score FID/IS/KID in the committed frozen LeNet "
                        "feature space (metrics/assets/); auto falls back "
                        "to retraining when no compatible space exists")
    p.add_argument("--ref_size", type=int, default=1280,
                   help="real reference-set size for FID/KID (flagship "
                        "runs use 8192)")
    p.add_argument("--vae_scheduled_p", default="off",
                   help="snn-vae scheduled-sampling probability: 'off' = 0, "
                        "'anneal' = 0.1 -> 0.3 over training, or a fixed "
                        "float")
    p.add_argument("--syops", action="store_true",
                   help="print the spike-aware op/energy report of the "
                        "stage-1 model")
    return p.parse_args(argv)


def _refuse(args: argparse.Namespace) -> None:
    """Raise for the choices the port does not run."""
    if args.data_parallel > 1:
        raise NotImplementedError(
            "--data_parallel > 1: the port trains on one card (ROADMAP.md queue 1, item 2)")


def _clock(dev: torch.device) -> float:
    """Host seconds after the card's queued work has finished."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def main(argv: Optional[List[str]] = None, device="cuda") -> Dict[str, object]:
    """Run the CLI; returns the recon means, the metrics.json contents and
    the seconds of each stage (host clock, the card synchronised), or for
    ``--model snn-vae`` what ``_run_snn_vae`` returns."""
    args = parse_args(argv)
    _refuse(args)
    dev = resolve_device(device)
    if dev.type == "cuda":
        # full fp32 convs and matmuls: the frozen-stats check needs them
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    sweep = ([float(x) for x in args.temperatures.split(",")]
             if args.temperatures else list(TEMPERATURES))
    np.random.seed(args.seed)

    save_path = os.path.join(args.result_dir, args.dataset_name, args.model)
    os.makedirs(save_path, exist_ok=True)
    sample_path = os.path.join(args.sample_dir, args.dataset_name, args.model)
    os.makedirs(sample_path, exist_ok=True)

    ds = load_dataset(args.dataset_name, args.data_path,
                      synthetic_size=(args.synthetic_train, args.synthetic_test))
    print(f"load data: {args.dataset_name}! "
          f"(synthetic={ds.synthetic}, train={ds.train_images.shape})")
    variance = data_variance(ds.train_images)
    dtype = torch.bfloat16 if args.bf16 else None
    seconds = {}

    # ---- stage 1: VQ-VAE ------------------------------------------------
    vq_cfg = VQVAEConfig(
        num_steps=args.num_steps,
        num_embeddings=args.codebook_size,
        in_channels=int(ds.train_images.shape[-1]),
        usage_loss_weight=0.1 if args.model == "snn-vq-vae-uni" else 0.0,
    )
    init = torch.Generator().manual_seed(args.seed)
    if args.model == "vq-vae":
        model = weights.load_ann_vqvae(weights.init_ann_vqvae_variables(vq_cfg, init),
                                       vq_cfg, device=dev, train=True)
    elif args.model == "snn-vae":
        vae_cfg = SNNVAEConfig(num_steps=args.num_steps)
        model = weights.load_snn_vae(
            *weights.init_snn_vae_variables(vae_cfg, vq_cfg, init), vae_cfg, vq_cfg,
            device=dev, lif_backend="auto", train=True)
    else:
        model = weights.load_vqvae(*weights.init_vqvae_variables(vq_cfg, init), vq_cfg,
                                   device=dev, lif_backend="auto", train=True, dtype=dtype)
    print("The model is ready!")
    if args.model == "snn-vae":
        return _run_snn_vae(args, model, ds, save_path, sample_path, dev)
    t0 = _clock(dev)
    if args.checkpoint or args.ready:
        restore_checkpoint(create_train_state(model), args.checkpoint or args.ready, "model")
        print(f"loaded stage-1 checkpoint from {args.checkpoint or args.ready}")
    else:
        def epoch_cb(epoch, st):
            imgs = ds.test_images[:32] - 0.5
            recon = st.model(torch.from_numpy(imgs).to(dev), train=False)["recon"]
            save_recon_grid(imgs, recon.cpu().numpy(),
                            os.path.join(save_path, f"epoch={epoch}_test.png"))
            save_checkpoint(st, save_path, "model")

        train_vqvae(model, ds.train_images, variance, epochs=args.epochs,
                    batch_size=args.batch_size, seed=args.seed, epoch_callback=epoch_cb,
                    data_parallel=args.data_parallel, device=dev)
    seconds["stage1"] = _clock(dev) - t0
    if args.syops:
        _print_syops(args, model, ds, dev)

    # ---- stage 2: diffusion prior ---------------------------------------
    print("prepare data for train diffusion...")
    t0 = _clock(dev)
    indices = extract_code_indices(model, ds.train_images, device=dev)
    seconds["codes"] = _clock(dev) - t0
    mask_id = diffusion.pick_mask_id(args.mask, args.codebook_size,
                                     torch.from_numpy(indices[:args.batch_size]))
    print("mask_id = ", mask_id)
    d_cfg = DiffusionConfig(num_embeddings=args.codebook_size, mask_id=mask_id,
                            num_steps=args.num_steps)
    d_backend = "bnlif" if args.lif_backend == "auto" and dev.type == "cuda" else "auto"
    print(f"denoiser backend: {d_backend}")
    denoiser = weights.load_denoiser(
        *weights.init_denoiser_variables(d_cfg, torch.Generator().manual_seed(args.seed)),
        d_cfg, device=dev, lif_backend=d_backend, train=True, dtype=dtype)
    diff_path = os.path.join(save_path, "diff_result")
    os.makedirs(diff_path, exist_ok=True)
    t0 = _clock(dev)
    if args.checkpoint:
        restore_checkpoint(create_train_state(denoiser),
                           os.path.join(args.checkpoint, "diff_result"), "diff_model")
        print("loaded diffusion checkpoint")
    else:
        def diff_cb(epoch, st):
            if epoch % 10 == 0:
                gen = torch.Generator(device=dev).manual_seed(epoch)
                codes = sample_codes(st.model, d_cfg, 32, temperature=0.65,
                                     generator=gen, device=dev)
                imgs = model.decode_indices(codes).cpu().numpy()
                save_image_grid(imgs, os.path.join(diff_path, f"epoch={epoch}_test.png"))
                save_checkpoint(st, diff_path, "diff_model")

        dstate = train_diffusion(denoiser, d_cfg, indices, epochs=args.epochs * 2,
                                 batch_size=args.batch_size, seed=args.seed,
                                 epoch_callback=diff_cb, data_parallel=args.data_parallel,
                                 device=dev)
        save_checkpoint(dstate, diff_path, "diff_model")
    seconds["stage2"] = _clock(dev) - t0

    # ---- evaluation ------------------------------------------------------
    t0 = _clock(dev)
    mse, ssim_loss = _eval_recon(args, model, ds, dev)
    seconds["recon"] = _clock(dev) - t0
    t0 = _clock(dev)
    results = _eval_generation(args, sweep, model, d_cfg, denoiser, ds, sample_path, dev)
    seconds["generation"] = _clock(dev) - t0
    return {"recon_mse": mse, "recon_ssim_loss": ssim_loss, "metrics": results,
            "seconds": seconds}


def _print_syops(args, model, ds, dev):
    """The stage-1 model's op/energy report in eval on the first
    ``--batch_size`` test images, in the JAX CLI's format."""
    imgs = torch.from_numpy(ds.test_images[:args.batch_size] - 0.5).to(dev)
    _, per_layer, total = syops.profile_apply(model, imgs, train=False)
    n_params = syops.count_params(model)
    print(syops.format_report(per_layer, total, n_params))
    print("{:<30}  {:.3e}".format("Computational complexity ACs:", total["acs"]))
    print("{:<30}  {:.3e}".format("Computational complexity MACs:", total["macs"]))
    print("{:<30}  {:,}".format("Number of parameters: ", n_params))


@torch.no_grad()
def _eval_recon(args, model, ds, dev):
    """(mean MSE, mean 1 - SSIM) of the eval forward over the test set in
    batches of ``--batch_size`` (the remainder dropped)."""
    mses, ssims = [], []
    for batch in batch_iterator(ds.test_images, args.batch_size, shuffle=False):
        x = torch.from_numpy(batch - 0.5).to(dev)
        recon = model(x, train=False)["recon"]
        mses.append(float(torch.mean((recon - x) ** 2)))
        ssims.append(1.0 - float(ssim(recon, x)))
    mse, ssim_loss = float(np.mean(mses)), float(np.mean(ssims))
    print("loss_ssim = ", round(ssim_loss, 3))
    print("loss_mse = ", round(mse, 3))
    return mse, ssim_loss


def _eval_generation(args, sweep, model, d_cfg, denoiser, ds, sample_path, dev):
    """Temperature sweep: grids, metric batches and metrics.json."""
    feature_fn, space_info = get_feature_space(
        args.dataset_name, ds.train_images, ds.train_labels, ds.num_classes,
        mode=args.frozen_metrics, device=dev)

    real = ds.test_images[:args.ref_size]
    real_feats, _ = feature_fn(real)

    # when this eval's real set is the one the committed stats were pinned
    # from, its recomputed stats must equal them
    if space_info.get("frozen"):
        verified = verify_stats(load_frozen_stats(args.dataset_name), real, real_feats)
        if verified is False:
            raise RuntimeError(
                "frozen stats drifted (mu/sigma mismatch vs committed "
                "reference) — feature space not reproducible")
        if verified:
            space_info["stats_verified"] = True
            print("frozen reference stats verified")

    # FID between two halves of the real set: the floor of this space
    held = ds.test_images[args.ref_size: args.ref_size + len(real)]
    if len(held) >= 256:
        held_feats, _ = feature_fn(held)
        null_fid = round(fid_from_features(real_feats, held_feats), 4)
    else:
        half = len(real) // 2
        null_fid = round(fid_from_features(real_feats[:half], real_feats[half:]), 4)
    print(f"null FID (real vs real, n={len(real)}): {null_fid}")

    n_total = args.sample_batches * 16
    chunk = min(512, n_total)
    sampler_dtype = SAMPLER_DTYPES.get(
        args.sampler_dtype, torch.bfloat16 if args.bf16 else torch.float32)
    generator = torch.Generator(device=dev).manual_seed(args.seed + 1)

    results = {}
    last_gen01 = None
    for temp in sweep:
        t0 = time.time()
        chunks = []
        produced = 0
        while produced < n_total:
            codes = sample_codes(
                denoiser, d_cfg, chunk, temperature=temp, generator=generator,
                sample_steps=args.sample_steps, unmask_mode=args.unmask_mode,
                choice_temperature=args.choice_temperature, spacing=args.sample_spacing,
                device=dev, fused=FUSED[args.fused_sampler], dtype=sampler_dtype)
            chunks.append(model.decode_indices(codes))
            produced += chunk
        gen = torch.cat(chunks)[:n_total].cpu().numpy()  # [-.5, .5]
        for g in range(min(args.grid_batches, len(gen) // 32)):
            save_image_grid(gen[32 * g: 32 * g + 32],
                            os.path.join(sample_path, str(temp), f"image_{temp}_{g}.png"))
        gen01 = np.clip(gen + 0.5, 0, 1)
        feats, probs = feature_fn(gen01)
        entry = {"images_per_sec": round(len(gen) / (time.time() - t0), 1)}
        if args.metric in (None, "IS"):
            is_mean, _ = inception_score_from_probs(probs, splits=4)
            entry["IS"] = round(is_mean, 4)
        if args.metric in (None, "FID"):
            entry["FID"] = round(fid_from_features(feats, real_feats), 4)
        if args.metric in (None, "KID"):
            # unit-norm features, reported x 1e3 (the LeNet space's convention)
            kid_mean, _ = kid_from_features(
                real_feats, feats, subsets=10, subset_size=min(500, len(gen)),
                normalize="unit")
            entry["KID_x1e3"] = round(kid_mean * 1e3, 4)
        if args.metric in (None, "MODE"):
            mc = mode_coverage_kl(feature_fn, gen01, ds.num_classes)
            entry["mode_KL"] = round(mc["kl"], 4)
            entry["covered_modes"] = mc["covered_modes"]
        results[temp] = entry
        print(f"temp={temp}: {entry}")
        last_gen01 = gen01

    # showcase artifacts at the last temperature: per-class grids and the
    # one-per-class montage
    if args.metric in (None, "MODE"):
        per_class_grids(feature_fn, last_gen01, ds.num_classes,
                        os.path.join(sample_path, "classes"))
        paper_montage(feature_fn, last_gen01, ds.num_classes,
                      os.path.join(sample_path, "paper_image.png"), per_class=2)

    results["null_FID"] = null_fid
    results["feature_space"] = {
        "frozen": bool(space_info.get("frozen")),
        "name": space_info.get("name"),
        "sha256": space_info.get("space_sha", "")[:16],
        "stats_verified": bool(space_info.get("stats_verified", False)),
        "ref_size": int(len(real)),
    }
    with open(os.path.join(sample_path, "metrics.json"), "w") as f:
        json.dump(results, f, indent=2)
    print("metrics written to", os.path.join(sample_path, "metrics.json"))
    return results


def make_train_step_snn_vae():
    """A step ``(state, images (N, H, W, C) in [-0.5, 0.5], generator,
    p_scheduled) -> {"loss", "mmd", "rec"}`` of the SNN-VAE: loss =
    mmd_loss + recon_loss, BPTT, AdamW; updates ``state`` in place."""

    def train_step(state: TrainState, images: torch.Tensor, generator: torch.Generator,
                   p_scheduled: float):
        model = state.model
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        out = model(images, generator, p_scheduled=p_scheduled)
        loss = out["mmd_loss"] + out["recon_loss"]
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return {"loss": loss.detach(), "mmd": out["mmd_loss"].detach(),
                "rec": out["recon_loss"].detach()}

    return train_step


def scheduled_p(mode: str, epoch: int, epochs: int) -> float:
    """``--vae_scheduled_p``: 'off' 0, 'anneal' ``SNNVAEConfig``'s
    scheduled_start -> scheduled_end (0.1 -> 0.3) over the epochs, else
    the number given."""
    if mode == "anneal":
        cfg = SNNVAEConfig()
        return cfg.scheduled_start + (cfg.scheduled_end - cfg.scheduled_start) * epoch / max(
            epochs, 1)
    if mode == "off":
        return 0.0
    return float(mode)


def _run_snn_vae(args, model, ds, save_path, sample_path, dev) -> Dict[str, object]:
    """The SNN-VAE's path: train (or ``--checkpoint``), a sample grid,
    then IS, KID and FID of 40 x ``--batch_size`` samples against the
    first ``--ref_size`` test images. Returns the figures, the feature
    space and the seconds of each part (host clock, the card
    synchronised)."""
    state = create_train_state(model)
    generator = torch.Generator(device=dev).manual_seed(args.seed)
    seconds = {}
    t0 = _clock(dev)
    if args.checkpoint:
        restore_checkpoint(state, args.checkpoint, "model")
        print(f"loaded stage-1 checkpoint from {args.checkpoint}")
    else:
        step_fn = make_train_step_snn_vae()
        spe = ds.train_images.shape[0] // args.batch_size
        for epoch in range(args.epochs):
            p_sched = scheduled_p(args.vae_scheduled_p, epoch, args.epochs)
            for i, batch in enumerate(batch_iterator(ds.train_images, args.batch_size,
                                                     seed=args.seed, epoch=epoch)):
                m = step_fn(state, torch.from_numpy(batch - 0.5).to(dev), generator, p_sched)
                if (i + 1) % 20 == 0 or i + 1 == spe:
                    print(f"[{epoch}/{args.epochs}][{i}/{spe}]: "
                          f"loss {float(m['loss']):.3f} "
                          f"loss_eq {float(m['mmd']):.3f} "
                          f"loss_rec {float(m['rec']):.3f}")
            save_checkpoint(state, save_path, "model")
    seconds["train"] = _clock(dev) - t0

    t0 = _clock(dev)
    x, _ = model.sample(args.batch_size, generator)
    save_image_grid(x.cpu().numpy(), os.path.join(sample_path, "image.png"))
    gen = torch.cat([model.sample(args.batch_size, generator)[0]
                     for _ in range(SNN_VAE_SAMPLE_CALLS)]).cpu().numpy()
    gen = np.clip(gen + 0.5, 0, 1)
    seconds["sample"] = _clock(dev) - t0

    t0 = _clock(dev)
    feature_fn, space_info = get_feature_space(
        args.dataset_name, ds.train_images, ds.train_labels, ds.num_classes,
        mode=args.frozen_metrics, device=dev)
    feats, probs = feature_fn(gen)
    real_feats, _ = feature_fn(ds.test_images[:args.ref_size])
    is_mean, _ = inception_score_from_probs(probs, splits=4)
    kid_mean, _ = kid_from_features(real_feats, feats, subsets=10,
                                    subset_size=min(500, len(gen)), normalize="unit")
    fid = fid_from_features(feats, real_feats)
    sha = space_info.get("space_sha", "")[:16]
    print(f"IS = {is_mean:.4f}  KIDx1e3 = {kid_mean * 1e3:.4f}  "
          f"FID = {fid:.4f}  "
          f"[space {sha}{' frozen' if space_info.get('frozen') else ''}]")
    seconds["metrics"] = _clock(dev) - t0
    return {"IS": float(is_mean), "KID_x1e3": float(kid_mean * 1e3), "FID": float(fid),
            "feature_space": {"frozen": bool(space_info.get("frozen")),
                              "name": space_info.get("name"), "sha256": sha},
            "n_samples": int(len(gen)), "seconds": seconds}


if __name__ == "__main__":
    main()
