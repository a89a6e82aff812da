#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``spiking_diffusion_tpu_torch``) on one GPU.

Usage, from the root of a checkout, on a machine with an NVIDIA H100 and
the CUDA toolkit (``nvcc`` under ``$CUDA_HOME``, default /usr/local/cuda):

    python3 chip_smoke.py

Phases, each between a flushed ``phase <name> start`` / ``done in <s>`` line:

0. device: needs a CUDA device (exits non-zero without one); prints the
   card's name and power limit; turns TF32 off and cuDNN deterministic on,
   so that the kernel and plain runs compute the same convolutions.
1. build: compiles every CUDA source of the port (K1 forward, K1
   backward, K2, K3, K4) with ``nvcc`` (into ``build/``), all at once, and
   prints the build times and ``-Xptxas -v`` lines; K3's must show no
   function that spills and its twelve kernels (forward and backward, fp32
   and bf16, on three routes) at most 128 registers a thread (two blocks
   of 256 per SM); then the ``HMMA``
   (tensor-core) instructions of each K2 and K4 kernel in the built
   libraries' SASS (``cuobjdump -sass``): K2's conv and readout kernels
   in each weight type, and K4's five (bf16 forward and dx, bf16 dW,
   fp32 forward, fp32 dx, fp32 dW) must have some.
2. models: the full-width MNIST flagship (49-step sampler, T=16 denoiser
   64-128-256-512-256, K=128, then the VQ-VAE decode) with seeded random
   weights whose BN statistics are set from one batch; the card's logits
   and images are held against the same model on the CPU.
3. kernels: every kernel against its plain PyTorch version on the card, at
   the shapes its path gives it at batch 256, and timed beside the
   kernel's bound on an H100 (CUDA events, L2 flushed, each launch queued
   behind a spin kernel). K1 (LIF forward): bitwise, median of 20. K2 (the
   fused denoiser, tensor cores) in fp32, bf16 and int8: int8 bitwise;
   fp32 and bf16 at least 99 % of logits within 1e-4 and a median
   |difference| of at most 1e-6 (sums in another order can flip a spike at
   threshold); median of 5; and a ragged batch of 13; its bound is its
   operations over the bf16 tensor-core rate for fp32 (three bf16 products
   per product) and bf16, over the int8 rate for int8, with the CUDA-core
   and bf16-rate bounds logged beside; one call split by kernel
   (``torch.profiler``, the weight packing included), the host's time per
   call and per reverse step, and the peak memory of a call. K1 backward at the five LIF shapes of the
   training step: bitwise with atan; with sigmoid within rtol 1e-5, atol
   1e-6 (``expf`` against PyTorch's exp); other neuron settings bitwise.
   K3 forward and backward at the five block shapes (block 0 with T_in =
   1): spikes bitwise in fp32 and bf16, dy bitwise, dscale and dshift
   within rtol 1e-5 and equal from launch to launch (whether they are
   bitwise is logged). Median of 20; the share of its byte bound that
   each of the four per-step times (fwd, bwd; fp32, bf16) reaches is
   logged. The
   bounds of K1 and K3 are the bytes the call needs (each input read
   once, each output written once) over 3.35 TB/s. K4 (the training
   conv) forward and backward at the six conv shapes of a 'bnlifconv'
   training step, in fp32 and bf16, against its plain version at the
   JAX package's tolerances (y 1e-5, bf16 2e-2; s1, s2 rtol 1e-4, atol
   1e-3; dx, dW, db 1e-4), the sums' also widened by 1e-6 of the sum of
   their terms' absolute values (a sum of up to 200,704 terms in another
   order), s1, s2, dW and db equal from launch to launch; every fp32
   forward and backward (dW and dx) of the path's x (spikes, token ids,
   timesteps) must take the tensor-core route; the same x with one
   element off bf16's grid the CUDA-core route in the forward and dW, and
   with one inf in gy as well the CUDA-core route in dx, held at the same
   tolerances (with inf and NaN where the plain version has them);
   median of 10, beside its bound (operations over the peak of the type,
   or bytes; fp32's tensor-core routes do three bf16 products per
   product in the forward and dW and six in dx, so their bound counts
   those over the bf16 peak, logged beside the CUDA-core bound) and the
   library call (cuDNN: ``F.conv2d`` plus the two sums,
   ``aten.convolution_backward``); the backward also without dx, which
   splits it into its dW + db and dx parts (fp32 on both routes); and by
   kernel (``torch.profiler``) the fp32 forward's and backward's and the
   bf16 step's device time. K1 forward and backward (fp32) and K3 forward
   and backward (fp32 and bf16) at the M of stage 1's six LIF layers at
   batch 256 (the encoder's 14×14 and 7×7 blocks, the re-spike, the
   decoder's 14×14 and 28×28 blocks; T_in = 1 for the encoder's first
   block and the re-spike): bitwise, as above, timed beside their byte
   bounds (plain versions median of 5).
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
6. generation_bnlifconv: layerwise-sampler requests at batch 16 and 256
   through a 'bnlifconv' denoiser with the models' weights, in eval mode:
   exactly 6 K4-forward and 5 K3-forward launches per reverse step, no
   backward, 3 K1 launches (the decode), every K4 forward on the
   tensor-core route; valid codes and images. The
   share of codes equal to the layerwise fp32 request on the same noise
   is reported, not bounded.
7. train_stage1: the full-width VQ-VAE (seeded random weights, BN
   statistics set from one batch) trains on ``synthetic_dataset("MNIST")``
   images on each branch (layerwise on K1, 'bnlif' on K3), 4 fp32 steps
   at batch 32 and 4 at 256 and 4 bf16 steps at 256, with the launch
   counts reset just before: exactly 6 + 6 K1 launches per layerwise step
   and 6 + 6 K3 per 'bnlif' step, no other kernel; finite losses, convs in
   the step's dtype, the bf16 first loss within 5 % of fp32's. The first
   batch-32 step equals the same step through the plain versions on the
   card and agrees with the CPU (see below). One epoch of
   ``train_vqvae`` at batch 32 over 512 images, then
   ``extract_code_indices`` of the trained model over 1,000 images (a
   remainder batch of 232 included): 3 K1 (or K3) forward launches per
   batch of 256, codes equal to the plain versions' on the card, the share
   that agrees with the CPU's logged; ``encode_indices`` images/s at 256.
   Reports ms per step (CUDA events), the peak device memory, and one more
   step of each run by kernel (``torch.profiler``) with the share of the
   step the card was busy. Against the CPU the first step is held at the
   loss 1e-4 and gradients rtol 2e-3, atol 1e-3 (BN statistics at the CPU
   tests' tolerance), with at most 1e-4 of its spikes differing from the
   CPU's: cuDNN and the CPU sum a conv in another order, which flips a
   spike at threshold (STAGE1_CPU_*).
8. train_stage2: the full-width denoiser (seeded random weights) trains
   on the first 256 code grids that stage 1's ``extract_code_indices``
   made (layerwise branch), on each
   branch (layerwise on K1, 'bnlif' on K3, 'bnlifconv' on K4 and K3) at
   batch 32 and 256, a few AdamW steps each with the launch counts reset
   just before: exactly 5 + 5 K1 launches per layerwise step, 5 + 5 K3
   per 'bnlif' step, 6 + 6 K4 and 5 + 5 K3 per 'bnlifconv' step, no other
   kernel, every fp32 K4 forward, dW and dx on the tensor-core route;
   finite losses.
   The first step at batch 32 must equal the same step through the plain
   versions on the card on the layerwise and 'bnlif' branches (the same
   operations, with kernels bitwise their plain versions) and agree with
   the same step on the CPU at the CPU tests' tolerances: loss within
   1e-5, gradients within rtol 2e-3, atol 2e-4, new BN statistics within
   rtol 1e-5, atol 1e-6. On 'bnlifconv' the first step is held at those
   tolerances against the CPU and the 'bnlif' branch's step; against the
   plain versions on the card, whose conv sums in another order so that a
   spike at threshold flips, with the gradients at those tolerances, the
   loss within 5e-4 and the BN statistics within rtol 1e-5, atol 1e-4
   (CONV_*), with the number of elements outside each tolerance reported;
   and each K4 forward of that step against its plain version on its own
   inputs at K4's tolerances. One epoch of ``train_diffusion`` per
   branch. Then every branch in bf16 at batch 256: the same launch
   counts, every conv's input (spikes) and output in bf16, finite losses,
   the first loss within 5 % of the branch's fp32 first loss on the same
   corruption. Reports ms per step (CUDA events) and the peak device
   memory.

9. trained_weights: the committed trained weights
   (``result_torch/MNIST/snn-vq-vae``, exported from the JAX package's
   60 + 120 epoch flagship run) load with ``weights_only=True`` into the
   full-width modules, strictly. The CLI's ``_eval_recon`` over 1,024
   synthetic test images in fp32 on the card (exactly 6 K1 launches per
   batch of 256) and on the CPU: MSE and 1 - SSIM within 1e-4 (stage 1's
   card-against-CPU loss tolerance); the share of ``encode_indices`` codes
   that agree between the card and the CPU is logged. At batch 256 on one
   set of per-step noise the layerwise fp32 sampler and the fused one in
   fp32, bf16 and int8 (49 K2 launches each) give valid codes and images,
   the share of codes equal to the layerwise ones logged; K2 on the
   trained weights against its plain version at the kernels phase's bounds
   on the first reverse step (all masked, t = 49) and on a half-masked
   grid at t = 25, at batch 256 and at the CLI's chunk of 512, with the
   share of fused fp32 logits within 1e-5 of the layerwise ones logged;
   every K1 launch of the CLI eval's bf16 decode of a 512-grid chunk, of a
   recon batch of 256 and of the codes' remainder batch held bitwise
   against the plain version.
10. syops: the op/energy profiler (``profiling/``) on the trained weights,
   a ``DeviceMonitor`` sampling the card's memory across the phase (some
   sample above 0 bytes). The VQ-VAE in fp32, in eval, on 'auto' (exactly
   6 K1 launches a forward, no other kernel) and 'bnlif' (6 K3): on the
   first 32 test images as the CLI loads them, its counters held to the
   JAX package's record of the same images and weights
   (``profiling/assets/syops_e60_jax.json``, ``scripts/syops_jax_record.py``),
   and on the first 256 to the port's counters on the CPU: the same 19
   keys, ops and MACs equal, every rate within 1e-4, ACs within 1e-4 of the
   layer's ops (a conv summed in another order may flip a spike), the same
   parameter count. The denoiser at the 5 default probes of 64 grids
   sampled at 0.8, on 'auto' (5 K1 a forward) and 'bnlif' (5 K3), the
   totals of the branches held alike. ``generation_energy`` at 64 samples
   on the layerwise sampler (exactly 245 + 25 + 3 K1 launches): finite,
   positive, the spike rate in (0, 1). Then no hook is left on any model,
   and a layerwise sample at 16 launches what it did before the profiles,
   with the same codes. ``benchmark`` times the VQ-VAE's eval forward at
   256 with and without profiling (CUDA events); ``trace`` of one forward
   per branch names ``lif_fwd_kernel`` (6 times) or ``bn_lif_fwd_kernel``
   (6) and not the other branch's kernel.
11. cli: ``cli.main(..., device="cuda")`` three times in a temporary
   directory, the launch counts reset just before each and held exactly to
   what the flags give (``cli_launches``): a training run (1 + 2 epochs
   over 512 images at batch 32, 'bnlif' stage 2, a 256-image sweep at 0.8
   on fp32 K2, ``--syops``) whose artifact tree and metrics.json keys are
   the JAX CLI's and whose output holds the ``--syops`` report (19 rows,
   TOTAL, parameters and the three summary lines); then the eval of the trained weights with the JAX record's flags
   (``--bf16 --batch_size 256``, 60,000 + 10,240 synthetic images, 8,192
   reference images, temperatures 0.8 and 1.0 of 1,280 images each on bf16
   K2): K1 and K2 only, the frozen stats verified, the space's sha
   ``fa7286439409571c``, the null FID within 0.01 of the record's 12.676,
   10 modes covered at both temperatures, FID at 0.8 under twice the
   record's 46.5738; every number logged beside the record's. Then the
   gate: the same eval at 0.8 over 8,192 generated images, exact launches,
   10 modes and FID under ``FID_GATE_BOUND``.
12. cli_vq_vae: ``--model vq-vae`` (the ANN VQ-VAE, no kernel in stage 1)
   through ``cli.main`` twice, the launches held exactly: a training run
   with the cli phase's flags (K3 in stage 2, fp32 K2 in the sweep, no K1)
   whose ``--syops`` report has no layer row, as the JAX CLI's for that
   model; then the eval of the exported baseline
   (``result_torch/MNIST/vq-vae``) with its record's flags (fp32,
   ``--batch_size 256``, 60,000 + 10,240 synthetic images, 8,192
   reference images, 0.8 and 1.0 of 1,280 images): frozen stats verified,
   null FID within 0.01 of 12.676, 10 modes, FID at 0.8 under twice the
   record's 172.406, every figure logged beside the record's. Its recon
   of 1,024 images on the card and the CPU: MSE and 1 - SSIM within 1e-4,
   the codes that differ counted. K2 against its plain version on the
   baseline's denoiser at the eval's chunk of 512 (first step and t = 25,
   every dtype). FID at 1.0 alone through ``cli._eval_generation`` on the
   eval's data for seeds 42-44 on fused fp32 and ``--bf16`` and seed 42 on
   the layerwise sampler (stats verified, K2 launches exact, figures
   logged): whether the distance from the record follows the kernel, the
   arithmetic or the draw.
13. cli_snn_vae: ``--model snn-vae`` on the card. Every K1 launch of a
   training step at batch 32 and 256 (the latent head's (16, N·56) and the
   decoder input's (16, N·784) among them), forward and backward, bitwise
   against the plain versions; a CLI training run with ``--vae_scheduled_p
   anneal`` (exactly 7 + 7 K1 a step and 3 K1 a sample call; ``model.pt``
   and ``image.png``); 4 steps of the exported baseline at batch 32 and
   256 on 'auto' (7 + 7 K1 a step) and 'bnlif' (5 + 5 K3 and 2 + 2 K1),
   ms per step by CUDA events, one more step by kernel, the first step at
   32 equal to the plain versions' on the card; ``sample`` of 64 on one
   injected choice on both branches (3 K1; 'bnlif' 1 K1 + 2 K3), card
   against CPU: z equal, images within 1e-4; the
   eval of the exported baseline with its record's flags (10,240 samples,
   8,192 reference images), IS, KID and FID logged beside the record's
   8.98 and 801.5.
14. metrics_extra: InceptionV3 of seeded weights (BN statistics from 4
   calibration images) at 299 on 8 images in both pipelines, card against
   CPU within 1e-4 of the largest output, and its forward time;
   ``clean_resize`` of 64 uint8 images card against CPU within 1e-5; the
   freeze protocol at canonical sizes (60,000 + 10,240 images, 5 epochs)
   into a temporary root, read back in mode 'on' and its stats verified
   by the CLI's rule (``frozen.verify_stats``), with its seconds.

The last lines are a JSON line of per-kernel numbers, the card's
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": ...}``.
Any failure prints its traceback and exits non-zero without that line.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import io
import json
import math
import os
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from spiking_diffusion_tpu_torch import cli
from spiking_diffusion_tpu_torch.config import DiffusionConfig, SNNVAEConfig, VQVAEConfig
from spiking_diffusion_tpu_torch.data import data_variance, load_dataset, synthetic_dataset
from spiking_diffusion_tpu_torch.generate import sample_codes
from spiking_diffusion_tpu_torch.metrics import cleanfid, frozen, inception
from spiking_diffusion_tpu_torch.models import diffusion, weights
from spiking_diffusion_tpu_torch.models.ann_vqvae import ANNVQVAE
from spiking_diffusion_tpu_torch.models.denoiser import SpikingDenoiser
from spiking_diffusion_tpu_torch.models.layers import LIF, SeqConv
from spiking_diffusion_tpu_torch.models.snn_vae import SNNVAE
from spiking_diffusion_tpu_torch.models.vqvae import SNNVQVAE
from spiking_diffusion_tpu_torch.ops import _build
from spiking_diffusion_tpu_torch.ops import bn_lif as bnl
from spiking_diffusion_tpu_torch.ops import fused_denoiser as fd
from spiking_diffusion_tpu_torch.ops import lif as lif_op
from spiking_diffusion_tpu_torch.ops import spike_conv as sc
from spiking_diffusion_tpu_torch.profiling import benchmark, monitor, syops, trace
from spiking_diffusion_tpu_torch.snn import surrogate
from spiking_diffusion_tpu_torch.snn.neuron import NeuronParams
from spiking_diffusion_tpu_torch.train import stage1, stage2
from spiking_diffusion_tpu_torch.train.state import create_train_state

BUDGET_S = 900  # the whole run, the build included
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
BATCH = 256  # batch of the kernel shapes and of the large request
REQUESTS = (16, 16, 16, 256)  # 16 is the reference's per-call batch
FUSED_REQUESTS = (3, 0, 1)  # indices into REQUESTS: batch 256, 16, 16
BNLIFCONV_REQUESTS = (0, 3)  # batch 16, 256
T = 16
TIMING_REPS = 20
K2_TIMING_REPS = 5
K2_RAGGED = 13
# peak rate of the work's type on an H100 SXM (NVIDIA data sheet, dense):
# fp32 on the CUDA cores, bf16 and int8 on the tensor cores
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12, torch.int8: 1979e12}
# K4's fp32 tensor-core routes: three bf16 products per product in the
# forward and dW (x exact in bf16, three planes of the other operand), six
# in dx (the plane products of g and the weight that it keeps)
K4_FP32_PLANES = 3
K4_FP32_DX_TERMS = len(sc.DX_TERMS)
# the five tensor-core kernels of K4 by what they run, as their SASS names
# them: conv_mma_kernel<Out, terms>, wgrad_mma_kernel<g planes>
K4_MMA_KERNELS = {"bf16 forward and dx": "conv_mma_kernelI13__nv_bfloat16Li1E",
                  "bf16 dW": "wgrad_mma_kernelILi1E", "fp32 forward": "conv_mma_kernelIfLi3E",
                  "fp32 dx": "conv_mma_kernelIfLi6E", "fp32 dW": "wgrad_mma_kernelILi3E"}
K2_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
K2_STEP_LAUNCHES = 49  # one per reverse step
K1_DECODE_LAUNCHES = 3
K2_NEAR = 1e-4  # fp32/bf16: at least K2_NEAR_SHARE of logits within this
K2_NEAR_SHARE = 0.99
K2_MEDIAN = 1e-6
SPIN_CYCLES = 2_000_000  # ~1 ms of device time at the H100's clock
LIF_LAUNCHES_PER_BATCH = 5 * 49 + 3  # 5 LIF layers x 49 steps + 3 in decode
K1_REPLACES = "spiking_diffusion_tpu/ops/pallas_lif.py:129"
K1_BWD_REPLACES = "spiking_diffusion_tpu/ops/pallas_lif.py:141"
K2_REPLACES = "spiking_diffusion_tpu/ops/fused_denoiser.py:828"
K3_FWD_REPLACES = "spiking_diffusion_tpu/ops/bn_lif.py:243"
K3_BWD_REPLACES = "spiking_diffusion_tpu/ops/bn_lif.py:253"
K4_FWD_REPLACES = "spiking_diffusion_tpu/ops/spike_conv.py:311"
K4_BWD_REPLACES = "spiking_diffusion_tpu/ops/spike_conv.py:322"
K4_TIMING_REPS = 10
# K4 against its plain version: the JAX package's tolerances for its kernel
# against XLA's conv (tests/test_spike_conv.py); the sums run in another order
K4_Y_TOL = {"fp32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}
K4_MOMENT_TOL = dict(rtol=1e-4, atol=1e-3)
K4_GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
# s1, dW, dx and db are sums of up to 200,704 terms: a sum in another order
# may also differ by this share of the sum of the terms' absolute values
# (~17 fp32 roundings of it), which matters where the terms cancel, as
# with block 0's inputs (token ids and timesteps up to 128)
K4_SUM_SHARE = 1e-6
K4_PER_STEP = 6  # five blocks and the readout
K4_DX_PER_STEP = 5  # block 0's input is the token map: no dx
K3_PER_STEP = 5
SIGMOID_TOL = dict(rtol=1e-5, atol=1e-6)  # expf against PyTorch's exp
K3_SUM_RTOL = 1e-5  # dscale, dshift: per-channel sums of 12,544 x 16 terms
# forward and backward in fp32 and bf16 on each of three routes (the path's,
# registers, scratch)
K3_KERNELS = 12
K3_MAX_REGISTERS = 128  # two blocks of 256 threads per SM
TRAIN_BATCHES = (32, 256)  # the CLI's default batch (cli.py:91), the kernels'
TRAIN_STEPS = 4
TRAIN_BRANCHES = {"layerwise": ("auto", "torch"), "bnlif": ("bnlif", "bnlif_torch"),
                  "bnlifconv": ("bnlifconv", "bnlifconv_torch")}
BF16_LOSS_RTOL = 0.05  # bf16 first loss against fp32 (tests/test_bf16.py's bound)
# launches per training step: K1 fwd, K1 bwd, K3 fwd, K3 bwd, K2, K4 fwd, K4 bwd
STEP_LAUNCHES = {"layerwise": (5, 5, 0, 0, 0, 0, 0), "bnlif": (0, 0, 5, 5, 0, 0, 0),
                 "bnlifconv": (0, 0, 5, 5, 0, 6, 6)}
LOSS_ATOL = 1e-5  # the CPU tests' tolerances (tests/test_torch_stage2.py)
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)
STATS_TOL = dict(rtol=1e-5, atol=1e-6)
# 'bnlifconv' at full width: K4 sums in another order than its plain
# version's torch.matmul, so a membrane within rounding of its threshold
# flips and the flip carries through the later blocks: one block-0 neuron
# a rounding above threshold in fp64, and in K4's, the CPU's and cuDNN's
# sums, lies below it in the plain version's on the card, which moves the
# loss by 1.56e-4 and the running statistics of the blocks after it by up
# to 3.25e-5 beyond rtol 1e-5 (chip runs, NVIDIA H100 80GB HBM3, 700 W).
# That one comparison allows the loss 5e-4 and the BN statistics atol 1e-4,
# elementwise, with gradients at GRAD_TOL; the step is held at the CPU
# tests' tolerances against the CPU and the 'bnlif' branch's step, and each
# K4 forward of the step against its plain version on its own inputs at
# K4's tolerances (check_k4_in_step)
CONV_LOSS_ATOL = 5e-4
CONV_STATS_TOL = dict(rtol=1e-5, atol=1e-4)
# stage 1 (the VQ-VAE): launches per training step (3 encoder blocks, the
# re-spike, 2 decoder blocks) and per encode_indices batch (the encoder), as
# STEP_LAUNCHES counts them
STAGE1_BRANCHES = {"layerwise": ("auto", "torch"), "bnlif": ("bnlif", "bnlif_torch")}
STAGE1_STEP_LAUNCHES = {"layerwise": (6, 6, 0, 0, 0, 0, 0), "bnlif": (0, 0, 6, 6, 0, 0, 0)}
STAGE1_ENCODE_LAUNCHES = {"layerwise": (3, 0, 0, 0, 0, 0, 0), "bnlif": (0, 0, 3, 0, 0, 0, 0)}
STAGE1_IMAGES = 1000  # extract_code_indices over 1000: 3 batches of 256 and one of 232
STAGE1_EPOCH_IMAGES = 512  # one train_vqvae epoch at batch 32: 16 steps
STAGE1_PLAIN_REPS = 5  # the plain LIF loops at stage 1's largest M take ~0.1 s a call
# The first stage-1 step on the card against the CPU. cuDNN and the CPU sum
# the encoder's second conv in another order, which puts one of the 1.6 M
# spikes of its LIF layer on the other side of the threshold at batch 32;
# the flip spreads to 7 of the 0.4 M spikes of the next block, which move
# the readout and the commitment losses (loss |d| 3.22e-5, gradients up to
# 4.1e-4, 30 of 50,658 elements beyond atol 2e-4; BN statistics within the
# CPU tests' tolerance; chip runs, NVIDIA H100 80GB HBM3, 700 W). The kernels are held bitwise against their plain
# versions on the card (the same step is equal there); against the CPU the
# loss is held within 1e-4, the gradients at rtol 2e-3, atol 1e-3, the BN
# statistics at the CPU tests' tolerance, and at most STAGE1_FLIP_SHARE of
# the step's spikes may differ from the CPU's
STAGE1_CPU_LOSS_ATOL = 1e-4
STAGE1_CPU_GRAD_TOL = dict(rtol=2e-3, atol=1e-3)
STAGE1_FLIP_SHARE = 1e-4
LOGIT_ATOL = 5e-5  # card vs CPU: fp32 convolutions summed in another order
IMAGE_ATOL = 1e-5
# the committed trained weights (scripts/export_torch_weights.py from the
# JAX package's 60 + 120 epoch MNIST flagship run)
TRAINED = Path(__file__).resolve().parent / "result_torch" / "MNIST" / "snn-vq-vae"
TRAINED_IMAGES = 1024  # recon and codes, card against CPU
TRAINED_STEP_NOISE_SEED = 7
K2_AGREE_ATOL = 1e-5  # logged: the fused logits' share within this of the layerwise ones
# the CLI on the card: a short training run, then the eval of the trained
# weights with the flags of the JAX record (--bf16 --batch_size 256, the
# canonical 60,000 + 10,240 synthetic set, 8,192 reference images)
CLI_TRAIN_FLAGS = ["--epochs", "1", "--batch_size", "32", "--synthetic_train", "512",
                   "--synthetic_test", "2560", "--ref_size", "1280", "--temperatures", "0.8",
                   "--sample_batches", "16", "--grid_batches", "1", "--frozen_metrics", "on",
                   "--syops"]
CLI_EVAL_FLAGS = ["--checkpoint", str(TRAINED), "--bf16", "--batch_size", "256",
                  "--synthetic_train", "60000", "--synthetic_test", "10240", "--ref_size",
                  "8192", "--frozen_metrics", "on", "--temperatures", "0.8,1.0"]
# the JAX package's record of the same eval on a TPU
# (sample_r5_e60/MNIST/snn-vq-vae/metrics.json; quality, not speed)
JAX_RECORD = {"0.8": {"IS": 9.653, "FID": 46.5738, "KID_x1e3": 3.6892, "mode_KL": 0.0177,
                      "covered_modes": 10},
              "1.0": {"IS": 9.4662, "FID": 82.7092, "KID_x1e3": 11.1061, "mode_KL": 0.0356,
                      "covered_modes": 10},
              "null_FID": 12.676, "sha256": "fa7286439409571c"}
NULL_FID_ATOL = 0.01
# a band that catches a broken sampler or decode (FIDs in the hundreds, as
# the record's own near-zero temperatures give), not a parity check: the
# record's spread is wide (its int8 run 36.05 at 0.8, 59.4-82.7 at 1.0-1.2)
FID_08_BOUND = 2 * JAX_RECORD["0.8"]["FID"]
# the gate on the eval's quality: FID at 0.8 over 8,192 generated images
# (--sample_batches 512) of the trained weights on the eval's path. One
# draw of 1,280 images spreads too widely to tell a sound sampler from an
# unsound one (8 seeds: 55.2-125.7); over 8,192 images the eval's bf16
# sampler read 60.9, 69.4 and 65.3 (seeds 42-44), int8 57.5 and 59.8, the
# layerwise bf16 denoiser 65.9, and exact fp32 arithmetic, fused or
# layerwise, 93.9-103.0 (PERF.md section 6): the bound sits between the two
CLI_GATE_FLAGS = CLI_EVAL_FLAGS[:-2] + ["--temperatures", "0.8", "--sample_batches", "512"]
FID_GATE_BOUND = 80.0
# the op/energy profiler on the trained VQ-VAE: the JAX package's counts of
# its first 32 test images (scripts/syops_jax_record.py), the card's held to
# them and to the CPU's: ops and MACs exactly, each rate within 1e-4 and the
# ACs within 1e-4 of the layer's ops (a conv summed in another order may
# put a membrane on the other side of its threshold)
SYOPS_RECORD = (Path(__file__).resolve().parent / "spiking_diffusion_tpu_torch" / "profiling"
                / "assets" / "syops_e60_jax.json")
SYOPS_RECORD_IMAGES = 32  # the CLI's default --batch_size
SYOPS_RATE_ATOL = 1e-4
SYOPS_ACS_SHARE = 1e-4
SYOPS_SAMPLES = 64  # generation_energy's default
SYOPS_LAYERS = 19  # the VQ-VAE's counted layers: 3 x 3 encoder, 3 re-spike, 7 decoder
# launches of one eval forward, as launch_counts() orders them
SYOPS_VQ_LAUNCHES = {"auto": (6, 0, 0, 0, 0, 0, 0), "bnlif": (0, 0, 6, 0, 0, 0, 0)}
SYOPS_DEN_LAUNCHES = {"auto": (5, 0, 0, 0, 0, 0, 0), "bnlif": (0, 0, 5, 0, 0, 0, 0)}
SYOPS_TIMING_ITERS = 10
SYOPS_SAMPLE_BATCH = 16  # the layerwise sample held before and after the profiles
SYOPS_MONITOR_S = 0.5
# the trace names each branch's neuron kernel (bn_lif_fwd_kernel also
# contains lif_fwd_kernel)
TRACE_KERNELS = {"auto": re.compile(r"(?<!bn_)lif_fwd_kernel"),
                 "bnlif": re.compile(r"bn_lif_fwd_kernel")}
# the paper's two baselines: the exported weights of the JAX package's
# round-3 MNIST runs (scripts/export_torch_weights.py)
BASELINES = Path(__file__).resolve().parent / "result_torch" / "MNIST"
# the JAX package's record of the ANN VQ-VAE's eval on a TPU, in fp32
# (sample_r3/MNIST/vq-vae/metrics.json; quality, not speed)
VQ_VAE_RECORD = {"0.8": {"IS": 9.2838, "FID": 172.406, "mode_KL": 0.0444, "covered_modes": 10},
                 "1.0": {"IS": 9.3644, "FID": 124.7888, "mode_KL": 0.0281, "covered_modes": 10},
                 "null_FID": 12.676, "sha256": "fa7286439409571c"}
VQ_VAE_FID_08_BOUND = 2 * VQ_VAE_RECORD["0.8"]["FID"]  # phase cli's band for e60
# the SNN-VAE's run in the same frozen space (STATUS_r3.md:64)
# the vq-vae eval's FID at 1.0 against the record's: its one eval draw
# again (--temperatures 1.0 alone), on other draws, on the layerwise
# sampler (no K2) and in bf16, through the CLI's own evaluation
VQ_VAE_GAP_SEEDS = (42, 43, 44)
VQ_VAE_GAP_RUNS = ([(f"fused fp32, seed {s}", ["--seed", str(s)]) for s in VQ_VAE_GAP_SEEDS]
                   + [("layerwise fp32, seed 42", ["--seed", "42", "--fused_sampler", "off"])]
                   + [(f"fused bf16, seed {s}", ["--seed", str(s), "--bf16"])
                      for s in VQ_VAE_GAP_SEEDS])
SNN_VAE_RECORD = {"FID": 801.5, "IS": 8.98}
CLI_VQ_TRAIN_FLAGS = ["--model", "vq-vae"] + CLI_TRAIN_FLAGS
CLI_VQ_EVAL_FLAGS = ["--model", "vq-vae", "--checkpoint", str(BASELINES / "vq-vae"),
                     "--batch_size", "256", "--synthetic_train", "60000", "--synthetic_test",
                     "10240", "--ref_size", "8192", "--frozen_metrics", "on",
                     "--temperatures", "0.8,1.0"]
CLI_SNN_TRAIN_FLAGS = ["--model", "snn-vae", "--epochs", "1", "--batch_size", "32",
                       "--synthetic_train", "512", "--synthetic_test", "2560", "--ref_size",
                       "1280", "--vae_scheduled_p", "anneal", "--frozen_metrics", "on"]
CLI_SNN_EVAL_FLAGS = ["--model", "snn-vae", "--checkpoint", str(BASELINES / "snn-vae"),
                      "--batch_size", "256", "--synthetic_train", "60000", "--synthetic_test",
                      "10240", "--ref_size", "8192", "--frozen_metrics", "on"]
SNN_VAE_BRANCHES = {"layerwise": ("auto", "torch"), "bnlif": ("bnlif", "bnlif_torch")}
# launches of an SNN-VAE training step (encoder 3, the heads 2, decoder 2)
# and of a sample call (the decoder input, decoder 2), as launch_counts() orders them
SNN_VAE_STEP_LAUNCHES = {"layerwise": (7, 7, 0, 0, 0, 0, 0), "bnlif": (2, 2, 5, 5, 0, 0, 0)}
SNN_VAE_SAMPLE_LAUNCHES = {"layerwise": (3, 0, 0, 0, 0, 0, 0), "bnlif": (1, 0, 2, 0, 0, 0, 0)}
SNN_VAE_SAMPLE_CHECK = 64  # images of the sample held card against CPU
SNN_VAE_SAMPLE_ATOL = 1e-4
INCEPTION_CALIBRATION = 4  # images whose batch statistics set the seeded net's BN
INCEPTION_IMAGES = 8
INCEPTION_REPS = 5
INCEPTION_RTOL = 1e-4  # of the largest output: the CPU tests' tolerance against JAX
RESIZE_ATOL = 1e-5
FREEZE_SIZES = (60000, 10240)  # the canonical freeze protocol's sets


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


def sass_hmma(path) -> dict:
    """{kernel: HMMA instructions} of a built library's SASS (``cuobjdump``
    beside ``nvcc``), the kernels without any included as 0."""
    cuobjdump = str(Path(_build.nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            counts[name] = 0
        elif name is not None and "HMMA" in line:
            counts[name] += 1
    return counts


def ptxas_usage(log: str) -> dict:
    """{function: (registers, spill store bytes, spill load bytes)} from a
    build's ``-Xptxas -v`` lines (registers 0 where ptxas gives none, as
    for a device function)."""
    usage, name = {}, None
    for line in log.splitlines():
        found = re.search(r"Function properties for (\S+)", line)
        if found:
            name = found.group(1)
            usage[name] = (0, 0, 0)
            continue
        found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if found and name is not None:
            usage[name] = (usage[name][0], int(found.group(1)), int(found.group(2)))
            continue
        found = re.search(r"Used (\d+) registers", line)
        if found and name is not None:
            usage[name] = (int(found.group(1)), *usage[name][1:])
    return usage


def check_k3_registers(built) -> dict:
    """K3's build from its ptxas lines: no function spills, and each of the
    K3_KERNELS kernels takes at most K3_MAX_REGISTERS a thread (two blocks
    of 256 threads per SM)."""
    if not built.log:
        log("  K3 built before this run: no ptxas lines to check")
        return {}
    usage = ptxas_usage(built.log)
    for name, (regs, stores, loads) in usage.items():
        log(f"  K3 ptxas: {regs:3d} registers, spills {stores}/{loads} bytes: {name}")
        check(stores == 0 and loads == 0, f"K3 function {name} spills")
    kernels = {n: u[0] for n, u in usage.items() if re.search(r"bn_lif_(fwd|bwd)_kernel", n)}
    check(len(kernels) == K3_KERNELS, f"ptxas reports {len(kernels)} K3 kernels, "
          f"not {K3_KERNELS}")
    for name, regs in kernels.items():
        check(regs <= K3_MAX_REGISTERS, f"K3 kernel {name} takes {regs} registers")
    return kernels


def lif_bound_ms(nbytes: float) -> float:
    """Bytes over the HBM rate: the bound of the LIF kernels (K1, K3), whose
    few fp32 operations per byte put them far below the card's fp32 rate."""
    return nbytes / HBM_BYTES_PER_S * 1e3


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


def compare_lif(x, v_init, params, rate_range=(0.05, 0.95)) -> float:
    """K1's forward against its plain version, bitwise; with ``rate_range``
    the firing rate must lie inside it (a random input that spikes)."""
    s, v = lif_op.lif_fwd(x, v_init, params)
    s_ref, v_ref = lif_op.lif_fwd_reference(x, v_init, params)
    torch.cuda.synchronize()
    rate = float(s_ref.mean())
    if rate_range:
        check(rate_range[0] < rate < rate_range[1],
              f"firing rate {rate} outside {rate_range}")
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
        bound = lif_bound_ms((2 * T + 1) * m * 4)  # x read, s and v_T written
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


def wall_ms(fn, reps: int = 5) -> float:
    """Median host ms of ``fn`` from a synchronised start; with ``sync``
    false in ``fn`` it is the time to enqueue."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def k2_split(den, dcfg, dtype, a1, folded, gen) -> dict:
    """One K2 call at batch 256 by kernel: {kernel: [device ms, launches]}
    (``torch.profiler``; the weight packing's PyTorch kernels included); the
    host's ms to enqueue a call (the packing runs there); one reverse step's
    denoise function (folding, first conv, K2) to its end, and the folding
    and first conv alone (medians of 5); and the peak device memory a K2
    call adds (MiB)."""
    profile = kernel_profile(lambda: fd.fused_denoise(a1, folded, dcfg))
    host_ms = wall_ms(lambda: fd.fused_denoise(a1, folded, dcfg))
    h = dcfg.latent_size
    tokens = torch.randint(0, dcfg.num_embeddings + 1, (BATCH, h, h), generator=gen,
                           device="cuda")
    t = torch.randint(1, dcfg.num_timesteps + 1, (BATCH,), generator=gen, device="cuda")
    denoise = fd.make_fused_denoise_fn(den, dcfg, dtype)

    def fold():
        f = fd.fold_denoiser_weights(den, dtype)
        return fd.first_preactivation(tokens, t, f.k1, f.b1)

    def step():
        denoise(tokens, t)
        torch.cuda.synchronize()

    fold_ms = wall_ms(lambda: (fold(), torch.cuda.synchronize()))
    step_ms = wall_ms(step)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fd.fused_denoise(a1, folded, dcfg)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    return {"profile": profile, "host_ms": host_ms, "fold_ms": fold_ms, "step_ms": step_ms,
            "peak_mib": peak}


def phase_k2(den, dcfg, gen: torch.Generator, flush: torch.Tensor, card: str) -> dict:
    """K2 against its plain version at batch 256 and 13 in each weight type,
    timed beside its bounds. The route does bf16 products on the tensor
    cores: three per product for fp32 weights (exact planes), one for bf16
    and int8 (int8 values are exact in bf16). ``bound_ms`` is the work's
    operations over the peak of its type (fp32: three bf16 products per
    product); the CUDA-core bound (fp32) and the bf16-rate bound (int8) are
    logged beside."""
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
        planes = fd.planes_of(dtype)
        ops_ms = planes * useful / PEAK_OPS[torch.bfloat16 if planes == 3 else dtype] * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        bound = max(ops_ms, bytes_ms)
        # beside it: fp32 on the CUDA cores, int8 at the bf16 rate it runs at
        other_dtype = {torch.float32: torch.float32, torch.int8: torch.bfloat16}.get(dtype)
        other_ms = useful / PEAK_OPS[other_dtype] * 1e3 if other_dtype else None
        split = k2_split(den, dcfg, dtype, a1, folded, gen)
        rows[name] = {"ms": ms, "plain_ms": plain, "bound_ms": bound,
                      "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                      "max_abs_err": max_err, "useful_tflop": useful / 1e12,
                      "tflops": useful / ms / 1e9, "share_of_bound": bound / ms,
                      "bf16_products_tflops": planes * executed / ms / 1e9,
                      **({"bound_cuda_cores_ms" if dtype == torch.float32
                          else "bound_bf16_rate_ms": other_ms} if other_ms else {}),
                      **split}
        log(f"  K2 {name} batch {BATCH}: kernel {ms:.3f} ms, plain {plain:.3f} ms, "
            f"bound {bound:.3f} ms ({rows[name]['bound_by']}: {useful / 1e12:.4f} "
            f"TFLOP useful x {planes} bf16 products at "
            f"{PEAK_OPS[torch.bfloat16 if planes == 3 else dtype] / 1e12:g} TFLOP/s; "
            f"{nbytes / 1e6:.1f} MB at 3.35 TB/s = {bytes_ms:.4f} ms)"
            + (f", {'CUDA-core' if dtype == torch.float32 else 'bf16-rate'} bound "
               f"{other_ms:.3f} ms" if other_ms else "")
            + f", kernel at {bound / ms:.2%} of bound, {useful / ms / 1e9:.2f} TFLOP/s useful "
            f"({planes * executed / ms / 1e9:.2f} of bf16 products counting all 9 taps); per "
            f"generated batch (49 calls) {49 * ms:.1f} ms, bound {49 * bound:.1f} ms [{card}]")
        for kname, (kms, count) in sorted(split["profile"].items(), key=lambda kv: -kv[1][0]):
            log(f"    {kname}: {kms:.3f} ms device, {count} launches")
        log(f"    host: enqueue of a K2 call (packing included) {split['host_ms']:.3f} ms; "
            f"folding + first conv to their end {split['fold_ms']:.3f} ms; one reverse "
            f"step's denoise function to its end {split['step_ms']:.3f} ms; peak memory of "
            f"a K2 call {split['peak_mib']:.1f} MiB")
    return rows


def train_lif_shapes():
    """(name, M) of the five LIF layers of a training step at batch 256."""
    return [(f"denoiser_lif{i + 1}_C{c}", BATCH * 49 * c)
            for i, c in enumerate(DiffusionConfig().denoiser_channels)]


def compare_lif_bwd(x, v_init, gs, params, need_dv0) -> float:
    dx, dv = lif_op.lif_bwd(x, v_init, gs, params, need_dv0)
    dx_ref, dv_ref = lif_op.lif_bwd_reference(x, v_init, gs, params, need_dv0)
    torch.cuda.synchronize()
    check(float(dx_ref.abs().max()) > 0.1, "K1 bwd: vanishing reference gradient")
    check((dv is None) == (dv_ref is None) == (not need_dv0), "K1 bwd: dV0 when not asked")
    err = 0.0
    for what, got, want in (("dX", dx, dx_ref), ("dV0", dv, dv_ref)):
        if want is None:
            continue
        if params.surrogate.name == "sigmoid":
            torch.testing.assert_close(got, want, **SIGMOID_TOL)
        else:
            check(torch.equal(got, want), f"K1 bwd {what} differs from the plain version")
        err = max(err, float((got - want).abs().max()))
    return err


def phase_k1_bwd(gen: torch.Generator, flush: torch.Tensor) -> dict:
    params = NeuronParams()
    max_err = 0.0
    rows = []
    for name, m in train_lif_shapes():
        x = lif_input(m, gen)
        gs = torch.randn((T, m), generator=gen, device="cuda")
        # the training path's call: no v_init (no v0 read), no dV0 written
        max_err = max(max_err, compare_lif_bwd(x, None, gs, params, False))
        ms = cuda_ms(lambda: lif_op.lif_bwd(x, None, gs, params, False), flush)
        plain = cuda_ms(lambda: lif_op.lif_bwd_reference(x, None, gs, params, False), flush)
        bound = lif_bound_ms(3 * T * m * 4)  # x and gs read, dX written
        rows.append({"shape": name, "T": T, "M": m, "ms": ms, "plain_ms": plain,
                     "bound_ms": bound})
        log(f"  K1 bwd {name:20s} T={T} M={m:9d}: kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, bound {bound:.4f} ms (bytes), kernel at "
            f"{bound / ms:.1%} of bound, bitwise equal")
    m = BATCH * 49 * 64 + 7
    x = lif_input(m, gen)
    gs = torch.randn((T, m), generator=gen, device="cuda")
    v0 = torch.rand((m,), generator=gen, device="cuda") * 0.9
    variants = {
        "soft_reset": NeuronParams(hard_reset=False),
        "no_decay_input": NeuronParams(decay_input=False),
        "soft_no_decay_input": NeuronParams(hard_reset=False, decay_input=False),
        "tau4_vth07_vreset01": NeuronParams(tau=4.0, v_threshold=0.7, v_reset=0.1),
        "detach_reset": NeuronParams(detach_reset=True),
        "sigmoid": NeuronParams(surrogate=surrogate.sigmoid),
    }
    for name, p in variants.items():
        errs = [compare_lif_bwd(x, v_init, gs, p, True) for v_init in (None, v0)]
        if p.surrogate.name != "sigmoid":
            max_err = max(max_err, *errs)
        log(f"  K1 bwd {name} (M={m}, v_init none and given): max|d| {max(errs):.3g}"
            + (f" (tolerance rtol {SIGMOID_TOL['rtol']:g}, atol {SIGMOID_TOL['atol']:g})"
               if p.surrogate.name == "sigmoid" else ", bitwise equal"))
    per_step = lambda key: sum(r[key] for r in rows)  # noqa: E731
    return {"rows": rows, "max_abs_err": max_err, "ms": per_step("ms"),
            "plain_ms": per_step("plain_ms"), "bound_ms": per_step("bound_ms")}


def k3_path_shapes():
    """(name, T_in, C, (H, W)) of the five K3 launches of a 'bnlif' training
    step."""
    return [(f"block{i}_C{c}", 1 if i == 0 else T, c, (7, 7))
            for i, c in enumerate(DiffusionConfig().denoiser_channels)]


def phase_k3(gen: torch.Generator, flush: torch.Tensor, shapes=None,
             plain_reps: int = TIMING_REPS, what: str = "training step") -> dict:
    """K3 forward and backward against their plain versions at the path's
    shapes (default: the denoiser's), in fp32 and bf16; the times summed
    over the shapes, one launch each: per training step."""
    params = NeuronParams()
    out = {}
    for dname, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        rows = []
        err_fwd = err_bwd = 0.0
        sums_bitwise = True
        itemsize = torch.tensor([], dtype=dtype).element_size()
        for name, t_in, c, hw in shapes or k3_path_shapes():
            y = (torch.randn((t_in, BATCH, c, *hw), generator=gen, device="cuda")
                 * 2.0).to(dtype)
            scale = torch.rand((c,), generator=gen, device="cuda") + 0.5
            shift = torch.rand((c,), generator=gen, device="cuda") * 0.6 - 0.3
            gs = torch.randn((T, BATCH, c, *hw), generator=gen, device="cuda").to(dtype)
            s = bnl.bn_lif_fwd(y, scale, shift, params, T)
            s_ref = bnl.bn_lif_fwd_reference(y, scale, shift, params, T)
            dy, dsc, dsh = bnl.bn_lif_bwd(y, scale, shift, gs, params, T)
            _, dsc2, dsh2 = bnl.bn_lif_bwd(y, scale, shift, gs, params, T)
            dy_ref, dsc_ref, dsh_ref = bnl.bn_lif_bwd_reference(y, scale, shift, gs, params, T)
            torch.cuda.synchronize()
            rate = float(s_ref.float().mean())
            check(0.05 < rate < 0.95, f"K3 firing rate {rate} outside (0.05, 0.95)")
            check(torch.equal(s, s_ref), f"K3 {dname} spikes differ from the plain version")
            check(torch.equal(dy, dy_ref), f"K3 {dname} dy differs from the plain version")
            check(torch.equal(dsc, dsc2) and torch.equal(dsh, dsh2),
                  "K3 dscale/dshift differ between two launches")
            sum_err = 0.0
            for got, want in ((dsc, dsc_ref), (dsh, dsh_ref)):
                torch.testing.assert_close(got, want, rtol=K3_SUM_RTOL, atol=0)
                sum_err = max(sum_err, float((got - want).abs().max()))
                sums_bitwise = sums_bitwise and torch.equal(got, want)
            err_fwd = max(err_fwd, float((s.float() - s_ref.float()).abs().max()))
            err_bwd = max(err_bwd, float((dy.float() - dy_ref.float()).abs().max()), sum_err)
            m = BATCH * math.prod(hw) * c
            fwd_ms = cuda_ms(lambda: bnl.bn_lif_fwd(y, scale, shift, params, T), flush)
            bwd_ms = cuda_ms(lambda: bnl.bn_lif_bwd(y, scale, shift, gs, params, T), flush)
            fwd_plain = cuda_ms(lambda: bnl.bn_lif_fwd_reference(y, scale, shift, params, T),
                                flush, plain_reps)
            bwd_plain = cuda_ms(lambda: bnl.bn_lif_bwd_reference(
                y, scale, shift, gs, params, T), flush, plain_reps)
            fwd_bound = lif_bound_ms((t_in + T) * m * itemsize)  # y read, s written
            # y and gs read, dy written
            bwd_bound = lif_bound_ms((2 * t_in + T) * m * itemsize)
            rows.append({"shape": name, "T_in": t_in, "t_out": T, "M": m,
                         "fwd_ms": fwd_ms, "fwd_plain_ms": fwd_plain, "fwd_bound_ms": fwd_bound,
                         "bwd_ms": bwd_ms, "bwd_plain_ms": bwd_plain, "bwd_bound_ms": bwd_bound})
            log(f"  K3 {dname} {name:12s} T_in={t_in:2d} M={m:9d}: fwd {fwd_ms:.4f} ms "
                f"(plain {fwd_plain:.4f}, bound {fwd_bound:.4f}, {fwd_bound / fwd_ms:.1%}); "
                f"bwd {bwd_ms:.4f} ms (plain {bwd_plain:.4f}, bound {bwd_bound:.4f}, "
                f"{bwd_bound / bwd_ms:.1%}); spikes and dy bitwise, max|d dscale, dshift| "
                f"{sum_err:.3g}, rate {rate:.3f}")
        per_step = lambda key: sum(r[key] for r in rows)  # noqa: E731
        res = {"rows": rows, "fwd_err": err_fwd, "bwd_err": err_bwd,
               "sums_bitwise": sums_bitwise,
               **{k: per_step(k) for k in ("fwd_ms", "fwd_plain_ms", "fwd_bound_ms",
                                           "bwd_ms", "bwd_plain_ms", "bwd_bound_ms")}}
        for key in ("fwd", "bwd"):
            res[f"{key}_share"] = res[f"{key}_bound_ms"] / res[f"{key}_ms"]
        log(f"  K3 {dname} per {what}: fwd {res['fwd_ms']:.4f} ms, "
            f"{res['fwd_share']:.1%} of its bound {res['fwd_bound_ms']:.4f}; "
            f"bwd {res['bwd_ms']:.4f} ms, {res['bwd_share']:.1%} of its bound "
            f"{res['bwd_bound_ms']:.4f}; dscale, dshift "
            f"{'bitwise' if sums_bitwise else 'not bitwise'} the plain version's")
        out[dname] = res
    return out


def stage1_lif_shapes():
    """(name, T_in, C, (H, W)) of the six LIF layers of a stage-1 step at
    batch 256: three encoder blocks (the first on the image, the same at
    every step), the re-spike (T_in = 1) and two decoder blocks."""
    v = VQVAEConfig()
    (c1, c2), d, (d1, d2) = v.enc_channels, v.embedding_dim, v.dec_channels
    return [(f"encoder0_C{c1}", 1, c1, (14, 14)), (f"encoder1_C{c2}", T, c2, (7, 7)),
            (f"encoder2_D{d}", T, d, (7, 7)), (f"respike_D{d}", 1, d, (7, 7)),
            (f"decoder0_C{d1}", T, d1, (14, 14)), (f"decoder1_C{d2}", T, d2, (28, 28))]


def phase_k1_stage1(gen: torch.Generator, flush: torch.Tensor) -> dict:
    """K1 forward and backward against their plain versions (bitwise) at
    the M of stage 1's six LIF layers, as the layerwise path calls them (a
    T_in = 1 layer's input repeated over T first; no v_init, no dV0),
    timed beside their byte bounds; per training step at batch 256. The
    kernels are fp32 only: on a bf16 input the forward's wrapper casts x
    up and the spikes down around the kernel (timed as ``fwd_bf16``, its
    bound the bf16 x and spikes and the fp32 v_T); the backward is the
    fp32 one in either dtype."""
    params = NeuronParams()
    rows, max_fwd, max_bwd = [], 0.0, 0.0
    for name, _, c, hw in stage1_lif_shapes():
        m = BATCH * c * math.prod(hw)
        x = lif_input(m, gen)
        gs = torch.randn((T, m), generator=gen, device="cuda")
        max_fwd = max(max_fwd, compare_lif(x, None, params))
        max_bwd = max(max_bwd, compare_lif_bwd(x, None, gs, params, False))
        x16 = x.bfloat16()
        check(torch.equal(lif_op.lif_fwd(x16)[0], lif_op.lif_fwd_reference(x16)[0]),
              "K1 bf16 spikes differ from the plain version")
        row = {"shape": name, "T": T, "M": m,
               "fwd_bf16_ms": cuda_ms(lambda: lif_op.lif_fwd(x16, None, params), flush),
               "fwd_bf16_bound_ms": lif_bound_ms((2 * T * 2 + 4) * m),
               "fwd_ms": cuda_ms(lambda: lif_op.lif_fwd(x, None, params), flush),
               "fwd_plain_ms": cuda_ms(lambda: lif_op.lif_fwd_reference(x, None, params),
                                       flush, STAGE1_PLAIN_REPS),
               "fwd_bound_ms": lif_bound_ms((2 * T + 1) * m * 4),
               "bwd_ms": cuda_ms(lambda: lif_op.lif_bwd(x, None, gs, params, False), flush),
               "bwd_plain_ms": cuda_ms(lambda: lif_op.lif_bwd_reference(
                   x, None, gs, params, False), flush, STAGE1_PLAIN_REPS),
               "bwd_bound_ms": lif_bound_ms(3 * T * m * 4)}
        rows.append(row)
        log(f"  K1 stage-1 {name:15s} T={T} M={m:9d}: fwd {row['fwd_ms']:.4f} ms (plain "
            f"{row['fwd_plain_ms']:.4f}, bound {row['fwd_bound_ms']:.4f}, "
            f"{row['fwd_bound_ms'] / row['fwd_ms']:.1%}); bwd {row['bwd_ms']:.4f} ms (plain "
            f"{row['bwd_plain_ms']:.4f}, bound {row['bwd_bound_ms']:.4f}, "
            f"{row['bwd_bound_ms'] / row['bwd_ms']:.1%}); bf16 fwd {row['fwd_bf16_ms']:.4f} ms "
            f"(bound {row['fwd_bf16_bound_ms']:.4f}); bitwise equal")
    res = {"rows": rows, "fwd_err": max_fwd, "bwd_err": max_bwd,
           **{k: sum(r[k] for r in rows) for k in rows[0] if k.endswith("_ms")}}
    log(f"  K1 per stage-1 training step: fwd {res['fwd_ms']:.4f} ms, "
        f"{res['fwd_bound_ms'] / res['fwd_ms']:.1%} of its bound {res['fwd_bound_ms']:.4f}; "
        f"bwd {res['bwd_ms']:.4f} ms, {res['bwd_bound_ms'] / res['bwd_ms']:.1%} of its bound "
        f"{res['bwd_bound_ms']:.4f}; bf16 fwd (wrapper) {res['fwd_bf16_ms']:.4f} ms, bound "
        f"{res['fwd_bf16_bound_ms']:.4f}")
    return res


def k4_path_shapes():
    """(name, images, Cin, Cout, moments, dx) of the six K4 calls of a
    'bnlifconv' training step at batch 256: block 0 on its length-1 time
    axis (no dx: its input is the token map), blocks 1-4 on T * N images,
    the readout without moments."""
    chans = DiffusionConfig().denoiser_channels
    shapes = [(f"block0_{2}to{chans[0]}", BATCH, 2, chans[0], True, False)]
    shapes += [(f"block{i}_{cin}to{cout}", T * BATCH, cin, cout, True, True)
               for i, (cin, cout) in enumerate(zip(chans[:-1], chans[1:]), start=1)]
    cin = chans[-1] + chans[0]
    k = DiffusionConfig().num_embeddings
    shapes.append((f"readout_{cin}to{k}", T * BATCH, cin, k, False, True))
    return shapes


def k4_cost(n, cin, cout, moments, dx, itemsize):
    """(forward FLOPs, forward bytes, backward FLOPs, backward bytes) of one
    K4 call: 2 * Cin * Cout per tap product inside the 7x7 grid (361 of
    the 441 of 9 taps at 49 pixels; the rest multiply the zero padding),
    once forward and once each for dW and dx backward; each input read and
    each output written once."""
    m = n * 49
    valid = sum((7 - abs(dy)) * (7 - abs(dx)) for dy in (-1, 0, 1) for dx in (-1, 0, 1))
    flops = 2.0 * n * valid * cin * cout
    w_bytes = 9 * cin * cout * itemsize
    fwd_bytes = m * cin * itemsize + w_bytes + cout * 4 + m * cout * itemsize \
        + (2 * cout * 4 if moments else 0)
    # x, y and gy read (gs1, gs2 with moments), the weight read for dx;
    # dW, db written, dx written
    bwd_bytes = m * cin * itemsize + 2 * m * cout * itemsize + cout * 4 * 3 \
        + 9 * cin * cout * 4 + (w_bytes + m * cin * itemsize if dx else 0)
    return flops, fwd_bytes, flops * (2 if dx else 1), bwd_bytes


def k4_bound_ms(flops, nbytes, peak):
    """(least ms, what bounds it) of ``flops`` operations at ``peak`` per
    second and ``nbytes`` at the HBM rate."""
    ops_ms = flops / peak * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def k4_fwd_bounds(flops, nbytes, dtype):
    """The forward's bound (ms, what bounds it) on the route its path
    takes, and (fp32) the CUDA-core route's: fp32 runs the tensor-core
    route at K4_FP32_PLANES bf16 products per product."""
    if dtype == torch.float32:
        return (k4_bound_ms(K4_FP32_PLANES * flops, nbytes, PEAK_OPS[torch.bfloat16]),
                k4_bound_ms(flops, nbytes, PEAK_OPS[torch.float32]))
    return k4_bound_ms(flops, nbytes, PEAK_OPS[dtype]), None


def k4_bwd_bounds(flops, dx, nbytes, dtype):
    """The backward's bound (ms, what bounds it) on the route its path
    takes, and (fp32) the CUDA-core route's: fp32 runs dW at
    K4_FP32_PLANES and dx at K4_FP32_DX_TERMS bf16 products per product;
    ``flops`` is one product's (the forward's) operations."""
    work = flops * (2 if dx else 1)
    if dtype == torch.float32:
        products = K4_FP32_PLANES + (K4_FP32_DX_TERMS if dx else 0)
        return (k4_bound_ms(products * flops, nbytes, PEAK_OPS[torch.bfloat16]),
                k4_bound_ms(work, nbytes, PEAK_OPS[torch.float32]))
    return k4_bound_ms(work, nbytes, PEAK_OPS[dtype]), None


def k4_inputs(n, cin, cout, dtype, gen):
    """x as the path gives it (block 0: token ids and timesteps; else
    spikes at a rate of 0.25), the init's weights and bias, and random
    cotangents."""
    if cin == 2:
        dcfg = DiffusionConfig()
        tok = torch.randint(0, dcfg.num_embeddings + 1, (n, 1, 7, 7), generator=gen,
                            device="cuda")
        tim = torch.randint(1, dcfg.num_timesteps + 1, (n, 1, 1, 1), generator=gen,
                            device="cuda").expand(n, 1, 7, 7)
        x = torch.cat([tok, tim], 1).float()
    else:
        x = (torch.rand((n, cin, 7, 7), generator=gen, device="cuda") < 0.25).float()
    bound = 1.0 / math.sqrt(9 * cin)
    w = (torch.rand((cout, cin, 3, 3), generator=gen, device="cuda") * 2 - 1) * bound
    b = (torch.rand((cout,), generator=gen, device="cuda") * 2 - 1) * bound
    gy = torch.randn((n, cout, 7, 7), generator=gen, device="cuda").to(dtype)
    gs1 = torch.randn((cout,), generator=gen, device="cuda") * 1e-2
    gs2 = torch.randn((cout,), generator=gen, device="cuda") * 1e-3
    return x.to(dtype), w, b, gy, gs1, gs2


def assert_near(what, got, want, abs_sum, rtol, atol):
    """|got - want| <= atol + rtol * |want| + K4_SUM_SHARE * abs_sum,
    elementwise; abs_sum is the sum of the absolute values of the terms
    that make up each element."""
    got, want = got.float(), want.float()
    allowed = atol + rtol * want.abs() + K4_SUM_SHARE * abs_sum
    excess = float(((got - want).abs() - allowed).max())
    check(excess <= 0.0, f"{what}: |d| exceeds its tolerance by {excess:.3g} (max|d| "
          f"{float((got - want).abs().max()):.3g})")
    return float((got - want).abs().max())


def check_fp32_routes(what: str, tensor_cores: int, cuda_cores: int = 0) -> tuple:
    """Since the route counts were reset, ``tensor_cores`` of K4's fp32
    forwards took the tensor-core route and ``cuda_cores`` the CUDA-core
    route: (tensor cores, CUDA cores)."""
    routes = sc.fp32_route_counts()
    want = (tensor_cores, cuda_cores)
    check(routes == want, f"{what}: fp32 K4 forwards by route (tensor cores, CUDA cores) "
          f"{routes}, expected {want}")
    return routes


def check_fp32_bwd_routes(what: str, dw_tc: int, dx_tc: int, dw_cc: int = 0,
                          dx_cc: int = 0) -> tuple:
    """Since the route counts were reset, K4's fp32 backwards took dW on
    the tensor cores ``dw_tc`` times and on the CUDA cores ``dw_cc``
    times, dx ``dx_tc`` and ``dx_cc`` times: (dW tensor cores, dW CUDA
    cores, dx tensor cores, dx CUDA cores)."""
    routes = sc.fp32_bwd_route_counts()
    want = (dw_tc, dw_cc, dx_tc, dx_cc)
    check(routes == want, f"{what}: fp32 K4 backward passes by route (dW tensor cores, dW "
          f"CUDA cores, dx tensor cores, dx CUDA cores) {routes}, expected {want}")
    return routes


def k4_bwd_abs_sums(x, w, y, gy, gs1, gs2, moments, dx_needed):
    """(dx, dW, db) of the backward's contractions over absolute values:
    each element's sum of |terms|."""
    g = sc.grad_out(y, gy, gs1, gs2, moments)
    zeros = torch.zeros_like(gs1)
    return sc.spike_conv3x3_bwd_reference(x.abs(), w.abs(), y, g.abs().to(x.dtype), zeros,
                                          zeros, False, dx_needed)


def compare_k4(x, w, b, gy, gs1, gs2, moments, dx_needed, dname):
    """K4 forward and backward against their plain versions: (max |d y|,
    max |d| / |plain| of s1 and s2, max |d| of dx, dW and db). An fp32 x
    of the path must take the tensor-core route."""
    sc.reset_fp32_route_counts()
    y, s1, s2 = sc.spike_conv3x3_fwd(x, w, b, moments)
    _, s1b, s2b = sc.spike_conv3x3_fwd(x, w, b, moments)
    check_fp32_routes("K4 on the path's x", 2 if dname == "fp32" else 0)
    y_ref, s1_ref, s2_ref = sc.spike_conv3x3_fwd_reference(x, w, b, moments)
    got = sc.spike_conv3x3_bwd(x, w, y_ref, gy, gs1, gs2, moments, dx_needed)
    again = sc.spike_conv3x3_bwd(x, w, y_ref, gy, gs1, gs2, moments, dx_needed)
    n_tc = 2 if dname == "fp32" else 0
    check_fp32_bwd_routes("K4 backward on the path's x", n_tc, n_tc if dx_needed else 0)
    want = sc.spike_conv3x3_bwd_reference(x, w, y_ref, gy, gs1, gs2, moments, dx_needed)
    abs_sums = k4_bwd_abs_sums(x, w, y_ref, gy, gs1, gs2, moments, dx_needed)
    torch.cuda.synchronize()
    check(float(y_ref.float().std()) > 0.1, "K4: near-constant reference y")
    torch.testing.assert_close(y.float(), y_ref.float(), **K4_Y_TOL[dname])
    err_fwd = float((y.float() - y_ref.float()).abs().max())
    err_moments = 0.0
    if moments:
        yf = y_ref.float()
        for what, a, a2, a_ref, abs_sum in (("s1", s1, s1b, s1_ref, yf.abs().sum((0, 2, 3))),
                                            ("s2", s2, s2b, s2_ref, s2_ref)):
            check(torch.equal(a, a2), f"K4 {what} differs between two launches")
            assert_near(f"K4 {dname} {what}", a, a_ref, abs_sum, **K4_MOMENT_TOL)
            err_moments = max(err_moments, float(((a - a_ref).abs() / a_ref.abs()).max()))
    else:
        check(float(s1.abs().sum()) == float(s2.abs().sum()) == 0.0, "K4 moments not zero")
    err_bwd = 0.0
    for name, a, a2, a_ref, abs_sum in zip(("dx", "dW", "db"), got, again, want, abs_sums):
        if a_ref is None:
            check(a is None, "K4 dx computed when not asked")
            continue
        check(torch.equal(a, a2), f"K4 {name} differs between two launches")
        tol = K4_Y_TOL[dname] if (name == "dx" and dname == "bf16") else K4_GRAD_TOL
        err_bwd = max(err_bwd, assert_near(f"K4 {dname} {name}", a, a_ref, abs_sum, **tol))
    return err_fwd, err_moments, err_bwd


def kernel_profile(fn) -> dict:
    """{kernel: [device ms, launches]} of one call of ``fn`` under
    ``torch.profiler`` (the kernels' own device time, no gaps)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = re.search(r"(\w+)\s*[<(]", e.key.replace("(anonymous namespace)", ""))
            row = out.setdefault(name.group(1) if name else e.key[:40], [0.0, 0])
            row[0] += e.self_device_time_total / 1e3
            row[1] += e.count
    return out


def add_profile(profile: dict, fn) -> None:
    """Adds ``kernel_profile(fn)`` into ``profile``."""
    for kname, (kms, count) in kernel_profile(fn).items():
        row = profile.setdefault(kname, [0.0, 0])
        row[0] += kms
        row[1] += count


def assert_near_nonfinite(what, got, want, abs_sum, rtol, atol):
    """``assert_near`` on the elements where ``want`` is finite; inf, -inf
    and NaN at the same places as in ``want``."""
    for kind in ("isnan", "isposinf", "isneginf"):
        check(torch.equal(getattr(got, kind)(), getattr(want, kind)()),
              f"{what}: {kind} differs from the plain version")
    finite = want.isfinite()
    return assert_near(what, got[finite], want[finite], abs_sum[finite], rtol, atol)


def compare_k4_cuda_cores(x, w, b, gy, gy_inf, gs1, gs2, moments, dx_needed) -> tuple:
    """K4 fp32 with x's first element moved off bf16's grid: the forward
    and dW on the CUDA-core route, dx on the tensor cores; then with one
    inf in gy as well: dW and dx on the CUDA-core route. Each against the
    plain version at the same tolerances (inf and NaN where it has them);
    (max |d y|, max |d| of the finite dx, dW and db)."""
    sc.reset_fp32_route_counts()
    y, s1, s2 = sc.spike_conv3x3_fwd(x, w, b, moments)
    check_fp32_routes("K4 on an x that bf16 cannot hold", 0, 1)
    y_ref, s1_ref, s2_ref = sc.spike_conv3x3_fwd_reference(x, w, b, moments)
    torch.testing.assert_close(y, y_ref, **K4_Y_TOL["fp32"])
    if moments:
        for what, a, a_ref, abs_sum in (("s1", s1, s1_ref, y_ref.abs().sum((0, 2, 3))),
                                        ("s2", s2, s2_ref, s2_ref)):
            assert_near(f"K4 CUDA-core route {what}", a, a_ref, abs_sum, **K4_MOMENT_TOL)
    err_bwd = 0.0
    for what, g_in, routes in (("x off the grid", gy, (0, 1 if dx_needed else 0, 1, 0)),
                               ("and g with an inf", gy_inf, (0, 0, 1, 1 if dx_needed else 0))):
        sc.reset_fp32_route_counts()
        got = sc.spike_conv3x3_bwd(x, w, y_ref, g_in, gs1, gs2, moments, dx_needed)
        check_fp32_bwd_routes(f"K4 backward, {what}", *routes)
        want = sc.spike_conv3x3_bwd_reference(x, w, y_ref, g_in, gs1, gs2, moments, dx_needed)
        abs_sums = k4_bwd_abs_sums(x, w, y_ref, g_in, gs1, gs2, moments, dx_needed)
        for name, a, a_ref, abs_sum in zip(("dx", "dW", "db"), got, want, abs_sums):
            if a_ref is not None:
                err_bwd = max(err_bwd, assert_near_nonfinite(
                    f"K4 fp32 {name}, {what}", a, a_ref, abs_sum, **K4_GRAD_TOL))
    return float((y - y_ref).abs().max()), err_bwd


def with_inf(t: torch.Tensor) -> torch.Tensor:
    """t with its middle element set to +inf."""
    t = t.clone()
    t.view(-1)[t.numel() // 2] = float("inf")
    return t


def off_grid(x: torch.Tensor) -> torch.Tensor:
    """x with its first element set to 1/3, which bf16 cannot hold."""
    x = x.clone()
    x.view(-1)[0] = 1.0 / 3.0
    return x


def phase_k4(gen: torch.Generator, flush: torch.Tensor, card: str) -> dict:
    """K4 forward and backward against their plain versions at the six conv
    shapes of a 'bnlifconv' training step at batch 256, in fp32 and bf16,
    timed beside their bound and the library call (cuDNN through
    ``F.conv2d`` plus the two sums; ``aten.convolution_backward``): the
    times per training step. fp32 also on its CUDA-core routes."""
    out = {}
    profile = {}  # bf16 kernel -> [device ms, launches] per training step
    profile_fp32 = {}  # the same for the fp32 forward
    profile_fp32_bwd = {}  # and the fp32 backward
    for dname, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        rows = []
        err_fwd = err_moments = err_bwd = 0.0
        itemsize = torch.tensor([], dtype=dtype).element_size()
        for name, n, cin, cout, moments, dx_needed in k4_path_shapes():
            x, w, b, gy, gs1, gs2 = k4_inputs(n, cin, cout, dtype, gen)
            e_f, e_m, e_b = compare_k4(x, w, b, gy, gs1, gs2, moments, dx_needed, dname)
            err_fwd, err_bwd = max(err_fwd, e_f), max(err_bwd, e_b)
            err_moments = max(err_moments, e_m)
            y = sc.spike_conv3x3_fwd(x, w, b, moments)[0]
            wd, bd = w.to(dtype), b.to(dtype)

            def library_fwd():
                yl = torch.nn.functional.conv2d(x, wd, bd, padding=1)
                if moments:
                    yf = yl.float()
                    return yf.sum((0, 2, 3)), (yf * yf).sum((0, 2, 3))
                return yl

            def library_bwd():
                return torch.ops.aten.convolution_backward(
                    gy, x, wd, [cout], [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                    [dx_needed, True, True])

            reps = K4_TIMING_REPS
            times = {
                "fwd_ms": cuda_ms(lambda: sc.spike_conv3x3_fwd(x, w, b, moments), flush, reps),
                "fwd_plain_ms": cuda_ms(lambda: sc.spike_conv3x3_fwd_reference(
                    x, w, b, moments), flush, reps),
                "fwd_library_ms": cuda_ms(library_fwd, flush, reps),
                "bwd_ms": cuda_ms(lambda: sc.spike_conv3x3_bwd(
                    x, w, y, gy, gs1, gs2, moments, dx_needed), flush, reps),
                "bwd_plain_ms": cuda_ms(lambda: sc.spike_conv3x3_bwd_reference(
                    x, w, y, gy, gs1, gs2, moments, dx_needed), flush, reps),
                "bwd_library_ms": cuda_ms(library_bwd, flush, reps),
                # dW + db alone; the rest of bwd_ms is dx
                "bwd_nodx_ms": cuda_ms(lambda: sc.spike_conv3x3_bwd(
                    x, w, y, gy, gs1, gs2, moments, False), flush, reps),
            }
            if dtype == torch.bfloat16:  # where the step's K4 time goes, by kernel
                add_profile(profile, lambda: (
                    sc.spike_conv3x3_fwd(x, w, b, moments),
                    sc.spike_conv3x3_bwd(x, w, y, gy, gs1, gs2, moments, dx_needed)))
            f_flops, f_bytes, b_flops, b_bytes = k4_cost(n, cin, cout, moments, dx_needed,
                                                         itemsize)
            (fwd_bound, fwd_by), cc_bound = k4_fwd_bounds(f_flops, f_bytes, dtype)
            (bwd_bound, bwd_by), bwd_cc_bound = k4_bwd_bounds(f_flops, dx_needed, b_bytes, dtype)
            extra, cc_log, bwd_cc_log = {}, "", ""
            if dtype == torch.float32:  # the other routes, on the path's x moved off the grid
                add_profile(profile_fp32, lambda: sc.spike_conv3x3_fwd(x, w, b, moments))
                add_profile(profile_fp32_bwd, lambda: sc.spike_conv3x3_bwd(
                    x, w, y, gy, gs1, gs2, moments, dx_needed))
                x_off, gy_inf = off_grid(x), with_inf(gy)
                err_cc, err_bwd_cc = compare_k4_cuda_cores(x_off, w, b, gy, gy_inf, gs1, gs2,
                                                           moments, dx_needed)
                err_fwd, err_bwd = max(err_fwd, err_cc), max(err_bwd, err_bwd_cc)
                sc.reset_fp32_route_counts()
                extra = {"fwd_cc_ms": cuda_ms(lambda: sc.spike_conv3x3_fwd(x_off, w, b, moments),
                                              flush, reps),
                         "fwd_cc_bound_ms": cc_bound[0],
                         # dW and dx on the CUDA cores: x off the grid, an inf in g
                         "bwd_cc_ms": cuda_ms(lambda: sc.spike_conv3x3_bwd(
                             x_off, w, y, gy_inf, gs1, gs2, moments, dx_needed), flush, reps),
                         "bwd_cc_nodx_ms": cuda_ms(lambda: sc.spike_conv3x3_bwd(
                             x_off, w, y, gy_inf, gs1, gs2, moments, False), flush, reps),
                         "bwd_cc_bound_ms": bwd_cc_bound[0]}
                check_fp32_routes("K4 timed on an x that bf16 cannot hold", 0, reps + 1)
                check_fp32_bwd_routes("K4 backward timed on the CUDA-core routes", 0,
                                      0, 2 * (reps + 1), reps + 1 if dx_needed else 0)
                cc_log = (f" CUDA-core route {extra['fwd_cc_ms']:.3f} ms (bound "
                          f"{cc_bound[0]:.3f}, max|d y| {err_cc:.3g});")
                bwd_cc_log = (f"; CUDA-core routes {extra['bwd_cc_ms']:.3f} ms, dW + db "
                              f"{extra['bwd_cc_nodx_ms']:.3f} (bound {bwd_cc_bound[0]:.3f}, "
                              f"max|d dx, dW, db| {err_bwd_cc:.3g})")
                del x_off, gy_inf
            rows.append({"shape": name, "M": n * 49, "Cin": cin, "Cout": cout, **times,
                         **extra, "fwd_bound_ms": fwd_bound, "fwd_bound_by": fwd_by,
                         "bwd_bound_ms": bwd_bound, "bwd_bound_by": bwd_by,
                         "fwd_gflop": f_flops / 1e9, "bwd_gflop": b_flops / 1e9})
            log(f"  K4 {dname} {name:18s} M={n * 49:7d}: fwd {times['fwd_ms']:.3f} ms "
                f"(plain {times['fwd_plain_ms']:.3f}, cuDNN {times['fwd_library_ms']:.3f}, "
                f"bound {fwd_bound:.3f} {fwd_by}, {fwd_bound / times['fwd_ms']:.1%} of it, "
                f"{f_flops / times['fwd_ms'] / 1e9:.2f} TFLOP/s useful);{cc_log} bwd "
                f"{times['bwd_ms']:.3f} ms (plain "
                f"{times['bwd_plain_ms']:.3f}, cuDNN {times['bwd_library_ms']:.3f}, bound "
                f"{bwd_bound:.3f} {bwd_by}, {b_flops / times['bwd_ms'] / 1e9:.2f} TFLOP/s "
                f"useful; dW + db {times['bwd_nodx_ms']:.3f}, dx "
                f"{times['bwd_ms'] - times['bwd_nodx_ms']:.3f}{bwd_cc_log}); max|d y| "
                f"{e_f:.3g}, max rel |d s1, s2| {e_m:.3g}, max|d dx, dW, db| {e_b:.3g} [{card}]")
            del x, y, gy
        per_step = lambda key: sum(r[key] for r in rows)  # noqa: E731
        keys = ["fwd_ms", "fwd_plain_ms", "fwd_library_ms", "fwd_bound_ms", "bwd_ms",
                "bwd_plain_ms", "bwd_library_ms", "bwd_bound_ms", "bwd_nodx_ms", "fwd_gflop",
                "bwd_gflop"]
        if dtype == torch.float32:
            keys += ["fwd_cc_ms", "fwd_cc_bound_ms", "bwd_cc_ms", "bwd_cc_nodx_ms",
                     "bwd_cc_bound_ms"]
        out[dname] = {"rows": rows, "fwd_err": err_fwd, "bwd_err": err_bwd,
                      "moments_rel_err": err_moments, **{k: per_step(k) for k in keys}}
        for key in ("fwd", "bwd"):  # what bounds most of the step's bound
            by_ops = sum(r[f"{key}_bound_ms"] for r in rows
                         if r[f"{key}_bound_by"] == "operations")
            out[dname][f"{key}_bound_by"] = ("operations" if 2 * by_ops >= out[dname][
                f"{key}_bound_ms"] else "bytes")
        o = out[dname]
        cc = (f"; CUDA-core route {o['fwd_cc_ms']:.2f}, its bound {o['fwd_cc_bound_ms']:.2f}"
              if "fwd_cc_ms" in o else "")
        bwd_cc = (f"; CUDA-core routes {o['bwd_cc_ms']:.2f}, dW + db {o['bwd_cc_nodx_ms']:.2f}, "
                  f"their bound {o['bwd_cc_bound_ms']:.2f}" if "bwd_cc_ms" in o else "")
        log(f"  K4 {dname} per training step (6 calls): fwd {o['fwd_ms']:.2f} ms (cuDNN "
            f"{o['fwd_library_ms']:.2f}, bound {o['fwd_bound_ms']:.2f}, "
            f"{o['fwd_bound_ms'] / o['fwd_ms']:.1%} of it, "
            f"{o['fwd_gflop'] / o['fwd_ms']:.1f} TFLOP/s useful{cc}); bwd {o['bwd_ms']:.2f} ms "
            f"(cuDNN {o['bwd_library_ms']:.2f}, bound {o['bwd_bound_ms']:.2f}, "
            f"{o['bwd_gflop'] / o['bwd_ms']:.1f} TFLOP/s useful; dW + db "
            f"{o['bwd_nodx_ms']:.2f}, dx {o['bwd_ms'] - o['bwd_nodx_ms']:.2f}{bwd_cc}) [{card}]")
    for what, prof in (("fp32 fwd", profile_fp32), ("fp32 bwd", profile_fp32_bwd),
                       ("bf16 fwd + bwd", profile)):
        by_time = sorted(prof.items(), key=lambda kv: -kv[1][0])
        log(f"  K4 {what} per training step by kernel (torch.profiler): "
            + "; ".join(f"{k} {v[0]:.3f} ms / {v[1]}" for k, v in by_time) + f" [{card}]")
    out["fp32"]["fwd_profile"] = profile_fp32
    out["fp32"]["bwd_profile"] = profile_fp32_bwd
    return out


# --- phase 3: generation at full width ---------------------------------------


def build_models(dcfg, vcfg):
    """Seeded random full-width models, BN statistics set from one batch, as
    kernel-path and plain-path copies with the same weights."""
    gen = torch.Generator().manual_seed(0)
    den = weights.load_denoiser(*weights.init_denoiser_variables(dcfg, gen),
                                dcfg, device="cuda")
    vq = weights.load_vqvae(*weights.init_vqvae_variables(vcfg, gen),
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


def phase_generation_bnlifconv(models, dcfg, layerwise, card: str) -> dict:
    """Layerwise-sampler requests at batch 16 and 256 through a 'bnlifconv'
    denoiser (the models' weights) in eval mode: exactly 6 K4-forward and
    5 K3-forward launches per reverse step, no backward, 3 K1 in the
    decode. Returns the launches and fp32 routes summed over both, and each
    request's times."""
    den, vq = models[:2]
    fused = SpikingDenoiser(dcfg, lif_backend="bnlifconv").cuda().eval()
    fused.load_state_dict(den.state_dict())
    steps = len(diffusion.schedule(dcfg)[0])
    total = [0] * 7
    total_routes = [0, 0]
    requests = {}
    for i in BNLIFCONV_REQUESTS:  # on the layerwise requests' noise
        n = REQUESTS[i]
        reset_launch_counts()
        codes, images, sample_ms, decode_ms = run_request(fused, vq, dcfg, n,
                                                          request_noise(dcfg, i, steps))
        counts = launch_counts()
        lw_codes, lw_sample_ms, lw_decode_ms = layerwise[i]
        agree = float((codes == lw_codes).float().mean())
        log(f"  bnlifconv request {i} batch {n}: launches {format_counts(counts)}, sampler "
            f"{sample_ms:.1f} ms ({sample_ms / steps:.3f} ms/step; layerwise fp32 "
            f"{lw_sample_ms / steps:.3f}), decode {decode_ms:.2f} ms, "
            f"{n / ((sample_ms + decode_ms) / 1e3):.1f} images/s (layerwise fp32 "
            f"{n / ((lw_sample_ms + lw_decode_ms) / 1e3):.1f}); codes agreeing with "
            f"layerwise fp32 {agree:.4f} [{card}]")
        want = (K1_DECODE_LAUNCHES, 0, K3_PER_STEP * steps, 0, 0, K4_PER_STEP * steps, 0)
        check(counts == want, f"bnlifconv generation launches {counts}, expected {want}")
        routes = check_fp32_routes("bnlifconv generation", counts[5])
        log(f"  bnlifconv request {i}: fp32 K4 forwards on the tensor cores / CUDA cores: "
            f"{routes[0]} / {routes[1]}")
        check_outputs(codes, images, n, dcfg)
        total = [a + b for a, b in zip(total, counts)]
        total_routes = [a + b for a, b in zip(total_routes, routes)]
        requests[n] = {"sample_ms": sample_ms, "decode_ms": decode_ms,
                       "images_per_s": n / ((sample_ms + decode_ms) / 1e3),
                       "agree_with_layerwise": agree}
    return {"launches": tuple(total), "fp32_routes": tuple(total_routes),
            "requests": requests}


# --- phase 8: stage-2 training at full width ----------------------------------


def launch_counts():
    """K1 fwd, K1 bwd, K3 fwd, K3 bwd, K2, K4 fwd, K4 bwd."""
    return (lif_op.LAUNCHES, lif_op.LAUNCHES_BWD, bnl.LAUNCHES_FWD, bnl.LAUNCHES_BWD,
            fd.LAUNCHES, sc.LAUNCHES_FWD, sc.LAUNCHES_BWD)


def reset_launch_counts():
    lif_op.LAUNCHES = lif_op.LAUNCHES_BWD = bnl.LAUNCHES_FWD = bnl.LAUNCHES_BWD = 0
    fd.LAUNCHES = sc.LAUNCHES_FWD = sc.LAUNCHES_BWD = 0
    sc.reset_fp32_route_counts()


def format_counts(c) -> str:
    return (f"K1 fwd/bwd {c[0]}/{c[1]}, K3 fwd/bwd {c[2]}/{c[3]}, K2 {c[4]}, "
            f"K4 fwd/bwd {c[5]}/{c[6]}")


def train_state(variables, dcfg, backend, device, dtype=None):
    return create_train_state(weights.load_denoiser(
        *variables, dcfg, device=device, lif_backend=backend, train=True, dtype=dtype))


def step_record(state, loss):
    """(loss, gradients, BN running statistics) of the step just taken."""
    model = state.model
    return (float(loss), {n: p.grad.detach().clone() for n, p in model.named_parameters()},
            {k: v.clone() for k, v in model.state_dict().items()
             if k.endswith((".mean", ".var"))})


def compare_steps(what, got, want, exact: bool, loss_atol: float = LOSS_ATOL,
                  stats_tol: dict = STATS_TOL, grad_tol: dict = GRAD_TOL) -> dict:
    """Hold step record ``got`` against ``want``: equal (``exact``: the same
    step through the plain versions of kernels that are bitwise theirs), or
    the loss within ``loss_atol``, the gradients elementwise at ``grad_tol``
    (default the CPU tests' tolerance; the log counts the elements outside
    that) and the BN statistics at ``stats_tol``."""
    def diff(g, w, tol):
        """max |d| over the tensors, the elements outside ``tol``, and the
        least atol that would hold them all at tol's rtol."""
        pairs = [(g[n], w[n].to(g[n].device)) for n in g]
        return (max(float((a - b).abs().max()) for a, b in pairs),
                sum(int((~torch.isclose(a, b, **tol)).sum()) for a, b in pairs),
                sum(a.numel() for a, _ in pairs),
                max(float(((a - b).abs() - tol["rtol"] * b.abs()).max()) for a, b in pairs))

    loss_d = abs(got[0] - want[0])
    grad_d, grad_out, grad_n, grad_atol = diff(got[1], want[1], GRAD_TOL)
    stat_d, stat_out, stat_n, stat_atol = diff(got[2], want[2], stats_tol)
    log(f"  first step vs {what}: |d loss| {loss_d:.3g}, max|d grad| {grad_d:.3g}, "
        f"max|d BN stats| {stat_d:.3g}; outside rtol {GRAD_TOL['rtol']:g}, atol "
        f"{GRAD_TOL['atol']:g}: {grad_out} of {grad_n} gradient elements (least atol "
        f"{grad_atol:.3g}); outside rtol {stats_tol['rtol']:g}, atol {stats_tol['atol']:g}: "
        f"{stat_out} of {stat_n} BN statistics (least atol {stat_atol:.3g})")
    row = {"loss": loss_d, "grad": grad_d, "stats": stat_d, "grad_outside_tol": grad_out,
           "stats_outside_tol": stat_out, "grad_least_atol": grad_atol,
           "stats_least_atol": stat_atol}
    if exact:
        check(loss_d == 0.0, f"loss differs from {what}")
        for g, w in ((got[1], want[1]), (got[2], want[2])):
            for n in g:
                check(torch.equal(g[n], w[n]), f"{n} differs from {what}")
        return row
    check(loss_d <= loss_atol, f"loss differs from {what}: {loss_d:.3g} > {loss_atol:g}")
    for n in got[1]:
        torch.testing.assert_close(got[1][n], want[1][n].to(got[1][n].device), **grad_tol,
                                   msg=lambda m, n=n: f"{n} gradient vs {what}: {m}")
    for n in got[2]:
        torch.testing.assert_close(got[2][n], want[2][n].to(got[2][n].device), **stats_tol,
                                   msg=lambda m, n=n: f"{n} vs {what}: {m}")
    return row


def check_k4_in_step(variables, dcfg, step_fn, x0, corruption) -> float:
    """The first 'bnlifconv' step once more, each of its K4 forwards held
    against the plain version on the very inputs the step gave it, at the
    K4 phase's tolerances (y 1e-5, the moments as there), each on the
    tensor-core route: the kernel at its own tolerance on the training
    path's inputs, where a spike flipped downstream cannot hide a fault.
    Logs how far the kernel's y and the plain version's lie from an fp64
    conv of the same inputs. Max |d y|."""
    state = train_state(variables, dcfg, "bnlifconv", "cuda")
    calls = []

    def hook(module, args, kwargs, out):
        calls.append((args[0].detach(), module.weight.detach().clone(),
                      module.bias.detach().clone(), kwargs.get("with_moments", True),
                      *(o.detach() for o in out)))

    handles = [m.register_forward_hook(hook, with_kwargs=True) for m in state.model.modules()
               if isinstance(m, SeqConv)]
    reset_launch_counts()
    step_fn(state, x0, corruption=corruption)
    for h in handles:
        h.remove()
    check(len(calls) == K4_PER_STEP, f"{len(calls)} K4 forwards in a step")
    check_fp32_routes("the first bnlifconv step", K4_PER_STEP)
    check_fp32_bwd_routes("the first bnlifconv step", K4_PER_STEP, K4_DX_PER_STEP)
    err = err_k4 = err_plain = 0.0
    for i, (x, w, b, moments, y, s1, s2) in enumerate(calls):
        y_ref, s1_ref, s2_ref = sc.spike_conv3x3_fwd_reference(x, w, b, moments)
        err = max(err, assert_near(f"K4 call {i} of the first step: y", y, y_ref, 0.0,
                                   **K4_Y_TOL["fp32"]))
        y64 = torch.nn.functional.conv2d(x.double(), w.double(), b.double(), padding=1)
        err_k4 = max(err_k4, float((y.double() - y64).abs().max()))
        err_plain = max(err_plain, float((y_ref.double() - y64).abs().max()))
        if moments:
            for what, a, a_ref, abs_sum in (("s1", s1, s1_ref, y_ref.abs().sum((0, 2, 3))),
                                            ("s2", s2, s2_ref, s2_ref)):
                assert_near(f"K4 call {i} of the first step: {what}", a, a_ref, abs_sum,
                            **K4_MOMENT_TOL)
    log(f"  first bnlifconv step, each K4 forward against its plain version on its own "
        f"inputs: max|d y| {err:.3g} (tolerance rtol {K4_Y_TOL['fp32']['rtol']:g}, atol "
        f"{K4_Y_TOL['fp32']['atol']:g}), moments within theirs, all {K4_PER_STEP} on the "
        f"tensor cores, and every dW and dx of the step; max|y - fp64 conv| kernel "
        f"{err_k4:.3g}, plain version {err_plain:.3g}")
    return err


def check_path_bwd_routes(what: str, launches: int) -> tuple:
    """``launches`` fp32 K4 backwards of 'bnlifconv' training steps, every
    dW and every dx (five a step) on the tensor cores."""
    return check_fp32_bwd_routes(what, launches, launches // K4_PER_STEP * K4_DX_PER_STEP)


def train_batches(dcfg, codes, n):
    """The TRAIN_STEPS batches of size n and their corruptions, drawn from
    a generator seeded with n: the same for every branch and dtype."""
    gen = torch.Generator(device="cuda").manual_seed(n)
    batches = [codes[(i * n) % len(codes):(i * n) % len(codes) + n]
               for i in range(TRAIN_STEPS)]
    return batches, [diffusion.corrupt(x0, dcfg, gen) for x0 in batches]


def run_steps(state, step_fn, batches, corruptions=None):
    """TRAIN_STEPS steps from reset launch counts: (ms per step, losses,
    first step's record, launch counts, peak device memory). A stage-2
    step gets its batch's corruption, a stage-1 step its images alone."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    reset_launch_counts()
    for i, (x0, corruption) in enumerate(zip(batches, corruptions or [None] * len(batches))):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        loss = (step_fn(state, x0) if corruption is None
                else step_fn(state, x0, corruption=corruption))["loss"]
        ev[1].record()
        ev[1].synchronize()
        times.append(ev[0].elapsed_time(ev[1]))
        losses.append(float(loss))
        if i == 0:
            first = step_record(state, loss)
    return times, losses, first, launch_counts(), torch.cuda.max_memory_allocated()


def phase_train(dcfg, codes: torch.Tensor, card: str) -> dict:
    """Stage-2 training on each branch at each batch in fp32, one epoch of
    ``train_diffusion`` per branch, then each branch in bf16 at batch 256:
    {branch: {batch: ..., "loop": ..., "bf16": ...}}."""
    variables = weights.init_denoiser_variables(dcfg, torch.Generator().manual_seed(3))
    step_fn = stage2.make_train_step_diffusion(dcfg)
    results = {}
    firsts = {}  # branch -> the first batch-32 step on the card
    for branch, (backend, plain) in TRAIN_BRANCHES.items():
        results[branch] = {}
        want = tuple(k * TRAIN_STEPS for k in STEP_LAUNCHES[branch])
        for n in TRAIN_BATCHES:
            state = train_state(variables, dcfg, backend, "cuda")
            batches, corruptions = train_batches(dcfg, codes, n)
            times, losses, first, counts, peak = run_steps(state, step_fn, batches,
                                                           corruptions)
            log(f"  {branch} batch {n}: launches {format_counts(counts)} in {TRAIN_STEPS} "
                f"steps; ms per step {', '.join(f'{t:.2f}' for t in times)} (median after "
                f"the first {statistics.median(times[1:]):.2f}); losses "
                f"{', '.join(f'{v:.4f}' for v in losses)}; peak memory "
                f"{peak / 2**30:.2f} GiB [{card}]")
            check(counts == want, f"{branch}: launches {counts}, expected {want}")
            check(all(math.isfinite(v) for v in losses), f"{branch}: loss not finite")
            row = {"launches": counts, "ms": times, "ms_median": statistics.median(times[1:]),
                   "losses": losses, "peak_bytes": peak,
                   "fp32_routes": check_fp32_routes(f"{branch} batch {n}", counts[5]),
                   "fp32_bwd_routes": check_path_bwd_routes(f"{branch} batch {n}", counts[6])}
            if n == TRAIN_BATCHES[0]:
                firsts[branch] = first
                before = launch_counts()
                plain_state = train_state(variables, dcfg, plain, "cuda")
                loss_p = step_fn(plain_state, batches[0], corruption=corruptions[0])["loss"]
                plain_rec = step_record(plain_state, loss_p)
                check(launch_counts() == before, "the plain step launched a kernel")
                cpu_state = train_state(variables, dcfg, backend, "cpu")
                cpu_corr = tuple(a.cpu() for a in corruptions[0])
                loss_c = step_fn(cpu_state, batches[0].cpu(), corruption=cpu_corr)["loss"]
                # K1 and K3 are bitwise their plain versions; K4 sums in
                # another order than its plain version's torch.matmul
                conv = branch == "bnlifconv"
                row["vs_plain"] = compare_steps(
                    "the plain versions on the card", first, plain_rec, not conv,
                    *((CONV_LOSS_ATOL, CONV_STATS_TOL) if conv else ()))
                row["vs_cpu"] = compare_steps("the CPU", first, step_record(cpu_state, loss_c),
                                              False)
                if conv:
                    row["vs_bnlif"] = compare_steps("the 'bnlif' branch on the card", first,
                                                    firsts["bnlif"], False)
                    row["k4_in_step_max_abs_err"] = check_k4_in_step(
                        variables, dcfg, step_fn, batches[0], corruptions[0])
            results[branch][n] = row
        # the loop a user calls: one epoch over the 256 grids at batch 32
        logged = []
        den = weights.load_denoiser(*variables, dcfg, device="cuda", lif_backend=backend,
                                    train=True)
        reset_launch_counts()
        t0 = time.perf_counter()
        state = stage2.train_diffusion(den, dcfg, codes, epochs=1, batch_size=TRAIN_BATCHES[0],
                                       seed=0, log_every=1, log_fn=logged.append)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        losses = [float(line.split("loss ")[1]) for line in logged if "loss " in line]
        log(f"  {branch} train_diffusion: {state.step} steps at batch {TRAIN_BATCHES[0]} in "
            f"{seconds:.2f} s (host clock), launches {format_counts(counts)}; losses "
            f"{', '.join(f'{v:.3f}' for v in losses)}")
        check(state.step == len(codes) // TRAIN_BATCHES[0], "train_diffusion step count")
        check_fp32_routes(f"{branch} train_diffusion", counts[5])
        bwd_routes = check_path_bwd_routes(f"{branch} train_diffusion", counts[6])
        check(counts == tuple(k * state.step for k in STEP_LAUNCHES[branch]),
              f"{branch} train_diffusion launches {counts}")
        check(len(losses) == state.step and all(math.isfinite(v) for v in losses),
              f"{branch} train_diffusion losses {losses}")
        results[branch]["loop"] = {"launches": counts, "seconds": seconds, "losses": losses,
                                   "fp32_bwd_routes": bwd_routes}
    for branch, (backend, _) in TRAIN_BRANCHES.items():
        n = TRAIN_BATCHES[-1]
        state = train_state(variables, dcfg, backend, "cuda", torch.bfloat16)
        dtypes = set()  # what every conv takes in (spikes) and gives out

        def hook(module, args, out):
            dtypes.update((args[0].dtype, (out[0] if isinstance(out, tuple) else out).dtype))

        handles = [m.register_forward_hook(hook) for m in state.model.modules()
                   if isinstance(m, SeqConv)]
        times, losses, _, counts, peak = run_steps(state, step_fn,
                                                   *train_batches(dcfg, codes, n))
        for h in handles:
            h.remove()
        check(dtypes == {torch.bfloat16}, f"{branch} bf16: convs and spikes in {dtypes}")
        fp32_first = results[branch][n]["losses"][0]
        rel = abs(losses[0] - fp32_first) / abs(fp32_first)
        log(f"  {branch} bf16 batch {n}: launches {format_counts(counts)} in {TRAIN_STEPS} "
            f"steps; ms per step {', '.join(f'{t:.2f}' for t in times)} (median after the "
            f"first {statistics.median(times[1:]):.2f}); losses "
            f"{', '.join(f'{v:.4f}' for v in losses)}; first loss {rel:.3%} from fp32's "
            f"{fp32_first:.4f}; peak memory {peak / 2**30:.2f} GiB [{card}]")
        want = tuple(k * TRAIN_STEPS for k in STEP_LAUNCHES[branch])
        check(counts == want, f"{branch} bf16: launches {counts}, expected {want}")
        check_fp32_routes(f"{branch} bf16", 0)
        check_fp32_bwd_routes(f"{branch} bf16", 0, 0)
        check(all(math.isfinite(v) for v in losses), f"{branch} bf16: loss not finite")
        check(rel <= BF16_LOSS_RTOL, f"{branch} bf16 first loss {rel:.3%} from fp32's")
        results[branch]["bf16"] = {"launches": counts, "ms": times,
                                   "ms_median": statistics.median(times[1:]),
                                   "losses": losses, "rel_to_fp32": rel, "peak_bytes": peak}
    return results


# --- phase 7: stage-1 training at full width ----------------------------------


def stage1_setup(vcfg):
    """(raw [0, 1] images of ``synthetic_dataset("MNIST")`` (the CLI's
    offline fallback), their variance, the state dict of seeded random
    full-width VQ-VAE weights with BN statistics set from one batch)."""
    ds = synthetic_dataset("MNIST", n_train=STAGE1_IMAGES, n_test=1, seed=0)
    vq = weights.load_vqvae(*weights.init_vqvae_variables(vcfg, torch.Generator().manual_seed(4)),
                            vcfg, device="cuda")
    batch = torch.from_numpy(ds.train_images[:BATCH]).cuda() - 0.5
    weights.calibrate_batchnorm(vq, lambda: vq(batch, train=False))
    return ds.train_images, data_variance(ds.train_images), vq.state_dict()


def stage1_model(vcfg, state_dict, backend, device, dtype=None):
    vq = SNNVQVAE(vcfg, backend, dtype)
    vq.load_state_dict(state_dict)
    return vq.to(device)


def stage1_batches(images, n):
    """The TRAIN_STEPS batches of size n on the card, shifted to [-0.5, 0.5]:
    the same for every branch and dtype."""
    data = torch.from_numpy(images).cuda()
    return [data[(torch.arange(n, device="cuda") + i * n) % len(data)] - 0.5
            for i in range(TRAIN_STEPS)]


def conv_dtypes(model, run):
    """(every dtype that an encoder or decoder conv took in or gave out, run())."""
    seen = set()

    def hook(module, args, out):
        seen.update((args[0].dtype, out.dtype))

    handles = [m.register_forward_hook(hook)
               for m in (*model.encoder.convs, *model.decoder.deconvs)]
    try:
        return seen, run()
    finally:
        for h in handles:
            h.remove()


def step_profile(what: str, step_ms: float, step) -> dict:
    """One more step under ``torch.profiler``: its kernels' device time by
    kernel (the eight longest logged), and their sum against the timed
    step's median, the share of the step the card was busy."""
    profile = kernel_profile(step)
    busy = sum(v[0] for v in profile.values())
    top = sorted(profile.items(), key=lambda kv: -kv[1][0])[:8]
    log(f"  {what} step by kernel: {busy:.2f} ms of device time in "
        f"{sum(v[1] for v in profile.values())} launches, {busy / step_ms:.1%} of the "
        f"{step_ms:.2f} ms step; " + ", ".join(f"{k} {v[0]:.2f} ms x{v[1]}" for k, v in top))
    return {"busy_ms": busy, "busy_share": busy / step_ms, "kernels": profile}


def spike_trains(model, run):
    """(the spikes of the VQ-VAE's six LIF layers during run(), as the
    layers after them take them in: the encoder's second and third convs,
    the quantizer, the decoder's three deconvs; run())."""
    seen = []

    def hook(module, args):
        seen.append(args[0].detach())

    mods = (*model.encoder.convs[1:], model.vq_layer, *model.decoder.deconvs)
    handles = [m.register_forward_pre_hook(hook) for m in mods]
    try:
        return seen, run()
    finally:
        for h in handles:
            h.remove()


def stage1_codes(vcfg, model, branch, images, card: str) -> tuple:
    """``extract_code_indices`` over the images at batch 256 on the card
    (exact launch counts), the same through the plain versions on the card
    (equal codes, no launch) and on the CPU (the share that agrees is
    logged); ``encode_indices`` images/s at 256 (CUDA events, median of
    5). Returns (codes, row)."""
    backend, plain = STAGE1_BRANCHES[branch]
    sd = model.state_dict()
    reset_launch_counts()
    codes = stage1.extract_code_indices(model, images, batch_size=BATCH)
    counts = launch_counts()
    batches = -(-len(images) // BATCH)
    want = tuple(k * batches for k in STAGE1_ENCODE_LAUNCHES[branch])
    check(counts == want, f"extract_code_indices launches {counts}, expected {want}")
    check(codes.shape == (len(images), 7, 7) and codes.dtype.name == "int32", "code shape")
    check(0 <= int(codes.min()) and int(codes.max()) < vcfg.num_embeddings, "codes outside [0, K)")
    codes_plain = stage1.extract_code_indices(stage1_model(vcfg, sd, plain, "cuda"), images,
                                              batch_size=BATCH)
    check(launch_counts() == counts, "the plain extract_code_indices launched a kernel")
    check(bool((codes == codes_plain).all()), "codes differ from the plain versions' on the card")
    codes_cpu = stage1.extract_code_indices(stage1_model(vcfg, sd, backend, "cpu"), images,
                                            batch_size=BATCH, device="cpu")
    agree = float((codes == codes_cpu).mean())
    batch = torch.from_numpy(images[:BATCH]).cuda() - 0.5
    times = []
    for _ in range(6):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        model.encode_indices(batch)
        ev[1].record()
        ev[1].synchronize()
        times.append(ev[0].elapsed_time(ev[1]))
    ms = statistics.median(times[1:])
    log(f"  extract_code_indices over {len(images)} images: launches {format_counts(counts)}, "
        f"{len(np.unique(codes))} distinct codes, equal to the plain versions' on the card, "
        f"{agree:.4f} of codes agree with the CPU's; encode_indices at batch {BATCH}: "
        f"{ms:.3f} ms, {BATCH / ms * 1e3:.0f} images/s [{card}]")
    return codes, {"launches": counts, "agree_with_cpu": agree, "encode_ms": ms,
                   "encode_images_per_s": BATCH / ms * 1e3}


def phase_train_stage1(vcfg, card: str) -> dict:
    """Stage-1 training of the full-width VQ-VAE on each branch at each
    batch in fp32, in bf16 at batch 256, one epoch of ``train_vqvae`` per
    branch and ``extract_code_indices`` of the trained model:
    {branch: {batch: ..., "bf16": ..., "loop": ..., "codes": ...}}."""
    images, var, sd = stage1_setup(vcfg)
    step_fn = stage1.make_train_step_vqvae(var)
    results = {}
    for branch, (backend, plain) in STAGE1_BRANCHES.items():
        results[branch] = {}
        want = tuple(k * TRAIN_STEPS for k in STAGE1_STEP_LAUNCHES[branch])
        for dtype in (None, torch.bfloat16):
            for n in TRAIN_BATCHES if dtype is None else TRAIN_BATCHES[-1:]:
                state = create_train_state(stage1_model(vcfg, sd, backend, "cuda", dtype))
                batches = stage1_batches(images, n)
                dtypes, (times, losses, first, counts, peak) = conv_dtypes(
                    state.model, lambda: run_steps(state, step_fn, batches))
                dname = "fp32" if dtype is None else "bf16"
                log(f"  {branch} {dname} batch {n}: launches {format_counts(counts)} in "
                    f"{TRAIN_STEPS} steps; ms per step {', '.join(f'{t:.2f}' for t in times)} "
                    f"(median after the first {statistics.median(times[1:]):.2f}); losses "
                    f"{', '.join(f'{v:.4f}' for v in losses)}; peak memory "
                    f"{peak / 2**30:.2f} GiB [{card}]")
                check(counts == want, f"{branch} {dname}: launches {counts}, expected {want}")
                check(all(math.isfinite(v) for v in losses), f"{branch} {dname}: loss not finite")
                check(dtypes == {dtype or torch.float32}, f"{branch} {dname}: convs in {dtypes}")
                row = {"launches": counts, "ms": times, "ms_median": statistics.median(times[1:]),
                       "losses": losses, "peak_bytes": peak}
                row["profile"] = step_profile(f"{branch} {dname} batch {n}", row["ms_median"],
                                              lambda: step_fn(state, batches[0]))
                if dtype is not None:
                    fp32_first = results[branch][n]["losses"][0]
                    row["rel_to_fp32"] = abs(losses[0] - fp32_first) / abs(fp32_first)
                    log(f"  {branch} bf16 first loss {row['rel_to_fp32']:.3%} from fp32's "
                        f"{fp32_first:.4f}")
                    check(row["rel_to_fp32"] <= BF16_LOSS_RTOL, f"{branch} bf16 first loss")
                    results[branch]["bf16"] = row
                    continue
                if n == TRAIN_BATCHES[0]:
                    before = launch_counts()
                    plain_state = create_train_state(stage1_model(vcfg, sd, plain, "cuda"))
                    spikes_card, loss_p = spike_trains(
                        plain_state.model, lambda: step_fn(plain_state, batches[0])["loss"])
                    plain_rec = step_record(plain_state, loss_p)
                    check(launch_counts() == before, "the plain step launched a kernel")
                    cpu_state = create_train_state(stage1_model(vcfg, sd, backend, "cpu"))
                    spikes_cpu, loss_c = spike_trains(
                        cpu_state.model, lambda: step_fn(cpu_state, batches[0].cpu())["loss"])
                    row["vs_plain"] = compare_steps("the plain versions on the card", first,
                                                    plain_rec, True)
                    flips = [int((a.cpu() != b).sum()) for a, b in zip(spikes_card, spikes_cpu)]
                    total = sum(a.numel() for a in spikes_cpu)
                    log(f"  spikes of the six LIF layers that differ between the card and the "
                        f"CPU: {', '.join(map(str, flips))} of {total}")
                    check(sum(flips) <= STAGE1_FLIP_SHARE * total, "spikes differ from the CPU's")
                    row["vs_cpu"] = compare_steps(
                        "the CPU", first, step_record(cpu_state, loss_c), False,
                        STAGE1_CPU_LOSS_ATOL, STATS_TOL, STAGE1_CPU_GRAD_TOL)
                    row["vs_cpu"]["spikes_differing"] = flips
                results[branch][n] = row
        # the loop a user calls, then the codes it hands to stage 2
        logged = []
        model = stage1_model(vcfg, sd, backend, "cuda")
        reset_launch_counts()
        t0 = time.perf_counter()
        state = stage1.train_vqvae(model, images[:STAGE1_EPOCH_IMAGES], var, epochs=1,
                                   batch_size=TRAIN_BATCHES[0], seed=0, log_every=1,
                                   log_fn=logged.append)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        losses = [float(line.split("loss ")[1].split()[0]) for line in logged if "loss " in line]
        log(f"  {branch} train_vqvae: {state.step} steps at batch {TRAIN_BATCHES[0]} in "
            f"{seconds:.2f} s (host clock), launches {format_counts(counts)}; losses "
            f"{', '.join(f'{v:.3f}' for v in losses)}")
        check(state.step == STAGE1_EPOCH_IMAGES // TRAIN_BATCHES[0], "train_vqvae step count")
        check(counts == tuple(k * state.step for k in STAGE1_STEP_LAUNCHES[branch]),
              f"{branch} train_vqvae launches {counts}")
        check(len(losses) == state.step and all(math.isfinite(v) for v in losses),
              f"{branch} train_vqvae losses {losses}")
        results[branch]["loop"] = {"launches": counts, "seconds": seconds, "losses": losses}
        codes, results[branch]["codes"] = stage1_codes(vcfg, state.model, branch, images, card)
        results[branch]["codes_array"] = codes
    return results


def stage_launches(rows: dict, idx: int) -> int:
    """A kernel's launches (index ``idx`` of ``launch_counts()``) summed over
    a training phase's runs of one branch."""
    return sum(r["launches"][idx] for r in rows.values())


def stage1_times(res: dict, key: str) -> dict:
    """A kernel's stage-1 times per training step (K1's forward also on a
    bf16 input) and its rows by shape."""
    return {"ms": res[f"{key}_ms"], "plain_ms": res[f"{key}_plain_ms"],
            "bound_ms": res[f"{key}_bound_ms"],
            **({"bf16": {"ms": res["fwd_bf16_ms"], "bound_ms": res["fwd_bf16_bound_ms"]}}
               if f"{key}_bf16_ms" in res else {}),
            "shapes": [{k: v for k, v in r.items() if not k.startswith(
                "bwd" if key == "fwd" else "fwd")} for r in res["rows"]]}


# --- phase 9: the committed trained weights ---------------------------------


def load_trained(name: str, module: torch.nn.Module, device) -> torch.nn.Module:
    """An exported state dict (``weights_only``) into a full-width module,
    strictly, in eval mode on ``device``."""
    sub = TRAINED / ("diff_result" if name == "diff_model" else "")
    ckpt = torch.load(sub / f"{name}.pt", map_location=device, weights_only=True)
    module.load_state_dict(ckpt["model"], strict=True)
    return module.to(device).eval()


def cli_chunk(flags) -> int:
    """The sampling chunk of a CLI run: min(512, 16 * --sample_batches)."""
    return min(512, 16 * cli.parse_args(flags).sample_batches)


def k2_trained_sizes() -> list:
    """Batch 256 and the chunk sizes of the CLI runs of phase cli."""
    return sorted({BATCH} | {cli_chunk(f) for f in (CLI_TRAIN_FLAGS, CLI_EVAL_FLAGS,
                                                   CLI_GATE_FLAGS)})


def k1_launches_of(run) -> list:
    """(x, v_init, params) of every K1 forward launch that ``run()`` makes,
    copied as the kernel gets them."""
    seen = []
    fwd = lif_op.lif_fwd

    def record(x, v_init=None, params=NeuronParams()):
        seen.append((x.clone(), None if v_init is None else v_init.clone(), params))
        return fwd(x, v_init, params)

    lif_op.lif_fwd = record
    try:
        with torch.no_grad():
            run()
    finally:
        lif_op.lif_fwd = fwd
    return seen


def k2_probes(dcfg, n: int, codes: torch.Tensor, gen: torch.Generator) -> list:
    """K2's inputs on trained weights at batch n: the first reverse step
    (all masked, t = T) and a grid of ``codes`` (repeated to n), half
    masked, at t = 25."""
    h = dcfg.latent_size
    grids = codes.repeat(-(-n // len(codes)), 1, 1)[:n]
    first = (torch.full((n, h, h), dcfg.mask_id, dtype=torch.int32, device="cuda"),
             torch.full((n,), dcfg.num_timesteps, dtype=torch.int32, device="cuda"))
    half = torch.rand((n, h, h), generator=gen, device="cuda") < 0.5
    mid = (torch.where(half, torch.full_like(grids, dcfg.mask_id), grids),
           torch.full((n,), 25, dtype=torch.int32, device="cuda"))
    return [("first step", first), ("t=25", mid)]


def compare_k2_probes(what: str, den, dcfg, inputs: list) -> dict:
    """K2 against its plain version on ``den``'s weights folded for each
    sampler dtype, on each of ``inputs``; max |d logits| per dtype."""
    err = {}
    for label, (tokens, t) in inputs:
        for name, dtype in K2_DTYPES.items():
            folded = fd.fold_denoiser_weights(den, dtype)
            a1 = fd.first_preactivation(tokens, t, folded.k1, folded.b1)
            d = compare_k2(f"{name} {what}, {label}", folded, a1, dcfg)
            err[name] = max(err.get(name, 0.0), d)
    return err


def fused_logit_share(den, dcfg, inputs: list) -> dict:
    """The share of the fused fp32 sampler's logits within K2_AGREE_ATOL
    of the layerwise denoiser's (``den``'s own forward), on each input."""
    share = {}
    for label, (tokens, t) in inputs:
        with torch.no_grad():
            fused = fd.make_fused_denoise_fn(den, dcfg, torch.float32)(tokens, t)
            d = (fused - den(tokens, t)).abs()
        share[label] = float((d <= K2_AGREE_ATOL).float().mean())
        log(f"  fused fp32 logits within {K2_AGREE_ATOL:g} of the layerwise ones, "
            f"{label}, N={len(tokens)}: {share[label]:.6f}")
    return share


def phase_trained_weights(card: str) -> dict:
    """The trained weights on the card: recon card against CPU, the
    encoder's codes card against CPU, and the samplers on one set of
    per-step noise, K2 against its plain version on their logits."""
    dcfg, vcfg = DiffusionConfig(), VQVAEConfig()
    vq = load_trained("model", SNNVQVAE(vcfg), "cuda")
    vq_cpu = load_trained("model", SNNVQVAE(vcfg), "cpu")
    den = load_trained("diff_model", SpikingDenoiser(dcfg), "cuda")
    ds = synthetic_dataset("MNIST", n_train=0, n_test=TRAINED_IMAGES)
    args = argparse.Namespace(batch_size=BATCH)
    reset_launch_counts()
    t0 = time.perf_counter()
    card_recon = cli._eval_recon(args, vq, ds, torch.device("cuda"))
    card_s = time.perf_counter() - t0
    counts = launch_counts()
    t0 = time.perf_counter()
    cpu_recon = cli._eval_recon(args, vq_cpu, ds, torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    d_recon = [abs(a - b) for a, b in zip(card_recon, cpu_recon)]
    log(f"  recon of {TRAINED_IMAGES} images, fp32: card MSE {card_recon[0]:.8f}, 1 - SSIM "
        f"{card_recon[1]:.8f} in {card_s:.2f} s [{card}]; CPU MSE {cpu_recon[0]:.8f}, 1 - SSIM "
        f"{cpu_recon[1]:.8f} in {cpu_s:.2f} s; |d| {d_recon[0]:.3g}, {d_recon[1]:.3g} "
        f"(tol {STAGE1_CPU_LOSS_ATOL:g}); launches {format_counts(counts)}")
    want = (6 * TRAINED_IMAGES // BATCH, 0, 0, 0, 0, 0, 0)
    check(counts == want, f"recon launches {counts}, expected {want}")
    check(max(d_recon) <= STAGE1_CPU_LOSS_ATOL, "trained recon: card against CPU")
    x = torch.from_numpy(ds.test_images - 0.5)
    codes_card = vq.encode_indices(x.cuda()).cpu()
    codes_agree = float((codes_card == vq_cpu.encode_indices(x)).float().mean())
    log(f"  encode_indices of {TRAINED_IMAGES} images: codes agreeing card against CPU "
        f"{codes_agree:.6f}, {len(torch.unique(codes_card))} distinct codes")

    steps = len(diffusion.schedule(dcfg)[0])
    gen = torch.Generator(device="cuda").manual_seed(TRAINED_STEP_NOISE_SEED)
    noise = list(diffusion.draw_noise(dcfg, BATCH, steps, gen, "cuda"))
    codes = {"layerwise fp32": sample_codes(den, dcfg, BATCH, noise=noise, device="cuda")}
    for name, dtype in K2_DTYPES.items():
        fd.LAUNCHES = 0
        codes[f"fused {name}"] = sample_codes(den, dcfg, BATCH, noise=noise, device="cuda",
                                              fused=True, dtype=dtype)
        check(fd.LAUNCHES == K2_STEP_LAUNCHES, f"fused {name}: {fd.LAUNCHES} K2 launches")
    agree = {k: float((v == codes["layerwise fp32"]).float().mean()) for k, v in codes.items()}
    for key, value in codes.items():
        images = vq.decode_indices(value)
        check_outputs(value, images, BATCH, dcfg)
    log("  codes at batch 256 on one set of per-step noise, share agreeing with layerwise "
        "fp32: " + ", ".join(f"{k} {v:.4f}" for k, v in agree.items()))

    # K2 on the trained weights: the first reverse step (all masked, t = T)
    # and a half-masked grid of the layerwise codes at t = 25, at batch 256
    # and at the chunk sizes of the CLI's sweeps (fp32 in its training run,
    # bf16 in its eval), on the eval's own denoiser ('bnlif', bf16)
    den_eval = load_trained("diff_model", SpikingDenoiser(dcfg, lif_backend="bnlif",
                                                          dtype=torch.bfloat16), "cuda")
    k2_err, logit_share = {}, {}
    for n in k2_trained_sizes():
        inputs = k2_probes(dcfg, n, codes["layerwise fp32"], gen)
        for name, err in compare_k2_probes("trained", den_eval, dcfg, inputs).items():
            k2_err[name] = max(k2_err.get(name, 0.0), err)
        if n == BATCH:
            logit_share = fused_logit_share(den, dcfg, inputs)

    # K1 at the CLI eval's shapes (bf16 models, the eval's batch): every
    # launch of a decode of one sampling chunk, of a recon batch and of the
    # remainder batch of extract_code_indices, held against the plain version
    vq_eval = load_trained("model", SNNVQVAE(vcfg, dtype=torch.bfloat16), "cuda")
    args = cli.parse_args(CLI_EVAL_FLAGS)
    chunk = cli_chunk(CLI_EVAL_FLAGS)
    grids = codes["layerwise fp32"].repeat(-(-chunk // BATCH), 1, 1)[:chunk]
    images = torch.from_numpy(ds.test_images - 0.5).cuda()
    images = images.repeat(-(-args.batch_size // len(images)), 1, 1, 1)
    remainder = args.synthetic_train % 256 or 256
    k1_err = 0.0
    for what, run in ((f"decode of {chunk} grids", lambda: vq_eval.decode_indices(grids)),
                      (f"recon of {args.batch_size} images",
                       lambda: vq_eval(images[:args.batch_size], train=False)),
                      (f"encode_indices of {remainder} images",
                       lambda: vq_eval.encode_indices(images[:remainder]))):
        launches = k1_launches_of(run)
        rates = []
        for x, v_init, params in launches:
            k1_err = max(k1_err, compare_lif(x, v_init, params, rate_range=None))
            rates.append(float(lif_op.lif_fwd_reference(x, v_init, params)[0].mean()))
        log(f"  K1 at the CLI eval's {what}, bf16: {len(launches)} launches, M "
            f"{[x.shape[1] for x, _, _ in launches]}, firing rates "
            f"{[round(r, 4) for r in rates]}, bitwise equal")
        check(len(launches) > 0 and max(rates) > 0, f"K1 at the {what}: no spikes")
    return {"recon_card": card_recon, "recon_cpu": cpu_recon, "recon_seconds": [card_s, cpu_s],
            "codes_card_vs_cpu": codes_agree, "sampler_agree": agree, "k2_max_abs_err": k2_err,
            "fused_logits_within_1e-5": logit_share, "k1_cli_max_abs_err": k1_err}


# --- phase 10: the op/energy profiler ----------------------------------------


def syops_images(n: int) -> torch.Tensor:
    """The first n test images as the CLI loads them at its default sizes
    (the synthetic fallback), minus 0.5, on the card."""
    args = cli.parse_args([])
    ds = synthetic_dataset("MNIST", args.synthetic_train, args.synthetic_test)
    return torch.from_numpy(ds.test_images[:n] - 0.5).cuda()


def total_entry(total: dict) -> dict:
    """The totals as an entry: ops, acs, macs, rate (the mean rate)."""
    return {"ops": total["ops"], "acs": total["acs"], "macs": total["macs"],
            "rate": total["mean_spike_rate"]}


def hold_entry(what: str, got: dict, want: dict) -> tuple:
    """An entry against a reference: ops and MACs equal, the rate within
    SYOPS_RATE_ATOL, the ACs within SYOPS_ACS_SHARE of the ops. Returns
    (|d rate|, |d ACs| / ops)."""
    d_rate = abs(got["rate"] - want["rate"])
    d_acs = abs(got["acs"] - want["acs"]) / want["ops"]
    check(got["ops"] == want["ops"] and got["macs"] == want["macs"],
          f"{what}: ops, MACs {got['ops']}, {got['macs']} against {want['ops']}, {want['macs']}")
    check(d_rate <= SYOPS_RATE_ATOL and d_acs <= SYOPS_ACS_SHARE,
          f"{what}: rate {got['rate']} against {want['rate']}, ACs {got['acs']} against "
          f"{want['acs']}")
    return d_rate, d_acs


def hold_counts(what: str, per_layer: dict, total: dict, want_layer: dict,
                want_total: dict) -> tuple:
    """A profile against a reference, layer by layer and in total: the same
    keys, each entry held by ``hold_entry``. Returns the largest |d rate|
    and |d ACs| / ops."""
    check(list(per_layer) == list(want_layer), f"{what}: keys {list(per_layer)}")
    pairs = [(k, e, want_layer[k]) for k, e in per_layer.items()]
    pairs.append(("totals", total_entry(total), total_entry(want_total)))
    diffs = [hold_entry(f"{what}, {k}", e, w) for k, e, w in pairs]
    return max(d[0] for d in diffs), max(d[1] for d in diffs)


def hook_count(model: torch.nn.Module) -> int:
    """Forward hooks on the model's modules, and LIF layers under a profile."""
    return sum(len(m._forward_hooks) + len(m._forward_pre_hooks)
               + (isinstance(m, LIF) and m.profile is not None) for m in model.modules())


def add_counts(acc: list, counts: tuple) -> None:
    for i, c in enumerate(counts):
        acc[i] += c


def phase_syops(card: str) -> dict:
    """The op/energy profiler on the trained weights, with a
    ``DeviceMonitor`` sampling the card's memory across it."""
    dm = monitor.DeviceMonitor(interval=SYOPS_MONITOR_S)
    try:
        res = syops_checks(card)
    finally:
        records = dm.stop()
    in_use = [r["0"]["bytes_in_use"] for r in records if "0" in r]
    res["device_monitor"] = dm.summary()
    log(f"  DeviceMonitor: {len(records)} samples every {SYOPS_MONITOR_S} s, bytes in use "
        f"{min(in_use, default=0)}..{max(in_use, default=0)}, summary {res['device_monitor']}")
    check(max(in_use, default=0) > 0, "DeviceMonitor saw no bytes in use")
    return res


def syops_checks(card: str) -> dict:
    """The trained VQ-VAE profiled on 'auto' (K1) and 'bnlif' (K3): the
    first 32 test images against the JAX package's record, 256 against the
    CPU; the trained denoiser at the default probes of 64 sampled grids on
    both branches; ``generation_energy``; no hook left and the launches of
    a layerwise sample unchanged; the cost of counting (``benchmark``);
    ``trace`` names each branch's kernel."""
    dcfg, vcfg = DiffusionConfig(), VQVAEConfig()
    with open(SYOPS_RECORD) as f:
        record = json.load(f)
    args = cli.parse_args([])
    check(record["images"] == SYOPS_RECORD_IMAGES == args.batch_size
          and record["data_sizes"] == [args.synthetic_train, args.synthetic_test],
          "the JAX record's images are not the CLI's")
    images = syops_images(BATCH)
    branches = tuple(SYOPS_VQ_LAUNCHES)
    vqs = {b: load_trained("model", SNNVQVAE(vcfg, lif_backend=b), "cuda") for b in branches}
    dens = {b: load_trained("diff_model", SpikingDenoiser(dcfg, lif_backend=b), "cuda")
            for b in branches}
    models = list(vqs.values()) + list(dens.values())
    check(all(hook_count(m) == 0 for m in models), "hooks on a model before profiling")
    steps = len(diffusion.schedule(dcfg)[0])

    def layerwise_sample():
        gen = torch.Generator(device="cuda").manual_seed(TRAINED_STEP_NOISE_SEED)
        noise = diffusion.draw_noise(dcfg, SYOPS_SAMPLE_BATCH, steps, gen, "cuda")
        reset_launch_counts()
        codes = sample_codes(dens["auto"], dcfg, SYOPS_SAMPLE_BATCH, noise=noise, device="cuda")
        return codes, launch_counts()

    codes_before, launches_before = layerwise_sample()
    check(launches_before == (5 * steps, 0, 0, 0, 0, 0, 0),
          f"layerwise sample launches {launches_before}")
    launches = [0] * 7
    res = {"vqvae": {}}
    for branch, vq in vqs.items():
        reset_launch_counts()
        _, per_layer, total = syops.profile_apply(vq, images[:SYOPS_RECORD_IMAGES], train=False)
        counts = launch_counts()
        add_counts(launches, counts)
        check(counts == SYOPS_VQ_LAUNCHES[branch], f"{branch}: profile launches {counts}")
        check(len(per_layer) == SYOPS_LAYERS, f"{branch}: {len(per_layer)} layers")
        rec = record[branch]
        d_rec = hold_counts(f"{branch} against the JAX record", per_layer, total,
                            rec["per_layer"], rec["totals"])
        n_params = syops.count_params(vq)
        check(n_params == rec["count_params"], f"{branch}: {n_params} parameters")
        reset_launch_counts()
        _, per_layer, total = syops.profile_apply(vq, images, train=False)
        counts = launch_counts()
        add_counts(launches, counts)
        check(counts == SYOPS_VQ_LAUNCHES[branch], f"{branch}: profile launches {counts}")
        vq_cpu = load_trained("model", SNNVQVAE(vcfg, lif_backend=branch), "cpu")
        _, per_layer_cpu, total_cpu = syops.profile_apply(vq_cpu, images.cpu(), train=False)
        d_cpu = hold_counts(f"{branch} card against the CPU", per_layer, total, per_layer_cpu,
                            total_cpu)
        log(f"  VQ-VAE {branch}, eval: launches {format_counts(counts)}; {SYOPS_RECORD_IMAGES} "
            f"images against the JAX record: max|d rate| {d_rec[0]:.3g}, max|d ACs|/ops "
            f"{d_rec[1]:.3g}; {BATCH} images card against the CPU: {d_cpu[0]:.3g}, "
            f"{d_cpu[1]:.3g} (tol {SYOPS_RATE_ATOL:g}, {SYOPS_ACS_SHARE:g}); at {BATCH}: ops "
            f"{total['ops']:.6e}, ACs {total['acs']:.6e}, MACs {total['macs']:.6e}, mean rate "
            f"{total['mean_spike_rate']:.6f}, {total['energy_mJ']:.6f} mJ, {n_params} "
            "parameters")
        res["vqvae"][branch] = {"totals": total, "against_record": d_rec, "against_cpu": d_cpu}

    # the denoiser at the default probes of 64 grids sampled at 0.8
    gen = torch.Generator(device="cuda").manual_seed(TRAINED_STEP_NOISE_SEED + 1)
    codes = sample_codes(dens["auto"], dcfg, SYOPS_SAMPLES, temperature=0.8, generator=gen,
                         device="cuda")
    probes = []
    for t in syops.default_probe_steps(dcfg):
        t_vec = torch.full((SYOPS_SAMPLES,), t, dtype=torch.int32, device="cuda")
        u = torch.rand(codes.shape, generator=gen, device="cuda")
        probes.append((diffusion.q_sample(codes, t_vec, dcfg.mask_id, dcfg.num_timesteps,
                                          u)[0], t_vec))
    probe_totals = {}
    for branch, den in dens.items():
        probe_totals[branch] = []
        for x_t, t_vec in probes:
            reset_launch_counts()
            _, _, total = syops.profile_apply(den, x_t, t_vec)
            counts = launch_counts()
            add_counts(launches, counts)
            check(counts == SYOPS_DEN_LAUNCHES[branch], f"denoiser {branch}: launches {counts}")
            probe_totals[branch].append(total)
    d_den = [hold_entry(f"denoiser probe t={int(t_vec[0])}, 'bnlif' against 'auto'",
                        total_entry(b), total_entry(a))
             for (_, t_vec), a, b in zip(probes, *probe_totals.values())]
    log(f"  denoiser at the probes {syops.default_probe_steps(dcfg)} of {SYOPS_SAMPLES} grids: "
        + "; ".join(f"t={int(t_vec[0])}: ops {a['ops']:.6e}, ACs {a['acs']:.6e}, MACs "
                    f"{a['macs']:.6e}, mean rate {a['mean_spike_rate']:.6f}"
                    for (_, t_vec), a in zip(probes, probe_totals["auto"]))
        + f"; 'bnlif' against 'auto': max|d rate| {max(d[0] for d in d_den):.3g}, max|d ACs|/ops "
        f"{max(d[1] for d in d_den):.3g}")
    res["denoiser_probes"] = probe_totals

    gen = torch.Generator(device="cuda").manual_seed(TRAINED_STEP_NOISE_SEED + 2)
    reset_launch_counts()
    energy = syops.generation_energy(dens["auto"], vqs["auto"], dcfg, gen,
                                     n_samples=SYOPS_SAMPLES, device="cuda")
    counts = launch_counts()
    add_counts(launches, counts)
    probes_n = len(syops.default_probe_steps(dcfg))
    want = (5 * steps + 5 * probes_n + K1_DECODE_LAUNCHES, 0, 0, 0, 0, 0, 0)
    log(f"  generation_energy at {SYOPS_SAMPLES} samples, layerwise: "
        + ", ".join(f"{k} {v!r}" for k, v in energy.items())
        + f"; launches {format_counts(counts)}")
    check(counts == want, f"generation_energy launches {counts}, expected {want}")
    check(all(math.isfinite(v) and v > 0 for v in energy.values()),
          f"generation_energy {energy}")
    check(0 < energy["denoiser_spike_rate"] < 1, "denoiser spike rate outside (0, 1)")
    res["generation_energy"] = energy

    # profiling off: no hook left, and a sample launches what it did before
    check(all(hook_count(m) == 0 for m in models), "a hook or profile left on a model")
    codes_after, launches_after = layerwise_sample()
    check(launches_after == launches_before and torch.equal(codes_after, codes_before),
          f"layerwise sample after profiling: launches {launches_after}")
    log(f"  profiling off: no hook on any model; a layerwise sample at {SYOPS_SAMPLE_BATCH} "
        f"launches {format_counts(launches_after)} before and after, the same codes")

    res["timing"] = {}
    for branch, vq in vqs.items():
        plain = benchmark(lambda: vq(images, train=False), iters=SYOPS_TIMING_ITERS)
        counted = benchmark(lambda: syops.profile_apply(vq, images, train=False),
                            iters=SYOPS_TIMING_ITERS)
        res["timing"][branch] = {"forward": plain, "profiled": counted}
        log(f"  VQ-VAE {branch} eval forward at {BATCH} (CUDA events, mean of "
            f"{SYOPS_TIMING_ITERS}): {plain['mean_ms']:.3f} ms (min {plain['min_ms']:.3f}); "
            f"profiled {counted['mean_ms']:.3f} ms (min {counted['min_ms']:.3f}) [{card}]")

    res["trace"] = {}
    with tempfile.TemporaryDirectory() as root:
        for branch, vq in vqs.items():
            with trace(os.path.join(root, branch)) as log_dir:
                vq(images, train=False)
            with open(os.path.join(log_dir, "trace.json")) as f:
                events = json.load(f)["traceEvents"]
            names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
            hits = [n for n in names if TRACE_KERNELS[branch].search(n)]
            others = [n for b, pat in TRACE_KERNELS.items() if b != branch
                      for n in names if pat.search(n)]
            log(f"  trace of one {branch} forward: {len(names)} kernel events, {len(hits)} of "
                f"{sorted(set(hits))}")
            check(len(hits) == SYOPS_VQ_LAUNCHES[branch][0 if branch == "auto" else 2]
                  and not others, f"{branch} trace: kernels {sorted(set(names))}")
            res["trace"][branch] = len(hits)
    res["launches"] = tuple(launches)
    return res


# --- phase 11: the command-line interface -------------------------------------


def temperatures(args) -> list:
    return [float(t) for t in args.temperatures.split(",")]


def cli_launches(args) -> tuple:
    """Launches of a ``cli.main`` run on the card, as ``launch_counts()``
    orders them, from its parsed flags.

    Stage 1 (unless ``--checkpoint``): 6 + 6 K1 a step, and each epoch's
    recon grid 6 K1. Codes: 3 K1 per batch of 256. Stage 2 (unless
    ``--checkpoint``) on 'bnlif': 5 + 5 K3 a step over twice the epochs,
    every 10th epoch 32 layerwise samples (5 K3 per reverse step) and their
    decode (3 K1). Recon: 6 K1 per batch. Each temperature: 49 K2 and a
    decode (3 K1) per chunk of up to 512 images. ``--syops``: one eval
    forward of the stage-1 model (6 K1). The ANN VQ-VAE (``--model
    vq-vae``) runs no kernel: its runs launch the K3 and K2 terms only.
    ``--model snn-vae``: ``snn_vae_cli_launches``."""
    if args.model == "snn-vae":
        return snn_vae_cli_launches(args)
    spiking = 0 if args.model == "vq-vae" else 1  # stage 1's K1 launches
    steps = 49
    n_train, batch = args.synthetic_train, args.batch_size
    k1_fwd = 3 * -(-n_train // 256) + 6 * (args.synthetic_test // batch)
    k1_bwd = k3_fwd = k3_bwd = 0
    if args.syops:
        k1_fwd += SYOPS_VQ_LAUNCHES["auto"][0]
    if not args.checkpoint:
        epochs, steps1 = args.epochs, n_train // batch
        samples = len(range(0, 2 * epochs, 10))
        k1_fwd += 6 * (steps1 + 1) * epochs + K1_DECODE_LAUNCHES * samples
        k1_bwd = 6 * steps1 * epochs
        k3_fwd = K3_PER_STEP * (2 * epochs * steps1 + steps * samples)
        k3_bwd = K3_PER_STEP * 2 * epochs * steps1
    n_total = args.sample_batches * 16
    chunks = len(temperatures(args)) * -(-n_total // min(512, n_total))
    return (spiking * (k1_fwd + K1_DECODE_LAUNCHES * chunks), spiking * k1_bwd, k3_fwd,
            k3_bwd, K2_STEP_LAUNCHES * chunks, 0, 0)


def snn_vae_cli_launches(args) -> tuple:
    """Launches of a ``--model snn-vae`` run (the CLI maps every
    ``--lif_backend`` to 'auto'): 7 + 7 K1 a training step (unless
    ``--checkpoint``), then 3 K1 per ``sample`` call, one for the grid and
    ``cli.SNN_VAE_SAMPLE_CALLS`` for the scores."""
    steps = 0 if args.checkpoint else args.epochs * (args.synthetic_train // args.batch_size)
    fwd, bwd = SNN_VAE_STEP_LAUNCHES["layerwise"][:2]
    sample = SNN_VAE_SAMPLE_LAUNCHES["layerwise"][0] * (1 + cli.SNN_VAE_SAMPLE_CALLS)
    return (fwd * steps + sample, bwd * steps, 0, 0, 0, 0, 0)


class Tee(io.TextIOBase):
    """A text stream that writes to ``stream`` and keeps a copy."""

    def __init__(self, stream):
        self.stream, self.copy = stream, io.StringIO()

    def write(self, text: str) -> int:
        self.copy.write(text)
        return self.stream.write(text)

    def flush(self) -> None:
        self.stream.flush()


def cli_run(flags, root: str, card: str) -> tuple:
    """``cli.main(flags)`` on the card with the counts reset just before,
    held to ``cli_launches``: (its return, its sample dir, its result dir,
    launches, what it printed)."""
    dirs = ["--result_dir", os.path.join(root, "result"),
            "--sample_dir", os.path.join(root, "sample")]
    args = cli.parse_args(flags)
    want = cli_launches(args)
    reset_launch_counts()
    t0 = time.perf_counter()
    tee = Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        out = cli.main(flags + dirs, device="cuda")
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    figures = (f"recon MSE {out['recon_mse']:.6f}, 1 - SSIM {out['recon_ssim_loss']:.6f}"
               if "recon_mse" in out else
               f"IS {out['IS']:.4f}, KID_x1e3 {out['KID_x1e3']:.4f}, FID {out['FID']:.4f}")
    log(f"  cli.main {' '.join(flags)}: {seconds:.1f} s (host clock); stages "
        + ", ".join(f"{k} {v:.2f} s" for k, v in out["seconds"].items())
        + f"; {figures}; launches {format_counts(counts)} [{card}]")
    check(counts == want, f"cli launches {counts}, expected {want}")
    model_dir = os.path.join(args.dataset_name, args.model)
    return out, os.path.join(root, "sample", model_dir), os.path.join(root, "result", model_dir), \
        counts, tee.copy.getvalue()


def check_syops_report(printed: str, layers: int = SYOPS_LAYERS) -> list:
    """The ``--syops`` report in a CLI run's output: the header, a row per
    counted layer (``layers``: the VQ-VAE's 'auto' branch has 19, the ANN
    VQ-VAE none), the rule, the TOTAL row, the parameters line and the
    three summary lines, in the JAX CLI's format; returns its lines."""
    lines = printed.splitlines()
    heads = [i for i, line in enumerate(lines) if line.split()[:2] == ["layer", "Ops"]]
    check(len(heads) == 1, f"{len(heads)} --syops reports")
    report = lines[heads[0]:heads[0] + layers + 7]
    rows, tail = report[1:layers + 1], report[layers + 1:]
    check(all(r.split()[0].endswith("/counters") and r.endswith("%") for r in rows),
          "--syops rows")
    check(len(tail) == 6 and tail[0] == "-" * 112 and tail[1].startswith("TOTAL ")
          and tail[2].startswith("params: "), "--syops TOTAL and params lines")
    for line, label in zip(tail[3:], ("Computational complexity ACs:",
                                      "Computational complexity MACs:",
                                      "Number of parameters: ")):
        check(line.startswith(f"{label:<30}  "), f"--syops summary line {line!r}")
    return report


def check_metrics(path: str, flags) -> dict:
    """metrics.json with the JAX CLI's keys and finite values."""
    with open(os.path.join(path, "metrics.json")) as f:
        metrics = json.load(f)
    temps = temperatures(cli.parse_args(flags))
    keys = {str(t) for t in temps} | {"null_FID", "feature_space"}
    check(set(metrics) == keys, f"metrics.json keys {sorted(metrics)}")
    for t in temps:
        entry = metrics[str(t)]
        check(set(entry) == {"images_per_sec", "IS", "FID", "KID_x1e3", "mode_KL",
                             "covered_modes"}, f"metrics.json {t}: keys {sorted(entry)}")
        check(all(math.isfinite(v) for v in entry.values()), f"metrics.json {t}: {entry}")
    check(set(metrics["feature_space"]) == {"frozen", "name", "sha256", "stats_verified",
                                            "ref_size"}, "metrics.json feature_space keys")
    check(math.isfinite(metrics["null_FID"]), "null FID not finite")
    return metrics


def phase_cli(card: str) -> dict:
    """``cli.main`` three times on the card: a short two-stage training run,
    the eval of the committed trained weights with the JAX record's flags,
    and that eval at 0.8 over 8,192 images, the gate on its FID."""
    with tempfile.TemporaryDirectory() as root:
        out, sample, result, train_counts, printed = cli_run(CLI_TRAIN_FLAGS, root, card)
        report = check_syops_report(printed)
        log(f"  --syops: a report of {SYOPS_LAYERS} layers, {report[SYOPS_LAYERS + 2]!r}")
        for name in ("epoch=0_test.png", "model.pt", "diff_result/epoch=0_test.png",
                     "diff_result/diff_model.pt"):
            check(os.path.isfile(os.path.join(result, name)), f"no {name}")
        for name in ("0.8/image_0.8_0.png", "paper_image.png"):
            check(os.path.isfile(os.path.join(sample, name)), f"no {name}")
        check(len(os.listdir(os.path.join(sample, "classes"))) > 0, "no classes/ grids")
        check_metrics(sample, CLI_TRAIN_FLAGS)
        train = {"launches": train_counts, "seconds": out["seconds"],
                 "recon": [out["recon_mse"], out["recon_ssim_loss"]], "syops": report[-6:]}

    with tempfile.TemporaryDirectory() as root:
        out, sample, _, eval_counts, _ = cli_run(CLI_EVAL_FLAGS, root, card)
        metrics = check_metrics(sample, CLI_EVAL_FLAGS)
    temps = temperatures(cli.parse_args(CLI_EVAL_FLAGS))
    space = metrics["feature_space"]
    log(f"  eval: feature space {space}; null FID {metrics['null_FID']} (JAX record "
        f"{JAX_RECORD['null_FID']})")
    for t in temps:
        entry, rec = metrics[str(t)], JAX_RECORD[str(t)]
        log(f"  eval temperature {t}: " + ", ".join(
            f"{k} {entry[k]} (JAX record {rec[k]})" for k in rec)
            + f"; {entry['images_per_sec']} images/s [{card}]")
    check(space["stats_verified"] and space["frozen"], "frozen stats not verified")
    check(space["sha256"] == JAX_RECORD["sha256"], f"feature space {space['sha256']}")
    check(abs(metrics["null_FID"] - JAX_RECORD["null_FID"]) <= NULL_FID_ATOL,
          f"null FID {metrics['null_FID']}")
    check(all(metrics[str(t)]["covered_modes"] == 10 for t in temps),
          "a mode not covered")
    check(metrics["0.8"]["FID"] < FID_08_BOUND,
          f"FID at 0.8 {metrics['0.8']['FID']} not under {FID_08_BOUND}")
    evaluation = {"launches": eval_counts, "seconds": out["seconds"],
                  "recon": [out["recon_mse"], out["recon_ssim_loss"]], "metrics": metrics}

    with tempfile.TemporaryDirectory() as root:
        out, sample, _, gate_counts, _ = cli_run(CLI_GATE_FLAGS, root, card)
        gate = check_metrics(sample, CLI_GATE_FLAGS)
    n_gate = cli.parse_args(CLI_GATE_FLAGS).sample_batches * 16
    log(f"  gate: FID at 0.8 over {n_gate} images {gate['0.8']['FID']} (bound "
        f"{FID_GATE_BOUND:.4f}), IS {gate['0.8']['IS']}, KID_x1e3 {gate['0.8']['KID_x1e3']}, "
        f"mode_KL {gate['0.8']['mode_KL']}, {gate['0.8']['covered_modes']} modes; "
        f"{gate['0.8']['images_per_sec']} images/s [{card}]")
    check(gate["0.8"]["covered_modes"] == 10, "gate: a mode not covered")
    check(gate["0.8"]["FID"] < FID_GATE_BOUND,
          f"FID at 0.8 over {n_gate} images {gate['0.8']['FID']} not under {FID_GATE_BOUND}")
    return {"train": train, "eval": evaluation,
            "gate": {"launches": gate_counts, "seconds": out["seconds"], "metrics": gate}}


CLI_RUNS = ("train", "eval", "gate")


def cli_launch_counts(runs: dict, idx: int) -> dict:
    """A kernel's launches (index ``idx`` of ``launch_counts()``) in each
    CLI run."""
    return {run: runs[run]["launches"][idx] for run in CLI_RUNS}


# --- phases 12-14: the paper's baselines and the metrics' other modules ------


def baseline_model(model: str, module: torch.nn.Module, device) -> torch.nn.Module:
    """A baseline's exported stage-1 state dict (``weights_only``) into a
    full-width module, strictly, in eval mode on ``device``."""
    ckpt = torch.load(BASELINES / model / "model.pt", map_location=device, weights_only=True)
    module.load_state_dict(ckpt["model"], strict=True)
    return module.to(device).eval()


def phase_cli_vq_vae(card: str) -> dict:
    """``--model vq-vae`` (the ANN VQ-VAE) through ``cli.main`` on the card:
    a short two-stage training run (exact K3 and K2 launches, no K1) with
    ``--syops`` (no counted layer), the eval of the exported baseline with
    its record's flags, and its recon of 1,024 images card against CPU."""
    with tempfile.TemporaryDirectory() as root:
        out, sample, result, train_counts, printed = cli_run(CLI_VQ_TRAIN_FLAGS, root, card)
        report = check_syops_report(printed, layers=0)
        log(f"  --syops of the ANN VQ-VAE: no layer rows, {report[2]!r}")
        for name in ("epoch=0_test.png", "model.pt", "diff_result/epoch=0_test.png",
                     "diff_result/diff_model.pt"):
            check(os.path.isfile(os.path.join(result, name)), f"vq-vae: no {name}")
        for name in ("0.8/image_0.8_0.png", "paper_image.png"):
            check(os.path.isfile(os.path.join(sample, name)), f"vq-vae: no {name}")
        check_metrics(sample, CLI_VQ_TRAIN_FLAGS)
        train = {"launches": train_counts, "seconds": out["seconds"],
                 "recon": [out["recon_mse"], out["recon_ssim_loss"]]}

    with tempfile.TemporaryDirectory() as root:
        out, sample, _, eval_counts, _ = cli_run(CLI_VQ_EVAL_FLAGS, root, card)
        metrics = check_metrics(sample, CLI_VQ_EVAL_FLAGS)
    space = metrics["feature_space"]
    log(f"  vq-vae eval: feature space {space}; null FID {metrics['null_FID']} (JAX record "
        f"{VQ_VAE_RECORD['null_FID']})")
    for t in temperatures(cli.parse_args(CLI_VQ_EVAL_FLAGS)):
        entry, rec = metrics[str(t)], VQ_VAE_RECORD[str(t)]
        log(f"  vq-vae eval temperature {t}: " + ", ".join(
            f"{k} {entry[k]} (JAX record {rec[k]})" for k in rec)
            + f"; KID_x1e3 {entry['KID_x1e3']}; {entry['images_per_sec']} images/s [{card}]")
        check(entry["covered_modes"] == 10, f"vq-vae eval {t}: a mode not covered")
    check(space["stats_verified"] and space["frozen"], "vq-vae eval: frozen stats not verified")
    check(space["sha256"] == VQ_VAE_RECORD["sha256"], f"vq-vae feature space {space['sha256']}")
    check(abs(metrics["null_FID"] - VQ_VAE_RECORD["null_FID"]) <= NULL_FID_ATOL,
          f"vq-vae null FID {metrics['null_FID']}")
    check(metrics["0.8"]["FID"] < VQ_VAE_FID_08_BOUND,
          f"vq-vae FID at 0.8 {metrics['0.8']['FID']} not under {VQ_VAE_FID_08_BOUND}")
    evaluation = {"launches": eval_counts, "seconds": out["seconds"],
                  "recon": [out["recon_mse"], out["recon_ssim_loss"]], "metrics": metrics}

    # the CLI's recon of 1,024 test images, card against CPU; the codes of
    # the two may differ at near-ties, which the log counts
    vq = baseline_model("vq-vae", ANNVQVAE(VQVAEConfig()), "cuda")
    vq_cpu = baseline_model("vq-vae", ANNVQVAE(VQVAEConfig()), "cpu")
    ds = synthetic_dataset("MNIST", n_train=0, n_test=TRAINED_IMAGES)
    args = argparse.Namespace(batch_size=BATCH)
    reset_launch_counts()
    card_recon = cli._eval_recon(args, vq, ds, torch.device("cuda"))
    counts = launch_counts()
    cpu_recon = cli._eval_recon(args, vq_cpu, ds, torch.device("cpu"))
    d_recon = [abs(a - b) for a, b in zip(card_recon, cpu_recon)]
    x = torch.from_numpy(ds.test_images - 0.5)
    codes = vq.encode_indices(x.cuda()).cpu()
    differing = int((codes != vq_cpu.encode_indices(x)).sum())
    log(f"  vq-vae recon of {TRAINED_IMAGES} images: card MSE {card_recon[0]:.8f}, 1 - SSIM "
        f"{card_recon[1]:.8f}; CPU {cpu_recon[0]:.8f}, {cpu_recon[1]:.8f}; |d| "
        f"{d_recon[0]:.3g}, {d_recon[1]:.3g} (tol {STAGE1_CPU_LOSS_ATOL:g}); codes differing "
        f"card against CPU: {differing} of {codes.numel()}, {len(torch.unique(codes))} "
        f"distinct; launches {format_counts(counts)} [{card}]")
    check(counts == (0,) * 7, f"the ANN VQ-VAE launched {counts}")
    check(max(d_recon) <= STAGE1_CPU_LOSS_ATOL, "vq-vae recon: card against CPU")

    # K2 on the baseline's denoiser as its eval runs it ('bnlif', fp32
    # sampler), at the eval's sampling chunk, on the encoder's codes
    dcfg = DiffusionConfig()
    den = baseline_denoiser(None)
    gen = torch.Generator(device="cuda").manual_seed(TRAINED_STEP_NOISE_SEED)
    inputs = k2_probes(dcfg, cli_chunk(CLI_VQ_EVAL_FLAGS), codes.cuda(), gen)
    k2_err = compare_k2_probes("vq-vae trained", den, dcfg, inputs)
    logit_share = fused_logit_share(den, dcfg, inputs)
    return {"train": train, "eval": evaluation,
            "recon": {"card": card_recon, "cpu": cpu_recon, "codes_differing": differing},
            "k2_max_abs_err": k2_err, "fused_logits_within_1e-5": logit_share,
            "fid_1.0": vq_vae_gap(vq, den, dcfg, card)}


def baseline_denoiser(dtype) -> SpikingDenoiser:
    """The vq-vae baseline's exported denoiser as its eval builds it
    ('bnlif' on the card, ``dtype`` None or bf16), in eval mode."""
    den = SpikingDenoiser(DiffusionConfig(), lif_backend="bnlif", dtype=dtype)
    ckpt = torch.load(BASELINES / "vq-vae" / "diff_result" / "diff_model.pt",
                      map_location="cuda", weights_only=True)
    den.load_state_dict(ckpt["model"], strict=True)
    return den.cuda().eval()


def vq_vae_gap(vq, den, dcfg, card: str) -> dict:
    """FID at 1.0 of the vq-vae baseline through the CLI's own evaluation
    (``cli._eval_generation``, on the eval's data and frozen space) for
    each of VQ_VAE_GAP_RUNS: whether its distance from the record follows
    the kernel (fused against layerwise on one draw), the arithmetic
    (bf16 against fp32) or the draw (the seeds)."""
    base = cli.parse_args(CLI_VQ_EVAL_FLAGS)
    ds = load_dataset(base.dataset_name, base.data_path,
                      synthetic_size=(base.synthetic_train, base.synthetic_test))
    dens = {False: den, True: baseline_denoiser(torch.bfloat16)}
    rows = {}
    for label, extra in VQ_VAE_GAP_RUNS:
        args = cli.parse_args(CLI_VQ_EVAL_FLAGS[:-2] + ["--temperatures", "1.0"] + extra)
        chunks = -(-args.sample_batches * 16 // min(512, args.sample_batches * 16))
        np.random.seed(args.seed)
        reset_launch_counts()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as root, contextlib.redirect_stdout(io.StringIO()):
            out = cli._eval_generation(args, temperatures(args), vq, dcfg, dens[args.bf16],
                                       ds, root, torch.device("cuda"))
        seconds = time.perf_counter() - t0
        counts, entry = launch_counts(), out[1.0]
        log(f"  vq-vae FID at 1.0, {label}: {entry['FID']} (record "
            f"{VQ_VAE_RECORD['1.0']['FID']}), IS {entry['IS']}, KID_x1e3 "
            f"{entry['KID_x1e3']}, {entry['covered_modes']} modes; K2 {counts[4]}; "
            f"{seconds:.1f} s [{card}]")
        check(out["feature_space"]["stats_verified"], f"vq-vae {label}: stats not verified")
        check(all(math.isfinite(v) for v in entry.values()), f"vq-vae {label}: {entry}")
        fused = cli.FUSED[args.fused_sampler] is not False
        check(counts[4] == (K2_STEP_LAUNCHES * chunks if fused else 0),
              f"vq-vae {label}: {counts[4]} K2 launches")
        rows[label] = {"FID": entry["FID"], "IS": entry["IS"], "KID_x1e3": entry["KID_x1e3"],
                       "covered_modes": entry["covered_modes"], "launches": counts,
                       "seconds": seconds}
    return rows


def snn_vae_model(backend: str, device) -> SNNVAE:
    """The exported SNN-VAE on ``device`` on branch ``backend``, in
    training mode."""
    return baseline_model("snn-vae", SNNVAE(SNNVAEConfig(), VQVAEConfig(), backend),
                          device).train()


def snn_vae_images(n: int) -> torch.Tensor:
    """n synthetic training images as the CLI feeds them, on the card."""
    ds = synthetic_dataset("MNIST", n_train=BATCH, n_test=1, seed=0)
    return torch.from_numpy(ds.train_images[:n]).cuda() - 0.5


def k1_bwd_launches_of(run) -> list:
    """(x, v_init, spike cotangent, params, need_dv0) of every K1 backward
    launch that ``run()`` makes, copied as the kernel gets them."""
    seen = []
    bwd = lif_op.lif_bwd

    def record(x, v_init, gs, params=NeuronParams(), need_dv0=True):
        seen.append((x.clone(), None if v_init is None else v_init.clone(), gs.clone(),
                     params, need_dv0))
        return bwd(x, v_init, gs, params, need_dv0)

    lif_op.lif_bwd = record
    try:
        run()
    finally:
        lif_op.lif_bwd = bwd
    return seen


def snn_vae_k1_shapes(n: int, card: str) -> float:
    """Every K1 launch of an SNN-VAE training step at batch n on 'auto'
    (the heads' (16, n*56) and (16, n*784) among them), forward and
    backward, held bitwise against its plain version; returns the largest
    difference."""
    model = snn_vae_model("auto", "cuda")
    images = snn_vae_images(n)
    gen = torch.Generator(device="cuda").manual_seed(1)
    fwd = k1_launches_of(lambda: model(images, gen, p_scheduled=0.2))
    err = max(compare_lif(x, v_init, params, rate_range=None) for x, v_init, params in fwd)
    gen.manual_seed(1)
    state = create_train_state(model)
    bwd = k1_bwd_launches_of(lambda: cli.make_train_step_snn_vae()(state, images, gen, 0.2))
    for x, v_init, gs, params, need_dv0 in bwd:
        dx, dv = lif_op.lif_bwd(x, v_init, gs, params, need_dv0)
        dx_ref, dv_ref = lif_op.lif_bwd_reference(x, v_init, gs, params, need_dv0)
        check(torch.equal(dx, dx_ref) and (dv is None) == (dv_ref is None),
              "K1 bwd differs from the plain version at an SNN-VAE shape")
        err = max(err, float((dx - dx_ref).abs().max()))
    m_fwd = [x.shape[1] for x, _, _ in fwd]
    check(len(fwd) == len(bwd) == SNN_VAE_STEP_LAUNCHES["layerwise"][0],
          f"SNN-VAE step: {len(fwd)} K1 forwards, {len(bwd)} backwards")
    check(n * SNNVAEConfig().latent_dim in m_fwd and n * 784 in m_fwd,
          f"the heads' shapes are not among {m_fwd}")
    log(f"  K1 at the SNN-VAE's batch-{n} step: forward M {m_fwd}, backward M "
        f"{[x.shape[1] for x, *_ in bwd]}, bitwise equal to the plain versions [{card}]")
    return err


def phase_cli_snn_vae(card: str) -> dict:
    """``--model snn-vae`` on the card: K1 bitwise at the step's shapes; a
    CLI training run with ``--vae_scheduled_p anneal``; TRAIN_STEPS steps
    of the exported model at batch 32 and 256 on 'auto' and 'bnlif' with
    exact launches (the first at 32 equal to the plain versions' step on
    the card); ``sample`` card against CPU on one injected choice; the eval
    of the exported baseline with its record's flags."""
    k1_err = max(snn_vae_k1_shapes(n, card) for n in TRAIN_BATCHES)
    with tempfile.TemporaryDirectory() as root:
        out, sample, result, train_counts, printed = cli_run(CLI_SNN_TRAIN_FLAGS, root, card)
        check(sorted(os.listdir(result)) == ["model.pt"], f"snn-vae result {os.listdir(result)}")
        check(sorted(os.listdir(sample)) == ["image.png"], f"snn-vae sample {os.listdir(sample)}")
        check("IS = " in printed and all(math.isfinite(out[k]) for k in ("IS", "FID")),
              "snn-vae: no scores")
    train_run = {"launches": train_counts, "seconds": out["seconds"],
                 "scores": {k: out[k] for k in ("IS", "KID_x1e3", "FID")}}

    step = cli.make_train_step_snn_vae()
    steps = {}
    for branch, (backend, plain) in SNN_VAE_BRANCHES.items():
        steps[branch] = {}
        want = tuple(k * TRAIN_STEPS for k in SNN_VAE_STEP_LAUNCHES[branch])
        for n in TRAIN_BATCHES:
            state = create_train_state(snn_vae_model(backend, "cuda"))
            batches = [snn_vae_images(n)] * TRAIN_STEPS
            gen = torch.Generator(device="cuda").manual_seed(2)
            times, losses, first, counts, peak = run_steps(
                state, lambda st, x: step(st, x, gen, 0.2), batches)
            ms = statistics.median(times[1:])
            log(f"  snn-vae {branch} batch {n}: launches {format_counts(counts)} in "
                f"{TRAIN_STEPS} steps; ms per step {', '.join(f'{t:.2f}' for t in times)} "
                f"(median after the first {ms:.2f}); losses "
                f"{', '.join(f'{v:.4f}' for v in losses)}; peak memory {peak / 2**30:.2f} GiB "
                f"[{card}]")
            check(counts == want, f"snn-vae {branch} batch {n}: launches {counts}, "
                  f"expected {want}")
            check(all(math.isfinite(v) for v in losses), f"snn-vae {branch}: loss not finite")
            row = {"launches": counts, "ms": times, "ms_median": ms, "losses": losses,
                   "peak_bytes": peak}
            row["profile"] = step_profile(f"snn-vae {branch} batch {n}", ms,
                                          lambda: step(state, batches[0], gen, 0.2))
            if n == TRAIN_BATCHES[0]:
                before = launch_counts()
                plain_state = create_train_state(snn_vae_model(plain, "cuda"))
                gen.manual_seed(2)
                loss = step(plain_state, batches[0], gen, 0.2)["loss"]
                check(launch_counts() == before, "the plain SNN-VAE step launched a kernel")
                row["vs_plain"] = compare_steps("the plain versions on the card", first,
                                                step_record(plain_state, loss), True)
            steps[branch][n] = row

    # sample on the card against the CPU on one injected choice, on each
    # branch
    cfg = SNNVAEConfig()
    choice = torch.randint(0, cfg.k, (cfg.num_steps, SNN_VAE_SAMPLE_CHECK, cfg.latent_dim),
                           generator=torch.Generator().manual_seed(3))
    sample = {}
    for branch, (backend, _) in SNN_VAE_BRANCHES.items():
        model = snn_vae_model(backend, "cuda")
        reset_launch_counts()
        x_card, z_card = model.sample(choice=choice.cuda())
        sample_counts = launch_counts()
        x_cpu, z_cpu = snn_vae_model(backend, "cpu").sample(choice=choice)
        z_differing = int((z_card.cpu() != z_cpu).sum())
        d_image = float((x_card.cpu() - x_cpu).abs().max())
        log(f"  snn-vae {branch} sample of {SNN_VAE_SAMPLE_CHECK} on one choice: launches "
            f"{format_counts(sample_counts)}; z differing card against CPU {z_differing} of "
            f"{z_cpu.numel()} (rate {float(z_cpu.mean()):.4f}); max|d image| {d_image:.3g} "
            f"(tol {SNN_VAE_SAMPLE_ATOL:g}) [{card}]")
        check(sample_counts == SNN_VAE_SAMPLE_LAUNCHES[branch],
              f"snn-vae {branch} sample launches {sample_counts}")
        check(z_differing == 0 and d_image <= SNN_VAE_SAMPLE_ATOL,
              f"snn-vae {branch} sample: card against CPU")
        sample[branch] = {"launches": sample_counts, "z_differing": z_differing,
                          "max_abs_image_err": d_image}

    with tempfile.TemporaryDirectory() as root:
        out, _, _, eval_counts, _ = cli_run(CLI_SNN_EVAL_FLAGS, root, card)
    log(f"  snn-vae eval of {out['n_samples']} samples: IS {out['IS']:.4f} (record "
        f"{SNN_VAE_RECORD['IS']}), FID {out['FID']:.4f} (record {SNN_VAE_RECORD['FID']}), "
        f"KID_x1e3 {out['KID_x1e3']:.4f}; space {out['feature_space']} [{card}]")
    check(out["feature_space"]["frozen"] and out["feature_space"]["sha256"]
          == VQ_VAE_RECORD["sha256"], f"snn-vae feature space {out['feature_space']}")
    check(all(math.isfinite(out[k]) for k in ("IS", "KID_x1e3", "FID")), "snn-vae eval scores")
    return {"k1_max_abs_err": k1_err, "train": train_run, "steps": steps,
            "sample": sample,
            "eval": {"launches": eval_counts, "seconds": out["seconds"],
                     "scores": {k: out[k] for k in ("IS", "KID_x1e3", "FID")}}}


def phase_metrics_extra(card: str) -> dict:
    """InceptionV3 (seeded weights) at 299 on the card against the CPU in
    both pipelines; ``clean_resize`` card against CPU; the freeze protocol
    at canonical sizes into a temporary root, read back and verified."""
    calibration = torch.rand((INCEPTION_CALIBRATION, 299, 299, 3),
                             generator=torch.Generator().manual_seed(1))
    net_cpu = inception.seeded_inception(0, calibration)
    net = copy.deepcopy(net_cpu).cuda()
    images = synthetic_dataset("MNIST", n_train=0, n_test=INCEPTION_IMAGES).test_images
    feats, probs = inception.inception_feature_fn(net, INCEPTION_IMAGES)(images)
    feats_cpu, probs_cpu = inception.inception_feature_fn(net_cpu, INCEPTION_IMAGES,
                                                          device="cpu")(images)
    errs = [float(np.abs(a - b).max() / np.abs(b).max())
            for a, b in ((feats, feats_cpu), (probs, probs_cpu))]
    x = inception.resize_for_inception(images)
    times = []
    with torch.no_grad():
        for _ in range(INCEPTION_REPS + 1):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            net(x * 2.0 - 1.0, transform_input=True)
            ev[1].record()
            ev[1].synchronize()
            times.append(ev[0].elapsed_time(ev[1]))
    ms = statistics.median(times[1:])
    log(f"  InceptionV3 (seeded) at 299 on {INCEPTION_IMAGES} images, card against CPU: "
        f"features {errs[0]:.3g}, probabilities {errs[1]:.3g} of the largest (tol "
        f"{INCEPTION_RTOL:g}); a forward {ms:.3f} ms [{card}]")
    check(all(e <= INCEPTION_RTOL for e in errs), "InceptionV3: card against CPU")

    raw = np.random.RandomState(0).randint(0, 256, (64, 28, 28)).astype(np.uint8)
    resize_err = float((cleanfid.clean_resize(raw).cpu()
                        - cleanfid.clean_resize(raw, device="cpu")).abs().max())
    log(f"  clean_resize of 64 uint8 images to 299, card against CPU: max|d| "
        f"{resize_err:.3g} (tol {RESIZE_ATOL:g})")
    check(resize_err <= RESIZE_ATOL, "clean_resize: card against CPU")

    ds = load_dataset("MNIST", synthetic_size=FREEZE_SIZES)
    with tempfile.TemporaryDirectory() as root:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = frozen.freeze_feature_space("MNIST", ds.train_images, ds.train_labels,
                                          ds.test_images, ds.num_classes, root=root,
                                          log_fn=None)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        feature_fn, info = frozen.get_feature_space("MNIST", ds.train_images, ds.train_labels,
                                                    ds.num_classes, mode="on", root=root,
                                                    log_fn=None)
        stats = frozen.load_frozen_stats("MNIST", root=root)
        real = ds.test_images[:frozen.CANONICAL_REF_N]
        feats, _ = feature_fn(real)
        verified = frozen.verify_stats(stats, real, feats) is True
    log(f"  freeze_feature_space at {FREEZE_SIZES[0]} + {FREEZE_SIZES[1]} images, "
        f"{frozen.FREEZE_EPOCHS} epochs: {seconds:.2f} s (host clock), space "
        f"{out['space_sha'][:16]} (the committed space, frozen on a TPU: "
        f"{VQ_VAE_RECORD['sha256']}); read back in mode 'on': {info['space_sha'][:16]}, "
        f"stats verified {verified} [{card}]")
    check(info["frozen"] and info["space_sha"] == out["space_sha"], "frozen space read back")
    check(verified, "the space frozen on the card does not verify")
    return {"inception": {"feature_rel_err": errs[0], "prob_rel_err": errs[1],
                          "forward_ms": ms, "images": INCEPTION_IMAGES},
            "clean_resize_max_abs_err": resize_err,
            "freeze": {"seconds": seconds, "space_sha": out["space_sha"][:16],
                       "verified": verified}}


def launches_of(runs: dict, idx: int) -> dict:
    """A kernel's launches (index ``idx`` of ``launch_counts()``) in each
    run of a phase."""
    return {run: row["launches"][idx] for run, row in runs.items()}


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
            for built in _build.build([lif_op.SOURCE, lif_op.SOURCE_BWD, fd.SOURCE,
                                       bnl.SOURCE, sc.SOURCE]):
                log(f"  {built.name}: {built.seconds:.1f} s -> {built.path.name}")
                for line in built.log.splitlines():
                    log(f"    {line}")
                if built.name == sc.SOURCE:
                    k4_hmma = sass_hmma(built.path)
                if built.name == fd.SOURCE:
                    k2_hmma = sass_hmma(built.path)
                if built.name == bnl.SOURCE:
                    k3_registers = check_k3_registers(built)
            for name, count in k2_hmma.items():
                log(f"  K2 SASS: {count:3d} HMMA in {name}")
            for kname in ("conv_lif_kernel", "readout_kernel"):
                found = [n for n in k2_hmma if kname in n]
                check(len(found) == 3 and all(k2_hmma[n] > 0 for n in found),
                      f"K2's {kname} does not reach the tensor cores in every weight type")
            for name, count in k4_hmma.items():
                log(f"  K4 SASS: {count:3d} HMMA in {name}")
            mma = [n for n in k4_hmma if "mma_kernel" in n]
            check(len(mma) == len(K4_MMA_KERNELS), f"K4 builds {len(mma)} tensor-core kernels")
            for what, kname in K4_MMA_KERNELS.items():
                found = [n for n in mma if kname in n]
                check(len(found) == 1 and k4_hmma[found[0]] > 0,
                      f"K4's {what} kernel does not reach the tensor cores")
            check(not any(re.search(r"\d(conv|wgrad|grad_out)_kernelI13__nv_bfloat16", n)
                          for n in k4_hmma), "K4 still builds a bf16 CUDA-core kernel")
        with Phase("models"):
            dcfg, vcfg = DiffusionConfig(), VQVAEConfig()
            models = build_models(dcfg, vcfg)
            check_against_cpu(*models[:2], dcfg, vcfg)
        with Phase("kernels"):
            gen = torch.Generator(device="cuda").manual_seed(0)
            flush = torch.empty(64 * 2**20 // 4, device="cuda")  # 64 MiB > 50 MB L2
            k1 = phase_k1(gen, flush)
            k1_bwd = phase_k1_bwd(gen, flush)
            k2 = phase_k2(models[0], dcfg, gen, flush, smi)
            k3 = phase_k3(gen, flush)
            k4 = phase_k4(gen, flush, smi)
            k1_s1 = phase_k1_stage1(gen, flush)
            k3_s1 = phase_k3(gen, flush, stage1_lif_shapes(), STAGE1_PLAIN_REPS,
                             "stage-1 training step")
            del flush
        with Phase("generation"):
            launches, layerwise = phase_generation(models, dcfg, smi)
        with Phase("generation_fused"):
            fused_launches = phase_generation_fused(models, dcfg, layerwise, smi)
        with Phase("generation_bnlifconv"):
            conv_gen = phase_generation_bnlifconv(models, dcfg, layerwise, smi)
        with Phase("train_stage1"):
            del models
            torch.cuda.empty_cache()
            train1 = phase_train_stage1(vcfg, smi)
        with Phase("train_stage2"):
            torch.cuda.empty_cache()
            # stage 2 trains on the codes that stage 1's extract_code_indices made
            codes = torch.from_numpy(train1["layerwise"].pop("codes_array")[:BATCH]).cuda()
            train1["bnlif"].pop("codes_array")
            train = phase_train(dcfg, codes, smi)
        with Phase("trained_weights"):
            torch.cuda.empty_cache()
            trained = phase_trained_weights(smi)
        with Phase("syops"):
            torch.cuda.empty_cache()
            profiled = phase_syops(smi)
        with Phase("cli"):
            cli_runs = phase_cli(smi)
        with Phase("cli_vq_vae"):
            vq = phase_cli_vq_vae(smi)
            vq_runs = {"cli_train": vq["train"], "cli_eval": vq["eval"]}
        with Phase("cli_snn_vae"):
            torch.cuda.empty_cache()
            snn = phase_cli_snn_vae(smi)
            snn_runs = {"cli_train": snn["train"], "cli_eval": snn["eval"],
                        **{f"sample {b}": row for b, row in snn["sample"].items()},
                        **{f"{b} {n}": row for b, rows in snn["steps"].items()
                           for n, row in rows.items()}}
        with Phase("metrics_extra"):
            phase_metrics_extra(smi)
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
        # random inputs at the path's shapes, stage 1's and the CLI eval's
        "max_abs_err": max(k1["max_abs_err"], k1_s1["fwd_err"], trained["k1_cli_max_abs_err"],
                           snn["k1_max_abs_err"]),
        # times of the 248 launches of one generated batch of 256
        "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        # K1 launches on the fused path (3 per generated batch, the decode)
        "launches_fused_path": {k: v[1] for k, v in fused_launches.items()},
        # on the layerwise training paths: 5 per stage-2 step, 6 per stage-1
        # step and 3 per encode_indices batch
        "launches_train_stage2": stage_launches(train["layerwise"], 0),
        "launches_train_stage1": stage_launches(train1["layerwise"], 0),
        "launches_cli": cli_launch_counts(cli_runs, 0),
        # the baselines: the ANN VQ-VAE runs none; the SNN-VAE 7 a training
        # step ('bnlif': 2), 3 a sample call
        "launches_cli_vq_vae": launches_of(vq_runs, 0),
        "launches_snn_vae": launches_of(snn_runs, 0),
        # the profiler's runs on the trained weights (phase syops)
        "launches_syops": profiled["launches"][0],
        "shapes": k1["rows"],
        # times of the 6 launches of one layerwise stage-1 step at batch 256
        "stage1": stage1_times(k1_s1, "fwd"),
    }, {
        "name": "K1 lif_bwd", "route": "cuda",
        "source": "spiking_diffusion_tpu_torch/csrc/lif_bwd.cu",
        "replaces": K1_BWD_REPLACES,
        "launches": stage_launches(train["layerwise"], 1),
        "launches_train_stage1": stage_launches(train1["layerwise"], 1),
        "launches_cli": cli_launch_counts(cli_runs, 1),
        "launches_snn_vae": launches_of(snn_runs, 1),
        "max_abs_err": max(k1_bwd["max_abs_err"], k1_s1["bwd_err"], snn["k1_max_abs_err"]),
        # times of the 5 launches of one layerwise training step at batch 256
        "ms": k1_bwd["ms"], "plain_ms": k1_bwd["plain_ms"], "bound_ms": k1_bwd["bound_ms"],
        "bound_by": "bytes", "library_ms": None, "shapes": k1_bwd["rows"],
        "stage1": stage1_times(k1_s1, "bwd"),
    }]
    for name, row in k2.items():
        kernels.append({
            "name": f"K2 fused_denoiser {name}", "route": "cuda",
            "source": "spiking_diffusion_tpu_torch/csrc/fused_denoiser.cu",
            "replaces": K2_REPLACES, "launches": fused_launches[name][0],
            # the CLI's sweeps: fp32 in the training run, bf16 in the eval
            "launches_cli": {run: cli_runs[run]["launches"][4] if name == dname else 0
                             for run, dname in (("train", "fp32"), ("eval", "bf16"),
                                                ("gate", "bf16"))},
            # the ANN VQ-VAE's sweeps run fp32 K2 (no --bf16, as its record)
            "launches_cli_vq_vae": {run: n if name == "fp32" else 0
                                    for run, n in launches_of(vq_runs, 4).items()},
            # on the vq-vae baseline's denoiser at its eval's chunk of 512
            "max_abs_err_trained_vq_vae": vq["k2_max_abs_err"][name],
            # on the trained weights: the first reverse step and t = 25, at
            # batch 256 and at the CLI's chunk sizes
            "max_abs_err_trained": trained["k2_max_abs_err"][name],
            # one call at batch 256; no single PyTorch call is the denoiser
            "library_ms": None, **row, "sass_hmma": k2_hmma,
        })
    for key, name, replaces, idx in (("fwd", "K3 bn_lif_fwd", K3_FWD_REPLACES, 2),
                                     ("bwd", "K3 bn_lif_bwd", K3_BWD_REPLACES, 3)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "spiking_diffusion_tpu_torch/csrc/bn_lif.cu",
            "replaces": replaces,
            "launches": stage_launches(train["bnlif"], idx),
            "launches_train_stage1": stage_launches(train1["bnlif"], idx),
            "launches_cli": cli_launch_counts(cli_runs, idx),
            "launches_cli_vq_vae": launches_of(vq_runs, idx),
            "launches_snn_vae": launches_of(snn_runs, idx),
            "launches_syops": profiled["launches"][idx],
            "max_abs_err": max(k3["fp32"][f"{key}_err"], k3_s1["fp32"][f"{key}_err"]),
            # fp32 times of the 5 launches of one 'bnlif' training step at batch 256
            "ms": k3["fp32"][f"{key}_ms"], "plain_ms": k3["fp32"][f"{key}_plain_ms"],
            "bound_ms": k3["fp32"][f"{key}_bound_ms"], "bound_by": "bytes",
            "library_ms": None,
            "bf16": {k: k3["bf16"][f"{key}_{k}"] for k in ("ms", "plain_ms", "bound_ms")},
            "share_of_bound": {d: k3[d][f"{key}_share"] for d in k3},
            "sums_bitwise": {d: k3[d]["sums_bitwise"] for d in k3},
            "ptxas_registers": {n: r for n, r in k3_registers.items() if f"_{key}_" in n},
            # times of the 6 launches of one 'bnlif' stage-1 step at batch 256
            "stage1": {d: stage1_times(k3_s1[d], key) for d in k3_s1},
        })
    for key, name, replaces, idx in (("fwd", "K4 spike_conv_fwd", K4_FWD_REPLACES, 5),
                                     ("bwd", "K4 spike_conv_bwd", K4_BWD_REPLACES, 6)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "spiking_diffusion_tpu_torch/csrc/spike_conv.cu",
            "replaces": replaces,
            # every 'bnlifconv' training run (fp32 and bf16) and the request
            "launches": sum(r["launches"][idx] for r in train["bnlifconv"].values())
            + conv_gen["launches"][idx],
            # fwd: of y (the moments' largest relative error beside it); bwd:
            # of dx, dW and db
            "max_abs_err": k4["fp32"][f"{key}_err"],
            **({"moments_max_rel_err": k4["fp32"]["moments_rel_err"]} if key == "fwd" else {}),
            # fp32 times of the 6 calls of one 'bnlifconv' training step at batch 256
            "ms": k4["fp32"][f"{key}_ms"], "plain_ms": k4["fp32"][f"{key}_plain_ms"],
            "bound_ms": k4["fp32"][f"{key}_bound_ms"],
            "bound_by": k4["fp32"][f"{key}_bound_by"],
            "library_ms": k4["fp32"][f"{key}_library_ms"],
            "launches_per_train_step": K4_PER_STEP,
            "launches_cli": cli_launch_counts(cli_runs, idx),
            "launches_generation": conv_gen["launches"][idx],
            **({"generation_requests": conv_gen["requests"]} if key == "fwd" else {}),
            # fwd: the fp32 route (tensor cores for an x exact in bf16, bound
            # at three bf16 products per product) and the CUDA-core route's
            # time and bound on the same x moved off bf16's grid; the path's
            # fp32 forwards by route (tensor cores, CUDA cores)
            **({"cuda_core_route_ms": k4["fp32"]["fwd_cc_ms"],
                "cuda_core_route_bound_ms": k4["fp32"]["fwd_cc_bound_ms"],
                "fp32_routes_on_path": [
                    sum(r["fp32_routes"][i] for r in train["bnlifconv"].values()
                        if "fp32_routes" in r) + conv_gen["fp32_routes"][i] for i in (0, 1)],
                "fp32_profile": k4["fp32"]["fwd_profile"]} if key == "fwd" else {}),
            "bf16": {k: k4["bf16"][f"{key}_{k}"]
                     for k in ("ms", "plain_ms", "bound_ms", "library_ms", "err")},
            # bwd: the fp32 routes (dW on the tensor cores at three bf16 products
            # per product, dx at six, bound so) and the CUDA-core routes' times
            # and bound on the same x moved off bf16's grid with an inf in g;
            # dW + db alone on each; the path's fp32 backwards by route (dW
            # tensor cores, dW CUDA cores, dx tensor cores, dx CUDA cores)
            **({"bwd_nodx_ms": {d: k4[d]["bwd_nodx_ms"] for d in k4},
                "cuda_core_route_ms": k4["fp32"]["bwd_cc_ms"],
                "cuda_core_route_nodx_ms": k4["fp32"]["bwd_cc_nodx_ms"],
                "cuda_core_route_bound_ms": k4["fp32"]["bwd_cc_bound_ms"],
                "fp32_bwd_routes_on_path": [
                    sum(r["fp32_bwd_routes"][i] for r in train["bnlifconv"].values()
                        if "fp32_bwd_routes" in r) for i in range(4)],
                "fp32_profile": k4["fp32"]["bwd_profile"]} if key == "bwd" else {}),
            "sass_hmma": k4_hmma,
            "shapes": [{k: v for k, v in r.items() if k.startswith(key) or k in (
                "shape", "M", "Cin", "Cout")} for r in k4["fp32"]["rows"]],
        })
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
