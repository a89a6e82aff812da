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
   call and per reverse step, and the peak memory of a call. Then on the
   e60 weights (``result_torch/MNIST/snn-vq-vae``) at batch 256, the int8
   sampler with per-row scales and with each of JAX's options set through
   its environment variable (``SD_INT8_SCALES=cout``,
   ``SD_INT8_CLIP_PCT=99.9``, ``SD_INT8_LOGITS=bf16``) and each roofline
   ablation (``SD_FUSED_ABLATE=nolif|noshift|matmul``): one K2 launch
   through the sampler's entry point (``make_denoise_fn``) whose logits are
   a direct call's, K2 against its plain version in the same mode (bitwise
   but for the bf16 readout, held at the bf16 bound), ms per call and its
   share of the per-row int8 call's. K1 backward at the five LIF shapes of the
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
   folding moves the logits by one fp32 rounding). Then request 0 with
   JAX's ``SD_INT8_LOGITS=bf16`` set in the process: the variable reaches
   the entry point (a bf16 readout), 49 K2 launches, valid codes and
   images, and K2's plain version in the same mode gives the same codes.
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
   card-against-CPU loss tolerance); the ``encode_indices`` codes that
   differ between the card and the CPU are counted. At batch 256 on one
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
   eval's data for seed 42 on fused fp32, the layerwise sampler and
   ``--bf16`` (stats verified, K2 launches exact, figures logged): whether
   the distance from the record follows the kernel or the arithmetic.
13. cli_snn_vae (in the side lane, after cli_datasets): ``--model
   snn-vae`` on the card. Every K1 launch of a
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
   freeze protocol (5 epochs) on 2,048 training images, its stats over
   the 8,192 test images of the canonical reference set's size, into a
   temporary root, read back in mode 'on' and its stats verified by the
   CLI's rule (``frozen.verify_stats``), with its seconds.
15. cli_datasets: every other dataset's committed spiking VQ-VAE
   (``result_torch/<dataset>/snn-vq-vae``). CIFAR10 at 3 input channels
   through ``cli.main``: a training run with the cli phase's flags (exact
   K1, K3 and K2 launches, the JAX artifact tree with RGB PNGs, the
   ``--syops`` report), then the eval of its export with the record's
   flags (K1 and bf16 K2 only, RGB PNGs, frozen stats verified, the
   space's sha, null FID within 1e-3 of the record's 1.6337, every figure
   logged beside the record's); K2 on its denoiser against the plain
   version at the eval's chunk of 512 (first step and t = 25, every
   dtype) and every K1 launch of the eval's decode, recon and remainder
   batch bitwise. Then the CLI eval of CIFAR10-BW, FMNIST, KMNIST and
   Letters in the side lane's process, after its earlier phases, with the record's
   flags but a sweep of one 16-image batch: exact launches, frozen stats
   verified, the space's sha and the null FID within 1e-3 of the
   record's. The CLI's recon of all five on the card (exactly 6 K1
   launches a batch) and on the CPU over 1,024 test images, MSE and
   1 - SSIM within 1e-4, the codes of its forward passes compared; the
   CPU's side runs in HOST_WORKERS worker processes, a batch each, while
   the card runs the CLI.
16. data_parallel: two ranks on the one card over gloo (NCCL refuses two
   ranks on a GPU), spawned by ``parallel.launch`` once phase
   tensor_parallel's ranks have run their references, each holding a replica. Meanwhile each rank runs the
   same steps in one process on the global batch (``make_train_step_*``,
   no mesh): the references. From the start of phase serve_export (their
   cue), on each rank, with the launch counts reset just before: 4 fp32 stage-1 steps (layerwise, K1)
   at a global batch of 256, 128 a rank (exactly 6 + 6 K1 a step); 4
   stage-2 steps on 'bnlif' (K3) at 256 in fp32 and in bf16 (5 + 5 K3 a
   step); the fused bf16 sampler (K2) on the trained weights at 256 (49
   K2 calls); ``cli.main`` with ``--data_parallel 2`` and phase cli's
   training flags (rank 0 exactly the launches of phase cli's run, rank
   1 those of the training steps). The first DP step, from the
   references' state, is held to theirs: loss, gradients and BN
   statistics within stage 1's card-against-CPU bounds (STAGE1_CPU_*, at
   most STAGE1_FLIP_SHARE of its spikes on the rank's rows differing) and
   stage 2's 'bnlifconv' plain-on-card bounds (CONV_*; bf16 gradients at
   DP_BF16_GRAD_TOL), the parameters after it within DP_PARAM_ATOL where
   the gradient lies beyond twice the bound's atol and within 2 lr
   elsewhere; the later losses are logged. The ranks' parameters and
   buffers stay bitwise equal. The DP sampler's logits at t = 25 against
   the single process's on the same rows at K2's bound, its codes'
   agreement logged. The CLI run's artifact tree is phase cli's (the
   per-class grids aside: one per class the draw yields) and its output
   has the ``--syops`` report and the SyncBN backend line. ms per DP step
   (CUDA events) and, in one more step with each collective timed, the
   all-reduces' count, bytes and ms, labelled as two ranks sharing one
   card. Then a world of one rank on NCCL all-reduces once on the card.
17. tensor_parallel: four ranks on the one card over gloo forming a 2 x 2
   (data x model) mesh (``parallel.make_mesh_2d``), spawned after phase
   kernels; each runs the single-process references once phase
   train_stage1 has made the codes. Once phase data_parallel's ranks are
   done (beside phase serve_export), at the
   full-width flagship and a global batch of 64 (32 rows a data row: gloo
   copies every gather of a block's spike train through the host), each
   from a replica synced over the data group and sharded over the model
   group (``parallel.shard_state_tp``: every conv's output channels, its
   BN and neuron, the codebook's rows, AdamW's moments), with the launch
   counts reset just before: 4 TP stage-1 steps (layerwise fp32, exactly
   6 + 6 K1 a step on each rank's channels), 4 stage-2 steps on 'bnlif'
   in fp32 and in bf16 (5 + 5 K3) and 4 on 'bnlifconv' in fp32 (6 + 6 K4
   and 5 + 5 K3); and the baselines at full width with seeded weights: 4
   stage-1 steps of the ANN VQ-VAE (its convs' output channels and its
   codebook's rows sharded; no kernel, cuDNN) and 4 steps of the SNN-VAE
   (``cli.make_train_step_snn_vae_tp``: its heads' and cells' Linears
   column-parallel, exactly 7 + 7 K1 a step on each rank's features; every
   rank draws the step's draws whole from one seeded generator). The first
   TP step, its gradients, statistics and
   parameters gathered whole, is held to the references' at phase
   data_parallel's bounds (``hold_dp_run``; stage 1's spikes on the
   rank's rows at most STAGE1_FLIP_SHARE differing); after each run every
   tensor is bitwise equal over the data group and every replicated one
   over the model group. ms per TP step (CUDA events) beside one
   process's, and in one more step with each collective timed the
   collectives' count, bytes and ms by group, labelled as four ranks
   sharing one card: the process model's cost, not scaling.

18. zoo: the classifier zoo (``models/zoo.py``) at the JAX modules' own
   widths on seeded weights (``weights.init_zoo_variables``), T = 4, batch
   64: PLIFNet (128 channels, voting 10) on synthetic MNIST 28x28x1,
   SpikingVGG vgg11, SpikingResNet and SEW-ResNet ADD (stages (2, 2),
   width 64) on CIFAR10's synthetic 32x32x3. Four training steps each
   (``zoo.train_step``, ``train_classifier``'s AdamW), the launch counts
   reset just before: exactly 8 / 9 / 10 / 0 K1 forward and as many
   backward launches a step (VGG, ResNet, SEW, PLIFNet: one per LIF layer;
   PLIF is plain PyTorch), then an eval forward with 8 / 9 / 10 / 0; finite
   losses; ms per step (CUDA events, median of steps 2-4) and peak memory.
   ``lif_multi_step`` on the card: atan and sigmoid launch K1, erf takes
   the plain scan under 'auto' and raises under 'cuda'. ANN -> SNN
   conversion (IF neurons) at T = 32 over 256 images. Runs after cli,
   beside the side lane; its CPU side (each model's first
   step, each LIF and PLIF layer passing the card's spikes on, and ANN ->
   SNN) runs in a nice'd worker process beside the later phases, where
   the main process waits for the side lane and the ranks, and phase
   zoo_check, last, holds the card to it: the first step at stage 1's
   bounds (STAGE1_CPU_*, at most STAGE1_FLIP_SHARE of each layer's spikes
   differing), the conversion's scales within 1e-6 and at least 99 % of
   its outputs within 1e-5.

19. serve_export (after zoo, before the side lane's join): the server
   (``examples/serve_torch.py``) on the committed e60 weights. A bf16
   ``Generator`` at batch 64 (K2 + K1) behind a ``ThreadingHTTPServer``
   on 127.0.0.1: three ``/generate?n=64`` requests, whose PNGs each equal
   the matching sequential draw of ``generate.generate`` from a generator
   seeded alike, bitwise, then one ``sample`` call whose fp32 images do;
   ``/healthz``, ``/stats``, a 400 and a 404; exactly 49 K2 calls and 3 K1
   launches a batch drawn (warm-up and speculation included). The e60
   VQ-VAE's and denoiser's netlists (``models/deploy.py``) written and
   read (host ms), the modules reloaded on the card, one request on one
   noise set: codes and images bitwise the originals'. One decode's spike
   train packed and unpacked on the card (``ops/bitpack.py``), bitwise.
   ``lynxi_infer_torch.run`` at its defaults: exactly 2 K1 forward and
   backward launches a training step (and 2 in the eval forward),
   argmax agreement 1.0 with the exported manifest's executor. Then
   ``bench(4)`` at batch 64 and 256 in fp32, bf16 and int8, the launches
   held (7 batches each), p50 / p90 / images/s logged (4 requests, 8
   before phase data_tools came: the figures beside the ranks' steps are
   no serving figures; those come from ``examples/serve_torch.py --bench
   8`` alone).

20. data_tools (after serve_export, before the side lane's join): the
   event-camera classifier ``examples/dvs_classify_torch.py`` at its
   defaults through its ``main`` (4 classes x 128 seeded synthetic streams
   integrated by the native C++ integrator into 16x16x2 frames, T = 8,
   ``SpikingVGG((16, "M", 32, "M"))``, 5 epochs of batch 64, then the
   prediction of 128 test samples), the launch counts reset just before:
   exactly 2 K1 forward and backward launches a training step (40) and 2
   forwards in the prediction (DVS_LAUNCHES); the loss of the last epoch
   under the first's; test accuracy over 0.5 (chance 0.25); ms per step
   (CUDA events). Its first step's CPU side (each LIF layer passing the
   card's spikes on) runs in the zoo's worker, held in phase
   data_tools_check at the end at stage 1's card-against-CPU bounds. The
   native integrator bitwise its plain numpy version over all 640 streams
   of that run in both ``split_by`` modes, host ms per sample of each;
   ``--dataset nmnist`` on a tree ``NMNIST.synthesize`` writes, its frame
   cache read again bitwise the frames integrated from the events;
   ``padded_sequence_mask`` on a CUDA lengths tensor. In the side lane,
   after cli_snn_vae, phase data_tools_examples runs the twelve other
   examples of the data and tools path on the card at the tiny flags of
   ``tests/test_torch_examples.py`` (LANE_EXAMPLES), each one's last line
   printed; a failure fails the run.

Two lanes share the card and the host after phase kernels, so that the run
keeps under five minutes: phases metrics_extra, cli_vq_vae, cli_datasets,
cli_snn_vae and data_tools_examples (which share no state with the rest)
run in a spawned process of their own (``SideLane``), its log printed
whole where the main sequence joins it (phase side_lane, after serve_export); the CPU's side of
the datasets' recon runs from the lane's start in HOST_WORKERS worker
processes at a lower priority, and phase trained_weights' CPU recon from
the run's start in the main sequence's worker (the zoo's). Phase
tensor_parallel's ranks start with the side lane and run their references
once phase train_stage1 has made the stage-2 codes; phase data_parallel's
ranks start when those are done (the card then holds one set of
references at a time). Phase data_parallel's ranks take their cue (with
phase cli's artifact tree) at the start of phase serve_export, phase
tensor_parallel's when those are done: their steps run beside
serve_export. The timings of phases generation to serve_export, and of
the ranks' steps, are therefore taken beside other work; phase kernels'
are the card's alone.

The last lines are a JSON line of per-kernel numbers, the card's
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": ...}``.
Any failure prints its traceback and exits non-zero without that line.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import importlib.util
import io
import json
import math
import multiprocessing
import os
import re
import signal
import statistics
import subprocess
import sys
import struct
import tempfile
import threading
import time
import traceback
import urllib.error
import urllib.request
import zlib
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from http.server import ThreadingHTTPServer
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from spiking_diffusion_tpu_torch import cli, parallel
from spiking_diffusion_tpu_torch.config import DiffusionConfig, SNNVAEConfig, VQVAEConfig
from spiking_diffusion_tpu_torch.data import data_variance, load_dataset, synthetic_dataset
from spiking_diffusion_tpu_torch.data.extra_datasets import load_cifar10
from spiking_diffusion_tpu_torch.generate import generate as generate_images
from spiking_diffusion_tpu_torch.generate import sample_codes
from spiking_diffusion_tpu_torch.metrics import cleanfid, frozen, inception
from spiking_diffusion_tpu_torch.models import ann2snn, deploy, diffusion, weights, zoo
from spiking_diffusion_tpu_torch.models.ann_vqvae import ANNVQVAE
from spiking_diffusion_tpu_torch.models.denoiser import SpikingDenoiser
from spiking_diffusion_tpu_torch.models.layers import LIF, SeqConv
from spiking_diffusion_tpu_torch.models.snn_vae import SNNVAE
from spiking_diffusion_tpu_torch.models.vqvae import SNNVQVAE
from spiking_diffusion_tpu_torch.ops import _build
from spiking_diffusion_tpu_torch.ops import bitpack
from spiking_diffusion_tpu_torch.ops import bn_lif as bnl
from spiking_diffusion_tpu_torch.ops import fused_denoiser as fd
from spiking_diffusion_tpu_torch.ops import lif as lif_op
from spiking_diffusion_tpu_torch.ops import spike_conv as sc
from spiking_diffusion_tpu_torch.parallel.launch import free_port
from spiking_diffusion_tpu_torch.parallel.mesh import init_process_group
from spiking_diffusion_tpu_torch.profiling import benchmark, monitor, syops, trace
from spiking_diffusion_tpu_torch.snn import encoding, neuron, surrogate
from spiking_diffusion_tpu_torch.snn.neuron import NeuronParams
from spiking_diffusion_tpu_torch.train import stage1, stage2
from spiking_diffusion_tpu_torch.train.state import TrainState, create_train_state
from spiking_diffusion_tpu_torch.utils.grids import _tile, _to_uint8

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
# the int8 sampler's options (JAX's environment variables) and roofline
# ablations, held and timed at batch 256 on the e60 weights
K2_OPTIONS = {"int8 cout": {"SD_INT8_SCALES": "cout"},
              "int8 clip 99.9": {"SD_INT8_CLIP_PCT": "99.9"},
              "int8 bf16 logits": {"SD_INT8_LOGITS": "bf16"}}
K2_ABLATIONS = ("nolif", "noshift", "matmul")
K2_OPTION_ENV = ("SD_INT8_SCALES", "SD_INT8_CLIP_PCT", "SD_INT8_LOGITS", "SD_FUSED_ABLATE")
E60 = "MNIST/snn-vq-vae"  # the export of the JAX package's result_r5_e60
K2_OPTIONS_SEED = 21
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
# the committed exports (scripts/export_torch_weights.py): <dataset>/<model>;
# MNIST/snn-vq-vae is the JAX package's 60 + 120 epoch flagship run
EXPORTED = Path(__file__).resolve().parent / "result_torch"
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
CLI_EVAL_FLAGS = ["--checkpoint", str(EXPORTED / "MNIST" / "snn-vq-vae"), "--bf16", "--batch_size", "256",
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
# a trace that holds no kernel event at all is the profiler's failure (CUPTI
# delivered nothing, in one smoke run of ten), not the path's: traced again
TRACE_ATTEMPTS = 2
TRACE_KERNELS = {"auto": re.compile(r"(?<!bn_)lif_fwd_kernel"),
                 "bnlif": re.compile(r"bn_lif_fwd_kernel")}
# the paper's two baselines are the exports of the JAX package's round-3
# MNIST runs, MNIST/vq-vae and MNIST/snn-vae
# the JAX package's record of the ANN VQ-VAE's eval on a TPU, in fp32
# (sample_r3/MNIST/vq-vae/metrics.json; quality, not speed)
VQ_VAE_RECORD = {"0.8": {"IS": 9.2838, "FID": 172.406, "mode_KL": 0.0444, "covered_modes": 10},
                 "1.0": {"IS": 9.3644, "FID": 124.7888, "mode_KL": 0.0281, "covered_modes": 10},
                 "null_FID": 12.676, "sha256": "fa7286439409571c"}
VQ_VAE_FID_08_BOUND = 2 * VQ_VAE_RECORD["0.8"]["FID"]  # phase cli's band for e60
# the vq-vae eval's FID at 1.0 against the record's, on one other draw
# (--temperatures 1.0 alone) through the CLI's own evaluation: fused fp32,
# the layerwise sampler (no K2) and bf16, all at one seed
VQ_VAE_GAP_RUNS = [("fused fp32, seed 42", ["--seed", "42"]),
                   ("layerwise fp32, seed 42", ["--seed", "42", "--fused_sampler", "off"]),
                   ("fused bf16, seed 42", ["--seed", "42", "--bf16"])]
# the SNN-VAE's run in the same frozen space (STATUS_r3.md:64)
SNN_VAE_RECORD = {"FID": 801.5, "IS": 8.98}
CLI_VQ_TRAIN_FLAGS = ["--model", "vq-vae"] + CLI_TRAIN_FLAGS
CLI_VQ_EVAL_FLAGS = ["--model", "vq-vae", "--checkpoint", str(EXPORTED / "MNIST" / "vq-vae"),
                     "--batch_size", "256", "--synthetic_train", "60000", "--synthetic_test",
                     "10240", "--ref_size", "8192", "--frozen_metrics", "on",
                     "--temperatures", "0.8,1.0"]
CLI_SNN_TRAIN_FLAGS = ["--model", "snn-vae", "--epochs", "1", "--batch_size", "32",
                       "--synthetic_train", "512", "--synthetic_test", "2560", "--ref_size",
                       "1280", "--vae_scheduled_p", "anneal", "--frozen_metrics", "on"]
CLI_SNN_EVAL_FLAGS = ["--model", "snn-vae", "--checkpoint", str(EXPORTED / "MNIST" / "snn-vae"),
                      "--batch_size", "256", "--synthetic_train", "60000", "--synthetic_test",
                      "10240", "--ref_size", "8192", "--frozen_metrics", "on"]
SNN_VAE_BRANCHES = {"layerwise": ("auto", "torch"), "bnlif": ("bnlif", "bnlif_torch")}
# launches of an SNN-VAE training step (encoder 3, the heads 2, decoder 2)
# and of a sample call (the decoder input, decoder 2), as launch_counts() orders them
SNN_VAE_STEP_LAUNCHES = {"layerwise": (7, 7, 0, 0, 0, 0, 0), "bnlif": (2, 2, 5, 5, 0, 0, 0)}
SNN_VAE_SAMPLE_LAUNCHES = {"layerwise": (3, 0, 0, 0, 0, 0, 0), "bnlif": (1, 0, 2, 0, 0, 0, 0)}
SNN_VAE_SAMPLE_CHECK = 64  # images of the sample held card against CPU
SNN_VAE_SAMPLE_ATOL = 1e-4
# every other dataset's spiking VQ-VAE (scripts/export_torch_weights.py from
# the JAX package's runs: result_r3, FMNIST result_r5_f60), and the JAX
# record of its eval on a TPU with the flags of scripts/flagship_r3.sh, the
# CLI eval's flags here (sample_r3/<dataset>/snn-vq-vae/metrics.json,
# sample_r5_f60 for FMNIST; quality, not speed, one draw: no FID bound)
DATASET_CHANNELS = {"CIFAR10": 3, "CIFAR10-BW": 1, "FMNIST": 1, "KMNIST": 1, "Letters": 1}
DATASET_RECORDS = {
    "CIFAR10": {"null_FID": 1.6337, "sha256": "f992769c089edcaf",
                "0.8": {"IS": 9.0512, "FID": 278.4072, "mode_KL": 0.0707, "covered_modes": 10},
                "1.0": {"IS": 8.9856, "FID": 220.2074, "mode_KL": 0.0583,
                        "covered_modes": 10}},
    "CIFAR10-BW": {"null_FID": 2.1342, "sha256": "092bc88ffb7aa330"},
    "FMNIST": {"null_FID": 7.0819, "sha256": "97f35e8a9d0d7b4d"},
    "KMNIST": {"null_FID": 7.32, "sha256": "d112a87d08a71e87"},
    "Letters": {"null_FID": 16.9568, "sha256": "f5eda5f0f1f40222"},
}
DATASET_NULL_FID_ATOL = 1e-3
# recon card against CPU over TRAINED_IMAGES test images of each dataset;
# the CPU's side in worker processes, a batch each, started with the side
# lane and at a lower priority than the card's processes (its 20 batches of
# ~8.5 s of CPU time alone take 5 rounds on 4 workers): the host's 8 cores
# also run the main sequence, the side lane and, later, the ranks
HOST_WORKERS = 4
HOST_NICE = 10
HOST_WAIT_S = 300  # the longest wait for a worker's result
# the other datasets' CLI evals in the smoke: the record's flags, but a
# sweep of one batch (their full sweeps run through the CLI on their own)
DATASET_EVAL_SWEEP = ["--temperatures", "0.8", "--sample_batches", "1", "--grid_batches", "1"]
CIFAR10_TRAIN_FLAGS = ["--dataset_name", "CIFAR10"] + CLI_TRAIN_FLAGS
PNG_RGB = 2  # the colour type in a PNG's header


def dataset_eval_flags(name: str) -> list:
    """The CLI eval of dataset ``name``'s export with its record's flags."""
    return ["--dataset_name", name, "--checkpoint",
            str(EXPORTED / name / "snn-vq-vae")] + CLI_EVAL_FLAGS[2:]


INCEPTION_CALIBRATION = 4  # images whose batch statistics set the seeded net's BN
INCEPTION_IMAGES = 8
INCEPTION_REPS = 5
INCEPTION_RTOL = 1e-4  # of the largest output: the CPU tests' tolerance against JAX
RESIZE_ATOL = 1e-5
# the freeze protocol's sets, its training set cut from the canonical 60,000
# to 2,048 (5 epochs of LeNet steps, bound by the host's launches, took
# 37-55 s at 60,000 and 22 s at 6,000 beside the main sequence); the test
# set keeps the stats' CANONICAL_REF_N images
FREEZE_SIZES = (2048, 8192)
# phase zoo: the JAX modules' own widths; name -> (weights kind, the model's
# arguments, dataset, K1 launches of a forward)
# (in the order of their CPU steps' cost, the dearest first: each CPU step
# runs beside the card's later models)
ZOO_MODELS = {
    "SEW-ResNet ADD": ("sew", dict(stages=(2, 2), width=64, sew="ADD"), "CIFAR10", 10),
    "SpikingResNet": ("resnet", dict(stages=(2, 2), width=64), "CIFAR10", 9),
    "SpikingVGG vgg11": ("vgg", dict(cfg=zoo.VGG_CFGS["vgg11"]), "CIFAR10", 8),
    "PLIFNet": ("plif", dict(channels=128, voting_size=10, input_shape=(28, 28, 1)),
                "MNIST", 0),
}
ZOO_T = 4
ZOO_BATCH = 64
ZOO_STEPS = 4
ZOO_SEED = 5
ANN2SNN_T = 32
# the zoo's CPU-side worker process: started with the run, used after phase
# zoo beside the later phases, below their priority but above the recon pool's
ZOO_CPU_THREADS = 4
ZOO_NICE = 5
ANN2SNN_IMAGES = 256
ANN2SNN_SHARE = 0.99  # of the converted SNN's outputs within 1e-5 card against CPU


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


def compare_k2(name, folded, a1, dcfg, ablate: str = "") -> float:
    """K2 against its plain version on the same inputs (``ablate``: both in
    that roofline mode); max |d logits|. Bitwise where every weight is
    int8, else at the bf16 and fp32 samplers' bound."""
    out = fd.fused_denoise(a1, folded, dcfg, ablate)
    ref = fd.fused_denoise_reference(a1, folded, dcfg, ablate)
    torch.cuda.synchronize()
    diff = (out - ref).abs()
    max_d, med = float(diff.max()), float(diff.median())
    near = float((diff <= K2_NEAR).float().mean())
    log(f"  K2 {name} N={a1.shape[0]}: max|d logits| {max_d:.3g}, median "
        f"{med:.3g}, share within {K2_NEAR:g} {near:.6f}; logits std "
        f"{float(ref.std()):.4f}")
    check(bool(torch.isfinite(out).all()), "K2 logits not finite")
    check(float(ref.std()) > 0.01, "constant reference logits")
    if all(w.dtype == torch.int8 for w in folded.weights):
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


@contextlib.contextmanager
def environment(values: dict):
    """The process's environment with ``values`` set, restored after."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


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


def k2_option_arm(den, dcfg, name, env, tokens, t, flush, base_ms) -> dict:
    """One int8 arm of phase k2 on the e60 weights: the sampler's entry
    point (``make_denoise_fn``) built with ``env`` set runs K2 once on the
    token map (the launch counted; its logits those of a direct call); K2
    against its plain version in the same mode; its ms per call."""
    ablate = env.get("SD_FUSED_ABLATE", "")
    with environment(env):
        fn = fd.make_denoise_fn(den, dcfg, fused=True, dtype=torch.int8)
        fd.LAUNCHES = 0
        logits = fn(tokens, t)
        launches = fd.LAUNCHES
        folded = fd.fold_denoiser_weights(den, torch.int8)
    check(launches == 1, f"K2 {name}: {launches} launches through the sampler's entry point")
    a1 = fd.first_preactivation(tokens, t, folded.k1, folded.b1)
    direct = fd.fused_denoise(a1, folded, dcfg, ablate)
    check(torch.equal(logits.reshape(direct.shape), direct),
          f"K2 {name}: the entry point's logits are not the direct call's")
    err = compare_k2(name, folded, a1, dcfg, ablate)
    ms = cuda_ms(lambda: fd.fused_denoise(a1, folded, dcfg, ablate), flush, K2_TIMING_REPS)
    row = {"launches": launches, "max_abs_err": err, "ms": ms,
           "readout": str(folded.weights[-1].dtype).replace("torch.", ""),
           "bias_rows": folded.biases[0].shape[0]}
    if base_ms is not None:
        row["share_of_int8_row"] = ms / base_ms
    return row


def phase_k2_options(flush: torch.Tensor, card: str) -> dict:
    """K2's int8 options (per-cout scales, a 99.9 percentile clip, a bf16
    readout) and roofline ablations at batch 256 on the e60 weights, each
    chosen through JAX's environment variable: {"options", "ablations"},
    each arm's launches through the entry point, its error against the
    plain version (int8 bitwise; the bf16 readout at the bf16 sampler's
    bound) and ms per call beside the default int8 call's."""
    dcfg = DiffusionConfig()
    den = exported_denoiser(E60)
    h = dcfg.latent_size
    # a generator of its own: the other kernels' random inputs stay as they were
    gen = torch.Generator(device="cuda").manual_seed(K2_OPTIONS_SEED)
    tokens = torch.randint(0, dcfg.num_embeddings + 1, (BATCH, h, h), generator=gen,
                           device="cuda")
    t = torch.randint(1, dcfg.num_timesteps + 1, (BATCH,), generator=gen, device="cuda")
    check(not any(os.environ.get(k) for k in K2_OPTION_ENV),
          "an int8 option is set in the environment")
    base = k2_option_arm(den, dcfg, "int8 row e60", {}, tokens, t, flush, None)
    options = {name: k2_option_arm(den, dcfg, f"{name} e60", env, tokens, t, flush, base["ms"])
               for name, env in K2_OPTIONS.items()}
    ablations = {a: k2_option_arm(den, dcfg, f"int8 row, {a}, e60", {"SD_FUSED_ABLATE": a},
                                  tokens, t, flush, base["ms"]) for a in K2_ABLATIONS}
    log(f"  K2 int8 at batch {BATCH} on the e60 weights, one call (CUDA events, median of "
        f"{K2_TIMING_REPS}), through the entry point with JAX's variables: row scales "
        f"{base['ms']:.3f} ms; " + "; ".join(
            f"{n} {r['ms']:.3f} ms ({r['share_of_int8_row']:.1%})" for n, r in options.items())
        + f" [{card}]")
    log("  K2 roofline ablations, each against the plain version of its mode, as a share of "
        "the int8 call (row scales) on the same inputs: " + "; ".join(
            f"{a} {r['ms']:.3f} ms = {r['share_of_int8_row']:.1%}" for a, r in ablations.items())
        + f" [{card}]")
    return {"int8 row": base, "options": options, "ablations": ablations}


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
    launches["int8 bf16 logits"] = bf16_logits_request(den, vq, dcfg, steps, card)
    return launches


def bf16_logits_request(den, vq, dcfg, steps: int, card: str) -> tuple:
    """Request 0 through ``sample_codes`` (fused, int8) with JAX's
    ``SD_INT8_LOGITS=bf16`` in the process: the variable reaches the entry
    point (the readout folds to bf16), 49 K2 launches, valid codes and
    images, the codes of K2's plain version in the same mode. (K2 launches,
    K1 launches)."""
    n = REQUESTS[0]
    noise = request_noise(dcfg, 0, steps)
    with environment({"SD_INT8_LOGITS": "bf16"}):
        check(fd.fold_denoiser_weights(den, torch.int8).weights[-1].dtype == torch.bfloat16,
              "SD_INT8_LOGITS=bf16 did not reach the folding")
        lif_op.LAUNCHES = 0
        fd.LAUNCHES = 0
        codes, images, sample_ms, decode_ms = run_request(den, vq, dcfg, n, noise, fused=True,
                                                          dtype=torch.int8)
        k2, k1 = fd.LAUNCHES, lif_op.LAUNCHES
        codes_p, _, plain_ms, _ = run_request(
            den, vq, dcfg, n, noise, sample=plain_fused_sampler(den, dcfg, torch.int8, n, noise))
    check(fd.LAUNCHES == k2, "the plain fused run launched K2")
    log(f"  fused int8 with SD_INT8_LOGITS=bf16, request 0 batch {n}: K2 launches {k2}, K1 "
        f"launches {k1}, sampler {sample_ms:.1f} ms ({sample_ms / steps:.3f} ms/step), decode "
        f"{decode_ms:.2f} ms; K2's plain version: sampler {plain_ms:.1f} ms, codes identical "
        f"{bool(torch.equal(codes, codes_p))} [{card}]")
    check(k2 == K2_STEP_LAUNCHES, f"{k2} K2 launches, expected {K2_STEP_LAUNCHES}")
    check(k1 == K1_DECODE_LAUNCHES, f"{k1} K1 launches, expected {K1_DECODE_LAUNCHES}")
    check_outputs(codes, images, n, dcfg)
    check(torch.equal(codes, codes_p), "bf16-logits codes differ from the plain version")
    return k2, k1


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
        return (max((float((a - b).abs().max()) for a, b in pairs), default=0.0),
                sum(int((~torch.isclose(a, b, **tol)).sum()) for a, b in pairs),
                sum(a.numel() for a, _ in pairs),
                max((float(((a - b).abs() - tol["rtol"] * b.abs()).max()) for a, b in pairs),
                    default=0.0))

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


def stage1_run_model(run: str, device, dtype=None, backend: str = "auto") -> torch.nn.Module:
    """The stage-1 model of the export ``<dataset>/<model>`` under
    ``result_torch/`` (``weights_only``), full width, on branch ``backend``,
    loaded strictly, in eval mode on ``device``."""
    dataset, model = run.split("/")
    vcfg = VQVAEConfig(in_channels=DATASET_CHANNELS.get(dataset, 1))
    if model == "vq-vae":
        module = ANNVQVAE(vcfg)
    elif model == "snn-vae":
        module = SNNVAE(SNNVAEConfig(), vcfg, backend)
    else:
        module = SNNVQVAE(vcfg, lif_backend=backend, dtype=dtype)
    ckpt = torch.load(EXPORTED / run / "model.pt", map_location=device, weights_only=True)
    module.load_state_dict(ckpt["model"], strict=True)
    return module.to(device).eval()


def exported_denoiser(run: str, dtype=None, backend: str = "bnlif") -> SpikingDenoiser:
    """The denoiser of the export ``<dataset>/<model>`` on the card, on
    branch ``backend`` ('bnlif', as the CLI's eval builds it, by default),
    loaded strictly, in eval mode."""
    den = SpikingDenoiser(DiffusionConfig(), lif_backend=backend, dtype=dtype)
    ckpt = torch.load(EXPORTED / run / "diff_result" / "diff_model.pt", map_location="cuda",
                      weights_only=True)
    den.load_state_dict(ckpt["model"], strict=True)
    return den.cuda().eval()


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


def k1_at_cli_eval(what: str, vq_eval, codes: torch.Tensor, images: np.ndarray,
                   flags) -> float:
    """Every K1 launch of a CLI eval's decode of one sampling chunk (grids
    of ``codes`` repeated), of a recon batch and of the remainder batch of
    extract_code_indices (of ``images``, repeated to a batch), on the eval
    model ``vq_eval``, held bitwise against the plain version; max |d|."""
    args = cli.parse_args(flags)
    chunk = cli_chunk(flags)
    grids = codes.repeat(-(-chunk // len(codes)), 1, 1)[:chunk]
    x = torch.from_numpy(images - 0.5).cuda()
    x = x.repeat(-(-args.batch_size // len(x)), 1, 1, 1)
    remainder = args.synthetic_train % 256 or 256
    k1_err = 0.0
    for part, run in ((f"decode of {chunk} grids", lambda: vq_eval.decode_indices(grids)),
                      (f"recon of {args.batch_size} images",
                       lambda: vq_eval(x[:args.batch_size], train=False)),
                      (f"encode_indices of {remainder} images",
                       lambda: vq_eval.encode_indices(x[:remainder]))):
        launches = k1_launches_of(run)
        rates = []
        for xs, v_init, params in launches:
            k1_err = max(k1_err, compare_lif(xs, v_init, params, rate_range=None))
            rates.append(float(lif_op.lif_fwd_reference(xs, v_init, params)[0].mean()))
        log(f"  K1 at the {what}CLI eval's {part}, bf16: {len(launches)} launches, M "
            f"{[xs.shape[1] for xs, _, _ in launches]}, firing rates "
            f"{[round(r, 4) for r in rates]}, bitwise equal")
        check(len(launches) > 0 and max(rates) > 0, f"K1 at the {what}{part}: no spikes")
    return k1_err


def phase_trained_weights(card: str, cpu) -> dict:
    """The trained weights on the card: recon and the encoder's codes card
    against CPU (``cpu``: the future of ``cpu_recon``'s, computed in the
    worker process since the run's start), and the samplers on one set of
    per-step noise, K2 against its plain version on their logits."""
    dcfg = DiffusionConfig()
    vq = stage1_run_model("MNIST/snn-vq-vae", "cuda")
    den = exported_denoiser("MNIST/snn-vq-vae", backend="auto")
    ds = recon_set("MNIST/snn-vq-vae", TRAINED_IMAGES)
    recon = recon_against_cpu("MNIST/snn-vq-vae", TRAINED_IMAGES,
                              cpu.result(timeout=HOST_WAIT_S), card)

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
    den_eval = exported_denoiser("MNIST/snn-vq-vae", torch.bfloat16)
    k2_err, logit_share = {}, {}
    for n in k2_trained_sizes():
        inputs = k2_probes(dcfg, n, codes["layerwise fp32"], gen)
        for name, err in compare_k2_probes("trained", den_eval, dcfg, inputs).items():
            k2_err[name] = max(k2_err.get(name, 0.0), err)
        if n == BATCH:
            logit_share = fused_logit_share(den, dcfg, inputs)

    # K1 at the CLI eval's shapes (bf16 models, the eval's batch)
    vq_eval = stage1_run_model("MNIST/snn-vq-vae", "cuda", torch.bfloat16)
    k1_err = k1_at_cli_eval("", vq_eval, codes["layerwise fp32"], ds.test_images,
                            CLI_EVAL_FLAGS)
    return {"recon": recon, "sampler_agree": agree, "k2_max_abs_err": k2_err,
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
    dcfg = DiffusionConfig()
    with open(SYOPS_RECORD) as f:
        record = json.load(f)
    args = cli.parse_args([])
    check(record["images"] == SYOPS_RECORD_IMAGES == args.batch_size
          and record["data_sizes"] == [args.synthetic_train, args.synthetic_test],
          "the JAX record's images are not the CLI's")
    images = syops_images(BATCH)
    branches = tuple(SYOPS_VQ_LAUNCHES)
    vqs = {b: stage1_run_model("MNIST/snn-vq-vae", "cuda", backend=b) for b in branches}
    dens = {b: exported_denoiser("MNIST/snn-vq-vae", backend=b) for b in branches}
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
        vq_cpu = stage1_run_model("MNIST/snn-vq-vae", "cpu", backend=branch)
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
            for attempt in range(TRACE_ATTEMPTS):
                with trace(os.path.join(root, f"{branch}{attempt}")) as log_dir:
                    vq(images, train=False)
                with open(os.path.join(log_dir, "trace.json")) as f:
                    events = json.load(f)["traceEvents"]
                names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
                if names:
                    break
                log(f"  trace of one {branch} forward: the profiler recorded no kernel at all "
                    f"(attempt {attempt + 1} of {TRACE_ATTEMPTS})")
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


def check_two_stage_tree(result: str, sample: str, flags, what: str = "") -> list:
    """The JAX CLI's artifacts of a two-stage training run: the checkpoints
    and epoch grids, a grid per temperature, the paper image, classes/ and
    metrics.json; returns the PNG paths."""
    temp = temperatures(cli.parse_args(flags))[0]
    pngs = [os.path.join(result, n) for n in ("epoch=0_test.png", "diff_result/epoch=0_test.png")]
    pngs += [os.path.join(sample, n) for n in (f"{temp}/image_{temp}_0.png", "paper_image.png")]
    for path in pngs + [os.path.join(result, n) for n in ("model.pt",
                                                          "diff_result/diff_model.pt")]:
        check(os.path.isfile(path), f"{what}no {path}")
    classes = os.listdir(os.path.join(sample, "classes"))
    check(len(classes) > 0, f"{what}no classes/ grids")
    check_metrics(sample, flags)
    return pngs + [os.path.join(sample, "classes", c) for c in classes]


def phase_cli(card: str) -> dict:
    """``cli.main`` three times on the card: a short two-stage training run,
    the eval of the committed trained weights with the JAX record's flags,
    and that eval at 0.8 over 8,192 images, the gate on its FID."""
    with tempfile.TemporaryDirectory() as root:
        out, sample, result, train_counts, printed = cli_run(CLI_TRAIN_FLAGS, root, card)
        report = check_syops_report(printed)
        log(f"  --syops: a report of {SYOPS_LAYERS} layers, {report[SYOPS_LAYERS + 2]!r}")
        check_two_stage_tree(result, sample, CLI_TRAIN_FLAGS)
        train = {"launches": train_counts, "seconds": out["seconds"],
                 "recon": [out["recon_mse"], out["recon_ssim_loss"]], "syops": report[-6:],
                 "tree": file_tree(root)}

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


def phase_cli_vq_vae(card: str) -> dict:
    """``--model vq-vae`` (the ANN VQ-VAE) through ``cli.main`` on the card:
    a short two-stage training run (exact K3 and K2 launches, no K1) with
    ``--syops`` (no counted layer), the eval of the exported baseline with
    its record's flags, and its recon of 1,024 images card against CPU."""
    with tempfile.TemporaryDirectory() as root:
        out, sample, result, train_counts, printed = cli_run(CLI_VQ_TRAIN_FLAGS, root, card)
        report = check_syops_report(printed, layers=0)
        log(f"  --syops of the ANN VQ-VAE: no layer rows, {report[2]!r}")
        check_two_stage_tree(result, sample, CLI_VQ_TRAIN_FLAGS, "vq-vae: ")
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
    recon = recon_against_cpu("MNIST/vq-vae", TRAINED_IMAGES,
                              cpu_recon("MNIST/vq-vae", TRAINED_IMAGES), card)

    # K2 on the baseline's denoiser as its eval runs it ('bnlif', fp32
    # sampler), at the eval's sampling chunk, on the encoder's codes
    dcfg = DiffusionConfig()
    den = exported_denoiser("MNIST/vq-vae")
    gen = torch.Generator(device="cuda").manual_seed(TRAINED_STEP_NOISE_SEED)
    inputs = k2_probes(dcfg, cli_chunk(CLI_VQ_EVAL_FLAGS), recon["codes"].cuda(), gen)
    k2_err = compare_k2_probes("vq-vae trained", den, dcfg, inputs)
    logit_share = fused_logit_share(den, dcfg, inputs)
    return {"train": train, "eval": evaluation,
            "recon": recon, "k2_max_abs_err": k2_err, "fused_logits_within_1e-5": logit_share,
            "fid_1.0": vq_vae_gap(den, dcfg, card)}


def vq_vae_gap(den, dcfg, card: str) -> dict:
    """FID at 1.0 of the vq-vae baseline through the CLI's own evaluation
    (``cli._eval_generation``, on the eval's data and frozen space) for
    each of VQ_VAE_GAP_RUNS: whether its distance from the record follows
    the kernel (fused against layerwise on one draw), the arithmetic
    (bf16 against fp32) or the draw."""
    base = cli.parse_args(CLI_VQ_EVAL_FLAGS)
    ds = load_dataset(base.dataset_name, base.data_path,
                      synthetic_size=(base.synthetic_train, base.synthetic_test))
    vq = stage1_run_model("MNIST/vq-vae", "cuda")
    dens = {False: den, True: exported_denoiser("MNIST/vq-vae", torch.bfloat16)}
    rows = {}
    for label, extra in VQ_VAE_GAP_RUNS:
        args = cli.parse_args(CLI_VQ_EVAL_FLAGS[:-2] + ["--temperatures", "1.0"] + extra)
        chunks = -(-args.sample_batches * 16 // cli_chunk(CLI_VQ_EVAL_FLAGS))
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
    return stage1_run_model("MNIST/snn-vae", device, backend=backend).train()


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


# --- phase zoo: the classifier zoo and ANN -> SNN conversion ----------------

_TAP = threading.local()


def _tapped(fn, first: bool):
    """``fn`` that also copies each spike train it makes to the host, into
    the calling thread's ``_TAP.trains`` when that thread set one. When the
    thread set ``_TAP.force`` (a list of spike trains), each call instead
    puts the next train of that list forward in place of its own, with its
    own gradient (``own + (forced - own).detach()``), and records its own."""
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        own = out[0] if first else out
        trains = getattr(_TAP, "trains", None)
        if trains is not None:
            trains.append(own.detach().cpu())
        force = getattr(_TAP, "force", None)
        if force:
            s = own + (force.pop(0).to(own) - own).detach()
            out = (s,) + tuple(out[1:]) if first else s
        return out
    return wrapped


@contextlib.contextmanager
def zoo_spike_tap():
    """While open, the zoo's LIF and PLIF layers go through ``_tapped``."""
    lif, plif = zoo.lif_multi_step, zoo.plif_scan
    zoo.lif_multi_step, zoo.plif_scan = _tapped(lif, False), _tapped(plif, True)
    try:
        yield
    finally:
        zoo.lif_multi_step, zoo.plif_scan = lif, plif


def zoo_data() -> dict:
    """dataset -> (images (N, H, W, C) in [0, 1], labels) for ZOO_STEPS
    batches: synthetic MNIST and CIFAR10's synthetic fallback at 32x32x3."""
    n = ZOO_BATCH * ZOO_STEPS
    mnist = synthetic_dataset("MNIST", n_train=n, n_test=1, seed=0)
    cifar = load_cifar10(image_size=32, synthetic_size=(n, 1))
    return {"MNIST": (mnist.train_images[:n], mnist.train_labels[:n]),
            "CIFAR10": (cifar.train_images[:n], cifar.train_labels[:n])}


def zoo_state(name: str, device):
    """A fresh train state (``train_classifier``'s AdamW) of zoo model
    ``name`` from seeded flax-layout weights."""
    kind, kw, _, _ = ZOO_MODELS[name]
    variables = weights.init_zoo_variables(kind, torch.Generator().manual_seed(ZOO_SEED), **kw)
    model = weights.load_zoo_model(kind, *variables, device=device, train=True, **kw)
    return create_train_state(model, weight_decay=1e-4)


def zoo_batches(data, device) -> list:
    images, labels = data
    return [(torch.from_numpy(images[i:i + ZOO_BATCH]).to(device),
             torch.from_numpy(labels[i:i + ZOO_BATCH]).to(device))
            for i in range(0, ZOO_BATCH * ZOO_STEPS, ZOO_BATCH)]


def zoo_step(state, batch) -> dict:
    loss, acc = zoo.train_step(state.model, state.optimizer, *batch, ZOO_T)
    return {"loss": loss, "acc": acc}


def zoo_recording_step(trains: list):
    """``zoo_step`` that records the first call's spike trains into ``trains``."""
    calls = []

    def step(state, batch):
        _TAP.trains = None if calls else trains
        calls.append(batch)
        try:
            return zoo_step(state, batch)
        finally:
            _TAP.trains = None
    return step


def zoo_worker_init() -> None:
    """The zoo's CPU-side worker process: lower priority, fewer threads,
    so that the phases beside it keep the host."""
    os.nice(ZOO_NICE)
    torch.set_num_threads(ZOO_CPU_THREADS)


def zoo_worker() -> ProcessPoolExecutor:
    """The main sequence's CPU-side worker, started now (its imports off
    the later phases' path): phase trained_weights' CPU recon from the
    start, then the zoo's CPU side from phase zoo."""
    pool = ProcessPoolExecutor(1, initializer=zoo_worker_init,
                               mp_context=multiprocessing.get_context("spawn"))
    pool.submit(int)
    return pool


def forced_cpu_step(state, step, card_trains: list, t0: float) -> tuple:
    """``step()``, a training step of ``state``'s model on the CPU, with each
    LIF and PLIF layer passing on the card's spike train (``card_trains``,
    bool arrays) in place of its own, with its own gradient: (the step's
    record, its own spike trains as bool arrays, seconds since ``t0``), as
    numpy."""
    with zoo_spike_tap():
        _TAP.trains, _TAP.force = [], [torch.from_numpy(a).float() for a in card_trains]
        try:
            loss = step()
            own = [t.numpy().astype(bool) for t in _TAP.trains]
        finally:
            _TAP.trains = _TAP.force = None
    loss, grads, stats = step_record(state, loss)
    return ((loss, {k: v.numpy() for k, v in grads.items()},
             {k: v.numpy() for k, v in stats.items()}), own, time.perf_counter() - t0)


def zoo_cpu_first_step(name: str, batch: tuple, card_trains: list) -> tuple:
    """Model ``name``'s first training step on the CPU, in the zoo's worker
    process, through ``forced_cpu_step``."""
    t0 = time.perf_counter()
    state = zoo_state(name, "cpu")
    images, labels = (torch.from_numpy(a) for a in batch)
    return forced_cpu_step(state, lambda: zoo_step(state, (images, labels))["loss"],
                           card_trains, t0)


def hold_first_step(what: str, record, trains: list, cpu: tuple) -> dict:
    """A first training step on the card (``record``, its spike trains
    ``trains``) held against the CPU's (``forced_cpu_step``'s return): each
    layer's own spikes, from the card's spikes before it, differ from the
    card's in at most STAGE1_FLIP_SHARE of them; the loss, gradients and BN
    statistics at stage 1's card-against-CPU bounds (STAGE1_CPU_*)."""
    (loss, grads, stats), cpu_trains, seconds = cpu
    cpu_record = (loss, {k: torch.from_numpy(v) for k, v in grads.items()},
                  {k: torch.from_numpy(v) for k, v in stats.items()})
    flips = [int((a != b).sum()) for a, b in zip(trains, cpu_trains)]
    total = sum(b.size for b in cpu_trains)
    log(f"  {what}: spikes of its {len(cpu_trains)} spiking layers that differ between "
        f"the card and the CPU (each from the card's spikes before it): "
        f"{', '.join(map(str, flips))} of {total}; the CPU step {seconds:.1f} s")
    check(len(trains) == len(cpu_trains) and sum(flips) <= STAGE1_FLIP_SHARE * total,
          f"{what}: spikes differ from the CPU's")
    row = compare_steps(f"the CPU ({what})", record, cpu_record, False, STAGE1_CPU_LOSS_ATOL,
                        STATS_TOL, STAGE1_CPU_GRAD_TOL)
    row["spikes_differing"] = flips
    return row


def ann2snn_cpu() -> tuple:
    """``ann2snn_run`` on the CPU, in the zoo's worker process, as numpy."""
    scales, y, ann, seconds = ann2snn_run("cpu")
    return scales, y.numpy(), ann.numpy(), seconds


def zoo_routes() -> dict:
    """``lif_multi_step`` on the card by surrogate family: atan and sigmoid
    launch K1 under 'auto'; erf takes ``lif_scan`` under 'auto' (no launch)
    and raises under 'cuda' before anything is launched."""
    x = torch.rand((ZOO_T, ZOO_BATCH, 64), device="cuda") * 3.0
    rows = {}
    for family in ("atan", "sigmoid", "erf"):
        params = NeuronParams(surrogate=surrogate.get_surrogate(family, 2.0))
        reset_launch_counts()
        before = dict(neuron.ROUTES)
        neuron.lif_multi_step(x, params=params, backend="auto")
        raised = False
        try:
            neuron.lif_multi_step(x, params=params, backend="cuda")
        except ValueError:
            raised = True
        torch.cuda.synchronize()
        routes = {k: neuron.ROUTES[k] - before[k] for k in before}
        rows[family] = {"k1_launches": lif_op.LAUNCHES, "routes": routes, "cuda_raised": raised}
        kernel = family in surrogate.KERNEL_FAMILIES
        want = (2, {"kernel": 2, "scan": 0}, False) if kernel else (0, {"kernel": 0, "scan": 1}, True)
        check((lif_op.LAUNCHES, routes, raised) == want,
              f"lif_multi_step with {family}: {rows[family]}, expected {want}")
    log(f"  lif_multi_step routes on the card: {rows}")
    return rows


ANN2SNN_SPECS = [("conv", {"stride": 1, "padding": 1}), ("relu",), ("pool", 2), ("flatten",),
                 ("dense", {}), ("relu",), ("dense", {})]


def ann2snn_run(device: str) -> tuple:
    """ANN -> SNN conversion (``models/ann2snn.py``; IF neurons, plain
    PyTorch) of a seeded conv-pool-dense-dense ANN on ANN2SNN_IMAGES
    synthetic MNIST images at T = ANN2SNN_T on ``device``: (scales, SNN
    outputs, ANN outputs, seconds of the converted SNN's forward)."""
    rng = np.random.RandomState(ZOO_SEED)
    flax = [{"kernel": rng.randn(3, 3, 1, 32).astype(np.float32) * 0.3,
             "bias": rng.randn(32).astype(np.float32) * 0.1}, None, None, None,
            {"kernel": rng.randn(32 * 14 * 14, 128).astype(np.float32) * 0.02,
             "bias": np.zeros(128, np.float32)}, None,
            {"kernel": rng.randn(128, 10).astype(np.float32) * 0.1,
             "bias": np.zeros(10, np.float32)}]
    params = [None if p is None else {k: v.to(device) for k, v in p.items()}
              for p in weights.ann2snn_params(ANN2SNN_SPECS, flax)]
    x = torch.from_numpy(synthetic_dataset("MNIST", n_train=ANN2SNN_IMAGES, n_test=1,
                                           seed=1).train_images).to(device)
    snn_fn, scales = ann2snn.convert(ANN2SNN_SPECS, params, x, num_steps=ANN2SNN_T)
    t0 = time.perf_counter()
    y = snn_fn(x)
    if device == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return scales, y.cpu(), ann2snn.ann_forward(ANN2SNN_SPECS, params, x).cpu(), seconds


def zoo_ann2snn(gpu: tuple, cpu: tuple, card: str) -> dict:
    """``ann2snn_run`` on the card against the same on the CPU: the scales
    within 1e-6, at least ANN2SNN_SHARE of the outputs within 1e-5 (a conv
    summed in another order may flip an IF spike), the argmax agreement
    with the ANN logged."""
    (sc_g, y_g, a_g, s_g), (sc_c, y_c, a_c, s_c) = gpu, cpu
    y_c, a_c = torch.from_numpy(y_c), torch.from_numpy(a_c)
    d = (y_g - y_c).abs()
    share = float((d <= 1e-5).float().mean())
    agree = float((y_g.argmax(1) == a_g.argmax(1)).float().mean())
    log(f"  ann2snn at T = {ANN2SNN_T}, {ANN2SNN_IMAGES} images: scales card {sc_g[1]:.6g}, "
        f"{sc_g[5]:.6g}, CPU {sc_c[1]:.6g}, {sc_c[5]:.6g}; SNN outputs card vs CPU max|d| "
        f"{float(d.max()):.3g}, {share:.4%} within 1e-5; ANN max|d| "
        f"{float((a_g - a_c).abs().max()):.3g}; SNN argmax = ANN argmax {agree:.1%}; "
        f"snn_fn {s_g * 1e3:.1f} ms on the card (host clock), {s_c * 1e3:.1f} ms on the CPU "
        f"[{card}]")
    for a, b in zip(sc_g, sc_c):
        check((a is None) == (b is None) and (a is None or abs(a - b) <= 1e-6 * abs(b)),
              f"ann2snn scales: card {sc_g} vs CPU {sc_c}")
    check(bool(torch.isfinite(y_g).all()) and share >= ANN2SNN_SHARE,
          f"ann2snn: {share:.4%} of outputs within 1e-5 of the CPU's")
    return {"max_abs_diff": float(d.max()), "share_within_1e-5": share,
            "argmax_agree_ann": agree, "card_s": s_g}


def phase_zoo(card: str, pool: ProcessPoolExecutor) -> dict:
    """The classifier zoo at the JAX modules' widths (ZOO_MODELS) on seeded
    weights, T = ZOO_T, batch ZOO_BATCH: ZOO_STEPS training steps each
    (``zoo.train_step``, ``train_classifier``'s step) with exact K1
    launches (one forward and one backward per LIF layer; PLIF none), ms
    per step (CUDA events, median of steps 2-4) and peak memory; an eval
    forward's exact K1 launches; ``lif_multi_step``'s routes by family;
    ANN -> SNN conversion on the card. The CPU's side (each first step,
    ANN -> SNN) goes to ``pool``, a nice'd worker process that runs it
    beside the later phases; ``finish_zoo`` holds the card to it."""
    data = zoo_data()
    rows, cpu = {}, {}
    with zoo_spike_tap():
        for name, (_, _, dataset, per_forward) in ZOO_MODELS.items():
            state = zoo_state(name, "cuda")
            batches = zoo_batches(data[dataset], "cuda")
            trains = []
            times, losses, first, counts, peak = run_steps(state, zoo_recording_step(trains),
                                                           batches)
            trains = [t.numpy().astype(bool) for t in trains]
            images, labels = data[dataset]
            cpu[name] = pool.submit(zoo_cpu_first_step, name,
                                    (images[:ZOO_BATCH], labels[:ZOO_BATCH]), trains)
            want = (per_forward * ZOO_STEPS, per_forward * ZOO_STEPS, 0, 0, 0, 0, 0)
            median = statistics.median(times[1:])
            log(f"  {name} T={ZOO_T} batch {ZOO_BATCH}: launches {format_counts(counts)} in "
                f"{ZOO_STEPS} steps; ms per step {', '.join(f'{t:.2f}' for t in times)} (median "
                f"after the first {median:.2f}); losses {', '.join(f'{v:.4f}' for v in losses)}; "
                f"peak memory {peak / 2**30:.2f} GiB [{card}]")
            check(counts == want, f"{name}: launches {counts}, expected {want}")
            check(all(math.isfinite(v) for v in losses), f"{name}: loss not finite")
            state.model.eval()
            reset_launch_counts()
            with torch.no_grad():
                logits = state.model(encoding.direct_encode(batches[0][0], ZOO_T))
            torch.cuda.synchronize()
            eval_counts = launch_counts()
            check(eval_counts == (per_forward, 0, 0, 0, 0, 0, 0),
                  f"{name} eval forward: launches {eval_counts}")
            check(tuple(logits.shape) == (ZOO_BATCH, 10) and bool(torch.isfinite(logits).all()),
                  f"{name} eval logits {tuple(logits.shape)}")
            rows[name] = {"launches": counts, "eval_launches": eval_counts, "ms": times,
                          "ms_median": median, "losses": losses, "peak_bytes": peak,
                          "first": first, "trains": trains}
            del state
    torch.cuda.empty_cache()
    return {"models": rows, "cpu": cpu, "routes": zoo_routes(),
            "ann2snn": (ann2snn_run("cuda"), pool.submit(ann2snn_cpu))}


def finish_zoo(run: dict, card: str) -> dict:
    """Phase zoo held against its CPU side (``hold_first_step``). The CPU's
    first step of each model takes the card's spikes downstream of each LIF
    and PLIF layer: a spike flipped at threshold by a sum in another order
    would otherwise move the next BN's batch statistics and so flip more,
    layer after layer (the residual nets: from 1 flip at the stem to 1.1 %
    of the last block's spikes)."""
    for name, row in run["models"].items():
        row["vs_cpu"] = hold_first_step(name, row.pop("first"), row.pop("trains"),
                                        run["cpu"][name].result(timeout=HOST_WAIT_S))
    gpu, cpu = run["ann2snn"]
    return {"models": run["models"], "routes": run["routes"],
            "ann2snn": zoo_ann2snn(gpu, cpu.result(timeout=HOST_WAIT_S), card)}


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


# --- phase 15: every other committed dataset ----------------------------------


def recon_set(run: str, n: int):
    """The first ``n`` synthetic test images of the dataset of ``run``
    (``<dataset>/<model>``), on which its recon is held card against CPU."""
    return load_dataset(run.split("/")[0], synthetic_size=(0, n))


def eval_recon(model: torch.nn.Module, ds, device: str) -> tuple:
    """The CLI's recon (``cli._eval_recon``) of ``ds``'s test images at
    batch 256, and the codes its forward passes chose, (N, h, w) int32."""
    codes = []
    hook = model.register_forward_hook(lambda m, i, out: codes.append(out["indices"].cpu()))
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            recon = cli._eval_recon(argparse.Namespace(batch_size=BATCH), model, ds,
                                    torch.device(device))
    finally:
        hook.remove()
    h = DiffusionConfig().latent_size
    return recon, torch.cat(codes).reshape(-1, h, h).to(torch.int32)


def cpu_recon(run: str, n: int, batch: int = None) -> dict:
    """The CLI's recon of ``run``'s export on the CPU over ``recon_set(run,
    n)``, or over its batch of 256 ``batch`` alone: (MSE, 1 - SSIM), the
    encoder's codes, seconds."""
    t0 = time.perf_counter()
    model, ds = stage1_run_model(run, "cpu"), recon_set(run, n)
    if batch is not None:
        ds = dataclasses.replace(ds, test_images=ds.test_images[batch * BATCH:(batch + 1) * BATCH])
    recon, codes = eval_recon(model, ds, "cpu")
    return {"recon": recon, "codes": codes.numpy(), "seconds": time.perf_counter() - t0}


def pooled_cpu_recon(run: str, n: int, batch: int) -> dict:
    """``cpu_recon`` of one batch in a worker process, in one thread."""
    torch.set_num_threads(1)
    return cpu_recon(run, n, batch)


def merge_batches(parts: list) -> dict:
    """``cpu_recon``'s result over all its batches from each batch's alone:
    the CLI's means are means of the batches' values."""
    return {"recon": tuple(float(np.mean([p["recon"][i] for p in parts])) for i in (0, 1)),
            "codes": np.concatenate([p["codes"] for p in parts]),
            "seconds": sum(p["seconds"] for p in parts)}


def recon_against_cpu(run: str, n: int, cpu: dict, card: str) -> dict:
    """The CLI's recon of ``run``'s export over ``n`` test images on the
    card, with exact launches (6 K1 a batch; none for the ANN VQ-VAE), held
    against ``cpu_recon``'s: MSE and 1 - SSIM within STAGE1_CPU_LOSS_ATOL;
    the encoder's codes that differ are counted."""
    model, ds = stage1_run_model(run, "cuda"), recon_set(run, n)
    reset_launch_counts()
    t0 = time.perf_counter()
    got, codes = eval_recon(model, ds, "cuda")
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    d = [abs(a - b) for a, b in zip(got, cpu["recon"])]
    differing = int((codes != torch.from_numpy(cpu["codes"])).sum())
    log(f"  {run} recon of {n} images, fp32: card MSE {got[0]:.8f}, 1 - SSIM {got[1]:.8f} in "
        f"{seconds:.2f} s [{card}]; CPU {cpu['recon'][0]:.8f}, {cpu['recon'][1]:.8f} in "
        f"{cpu['seconds']:.2f} s of CPU time; |d| {d[0]:.3g}, {d[1]:.3g} (tol "
        f"{STAGE1_CPU_LOSS_ATOL:g}); codes differing card against CPU {differing} of "
        f"{codes.numel()}, {len(torch.unique(codes))} distinct; launches {format_counts(counts)}")
    k1 = 0 if run.endswith("/vq-vae") else 6 * n // BATCH
    check(counts == (k1, 0, 0, 0, 0, 0, 0), f"{run} recon launches {counts}")
    check(max(d) <= STAGE1_CPU_LOSS_ATOL, f"{run} recon: card against CPU")
    return {"card": got, "cpu": cpu["recon"], "seconds": [seconds, cpu["seconds"]],
            "codes_differing": differing, "codes": codes, "launches": counts}


def png_color_type(path: str) -> int:
    with open(path, "rb") as f:
        return f.read(26)[25]


def check_rgb(pngs: list, what: str) -> None:
    types = {png_color_type(p) for p in pngs}
    check(len(pngs) > 0 and types == {PNG_RGB}, f"{what}: PNG colour types {types}")
    log(f"  {what}: {len(pngs)} PNGs, all RGB")


def check_space(what: str, space: dict, null_fid: float, record: dict) -> None:
    """The frozen space of a record's eval: its stats verified, its sha and
    the null FID the record's."""
    log(f"  {what}: feature space {space}; null FID {null_fid} (JAX record "
        f"{record['null_FID']})")
    check(space.get("frozen") and space.get("stats_verified"),
          f"{what}: frozen stats not verified")
    check(space["sha256"] == record["sha256"], f"{what}: feature space {space['sha256']}")
    check(abs(null_fid - record["null_FID"]) <= DATASET_NULL_FID_ATOL,
          f"{what}: null FID {null_fid}, record {record['null_FID']}")


def cifar10_runs(card: str) -> dict:
    """CIFAR10 (3 input channels) through ``cli.main`` on the card: a
    training run and the eval of its export with the record's flags; K2 on
    its denoiser and K1 at its eval's shapes against the plain versions."""
    with tempfile.TemporaryDirectory() as root:
        out, sample, result, train_counts, printed = cli_run(CIFAR10_TRAIN_FLAGS, root, card)
        check_syops_report(printed)
        check_rgb(check_two_stage_tree(result, sample, CIFAR10_TRAIN_FLAGS, "CIFAR10: "),
                  "CIFAR10 training run")
        train = {"launches": train_counts, "seconds": out["seconds"],
                 "recon": [out["recon_mse"], out["recon_ssim_loss"]]}

    flags = dataset_eval_flags("CIFAR10")
    with tempfile.TemporaryDirectory() as root:
        out, sample, _, eval_counts, _ = cli_run(flags, root, card)
        metrics = check_metrics(sample, flags)
        check_rgb([os.path.join(d, f) for d, _, files in os.walk(sample) for f in files
                   if f.endswith(".png")], "CIFAR10 eval")
    record = DATASET_RECORDS["CIFAR10"]
    check_space("CIFAR10 eval", metrics["feature_space"], metrics["null_FID"], record)
    for t in temperatures(cli.parse_args(flags)):
        entry, rec = metrics[str(t)], record[str(t)]
        log(f"  CIFAR10 eval temperature {t}: " + ", ".join(
            f"{k} {entry[k]} (JAX record {rec[k]})" for k in rec)
            + f"; KID_x1e3 {entry['KID_x1e3']}; {entry['images_per_sec']} images/s [{card}]")
    evaluation = {"launches": eval_counts, "seconds": out["seconds"],
                  "recon": [out["recon_mse"], out["recon_ssim_loss"]], "metrics": metrics}

    # K2 on CIFAR10's denoiser as its eval runs it ('bnlif', bf16), at the
    # eval's chunk, on the encoder's codes; K1 at the eval's shapes
    dcfg = DiffusionConfig()
    images = recon_set("CIFAR10/snn-vq-vae", TRAINED_IMAGES).test_images
    codes = stage1_run_model("CIFAR10/snn-vq-vae", "cuda").encode_indices(
        torch.from_numpy(images[:BATCH] - 0.5).cuda())
    gen = torch.Generator(device="cuda").manual_seed(TRAINED_STEP_NOISE_SEED)
    inputs = k2_probes(dcfg, cli_chunk(flags), codes, gen)
    k2_err = compare_k2_probes("CIFAR10 trained", exported_denoiser("CIFAR10/snn-vq-vae", torch.bfloat16),
                               dcfg, inputs)
    k1_err = k1_at_cli_eval("CIFAR10 ", stage1_run_model("CIFAR10/snn-vq-vae", "cuda",
                                                         torch.bfloat16), codes, images, flags)
    return {"train": train, "eval": evaluation, "k2_max_abs_err": k2_err,
            "k1_max_abs_err": k1_err}


def dataset_eval(name: str, card: str) -> dict:
    """The CLI eval of dataset ``name``'s export in the side lane's process,
    after its earlier phases, with its record's flags but a sweep of one
    16-image batch: exact launches, frozen stats verified, the space's sha
    and the null FID the record's."""
    flags = dataset_eval_flags(name)[:-2] + DATASET_EVAL_SWEEP  # its own --temperatures
    with tempfile.TemporaryDirectory() as root:
        out, sample, _, counts, _ = cli_run(flags, root, card)
        metrics = check_metrics(sample, flags)
    check_space(f"{name} eval", metrics["feature_space"], metrics["null_FID"],
                DATASET_RECORDS[name])
    return {"launches": counts, "seconds": out["seconds"],
            "recon": [out["recon_mse"], out["recon_ssim_loss"]], "metrics": metrics}


def submit_cpu_recon(pool) -> dict:
    """The CPU's side of every dataset's recon (``pooled_cpu_recon``), a
    batch a job: {dataset: [future]}."""
    return {n: [pool.submit(pooled_cpu_recon, f"{n}/snn-vq-vae", TRAINED_IMAGES, b)
                for b in range(TRAINED_IMAGES // BATCH)] for n in DATASET_RECORDS}


def phase_cli_datasets(card: str, cpu: dict) -> dict:
    """CIFAR10 through the CLI on the card, then every other dataset's CLI
    eval; then each recon card against CPU, the CPU's side from ``cpu``
    (``submit_cpu_recon``'s jobs)."""
    cifar10 = cifar10_runs(card)
    evals = {n: dataset_eval(n, card) for n in DATASET_RECORDS if n != "CIFAR10"}
    recon = {n: recon_against_cpu(f"{n}/snn-vq-vae", TRAINED_IMAGES, merge_batches(
        [job.result(HOST_WAIT_S) for job in jobs]), card) for n, jobs in cpu.items()}
    for row in recon.values():
        row.pop("codes")
    return {**cifar10, "evals": evals, "recon": recon}


# --- the side lane: phases metrics_extra, cli_vq_vae, cli_datasets -----------


# the other examples of the data and tools path, at the tiny flags of
# tests/test_torch_examples.py (dvs_classify_torch runs in phase data_tools)
LANE_EXAMPLES = {
    "classify_mnist_torch": ["--epochs", "1", "--num_steps", "2", "--channels", "4"],
    "speechcommands_kws_torch": ["--epochs", "1", "--channels", "2", "--batch_size", "2",
                                 "--steps_per_epoch", "1"],
    "ann2snn_cnn_mnist_torch": ["--epochs", "1", "--steps", "4", "--calib_size", "32",
                                "--eval_size", "32"],
    "tempotron_mnist_torch": ["--epochs", "1", "--train_size", "128", "--test_size", "64",
                              "-m", "4", "-T", "8", "--batch_size", "32"],
    "stdp_trace_torch": ["--T", "32"],
    "fptt_online_torch": ["--epochs", "2"],
    "rsnn_sequential_fmnist_torch": ["--epochs", "1", "--n_train", "64", "--n_test", "32",
                                     "--hidden", "8"],
    "spiking_lstm_mnist_torch": ["--epochs", "1", "--n_train", "64", "--n_test", "32",
                                 "--hidden", "8"],
    "spiking_lstm_text_torch": ["--iters", "5", "--hidden", "8", "--batch_size", "8"],
    "rl_cartpole_dqn_torch": ["--episodes", "6"],
    "rl_cartpole_a2c_torch": ["--updates", "4", "--eval_every", "2"],
    "rl_cartpole_ppo_torch": ["--rollouts", "2", "--n_steps", "8", "--ppo_epochs", "1",
                              "--minibatch", "16", "--hidden", "16", "--eval_every", "99"],
}


def phase_data_tools_examples(card: str) -> dict:
    """Each of LANE_EXAMPLES' ``main`` on the card at its tiny flags, in the
    side lane: its last printed line and its seconds; a failure is not
    caught."""
    rows = {}
    for name, argv in LANE_EXAMPLES.items():
        module = load_example(name)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            module.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        lines = buf.getvalue().strip().splitlines()
        check(bool(lines), f"{name} printed nothing")
        log(f"  {name} {' '.join(argv)}: {lines[-1]} ({seconds:.2f} s, host clock) [{card}]")
        rows[name] = {"last_line": lines[-1], "seconds": seconds}
    return rows


def side_lane(card: str, conn, go) -> None:
    """Phases metrics_extra, cli_vq_vae, cli_datasets, cli_snn_vae and
    data_tools_examples, which share no state with the main sequence, in a
    process of their own beside it, from ``go`` on; the CPU's side of the datasets' recon runs in
    its pool from then. Sends {"log": all it printed, "results", "error": a
    traceback or None} through ``conn``; the main process prints the log
    when it joins, so that each phase's lines stay together."""
    buf = io.StringIO()
    out = {"results": None, "error": None}
    go.wait()
    with contextlib.redirect_stdout(buf):
        pool = None
        try:
            pin_arithmetic()
            pool = ProcessPoolExecutor(HOST_WORKERS, initializer=os.nice, initargs=(HOST_NICE,),
                                       mp_context=multiprocessing.get_context("spawn"))
            cpu = submit_cpu_recon(pool)
            results = {}
            with Phase("metrics_extra"):
                phase_metrics_extra(card)
            with Phase("cli_vq_vae"):
                torch.cuda.empty_cache()
                results["vq"] = phase_cli_vq_vae(card)
                results["vq"]["recon"].pop("codes")
            with Phase("cli_datasets"):
                torch.cuda.empty_cache()
                results["datasets"] = phase_cli_datasets(card, cpu)
            with Phase("cli_snn_vae"):
                torch.cuda.empty_cache()
                results["snn"] = phase_cli_snn_vae(card)
            with Phase("data_tools_examples"):
                torch.cuda.empty_cache()
                results["examples"] = phase_data_tools_examples(card)
            out["results"] = results
        except Exception:
            out["error"] = traceback.format_exc()
        finally:
            if pool is not None:
                pool.shutdown(cancel_futures=True)
    out["log"] = buf.getvalue()
    conn.send(out)
    conn.close()


class SideLane:
    """``side_lane`` in a process spawned now (its imports off the later
    phases' path) and let go after phase kernels (whose timings are then
    the card's alone): the later phases of the main sequence share the card
    and the host with it."""

    def __init__(self, card: str):
        ctx = multiprocessing.get_context("spawn")
        self.conn, child = ctx.Pipe(duplex=False)
        self.go = ctx.Event()
        self.proc = ctx.Process(target=side_lane, args=(card, child, self.go))
        self.proc.start()
        child.close()

    def start(self) -> None:
        self.t0 = time.perf_counter()
        self.go.set()

    def finish(self) -> dict:
        """Wait for the lane; print its log; its results, or raise."""
        t0 = time.perf_counter()
        out = self.conn.recv()
        self.proc.join()
        sys.stdout.write(out["log"])
        log(f"  side lane: started {t0 - self.t0:.1f} s before this join, waited for "
            f"{time.perf_counter() - t0:.1f} s")
        if out["error"] is not None:
            raise RuntimeError(f"the side lane failed:\n{out['error']}")
        return out["results"]

    def close(self) -> None:
        if self.proc.is_alive():
            self.proc.terminate()
        self.proc.join()
        self.conn.close()


def zoo_launches(run: dict, idx: int) -> dict:
    """A kernel's launches in phase zoo's training steps and eval forward,
    by model."""
    return {name: {"train_4_steps": row["launches"][idx], "eval": row["eval_launches"][idx]}
            for name, row in run["models"].items()}


def launches_of(runs: dict, idx: int) -> dict:
    """A kernel's launches (index ``idx`` of ``launch_counts()``) in each
    run of a phase."""
    return {run: row["launches"][idx] for run, row in runs.items()}


# --- phase 16: data parallel, two ranks sharing the card -----------------------

DP_RANKS = 2  # one card: the ranks share it over gloo (NCCL refuses two ranks on a GPU)
DP_BATCH = BATCH  # the global batch of the DP steps and the sampler: 128 a rank
DP_NOISE_SEED = 11
DP_CLI_FLAGS = ["--data_parallel", str(DP_RANKS)] + CLI_TRAIN_FLAGS
# The DP step is the single-process step on the global batch up to the order
# of its sums (a BN moment is the mean of the ranks' means; a gradient the
# mean of their sums). The first DP step, from the same state, is held to
# the single process's: stage 1 at the bounds of its card-against-CPU check
# (STAGE1_CPU_*, at most STAGE1_FLIP_SHARE of its spikes differing), stage 2
# at those of its 'bnlifconv' plain-on-card check (CONV_*); the parameters
# after its AdamW update within DP_PARAM_ATOL where the gradient element is
# larger than twice the gradient bound's atol (within that bound its sign,
# hence AdamW's first update, is then the same), within 2 lr elsewhere (an element at rounding
# level takes either sign, which AdamW scales to +-lr). The later steps
# start from states that differ by that much, and a spiking layer amplifies
# it (a code assignment or a spike flips): their losses are logged.
DP_PARAM_ATOL = 1e-6
# A bf16 conv's weight and bias gradients are rounded to bf16 (the
# parameters are cast to bf16 for the conv): once in one process, once on
# each rank before the ranks' mean, half an ulp each, at most 2^-8 of the
# value: 2^-7 between the two. The bf16 DP step's gradients are held at
# that rtol, GRAD_TOL's atol.
DP_BF16_GRAD_TOL = dict(rtol=2 ** -7, atol=GRAD_TOL["atol"])


def pin_arithmetic() -> None:
    """fp32 convs and matmuls without TF32, cuDNN deterministic: the kernel
    and plain runs compute the same convolutions."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def rank_values(values, mesh) -> list:
    """Every rank's list of numbers, rank by rank, on every rank."""
    row = torch.tensor([[float(v) for v in values]], dtype=torch.float64, device=mesh.device)
    return parallel.all_gather_rows(row, mesh).tolist()


def first_step_spikes(model, run):
    """(the first training step's spikes of the VQ-VAE's six LIF layers, as
    ``spike_trains`` takes them, run())."""
    mods = (*model.encoder.convs[1:], model.vq_layer, *model.decoder.deconvs)
    seen = []

    def hook(module, args):
        if len(seen) < len(mods):
            seen.append(args[0].detach())

    handles = [m.register_forward_pre_hook(hook) for m in mods]
    try:
        return seen, run()
    finally:
        for h in handles:
            h.remove()


def state_lr(state) -> float:
    return state.optimizer.param_groups[0]["lr"]


def timed_dp_step(mesh, step) -> tuple:
    """One more DP step with every collective timed (the card synchronised
    around each): (the step's host ms, its collectives' ms, their count,
    their bytes)."""
    stats = mesh.stats
    calls, nbytes, seconds = stats.calls, stats.bytes, stats.seconds
    stats.timed = True
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        stats.timed = False
    return ms, (stats.seconds - seconds) * 1e3, stats.calls - calls, stats.bytes - nbytes


def hold_dp_rank(what, mesh, dp, dp_state, launches) -> None:
    """This rank's exact launches over the DP run, and the replicas bitwise
    equal after it (a collective: every rank calls it)."""
    check(dp["counts"] == tuple(k * len(dp["losses"]) for k in launches),
          f"{what}: rank {mesh.rank} launches {dp['counts']}")
    check(parallel.replicas_equal(dp_state.model, mesh), f"{what}: replicas differ")
    log(f"  {what}: launches exact, replicas bitwise equal after {len(dp['losses'])} steps")


def stepwise(state, step_fn, batches, corruptions=None, spikes=False) -> dict:
    """``run_steps`` over the first batch, then over the others, the launch
    counts reset before each and summed: the first step's record, the
    parameters after it and (``spikes``: stage 1) its spike trains, every
    loss, the later steps' ms, the launches, the peak memory."""
    rest = corruptions[1:] if corruptions else None
    first_run = lambda: run_steps(state, step_fn, batches[:1],  # noqa: E731
                                  corruptions[:1] if corruptions else None)
    seen, first = first_step_spikes(state.model, first_run) if spikes else ([], first_run())
    params = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    later = run_steps(state, step_fn, batches[1:], rest)
    return {"record": first[2], "params": params, "spikes": seen,
            "losses": first[1] + later[1], "ms": later[0],
            "counts": tuple(a + b for a, b in zip(first[3], later[3])),
            "peak": max(first[4], later[4])}


def hold_dp_run(what, single, dp, lr, loss_atol, stats_tol, grad_tol) -> dict:
    """The DP run ``dp`` against the single-process run ``single`` (each
    ``stepwise``'s return) on the global batch: the first step's loss,
    gradients and BN statistics within the bounds, the parameters after it
    (AdamW at ``lr``) as DP_PARAM_ATOL says; the later losses logged."""
    row = compare_steps(f"{what}, the single-process step on the global batch",
                        dp["record"], single["record"], exact=False, loss_atol=loss_atol,
                        stats_tol=stats_tol, grad_tol=grad_tol)
    sure_d = loose_d = 0.0
    loose = 0
    for n, p in dp["params"].items():
        d = (p - single["params"][n]).abs()
        sure = single["record"][1][n].abs() > 2 * grad_tol["atol"]
        sure_d = max(sure_d, float(d[sure].max()) if bool(sure.any()) else 0.0)
        loose_d = max(loose_d, float(d.max()))
        loose += int((d[~sure] > DP_PARAM_ATOL).sum())
    check(sure_d <= DP_PARAM_ATOL, f"{what}: a parameter differs by {sure_d:.3g} after the "
          "first step where its gradient is beyond the bound's atol")
    check(loose_d <= 2 * lr + DP_PARAM_ATOL, f"{what}: a parameter differs by {loose_d:.3g}")
    later = [abs(a - b) for a, b in zip(dp["losses"][1:], single["losses"][1:])]
    log(f"  {what}: after the first step max |d parameter| {sure_d:.3g} where |gradient| > "
        f"{2 * grad_tol['atol']:g}, {loose_d:.3g} elsewhere ({loose} elements beyond "
        f"{DP_PARAM_ATOL:g}); losses {['%.6f' % x for x in dp['losses']]}, |d| from the "
        f"single process's in steps 2-{len(later) + 1} {['%.3g' % x for x in later]}")
    return {**row, "losses": dp["losses"], "single_losses": single["losses"],
            "param_max_d": sure_d, "param_max_d_loose": loose_d, "later_loss_d": later,
            "dp_ms": dp["ms"], "peak_bytes": dp["peak"]}


def dp_timing(what, mesh, dp, timed, card) -> dict:
    """Rank 0 logs each rank's ms per DP step and the collectives in one
    more DP step."""
    ranks = rank_values([statistics.median(dp["ms"])] + list(timed), mesh)
    for r, (ms, step_ms, coll_ms, calls, nbytes) in enumerate(ranks):
        log(f"  {what}, rank {r}: {ms:.2f} ms per DP step (median of steps 2-{TRAIN_STEPS}, "
            f"CUDA events); a timed DP step {step_ms:.2f} ms (host clock), {int(calls)} "
            f"all-reduces of {nbytes / 2**20:.2f} MiB in {coll_ms:.2f} ms [{DP_RANKS} ranks "
            f"sharing one card over gloo, not a scaling figure; {card}]")
    return {"ranks": [{"ms": r[0], "timed_step_ms": r[1], "all_reduce_ms": r[2],
                       "all_reduces": int(r[3]), "all_reduce_bytes": int(r[4])}
                      for r in ranks]}


def stage1_setting(inp, batch: int = DP_BATCH) -> tuple:
    vcfg = VQVAEConfig()
    images, var, sd = inp["stage1"]
    return (vcfg, var, sd, stage1_batches(images, batch))


def stage2_setting(mesh, inp, batch: int = DP_BATCH) -> tuple:
    dcfg = DiffusionConfig()
    variables = weights.init_denoiser_variables(dcfg, torch.Generator().manual_seed(3))
    return (dcfg, variables) + train_batches(
        dcfg, torch.from_numpy(inp["codes"]).to(mesh.device), batch)


def single_stage1(mesh, inp) -> dict:
    """Stage 1's TRAIN_STEPS steps in one process on the global batch
    (``stepwise``), the first step's spikes cut to this rank's rows."""
    vcfg, var, sd, batches = stage1_setting(inp)
    single = stepwise(create_train_state(stage1_model(vcfg, sd, "auto", mesh.device)),
                      stage1.make_train_step_vqvae(var), batches, spikes=True)
    single["spikes"] = [rank_rows(x, mesh).clone() for x in single["spikes"]]
    return single


def single_stage2(mesh, inp, dtype) -> dict:
    """Stage 2's TRAIN_STEPS steps on 'bnlif' in ``dtype`` in one process on
    the global batch (``stepwise``)."""
    dcfg, variables, batches, corruptions = stage2_setting(mesh, inp)
    return stepwise(train_state(variables, dcfg, "bnlif", mesh.device, dtype),
                    stage2.make_train_step_diffusion(dcfg), batches, corruptions)


def single_sampler(mesh) -> dict:
    """The fused bf16 sampler at DP_BATCH in one process on the trained
    weights and seeded noise, and its logits on the t = 25 probe of its
    codes."""
    dcfg = DiffusionConfig()
    den = exported_denoiser("MNIST/snn-vq-vae", dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(DP_NOISE_SEED)
    noise = list(diffusion.draw_noise(dcfg, DP_BATCH, dcfg.num_timesteps, gen, "cuda"))
    codes = sample_codes(den, dcfg, DP_BATCH, noise=noise, device="cuda", fused=True,
                         dtype=torch.bfloat16)
    probe = k2_probes(dcfg, DP_BATCH, codes, gen)[1][1]
    logits = fd.make_fused_denoise_fn(den, dcfg, torch.bfloat16)(*probe)
    return {"den": den, "noise": noise, "codes": codes, "probe": probe, "logits": logits}


def rank_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows of a time-folded (T*N, ...) tensor of the global
    batch, as (T, N / W, ...)."""
    x = x.reshape((T, -1) + tuple(x.shape[1:]))
    per = x.shape[1] // mesh.world_size
    return x[:, mesh.rank * per:(mesh.rank + 1) * per]


def dp_stage1(mesh, inp, single, card) -> dict:
    """Stage 1, layerwise (K1), fp32, TRAIN_STEPS steps at DP_BATCH over the
    ranks against the same steps in one process on this rank (``single``)."""
    vcfg, var, sd, batches = stage1_setting(inp)
    state = create_train_state(parallel.replicate(parallel.sync_batchnorm(
        stage1_model(vcfg, sd, "auto", mesh.device), mesh), mesh))
    step = stage1.make_train_step_vqvae_dp(var, mesh)
    dp = stepwise(state, step, batches, spikes=True)
    pairs = list(zip(single.pop("spikes"), dp.pop("spikes")))
    differ = sum(int((a != b.reshape(a.shape)).sum()) for a, b in pairs)
    total = sum(a.numel() for a, _ in pairs)
    del pairs
    flips = rank_values([differ, total], mesh)
    log("  stage 1, the first step's spikes differing from the single process's on the "
        "rank's rows: " + ", ".join(f"rank {r} {int(d)} of {int(n)}"
                                   for r, (d, n) in enumerate(flips)))
    check(differ <= STAGE1_FLIP_SHARE * total, f"stage 1: {differ} of {total} spikes differ")
    hold_dp_rank("stage 1, layerwise fp32", mesh, dp, state, STAGE1_STEP_LAUNCHES["layerwise"])
    row = hold_dp_run("stage 1, layerwise fp32", single, dp, state_lr(state),
                      STAGE1_CPU_LOSS_ATOL, STATS_TOL, STAGE1_CPU_GRAD_TOL)
    timed = timed_dp_step(mesh, lambda: step(state, batches[0]))
    counts = rank_values(dp["counts"], mesh)
    return {**row, "launches": counts, "spike_flips": flips,
            **dp_timing("stage 1, layerwise fp32 at 256", mesh, dp, timed, card)}


def dp_stage2(mesh, inp, dtype, single, card) -> dict:
    """Stage 2 on 'bnlif' (K3) in ``dtype``, TRAIN_STEPS steps at DP_BATCH
    over the ranks against the same steps in one process on this rank
    (``single``)."""
    dcfg, variables, batches, corruptions = stage2_setting(mesh, inp)
    state = create_train_state(parallel.replicate(parallel.sync_batchnorm(weights.load_denoiser(
        *variables, dcfg, device=mesh.device, lif_backend="bnlif", train=True, dtype=dtype),
        mesh), mesh))
    step = stage2.make_train_step_diffusion_dp(dcfg, mesh)
    dp = stepwise(state, step, batches, corruptions)
    name = "fp32" if dtype is None else "bf16"
    hold_dp_rank(f"stage 2, 'bnlif' {name}", mesh, dp, state, STEP_LAUNCHES["bnlif"])
    row = hold_dp_run(f"stage 2, 'bnlif' {name}", single, dp, state_lr(state), CONV_LOSS_ATOL,
                      CONV_STATS_TOL, GRAD_TOL if dtype is None else DP_BF16_GRAD_TOL)
    timed = timed_dp_step(mesh, lambda: step(state, batches[0], corruption=corruptions[0]))
    counts = rank_values(dp["counts"], mesh)
    return {**row, "launches": counts,
            **dp_timing(f"stage 2, 'bnlif' {name} at 256", mesh, dp, timed, card)}


def dp_sampler(mesh, single, card) -> dict:
    """The fused bf16 sampler (K2) at DP_BATCH over the ranks on the trained
    weights, against the single process on the same noise (``single``):
    codes agreement logged; the logits at t = 25 on the same rows at K2's
    bound."""
    dcfg, den = DiffusionConfig(), single["den"]
    reset_launch_counts()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    codes = sample_codes(den, dcfg, DP_BATCH, noise=single["noise"], device="cuda", fused=True,
                         dtype=torch.bfloat16, data_parallel=DP_RANKS)
    ev[1].record()
    ev[1].synchronize()
    counts = launch_counts()
    check(counts == (0, 0, 0, 0, K2_STEP_LAUNCHES, 0, 0),
          f"DP sampler: rank {mesh.rank} launches {counts}")
    check(codes.shape == (DP_BATCH, 7, 7) and int(codes.max()) < dcfg.num_embeddings,
          "DP sampler codes")
    agree = float((codes == single["codes"]).float().mean())
    tokens, t = single["probe"]
    fn = fd.make_fused_denoise_fn(den, dcfg, torch.bfloat16)
    rows = parallel.all_gather_rows(fn(parallel.shard_batch(tokens, mesh),
                                       parallel.shard_batch(t, mesh)), mesh)
    diff = (rows - single["logits"]).abs()
    near, max_d = float((diff <= K2_NEAR).float().mean()), float(diff.max())
    ms = rank_values([ev[0].elapsed_time(ev[1])], mesh)
    log(f"  DP fused bf16 sampler at {DP_BATCH}: codes equal to the single process's "
        f"{agree:.6f}; logits at t = 25 within {K2_NEAR:g} of the single process's on the "
        f"same rows {near:.6f} (bound {K2_NEAR_SHARE}), max |d| {max_d:.3g}; "
        + ", ".join(f"rank {r} {v[0]:.1f} ms" for r, v in enumerate(ms))
        + f" (CUDA events, {DP_RANKS} ranks sharing one card) [{card}]")
    check(near >= K2_NEAR_SHARE, f"DP sampler logits: {near:.4f} within {K2_NEAR:g}")
    return {"codes_agree": agree, "logits_near": near, "logits_max_d": max_d,
            "ms": [v[0] for v in ms], "launches": rank_values(counts, mesh)}


def dp_cli_launches(args, rank: int) -> tuple:
    """A rank's launches in a ``--data_parallel`` CLI run: rank 0 runs what
    the single-card run does (``cli_launches``); the others the training
    steps alone (6 + 6 K1 a stage-1 step, 5 + 5 K3 a stage-2 step)."""
    if rank == 0:
        return cli_launches(args)
    steps1 = args.epochs * (args.synthetic_train // args.batch_size)
    return (6 * steps1, 6 * steps1, K3_PER_STEP * 2 * steps1, K3_PER_STEP * 2 * steps1,
            0, 0, 0)


def file_tree(root: str) -> list:
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def dp_cli(mesh, inp, card) -> dict:
    """``cli.main(DP_CLI_FLAGS)`` on this rank, with the launches reset just
    before; rank 0 holds the artifact tree to phase cli's and the output
    to the CLI's lines."""
    root = inp["cli_root"]
    dirs = ["--result_dir", os.path.join(root, "result"),
            "--sample_dir", os.path.join(root, "sample")]
    args = cli.parse_args(DP_CLI_FLAGS)
    reset_launch_counts()
    tee = Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        out = cli.main(DP_CLI_FLAGS + dirs, device="cuda")
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    want = dp_cli_launches(args, mesh.rank)
    check(counts == want, f"DP CLI: rank {mesh.rank} launches {counts}, expected {want}")
    ranks = rank_values(counts + (seconds,), mesh)
    if mesh.rank > 0:
        check(out is None, "a rank other than 0 returned a result")
        return {}
    printed = tee.copy.getvalue()
    model_dir = os.path.join(args.dataset_name, args.model)
    check_two_stage_tree(os.path.join(root, "result", model_dir),
                         os.path.join(root, "sample", model_dir), DP_CLI_FLAGS, "DP CLI: ")
    check_syops_report(printed)
    check(f"denoiser backend: bnlif + SyncBN DP over {DP_RANKS} ranks (gloo)" in printed,
          "DP CLI: no SyncBN backend line")
    # the per-class grids are one per class that the sweep's images fall in,
    # which the draw decides: the rest of the tree must be phase cli's
    tree, want = file_tree(root), inp["cli_tree"]
    check([f for f in tree if "/classes/" not in f] == [f for f in want if "/classes/" not in f],
          f"DP CLI tree {tree} is not phase cli's {want}")
    classes = [len([f for f in t if "/classes/" in f]) for t in (tree, want)]
    log(f"  cli.main {' '.join(DP_CLI_FLAGS)}: stages "
        + ", ".join(f"{k} {v:.2f} s" for k, v in out["seconds"].items())
        + f"; recon MSE {out['recon_mse']:.6f}; the tree of phase cli's run ({len(tree)} "
        f"files; class grids {classes[0]}, phase cli's {classes[1]}); "
        + "; ".join(f"rank {r} {format_counts([int(x) for x in v[:7]])}, {v[7]:.1f} s"
                    for r, v in enumerate(ranks)) + f" [{card}]")
    return {"launches": [[int(x) for x in v[:7]] for v in ranks],
            "seconds": [v[7] for v in ranks], "stages": out["seconds"]}


def dp_rank(inp: dict) -> dict:
    """One rank of phase data_parallel (``parallel.launch`` runs it on each
    rank); rank 0's return is the phase's. The rank first runs the
    single-process references (no launch counted, nothing printed), then
    waits for ``inp["go"]``: the main process sets it after the side lane's
    join, or with ``inp["abort"]`` to stop. Only rank 0 prints."""
    pin_arithmetic()
    mesh = parallel.make_mesh(DP_RANKS)
    seconds = {"start": time.time() - inp["launched"]}
    t0 = time.perf_counter()
    single = {"stage1": single_stage1(mesh, inp),
              **{name: single_stage2(mesh, inp, dtype)
                 for name, dtype in (("fp32", None), ("bf16", torch.bfloat16))},
              "sampler": single_sampler(mesh)}
    references_done(inp, seconds, t0)
    inp["go"].wait()
    if inp["abort"].is_set():
        return {}
    inp.update(inp["late"].get())
    quiet = open(os.devnull, "w") if mesh.rank else None
    card = inp["card"]
    with contextlib.redirect_stdout(quiet) if quiet else contextlib.nullcontext():
        try:
            out = {"backend": mesh.backend}
            for part, run in (
                    ("stage1", lambda: dp_stage1(mesh, inp, single["stage1"], card)),
                    ("stage2", lambda: {name: dp_stage2(mesh, inp, dtype, single[name], card)
                                        for name, dtype in (("fp32", None),
                                                            ("bf16", torch.bfloat16))}),
                    ("sampler", lambda: dp_sampler(mesh, single["sampler"], card)),
                    ("cli", lambda: dp_cli(mesh, inp, card))):
                t0 = time.perf_counter()
                out[part] = run()
                torch.cuda.empty_cache()
                seconds[part] = time.perf_counter() - t0
            log(f"  rank 0: running {seconds['start']:.1f} s after the launch, the "
                f"references {seconds['references']:.1f} s (both before the cue); "
                "after the cue " + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()
                                             if k not in ("start", "references")))
        finally:
            if quiet:
                quiet.close()
    return {**out, "seconds": seconds}


def dp_launches(dp: dict, idx: int) -> dict:
    """A kernel's launches (index ``idx`` of ``launch_counts()``) on each
    rank in each run of phase data_parallel that launched it."""
    runs = {"stage1": dp["stage1"]["launches"], "sampler": dp["sampler"]["launches"],
            "cli": dp["cli"]["launches"],
            **{f"stage2_{d}": row["launches"] for d, row in dp["stage2"].items()}}
    return {run: [int(r[idx]) for r in ranks] for run, ranks in runs.items()
            if any(r[idx] for r in ranks)}


def nccl_probe(card: str) -> dict:
    """A world of one rank on NCCL on the card, one all-reduce: the backend
    a machine with a card per rank takes."""
    init_process_group(0, 1, free_port(), backend="nccl", device="cuda")
    try:
        mesh = parallel.make_mesh(1, backend="nccl")
        x = torch.arange(4.0, device=mesh.device)
        t0 = time.perf_counter()
        torch.distributed.all_reduce(x, group=mesh.group)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        check(mesh.backend == "nccl" and torch.equal(x.cpu(), torch.arange(4.0)),
              "NCCL all-reduce")
        log(f"  NCCL: a world of 1 on {mesh.device}, backend {mesh.backend}, all_reduce of 4 "
            f"floats in {ms:.2f} ms (host clock, the first call) [{card}]")
    finally:
        torch.distributed.destroy_process_group()
    return {"backend": "nccl", "first_all_reduce_ms": ms}


class RanksRun:
    """A phase's ranks on the card over gloo (``fn`` through ``parallel.launch``
    in a thread of this process), started some phases before their own:
    they start up and run their single-process references meanwhile, and
    run the phase after ``finish``'s cue. ``send`` hands them inputs made
    after they started (each rank takes one ``inp["late"].get()``);
    ``ready`` is set once every rank has run its references. With
    ``after`` (another run) the ranks start once that run's ranks are
    ready, so that the card holds one set of references at a time.
    ``close`` stops ranks that never had the cue."""

    def __init__(self, fn, ranks: int, inp: dict, after: Optional["RanksRun"] = None):
        ctx = multiprocessing.get_context("spawn")
        self.go, self.abort, self.ready = ctx.Event(), ctx.Event(), ctx.Event()
        self.n_ranks, self.late = ranks, ctx.Queue()
        inp = {**inp, "go": self.go, "abort": self.abort, "ready": self.ready,
               "late": self.late}
        self.pool = ThreadPoolExecutor(1)
        self.ranks = self.pool.submit(self._launch, fn, inp, after)

    def _launch(self, fn, inp: dict, after: Optional["RanksRun"]):
        while after is not None and not after.ready.wait(1.0):
            if after.ranks.done() or self.abort.is_set():
                break
        if self.abort.is_set():
            return {}
        inp["launched"] = time.time()
        return parallel.launch(fn, self.n_ranks, args=(inp,), device="cuda")

    def send(self, values: dict) -> None:
        for _ in range(self.n_ranks):
            self.late.put(values)

    def cue(self) -> None:
        """Let the ranks run their phase (once their references are done)."""
        self.go.set()

    def finish(self) -> dict:
        """Cue the ranks, if not yet; rank 0's result."""
        self.go.set()
        out = self.ranks.result()
        check(out["backend"] == "gloo", f"ranks sharing the card on {out['backend']}")
        return out

    def close(self) -> None:
        if not self.go.is_set():
            self.abort.set()
            self.send({})  # for a rank still waiting on its late inputs
            self.go.set()
        self.pool.shutdown(wait=True)
        self.late.cancel_join_thread()


def references_done(inp: dict, seconds: dict, t0: float) -> None:
    """After a rank's references: free the card's cache; once every rank is
    here, rank 0 sets ``ready``."""
    torch.cuda.empty_cache()
    seconds["references"] = time.perf_counter() - t0
    torch.distributed.barrier()
    if torch.distributed.get_rank() == 0:
        inp["ready"].set()


class DataParallelRun(RanksRun):
    """Phase data_parallel's two ranks (``dp_rank``)."""

    def __init__(self, stage1_inputs: tuple, codes: np.ndarray, card: str,
                 after: Optional[RanksRun] = None):
        self.root = tempfile.TemporaryDirectory()
        images, var, sd = stage1_inputs
        super().__init__(dp_rank, DP_RANKS, {
            "stage1": (images, var, {k: v.cpu() for k, v in sd.items()}), "codes": codes,
            "cli_root": self.root.name, "card": card}, after)

    def cue(self, cli_tree: list) -> None:
        """Cue the ranks with phase cli's artifact tree."""
        if not self.go.is_set():
            self.send({"cli_tree": cli_tree})
        super().cue()

    def finish(self, card: str, cli_tree: list) -> dict:
        """Cue the ranks, if not yet; their result and the NCCL probe's."""
        self.cue(cli_tree)
        return {**super().finish(), "nccl": nccl_probe(card)}

    def close(self) -> None:
        super().close()
        self.root.cleanup()


# --- phase 17: tensor parallel, a 2 x 2 mesh of four ranks sharing the card ------

TP_MESH = (2, 2)  # data x model; one card: the ranks share it over gloo
TP_RANKS = TP_MESH[0] * TP_MESH[1]
# the global batch of the TP steps, 32 rows a data row: full width, a
# smaller batch, since gloo copies every gather and gradient sum of a
# block's spike train through the host
TP_BATCH = 64
# the runs: (branch, dtype, what they launch per step)
TP_RUNS = {"stage1": ("auto", None, STAGE1_STEP_LAUNCHES["layerwise"]),
           "bnlif_fp32": ("bnlif", None, STEP_LAUNCHES["bnlif"]),
           "bnlif_bf16": ("bnlif", torch.bfloat16, STEP_LAUNCHES["bnlif"]),
           "bnlifconv_fp32": ("bnlifconv", None, STEP_LAUNCHES["bnlifconv"]),
           # the baselines: the ANN VQ-VAE launches no kernel (cuDNN), the
           # SNN-VAE K1 on each rank's features
           "ann_vqvae": (None, None, (0, 0, 0, 0, 0, 0, 0)),
           "snn_vae": ("auto", None, SNN_VAE_STEP_LAUNCHES["layerwise"])}
TP_NAMES = {"stage1": "stage 1, layerwise fp32", "bnlif_fp32": "stage 2, 'bnlif' fp32",
            "bnlif_bf16": "stage 2, 'bnlif' bf16", "bnlifconv_fp32": "stage 2, 'bnlifconv' fp32",
            "ann_vqvae": "the ANN VQ-VAE, stage 1 fp32", "snn_vae": "the SNN-VAE, layerwise fp32"}
TP_BASELINE_SEED = 12  # the baselines' seeded weights and the SNN-VAE's draws
TP_SNN_VAE_P = 0.2  # the SNN-VAE steps' scheduled-sampling p (phase cli_snn_vae's)
# The TP step is the single-process step on the global batch up to the
# order of its sums: a sharded conv's input gradient is the sum of the
# model ranks' partial products, a BN moment the mean of the data rows'
# means, a gradient the mean of their sums; cuDNN may also take another
# algorithm for a conv of half the output channels. The first TP step is
# held at the DP bounds of phase data_parallel (hold_dp_run).


def tp_baseline(inp, name: str, device) -> tuple:
    """(a train state of the baseline ``name`` with seeded full-width
    weights on ``device``, its single-process step, its TP step builder
    over a mesh, the TRAIN_STEPS batches at TP_BATCH). The SNN-VAE's steps
    take their draws from a generator seeded alike in every process."""
    images, var, _ = inp["stage1"]
    vcfg = VQVAEConfig()
    gen = torch.Generator().manual_seed(TP_BASELINE_SEED)
    if name == "ann_vqvae":
        model = weights.load_ann_vqvae(weights.init_ann_vqvae_variables(vcfg, gen), vcfg,
                                       device=device, train=True)
        single = stage1.make_train_step_vqvae(var)
        return (create_train_state(model), single,
                lambda mesh: stage1.make_train_step_vqvae_tp(var, mesh),
                stage1_batches(images, TP_BATCH))
    cfg = SNNVAEConfig()
    model = weights.load_snn_vae(*weights.init_snn_vae_variables(cfg, vcfg, gen), cfg, vcfg,
                                 device=device, lif_backend="auto", train=True)
    draws = torch.Generator(device=device).manual_seed(TP_BASELINE_SEED)
    one = cli.make_train_step_snn_vae()

    def wrap(step):
        return lambda state, x: step(state, x, draws, TP_SNN_VAE_P)

    return (create_train_state(model), wrap(one),
            lambda mesh: wrap(cli.make_train_step_snn_vae_tp(mesh)),
            stage1_batches(images, TP_BATCH))


def tp_single(mesh, inp, name: str) -> dict:
    """The run ``name``'s TRAIN_STEPS steps in one process on the global
    batch (``stepwise``); stage 1's first-step spikes cut to this rank's
    data row."""
    backend, dtype, _ = TP_RUNS[name]
    if name in ("ann_vqvae", "snn_vae"):
        state, step, _, batches = tp_baseline(inp, name, mesh.device)
        return stepwise(state, step, batches)
    if name == "stage1":
        vcfg, var, sd, batches = stage1_setting(inp, TP_BATCH)
        single = stepwise(create_train_state(stage1_model(vcfg, sd, backend, mesh.device)),
                          stage1.make_train_step_vqvae(var), batches, spikes=True)
        single["spikes"] = [rank_rows(x, mesh.data).clone() for x in single["spikes"]]
        return single
    dcfg, variables, batches, corruptions = stage2_setting(mesh, inp, TP_BATCH)
    return stepwise(train_state(variables, dcfg, backend, mesh.device, dtype),
                    stage2.make_train_step_diffusion(dcfg), batches, corruptions)


def tp_state(model, mesh):
    """A train state of ``model`` replicated over the world, synced over the
    data group and sharded over the model group."""
    model = parallel.replicate(parallel.sync_batchnorm(model, mesh.data), mesh.world)
    return parallel.shard_state_tp(create_train_state(model), mesh)


def timed_tp_step(mesh, step) -> tuple:
    """One more TP step with every collective timed (the card synchronised
    around each): (its host ms; then for the model group and the data
    group: the collectives' ms, count and bytes)."""
    groups = (mesh.model.stats, mesh.data.stats)
    before = [(g.seconds, g.calls, g.bytes) for g in groups]
    for g in groups:
        g.timed = True
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        out = [(time.perf_counter() - t0) * 1e3]
    finally:
        for g in groups:
            g.timed = False
    for g, (seconds, calls, nbytes) in zip(groups, before):
        out += [(g.seconds - seconds) * 1e3, g.calls - calls, g.bytes - nbytes]
    return tuple(out)


def tp_timing(what, mesh, run, single_ms, timed, card) -> dict:
    """Rank 0 logs each rank's ms per TP step beside its single process's
    (``single_ms``) and the collectives of one more TP step by group."""
    ranks = rank_values([statistics.median(run["ms"]), single_ms] + list(timed), mesh.world)
    for r, (ms, one, step_ms, m_ms, m_calls, m_bytes, d_ms, d_calls, d_bytes) in enumerate(ranks):
        log(f"  {what}, rank {r}: {ms:.2f} ms per TP step (one process on the card at the "
            f"global batch: {one:.2f}; medians of steps 2-{TRAIN_STEPS}, CUDA events); a "
            f"timed TP step {step_ms:.2f} ms (host clock): model group "
            f"{int(m_calls)} collectives of {m_bytes / 2**20:.2f} MiB in {m_ms:.2f} ms, data "
            f"group {int(d_calls)} of {d_bytes / 2**20:.2f} MiB in {d_ms:.2f} ms [{TP_RANKS} "
            f"ranks sharing one card over gloo: the process model's cost, not scaling; {card}]")
    keys = ("ms", "single_ms", "timed_step_ms", "model_ms", "model_collectives",
            "model_bytes", "data_ms", "data_collectives", "data_bytes")
    return {"ranks": [dict(zip(keys, r)) for r in ranks]}


def unshard_run(run: dict, state, mesh) -> None:
    """A ``stepwise`` run of a sharded state with its first step's record
    and parameters whole (a collective over the model group)."""
    plan = state.model.tp_plan
    loss, grads, stats = run["record"]
    run["record"] = (loss, parallel.unshard_tensors(grads, plan, mesh),
                     parallel.unshard_tensors(stats, plan, mesh))
    run["params"] = parallel.unshard_tensors(run["params"], plan, mesh)


def hold_tp_rank(what, mesh, run, state, launches) -> None:
    """This rank's exact launches over the TP run, and the replicas bitwise
    equal after it: every tensor over the data group, every replicated
    one over the model group (collectives: every rank calls it)."""
    check(run["counts"] == tuple(k * len(run["losses"]) for k in launches),
          f"{what}: rank {mesh.world.rank} launches {run['counts']}")
    check(parallel.replicas_equal_tp(state.model, mesh), f"{what}: replicas differ")
    log(f"  {what}: launches exact, every tensor bitwise equal over the data group and every "
        f"replicated one over the model group after {len(run['losses'])} steps")


def tp_run(mesh, inp, name: str, single: dict, card: str) -> dict:
    """The run ``name``: TRAIN_STEPS steps at TP_BATCH over the mesh, its
    first step, unsharded, against the same steps in one process on this
    rank (``single``); exact launches on each rank, replicas bitwise equal
    over the data group and replicated tensors over the model group."""
    backend, dtype, launches = TP_RUNS[name]
    what = TP_NAMES[name]
    if name in ("ann_vqvae", "snn_vae"):
        state, _, make_step, batches = tp_baseline(inp, name, mesh.device)
        state = tp_state(state.model, mesh)
        step = make_step(mesh)
        run = stepwise(state, step, batches)
        bounds = (STAGE1_CPU_LOSS_ATOL, STATS_TOL, STAGE1_CPU_GRAD_TOL)
        again = lambda: step(state, batches[0])  # noqa: E731
    elif name == "stage1":
        vcfg, var, sd, batches = stage1_setting(inp, TP_BATCH)
        state = tp_state(stage1_model(vcfg, sd, backend, mesh.device), mesh)
        step = stage1.make_train_step_vqvae_tp(var, mesh)
        run = stepwise(state, step, batches, spikes=True)
        bounds = (STAGE1_CPU_LOSS_ATOL, STATS_TOL, STAGE1_CPU_GRAD_TOL)
        again = lambda: step(state, batches[0])  # noqa: E731
    else:
        dcfg, variables, batches, corruptions = stage2_setting(mesh, inp, TP_BATCH)
        state = tp_state(weights.load_denoiser(*variables, dcfg, device=mesh.device,
                                               lif_backend=backend, train=True, dtype=dtype),
                         mesh)
        step = stage2.make_train_step_diffusion_tp(dcfg, mesh)
        run = stepwise(state, step, batches, corruptions)
        bounds = (CONV_LOSS_ATOL, CONV_STATS_TOL,
                  GRAD_TOL if dtype is None else DP_BF16_GRAD_TOL)
        again = lambda: step(state, batches[0], corruption=corruptions[0])  # noqa: E731
    unshard_run(run, state, mesh)
    row = {}
    if name == "stage1":
        pairs = list(zip(single.pop("spikes"), run.pop("spikes")))
        differ = sum(int((a != b.reshape(a.shape)).sum()) for a, b in pairs)
        total = sum(a.numel() for a, _ in pairs)
        del pairs
        row["spike_flips"] = rank_values([differ, total], mesh.world)
        log(f"  {what}: the first step's spikes differing from the single process's on the "
            "rank's rows: " + ", ".join(f"rank {r} {int(d)} of {int(n)}"
                                       for r, (d, n) in enumerate(row["spike_flips"])))
        check(differ <= STAGE1_FLIP_SHARE * total, f"{what}: {differ} of {total} spikes differ")
    hold_tp_rank(what, mesh, run, state, launches)
    row.update(hold_dp_run(what, single, run, state_lr(state), *bounds))
    timed = timed_tp_step(mesh, again)
    return {**row, "launches": rank_values(run["counts"], mesh.world),
            **tp_timing(f"{what} at {TP_BATCH}", mesh, run, statistics.median(single["ms"]),
                        timed, card)}


def tp_rank(inp: dict) -> dict:
    """One rank of phase tensor_parallel (``parallel.launch`` runs it on each
    rank); rank 0's return is the phase's. The rank takes the stage-2 codes
    when the main process sends them, runs the single-process references
    (no launch counted, nothing printed), then waits for ``inp["go"]``: the
    main process sets it after phase data_parallel, or with
    ``inp["abort"]`` to stop. Only rank 0 prints."""
    pin_arithmetic()
    mesh = parallel.make_mesh_2d(*TP_MESH)
    seconds = {"start": time.time() - inp["launched"]}
    inp.update(inp["late"].get())  # the codes, once phase train_stage1 has made them
    if inp["abort"].is_set():
        return {}
    seconds["codes"] = time.time() - inp["launched"]
    t0 = time.perf_counter()
    single = {name: tp_single(mesh, inp, name) for name in TP_RUNS}
    references_done(inp, seconds, t0)
    inp["go"].wait()
    if inp["abort"].is_set():
        return {}
    quiet = open(os.devnull, "w") if mesh.world.rank else None
    with contextlib.redirect_stdout(quiet) if quiet else contextlib.nullcontext():
        try:
            out = {"backend": mesh.world.backend}
            log(f"  a {TP_MESH[0]} x {TP_MESH[1]} (data x model) mesh, {TP_RANKS} ranks over "
                f"{mesh.world.backend}, a global batch of {TP_BATCH}: "
                + ", ".join(f"{n} {d}" for n, d in state_plan_summary().items()))
            for name in TP_RUNS:
                t0 = time.perf_counter()
                out[name] = tp_run(mesh, inp, name, single.pop(name), inp["card"])
                torch.cuda.empty_cache()
                seconds[name] = time.perf_counter() - t0
            log(f"  rank 0: running {seconds['start']:.1f} s after the launch, the codes "
                f"{seconds['codes']:.1f} s after it, the references "
                f"{seconds['references']:.1f} s (before the cue); after the cue " + ", ".join(
                    f"{k} {v:.1f} s" for k, v in seconds.items()
                    if k not in ("start", "codes", "references")))
        finally:
            if quiet:
                quiet.close()
    return {**out, "seconds": seconds}


def state_plan_summary() -> dict:
    """Sharded and replicated tensors of each model's plan at the mesh's tp."""
    out = {}
    for name, model in (("VQ-VAE", SNNVQVAE(VQVAEConfig())),
                        ("denoiser", SpikingDenoiser(DiffusionConfig())),
                        ("ANN VQ-VAE", ANNVQVAE(VQVAEConfig())),
                        ("SNN-VAE", SNNVAE(SNNVAEConfig(), VQVAEConfig()))):
        plan = parallel.shard_plan(model, TP_MESH[1])
        whole = [n for n, d in plan.items() if d is None]
        out[name] = (f"{len(plan) - len(whole)} of {len(plan)} tensors sharded"
                     + (f" ({', '.join(whole)} whole)" if whole else ""))
    return out


def tp_launches(tp: dict, idx: int) -> dict:
    """A kernel's launches (index ``idx`` of ``launch_counts()``) on each
    rank in each run of phase tensor_parallel that launched it."""
    return {run: [int(r[idx]) for r in tp[run]["launches"]] for run in TP_RUNS
            if any(r[idx] for r in tp[run]["launches"])}


class TensorParallelRun(RanksRun):
    """Phase tensor_parallel's four ranks (``tp_rank``)."""

    def __init__(self, stage1_inputs: tuple, card: str):
        images, var, sd = stage1_inputs
        super().__init__(tp_rank, TP_RANKS, {
            "stage1": (images, var, {k: v.cpu() for k, v in sd.items()}), "card": card})


# --- phase 19: serving and export ---------------------------------------------

E60 = EXPORTED / "MNIST" / "snn-vq-vae"
EXAMPLES = Path(__file__).resolve().parent / "examples"
SERVE_BATCH = 64
SERVE_REQUESTS = 3  # over loopback, then one call of Generator.sample
SERVE_TEMPERATURE = 0.65
SERVE_BENCH_REQUESTS = 4  # was 8; cut to make room for phase data_tools
SERVE_BENCH_BATCHES = (64, 256)
SERVE_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
NETLIST_NOISE_SEED = 13
LYNXI_LIF_LAYERS = 2  # lynxi_infer_torch's SpikingVGG((8, "M", 16, "M"))


def load_example(name: str):
    """``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def decode_png(data: bytes) -> np.ndarray:
    """The pixels of a greyscale PNG of one IDAT with filter byte 0 on
    every row, as ``utils.grids.png_bytes`` writes it."""
    check(data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG")
    pos, chunks = 8, {}
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        chunks[data[pos + 4:pos + 8]] = data[pos + 8:pos + 8 + length]
        pos += 12 + length
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    check(depth == 8 and color == 0, f"PNG of depth {depth}, colour type {color}")
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(h, w + 1)
    check(not raw[:, 0].any(), "a PNG row with a filter")
    return raw[:, 1:]


def http_get(port: int, path: str) -> tuple:
    """(status, content type, body) of a GET on the loopback server."""
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=120) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, None, b""


def expect_launches(what: str, k1: int = 0, k1_bwd: int = 0, k2: int = 0) -> tuple:
    """The launch counts since the last reset, held exactly."""
    torch.cuda.synchronize()
    got = launch_counts()
    check(got == (k1, k1_bwd, 0, 0, k2, 0, 0),
          f"{what}: {format_counts(got)}, expected K1 {k1}/{k1_bwd}, K2 {k2}")
    return got


def serve_requests(serve, card: str) -> tuple:
    """The bf16 server at batch 64 over loopback: three /generate requests,
    /healthz, /stats, a 400 and a 404, then one ``sample`` call; each
    batch held bitwise to the matching sequential draw of
    ``generate.generate``. ((K1, K2) launches, the Generator)."""
    reset_launch_counts()
    gen = serve.Generator(str(E60), SERVE_BATCH, T, 128, dtype="bf16", device="cuda")
    server = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(gen))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port = server.server_address[1]
        pngs, walls = [], []
        for _ in range(SERVE_REQUESTS):
            t0 = time.perf_counter()
            status, kind, body = http_get(
                port, f"/generate?n={SERVE_BATCH}&temperature={SERVE_TEMPERATURE}")
            walls.append(time.perf_counter() - t0)
            check((status, kind) == (200, "image/png"), f"/generate answered {status} {kind}")
            pngs.append(body)
        health = json.loads(http_get(port, "/healthz")[2])
        stats = json.loads(http_get(port, "/stats")[2])
        bad = (http_get(port, "/generate?temperature=0")[0], http_get(port, "/nope")[0])
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    check(not thread.is_alive(), "the server thread did not stop")
    check(health == {"status": "ok", "batch": SERVE_BATCH}, f"/healthz {health}")
    check(set(stats) == {"batch", "last_latency_s"} and stats["last_latency_s"] > 0,
          f"/stats {stats}")
    check(bad == (400, 404), f"bad requests answered {bad}")
    direct = gen.sample(SERVE_BATCH, SERVE_TEMPERATURE)
    # the warm-up, the requests, the sample call and the last one's speculation
    batches = 1 + SERVE_REQUESTS + 1 + 1
    counts = expect_launches("the server", k1=3 * batches, k2=49 * batches)
    ref = torch.Generator(device="cuda").manual_seed(serve.SEED)
    for i in range(SERVE_REQUESTS + 1):
        codes, images = generate_images(gen.denoiser, gen.vqvae, gen.d_cfg, SERVE_BATCH,
                                        temperature=SERVE_TEMPERATURE, generator=ref,
                                        device="cuda", fused=True, dtype=torch.bfloat16)
        check_outputs(codes, images, SERVE_BATCH, gen.d_cfg)
        images = images.cpu().numpy()
        if i < SERVE_REQUESTS:
            grid = _tile(_to_uint8(images), rows=SERVE_BATCH // 8, cols=8)
            check(np.array_equal(decode_png(pngs[i]), grid),
                  f"request {i}'s PNG is not the {i}-th sequential draw")
        else:
            check(np.array_equal(direct, images), "the sample call's images are not the "
                  "matching sequential draw's")
    log(f"  server (bf16 K2, batch {SERVE_BATCH}, e60): {SERVE_REQUESTS} /generate requests "
        f"over loopback in {', '.join(f'{w * 1e3:.1f}' for w in walls)} ms (host clock), "
        f"each PNG the matching sequential draw of generate.generate bitwise, then a "
        f"sample call's fp32 images bitwise; /healthz {health}, /stats {stats}, 400 and "
        f"404; {batches} batches drawn (warm-up and speculation included): "
        f"{format_counts(counts)} [{card}]")
    return (counts[0], counts[4]), gen


def serve_bench(serve, card: str) -> dict:
    """``bench(SERVE_BENCH_REQUESTS)`` at batch 64 and 256 in each dtype,
    the launches held."""
    out = {}
    for name in SERVE_DTYPES:
        for batch in SERVE_BENCH_BATCHES:
            reset_launch_counts()
            t0 = time.perf_counter()
            gen = serve.Generator(str(E60), batch, T, 128, dtype=name, device="cuda")
            t1 = time.perf_counter()
            row = gen.bench(SERVE_BENCH_REQUESTS, SERVE_TEMPERATURE)
            row["seconds"] = {"generator": t1 - t0, "bench": time.perf_counter() - t1}
            # the warm-up, the priming request, the requests, the last speculation
            batches = 1 + 1 + SERVE_BENCH_REQUESTS + 1
            counts = expect_launches(f"bench {name} {batch}", k1=3 * batches, k2=49 * batches)
            row["launches"] = {"K1": counts[0], "K2": counts[4]}
            out[f"{name} {batch}"] = row
            log(f"  bench({SERVE_BENCH_REQUESTS}) {name} at {batch}: p50 {row['p50_s']} s, "
                f"p90 {row['p90_s']} s, min {row['min_s']} s, max {row['max_s']} s, "
                f"{row['images_per_sec']} images/s (host clock, images on the host); "
                f"{format_counts(counts)}; the Generator built in "
                f"{row['seconds']['generator']:.2f} s (its warm-up batch included), bench "
                f"{row['seconds']['bench']:.2f} s [{card}]")
            del gen
    return out


def netlist_round_trip(vq, den, card: str) -> dict:
    """The e60 VQ-VAE's and denoiser's netlists written and read (host ms),
    the modules reloaded from them on the card; one request with injected
    noise on both pairs: codes and images bitwise equal."""
    dcfg, vcfg = den.cfg, vq.cfg
    ms = {}
    with tempfile.TemporaryDirectory() as root:
        trees = {}
        for name, module, variables, p in (
                ("svae", vq, weights.vqvae_variables, vcfg.lif.to_params()),
                ("denoiser", den, weights.denoiser_variables, dcfg.lif.to_params())):
            t0 = time.perf_counter()
            deploy.export_netlist(variables(module), os.path.join(root, name),
                                  neuron_params=p, meta={"model": name, "T": T})
            t1 = time.perf_counter()
            trees[name], manifest = deploy.import_netlist(os.path.join(root, name))
            ms[name] = {"write_ms": (t1 - t0) * 1e3,
                        "read_ms": (time.perf_counter() - t1) * 1e3,
                        "tensors": len(manifest["tensors"]),
                        "npz_bytes": os.path.getsize(os.path.join(root, name + ".npz"))}
    vq2 = weights.load_vqvae(trees["svae"]["params"], trees["svae"]["batch_stats"], vcfg,
                             device="cuda")
    den2 = weights.load_denoiser(trees["denoiser"]["params"],
                                 trees["denoiser"]["batch_stats"], dcfg, device="cuda")
    steps = len(diffusion.schedule(dcfg)[0])
    noise = list(diffusion.draw_noise(dcfg, SERVE_BATCH, steps, torch.Generator(
        device="cuda").manual_seed(NETLIST_NOISE_SEED), "cuda"))
    reset_launch_counts()
    runs = [generate_images(d, v, dcfg, SERVE_BATCH, temperature=SERVE_TEMPERATURE,
                            noise=noise, device="cuda", fused=True, dtype=torch.bfloat16)
            for d, v in ((den, vq), (den2, vq2))]
    counts = expect_launches("the netlist request", k1=6, k2=98)
    (codes, images), (codes2, images2) = runs
    check_outputs(codes, images, SERVE_BATCH, dcfg)
    check(torch.equal(codes, codes2) and torch.equal(images, images2),
          "the modules reloaded from the netlist give other codes or images")
    log(f"  netlist of the e60 weights: " + "; ".join(
        f"{n} {r['tensors']} tensors, {r['npz_bytes']} npz bytes, written in "
        f"{r['write_ms']:.1f} ms, read in {r['read_ms']:.1f} ms" for n, r in ms.items())
        + f" (host clock, the write from the card's modules); reloaded on the card, one "
        f"request of {SERVE_BATCH} on the same noise: codes and images bitwise the "
        f"originals'; {format_counts(counts)} [{card}]")
    return {"files": ms, "launches": {"K1": counts[0], "K2": counts[4]}}


def lynxi_on_card(card: str) -> dict:
    """``lynxi_infer_torch.run`` at its defaults on the card: exact K1
    launches, argmax agreement 1.0."""
    lynxi = load_example("lynxi_infer_torch")
    reset_launch_counts()
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        res = lynxi.run(out=os.path.join(root, "fmnist_vgg"), device="cuda")
        seconds = time.perf_counter() - t0
    steps = res.pop("steps")
    # each step forward and backward through both LIF layers, then the eval forward
    counts = expect_launches("lynxi_infer_torch", k1=LYNXI_LIF_LAYERS * (steps + 1),
                             k1_bwd=LYNXI_LIF_LAYERS * steps)
    check(res["agreement"] == 1.0, f"Lynxi argmax agreement {res['agreement']}")
    log(f"  lynxi_infer_torch at its defaults: {steps} training steps, argmax agreement "
        f"{res['agreement']}, max |d logit| {res['max_abs_logit_diff']:.3g} (the framework's "
        f"K1 and cuDNN against the manifest's PyTorch executor), train accuracy "
        f"{res['train_accuracy']:.3f}, exported model's test accuracy "
        f"{res['test_accuracy']:.3f}; {seconds:.2f} s (host clock); {format_counts(counts)} "
        f"[{card}]")
    return {"steps": steps, "agreement": res["agreement"],
            "max_abs_logit_diff": res["max_abs_logit_diff"], "seconds": seconds,
            "launches": {"K1": counts[0], "K1 bwd": counts[1]}}


def bitpack_on_card(vq, codes: torch.Tensor, card: str) -> dict:
    """One decode's spike train (the re-spike feeding the decoder) packed
    and unpacked on the card: bitwise, and the bytes the CPU packs."""
    with torch.no_grad():
        q = vq.vq_layer.quantize(codes.long()).permute(0, 3, 1, 2)
        spikes = vq.vq_layer.respike(q.contiguous())
    packed, shape = bitpack.pack_spikes(spikes)
    back = bitpack.unpack_spikes(packed, shape, spikes.dtype)
    rate = float(spikes.mean())
    check(packed.is_cuda and packed.dtype == torch.uint8, "packed off the card")
    check(0.0 < rate < 1.0, f"spike rate {rate}")
    check(torch.equal(back, spikes), "unpacked spikes differ")
    check(torch.equal(packed.cpu(), bitpack.pack_spikes(spikes.cpu())[0]),
          "the card packs other bytes than the CPU")
    log(f"  bitpack of one decode's spike train {tuple(shape)} (rate {rate:.4f}): "
        f"{spikes.numel() * spikes.element_size()} bytes -> {packed.numel()}, unpacked "
        f"bitwise, the CPU's bytes [{card}]")
    return {"shape": list(shape), "packed_bytes": packed.numel()}


def serve_launches(served: dict, kernel: str, dtype: Optional[str] = None) -> dict:
    """A kernel's launches in each run of phase serve_export (K2: the runs
    of sampler ``dtype``)."""
    k1, k2 = served["server_launches"]
    out = {"server": k1 if kernel == "K1" else k2} if dtype in (None, "bf16") else {}
    if dtype in (None, "bf16"):
        out["netlist"] = served["netlist"]["launches"][kernel]
    if kernel == "K1":
        out["lynxi"] = served["lynxi"]["launches"]["K1"]
    out.update({f"bench {run}": row["launches"][kernel] for run, row in served["bench"].items()
                if dtype is None or run.split()[0] == dtype})
    return out


def phase_serve_export(card: str) -> dict:
    """The server, its bench, the netlist, Lynxi and bitpack on the card."""
    t = [time.perf_counter()]
    serve = load_example("serve_torch")
    launches, gen = serve_requests(serve, card)
    t.append(time.perf_counter())
    net = netlist_round_trip(gen.vqvae, gen.denoiser, card)
    codes = torch.randint(0, 128, (SERVE_BATCH, 7, 7), device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(3))
    packed = bitpack_on_card(gen.vqvae, codes, card)
    del gen
    torch.cuda.empty_cache()
    t.append(time.perf_counter())
    lynxi = lynxi_on_card(card)
    t.append(time.perf_counter())
    bench = serve_bench(serve, card)
    t.append(time.perf_counter())
    seconds = dict(zip(("server", "netlist_bitpack", "lynxi", "bench"), np.diff(t).tolist()))
    log("  serve_export seconds (host clock): " + ", ".join(
        f"{k} {v:.2f}" for k, v in seconds.items()))
    return {"server_launches": launches, "bench": bench, "netlist": net, "lynxi": lynxi,
            "bitpack": packed, "seconds": seconds}


# --- phase data_tools: the event-camera classifier and the data path ---------

DVS_LIF_LAYERS = 2  # dvs_classify_torch's SpikingVGG((16, "M", 32, "M")): two conv + BN + LIF
DVS_TRAIN_SAMPLES = 4 * 128  # its defaults: 4 classes x 128 samples
DVS_STEPS = 5 * (DVS_TRAIN_SAMPLES // 64)  # 5 epochs of 8 batches of 64
# one K1 forward and backward per LIF layer a training step, one forward
# per layer in the prediction pass over the 128 test samples
DVS_LAUNCHES = (DVS_LIF_LAYERS * (DVS_STEPS + 1), DVS_LIF_LAYERS * DVS_STEPS, 0, 0, 0, 0, 0)
DVS_MIN_ACCURACY = 0.5  # chance is 0.25
DVS_EVENT_SETS = ((128, 0), (32, 1))  # (per class, seed): the training and test streams


def dvs_cpu_first_step(batch: tuple, card_trains: list) -> tuple:
    """dvs_classify_torch's first training step on the CPU, in the zoo's
    worker process, through ``forced_cpu_step``."""
    t0 = time.perf_counter()
    dvs = load_example("dvs_classify_torch")
    x, y = (torch.from_numpy(a) for a in batch)
    state = TrainState(*dvs.build_model(dvs.CLASSES, tuple(x.shape[2:]), "cpu"))
    return forced_cpu_step(state, lambda: dvs.train_step(state.model, state.optimizer, x, y),
                           card_trains, t0)


def dvs_run(dvs, card: str) -> dict:
    """``dvs_classify_torch.main`` at its defaults on the card, the launch
    counts reset just before; its first step recorded (the record, its
    batch, its spike trains), each step timed by CUDA events."""
    first, events = {}, []
    plain_step = dvs.train_step

    def step(model, optimizer, x, y):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        if first:
            loss = plain_step(model, optimizer, x, y)
        else:
            _TAP.trains = trains = []
            try:
                loss = plain_step(model, optimizer, x, y)
            finally:
                _TAP.trains = None
            first.update(record=step_record(TrainState(model, optimizer), loss),
                         batch=(x.cpu().numpy(), y.cpu().numpy()),
                         trains=[t.numpy().astype(bool) for t in trains])
        ev[1].record()
        events.append(ev)
        return loss

    dvs.train_step = step
    try:
        with zoo_spike_tap():
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            res = dvs.main([])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = launch_counts()
    finally:
        dvs.train_step = plain_step
    ms = [a.elapsed_time(b) for a, b in events]
    median = statistics.median(ms[1:])
    log(f"  dvs_classify_torch at its defaults ({res['train_shape'][0]} samples of "
        f"{tuple(res['train_shape'][1:])} frames, {res['steps']} steps of batch 64, then the "
        f"prediction of 128): launches {format_counts(counts)}; losses "
        f"{', '.join(f'{v:.4f}' for v in res['losses'])}; test accuracy {res['accuracy']:.3f} "
        f"(chance 0.25); ms per training step {median:.3f} (median of steps 2-{len(ms)}, CUDA "
        f"events; the first {ms[0]:.2f}); the run {seconds:.2f} s (host clock) [{card}]")
    check(counts == DVS_LAUNCHES, f"dvs_classify_torch: launches {counts}, expected "
          f"{DVS_LAUNCHES}")
    check(res["steps"] == DVS_STEPS and len(ms) == DVS_STEPS, f"dvs: {res['steps']} steps")
    check(all(math.isfinite(v) for v in res["losses"]) and res["losses"][-1] < res["losses"][0],
          f"dvs_classify_torch: the loss did not fall: {res['losses']}")
    check(res["accuracy"] > DVS_MIN_ACCURACY,
          f"dvs_classify_torch: test accuracy {res['accuracy']:.3f} <= {DVS_MIN_ACCURACY}")
    return {"launches": counts, "losses": res["losses"], "accuracy": res["accuracy"],
            "ms": ms, "ms_median": median, "seconds": seconds, "first": first}


def dvs_integrator_check(dvs, card: str) -> dict:
    """The native integrator against its plain numpy version over every
    stream of dvs_classify_torch's run (training and test sets), in both
    ``split_by`` modes: bitwise; host ms per sample of each."""
    from spiking_diffusion_tpu_torch.data.events import integrate_events_to_frames

    streams = [ev for n, seed in DVS_EVENT_SETS for ev in dvs.make_events(n, seed)[0]]
    rows = {}
    for split in ("time", "number"):
        seconds = {True: 0.0, False: 0.0}
        for ev in streams:
            out = {}
            for native in (True, False):
                t0 = time.perf_counter()
                out[native] = integrate_events_to_frames(ev, dvs.H, dvs.W, dvs.T_FRAMES, split,
                                                         use_native=native)
                seconds[native] += time.perf_counter() - t0
            check(out[True].dtype == out[False].dtype and np.array_equal(out[True], out[False]),
                  f"native integrator differs from numpy ({split})")
        rows[split] = {"native_ms": seconds[True] * 1e3 / len(streams),
                       "plain_ms": seconds[False] * 1e3 / len(streams)}
    log(f"  native integrator bitwise its plain numpy version on all {len(streams)} streams "
        f"(200 events each) in both modes; host ms per sample, native / plain: " + "; ".join(
            f"{s} {r['native_ms']:.4f} / {r['plain_ms']:.4f}" for s, r in rows.items())
        + f" [host of {card}]")
    return {"samples": len(streams), **rows}


def dvs_folder_check(dvs, card: str) -> dict:
    """``--dataset nmnist`` on a tree ``NMNIST.synthesize`` writes: the run,
    then its frame cache read again, bitwise the frames integrated from the
    events (the cache's first pass)."""
    from spiking_diffusion_tpu_torch.data import neuromorphic as nm

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        res = dvs.main(["--dataset", "nmnist", "--root", root])
        seconds = time.perf_counter() - t0
        base = os.path.join(root, "nmnist")
        cache = os.path.join(base, "frames_number_8_split_by_number")
        check(os.path.isdir(cache), f"no frame cache at {cache}")
        n = 0
        for train in (True, False):
            kw = dict(data_type="frame", frames_number=dvs.T_FRAMES, split_by="number")
            again = nm.NMNIST(base, train=train, **kw)
            events = nm.NMNIST(base, train=train)
            check([p for p, _ in again.samples] == [
                p.replace(os.path.join(base, "events_np"), cache) for p, _ in events.samples],
                "the frame cache's samples are not the events'")
            for i in range(len(events)):
                want = nm.integrate_by_fixed_frames(events[i][0], "number", dvs.T_FRAMES,
                                                    *nm.NMNIST.get_H_W())
                check(np.array_equal(again[i][0], want) and again[i][1] == events[i][1],
                      f"cached frames of {events.samples[i][0]} differ")
                n += 1
    log(f"  --dataset nmnist on a synthesized tree: {res['train_shape'][0]} training samples "
        f"of {tuple(res['train_shape'][1:])}, {res['classes']} classes, losses "
        f"{', '.join(f'{v:.4f}' for v in res['losses'])}, accuracy {res['accuracy']:.3f}, "
        f"{seconds:.2f} s; its {n} cached frame sets, read again, bitwise the integrated "
        f"events [{card}]")
    return {"accuracy": res["accuracy"], "losses": res["losses"], "cached": n,
            "seconds": seconds}


def mask_check() -> dict:
    """``padded_sequence_mask`` on a CUDA lengths tensor: a bool (T, N)
    tensor on the card, equal to the CPU's."""
    from spiking_diffusion_tpu_torch.data.neuromorphic import padded_sequence_mask

    lengths = torch.tensor([5, 1, 0, 3, 7], device="cuda")
    mask = padded_sequence_mask(lengths)
    want = padded_sequence_mask(lengths.cpu().numpy())
    check(mask.device.type == "cuda" and mask.dtype == torch.bool
          and tuple(mask.shape) == (7, 5) and torch.equal(mask.cpu(), want),
          f"padded_sequence_mask on the card: {mask}")
    log(f"  padded_sequence_mask on a CUDA lengths tensor: {tuple(mask.shape)} bool on "
        f"{mask.device}, equal to the CPU's")
    return {"shape": list(mask.shape)}


def phase_data_tools(card: str, pool: ProcessPoolExecutor) -> dict:
    """dvs_classify_torch on the card (exact K1 launches, the loss falling,
    accuracy over DVS_MIN_ACCURACY; its first step's CPU side submitted to
    ``pool``), the native integrator, the folder path and the mask."""
    t = [time.perf_counter()]
    dvs = load_example("dvs_classify_torch")
    run = dvs_run(dvs, card)
    first = run.pop("first")
    run["cpu"] = pool.submit(dvs_cpu_first_step, first["batch"], first["trains"])
    run["record"], run["trains"] = first["record"], first["trains"]
    t.append(time.perf_counter())
    run["integrator"] = dvs_integrator_check(dvs, card)
    t.append(time.perf_counter())
    run["folder"] = dvs_folder_check(dvs, card)
    t.append(time.perf_counter())
    run["mask"] = mask_check()
    t.append(time.perf_counter())
    run["seconds"] = dict(zip(("dvs_run", "integrator", "folder", "mask"), np.diff(t).tolist()))
    log("  data_tools seconds (host clock): " + ", ".join(
        f"{k} {v:.2f}" for k, v in run["seconds"].items()))
    return run


def finish_data_tools(run: dict) -> dict:
    """dvs_classify_torch's first step on the card held against the CPU's,
    as phase zoo's (``hold_first_step``)."""
    trains = run.pop("trains")
    check(len(trains) == DVS_LIF_LAYERS, f"dvs: {len(trains)} spike trains recorded")
    run["vs_cpu"] = hold_first_step("dvs_classify_torch", run.pop("record"), trains,
                                    run.pop("cpu").result(timeout=HOST_WAIT_S))
    return run


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU", file=sys.stderr)
        return 2
    signal.signal(signal.SIGALRM, over_budget)
    signal.alarm(BUDGET_S)
    t_start = time.perf_counter()
    dp_run = tp_run = side = None
    zoo_pool = None
    try:
        with Phase("device"):
            smi = nvidia_smi()
            kind = torch.cuda.get_device_name(0)
            log(f"  {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
            pin_arithmetic()
            log("  cudnn.allow_tf32=False cuda.matmul.allow_tf32=False "
                "cudnn.deterministic=True cudnn.benchmark=False")
        zoo_pool = zoo_worker()
        # phase trained_weights' CPU recon, in the worker from now on
        trained_cpu = zoo_pool.submit(cpu_recon, "MNIST/snn-vq-vae", TRAINED_IMAGES)
        side = SideLane(smi)
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
                # each weight type, with and without the noshift ablation
                found = [n for n in k2_hmma if kname in n]
                check(len(found) == 6 and all(k2_hmma[n] > 0 for n in found),
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
            k2_options = phase_k2_options(flush, smi)
            k3 = phase_k3(gen, flush)
            k4 = phase_k4(gen, flush, smi)
            k1_s1 = phase_k1_stage1(gen, flush)
            k3_s1 = phase_k3(gen, flush, stage1_lif_shapes(), STAGE1_PLAIN_REPS,
                             "stage-1 training step")
            del flush
        # the side lane's phases run beside the main sequence from here, and
        # phase tensor_parallel's ranks start up
        side.start()
        stage1_inputs = stage1_setup(VQVAEConfig())
        tp_run = TensorParallelRun(stage1_inputs, smi)
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
            dp_codes = codes.cpu().numpy()
            train1["bnlif"].pop("codes_array")
            # the TP ranks run their references from here; then phase
            # data_parallel's ranks start up and run theirs
            tp_run.send({"codes": dp_codes})
            dp_run = DataParallelRun(stage1_inputs, dp_codes, smi, after=tp_run)
            del stage1_inputs
            train = phase_train(dcfg, codes, smi)
        with Phase("trained_weights"):
            torch.cuda.empty_cache()
            trained = phase_trained_weights(smi, trained_cpu)
        with Phase("syops"):
            torch.cuda.empty_cache()
            profiled = phase_syops(smi)
        with Phase("cli"):
            cli_runs = phase_cli(smi)
        with Phase("zoo"):
            # its CPU side runs in the nice'd worker beside the later phases,
            # where this process waits for the side lane and the ranks
            torch.cuda.empty_cache()
            zoo_pending = phase_zoo(smi, zoo_pool)
        with Phase("serve_export"):
            # phase data_parallel's ranks take their cue now and phase
            # tensor_parallel's when those are done: their steps run beside
            # this phase
            dp_run.cue(cli_runs["train"]["tree"])
            dp_run.ranks.add_done_callback(lambda _: tp_run.cue())
            torch.cuda.empty_cache()
            served = phase_serve_export(smi)
        with Phase("data_tools"):
            # the dvs example's CPU first step runs in the zoo's worker
            torch.cuda.empty_cache()
            data_pending = phase_data_tools(smi, zoo_pool)
        with Phase("side_lane"):
            lane = side.finish()
            vq, datasets, snn = lane["vq"], lane["datasets"], lane["snn"]
            snn_runs = {"cli_train": snn["train"], "cli_eval": snn["eval"],
                        **{f"sample {b}": row for b, row in snn["sample"].items()},
                        **{f"{b} {n}": row for b, rows in snn["steps"].items()
                           for n, row in rows.items()}}
            vq_runs = {"cli_train": vq["train"], "cli_eval": vq["eval"]}
            dataset_runs = {"cifar10_train": datasets["train"], "cifar10_eval": datasets["eval"],
                            **{f"{n} eval": row for n, row in datasets["evals"].items()},
                            **{f"recon {n}": row for n, row in datasets["recon"].items()}}
        with Phase("data_parallel"):
            dp = dp_run.finish(smi, cli_runs["train"]["tree"])
        with Phase("tensor_parallel"):
            tp = tp_run.finish()
        with Phase("zoo_check"):
            zoo_run = finish_zoo(zoo_pending, smi)
        with Phase("data_tools_check"):
            data_tools = finish_data_tools(data_pending)
        log(f"total {time.perf_counter() - t_start:.1f} s")
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        signal.alarm(0)
        for ranks in (side, dp_run, tp_run):
            if ranks is not None:
                ranks.close()
        if zoo_pool is not None:
            zoo_pool.shutdown(cancel_futures=True)
    kernels = [{
        "name": "K1 lif_fwd", "route": "cuda",
        "source": "spiking_diffusion_tpu_torch/csrc/lif_fwd.cu",
        "replaces": K1_REPLACES, "launches": launches,
        # random inputs at the path's shapes, stage 1's and the CLI eval's
        "max_abs_err": max(k1["max_abs_err"], k1_s1["fwd_err"], trained["k1_cli_max_abs_err"],
                           snn["k1_max_abs_err"], datasets["k1_max_abs_err"]),
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
        # the datasets' CLI runs and each dataset's recon of 1,024 images
        "launches_cli_datasets": launches_of(dataset_runs, 0),
        # the profiler's runs on the trained weights (phase syops)
        "launches_syops": profiled["launches"][0],
        # phase data_parallel, per rank: 6 a DP stage-1 step; the CLI run
        "launches_data_parallel": dp_launches(dp, 0),
        # phase tensor_parallel, per rank: 6 a TP stage-1 step
        "launches_tensor_parallel": tp_launches(tp, 0),
        # phase zoo: 8 / 9 / 10 / 0 a training step and an eval forward
        # (SpikingVGG, SpikingResNet, SEW-ResNet, PLIFNet), in 4 steps + 1
        "launches_zoo": zoo_launches(zoo_run, 0),
        # phase serve_export: 3 a served batch (the decode), 6 in the netlist
        # request pair, 2 a Lynxi VGG step and its eval forward
        "launches_serve_export": serve_launches(served, "K1"),
        # phase data_tools: dvs_classify_torch at its defaults, 2 a training
        # step (40 steps) and 2 in the prediction pass
        "launches_data_tools": data_tools["launches"][0],
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
        "launches_cli_datasets": launches_of(dataset_runs, 1),
        "launches_data_parallel": dp_launches(dp, 1),
        "launches_tensor_parallel": tp_launches(tp, 1),
        "launches_zoo": zoo_launches(zoo_run, 1),
        # phase serve_export: 2 a training step of lynxi_infer_torch's VGG
        "launches_serve_export": {"lynxi": served["lynxi"]["launches"]["K1 bwd"]},
        # phase data_tools: 2 a dvs_classify_torch training step (40 steps)
        "launches_data_tools": data_tools["launches"][1],
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
            # the datasets' CLI runs: fp32 in CIFAR10's training run, bf16
            # in every eval
            "launches_cli_datasets": {
                run: row["launches"][4] if name == ("fp32" if run == "cifar10_train" else "bf16")
                else 0 for run, row in dataset_runs.items() if not run.startswith("recon")},
            # phase data_parallel, per rank: the bf16 sampler's 49; the CLI
            # run's fp32 sweep on rank 0
            "launches_data_parallel": {run: n for run, n in dp_launches(dp, 4).items()
                                       if (run == "sampler") == (name == "bf16")
                                       and (run == "cli") <= (name == "fp32")},
            # phase serve_export: 49 a served batch, warm-up and speculation
            # included (the server and the netlist request bf16; bench each)
            "launches_serve_export": serve_launches(served, "K2", name),
            # on the vq-vae baseline's denoiser at its eval's chunk of 512
            "max_abs_err_trained_vq_vae": vq["k2_max_abs_err"][name],
            # on CIFAR10's denoiser at its eval's chunk of 512
            "max_abs_err_trained_cifar10": datasets["k2_max_abs_err"][name],
            # on the trained weights: the first reverse step and t = 25, at
            # batch 256 and at the CLI's chunk sizes
            "max_abs_err_trained": trained["k2_max_abs_err"][name],
            # one call at batch 256; no single PyTorch call is the denoiser
            "library_ms": None, **row, "sass_hmma": k2_hmma,
            # int8: the e60 weights at 256 through the entry point with JAX's
            # variables, each option's and ablation's one launch, error and
            # ms; the request with SD_INT8_LOGITS=bf16 in phase
            # generation_fused
            **({"e60_int8_row": k2_options["int8 row"], "options": k2_options["options"],
                "ablations": k2_options["ablations"],
                "launches_bf16_logits_request": fused_launches["int8 bf16 logits"][0]}
               if name == "int8" else {}),
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
            "launches_cli_datasets": launches_of(dataset_runs, idx),
            "launches_syops": profiled["launches"][idx],
            # phase data_parallel, per rank: 5 a DP stage-2 step; the CLI run
            "launches_data_parallel": dp_launches(dp, idx),
            # phase tensor_parallel, per rank: 5 a TP stage-2 step on 'bnlif'
            # (fp32 and bf16) and on 'bnlifconv'
            "launches_tensor_parallel": tp_launches(tp, idx),
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
            "launches_cli_datasets": launches_of(dataset_runs, idx),
            "launches_generation": conv_gen["launches"][idx],
            # phase tensor_parallel, per rank: 6 a TP 'bnlifconv' step
            "launches_tensor_parallel": tp_launches(tp, idx),
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
