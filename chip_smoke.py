#!/usr/bin/env python3
"""Drive the PyTorch port (pdm_tpu_torch) on one NVIDIA GPU and check it.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA card, nvcc (CUDA_HOME or /usr/local/cuda) and nothing of
the JAX package. Phases, each of which fails the run (non-zero exit) on
any error or disagreement:

1. The card's name and power limit, torch and CUDA versions, and the
   build of every kernel from pdm_tpu_torch/csrc/ (nvcc, sm_90a).
2. Every kernel of the main path at every shape the flagship UNet gives
   it, against its plain PyTorch version on the same card inputs, with
   the tolerance stated; times beside the bound and one library call as a
   yardstick. A time is the card's (CUDA events, median of repetitions,
   warm L2, the host's enqueue hidden behind a sleep kernel); the host's
   own cost per call is reported beside it. Attention (row 1) also at the
   edge shapes ATTN_EDGES in bf16: head dims that pad to 16, 32, 64 and
   128, and T 512 (the two-pass kernel); GroupNorm (row 3) also at
   GN_EDGES (one group of 512 channels, 3 channels a group, fp32 at the
   largest tile). Every shape's kernel is called twice (bitwise equal);
   GroupNorm's launch plan is printed.
3. The full-width flagship UNet in fp32 on the card (kernels) against the
   same weights on the CPU (plain versions) at batch 2, and a 10-step
   fp32 DDIM sample on both from the same starting noise.
4. The main path: the bf16 flagship (seeded random weights, std 0.02) in
   DDPMSampler(step_type="ddpm", n_steps=N_STEPS, batch_size=64,
   precision="half") on LinearBetaScheduler(1e-4, 2.478e4): 100 steps of
   bench.py's 1000 (launch counts are per step, so fewer steps check as
   much). The launch counters are zeroed just before and read just after;
   each kernel must have launched exactly its per-forward count times
   N_STEPS. Then the card's
   busy time for one model evaluation against the step's wall time, and a
   torch.profiler trace of 20 more steps: the card's time per step by
   kernel and by kind of kernel.
5. The backward kernels at every shape the flagship's training step
   gives them (batch 128, bf16, and fp32 for attention; attention also
   at ATTN_EDGES in bf16), and the forward kernels at the training batch, against
   their plain versions, with times beside the bound, the plain version
   and one library call's backward alone (torch.autograd.grad over
   scaled_dot_product_attention, and over group_norm then silu); the
   GroupNorm backward (row 4) also at GN_EDGES. Every shape's kernels are
   called twice (bitwise equal); GroupNorm's launch plan is printed. Then
   rows 1 and 2, untimed, at every head dim they take (8 to 128 by 8) at
   T 16, 64, 256 and 512, bf16 and fp32.
6. The full-width fp32 flagship train step (batch 2, dropout off, the
   same tau and eps) on the card against the CPU: loss and every
   gradient the step applied within the stated tolerance of their scale,
   then the parameters after that Adam step. Then a probe of the card's
   backward: two backward passes of that step's loss on the same inputs,
   compared bitwise, as the card runs by default and under
   cudnn.deterministic with use_deterministic_algorithms(True); the
   largest difference of each parameter group is printed.
7. The training main path: the bf16 flagship with fp32 master weights in
   DDPMTrainer(lr 1e-4, warmup 10, total 1000, clip 1.0, EMA 0.9999), as
   bench.py's train step, at batch 128 of N(0, 1) CIFAR-shaped data from a
   seed with dropout 0.2. Warm steps, then timed steps with the launch
   counters zeroed just before and read just after: each of the four
   kernels must have launched exactly its per-step count. Loss and
   grad_norm finite; the card's busy time per step against the wall time;
   a torch.profiler breakdown; a checkpoint saved, resumed into a fresh
   trainer (the resumed state equal to the saved one) and one more step.
8. The fused multi-temperature Boltzmann sweep kernel against its plain
   version on the same card inputs (the first 64 rows), in all three
   precision modes, with and without an (N, 1) payload, at CIFAR-10 scale
   (B = 1024 starts, N = 50,000, D = 3072, 32 temperatures) and at edge
   shapes (gmm1d's D = 1 with N = 1e6; high_dim_exp's D = 100, N = 1e5,
   200 temperatures; no tile's multiple; one start), each within a
   tolerance derived from the Grams' rounding (sweep_logit_error), and
   two calls bitwise equal; the kernel in fp32 against one moments pass
   per temperature; times beside the bound, the plain version and the two
   Grams alone through cuBLAS. fp32 runs the 128-row kernel, the bf16
   modes the 64-row one (each shape prints its plan).
9. The statistics main path: thermo_sweep on the card at CIFAR-10 scale
   (fp32, global-floor regularization) with the sweep's launch counter
   zeroed just before and read just after (two launches per batch);
   bench.py's sweep_pairs_per_sec; the streamed tier against the
   device-resident sweep on the same draws; metric_stats with adaptive
   k-NN; the entropy and metric schedules from the sweep (tau -> log_temp
   -> tau on the card and the CPU) and a 10-step DDIM sample of the bf16
   flagship on each; a warm sweep's wall time against the card's busy
   time (profiler kernel sum): the idle share.
10. The single-temperature moments kernel (the analytic denoiser's op)
   against its plain version on the same card inputs, in all three
   precision modes, with the payload (and at the main shape without), at
   CIFAR-10 scale (B = 1000 queries, N = 50,000, D = K = 3072, the data as
   payload) and at high_dim_exp's D = 100, gmm1d's D = 1 with N = 1e6, the
   schedule CLI's B = 1024 over N = 100,000 at D = K = 1, the
   MC metric's K = 2D payload, one query at no tile's multiple, and the
   MC metric's K = 2D = 6144 at CIFAR-10's D (above the cluster kernel's
   threshold); queries noised from data points with one temperature per
   row over the sampler's range. Each within what the Grams' rounding
   allows (moments_logit_error, moments_check) and two calls bitwise
   equal; times beside the bound, the plain version and the Gram and
   payload products alone through cuBLAS. Each shape prints the kernel its
   plan chose: tall (fp32), cluster (bf16 modes, K % 4 == 0 up to 3072)
   or tiled (the bf16 modes' other calls), so all three launch.
11. The analytic main path: TrueDDPM on LinearBetaScheduler(1e-4,
   2.478e4) over 50,000 CIFAR-shaped points, DDIM 10 steps at batch 1000,
   the moments launch counter zeroed just before and read just after (two
   per step); every step's x0 against the plain version on the same xt;
   ms/step, samples/s, a CUDA-event breakdown of a step and the card's
   idle share; finite samples and the share a training image memorized.
12. The paper's experiments on the card: high_dim_exp.yaml (the sweep,
   the metric and cosine schedules, TrueDDPM DDPM-20 for 10,000 samples
   each: MMD, component occupancy, MSE), gmm1d (DDPM-10, MMD, modes hit)
   and the model-based and MC metric estimators against their Gaussian
   closed forms.
13. The whole attention block (rows 5 and 6, the opt-in path) against
   its plain versions on the same card inputs at the flagship's attention
   shapes (T 256 and the 4x4 mid block's 16, C 256, 4 heads): the forward
   at batch 64 and 128, the backward at 128 (every gradient of the
   autograd Function: dx, dh, dW_q/k/v, db_qkv, dW_out, db_out), bf16 and
   fp32, with times beside the bound, the plain version and the library
   composition (F.linear, scaled_dot_product_attention, F.linear, add;
   for the backward that composition's autograd); each kernel called twice
   (bitwise equal), the launch plan printed; beside each, the staged
   launch plan forced at the same shape and inputs, held to the same
   tolerance and timed (staged_ms). Then, untimed, the edge
   shapes BLOCK_EDGES (T 16 at head dims 16 and 32 with 8 heads, T 64, a
   ragged T with packing, two packed images a strip, three key chunks, 75
   packed groups, more clusters than the card holds at once), bf16 and
   fp32, each twice, bitwise equal; the forward's rows (out, lse) and the
   backward's (dh, weight and bias gradients) are held and reported apart.
14. The whole-block sampling path, PDM_FUSED_BLOCK=1 set for phases 14-16
   only: one bf16 model evaluation against the default path on the same
   input, then the bf16 flagship's DDPM-50 at batch 64 (phase 4 runs
   100; the counts are per step), with
   exactly 8 row-5 launches, no row-1 launch and 69 GroupNorm launches
   per step, the card's busy time and a profiler breakdown; then the
   default and whole-block paths in ten alternating pairs of short turns
   (TURN_STEPS steps each), whose per-pair differences say whether the
   whole block's 48 fewer launches a step move the host-bound rate.
15. The whole-block training path: the bf16 train step at batch 128 as
   phase 7, with exact launch counts (row 5 8 and row 6 24 per step, rows
   1 and 2 none, GroupNorm 69 and 69) and the card's busy time; then the
   two paths in two alternating pairs of turns on the same trainer
   (TRAIN_TURN_STEPS steps each).
16. The whole-block path in fp32 at full width, card vs CPU: the UNet
   forward at batch 2 and the train step as phase 6.
17. The config path, as scripts/train_diffusion.py and make_eval_fn drive
   the JAX package, in a temporary working directory: load_config() (the
   port's copy of config.yaml) and ddpm_from_config build the bf16
   flagship (47.2 M parameters, the hand-built module's names, shapes and
   dtypes); a PDMC cache of 50,000 seeded uint8 32x32x3 images
   (runtime.write_cache, the native runtime asserted) loads through
   get_data_tensor bitwise as numpy decodes it; DDPMTrainer from
   config.ddpm_training (batch 128, lr 2e-4, warmup 5000, clip 10, EMA
   0.9999, a CSVLogger and a PhaseTimer) takes 5 steps on that tensor and
   5 from the same data as HostResidentData (pinned staging), each with the
   launch counters zeroed just before and read just after (rows 1-4 at
   phase 7's counts per step), every host-resident batch bitwise the rows
   np.random.default_rng((0, it)) names; a checkpoint, then
   ddpm_from_config(pretrained=True) bitwise the saved EMA; the eval hook
   (PDM_INCEPTION_WEIGHTS set to phase 18's seeded InceptionV3 npz, its
   reference statistics over the 50,000 images at construction): the
   DDIM-100 grid, read back from its PNG, and FID over 64 DDIM-100
   samples (1,600 row-1 and 13,800 row-3 launches), a finite,
   non-negative fid_100_steps; without the weights, fid.required refused;
   the seeded
   flagship written as a diffusers directory under legacy attention names
   (.safetensors and .bin) and imported through --ddpm.diffusers_path, its
   bf16 forward bitwise the same weights loaded directly; model_name true
   over the same cache, DDIM 10 at the sample group's batch of 1000 (row 7
   twice a step, every step's x0 against the plain version as phase 11);
   the data layer's load time and the host-resident gather's rate.
18. FID and the entry points, in a temporary working directory: the
   float64 trace_sqrtm_product and frechet_distance at F 2048, full rank
   and rank 64, against the nuclear norm of the centred features'
   product in float64 on the CPU (SQRTM_TOL; no eigh, no threshold), the
   FID of a set with itself 0, the eigh's ms; InceptionV3 with seeded
   random weights (a JAX-layout npz, PDM_INCEPTION_WEIGHTS set for
   phases 17-18 only): 16 images' features card vs CPU (INCEPTION_TOL),
   TF32 off inside the extractor and restored after, ms per 1,000 images
   at batch 500 and peak memory; a LeNet trained on the card on seeded
   MNIST-shaped data and its FID card vs CPU; then the four CLIs, in this
   process through each one's main(argv=...) with the flags a user gives
   python -m pdm_tpu_torch.scripts.<name> (in-process, so that the launch
   counters can be read; python -m itself is not run), over PDMC caches
   of CIFAR-10's shape (50,000 train, 10,000 test): compute_stats_forward,
   the flagship's train_diffusion for 5 steps with an eval (grid and FID
   over CLI_FID_SAMPLES samples, cut from cifar10's 50,000) at step 5,
   sample from its checkpoint, compute_fid with n_steps [10] over as
   many; each with
   rows 1-4's and row 8's launch counters zeroed just before and read
   just after (exact counts), its wall time, and its artifact read back
   (a finite, non-negative FID in the training log and the FID table).
   Then (18e) the nine offline experiment CLIs (sample_gmm, the three
   verify_*_metric, analyze_synthetic_stats, compute_stats_empirical and
   compute_model_metric_schedule on the analytic denoiser over the same
   cache, reproduce_high_dim, e2e_synthetic) and export_sampler with its
   artifact replayed, each once through its main() at the CPU tests'
   sizes, with its wall time and launches (rows 7 and 8 exact; rows 1
   and 3 in e2e_synthetic printed).
19. Schedule optimization through the sampler. (a) Row 7b, the
   posterior mean's VJP (csrc/boltzmann_moments_vjp.cu), against its
   plain version on the same card inputs at VJP_SHAPES (the CLI's B 1024
   over the 1-D GMM's 100,000 points, D = 1; CIFAR-10 scale, B 256, N
   50,000, D 3072, in all three modes; an edge shape with D % 4 != 0),
   queries at one temperature per row, the first at T = 1e-4 (one-hot),
   each within vjp_tolerance and two calls bitwise equal; the plan each
   call took printed (the small-D path, one fused kernel and the merge, 2
   launches, for fp32 at D <= 4; else the Grams kernel, the split-K
   product and the merge, 3 launches at one segment), its launches exact;
   times beside the bound, the plain version and the library composition.
   (b) The knot
   gradient of mean(x^2) through sample_with_grid, card against CPU, from
   the same x_init and noise: TrueDDPM on the 1-D GMM for all four step
   types, the fp32 flagship at batch 2 with remat. (c) The CLI
   (pdm_tpu_torch/scripts/optimize_schedule.py) in this process through
   main() at JAX's constants: rows 7 and 7b two launches each a step
   (row 7b on the small-D path), exactly; a finite
   history; the npz read back, its knots sorted and in the clip range;
   JAX's criterion (MMD after <= 1.2 x before over three seeds of 512
   samples); its wall time. (d) The schedule optimizer through TrueDDPM
   at CIFAR-10 scale (50,000 N(0, 1) points, 10 knots, batch 256, DDIM, 3
   iterations): ms per iteration, exact launch counts (row 7 two a step,
   row 7b three on the large-D path), rows 7 and 7b's share of the card's
   time and the idle share (profiler); 19c and 19d print the figures of
   row 7b's previous design beside their own. (e) Through the
   bf16 flagship (seeded weights, eval mode) as
   scripts/optimize_schedule_flagship.py sets it (5 knots, batch 256,
   DDPM, remat, rate 0.05, LeNet-feature MMD), 5 iterations (cut from
   200): ms per iteration, peak memory, finite knots, rows 1-4's launch
   counts exact.
20. The data axis (pdm_tpu_torch/parallel/) on the one card. (a) One
   rank in a world-size-1 group started by the CLIs' entry,
   initialize_multihost (file rendezvous, LOCAL_RANK set), which must
   pick NCCL and this card: thermo_sweep(mesh=)
   at phase 9's shape against the sweep without a mesh within the
   regrouped-sum bound (STREAM_EPS), TrueDDPM DDIM-10 at phase 11's shape
   through sharded_sampler against the sampler without a mesh (row 7 two
   launches a step), feature_statistics(mesh=) over 5,000 images, and the
   bf16 flagship's data-parallel train step at batch 128 with rows 1-4 at
   phase 7's exact counts a step; each beside its time without a mesh,
   the step's collective bill (one all-reduce of the fp32 gradients and
   the loss), that all-reduce alone by CUDA events, and project_step's
   NVLink projection for 2, 4 and 8 cards. (b) Two ranks sharing the card
   under gloo (asked for by name: NCCL refuses two ranks on one device),
   started with torch.multiprocessing (spawn), each half of the dataset
   or of the batch: the sweep's and the moments' shard merge (rows 8 and
   7 on each half) at CIFAR-10 scale, the TrueDDPM data-parallel sampler,
   the fp32 flagship's train step at batch 2 (1 a rank, dropout 0.2)
   against one process (loss, gradients, parameters after Adam), FSDP's
   share of the masters, EMA and Adam moments (at most half plus the
   leaves no dimension of which 2 divides) and its step against the
   data-parallel one, and the bf16 train step at batch 128 (64 a rank)
   with exact launch counts on each rank. The ranks print their own
   lines; a failing rank fails the run.
21. The model axis (parallel/model_parallel.py). (a) Rows 3s and 4s, the
   split-statistics GroupNorm kernels (csrc/groupnorm_split.cu), each
   against its plain version at B 64, S 1024 cut into 2 and 4 row pieces,
   C 128 and 256, G 32, bf16 and fp32, and at B 8, S 65536 cut in 2, C
   128, bf16 (the first level of a 256 x 256 image), each launch called
   twice (bitwise equal), its card launches counted (one a call each:
   the kernel's counter and the PyTorch operators beside it), timed on
   one piece beside the previous design's time ("was"), its bound, plain
   version and a library call, and timed again cold, each call on a copy
   of its inputs that L2 no longer holds (its share of the HBM bound is
   taken from that time); the
   pieces' pair (their sums
   added in piece order, as the model group's all-reduce adds them)
   against rows 3 and 4 on the whole image; then the pair at one rank
   against row 3 (4) on the same shape, timed. (b) Two ranks sharing the
   card under gloo on a 1 x 2 mesh: the bf16 flagship's channel (TP) and
   spatial (SP) forward at
   batch 64 and the fp32 one at batch 8 against one process on the card
   (rows 1 and 3, and 3s, at exact counts), one fp32 train step of each
   partition at batch 2 against one process (loss, whole gradients,
   parameters after Adam), the bf16 train steps at batch 8 of each
   partition and of one process with exact launches (rows 1-4; under SP
   rows 3s/4s for the 61 GroupNorms outside the attention blocks), their
   model-axis byte bill by kind and project_step's NVLink projection on
   2, 4 and 8 cards, and sharded_sampler(partition="spatial") fp32
   DDIM-5 at batch 64 against the unsharded sampler. (c) Four ranks
   sharing the card under gloo on a 1 x 4 mesh: the spatial sampler of
   the tiny UNet at 18 x 18 (4 does not divide 18, so every level runs
   whole on every rank), fp32 DDIM-3 at batch 4, against the unsharded
   sampler, and one fp32 spatial train step at 18 x 18, batch 4, against
   one process, each with no halo exchanged and no row 3s/4s launch.
22. Serving (pdm_tpu_torch/utils/serving.py, rows 1, 3, 5 and 7 as
   torch.library custom ops). (a) The bf16 flagship (phase 4's weights)
   in DDPMSampler(step_type="ddim", n_steps=50, batch_size=64,
   precision="half"): one step exported with torch.export into a
   temporary directory, replayed in a fresh process that imports only
   pdm_tpu_torch.ops and the loader, against batch_sample on the same
   seed (within 1e-4, bitwise expected), with exactly 8 row-1 and 69
   row-3 launches a step; export s, bytes, replay and eager ms a step in
   alternating turns, row 3's enqueue through the op against the direct
   launch, and five steps of the loaded program and of the eager step
   module under the profiler (card ms, host self CPU ms, the pdm:: ops'
   share). (b) The same exported with PDM_FUSED_BLOCK=1, DDIM-10,
   replayed with the setting unset: 8 row-5 and 69 row-3 launches a
   step. (c) TrueDDPM over phase 11's 50,000 CIFAR-shaped N(0, 1) points
   at batch 1000 with DDPM-10 (the loader draws each step's noise): 2
   row-7 launches a step, bitwise batch_sample. The directory is deleted.
23. The 256x256 family (models/configs.py's CELEBAHQ_UNET:
   google/ddpm-celebahq-256's architecture, 113.67 M parameters, six
   attention blocks of one head of 512) in bf16 with seeded weights, and
   the single-head 32 x 32 DDPM (heads of 256). Rows 1 and 2 (head dims
   above 128: attention_wide.cu) against their plain versions at every
   attention shape of both models,
   bf16 and fp32, timed beside the bound, the plain version and SDPA (its
   backend named), and untimed at head dims 136-576 and T 8-1024, each
   call twice (bitwise equal); rows 3 and 4 at every GroupNorm shape of
   the family at batch 8 (S 65536 x C 128 down to S 64 x C 512). Then
   config.json and the weights (write_safetensors) in a temporary
   directory -> load_config -> ddpm_from_config(model_name diffusers) ->
   the sample CLI's build_sampler: DDIM-50 at batch 8, two batches, with
   exactly 6 row-1 and 71 row-3 launches a step and no plain attention on
   a CUDA tensor; DDPMTrainer at batch 8 x grad_accum 16, three steps
   (rows 1-4 exactly 6, 12, 71 and 71 a micro-batch, finite loss); the
   fp32 family at batch 1, card vs CPU (FORWARD_TOL); the single-head
   32 x 32 DDPM's DDIM-10 at batch 64 (6 row-1 launches a step). The
   host's load, clocks and a fixed loop's time are sampled before and
   after the family's sampler and train steps (host_clock), beside their
   host-bound times. The whole block at every
   geometry JAX's gate admits: rows 5 and 6 on the staged plan
   against their plain versions at the family's blocks (B 8), the
   single-head 32 x 32's (B 64, and B 128 with the backward) and the
   edges BLOCK_WIDE_EDGES, bf16 and fp32, timed beside the bound, the
   plain version and the library composition (SDPA's backend named),
   each call twice (bitwise equal), launches exact (BLOCK_LAUNCHES); then
   with
   PDM_FUSED_BLOCK=1: (g) the family's DDIM-50 (18 row-5 launches and 71
   row-3 a step, no row-1), (h) its train step (18 row-5 and 48 row-6
   launches a micro-batch), then the two paths in HIGHRES_TURN_PAIRS
   alternating pairs of turns (a batch of the sampler, a train step),
   (i) its fp32 forward card vs CPU, (j) a
   single-head tiny UNet's fp32 train step card vs CPU, (k) the
   single-head 32 x 32's DDIM-10; no plain version on a card tensor
   (plain_on_card_spy).
24. One JSON line {"kernels": [...]} with all seventeen kernels (the
   eight rows, 7b, rows 1 and 2 at wide head dims, rows 5 and 6 on the
   staged plan, and rows 3s/4s' four entries, each with its worst error
   as a fraction of its tolerance; phases 18e's, 20's, 21's, 22's and
   23's launches among their paths), then the last line {"ok": true,
   "device": {...}}.
"""

from __future__ import annotations

import contextlib
import datetime
import functools
import gc
import itertools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

# H100 SXM data sheet (dense): bytes/s of HBM3, operations/s by type
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

N_STEPS = 100  # the main path's DDPM steps (bench.py runs 1000)
BATCH = 64
PROFILE_STEPS = 20  # main-path steps traced for the time breakdown
FLAGSHIP = {
    "freq_shift": 1, "flip_sin_to_cos": False,
    "down_block_types": ["DownBlock2D", "AttnDownBlock2D", "DownBlock2D",
                         "DownBlock2D"],
    "up_block_types": ["UpBlock2D", "UpBlock2D", "AttnUpBlock2D", "UpBlock2D"],
    "block_out_channels": [128, 256, 256, 256],
    "downsample_padding": 0, "attention_head_dim": 64,
    "dropout": 0.2, "norm_eps": 1e-6, "layers_per_block": 3,
}
# tolerances of kernel vs plain version on the same card inputs:
# fp32 differs by summation order only; bf16 outputs may differ by one
# rounding step of the output (ulp / |value| <= 2^-7 for bf16)
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 2e-3)}  # (rtol, atol)
FORWARD_TOL = 1e-3  # fp32 UNet forward / DDIM sample, card vs CPU, of scale
# backward kernel vs plain version, (rtol, atol as a fraction of the
# tensor's max |value|): fp32 by summation order; bf16 by one rounding step
# of an output or of a rounded P / ds inside the kernel
BWD_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (2 ** -7, 2 ** -8)}
PARAM_GRAD_TOL = (1e-4, 1e-4)  # dscale / dbias: fp32 sums over B and S
# fp32 train step, card vs CPU: loss relative; each gradient 1e-3 of its
# own scale plus 1e-5 of the largest gradient's (to_k.bias's gradient is
# zero in exact arithmetic); the Adam step below
TRAIN_TOL = {"loss": 1e-4, "grad": 1e-3, "grad_floor": 1e-5}
TRAIN_BATCH = 128  # bench.py's train step
TRAIN_WARM = 3
TRAIN_STEPS = 30
TRAIN_PROFILE_STEPS = 5
# per-step calls on the training path: 8 attention and 69 GroupNorm layers,
# each once forward and once backward; attention's backward is two kernels
TRAIN_LAUNCHES = {"attention_fwd": 8, "attention_bwd": 16,
                  "group_norm_fwd": 69, "group_norm_bwd": 69}
# rows 1 and 2 off the main path, timed beside the main shapes: (T, head
# dim, heads) with head dims that pad to 16, 32, 64 and 128 in the
# single-pass kernels (T <= 256) and T 512 in the two-pass ones
ATTN_EDGES = ((16, 8, 8), (64, 24, 4), (256, 40, 4), (256, 128, 2),
              (512, 64, 4), (512, 128, 2))
# and untimed, every head dim the kernels take at these T, bf16 and fp32
ATTN_SWEEP_T = (16, 64, 256, 512)
ATTN_SWEEP_HD = tuple(range(8, 129, 8))
# operations per element of the GroupNorm backward (fp32), over its three
# passes: statistics 3; normalizing 2, the SiLU VJP ~10, partials 2, dn 1;
# normalizing again 2 and dx 4 (dn stays on chip from the second pass)
GN_BWD_OPS = {"silu": 24, "none": 14}
# GroupNorm edge shapes beside the main path's (B, S, C, groups, dtype,
# act): one group of 512 channels (the backward once refused more than 256
# a group; at S 1024 its plan streams), 3 channels a group, and fp32 at the
# largest tile at the fp32 train step's batch
GN_EDGES = ((128, 64, 512, 1, "bfloat16", "silu"), (64, 1024, 512, 1, "bfloat16", "silu"),
            (64, 64, 96, 32, "bfloat16", "silu"), (2, 1024, 384, 32, "float32", "silu"))

# The opt-in whole attention block (rows 5 and 6, PDM_FUSED_BLOCK=1): the
# flagship's attention geometries (T, C, heads) with their calls per model
# evaluation (seven blocks at 16x16, the mid block at 4x4)
BLOCK_GEOMS = ((256, 256, 4, 7), (16, 256, 4, 1))
# and untimed, shapes off the flagship's path: (B, T, heads, head dim) with
# T 16 at head dims 16 and 32 and 8 heads, T 64 (one image a strip, the
# packing's edge), a ragged T with packing (40: one image and 24 rows of
# padding a strip), two packed images a strip (T 24, B 9: a partial
# group), three key chunks and a padding strip (T 192), T 100 at head dim 16
BLOCK_EDGES = ((5, 16, 8, 16), (5, 16, 8, 32), (4, 64, 8, 64), (5, 40, 4, 32),
               (9, 24, 2, 64), (3, 192, 2, 64), (3, 100, 4, 16), (600, 16, 4, 64))
# rows 5 and 6 against their plain versions, (rtol, atol as a fraction of
# the tensor's max |value|): fp32 by summation order; bf16 by a rounding
# (of q, k, v, P or att forward; of datt, P, ds or dqkv backward) that the
# other summation order can flip, which moves what follows by about one
# bf16 step (2^-8) of that operand, and a backward product sums two such
BLOCK_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2 ** -7, 2 ** -7)}
BLOCK_BWD_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (2 ** -6, 2 ** -6)}
# one bf16 model evaluation, whole-block path against the default path on
# the same input, of the output's scale: the two round at other points (the
# residual add, the qkv bias add), as the bf16 UNet and JAX's do
# (tests/test_torch_unet.py holds those to the same 2e-2)
FUSED_VS_DEFAULT_TOL = 2e-2
# per-step launches of the whole-block training path: 8 blocks, once
# forward and once backward (three kernels), no row 1 or 2 launch
# phase 14's whole-block DDPM sampler (phase 4 runs the default path's
# N_STEPS): launch counts are per step, so fewer steps check as much
BLOCK_SAMPLER_STEPS = 50
TURN_STEPS = 50        # sampler steps per turn of the two paths' comparison
TURN_PAIRS = 10        # alternating (default, whole block) pairs of turns
TRAIN_TURN_STEPS = 10  # train steps per turn
# the launches of one whole-block call by (route, backward), written out
# here so that a launch a wrapper drops or adds shows: cluster, one kernel
# forward and three backward; staged, the qkv projection, row 1 and the out
# projection forward, and backward the qkv projection, row 1, the datt
# projection, row 2's two kernels, the dh projection, the weight gradients
# and their merge
BLOCK_LAUNCHES = {("cluster", False): 1, ("cluster", True): 3,
                  ("staged", False): 3, ("staged", True): 8}
BLOCK_TRAIN_LAUNCHES = {"attention_fwd": 0, "attention_bwd": 0,
                        "block_fwd": 8, "block_bwd": 24,
                        "group_norm_fwd": 69, "group_norm_bwd": 69}

# The statistics path: the sweep at CIFAR-10 scale on data of CIFAR-10's
# shape from a seed (N(0, 1), N = 50,000, D = 3072), B = 1024 starts, 32
# temperatures over CIFAR-10's range 1e0-1e6 (config/yaml/groups/
# forward_stats.yaml, config/datasets.py). Edge shapes: gmm1d (D = 1,
# N = 1e6, T 1e-4-1e1), high_dim_exp (D = 100, N = 1e5, 200 temperatures,
# batch 500, T 1e-4-1e4), no tile's multiple, and one start.
# (label, B, N, D, n_temps, log10 T range)
SWEEP_MAIN = ("cifar10", 1024, 50_000, 3072, 32, (0.0, 6.0))
SWEEP_EDGES = (("gmm1d", 1024, 1_000_000, 1, 32, (-4.0, 1.0)),
               ("high_dim", 500, 100_000, 100, 200, (-4.0, 4.0)),
               ("ragged", 77, 5003, 333, 7, (-1.0, 3.0)),
               ("one_start", 1, 50_000, 3072, 32, (0.0, 6.0)))
SWEEP_MODES = ("fp32", "bf16_3x", "bf16")
SWEEP_SUBSET = 64  # rows held against the plain version
SWEEP_PASSES = {"fp32": 1, "bf16_3x": 3, "bf16": 1}
# operations per (row, point, temperature) of the epilogue: the logit 4,
# max 1, exp and its argument 2, g 1, three sums and two products 5; the
# payload adds a product and a sum
SWEEP_EPI_OPS = 13
BENCH_SWEEP = (1024, 96, (-2.0, 2.0), 4)  # bench.py:174-198: B, temps, range, reps
STREAM = (256, 10_000)  # n_samples, stream_chunk of the streamed tier
# the streamed tier and the device-resident sweep compute the same Gram
# entries; they differ in how the fp32 sums over the N points are grouped
# (chunks, then merges). Each such sum is within ~sqrt(N) 2^-24 of its
# terms' scale; the fields are built from terms up to log N (entropy) or
# their own size, so |diff| <= STREAM_EPS sqrt(N) (|value| + 1 + log N),
# with a factor 4 for the four sums (s0, s1, s2 and the merge's rescale)
STREAM_EPS = 4 * 2.0 ** -24
ROUNDTRIP_TOL = 1e-4  # tau -> log_temp -> tau on the knot schedules

# The analytic denoiser's path (row 7): TrueDDPM over data of CIFAR-10's
# shape (N(0, 1), N = 50,000, D = 3072), DDIM 10 steps at batch 1000 on
# LinearBetaScheduler(1e-4, 2.478e4) (config/yaml/groups/sample.yaml,
# ddpm.yaml, diffusion.yaml; n_samples raised from 100 to one batch), the
# data itself as the payload (K = D). The kernel is also held at
# high_dim_exp.yaml's D = 100, gmm1d's D = 1 with N = 1e6, mc_metric's
# K = 2D payload and one query at no tile's multiple, each with per-row
# temperatures over the sampler's range and queries noised from data
# points as the sampler meets them. (label, B, N, D, K)
MOMENTS_MAIN = ("cifar10", 1000, 50_000, 3072, 3072)
MOMENTS_EDGES = (("high_dim", 1000, 50_000, 100, 100),
                 ("gmm1d", 100, 1_000_000, 1, 1),
                 # the schedule CLI's shape (scripts/optimize_schedule.py:
                 # batch 1024 over 100,000 points, D = K = 1)
                 ("cli", 1024, 100_000, 1, 1),
                 ("mc_metric", 256, 20_000, 100, 200),
                 ("edges", 1, 5003, 333, 131),
                 # the MC metric's K = 2D payload at CIFAR-10's D: above the
                 # cluster kernel's K <= 3072, so the bf16 modes run the
                 # tiled kernel here (ops/boltzmann_kernel.py::kernel_choice)
                 ("over_threshold", 256, 20_000, 3072, 6144))
MOMENTS_LOG10_T = (-4.0, math.log10(2.478e4))
MOMENTS_SUBSET = 64  # rows held against the plain version, over the T range
# operations per (row, point) of the moments epilogue, as the sweep's
MOMENTS_EPI_OPS = 13
TRUE_STEPS = 10  # DDIM steps of the analytic main path
MEMORIZED = 1e-2  # a sample within this times sqrt(D) of a training image
# The paper's experiments (phase 12): high_dim_exp.yaml (dim 100, 5
# components, 50,000 training points; the sweep's 200 temperatures
# 1e-4..1e4, 1000 samples in batches of 500; DDPM-20, 10,000 samples in
# batches of 1000) and scripts/sample_gmm.py (N = 1e6)
HIGH_DIM = {"dim": 100, "n_train": 50_000, "n_temps": 200, "sweep_samples": 1000,
            "sweep_batch": 500, "steps": 20, "n_gen": 10_000, "batch": 1000}
GMM1D_N = 1_000_000
# The config path (phase 17): the default config.yaml (the cifar10 bf16
# flagship, ddpm_training's batch of 128) over a PDMC cache of CONFIG_N
# seeded uint8 32x32x3 images (CIFAR-10's train split has 50,000)
CONFIG_N = 50_000
CONFIG_SEED = 17
CONFIG_STEPS = 5       # train steps on each data path
CONFIG_PARAMS_M = 47.2  # the flagship's parameters, millions
EVAL_STEPS = 100       # make_eval_fn's DDIM steps
CONFIG_FID_SAMPLES = 64  # fid.samples of the eval hook's FID: one batch
# FID and the entry points (phase 18): covariances at Inception's feature
# dimension; InceptionV3 with seeded random weights at batch 500
# (get_compute_fid's batch); a LeNet on seeded MNIST-shaped data; the CLIs
# over CIFAR-10-shaped caches (50,000 train, 10,000 test): the flagship
# trained CLI_TRAIN_STEPS steps, its eval's FID over CLI_FID_SAMPLES
# samples (cut from cifar10's 50,000) and compute_fid over as many
FID_DIM = 2048
FID_SEED = 18
SQRTM_TOL = 1e-5       # card vs the float64 nuclear norm, relative (fp32 traces)
INCEPTION_SEED = 19
INCEPTION_BATCH = 500
INCEPTION_TOL = 1e-4   # fp32 convs, card vs CPU, of the features' scale
LENET_SEED = 20
LENET_N = 21_000
LENET_EPOCHS = 3
CLI_TEST_N = 10_000
CLI_TRAIN_STEPS = 5
CLI_FID_SAMPLES = 128
GATHER_REPS = 50       # host-resident gathers timed for the data path's rate
# Schedule optimization (phase 19). Row 7b, the posterior mean's VJP, at
# the CLI's shape (pdm_tpu_torch/scripts/optimize_schedule.py: B 1024 over
# generate_gmm_1d(100_000), D = K = 1, fp32, its LogSNR range), at CIFAR-10
# scale (the analytic path's B 256 over 50,000 N(0, 1) points, D = K =
# 3072, the sampler's range; every mode) and at edges (K % 4 != 0, one
# query at T = 1e-4, where p is one-hot): (label, B, N, D, log10 T range,
# modes); queries noised from data points, one temperature per row.
VJP_SHAPES = (("gmm1d", 1024, 100_000, 1, (-4.0, 1.0), ("fp32",)),
              ("cifar10", 256, 50_000, 3072, MOMENTS_LOG10_T, SWEEP_MODES),
              ("edges", 37, 1_003, 5, (-4.0, 1.0), SWEEP_MODES))
VJP_SUBSET = 64  # rows held against the plain version, over the T range
VJP_EPI_OPS = 16  # operations per (row, point) of the VJP's epilogue
# row 7b's launches a call on each path at one segment of the dataset
# (ops/boltzmann_kernel.py::plan_vjp): the small-D kernel and the merge;
# the Grams kernel, the product and the merge
VJP_LAUNCHES = {"small": 2, "large": 3}
# Phases 19c and 19d with row 7b's previous design (128-wide tiles at every
# D, the product added into device memory per sub-tile; NVIDIA H100 80GB
# HBM3, 700 W; PERF.md section 5), printed beside this run's: ms an
# iteration, and row 7b's ms a call at the CLI's shape and share of the
# card at CIFAR scale
BEFORE_REDESIGN = {"cli_ms_per_iteration": 37.3, "cli_row7b_ms": 1.3196,
                   "cifar_ms_per_iteration": 110.27, "cifar_row7b_share": 0.564}
# Card vs CPU gradients (phase 19b): the knot gradient of mean(x^2)
# through sample_with_grid on the 1-D GMM (N, knots, batch), at the CPU
# tests' tolerances of scale (tests/test_torch_schedule_opt.py: sample,
# gradient); the fp32 flagship at (batch, knots), remat on, 5e-3 of scale:
# phase 3's 1e-3 per forward (FORWARD_TOL), chained through 5 steps'
# forward and backward.
GMM_GRAD = (2000, 6, 32)
GMM_GRAD_TOL = (5e-4, 5e-3)
UNET_GRAD = (2, 5)
UNET_GRAD_TOL = 5e-3
# JAX's criterion for the CLI's knots (tests/test_schedule_opt.py:51-73):
# samples, seeds, reference points, MMD bandwidth, allowed ratio
CLI_EVAL = (512, 3, 2000, 0.1, 1.2)
# The analytic denoiser at CIFAR-10 scale (19d): N(0, 1) points of shape
# 3 x 32 x 32, knots, batch, DDIM, iterations, on phase 11's scheduler
CIFAR_OPT = (50_000, 10, 256, 3)
# The UNet path (19e), as scripts/optimize_schedule_flagship.py:96-106
# sets it: the bf16 flagship, 5 knots, batch 256, DDPM, remat, rate 0.05,
# sigmas (1, 3, 10, 30), LeNet features; 5 iterations, cut from 200
UNET_OPT = {"n_steps": 5, "batch_size": 256, "step_type": "ddpm",
            "learning_rate": 0.05, "sigmas": (1.0, 3.0, 10.0, 30.0),
            "n_iters": 5, "n_data": 50_000}
# The data axis (phase 20): timed train steps a path and the bound on the
# two-rank part's run
SCALE_OUT_STEPS = 5
SCALE_OUT_PAIRS = 2  # plain, mesh, mesh, plain turns a comparison
SCALE_OUT_TIMEOUT_S = 300


def gram_rounding(two_m: float, d: int, kernel_steps: float) -> float:
    """Bound on the difference of one Gram entry between two correct
    computations (the plain version's and a kernel's).

    Every Gram entry sums d products whose partial sums stay below
    two_m = 2M, M the largest half squared norm of an operand row
    (Cauchy-Schwarz), so each rounding step is at most one ulp(2M): about
    sqrt(d) of them in a sum rounded to nearest (the random walk of the
    plain version's cuBLAS or CPU sums), ``kernel_steps`` in the kernel
    (sqrt(d) for its FFMA chain; one per mma.sync for the tensor cores,
    which truncate the fp32 accumulator once per 16-deep step:
    passes * d / 16)."""
    return (math.sqrt(d) + kernel_steps) * float(np.spacing(np.float32(two_m)))


def sweep_logit_error(xsq_max: float, esq_max: float, ysq_max: float, d: int,
                      temps, kernel_steps: float):
    """(n_temps,) bound on the difference of one logit l_ij(T) between two
    correct computations of the sweep's Grams, from their rounding
    (gram_rounding): C0 enters the logit over T, D0 over sqrt(T)."""
    gram = gram_rounding(2.0 * max(xsq_max, esq_max, ysq_max), d, kernel_steps)
    temps = np.asarray(temps, np.float64)
    return gram / temps + gram / np.sqrt(temps)


def moments_logit_error(xsq_max: float, ysq_max: float, d: int, inv_temp,
                        y_scale, kernel_steps: float):
    """(B,) bound on the difference of one logit l_ij = -h_ij inv_temp_i of
    the single-temperature moments between two correct computations: the
    Gram's (gram_rounding) enters h times s_i = y_scale_i; the half norms
    (summed in another order) and the expansion's own roundings add
    (sqrt(d) + 4) ulp(2M) times 1 + s_i^2; all of it times inv_temp_i."""
    two_m = 2.0 * max(xsq_max, ysq_max)
    gram = gram_rounding(two_m, d, kernel_steps)
    norms = gram_rounding(two_m, d, 4.0)
    s = np.abs(np.asarray(y_scale, np.float64))
    return np.asarray(inv_temp, np.float64) * (s * gram + (1.0 + s * s) * norms)


def per_temp_logit_error(xsq_max: float, esq_max: float, ysq_max: float,
                         d: int, temps):
    """(n_temps,) rounding bound of the per-temperature oracle's own
    logits: its Gram terms are those of xt = x0 + sqrt(T) eps, with
    0.5|xt|^2 <= 2 (0.5|x0|^2 + T 0.5|eps|^2), sqrt(d) ulp of them over T."""
    temps = np.asarray(temps, np.float64)
    two_m = (4.0 * (xsq_max + temps * esq_max) + 2.0 * ysq_max).astype(np.float32)
    return math.sqrt(d) * np.spacing(two_m) / temps


def kernel_gram_steps(mode: str, d: int) -> float:
    """Rounding steps of one Gram entry in the sweep kernel (see above)."""
    return math.sqrt(d) if mode == "fp32" else SWEEP_PASSES[mode] * math.ceil(d / 16)


def sweep_check(got, want, delta, v_max: float = 0.0):
    """(max abs error, worst error / tolerance) of the moments ``got``
    against ``want`` (both (n_temps, rows)), for a logit error of at most
    ``delta`` (n_temps,). To first order in delta: log_z moves by at most
    delta, E[g] by delta (1 + 2 sd), Var[g] by 2 delta (2 sd + var), the
    payload mean by 2 delta max|v|; each also 1e-5 of (1 + its scale) for
    the epilogue's sums over N in another order (~sqrt(N per block) 2^-24)."""
    import torch

    dl = torch.as_tensor(delta, dtype=torch.float32, device=want.log_z.device)[:, None]
    sd = torch.sqrt(want.var)
    pairs = [(got.log_z, want.log_z, dl), (got.e1, want.e1, dl * (1 + 2 * sd)),
             (got.var, want.var, 2 * dl * (2 * sd + want.var))]
    if want.mean is not None:
        pairs.append((got.mean[..., 0], want.mean[..., 0], 2 * dl * v_max))
    err, worst = 0.0, 0.0
    for a, b, tol in pairs:
        diff = (a - b).abs()
        floor = 1e-5 * (1.0 + b.abs().amax(dim=1, keepdim=True))
        err = max(err, float(diff.max()))
        worst = max(worst, float((diff / (tol + floor)).max()))
    return err, worst


def moments_check(got, want, delta, gap=None, v_range: float = 0.0,
                  v_max: float = 0.0, n: int = 1):
    """(max abs error, worst error / tolerance) of single-temperature
    moments ``got`` against ``want`` ((rows,) fields, mean (rows, K)) for a
    per-row logit error of at most ``delta``. log_z, e1 and var as
    sweep_check holds them, each row in the place of a temperature. The
    mean: reweighting by exp(+-delta) moves a convex combination of
    payload rows by at most expm1(2 delta) / 2 of their range
    ``v_range``, and never by more than the range; where the reference's
    top logit leads the next by ``gap`` (rows,), each side's mean is within
    (N - 1) exp(2 delta - (gap - 2 delta)) of the range of the top
    point's, so rows whose two nearest points are closer than the error
    may give either's mean and rows with a clear winner may not. The
    mean's floor, 4 sqrt(N) 2^-24 max|v|, is the fp32 sums over N points
    in another order."""
    import torch

    scal = [None if f is None else f[:, None]
            for f in (got.log_z, got.shift, got.e1_hat, got.e2_hat)]
    ref = [f[:, None] for f in (want.log_z, want.shift, want.e1_hat, want.e2_hat)]
    err, worst = sweep_check(type(want)(*scal, None), type(want)(*ref, None), delta)
    if want.mean is None:
        return err, worst
    d = torch.as_tensor(np.asarray(delta, np.float64), device=want.mean.device)
    share = torch.minimum(torch.expm1(2.0 * d) / 2.0, torch.ones_like(d))
    if gap is not None:
        g = torch.as_tensor(np.asarray(gap, np.float64), device=d.device)
        share = torch.minimum(share, 2.0 * (n - 1) * torch.exp(4.0 * d - g))
    tol = (share * v_range).float()[:, None] + 4.0 * math.sqrt(n) * 2.0 ** -24 * v_max
    diff = (got.mean - want.mean).abs()
    return max(err, float(diff.max())), max(worst, float((diff / tol).max()))


def top_two_gap(x, y, inv_temp, y_scale, chunk: int = 1 << 15):
    """(rows,) lead of each row's largest plain fp32 logit over its second
    (the single-temperature moments' logits, cuBLAS without TF32)."""
    import torch

    from pdm_tpu_torch.ops.precision import matmul_fp32

    xf = x.reshape(x.shape[0], -1).float()
    yf = y.reshape(y.shape[0], -1).float()
    xsq = 0.5 * (xf * xf).sum(1, keepdim=True)
    s = torch.as_tensor(y_scale, dtype=torch.float32, device=xf.device).reshape(-1, 1)
    it = torch.as_tensor(inv_temp, dtype=torch.float32, device=xf.device).reshape(-1, 1)
    best = torch.full((xf.shape[0], 2), float("-inf"), device=xf.device)
    for lo in range(0, yf.shape[0], chunk):
        yc = yf[lo:lo + chunk]
        lg = -((xsq - s * matmul_fp32(xf, yc.T)) + s * s * 0.5 * (yc * yc).sum(1)) * it
        k = min(2, lg.shape[1])
        best = torch.topk(torch.cat([best, torch.topk(lg, k, dim=1).values], 1),
                          2, dim=1).values
    return (best[:, 0] - best[:, 1]).cpu().numpy()


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def make_timer(cycles_per_ms: float):
    """A function timing `fn` on the card: (device ms, host ms) per call,
    medians over `reps` runs of `inner` back-to-back calls.

    The device time comes from CUDA events around the calls. A sleep kernel
    queued just before them holds the stream while the host enqueues the
    calls, so the host's own cost per call (returned beside it) does not
    show in the device time; a run whose enqueue outlasted the sleep is
    repeated with a longer sleep. L2 stays warm between calls."""
    import torch

    def time_ms(fn, reps: int = 10, inner: int = 20):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        sleep_ms, dev, host, tries = 10.0, [], [], 0
        while len(dev) < reps:
            tries += 1
            if tries > reps + 3:
                fail("timing: the enqueue keeps outlasting the sleep kernel "
                     "(a host sync inside the timed call?)")
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(int(sleep_ms * cycles_per_ms))
            a.record()
            t0 = time.perf_counter()
            for _ in range(inner):
                fn()
            enqueue_ms = (time.perf_counter() - t0) * 1e3
            b.record()
            torch.cuda.synchronize()
            if enqueue_ms > 0.8 * sleep_ms:
                sleep_ms = 2.0 * enqueue_ms
                continue
            dev.append(a.elapsed_time(b) / inner)
            host.append(enqueue_ms / inner)
        return statistics.median(dev), statistics.median(host)

    return time_ms


def sleep_rate() -> float:
    """Cycles of torch.cuda._sleep per millisecond on this card."""
    import torch

    cycles = 20_000_000
    torch.cuda._sleep(cycles // 10)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(cycles)
    b.record()
    torch.cuda.synchronize()
    return cycles / a.elapsed_time(b)


def bound(n_bytes: float, n_ops: float, dtype: str):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(got, want, dtype: str):
    rtol, atol = TOL[dtype]
    diff = (got.float() - want.float()).abs()
    ok = bool((diff <= atol + rtol * want.float().abs()).all())
    return float(diff.max()), ok, rtol, atol


def compare_fraction(got, want, dtype: str) -> float:
    """The largest |got - want| as a fraction of compare()'s bound."""
    rtol, atol = TOL[dtype]
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def compare_to_scale(got, want, rtol: float, atol_of_scale: float):
    """(max abs error, ok) for |got - want| <= rtol |want| + atol_of_scale
    * max |want|."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    bound_t = rtol * want.abs() + atol_of_scale * float(want.abs().max())
    return float(diff.max()), bool((diff <= bound_t).all())


def compare_to_typical(got, want, rtol: float, atol_of_median: float):
    """(max abs error, ok, atol) for |got - want| <= rtol |want| + atol
    with atol = atol_of_median * median |want|: each element is held to
    its own size, and the floor is a typical element's, not the largest
    one's."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    atol = atol_of_median * float(want.abs().median())
    return float(diff.max()), bool((diff <= rtol * want.abs() + atol).all()), atol


def tol_fraction(got, want, rtol: float, atol_of_scale: float) -> float:
    """The largest |got - want| as a fraction of compare_to_scale's
    bound (1.0 is the tolerance's edge)."""
    got, want = got.float(), want.float()
    bound_t = rtol * want.abs() + atol_of_scale * float(want.abs().max())
    return float(((got - want).abs() / bound_t.clamp_min(1e-30)).max())


def adam_first_step_bound(g_a, g_b, lr: float, eps: float = 1e-8):
    """The most two first Adam steps (update lr * g / (|g| + eps), weight
    decay 0) can differ by, elementwise, for gradients g_a and g_b: near
    g = 0 a gradient that changes sign moves the update by up to 2 lr."""
    import torch

    diff = (g_a - g_b).abs()
    return lr * torch.clamp(
        2 * diff / (torch.maximum(g_a.abs(), g_b.abs()) + eps), max=2.0)


def train_step_with_grads(trainer, state, x0, **kwargs):
    """``trainer.train_step``, returning also the fp32 gradients that step
    applied (before clipping) as CPU copies keyed by parameter name.
    Checks of the step's parameters use these, not the gradients of
    another backward pass: Adam's first step moves an element by up to
    2 lr when its gradient changes by a rounding step."""
    grads_of = trainer._grads
    names = [k for k, _ in trainer.ddpm.module.named_parameters()]
    seen = {}

    def record(*args):
        loss, grads = grads_of(*args)
        seen.update({k: g.to("cpu", copy=True) for k, g in zip(names, grads)})
        return loss, grads

    trainer._grads = record
    try:
        state, metrics = trainer.train_step(state, x0, **kwargs)
    finally:
        del trainer._grads
    return state, metrics, seen


def seeded_state_dict(net, seed: int = 0, std: float = 0.02):
    """Random weights from a seed, every parameter N(0, std^2), in state
    dict order (as bench.py fills the JAX flagship)."""
    import torch

    rng = np.random.RandomState(seed)
    return {k: torch.from_numpy(
                (rng.standard_normal(tuple(v.shape)) * std).astype(np.float32))
            for k, v in net.state_dict().items()}


def profile_steps(run, n_steps: int, label: str = "profile") -> float:
    """Print the card's kernel time per main-path step, by kernel and by
    kind, from a torch.profiler trace of `run` (n_steps steps); returns
    the card's busy ms per step under the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_kernel = {}
    for e in prof.events():
        # kernels only: a GPU-side user annotation (Optimizer.step's range)
        # spans kernels already counted
        if (e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            ms, n = per_kernel.get(e.name, (0.0, 0))
            per_kernel[e.name] = (ms + e.device_time_total / 1e3, n + 1)
    kinds = (("whole-block kernel", ("attention_block_fwd",)),
             ("whole-block backward kernels", ("attention_block_bwd",
                                               "attention_block_wgrad")),
             ("attention kernel", ("attention_fwd",)),
             ("attention backward kernels", ("attention_bwd",)),
             ("GroupNorm kernel", ("group_norm_fwd",)),
             ("GroupNorm backward kernel", ("group_norm_bwd",)),
             ("convolution", ("conv", "fprop", "dgrad", "wgrad", "nhwc",
                              "nchw")),
             ("matmul", ("gemm", "cutlass", "cublas", "nvjet")),
             ("optimizer (foreach)", ("foreach", "multi_tensor")))
    by_kind = {name: [0.0, 0] for name, _ in kinds}
    by_kind["other"] = [0.0, 0]
    for kname, (ms, n) in per_kernel.items():
        kind = next((name for name, keys in kinds
                     if any(key in kname.lower() for key in keys)), "other")
        by_kind[kind][0] += ms
        by_kind[kind][1] += n
    busy = sum(ms for ms, _ in per_kernel.values())
    log(f"{label}: {n_steps} steps, {wall_ms / n_steps:.3f} ms/step wall "
        f"under the profiler, card busy {busy / n_steps:.3f} ms/step "
        f"({busy / wall_ms:.1%}), "
        f"{sum(n for _, n in per_kernel.values()) / n_steps:g} launches/step")
    for kind, (ms, n) in sorted(by_kind.items(), key=lambda kv: -kv[1][0]):
        log(f"{label}: {kind}: {ms / n_steps:.4f} ms/step, {n / n_steps:g} "
            f"launches/step")
    # the 15 largest kernels, then every other attention kernel (rows 1, 2,
    # 5 and 6 by name: their split is read against their bounds)
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])
    top = ranked[:15] + [kv for kv in ranked[15:] if "attention_" in kv[0]]
    for kname, (ms, n) in top:
        log(f"{label} kernel: {ms / n_steps:.4f} ms/step x{n / n_steps:g} "
            f"{kname[:110]}")
    return busy / n_steps


def sweep_kernel_rows(time_ms, dev):
    """Phase 8: the sweep kernel against its plain version at every shape
    and mode, with and without an (N, 1) payload, on the first
    SWEEP_SUBSET rows; times of the kernel, the plain version and the two
    Grams through cuBLAS. Returns the rows and the main shape's dataset."""
    import torch

    from pdm_tpu_torch.ops import boltzmann_sweep as sw
    from pdm_tpu_torch.ops.precision import full_fp32_matmul, split

    g = torch.Generator(device=dev).manual_seed(3)
    rows, main_data = [], None
    for label, B, N, D, nt, (t_lo, t_hi) in (SWEEP_MAIN, *SWEEP_EDGES):
        y = torch.randn(N, D, generator=g, device=dev)
        x0 = y[:B].clone()  # starts are dataset points, as in thermo_sweep
        eps = torch.randn(B, D, generator=g, device=dev)
        temps = torch.logspace(t_lo, t_hi, nt, device=dev)
        vals = torch.rand(N, 1, generator=g, device=dev) + 0.1
        k = min(B, SWEEP_SUBSET)
        sq = [float((0.5 * (t * t).sum(1)).max()) for t in (x0, eps, y)]
        for mode in SWEEP_MODES:
            prep = sw.prepare_y(y, mode)
            delta = sweep_logit_error(*sq, D, temps.cpu().numpy(),
                                      kernel_gram_steps(mode, D))
            for with_v in (False, True):
                v = vals if with_v else None
                before = sw.boltzmann_sweep.launches
                got = sw.boltzmann_sweep(x0, eps, prep, temps, values=v,
                                         mxu_precision=mode)
                torch.cuda.synchronize()
                launched = sw.boltzmann_sweep.launches - before
                again = sw.boltzmann_sweep(x0, eps, prep, temps, values=v,
                                           mxu_precision=mode)
                same = all(torch.equal(a, b) for a, b in zip(got, again) if a is not None)
                plan = sw.plan_sweep(mode, B, prep.yt_hi.shape[1], sw._resident_blocks(
                    "sweep", dev.index or 0, sw.MODE_CODES[mode], int(with_v)))
                want = sw.boltzmann_sweep_reference(
                    x0[:k], eps[:k], prep, temps, values=v, mxu_precision=mode)
                sub = sw.BoltzmannMoments(*(None if f is None else f[:, :k]
                                            for f in got))
                err, worst = sweep_check(sub, want, delta, v_max=float(vals.max()))
                finite = all(bool(torch.isfinite(f).all()) for f in got if f is not None)
                row = {"label": label, "shape": [B, N, D, nt], "log10_temps":
                       [t_lo, t_hi], "mode": mode, "values": with_v,
                       "launches": launched, "max_abs_err": err,
                       "worst_of_tolerance": worst, "bitwise_repeat": same,
                       "plan": plan._asdict(),
                       "logit_tol_min_max": [float(delta.min()), float(delta.max())]}
                ok = launched == 2 and finite and worst <= 1.0 and same
                if not with_v:
                    ms, host_ms = time_ms(lambda: sw.boltzmann_sweep(
                        x0, eps, prep, temps, mxu_precision=mode), reps=3, inner=1)
                    plain_ms = event_ms(lambda: sw.boltzmann_sweep_reference(
                        x0, eps, prep, temps, mxu_precision=mode), reps=1)[0]
                    lib = library_grams(x0, eps, y, mode, split, full_fp32_matmul)
                    library_ms = time_ms(lib, reps=3, inner=1)[0]
                    passes = SWEEP_PASSES[mode]
                    esz = 4 if mode == "fp32" else 2
                    n_bytes = (2 * B * D * 4 + D * N * esz * (2 if passes == 3 else 1)
                               + N * 4 + nt * 4 + 4 * nt * B * 4)
                    t_ops = (4 * B * N * D * passes
                             / PEAK_OPS_PER_S["float32" if mode == "fp32" else "bfloat16"]
                             + SWEEP_EPI_OPS * B * N * nt / PEAK_OPS_PER_S["float32"]) * 1e3
                    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
                    row.update(ms=ms, host_ms=host_ms, plain_ms=plain_ms,
                               library_ms=library_ms,
                               bound_ms=max(t_ops, t_bytes),
                               bound_by="operations" if t_ops >= t_bytes else "bytes",
                               gram_tflops=4 * B * N * D * passes / ms / 1e9,
                               pairs_per_s=B * N * nt / ms * 1e3)
                rows.append(row)
                log(f"sweep {label} B={B} N={N} D={D} temps={nt} {mode}"
                    f"{' +payload' if with_v else ''}: {plan.tile_rows}-row blocks, "
                    f"{plan.n_chunks} chunks; launches {launched}, bitwise repeat {same}, "
                    f"max_abs_err {err:.3g} (worst {worst:.3g} of the tolerance; "
                    f"logit tol {row['logit_tol_min_max'][0]:.3g}-"
                    f"{row['logit_tol_min_max'][1]:.3g})"
                    + ("" if with_v else
                       f" kernel_ms {row['ms']:.4f} (host {row['host_ms']:.4f}) "
                       f"plain_ms {row['plain_ms']:.4f} library_ms (Grams only) "
                       f"{row['library_ms']:.4f} bound_ms {row['bound_ms']:.4f} "
                       f"({row['bound_by']}) {row['gram_tflops']:.2f} Gram TFLOP/s")
                    + f" {'ok' if ok else 'MISMATCH'}")
                if not ok:
                    fail(f"sweep kernel disagrees with its plain version (or "
                         f"launched {launched} kernels, or two calls differ) at "
                         f"{label} {mode} payload={with_v}")
            del prep
            torch.cuda.empty_cache()
        if label == SWEEP_MAIN[0]:
            # the independent oracle: one plain moments pass per temperature
            kp = 8
            got = sw.boltzmann_sweep(x0[:kp], eps[:kp], y, temps, mxu_precision="fp32")
            want = sw.boltzmann_sweep_per_temp(x0[:kp], eps[:kp], y, temps)
            tnp = temps.cpu().numpy()
            delta = (sweep_logit_error(*sq, D, tnp, kernel_gram_steps("fp32", D))
                     + per_temp_logit_error(*sq, D, tnp))
            err, worst = sweep_check(got, want, delta)
            log(f"sweep {label} fp32 vs one moments pass per temperature at "
                f"xt = x0 + sqrt(T) eps ({kp} rows): max_abs_err {err:.3g} "
                f"(worst {worst:.3g} of the tolerance) "
                f"{'ok' if worst <= 1.0 else 'MISMATCH'}")
            if worst > 1.0:
                fail("sweep kernel disagrees with the per-temperature oracle")
            main_data = y
        del x0, eps, vals
        torch.cuda.empty_cache()
    return rows, main_data


def library_gram(a, y, mode, split, full_fp32_matmul):
    """One Gram a . y^T through cuBLAS in the mode's arithmetic (fp32
    without TF32; bf16 hi*hi; the three bf16 passes of bf16_3x)."""
    import torch

    if mode == "fp32":
        def run():
            with full_fp32_matmul():
                return torch.matmul(a, y.T)
        return run
    (a_hi, a_lo), (y_hi, y_lo) = split(a, mode), split(y, mode)

    def run():
        out = torch.matmul(a_hi, y_hi.T)
        if a_lo is not None:
            return out, torch.matmul(a_hi, y_lo.T), torch.matmul(a_lo, y_hi.T)
        return out
    return run


def library_grams(x0, eps, y, mode, split, full_fp32_matmul):
    """The sweep's two Grams alone through cuBLAS (library_gram)."""
    gx = library_gram(x0, y, mode, split, full_fp32_matmul)
    ge = library_gram(eps, y, mode, split, full_fp32_matmul)
    return lambda: (gx(), ge())


def event_ms(fn, reps: int = 3):
    """(card ms between CUDA events, host ms) of `fn` after a warm call,
    each call ending in a synchronize, the host's enqueue included (for
    calls that enqueue more launches than a sleep kernel can hide);
    medians over `reps`."""
    import torch

    fn()
    torch.cuda.synchronize()
    card, host = [], []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        card.append(a.elapsed_time(b))
    return statistics.median(card), statistics.median(host)


def sweep_stages(data, temps, gen, dev) -> None:
    """Where one thermo_sweep's time goes: each stage of its main path
    timed alone with CUDA events (a profiler trace drops the first
    kernels after it starts, which here are the dataset pack's)."""
    import torch

    from pdm_tpu_torch.ops import boltzmann_sweep as sw
    from pdm_tpu_torch.stats.sweep import thermo_sweep

    n, d = data.shape
    B = SWEEP_MAIN[1]
    tt = torch.as_tensor(temps, dtype=torch.float32, device=dev)
    prep = sw.prepare_y(data, "fp32")
    idx = torch.randint(0, n, (B,), generator=gen, device=dev)
    eps = torch.randn((B, d), generator=gen, device=dev)
    x0 = data[idx]
    mom = sw.boltzmann_sweep(x0, eps, prep, tt)
    stages = {
        "prepare_y (pad, transpose, half norms)": lambda: sw.prepare_y(data, "fp32"),
        "draws (indices, noise)": lambda: (
            torch.randint(0, n, (B,), generator=gen, device=dev),
            torch.randn((B, d), generator=gen, device=dev)),
        "gather of the starts": lambda: data[idx],
        "boltzmann_sweep (kernels and wrapper)": lambda: sw.boltzmann_sweep(
            x0, eps, prep, tt),
        "curves to the host": lambda: (
            mom.entropy(n).mean(dim=1).cpu().numpy(),
            (-tt[:, None] * mom.log_z).mean(dim=1).cpu().numpy(),
            mom.var.cpu().numpy()),
        "dataset trace of covariance": lambda: float(
            torch.var(data, dim=0, unbiased=True).sum()),
        "thermo_sweep, whole": lambda: thermo_sweep(
            data, temps, B, B, generator=gen, regularize=True, device=dev),
    }
    for name, fn in stages.items():
        card, host = event_ms(fn)
        log(f"stats stage: {name}: {card:.4f} ms card (CUDA events), "
            f"{host:.4f} ms host")


def stats_main_path(data, ddpm, dev) -> int:
    """Phase 9: thermo_sweep on the card at the main shape (the launch
    counter zeroed just before, read just after), bench.py's sweep rate,
    the streamed tier on the same draws, metric_stats with adaptive k-NN,
    then both knot schedules from the sweep and a 10-step DDIM sample of
    the bf16 flagship on each. Returns the main path's sweep launches."""
    import torch

    from pdm_tpu_torch.diffusion.sampling import DDPMSampler
    from pdm_tpu_torch.ops import boltzmann_sweep as sw
    from pdm_tpu_torch.schedulers.interpolated import (
        entropy_scheduler, metric_scheduler,
    )
    from pdm_tpu_torch.stats.sweep import metric_stats, thermo_sweep

    label, B, N, D, nt, (t_lo, t_hi) = SWEEP_MAIN
    n_samples = B  # forward_stats.yaml: n_samples 1024, batch_size 1024
    temps = np.logspace(t_lo, t_hi, nt)
    gen = torch.Generator(device=dev).manual_seed(0)
    sw.boltzmann_sweep.launches = 0
    t0 = time.perf_counter()
    out = thermo_sweep(data, temps, n_samples, B, generator=gen,
                       regularize=True, device=dev)
    wall = time.perf_counter() - t0
    launches = sw.boltzmann_sweep.launches
    finite = all(np.isfinite(v).all() for v in out.values())
    log(f"stats main path: thermo_sweep fp32 {label} B={B} N={N} D={D} "
        f"temps={nt} regularize (global floor): {wall:.4f} s per sweep, "
        f"{4 * B * N * D / wall / 1e12:.3f} Gram TFLOP/s, "
        f"{B * N * nt / wall:.4g} pairs/s; launches {launches}; entropy "
        f"{out['entropy'][0]:.4g} .. {out['entropy'][-1]:.4g}, metric "
        f"{out['metric'].min():.4g} .. {out['metric'].max():.4g}, "
        f"tr_sigma0 {float(out['dataset_tr_sigma0']):.6g}; finite {finite}")
    if launches != 2 * math.ceil(n_samples / B) or not finite:
        fail(f"thermo_sweep: {launches} sweep launches (want 2 per batch) or "
             f"outputs not finite")
    sweep_stages(data, temps, gen, dev)
    # the card's idle share of a warm sweep: its wall time against the
    # kernels' sum in a profiler trace of two more (the first kernels after
    # the trace starts can be dropped, so the share is an upper bound)
    t0 = time.perf_counter()
    thermo_sweep(data, temps, n_samples, B, generator=gen, regularize=True, device=dev)
    warm_ms = (time.perf_counter() - t0) * 1e3
    busy = profile_steps(lambda: [thermo_sweep(data, temps, n_samples, B, generator=gen,
                                               regularize=True, device=dev)
                                  for _ in range(2)], 2, "stats profile")
    log(f"stats main path: a warm thermo_sweep takes {warm_ms:.4f} ms, the card busy "
        f"{busy:.4f} ms of it (profiler kernel sum): idle {max(0.0, 1.0 - busy / warm_ms):.1%}")

    # bench.py's sweep rate: prepared dataset, 4 sweeps of 96 temperatures
    bB, bnt, (b_lo, b_hi), reps = BENCH_SWEEP
    x = torch.randn(bB, D, generator=gen, device=dev)
    eps = torch.randn(bB, D, generator=gen, device=dev)
    btemps = torch.logspace(b_lo, b_hi, bnt, device=dev)
    prep = sw.prepare_y(data, "fp32")
    sw.boltzmann_sweep(x, eps, prep, btemps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        mom = sw.boltzmann_sweep(x, eps, prep, btemps)
    torch.cuda.synchronize()
    bench_s = time.perf_counter() - t0
    log(f"stats: sweep_pairs_per_sec (bench.py's definition: {reps} sweeps of "
        f"{bnt} temperatures, B={bB}, N={N}, D={D}, fp32) "
        f"{reps * bnt * bB * N / bench_s:.6g}; {bench_s / reps * 1e3:.3f} ms "
        f"per sweep; finite {bool(torch.isfinite(mom.log_z).all())}")
    del prep, x, eps, mom

    # the streamed tier on the device-resident sweep's draws
    n_s, chunk = STREAM
    draws = [(torch.randint(0, N, (n_s,), generator=gen, device=dev),
              torch.randn(n_s, D, generator=gen, device=dev))]
    resident = thermo_sweep(data, temps, n_s, n_s, draws=draws, device=dev)
    t0 = time.perf_counter()
    streamed = thermo_sweep(data.cpu().numpy(), temps, n_s, n_s, draws=draws,
                            stream_chunk=chunk, device=dev)
    stream_s = time.perf_counter() - t0
    eps_n = STREAM_EPS * math.sqrt(N)
    per_field = {k: float(np.max(np.abs(streamed[k] - resident[k]) / (
        eps_n * (np.abs(resident[k]) + 1.0 + math.log(N)))))
        for k in ("entropy", "free_energy", "heat_capacity", "metric")}
    worst = max(per_field.values())
    log(f"stats: streamed tier (stream_chunk {chunk}, n_samples {n_s}) vs the "
        f"device-resident sweep on the same draws: worst of the tolerance "
        f"{ {k: float(f'{v:.3g}') for k, v in per_field.items()} } (tolerance "
        f"{eps_n:.3g} (|value| + 1 + log N)); {stream_s:.3f} s "
        f"{'ok' if worst <= 1.0 else 'MISMATCH'}")
    if worst > 1.0:
        fail("streamed sweep disagrees with the device-resident sweep")

    t0 = time.perf_counter()
    knn_out = metric_stats(data, temps, B, B, generator=gen, regularize=True,
                           adaptive_knn=True, device=dev)
    knn_s = time.perf_counter() - t0
    ok = bool(np.isfinite(knn_out["metric"]).all() and (knn_out["metric"] > 0).all())
    log(f"stats: metric_stats adaptive k-NN (k=5) N={N}: {knn_s:.3f} s, metric "
        f"{knn_out['metric'].min():.4g} .. {knn_out['metric'].max():.4g} "
        f"{'ok' if ok else 'NOT FINITE'}")
    if not ok:
        fail("metric_stats with adaptive k-NN: metric not finite and positive")

    # the knot schedules from the main sweep, on the card and on the CPU
    kinds = {
        "entropy": lambda d: entropy_scheduler(
            out["temp"], out["entropy"], extrapolate=True, min_temp=10 ** t_lo,
            max_temp=10 ** t_hi, device=d),
        "metric": lambda d: metric_scheduler(out["log_temp"], out["metric"],
                                             device=d),
    }
    tau_cpu = torch.linspace(0.0, 1.0, 101)
    for name, make in kinds.items():
        card_s, cpu_s = make(dev), make("cpu")
        lt_card = card_s.log_temp_from_tau(tau_cpu.to(dev))
        back_card = card_s.tau_from_log_temp(lt_card).cpu()
        lt_cpu = cpu_s.log_temp_from_tau(tau_cpu)
        back_cpu = cpu_s.tau_from_log_temp(lt_cpu)
        rt = max(float((back_card - tau_cpu).abs().max()),
                 float((back_cpu - tau_cpu).abs().max()))
        same = float((lt_card.cpu() - lt_cpu).abs().max())
        sampler = DDPMSampler(ddpm=ddpm, scheduler=card_s, n_steps=10,
                              obj_size=(3, 32, 32), batch_size=BATCH,
                              n_samples=BATCH, step_type="ddim",
                              precision="half", device=dev)
        t0 = time.perf_counter()
        xs = sampler.batch_sample(gen)["x"]
        torch.cuda.synchronize()
        sample_s = time.perf_counter() - t0
        ok = (rt <= ROUNDTRIP_TOL and same <= ROUNDTRIP_TOL
              and tuple(xs.shape) == (BATCH, 3, 32, 32)
              and bool(torch.isfinite(xs).all()))
        log(f"stats: {name} schedule ({card_s.timestamps.numel()} knots): tau -> "
            f"log_temp -> tau worst {rt:.3g}, card vs CPU log_temp {same:.3g} "
            f"(tol {ROUNDTRIP_TOL}); 10-step DDIM sample of the bf16 flagship, "
            f"batch {BATCH}: {sample_s:.3f} s, mean {float(xs.mean()):.4g} std "
            f"{float(xs.std()):.4g} {'ok' if ok else 'FAILED'}")
        if not ok:
            fail(f"{name} schedule: round trip or sample failed")
    return launches


def moments_case(dev, g, B, N, D, K):
    """Row 7's inputs: a dataset, queries xt = sqrt(ab) y_j + sqrt(1 - ab)
    eps with one temperature per row over MOMENTS_LOG10_T (the sampler's
    range), the denoiser's inv_temp = 1 / (1 - ab) and y_scale =
    sqrt(ab), and a payload: the data itself (K = D), the MC metric's
    [y, y^2] (K = 2D) or N(0, 1)."""
    import torch

    y = torch.randn(N, D, generator=g, device=dev)
    temps = torch.logspace(*MOMENTS_LOG10_T, B, device=dev)
    ab = 1.0 / (1.0 + temps)
    idx = torch.randint(0, N, (B,), generator=g, device=dev)
    x = (torch.sqrt(ab)[:, None] * y[idx]
         + torch.sqrt(1.0 - ab)[:, None] * torch.randn(B, D, generator=g, device=dev))
    if K == D:
        v = y
    elif K == 2 * D:
        v = torch.cat([y, y * y], dim=1)
    else:
        v = torch.randn(N, K, generator=g, device=dev)
    return x, y, 1.0 / (1.0 - ab), torch.sqrt(ab), v


def moments_bound(B, N, D, K, mode):
    """(bound ms, bound_by) of one moments call: the Gram's passes at the
    mode's peak, the fp32 payload product and epilogue at fp32's; each
    input read once (queries, the pack, norms, per-row terms, payload),
    each output written once."""
    passes = SWEEP_PASSES[mode]
    esz = 4 if mode == "fp32" else 2
    n_bytes = (B * D * 4 + D * N * esz * (2 if passes == 3 else 1) + N * 4
               + 2 * B * 4 + 4 * B * 4 + (N * K * 4 + B * K * 4 if K else 0))
    t_ops = (2 * B * N * D * passes
             / PEAK_OPS_PER_S["float32" if mode == "fp32" else "bfloat16"]
             + (2 * B * N * K + MOMENTS_EPI_OPS * B * N) / PEAK_OPS_PER_S["float32"]) * 1e3
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def moments_kernel_rows(time_ms, dev):
    """Phase 10: the moments kernel (row 7) against its plain version on
    the same card inputs at every shape and mode, with the payload (and at
    the main shape without), on MOMENTS_SUBSET rows over the temperature
    range; times of the kernel, the plain version and the products alone
    through cuBLAS (the Gram in the mode's arithmetic, the fp32 p . V)."""
    import torch

    from pdm_tpu_torch.ops import boltzmann as bz
    from pdm_tpu_torch.ops import boltzmann_kernel as bk
    from pdm_tpu_torch.ops import boltzmann_sweep as sw
    from pdm_tpu_torch.ops.precision import full_fp32_matmul, split

    g = torch.Generator(device=dev).manual_seed(4)
    rows = []
    for label, B, N, D, K in (MOMENTS_MAIN, *MOMENTS_EDGES):
        x, y, it, s, v = moments_case(dev, g, B, N, D, K)
        sub = torch.linspace(0, B - 1, min(B, MOMENTS_SUBSET), device=dev).round().long().unique()
        gap = top_two_gap(x[sub], y, it[sub], s[sub])
        sq = [float((0.5 * (t * t).sum(1)).max()) for t in (x, y)]
        v_range, v_max = float(v.max() - v.min()), float(v.abs().max())
        p_lib = torch.rand(B, N, generator=g, device=dev)  # any weights: products only
        for mode in SWEEP_MODES:
            prep = sw.prepare_y(y, mode)
            delta = moments_logit_error(*sq, D, it[sub].cpu().numpy(), s[sub].cpu().numpy(),
                                        kernel_gram_steps(mode, D))
            gram_lib = library_gram(x, y, mode, split, full_fp32_matmul)
            for with_v in ((False, True) if label == MOMENTS_MAIN[0] else (True,)):
                vals = v if with_v else None

                def kernel(vals=vals, prep=prep, mode=mode):
                    return bz.boltzmann_moments(x, prep, it, s, values=vals,
                                                mxu_precision=mode)

                def library(vals=vals, gram_lib=gram_lib):
                    out = gram_lib()
                    if vals is not None:
                        with full_fp32_matmul():
                            out = out, torch.matmul(p_lib, vals)
                    return out

                before = bz.boltzmann_moments.launches
                got = kernel()
                torch.cuda.synchronize()
                launched = bz.boltzmann_moments.launches - before
                same = all(torch.equal(a, b) for a, b in zip(got, kernel()) if a is not None)
                plan = bk.device_plan(bk.operands(x, prep, it, s, values=vals, mode=mode))
                want = bz.boltzmann_moments_reference(x[sub], y, it[sub], s[sub], values=vals,
                                                      mxu_precision=mode)
                got_sub = bz.BoltzmannMoments(*(None if f is None else f[sub] for f in got))
                err, worst = moments_check(got_sub, want, delta, gap, v_range, v_max, N)
                finite = all(bool(torch.isfinite(f).all()) for f in got if f is not None)
                ms, host_ms = time_ms(kernel, reps=3, inner=1)
                plain_ms = event_ms(lambda: bz.boltzmann_moments_reference(
                    x, y, it, s, values=vals, mxu_precision=mode), reps=1)[0]
                library_ms = time_ms(library, reps=3, inner=1)[0]
                b_ms, b_by = moments_bound(B, N, D, K if with_v else 0, mode)
                row = {"label": label, "shape": [B, N, D, K if with_v else 0],
                       "mode": mode, "values": with_v, "launches": launched,
                       "max_abs_err": err, "worst_of_tolerance": worst,
                       "bitwise_repeat": same, "plan": plan._asdict(),
                       "logit_tol_min_max": [float(delta.min()), float(delta.max())],
                       "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
                       "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
                       "tflops": 2 * B * N * (D * SWEEP_PASSES[mode] + (K if with_v else 0))
                       / ms / 1e9}
                rows.append(row)
                ok = launched == 2 and finite and worst <= 1.0 and same
                log(f"moments {label} B={B} N={N} D={D} K={row['shape'][3]} {mode}: "
                    f"{plan.kernel} kernel ({plan.tile_rows}-row blocks, clusters of "
                    f"{plan.cluster}, {plan.n_chunks} chunks); launches {launched}, bitwise "
                    f"repeat {same}, max_abs_err {err:.3g} (worst {worst:.3g} of the "
                    f"tolerance; logit tol {row['logit_tol_min_max'][0]:.3g}-"
                    f"{row['logit_tol_min_max'][1]:.3g}) kernel_ms {ms:.4f} (host "
                    f"{host_ms:.4f}) plain_ms {plain_ms:.4f} library_ms (products only) "
                    f"{library_ms:.4f} bound_ms {b_ms:.4f} ({b_by}) {row['tflops']:.2f} "
                    f"TFLOP/s {'ok' if ok else 'MISMATCH'}")
                if not ok:
                    fail(f"moments kernel disagrees with its plain version (or launched "
                         f"{launched} kernels, or two calls differ) at {label} {mode} "
                         f"payload={with_v}")
            del prep, gram_lib
            torch.cuda.empty_cache()
        del x, y, v, p_lib
        torch.cuda.empty_cache()
    return rows


def nearest_distance(x, data, chunk: int = 1 << 14):
    """(B,) distance of each row of x to its nearest row of data: the
    argmin from fp32 Grams (TF32 off), the distance recomputed directly."""
    import torch

    from pdm_tpu_torch.ops.precision import matmul_fp32

    xf = x.reshape(x.shape[0], -1).float()
    df = data.reshape(data.shape[0], -1).float()
    best = torch.full((xf.shape[0],), float("inf"), device=xf.device)
    arg = torch.zeros((xf.shape[0],), dtype=torch.long, device=xf.device)
    for lo in range(0, df.shape[0], chunk):
        dc = df[lo:lo + chunk]
        d2 = (dc * dc).sum(1)[None, :] - 2.0 * matmul_fp32(xf, dc.T)
        val, idx = d2.min(dim=1)
        better = val < best
        best = torch.where(better, val, best)
        arg = torch.where(better, idx + lo, arg)
    return (xf - df[arg]).norm(dim=1)


def true_step_errors(ddpm, sampler, x_init, states):
    """Every step's x0 (the moments' mean) of a TrueDDPM DDIM sample with
    track_states against the plain version on the same xt, the inputs the
    sampler gave the model, within what the Grams' rounding allows
    (moments_logit_error, moments_check). Returns (max_abs_err, the worst
    error as a fraction of its tolerance, each step's (xt, log_temp,
    inv_temp, y_scale))."""
    import torch

    from pdm_tpu_torch.diffusion.sampling import _step_tables
    from pdm_tpu_torch.ops import boltzmann as bz

    sched, data = ddpm.scheduler, ddpm.train_data
    B, N, D = x_init.shape[0], data.shape[0], data[0].numel()
    n_steps = sampler.n_steps
    lt_steps = _step_tables(sampler._grid())["log_temp"]
    flat = data.reshape(N, -1)
    v_range, v_max = float(flat.max() - flat.min()), float(flat.abs().max())
    worst_all, err_all, step_inputs = 0.0, 0.0, []
    with torch.inference_mode():
        for i in range(n_steps):
            xt = x_init if i == 0 else states[n_steps - i]
            tau = torch.clamp(sched.tau_from_log_temp(lt_steps[i]), 0.0, 1.0)
            lt = torch.broadcast_to(sched.log_temp_from_tau(tau), (B,))
            it, s = 1.0 / torch.sigmoid(lt), torch.sqrt(torch.sigmoid(-lt))
            got = bz.boltzmann_moments(xt, ddpm.pack(), it, s, values=data)
            want = bz.boltzmann_moments_reference(xt, data, it, s, compute_mean=True)
            sq = [float((0.5 * (t * t).reshape(t.shape[0], -1).sum(1)).max()) for t in (xt, data)]
            delta = moments_logit_error(*sq, D, it.cpu().numpy(), s.cpu().numpy(),
                                        kernel_gram_steps("fp32", D))
            err, worst = moments_check(got, want, delta, top_two_gap(xt, data, it, s),
                                       v_range, v_max, N)
            worst_all, err_all = max(worst_all, worst), max(err_all, err)
            step_inputs.append((xt, lt_steps[i], it, s))
    return err_all, worst_all, step_inputs


def legacy_attention_names(state_dict):
    """A state dict under the attention leaf names that diffusers
    checkpoints older than its Attention refactor store."""
    out = {}
    for k, v in state_dict.items():
        for new, old in ((".to_q.", ".query."), (".to_k.", ".key."),
                         (".to_v.", ".value."), (".to_out.0.", ".proj_attn.")):
            k = k.replace(new, old)
        out[k] = v
    return out


def config_path(dev, weights, smi: str) -> dict:
    """Phase 17: the flagship's config path, as scripts/train_diffusion.py
    and make_eval_fn drive it, in a temporary working directory (the
    config's relative checkpoints/, logs/ and eval_samples/ land there)
    with PDM_DATA_CACHE pointing into it. Returns each path's launches and
    the data layer's numbers."""
    cwd, cache_before = os.getcwd(), os.environ.get("PDM_DATA_CACHE")
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        os.environ["PDM_DATA_CACHE"] = os.path.join(tmp, "data_cache")
        try:
            return _config_path(dev, weights, smi)
        finally:
            os.chdir(cwd)
            if cache_before is None:
                os.environ.pop("PDM_DATA_CACHE", None)
            else:
                os.environ["PDM_DATA_CACHE"] = cache_before


def _config_path(dev, weights, smi: str) -> dict:
    import csv
    import warnings

    import torch

    from pdm_tpu_torch import runtime
    from pdm_tpu_torch.config.loader import (
        load_config, parse_args_from_config, update_config_from_args,
    )
    from pdm_tpu_torch.diffusion.sampling import DDPMSampler
    from pdm_tpu_torch.diffusion.trainer import DDPMTrainer
    from pdm_tpu_torch.models.diffusers_import import write_safetensors
    from pdm_tpu_torch.models.from_config import ddpm_from_config
    from pdm_tpu_torch.models.unet import unet_from_config
    from pdm_tpu_torch.models.unet_ddpm import UNetDDPM
    from pdm_tpu_torch.ops import attention as attn_op
    from pdm_tpu_torch.ops import boltzmann as bz
    from pdm_tpu_torch.ops import groupnorm as gn_op
    from pdm_tpu_torch.schedulers.from_config import scheduler_from_config
    from pdm_tpu_torch.utils.data import (
        HostResidentData, get_data_array, get_data_tensor, pdmc_cache_path,
    )
    from pdm_tpu_torch.utils.logging import CSVLogger, make_eval_fn, read_png
    from pdm_tpu_torch.utils.profiling import PhaseTimer

    counters = ((attn_op.fused_spatial_attention, "attention_fwd"),
                (attn_op.attention_bwd, "attention_bwd"),
                (gn_op.fused_group_norm_act, "group_norm_fwd"),
                (gn_op.group_norm_bwd, "group_norm_bwd"))

    def with_args(argv):
        cfg = load_config()
        update_config_from_args(cfg, parse_args_from_config(cfg, argv))
        return cfg

    # 1. the model from the config
    cfg = load_config()
    tr = cfg.ddpm_training
    got_cfg = (cfg.dataset_name, cfg.ddpm.model_name, cfg.ddpm.precision,
               tr.batch_size, tr.learning_rate, tr.warmup_steps, tr.grad_clip,
               tr.ema_decay)
    want_cfg = ("cifar10", "unet", "bf16", 128, 2e-4, 5000, 10.0, 0.9999)
    if got_cfg != want_cfg:
        fail(f"config path: config.yaml gives {got_cfg}, want {want_cfg}")
    t0 = time.perf_counter()
    ddpm = ddpm_from_config(cfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    hand = unet_from_config(3, FLAGSHIP, dtype=torch.bfloat16, device="cpu")
    layout = [(k, tuple(v.shape), v.dtype) for k, v in ddpm.module.state_dict().items()]
    want_layout = [(k, tuple(v.shape), v.dtype) for k, v in hand.state_dict().items()]
    n_params = sum(p.numel() for p in ddpm.module.parameters())
    log(f"config path: load_config() -> {cfg.experiment_name}; ddpm_from_config "
        f"built the {cfg.ddpm.precision} flagship on {ddpm.device} in {build_s:.2f} s: "
        f"{n_params:,} parameters in {len(layout)} tensors, module dtype "
        f"{ddpm.module.dtype}, names/shapes/dtypes equal to the hand-built "
        f"module: {layout == want_layout}")
    if (layout != want_layout or round(n_params / 1e6, 1) != CONFIG_PARAMS_M
            or ddpm.module.dtype != torch.bfloat16 or ddpm.device != dev):
        fail("config path: ddpm_from_config did not build the bf16 flagship")
    del hand

    # 2. the data: a PDMC cache of CIFAR-10's shape, through the runtime
    u8 = np.random.RandomState(CONFIG_SEED).randint(
        0, 256, (CONFIG_N, 32, 32, 3), dtype=np.uint8)
    os.makedirs(os.environ["PDM_DATA_CACHE"])
    runtime.write_cache(pdmc_cache_path("cifar10", True), u8)
    if not runtime.native_available():
        fail(f"config path: the native data runtime did not build: "
             f"{runtime.build_error}")
    load_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        data = get_data_tensor(cfg)
        torch.cuda.synchronize()
        load_ms.append((time.perf_counter() - t0) * 1e3)
    want_data = (u8.astype(np.float32) * np.float32(2 / 255)
                 - np.float32(1)).transpose(0, 3, 1, 2)
    same_data = (tuple(data.shape) == (CONFIG_N, 3, 32, 32)
                 and data.dtype == torch.float32 and data.device == dev
                 and np.array_equal(data.cpu().numpy(), want_data))
    log(f"config path: get_data_tensor over a {CONFIG_N:,}-image PDMC cache "
        f"({u8.nbytes / 1e6:.1f} MB uint8, native runtime "
        f"{runtime.library_path().name}): {tuple(data.shape)} {data.dtype} on "
        f"{data.device} in {load_ms[0]:.1f} ms, again {load_ms[1]:.1f} ms "
        f"({smi}); bitwise equal to numpy's u8 * float32(2/255) - 1 in CHW: "
        f"{same_data}")
    if not same_data:
        fail("config path: the loaded dataset is not the cache's images")
    del want_data

    # 3. training from config.ddpm_training on the device-resident tensor
    timer = PhaseTimer()
    log_path = os.path.join("logs", f"{cfg.experiment_name}.csv")
    logger = CSVLogger(log_path, use_wandb=tr.use_wandb,
                       run_name=cfg.experiment_name)
    cfg.fid.samples = CONFIG_FID_SAMPLES
    t0 = time.perf_counter()
    eval_fn = make_eval_fn(cfg, data, logger=logger)
    torch.cuda.synchronize()
    eval_build_s = time.perf_counter() - t0
    aug = cfg.data_augmentation
    trainer = DDPMTrainer(
        ddpm, learning_rate=tr.learning_rate, weight_decay=tr.weight_decay,
        betas=tuple(tr.betas), warmup_steps=tr.warmup_steps,
        total_iters=tr.total_iters, grad_clip=tr.grad_clip,
        ema_decay=tr.ema_decay, eval_steps=tr.eval_steps,
        keep_checkpoints=tr.keep_checkpoints, checkpoint_dir=cfg.checkpoint_dir,
        eval_fn=eval_fn, log_fn=logger,
        horizontal_flip=aug.use_augmentation and aug.horizontal_flip,
        grad_accum=tr.grad_accum, timer=timer)
    want_launches = {k: v * CONFIG_STEPS for k, v in TRAIN_LAUNCHES.items()}
    host = HostResidentData(get_data_array(cfg), tr.batch_size)
    if host.device != dev or not all(b.is_pinned() for b in host._staging):
        fail("config path: HostResidentData's staging is not pinned for the card")
    # one untimed, unlogged step on each data path first: the first call of
    # each kernel and allocation is not a step's cost
    trainer.log_fn, trainer.timer = None, None
    for source in (data, host):
        trainer.train(source, batch_size=tr.batch_size, total_iters=1)
    trainer.log_fn = logger

    def train(source, timer_now):
        trainer.timer = timer_now
        for fn, _ in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        state = trainer.train(source, batch_size=tr.batch_size,
                              total_iters=CONFIG_STEPS, log_every=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return state, {key: fn.launches for fn, key in counters}, wall

    state, dev_launches, dev_wall = train(data, timer)
    with open(log_path) as f:
        rows = list(csv.reader(f))
    values = [float(r[2]) for r in rows[1:]]
    metrics = sorted({r[1] for r in rows[1:]})
    dev_sum = timer.summary()
    log(f"config path: device-resident training, {CONFIG_STEPS} steps at batch "
        f"{tr.batch_size} (lr {tr.learning_rate}, warmup {tr.warmup_steps}, clip "
        f"{tr.grad_clip}, EMA {tr.ema_decay}, flip "
        f"{aug.use_augmentation and aug.horizontal_flip}) in {dev_wall:.3f} s; "
        f"launches {dev_launches} (want {want_launches}); CSV {log_path}: "
        f"{len(rows) - 1} rows of {metrics}, last loss "
        f"{values[-3] if len(values) >= 3 else float('nan'):.5g}")
    log("config path: PhaseTimer, device-resident data\n" + timer.report())
    if dev_launches != want_launches:
        fail(f"config path: training launch counts {dev_launches} != {want_launches}")
    if (len(rows) != 1 + 3 * CONFIG_STEPS or rows[0] != ["step", "metric", "value", "time"]
            or not all(math.isfinite(v) for v in values)
            or metrics != ["grad_norm", "learning_rate", "loss"]):
        fail("config path: the CSV log lacks its rows or holds non-finite values")

    # 4. the same steps from host memory: pinned staging, JAX's index stream
    seen = []
    gather = host.device_batch

    def recording_batch(idx):
        out = gather(idx)
        seen.append((np.asarray(idx).copy(), out))
        return out

    host.device_batch = recording_batch
    timer_h = PhaseTimer()
    state_h, host_launches, host_wall = train(host, timer_h)
    host.device_batch = gather
    same_rows = len(seen) == CONFIG_STEPS
    for it, (idx, out) in enumerate(seen, 1):
        want_idx = np.random.default_rng((0, it)).integers(0, CONFIG_N, tr.batch_size)
        same_rows = same_rows and np.array_equal(idx, want_idx) and torch.equal(
            out, data.index_select(0, torch.from_numpy(want_idx).to(dev)))
    host_sum = timer_h.summary()
    log(f"config path: host-resident training, the same {CONFIG_STEPS} steps in "
        f"{host_wall:.3f} s; launches {host_launches}; every step's batch "
        f"bitwise data[default_rng((0, it)).integers(0, N, {tr.batch_size})]: "
        f"{same_rows}")
    log("config path: PhaseTimer, host-resident data\n" + timer_h.report())
    log(f"config path: data phase {dev_sum['data']['mean_ms']:.3f} ms/step "
        f"device-resident vs {host_sum['data']['mean_ms']:.3f} ms/step "
        f"host-resident; train_step phase {dev_sum['train_step']['mean_ms']:.3f} "
        f"vs {host_sum['train_step']['mean_ms']:.3f} ms/step ({smi})")
    if host_launches != want_launches:
        fail(f"config path: host-resident launch counts {host_launches} != "
             f"{want_launches}")
    if not same_rows:
        fail("config path: the host-resident path gathered other rows than JAX's "
             "stream names")
    finite = all(bool(torch.isfinite(t).all()) for t in state_h.params.values())
    if not finite:
        fail("config path: host-resident training gave non-finite parameters")

    # 5. checkpoint, then the factory's pretrained path
    t0 = time.perf_counter()
    trainer.save_checkpoint(state_h, state_h.step)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = ddpm_from_config(cfg, pretrained=True)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    loaded_ok = all(torch.equal(p, state_h.ema_params[k].to(p.dtype))
                    for k, p in loaded.module.named_parameters())
    log(f"config path: checkpoint step {state_h.step} saved in {save_s:.2f} s under "
        f"{cfg.checkpoint_dir}; ddpm_from_config(pretrained=True) in {load_s:.2f} s, "
        f"its weights bitwise the saved EMA's: {loaded_ok}")
    if not loaded_ok:
        fail("config path: load_pretrained_unet did not load the saved EMA weights")
    del state, trainer

    # 6. the eval hook's DDIM-100 grid and FID on the EMA weights
    attn_op.fused_spatial_attention.launches = 0
    gn_op.fused_group_norm_act.launches = 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        eval_metrics = eval_fn(loaded, state_h.step)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
    eval_launches = {"attention_fwd": attn_op.fused_spatial_attention.launches,
                     "group_norm_fwd": gn_op.fused_group_norm_act.launches}
    want_eval = {"attention_fwd": 8 * EVAL_STEPS * 2,
                 "group_norm_fwd": 69 * EVAL_STEPS * 2}
    grid = read_png(os.path.join("eval_samples", f"step_{state_h.step}.png"))
    fid_warned = any("FID unavailable" in str(w.message) for w in caught)
    fid = eval_metrics.get("fid_100_steps", float("nan"))
    log(f"config path: eval hook DDIM-{EVAL_STEPS} grid at batch "
        f"{min(500, cfg.dataset_config.fid_samples)} and FID over "
        f"{cfg.fid.samples} samples at batch {min(64, cfg.fid.samples)} against "
        f"the {CONFIG_N:,} training images (InceptionV3, seeded weights; its "
        f"reference statistics took {eval_build_s:.2f} s at make_eval_fn) in "
        f"{eval_s:.2f} s, launches {eval_launches} (want {want_eval}); grid PNG "
        f"read back {grid.shape} {grid.dtype} mean {float(grid.mean()):.2f} std "
        f"{float(grid.std()):.2f}; metrics {eval_metrics}; FID unavailable "
        f"warned: {fid_warned}")
    if eval_launches != want_eval:
        fail(f"config path: eval launch counts {eval_launches} != {want_eval}")
    if grid.shape != (160, 160, 3) or float(grid.std()) == 0.0:
        fail("config path: the eval grid PNG is not a 5x5 grid of 32x32 RGB images")
    if fid_warned or not (math.isfinite(fid) and fid >= 0):
        fail("config path: the eval hook gave no finite, non-negative FID")
    # without the weights: a warning at every eval, and fid.required refuses
    cfg.fid.required = True
    with env_var("PDM_INCEPTION_WEIGHTS", None):
        try:
            make_eval_fn(cfg, data)
        except RuntimeError as e:
            log(f"config path: without PDM_INCEPTION_WEIGHTS, fid.required=true "
                f"raises: {e}")
        else:
            fail("config path: fid.required=true without weights did not raise")
    cfg.fid.required = False
    del loaded, host, data, eval_fn

    # 7. a diffusers directory of the seeded flagship under legacy names
    dcfg = {"_class_name": "UNet2DModel", **FLAGSHIP, "num_train_timesteps": 1000}
    legacy = legacy_attention_names(weights)
    for fmt in ("safetensors", "bin"):
        os.makedirs(f"diffusers_{fmt}")
        with open(os.path.join(f"diffusers_{fmt}", "config.json"), "w") as f:
            json.dump(dcfg, f)
    write_safetensors(os.path.join("diffusers_safetensors",
                                   "diffusion_pytorch_model.safetensors"), legacy)
    torch.save(legacy, os.path.join("diffusers_bin", "diffusion_pytorch_model.bin"))
    g = torch.Generator(device=dev).manual_seed(CONFIG_SEED)
    x = torch.randn(BATCH, 3, 32, 32, generator=g, device=dev)
    tau = torch.rand(BATCH, generator=g, device=dev)
    net = unet_from_config(3, FLAGSHIP, dtype=torch.bfloat16, device=dev)
    net.load_state_dict(weights)
    direct = UNetDDPM(scheduler_from_config(cfg), net, tau_scale=999.0, device=dev)
    with torch.inference_mode():
        want_out = direct(x, tau)
        for fmt in ("safetensors", "bin"):
            imported = ddpm_from_config(with_args([
                "--ddpm.model_name", "diffusers",
                "--ddpm.diffusers_path", f"diffusers_{fmt}"]))
            got_out = imported(x, tau)
            same_out = (imported.tau_scale == 999.0 and got_out.dtype == want_out.dtype
                        and torch.equal(got_out, want_out))
            log(f"config path: ddpm.model_name diffusers from "
                f"diffusion_pytorch_model.{fmt} (legacy attention names): bf16 "
                f"forward at batch {BATCH} bitwise the directly loaded weights': "
                f"{same_out}")
            if not same_out:
                fail(f"config path: the {fmt} import's forward differs from the "
                     f"same weights loaded directly")
            del imported
    del net, direct
    torch.cuda.empty_cache()

    # 8. the analytic denoiser from the config, over the same cache
    cfg_t = with_args(["--ddpm.model_name", "true", "--ddpm.parametrization", "x0"])
    t0 = time.perf_counter()
    true = ddpm_from_config(cfg_t)
    torch.cuda.synchronize()
    true_s = time.perf_counter() - t0
    sc = cfg_t.sample
    sampler = DDPMSampler(
        ddpm=true, scheduler=scheduler_from_config(
            cfg_t, noise_schedule_type=sc.noise_schedule_type),
        n_steps=sc.n_steps, obj_size=cfg_t.dataset_config.obj_size,
        batch_size=sc.batch_size, n_samples=sc.batch_size,
        step_type=sc.step_type, precision=sc.precision, track_states=True)
    bz.boltzmann_moments.launches = 0
    t0 = time.perf_counter()
    out = sampler.batch_sample(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    true_wall = time.perf_counter() - t0
    true_launches = bz.boltzmann_moments.launches
    x_init = torch.randn((sc.batch_size, *cfg_t.dataset_config.obj_size),
                         generator=torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    err, worst, _ = true_step_errors(true, sampler, x_init, out["states"])
    finite = bool(torch.isfinite(out["x"]).all())
    log(f"config path: ddpm.model_name true ({cfg_t.experiment_name}) over the cache, "
        f"built in {true_s:.2f} s; {sc.step_type.upper()} {sc.n_steps} steps at batch "
        f"{sc.batch_size} ({sc.noise_schedule_type}, {sc.precision}) in "
        f"{true_wall:.4f} s ({true_wall / sc.n_steps * 1e3:.3f} ms/step); moments "
        f"launches {true_launches} (want {2 * sc.n_steps}); every step's x0 against "
        f"the plain version: max_abs_err {err:.3g}, worst {worst:.3g} of the "
        f"tolerance; samples finite {finite}")
    if true_launches != 2 * sc.n_steps:
        fail(f"config path: {true_launches} moments launches, want {2 * sc.n_steps}")
    if worst > 1.0 or not finite:
        fail("config path: the analytic model's x0 disagrees with the plain version")
    del true, sampler, out
    torch.cuda.empty_cache()

    # 9. the data path's rate: the host-resident gather and its copy, beside
    # numpy's fancy indexing of the same rows
    host = HostResidentData(get_data_array(cfg), tr.batch_size)
    batch_bytes = tr.batch_size * 3 * 32 * 32 * 4
    idxs = [np.random.default_rng((1, i)).integers(0, CONFIG_N, tr.batch_size)
            for i in range(GATHER_REPS)]
    for idx in idxs[:3]:
        host.gather(idx)
        host.device_batch(idx)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for idx in idxs:
        host.gather(idx)
    gather_s = (time.perf_counter() - t0) / GATHER_REPS
    t0 = time.perf_counter()
    for idx in idxs:
        host.device_batch(idx)
    torch.cuda.synchronize()
    batch_s = (time.perf_counter() - t0) / GATHER_REPS
    t0 = time.perf_counter()
    for idx in idxs:
        host.data[idx]
    fancy_s = (time.perf_counter() - t0) / GATHER_REPS
    log(f"config path: data layer ({smi}; {os.cpu_count()} CPUs, "
        f"{len(os.sched_getaffinity(0))} usable): get_data_tensor "
        f"{load_ms[0]:.1f} / {load_ms[1]:.1f} ms for {CONFIG_N:,} images; "
        f"host-resident gather of {tr.batch_size} rows {gather_s * 1e3:.4f} ms "
        f"({batch_bytes / gather_s / 1e9:.2f} GB/s of fp32 rows; numpy's "
        f"data[idx] {fancy_s * 1e3:.4f} ms), gather and copy to the card "
        f"{batch_s * 1e3:.4f} ms ({batch_bytes / batch_s / 1e9:.2f} GB/s)")
    return {"train_launches": dev_launches, "host_launches": host_launches,
            "eval_launches": eval_launches, "true_launches": true_launches,
            "true_ms_per_step": true_wall / sc.n_steps * 1e3,
            "load_ms": load_ms, "gather_ms": gather_s * 1e3,
            "numpy_gather_ms": fancy_s * 1e3,
            "device_batch_ms": batch_s * 1e3,
            "data_ms_per_step": {"device": dev_sum["data"]["mean_ms"],
                                 "host": host_sum["data"]["mean_ms"]},
            "train_step_ms": {"device": dev_sum["train_step"]["mean_ms"],
                              "host": host_sum["train_step"]["mean_ms"]}}


@contextlib.contextmanager
def env_var(name: str, value):
    """``os.environ[name]`` set to ``value`` (removed for None) inside the
    block, restored after."""
    before = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if before is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = before


def block_turns(run, pairs: int, steps: int) -> dict:
    """`run` (one turn of `steps` steps) in `pairs` alternating pairs of
    turns on the default path (PDM_FUSED_BLOCK=0) and the whole-block path
    (=1), the order inside a pair alternating too, in ms a step: the host's
    speed drifts between phases, so only the per-pair differences compare
    the two paths. PDM_FUSED_BLOCK is restored after each turn."""
    import torch

    turns = {"0": [], "1": []}
    for pair in range(pairs):
        for flag in (("0", "1") if pair % 2 == 0 else ("1", "0")):
            with env_var("PDM_FUSED_BLOCK", flag):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                turns[flag].append((time.perf_counter() - t0) / steps * 1e3)
    gain = [d - f for d, f in zip(turns["0"], turns["1"])]
    return {"steps_per_turn": steps, "pairs": pairs, "default_ms": turns["0"],
            "whole_block_ms": turns["1"], "default_minus_whole_block_ms": gain,
            "default_median_ms": statistics.median(turns["0"]),
            "whole_block_median_ms": statistics.median(turns["1"]),
            "median_gain_ms": statistics.median(gain),
            "pairs_whole_block_faster": sum(g_ > 0 for g_ in gain)}


def turns_summary(label: str, t: dict) -> str:
    """One log line of :func:`block_turns`'s result."""
    gain = t["default_minus_whole_block_ms"]
    return (f"{label} in {t['pairs']} alternating pairs of turns, {t['steps_per_turn']} "
            f"steps each: default path median {t['default_median_ms']:.3f} ms/step, "
            f"whole-block path median {t['whole_block_median_ms']:.3f}; default minus "
            f"whole block per pair median {t['median_gain_ms']:.3f} ms (range "
            f"{min(gain):.3f} to {max(gain):.3f}), whole block faster in "
            f"{t['pairs_whole_block_faster']} of {t['pairs']} pairs; " + json.dumps(t))


def write_inception_npz(path: str) -> str:
    """Seeded random InceptionV3 weights in the JAX package's .npz layout
    (the pretrained FID weights are not in the repository): kernels
    He-normal, so the 2048 features stay O(1) through the ReLU layers;
    BN scale and variance U(0.5, 1.5), mean and bias N(0, 0.1^2)."""
    from pdm_tpu_torch.models.inception import (
        InceptionV3Features, inception_arrays,
    )

    rng = np.random.RandomState(INCEPTION_SEED)
    state = {}
    for key, v in InceptionV3Features().state_dict().items():
        if key.endswith("weight"):
            fan_in = int(np.prod(v.shape[1:]))
            arr = rng.standard_normal(tuple(v.shape)) * math.sqrt(2.0 / fan_in)
        elif key.endswith(("bn_scale", "bn_var")):
            arr = rng.uniform(0.5, 1.5, tuple(v.shape))
        else:
            arr = 0.1 * rng.standard_normal(tuple(v.shape))
        state[key] = arr.astype(np.float32)
    import torch

    np.savez(path, **inception_arrays({k: torch.from_numpy(a) for k, a in state.items()}))
    return path


def trace_sqrtm_reference(x1, x2) -> float:
    """tr sqrtm(S1 S2) from the features themselves, in float64 on the CPU,
    with no eigh and no threshold: with A, B the centred features over
    sqrt(n - 1), S1 = A^T A and S2 = B^T B, so the trace is the nuclear
    norm of A B^T, the sum of the singular values of R1 R2^T where
    A = Q1 R1 and B = Q2 R2."""
    rs = [np.linalg.qr((x.astype(np.float64) - x.mean(0, dtype=np.float64))
                       / np.sqrt(len(x) - 1), mode="r") for x in (x1, x2)]
    return float(np.linalg.svd(rs[0] @ rs[1].T, compute_uv=False).sum())


def frechet_phase(dev, smi: str) -> dict:
    """Phase 18a: trace_sqrtm_product and frechet_distance at F 2048 on the
    card, full rank and rank 64, against the nuclear norm of the centred
    features' product in float64 on the CPU (trace_sqrtm_reference), with
    the eigh's time."""
    import torch

    from pdm_tpu_torch.ops.sqrtm import trace_sqrtm_product
    from pdm_tpu_torch.utils.fid import frechet_distance

    rng = np.random.RandomState(FID_SEED)
    f = FID_DIM
    # features with a decaying spectrum and nonzero means, as Inception's
    scales = np.exp(-np.arange(f) / 400.0).astype(np.float32)
    out = {}
    for label, n in (("full rank", 4 * f), ("rank 64", 65)):
        f1 = rng.standard_normal((n, f)).astype(np.float32) * scales + 0.5
        f2 = (rng.standard_normal((n, f)).astype(np.float32) * scales * 1.1
              + 0.55)
        mus = [a.mean(0).astype(np.float32) for a in (f1, f2)]
        sigmas = [np.cov(a, rowvar=False).astype(np.float32) for a in (f1, f2)]
        t0 = time.perf_counter()
        want_tr = trace_sqrtm_reference(f1, f2)
        ref_s = time.perf_counter() - t0
        want_fid = (float(np.sum((mus[0].astype(np.float64) - mus[1]) ** 2))
                    + float(np.trace(sigmas[0].astype(np.float64)))
                    + float(np.trace(sigmas[1].astype(np.float64))) - 2 * want_tr)
        mu_t = [torch.from_numpy(m).to(dev) for m in mus]
        s_t = [torch.from_numpy(s).to(dev) for s in sigmas]
        got_tr = float(trace_sqrtm_product(*s_t))
        got_fid = float(frechet_distance(mu_t[0], s_t[0], mu_t[1], s_t[1]))
        self_fid = float(frechet_distance(mu_t[0], s_t[0], mu_t[0], s_t[0]))
        scale = float(np.trace(sigmas[0]) + np.trace(sigmas[1]))
        tr_err = abs(got_tr - want_tr) / want_tr
        fid_err = abs(got_fid - want_fid) / scale
        eigh64 = event_ms(lambda: torch.linalg.eigh(s_t[0].double()))[0]
        eigh32 = event_ms(lambda: torch.linalg.eigh(s_t[0]))[0]
        tsp_ms = event_ms(lambda: trace_sqrtm_product(*s_t))[0]
        fid_ms = event_ms(lambda: frechet_distance(mu_t[0], s_t[0], mu_t[1], s_t[1]))[0]
        log(f"fid: F {f} {label} (n {n}): trace_sqrtm_product card {got_tr:.9g} vs "
            f"nuclear norm float64 {want_tr:.9g} (rel err {tr_err:.3g}); FID card "
            f"{got_fid:.9g} vs {want_fid:.9g} (err {fid_err:.3g} of tr S1 + tr S2); "
            f"FID of a set with itself {self_fid:.3g}; card eigh float64 "
            f"{eigh64:.3f} ms (float32 {eigh32:.3f} ms), trace_sqrtm_product "
            f"{tsp_ms:.3f} ms, frechet_distance {fid_ms:.3f} ms; the reference "
            f"{ref_s * 1e3:.0f} ms on the CPU ({smi})")
        if not (tr_err <= SQRTM_TOL and fid_err <= SQRTM_TOL and got_fid >= 0
                and abs(self_fid) <= 1e-3):
            fail(f"fid: the card's Frechet distance at F {f} {label} disagrees "
                 f"with the float64 reference")
        out[label] = {"eigh64_ms": eigh64, "eigh32_ms": eigh32,
                      "trace_sqrtm_ms": tsp_ms, "frechet_ms": fid_ms,
                      "rel_err": tr_err}
    return out


def inception_phase(dev, smi: str, weights_path: str) -> dict:
    """Phase 18b: InceptionV3 with seeded random weights from a JAX-layout
    npz: features of 16 images on the card against the CPU, TF32 off
    inside the extractor and restored after, and its rate at batch 500."""
    import torch

    from pdm_tpu_torch.models.inception import load_inception
    from pdm_tpu_torch.utils.fid import inception_feature_fn, quantize_like_uint8

    u8 = np.random.RandomState(INCEPTION_SEED).randint(
        0, 256, (INCEPTION_BATCH, 3, 32, 32)).astype(np.float32)
    x = torch.from_numpy(u8 * np.float32(2 / 255) - np.float32(1))
    fn, dim = inception_feature_fn(device=dev)
    got = fn(x[:16].to(dev)).cpu().numpy()
    cpu_fn, _ = inception_feature_fn(device="cpu")
    t0 = time.perf_counter()
    want = cpu_fn(x[:16]).numpy()
    cpu_s = time.perf_counter() - t0
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    # TF32: on before the call, off inside the extractor, on again after
    model = load_inception(weights_path, device=dev)
    seen = []
    model.Conv2d_1a_3x3.register_forward_pre_hook(
        lambda mod, args: seen.append((torch.backends.cudnn.allow_tf32,
                                       torch.backends.cuda.matmul.allow_tf32)))
    torch.backends.cudnn.allow_tf32 = True
    with torch.no_grad():
        model(quantize_like_uint8(x[:2].to(dev)))
    restored = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    xb = x.to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn(xb)
    torch.cuda.synchronize()
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    card_ms, host_ms = event_ms(lambda: fn(xb))
    per_1000 = card_ms * 1000.0 / INCEPTION_BATCH
    log(f"fid: InceptionV3 ({dim} features, seeded random weights from a "
        f"JAX-layout npz, 32x32 resized to 299x299): 16 images on the card vs "
        f"the CPU (CPU {cpu_s:.1f} s): max_abs_err {err:.3g} of scale "
        f"{scale:.3g}; cudnn/cuBLAS TF32 inside the extractor {seen[0]}, "
        f"cudnn TF32 after {restored} (on before); batch {INCEPTION_BATCH}: "
        f"{card_ms:.1f} ms ({per_1000:.1f} ms per 1,000 images, host "
        f"{host_ms:.1f} ms), peak card memory {peak_gb:.2f} GB above the "
        f"inputs ({smi})")
    if got.shape != (16, 2048) or not err <= INCEPTION_TOL * scale:
        fail("fid: InceptionV3 features on the card disagree with the CPU")
    if seen[0] != (False, False) or restored is not True:
        fail("fid: TF32 was not off inside the extractor and restored after")
    del model, xb
    torch.cuda.empty_cache()
    return {"ms_per_1000": per_1000, "batch_ms": card_ms, "peak_gb": peak_gb,
            "max_abs_err": err, "scale": scale}


def lenet_phase(dev, smi: str) -> dict:
    """Phase 18c: a LeNet trained on the card on seeded MNIST-shaped data
    (labels: the argmax of ten fixed random projections), written in JAX's
    npz format, and the LeNet FID path on the card against the CPU."""
    import torch

    from pdm_tpu_torch.models.lenet import evaluate_lenet, save_lenet, train_lenet
    from pdm_tpu_torch.utils.fid import get_compute_fid, lenet_feature_fn

    rng = np.random.RandomState(LENET_SEED)
    x = (rng.randint(0, 256, (LENET_N, 1, 32, 32)) * (2 / 255) - 1).astype(np.float32)
    proj = rng.standard_normal((1024, 10)).astype(np.float32)
    y = np.argmax(x.reshape(LENET_N, -1) @ proj, axis=1)
    t0 = time.perf_counter()
    model = train_lenet(torch.Generator().manual_seed(0), x[:-1000], y[:-1000],
                        epochs=LENET_EPOCHS, verbose=False, device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    _, acc = evaluate_lenet(model, x[-1000:], y[-1000:])
    save_lenet(model, "lenet_mnist.npz")
    fids = {}
    for where in (dev, "cpu"):
        fn, dim = lenet_feature_fn("lenet_mnist.npz", device=where)
        compute = get_compute_fid(x[:5000], fn, dim, device=where)
        fids[str(where)] = compute(np.clip(x[5000:10000] * 0.9, -1, 1))
    card, cpu = fids[str(dev)], fids["cpu"]
    log(f"fid: LeNet trained on the card in {train_s:.2f} s ({LENET_EPOCHS} epochs "
        f"of {LENET_N - 1000:,} seeded MNIST-shaped images): held-out accuracy "
        f"{acc:.3f}; LeNet FID of 5,000 shrunk images against 5,000 others: card "
        f"{card:.6g}, CPU {cpu:.6g} ({smi})")
    if not (acc > 0.3 and math.isfinite(card) and card >= 0
            and abs(card - cpu) <= 1e-3 * max(cpu, 1.0)):
        fail("fid: the LeNet path failed or the card's FID disagrees with the CPU")
    return {"accuracy": acc, "fid": card, "train_s": train_s}


def entry_points(dev, smi: str) -> dict:
    """Phase 18d: the four CLIs in turn on the card, in this process
    through each one's main(argv=...) with a user's flags (so that the
    launch counters can be read; python -m itself is not run), over PDMC
    caches of CIFAR-10's shape (50,000 train and 10,000 test
    seeded uint8 images): compute_stats_forward, the flagship's
    train_diffusion for CLI_TRAIN_STEPS steps with an eval (grid and FID
    over CLI_FID_SAMPLES samples) at the last, sample from its checkpoint,
    compute_fid with n_steps [10]. Each with rows 1-4's launch counters
    zeroed just before and read just after, its wall time, and its
    artifact read back."""
    import csv

    import torch

    from pdm_tpu_torch import runtime
    from pdm_tpu_torch.ops import attention as attn_op
    from pdm_tpu_torch.ops import boltzmann_sweep as sw
    from pdm_tpu_torch.ops import groupnorm as gn_op
    from pdm_tpu_torch.scripts import (
        compute_fid, compute_stats_forward, sample, train_diffusion,
    )
    from pdm_tpu_torch.utils.data import pdmc_cache_path

    counters = ((attn_op.fused_spatial_attention, "attention_fwd"),
                (attn_op.attention_bwd, "attention_bwd"),
                (gn_op.fused_group_norm_act, "group_norm_fwd"),
                (gn_op.group_norm_bwd, "group_norm_bwd"),
                (sw.boltzmann_sweep, "sweep"))
    rng = np.random.RandomState(CONFIG_SEED)
    os.makedirs(os.environ["PDM_DATA_CACHE"])
    for train, n in ((True, CONFIG_N), (False, CLI_TEST_N)):
        runtime.write_cache(pdmc_cache_path("cifar10", train),
                            rng.randint(0, 256, (n, 32, 32, 3), dtype=np.uint8))
    out = {}

    def run(name, main, argv, want):
        for fn, _ in counters:
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = main(argv=argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {key: fn.launches for fn, key in counters}
        log(f"entry points: {name} {' '.join(argv)} in {wall:.2f} s wall; "
            f"launches {launches} (want {want}) ({smi})")
        if launches != want:
            fail(f"entry points: {name} launch counts {launches} != {want}")
        out[name] = {"wall_s": wall, "launches": launches}
        return result

    # forward_stats.yaml: 1024 samples in one batch, a partials and a merge
    run("compute_stats_forward", compute_stats_forward.main, [],
        {"attention_fwd": 0, "attention_bwd": 0, "group_norm_fwd": 0,
         "group_norm_bwd": 0, "sweep": 2})
    stats = dict(np.load("stats/cifar10_forward.npz"))
    log(f"entry points: stats/cifar10_forward.npz: {stats['temp'].shape[0]} "
        f"temperatures {stats['temp'][0]:.3g}..{stats['temp'][-1]:.3g}, entropy "
        f"{stats['entropy'][0]:.6g}..{stats['entropy'][-1]:.6g}")
    if not all(np.isfinite(v).all() for v in stats.values()):
        fail("entry points: the forward statistics are not finite")

    batches = 1 + math.ceil(CLI_FID_SAMPLES / 64)  # the grid, then FID's
    evals = EVAL_STEPS * batches
    run("train_diffusion", train_diffusion.main,
        ["--ddpm_training.total_iters", str(CLI_TRAIN_STEPS),
         "--ddpm_training.eval_steps", str(CLI_TRAIN_STEPS),
         "--fid.samples", str(CLI_FID_SAMPLES)],
        {"attention_fwd": 8 * (CLI_TRAIN_STEPS + evals),
         "attention_bwd": 16 * CLI_TRAIN_STEPS,
         "group_norm_fwd": 69 * (CLI_TRAIN_STEPS + evals),
         "group_norm_bwd": 69 * CLI_TRAIN_STEPS, "sweep": 0})
    exp = "cifar10_unet_eps_linear_beta_schedule"
    with open(f"logs/{exp}.csv") as f:
        logged = [r for r in csv.DictReader(f)]
    train_fid = [float(r["value"]) for r in logged if r["metric"] == "fid_100_steps"]
    log(f"entry points: logs/{exp}.csv: {len(logged)} rows, fid_100_steps "
        f"{train_fid} ({CLI_FID_SAMPLES} DDIM-100 samples against the {CONFIG_N:,} "
        f"training images); checkpoints: {sorted(os.listdir(f'checkpoints/{exp}'))}")
    if len(train_fid) != 1 or not (math.isfinite(train_fid[0]) and train_fid[0] >= 0):
        fail("entry points: the training log holds no finite, non-negative FID")

    sample_n = 10  # sample.yaml's n_steps
    run("sample", sample.main, [],
        {"attention_fwd": 8 * sample_n, "attention_bwd": 0,
         "group_norm_fwd": 69 * sample_n, "group_norm_bwd": 0, "sweep": 0})
    x = np.load(f"samples/{exp}_{sample_n}_ddim_steps.npz")["x"]
    log(f"entry points: samples/{exp}_{sample_n}_ddim_steps.npz {x.shape} "
        f"{x.dtype}, mean {float(x.mean()):.4f} std {float(x.std()):.4f}")
    if x.shape != (100, 3, 32, 32) or not np.isfinite(x).all():
        fail("entry points: the samples are not 100 finite CIFAR-shaped images")

    rows = run("compute_fid", compute_fid.main,
               ["--fid.n_steps", "[10]", "--fid.samples", str(CLI_FID_SAMPLES)],
               {"attention_fwd": 8 * 10, "attention_bwd": 0,
                "group_norm_fwd": 69 * 10, "group_norm_bwd": 0, "sweep": 0})
    with open(f"fid/{exp}.csv") as f:
        table = list(csv.DictReader(f))
    log(f"entry points: fid/{exp}.csv {table} ({CLI_FID_SAMPLES} DDIM-10 samples "
        f"against the {CLI_TEST_N:,} test images)")
    fid = float(table[0]["fid"]) if len(table) == 1 else float("nan")
    if not (math.isfinite(fid) and fid >= 0 and fid == rows[0]["fid"]):
        fail("entry points: the FID table holds no finite, non-negative FID")
    out["train_fid"], out["cli_fid"] = train_fid[0], fid
    return out


def experiment_clis(dev, smi: str) -> dict:
    """Phase 18e: the offline experiment CLIs and export_sampler, each once
    on the card through its main() at the CPU tests' sizes
    (tests/test_torch_scripts.py), in phase 18's working directory: its
    wall time, its launches of rows 1, 3, 7 and 8 (zeroed just before,
    read just after; exact where the count follows from the sizes) and its
    outputs read back."""
    import shutil as _shutil

    import torch

    from pdm_tpu_torch.config.loader import DEFAULT_CONFIG_PATH
    from pdm_tpu_torch.ops import attention as attn_op
    from pdm_tpu_torch.ops import boltzmann as bz
    from pdm_tpu_torch.ops import boltzmann_sweep as sw
    from pdm_tpu_torch.ops import groupnorm as gn_op
    from pdm_tpu_torch.scripts import (
        analyze_synthetic_stats, compute_model_metric_schedule,
        compute_stats_empirical, e2e_synthetic, export_sampler,
        reproduce_high_dim, sample_gmm, verify_logsnr_metric,
        verify_mc_metric, verify_rescaled_metric,
    )
    from pdm_tpu_torch.utils.serving import load_exported

    counters = (("attention", attn_op.fused_spatial_attention),
                ("group_norm", gn_op.fused_group_norm_act),
                ("moments", bz.boltzmann_moments), ("sweep", sw.boltzmann_sweep))
    out = {}

    def run(name, fn, want=None):
        for _, c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters}
        log(f"experiment CLIs: {name} in {wall:.2f} s wall; launches {launches}"
            + (f" (want {want})" if want is not None else "") + f" ({smi})")
        if want is not None and launches != want:
            fail(f"experiment CLIs: {name} launch counts {launches} != {want}")
        out[name] = {"wall_s": wall, "launches": launches}
        return result

    def only(**kw):
        return {"attention": 0, "group_norm": 0, "moments": 0, "sweep": 0, **kw}

    k = 4  # grid points of the verify CLIs; one moments call (2 launches) each
    for name, mod, size in (("verify_mc_metric", verify_mc_metric, "n_sigmas"),
                            ("verify_logsnr_metric", verify_logsnr_metric, "n_lambdas"),
                            ("verify_rescaled_metric", verify_rescaled_metric,
                             "n_sigma_sqs")):
        res = run(name, lambda: mod.main([], n_points=200, n_y=300, **{size: k}),
                  only(moments=2 * k))
        if not np.isfinite(res["mc"]).all():
            fail(f"experiment CLIs: {name} estimates not finite")
    res = run("sample_gmm", lambda: sample_gmm.main(
        [], n_data=5000, n_samples=20, n_ref=1000), only(moments=2 * 10))
    log(f"experiment CLIs: sample_gmm MMD {res['Initial']['mmd']:.6f}")
    res = run("analyze_synthetic_stats", lambda: analyze_synthetic_stats.main(
        ["--d", "10", "--sizes", "60", "120", "--n_samples", "32"]),
        only(sweep=2 * 3))
    log(f"experiment CLIs: analyze_synthetic_stats mid-range |S_mc - S_exact| "
        f"{res['mid_err']:.4f}")
    true_cifar = ["--dataset_name", "cifar10", "--ddpm.model_name", "true",
                  "--ddpm.parametrization", "x0"]
    written = run("compute_stats_empirical", lambda: compute_stats_empirical.main(
        argv=[*true_cifar, "--empirical_stats.n_temps", "5",
              "--empirical_stats.n_steps_per_temp", "2",
              "--empirical_stats.batch_size", "8"]), only(moments=2 * 5 * 2))
    for emp_path in written:
        emp = dict(np.load(emp_path))
        log(f"experiment CLIs: {emp_path}: entropy {emp['entropy'].tolist()}")
        if not all(np.isfinite(v).all() for v in emp.values()):
            fail("experiment CLIs: the empirical statistics are not finite")
    yaml_dir = os.path.abspath("yaml_true")
    _shutil.copytree(os.path.dirname(DEFAULT_CONFIG_PATH), yaml_dir)
    ddpm_yaml = os.path.join(yaml_dir, "groups", "ddpm.yaml")
    with open(ddpm_yaml) as f:
        text = f.read()
    with open(ddpm_yaml, "w") as f:
        f.write(text.replace("model_name: unet", 'model_name: "true"')
                .replace("parametrization: eps", "parametrization: x0"))
    with env_var("PDM_CONFIG", os.path.join(yaml_dir, "config.yaml")):
        res = run("compute_model_metric_schedule",
                  lambda: compute_model_metric_schedule.main(
                      ["--n_samples", "24", "--n_temps", "5"]), only(moments=2 * 5))
    if not np.isfinite(res["stats"]["metric"]).all() or res["timestamps"][-1] != 1.0:
        fail("experiment CLIs: the model metric schedule is not finite")
    with env_var("PDM_CONFIG", None):
        res = run("reproduce_high_dim", lambda: reproduce_high_dim.main(
            [], n_train=300, n_gen=50, n_temps=8, sweep_samples=32, sweep_batch=32,
            n_steps=3), only(moments=2 * 2 * 3, sweep=2))
    log("experiment CLIs: reproduce_high_dim table " + json.dumps(
        {k_: {"mmd": v["mmd"], "kl": v["kl"], "mse": v["mse"]}
         for k_, v in res["table"].items()}))
    res = run("e2e_synthetic", lambda: e2e_synthetic.main(
        ["--steps", "2", "--n_data", "300", "--batch_size", "16", "--fid_samples",
         "64", "--sample_steps", "2"]))
    if not (math.isfinite(res["best_fid"]) and math.isfinite(res["floor"])):
        fail("experiment CLIs: e2e_synthetic's FIDs are not finite")
    gmm = ["--dataset_name", "gmm1d", "--ddpm.model_name", "true",
           "--ddpm.parametrization", "x0", "--ddpm.noise_schedule_type", "log_snr",
           "--diffusion.min_temp", "1e-4", "--diffusion.max_temp", "1e1",
           "--sample.n_steps", "6", "--sample.batch_size", "32",
           "--sample.n_samples", "32", "--sample.step_type", "ddim"]
    path = run("export_sampler", lambda: export_sampler.main(
        [*gmm, "--out", "serving/gmm.pt2"]), only())
    fn, manifest = load_exported(path)
    replay = run("export_sampler's artifact replayed", lambda: fn(7),
                 only(moments=2 * 6))
    if tuple(replay.shape) != (32, 1, 1, 1) or not bool(torch.isfinite(replay).all()):
        fail("experiment CLIs: the exported GMM sampler's replay is not finite")
    return out


def fid_and_entry_points(dev, smi: str, weights_path: str) -> dict:
    """Phase 18, in a temporary working directory with PDM_DATA_CACHE
    pointing into it and PDM_INCEPTION_WEIGHTS at the seeded weights."""
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp, \
            env_var("PDM_DATA_CACHE", os.path.join(tmp, "data_cache")), \
            env_var("PDM_INCEPTION_WEIGHTS", weights_path):
        os.chdir(tmp)
        try:
            t0 = time.perf_counter()
            out = {"frechet": frechet_phase(dev, smi)}
            out["inception"] = inception_phase(dev, smi, weights_path)
            out["lenet"] = lenet_phase(dev, smi)
            out["cli"] = entry_points(dev, smi)
            out["experiments"] = experiment_clis(dev, smi)
            log(f"phase 18 took {time.perf_counter() - t0:.1f} s")
            return out
        finally:
            os.chdir(cwd)


def analytic_main_path(time_ms, dev):
    """Phase 11: TrueDDPM DDIM sampling at CIFAR-10 scale (MOMENTS_MAIN):
    the moments launch counter zeroed just before the sample and read just
    after (two per step); every step's x0 against the plain version on the
    same xt; ms/step, samples/s, the stages by CUDA events and the card's
    idle share; finite samples and how many a training image memorized.
    Returns (launches, path numbers)."""
    import torch

    from pdm_tpu_torch.diffusion.sampling import DDPMSampler, _step_tables
    from pdm_tpu_torch.models.base import TrueDDPM
    from pdm_tpu_torch.ops import boltzmann as bz
    from pdm_tpu_torch.ops import boltzmann_kernel as bk
    from pdm_tpu_torch.schedulers.analytic import LinearBetaScheduler

    label, B, N, D, _ = MOMENTS_MAIN
    g = torch.Generator(device=dev).manual_seed(5)
    data = torch.randn(N, 3, 32, 32, generator=g, device=dev)
    sched = LinearBetaScheduler(1e-4, 2.478e4)
    t0 = time.perf_counter()
    ddpm = TrueDDPM(sched, data, device=dev)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0

    def sampler_of(n_steps):
        return DDPMSampler(ddpm=ddpm, scheduler=sched, n_steps=n_steps,
                           obj_size=(3, 32, 32), batch_size=B, n_samples=B,
                           step_type="ddim", precision="full", track_states=True,
                           device=dev)

    sampler_of(1).batch_sample(torch.Generator(device=dev).manual_seed(1))
    torch.cuda.synchronize()
    sampler = sampler_of(TRUE_STEPS)
    bz.boltzmann_moments.launches = 0
    t0 = time.perf_counter()
    out = sampler.batch_sample(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = bz.boltzmann_moments.launches
    x, states = out["x"], out["states"]
    ms_step = wall / TRUE_STEPS * 1e3
    finite = bool(torch.isfinite(x).all())
    log(f"analytic main path: TrueDDPM DDIM {TRUE_STEPS} steps, batch {B}, {label} "
        f"N={N} D={D} fp32 (dataset packed once in {pack_s:.3f} s): {wall:.4f} s, "
        f"{ms_step:.3f} ms/step, {B / wall:.2f} samples/s; moments launches "
        f"{launches} ({launches / TRUE_STEPS:g}/step); output {tuple(x.shape)} mean "
        f"{float(x.mean()):.4g} std {float(x.std()):.4g} finite {finite}")
    if launches != 2 * TRUE_STEPS:
        fail(f"analytic main path: {launches} moments launches, want {2 * TRUE_STEPS}")
    if tuple(x.shape) != (B, 3, 32, 32) or not finite:
        fail("analytic main path: samples not finite of shape (1000, 3, 32, 32)")

    # every step's x0 (the moments' mean) against the plain version on the
    # same xt, the inputs the sampler gave the model
    x_init = torch.randn((B, 3, 32, 32), generator=torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    err_all, worst_all, step_inputs = true_step_errors(ddpm, sampler, x_init, states)
    log(f"analytic main path: every step's x0 against the plain version on the same xt: "
        f"max_abs_err {err_all:.3g}, worst {worst_all:.3g} of the tolerance "
        f"{'ok' if worst_all <= 1.0 else 'MISMATCH'}")
    if worst_all > 1.0:
        fail("analytic main path: x0 disagrees with the plain version")

    # where a step's time goes: each stage alone, the host's enqueue hidden
    xt, lt0, it, s = step_inputs[TRUE_STEPS // 2]
    tab = {k: v[TRUE_STEPS // 2] for k, v in _step_tables(sampler._grid()).items()}
    ops = bk.operands(xt, ddpm.pack(), it, s, values=data, mode="fp32")

    def step():
        preds = ddpm.get_predictions(xt, lt0)
        return tab["ddim_x0"] * preds.x0.float() + tab["ddim_eps"] * preds.eps.float()

    stages = {
        "moments kernels (partials and merge launches)": lambda: bk.launch(ops),
        "boltzmann_moments call (layout: transpose, per-row terms; launches)":
            lambda: bz.boltzmann_moments(xt, ddpm.pack(), it, s, values=data),
        "model evaluation (tau, alpha_bar, the call, eps from x0)":
            lambda: ddpm.get_predictions(xt, lt0),
        "one DDIM step (evaluation and update)": step,
    }
    card = {}
    with torch.inference_mode():
        for name, fn in stages.items():
            card[name], host = time_ms(fn, reps=5, inner=1)
            log(f"analytic stage: {name}: {card[name]:.4f} ms card, {host:.4f} ms host")
    busy = card["one DDIM step (evaluation and update)"]
    kern = card["moments kernels (partials and merge launches)"]
    log(f"analytic main path: the moments kernels are {kern / busy:.1%} of a step's "
        f"{busy:.4f} ms card time; the card is idle {max(0.0, 1.0 - busy / ms_step):.1%} "
        f"of a {ms_step:.3f} ms step")
    dist = nearest_distance(x, data)
    share = float((dist <= MEMORIZED * math.sqrt(D)).float().mean())
    log(f"analytic main path: {share:.1%} of the samples lie within "
        f"{MEMORIZED} sqrt(D) = {MEMORIZED * math.sqrt(D):.3f} of their nearest "
        f"training image (median distance {float(dist.median()):.4g}): the Bayes-"
        f"optimal denoiser of a finite set reproduces its points")
    del ddpm, data, states, out, step_inputs, ops
    torch.cuda.empty_cache()
    return launches, {"launches": launches, "launches_per_step": launches / TRUE_STEPS,
                      "ms_per_step": ms_step, "samples_per_s": B / wall,
                      "card_ms_per_step": busy, "kernels_ms_per_step": kern}


def g_lambda_gaussian(sigma_sq, sigma0_sq=1.0):
    """Closed-form G(lambda), lambda = log sigma^2, for N(0, sigma0^2) data
    (tests/test_stats.py:23-26)."""
    return 0.5 * sigma0_sq * (sigma0_sq + 2 * sigma_sq) / (sigma0_sq + sigma_sq) ** 2


def paper_experiments(dev) -> None:
    """Phase 12: the paper's experiments on the card through the moments
    kernel: high_dim_exp.yaml (the sweep, the metric and cosine schedules,
    TrueDDPM DDPM-20 for 10,000 samples each; MMD at sigma = sqrt(dim)
    against 5,000 training points, component occupancy, mean MSE to the
    assigned mean, as scripts/reproduce_high_dim.py:169-187 without KL),
    gmm1d (scripts/sample_gmm.py: DDPM-10 on 100 samples, MMD at 0.1,
    modes hit) and the estimators against the closed forms of
    tests/test_stats.py."""
    import torch

    from pdm_tpu_torch.diffusion.sampling import DDPMSampler, get_samples
    from pdm_tpu_torch.models.base import TrueDDPM
    from pdm_tpu_torch.ops import boltzmann as bz
    from pdm_tpu_torch.ops.mmd import mmd_rbf
    from pdm_tpu_torch.schedulers.analytic import CosineScheduler, LogSNRScheduler
    from pdm_tpu_torch.schedulers.interpolated import metric_scheduler
    from pdm_tpu_torch.stats.mc_metric import metric_scalar
    from pdm_tpu_torch.stats.model_metric import (
        empirical_entropy_stats, model_metric_stats,
    )
    from pdm_tpu_torch.stats.sweep import thermo_sweep
    from pdm_tpu_torch.utils.synthetic import generate_anisotropic_gmm, generate_gmm_1d

    gen = torch.Generator(device=dev).manual_seed(6)
    hd = HIGH_DIM
    dim, n_comp, n_train, n_gen, batch, steps = (hd["dim"], 5, hd["n_train"], hd["n_gen"],
                                                 hd["batch"], hd["steps"])
    train, means, _ = generate_anisotropic_gmm(dim=dim, n_components=n_comp,
                                               n_samples=n_train)
    data = torch.from_numpy(train).to(dev)
    t0 = time.perf_counter()
    stats = thermo_sweep(data, np.logspace(-4, 4, hd["n_temps"]), hd["sweep_samples"],
                         hd["sweep_batch"], generator=gen, device=dev)
    log(f"high_dim: thermo_sweep ({hd['n_temps']} temperatures 1e-4..1e4, "
        f"{hd['sweep_samples']} samples in batches of {hd['sweep_batch']}) "
        f"{time.perf_counter() - t0:.3f} s; metric "
        f"{stats['metric'].min():.4g} .. {stats['metric'].max():.4g}")
    schedules = {"Cosine": CosineScheduler(1e-4, 1e4),
                 "Metric": metric_scheduler(stats["log_temp"], stats["metric"], device=dev)}
    rng = np.random.RandomState(0)
    flat = train.reshape(n_train, dim)
    ref = flat[rng.randint(0, n_train, n_gen)]
    samples = {"Baseline (True)": flat[rng.randint(0, n_train, n_gen)]}
    for name, sch in schedules.items():
        ddpm = TrueDDPM(sch, data, device=dev)
        bz.boltzmann_moments.launches = 0
        t0 = time.perf_counter()
        out = get_samples(ddpm, sch, n_steps=steps, obj_size=(1, dim, 1), n_samples=n_gen,
                          batch_size=batch, step_type="ddpm", generator=gen, device=dev)
        wall = time.perf_counter() - t0
        launches = bz.boltzmann_moments.launches
        samples[name] = out["x"].reshape(n_gen, dim)
        log(f"high_dim: {name} schedule, TrueDDPM DDPM-{steps}, {n_gen} samples in "
            f"batches of {batch}: {wall:.3f} s, {n_gen / wall:.1f} samples/s; moments "
            f"launches {launches}")
        if launches != 2 * steps * (n_gen // batch):
            fail(f"high_dim {name}: {launches} moments launches")
    n_mmd = min(5000, n_gen)
    ref_t = torch.from_numpy(ref[:n_mmd]).to(dev)
    for name, x in samples.items():
        mmd = float(mmd_rbf(torch.from_numpy(x[:n_mmd]).to(dev), ref_t,
                            sigmas=(float(np.sqrt(dim)),)))
        d = ((x[:, None, :] - means[None]) ** 2).sum(-1)
        assign = d.argmin(1)
        occ = np.bincount(assign, minlength=n_comp) / len(x)
        mse = np.nanmean([((x[assign == i] - means[i]) ** 2).sum(1).mean()
                          if (assign == i).any() else np.nan for i in range(n_comp)])
        ok = bool(np.isfinite(x).all() and occ.min() >= 0.05)
        log(f"high_dim: {name:<16} MMD {mmd:.6f}  avg MSE {mse:.4f}  components "
            f"[{', '.join(f'{o:.3f}' for o in occ)}] {'ok' if ok else 'FAILED'}")
        if not ok:
            fail(f"high_dim {name}: samples not finite or a component under 5%")
    del data, samples, schedules
    torch.cuda.empty_cache()

    # gmm1d (scripts/sample_gmm.py)
    g1 = torch.from_numpy(generate_gmm_1d(GMM1D_N)).to(dev)
    sch = LogSNRScheduler(1e-4, 1e1)
    sampler = DDPMSampler(ddpm=TrueDDPM(sch, g1, device=dev), scheduler=sch, n_steps=10,
                          obj_size=(1, 1, 1), batch_size=100, n_samples=100,
                          step_type="ddpm", device=dev)
    x = sampler.sample(gen)["x"].reshape(-1)
    mmd = float(mmd_rbf(torch.from_numpy(x[:, None]).to(dev), g1[:10_000].reshape(-1, 1),
                        sigmas=(0.1,)))
    modes = np.array([-1.1, -0.9, 0.9, 1.1])
    hit = np.unique(np.abs(x[:, None] - modes[None]).argmin(1))
    ok = bool(np.isfinite(x).all() and len(hit) == 4)
    log(f"gmm1d: TrueDDPM DDPM-10 on 100 samples, N = {GMM1D_N}: MMD (sigma 0.1) {mmd:.6f}, "
        f"modes hit {len(hit)} of 4 {'ok' if ok else 'FAILED'}")
    if not ok:
        fail("gmm1d: samples not finite or a mode missed")
    del g1, sampler

    # the estimators against their Gaussian closed forms (tests/test_stats.py)
    checks = []
    d8 = np.random.RandomState(8).randn(20_000, 1, 1, 1).astype(np.float32)
    temp = np.logspace(-1, 1, 5)
    got = model_metric_stats(TrueDDPM(LogSNRScheduler(1e-3, 1e3), d8, device=dev), d8,
                             temp, 512, 256, generator=gen, device=dev)["metric"]
    want = 0.5 * ((1 - 1 / np.sqrt(1 + temp)) ** 2 / temp + 1 / (1 + temp))
    checks.append(("model_metric_stats (VE into the VP posterior)", got, want,
                   np.abs(got - want) <= 0.02 + 0.3 * np.abs(want), "rtol 0.3 atol 0.02"))
    d9 = np.random.RandomState(9).randn(10_000, 1, 1, 1).astype(np.float32)
    temp9 = np.logspace(-2, 2, 9)
    ent = empirical_entropy_stats(TrueDDPM(LogSNRScheduler(1e-3, 1e3), d9, device=dev),
                                  d9, temp9, 256, 256, generator=gen, device=dev)
    tf = np.logspace(-2, 2, 2001)
    f = 0.5 / (1 + tf)
    cum = np.concatenate([[0.0], np.cumsum(0.5 * (f[1:] + f[:-1]) * np.diff(np.log(tf)))])
    want9 = np.interp(np.log(temp9), np.log(tf), cum)
    want9 -= want9[-1]
    checks.append(("empirical_entropy_stats (entropy)", ent["entropy"], want9,
                   (np.abs(ent["entropy"] - want9) <= 0.1)
                   & (ent["d_entropy_d_log_temp"] > 0), "atol 0.1, dS/dlogT > 0"))
    x10 = torch.randn(10_000, 1, generator=gen, device=dev)
    lams = np.linspace(-3, 3, 7)
    got = np.array([float(metric_scalar(lam, x10, 10_000, generator=gen, device=dev))
                    for lam in lams])
    want = g_lambda_gaussian(np.exp(lams))
    checks.append(("metric_scalar", got, want, np.abs(got - want) <= 0.02 + 0.15 * want,
                   "rtol 0.15 atol 0.02"))
    for name, got, want, ok, tol in checks:
        log(f"estimator {name} vs the Gaussian closed form ({tol}): got "
            f"{np.array2string(np.asarray(got), precision=4)} want "
            f"{np.array2string(np.asarray(want), precision=4)} "
            f"{'ok' if bool(np.all(ok)) else 'FAILED'}")
        if not np.all(ok):
            fail(f"{name} disagrees with its closed form")


def block_inputs(g, dev, B, T, C, dtype):
    """x, h, (w_q, w_k, w_v), (b_q, b_k, b_v), w_out, b_out of one block in
    the module's layout and dtype: activations N(0, 1), weights N(0, 1/C),
    biases N(0, 0.01)."""
    import torch

    def r(*shape, s=1.0):
        return (s * torch.randn(*shape, generator=g, device=dev)).to(dtype)

    ws = [r(C, C, s=C ** -0.5) for _ in range(4)]
    bs = [r(C, s=0.1) for _ in range(4)]
    return r(B, T, C), r(B, T, C), ws[:3], bs[:3], ws[3], bs[3]


def block_library(x, h, ws, bs, w_out, b_out, heads, scale):
    """The whole block as library calls (F.linear, SDPA, F.linear, add),
    the yardstick of rows 5 and 6: returns a function of no arguments,
    with the SDPA backend it runs as its ``backend`` attribute."""
    import torch
    import torch.nn.functional as F

    B, T, C = h.shape
    w_cat, b_cat = torch.cat(list(ws)), torch.cat(list(bs))

    def qkv():
        return F.linear(h, w_cat, b_cat).view(B, T, 3, heads, C // heads).permute(
            2, 0, 3, 1, 4)

    def run():
        q, k, v = qkv()
        a = F.scaled_dot_product_attention(q, k, v, scale=scale)
        return x + F.linear(a.transpose(1, 2).reshape(B, T, C), w_out, b_out)

    with torch.no_grad():
        run.backend = sdpa_backend(*qkv(), scale)
    return run


def staged_row(call, want: dict, tol, time_ms, reps, pick=lambda r: r) -> dict:
    """The staged launch plan forced at a cluster-plan shape: `call`'s
    outputs (through `pick`, in `want`'s order) against the plain version's
    `want` to `tol`, and its time beside the cluster plan's. Fails on a
    mismatch."""
    import torch

    got = pick(call())
    torch.cuda.synchronize()
    errs = {k: compare_to_scale(a, b, *tol) for (k, b), a in zip(want.items(), got)}
    if not all(ok for _, ok in errs.values()):
        fail(f"the staged plan at a cluster shape disagrees with the plain version: "
             f"{[k for k, (_, ok) in errs.items() if not ok]}")
    return {"staged_ms": time_ms(call, **reps)[0],
            "staged_max_abs_err": max(e for e, _ in errs.values())}


def staged_note(row: dict) -> str:
    """The staged plan's figures in a cluster row's log line."""
    if "staged_ms" not in row:
        return ""
    return (f"; the staged plan on the same inputs {row['staged_ms']:.4f} ms "
            f"(max_abs_err {row['staged_max_abs_err']:.3g})")


def block_kernel_rows(time_ms, dev, geoms=BLOCK_GEOMS, batches=(BATCH, TRAIN_BATCH),
                      seed: int = 5):
    """Rows 5 and 6 against their plain versions on the same card inputs at
    `geoms` ((T, C, heads, calls a step); by default the flagship's
    attention shapes): the forward at each of `batches`, the backward at
    the last, bf16 and fp32, each row naming its launch plan (route).
    Returns ({batch: forward rows}, backward rows)."""
    import torch
    from pdm_tpu_torch.ops import attention_block as tb

    g = torch.Generator(device=dev).manual_seed(seed)
    fwd = {b: [] for b in batches}
    bwd_rows = []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        esz = 2 if dtype == torch.bfloat16 else 4
        for (T, C, heads, calls), batch in [(geom, b) for b in batches
                                           for geom in geoms]:
            hd = C // heads
            scale = 1.0 / math.sqrt(hd)
            route = tb.block_route(T, C, heads)
            # the staged plan's fp32 calls take milliseconds: fewer of them
            staged_reps = {"reps": 3, "inner": 5} if dtype == torch.float32 else {}
            reps = staged_reps if route == "staged" else {}
            x, h, ws, bs, wo, bo = block_inputs(g, dev, batch, T, C, dtype)
            args = (x, h, ws, bs, wo, bo, heads, scale)
            out, lse = tb._forward(*args)
            out2, lse2 = tb._forward(*args)
            ref, ref_lse = tb._reference_with_lse(x, h, *ws, bs, wo, bo, heads, scale)
            torch.cuda.synchronize()
            same = torch.equal(out, out2) and torch.equal(lse, lse2)
            plan = (tb.plan_block(batch, T, hd, backward=False)._asdict()
                    if dtype == torch.bfloat16 and route == "cluster" else None)
            rtol, atol = BLOCK_TOL[dname]
            err, ok = compare_to_scale(out, ref, rtol, atol)
            lse_err, lse_ok = compare_to_scale(lse, ref_lse, rtol, atol)
            frac = max(tol_fraction(out, ref, rtol, atol),
                       tol_fraction(lse, ref_lse, rtol, atol))
            b_ms, b_by = bound(3 * batch * T * C * esz + 4 * C * C * esz + 4 * C * esz
                               + batch * heads * T * 4,
                               8 * batch * T * C * C + 4 * batch * T * T * C, dname)
            ms, host_ms = time_ms(lambda: tb._forward(*args), **reps)
            library = block_library(*args)
            row = {
                "shape": [batch, T, C], "heads": heads, "dtype": dname,
                "calls_per_step": calls if dtype == torch.bfloat16 else 0,
                "route": route, "launches_per_call": BLOCK_LAUNCHES[route, False],
                "max_abs_err": err, "lse_max_abs_err": lse_err,
                "tol_fraction": frac, "rtol": rtol, "bitwise_repeat": same,
                "plan": plan, "atol_of_scale": atol, "ms": ms, "host_ms": host_ms,
                "plain_ms": time_ms(lambda: tb._reference_with_lse(
                    x, h, *ws, bs, wo, bo, heads, scale), inner=5)[0],
                "library_ms": time_ms(library, **reps)[0],
                "library": "F.linear + scaled_dot_product_attention + F.linear + add",
                "library_backend": library.backend,
                "bound_ms": b_ms, "bound_by": b_by,
            }
            if route == "cluster":  # the staged plan beside it on the same inputs
                row.update(staged_row(lambda: tb.launch_fwd(*args, route="staged"),
                                      {"out": ref, "lse": ref_lse}, BLOCK_TOL[dname],
                                      time_ms, staged_reps))
            fwd[batch].append(row)
            log(f"whole block ({route}) {dname} B={batch} T={T} C={C} heads={heads}: max_abs_err "
                f"{err:.3g} (lse {lse_err:.3g}; tol rtol {rtol} atol {atol:.3g} of "
                f"scale; worst {frac:.3g} of it) kernel_ms {ms:.4f} (host {host_ms:.4f}) plain_ms "
                f"{row['plain_ms']:.4f} library_ms {row['library_ms']:.4f} (SDPA "
                f"{library.backend}) bound_ms "
                f"{b_ms:.4f} ({b_by}); two calls bitwise equal: {same}; plan {plan}"
                f"{staged_note(row)} {'ok' if ok and lse_ok else 'MISMATCH'}")
            if not (ok and lse_ok):
                fail(f"whole-block kernel disagrees with its plain version at "
                     f"{row['shape']} {dname}")
            if not same:
                fail(f"whole-block kernel not bitwise repeatable at {row['shape']} {dname}")
            if batch != batches[-1]:
                continue

            # the backward at the training batch: every gradient of the
            # autograd Function against the plain backward on the same lse
            gco = torch.randn(batch, T, C, generator=g, device=dev).to(dtype)
            leaves = [t.detach().clone().requires_grad_()
                      for t in (x, h, *ws, *bs, wo, bo)]
            got = torch.autograd.grad(tb.fused_attention_block(
                leaves[0], leaves[1], *leaves[2:5], leaves[5:8], leaves[8],
                leaves[9], heads, scale), leaves, gco)
            want = tb.attention_block_bwd_reference(h, *ws, bs, wo, lse, gco, heads, scale)
            once = tb.attention_block_bwd(h, *ws, bs, wo, lse, gco, heads, scale)
            twice = tb.attention_block_bwd(h, *ws, bs, wo, lse, gco, heads, scale)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(once, twice))
            plan = (tb.plan_block(batch, T, hd, backward=True)._asdict()
                    if dtype == torch.bfloat16 and route == "cluster" else None)
            del once, twice
            rtol, atol = BLOCK_BWD_TOL[dname]
            named = {"dh": (got[1], want[0]), "dw_q": (got[2], want[1]),
                     "dw_k": (got[3], want[2]), "dw_v": (got[4], want[3]),
                     "db_qkv": (torch.cat(got[5:8]), torch.cat(want[4:7])),
                     "dw_out": (got[8], want[7])}
            checks = {k: compare_to_scale(a, b, rtol, atol) for k, (a, b) in named.items()}
            frac = max(tol_fraction(a, b, rtol, atol) for a, b in named.values())
            db_out = gco.float().sum(dim=(0, 1)).to(bo.dtype)
            checks["db_out"] = compare_to_scale(got[9], db_out, *PARAM_GRAD_TOL)
            checks["dx"] = (float((got[0].float() - gco.float()).abs().max()),
                            torch.equal(got[0], gco))
            err = max(c[0] for c in checks.values())
            ok = all(c[1] for c in checks.values())
            # the function's least work: recompute q, k, v (6 B T C^2) and
            # datt (2), dh (6), dW_qkv (6), dW_out (2); the attention's
            # scores, P v, dv, dp, dq and dk (2 B T^2 C each)
            b_ms, b_by = bound(3 * batch * T * C * esz + batch * heads * T * 4
                               + 8 * C * C * esz + 3 * C * esz,
                               22 * batch * T * C * C + 12 * batch * T * T * C, dname)
            ms, host_ms = time_ms(lambda: tb.attention_block_bwd(
                h, *ws, bs, wo, lse, gco, heads, scale), **reps)
            lib_leaves = [t.detach().clone().requires_grad_()
                          for t in (x, h, *ws, *bs, wo, bo)]
            library = block_library(lib_leaves[0], lib_leaves[1], lib_leaves[2:5],
                                    lib_leaves[5:8], lib_leaves[8], lib_leaves[9],
                                    heads, scale)
            lib_out = library()
            row = {
                "shape": [batch, T, C], "heads": heads, "dtype": dname,
                "calls_per_step": calls if dtype == torch.bfloat16 else 0,
                "route": route, "launches_per_call": BLOCK_LAUNCHES[route, True],
                "max_abs_err": err,
                "errors": {k: c[0] for k, c in checks.items()},
                "tol_fraction": frac, "bitwise_repeat": same, "plan": plan,
                "weight_grad_chunks": tb._weight_grad_chunks(
                    batch * T, C, dtype == torch.bfloat16,
                    torch.cuda.get_device_properties(dev).multi_processor_count),
                "rtol": rtol, "atol_of_scale": atol, "ms": ms, "host_ms": host_ms,
                "plain_ms": time_ms(lambda: tb.attention_block_bwd_reference(
                    h, *ws, bs, wo, lse, gco, heads, scale), inner=3)[0],
                "library_ms": time_ms(lambda: torch.autograd.grad(
                    lib_out, lib_leaves, gco, retain_graph=True), **reps)[0],
                "library": "autograd of F.linear + scaled_dot_product_attention "
                           "+ F.linear + add",
                "library_backend": library.backend,
                "bound_ms": b_ms, "bound_by": b_by,
                # the design's own traffic beyond the bound: dqkv and att
                # written by the first kernel and read by the second
                "intermediate_mb": 2 * batch * T * 4 * C * esz / 1e6,
            }
            if route == "cluster":  # db_qkv as one vector, as above
                def db_qkv_joined(r):
                    return (*r[:4], torch.cat(r[4:7]), r[7])

                row.update(staged_row(
                    lambda: tb.attention_block_bwd(h, *ws, bs, wo, lse, gco, heads,
                                                   scale, route="staged"),
                    dict(zip(("dh", "dw_q", "dw_k", "dw_v", "db_qkv", "dw_out"),
                             db_qkv_joined(want))),
                    BLOCK_BWD_TOL[dname], time_ms, staged_reps, pick=db_qkv_joined))
            bwd_rows.append(row)
            log(f"whole block backward ({route}) {dname} B={batch} T={T} C={C} "
                f"heads={heads}: "
                f"errors {', '.join(f'{k} {c[0]:.3g}' for k, c in checks.items())} "
                f"(tol rtol {rtol} atol {atol:.3g} of scale, worst {frac:.3g} of it; "
                f"db_out {PARAM_GRAD_TOL}; dx exact) kernel_ms {ms:.4f} (host {host_ms:.4f}) plain_ms "
                f"{row['plain_ms']:.4f} library_ms {row['library_ms']:.4f} bound_ms "
                f"{b_ms:.4f} ({b_by}); dqkv and att round trip "
                f"{row['intermediate_mb']:.1f} MB; two calls bitwise equal: {same}; "
                f"plan {plan}, {row['weight_grad_chunks']} weight-gradient chunks"
                f"{staged_note(row)} {'ok' if ok else 'MISMATCH'}")
            if not ok:
                bad = [k for k, c in checks.items() if not c[1]]
                fail(f"whole-block backward kernels disagree with their plain "
                     f"version at {row['shape']} {dname}: {bad}")
            if not same:
                fail(f"whole-block backward kernels not bitwise repeatable at "
                     f"{row['shape']} {dname}")
            del lib_out, lib_leaves, leaves, got, want
    torch.cuda.empty_cache()
    return fwd, bwd_rows


def block_edge_rows(dev, edges=BLOCK_EDGES, seed: int = 9):
    """Rows 5 and 6 at `edges` ((B, T, heads, hd); by default BLOCK_EDGES),
    bf16 and fp32, untimed: the forward and lse and every gradient of the
    backward against the plain versions to BLOCK_TOL / BLOCK_BWD_TOL, each
    kernel called twice (bitwise equal), the route's launches exact.
    Returns (forward rows: out and lse; backward rows: dh, the weight and
    the bias gradients), one per shape and dtype (no calls on the main
    path)."""
    import torch
    from pdm_tpu_torch.ops import attention_block as tb

    g = torch.Generator(device=dev).manual_seed(seed)
    fwd_rows, bwd_rows = [], []
    for B, T, heads, hd in edges:
        C = heads * hd
        scale = 1.0 / math.sqrt(hd)
        route = tb.block_route(T, C, heads)
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            x, h, ws, bs, wo, bo = block_inputs(g, dev, B, T, C, dtype)
            counts = (tb.fused_attention_block.launches, tb.attention_block_bwd.launches)
            out, lse = tb._forward(x, h, ws, bs, wo, bo, heads, scale)
            out2, lse2 = tb._forward(x, h, ws, bs, wo, bo, heads, scale)
            ref, ref_lse = tb._reference_with_lse(x, h, *ws, bs, wo, bo, heads, scale)
            gco = torch.randn(B, T, C, generator=g, device=dev).to(dtype)
            got = tb.attention_block_bwd(h, *ws, bs, wo, lse, gco, heads, scale)
            got2 = tb.attention_block_bwd(h, *ws, bs, wo, lse, gco, heads, scale)
            want = tb.attention_block_bwd_reference(h, *ws, bs, wo, lse, gco, heads, scale)
            torch.cuda.synchronize()
            launched = (tb.fused_attention_block.launches - counts[0],
                        tb.attention_block_bwd.launches - counts[1])
            if launched != (2 * BLOCK_LAUNCHES[route, False], 2 * BLOCK_LAUNCHES[route, True]):
                fail(f"whole block edge {[B, T, heads, hd]} {dname} ({route}): "
                     f"{launched} launches for two calls each way")
            fwd_pairs = {"out": (out, ref), "lse": (lse, ref_lse)}
            bwd_pairs = {name: (got[i], want[i]) for name, i in
                         (("dh", 0), ("dw_q", 1), ("dw_k", 2), ("dw_v", 3), ("dw_out", 7))}
            bwd_pairs["db_qkv"] = (torch.cat(got[4:7]), torch.cat(want[4:7]))
            for kind, pairs, tol, same, rows in (
                    ("forward", fwd_pairs, BLOCK_TOL,
                     torch.equal(out, out2) and torch.equal(lse, lse2), fwd_rows),
                    ("backward", bwd_pairs, BLOCK_BWD_TOL,
                     all(torch.equal(a, b) for a, b in zip(got, got2)), bwd_rows)):
                errs = {k: compare_to_scale(a, b, *tol[dname]) for k, (a, b) in pairs.items()}
                frac = max(tol_fraction(a, b, *tol[dname]) for a, b in pairs.values())
                ok = all(c[1] for c in errs.values())
                plan = (tb.plan_block(B, T, hd, backward=kind == "backward")._asdict()
                        if dtype == torch.bfloat16 and route == "cluster" else None)
                rows.append({"shape": [B, T, C], "heads": heads, "dtype": dname,
                             "calls_per_step": 0, "edge": True, "route": route,
                             "max_abs_err": max(c[0] for c in errs.values()),
                             "tol_fraction": frac, "bitwise_repeat": same, "plan": plan})
                log(f"whole block edge ({route}) {kind} {dname} B={B} T={T} heads={heads} "
                    f"hd={hd}: "
                    f"worst {frac:.3g} of {'BLOCK_TOL' if kind == 'forward' else 'BLOCK_BWD_TOL'}"
                    f" ({', '.join(pairs)}), two calls bitwise equal: {same}; plan {plan} "
                    f"{'ok' if ok and same else 'MISMATCH'}")
                if not ok:
                    fail(f"whole-block {kind} kernel disagrees with its plain version at "
                         f"the edge {[B, T, heads, hd]} {dname}: "
                         f"{[k for k, c in errs.items() if not c[1]]}")
                if not same:
                    fail(f"whole-block {kind} kernel not bitwise repeatable at the edge "
                         f"{[B, T, heads, hd]} {dname}")
    torch.cuda.empty_cache()
    return fwd_rows, bwd_rows


def backward_probe(weights, sched, dev, x6, tau6, eps6) -> dict:
    """Two backward passes of the full-width fp32 train step's loss on the
    same weights and inputs, compared bitwise: once as the card runs by
    default, once with torch.backends.cudnn.deterministic and
    torch.use_deterministic_algorithms(True) (warn_only, so an op without a
    deterministic implementation is named rather than raised). Prints the
    largest difference of each parameter group and, where the two passes
    differ, the parameter whose gradient the backward computes first (the
    last in module order) among those that differ."""
    import warnings

    import torch
    from pdm_tpu_torch.diffusion.trainer import DDPMTrainer
    from pdm_tpu_torch.models.unet import unet_from_config
    from pdm_tpu_torch.models.unet_ddpm import UNetDDPM

    net = unet_from_config(3, {**FLAGSHIP, "dropout": 0.0}, dtype=torch.float32,
                           device=dev)
    net.load_state_dict(weights)
    net.train()
    trainer = DDPMTrainer(UNetDDPM(sched, net, device=dev), learning_rate=1e-4,
                          warmup_steps=0)
    trainer.ddpm.train()
    names = [k for k, _ in net.named_parameters()]

    def group(name):
        parts = name.split(".")
        return ".".join(parts[:2]) if parts[0].endswith("blocks") else parts[0]

    def two_passes():
        a = trainer._grads(x6.to(dev), None, tau6.to(dev), eps6.to(dev))[1]
        b = trainer._grads(x6.to(dev), None, tau6.to(dev), eps6.to(dev))[1]
        return [float((ga - gb).abs().max()) for ga, gb in zip(a, b)]

    result = {}
    before = (torch.backends.cudnn.deterministic,
              torch.are_deterministic_algorithms_enabled())
    for mode in ("default", "deterministic"):
        caught = []
        if mode == "deterministic":
            torch.backends.cudnn.deterministic = True
            torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                diffs = two_passes()
        finally:
            torch.backends.cudnn.deterministic = before[0]
            torch.use_deterministic_algorithms(before[1])
        by_group = {}
        for name, d in zip(names, diffs):
            by_group[group(name)] = max(by_group.get(group(name), 0.0), d)
        differing = [n for n, d in zip(names, diffs) if d > 0.0]
        first = differing[-1] if differing else None
        nondet = sorted({str(w.message).split(".")[0] for w in caught
                         if "deterministic" in str(w.message)})
        log(f"backward probe ({mode}): two passes on the same inputs differ in "
            f"{len(differing)} of {len(names)} parameters; largest difference "
            f"by group {json.dumps({k: v for k, v in by_group.items()})}; first "
            f"to differ in backward order: {first}; ops without a "
            f"deterministic implementation: {nondet or 'none'}")
        result[mode] = {"differing": len(differing), "first": first,
                        "max": max(diffs), "nondeterministic_ops": nondet}
    del trainer, net
    torch.cuda.empty_cache()
    return result


def train_step_card_vs_cpu(weights, sched, dev, x6, tau6, eps6, label):
    """The full-width fp32 flagship train step (batch 2, dropout off, the
    same tau and eps) on the card against the CPU: loss and every gradient
    the step applied within TRAIN_TOL of their scale, then the parameters
    after that Adam step within what the two gradients allow."""
    import torch
    from pdm_tpu_torch.diffusion.trainer import DDPMTrainer
    from pdm_tpu_torch.models.unet import unet_from_config
    from pdm_tpu_torch.models.unet_ddpm import UNetDDPM

    lr6 = 1e-4
    step6 = {}
    for name, d in (("cpu", torch.device("cpu")), ("card", dev)):
        net6 = unet_from_config(3, {**FLAGSHIP, "dropout": 0.0},
                                dtype=torch.float32, device=d)
        tr6 = DDPMTrainer(UNetDDPM(sched, net6, device=d), learning_rate=lr6,
                          warmup_steps=0, grad_clip=1e9, ema_decay=0.9999)
        st6 = tr6.init_state(weights)
        st6, m6, grads6 = train_step_with_grads(
            tr6, st6, x6.to(d), tau=tau6.to(d), eps=eps6.to(d))
        step6[name] = (float(m6["loss"]), grads6,
                       {k: v.cpu() for k, v in st6.params.items()},
                       float(m6["grad_norm"]))
        del net6, tr6, st6
    torch.cuda.empty_cache()
    cpu6, card6 = step6["cpu"], step6["card"]
    loss_err = abs(card6[0] - cpu6[0]) / abs(cpu6[0])
    top = max(float(v.abs().max()) for v in cpu6[1].values())
    worst_grad, worst_step, bad = 0.0, 0.0, []
    for k, g6 in cpu6[1].items():
        e = float((card6[1][k] - g6).abs().max())
        tol_k = TRAIN_TOL["grad"] * float(g6.abs().max()) + TRAIN_TOL["grad_floor"] * top
        worst_grad = max(worst_grad, e / tol_k)
        excess = ((card6[2][k] - cpu6[2][k]).abs()
                  - adam_first_step_bound(card6[1][k], g6, lr6) - 1e-7)
        worst_step = max(worst_step, float(excess.max()))
        if e > tol_k or float(excess.max()) > 0:
            bad.append(k)
    log(f"{label} fp32 train step B=2, card (kernels) vs CPU (plain): loss "
        f"{card6[0]:.6g} vs {cpu6[0]:.6g} (rel err {loss_err:.3g}, tol "
        f"{TRAIN_TOL['loss']}); grad_norm {card6[3]:.6g} vs {cpu6[3]:.6g}; "
        f"worst gradient error {worst_grad:.3g} of its tolerance (1e-3 of its "
        f"scale + 1e-5 of {top:.3g}); params after one Adam step (lr {lr6}) "
        f"within the bound the gradients allow, worst excess {worst_step:.3g}")
    if not (loss_err <= TRAIN_TOL["loss"]) or bad:
        fail(f"{label} fp32 train step on the card disagrees with the CPU: {bad[:5]}")


def attention_head_dim_sweep(attn_op, dev, g) -> None:
    """Rows 1 and 2 at every head dim the kernels take (ATTN_SWEEP_HD) and
    ATTN_SWEEP_T, bf16 and fp32, on the column thirds of one (2, T, 3C)
    projection with 2 heads: the forward (and lse) to TOL, the three
    gradients to BWD_TOL, against the plain versions on the same inputs.
    Untimed; fails on the first disagreement."""
    import torch

    worst = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        for T in ATTN_SWEEP_T:
            for hd in ATTN_SWEEP_HD:
                C, heads = 2 * hd, 2
                qkv = torch.randn(2, T, 3 * C, generator=g, device=dev).to(dtype)
                q, k, v = qkv.split(C, dim=-1)
                do = torch.randn(2, T, C, generator=g, device=dev).to(dtype)
                scale = 1.0 / math.sqrt(hd)
                out, lse = attn_op.attention_with_lse(q, k, v, heads, scale)
                ref, ref_lse = attn_op._reference_with_lse(q, k, v, heads, scale)
                got = attn_op.attention_bwd(q, k, v, lse, do, heads, scale)
                want = attn_op.attention_bwd_reference(q, k, v, lse, do, heads, scale)
                torch.cuda.synchronize()
                lse_tol = 1e-4 * (1.0 + float(ref_lse.abs().max()))
                fwd = max(compare_fraction(out, ref, dname),
                          float((lse - ref_lse).abs().max()) / lse_tol)
                bwd = max(tol_fraction(a_, b_, *BWD_TOL[dname])
                          for a_, b_ in zip(got, want))
                key = (dname, "single-pass" if T <= 256 and dtype == torch.bfloat16
                       else "two-pass" if dtype == torch.bfloat16 else "fp32")
                worst[key] = max(worst.get(key, (0.0, 0.0))[0], fwd), max(
                    worst.get(key, (0.0, 0.0))[1], bwd)
                if fwd > 1.0 or bwd > 1.0:
                    fail(f"attention kernels disagree with their plain versions at "
                         f"T={T} hd={hd} {dname}: forward {fwd:.3g}, backward "
                         f"{bwd:.3g} of the tolerance")
    for (dname, kind), (fwd, bwd) in worst.items():
        log(f"attention head-dim sweep {dname} {kind}: hd {ATTN_SWEEP_HD[0]}-"
            f"{ATTN_SWEEP_HD[-1]}, T {ATTN_SWEEP_T}: worst forward {fwd:.3g}, "
            f"backward {bwd:.3g} of the tolerance")


def vjp_case(dev, g, y, B, log10_t):
    """Row 7b's inputs over a dataset y (N, D): queries xt = sqrt(ab) y_j +
    sqrt(1 - ab) eps at one temperature per row, log-spaced over
    ``log10_t`` (the first row at its lower end, one-hot at T = 1e-4), the
    denoiser's inv_temp = 1 / (1 - ab) and y_scale = sqrt(ab), and an
    N(0, 1) cotangent of the mean."""
    import torch

    N, D = y.shape
    temps = torch.logspace(*log10_t, B, device=dev)
    ab = 1.0 / (1.0 + temps)
    idx = torch.randint(0, N, (B,), generator=g, device=dev)
    x = (torch.sqrt(ab)[:, None] * y[idx]
         + torch.sqrt(1.0 - ab)[:, None] * torch.randn(B, D, generator=g, device=dev))
    c = torch.randn(B, D, generator=g, device=dev)
    return x, 1.0 / (1.0 - ab), torch.sqrt(ab), c


def vjp_bound(B, N, D, mode):
    """(bound ms, bound_by) of one VJP call: the two Grams (x.y and c.y)
    at the mode's peak, the fp32 product w.y and the epilogue at fp32's;
    each input read once (queries, cotangent, the pack, norms, the row-major
    dataset, per-row terms), each output written once (dx, two scalars)."""
    passes = SWEEP_PASSES[mode]
    esz = 4 if mode == "fp32" else 2
    n_bytes = (2 * B * D * 4 + D * N * esz * (2 if passes == 3 else 1) + N * 4
               + N * D * 4 + 5 * B * 4 + B * D * 4 + 2 * B * 4)
    t_ops = (2 * 2 * B * N * D * passes
             / PEAK_OPS_PER_S["float32" if mode == "fp32" else "bfloat16"]
             + (2 * B * N * D + VJP_EPI_OPS * B * N) / PEAK_OPS_PER_S["float32"]) * 1e3
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def vjp_tolerance(x, y, it, s, c, mode, delta, gap, eps_u, eps_g):
    """Per-output tolerances (dx (rows, D), d inv_temp and d y_scale
    (rows,)) of row 7b against its plain version on the same rows, for
    logits that differ by at most ``delta`` (rows,) between the two
    (moments_logit_error), Grams c.y by ``eps_u`` and x.y by ``eps_g``.

    Each output is F = sum_j w_j phi_j with w_j = p_j (u_j - ubar). With
    p'_j / p_j within 1 + r, r = expm1(2 delta) (at most 2 (N - 1)
    exp(4 delta - gap) where the top logit leads by ``gap``, as
    moments_check), ubar moves by at most r E_p|u - ubar| + eps_u, so F
    by r M1 + (1 + r) E_p|phi| (2 eps_u + r E_p|u - ubar|) + (1 + r) ((1 +
    r) E_p|u - ubar| + 2 eps_u) dphi, with M1 = E_p[|u - ubar| |phi|] and
    dphi the move of phi itself: 0 for dx (phi = -inv_temp (x - s y_j)
    per component), 2 delta / inv_temp for d
    inv_temp (phi = -(log_z - l_j) / inv_temp), inv_temp eps_g for d
    y_scale (phi = -inv_temp (2 s ysq_j - x.y_j)). Plus 8 sqrt(N) 2^-24 of
    (M1 + 2 eps_u E|phi|): fp32 sums over N in another order. The
    expectations come from a float64 pass over the plain version's Grams
    (the mode's split operands)."""
    import torch

    from pdm_tpu_torch.ops.precision import split

    f = torch.float64

    def parts(a):
        hi, lo = split(a.float(), mode)
        return hi.to(f), None if lo is None else lo.to(f)

    def gram64(a, b):
        out = a[0] @ b[0].T
        if a[1] is not None:
            out = out + a[0] @ b[1].T + a[1] @ b[0].T
        return out

    xp, cp = parts(x), parts(c)
    x64 = x.to(f)
    it, s = it.to(f), s.to(f)
    xsq = 0.5 * (x64 * x64).sum(1)
    N, D = y.shape
    # (rows, chunk, D) float64 temporaries of at most 2^26 elements
    chunk = max(1, min(8192, (1 << 26) // (x.shape[0] * D)))

    def chunks():
        for lo in range(0, N, chunk):
            yc = y[lo:lo + chunk].float()
            y64 = yc.to(f)
            ysq = 0.5 * (y64 * y64).sum(1)
            g = gram64(xp, parts(yc))
            lg = -((xsq[:, None] - s[:, None] * g) + (s * s)[:, None] * ysq[None]) * it[:, None]
            yield y64, parts(yc), ysq, g, lg

    m = torch.full_like(xsq, float("-inf"))
    s0 = torch.zeros_like(xsq)
    sy = torch.zeros_like(x64)
    for y64, _, _, _, lg in chunks():
        m_new = torch.maximum(m, lg.max(1).values)
        scale = torch.exp(m - m_new)
        p = torch.exp(lg - m_new[:, None])
        s0 = s0 * scale + p.sum(1)
        sy = sy * scale[:, None] + p @ y64
        m = m_new
    log_z = m + torch.log(s0)
    ubar = (c.to(f) * (sy / s0[:, None])).sum(1)
    ea = torch.zeros_like(xsq)
    m_x, e_x = torch.zeros_like(x64), torch.zeros_like(x64)
    m_i, e_i, m_s, e_s = (torch.zeros_like(xsq) for _ in range(4))
    for y64, yp, ysq, g, lg in chunks():
        p = torch.exp(lg - log_z[:, None])
        pa = p * (gram64(cp, yp) - ubar[:, None]).abs()
        ea += pa.sum(1)
        dist = (x64[:, None, :] - s[:, None, None] * y64[None]).abs()
        m_x += torch.einsum("ij,ijk->ik", pa, dist)
        e_x += torch.einsum("ij,ijk->ik", p, dist)
        phi = (log_z[:, None] - lg).abs() / it[:, None]
        m_i += (pa * phi).sum(1)
        e_i += (p * phi).sum(1)
        phi = (2.0 * s[:, None] * ysq[None] - g).abs()
        m_s += (pa * phi).sum(1)
        e_s += (p * phi).sum(1)
    m_x, e_x, m_s, e_s = it[:, None] * m_x, it[:, None] * e_x, it * m_s, it * e_s
    d = torch.as_tensor(np.asarray(delta, np.float64), device=x.device)
    gp = torch.as_tensor(np.asarray(gap, np.float64), device=x.device)
    r = torch.clamp(torch.minimum(torch.expm1(2.0 * d),
                                  2.0 * (N - 1) * torch.exp(4.0 * d - gp)), max=1e30)
    floor = 8.0 * math.sqrt(N) * 2.0 ** -24

    def tol(m1, e1, dphi):
        rr, ee = (r, ea) if m1.ndim == 1 else (r[:, None], ea[:, None])
        return (rr * m1 + (1 + rr) * e1 * (2 * eps_u + rr * ee)
                + (1 + rr) * ((1 + rr) * ee + 2 * eps_u) * dphi
                + floor * (m1 + 2 * eps_u * e1))

    return (tol(m_x, e_x, 0.0), tol(m_i, e_i, 2.0 * d / it), tol(m_s, e_s, it * eps_g),
            int((r < 1.0).sum()))


def vjp_kernel_rows(time_ms, dev):
    """Phase 19a: row 7b (the posterior mean's VJP) against its plain
    version on the same card inputs at VJP_SHAPES, in each mode, on
    VJP_SUBSET rows over the temperature range (vjp_tolerance), two calls
    bitwise equal; times of the kernel, the plain version and the library
    composition (the three products through cuBLAS in fp32 without TF32,
    with the elementwise work)."""
    import torch

    from pdm_tpu_torch.ops import boltzmann as bz
    from pdm_tpu_torch.ops import boltzmann_kernel as bk
    from pdm_tpu_torch.ops import boltzmann_sweep as sw
    from pdm_tpu_torch.ops.precision import full_fp32_matmul
    from pdm_tpu_torch.utils.synthetic import generate_gmm_1d

    g = torch.Generator(device=dev).manual_seed(21)
    rows = []
    for label, B, N, D, log10_t, modes in VJP_SHAPES:
        if label == "gmm1d":
            y = torch.from_numpy(generate_gmm_1d(N)).reshape(N, 1).to(dev)
        else:
            y = torch.randn(N, D, generator=g, device=dev)
        x, it, s, c = vjp_case(dev, g, y, B, log10_t)
        sub = torch.linspace(0, B - 1, min(B, VJP_SUBSET), device=dev).round().long().unique()
        gap = top_two_gap(x[sub], y, it[sub], s[sub])
        xsq_max, ysq_max, csq_max = (float((0.5 * (t * t).sum(1)).max()) for t in (x, y, c))
        ysq = 0.5 * (y * y).sum(1)
        for mode in modes:
            prep = sw.prepare_y(y, mode)
            mom = bz.boltzmann_moments(x, prep, it, s, values=y, mxu_precision=mode)

            def kernel(prep=prep, mom=mom, mode=mode):
                return bz.posterior_mean_vjp(x, prep, it, s, mom.log_z, mom.mean, c,
                                             values=y, mxu_precision=mode)

            def library(mom=mom):
                with full_fp32_matmul():
                    gm = torch.matmul(x, y.T)
                    u = torch.matmul(c, y.T)
                    cm = (c * mom.mean).sum(1)
                    h = (0.5 * (x * x).sum(1)[:, None] - s[:, None] * gm
                         + (s * s)[:, None] * ysq[None])
                    gz = mom.log_z[:, None] + h * it[:, None]
                    w = torch.exp(-gz) * (u - cm[:, None])
                    sums = (w.sum(1), (w * gz).sum(1),
                            (w * (2.0 * s[:, None] * ysq[None] - gm)).sum(1))
                    return torch.matmul(w, y), sums

            before = bz.posterior_mean_vjp.launches
            got = kernel()
            torch.cuda.synchronize()
            launched = bz.posterior_mean_vjp.launches - before
            same = all(torch.equal(a, b) for a, b in zip(got, kernel()))
            plan = bk.vjp_device_plan(bk.vjp_operands(x, prep, it, s, mom.log_z, mom.mean, c,
                                                      values=y, mode=mode))
            ref = bz.boltzmann_moments_reference(x[sub], y, it[sub], s[sub], compute_mean=True,
                                                 mxu_precision=mode)
            want = bz.posterior_mean_vjp_reference(x[sub], y, it[sub], s[sub], ref.log_z,
                                                   ref.mean, c[sub], mxu_precision=mode)
            steps = kernel_gram_steps(mode, D)
            delta = moments_logit_error(xsq_max, ysq_max, D, it[sub].cpu().numpy(),
                                        s[sub].cpu().numpy(), steps)
            eps_u = 2.0 * gram_rounding(2.0 * max(csq_max, ysq_max), D, steps)
            eps_g = gram_rounding(2.0 * max(xsq_max, ysq_max), D, steps)
            *tols, first_order = vjp_tolerance(x[sub], y, it[sub], s[sub], c[sub], mode,
                                               delta, gap, eps_u, eps_g)
            err, worst = 0.0, 0.0
            for a, b, t in zip(got, want, tols):
                diff = (a[sub].double() - b.double()).abs()
                err = max(err, float(diff.max()))
                worst = max(worst, float(torch.where(diff == 0, 0.0, diff / t).max()))
            finite = all(bool(torch.isfinite(t).all()) for t in got)
            ms, host_ms = time_ms(kernel, reps=3, inner=1)
            plain_ms = event_ms(lambda mom=mom, mode=mode: bz.posterior_mean_vjp_reference(
                x, y, it, s, mom.log_z, mom.mean, c, mxu_precision=mode), reps=1)[0]
            library_ms = time_ms(library, reps=3, inner=1)[0]
            b_ms, b_by = vjp_bound(B, N, D, mode)
            row = {"label": label, "shape": [B, N, D], "mode": mode, "launches": launched,
                   "max_abs_err": err, "worst_of_tolerance": worst, "bitwise_repeat": same,
                   "plan": plan._asdict(), "rows_checked": int(sub.numel()),
                   "rows_first_order": first_order,
                   "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
                   "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "tflops": 2 * B * N * D * (2 * SWEEP_PASSES[mode] + 1) / ms / 1e9}
            rows.append(row)
            want_launches = VJP_LAUNCHES[plan.path]
            ok = (launched == want_launches and len(plan.segments) == 1 and finite
                  and worst <= 1.0 and same)
            products = ("" if plan.path == "small" else
                        f", product {plan.product_chunks} chunks of "
                        f"{plan.product_per_chunk} sub-tiles, w^T "
                        f"{plan.workspace * 4 / 1e6:.1f} MB")
            log(f"moments VJP {label} B={B} N={N} D={D} {mode}: {plan.path}-D path, "
                f"{plan.tile_rows}-row blocks, {len(plan.segments)} segment(s), "
                f"{plan.n_chunks} chunks of {plan.per_chunk} sub-tiles{products}; launches "
                f"{launched} (want {want_launches}), "
                f"bitwise repeat {same}, max_abs_err {err:.3g} (worst {worst:.3g} of the "
                f"tolerance; {first_order} of {int(sub.numel())} rows within first order) "
                f"kernel_ms {ms:.4f} (host {host_ms:.4f}) plain_ms {plain_ms:.4f} library_ms "
                f"(three products, fp32) {library_ms:.4f} bound_ms {b_ms:.4f} ({b_by}) "
                f"{row['tflops']:.2f} TFLOP/s {'ok' if ok else 'MISMATCH'}")
            if not ok:
                fail(f"moments VJP kernel disagrees with its plain version (or launched "
                     f"{launched} kernels for {want_launches}, or two calls differ) at "
                     f"{label} {mode}")
            del prep, mom, got
            torch.cuda.empty_cache()
        del x, y, c
        torch.cuda.empty_cache()
    return rows


def card_kernel_share(run, names):
    """(wall ms, card busy ms, {group: card ms}) of ``run`` under
    torch.profiler: the kernels whose names contain each group's key."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy, groups = 0.0, {k: 0.0 for k in names}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            ms = e.device_time_total / 1e3
            busy += ms
            for key, sub in names.items():
                if sub in e.name:
                    groups[key] += ms
    return wall, busy, groups


def schedule_grads_card_vs_cpu(dev, weights) -> dict:
    """Phase 19b: the knot gradient of mean(x^2) through sample_with_grid
    on the card (kernels) against the CPU (plain versions), from the same
    x_init and noise: TrueDDPM on the 1-D GMM for every step type, then the
    fp32 flagship with remat."""
    import torch

    from pdm_tpu_torch.diffusion.sampling import STEP_TYPES, discretize_schedule
    from pdm_tpu_torch.diffusion.schedule_opt import sample_with_grid
    from pdm_tpu_torch.models.base import TrueDDPM
    from pdm_tpu_torch.models.unet import unet_from_config
    from pdm_tpu_torch.models.unet_ddpm import UNetDDPM
    from pdm_tpu_torch.schedulers.analytic import LinearBetaScheduler, LogSNRScheduler
    from pdm_tpu_torch.utils.synthetic import generate_gmm_1d

    def knot_grad(ddpm, grid, where, shape, step_type, x_init, noise, remat=False):
        lt = grid.to(where).clone().requires_grad_(True)
        x = sample_with_grid(ddpm, lt, None, shape, step_type, remat=remat,
                             x_init=torch.from_numpy(x_init),
                             noise=torch.from_numpy(noise))
        (gk,) = torch.autograd.grad(torch.mean(torch.square(x)), [lt])
        return x.detach().cpu(), gk.cpu()

    def check(label, outs, tol_x, tol_g):
        (x_c, g_c), (x_d, g_d) = outs["cpu"], outs["card"]
        ex = float((x_d - x_c).abs().max()) / float(x_c.abs().max())
        eg = float((g_d - g_c).abs().max()) / float(g_c.abs().max())
        ok = ex <= tol_x and eg <= tol_g and bool(torch.isfinite(g_d).all())
        log(f"schedule gradient {label}, card (kernels) vs CPU (plain): sample "
            f"{ex:.3g} of scale (tol {tol_x}), knot gradient {eg:.3g} of scale (tol "
            f"{tol_g}); gradient {[round(float(v), 6) for v in g_d]} "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"schedule gradient {label}: the card disagrees with the CPU")
        return {"sample_err_of_scale": ex, "grad_err_of_scale": eg}

    out = {}
    rng = np.random.RandomState(19)
    N, n_steps, B = GMM_GRAD
    data = generate_gmm_1d(N)
    sched = LogSNRScheduler(1e-4, 1e1)
    grid = discretize_schedule(sched, n_steps)
    shape = (B, 1, 1, 1)
    x_init = rng.standard_normal(shape).astype(np.float32)
    noise = rng.standard_normal((n_steps, *shape)).astype(np.float32)
    models = {"cpu": TrueDDPM(sched, data, device="cpu"), "card": TrueDDPM(sched, data, device=dev)}
    for step_type in STEP_TYPES:
        outs = {k: knot_grad(m, grid, m.device, shape, step_type, x_init, noise)
                for k, m in models.items()}
        out[f"gmm1d {step_type}"] = check(f"gmm1d {step_type} (N={N}, {n_steps} knots, "
                                          f"B={B})", outs, *GMM_GRAD_TOL)
    B, n_steps = UNET_GRAD
    sched = LinearBetaScheduler(1e-4, 2.478e4)
    grid = discretize_schedule(sched, n_steps)
    shape = (B, 3, 32, 32)
    x_init = rng.standard_normal(shape).astype(np.float32)
    noise = rng.standard_normal((n_steps, *shape)).astype(np.float32)
    outs = {}
    for key, where in (("cpu", torch.device("cpu")), ("card", dev)):
        net = unet_from_config(3, FLAGSHIP, dtype=torch.float32, device=where)
        net.load_state_dict(weights)
        ddpm = UNetDDPM(sched, net, parametrization="eps", device=where)
        outs[key] = knot_grad(ddpm, grid, where, shape, "ddpm", x_init, noise, remat=True)
        del ddpm, net
    out["flagship fp32"] = check(f"flagship fp32 DDPM, remat (B={B}, {n_steps} knots)",
                                 outs, FORWARD_TOL, UNET_GRAD_TOL)
    torch.cuda.empty_cache()
    return out


def schedule_cli_path(dev) -> dict:
    """Phase 19c: pdm_tpu_torch/scripts/optimize_schedule.py at JAX's
    constants, in this process through main() in a temporary working
    directory, the moments and VJP launch counters zeroed just before and
    read just after; the npz read back; JAX's criterion (CLI_EVAL) on the
    knots it wrote."""
    import torch

    from pdm_tpu_torch.diffusion.sampling import discretize_schedule
    from pdm_tpu_torch.diffusion.schedule_opt import sample_with_grid
    from pdm_tpu_torch.models.base import TrueDDPM
    from pdm_tpu_torch.ops import boltzmann as bz
    from pdm_tpu_torch.ops.mmd import mmd_rbf
    from pdm_tpu_torch.schedulers.analytic import LogSNRScheduler
    from pdm_tpu_torch.scripts import optimize_schedule as cli
    from pdm_tpu_torch.utils.synthetic import generate_gmm_1d

    cwd, work = os.getcwd(), tempfile.mkdtemp()
    try:
        os.chdir(work)
        bz.boltzmann_moments.launches = 0
        bz.posterior_mean_vjp.launches = 0
        t0 = time.perf_counter()
        out = cli.main(["--device", str(dev)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"moments": bz.boltzmann_moments.launches,
                    "vjp": bz.posterior_mean_vjp.launches}
        saved = np.load(os.path.join(work, cli.OUT))
        lt, history = saved["log_temp"], saved["history"]
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    # a step: row 7's partials and merge, row 7b on its small-D path
    want = {"moments": 2 * cli.N_STEPS * cli.N_ITERS,
            "vjp": VJP_LAUNCHES["small"] * cli.N_STEPS * cli.N_ITERS}
    lo, hi = math.log(cli.MIN_TEMP), math.log(cli.MAX_TEMP)
    n_eval, seeds, n_ref, sigma, ratio = CLI_EVAL
    data = generate_gmm_1d(cli.N_DATA)
    sched = LogSNRScheduler(cli.MIN_TEMP, cli.MAX_TEMP)
    ddpm = TrueDDPM(sched, data, device=dev)
    ref = torch.from_numpy(data[:n_ref].reshape(-1, 1)).to(dev)

    def eval_mmd(grid, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        with torch.no_grad():
            x = sample_with_grid(ddpm, torch.as_tensor(grid, device=dev), gen,
                                 (n_eval, 1, 1, 1))
            return float(mmd_rbf(x.reshape(-1, 1), ref, sigmas=(sigma,)))

    init = discretize_schedule(sched, cli.N_STEPS, device=dev)
    before = float(np.mean([eval_mmd(init, k) for k in range(seeds)]))
    after = float(np.mean([eval_mmd(lt, k) for k in range(seeds)]))
    ok = (launches == want and bool(np.isfinite(history).all())
          and len(history) == cli.N_ITERS and bool(np.all(np.diff(lt) >= 0))
          and lt.min() >= lo - 1e-6 and lt.max() <= hi + 1e-6
          and np.array_equal(lt, out["log_temp"]) and after <= ratio * before)
    log(f"schedule CLI: optimize_schedule main() ({cli.N_ITERS} iterations at batch "
        f"{cli.BATCH_SIZE}, {cli.N_STEPS} knots, {cli.STEP_TYPE}, N={cli.N_DATA:,}) in "
        f"{wall:.2f} s ({wall / cli.N_ITERS * 1e3:.3f} ms/iteration; before row 7b's "
        f"redesign {BEFORE_REDESIGN['cli_ms_per_iteration']} with row 7b "
        f"{BEFORE_REDESIGN['cli_row7b_ms']} ms a call); launches row 7 "
        f"{launches['moments']}, row 7b {launches['vjp']} (want {want['moments']} and "
        f"{want['vjp']}: two a step each); "
        f"MMD {history[0]:.6g} -> {history[-1]:.6g}; knots {np.round(lt, 4).tolist()}; "
        f"JAX's criterion over {seeds} seeds of {n_eval} samples: MMD {before:.6g} -> "
        f"{after:.6g} (<= {ratio} x) {'ok' if ok else 'FAILED'}")
    if not ok:
        fail("schedule CLI: launch counts, history, knots or the MMD criterion")
    del ddpm
    return {"wall_s": wall, "ms_per_iteration": wall / cli.N_ITERS * 1e3,
            "launches": launches, "mmd_before": before, "mmd_after": after,
            "history_first_last": [float(history[0]), float(history[-1])]}


def schedule_cifar_path(dev) -> dict:
    """Phase 19d: optimize_schedule through TrueDDPM at CIFAR-10 scale
    (CIFAR_OPT, DDIM, phase 11's scheduler): a warm iteration, then the
    counted run with the launch counters zeroed just before and read just
    after, then one iteration under the profiler (rows 7 and 7b's share of
    the card's time, the idle share)."""
    import torch

    from pdm_tpu_torch.diffusion.sampling import discretize_schedule
    from pdm_tpu_torch.diffusion.schedule_opt import optimize_schedule
    from pdm_tpu_torch.models.base import TrueDDPM
    from pdm_tpu_torch.ops import boltzmann as bz
    from pdm_tpu_torch.schedulers.analytic import LinearBetaScheduler

    N, n_steps, B, iters = CIFAR_OPT
    g = torch.Generator(device=dev).manual_seed(22)
    data = torch.randn(N, 3, 32, 32, generator=g, device=dev)
    sched = LinearBetaScheduler(1e-4, 2.478e4)
    ddpm = TrueDDPM(sched, data, device=dev)
    init = discretize_schedule(sched, n_steps, device=dev)
    clip = (math.log(1e-4), math.log(2.478e4))

    def run(n, seed):
        return optimize_schedule(ddpm, data, init, n_iters=n, batch_size=B,
                                 step_type="ddim", clip_range=clip, verbose=False,
                                 generator=torch.Generator(device=dev).manual_seed(seed),
                                 device=dev)

    run(1, 1)
    torch.cuda.synchronize()
    bz.boltzmann_moments.launches = 0
    bz.posterior_mean_vjp.launches = 0
    t0 = time.perf_counter()
    out = run(iters, 0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"moments": bz.boltzmann_moments.launches,
                "vjp": bz.posterior_mean_vjp.launches}
    # a step: row 7's partials and merge; row 7b's Grams, product and merge
    want = {"moments": 2 * n_steps * iters, "vjp": VJP_LAUNCHES["large"] * n_steps * iters}
    wall_p, busy, share = card_kernel_share(lambda: run(1, 2), {"row 7": "moments_",
                                                                "row 7b": "vjp_"})
    ms_iter = wall / iters * 1e3
    busy_of = max(busy, 1e-9)
    finite = bool(np.isfinite(out["log_temp"]).all() and np.isfinite(out["history"]).all())
    ok = launches == want and finite
    log(f"schedule at CIFAR-10 scale: TrueDDPM over {N:,} N(0, 1) points of 3x32x32, "
        f"{n_steps} knots, batch {B}, DDIM: {ms_iter:.2f} ms/iteration over {iters} "
        f"(before row 7b's redesign {BEFORE_REDESIGN['cifar_ms_per_iteration']}); "
        f"launches row 7 {launches['moments']}, row 7b {launches['vjp']} (want "
        f"{want['moments']} and {want['vjp']}); one profiled iteration {wall_p:.2f} ms "
        f"wall, card busy {busy:.2f} ms "
        f"(idle {max(0.0, 1.0 - busy / wall_p):.1%}): row 7 {share['row 7']:.2f} ms "
        f"({share['row 7'] / busy_of:.1%}), row 7b {share['row 7b']:.2f} ms "
        f"({share['row 7b'] / busy_of:.1%}; before its redesign "
        f"{BEFORE_REDESIGN['cifar_row7b_share']:.1%}); MMD {out['history'].tolist()} "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        fail("schedule at CIFAR-10 scale: launch counts or non-finite knots")
    del ddpm, data
    torch.cuda.empty_cache()
    return {"ms_per_iteration": ms_iter, "launches": launches,
            "card_busy_ms": busy, "wall_ms_profiled": wall_p,
            "idle_share": max(0.0, 1.0 - busy / wall_p),
            "row7_ms": share["row 7"], "row7b_ms": share["row 7b"]}


def schedule_unet_path(dev, weights) -> dict:
    """Phase 19e: optimize_schedule through the bf16 flagship (seeded
    weights, eval mode) with remat and LeNet-feature MMD (UNET_OPT), the
    launch counters of rows 1-4 zeroed just before and read just after."""
    import torch

    from pdm_tpu_torch.diffusion.sampling import discretize_schedule
    from pdm_tpu_torch.diffusion.schedule_opt import optimize_schedule
    from pdm_tpu_torch.models.lenet import LeNet, init_lenet
    from pdm_tpu_torch.models.unet import unet_from_config
    from pdm_tpu_torch.models.unet_ddpm import UNetDDPM
    from pdm_tpu_torch.ops import attention as attn_op
    from pdm_tpu_torch.ops import groupnorm as gn_op
    from pdm_tpu_torch.schedulers.analytic import LinearBetaScheduler

    o = UNET_OPT
    sched = LinearBetaScheduler(1e-4, 2.478e4)
    net = unet_from_config(3, FLAGSHIP, dtype=torch.bfloat16, device=dev)
    net.load_state_dict(weights)
    ddpm = UNetDDPM(sched, net, parametrization="eps", device=dev)
    lenet = init_lenet(LeNet(in_dim=3 * 32 * 32).to(dev),
                       torch.Generator(device=dev).manual_seed(LENET_SEED))
    g = torch.Generator(device=dev).manual_seed(23)
    data = torch.randn(o["n_data"], 3, 32, 32, generator=g, device=dev)
    init = discretize_schedule(sched, o["n_steps"], device=dev)
    counters = ((attn_op.fused_spatial_attention, "attention_fwd"),
                (attn_op.attention_bwd, "attention_bwd"),
                (gn_op.fused_group_norm_act, "group_norm_fwd"),
                (gn_op.group_norm_bwd, "group_norm_bwd"))
    # the counts at each iteration's first feature call (the generated
    # batch's, after its sampler forward and before its backward): two
    # consecutive ones are one iteration apart
    marks = []

    def features(x):
        marks.append({key: fn.launches for fn, key in counters})
        return lenet(x, features_only=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn, _ in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    out = optimize_schedule(
        ddpm, data, init, n_iters=o["n_iters"], batch_size=o["batch_size"],
        learning_rate=o["learning_rate"], step_type=o["step_type"], sigmas=o["sigmas"],
        clip_range=(math.log(1e-4), math.log(2.478e4)), feature_fn=features, remat=True,
        verbose=False, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = {key: fn.launches for fn, key in counters}
    # per iteration: every step's forward and its checkpoint recompute
    # (rows 1 and 3); the backward of every attention (row 2, two launches
    # each) and of every GroupNorm but the first step's first (its input,
    # conv_in of the fixed x_T, does not depend on the knots)
    n, it = o["n_steps"], o["n_iters"]
    per_iter = {"attention_fwd": 2 * n * 8, "attention_bwd": n * 8 * 2,
                "group_norm_fwd": 2 * n * 69, "group_norm_bwd": n * 69 - 1}
    gen_marks = marks[0::2]
    iters = [{k: b[k] - a[k] for k in per_iter} for a, b in zip(gen_marks, gen_marks[1:])]
    # the first iteration's forward and the last's backward make one more
    iters.append({k: gen_marks[0][k] + launches[k] - gen_marks[-1][k] for k in per_iter})
    lt = out["log_temp"]
    ok = (len(gen_marks) == it and all(c == per_iter for c in iters)
          and bool(np.isfinite(lt).all()) and bool(np.isfinite(out["history"]).all())
          and bool(np.all(np.diff(lt) >= 0)))
    log(f"schedule through the bf16 flagship: {it} iterations (cut from 200), "
        f"{n} knots, batch {o['batch_size']}, {o['step_type']}, remat, LeNet features: "
        f"{wall / it * 1e3:.1f} ms/iteration, peak {peak:.2f} GB; launches {launches}, "
        f"each iteration {iters} (want {per_iter}); knots {np.round(lt, 4).tolist()}; "
        f"MMD {np.round(out['history'], 6).tolist()} {'ok' if ok else 'FAILED'}")
    if not ok:
        fail("schedule through the flagship: launch counts or non-finite knots")
    del ddpm, net, lenet, data
    torch.cuda.empty_cache()
    return {"ms_per_iteration": wall / it * 1e3, "peak_gb": peak, "launches": launches,
            "iterations": it}


def schedule_opt_phase(time_ms, dev, weights) -> dict:
    """Phase 19: schedule optimization through the sampler (19a-19e)."""
    t0 = time.perf_counter()
    out = {"vjp_rows": vjp_kernel_rows(time_ms, dev)}
    out["grads"] = schedule_grads_card_vs_cpu(dev, weights)
    out["cli"] = schedule_cli_path(dev)
    out["cifar"] = schedule_cifar_path(dev)
    out["unet"] = schedule_unet_path(dev, weights)
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 19 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------
# phase 20: the data axis (parallel/) on one card
# ---------------------------------------------------------------------


def _rel_to_bound(got, want, eps_n, n):
    """The largest |got - want| as a fraction of the regrouped-sum bound
    eps_n (|want| + 1 + log N) (STREAM_EPS: the sums over N grouped per
    rank, then merged)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / (eps_n * (np.abs(want) + 1.0
                                                       + math.log(n)))))


def turns(run_plain, run_mesh, pairs: int = SCALE_OUT_PAIRS):
    """Host ms of each path (ending in a synchronize): one warm call each,
    then ``pairs`` times plain, mesh, mesh, plain; medians."""
    import torch

    ms = {run_plain: [], run_mesh: []}
    for fn in (run_plain, run_mesh):
        fn()
    for _ in range(pairs):
        for fn in (run_plain, run_mesh, run_mesh, run_plain):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms[fn].append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms[run_plain]), statistics.median(ms[run_mesh])


def counted(fn, counters):
    """``fn()`` with the launch counters zeroed just before and read just
    after: (its result, the launches)."""
    for c in counters:
        c.launches = 0
    out = fn()
    return out, [c.launches for c in counters]


def sweep_mesh_check(data, mesh, dev, label) -> dict:
    """thermo_sweep at phase 9's shape with and without ``mesh`` on the
    same generator's draws, in turns; a counted mesh sweep against the
    sweep without one, within the regrouped-sum bound."""
    import torch

    from pdm_tpu_torch.ops import boltzmann_sweep as sw
    from pdm_tpu_torch.stats.sweep import thermo_sweep

    _, B, N, _, nt, (t_lo, t_hi) = SWEEP_MAIN
    temps = np.logspace(t_lo, t_hi, nt)

    def run(m):
        return lambda: thermo_sweep(
            data, temps, B, B, regularize=True, mesh=m,
            generator=torch.Generator(device=dev).manual_seed(0), device=dev)

    plain_ms, mesh_ms = turns(run(None), run(mesh))
    got, (launches,) = counted(run(mesh), [sw.boltzmann_sweep])
    want = run(None)()
    eps_n = STREAM_EPS * math.sqrt(N)
    worst = {k: _rel_to_bound(got[k], want[k], eps_n, N)
             for k in ("entropy", "free_energy", "heat_capacity", "metric")}
    log(f"{label}: thermo_sweep(mesh=) fp32 B={B} N={N} {nt} temperatures: "
        f"{mesh_ms:.3f} ms against {plain_ms:.3f} ms without a mesh (medians of "
        f"{2 * SCALE_OUT_PAIRS} turns each); sweep launches {launches} on this "
        f"rank; worst of the regrouped-sum bound "
        f"{{{', '.join(f'{k}: {v:.3g}' for k, v in worst.items())}}}")
    if max(worst.values()) > 1.0 or launches != 2:
        fail(f"{label}: thermo_sweep(mesh=) disagrees with one process or "
             f"launched {launches} sweeps")
    return {"ms": mesh_ms, "plain_ms": plain_ms, "launches": launches,
            "worst": max(worst.values())}


def sampler_mesh_check(ddpm, sched, mesh, dev, label, B) -> dict:
    """TrueDDPM DDIM-10 at batch B through sharded_sampler against the
    sampler without a mesh from the same generator, in turns: row 7 on
    this rank's rows over the whole dataset, two launches a step."""
    import torch

    from pdm_tpu_torch.diffusion.sampling import DDPMSampler
    from pdm_tpu_torch.ops import boltzmann as bz
    from pdm_tpu_torch.parallel import sharded_sampler

    sampler = DDPMSampler(ddpm=ddpm, scheduler=sched, n_steps=TRUE_STEPS,
                          obj_size=(3, 32, 32), batch_size=B, n_samples=B,
                          step_type="ddim", device=dev)
    sharded = sharded_sampler(sampler, mesh)

    def run(s):
        return lambda: s.batch_sample(torch.Generator(device=dev).manual_seed(0))["x"]

    plain_ms, mesh_ms = turns(run(sampler), run(sharded))
    got, (launches,) = counted(run(sharded), [bz.boltzmann_moments])
    want = run(sampler)()
    # each step's posterior mean regroups the kernel's sums over N at the
    # rank's batch: STREAM_EPS sqrt(N) of the data's scale a step
    scale = float(ddpm.train_data.abs().max())
    tol = TRUE_STEPS * STREAM_EPS * math.sqrt(ddpm.train_data.shape[0]) * (scale + 1.0)
    err = float((got - want).abs().max())
    log(f"{label}: TrueDDPM DDIM-{TRUE_STEPS} at batch {B} through sharded_sampler "
        f"({B // mesh.data_size} rows a rank): {mesh_ms / TRUE_STEPS:.3f} ms/step "
        f"against {plain_ms / TRUE_STEPS:.3f} without a mesh (turns); moments "
        f"launches {launches} on this rank; max |diff| {err:.3g} (tol {tol:.3g})")
    if not (err <= tol) or launches != 2 * TRUE_STEPS:
        fail(f"{label}: data-parallel sampler disagrees or launched {launches}")
    return {"ms": mesh_ms / TRUE_STEPS, "plain_ms": plain_ms / TRUE_STEPS,
            "launches": launches, "err": err}


TRAIN_COUNTERS = (("attention_fwd", "attention", "fused_spatial_attention"),
                  ("attention_bwd", "attention", "attention_bwd"),
                  ("group_norm_fwd", "groupnorm", "fused_group_norm_act"),
                  ("group_norm_bwd", "groupnorm", "group_norm_bwd"))


def _counter(module, fn):
    import importlib

    return getattr(importlib.import_module(f"pdm_tpu_torch.ops.{module}"), fn)


def bf16_train_mesh(weights, sched, mesh, dev, label, batch, steps) -> dict:
    """The bf16 flagship's data-parallel train step at global ``batch``
    beside the same step without a mesh (another trainer, in turns of
    ``steps`` steps); then ``steps`` counted steps: launch counts exact on
    this rank, the step's byte bill, and its all-reduce alone by CUDA
    events beside the NVLink projection."""
    import torch

    from pdm_tpu_torch.diffusion.trainer import DDPMTrainer, step_generator
    from pdm_tpu_torch.models.unet import unet_from_config
    from pdm_tpu_torch.models.unet_ddpm import UNetDDPM
    from pdm_tpu_torch.parallel.collectives import H100_NVLINK_BW, project_step
    from pdm_tpu_torch.parallel.mesh import batch_sharding

    x = torch.from_numpy(np.random.RandomState(2).standard_normal(
        (batch, 3, 32, 32)).astype(np.float32)).to(dev)
    runs = []
    for m in (None, mesh):
        net = unet_from_config(3, FLAGSHIP, dtype=torch.bfloat16, device=dev)
        trainer = DDPMTrainer(UNetDDPM(sched, net, parametrization="eps", device=dev),
                              learning_rate=1e-4, warmup_steps=10, total_iters=1000,
                              grad_clip=1.0, ema_decay=0.9999)
        state = trainer.init_state(weights, m)
        xs = x if m is None else x[batch_sharding(m).rows(batch)]
        it = iter(range(1, 1_000_000))

        def run(trainer=trainer, state=state, xs=xs, it=it):
            for _ in range(steps):
                _, metrics = trainer.train_step(state, xs,
                                                step_generator(0, next(it), dev))
            return metrics

        runs.append(run)
    plain_ms, mesh_ms = turns(*runs)
    mesh.stats.reset()
    m, launches = counted(runs[1], [_counter(mod, fn) for _, mod, fn in TRAIN_COUNTERS])
    launches = {key: n for (key, _, _), n in zip(TRAIN_COUNTERS, launches)}
    bill = {k: mesh.stats[k] // steps for k in mesh.stats.bytes_by_kind}
    calls = {k: mesh.stats.counts(k) / steps for k in mesh.stats.count_by_kind}
    # the step's all-reduce alone: one flat fp32 buffer of the bill's size
    flat = torch.zeros(bill.get("all-reduce", 4) // 4, device=dev)
    mesh.all_reduce(flat)
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(5):
        mesh.all_reduce(flat)
    b.record()
    torch.cuda.synchronize()
    ar_ms = a.elapsed_time(b) / 5
    one = type(mesh.stats)()
    for k, v in bill.items():
        one.add(k, v)
    proj = {n: project_step(one, n, H100_NVLINK_BW)["total"] * 1e3 for n in (2, 4, 8)}
    log(f"{label}: bf16 flagship train step, global batch {batch} "
        f"({batch // mesh.data_size} a rank): {mesh_ms / steps:.3f} ms/step against "
        f"{plain_ms / steps:.3f} without a mesh (turns of {steps} steps); launches "
        f"a step {({k: v / steps for k, v in launches.items()})}; loss "
        f"{float(m['loss']):.5g}; collective bill a step {bill} bytes in "
        f"{calls} calls; the step's all-reduce alone {ar_ms:.3f} ms (CUDA events, "
        f"{mesh.data_size} rank(s) on this card); projected over NVLink "
        f"(H100 SXM data sheet, 450 GB/s a direction) on 2/4/8 cards "
        f"{({n: round(v, 4) for n, v in proj.items()})} ms")
    want = {k: v * steps for k, v in TRAIN_LAUNCHES.items()}
    if launches != want or not math.isfinite(float(m["loss"])):
        fail(f"{label}: train-step launches {launches} != {want} or loss not finite")
    n_params = sum(t.numel() for t in net.parameters())
    if bill.get("all-reduce") != 4 * (n_params + 1) or calls.get("all-reduce") != 1:
        fail(f"{label}: the step's all-reduce {bill} is not one of the "
             f"{n_params} fp32 gradients and the loss")
    return {"ms": mesh_ms / steps, "plain_ms": plain_ms / steps,
            "launches": launches, "bill": bill, "all_reduce_ms": ar_ms,
            "projected_ms": proj}


def fp32_step_pair(weights, sched, dev, x, mesh, fsdp, lr=1e-4):
    """One fp32 flagship train step (dropout 0.2, the step generator's
    draws) on ``x`` (this rank's rows) with the applied gradients, the
    whole params after it and the trainer's state."""
    import torch

    from pdm_tpu_torch.diffusion.trainer import DDPMTrainer, _gather, step_generator
    from pdm_tpu_torch.models.unet import unet_from_config
    from pdm_tpu_torch.models.unet_ddpm import UNetDDPM

    net = unet_from_config(3, FLAGSHIP, dtype=torch.float32, device=dev)
    tr = DDPMTrainer(UNetDDPM(sched, net, device=dev), learning_rate=lr,
                     warmup_steps=0, grad_clip=1e9, ema_decay=0.9999, fsdp=fsdp)
    st = tr.init_state(weights, mesh)
    st, m, grads = train_step_with_grads(tr, st, x,
                                         generator=step_generator(0, 1, dev))
    params = {k: v.cpu() for k, v in _gather(st, st.params).items()}
    return float(m["loss"]), grads, params, st


def scale_out_child(rank: int, tmp: str) -> None:
    """Phase 20b on one rank of two sharing the card under gloo (NCCL
    refuses two ranks on one device): rows 7 and 8 on half the dataset,
    the data-parallel sampler and train steps, FSDP; rank 0 also runs each
    case without a mesh and holds the mesh against it."""
    import torch
    import torch.distributed as dist

    from pdm_tpu_torch.models.base import TrueDDPM
    from pdm_tpu_torch.models.unet import unet_from_config
    from pdm_tpu_torch.ops import boltzmann as bz
    from pdm_tpu_torch.parallel import make_mesh
    from pdm_tpu_torch.parallel.mesh import batch_sharding
    from pdm_tpu_torch.schedulers.analytic import LinearBetaScheduler

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    label = f"scale-out rank {rank}/2 (gloo)"
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv2", rank=rank,
                            world_size=2, timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_mesh(data=2)
        res = {"rank": rank}
        _, B, N, D, _ = MOMENTS_MAIN
        data = torch.randn(N, 3, 32, 32, generator=torch.Generator(
            device=dev).manual_seed(5), device=dev)
        res["sweep"] = sweep_mesh_check(data, mesh, dev, label)
        # row 7 on each half of the dataset, merged across the ranks
        g = torch.Generator(device=dev).manual_seed(6)
        q = torch.randn(B, D, generator=g, device=dev)
        it = torch.full((B,), 1.0 / 300.0, device=dev)
        half = data.reshape(N, D)[batch_sharding(mesh).rows(N)]
        merged = bz.boltzmann_moments_shard_body(q, half, it, mesh=mesh,
                                                 compute_mean=True)
        whole = bz.boltzmann_moments(q, data.reshape(N, D), it, compute_mean=True)
        eps_n = STREAM_EPS * math.sqrt(N)
        worst = max(_rel_to_bound(getattr(merged, f).cpu(), getattr(whole, f).cpu(),
                                  eps_n, N) for f in ("log_z", "e1_hat", "e2_hat"))
        scale = float(data.abs().max())
        mean_err = float((merged.mean - whole.mean).abs().max())
        log(f"{label}: boltzmann_moments_shard_body B={B} over half of N={N} "
            f"D={D} each, merged: worst of the regrouped-sum bound {worst:.3g}; "
            f"mean max |diff| {mean_err:.3g} (tol {eps_n * (scale + 1):.3g})")
        if worst > 1.0 or mean_err > eps_n * (scale + 1):
            fail(f"{label}: the moments' shard merge disagrees with one call")
        res["moments_worst"] = worst
        sched = LinearBetaScheduler(1e-4, 2.478e4)
        ddpm = TrueDDPM(sched, data, device=dev)
        res["sampler"] = sampler_mesh_check(ddpm, sched, mesh, dev, label, B)
        del ddpm, data, half, merged, whole, q
        torch.cuda.empty_cache()

        cpu_net = unet_from_config(3, FLAGSHIP, dtype=torch.float32, device="cpu")
        weights = seeded_state_dict(cpu_net)
        del cpu_net
        x2 = torch.from_numpy(np.random.RandomState(6).standard_normal(
            (2, 3, 32, 32)).astype(np.float32)).to(dev)
        mine = x2[batch_sharding(mesh).rows(2)]
        dp = fp32_step_pair(weights, sched, dev, mine, mesh, False)
        fs = fp32_step_pair(weights, sched, dev, mine, mesh, True)
        st = fs[3]
        held = sum(t.numel() for t in st.params.values())
        ema = sum(t.numel() for t in st.ema_params.values())
        moments = sum(s[k].numel() for s in st.optimizer.state.values()
                      for k in ("exp_avg", "exp_avg_sq"))
        whole_n = sum(t.numel() for t in dp[2].values())
        left = sum(st.params[n].numel() for n, spec in st.shard_specs.items()
                   if "data" not in spec)
        # the card's default backward is not deterministic (phase 6), so
        # the two steps' gradients differ by rounding; Adam's first step
        # moves an element by up to what that allows
        fs_err = max(float((fs[2][k] - dp[2][k]).abs().max()) for k in dp[2])
        fs_excess = max(float(((fs[2][k] - dp[2][k]).abs()
                               - adam_first_step_bound(fs[1][k], dp[1][k], 1e-4)
                               - 1e-7).max()) for k in dp[2])
        log(f"{label}: FSDP holds {held} of {whole_n} master values "
            f"({held / whole_n:.4f}), EMA {ema}, Adam moments {moments} (whole "
            f"{2 * whole_n}); {left} values in leaves no dimension of which 2 "
            f"divides; {4 * (held + ema + moments) / 2**20:.1f} MiB of fp32 state "
            f"against {16 * whole_n / 2**20:.1f} MiB; its step against the "
            f"data-parallel step: loss {fs[0]:.7g} vs {dp[0]:.7g}, params max "
            f"|diff| {fs_err:.3g}, within the bound the two steps' gradients "
            f"allow (worst excess {fs_excess:.3g})")
        if not (held <= whole_n / 2 + left and ema == held and moments == 2 * held):
            fail(f"{label}: FSDP holds more than half the state")
        if fs_excess > 0 or abs(fs[0] - dp[0]) > TRAIN_TOL["loss"] * abs(dp[0]):
            fail(f"{label}: the FSDP step differs from the data-parallel step")
        res["fsdp"] = {"held": held, "whole": whole_n, "left": left, "err": fs_err,
                       "excess": fs_excess}
        if rank == 0:
            one = fp32_step_pair(weights, sched, dev, x2, None, False)
            loss_err = abs(dp[0] - one[0]) / abs(one[0])
            worst_excess = max(float(((dp[2][k] - one[2][k]).abs()
                                      - adam_first_step_bound(dp[1][k], one[1][k], 1e-4)
                                      - 1e-7).max()) for k in one[2])
            top = max(float(v.abs().max()) for v in one[1].values())
            worst_grad = max(float((dp[1][k] - g1).abs().max())
                             / (TRAIN_TOL["grad"] * float(g1.abs().max())
                                + TRAIN_TOL["grad_floor"] * top)
                             for k, g1 in one[1].items())
            log(f"{label}: fp32 flagship train step, batch 2 (1 a rank), dropout "
                f"0.2, against one process: loss {dp[0]:.7g} vs {one[0]:.7g} (rel "
                f"{loss_err:.3g}, tol {TRAIN_TOL['loss']}); worst gradient "
                f"{worst_grad:.3g} of its tolerance; params after Adam within the "
                f"bound the gradients allow, worst excess {worst_excess:.3g}")
            if loss_err > TRAIN_TOL["loss"] or worst_grad > 1.0 or worst_excess > 0:
                fail(f"{label}: the data-parallel fp32 step disagrees with one process")
            res["fp32_step"] = {"loss_err": loss_err, "grad": worst_grad}
        del dp, fs, st
        torch.cuda.empty_cache()
        res["train"] = bf16_train_mesh(weights, sched, mesh, dev, label,
                                       TRAIN_BATCH, SCALE_OUT_STEPS)
        with open(os.path.join(tmp, f"child{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def scale_out_phase(dev, weights, smi) -> dict:
    """Phase 20: (a) one rank under NCCL through each mesh path, (b) two
    ranks sharing the card under gloo (scale_out_child)."""
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from pdm_tpu_torch.models.base import TrueDDPM
    from pdm_tpu_torch.parallel import initialize_multihost, make_mesh
    from pdm_tpu_torch.schedulers.analytic import LinearBetaScheduler
    from pdm_tpu_torch.utils.fid import feature_statistics

    out = {}
    tmp = tempfile.mkdtemp()
    try:
        # (a) one rank under NCCL, started as every CLI starts it: through
        # initialize_multihost with torchrun's LOCAL_RANK, which picks the
        # backend and sets the rank's card before any device is resolved
        label = "scale-out (a), 1 rank (nccl)"
        local = os.environ.get("LOCAL_RANK")
        os.environ["LOCAL_RANK"] = str(dev.index)
        try:
            initialize_multihost(f"file://{tmp}/rdv1", 1, 0, timeout_s=300)
        finally:
            if local is None:
                os.environ.pop("LOCAL_RANK")
            else:
                os.environ["LOCAL_RANK"] = local
        try:
            backend, current = dist.get_backend(), torch.cuda.current_device()
            if backend != "nccl" or current != dev.index:
                fail(f"{label}: initialize_multihost started {backend} on card "
                     f"{current}, not nccl on card {dev.index}")
            mesh = make_mesh(data=1)
            log(f"{label}: {mesh} over {backend} on card {current} "
                f"(initialize_multihost); {smi}")
            _, B, N, D, _ = MOMENTS_MAIN
            data = torch.randn(N, 3, 32, 32, generator=torch.Generator(
                device=dev).manual_seed(5), device=dev)
            out["sweep"] = sweep_mesh_check(data, mesh, dev, label)
            sched = LinearBetaScheduler(1e-4, 2.478e4)
            ddpm = TrueDDPM(sched, data, device=dev)
            out["sampler"] = sampler_mesh_check(ddpm, sched, mesh, dev, label, B)
            # FID's feature statistics: a fixed projection of 5,000 images
            proj = torch.randn(D, 2048, generator=torch.Generator(
                device=dev).manual_seed(7), device=dev) / math.sqrt(D)

            def feats(x):
                return x.reshape(x.shape[0], -1).float() @ proj

            def fid_stats(m):
                return lambda: feature_statistics(data[:5000], feats, 2048,
                                                  batch_size=500, device=dev, mesh=m)

            plain_ms, mesh_ms = turns(fid_stats(None), fid_stats(mesh))
            got, want = fid_stats(mesh)(), fid_stats(None)()
            mu_err = float((got[0] - want[0]).abs().max())
            sg_err, ok = compare_to_scale(got[1], want[1], 1e-4, 1e-5)
            log(f"{label}: feature_statistics(mesh=) over 5,000 images, 2048 "
                f"features, batch 500: {mesh_ms:.3f} ms against {plain_ms:.3f} "
                f"(turns); mean max |diff| {mu_err:.3g}, covariance {sg_err:.3g} "
                f"(tol 1e-4 rel + 1e-5 of scale)")
            if not ok or mu_err > 1e-5:
                fail(f"{label}: feature_statistics(mesh=) disagrees")
            del ddpm, data, proj
            torch.cuda.empty_cache()
            out["train"] = bf16_train_mesh(weights, sched, mesh, dev, label,
                                           TRAIN_BATCH, SCALE_OUT_STEPS)
        finally:
            dist.destroy_process_group()

        # (b) two ranks on the one card under gloo
        t0 = time.perf_counter()
        ctx = mp.start_processes(scale_out_child, args=(tmp,), nprocs=2,
                                 join=False, start_method="spawn")
        deadline = time.monotonic() + SCALE_OUT_TIMEOUT_S
        try:
            while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
                if time.monotonic() > deadline:
                    fail(f"scale-out (b): the two ranks outlived {SCALE_OUT_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        kids = [json.load(open(os.path.join(tmp, f"child{r}.json"))) for r in range(2)]
        log(f"scale-out (b): two ranks on one card under gloo passed in "
            f"{time.perf_counter() - t0:.1f} s")
        out["two_ranks"] = kids
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# ---------------------------------------------------------------------
# phase 21: the model axis (tensor and spatial parallelism) and rows 3s/4s
# ---------------------------------------------------------------------

# rows 3s and 4s: the split pair against rows 3 and 4 on the whole image,
# (B, S, C, R): the flagship's first level (B 64, S 1024) cut into R row
# pieces, and the first level of a 256 x 256 image split in two (B 8,
# S 65536: the high-resolution case, bf16 only); G 32
SPLIT_GN_CASES = ((64, 1024, 128, 2), (64, 1024, 128, 4), (64, 1024, 256, 2),
                  (64, 1024, 256, 4), (8, 65536, 128, 2))
SPLIT_GN_HIGHRES = (8, 65536, 128, 2)
SPLIT_GN_G = 32
SPLIT_GN_HEAD = (64, 1024)  # the one-rank comparison's B, S (C 128)
# The previous design's kernels (row 3's cluster plan, streaming) on one
# piece, bf16, B 64, S 512 of 1024, as this phase measured them on an
# NVIDIA H100 80GB HBM3 at 700 W; printed beside this run's as "was":
# (C, kernel) -> ms. The high-resolution case was not measured then.
SPLIT_GN_WAS = {(128, "stats"): 0.0076, (128, "apply"): 0.0090,
                (128, "bwd_stats"): 0.0204, (128, "bwd_apply"): 0.0155,
                (256, "stats"): 0.0094, (256, "apply"): 0.0154,
                (256, "bwd_stats"): 0.0316, (256, "bwd_apply"): 0.0299}
# launches a call puts on the card (card_launches), and the previous
# design's: its 4s statistics added the images' dgamma/dbeta in a second
# launch
SPLIT_GN_LAUNCHES = {"stats": 1, "apply": 1, "bwd_stats": 1, "bwd_apply": 1}
SPLIT_GN_WAS_LAUNCHES = {"stats": 1, "apply": 1, "bwd_stats": 2, "bwd_apply": 1}
# operations per element (fp32): 3s statistics 3 (an add, an fma); the
# normalise 3, the SiLU 4 more; 4s statistics 4 (n_hat 2, the partials 2),
# the SiLU's VJP 10 more; dx 7 (n_hat 2, dn 1, dx 4), the SiLU's VJP 10 more
SPLIT_GN_OPS = {"stats": {"silu": 3, "none": 3}, "apply": {"silu": 7, "none": 3},
                "bwd_stats": {"silu": 14, "none": 4},
                "bwd_apply": {"silu": 17, "none": 7}}
# the model-parallel bf16 flagship against one process on the card, of the
# output's scale: two bf16 computations of the same network that round at
# other places (narrower convs choose other cuDNN algorithms; row 3s sums in
# another grouping); fp32: FORWARD_TOL
MP_BF16_TOL = 2e-2
MP_STEP_BATCH = 2      # the fp32 train steps held against one process
MP_BF16_BATCH = 8      # the bf16 train steps counted and timed
MP_DDIM_STEPS = 5      # the spatial sampler against the unsharded one
MP_TIMEOUT_S = 400
# phase 21(c): the spatial sampler on an image whose rows the model axis
# does not divide: the tiny UNet (the CPU tests' TINY) at 18 x 18 over a
# 1 x 4 mesh (its downsample needs an even height, so 2 ranks cannot show
# the case), fp32 DDIM-3 at batch 4
UNEVEN_RANKS, UNEVEN_SIZE, UNEVEN_STEPS, UNEVEN_BATCH = 4, 18, 3, 4
TINY_UNET = {"block_out_channels": [16, 32],
             "down_block_types": ["DownBlock2D", "AttnDownBlock2D"],
             "up_block_types": ["AttnUpBlock2D", "UpBlock2D"],
             "layers_per_block": 1, "attention_head_dim": 16, "norm_groups": 4,
             "dropout": 0.0}
SPLIT_COUNTERS = (("group_norm_stats", "groupnorm", "group_norm_stats"),
                  ("group_norm_apply", "groupnorm", "group_norm_apply"),
                  ("group_norm_bwd_stats", "groupnorm", "group_norm_bwd_stats"),
                  ("group_norm_bwd_apply", "groupnorm", "group_norm_bwd_apply"))


def split_gn_pieces(x, dy, scale, bias, G, R, eps, act):
    """Rows 3s and 4s over R row pieces of (B, S, C) x, each piece's sums
    added in piece order as the all-reduce adds them: (y, dx, dscale,
    dbias) of the whole image, and the sums (forward, backward)."""
    import torch

    from pdm_tpu_torch.ops import groupnorm as gn_op

    xs, ds = x.chunk(R, dim=1), dy.chunk(R, dim=1)
    xs, ds = [t.contiguous() for t in xs], [t.contiguous() for t in ds]
    n = float(x.shape[1]) * float(x.shape[2] // G)
    sums = gn_op.group_norm_stats(xs[0], G)
    for piece in xs[1:]:
        sums = sums + gn_op.group_norm_stats(piece, G)
    y = torch.cat([gn_op.group_norm_apply(p, scale, bias, sums, G, n, eps, act)
                   for p in xs], dim=1)
    parts = [gn_op.group_norm_bwd_stats(p, d, scale, bias, sums, G, n, eps, act)
             for p, d in zip(xs, ds)]
    gsums = parts[0][0]
    dscale, dbias = parts[0][1], parts[0][2]
    for g, a, b in parts[1:]:
        gsums, dscale, dbias = gsums + g, dscale + a, dbias + b
    dx = torch.cat([gn_op.group_norm_bwd_apply(p, d, scale, bias, sums, gsums,
                                               G, n, eps, act)
                    for p, d in zip(xs, ds)], dim=1)
    return y, dx, dscale, dbias, sums, gsums


def card_launches(fn) -> int:
    """The launches one call of ``fn`` makes on the card (after a warm
    call): the port's GroupNorm kernels (their wrappers' counters) and the
    PyTorch operators run beside them (a dispatch mode's count;
    allocations and views, which launch nothing, left out)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from pdm_tpu_torch.ops import groupnorm as gn_op

    kernels = (gn_op.fused_group_norm_act, gn_op.group_norm_bwd, gn_op.group_norm_stats,
               gn_op.group_norm_apply, gn_op.group_norm_bwd_stats,
               gn_op.group_norm_bwd_apply)

    class Ops(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not (getattr(func, "is_view", False)
                    or func._overloadpacket.__name__.startswith("empty")):
                Ops.n += 1
            return func(*args, **(kwargs or {}))

    fn()
    before = [k.launches for k in kernels]
    with Ops():
        fn()
    return Ops.n + sum(k.launches - b for k, b in zip(kernels, before))


def split_gn_phase(time_ms, dev) -> dict:
    """Phase 21(a): rows 3s and 4s against their plain versions, and the
    split pair against rows 3 and 4 on the whole image, at SPLIT_GN_CASES
    in bf16 and (but the high-resolution case) fp32 with the SiLU; each
    launch called twice on one piece (bitwise equal), its card launches
    counted (card_launches), and timed (L2 warm, and cold: copies of its
    inputs in turn) beside the previous design's time, its bound, its plain version
    and a library call; the pair at one rank
    against row 3 (4) on the same shape."""
    import torch
    import torch.nn.functional as F

    from pdm_tpu_torch.ops import groupnorm as gn_op

    G = SPLIT_GN_G
    eps, act = 1e-6, "silu"
    rows, pair_rows = [], []
    g = torch.Generator(device=dev).manual_seed(21)
    for dname in ("bfloat16", "float32"):
        dtype = getattr(torch, dname)
        for B, S, C, R in SPLIT_GN_CASES:
            if dname == "float32" and (B, S, C, R) == SPLIT_GN_HIGHRES:
                continue
            x = torch.randn(B, S, C, generator=g, device=dev).to(dtype)
            dy = torch.randn(B, S, C, generator=g, device=dev).to(dtype)
            scale = 1.0 + 0.1 * torch.randn(C, generator=g, device=dev)
            bias = 0.1 * torch.randn(C, generator=g, device=dev)
            y, dx, dsc, dbi, sums, gsums = split_gn_pieces(x, dy, scale, bias, G, R,
                                                           eps, act)
            y3 = gn_op.fused_group_norm_act(x, scale, bias, G, eps, act)
            dx4, dsc4, dbi4 = gn_op.group_norm_bwd(x, scale, bias, dy, G, eps, act)
            torch.cuda.synchronize()
            err_y, ok_y, _, _ = compare(y, y3, dname)
            rt, at = BWD_TOL[dname]
            err_dx, ok_dx = compare_to_scale(dx, dx4, rt, at)
            err_p = max(compare_to_scale(a, b, *PARAM_GRAD_TOL)[0]
                        for a, b in ((dsc, dsc4), (dbi, dbi4)))
            ok_p = all(compare_to_scale(a, b, *PARAM_GRAD_TOL)[1]
                       for a, b in ((dsc, dsc4), (dbi, dbi4)))
            del y, dx, y3, dx4
            # each kernel against its plain version on the first piece
            piece = x.chunk(R, dim=1)[0].contiguous()
            dpiece = dy.chunk(R, dim=1)[0].contiguous()
            del x, dy
            n = float(S) * float(C // G)
            ks = {
                "stats": (lambda p, d: (gn_op.group_norm_stats(p, G),),
                          lambda p, d: (gn_op.group_norm_stats_reference(p, G),)),
                "apply": (lambda p, d: (gn_op.group_norm_apply(p, scale, bias, sums, G,
                                                               n, eps, act),),
                          lambda p, d: (gn_op.group_norm_apply_reference(
                              p, scale, bias, sums, G, n, eps, act),)),
                "bwd_stats": (lambda p, d: gn_op.group_norm_bwd_stats(
                                  p, d, scale, bias, sums, G, n, eps, act),
                              lambda p, d: gn_op.group_norm_bwd_stats_reference(
                                  p, d, scale, bias, sums, G, n, eps, act)),
                "bwd_apply": (lambda p, d: (gn_op.group_norm_bwd_apply(
                                  p, d, scale, bias, sums, gsums, G, n, eps,
                                  act),),
                              lambda p, d: (gn_op.group_norm_bwd_apply_reference(
                                  p, d, scale, bias, sums, gsums, G, n,
                                  eps, act),)),
            }
            timed = dname == "bfloat16" or R == 2
            side = int(round(math.sqrt(S)))
            x4 = piece.view(B, S // R // side, side, C).permute(0, 3, 1, 2)
            xg = piece.view(B, S // R, G, C // G)
            xf = x4.detach().clone().requires_grad_(True)
            yf = F.silu(F.group_norm(xf, G, scale.to(dtype), bias.to(dtype), eps))
            d4 = dpiece.view(B, S // R // side, side, C).permute(0, 3, 1, 2)
            library = {"stats": lambda: torch.var_mean(xg, dim=(1, 3)),
                       "apply": None, "bwd_stats": None,
                       "bwd_apply": lambda: torch.autograd.grad(yf, xf, d4,
                                                                retain_graph=True)}
            esz = piece.element_size()
            io = {"stats": piece.numel() * esz + B * G * 8,
                  "apply": 2 * piece.numel() * esz + B * G * 8 + 8 * C,
                  "bwd_stats": 2 * piece.numel() * esz + B * G * 16 + 16 * C,
                  "bwd_apply": 3 * piece.numel() * esz + B * G * 16 + 8 * C}
            plan = list(gn_op.plan_split(B, S // R, C, esz))
            # copies of the piece that the cold timings cycle through: at
            # least three times L2's bytes, so each call reads its inputs
            # from HBM
            l2 = getattr(torch.cuda.get_device_properties(dev), "L2_cache_size", 50 << 20)
            copies = [(piece.clone(), dpiece.clone()) for _ in range(
                -(-3 * l2 // (2 * piece.numel() * piece.element_size())))] if timed else []
            turn = itertools.cycle(copies)
            for name, (kern_of, plain_of) in ks.items():
                kern = functools.partial(kern_of, piece, dpiece)
                plain = functools.partial(plain_of, piece, dpiece)
                got, again, want = kern(), kern(), plain()
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                if name in ("stats", "bwd_stats"):
                    checks = [compare_to_scale(a, b, *PARAM_GRAD_TOL) for a, b in
                              zip(got, want)]
                    worst = max(tol_fraction(a, b, *PARAM_GRAD_TOL)
                                for a, b in zip(got, want))
                elif name == "apply":
                    checks = [compare(got[0], want[0], dname)[:2]]
                    worst = compare_fraction(got[0], want[0], dname)
                else:
                    checks = [compare_to_scale(got[0], want[0], rt, at)]
                    worst = tol_fraction(got[0], want[0], rt, at)
                err, ok = max(c[0] for c in checks), all(c[1] for c in checks)
                launches = card_launches(kern)
                row = {"kernel": name, "shape": [B, S // R, C], "pieces": R,
                       "groups": G, "dtype": dname, "act": act, "plan": plan,
                       "max_abs_err": err, "worst_of_tolerance": worst,
                       "bitwise_repeat": same, "card_launches": launches}
                if timed:
                    b_ms, b_by = bound(io[name], SPLIT_GN_OPS[name][act] * piece.numel(),
                                       "float32")
                    ms, host_ms = time_ms(kern)
                    cold_ms = time_ms(lambda: kern_of(*next(turn)))[0]
                    lib = library[name]
                    row.update(ms=ms, host_ms=host_ms, cold_ms=cold_ms,
                               bound_ms=b_ms, bound_by=b_by,
                               share_of_bound=b_ms / cold_ms, warm_share_of_bound=b_ms / ms,
                               plain_ms=time_ms(plain, inner=5)[0],
                               library_ms=None if lib is None else time_ms(lib)[0])
                was = (SPLIT_GN_WAS.get((C, name)) if timed and (dname, B, S, R) ==
                       ("bfloat16", 64, 1024, 2) else None)
                rows.append(row)
                log(f"row {'3s' if name in ('stats', 'apply') else '4s'} {name} {dname} "
                    f"B={B} S={S // R} (1/{R} of {S}) C={C} G={G} plan {tuple(plan)}: "
                    f"max_abs_err {err:.3g} ({worst:.3g} of its tolerance); two calls "
                    f"bitwise equal: {same}; {launches} card launch(es) a call (was "
                    f"{SPLIT_GN_WAS_LAUNCHES[name]})"
                    + (f"; kernel_ms {row['ms']:.4f} warm L2 (the previous design's: "
                       f"{was}; host {row['host_ms']:.4f}), {row['cold_ms']:.4f} cold "
                       f"(each call on a copy of its inputs L2 no longer holds: "
                       f"{len(copies)} copies) bound_ms {row['bound_ms']:.4f} "
                       f"({row['bound_by']}; {row['share_of_bound']:.1%} of it cold, "
                       f"{row['warm_share_of_bound']:.1%} warm) plain_ms "
                       f"{row['plain_ms']:.4f} library_ms {row['library_ms']}"
                       if timed else ""))
                if not ok:
                    fail(f"row {name} disagrees with its plain version at {row['shape']} "
                         f"{dname}")
                if not same:
                    fail(f"row {name} is not bitwise repeatable at {row['shape']} {dname}")
                if launches != SPLIT_GN_LAUNCHES[name]:
                    fail(f"row {name} put {launches} launches on the card at "
                         f"{row['shape']} {dname}, not {SPLIT_GN_LAUNCHES[name]}")
            log(f"split pair {dname} B={B} S={S} in {R} pieces C={C} G={G} against rows "
                f"3/4 on the whole image: y {err_y:.3g}, dx {err_dx:.3g}, dscale/dbias "
                f"{err_p:.3g}")
            if not (ok_y and ok_dx and ok_p):
                fail(f"rows 3s/4s over {R} pieces disagree with rows 3/4 at B={B} S={S} "
                     f"C={C} {dname}")
            pair_rows.append({"B": B, "S": S, "C": C, "pieces": R, "dtype": dname,
                              "y_err": err_y, "dx_err": err_dx, "param_err": err_p})
            del piece, dpiece, xf, yf, x4, xg, d4, ks, library, copies, turn
            torch.cuda.empty_cache()
    # what the split costs against row 3 (4) at one rank, on the same shape
    cost = []
    B, S = SPLIT_GN_HEAD
    for dname in ("bfloat16", "float32"):
        dtype = getattr(torch, dname)
        C = 128
        x = torch.randn(B, S, C, generator=g, device=dev).to(dtype)
        dy = torch.randn(B, S, C, generator=g, device=dev).to(dtype)
        scale = torch.ones(C, device=dev)
        bias = torch.zeros(C, device=dev)
        n = float(S) * float(C // G)

        def split_fwd():
            sums = gn_op.group_norm_stats(x, G)
            return gn_op.group_norm_apply(x, scale, bias, sums, G, n, eps, act)

        sums = gn_op.group_norm_stats(x, G)

        def split_bwd():
            gs = gn_op.group_norm_bwd_stats(x, dy, scale, bias, sums, G, n, eps, act)[0]
            return gn_op.group_norm_bwd_apply(x, dy, scale, bias, sums, gs, G, n, eps,
                                              act)

        same = split_fwd()
        y3 = gn_op.fused_group_norm_act(x, scale, bias, G, eps, act)
        esz = x.element_size()
        fb, _ = bound(2 * x.numel() * esz + 8 * C, 12 * x.numel(), "float32")
        bb, _ = bound(3 * x.numel() * esz + 8 * C, GN_BWD_OPS[act] * x.numel(), "float32")
        c = {"dtype": dname, "shape": [B, S, C], "groups": G,
             "row3_ms": time_ms(lambda: gn_op.fused_group_norm_act(x, scale, bias, G,
                                                                   eps, act))[0],
             "split_fwd_ms": time_ms(split_fwd)[0],
             "row4_ms": time_ms(lambda: gn_op.group_norm_bwd(x, scale, bias, dy, G, eps,
                                                             act))[0],
             "split_bwd_ms": time_ms(split_bwd)[0],
             "fwd_bound_ms": fb, "bwd_bound_ms": bb,
             "fwd_launches": [card_launches(lambda: gn_op.fused_group_norm_act(
                 x, scale, bias, G, eps, act)), card_launches(split_fwd)],
             "bwd_launches": [card_launches(lambda: gn_op.group_norm_bwd(
                 x, scale, bias, dy, G, eps, act)), card_launches(split_bwd)],
             "y_err_vs_row3": float((same.float() - y3.float()).abs().max())}
        c["fwd_ratio"] = c["split_fwd_ms"] / c["row3_ms"]
        c["bwd_ratio"] = c["split_bwd_ms"] / c["row4_ms"]
        cost.append(c)
        log(f"split at one rank {dname} B={B} S={S} C={C} G={G}: forward row 3 "
            f"{c['row3_ms']:.4f} ms ({c['fwd_launches'][0]} card launches) vs 3s "
            f"stats+apply {c['split_fwd_ms']:.4f} ms ({c['fwd_launches'][1]}), "
            f"{c['fwd_ratio']:.3f}x, bound {fb:.4f}; backward row 4 {c['row4_ms']:.4f} "
            f"ms ({c['bwd_launches'][0]}) vs 4s {c['split_bwd_ms']:.4f} ms "
            f"({c['bwd_launches'][1]}), {c['bwd_ratio']:.3f}x, bound {bb:.4f}; y vs "
            f"row 3 max |diff| {c['y_err_vs_row3']:.3g}")
    return {"rows": rows, "pairs": pair_rows, "one_rank": cost}


def _whole_grads(grads, module, mesh):
    """Whole gradients from a model-parallel module's (its sharded leaves
    gathered over the model group)."""
    from pdm_tpu_torch.parallel.collectives import all_gather_dim

    out = {}
    for name, gr in grads.items():
        spec = module.specs[name]
        if "model" in spec:
            gr = all_gather_dim(gr.contiguous(), mesh.model_group, mesh.model_size,
                                spec.index("model"))
        out[name] = gr
    return out


def mp_fp32_step(weights, sched, dev, x, mesh, partition, lr=1e-4, config=None):
    """One fp32 train step of the UNet ``config`` (the flagship by default;
    its dropout from the step generator) on ``x``, over ``mesh``'s model
    axis with ``partition`` (or one process): the loss, the whole
    gradients it applied, the whole params after it."""
    import torch

    from pdm_tpu_torch.diffusion.trainer import DDPMTrainer, step_generator, whole_tensors
    from pdm_tpu_torch.models.unet import unet_from_config
    from pdm_tpu_torch.models.unet_ddpm import UNetDDPM

    net = unet_from_config(3, config or FLAGSHIP, dtype=torch.float32, device=dev)
    tr = DDPMTrainer(UNetDDPM(sched, net, device=dev), learning_rate=lr,
                     warmup_steps=0, grad_clip=1e9, ema_decay=0.9999,
                     model_partition=partition)
    st = tr.init_state(weights, mesh)
    st, m, grads = train_step_with_grads(tr, st, x, generator=step_generator(0, 1, dev))
    if mesh is not None:
        grads = _whole_grads({k: v.to(dev) for k, v in grads.items()},
                             tr.ddpm.module, mesh)
    params = {k: v.cpu() for k, v in whole_tensors(st, st.params).items()}
    return float(m["loss"]), {k: v.cpu() for k, v in grads.items()}, params


def mp_step_agreement(got, one) -> tuple:
    """An mp_fp32_step over the model axis against one process's: the
    loss's relative error, the worst gradient as a fraction of its
    tolerance (TRAIN_TOL), and the params' worst excess over the bound
    Adam's first step allows the two gradients (agreement: loss error
    within TRAIN_TOL, gradient at most 1, excess at most 0)."""
    loss_err = abs(got[0] - one[0]) / abs(one[0])
    top = max(float(v.abs().max()) for v in one[1].values())
    worst_grad = max(float((got[1][k] - g1).abs().max())
                     / (TRAIN_TOL["grad"] * float(g1.abs().max())
                        + TRAIN_TOL["grad_floor"] * top)
                     for k, g1 in one[1].items())
    excess = max(float(((got[2][k] - one[2][k]).abs()
                        - adam_first_step_bound(got[1][k], one[1][k], 1e-4)
                        - 1e-7).max()) for k in one[2])
    return loss_err, worst_grad, excess


def model_axis_child(rank: int, tmp: str) -> None:
    """Phase 21(b) on one rank of two sharing the card under gloo, mesh
    1 x 2: the bf16 flagship's TP and SP forward at the sampler's batch
    against one process (and fp32), one fp32 TP and SP train step against
    one process, the bf16 steps counted and timed with their byte bills,
    and sharded_sampler(partition="spatial") against the unsharded one."""
    import torch
    import torch.distributed as dist

    from pdm_tpu_torch.diffusion.sampling import DDPMSampler
    from pdm_tpu_torch.diffusion.trainer import DDPMTrainer, step_generator
    from pdm_tpu_torch.models.unet import AttentionBlock, GroupNormAct, unet_from_config
    from pdm_tpu_torch.models.unet_ddpm import UNetDDPM
    from pdm_tpu_torch.parallel import (
        make_mesh, sharded_sampler, unet_with_sp, unet_with_tp,
    )
    from pdm_tpu_torch.parallel.collectives import H100_NVLINK_BW, project_step
    from pdm_tpu_torch.schedulers.analytic import LinearBetaScheduler

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    label = f"model axis rank {rank}/2 (gloo)"
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv21", rank=rank,
                            world_size=2, timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_mesh(data=1, model=2)
        res = {"rank": rank}
        counters = [_counter(mod, fn) for _, mod, fn in TRAIN_COUNTERS + SPLIT_COUNTERS]
        keys = [k for k, _, _ in TRAIN_COUNTERS + SPLIT_COUNTERS]
        sched = LinearBetaScheduler(1e-4, 2.478e4)
        cpu_net = unet_from_config(3, FLAGSHIP, dtype=torch.float32, device="cpu")
        weights = seeded_state_dict(cpu_net)
        n_gn = sum(isinstance(m, GroupNormAct) for m in cpu_net.modules())
        n_attn = sum(isinstance(m, AttentionBlock) for m in cpu_net.modules())
        del cpu_net
        h = 32 // mesh.model_size
        rows = slice(mesh.model_index * h, (mesh.model_index + 1) * h)
        x = torch.from_numpy(np.random.RandomState(21).standard_normal(
            (BATCH, 3, 32, 32)).astype(np.float32)).to(dev)
        tau = torch.linspace(0.05, 0.95, BATCH, device=dev)
        # (1) the forward, bf16 at the sampler's batch and fp32 at batch 8
        fwd = {}
        for dname, batch, tol in (("bfloat16", BATCH, MP_BF16_TOL),
                                  ("float32", 8, FORWARD_TOL)):
            net = unet_from_config(3, FLAGSHIP, dtype=getattr(torch, dname), device=dev)
            net.load_state_dict(weights)
            xb, tb = x[:batch], tau[:batch]
            with torch.inference_mode():
                ref = net(xb, tb)
            for part, make, inp, want in (
                    ("channel", unet_with_tp, xb, ref),
                    ("spatial", unet_with_sp, xb[:, :, rows].contiguous(),
                     ref[:, :, rows])):
                mp_net = make(net, mesh)
                mesh.model_stats.reset()
                with torch.inference_mode():
                    out, launches = counted(lambda: mp_net(inp, tb), counters)
                    torch.cuda.synchronize()
                    bill = dict(mesh.model_stats.bytes_by_kind)
                    ms = statistics.median(
                        [_host_ms(lambda: mp_net(inp, tb)) for _ in range(3)])
                    plain_ms = statistics.median(
                        [_host_ms(lambda: net(xb, tb)) for _ in range(3)])
                err, ok = compare_to_scale(out, want, 0.0, tol)
                launches = dict(zip(keys, launches))
                fwd[f"{part} {dname}"] = {"err": err, "ms": ms, "plain_ms": plain_ms,
                                          "launches": launches, "bill": bill}
                log(f"{label}: {part} forward, {dname} flagship, batch {batch}: max "
                    f"|diff| {err:.3g} against one process (tol {tol} of scale "
                    f"{float(want.abs().max()):.3g}); {ms:.2f} ms against {plain_ms:.2f} "
                    f"one process (host clock, synchronized); launches {launches}; "
                    f"model-axis bill {bill} bytes")
                if not ok:
                    fail(f"{label}: the {part} {dname} forward disagrees with one process")
                want_l = ({"attention_fwd": n_attn, "group_norm_fwd": n_gn}
                          if part == "channel" else
                          {"attention_fwd": n_attn, "group_norm_fwd": n_attn,
                           "group_norm_stats": n_gn - n_attn,
                           "group_norm_apply": n_gn - n_attn})
                got_l = {k: v for k, v in launches.items() if v}
                if got_l != want_l:
                    fail(f"{label}: {part} forward launches {got_l} != {want_l}")
            del net, mp_net, ref, out
        res["forward"] = fwd
        torch.cuda.empty_cache()
        # (2) one fp32 train step of each partition against one process
        x2 = x[:MP_STEP_BATCH]
        one = mp_fp32_step(weights, sched, dev, x2, None, "channel")
        steps = {}
        for part in ("channel", "spatial"):
            got = mp_fp32_step(weights, sched, dev, x2, mesh, part)
            loss_err, worst_grad, excess = mp_step_agreement(got, one)
            steps[part] = {"loss_err": loss_err, "grad": worst_grad, "excess": excess}
            log(f"{label}: fp32 flagship {part} train step, batch {MP_STEP_BATCH}, "
                f"dropout 0.2, against one process: loss {got[0]:.7g} vs {one[0]:.7g} "
                f"(rel {loss_err:.3g}, tol {TRAIN_TOL['loss']}); worst gradient "
                f"{worst_grad:.3g} of its tolerance; params after Adam within the bound "
                f"the gradients allow, worst excess {excess:.3g}")
            if loss_err > TRAIN_TOL["loss"] or worst_grad > 1.0 or excess > 0:
                fail(f"{label}: the {part} fp32 train step disagrees with one process")
        res["fp32_step"] = steps
        del one, got
        torch.cuda.empty_cache()
        # (3) the bf16 train steps: launches, time, the byte bill
        xb = x[:MP_BF16_BATCH]
        train = {}
        for part in ("channel", "spatial", None):
            # the card memory the trainer holds on this rank: the module, the
            # fp32 masters and EMA after init_state, the Adam moments too
            # after the steps (the trainer holds the only reference to the
            # whole model, as train_diffusion's does; the previous part's
            # trainer is gone: its step closure held it)
            gc.collect()
            torch.cuda.synchronize()
            mem0 = torch.cuda.memory_allocated()
            tr = DDPMTrainer(UNetDDPM(sched, unet_from_config(
                3, FLAGSHIP, dtype=torch.bfloat16, device=dev), device=dev),
                learning_rate=1e-4, warmup_steps=10, total_iters=1000,
                grad_clip=1.0, ema_decay=0.9999, model_partition=part or "channel")
            st = tr.init_state(weights, None if part is None else mesh)
            torch.cuda.synchronize()
            mem_init = torch.cuda.memory_allocated() - mem0
            it = iter(range(1, 1000))

            def step(tr=tr, st=st, it=it):
                return tr.train_step(st, xb, step_generator(0, next(it), dev))[1]

            step()
            torch.cuda.synchronize()
            mesh.model_stats.reset()
            mesh.stats.reset()
            m, launches = counted(step, counters)
            torch.cuda.synchronize()
            bill = dict(mesh.model_stats.bytes_by_kind)
            calls = dict(mesh.model_stats.count_by_kind)
            data_bill = dict(mesh.stats.bytes_by_kind)
            ms = statistics.median([_host_ms(step) for _ in range(3)])
            torch.cuda.synchronize()
            mem_steps = torch.cuda.memory_allocated() - mem0
            name = part or "one process"
            train[name] = {"ms": ms, "launches": dict(zip(keys, launches)),
                           "loss": float(m["loss"]), "bill": bill, "calls": calls,
                           "data_bill": data_bill,
                           "held_bytes": {"init_state": mem_init, "after_steps": mem_steps}}
            if part is not None:
                one_bill = type(mesh.model_stats)()
                for k, v in bill.items():
                    one_bill.add(k, v)
                train[name]["projected_ms"] = {
                    n: project_step(one_bill, n, H100_NVLINK_BW)["total"] * 1e3
                    for n in (2, 4, 8)}
            log(f"{label}: bf16 flagship train step, {name}, batch {MP_BF16_BATCH}: "
                f"{ms:.2f} ms (host clock, synchronized); loss {float(m['loss']):.5g}; "
                f"launches {train[name]['launches']}; model-axis bill {bill} bytes in "
                f"{calls} calls; data-axis bill {data_bill}; projected over NVLink (H100 "
                f"SXM data sheet, 450 GB/s a direction) on 2/4/8 cards, this 2-rank "
                f"bill at JAX's ring volumes, halos as JAX's collective-permute (the "
                f"port's halo all-gather moves every rank's boundary rows) "
                f"{train[name].get('projected_ms')} ms; card memory the trainer "
                f"holds (torch.cuda.memory_allocated) {mem_init} bytes after "
                f"init_state, {mem_steps} after the steps")
            if not math.isfinite(float(m["loss"])):
                fail(f"{label}: the bf16 {name} train step's loss is not finite")
            got_l = {k: v for k, v in train[name]["launches"].items() if v}
            if part == "channel":
                want_l = {"attention_fwd": n_attn, "attention_bwd": 2 * n_attn,
                          "group_norm_fwd": n_gn, "group_norm_bwd": n_gn}
            elif part == "spatial":
                k = n_gn - n_attn
                want_l = {"attention_fwd": n_attn, "attention_bwd": 2 * n_attn,
                          "group_norm_fwd": n_attn, "group_norm_bwd": n_attn,
                          "group_norm_stats": k, "group_norm_apply": k,
                          "group_norm_bwd_stats": k, "group_norm_bwd_apply": k}
            else:
                want_l = TRAIN_LAUNCHES
            if got_l != want_l:
                fail(f"{label}: {name} train-step launches {got_l} != {want_l}")
            del tr, st, step, m
            torch.cuda.empty_cache()
        one_held = train["one process"]["held_bytes"]
        for part in ("channel", "spatial"):
            held = train[part]["held_bytes"]
            held["of_one_process"] = {k: held[k] / one_held[k] for k in one_held}
            log(f"{label}: the {part} trainer holds {held['of_one_process']} of one "
                f"process's card memory (after init_state, after the steps)")
        if train["spatial"]["held_bytes"]["init_state"] > 1.01 * one_held["init_state"]:
            fail(f"{label}: the spatial trainer holds more than one process's weights")
        if train["channel"]["held_bytes"]["after_steps"] > 0.6 * one_held["after_steps"]:
            fail(f"{label}: the channel trainer does not cut its card memory by m")
        res["train"] = train
        # (4) the spatial sampler against the unsharded one, fp32
        net = unet_from_config(3, FLAGSHIP, dtype=torch.float32, device=dev)
        net.load_state_dict(weights)
        ddpm = UNetDDPM(sched, net, device=dev)
        sampler = DDPMSampler(ddpm=ddpm, scheduler=sched, n_steps=MP_DDIM_STEPS,
                              obj_size=(3, 32, 32), batch_size=BATCH, n_samples=BATCH,
                              step_type="ddim", device=dev)
        sp = sharded_sampler(sampler, mesh, partition="spatial")

        def draw(s):
            return lambda: s.batch_sample(torch.Generator(device=dev).manual_seed(3))["x"]

        mesh.model_stats.reset()
        got, launches = counted(draw(sp), counters)
        want = draw(sampler)()
        torch.cuda.synchronize()
        # each element to its own size plus a typical element's: the final
        # x of random weights reaches |x| ~ 10^3 at its largest, so a floor
        # from max |x| would pass a wrong halo row
        err, ok, atol = compare_to_typical(got, want, FORWARD_TOL, FORWARD_TOL)
        # the control: rank 1's upper halo row at conv_out zeroed (both
        # ranks still exchange), which the check must refuse
        bad = zeroed_halo_row(draw(sp))
        bad_err, bad_ok, _ = compare_to_typical(bad, want, FORWARD_TOL, FORWARD_TOL)
        bad_ok_by_max = compare_to_scale(bad, want, 0.0, FORWARD_TOL)[1]
        ms = _host_ms(draw(sp))
        plain_ms = _host_ms(draw(sampler))
        res["sampler"] = {"err": err, "ms": ms / MP_DDIM_STEPS,
                          "plain_ms": plain_ms / MP_DDIM_STEPS,
                          "launches": dict(zip(keys, launches)),
                          "atol": atol, "max_abs": float(want.abs().max()),
                          "median_abs": float(want.abs().median()),
                          "control_err": bad_err,
                          "control_passes_max_scale_check": bad_ok_by_max}
        log(f"{label}: sharded_sampler(partition='spatial') fp32 DDIM-{MP_DDIM_STEPS} "
            f"at batch {BATCH}: max |diff| {err:.4g} against the unsharded sampler "
            f"(tol {FORWARD_TOL} |x| + {atol:.4g}, {FORWARD_TOL} of median |x| "
            f"{res['sampler']['median_abs']:.4g}; max |x| "
            f"{res['sampler']['max_abs']:.4g}); one halo row zeroed: max |diff| "
            f"{bad_err:.4g}, refused {not bad_ok} (the former bound, {FORWARD_TOL} "
            f"of max |x|, would have passed it: {bad_ok_by_max}); "
            f"{ms / MP_DDIM_STEPS:.2f} ms a step against {plain_ms / MP_DDIM_STEPS:.2f}; "
            f"launches {res['sampler']['launches']}")
        if not ok or tuple(got.shape) != (BATCH, 3, 32, 32):
            fail(f"{label}: the spatial sampler disagrees with the unsharded one")
        if bad_ok:
            fail(f"{label}: the spatial sampler's check passes a zeroed halo row")
        with open(os.path.join(tmp, f"mp{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def zeroed_halo_row(fn):
    """``fn()`` with rank 1's upper halo row zeroed at the spatial UNet's
    conv_out (a control for the check: every rank still enters the halo
    exchange)."""
    import torch.nn.functional as F

    from pdm_tpu_torch.parallel import model_parallel as mpm

    conv_of = mpm._Spatial.conv

    def conv(self, conv, a):
        if conv is not self.mp.conv_out or not a.split:
            return conv_of(self, conv, a)
        x = self.halo(a.t, 1, 1)
        if self.r == 1:
            x = x.clone()
            x[:, :, 0] = 0
        return mpm._Act(F.conv2d(x, conv.weight, conv.bias, 1, (0, 1)), True)

    mpm._Spatial.conv = conv
    try:
        return fn()
    finally:
        mpm._Spatial.conv = conv_of


def _host_ms(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def uneven_sampler_child(rank: int, tmp: str) -> None:
    """Phase 21(c) on one rank of UNEVEN_RANKS sharing the card under gloo,
    mesh 1 x 4: sharded_sampler(partition="spatial") of the tiny UNet at
    18 x 18 (4 does not divide 18: every level runs whole on every rank)
    against the unsharded sampler on the card, and one fp32 spatial train
    step at 18 x 18 against one process, each with its launches and the
    model axis's halo bytes (none)."""
    import torch
    import torch.distributed as dist

    from pdm_tpu_torch.diffusion.sampling import DDPMSampler
    from pdm_tpu_torch.models.unet import unet_from_config
    from pdm_tpu_torch.models.unet_ddpm import UNetDDPM
    from pdm_tpu_torch.parallel import make_mesh, sharded_sampler
    from pdm_tpu_torch.schedulers.analytic import LinearBetaScheduler

    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    label = f"uneven rows rank {rank}/{UNEVEN_RANKS} (gloo)"
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv21c", rank=rank,
                            world_size=UNEVEN_RANKS,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_mesh(data=1, model=UNEVEN_RANKS)
        counters = [_counter(mod, fn) for _, mod, fn in TRAIN_COUNTERS + SPLIT_COUNTERS]
        keys = [k for k, _, _ in TRAIN_COUNTERS + SPLIT_COUNTERS]
        net = unet_from_config(3, TINY_UNET, dtype=torch.float32, device="cpu")
        net.load_state_dict(seeded_state_dict(net, std=0.1))
        net = net.to(dev)
        sched = LinearBetaScheduler(1e-4, 1e2)
        sampler = DDPMSampler(ddpm=UNetDDPM(sched, net, device=dev), scheduler=sched,
                              n_steps=UNEVEN_STEPS,
                              obj_size=(3, UNEVEN_SIZE, UNEVEN_SIZE),
                              batch_size=UNEVEN_BATCH, n_samples=UNEVEN_BATCH,
                              step_type="ddim", device=dev)
        sp = sharded_sampler(sampler, mesh, partition="spatial")

        def draw(s):
            return lambda: s.batch_sample(torch.Generator(device=dev).manual_seed(5))["x"]

        mesh.model_stats.reset()
        got, launches = counted(draw(sp), counters)
        halo = mesh.model_stats["collective-permute"]
        want = draw(sampler)()
        torch.cuda.synchronize()
        err, ok, atol = compare_to_typical(got, want, FORWARD_TOL, FORWARD_TOL)
        launches = dict(zip(keys, launches))
        used = {k: v for k, v in launches.items() if v}
        res = {"rank": rank, "err": err, "atol": atol, "halo_bytes": halo,
               "launches": launches, "shape": list(got.shape)}
        log(f"{label}: sharded_sampler(partition='spatial') of the tiny UNet at "
            f"{UNEVEN_SIZE} x {UNEVEN_SIZE}, fp32 DDIM-{UNEVEN_STEPS} at batch "
            f"{UNEVEN_BATCH}: max |diff| {err:.4g} against the unsharded sampler (tol "
            f"{FORWARD_TOL} |x| + {atol:.4g}); halo bytes {halo}; launches {used}")
        if not ok or tuple(got.shape) != (UNEVEN_BATCH, 3, UNEVEN_SIZE, UNEVEN_SIZE):
            fail(f"{label}: the spatial sampler on uneven rows disagrees with the "
                 f"unsharded one")
        if halo or any(launches[k] for k, _, _ in SPLIT_COUNTERS):
            fail(f"{label}: rows were split (halo bytes {halo}, launches {launches})")
        # one fp32 spatial train step at the same height against one process
        weights = {k: v.cpu() for k, v in net.state_dict().items()}
        x0 = torch.from_numpy(np.random.RandomState(22).standard_normal(
            (UNEVEN_BATCH, 3, UNEVEN_SIZE, UNEVEN_SIZE)).astype(np.float32)).to(dev)
        one = mp_fp32_step(weights, sched, dev, x0, None, "spatial", config=TINY_UNET)
        mesh.model_stats.reset()
        got, step_launches = counted(
            lambda: mp_fp32_step(weights, sched, dev, x0, mesh, "spatial",
                                 config=TINY_UNET), counters)
        step_halo = mesh.model_stats["collective-permute"]
        loss_err, worst_grad, excess = mp_step_agreement(got, one)
        step_launches = dict(zip(keys, step_launches))
        res["fp32_step"] = {"loss_err": loss_err, "grad": worst_grad, "excess": excess,
                            "halo_bytes": step_halo, "launches": step_launches}
        log(f"{label}: fp32 spatial train step of the tiny UNet at {UNEVEN_SIZE} x "
            f"{UNEVEN_SIZE}, batch {UNEVEN_BATCH}, against one process: loss "
            f"{got[0]:.7g} vs {one[0]:.7g} (rel {loss_err:.3g}, tol {TRAIN_TOL['loss']}); "
            f"worst gradient {worst_grad:.3g} of its tolerance; params after Adam within "
            f"the bound the gradients allow, worst excess {excess:.3g}; halo bytes "
            f"{step_halo}; launches {({k: v for k, v in step_launches.items() if v})}")
        if loss_err > TRAIN_TOL["loss"] or worst_grad > 1.0 or excess > 0:
            fail(f"{label}: the spatial train step on uneven rows disagrees with one "
                 f"process")
        if step_halo or any(step_launches[k] for k, _, _ in SPLIT_COUNTERS):
            fail(f"{label}: the train step split rows (halo bytes {step_halo}, launches "
                 f"{step_launches})")
        with open(os.path.join(tmp, f"uneven{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def spawn_ranks(child, nprocs: int, tmp: str, what: str) -> None:
    """``child(rank, tmp)`` on ``nprocs`` spawned processes sharing the card;
    fails when one fails or all outlive MP_TIMEOUT_S."""
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    ctx = mp.start_processes(child, args=(tmp,), nprocs=nprocs, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + MP_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                fail(f"{what}: the {nprocs} ranks outlived {MP_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    log(f"{what}: {nprocs} ranks on one card under gloo passed in "
        f"{time.perf_counter() - t0:.1f} s")


def model_axis_phase(time_ms, dev) -> dict:
    """Phase 21: (a) rows 3s and 4s in one process (split_gn_phase), (b)
    two gloo ranks sharing the card on a 1 x 2 mesh (model_axis_child),
    with the byte bill and its NVLink projection in its report, (c) four
    gloo ranks on a 1 x 4 mesh: the spatial sampler and a spatial train
    step on an image whose rows 4 does not divide (uneven_sampler_child)."""
    out = {"split": split_gn_phase(time_ms, dev)}
    tmp = tempfile.mkdtemp()
    try:
        spawn_ranks(model_axis_child, 2, tmp, "model axis (b)")
        out["ranks"] = [json.load(open(os.path.join(tmp, f"mp{r}.json")))
                        for r in range(2)]
        spawn_ranks(uneven_sampler_child, UNEVEN_RANKS, tmp, "model axis (c)")
        out["uneven"] = [json.load(open(os.path.join(tmp, f"uneven{r}.json")))
                         for r in range(UNEVEN_RANKS)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# ---------------------------------------------------------------------
# phase 22: serving export (utils/serving.py) through the pdm:: custom ops
# ---------------------------------------------------------------------

SERVE_STEPS = 50        # (a) the bf16 flagship's DDIM steps
SERVE_BLOCK_STEPS = 10  # (b) the same with PDM_FUSED_BLOCK=1
SERVE_TRUE_STEPS = 10   # (c) TrueDDPM DDPM steps at CIFAR-10 scale
SERVE_SEED = 7
SERVE_TOL = 1e-4        # tests/test_serving.py's replay tolerance (rtol, atol)
SERVE_TURNS = 2         # (eager, replay) pairs of whole samples, order alternating
SERVE_DISPATCH = (64, 1024, 128, 200)  # B, S, C of row 3's op; calls a block
SERVE_PROFILE_STEPS = 5  # steps of the program and of the eager step profiled

# the fresh process of (a): it imports pdm_tpu_torch.ops (which registers
# the custom ops) and the loader, nothing else of the port, replays the
# artifact twice and reports the launches of the second replay
SERVE_CHILD = r"""
import json, sys, time
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import pdm_tpu_torch.ops
from pdm_tpu_torch.utils.serving import load_exported
from pdm_tpu_torch.ops import attention, attention_block, groupnorm
path, out, seed = sys.argv[1], sys.argv[2], int(sys.argv[3])
t0 = time.perf_counter()
fn, manifest = load_exported(path)
load_s = time.perf_counter() - t0
walls = []
for _ in range(2):
    attention.fused_spatial_attention.launches = 0
    groupnorm.fused_group_norm_act.launches = 0
    attention_block.fused_attention_block.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = fn(seed)
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t0)
torch.save(x.cpu(), out)
print(json.dumps({
    "load_s": load_s, "walls_s": walls, "manifest": manifest,
    "launches": {"attention": attention.fused_spatial_attention.launches,
                 "group_norm": groupnorm.fused_group_norm_act.launches,
                 "block": attention_block.fused_attention_block.launches},
    "jax_loaded": "jax" in sys.modules,
    "port_modules": sorted(m for m in sys.modules
                           if m.startswith("pdm_tpu_torch."))}))
"""


def serve_counters():
    from pdm_tpu_torch.ops import attention, attention_block, boltzmann, groupnorm

    return {"attention": attention.fused_spatial_attention,
            "group_norm": groupnorm.fused_group_norm_act,
            "block": attention_block.fused_attention_block,
            "moments": boltzmann.boltzmann_moments}


def serve_counted(fn):
    """fn() with every serving counter set to 0 just before and read just
    after: (result, launches by counter)."""
    import torch

    counters = serve_counters()
    for c in counters.values():
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k: c.launches for k, c in counters.items()}


def serve_turns(sampler, fn, n_steps, seed):
    """Eager batch_sample and the loaded artifact's fn in SERVE_TURNS pairs
    of whole samples, the order alternating: each one's ms a step."""
    import torch

    ms = {"eager": [], "replay": []}
    runs = {"eager": lambda: sampler.batch_sample(
                torch.Generator(device=sampler.device).manual_seed(seed)),
            "replay": lambda: fn(seed)}
    for pair in range(SERVE_TURNS):
        for kind in (("eager", "replay") if pair % 2 == 0 else ("replay", "eager")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[kind]()
            torch.cuda.synchronize()
            ms[kind].append((time.perf_counter() - t0) / n_steps * 1e3)
    return {"eager_ms": ms["eager"], "replay_ms": ms["replay"],
            "eager_median_ms": statistics.median(ms["eager"]),
            "replay_median_ms": statistics.median(ms["replay"])}


def serve_dispatch_us(dev) -> dict:
    """The host's enqueue of one row 3 call (SERVE_DISPATCH's shape, bf16,
    SiLU) through the custom op and launched directly, in alternating
    blocks of calls behind a sleep kernel, under inference mode: medians
    of us a call."""
    import torch

    from pdm_tpu_torch.ops import groupnorm as gn_op

    B, S, C, n = SERVE_DISPATCH
    x = torch.randn(B, S, C, device=dev).bfloat16()
    scale = torch.ones(C, device=dev)
    bias = torch.zeros(C, device=dev)
    calls = {"op_us": lambda: torch.ops.pdm.group_norm_act(
                 x, scale, bias, 32, 1e-6, "silu"),
             "direct_us": lambda: gn_op.launch_fwd(x, scale, bias, 32, 1e-6, "silu")}
    rate = sleep_rate()
    us = {k: [] for k in calls}
    with torch.inference_mode():
        for block in range(6):
            for k in (("op_us", "direct_us") if block % 2 == 0
                      else ("direct_us", "op_us")):
                torch.cuda.synchronize()
                torch.cuda._sleep(int(50 * rate))
                t0 = time.perf_counter()
                for _ in range(n):
                    calls[k]()
                us[k].append((time.perf_counter() - t0) / n * 1e6)
                torch.cuda.synchronize()
    return {k: statistics.median(v) for k, v in us.items()}


def serve_host_profile(sampler, fn, seed) -> dict:
    """SERVE_PROFILE_STEPS steps of the loaded program (``fn.programs[0]``)
    and of the eager step module on the same rows and input, each under
    torch.profiler and inference mode: per step, the card's busy ms (the
    kernels' device time), the host's self CPU ms over the profiled
    operators, and that of the pdm:: ops alone."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pdm_tpu_torch.core.draws import batch_randn
    from pdm_tpu_torch.diffusion.sampling import (
        STEP_MODULES, _step_tables, step_rows,
    )

    rows = step_rows(_step_tables(sampler._grid()))
    x = batch_randn((sampler.batch_size, *sampler.obj_size),
                    torch.Generator(device=sampler.device).manual_seed(seed),
                    device=sampler.device, dtype=torch.float32)
    steps = {"replay": fn.programs[0],
             "eager": STEP_MODULES[sampler.step_type](
                 sampler.ddpm, sampler.precision == "half")}
    out = {}
    with torch.inference_mode():
        for kind, step in steps.items():
            step(rows[0], x)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for i in range(SERVE_PROFILE_STEPS):
                    step(rows[i], x)
                torch.cuda.synchronize()
            card = sum(e.device_time_total for e in prof.events()
                       if e.device_type == DeviceType.CUDA
                       and not getattr(e, "is_user_annotation", False))
            rows_avg = prof.key_averages()
            host = sum(r.self_cpu_time_total for r in rows_avg)
            ops = sum(r.self_cpu_time_total for r in rows_avg
                      if r.key.startswith("pdm::"))
            n = SERVE_PROFILE_STEPS
            out[kind] = {"card_ms": card / 1e3 / n, "host_self_ms": host / 1e3 / n,
                         "pdm_ops_self_ms": ops / 1e3 / n}
    return out


def serve_diff(got, want):
    """(max |diff|, bitwise equal, within SERVE_TOL as rtol and atol)."""
    import torch

    got, want = got.float().cpu(), want.float().cpu()
    d = (got - want).abs()
    ok = bool((d <= SERVE_TOL + SERVE_TOL * want.abs()).all())
    return float(d.max()), torch.equal(got, want), ok


def serve_export(sampler, path, label):
    """export_sampler with its wall time: (seconds, bytes, manifest)."""
    import torch

    from pdm_tpu_torch.utils.serving import export_sampler

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    export_sampler(sampler, path)
    export_s = time.perf_counter() - t0
    with open(path + ".json") as f:
        manifest = json.load(f)
    log(f"serving {label}: exported in {export_s:.3f} s to {manifest['bytes']} "
        f"bytes ({', '.join(manifest['programs'])}); manifest "
        + json.dumps({k: manifest[k] for k in (
            "batch_size", "n_steps", "step_type", "obj_size", "precision",
            "platforms", "out_shape")}))
    return export_s, manifest["bytes"], manifest


def serving_phase(dev, weights) -> dict:
    """Phase 22: the serving export. (a) The bf16 flagship's DDIM-50 at
    batch 64 (phase 4's weights): exported, replayed in a fresh process that
    imports only pdm_tpu_torch.ops and the loader, within SERVE_TOL of
    batch_sample on the same seed (bitwise expected), with 8 row-1 and 69
    row-3 launches a step; export s, bytes, replay and eager ms a step in
    turns. (b) The same with PDM_FUSED_BLOCK=1 set for the export only,
    DDIM-10: 8 row-5 and 69 row-3 launches a step. (c) TrueDDPM at phase
    11's CIFAR-10 shape (50,000 N(0, 1) points of 3072 dimensions, batch
    1000) with DDPM-10, so that the loader draws each step's noise: 2 row-7
    launches a step, bitwise the eager sampler. The artifacts live in a
    temporary directory, deleted at the end."""
    import torch

    from pdm_tpu_torch.diffusion.sampling import DDPMSampler
    from pdm_tpu_torch.models.base import TrueDDPM
    from pdm_tpu_torch.models.unet import unet_from_config
    from pdm_tpu_torch.models.unet_ddpm import UNetDDPM
    from pdm_tpu_torch.schedulers.analytic import LinearBetaScheduler
    from pdm_tpu_torch.utils.serving import load_exported

    t_phase = time.perf_counter()
    out = {}
    sched = LinearBetaScheduler(1e-4, 2.478e4)
    tmp = tempfile.mkdtemp(prefix="pdm_serving_")
    opt_in_before = os.environ.pop("PDM_FUSED_BLOCK", None)
    try:
        net = unet_from_config(3, FLAGSHIP, dtype=torch.bfloat16, device=dev)
        net.load_state_dict(weights)
        ddpm = UNetDDPM(sched, net, parametrization="eps", device=dev)

        def unet_sampler(n_steps):
            return DDPMSampler(ddpm=ddpm, scheduler=sched, n_steps=n_steps,
                               obj_size=(3, 32, 32), batch_size=BATCH,
                               n_samples=BATCH, step_type="ddim",
                               precision="half", device=dev)

        # (a) rows 1 and 3, replayed in a fresh process
        sampler = unet_sampler(SERVE_STEPS)
        path = os.path.join(tmp, "flagship_ddim50.pt2")
        export_s, n_bytes, _ = serve_export(sampler, path, "(a) bf16 flagship DDIM-50")
        eager_x, eager_n = serve_counted(lambda: sampler.batch_sample(
            torch.Generator(device=dev).manual_seed(SERVE_SEED))["x"])
        x_path = os.path.join(tmp, "replay_x.pt")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", SERVE_CHILD, path, x_path, str(SERVE_SEED)],
            capture_output=True, text=True, timeout=600,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        child_s = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"serving (a): the fresh replay process exited "
                 f"{proc.returncode}:\n{proc.stderr[-3000:]}")
        child = json.loads(proc.stdout.strip().splitlines()[-1])
        replay_x = torch.load(x_path)
        err, bitwise, ok = serve_diff(replay_x, eager_x.cpu())
        want = {"attention": 8 * SERVE_STEPS, "group_norm": 69 * SERVE_STEPS,
                "block": 0}
        log(f"serving (a): fresh process ({child_s:.1f} s in all, load "
            f"{child['load_s']:.3f} s, replays {child['walls_s'][0]:.3f} and "
            f"{child['walls_s'][1]:.3f} s; jax loaded {child['jax_loaded']}; "
            f"port modules {child['port_modules']}): launches "
            f"{child['launches']} (want {want}; eager {eager_n}); replay vs "
            f"batch_sample on seed {SERVE_SEED}: max_abs_err {err:.3g}, "
            f"bitwise {bitwise} (tol {SERVE_TOL})")
        if child["launches"] != want:
            fail(f"serving (a): replay launches {child['launches']} != {want}")
        if (eager_n["attention"], eager_n["group_norm"]) != (want["attention"],
                                                            want["group_norm"]):
            fail(f"serving (a): eager launches {eager_n}")
        if not ok or child["jax_loaded"] or any(
                m.startswith(("pdm_tpu_torch.models", "pdm_tpu_torch.diffusion"))
                for m in child["port_modules"]):
            fail("serving (a): the fresh replay disagrees with batch_sample or "
                 "loaded more than the ops and the loader")
        if tuple(replay_x.shape) != (BATCH, 3, 32, 32) or not bool(
                torch.isfinite(replay_x).all()):
            fail("serving (a): replay not finite of shape (64, 3, 32, 32)")
        fn, _ = load_exported(path)
        turns = serve_turns(sampler, fn, SERVE_STEPS, SERVE_SEED)
        dispatch = serve_dispatch_us(dev)
        prof = serve_host_profile(sampler, fn, SERVE_SEED)
        log("serving (a): under torch.profiler, per step: " + ", ".join(
            f"{kind} card {v['card_ms']:.3f} ms, host self CPU "
            f"{v['host_self_ms']:.3f} ms (pdm:: ops {v['pdm_ops_self_ms']:.3f})"
            for kind, v in prof.items()))
        log(f"serving (a): eager {turns['eager_median_ms']:.3f} ms a step, "
            f"replay {turns['replay_median_ms']:.3f} (medians of {SERVE_TURNS} "
            f"turns each, in alternating order); the host's enqueue of row 3 at "
            f"B {SERVE_DISPATCH[0]}, S {SERVE_DISPATCH[1]}, C {SERVE_DISPATCH[2]}: "
            f"{dispatch['op_us']:.1f} us a call through pdm::group_norm_act, "
            f"{dispatch['direct_us']:.1f} launched directly (the replay's "
            f"77 op calls a step: {77 * (dispatch['op_us'] - dispatch['direct_us']) / 1e3:.3f} "
            f"ms more) " + json.dumps(turns))
        out["flagship"] = {
            "export_s": export_s, "bytes": n_bytes, "max_abs_err": err,
            "bitwise": bitwise, "launches": child["launches"],
            "steps": SERVE_STEPS, "child_s": child_s,
            "replay_walls_s": child["walls_s"], "dispatch": dispatch,
            "profile": prof, **turns}
        del fn

        # (b) row 5 with row 3: PDM_FUSED_BLOCK=1 read at export, baked in
        sampler = unet_sampler(SERVE_BLOCK_STEPS)
        path = os.path.join(tmp, "flagship_block_ddim10.pt2")
        with env_var("PDM_FUSED_BLOCK", "1"):
            export_s, n_bytes, _ = serve_export(
                sampler, path, "(b) bf16 flagship DDIM-10, PDM_FUSED_BLOCK=1")
            eager_x, eager_n = serve_counted(lambda: sampler.batch_sample(
                torch.Generator(device=dev).manual_seed(SERVE_SEED))["x"])
            fn, _ = load_exported(path)
            turns = serve_turns(sampler, fn, SERVE_BLOCK_STEPS, SERVE_SEED)
        # the replay, with the setting unset again
        replay_x, replay_n = serve_counted(lambda: fn(SERVE_SEED))
        err, bitwise, ok = serve_diff(replay_x, eager_x)
        want = {"attention": 0, "group_norm": 69 * SERVE_BLOCK_STEPS,
                "block": 8 * SERVE_BLOCK_STEPS, "moments": 0}
        log(f"serving (b): replay (PDM_FUSED_BLOCK unset) launches {replay_n} "
            f"(want {want}; eager {eager_n}); vs batch_sample: max_abs_err "
            f"{err:.3g}, bitwise {bitwise}; eager {turns['eager_median_ms']:.3f} "
            f"ms a step, replay {turns['replay_median_ms']:.3f} " + json.dumps(turns))
        if replay_n != want or eager_n != want or not ok:
            fail("serving (b): the whole-block replay disagrees with batch_sample "
                 "or its launch counts")
        out["whole_block"] = {
            "export_s": export_s, "bytes": n_bytes, "max_abs_err": err,
            "bitwise": bitwise, "launches": replay_n,
            "steps": SERVE_BLOCK_STEPS, **turns}
        del fn, net, ddpm, sampler
        torch.cuda.empty_cache()

        # (c) row 7: TrueDDPM at CIFAR-10 scale, DDPM (noise drawn by the loader)
        label, B, N, D, _ = MOMENTS_MAIN
        data = torch.randn(N, 3, 32, 32, generator=torch.Generator(
            device=dev).manual_seed(5), device=dev)
        true = TrueDDPM(sched, data, device=dev)
        sampler = DDPMSampler(ddpm=true, scheduler=sched, n_steps=SERVE_TRUE_STEPS,
                              obj_size=(3, 32, 32), batch_size=B, n_samples=B,
                              step_type="ddpm", device=dev)
        path = os.path.join(tmp, "true_cifar_ddpm10.pt2")
        export_s, n_bytes, _ = serve_export(
            sampler, path, f"(c) TrueDDPM {label} N={N} D={D} DDPM-10")
        t0 = time.perf_counter()
        fn, _ = load_exported(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        eager_x, eager_n = serve_counted(lambda: sampler.batch_sample(
            torch.Generator(device=dev).manual_seed(SERVE_SEED))["x"])
        replay_x, replay_n = serve_counted(lambda: fn(SERVE_SEED))
        err, bitwise, _ = serve_diff(replay_x, eager_x)
        turns = serve_turns(sampler, fn, SERVE_TRUE_STEPS, SERVE_SEED)
        want = {"attention": 0, "group_norm": 0, "block": 0,
                "moments": 2 * SERVE_TRUE_STEPS}
        log(f"serving (c): loaded in {load_s:.3f} s; replay launches {replay_n} "
            f"(want {want}; eager {eager_n}); vs batch_sample: max_abs_err "
            f"{err:.3g}, bitwise {bitwise}; eager {turns['eager_median_ms']:.3f} ms "
            f"a step, replay {turns['replay_median_ms']:.3f} " + json.dumps(turns))
        if replay_n != want or eager_n != want or not bitwise:
            fail("serving (c): the TrueDDPM replay is not bitwise batch_sample "
                 "or its launch counts differ")
        if not bool(torch.isfinite(replay_x).all()):
            fail("serving (c): replay not finite")
        out["true"] = {
            "export_s": export_s, "bytes": n_bytes, "load_s": load_s,
            "max_abs_err": err, "bitwise": bitwise, "launches": replay_n,
            "steps": SERVE_TRUE_STEPS, **turns}
        del fn, true, data, sampler
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if opt_in_before is not None:
            os.environ["PDM_FUSED_BLOCK"] = opt_in_before
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 22 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------
# phase 23: the 256x256 family (rows 1 and 2 at one head of 512)
# ---------------------------------------------------------------------

# rows 1 and 2 off the main paths, untimed: head dims at the wide kernels'
# edges (the first above the narrow kernels' 128, ragged chunks, the
# family's 512, and past it: the kernels have no head-dim bound) at T 8,
# 64, 256 and 1024, one head, B 2
WIDE_EDGE_HD = (136, 200, 264, 384, 504, 512, 520, 576)
WIDE_EDGE_T = (8, 64, 256, 1024)
# the single-head 32 x 32 DDPM (the original DDPM's attention): the
# flagship's block layout with two layers a block and one head a block,
# 35.75 M parameters, 51 GroupNorms, six heads of 256 (five at 16 x 16,
# the mid block at 4 x 4)
SINGLE_HEAD = {**FLAGSHIP, "layers_per_block": 2, "attention_head_dim": None}
SINGLE_HEAD_CALLS = {"attention": 6, "group_norm": 51}
SINGLE_HEAD_STEPS = 10
# the family's sampler (README's 256 x 256 sampling row: DDIM-50 at batch
# 8, two batches) and train step (scripts/endurance_256.py: micro-batch 8
# x grad_accum 16, lr 1e-4, warmup 100, clip 1.0, EMA 0.999)
HIGHRES_STEPS = 50
HIGHRES_BATCH = 8
HIGHRES_SAMPLES = 16
HIGHRES_ACCUM = 16
HIGHRES_TRAIN_STEPS = 3
HIGHRES_PROFILE_STEPS = 5
HIGHRES_TURN_PAIRS = 3  # alternating pairs of turns, default vs PDM_FUSED_BLOCK=1
# rows 5 and 6 at every geometry JAX's gate admits (PDM_FUSED_BLOCK=1 on
# the family and the single-head 32 x 32 DDPM: the staged launch plan):
# the blocks' (T, C, heads, calls a step), and edges (B, T, heads, hd) the
# cluster kernels do not take: 16 and 64 heads of 8 (64 x 176^2 just under
# 2^21), head dims 24 and 128, 512 and 1024 tokens, one head of 512 at T 8
FAMILY_BLOCK_GEOMS = ((256, 512, 1, 5), (64, 512, 1, 1))
SINGLE_BLOCK_GEOMS = ((256, 256, 1, 5), (16, 256, 1, 1))
BLOCK_WIDE_EDGES = ((2, 64, 16, 8), (2, 176, 64, 8), (2, 256, 4, 24), (2, 128, 4, 128),
                    (2, 512, 8, 64), (1, 1024, 2, 256), (2, 8, 1, 512), (1, 1024, 1, 512))
# a single-head UNet whose fp32 train step the CPU can take: one head of
# 128 in its four attention blocks at 8 x 8 (the staged plan), 16 x 16
# images, batch 4
SINGLE_TINY = {**TINY_UNET, "block_out_channels": [32, 128], "attention_head_dim": None}


def sdpa_backend(qh, kh, vh, scale: float) -> str:
    """The backend torch's scaled_dot_product_attention picks for these
    inputs (its own dispatcher's choice)."""
    import torch
    from torch.nn.attention import SDPBackend

    choice = int(torch._fused_sdp_choice(qh, kh, vh, scale=scale))
    return next((b.name for b in SDPBackend.__members__.values()
                 if int(b) == choice), str(choice))


def attention_rows(time_ms, dev, g, B, T, C, heads, calls, dtype,
                   forward: bool = True, backward: bool = True, timed: bool = True):
    """Rows 1 and 2 at (B, T, C, heads) on the column thirds of one
    (B, T, 3C) projection (the UNet's layout) against their plain
    versions: the forward (and lse) to TOL, the three gradients to
    BWD_TOL, each kernel called twice and bitwise equal. `forward` and
    `backward` pick the rows made (the backward runs on the forward's lse
    either way). Timed: ms beside the bound, the plain version and SDPA
    (its backend named). Returns (forward row or None, backward row or
    None)."""
    import torch
    import torch.nn.functional as F

    from pdm_tpu_torch.ops import attention as attn_op

    dname = str(dtype).split(".")[1]
    hd = C // heads
    qkv = torch.randn(B, T, 3 * C, generator=g, device=dev).to(dtype)
    q, k, v = qkv.split(C, dim=-1)
    do = (torch.randn(B, T, C, generator=g, device=dev).to(dtype)
          if backward else None)
    scale = 1.0 / math.sqrt(hd)
    kind = attn_op._entry("fwd", hd)  # the C entry a call launches: the rows' label
    where = f"{kind} {dname} B={B} T={T} C={C} heads={heads}"
    esz = qkv.element_size()
    reps, inner = (5, 5) if dtype == torch.float32 and hd > attn_op.NARROW_MAX_HEAD_DIM \
        else (10, 20)
    qh, kh, vh = (t.reshape(B, T, heads, hd).transpose(1, 2) for t in (q, k, v))
    backend = sdpa_backend(qh, kh, vh, scale) if timed else None
    base = {"shape": [B, T, C], "heads": heads, "dtype": dname, "kernel": kind,
            "calls_per_step": calls}
    out, lse = attn_op.attention_with_lse(q, k, v, heads, scale)
    fwd = bwd = None
    if forward:
        out2, lse2 = attn_op.attention_with_lse(q, k, v, heads, scale)
        ref, ref_lse = attn_op._reference_with_lse(q, k, v, heads, scale)
        torch.cuda.synchronize()
        err, ok, rtol, atol = compare(out, ref, dname)
        lse_err = float((lse - ref_lse).abs().max())
        lse_tol = 1e-4 * (1.0 + float(ref_lse.abs().max()))
        worst = max(compare_fraction(out, ref, dname), lse_err / lse_tol)
        same = torch.equal(out, out2) and torch.equal(lse, lse2)
        fwd = {**base, "max_abs_err": err, "lse_max_abs_err": lse_err,
               "worst_of_tolerance": worst, "bitwise_repeat": same,
               "rtol": rtol, "atol": atol}
        del out2, lse2, ref, ref_lse
        if timed:
            b_ms, b_by = bound(4 * B * T * C * esz + B * heads * T * 4,
                               4 * B * T * T * C, dname)
            ms, host_ms = time_ms(lambda: attn_op.attention_with_lse(
                q, k, v, heads, scale), reps=reps, inner=inner)
            fwd.update({
                "ms": ms, "host_ms": host_ms,
                "plain_ms": time_ms(lambda: attn_op._reference_with_lse(
                    q, k, v, heads, scale), reps=reps, inner=5)[0],
                "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                    qh, kh, vh, scale=scale), reps=reps, inner=inner)[0],
                "library_backend": backend, "bound_ms": b_ms, "bound_by": b_by})
            log(f"attention {where} x{calls}/step: max_abs_err {err:.3g} (lse "
                f"{lse_err:.3g}; tol rtol {rtol} atol {atol}; worst {worst:.3g} "
                f"of it; bitwise repeat {same}) kernel_ms {ms:.4f} (host "
                f"{host_ms:.4f}) plain_ms {fwd['plain_ms']:.4f} SDPA ({backend}) "
                f"{fwd['library_ms']:.4f} bound_ms {b_ms:.4f} ({b_by})")
        if not (ok and lse_err <= lse_tol and same):
            fail(f"attention kernel disagrees with its plain version or is not "
                 f"bitwise repeatable at {where}: worst {worst:.3g} of tol, "
                 f"bitwise {same}")
    if backward:
        got = attn_op.attention_bwd(q, k, v, lse, do, heads, scale)
        got2 = attn_op.attention_bwd(q, k, v, lse, do, heads, scale)
        want = attn_op.attention_bwd_reference(q, k, v, lse, do, heads, scale)
        torch.cuda.synchronize()
        rtol, atol = BWD_TOL[dname]
        checks = [compare_to_scale(a_, b_, rtol, atol) for a_, b_ in zip(got, want)]
        err = max(c[0] for c in checks)
        worst = max(tol_fraction(a_, b_, rtol, atol) for a_, b_ in zip(got, want))
        same = all(torch.equal(a_, b_) for a_, b_ in zip(got, got2))
        bwd = {**base, "max_abs_err": err, "worst_of_tolerance": worst,
               "bitwise_repeat": same, "rtol": rtol, "atol_of_scale": atol}
        del got2, want
        if timed:
            qg, kg, vg = (t.detach().clone().requires_grad_() for t in (qh, kh, vh))
            lib_out = F.scaled_dot_product_attention(qg, kg, vg, scale=scale)
            do_h = do.reshape(B, T, heads, hd).transpose(1, 2)
            b_ms, b_by = bound(7 * B * T * C * esz + B * heads * T * 4,
                               10 * B * T * T * C, dname)
            ms, host_ms = time_ms(lambda: attn_op.attention_bwd(
                q, k, v, lse, do, heads, scale), reps=reps, inner=inner)
            bwd.update({
                "ms": ms, "host_ms": host_ms,
                "plain_ms": time_ms(lambda: attn_op.attention_bwd_reference(
                    q, k, v, lse, do, heads, scale), reps=reps, inner=3)[0],
                "library_ms": time_ms(lambda: torch.autograd.grad(
                    lib_out, (qg, kg, vg), do_h, retain_graph=True),
                    reps=reps, inner=inner)[0],
                "library_backend": backend, "bound_ms": b_ms, "bound_by": b_by})
            del lib_out, qg, kg, vg
            log(f"attention backward {where} x{calls}/step: max_abs_err {err:.3g} "
                f"(tol rtol {rtol} atol {atol} of scale; worst {worst:.3g} of it; "
                f"bitwise repeat {same}) kernel_ms {ms:.4f} (host {host_ms:.4f}) "
                f"plain_ms {bwd['plain_ms']:.4f} SDPA backward ({backend}) "
                f"{bwd['library_ms']:.4f} bound_ms {b_ms:.4f} ({b_by})")
        if not (all(c[1] for c in checks) and same):
            fail(f"attention backward kernels disagree with their plain version "
                 f"or are not bitwise repeatable at {where}: worst {worst:.3g} of "
                 f"tol, bitwise {same}")
    return fwd, bwd


def group_norm_rows(time_ms, dev, g, B, S, C, G, dname, act, calls,
                    forward: bool = True, backward: bool = True):
    """Rows 3 and 4 at (B, S, C), G groups, against their plain versions:
    the forward to TOL, dx to BWD_TOL and dscale / dbias to
    PARAM_GRAD_TOL, each kernel called twice and bitwise equal; each timed
    beside the bound, the plain version and F.group_norm (+ SiLU) on the
    channels_last image. `forward` and `backward` pick the rows made.
    Returns (forward row or None, backward row or None)."""
    import torch
    import torch.nn.functional as F

    from pdm_tpu_torch.ops import groupnorm as gn_op

    dtype = getattr(torch, dname)
    x = torch.randn(B, S, C, generator=g, device=dev).to(dtype)
    dy = torch.randn(B, S, C, generator=g, device=dev).to(dtype) if backward else None
    scale = 1.0 + 0.2 * torch.randn(C, generator=g, device=dev)
    bias = 0.1 * torch.randn(C, generator=g, device=dev)
    side = int(round(math.sqrt(S)))
    x4 = x.view(B, side, side, C).permute(0, 3, 1, 2)  # channels_last
    sc_b, bi_b = scale.to(dtype), bias.to(dtype)
    where = f"{dname} B={B} S={S} C={C} groups={G} act={act}"
    base = {"shape": [B, S, C], "groups": G, "act": act, "dtype": dname,
            "calls_per_step": calls}
    fwd = bwd = None
    if forward:
        y = gn_op.fused_group_norm_act(x, scale, bias, G, 1e-6, act)
        y2 = gn_op.fused_group_norm_act(x, scale, bias, G, 1e-6, act)
        ref = gn_op.group_norm_reference(x, scale, bias, G, 1e-6, act).to(dtype)
        torch.cuda.synchronize()
        err, ok, rtol, atol = compare(y, ref, dname)
        worst = compare_fraction(y, ref, dname)
        same = bool(torch.equal(y, y2))
        plan = gn_op.plan_group_norm(B, S, C, G, x.element_size(), False)
        del y, y2, ref

        def library():
            z = F.group_norm(x4, G, sc_b, bi_b, 1e-6)
            return F.silu(z) if act == "silu" else z

        b_ms, b_by = bound(2 * x.numel() * x.element_size() + 2 * C * 4,
                           (12 if act == "silu" else 8) * x.numel(), "float32")
        ms, host_ms = time_ms(
            lambda: gn_op.fused_group_norm_act(x, scale, bias, G, 1e-6, act))
        fwd = {**base, "plan": list(plan), "max_abs_err": err,
               "worst_of_tolerance": worst, "bitwise_repeat": same, "rtol": rtol,
               "atol": atol, "ms": ms, "host_ms": host_ms,
               "plain_ms": time_ms(lambda: gn_op.group_norm_reference(
                   x, scale, bias, G, 1e-6, act).to(dtype), inner=5)[0],
               "library_ms": time_ms(library)[0],
               "bound_ms": b_ms, "bound_by": b_by}
        log(f"groupnorm {where} x{calls}/step plan {tuple(plan)}: max_abs_err "
            f"{err:.3g} (tol rtol {rtol} atol {atol}; worst {worst:.3g} of it; "
            f"bitwise repeat {same}) kernel_ms {ms:.4f} (host {host_ms:.4f}) "
            f"plain_ms {fwd['plain_ms']:.4f} library_ms {fwd['library_ms']:.4f} "
            f"bound_ms {b_ms:.4f} ({b_by})")
        if not (ok and same):
            fail(f"GroupNorm kernel disagrees with its plain version or is not "
                 f"bitwise repeatable at {where}")
    if backward:
        got = gn_op.group_norm_bwd(x, scale, bias, dy, G, 1e-6, act)
        again = gn_op.group_norm_bwd(x, scale, bias, dy, G, 1e-6, act)
        want = gn_op.group_norm_bwd_reference(x, scale, bias, dy, G, 1e-6, act)
        torch.cuda.synchronize()
        rtol, atol = BWD_TOL[dname]
        checks = [compare_to_scale(got[0], want[0], rtol, atol)] + [
            compare_to_scale(a_, b_, *PARAM_GRAD_TOL) for a_, b_ in zip(got[1:], want[1:])]
        err, ok = max(c[0] for c in checks), all(c[1] for c in checks)
        worst = max([tol_fraction(got[0], want[0], rtol, atol)] + [
            tol_fraction(a_, b_, *PARAM_GRAD_TOL) for a_, b_ in zip(got[1:], want[1:])])
        same = all(torch.equal(a_, b_) for a_, b_ in zip(got, again))
        plan = gn_op.plan_group_norm(B, S, C, G, x.element_size(), True)
        del got, again, want
        x4g = x4.detach().clone().requires_grad_()
        sc_g, bi_g = sc_b.clone().requires_grad_(), bi_b.clone().requires_grad_()
        lib_out = F.group_norm(x4g, G, sc_g, bi_g, 1e-6)
        if act == "silu":
            lib_out = F.silu(lib_out)
        dy4 = dy.view(B, side, side, C).permute(0, 3, 1, 2)
        b_ms, b_by = bound(3 * x.numel() * x.element_size() + 4 * C * 4,
                           GN_BWD_OPS[act] * x.numel(), "float32")
        ms, host_ms = time_ms(lambda: gn_op.group_norm_bwd(
            x, scale, bias, dy, G, 1e-6, act))
        bwd = {**base, "plan": list(plan), "max_abs_err": err,
               "worst_of_tolerance": worst, "bitwise_repeat": same, "rtol": rtol,
               "atol_of_scale": atol, "ms": ms, "host_ms": host_ms,
               "plain_ms": time_ms(lambda: gn_op.group_norm_bwd_reference(
                   x, scale, bias, dy, G, 1e-6, act), inner=3)[0],
               "library_ms": time_ms(lambda: torch.autograd.grad(
                   lib_out, (x4g, sc_g, bi_g), dy4, retain_graph=True))[0],
               "bound_ms": b_ms, "bound_by": b_by}
        del lib_out, x4g
        log(f"groupnorm backward {where} x{calls}/step plan {tuple(plan)}: "
            f"max_abs_err {err:.3g} (dx tol rtol {rtol} atol {atol} of scale; "
            f"dscale/dbias {PARAM_GRAD_TOL}; worst {worst:.3g} of it; bitwise "
            f"repeat {same}) kernel_ms {ms:.4f} (host {host_ms:.4f}) plain_ms "
            f"{bwd['plain_ms']:.4f} library_ms {bwd['library_ms']:.4f} bound_ms "
            f"{b_ms:.4f} ({b_by})")
        if not (ok and same):
            fail(f"GroupNorm backward kernel disagrees with its plain version or "
                 f"is not bitwise repeatable at {where}")
    return fwd, bwd


def wide_edge_rows(dev, g):
    """Rows 1 and 2, untimed, at WIDE_EDGE_HD x WIDE_EDGE_T (one head, B 2,
    every shape the gate admits), bf16 and fp32; the worst of each kernel
    and dtype printed."""
    import torch

    from pdm_tpu_torch.ops import attention as attn_op

    fwd_rows, bwd_rows = [], []
    for dtype in (torch.bfloat16, torch.float32):
        for T in WIDE_EDGE_T:
            for hd in WIDE_EDGE_HD:
                if not attn_op.use_fused_attention(T, hd, 1):
                    continue
                f, b = attention_rows(None, dev, g, 2, T, hd, 1, 0, dtype,
                                      timed=False)
                fwd_rows.append(f)
                bwd_rows.append(b)
    for dname in ("bfloat16", "float32"):
        f = [r for r in fwd_rows if r["dtype"] == dname]
        b = [r for r in bwd_rows if r["dtype"] == dname]
        log(f"attention wide-head edges {dname}: hd {WIDE_EDGE_HD} x T "
            f"{WIDE_EDGE_T}, {len(f)} shapes: worst forward "
            f"{max(r['worst_of_tolerance'] for r in f):.3g}, backward "
            f"{max(r['worst_of_tolerance'] for r in b):.3g} of the tolerance; "
            f"every call bitwise repeatable")
    return fwd_rows, bwd_rows


def model_calls(net, x, tau):
    """One forward of `net` with hooks: {(T, C, heads): calls} of its
    attention blocks and {(S, C, act): calls} of its GroupNorms."""
    import torch

    from pdm_tpu_torch.models.unet import AttentionBlock, GroupNormAct

    attn, gn = {}, {}

    def count(table, key):
        table[key] = table.get(key, 0) + 1

    hooks = []
    for m in net.modules():
        if isinstance(m, GroupNormAct):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, a: count(gn, (a[0].shape[2] * a[0].shape[3],
                                          a[0].shape[1], mod.act))))
        elif isinstance(m, AttentionBlock):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, a: count(attn, (a[0].shape[2] * a[0].shape[3],
                                            a[0].shape[1], mod.heads))))
    try:
        with torch.no_grad():
            net(x, tau)
    finally:
        for h in hooks:
            h.remove()
    return attn, gn


@contextlib.contextmanager
def plain_on_card_spy():
    """Counts calls of the plain versions of rows 1, 2, 5 and 6 (the
    modules' references, and the UNet's attention_reference) whose first
    tensor lies on the card, for the duration: {name: n}."""
    import pdm_tpu_torch.models.unet as unet_mod
    from pdm_tpu_torch.ops import attention as attn_op
    from pdm_tpu_torch.ops import attention_block as tb

    calls = {}
    patched = [(attn_op, "_reference_with_lse"), (attn_op, "attention_bwd_reference"),
               (tb, "_reference_with_lse"), (tb, "attention_block_reference"),
               (tb, "attention_block_bwd_reference"), (unet_mod, "attention_reference")]
    real = {(mod, name): getattr(mod, name) for mod, name in patched}

    def spy(key, fn):
        def call(*args, **kw):
            if any(getattr(a, "is_cuda", False) for a in args[:2]):
                calls[key] = calls.get(key, 0) + 1
            return fn(*args, **kw)
        return call

    for (mod, name), fn in real.items():
        setattr(mod, name, spy(f"{mod.__name__.split('.')[-1]}.{name}", fn))
    try:
        yield calls
    finally:
        for (mod, name), fn in real.items():
            setattr(mod, name, fn)


def block_launch_counts():
    from pdm_tpu_torch.ops import attention_block as tb

    return {"block_fwd": tb.fused_attention_block.launches,
            "block_bwd": tb.attention_block_bwd.launches}


def zero_block_launches():
    from pdm_tpu_torch.ops import attention_block as tb

    tb.fused_attention_block.launches = 0
    tb.attention_block_bwd.launches = 0


def tiny_single_head_step(dev) -> dict:
    """PDM_FUSED_BLOCK=1, fp32: one train step of SINGLE_TINY (its four
    blocks one head of 128 at 8 x 8: rows 5 and 6 on the staged plan) on
    the card against the CPU, as tests/test_torch_cuda.py holds the
    flagship-sized tiny UNet: loss within 1e-4, each gradient the step
    applied within 1e-4 of its scale plus 1e-6 of the largest; launches
    exact (rows 5 and 6 three and eight a block, rows 1 and 2 none), no
    plain version on a card tensor."""
    import torch
    from pdm_tpu_torch.diffusion.trainer import DDPMTrainer
    from pdm_tpu_torch.models.unet import unet_from_config
    from pdm_tpu_torch.models.unet_ddpm import UNetDDPM
    from pdm_tpu_torch.ops import attention_block as tb
    from pdm_tpu_torch.schedulers.analytic import LinearBetaScheduler

    rng = np.random.RandomState(26)
    cpu_net = unet_from_config(3, SINGLE_TINY, device="cpu")
    params = {k: torch.from_numpy((rng.standard_normal(tuple(v.shape)) * 0.1)
                                  .astype(np.float32))
              for k, v in cpu_net.named_parameters()}
    x0, eps = (torch.from_numpy(rng.standard_normal((4, 3, 16, 16)).astype(np.float32))
               for _ in range(2))
    tau = torch.from_numpy(rng.uniform(0, 1, 4).astype(np.float32))
    n_attn = sum(1 for n, _ in cpu_net.named_modules() if n.endswith("to_q"))
    heads = sorted({m.heads for m in cpu_net.modules() if hasattr(m, "to_q")})
    out = {}
    with env_var("PDM_FUSED_BLOCK", "1"), plain_on_card_spy() as plain:
        for d in (torch.device("cpu"), dev):
            net = cpu_net if d.type == "cpu" else unet_from_config(3, SINGLE_TINY, device=d)
            tr = DDPMTrainer(UNetDDPM(LinearBetaScheduler(1e-4, 1e2), net, device=d),
                             learning_rate=1e-3, warmup_steps=0, grad_clip=1e3)
            state = tr.init_state(params)
            zero_launches()
            zero_block_launches()
            state, m, grads = train_step_with_grads(tr, state, x0.to(d), tau=tau.to(d),
                                                    eps=eps.to(d))
            out[d.type] = (float(m["loss"]), grads,
                           {**launch_counts(), **block_launch_counts()})
            del net, tr, state
    cpu, card = out["cpu"], out["cuda"]
    want = {"attention_fwd": 0, "attention_bwd": 0, "group_norm_fwd": card[2]["group_norm_fwd"],
            "group_norm_bwd": card[2]["group_norm_bwd"],
            "block_fwd": BLOCK_LAUNCHES["staged", False] * n_attn,
            "block_bwd": BLOCK_LAUNCHES["staged", True] * n_attn}
    loss_err = abs(card[0] - cpu[0]) / abs(cpu[0])
    top = max(float(g.abs().max()) for g in cpu[1].values())
    worst = max(float((card[1][k] - g).abs().max())
                / (1e-4 * float(g.abs().max()) + 1e-6 * top) for k, g in cpu[1].items())
    log(f"single-head tiny UNet ({n_attn} blocks, heads {heads}, one of 128 at 8 x 8: "
        f"{tb.block_route(64, 128, 1)}) fp32 train step B=4, PDM_FUSED_BLOCK=1, card vs "
        f"CPU: loss {card[0]:.6g} vs {cpu[0]:.6g} (rel err {loss_err:.3g}, tol 1e-4); "
        f"worst gradient error {worst:.3g} of its tolerance (1e-4 of its scale + 1e-6 "
        f"of {top:.3g}); card launches {card[2]} (want {want}); plain versions on card "
        f"tensors {plain}")
    if (loss_err > 1e-4 or worst > 1.0 or card[2] != want or plain
            or cpu[2]["block_fwd"] or cpu[2]["block_bwd"]):
        fail("single-head tiny UNet: the fp32 opt-in train step on the card disagrees "
             "with the CPU, or its launches are wrong")
    return {"loss_rel_err": loss_err, "worst_of_tolerance": worst, "launches": card[2]}


def launch_counts():
    from pdm_tpu_torch.ops import attention as attn_op
    from pdm_tpu_torch.ops import groupnorm as gn_op

    return {"attention_fwd": attn_op.fused_spatial_attention.launches,
            "attention_bwd": attn_op.attention_bwd.launches,
            "group_norm_fwd": gn_op.fused_group_norm_act.launches,
            "group_norm_bwd": gn_op.group_norm_bwd.launches}


def zero_launches():
    from pdm_tpu_torch.ops import attention as attn_op
    from pdm_tpu_torch.ops import groupnorm as gn_op

    for fn in (attn_op.fused_spatial_attention, attn_op.attention_bwd,
               gn_op.fused_group_norm_act, gn_op.group_norm_bwd):
        fn.launches = 0


def host_clock() -> dict:
    """The host's state now, beside a host-bound time: the load average,
    the cores' current clocks as /proc/cpuinfo lists them (none where it
    lists none), and the ms a fixed pure-Python loop takes this thread."""
    mhz = []
    try:
        with open("/proc/cpuinfo") as f:
            mhz = [float(line.split(":")[1]) for line in f if line.startswith("cpu MHz")]
    except (OSError, ValueError):
        mhz = []
    t0 = time.perf_counter()
    acc = 0
    for i in range(200_000):
        acc += i & 7
    return {"load_1m": os.getloadavg()[0],
            "mhz_mean": statistics.fmean(mhz) if mhz else None,
            "mhz_min": min(mhz, default=None), "mhz_max": max(mhz, default=None),
            "loop_ms": (time.perf_counter() - t0) * 1e3}


def highres_phase(time_ms, dev, smi: str) -> dict:
    """Phase 23: the 256x256 family (CELEBAHQ_UNET, bf16, seeded weights)
    and the single-head 32 x 32 DDPM on the card. (a) The family's layout
    from one card forward with hooks: 113.67 M parameters, 6 attention
    blocks of one head of 512, 71 GroupNorms. (b) Rows 1 and 2 against
    their plain versions at every attention shape of the family (B 8) and
    of the single-head 32 x 32 model (B 64 forward, B 128 backward), bf16
    and fp32, timed, and at the wide kernels' edge head dims, untimed;
    rows 3 and 4 at every GroupNorm shape of the family at B 8, timed.
    (c) Sampling through the diffusers entry point: config.json and the
    seeded weights written by write_safetensors into a temporary
    directory, then load_config -> ddpm_from_config(model_name diffusers)
    -> the sample CLI's build_sampler: DDIM-50 at batch 8, two batches,
    with exact launches (6 row-1 and 71 row-3 a step) and no plain
    attention on a CUDA tensor; ms a step, samples/s, peak memory and the
    card's idle share. (d) DDPMTrainer at batch 8 x grad_accum 16 (the
    global batch 128 of scripts/endurance_256.py), three steps on seeded
    N(0, 1) 256 x 256 data after a warm one: finite loss, exact launches
    (rows 1-4: 6, 12, 71 and 71 a micro-batch), ms a step, img/s, peak
    memory, idle share. (e) The fp32 family at batch 1 on the card against
    the same weights on the CPU (FORWARD_TOL). (f) The single-head 32 x 32
    DDPM's DDIM-10 at batch 64: 6 row-1 (head dim 256) and 51 row-3
    launches a step. Rows 5 and 6 at every geometry JAX's gate admits: in
    (b) on the staged plan at the family's (B 8) and the single-head 32 x
    32's blocks (B 64; B 128 with the backward) and at BLOCK_WIDE_EDGES;
    then with PDM_FUSED_BLOCK=1 (g) (c)'s sampler (6 row-5 calls, 18
    launches, a step), (h) (d)'s trainer (6 row-5 and row-6 calls a
    micro-batch), (i) (e)'s forward against the same CPU output, (j) the
    fp32 train step of a single-head tiny UNet card vs CPU, (k) (f)'s
    sampler, each with exact launches and no plain version of rows 1, 2,
    5 or 6 on a card tensor."""
    import torch

    from pdm_tpu_torch.config.loader import (
        load_config, parse_args_from_config, update_config_from_args,
    )
    from pdm_tpu_torch.diffusion.sampling import DDPMSampler
    from pdm_tpu_torch.diffusion.trainer import DDPMTrainer, step_generator
    from pdm_tpu_torch.models.configs import (
        CELEBAHQ_UNET, HIGHRES_CALLS, HIGHRES_PARAMS_M, HIGHRES_SIZE,
    )
    from pdm_tpu_torch.models.diffusers_import import write_safetensors
    from pdm_tpu_torch.models.from_config import ddpm_from_config
    from pdm_tpu_torch.models.unet import unet_from_config
    from pdm_tpu_torch.models.unet_ddpm import UNetDDPM
    from pdm_tpu_torch.schedulers.analytic import LinearBetaScheduler
    from pdm_tpu_torch.scripts.sample import build_sampler

    t_phase = time.perf_counter()
    out = {"smi": smi}
    g = torch.Generator(device=dev).manual_seed(23)
    size = HIGHRES_SIZE

    # (a) the family's layout: the fp32 CPU model (also (e)'s reference)
    cpu_net = unet_from_config(3, CELEBAHQ_UNET, dtype=torch.float32, device="cpu")
    weights = seeded_state_dict(cpu_net, seed=23)
    cpu_net.load_state_dict(weights)
    n_params = sum(p.numel() for p in cpu_net.parameters())
    net = unet_from_config(3, CELEBAHQ_UNET, dtype=torch.bfloat16, device=dev)
    net.load_state_dict(weights)
    attn_calls, gn_calls = model_calls(
        net, torch.randn(1, 3, size, size, generator=g, device=dev).bfloat16(),
        torch.tensor([0.5], device=dev))
    per_fwd = {"attention": sum(attn_calls.values()), "group_norm": sum(gn_calls.values())}
    log(f"256x256 family: {n_params:,} parameters; per forward {per_fwd} "
        f"(attention (T, C, heads): {attn_calls}; {len(gn_calls)} GroupNorm "
        f"shapes (S, C, act))")
    if (round(n_params / 1e6, 2) != HIGHRES_PARAMS_M or per_fwd != HIGHRES_CALLS
            or any(h != 1 or c != 512 for _, c, h in attn_calls)):
        fail(f"256x256 family: {n_params} parameters, {per_fwd} calls, attention "
             f"{attn_calls}: not the family's layout")
    del net

    # (b) the kernels at the family's shapes and the single-head 32 x 32's
    sh_attn = {(256, 256, 1): 5, (16, 256, 1): 1}
    fwd_family, bwd_family, fwd_single, bwd_single = [], [], [], []
    for dtype in (torch.bfloat16, torch.float32):
        bf16 = dtype == torch.bfloat16
        for (T, C, heads), calls in sorted(attn_calls.items(), reverse=True):
            f, b = attention_rows(time_ms, dev, g, HIGHRES_BATCH, T, C, heads,
                                  calls if bf16 else 0, dtype)
            fwd_family.append(f)
            bwd_family.append(b)
        for (T, C, heads), calls in sorted(sh_attn.items(), reverse=True):
            c = calls if bf16 else 0
            fwd_single.append(attention_rows(time_ms, dev, g, BATCH, T, C, heads, c,
                                             dtype, backward=False)[0])
            bwd_single.append(attention_rows(time_ms, dev, g, TRAIN_BATCH, T, C,
                                             heads, c, dtype, forward=False)[1])
    edge_fwd, edge_bwd = wide_edge_rows(dev, g)
    # rows 5 and 6 (the staged plan) at the family's and the single-head
    # 32 x 32's blocks, then at the edges of JAX's geometry
    fam_blk, fam_blk_bwd = block_kernel_rows(time_ms, dev, FAMILY_BLOCK_GEOMS,
                                             (HIGHRES_BATCH,), seed=25)
    sh_blk, sh_blk_bwd = block_kernel_rows(time_ms, dev, SINGLE_BLOCK_GEOMS,
                                           (BATCH, TRAIN_BATCH), seed=26)
    blk_edge_fwd, blk_edge_bwd = block_edge_rows(dev, BLOCK_WIDE_EDGES, seed=27)
    gn_fwd, gn_bwd = [], []
    for (S, C, act), calls in sorted(gn_calls.items(), key=lambda kv: -kv[0][0] * kv[0][1]):
        f, b = group_norm_rows(time_ms, dev, g, HIGHRES_BATCH, S, C, 32, "bfloat16",
                               act, calls)
        gn_fwd.append(f)
        gn_bwd.append(b)
    torch.cuda.empty_cache()
    out["rows"] = {"attention_fwd": fwd_family, "attention_bwd": bwd_family,
                   "single_fwd": fwd_single, "single_bwd": bwd_single,
                   "edge_fwd": edge_fwd, "edge_bwd": edge_bwd,
                   "group_norm_fwd": gn_fwd, "group_norm_bwd": gn_bwd,
                   "block_fwd": fam_blk[HIGHRES_BATCH], "block_bwd": fam_blk_bwd,
                   "single_block_fwd": sh_blk[BATCH],
                   "single_block_fwd_train": sh_blk[TRAIN_BATCH],
                   "single_block_bwd": sh_blk_bwd,
                   "block_edge_fwd": blk_edge_fwd, "block_edge_bwd": blk_edge_bwd}
    log(f"phase 23 (b) done at {time.perf_counter() - t_phase:.1f} s")

    # (c) the diffusers entry point: write, load, sample
    tmp = tempfile.mkdtemp(prefix="pdm_highres_")
    try:
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump({"_class_name": "UNet2DModel", "sample_size": size,
                       "in_channels": 3, "out_channels": 3, **CELEBAHQ_UNET}, f)
        t0 = time.perf_counter()
        write_safetensors(os.path.join(tmp, "diffusion_pytorch_model.safetensors"),
                          weights)
        write_s = time.perf_counter() - t0
        cfg = load_config()
        update_config_from_args(cfg, parse_args_from_config(cfg, [
            "--dataset_name", "celeba-hq", "--ddpm.model_name", "diffusers",
            "--ddpm.diffusers_path", tmp, "--ddpm.precision", "bf16",
            "--sample.step_type", "ddim", "--sample.n_steps", str(HIGHRES_STEPS),
            "--sample.batch_size", str(HIGHRES_BATCH),
            "--sample.n_samples", str(HIGHRES_SAMPLES),
            "--sample.precision", "half"]))
        t0 = time.perf_counter()
        ddpm = ddpm_from_config(cfg, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    loaded = ddpm.module.state_dict()
    same = loaded.keys() == weights.keys() and all(
        torch.equal(loaded[k].cpu(), v.to(loaded[k].dtype)) for k, v in weights.items())
    log(f"256x256 family through the diffusers entry point: safetensors "
        f"written in {write_s:.2f} s, ddpm_from_config(model_name diffusers) "
        f"built the {cfg.ddpm.precision} model on {ddpm.device} in {load_s:.2f} s "
        f"(tau_scale {ddpm.tau_scale}); weights bitwise the written ones cast to "
        f"the module's dtypes: {same}")
    if not same or ddpm.device != dev or ddpm.module.dtype != torch.bfloat16:
        fail("256x256 family: the diffusers import did not give the written model")
    sampler = build_sampler(cfg, ddpm=ddpm, device=dev)
    if (sampler.step_type, sampler.n_steps, sampler.batch_size) != (
            "ddim", HIGHRES_STEPS, HIGHRES_BATCH):
        fail("256x256 family: build_sampler did not give DDIM-50 at batch 8")
    # a short run of the same sampler: the warm-up, then the profiled window
    short = DDPMSampler(ddpm=ddpm, scheduler=sampler.scheduler,
                        n_steps=HIGHRES_PROFILE_STEPS, obj_size=(3, size, size),
                        batch_size=HIGHRES_BATCH, n_samples=HIGHRES_BATCH,
                        step_type="ddim", precision="half", device=dev)
    short.batch_sample(torch.Generator(device=dev).manual_seed(1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with plain_on_card_spy() as plain:
        host = [host_clock()]
        zero_launches()
        t0 = time.perf_counter()
        samples = sampler.sample()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        host.append(host_clock())
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    x = torch.as_tensor(samples["x"])
    n_steps = HIGHRES_STEPS * (HIGHRES_SAMPLES // HIGHRES_BATCH)
    ms_step = wall / n_steps * 1e3
    busy = profile_steps(lambda: short.batch_sample(
        torch.Generator(device=dev).manual_seed(4)), HIGHRES_PROFILE_STEPS,
        label="256x256 sampling profile")
    want = {"attention_fwd": 6 * n_steps, "attention_bwd": 0,
            "group_norm_fwd": 71 * n_steps, "group_norm_bwd": 0}
    log(f"256x256 family sampling: DDIM-{HIGHRES_STEPS}, {HIGHRES_SAMPLES} samples "
        f"in batches of {HIGHRES_BATCH}: {wall:.3f} s, {ms_step:.3f} ms/step, "
        f"{HIGHRES_SAMPLES / wall:.3f} samples/s, peak memory {peak:.2f} GiB; "
        f"launches {launches} (want {want}); plain attention calls on CUDA "
        f"tensors {sum(plain.values())}; the card busy {busy:.3f} ms of a step, idle "
        f"{1.0 - busy / ms_step:.1%}; output {tuple(x.shape)} mean "
        f"{float(x.float().mean()):.4g} std {float(x.float().std()):.4g}; host "
        f"before / after {host}")
    if launches != want or sum(plain.values()):
        fail(f"256x256 family sampling: launches {launches} != {want} or plain "
             f"attention on CUDA tensors {sum(plain.values())} times")
    if tuple(x.shape) != (HIGHRES_SAMPLES, 3, size, size) or not bool(
            torch.isfinite(x).all()):
        fail(f"256x256 family sampling: output not finite of shape "
             f"({HIGHRES_SAMPLES}, 3, {size}, {size})")
    out["sampling"] = {"launches": launches, "steps": n_steps, "ms_per_step": ms_step,
                       "samples_per_s": HIGHRES_SAMPLES / wall, "peak_gib": peak,
                       "busy_ms_per_step": busy, "idle_share": 1.0 - busy / ms_step,
                       "plain_attention_cuda_calls": sum(plain.values()), "host": host}

    # (g) the same sampler with PDM_FUSED_BLOCK=1: rows 5 and 6 on the
    # staged plan in every attention block, no row-1 launch
    n_blk = HIGHRES_CALLS["attention"]
    with env_var("PDM_FUSED_BLOCK", "1"):
        short.batch_sample(torch.Generator(device=dev).manual_seed(1))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with plain_on_card_spy() as plain_b:
            host = [host_clock()]
            zero_launches()
            zero_block_launches()
            t0 = time.perf_counter()
            samples = sampler.sample()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {**launch_counts(), **block_launch_counts()}
            host.append(host_clock())
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        busy = profile_steps(lambda: short.batch_sample(
            torch.Generator(device=dev).manual_seed(4)), HIGHRES_PROFILE_STEPS,
            label="256x256 sampling profile, PDM_FUSED_BLOCK=1")
    x = torch.as_tensor(samples["x"])
    ms_blk = wall / n_steps * 1e3
    want = {"attention_fwd": 0, "attention_bwd": 0, "group_norm_fwd": 71 * n_steps,
            "group_norm_bwd": 0, "block_fwd": 3 * n_blk * n_steps, "block_bwd": 0}
    log(f"256x256 family sampling, PDM_FUSED_BLOCK=1: DDIM-{HIGHRES_STEPS}, "
        f"{HIGHRES_SAMPLES} samples in batches of {HIGHRES_BATCH}: {wall:.3f} s, "
        f"{ms_blk:.3f} ms/step (without the opt-in {ms_step:.3f}), "
        f"{HIGHRES_SAMPLES / wall:.3f} samples/s, peak memory {peak:.2f} GiB; launches "
        f"{launches} (want {want}: {n_blk} row-5 calls a step, three launches each); "
        f"plain versions on CUDA tensors {plain_b}; the card busy {busy:.3f} ms of a "
        f"step, idle {1.0 - busy / ms_blk:.1%}; output {tuple(x.shape)} mean "
        f"{float(x.float().mean()):.4g} std {float(x.float().std()):.4g}; host before / "
        f"after {host}")
    if launches != want or plain_b:
        fail(f"256x256 family sampling with PDM_FUSED_BLOCK=1: launches {launches} != "
             f"{want} or plain versions on CUDA tensors {plain_b}")
    if tuple(x.shape) != (HIGHRES_SAMPLES, 3, size, size) or not bool(
            torch.isfinite(x).all()):
        fail("256x256 family sampling with PDM_FUSED_BLOCK=1: output not finite or "
             "of the wrong shape")
    out["sampling_block"] = {"launches": launches, "steps": n_steps, "ms_per_step": ms_blk,
                             "samples_per_s": HIGHRES_SAMPLES / wall, "peak_gib": peak,
                             "busy_ms_per_step": busy, "idle_share": 1.0 - busy / ms_blk,
                             "host": host}
    # the two in alternating turns: (f) and (g) ran one after the other
    gen_t = torch.Generator(device=dev).manual_seed(5)
    out["sampling_turns"] = block_turns(lambda: sampler.batch_sample(gen_t),
                                        HIGHRES_TURN_PAIRS, HIGHRES_STEPS)
    log(turns_summary("256x256 family sampling (DDIM, one batch a turn)",
                      out["sampling_turns"]))
    del ddpm, sampler, short, samples, x
    torch.cuda.empty_cache()

    # (d) the train step: batch 8 x grad_accum 16
    sched = LinearBetaScheduler(1e-4, 2.478e4)
    net_t = unet_from_config(3, CELEBAHQ_UNET, dtype=torch.bfloat16, device=dev)
    ddpm_t = UNetDDPM(sched, net_t, parametrization="eps", device=dev)
    trainer = DDPMTrainer(ddpm_t, learning_rate=1e-4, warmup_steps=100,
                          total_iters=1000, grad_clip=1.0, ema_decay=0.999,
                          grad_accum=HIGHRES_ACCUM)
    state = trainer.init_state(weights)
    global_batch = HIGHRES_BATCH * HIGHRES_ACCUM
    x_train = torch.randn(global_batch, 3, size, size, generator=g, device=dev)
    state, _ = trainer.train_step(state, x_train, step_generator(0, 1, dev))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    with plain_on_card_spy() as plain:
        host = [host_clock()]
        zero_launches()
        t0 = time.perf_counter()
        for it in range(HIGHRES_TRAIN_STEPS):
            state, m = trainer.train_step(state, x_train, step_generator(0, it + 2, dev))
            losses.append(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        host.append(host_clock())
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = torch.stack(losses).float().cpu()
    micro = HIGHRES_TRAIN_STEPS * HIGHRES_ACCUM
    want = {"attention_fwd": 6 * micro, "attention_bwd": 12 * micro,
            "group_norm_fwd": 71 * micro, "group_norm_bwd": 71 * micro}
    ms_step = wall / HIGHRES_TRAIN_STEPS * 1e3
    gen_p = step_generator(0, 100, dev)
    busy = profile_steps(lambda: trainer.train_step(state, x_train, gen_p), 1,
                         label="256x256 training profile")
    log(f"256x256 family training: bf16, fp32 masters, batch {HIGHRES_BATCH} x "
        f"grad_accum {HIGHRES_ACCUM} = {global_batch}: {HIGHRES_TRAIN_STEPS} steps "
        f"in {wall:.3f} s, {ms_step:.3f} ms/step, {global_batch / ms_step * 1e3:.3f} "
        f"img/s, peak memory {peak:.2f} GiB; losses {losses.tolist()}; launches "
        f"{launches} (want {want}); plain attention calls on CUDA tensors "
        f"{sum(plain.values())}; the card busy {busy:.3f} ms of a step, idle "
        f"{1.0 - busy / ms_step:.1%}; host before / after {host}")
    if launches != want or sum(plain.values()):
        fail(f"256x256 family training: launches {launches} != {want} or plain "
             f"attention on CUDA tensors {sum(plain.values())} times")
    if not bool(torch.isfinite(losses).all()):
        fail("256x256 family training: loss not finite")
    out["training"] = {"launches": launches, "micro_batches": micro,
                       "ms_per_step": ms_step, "img_per_s": global_batch / ms_step * 1e3,
                       "peak_gib": peak, "busy_ms_per_step": busy,
                       "idle_share": 1.0 - busy / ms_step, "losses": losses.tolist(),
                       "host": host}

    # (h) the same trainer with PDM_FUSED_BLOCK=1: a warm step, then three
    with env_var("PDM_FUSED_BLOCK", "1"):
        state, _ = trainer.train_step(state, x_train, step_generator(0, 50, dev))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses = []
        with plain_on_card_spy() as plain_b:
            host = [host_clock()]
            zero_launches()
            zero_block_launches()
            t0 = time.perf_counter()
            for it in range(HIGHRES_TRAIN_STEPS):
                state, m = trainer.train_step(state, x_train,
                                              step_generator(0, it + 60, dev))
                losses.append(m["loss"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {**launch_counts(), **block_launch_counts()}
            host.append(host_clock())
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        gen_p = step_generator(0, 101, dev)
        busy = profile_steps(lambda: trainer.train_step(state, x_train, gen_p), 1,
                             label="256x256 training profile, PDM_FUSED_BLOCK=1")
    losses = torch.stack(losses).float().cpu()
    ms_blk = wall / HIGHRES_TRAIN_STEPS * 1e3
    want = {"attention_fwd": 0, "attention_bwd": 0, "group_norm_fwd": 71 * micro,
            "group_norm_bwd": 71 * micro, "block_fwd": 3 * n_blk * micro,
            "block_bwd": 8 * n_blk * micro}
    log(f"256x256 family training, PDM_FUSED_BLOCK=1: {HIGHRES_TRAIN_STEPS} steps in "
        f"{wall:.3f} s, {ms_blk:.3f} ms/step (without the opt-in {ms_step:.3f}), "
        f"{global_batch / ms_blk * 1e3:.3f} img/s, peak memory {peak:.2f} GiB; losses "
        f"{losses.tolist()}; launches {launches} (want {want}: {n_blk} row-5 and "
        f"row-6 calls a micro-batch, three and eight launches each); plain versions on "
        f"CUDA tensors {plain_b}; the card busy {busy:.3f} ms of a step, idle "
        f"{1.0 - busy / ms_blk:.1%}; host before / after {host}")
    if launches != want or plain_b:
        fail(f"256x256 family training with PDM_FUSED_BLOCK=1: launches {launches} != "
             f"{want} or plain versions on CUDA tensors {plain_b}")
    if not bool(torch.isfinite(losses).all()):
        fail("256x256 family training with PDM_FUSED_BLOCK=1: loss not finite")
    out["training_block"] = {"launches": launches, "micro_batches": micro,
                             "ms_per_step": ms_blk,
                             "img_per_s": global_batch / ms_blk * 1e3, "peak_gib": peak,
                             "busy_ms_per_step": busy, "idle_share": 1.0 - busy / ms_blk,
                             "losses": losses.tolist(), "host": host}

    def train_turn():
        nonlocal state
        state, _ = trainer.train_step(state, x_train, step_generator(0, 70, dev))

    out["training_turns"] = block_turns(train_turn, HIGHRES_TURN_PAIRS, 1)
    log(turns_summary("256x256 family training (one step a turn)", out["training_turns"]))
    del trainer, state, net_t, ddpm_t, x_train
    torch.cuda.empty_cache()

    # (e) fp32 forward at batch 1, card against CPU
    net32 = unet_from_config(3, CELEBAHQ_UNET, dtype=torch.float32, device=dev)
    net32.load_state_dict(weights)
    rng = np.random.RandomState(23)
    x1 = torch.from_numpy(rng.standard_normal((1, 3, size, size)).astype(np.float32))
    tau1 = torch.tensor([0.5])
    zero_launches()
    with torch.no_grad():
        card = net32(x1.to(dev), tau1.to(dev)).cpu()
        n_card = launch_counts()
        t0 = time.perf_counter()
        ref = cpu_net(x1, tau1)
        cpu_s = time.perf_counter() - t0
    scale_o = float(ref.abs().max())
    err = float((card - ref).abs().max())
    log(f"256x256 family fp32 forward B=1, card (kernels: {n_card}) vs CPU (plain, "
        f"{cpu_s:.1f} s): max_abs_err {err:.3g} of output scale {scale_o:.3g} "
        f"(tol {FORWARD_TOL} of scale)")
    if not (math.isfinite(err) and err <= FORWARD_TOL * scale_o) or (
            n_card["attention_fwd"], n_card["group_norm_fwd"]) != (6, 71):
        fail("256x256 family fp32 forward on the card disagrees with the CPU")
    out["card_vs_cpu"] = {"max_abs_err": err, "scale": scale_o}
    # (i) the same with PDM_FUSED_BLOCK=1 against the same CPU output
    with env_var("PDM_FUSED_BLOCK", "1"), torch.no_grad(), plain_on_card_spy() as plain_b:
        zero_launches()
        zero_block_launches()
        card = net32(x1.to(dev), tau1.to(dev)).cpu()
        n_card = {**launch_counts(), **block_launch_counts()}
    err = float((card - ref).abs().max())
    log(f"256x256 family fp32 forward B=1, PDM_FUSED_BLOCK=1, card (kernels: {n_card}) "
        f"vs CPU: max_abs_err {err:.3g} of output scale {scale_o:.3g} (tol {FORWARD_TOL} "
        f"of scale); plain versions on CUDA tensors {plain_b}")
    if not (math.isfinite(err) and err <= FORWARD_TOL * scale_o) or plain_b or (
            n_card["attention_fwd"], n_card["block_fwd"], n_card["group_norm_fwd"]) != (
            0, 3 * n_blk, 71):
        fail("256x256 family fp32 forward with PDM_FUSED_BLOCK=1 on the card disagrees "
             "with the CPU")
    out["card_vs_cpu_block"] = {"max_abs_err": err, "scale": scale_o}
    del net32, cpu_net
    # (j) a single-head UNet's fp32 train step with the opt-in, card vs CPU
    out["tiny_single_head_step"] = tiny_single_head_step(dev)

    # (f) the single-head 32 x 32 DDPM, DDIM-10 at batch 64
    net_s = unet_from_config(3, SINGLE_HEAD, dtype=torch.bfloat16, device=dev)
    net_s.load_state_dict(seeded_state_dict(
        unet_from_config(3, SINGLE_HEAD, device="meta"), seed=24))
    ddpm_s = UNetDDPM(sched, net_s, parametrization="eps", device=dev)
    attn_s, gn_s = model_calls(
        net_s, torch.randn(1, 3, 32, 32, generator=g, device=dev).bfloat16(),
        torch.tensor([0.5], device=dev))
    sampler = DDPMSampler(ddpm=ddpm_s, scheduler=sched, n_steps=SINGLE_HEAD_STEPS,
                          obj_size=(3, 32, 32), batch_size=BATCH, n_samples=BATCH,
                          step_type="ddim", precision="half", device=dev)
    sampler.batch_sample(torch.Generator(device=dev).manual_seed(2))
    torch.cuda.synchronize()
    with plain_on_card_spy() as plain:
        zero_launches()
        t0 = time.perf_counter()
        xs = sampler.batch_sample(torch.Generator(device=dev).manual_seed(3))["x"]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
    n_s = sum(p.numel() for p in net_s.parameters())
    want = {"attention_fwd": SINGLE_HEAD_CALLS["attention"] * SINGLE_HEAD_STEPS,
            "attention_bwd": 0,
            "group_norm_fwd": SINGLE_HEAD_CALLS["group_norm"] * SINGLE_HEAD_STEPS,
            "group_norm_bwd": 0}
    log(f"single-head 32x32 DDPM ({n_s:,} parameters; attention {attn_s}): "
        f"DDIM-{SINGLE_HEAD_STEPS} at batch {BATCH}: {wall / SINGLE_HEAD_STEPS * 1e3:.3f} "
        f"ms/step; launches {launches} (want {want}); plain attention calls on "
        f"CUDA tensors {sum(plain.values())}")
    if (launches != want or sum(plain.values()) or set(attn_s) != set(sh_attn)
            or sum(gn_s.values()) != SINGLE_HEAD_CALLS["group_norm"]
            or not bool(torch.isfinite(xs).all())):
        fail("single-head 32x32 DDPM: launches, layout or output wrong")
    out["single_head"] = {"launches": launches, "steps": SINGLE_HEAD_STEPS,
                          "ms_per_step": wall / SINGLE_HEAD_STEPS * 1e3,
                          "params": n_s}
    # (k) the same sampler with PDM_FUSED_BLOCK=1
    with env_var("PDM_FUSED_BLOCK", "1"):
        sampler.batch_sample(torch.Generator(device=dev).manual_seed(2))
        torch.cuda.synchronize()
        with plain_on_card_spy() as plain_b:
            zero_launches()
            zero_block_launches()
            t0 = time.perf_counter()
            xs = sampler.batch_sample(torch.Generator(device=dev).manual_seed(3))["x"]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {**launch_counts(), **block_launch_counts()}
    n_sh = SINGLE_HEAD_CALLS["attention"]
    want = {"attention_fwd": 0, "attention_bwd": 0,
            "group_norm_fwd": SINGLE_HEAD_CALLS["group_norm"] * SINGLE_HEAD_STEPS,
            "group_norm_bwd": 0, "block_fwd": 3 * n_sh * SINGLE_HEAD_STEPS, "block_bwd": 0}
    log(f"single-head 32x32 DDPM, PDM_FUSED_BLOCK=1: DDIM-{SINGLE_HEAD_STEPS} at batch "
        f"{BATCH}: {wall / SINGLE_HEAD_STEPS * 1e3:.3f} ms/step; launches {launches} "
        f"(want {want}: {n_sh} row-5 calls a step); plain versions on CUDA tensors "
        f"{plain_b}")
    if launches != want or plain_b or not bool(torch.isfinite(xs).all()):
        fail("single-head 32x32 DDPM with PDM_FUSED_BLOCK=1: launches or output wrong")
    out["single_head_block"] = {"launches": launches, "steps": SINGLE_HEAD_STEPS,
                                "ms_per_step": wall / SINGLE_HEAD_STEPS * 1e3}
    del net_s, ddpm_s, sampler
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 23 took {out['seconds']:.1f} s")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    # cuBLAS is deterministic under use_deterministic_algorithms only with
    # this workspace setting, read at its first call; 8 buffers of 4 MiB is
    # PyTorch's default on Hopper (phase 6's probe turns the mode on)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from pdm_tpu_torch.diffusion.sampling import DDPMSampler
    from pdm_tpu_torch.diffusion.trainer import DDPMTrainer, step_generator
    from pdm_tpu_torch.models.unet import (
        AttentionBlock, GroupNormAct, unet_from_config,
    )
    from pdm_tpu_torch.models.unet_ddpm import UNetDDPM
    from pdm_tpu_torch.ops import _build
    from pdm_tpu_torch.ops import attention as attn_op
    from pdm_tpu_torch.ops import attention_block as block_op
    from pdm_tpu_torch.ops import groupnorm as gn_op
    from pdm_tpu_torch.schedulers.analytic import LinearBetaScheduler

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # ---- phase 1: card, versions, build ----
    log(f"phase 1 at {time.perf_counter() - t_start:.1f} s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.load_kernels()
    build_s = time.perf_counter() - t0
    regs = [ln.split("ptxas info    : ")[-1] for ln in _build.build_info["log"]
            if "registers" in ln]
    spills = [ln for ln in _build.build_info["log"]
              if "spill" in ln and " 0 bytes spill stores" not in ln]
    log(f"build: {build_s:.2f} s, {len(regs)} kernel instantiations "
        f"(sm_90a) into {_build.build_info['library']}; "
        f"registers per thread {sorted({r.split()[1] for r in regs})}; "
        f"spills: {spills or 'none'}")

    time_ms = make_timer(sleep_rate())

    # shapes the main path gives each kernel: one CPU forward of the
    # full-width flagship with hooks (also phase 3's CPU reference)
    sched = LinearBetaScheduler(1e-4, 2.478e4)
    cpu_net = unet_from_config(3, FLAGSHIP, dtype=torch.float32, device="cpu")
    weights = seeded_state_dict(cpu_net)
    cpu_net.load_state_dict(weights)
    gn_calls, attn_calls = {}, {}

    def gn_hook(mod, args):
        _, C, H, W = args[0].shape
        key = (H * W, C, mod.act)
        gn_calls[key] = gn_calls.get(key, 0) + 1

    def attn_hook(mod, args):
        _, C, H, W = args[0].shape
        key = (H * W, C, mod.heads)
        attn_calls[key] = attn_calls.get(key, 0) + 1

    hooks = []
    for m in cpu_net.modules():
        if isinstance(m, GroupNormAct):
            hooks.append(m.register_forward_pre_hook(gn_hook))
        elif isinstance(m, AttentionBlock):
            hooks.append(m.register_forward_pre_hook(attn_hook))
    rng = np.random.RandomState(1)
    x_small = torch.from_numpy(rng.standard_normal((2, 3, 32, 32)).astype(np.float32))
    tau_small = torch.tensor([0.3, 0.7])
    with torch.no_grad():
        ref_out = cpu_net(x_small, tau_small)
    for h in hooks:
        h.remove()
    gn_per_fwd = sum(gn_calls.values())
    attn_per_fwd = sum(attn_calls.values())
    log(f"flagship forward: {attn_per_fwd} attention launches "
        f"({len(attn_calls)} shapes), {gn_per_fwd} GroupNorm launches "
        f"({len(gn_calls)} distinct (S, C, act))")
    if (attn_per_fwd, gn_per_fwd) != (8, 69):
        fail(f"expected 8 attention and 69 GroupNorm calls per forward, got "
             f"{attn_per_fwd} and {gn_per_fwd}")

    # ---- phase 2: each kernel vs its plain version at the flagship shapes ----
    log(f"phase 2 at {time.perf_counter() - t_start:.1f} s")
    g = torch.Generator(device=dev).manual_seed(0)

    # the main path's attention shapes (T, C, heads) with their calls per
    # step, then the edge shapes (no calls on the main path; bf16 only)
    attn_shapes = sorted(attn_calls.items(), reverse=True) + [
        ((T, heads * hd, heads), 0) for T, hd, heads in ATTN_EDGES]

    def attention_fwd_rows(batch, dtypes, shapes):
        return [attention_rows(time_ms, dev, g, batch, T, C, heads,
                               calls if dtype == torch.bfloat16 else 0, dtype,
                               backward=False)[0]
                for dtype in dtypes for (T, C, heads), calls in shapes]

    def group_norm_shapes(batch, edges):
        """The main path's GroupNorm shapes at `batch` (bf16, 32 groups)
        with their calls per step, then (`edges`) the edge shapes."""
        return ([((batch, S, C, 32, "bfloat16", act), calls)
                 for (S, C, act), calls in sorted(gn_calls.items(), reverse=True)]
                + [(edge, 0) for edge in (GN_EDGES if edges else ())])

    def group_norm_fwd_rows(batch, edges):
        return [group_norm_rows(time_ms, dev, g, *shape, calls, backward=False)[0]
                for shape, calls in group_norm_shapes(batch, edges)]

    attn_main = sorted(attn_calls.items(), reverse=True)
    attn_rows = (attention_fwd_rows(BATCH, (torch.bfloat16,), attn_shapes)
                 + attention_fwd_rows(BATCH, (torch.float32,), attn_main))
    gn_rows = group_norm_fwd_rows(BATCH, edges=True)

    # ---- phase 3: full-width fp32 UNet and a short sample, card vs CPU ----
    log(f"phase 3 at {time.perf_counter() - t_start:.1f} s")
    net32 = unet_from_config(3, FLAGSHIP, dtype=torch.float32, device=dev)
    net32.load_state_dict(weights)
    with torch.no_grad():
        card_out = net32(x_small.to(dev), tau_small.to(dev)).cpu()
    scale_out = float(ref_out.abs().max())
    fwd_err = float((card_out - ref_out).abs().max())
    log(f"flagship UNet fp32 forward B=2, card (kernels) vs CPU (plain): "
        f"max_abs_err {fwd_err:.3g} of output scale {scale_out:.3g} "
        f"(tol {FORWARD_TOL} of scale)")
    if not (math.isfinite(fwd_err) and fwd_err <= FORWARD_TOL * scale_out):
        fail("fp32 UNet forward on the card disagrees with the CPU")

    x_init = torch.from_numpy(rng.standard_normal((2, 3, 32, 32)).astype(np.float32))
    samples = {}
    for name, net, d in (("cpu", cpu_net, "cpu"), ("card", net32, dev)):
        sampler = DDPMSampler(
            ddpm=UNetDDPM(sched, net, device=d), scheduler=sched, n_steps=10,
            obj_size=(3, 32, 32), batch_size=2, step_type="ddim", device=d)
        samples[name] = sampler.batch_sample(x_init=x_init)["x"].cpu()
    s_scale = float(samples["cpu"].abs().max())
    s_err = float((samples["card"] - samples["cpu"]).abs().max())
    log(f"10-step fp32 DDIM sample B=2, card vs CPU: max_abs_err {s_err:.3g} "
        f"of sample scale {s_scale:.3g} (tol {FORWARD_TOL} of scale)")
    if not (math.isfinite(s_err) and s_err <= FORWARD_TOL * s_scale):
        fail("fp32 DDIM sample on the card disagrees with the CPU")
    del net32, cpu_net

    # ---- phase 4: the main path ----
    log(f"phase 4 at {time.perf_counter() - t_start:.1f} s")
    net = unet_from_config(3, FLAGSHIP, dtype=torch.bfloat16, device=dev)
    net.load_state_dict(weights)
    ddpm = UNetDDPM(sched, net, parametrization="eps", device=dev)

    def sampler_of(n_steps):
        return DDPMSampler(
            ddpm=ddpm, scheduler=sched, n_steps=n_steps,
            obj_size=(3, 32, 32), batch_size=BATCH, n_samples=BATCH,
            step_type="ddpm", precision="half", device=dev)

    sampler_of(2).batch_sample(torch.Generator(device=dev).manual_seed(1))
    torch.cuda.synchronize()
    sampler = sampler_of(N_STEPS)
    gen = torch.Generator(device=dev).manual_seed(0)
    attn_op.fused_spatial_attention.launches = 0
    gn_op.fused_group_norm_act.launches = 0
    t0 = time.perf_counter()
    x = sampler.batch_sample(gen)["x"]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    attn_launches = attn_op.fused_spatial_attention.launches
    gn_launches = gn_op.fused_group_norm_act.launches
    ms_step = wall / N_STEPS * 1e3
    log(f"main path: DDPM {N_STEPS} steps, batch {BATCH}, bf16 flagship: "
        f"{wall:.3f} s, {ms_step:.3f} ms/step, {BATCH / wall:.3f} samples/s; "
        f"launches attention {attn_launches} ({attn_launches / N_STEPS:g}/step), "
        f"GroupNorm {gn_launches} ({gn_launches / N_STEPS:g}/step); output "
        f"{tuple(x.shape)} {x.dtype} mean {float(x.mean()):.4g} std "
        f"{float(x.std()):.4g}")
    if tuple(x.shape) != (BATCH, 3, 32, 32) or not bool(torch.isfinite(x).all()):
        fail(f"main-path output not finite of shape (64, 3, 32, 32): {tuple(x.shape)}")
    if attn_launches != 8 * N_STEPS or gn_launches != 69 * N_STEPS:
        fail(f"launch counts {attn_launches}, {gn_launches} != "
             f"{8 * N_STEPS}, {69 * N_STEPS}")
    # the card's busy time for one model evaluation of a step (the UNet and
    # the prediction algebra), timed with the host's enqueue hidden: the
    # rest of a step's wall time the card waits on the host
    x_in = torch.randn(BATCH, 3, 32, 32, generator=gen, device=dev).bfloat16()
    lt_top = sampler._grid()[-1]
    with torch.inference_mode():
        eval_ms, eval_host_ms = time_ms(
            lambda: ddpm.get_predictions(x_in, lt_top), reps=5, inner=1)
    log(f"main path: one model evaluation keeps the card busy {eval_ms:.3f} "
        f"ms and takes the host {eval_host_ms:.3f} ms to enqueue; the card "
        f"is idle {1.0 - eval_ms / ms_step:.1%} of a {ms_step:.3f} ms step")

    profile_steps(lambda: sampler_of(PROFILE_STEPS).batch_sample(gen),
                  PROFILE_STEPS)

    # ---- phase 5: backward kernels (and forward at the training batch) ----
    log(f"phase 5 at {time.perf_counter() - t_start:.1f} s")
    attn_train_rows = attention_fwd_rows(TRAIN_BATCH, (torch.bfloat16,), attn_main)
    gn_train_rows = group_norm_fwd_rows(TRAIN_BATCH, edges=False)

    attn_bwd_rows = [
        attention_rows(time_ms, dev, g, TRAIN_BATCH, T, C, heads,
                       calls if dtype == torch.bfloat16 else 0, dtype, forward=False)[1]
        for dtype in (torch.bfloat16, torch.float32)
        for (T, C, heads), calls in (attn_shapes if dtype == torch.bfloat16
                                     else attn_main)]
    attention_head_dim_sweep(attn_op, dev, g)

    gn_bwd_rows = [group_norm_rows(time_ms, dev, g, *shape, calls, forward=False)[1]
                   for shape, calls in group_norm_shapes(TRAIN_BATCH, edges=True)]
    torch.cuda.empty_cache()

    # ---- phase 6: the full-width fp32 train step, card vs CPU ----
    log(f"phase 6 at {time.perf_counter() - t_start:.1f} s")
    x6 = torch.from_numpy(rng.standard_normal((2, 3, 32, 32)).astype(np.float32))
    tau6 = torch.from_numpy(rng.uniform(0.0, 1.0, 2).astype(np.float32))
    eps6 = torch.from_numpy(rng.standard_normal((2, 3, 32, 32)).astype(np.float32))
    train_step_card_vs_cpu(weights, sched, dev, x6, tau6, eps6, "flagship")
    backward_probe(weights, sched, dev, x6, tau6, eps6)

    # ---- phase 7: the training main path ----
    log(f"phase 7 at {time.perf_counter() - t_start:.1f} s")
    net_t = unet_from_config(3, FLAGSHIP, dtype=torch.bfloat16, device=dev)
    ddpm_t = UNetDDPM(sched, net_t, parametrization="eps", device=dev)
    hyper = dict(learning_rate=1e-4, warmup_steps=10, total_iters=1000,
                 grad_clip=1.0, ema_decay=0.9999)
    trainer = DDPMTrainer(ddpm_t, **hyper)
    state = trainer.init_state(weights)  # fp32 masters from the fp32 weights
    x_train = torch.from_numpy(np.random.RandomState(2).standard_normal(
        (TRAIN_BATCH, 3, 32, 32)).astype(np.float32)).to(dev)
    for it in range(1, TRAIN_WARM + 1):
        state, _ = trainer.train_step(state, x_train, step_generator(0, it, dev))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gens = [step_generator(0, TRAIN_WARM + i + 1, dev) for i in range(TRAIN_STEPS)]
    counters = ((attn_op.fused_spatial_attention, "attention_fwd"),
                (attn_op.attention_bwd, "attention_bwd"),
                (gn_op.fused_group_norm_act, "group_norm_fwd"),
                (gn_op.group_norm_bwd, "group_norm_bwd"))
    for fn, _ in counters:
        fn.launches = 0
    losses, norms, host_s = [], [], 0.0
    t0 = time.perf_counter()
    for gen in gens:
        t1 = time.perf_counter()
        state, m = trainer.train_step(state, x_train, gen)
        host_s += time.perf_counter() - t1
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train_launches = {key: fn.launches for fn, key in counters}
    losses, norms = torch.stack(losses).cpu(), torch.stack(norms).cpu()
    train_ms = wall / TRAIN_STEPS * 1e3
    host_ms = host_s / TRAIN_STEPS * 1e3
    log(f"training main path: bf16 flagship, fp32 masters, batch {TRAIN_BATCH}, "
        f"dropout 0.2, {hyper}: {TRAIN_STEPS} steps in {wall:.3f} s, "
        f"{train_ms:.3f} ms/step, {TRAIN_BATCH / wall * TRAIN_STEPS:.3f} img/s; "
        f"host {host_ms:.3f} ms/step inside train_step (waits on the "
        f"launch queue included); "
        f"launches {train_launches} "
        f"({ {k: v / TRAIN_STEPS for k, v in train_launches.items()} } per step); "
        f"loss first {float(losses[0]):.5g} last {float(losses[-1]):.5g}, "
        f"grad_norm first {float(norms[0]):.5g} last {float(norms[-1]):.5g}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not (bool(torch.isfinite(losses).all()) and bool(torch.isfinite(norms).all())):
        fail("training main path: loss or grad_norm not finite")
    want_launches = {k: v * TRAIN_STEPS for k, v in TRAIN_LAUNCHES.items()}
    if train_launches != want_launches:
        fail(f"training launch counts {train_launches} != {want_launches}")
    # the card's busy time per step: the sum of its kernels' times in a
    # profiler trace (a step enqueues more kernels than the launch queue
    # holds, so the sleep-kernel timing of phase 4 cannot hide its enqueue)
    gen_b = step_generator(0, 10_000, dev)
    busy_ms = profile_steps(lambda: [trainer.train_step(state, x_train, gen_b)
                                     for _ in range(TRAIN_PROFILE_STEPS)],
                            TRAIN_PROFILE_STEPS, label="training profile")
    # the host's time inside train_step includes its waits on that full
    # queue, so it tracks the wall time whichever side is slower; the
    # verdict comes from the card's idle time instead
    idle_ms = train_ms - busy_ms
    log(f"training main path: the card is busy {busy_ms:.3f} ms of a "
        f"{train_ms:.3f} ms step and idle {idle_ms:.3f} ms "
        f"({idle_ms / train_ms:.1%}), so the "
        f"{'host' if idle_ms > 0.1 * train_ms else 'card'} bounds the step")

    # checkpoint: save, resume into a fresh trainer, one more step
    with tempfile.TemporaryDirectory() as ckpt_dir:
        trainer.checkpoint_dir = ckpt_dir
        t0 = time.perf_counter()
        trainer.save_checkpoint(state, state.step)
        save_s = time.perf_counter() - t0
        net_r = unet_from_config(3, FLAGSHIP, dtype=torch.bfloat16, device=dev)
        resumed = DDPMTrainer(UNetDDPM(sched, net_r, device=dev),
                              checkpoint_dir=ckpt_dir, **hyper)
        t0 = time.perf_counter()
        st_r = resumed.load_checkpoint(resumed.init_state(),
                                       resumed.latest_checkpoint_step())
        load_s = time.perf_counter() - t0
    same = st_r.step == state.step and all(
        torch.equal(getattr(st_r, key)[k], v)
        for key in ("params", "ema_params") for k, v in getattr(state, key).items())
    sa, sb = state.optimizer.state_dict()["state"], st_r.optimizer.state_dict()["state"]
    same = same and all(torch.equal(sa[i][f], sb[i][f]) for i in sa
                        for f in ("exp_avg", "exp_avg_sq", "step"))
    same = same and all(torch.equal(p, q_) for p, q_ in zip(
        net_t.parameters(), net_r.parameters()))
    st_r, m_r = resumed.train_step(st_r, x_train, step_generator(0, st_r.step + 1, dev))
    log(f"checkpoint: saved step {state.step} in {save_s:.2f} s, resumed in "
        f"{load_s:.2f} s, resumed state equal to the saved one: {same}; one more "
        f"step on the card: loss {float(m_r['loss']):.5g} grad_norm "
        f"{float(m_r['grad_norm']):.5g}")
    if not same or not math.isfinite(float(m_r["loss"])):
        fail("checkpoint resume did not restore the saved state")
    del trainer, resumed, state, st_r, net_t, net_r, ddpm_t
    torch.cuda.empty_cache()

    # ---- phase 8: the sweep kernel against its plain version ----
    log(f"phase 8 at {time.perf_counter() - t_start:.1f} s")
    sweep_rows, main_data = sweep_kernel_rows(time_ms, dev)

    # ---- phase 9: the statistics main path ----
    log(f"phase 9 at {time.perf_counter() - t_start:.1f} s")
    stats_launches = stats_main_path(main_data, ddpm, dev)
    del main_data
    torch.cuda.empty_cache()

    # ---- phase 10: the moments kernel against its plain version ----
    log(f"phase 10 at {time.perf_counter() - t_start:.1f} s")
    moments_rows = moments_kernel_rows(time_ms, dev)

    # ---- phase 11: the analytic denoiser's main path ----
    log(f"phase 11 at {time.perf_counter() - t_start:.1f} s")
    true_launches, true_path = analytic_main_path(time_ms, dev)

    # ---- phase 12: the paper's experiments on the analytic denoiser ----
    log(f"phase 12 at {time.perf_counter() - t_start:.1f} s")
    paper_experiments(dev)

    # ---- phase 13: the whole-block kernels against their plain versions ----
    log(f"phase 13 at {time.perf_counter() - t_start:.1f} s")
    block_fwd, block_bwd_rows = block_kernel_rows(time_ms, dev)
    block_rows, block_train_rows = block_fwd[BATCH], block_fwd[TRAIN_BATCH]
    block_fwd_edges, block_bwd_edges = block_edge_rows(dev)

    # the whole-block path is opt-in: on for phases 14-16 only
    opt_in_before = os.environ.get("PDM_FUSED_BLOCK")
    os.environ["PDM_FUSED_BLOCK"] = "1"
    try:
        # ---- phase 14: the whole-block sampling path ----
        log(f"phase 14 at {time.perf_counter() - t_start:.1f} s")
        tau_in = torch.full((BATCH,), 0.5, device=dev)
        with torch.inference_mode():
            fused_out = net(x_in, tau_in)
            os.environ["PDM_FUSED_BLOCK"] = "0"
            default_out = net(x_in, tau_in)
            os.environ["PDM_FUSED_BLOCK"] = "1"
        d_scale = float(default_out.abs().max())
        d_err = float((fused_out - default_out).abs().max())
        log(f"one bf16 model evaluation B={BATCH}, whole-block path vs default path: "
            f"max_abs_err {d_err:.3g} of output scale {d_scale:.3g} (tol "
            f"{FUSED_VS_DEFAULT_TOL} of scale)")
        if not (math.isfinite(d_err) and d_err <= FUSED_VS_DEFAULT_TOL * d_scale):
            fail("the whole-block path disagrees with the default path")
        sampler_of(2).batch_sample(torch.Generator(device=dev).manual_seed(1))
        torch.cuda.synchronize()
        sampler = sampler_of(BLOCK_SAMPLER_STEPS)
        gen = torch.Generator(device=dev).manual_seed(0)
        block_op.fused_attention_block.launches = 0
        attn_op.fused_spatial_attention.launches = 0
        gn_op.fused_group_norm_act.launches = 0
        t0 = time.perf_counter()
        x = sampler.batch_sample(gen)["x"]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fused_launches = block_op.fused_attention_block.launches
        row1_launches = attn_op.fused_spatial_attention.launches
        gn_launches_f = gn_op.fused_group_norm_act.launches
        ms_step_f = wall / BLOCK_SAMPLER_STEPS * 1e3
        log(f"whole-block sampling path: DDPM {BLOCK_SAMPLER_STEPS} steps, batch {BATCH}, bf16 "
            f"flagship, PDM_FUSED_BLOCK=1: {wall:.3f} s, {ms_step_f:.3f} ms/step, "
            f"{BATCH / wall:.3f} samples/s; launches whole block {fused_launches} "
            f"({fused_launches / BLOCK_SAMPLER_STEPS:g}/step), attention {row1_launches}, "
            f"GroupNorm {gn_launches_f} ({gn_launches_f / BLOCK_SAMPLER_STEPS:g}/step); output "
            f"{tuple(x.shape)} mean {float(x.mean()):.4g} std {float(x.std()):.4g}")
        if tuple(x.shape) != (BATCH, 3, 32, 32) or not bool(torch.isfinite(x).all()):
            fail("whole-block sampling output not finite of shape (64, 3, 32, 32)")
        if (fused_launches, row1_launches, gn_launches_f) != (
                8 * BLOCK_SAMPLER_STEPS, 0, 69 * BLOCK_SAMPLER_STEPS):
            fail(f"whole-block sampling launch counts {fused_launches}, "
                 f"{row1_launches}, {gn_launches_f} != {8 * BLOCK_SAMPLER_STEPS}, 0, "
                 f"{69 * BLOCK_SAMPLER_STEPS}")
        with torch.inference_mode():
            eval_ms_f, eval_host_ms_f = time_ms(
                lambda: ddpm.get_predictions(x_in, lt_top), reps=5, inner=1)
        log(f"whole-block sampling path: one model evaluation keeps the card busy "
            f"{eval_ms_f:.3f} ms and takes the host {eval_host_ms_f:.3f} ms to "
            f"enqueue; the card is idle {1.0 - eval_ms_f / ms_step_f:.1%} of a "
            f"{ms_step_f:.3f} ms step (default path in this run: {ms_step:.3f} "
            f"ms/step, card busy {eval_ms:.3f} ms)")
        profile_steps(lambda: sampler_of(PROFILE_STEPS).batch_sample(gen),
                      PROFILE_STEPS, label="whole-block profile")
        # the two paths in ten alternating pairs of short turns in this run
        # (the order inside a pair alternates too): the host's speed drifts
        # between phases, so only the per-pair differences compare them
        leg = sampler_of(TURN_STEPS)
        log(turns_summary("sampling (DDPM)", block_turns(
            lambda: leg.batch_sample(gen), TURN_PAIRS, TURN_STEPS)))

        # ---- phase 15: the whole-block training path ----
        log(f"phase 15 at {time.perf_counter() - t_start:.1f} s")
        net_f = unet_from_config(3, FLAGSHIP, dtype=torch.bfloat16, device=dev)
        trainer_f = DDPMTrainer(UNetDDPM(sched, net_f, parametrization="eps",
                                         device=dev), **hyper)
        state_f = trainer_f.init_state(weights)
        for it in range(1, TRAIN_WARM + 1):
            state_f, _ = trainer_f.train_step(state_f, x_train, step_generator(0, it, dev))
        torch.cuda.synchronize()
        gens = [step_generator(0, TRAIN_WARM + i + 1, dev) for i in range(TRAIN_STEPS)]
        counters_f = ((attn_op.fused_spatial_attention, "attention_fwd"),
                      (attn_op.attention_bwd, "attention_bwd"),
                      (block_op.fused_attention_block, "block_fwd"),
                      (block_op.attention_block_bwd, "block_bwd"),
                      (gn_op.fused_group_norm_act, "group_norm_fwd"),
                      (gn_op.group_norm_bwd, "group_norm_bwd"))
        for fn, _ in counters_f:
            fn.launches = 0
        losses, norms = [], []
        t0 = time.perf_counter()
        for gen in gens:
            state_f, m = trainer_f.train_step(state_f, x_train, gen)
            losses.append(m["loss"])
            norms.append(m["grad_norm"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        block_train_launches = {key: fn.launches for fn, key in counters_f}
        losses, norms = torch.stack(losses).cpu(), torch.stack(norms).cpu()
        train_ms_f = wall / TRAIN_STEPS * 1e3
        log(f"whole-block training path: bf16 flagship, fp32 masters, batch "
            f"{TRAIN_BATCH}, PDM_FUSED_BLOCK=1: {TRAIN_STEPS} steps in {wall:.3f} s, "
            f"{train_ms_f:.3f} ms/step, {TRAIN_BATCH / wall * TRAIN_STEPS:.3f} img/s "
            f"(default path in this run: {train_ms:.3f} ms/step); launches "
            f"{block_train_launches}; loss first {float(losses[0]):.5g} last "
            f"{float(losses[-1]):.5g}, grad_norm first {float(norms[0]):.5g} last "
            f"{float(norms[-1]):.5g}")
        if not (bool(torch.isfinite(losses).all()) and bool(torch.isfinite(norms).all())):
            fail("whole-block training path: loss or grad_norm not finite")
        want_launches = {k: v * TRAIN_STEPS for k, v in BLOCK_TRAIN_LAUNCHES.items()}
        if block_train_launches != want_launches:
            fail(f"whole-block training launch counts {block_train_launches} != "
                 f"{want_launches}")
        gen_b = step_generator(0, 10_000, dev)
        busy_f = profile_steps(lambda: [trainer_f.train_step(state_f, x_train, gen_b)
                                        for _ in range(TRAIN_PROFILE_STEPS)],
                               TRAIN_PROFILE_STEPS, label="whole-block training profile")
        idle_f = train_ms_f - busy_f

        def train_turn():
            nonlocal state_f
            for _ in range(TRAIN_TURN_STEPS):
                state_f, _ = trainer_f.train_step(state_f, x_train, gen_b)

        log(turns_summary("training", block_turns(train_turn, 2, TRAIN_TURN_STEPS)))
        log(f"whole-block training path: the card is busy {busy_f:.3f} ms of a "
            f"{train_ms_f:.3f} ms step and idle {idle_f:.3f} ms "
            f"({idle_f / train_ms_f:.1%}) (default path: busy {busy_ms:.3f} ms)")
        del trainer_f, state_f, net_f
        torch.cuda.empty_cache()

        # ---- phase 16: the whole-block path in fp32, card vs CPU ----
        log(f"phase 16 at {time.perf_counter() - t_start:.1f} s")
        outs = {}
        for name, d in (("cpu", torch.device("cpu")), ("card", dev)):
            net16 = unet_from_config(3, FLAGSHIP, dtype=torch.float32, device=d)
            net16.load_state_dict(weights)
            block_op.fused_attention_block.launches = 0
            with torch.no_grad():
                outs[name] = net16(x_small.to(d), tau_small.to(d)).cpu()
            if name == "card" and block_op.fused_attention_block.launches != 8:
                fail("the fp32 UNet on the card did not take the whole-block path")
            del net16
        scale16 = float(outs["cpu"].abs().max())
        err16 = float((outs["card"] - outs["cpu"]).abs().max())
        log(f"flagship UNet fp32 forward B=2, PDM_FUSED_BLOCK=1, card (kernels) vs "
            f"CPU (plain): max_abs_err {err16:.3g} of output scale {scale16:.3g} "
            f"(tol {FORWARD_TOL} of scale); vs the default path's CPU output "
            f"{float((outs['cpu'] - ref_out).abs().max()):.3g}")
        if not (math.isfinite(err16) and err16 <= FORWARD_TOL * scale16):
            fail("fp32 whole-block UNet forward on the card disagrees with the CPU")
        train_step_card_vs_cpu(weights, sched, dev, x6, tau6, eps6,
                               "whole-block flagship")
    finally:
        if opt_in_before is None:
            os.environ.pop("PDM_FUSED_BLOCK", None)
        else:
            os.environ["PDM_FUSED_BLOCK"] = opt_in_before

    # ---- phase 17: the config path ----
    log(f"phase 17 at {time.perf_counter() - t_start:.1f} s")
    incep_dir = tempfile.mkdtemp()
    try:
        incep_npz = write_inception_npz(os.path.join(incep_dir, "inception.npz"))
        with env_var("PDM_INCEPTION_WEIGHTS", incep_npz):
            cfg_path = config_path(dev, weights, smi)
        cfg_train = (("config training, device-resident data", "train_launches"),
                     ("config training, host-resident data", "host_launches"))

        # ---- phase 18: FID and the entry points ----
        log(f"phase 18 at {time.perf_counter() - t_start:.1f} s")
        fid_out = fid_and_entry_points(dev, smi, incep_npz)
    finally:
        shutil.rmtree(incep_dir, ignore_errors=True)
    cli = fid_out["cli"]
    cli_sweep = cli["compute_stats_forward"]["launches"]["sweep"]

    # ---- phase 19: schedule optimization through the sampler ----
    log(f"phase 19 at {time.perf_counter() - t_start:.1f} s")
    sched_opt = schedule_opt_phase(time_ms, dev, weights)

    # ---- phase 20: the data axis on one card ----
    log(f"phase 20 at {time.perf_counter() - t_start:.1f} s")
    scale_out = scale_out_phase(dev, weights, smi)

    # ---- phase 21: the model axis (tensor and spatial parallelism) ----
    log(f"phase 21 at {time.perf_counter() - t_start:.1f} s")
    model_axis = model_axis_phase(time_ms, dev)

    # ---- phase 22: serving export through the custom ops ----
    log(f"phase 22 at {time.perf_counter() - t_start:.1f} s")
    serving = serving_phase(dev, weights)

    # ---- phase 23: the 256x256 family ----
    log(f"phase 23 at {time.perf_counter() - t_start:.1f} s")
    highres = highres_phase(time_ms, dev, smi)

    # ---- phase 24: the kernels line and the result ----
    log(f"phase 24 at {time.perf_counter() - t_start:.1f} s")

    def per_path(rows, launches, n_steps):
        main = [r for r in rows if r["calls_per_step"]]

        def per_step(key):
            return sum(r[key] * r["calls_per_step"] for r in main)

        bound_ms = per_step("bound_ms")
        by_bytes = sum(r["bound_ms"] * r["calls_per_step"] for r in main
                       if r["bound_by"] == "bytes")
        # rows 5 and 6 at cluster shapes: the staged plan timed beside it
        staged = ({"staged_ms": per_step("staged_ms")}
                  if main and all("staged_ms" in r for r in main) else {})
        return {
            "launches": launches, "launches_per_step": launches / n_steps,
            "ms": per_step("ms"), "host_ms": per_step("host_ms"),
            "plain_ms": per_step("plain_ms"), "bound_ms": bound_ms,
            "bound_by": "bytes" if by_bytes >= bound_ms / 2 else "operations",
            "library_ms": per_step("library_ms"), **staged,
        }

    def entry(name, source, replaces, design, paths, edges=()):
        """paths: (path, rows, launches, steps) for each main path that
        runs the kernel; the first gives the headline numbers. edges: rows
        of shapes off the main paths (checked, untimed)."""
        per = {path: per_path(rows, launches, n) for path, rows, launches, n in paths}
        head = per[paths[0][0]]
        rows = [r for _, path_rows, _, _ in paths for r in path_rows] + list(edges)
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "design": design,
            "launches": sum(v["launches"] for v in per.values()),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "worst_of_tolerance": max(
                r.get("worst_of_tolerance", r.get("tol_fraction", 0.0)) for r in rows),
            "per": f"main-path step of the {paths[0][0]} path: sum over the "
                   f"step's calls at their shapes of the per-call medians in "
                   f"'shapes'; 'paths' gives each path's",
            **{k: head[k] for k in ("ms", "host_ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms")},
            "paths": per,
            "shapes": rows,
        }

    hr = highres["rows"]
    hr_sample = ("256x256 family sampling (diffusers entry point, DDIM-50, B 8)",
                 highres["sampling"]["launches"], highres["sampling"]["steps"])
    hr_train = ("256x256 family training (a step = a micro-batch of 8)",
                highres["training"]["launches"], highres["training"]["micro_batches"])

    hr_sample_b = ("256x256 family whole-block sampling (PDM_FUSED_BLOCK=1, DDIM-50, B 8)",
                   highres["sampling_block"]["launches"], highres["sampling_block"]["steps"])
    hr_train_b = ("256x256 family whole-block training (PDM_FUSED_BLOCK=1; a step = a "
                  "micro-batch of 8)", highres["training_block"]["launches"],
                  highres["training_block"]["micro_batches"])

    def hr_path(which, rows, key):
        path, launches, n = which
        return (path, rows, launches[key], n)

    kernels = [
        entry("fused_spatial_attention", "pdm_tpu_torch/csrc/attention.cu",
              "pdm_tpu/ops/attention.py:75",
              "single pass on wgmma, q, k, v by TMA (T <= 256)",
              [("sampling", attn_rows, attn_launches, N_STEPS),
               ("training", attn_train_rows, train_launches["attention_fwd"],
                TRAIN_STEPS)]
              + [(path, attn_train_rows, cfg_path[which]["attention_fwd"], CONFIG_STEPS)
                 for path, which in cfg_train]),
        entry("attention_bwd", "pdm_tpu_torch/csrc/attention_bwd.cu",
              "pdm_tpu/ops/attention.py:123",
              "dq, then dk/dv: persistent wgmma kernels on a TMA ring (T <= 256)",
              [("training", attn_bwd_rows, train_launches["attention_bwd"],
                TRAIN_STEPS)]
              + [(path, attn_bwd_rows, cfg_path[which]["attention_bwd"], CONFIG_STEPS)
                 for path, which in cfg_train]),
        entry("fused_group_norm_act", "pdm_tpu_torch/csrc/groupnorm.cu",
              "pdm_tpu/ops/groupnorm.py:99",
              "a cluster's whole-row tiles in shared memory, read once",
              [("sampling", gn_rows, gn_launches, N_STEPS),
               ("training", gn_train_rows, train_launches["group_norm_fwd"],
                TRAIN_STEPS)]
              + [(path, gn_train_rows, cfg_path[which]["group_norm_fwd"], CONFIG_STEPS)
                 for path, which in cfg_train]
              + [hr_path(w, hr["group_norm_fwd"], "group_norm_fwd")
                 for w in (hr_sample, hr_train)]),
        entry("group_norm_bwd", "pdm_tpu_torch/csrc/groupnorm_bwd.cu",
              "pdm_tpu/ops/groupnorm.py:112",
              "a cluster's whole-row tiles, dn kept on chip",
              [("training", gn_bwd_rows, train_launches["group_norm_bwd"],
                TRAIN_STEPS)]
              + [(path, gn_bwd_rows, cfg_path[which]["group_norm_bwd"], CONFIG_STEPS)
                 for path, which in cfg_train]
              + [hr_path(hr_train, hr["group_norm_bwd"], "group_norm_bwd")]),
        entry("fused_spatial_attention_wide", "pdm_tpu_torch/csrc/attention_wide.cu",
              "pdm_tpu/ops/attention.py:75 (row 1 at head dims above 128)",
              "bf16 at T <= 256: one pass on wgmma, a strip's whole score row in "
              "registers contracted over 64-column head-dim chunks on a four-stage "
              "TMA ring, two strips a block sharing k and v, P v on wgmma with P "
              "in registers, output chunks split over blocks to fill the card; "
              "above T 256 two passes on mma.sync",
              [hr_path(hr_sample, hr["attention_fwd"], "attention_fwd"),
               hr_path(hr_train, hr["attention_fwd"], "attention_fwd"),
               ("single-head 32x32 sampling (DDIM-10, B 64)", hr["single_fwd"],
                highres["single_head"]["launches"]["attention_fwd"],
                highres["single_head"]["steps"])],
              hr["edge_fwd"]),
        entry("attention_bwd_wide", "pdm_tpu_torch/csrc/attention_wide.cu",
              "pdm_tpu/ops/attention.py:123 (row 2 at head dims above 128)",
              "bf16 at T <= 256: a dq kernel on wgmma computing each strip's S and "
              "dp once over its whole key row in registers (64-column head-dim "
              "chunks on a four-stage TMA ring), P, D and ds in registers, dq = ds "
              "k chunk by chunk, P and ds to a bf16 scratch; then dk = ds^T q and "
              "dv = P^T do as wgmma products over the query axis; above T 256 "
              "two sweeps on mma.sync, scores recomputed per 128-column block",
              [hr_path(hr_train, hr["attention_bwd"], "attention_bwd")],
              hr["edge_bwd"] + hr["single_bwd"]),
    ]
    # the single-head 32 x 32 sampler's GroupNorm launches (its shapes are
    # the flagship's at other widths: launch count only)
    k = next(k for k in kernels if k["name"] == "fused_group_norm_act")
    n = highres["single_head"]["launches"]["group_norm_fwd"]
    k["launches"] += n
    k["paths"]["single-head 32x32 sampling (DDIM-10, B 64)"] = {
        "launches": n, "launches_per_step": n / highres["single_head"]["steps"],
        "note": "launch count only"}
    kernels += [
        entry("fused_attention_block", "pdm_tpu_torch/csrc/attention_block.cu",
              "pdm_tpu/ops/attention_block.py:90",
              "a cluster per image group on a TMA ring into wgmma, q, k, v "
              "straight into swizzled tiles, W_out loaded during the "
              "attention, packed images at T <= 64",
              [("whole-block sampling", block_rows, fused_launches,
                BLOCK_SAMPLER_STEPS),
               ("whole-block training", block_train_rows,
                block_train_launches["block_fwd"], TRAIN_STEPS)], block_fwd_edges),
        entry("attention_block_bwd", "pdm_tpu_torch/csrc/attention_block_bwd.cu",
              "pdm_tpu/ops/attention_block.py:104",
              "as the forward with row 2's VJP, dh's weights loaded during "
              "it; 128 x 256 wgmma weight gradient tiles, split-K, merged in "
              "order",
              [("whole-block training", block_bwd_rows,
                block_train_launches["block_bwd"], TRAIN_STEPS)], block_bwd_edges),
    ]
    kernels += [
        entry("fused_attention_block_staged", "pdm_tpu_torch/csrc/attention_block_wide.cu",
              "pdm_tpu/ops/attention_block.py:90 (row 5 at the geometries the cluster "
              "kernels do not take)",
              "staged through device memory, three launches a call: the qkv "
              "projection on wgmma (persistent, 128 x 128 tiles, a producer warp "
              "keeping a four-stage TMA ring in flight across tiles, the weights "
              "read in place, TMA stores), row 1's kernel on its column thirds (above "
              "head dim 128 the one-pass wide kernel), the out projection with "
              "b_out and the residual in its epilogue",
              [hr_path(hr_sample_b, hr["block_fwd"], "block_fwd"),
               hr_path(hr_train_b, hr["block_fwd"], "block_fwd"),
               ("single-head 32x32 whole-block sampling (PDM_FUSED_BLOCK=1, DDIM-10, B 64)",
                hr["single_block_fwd"], highres["single_head_block"]["launches"]["block_fwd"],
                highres["single_head_block"]["steps"])],
              hr["block_edge_fwd"] + hr["single_block_fwd_train"]),
        entry("attention_block_bwd_staged", "pdm_tpu_torch/csrc/attention_block_wide.cu",
              "pdm_tpu/ops/attention_block.py:104 (row 6 at the geometries the "
              "cluster kernels do not take)",
              "staged, eight launches a call: qkv and att recomputed as the "
              "forward does, datt = do W_out and dh = dqkv W_qkv on the projection "
              "kernel, row 2's two kernels into the column thirds of one dqkv, "
              "attention_block_bwd.cu's split-K weight gradients and their merge",
              [hr_path(hr_train_b, hr["block_bwd"], "block_bwd")],
              hr["block_edge_bwd"] + hr["single_block_bwd"]),
    ]
    # the entry points' paths (phase 18): launch counts only, their
    # shapes being the main paths' at other batches
    # train_diffusion's forward kernels run in its train steps and in the
    # eval's sampler steps (the grid, then the FID batches of 64); its
    # backward kernels in the train steps alone
    eval_steps = EVAL_STEPS * (1 + math.ceil(CLI_FID_SAMPLES / 64))
    train_fwd = ("train_diffusion", CLI_TRAIN_STEPS + eval_steps,
                 f": {CLI_TRAIN_STEPS} train steps and the eval's {eval_steps} "
                 f"sampler steps")
    train_bwd = ("train_diffusion", CLI_TRAIN_STEPS,
                 f": {CLI_TRAIN_STEPS} train steps")
    sampled = (("sample", 10, ""), ("compute_fid", 10, ""))
    cli_paths = {
        "attention_fwd": ("fused_spatial_attention", (train_fwd, *sampled)),
        "attention_bwd": ("attention_bwd", (train_bwd,)),
        "group_norm_fwd": ("fused_group_norm_act", (train_fwd, *sampled)),
        "group_norm_bwd": ("group_norm_bwd", (train_bwd,)),
    }
    for key, (name, runs) in cli_paths.items():
        k = next(k for k in kernels if k["name"] == name)
        for cli_name, steps, note in runs:
            n = cli[cli_name]["launches"][key]
            k["launches"] += n
            k["paths"][f"{cli_name} CLI"] = {
                "launches": n, "launches_per_step": n / steps,
                "note": "launch count only" + note}
        # phase 19e: the schedule optimizer through the flagship
        n = sched_opt["unet"]["launches"][key]
        k["launches"] += n
        k["paths"]["schedule optimization through the flagship"] = {
            "launches": n,
            "launches_per_step": n / (UNET_OPT["n_steps"] * UNET_OPT["n_iters"]),
            "note": "launch count only: per sampler step of an iteration, the "
                    "forward and its checkpoint recompute (rows 1 and 3), the "
                    "backward (rows 2 and 4)"}
    # phase 20: the data-parallel train step on one rank (NCCL) and on
    # each of two ranks sharing the card (gloo)
    ranks = [("1 rank, nccl", scale_out)] + [
        (f"rank {kid['rank']} of 2, gloo", kid) for kid in scale_out["two_ranks"]]
    for key, (name, _) in cli_paths.items():
        k = next(k for k in kernels if k["name"] == name)
        for where, run in ranks:
            n = run["train"]["launches"][key]
            k["launches"] += n
            k["paths"][f"data-parallel training, {where}"] = {
                "launches": n, "launches_per_step": n / SCALE_OUT_STEPS,
                "ms_per_step": run["train"]["ms"],
                "note": "launch count only: the bf16 train step at global batch "
                        f"{TRAIN_BATCH} over the mesh"}
    # phase 21: the model-parallel bf16 train step and forward on each of
    # two ranks sharing the card (gloo)
    mp_ranks = [(f"rank {kid['rank']} of 2, gloo", kid) for kid in model_axis["ranks"]]
    for key, (name, _) in cli_paths.items():
        k = next(k for k in kernels if k["name"] == name)
        for where, run in mp_ranks:
            for part in ("channel", "spatial"):
                n = run["train"][part]["launches"][key]
                k["launches"] += n
                k["paths"][f"{part}-parallel training, {where}"] = {
                    "launches": n, "launches_per_step": n,
                    "ms_per_step": run["train"][part]["ms"],
                    "note": f"launch count only: one bf16 train step at batch "
                            f"{MP_BF16_BATCH} over a 1 x 2 mesh"}
    # phase 21(c): the uneven-height spatial sampler and train step on four
    # ranks (rows whole: rows 1-4)
    for key, (name, _) in cli_paths.items():
        k = next(k for k in kernels if k["name"] == name)
        for kid in model_axis["uneven"]:
            where = (f"{UNEVEN_SIZE} x {UNEVEN_SIZE} rows whole, rank {kid['rank']} of "
                     f"{UNEVEN_RANKS}, gloo")
            for what, launches, steps, note in (
                    ("spatial sampler", kid["launches"], UNEVEN_STEPS,
                     f"the tiny UNet's fp32 DDIM-{UNEVEN_STEPS}"),
                    ("spatial training", kid["fp32_step"]["launches"], 1,
                     "one fp32 train step of the tiny UNet")):
                n = launches[key]
                if n:
                    k["launches"] += n
                    k["paths"][f"{what}, {where}"] = {
                        "launches": n, "launches_per_step": n / steps,
                        "note": f"launch count only: {note} at batch {UNEVEN_BATCH} "
                                f"over a 1 x 4 mesh"}
    split_rows = model_axis["split"]["rows"]
    sp_names = {"stats": ("group_norm_stats", "3s", "groupnorm_split.cu",
                          "streaming reduction: a block a slab of rows, 16-byte "
                          "vectors four rows ahead, slab partials folded in slab "
                          "order by each image's last block"),
                "apply": ("group_norm_apply", "3s", "groupnorm_split.cu",
                          "streaming normalise from the all-reduced sums, the "
                          "channels' coefficients made once a block, 16-byte "
                          "vectors four rows ahead"),
                "bwd_stats": ("group_norm_bwd_stats", "4s", "groupnorm_split.cu",
                              "as 3s's statistics over x and dy; each image's last "
                              "block folds its slabs, the last image folds dgamma and "
                              "dbeta over the batch in image order: one launch"),
                "bwd_apply": ("group_norm_bwd_apply", "4s", "groupnorm_split.cu",
                              "streaming dx = a dz + b x + c from per-channel "
                              "coefficients made once a block")}
    for kern, (name, row, src, design) in sp_names.items():
        mine = [r for r in split_rows if r["kernel"] == kern]
        head = next(r for r in mine if r["dtype"] == "bfloat16" and r["pieces"] == 2
                    and r["shape"] == [64, 512, 128])
        key = name
        paths = {}
        total = 0
        for where, run in mp_ranks:
            n = run["train"]["spatial"]["launches"][key]
            paths[f"spatial-parallel training, {where}"] = {
                "launches": n, "launches_per_step": n,
                "ms_per_step": run["train"]["spatial"]["ms"]}
            total += n
            if kern in ("stats", "apply"):
                n = run["forward"]["spatial bfloat16"]["launches"][key]
                paths[f"spatial-parallel forward, {where}"] = {
                    "launches": n, "launches_per_step": n,
                    "ms_per_step": run["forward"]["spatial bfloat16"]["ms"]}
                total += n
                n = run["sampler"]["launches"][key]
                paths[f"spatial sampler (fp32 DDIM-{MP_DDIM_STEPS}), {where}"] = {
                    "launches": n, "launches_per_step": n / MP_DDIM_STEPS,
                    "ms_per_step": run["sampler"]["ms"]}
                total += n
        kernels.append({
            "name": name, "route": "cuda", "design": design,
            "source": f"pdm_tpu_torch/csrc/{src}",
            "replaces": ("pdm_tpu/ops/groupnorm.py:" + ("175" if row == "3s" else "192")
                         + " (row " + row + ": no TPU kernel "
                         "of its own; GSPMD's partition of the statistics of "
                         + ("_fgn_call" if row == "3s" else "_fgn_bwd") + ")"),
            "launches": total,
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "worst_of_tolerance": max(r["worst_of_tolerance"] for r in mine),
            "per": "one call on one rank's piece at the headline shape: bf16, B=64, "
                   "S=512 (1024 rows split in 2), C=128, G=32, SiLU; 'shapes' gives "
                   "every case (library: " + {
                       "stats": "torch.var_mean over the groups",
                       "apply": "none: no single call normalises with given statistics",
                       "bwd_stats": "none: no single call gives the partial sums",
                       "bwd_apply": "autograd of F.group_norm and F.silu (the whole "
                                    "backward)"}[kern] + "; cold_ms: back-to-back "
                   "calls, each on a copy of its inputs that L2 no longer holds)",
            **{k: head[k] for k in ("ms", "cold_ms", "host_ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms")},
            "paths": paths,
            "shapes": mine,
        })
    head = next(r for r in sweep_rows if r["label"] == SWEEP_MAIN[0]
                and r["mode"] == "fp32" and not r["values"])
    stats = {k: head[k] for k in ("ms", "host_ms", "plain_ms", "bound_ms",
                                  "bound_by", "library_ms")}
    kernels.append({
        "name": "boltzmann_sweep", "route": "cuda",
        "design": "tall fp32 kernel on a TMA ring; 64-row mma.sync in bf16",
        "source": "pdm_tpu_torch/csrc/boltzmann_sweep.cu",
        "replaces": "pdm_tpu/ops/boltzmann_sweep.py:105",
        "launches": stats_launches + cli_sweep + sum(
            run["sweep"]["launches"] for _, run in ranks),
        "max_abs_err": max(r["max_abs_err"] for r in sweep_rows),
        "worst_of_tolerance": max(r["worst_of_tolerance"] for r in sweep_rows),
        "per": "one call (a partials and a merge launch) at the stats path's "
               "shape, fp32: B=1024, N=50,000, D=3072, 32 temperatures; "
               "'shapes' gives every shape and mode (library: the two Grams "
               "alone through cuBLAS)",
        **stats,
        "paths": {"stats": {"launches": stats_launches,
                            "launches_per_step": 2, **stats},
                  "compute_stats_forward CLI": {"launches": cli_sweep,
                                                "launches_per_step": 2},
                  **{f"thermo_sweep(mesh=), {where}": {
                      "launches": run["sweep"]["launches"], "launches_per_step": 2,
                      "ms_per_sweep": run["sweep"]["ms"]} for where, run in ranks}},
        "shapes": sweep_rows,
    })
    head = next(r for r in moments_rows if r["label"] == MOMENTS_MAIN[0]
                and r["mode"] == "fp32" and r["values"])
    analytic = {k: head[k] for k in ("ms", "host_ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")}
    opt_paths = {"schedule CLI": sched_opt["cli"], "schedule at CIFAR-10 scale":
                 sched_opt["cifar"]}
    kernels.append({
        "name": "boltzmann_moments", "route": "cuda",
        "design": "tall fp32 kernel on TMA rings; cluster kernel for bf16 payloads",
        "source": "pdm_tpu_torch/csrc/boltzmann_moments.cu",
        "replaces": "pdm_tpu/ops/boltzmann_pallas.py:163",
        "launches": (true_launches + cfg_path["true_launches"]
                     + sum(v["launches"]["moments"] for v in opt_paths.values())
                     + sum(run["sampler"]["launches"] for _, run in ranks)),
        "max_abs_err": max(r["max_abs_err"] for r in moments_rows),
        "worst_of_tolerance": max(r["worst_of_tolerance"] for r in moments_rows),
        "per": "one call (a partials and a merge launch) at the analytic "
               "sampler's shape, fp32 with the data as payload: B=1000, "
               "N=50,000, D=K=3072; 'shapes' gives every shape and mode "
               "(library: the Gram and the p.V product alone through cuBLAS)",
        **analytic,
        "paths": {"analytic sampling": {**true_path, **analytic},
                  "config analytic sampling": {
                      "launches": cfg_path["true_launches"],
                      "launches_per_step": 2,
                      "ms_per_step": cfg_path["true_ms_per_step"], **analytic},
                  **{path: {"launches": v["launches"]["moments"], "launches_per_step": 2,
                            "ms_per_iteration": v["ms_per_iteration"]}
                     for path, v in opt_paths.items()},
                  **{f"data-parallel analytic sampling, {where}": {
                      "launches": run["sampler"]["launches"], "launches_per_step": 2,
                      "ms_per_step": run["sampler"]["ms"]} for where, run in ranks}},
        "shapes": moments_rows,
    })
    vjp_rows = sched_opt["vjp_rows"]
    head = next(r for r in vjp_rows if r["label"] == "gmm1d")
    kernels.append({
        "name": "boltzmann_moments_vjp", "route": "cuda",
        "design": "the posterior mean's VJP: fp32 at D <= 4 one fused kernel, a "
                  "thread a query row over a chunk of the dataset; else both Grams "
                  "on row 7's engines (tall fp32, mma.sync in bf16) writing w^T, "
                  "then a split-K fp32 product w.Y on the tall engine; chunk "
                  "partials merged in order",
        "source": "pdm_tpu_torch/csrc/boltzmann_moments_vjp.cu",
        "replaces": "pdm_tpu/ops/boltzmann.py:128 (no TPU kernel: JAX's autodiff "
                    "of boltzmann_moments_xla)",
        "launches": sum(v["launches"]["vjp"] for v in opt_paths.values()),
        "max_abs_err": max(r["max_abs_err"] for r in vjp_rows),
        "worst_of_tolerance": max(r["worst_of_tolerance"] for r in vjp_rows),
        "per": "one call (the small-D kernel and the merge) at the CLI's shape, fp32: "
               "B=1024, N=100,000, D=K=1; 'shapes' gives every shape and mode "
               "(library: the three products through cuBLAS in fp32 with the "
               "elementwise work)",
        **{k: head[k] for k in ("ms", "host_ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms")},
        "paths": {path: {"launches": v["launches"]["vjp"],
                         "launches_per_step": VJP_LAUNCHES[kind],
                         "ms_per_iteration": v["ms_per_iteration"]}
                  for (path, v), kind in zip(opt_paths.items(), ("small", "large"))},
        "shapes": vjp_rows,
    })
    # phase 18e: the offline experiment CLIs and export_sampler (launch
    # counts only; their shapes are the tests' small ones)
    by_key = {"attention": "fused_spatial_attention",
              "group_norm": "fused_group_norm_act",
              "moments": "boltzmann_moments", "sweep": "boltzmann_sweep"}
    for cli_name, run in fid_out["experiments"].items():
        for key, name in by_key.items():
            n = run["launches"][key]
            if n:
                k = next(k for k in kernels if k["name"] == name)
                k["launches"] += n
                k["paths"][f"{cli_name} (experiment CLI)"] = {
                    "launches": n, "wall_s": run["wall_s"],
                    "note": "launch count only, at the CPU tests' sizes"}
    # phase 22: the exported samplers' replays
    serve_paths = (
        ("fused_spatial_attention", "flagship", "attention",
         f"serving replay (a): bf16 flagship DDIM-{SERVE_STEPS}, a fresh process"),
        ("fused_group_norm_act", "flagship", "group_norm",
         f"serving replay (a): bf16 flagship DDIM-{SERVE_STEPS}, a fresh process"),
        ("fused_group_norm_act", "whole_block", "group_norm",
         f"serving replay (b): PDM_FUSED_BLOCK=1 at export, DDIM-{SERVE_BLOCK_STEPS}"),
        ("fused_attention_block", "whole_block", "block",
         f"serving replay (b): PDM_FUSED_BLOCK=1 at export, DDIM-{SERVE_BLOCK_STEPS}"),
        ("boltzmann_moments", "true", "moments",
         f"serving replay (c): TrueDDPM at CIFAR-10 scale, DDPM-{SERVE_TRUE_STEPS}"))
    for name, case, key, where in serve_paths:
        run = serving[case]
        k = next(k for k in kernels if k["name"] == name)
        n = run["launches"][key]
        k["launches"] += n
        k["paths"][where] = {
            "launches": n, "launches_per_step": n / run["steps"],
            "replay_ms_per_step": run["replay_median_ms"],
            "eager_ms_per_step": run["eager_median_ms"],
            "note": "launch count only: the replay's shapes are the eager path's"}
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
