#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py

1. Refuses to run without CUDA; prints the card's name and power limit.
2. Builds the port's kernels from ``arbitrarystyletransfer_tpu_torch/csrc``.
3. Kernel phase: each kernel's wrapper against its plain PyTorch twin on the
   card, at every shape the 512px batch-8 stylize routes and the training
   step give it (and a few off-path shapes that take the kernels' other
   code paths; ``expand_dw`` also at ada_out's 1024px shape, (16, 128,
   128, 256) -> E 768, whose x box comes in 4 channel chunks while every
   other shape's comes whole, ``expand_dw_last_boxes``; and the blocks
   that first leave the plain route at 1024px, e7-e14 and d0-d2 at 128px
   (C_in up to 128, C_out 128), on ``expand_dw``, ``flat_block``,
   ``flat_s2_block`` and ``mega_block``; and every block of the 512px
   path again at f32, the stylize CLI's dtype, summed per f32 request, the
   block kernels' sweep 2 of every path row on the designed kernel of its
   dtype, ``*_last_sweep2``, and their sweep 1 on the design the mirror
   names, 3xTF32 at f32, ``*_last_sweep1``; each f32 path row of
   ``expand_dw``, ``flat_block``, ``flat_s2_block``, ``mega_block`` and
   ``fused_sums`` also holds its and its twin's distance to the block in
   float64, its output and its SE sums, and sweep 2 alone on the float64
   block's hidden, within TF32_F64_FACTOR, ``tf32_vs_f64``; every case of
   the block kernels launched again, and on image 0 alone, gives the same
   bits, ``repeat_check``), with the max
   error against a stated tolerance and the
   device times (CUDA events) of the kernel, the twin and, where one
   PyTorch call computes the same function, that call (the SDPA yardstick
   of the AdaAttN kernels; never on the port's path).  The bf16
   ``adaattn_fwd`` (tensor cores) is held elementwise to
   ``adaattn_fwd_error_bound``, and at both dtypes to the exact answer of a
   one-hot softmax (std exactly 0: the check that sees v^2 fed in exactly);
   its f32 serving form (3xTF32, what every f32 inference path runs) is
   held to the twin and to the float64 form (``SERVE_CASES``: at most twice
   the twin's distance to float64), and timed against the float64 form
   and the f32 SDPA forward.  Two A/B times per
   shape: ``mega_block`` against ``flat_block`` on the same block
   (the (N, H, C, W) layout against NHWC), and the two-pass block
   (``fused_sums`` + ``fused_project``) against the fused route's block
   (``expand_dw`` + the PyTorch epilogue); ``fused_project`` by part at
   the path's shapes in both of its designs (``project_sweep``: share of
   the bound, registers, CTAs per SM, ms with the projection, the
   depthwise or the prefetch cut out).  Then the probe kernels
   (``ops/kernels/probes.py``: copy, the two product schedules, the two
   depthwise layouts, the issue rates) at the JAX probe scripts' default
   shapes, each against its twin (the copy bit-exact), with a library call
   beside all but the rates (the product and depthwise schedules also by
   part, and at shapes off their tiles; the products also in a chain of
   back-to-back calls, bit-exact); then the two probe drivers as a user runs
   them, the counters reset just before each and read just after (each
   must launch exactly its kernels' expected counts), their JSON lines,
   and the probe rows' times taken from them.  Then e2 on the plain route at 512px, timed
   as it is and with its two repairs undone (bf16 products before the
   bias, the NCHW pad).  Then rows 1 and 4 by sweep at every path shape
   (``sweeps_phase``: each sweep's device ms, bound, share of it, rates,
   registers and CTAs per SM; then sweep 2 alone in turns, the CUDA-core
   ``gate_project_generic`` against the designed kernel at the C_out-128
   and f32 shapes, ``sweep2_phase``: each one's ms, share of its own bound,
   registers, CTAs per SM and ring slots, the new one held to the twin and
   faster in every turn), after ragged shapes off the path through
   every sweep-1 mode and both sweep-2 layouts (H, W, E not multiples of
   the sweeps' tiles and channel chunks), held to the same gates, and the
   shapes whose x box comes in channel chunks (``split_phase``: C_in 256
   at k3 and k5 through ``expand_dw``, ``flat_block``, ``flat_s2_block``,
   ``fused_sums`` and ``fused_project``, each with the staging it must
   take, after ``smem_mirror_check``: the shared memory that
   ``ops/kernels/limits.py`` computes for every sweep-1 launcher, on a
   grid of k, C_in and C_out up to 128, must be what the kernels'
   occupancy queries report, or both must refuse; so must sweep 2's
   design, bytes and ring slots, ``sweep2_staging``).  Then
   the AdaAttN backward kernels (``adaattn_bwd_phase``) at the training
   buckets, ragged, bf16 and 512px shapes, an "offset" case (v = 30 +
   0.1 N(0, 1), also held to float64 autograd) and an "offset-1e8" case
   (the same v under a peaked softmax, dv also held to float64 autograd of
   the same function), at forced chunkings of the
   reduction axis and twice for equal bits, beside the SDPA yardstick
   (median of 5 windows, its backend named), and by part at the 160px and
   512px shapes (``bwd_sweep``: share of the bound, registers, CTAs per
   SM, ms with the tensor-core products, the TMA prefetch, the f64
   logits or dkv's f64 dv products cut out).
4. Policy: the dispatch table that ships with the port
   (``ops/tuned_policy.json``) must have been measured on this card and be
   the one "auto" reads, covering every block at 1024, 512, 320 and 256px;
   "auto"'s plan at each size is printed beside the table-less plan; then
   the port's tuner runs as a user runs it (``python -m
   arbitrarystyletransfer_tpu_torch.scripts.autotune_blocks --size 256
   --iters 3`` into a temporary file), every row must hold each route's time
   and a verdict (ada_out's "fused" too: ``expand_dw`` takes C_in 256),
   and how many verdicts equal the table's is printed.
   Routes: ``StylePipeline`` in bfloat16 with the AdaAttN kernel answers
   requests of 8 content/style pairs at 512x512 through four block routes:
   "fused"/"fused" (3 requests), "flat-all" (4; every block the flat kernels
   take), "auto" (2; the CLI's default, its launches those of its plan under
   the shipped table) and "mega" (3; 13 ``mega_block``
   and 2 ``expand_dw`` launches).  For each route the launch
   counters are reset just before its requests and read just after, and
   each request must launch exactly the route's kernels; outputs must be
   finite and unsaturated; request 1 is held against the same pipeline
   forced through the plain twins (bf16, and f32 through both); the f32
   requests (ROUTE_F32_REQUESTS, "flat" too) are timed, their launches
   held to the route's; request 1 served again, bf16 and f32, gives the
   same bytes (``served_again``).  Prints ms
   per request, img/s, the A/B at f32 of ``adaattn_fwd``'s serving form
   against its float64 form (in turns, on one f32 request; every f32
   request must run the serving form) and a profiler breakdown
   of one request per route, with its layout copies and pads; then every
   route's ms per request and img/s of this run side by side.
   Sizes: the same model at 1024px and 720px, batch 8 bf16, on
   "fused", "flat", "flat-all", "auto" and "mega" (6 requests each, the
   first a warm-up): each request's launches must equal
   ``flatblock.planned_launches`` (1024px: ada_out on ``expand_dw`` at
   128px; 720px: the width and evenness rules' other branches, "mega"
   without a ``mega_block``), the image finite, unsaturated and within the
   routes' bf16 gate of the same route through the plain twins (run two
   images at a time: the AdaAttN twin materializes its logits); prints ms
   per request (median and range of the five timed), img/s, peak GiB and
   the plain twins' ms.
5. Training: ``ASTTrainer`` (full-width ``ModelConfig`` with the AdaAttN
   kernels, f32, batch 8, the seeded random VGG, in-memory uniform batches,
   no previews).  The step through the kernels is held against the step
   with the AdaAttN stage in float64 (the loss and the AdaAttN projection
   gradients, as close as the twins' step or within a stated share) and
   against the kernel forward with the twins' backward (the gradients; see
   ``kernel_vs_twin_step``), on three batches of the shared generator and
   the standing ill-conditioned batches ``TRAIN_OWN_SEEDS`` (and would log
   the gate, unheld, on an open fault's batches, ``TRAIN_WATCH_SEEDS``,
   none now); one warm-up step per bucket (96, 128, 160px),
   then timed steps at 160px, each of which must launch exactly 2
   ``adaattn_fwd``, 2 ``adaattn_dq`` and 2 ``adaattn_dkv`` and nothing else,
   with a finite loss, a step counter that advances and BatchNorm buffers
   that move; the 160px warm-up step taken twice from one state, the
   gradients and the state equal bit for bit (``repeat_step``); the
   standing batches' gate figures as exact JSON; a checkpoint
   save/restore round trip; a profile of one step by phase and by kernel.  Then the GAN step: the same trainer with
   ``use_dis`` (the full MobileNetV2 discriminator, dropout 0.2), its
   kernel step held against the twins' and the float64 AdaAttN stage's
   with the GAN terms (gen_adv_loss, dis_loss and the discriminator's
   gradients beside the loss and the AdaAttN gradients, and the AdaAttN
   gradients of the adversarial term alone); warm-up steps at 96, 128 and
   160px up to the first R1 step, then GAN_STEPS steps at 160px, each
   launching exactly the train step's kernels, with finite losses, both
   counters advancing, the discriminator's BatchNorm buffers moving and R1
   nonzero exactly on its steps; dis steps 2 and 7 (R1) taken twice from
   one state, equal bit for bit; a save and a resume that takes the next
   step bit for bit as the run does (dropout masks included, under the
   cuDNN settings the trainers choose themselves); the median
   ms without R1, the R1 steps' ms, each timed step's device time by phase
   (CUDA events at the trainer's marks, R1 included), and a profile of one
   GAN step by kernel.
6. Lifecycle, from training to serving, over synthetic PNGs written to a
   temporary folder and read by the port's loaders, TF32 off:
   ``AutoencoderTrainer`` (batch 16, 256px, f32, the parity weights) takes
   4 steps and writes ``ae.pt`` (finite losses; the first step's loss
   against the same step in float64 at 1e-4; median ms per step; the
   first batch's step taken twice from the state the run ended in, equal
   bit for bit); the
   ``ASTTrainer`` warm-started from it (its enc, ada_out and dec equal to
   the AE's bit for bit) takes 2 steps at 160px batch 8 through the AdaAttN
   kernels and writes ``ast.pt``; ``StylePipeline.from_checkpoint`` serves
   that checkpoint through the graph engine (f32, 3 requests at 512px
   batch 8, 2 ``adaattn_fwd`` each; request 1 against the dense twin at the
   f32 image gate, and served again with the same bytes) and, recalibrated from 16 batches of 8 at 320px, through
   the fused engine's "auto" route (bf16; request 1 against the graph
   engine at f32 over the same state at the bf16 image gate), printing the
   drift (and the reference initialization's), whether the call warned or
   needed ``allow_unstable`` and the seconds it took.
7. Data parallelism (``dp``): 2 ranks (``parallel.launch.run_ranks``; NCCL
   with two cards, else gloo with both on the one card, where the times
   test the sharded path, not its speed) train ``ASTTrainer(mesh=)`` at
   global batch 8 (4 per rank), f32, TF32 off: the first step at 160px
   held against the one-process step on the same global batch (the loss,
   every gradient, the state after the step: within the larger of the
   train gate's fixed tolerance and twice the larger of the twins' step's
   distance to the float64 AdaAttN stage's and the one-process step's own
   spread over eight orders of the batch's rows, ``dp_gates``), a
   warm-up step at 96 and 128px, then 3 timed steps at 160px, each
   launching 2/2/2 of rows 2, 6, 7 per rank, the state equal bit for bit
   across the ranks after them; a GAN step (dropout 0.2, an R1 step) and
   an autoencoder step at 128px, each against one process the same way;
   2 "auto" requests (bf16, 512px batch 8) with rows 1, 2, 4, 5 as "auto"'s
   plan says per rank and no ``torch.distributed`` call inside the engine,
   the gathered batch against the one-process request (bit for bit, or
   within the routes phase's bf16 gate); 2 graph-engine requests (f32,
   batch-statistics BatchNorm over the ranks) at the larger of the f32
   image gate and twice the one-process engine's spread over the batch's
   orders; then
   ``torchrun --nproc_per_node 2 -m arbitrarystyletransfer_tpu_torch.train``
   for 2 steps at 64px over the lifecycle's synthetic PNGs and a 2-rank
   ``--load`` resume (one ``ast.pt``, from rank 0).  Prints ``{"dp":
   {...}}``: backend, devices, launches per rank, each gate's distance and
   limit, ms per step and per request per rank beside one process's.
8. Prints each phase's seconds, one JSON line per the kernels (with each
   kernel's bound: the larger of its bytes over the HBM rate and its
   operations over the peak of their type), the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.  Any failure raises: exit code != 0.

The JAX trainers' orbax checkpoints are not read here: the reader
(``train/orbax.read_orbax``) needs ``tensorstore``, which the card's machine
lacks; ``python -m arbitrarystyletransfer_tpu_torch.convert_orbax SAVE_DIR``
converts them to ``.pt`` files where the trainer ran (the CPU tests cover
both).

``python3 chip_smoke.py --phase NAME`` runs one phase alone after the build
(``ALONE``), from a fresh generator of the seed it draws from in the whole
run, and ends with ``{"ok": true, "phase": NAME}``.

Weights are random from a seed.  They are drawn at fan-in scale with the
SE gates mostly open and the head normalized (as in tests/test_torch_*.py),
because the reference initialization closes the SE gates and the decoder
then emits a constant image that would hide any difference.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import random
import statistics
import subprocess
import sys
import time

SEED = 0
DEVICE = "cuda"
BATCH, SIZE = 8, 512
ALPHAS = (1.0, 0.8, 0.5, 1.0)

KERNELS = ("expand_dw", "adaattn_fwd", "flat_block", "flat_s2_block",
           "adaattn_dq", "adaattn_dkv", "mega_block", "fused_sums",
           "fused_project", "probe_copy", "probe_mm_einsum",
           "probe_mm_rowloop", "probe_dw_t", "probe_dw_nhwc", "probe_rate")


def counts(**launched):
    """{kernel: launches} over every kernel, 0 where not named."""
    return {k: launched.get(k, 0) for k in KERNELS}


@functools.lru_cache(maxsize=None)
def auto_plan(size=SIZE):
    """("auto"'s plan of each chain, {kernel: launches} of one request) at
    ``size`` on DEVICE, under the table that ``ops/policy.py`` loads there
    (the shipped one: ``policy_phase`` checks it)."""
    from arbitrarystyletransfer_tpu_torch import ModelConfig
    from arbitrarystyletransfer_tpu_torch.ops import flatblock

    cfg = ModelConfig()
    plan = flatblock.planned_chains(cfg, size, "auto", "auto", device=DEVICE)
    launches = flatblock.planned_launches(cfg, size, "auto", "auto",
                                          device=DEVICE)
    return plan, counts(adaattn_fwd=1, **launches)


def route_launches(impl):
    """{kernel: launches} of one 512px request on route ``impl``."""
    expected = next(e for name, _, e in ROUTES if name == impl)
    return auto_plan()[1] if expected is None else expected


def auto_case_launches(label, route):
    """Blocks of a case of the 512px path (label "e5-e6": encoder blocks 5
    and 6; "d3": decoder block 3) that "auto" plans onto ``route``."""
    chain = {"e": "enc", "d": "dec"}[label[0]]
    first, _, last = label[1:].partition("-")
    last = int(last.lstrip("ed") or first)
    offset = 1 if chain == "enc" else 0  # the encoder's plan starts at 1
    plan = auto_plan()[0][chain]
    return sum(plan[i - offset] == route for i in range(int(first), last + 1))


# Kernel launches per 512px batch-8 request, by route: (encoder_impl and
# decoder_impl, requests, {kernel: launches}).  "mega" (slice 4): 13
# mega_block (e1, e3, d3-d13), 2 expand_dw (e5, e6 at 128px).  "auto"'s
# (None here) come from its plan under the shipped table (``auto_plan``).
ROUTES = (
    ("fused", 3, counts(expand_dw=15, adaattn_fwd=1)),
    ("flat-all", 4, counts(adaattn_fwd=1, flat_block=15, flat_s2_block=2)),
    ("auto", 2, None),
    ("mega", 3, counts(expand_dw=2, adaattn_fwd=1, mega_block=13)),
)
# The sizes phase: the full-width model at sizes the other
# phases do not run, batch 8 bf16, on each route: 1024px (ada_out at 128px
# on expand_dw, e7-e14 and d0-d2 on the kernels) and 720px (feature maps
# 360, 180, 90: the width and evenness rules' other branches; "mega" runs
# no mega_block there).  SIZES_REQUESTS per route, the first a warm-up,
# the others timed (their median and range are printed); the plain twins
# run SIZES_PLAIN_CHUNK images at a time, once (the twin of
# adaattn_fwd materializes the (2B, N, N) logits: 17 GB at 1024px batch 8).
# Its inputs come from a generator of its own (seed + SIZES_SEED).
SIZES, SIZES_ROUTES = (1024, 720), ("fused", "flat", "flat-all", "auto",
                                    "mega")
SIZES_BATCH, SIZES_REQUESTS, SIZES_PLAIN_CHUNK, SIZES_SEED = 8, 6, 2, 18
# The sizes the shipped dispatch table covers; the policy phase prints
# "auto"'s plan at each and runs the tuner at the last, POLICY_TUNE_ITERS
# calls a window.
POLICY_SIZES, POLICY_TUNE_ITERS = (1024, 512, 320, 256), 3
MAIN_ROUTE = "flat-all"  # the stylize routes' main path (slice 2)
# The routes phase also serves each route's request 1 and the next ones at
# f32 (the stylize CLI's dtype), ROUTE_F32_REQUESTS in all, the first held
# to the plain twins and a warm-up, the others timed (median); and "flat"
# (F32_ONLY_ROUTES), which serves at bf16 in the sizes phase, at f32 here,
# its first request held to the twins too.
ROUTE_F32_REQUESTS, F32_ONLY_ROUTES = 4, ("flat",)

# Training (slice 3's main path): ASTTrainer, full-width ModelConfig with the
# AdaAttN kernels, f32, batch 8, one warm-up step per bucket, then timed
# steps at the last bucket.  Launches per step: one forward and one backward
# per AdaAttN module (two modules), nothing else.
TRAIN_BATCH, TRAIN_SIZES, TRAIN_STEPS = 8, (96, 128, 160), 6
# Batches on which the kernel step is held against the twins' and the
# float64 step (``kernel_vs_twin_step``): their conditioning differs.
STEP_BATCHES = 3
# Then standing batches, each from a generator of its own (device seed),
# each of which must reach TRAIN_OWN_RATIO: 103 reaches (mean / std)^2 ~9e4
# and failed the float64 gradient gate with f32 logits and T - D; 108
# reaches ~1e8, where dv's f32 epilogue missed the 1e-4 gate against the
# twins' backward on the W_v gradient until dv was float64 (PERF.md).
# Then batches run through the gate and logged but not held to it, for an
# open fault (none now).
TRAIN_OWN_SEEDS, TRAIN_OWN_RATIO = (103, 108), 5e4
# The bf16 case (``bf16_step_case``): the step at compute_dtype "bfloat16"
# on a batch from a generator of its own (device seed), through the kernels,
# held to the f32 step within TRAIN_BF16_FACTOR times the bf16 twins'
# distance to it (the routes' bf16 image gate, IMAGE_BF16_FACTOR).
TRAIN_BF16_SEED, TRAIN_BF16_FACTOR = 116, 2.0
TRAIN_WATCH_SEEDS = ()
TRAIN_LAUNCHES = counts(adaattn_fwd=2, adaattn_dq=2, adaattn_dkv=2)
# The GAN step: the train phase's trainer with ``use_dis`` (the
# full MobileNetV2 discriminator, dropout 0.2, seeded init); one warm-up
# step at each of the first buckets, then warm-up steps at the last bucket
# up to and including the first R1 step (discriminator step 7), so that no
# timed step pays the double backward's first use; then GAN_STEPS timed
# steps at the last bucket run the discriminator's steps 8-23, R1 at 15 and
# 23.  Each launches TRAIN_LAUNCHES: the discriminator is plain PyTorch, as
# JAX's is XLA.
GAN_STEPS = 16
# The lifecycle, from training to serving: the Stage-1 autoencoder at
# AETrainConfig's width (batch 16, 256px, f32), the AST warm-started from its
# checkpoint (160px batch 8, the AdaAttN kernels), then that checkpoint
# served through the graph engine (512px batch 8, f32) and, recalibrated
# from RECAL_BATCHES batches of 8 at 320px (the CLI's loader), through the
# fused engine's "auto" route (bf16).  Synthetic PNGs in a temporary folder
# (LIFE_IMAGES content, LIFE_IMAGES // 2 style), read by the port's loaders.
LIFE_IMAGES = 24
LIFE_AE_BATCH, LIFE_AE_SIZE, LIFE_AE_STEPS = 16, 256, 4
LIFE_AST_BATCH, LIFE_AST_SIZE, LIFE_AST_STEPS = 8, 160, 2
LIFE_GRAPH_REQUESTS = LIFE_FUSED_REQUESTS = 3
RECAL_BATCHES, RECAL_SIZE = 16, 320
# Every loader of the lifecycle has one worker thread and its datasets list
# their files in an order of the seed's (``seeded_order``), so that its
# batches, and with them the checkpoints, the recalibrated statistics and
# the drift, are the seed's in every run (two threads put their batches in
# any order; the loaders shuffle the file system's listing).
LIFE_WORKERS = 1
# The AE's first step's loss against the same step in float64: within
# AE_ORDER_FACTOR times the largest distance to it of the float32 loss over
# ``dp_orders``' row orders of the same batch (the float32 rounding of this
# batch: train-mode BatchNorm over 16 images amplifies it, to 7.98e-4 on
# some of the loader's batches, ``scripts/ae_loss_spread.py``), floored at
# AE_LOSS_TOL.  JAX's float32 loss lies as far on these batches, and inside
# this limit (tests/test_torch_ae_gate.py, on the CPU).
AE_LOSS_TOL, AE_ORDER_FACTOR = 1e-4, 2.0
# The recalibrated state through the graph engine and the fused engine's
# plain route (BatchNorm folded), both in float64, stage by stage on the
# same inputs (the encoder's taps, the attention and ada_out fuse, the
# decoder): relative distance.  Folding changes only the rounding, so the
# distance falls with the unit roundoff (the encoder's taps ~1e-12 apart in
# float64); a fault in the folding would not.  The whole image is not held
# to it: the decoder of the phase's near-init state amplifies the distance
# of its input by a factor that moves by orders of magnitude from one
# retraining to the next, and the image's distance with it
# (``scripts/fold_gap_spread.py`` in the port); its response to one ulp on
# the taps is logged beside it.
FOLD_F64_TOL = 1e-6
# Launches per graph-engine request: one adaattn_fwd per AdaAttN module.
GRAPH_LAUNCHES = counts(adaattn_fwd=2)
# Data parallelism: DP_RANKS ranks (``dp_plan``: NCCL on two
# cards, gloo on one) train at the train phase's shapes with the global
# batch DP_BATCH (DP_BATCH / DP_RANKS per rank): the first step on the
# global batch held against the one-process step, a warm-up step per other
# bucket, then DP_STEPS timed steps, each launching TRAIN_LAUNCHES per
# rank; a GAN step at the discriminator's step DP_GAN_DIS_STEP (an R1 step)
# and an AE step at DP_AE_SIZE, each against one process; DP_REQUESTS
# "auto" requests (bf16) and DP_GRAPH_REQUESTS graph-engine requests with
# batch-statistics BatchNorm (f32) at 512px batch 8 against one process;
# then the train CLI under torchrun, DP_CLI_STEPS steps at DP_CLI_SIZE and
# a resumed step.
DP_RANKS, DP_BATCH, DP_STEPS, DP_GAN_DIS_STEP = 2, 8, 3, 7
DP_AE_SIZE, DP_REQUESTS, DP_GRAPH_REQUESTS = 128, 2, 2
DP_CLI_SIZE, DP_CLI_STEPS, DP_TIMEOUT = 64, 2, 600.0
# A gradient's max in the dp gates is floored at this share of the largest
# gradient (tests/test_torch_train_step.py's floor): below it lie the
# gradients that are rounding noise (the BatchNorm biases that another
# BatchNorm follows), and over ranks each rank's share of that cancelling
# sum is larger than the sum.
DP_GRAD_FLOOR = 1e-4
DP_COLLECTIVES = ("all_reduce", "broadcast", "all_gather",
                  "all_gather_into_tensor", "reduce_scatter",
                  "reduce_scatter_tensor", "all_to_all", "all_to_all_single",
                  "reduce", "gather", "scatter", "barrier", "send", "recv",
                  "isend", "irecv")
# AdaAttN backward cases: name, B, Nc, Ns, dtype of q/k/v, dtype of dm,
# launches of each kernel per 160px training step.  The three training
# buckets (Nc = Ns = (size / 8)^2), a ragged case, bf16 inputs, and the
# stacked 512px shape (both taps of batch 8).
BWD_CASES = (
    ("96px", 8, 144, 144, "float32", "float32", 0),
    ("128px", 8, 256, 256, "float32", "float32", 0),
    ("160px", 8, 400, 400, "float32", "float32", 2),
    ("ragged", 2, 100, 77, "float32", "float32", 0),
    ("bf16", 8, 400, 400, "bfloat16", "float32", 0),
    ("bf16-dm", 8, 400, 400, "bfloat16", "bfloat16", 0),
    ("512px", 16, 4096, 4096, "float32", "float32", 0),
    ("offset", 8, 400, 400, "float32", "float32", 0),
    ("offset-1e8", 8, 400, 400, "float32", "float32", 0),
)
# Cases added after the backward phase's first run draw from a generator of
# their own (seed + 9), so that every later phase keeps its inputs.
# "offset": v = 30 + 0.1 N(0, 1), where (mean / std)^2 exceeds 1e4 and the
# uncentred backward cancels; its residuals come from the f32 forward kernel
# (the float64 statistics rounded), and its gradients are also held to
# float64 autograd of the dense statistics.  "offset-1e8": the same v under
# a peaked softmax (q and k at scale 1: logits of std ~11), where (mean /
# std)^2 exceeds 1e8 and dv's two terms cancel by up to |vc| / std; dv is
# also held to float64 autograd of the function on the same inputs
# (``dv_f64``), which f32 sums of dv missed.
BWD_OWN_GEN = ("offset", "offset-1e8")
# The least (mean / std)^2 each of those cases must reach.
BWD_OFFSET_RATIO = {"offset": 1e4, "offset-1e8": 1e8}
# Their q and k scale.
BWD_QK_SCALE = {"offset-1e8": 1.0}
# The cases whose rows 6-7 are timed by part (``bwd_sweep``): ms, share of
# the bound, registers, CTAs per SM, and ms with one part cut out.
BWD_SWEEP_CASES = ("160px", "512px")
BWD_SWEEP_SPLITS = (1, 2, 3, 4, 7)
# dq, dk, dv sum up to 4096 terms in another order than the twin's.
BWD_F32_TOL = 1e-4
# The training step through the kernels vs the step whose AdaAttN stage
# runs in float64, from the same state and batch: the loss (relative) and
# the AdaAttN projection gradients (relative to the largest of each), or
# up to STEP_OWN_FACTOR times the plain twins' own distance to that step
# where it is larger: the f32 rounding of the AdaAttN stage reaches the
# loss and these gradients amplified by the largest (mean / std)^2 of the
# statistics, up to ~1e4 on a random batch (see ``kernel_vs_twin_step``).
STEP_LOSS_TOL, STEP_GRAD_TOL, STEP_OWN_FACTOR = 1e-5, 1e-4, 2.0

# H100 SXM peaks for the bounds (NVIDIA's data sheet, dense, at 700 W):
# bf16 tensor cores, f32 on the CUDA cores, HBM3; TF32 tensor cores and f64
# (tensor cores, the card's highest f64 rate) for rows 6-7.
PEAK_BF16, PEAK_F32, HBM_BYTES_S = 989e12, 67e12, 3.35e12
PEAK_TF32, PEAK_F64 = 495e12, 67e12

# The blocks that first leave the plain route at 1024px, on 128px maps
# (e8-e14 on the encoder's 16 stacked images, d0-d2 on the decoder's 8;
# e7's stride-2 input at 256px, and at 180px on a 720px request): the
# tables' rows labelled "@1024" (or "@720"), off the 512px request (0
# launches), each kernel held to its twin at the usual gates as the 512px
# shapes are.  They draw from a generator of their own (seed +
# SIZE_CASES_SEED), so the 512px cases keep their inputs.
SIZE_CASES_SEED, SIZE_CASE_TAGS = 20, ("@1024", "@720")


def size_case(label):
    """Whether a case is one of the 1024px or 720px rows."""
    return label.endswith(SIZE_CASE_TAGS)


# Every distinct expand_dw shape of the 512px batch-8 request: name, batch
# (the encoder runs content and style stacked: 16), H=W, C_in, E, k,
# folded-BN biases, launches per request on the fused route; then the
# 1024px rows.
EXPAND_DW_CASES = (
    ("e1", 16, 512, 16, 96, 3, True, 1),
    ("e3", 16, 256, 24, 144, 3, True, 1),
    ("e5-e6", 16, 128, 40, 160, 5, True, 2),
    ("d3", 8, 128, 96, 288, 5, False, 1),
    ("d4", 8, 128, 96, 384, 5, False, 1),
    ("d5-d7", 8, 256, 80, 320, 3, False, 3),
    ("d8-d9", 8, 512, 40, 160, 5, False, 2),
    ("d10", 8, 512, 40, 240, 5, False, 1),
    ("d11-d12", 8, 512, 24, 144, 3, False, 2),
    ("d13", 8, 512, 16, 96, 3, False, 1),
    ("e8-e9@1024", 16, 128, 80, 320, 3, True, 0),
    ("e10@1024", 16, 128, 80, 320, 5, True, 0),
    ("e11@1024", 16, 128, 96, 288, 5, True, 0),
    ("e12@1024", 16, 128, 96, 288, 3, True, 0),
    ("e13-e14@1024", 16, 128, 128, 384, 3, True, 0),
    ("d0-d2@1024", 8, 128, 128, 384, 3, False, 0),
)
# ada_out at 1024px: the stacked [stylized; content] maps, 2B =
# 16 at 128px, C_in 256 (2 x 128), E 768, k3, no folded BN; on no 512px
# request.  Its x box comes in 4 channel chunks (expand_dw_last_boxes),
# every other case's as one box.  It draws from a generator of its own
# (seed + ADA_OUT_SEED), so the other cases and phases keep their inputs.
ADA_OUT_CASE = ("ada_out", 16, 128, 256, 768, 3, False, 0)
ADA_OUT_SEED = 17
# flat_block shapes: name (the blocks of the 512px path it is), batch, H=W,
# C_in, E, C_out, k, folded-BN biases, residual, dtype, launches per request
# on "flat-all" ("auto"'s come from its plan, ``auto_case_launches``).  The
# last four are off the 512px path: the CLI's 320px width, the f32 path,
# the expand==1 form, and a C_in that is not a multiple of 8 with an odd
# C_out and size (the CUDA-core expand and projection, partial tiles); then
# the 1024px rows (C_out 128: sweep 2's CUDA-core gate_project_generic).
FLAT_BLOCK_CASES = (
    ("e1", 16, 512, 16, 96, 16, 3, True, True, "bfloat16", 1),
    ("e3", 16, 256, 24, 144, 24, 3, True, True, "bfloat16", 1),
    ("e5-e6", 16, 128, 40, 160, 40, 5, True, True, "bfloat16", 2),
    ("d3", 8, 128, 96, 288, 96, 5, False, True, "bfloat16", 1),
    ("d4", 8, 128, 96, 384, 80, 5, False, False, "bfloat16", 1),
    ("d5-d6", 8, 256, 80, 320, 80, 3, False, True, "bfloat16", 2),
    ("d7", 8, 256, 80, 320, 40, 3, False, False, "bfloat16", 1),
    ("d8-d9", 8, 512, 40, 160, 40, 5, False, True, "bfloat16", 2),
    ("d10", 8, 512, 40, 240, 24, 5, False, False, "bfloat16", 1),
    ("d11", 8, 512, 24, 144, 24, 3, False, True, "bfloat16", 1),
    ("d12", 8, 512, 24, 144, 16, 3, False, False, "bfloat16", 1),
    ("d13", 8, 512, 16, 96, 16, 3, False, True, "bfloat16", 1),
    ("d10@320", 8, 320, 40, 240, 24, 5, False, False, "bfloat16", 0),
    ("e1-f32", 2, 128, 16, 96, 16, 3, True, True, "float32", 0),
    ("expand1", 2, 128, 40, 40, 40, 3, True, True, "bfloat16", 0),
    ("cin12", 2, 37, 12, 48, 13, 5, True, False, "bfloat16", 0),
    ("e8-e9@1024", 16, 128, 80, 320, 80, 3, True, True, "bfloat16", 0),
    ("e10@1024", 16, 128, 80, 320, 96, 5, True, False, "bfloat16", 0),
    ("e11@1024", 16, 128, 96, 288, 96, 5, True, True, "bfloat16", 0),
    ("e12@1024", 16, 128, 96, 288, 128, 3, True, False, "bfloat16", 0),
    ("e13-e14@1024", 16, 128, 128, 384, 128, 3, True, True, "bfloat16", 0),
    ("d0-d1@1024", 8, 128, 128, 384, 128, 3, False, True, "bfloat16", 0),
    ("d2@1024", 8, 128, 128, 384, 96, 3, False, False, "bfloat16", 0),
)
# flat_s2_block shapes: name, batch, input H=W, C_in, E, C_out, k, biases,
# dtype, launches per request on "flat-all"; the last three
# are off the path (the f32 path; the CUDA-core expand and projection with
# partial tiles; partial 8x16 output tiles and a partial channel chunk on
# the path's persistent, TMA-staged sweep 1); then e7 at 1024px and 720px.
FLAT_S2_CASES = (
    ("e2", 16, 512, 16, 96, 24, 3, True, "bfloat16", 1),
    ("e4", 16, 256, 24, 144, 40, 5, True, "bfloat16", 1),
    ("e4-f32", 2, 64, 24, 144, 40, 5, True, "float32", 0),
    ("cin12", 2, 36, 12, 48, 13, 3, True, "bfloat16", 0),
    ("s2-rag-k5", 2, 74, 24, 48, 24, 5, True, "bfloat16", 0),
    ("e7@1024", 16, 256, 40, 160, 80, 3, True, "bfloat16", 0),
    ("e7@720", 16, 180, 40, 160, 80, 3, True, "bfloat16", 0),
)
# Cases added after the flat phases' first run draw from a generator of
# their own (seed + 8), so that the other cases and every later phase get
# the inputs they got before.
FLAT_OWN_GEN = ("s2-rag-k5",)
# mega_block shapes (x is (N, H, C_in, W)): name, batch, H, W, C_in, E,
# C_out, k, folded-BN biases, residual, dtype, launches per "mega" request.
# The 11 rows of the 512px path, then off the path: the f32 path, the
# expand==1 form, a C_out that is not a multiple of 16, an odd H, an H below
# the 16-row tile, and a C_in that is not a multiple of 8 with an odd C_out
# and a W whose last tile is partial (the scalar staging); then d0-d2 at
# 1024px.
MEGA_CASES = (
    ("e1", 16, 512, 512, 16, 96, 16, 3, True, True, "bfloat16", 1),
    ("e3", 16, 256, 256, 24, 144, 24, 3, True, True, "bfloat16", 1),
    ("d3", 8, 128, 128, 96, 288, 96, 5, False, True, "bfloat16", 1),
    ("d4", 8, 128, 128, 96, 384, 80, 5, False, False, "bfloat16", 1),
    ("d5-d6", 8, 256, 256, 80, 320, 80, 3, False, True, "bfloat16", 2),
    ("d7", 8, 256, 256, 80, 320, 40, 3, False, False, "bfloat16", 1),
    ("d8-d9", 8, 512, 512, 40, 160, 40, 5, False, True, "bfloat16", 2),
    ("d10", 8, 512, 512, 40, 240, 24, 5, False, False, "bfloat16", 1),
    ("d11", 8, 512, 512, 24, 144, 24, 3, False, True, "bfloat16", 1),
    ("d12", 8, 512, 512, 24, 144, 16, 3, False, False, "bfloat16", 1),
    ("d13", 8, 512, 512, 16, 96, 16, 3, False, True, "bfloat16", 1),
    ("e1-f32", 2, 128, 128, 16, 96, 16, 3, True, True, "float32", 0),
    ("expand1", 2, 128, 128, 40, 40, 40, 3, True, True, "bfloat16", 0),
    ("cout8", 2, 64, 128, 16, 96, 8, 3, True, False, "bfloat16", 0),
    ("odd-h", 2, 33, 128, 24, 144, 24, 3, False, True, "bfloat16", 0),
    ("h9", 2, 9, 128, 8, 24, 16, 3, True, False, "bfloat16", 0),
    ("cin12", 2, 37, 40, 12, 48, 13, 5, True, False, "bfloat16", 0),
    ("d0-d1@1024", 8, 128, 128, 128, 384, 128, 3, False, True, "bfloat16",
     0),
    ("d2@1024", 8, 128, 128, 128, 384, 96, 3, False, False, "bfloat16", 0),
)
# The 512px path's blocks at f32, the stylize CLI's dtype (``ModelConfig``'s
# default): each bf16 path row of FLAT_BLOCK_CASES, FLAT_S2_CASES and
# MEGA_CASES again as label + F32_TAG in float32, its launches those of
# one 512px batch-8 f32 request (the plan does not depend on the dtype),
# held at F32_TOL and summed per f32 request beside the bf16 sums; plus
# d0-d1 at 1024px (C_out 128 x E 384: sweep 2's f32 design at two ring
# slots, 0 launches).  Sweep 2 of every one must take gate_project_tf32.
# They draw from a generator of their own (seed + F32_SEED).
F32_TAG, F32_SEED = ":f32", 21


def f32_rows(cases, extra=()):
    """The f32 twins of the path rows of ``cases`` and of ``extra``."""
    return tuple((c[0] + F32_TAG,) + c[1:-2] + ("float32", c[-1])
                 for c in cases if c[-1] or c[0] in extra)


def f32_row(label):
    """Whether a case is one of the f32 path rows."""
    return label.endswith(F32_TAG)


FLAT_BLOCK_F32 = f32_rows(FLAT_BLOCK_CASES, ("d0-d1@1024",))
# Beside the path rows, the 3xTF32 sweep 1 of flat_s2_block and mega_block
# at ragged maps (0 launches, drawn last from the f32 generator): stride 2
# at k5 (the whole box) and k3 (two chunks of 8 channels) on maps whose
# last tiles are partial, and mega_block at k5 with C_in 12 (the box's
# channels past C_in zero), an odd H and W = 40 (the shifted grid's last
# tile partial).
FLAT_S2_F32 = f32_rows(FLAT_S2_CASES) + (
    ("s2-rag-k5" + F32_TAG, 2, 74, 24, 48, 24, 5, True, "float32", 0),
    ("s2-rag-k3" + F32_TAG, 2, 70, 16, 48, 16, 3, False, "float32", 0))
MEGA_F32 = f32_rows(MEGA_CASES, ("d0-d1@1024",)) + (
    ("rag40-k5" + F32_TAG, 2, 37, 40, 12, 48, 16, 5, True, False,
     "float32", 0),)
# expand_dw's f32 rows (x float32: the 3xTF32 sweep 1): each 512px path
# shape of EXPAND_DW_CASES, its launches those of one 512px batch-8 f32
# "fused" request, held at F32_TOL / SUMS_TOL and summed per f32 request
# beside the bf16 sums; plus d0-d2 at 1024px and ada_out (C_in 256: the
# x box in 4 chunks of 64 channels, one CTA per SM), 0 launches.  They
# draw from a generator of their own (seed + EXPAND_F32_SEED).
EXPAND_DW_F32 = tuple((c[0] + F32_TAG,) + c[1:] for c in EXPAND_DW_CASES
                      + (ADA_OUT_CASE,)
                      if c[-1] or c[0] in ("d0-d2@1024", ADA_OUT_CASE[0]))
EXPAND_F32_SEED = 25
# sweep 2's design by the value of ``*_last_sweep2``.
SWEEP2_DESIGNS = {0: "generic", 1: "mma", 2: "tf32"}

# fused_sums + fused_project (the two-pass block, NHWC): name, batch, H=W,
# C_in, E, C_out, k, folded-BN biases (with them the projection bias is
# added after the kernel), residual, dtype, blocks of that shape on the
# fused route per request (the 15 of EXPAND_DW_CASES with their C_out).  The
# last two are off that route: the f32 path and the expand==1 form.
TWO_PASS_CASES = (
    ("e1", 16, 512, 16, 96, 16, 3, True, True, "bfloat16", 1),
    ("e3", 16, 256, 24, 144, 24, 3, True, True, "bfloat16", 1),
    ("e5-e6", 16, 128, 40, 160, 40, 5, True, True, "bfloat16", 2),
    ("d3", 8, 128, 96, 288, 96, 5, False, True, "bfloat16", 1),
    ("d4", 8, 128, 96, 384, 80, 5, False, False, "bfloat16", 1),
    ("d5-d6", 8, 256, 80, 320, 80, 3, False, True, "bfloat16", 2),
    ("d7", 8, 256, 80, 320, 40, 3, False, False, "bfloat16", 1),
    ("d8-d9", 8, 512, 40, 160, 40, 5, False, True, "bfloat16", 2),
    ("d10", 8, 512, 40, 240, 24, 5, False, False, "bfloat16", 1),
    ("d11", 8, 512, 24, 144, 24, 3, False, True, "bfloat16", 1),
    ("d12", 8, 512, 24, 144, 16, 3, False, False, "bfloat16", 1),
    ("d13", 8, 512, 16, 96, 16, 3, False, True, "bfloat16", 1),
    ("e1-f32", 2, 128, 16, 96, 16, 3, True, True, "float32", 0),
    ("expand1", 2, 128, 40, 40, 40, 3, True, True, "bfloat16", 0),
    # C_out 128 (the tile design's 16 output tiles) and an odd C_out at
    # C_in 256 (its CUDA-core projection with the chunked x box), k3 and
    # k5, f32 too: shapes the kernel refused before; they draw from a
    # generator of their own (TWO_PASS_OWN_GEN).
    ("c128", 2, 48, 128, 384, 128, 3, False, False, "bfloat16", 0),
    ("odd-cin256-k3", 2, 48, 256, 288, 127, 3, False, False, "bfloat16", 0),
    ("odd-cin256-k5", 2, 48, 256, 288, 13, 5, False, False, "bfloat16", 0),
    ("c128-f32-k5", 2, 48, 256, 288, 128, 5, False, False, "float32", 0),
)
TWO_PASS_OWN_GEN, TWO_PASS_SEED = ("c128", "odd-cin256-k3", "odd-cin256-k5",
                                   "c128-f32-k5"), 22
# The fused route's 12 block shapes again in float32 (the two-pass block's
# f32 time and bound per 512px f32 request, row 3's f32 figures; their
# sums held to float64 by ``tf32_vs_f64``), from a generator of their own
# (seed + TWO_PASS_F32_SEED), after the bf16 cases.
TWO_PASS_F32_SEED = 27
# Ragged shapes off the path (0 launches per request), in each table's
# layout, one per k: H and W not multiples of the sweeps' 16x16 and
# 128-pixel tiles, E not a multiple of sweep 1's 32-channel chunk or sweep
# 2's 64-channel box, for every sweep-1 mode (expand_dw: fused; flat_block:
# flat; mega_block: mega; fused_sums: sums) and both sweep-2 layouts
# (flat_block: NHWC y; mega_block: (N, H, C, W) y).  ``ragged_phase`` runs
# them with a generator of their own.
RAGGED = {
    "expand_dw": (("rag-k3", 2, 37, 16, 48, 3, True, 0),
                  ("rag-k5", 2, 37, 40, 48, 5, False, 0)),
    "flat_block": (
        ("rag-k3", 2, 37, 16, 48, 16, 3, True, True, "bfloat16", 0),
        ("rag-k5", 2, 37, 40, 48, 24, 5, False, False, "bfloat16", 0)),
    "mega_block": (
        ("rag-k3", 2, 37, 37, 16, 48, 16, 3, True, True, "bfloat16", 0),
        ("rag-k5", 2, 37, 37, 40, 48, 24, 5, False, False, "bfloat16", 0)),
    "fused_2pass": (
        ("rag-k3", 2, 37, 16, 48, 16, 3, True, True, "bfloat16", 0),
        ("rag-k5", 2, 37, 40, 48, 24, 5, False, False, "bfloat16", 0)),
}
# The probe kernels' rows: name, source, TPU kernel under scripts/.
PROBE_ROWS = (
    ("probe_copy", "probe_copy.cu", "probe_mega2.py:47"),
    ("probe_mm_einsum", "probe_mm.cu", "probe_mega2.py:111"),
    ("probe_mm_rowloop", "probe_mm.cu", "probe_mega2.py:118"),
    ("probe_dw_t", "probe_dw.cu", "probe_mega2.py:152"),
    ("probe_dw_nhwc", "probe_dw.cu", "probe_mega2.py:165"),
    ("probe_rate", "probe_rate.cu", "probe_vpu_rate.py:70"),
)
RATE_SHAPE = (256, 4096, 512)  # probe_vpu_rate's defaults: C, L, reps
RATE_ROW = ("fma", "f32", 8)  # the case of the probe_rate row
# Launches of each probe kernel in one run of each probe driver at its
# defaults.  probe_mega2's timed() makes 1 + 3 windows x 20 calls (copy,
# depthwise), per_call_ms 1 + 3 x 12 and 1 + 3 x 3 chained calls (products,
# rates), per kernel and shape (rates: per case; seven cases).
PROBE_DRIVERS = (
    ("probe_mega2", counts(probe_copy=2 * 61, probe_mm_einsum=2 * 47,
                           probe_mm_rowloop=2 * 47, probe_dw_t=2 * 61,
                           probe_dw_nhwc=2 * 61)),
    ("probe_vpu_rate", counts(probe_rate=7 * 47)),
)
# Depthwise probe shapes off probe_mega2's, for correctness only: (th,
# C, W, k) not multiples of the kernels' tiles (8 or 4 rows; dw_t 512
# columns of one channel, dw_nhwc 16 columns of 32 channels).  dw_t stages
# a W that is not a multiple of 4 with plain loads ("sync"), any other shape
# asynchronously: whole rows (W 20, 4: one strip that wraps both ways), or
# two segments whose sides are staged (516).
DW_RAGGED = {
    "probe_dw_t": ((13, 37, 37, 3), (11, 5, 516, 5), (9, 3, 20, 5),
                   (6, 3, 4, 3), (5, 2, 3, 5), (7, 3, 1030, 3)),
    "probe_dw_nhwc": ((13, 36, 37, 3), (11, 68, 21, 5), (9, 4, 3, 5),
                      (17, 100, 50, 3)),
}
# Product probe shapes off probe_mega2's, for correctness only: (R, C, E, W)
# off the kernels' tiles (64 pixels, k-steps of 16 rows of C, passes of 64
# columns of E) and limits (C > 256 takes two x boxes, E > 256 two y boxes,
# an even E / 8 a weight moved to stride E + 8 from the y staging tiles or,
# where they cannot hold it, in place: the (240, 240) and (160, 320)
# weights, near the shared memory a CTA has; 4096 items, more than the
# grid, so each CTA walks a ring of several slots, wrapping).
# Every shape stages x and the weight asynchronously (TMA boxes and a bulk
# copy); the "async" cut stages them by plain loads ("sync") and is held to
# the twin too.  ``probes_phase`` draws them from a generator of their own
# (seed + 12).
MM_RAGGED = ((5, 17, 8, 72), (3, 300, 24, 520), (7, 40, 264, 136),
             (1, 1, 8, 8), (2, 240, 240, 64), (2, 160, 320, 64),
             (64, 40, 160, 4096))
# The products' chained checks: (R, C = E, W) and the number of calls, each
# launched straight after the last (a programmatic dependent of it) and
# reading its y, the weights permutations (y[:, e] = x[:, perm[e]]: exact);
# the second walks 4160 items, more than the grid.
MM_CHAIN = (((32, 64, 520), 8), ((64, 64, 4104), 8))
# The (C, E) grid over which the product entry points must take every
# weight whose first design's shared memory (``mm_first_smem``) fit.
MM_LIMIT_C = (1, 16, 40, 100, 160, 240, 256, 257, 300, 400, 512, 640, 768,
              1000, 1400)
MM_LIMIT_E = tuple(range(8, 1601, 8))
SMEM_OPT_IN = 232448  # bytes of shared memory a CTA may have on an H100
# AdaAttN: both taps stacked (2B = 16 images of 64x64 = 4096 positions).
# name, B, Nc, Ns, dtype, scale of q and k (logits of std 128^0.5 scale^2:
# ~1 at 0.3, ~3.4 at 0.55, a peaked softmax), the main path's call.  The
# bf16 cases take the tensor-core kernel, held to adaattn_fwd_error_bound;
# ragged-nc has partial query and key tiles; ragged-f32 takes the float64
# kernel of the training step.  The cases added with the tensor-core
# kernel (``ADAATTN_OWN_GEN``) draw from a generator of their own, so that
# the other cases and every later phase get the inputs they got before.
ADAATTN_OWN_GEN = ("peaked", "ragged-nc")
# One-hot softmax cases (``one_hot_attention``): B, Nc, Ns (<= 128; 100
# leaves a ragged style tail), each at bf16 and f32.
ONE_HOT_CASES = ((16, 4096, 128), (16, 4096, 100))
ADAATTN_CASES = (
    ("taps", 16, 4096, 4096, "bfloat16", 0.3, True),
    ("peaked", 16, 4096, 4096, "bfloat16", 0.55, False),
    ("ragged-ns", 16, 4096, 4000, "bfloat16", 0.3, False),
    ("ragged-nc", 2, 1000, 777, "bfloat16", 0.3, False),
    ("ragged-f32", 2, 1000, 777, "float32", 0.3, False),
)
# The f32 serving form (``adaattn_fwd(..., serve=True)``, 3xTF32): name, B,
# Nc, Ns, q and k scale, value offset.  "taps-f32" is the fused engine's
# call per 512px f32 request (both taps stacked), "graph" the graph
# engine's per tap at 512px batch 8 and "cli-320" at the CLI's default
# 320px batch 1 (1 x 40 x 40 positions: the style axis in 6 chunks,
# ``serve_splits``), "ragged-f32" partial tiles in 3 chunks; "offset"
# values at 3 + N(0, 1) and "peaked" logits of std ~3.4.  Each output is
# held to the twin at F32_TOL (l at L_TOL) and, for mean and std, to the
# float64 form (the float64 statistics rounded once) at most
# SERVE_TWIN_FACTOR times the twin's own distance to it; where the twin's
# mean or std itself lies farther than F32_TOL of its largest value from
# float64 (std = sqrt(ev2 - mean^2) cancels in f32 in the nearly one-hot
# rows of "peaked" and the offset rows), that output is held by the
# float64 rule alone, and the log says so.  The one-hot rows
# (``ONE_HOT_CASES``) go through it too, held to the same gates: the twin
# is exact there, so the rule asks the serving form to be exact.  They
# draw from a generator of their own (seed + 22).
SERVE_CASES = (
    ("taps-f32", 16, 4096, 4096, 0.3, 0.0),
    ("graph", 8, 4096, 4096, 0.3, 0.0),
    ("cli-320", 1, 1600, 1600, 0.3, 0.0),
    ("ragged-f32", 2, 1000, 777, 0.3, 0.0),
    ("offset", 2, 1000, 777, 0.3, 3.0),
    ("peaked", 16, 4096, 4096, 0.55, 0.0),
)
SERVE_TWIN_FACTOR = 2.0
# The main path's calls, where the serving form must beat the float64 form.
SERVE_FASTER = ("taps-f32", "graph", "cli-320")
# One bf16 ulp of the largest value: each hidden/mean/std/output element is
# rounded once from an f32 value that the kernel and its twin sum in
# different orders, so a rounding may flip by one ulp.
BF16_TOL = 2.0 ** -7
F32_TOL = 1e-5
SUMS_TOL = 2e-4   # f32 sums over up to 512*512 pixels, atomics in any order
L_TOL = 1e-4      # f32 sum of up to 4096 exps, tiled in another order
# Request 1 through the kernels vs through the plain twins.  At f32 the two
# differ only in summation order.  At bf16 the 1-ulp rounding flips above
# propagate through ~35 blocks of a network whose random weights sit near
# the edge of chaos, so the kernel path is held to the bf16 path's own
# error: its distance to the plain bf16 path may be at most this factor of
# the plain bf16 path's distance to the plain f32 path.
IMAGE_F32_TOL = (1e-3, 1e-5)       # (max abs, mean abs) on a [0, 1] image
IMAGE_BF16_FACTOR = 2.0


def log(*a):
    print(*a, flush=True)


def timed_ms(fn, iters=10, warmup=2):
    """Mean device ms per call, CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(out, ref):
    return float((out.float() - ref.float()).abs().max())


def check(ok, what):
    if not ok:
        raise AssertionError(what)


# The f32 launches of ``adaattn_fwd`` by form ("serve": the 3xTF32 serving
# kernel, "f64": the float64 one) over the paths whose form is checked
# (``check_forms``): the routes' f32 requests, the lifecycle's
# graph-engine requests, the train phase's timed steps.
F32_FORM_LAUNCHES = {"serve": 0, "f64": 0}


def f32_forms():
    """``adaattn_fwd``'s f32 launches by form so far (a snapshot)."""
    from arbitrarystyletransfer_tpu_torch.ops.kernels.adaattn_fwd import (
        F32_FORMS,
    )

    return dict(F32_FORMS)


def check_forms(before, form, n, what):
    """The f32 ``adaattn_fwd`` launches since ``before`` (``f32_forms()``)
    are ``n``, every one of ``form``; counted in F32_FORM_LAUNCHES."""
    now = f32_forms()
    got = {k: now[k] - before[k] for k in now}
    check(got[form] == n and sum(got.values()) == n,
          f"{what}: f32 adaattn_fwd launches by form {got}, expected {n} "
          f"{form}")
    F32_FORM_LAUNCHES[form] += n


class Bound:
    """The least time the card could take for some launches: the larger of
    their bytes (each input read once, each output written once) over the
    HBM rate and their operations over the peak of their type (bf16 work
    at the tensor-core peak, f32 work at the CUDA-core peak)."""

    def __init__(self):
        self.nbytes = self.flops = 0.0
        self.ops_s = 0.0  # seconds of operations at their peaks

    def add(self, nbytes, flops, peak, times=1):
        self.nbytes += times * nbytes
        self.flops += times * flops
        self.ops_s += times * flops / peak

    def add_block(self, nbytes, mm_flops, dw_flops, size, times=1):
        """A block kernel's launches: its 1x1 products at the fastest rate
        the card reaches at the I/O dtype's accuracy (``size`` 2: the bf16
        tensor cores; 4: three TF32 products per f32 one, as sweep 2's
        3xTF32 design and ``adaattn_bwd`` run them), its depthwise at the
        f32 peak (it runs in f32 at every dtype, as the TPU kernels'
        semantics ask)."""
        self.add(nbytes, mm_flops, PEAK_BF16 if size == 2 else PEAK_TF32 / 3,
                 times)
        self.add(0, dw_flops, PEAK_F32, times)

    def ms(self):
        return 1e3 * max(self.nbytes / HBM_BYTES_S, self.ops_s)

    def by(self):
        return ("bytes" if self.nbytes / HBM_BYTES_S >= self.ops_s
                else "operations")

    def merge(self, other, times=1):
        """Adds ``times`` of another bound's launches."""
        self.nbytes += times * other.nbytes
        self.flops += times * other.flops
        self.ops_s += times * other.ops_s


def sdpa_yardstick(q, k, v, backward=False, windows=5, iters=10,
                   warmup=3):
    """Device ms of one ``F.scaled_dot_product_attention(q, k, cat([v,
    v*v]), scale=1.0)`` call (with ``backward``: forward plus the gradients
    of q, k, v under autograd): A [v, v^2] and its gradients, the function
    of the AdaAttN kernels.  A yardstick only; the port never calls it.
    Each fused backend (flash, efficient attention, cuDNN) that takes the
    inputs' dtype is timed, else each that takes bf16, else the math
    backend: ``warmup`` calls, then the median of ``windows`` windows of
    ``iters`` calls.  Returns (ms, what was timed: the fastest backend and
    its dtype)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    fused = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
             SDPBackend.CUDNN_ATTENTION]
    groups = [[(q.dtype, be) for be in fused]]
    if q.dtype != torch.bfloat16:
        groups.append([(torch.bfloat16, be) for be in fused])
    groups.append([(q.dtype, SDPBackend.MATH)])
    for group in groups:
        best = None
        for dt, backend in group:
            qq, kk, vv = (t.detach().to(dt)[:, None].requires_grad_(backward)
                          for t in (q, k, v))
            g = (torch.randn(*qq.shape[:-1], 2 * qq.shape[-1],
                             device=q.device, dtype=dt) if backward else None)

            def run():
                with sdpa_kernel([backend]):
                    out = F.scaled_dot_product_attention(
                        qq, kk, torch.cat([vv, vv * vv], dim=-1), scale=1.0)
                    if backward:
                        torch.autograd.grad(out, (qq, kk, vv), g)

            try:
                run()
                torch.cuda.synchronize()
            except RuntimeError:
                continue
            for _ in range(warmup - 1):
                run()
            ms = statistics.median(timed_ms(run, iters=iters, warmup=0)
                                   for _ in range(windows))
            label = f"{backend.name.lower()} {str(dt).removeprefix('torch.')}"
            if best is None or ms < best[0]:
                best = (ms, label)
        if best is not None:
            return best
    raise AssertionError("no SDPA backend took the yardstick")


def sweep1_check(kernel, label, dtype, c_in, k, expand=True,
                 layout="nhwc"):
    """The sweep-1 design and x boxes of ``kernel``'s last launch
    ("expand_dw", "flat_block", "flat_s2_block" or "mega_block", whose x
    is ``layout`` "xt" at W % 8 == 0, else "xt_rows"): the design
    ``limits.sweep1_design`` (``s2_sweep1_design``) names for the shape
    (the bf16 tensor-core expand, f32's 3xTF32 or the CUDA-core one) and
    the boxes per halo of its ``sweep1_staging`` (``flat_s2_staging``: the
    whole box, kCSplit's or kXSplit's chunks, ``tf32_chunk``'s); a path
    row at f32 (``f32_row``) must take the 3xTF32 design.  Returns
    (design, boxes)."""
    from arbitrarystyletransfer_tpu_torch.ops.kernels import limits
    from arbitrarystyletransfer_tpu_torch.ops.kernels._build import (
        load_library,
    )

    lib = load_library()
    design = limits.SWEEP1_DESIGNS.get(
        getattr(lib, f"{kernel}_last_sweep1")())
    boxes = getattr(lib, f"{kernel}_last_boxes")()
    bf16 = dtype == "bfloat16"
    s2 = kernel == "flat_s2_block"
    want = (limits.s2_sweep1_design(bf16, c_in, k=k) if s2 else
            limits.sweep1_design(bf16, c_in, expand, layout, k=k))
    check(design == want, f"{kernel} {label} {dtype}: sweep 1 took {design}, "
          f"the mirror says {want}")
    check(not f32_row(label) or design == "tf32", f"{kernel} {label}: the "
          f"f32 path row's sweep 1 took the {design} expand, not 3xTF32")
    if want != "core" and layout != "xt_rows":  # xt_rows: no box
        tf32 = want == "tf32"
        chunks = (limits.flat_s2_staging(k, c_in, tf32) if s2 else
                  limits.sweep1_staging(k, c_in, layout, tf32=tf32))["boxes"]
        check(boxes == chunks, f"{kernel} {label}: {boxes} x boxes per "
              f"halo, the mirror {chunks}")
    return design, boxes


# The f32 kernels against float64: at each f32 path row of rows 1, 3
# ("sums"), 4, 5 and 8, the kernel's output and the f32 twin's against the
# same block in float64 (``block_f64``): row 1's hidden (sweep 1 alone),
# rows 4, 5 and 8's y (sweep 2's 3xTF32 projection too), and every row's SE
# sums (label + " sums"); and sweep 2 alone on the float64 block's hidden
# and exact sums (kernel "sweep2", ``sweep2_vs_f64``).  Held
# (``tf32_gate``): each kernel's max and mean abs distance at most
# TF32_F64_FACTOR times the twin's.
TF32_VS_F64 = []
TF32_F64_FACTOR = 1.5


def block_f64(x, we, wd, k, pre_act=True, be=None, bd=None, se=None,
              wp=None, pb=None, identity=False, stride=1):
    """The block of NHWC ``x`` in float64 from the same f32 operands, with
    no rounding between its stages: expand_dw's (hidden, sums) where
    ``se`` is None, else the whole block's (y, sums)."""
    import torch
    import torch.nn.functional as F
    from arbitrarystyletransfer_tpu_torch.ops.basic import (
        hardswish,
        reflect_pad,
        se_gate,
    )

    h = x.double()
    if we is not None:
        h = h @ we.double()
    if be is not None:
        h = h + be.double()
    if pre_act:
        h = hardswish(h)
    hp = reflect_pad(h, (k - 1) // 2).permute(0, 3, 1, 2)
    out = F.conv2d(hp, wd.double().permute(2, 0, 1)[:, None], stride=stride,
                   groups=wd.shape[-1]).permute(0, 2, 3, 1)
    if bd is not None:
        out = out + bd.double()
    hidden = hardswish(out)
    sums = hidden.sum(dim=(1, 2))
    if se is None:
        return hidden, sums
    se64 = {name: {key: t.double() for key, t in layer.items()}
            for name, layer in se.items()}
    gate = se_gate(sums, hidden.shape[1] * hidden.shape[2], se64)
    y = (hidden * gate[:, None, None, :]) @ wp.double()
    if pb is not None:
        y = y + pb.double()
    if identity:
        y = y + x.double()
    return y, sums


def tf32_vs_f64(kernel, label, out, twin, exact):
    """Records and logs the kernel's and the twin's max and mean abs
    distance to ``exact`` (float64) at one f32 path row."""
    d_k = (out.double() - exact).abs()
    d_t = (twin.double() - exact).abs()
    rec = {"kernel": kernel, "row": label,
           "kernel_max": float(d_k.max()), "twin_max": float(d_t.max()),
           "kernel_mean": float(d_k.mean()), "twin_mean": float(d_t.mean()),
           "scale": float(exact.abs().max())}
    rec["farther"] = rec["kernel_max"] > rec["twin_max"]
    for key in ("max", "mean"):
        rec[f"factor_{key}"] = (rec[f"kernel_{key}"] / rec[f"twin_{key}"]
                                if rec[f"twin_{key}"] else
                                0.0 if not rec[f"kernel_{key}"] else math.inf)
    TF32_VS_F64.append(rec)
    log(f"{kernel} {label} vs float64: kernel max {rec['kernel_max']:.4g} "
        f"mean {rec['kernel_mean']:.4g}, f32 twin max {rec['twin_max']:.4g} "
        f"mean {rec['twin_mean']:.4g} (largest value {rec['scale']:.4g})"
        + (" -- the kernel farther" if rec["farther"] else ""))


def tf32_gate():
    """Logs ``TF32_VS_F64`` and fails where a kernel lies more than
    TF32_F64_FACTOR times as far from float64 as its f32 twin (max abs or
    mean abs)."""
    log(json.dumps({"tf32_vs_f64": TF32_VS_F64}))
    far = [f"{r['kernel']} {r['row']} (max {r['factor_max']:.3f}x, mean "
           f"{r['factor_mean']:.3f}x)" for r in TF32_VS_F64
           if max(r["factor_max"], r["factor_mean"]) > TF32_F64_FACTOR]
    worst = max((max(r["factor_max"], r["factor_mean"])
                 for r in TF32_VS_F64), default=0.0)
    log(f"tf32_vs_f64: {len(TF32_VS_F64)} rows, the largest factor of the "
        f"twin's distance to float64 {worst:.3f} (limit "
        f"{TF32_F64_FACTOR})")
    check(not far, f"f32 kernels past {TF32_F64_FACTOR}x their twin's "
          f"distance to float64: {far}")


def repeat_check(kernel, label, fn, x, outs):
    """``fn(x)`` launched again returns ``outs`` bit for bit, and
    ``fn(x[:1])`` (image 0 alone, the same pointer) returns image 0 of
    ``outs`` bit for bit: no output depends on the order in which the
    CTAs ran, on the grid or on the batch."""
    import torch

    again = fn(x)
    check(all(torch.equal(a, b) for a, b in zip(outs, again)),
          f"{kernel} {label}: a second launch differs")
    del again
    if x.shape[0] > 1:
        one = fn(x[:1])
        check(all(torch.equal(a[:1], b) for a, b in zip(outs, one)),
              f"{kernel} {label}: image 0 alone differs from image 0 of "
              f"the batch of {x.shape[0]}")


def launch_sweep2(hidden, sums, se, wp, pb, res):
    """Sweep 2 alone (``gate_project_launch``, the designed kernel of the
    dtype) on NHWC ``hidden`` and its ``sums``: y NHWC."""
    import torch
    from arbitrarystyletransfer_tpu_torch.ops.kernels import _build

    n, h, w, e = hidden.shape
    dt = hidden.dtype
    c_out = wp.shape[1]
    d0t = se["Dense_0"]["kernel"].t().contiguous()
    d1k = se["Dense_1"]["kernel"].contiguous()
    wpt = wp.to(dt).t().contiguous()
    gate = torch.empty(n, e, device=hidden.device)
    y = torch.empty(n, h, w, c_out, dtype=dt, device=hidden.device)
    rc = _build.load_library().gate_project_launch(
        1, hidden.data_ptr(), sums.data_ptr(), d0t.data_ptr(),
        se["Dense_0"]["bias"].data_ptr(), d1k.data_ptr(),
        se["Dense_1"]["bias"].data_ptr(), wpt.data_ptr(),
        None if pb is None else pb.data_ptr(),
        None if res is None else res.data_ptr(), gate.data_ptr(),
        y.data_ptr(), n, h * w, e, d0t.shape[0], c_out, w, 0,
        int(dt == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "gate_project")
    return y


def sweep2_vs_f64(label, x, we, wd, k, pre_act, be, bd, se, wp, pb,
                  residual):
    """Sweep 2 alone against float64 at one f32 row of flat_block: the
    float64 block's hidden rounded once to f32 and its exact sums rounded
    once, through the kernel's sweep 2 (``launch_sweep2``) and the twin's
    (``gate_project_reference``), each against sweep 2 in float64 on that
    hidden and the exact sums (``tf32_vs_f64`` kernel "sweep2")."""
    from arbitrarystyletransfer_tpu_torch.ops.basic import se_gate
    from arbitrarystyletransfer_tpu_torch.ops.kernels.flat_block import (
        gate_project_reference,
    )

    hidden64, sums64 = block_f64(x, we, wd, k, pre_act, be, bd)
    hidden, sums = hidden64.float().contiguous(), sums64.float()
    del hidden64
    res = x if residual else None
    y = launch_sweep2(hidden, sums, se, wp, pb, res)
    twin = gate_project_reference(hidden, sums, se, wp, pb, res)
    se64 = {name: {key: t.double() for key, t in layer.items()}
            for name, layer in se.items()}
    gate = se_gate(sums64, hidden.shape[1] * hidden.shape[2], se64)
    exact = (hidden.double() * gate[:, None, None, :]) @ wp.double()
    if pb is not None:
        exact = exact + pb.double()
    if residual:
        exact = exact + x.double()
    tf32_vs_f64("sweep2", label, y, twin, exact)


def expand_dw_phase(gen, cases=None):
    """expand_dw against its twin at each case, with the sweep-1 design and
    boxes each must take (``sweep1_check``); returns the worst hidden error
    of the bf16 cases, the device ms per 512px batch-8 bf16 "fused"
    request (kernel, twin), its bound, and the same of the f32 request (the
    f32 rows, ``EXPAND_DW_F32``) as a dict."""
    import torch
    from arbitrarystyletransfer_tpu_torch.ops.kernels.expand_dw import (
        expand_dw,
        expand_dw_reference,
    )

    worst = 0.0
    ms = plain_ms = 0.0
    bound = Bound()
    f32 = {"ms": 0.0, "plain_ms": 0.0, "bound": Bound(), "worst": 0.0}
    # Off the main path: the expand==1 form, and a C_in that is not a
    # multiple of 8 (the CUDA-core expand instead of the tensor cores).
    if cases is None:
        cases = EXPAND_DW_CASES + (("expand1", 2, 128, 40, 40, 3, True, 0),
                                   ("cin12", 2, 37, 12, 40, 5, True, 0),
                                   ADA_OUT_CASE) + EXPAND_DW_F32
    own = torch.Generator(device=DEVICE).manual_seed(SEED + ADA_OUT_SEED)
    big = torch.Generator(device=DEVICE).manual_seed(SEED + SIZE_CASES_SEED)
    gen32 = torch.Generator(device=DEVICE).manual_seed(SEED + EXPAND_F32_SEED)
    for name, n, hw, c_in, e, k, bn, per_req in cases:
        expand = name != "expand1"
        dev = dict(device=DEVICE)
        dt = torch.float32 if f32_row(name) else torch.bfloat16
        g = (gen32 if f32_row(name) else own if name == ADA_OUT_CASE[0]
             else big if size_case(name) else gen)
        x = torch.randn(n, hw, hw, c_in, generator=g, **dev).to(dt)
        we = (torch.randn(c_in, e, generator=g, **dev) / math.sqrt(c_in)
              if expand else None)
        wd = torch.randn(k, k, e, generator=g, **dev) / k
        be = 0.1 * torch.randn(e, generator=g, **dev) if bn else None
        bd = 0.1 * torch.randn(e, generator=g, **dev) if bn else None
        args = (x, we, wd, k, expand, be, bd)
        hidden, sums = expand_dw(*args)
        torch.cuda.synchronize()
        design, boxes = sweep1_check("expand_dw", name, str(dt)[6:], c_in, k,
                                     expand)
        repeat_check("expand_dw", name, lambda xx: expand_dw(xx, *args[1:]),
                     x, (hidden, sums))
        r_hidden, r_sums = expand_dw_reference(*args)
        err_h, err_s = max_err(hidden, r_hidden), max_err(sums, r_sums)
        if f32_row(name) and per_req:
            exact_h, exact_s = block_f64(x, we, wd, k, expand, be, bd)
            tf32_vs_f64("expand_dw", name, hidden, r_hidden, exact_h)
            tf32_vs_f64("expand_dw", name + " sums", sums, r_sums, exact_s)
            del exact_h, exact_s
        rel = F32_TOL if dt == torch.float32 else BF16_TOL
        tol_h = rel * float(r_hidden.float().abs().max())
        tol_s = SUMS_TOL * float(r_sums.abs().max())
        if f32_row(name):
            f32["worst"] = max(f32["worst"], err_h)
        else:
            worst = max(worst, err_h)
        del hidden, sums, r_hidden, r_sums
        t_k = timed_ms(lambda: expand_dw(*args))
        t_p = timed_ms(lambda: expand_dw_reference(*args), iters=3, warmup=1)
        size = x.element_size()
        case_bound = Bound()
        case_bound.add_block(size * n * hw * hw * (c_in + e) + 4 * n * e,
                             2 * n * hw * hw * e * c_in * expand,
                             2 * n * hw * hw * e * k * k, size)
        if f32_row(name):
            f32["ms"] += per_req * t_k
            f32["plain_ms"] += per_req * t_p
            f32["bound"].merge(case_bound, per_req)
        else:
            ms += per_req * t_k
            plain_ms += per_req * t_p
            bound.merge(case_bound, per_req)
        log(f"expand_dw {name:8s} x={tuple(x.shape)} {str(dt)[6:]} E={e} "
            f"k={k} bn={bn}: hidden err {err_h:.4g} (tol {tol_h:.4g}), sums "
            f"err {err_s:.4g} (tol {tol_s:.4g}); kernel {t_k:.4f} ms, plain "
            f"{t_p:.4f} ms, bound {case_bound.ms():.4f} ms "
            f"({case_bound.by()}), sweep 1 {design}, x boxes per halo "
            f"{boxes}")
        check(err_h <= tol_h and err_s <= tol_s, f"expand_dw {name} differs")
        torch.cuda.empty_cache()
    if ms:  # the path's cases
        log(f"expand_dw per fused request: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound.ms():.4f} ms ({bound.by()})")
    if f32["ms"]:
        log(f"expand_dw per fused f32 request: kernel {f32['ms']:.4f} ms, "
            f"plain {f32['plain_ms']:.4f} ms, bound "
            f"{f32['bound'].ms():.4f} ms ({f32['bound'].by()})")
    return worst, ms, plain_ms, bound, f32


def ragged_phase(gen):
    """The ragged shapes (``RAGGED``) through every sweep-1 mode and both
    sweep-2 layouts, each against its twin at its usual gate."""
    from arbitrarystyletransfer_tpu_torch.ops.kernels.flat_block import (
        flat_block,
        flat_block_reference,
    )

    expand_dw_phase(gen, RAGGED["expand_dw"])
    flat_kernel_phase(gen, "flat_block", flat_block, flat_block_reference,
                      RAGGED["flat_block"], 1)
    mega_phase(gen, RAGGED["mega_block"])
    two_pass_phase(gen, RAGGED["fused_2pass"])


# Shapes whose x box the first sweeps stage in channel chunks,
# none of them on a route but ada_out's (``ADA_OUT_CASE``): name, batch,
# H=W (not a multiple of the 16x16 tiles), C_in, E, C_out, k; bf16, no
# folded BN.  expand_dw, flat_block and fused_sums take 4 chunks of 64
# channels (kCSplit), flat_s2_block 8 of 32, fused_project the tile design
# with kCSplit's chunks (its persistent design stages whole boxes).
SPLIT_CASES = (("cin256-k3", 2, 48, 256, 288, 64, 3),
               ("cin256-k5", 2, 48, 256, 288, 64, 5))
SPLIT_SEED = 19
# The grid on which the split phase holds ops/kernels/limits.py to the
# kernels' own shared-memory arithmetic: k 3 and 5, every C_in from 8 to
# 512 in steps of 8, each C_out of MIRROR_C_OUT (even and odd:
# fused_project's two projections; the persistent design at 64 and 96,
# with E = 4 C_in, whose resident expand weights it counts; the tile
# design's 16 output tiles at 127 and 128).  The flat and mega blocks'
# sweep 2 is queried at E 64, C_out 64 (sweep 1's bytes do not depend on
# them).  Then sweep 2 itself (``sweep2_staging`` against
# ``gate_project_occupancy``): every E of MIRROR_E at each C_out of
# MIRROR_SWEEP2_C_OUT, bf16 and f32, NHWC and (N, H, C, W), the design's
# bytes and ring slots, or both refuse it.
MIRROR_C_IN, MIRROR_C_OUT = tuple(range(8, 520, 8)), (13, 64, 96, 127, 128)
MIRROR_E = tuple(range(4, 780, 4))
MIRROR_SWEEP2_C_OUT = (13, 16, 24, 40, 80, 96, 104, 128, 130)


def smem_mirror_check():
    """``ops/kernels/limits.py`` against the kernels on this card: the
    shared memory a CTA may have (``max_smem_optin``) is the mirror's
    ``SMEM_OPT_IN``, and at every shape of ``MIRROR_C_IN`` x
    ``MIRROR_C_OUT`` the bytes of the bf16 sweep-1 kernel that each
    launcher takes (``expand_dw_occupancy``, ``flat_block_occupancy``,
    ``mega_block_occupancy``, ``flat_s2_occupancy`` and
    ``fused_project_occupancy`` of the design the mirror names) are the
    mirror's, or both refuse the shape.  Launches nothing; returns the
    number of shapes compared."""
    import ctypes

    from arbitrarystyletransfer_tpu_torch.ops.kernels import limits
    from arbitrarystyletransfer_tpu_torch.ops.kernels._build import (
        load_library,
    )

    lib = load_library()
    check(lib.max_smem_optin() == limits.SMEM_OPT_IN,
          f"the card's shared memory per CTA is {lib.max_smem_optin()}, the "
          f"mirror's {limits.SMEM_OPT_IN}")
    out = (ctypes.c_int * 6)()
    ptr = ctypes.cast(out, ctypes.c_void_p)

    def kernel_smem(name, *args):
        return out[1] if getattr(lib, name)(*args, ptr) == 0 else None

    def mirror_smem(fn, *args, **kw):
        try:
            return fn(*args, **kw)
        except ValueError:
            return None

    compared = 0
    for k in (3, 5):
        for c_in in MIRROR_C_IN:
            e = 4 * c_in
            pairs = [
                ("expand_dw", kernel_smem("expand_dw_occupancy", k, c_in),
                 mirror_smem(limits.check_sweep1, "expand_dw", k, c_in)),
                ("flat_block", kernel_smem("flat_block_occupancy", k, c_in,
                                           64, 64, 0),
                 mirror_smem(limits.check_sweep1, "flat_block", k, c_in)),
                ("mega_block", kernel_smem("mega_block_occupancy", k, c_in,
                                           64, 64, 0),
                 mirror_smem(limits.check_sweep1, "mega_block", k, c_in,
                             "xt")),
                ("flat_s2_block", kernel_smem("flat_s2_occupancy", k, c_in,
                                              64, 64),
                 mirror_smem(limits.check_flat_s2, k, c_in))]
            for c_out in MIRROR_C_OUT:
                st = mirror_smem(limits.check_fused_project, k, c_in, c_out,
                                 e=e)
                design = int(st is not None and st["design"] == "persistent")
                pairs.append((f"fused_project C_out {c_out} design {design}",
                              kernel_smem("fused_project_occupancy", design,
                                          k, c_in, e, c_out), st))
            for name, got, st in pairs:
                want = None if st is None else st["smem"]
                check(got == want, f"{name} k {k} C_in {c_in}: the kernel "
                      f"takes {got} bytes of shared memory, the mirror "
                      f"{want} (None: refused)")
                compared += 1
    log(f"smem mirror: {compared} shapes (k 3, 5; C_in "
        f"{MIRROR_C_IN[0]}-{MIRROR_C_IN[-1]}; C_out {MIRROR_C_OUT}) equal "
        f"the kernels' own, the card's {lib.max_smem_optin()} bytes per CTA "
        "the mirror's")
    # The f32 3xTF32 sweep 1 (expand_dw, flat_block: NHWC; mega_block: the
    # (N, H, C, W) box; flat_s2_block: its stride-2 layout): its bytes,
    # boxes per halo and channels per box, or both refuse it (the
    # CUDA-core expand takes the shape); and at least the CTAs per SM its
    # sizing was made for ("ctas").
    def tf32_mirror(layout, c_in, k):
        try:
            if layout == "s2":
                return limits.flat_s2_staging(k, c_in, f32=True)
            if layout == "nhwc" and c_in % 8:
                return None
            return limits.sweep1_staging(k, c_in, layout, tf32=True)
        except ValueError:
            return None

    tf32 = 0
    queries = (("expand_dw", "nhwc"), ("flat_block", "nhwc"),
               ("mega_block", "xt"), ("flat_s2", "s2"))
    for k in (3, 5):
        for c_in in MIRROR_C_IN:
            for name, layout in queries:
                st = tf32_mirror(layout, c_in, k)
                want = st and (st["smem"], st["boxes"], st["chunk"])
                rc = getattr(lib, f"{name}_f32_occupancy")(k, c_in, ptr)
                got = None if rc else (out[1], out[3], out[4])
                check(got == want, f"{name} f32 k {k} C_in {c_in}: the "
                      f"kernel takes {got} (bytes, boxes, channels per box), "
                      f"the mirror {want} (None: the CUDA-core expand)")
                if got:
                    check(out[2] >= st["ctas"], f"{name} f32 k {k} C_in "
                          f"{c_in}: {out[2]} CTAs per SM, the mirror "
                          f"{st['ctas']}")
                compared += 1
                tf32 += got is not None
    log(f"3xTF32 sweep-1 mirror: {len(MIRROR_C_IN) * 2 * len(queries)} "
        f"shapes (k 3, 5; {', '.join(q[0] for q in queries)}), {tf32} on "
        "the design, the rest on the CUDA-core expand, equal the kernels' "
        "bytes, boxes and chunks")
    out4 = (ctypes.c_int * 4)()
    ptr4 = ctypes.cast(out4, ctypes.c_void_p)
    designs = {"mma": 0, "tf32": 0, "generic": 0}
    for e in MIRROR_E:
        for c_out in MIRROR_SWEEP2_C_OUT:
            for bf16 in (True, False):
                for yt in (False, True):
                    st = limits.sweep2_staging(e, c_out, bf16, yt)
                    designs[st["design"]] += 1
                    rc = lib.gate_project_occupancy(1, e, c_out, 1, int(yt),
                                                    int(bf16), ptr4)
                    got = (None if rc else (out4[1], out4[3]))
                    want = (None if st["design"] == "generic"
                            else (st["smem"], st["slots"]))
                    check(got == want, f"sweep 2 E {e} C_out {c_out} bf16 "
                          f"{bf16} yt {yt}: the kernel takes {got} (bytes, "
                          f"slots), the mirror {want} (None: generic)")
                    compared += 1
    log(f"sweep-2 mirror: {sum(designs.values())} shapes (E "
        f"{MIRROR_E[0]}-{MIRROR_E[-1]}, C_out {MIRROR_SWEEP2_C_OUT}, bf16 "
        f"and f32, both layouts) equal the kernel's design, bytes and ring "
        f"slots ({designs})")
    return compared


def split_phase(gen):
    """Every sweep-1 launcher at ``SPLIT_CASES``, against its twin at the
    usual gates (one bf16 ulp of the largest output; ``SUMS_TOL`` for the
    SE sums), with the staging each must take."""
    import torch
    from arbitrarystyletransfer_tpu_torch.ops.basic import se_gate
    from arbitrarystyletransfer_tpu_torch.ops.kernels import (
        expand_dw as edw_mod,
        flat_block as flat_mod,
        flat_s2 as s2_mod,
        fused_2pass as f2p_mod,
    )
    from arbitrarystyletransfer_tpu_torch.ops.kernels._build import (
        load_library,
    )

    lib = load_library()
    smem_mirror_check()
    for label, n, hw, c_in, e, c_out, k in SPLIT_CASES:
        x = torch.randn(n, hw, hw, c_in, generator=gen,
                        device=DEVICE).bfloat16()
        (we, wd, se, wp), _ = random_block(gen, c_in, e, c_out, k, False)
        runs = {
            "expand_dw": (lambda: edw_mod.expand_dw(x, we, wd, k),
                          lambda: edw_mod.expand_dw_reference(x, we, wd, k),
                          lib.expand_dw_last_boxes, 4),
            "flat_block": (lambda: flat_mod.flat_block(x, we, wd, se, wp, k),
                           lambda: flat_mod.flat_block_reference(
                               x, we, wd, se, wp, k), None, None),
            "flat_s2_block": (
                lambda: s2_mod.flat_s2_block(x, we, wd, se, wp, k),
                lambda: s2_mod.flat_s2_block_reference(x, we, wd, se, wp, k),
                lib.flat_s2_block_last_boxes, 8),
            "fused_sums": (lambda: (f2p_mod.fused_sums(x, we, wd, k),),
                           lambda: (f2p_mod.fused_sums_reference(
                               x, we, wd, k),), None, None),
        }
        for name, (kernel, twin, boxes, want) in runs.items():
            outs = kernel()
            torch.cuda.synchronize()
            got = boxes() if boxes else None
            refs = twin()
            errs = []
            for o, r in zip(outs, refs):  # the output (bf16), the sums
                tol = BF16_TOL if o.dtype == torch.bfloat16 else SUMS_TOL
                err = max_err(o, r)
                errs.append(err)
                check(tuple(o.shape) == tuple(r.shape)
                      and err <= tol * float(r.float().abs().max()),
                      f"{name} {label}: err {err}")
            log(f"split {name} {label} x={tuple(x.shape)} E={e} "
                f"C_out={c_out} k={k}: errs {[f'{v:.4g}' for v in errs]}"
                + (f", x boxes per halo {got}" if got is not None else ""))
            check(want is None or got == want,
                  f"{name} {label}: {got} boxes per halo, expected {want}")
            del outs, refs
        gate = se_gate(f2p_mod.fused_sums_reference(x, we, wd, k), hw * hw,
                       se)
        y = f2p_mod.fused_project(x, we, wd, k, gate, wp)
        torch.cuda.synchronize()
        design = lib.fused_project_last_design()
        r_y = f2p_mod.fused_project_reference(x, we, wd, k, gate, wp)
        err = max_err(y, r_y)
        log(f"split fused_project {label}: err {err:.4g}, design "
            f"{ {1: 'persistent', 0: 'tile'}.get(design) }")
        check(design == 0, f"fused_project {label}: design {design}")
        check(err <= BF16_TOL * float(r_y.float().abs().max()),
              f"fused_project {label}: err {err}")
        torch.cuda.empty_cache()


def sweeps_phase(gen):
    """Rows 1, 4, 8 and 5 by sweep at every shape of their path: each sweep's
    device ms (a profiler trace), its own bound (sweep 1: the f32
    depthwise at the f32 peak and the expand at the bf16 peak against x,
    the hidden and the sums at HBM; sweep 2: the hidden, the sums, y and
    the residual at HBM against the projection at the bf16 peak), its
    share of it, its TFLOP/s and TB/s, its kernel's registers, shared
    memory and CTAs per SM (``scripts/sweep_times.py``, one JSON line per
    shape and sweep); then each sweep's ms per request; then, on a
    generator of their own, the 1024px blocks of sweep 2's C_out-128 bucket
    and ``mega_block``'s C_out-96 d2 beside them (``SWEEP_1024``, on no
    512px request), split by sweep."""
    import torch
    from arbitrarystyletransfer_tpu_torch.scripts.sweep_times import (
        time_sweeps,
    )

    records = time_sweeps(
        gen, [c for c in EXPAND_DW_CASES if c[-1]],
        [c for c in FLAT_BLOCK_CASES if c[-1]], DEVICE, log,
        mega_cases=[c for c in MEGA_CASES if c[-1]],
        s2_cases=[c for c in FLAT_S2_CASES if c[-1]])
    for r in records:
        if r["kernel"] in ("mega_block", "flat_s2_block") and "staging" in r:
            check(r["staging"] == "async",
                  f"{r['kernel']} {r['shape']}: x staged {r['staging']}")
    per_req = {}
    for r in records:
        key = f"{r['kernel']} {r['sweep']}"
        per_req[key] = per_req.get(key, 0.0) + r["ms"] * r["per_request"]
    log("sweeps per request (expand_dw on \"fused\", flat_block and "
        "flat_s2_block on \"flat-all\", mega_block on \"mega\"): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in per_req.items()))
    gen_1024 = torch.Generator(device=DEVICE).manual_seed(SEED + SWEEP_1024[1])
    big = time_sweeps(
        gen_1024, [], [c for c in FLAT_BLOCK_CASES if c[0] in SWEEP_1024[0]],
        DEVICE, log,
        mega_cases=[c for c in MEGA_CASES if c[0] in SWEEP_1024[0]])
    log("sweeps at 1024px (ms per launch): " + ", ".join(
        f"{r['kernel']} {r['shape']} {r['sweep']} {r['ms']:.4f}"
        for r in big))
    sweep2_phase(gen)
    # The f32 path rows of expand_dw, flat_block, mega_block and
    # flat_s2_block by sweep (the 3xTF32 sweep 1), on a generator of their
    # own; mega_block and flat_s2_block draw after the others.
    gen32 = torch.Generator(device=DEVICE).manual_seed(
        SEED + EXPAND_F32_SEED + 1)
    f32 = time_sweeps(
        gen32, [c for c in EXPAND_DW_F32 if c[-1]],
        [c for c in FLAT_BLOCK_F32 if c[-1]], DEVICE, log,
        mega_cases=[c for c in MEGA_F32 if c[-1]],
        s2_cases=[c for c in FLAT_S2_F32 if c[-1]], expand_dtype="float32")
    for r in f32:
        if r["kernel"] in ("mega_block", "flat_s2_block") and "staging" in r:
            check(r["staging"] == "async",
                  f"{r['kernel']} {r['shape']}: x staged {r['staging']}")
    per_f32 = {}
    for r in f32:
        key = f"{r['kernel']} {r['sweep']}"
        per_f32[key] = per_f32.get(key, 0.0) + r["ms"] * r["per_request"]
    log("sweeps per 512px f32 request (expand_dw on \"fused\", flat_block "
        "and flat_s2_block on \"flat-all\", mega_block on \"mega\"): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in per_f32.items()))
    return per_req


# The 1024px rows the sweeps phase splits by sweep (0 launches per 512px
# request), and their generator's seed offset.
SWEEP_1024 = (("e12@1024", "e13-e14@1024", "d0-d1@1024", "d2@1024"), 23)


def sweep2_cases():
    """Sweep 2 alone at the shapes whose design this slice added: the
    C_out-128 blocks at bf16 (flat_block's NHWC y, mega_block's (N, H, C,
    W) y) and every f32 path block (the f32 rows), as ``sweep2_ab`` takes
    them: (label, n, h, w, e, c_out, residual, dtype, yt, launches per
    request on "flat-all" ("mega" for the mega rows))."""
    cases = [(c[0], c[1], c[2], c[2], c[4], c[5], c[8], c[9], False, c[-1])
             for c in FLAT_BLOCK_CASES + FLAT_BLOCK_F32
             if c[5] > 96 or f32_row(c[0])]
    cases += [(c[0], c[1], c[2] // 2, c[2] // 2, c[4], c[5], False, c[8],
               False, c[-1]) for c in FLAT_S2_F32 if c[-1]]
    cases += [(c[0] + "/yt", c[1], c[2], c[3], c[5], c[6], c[9], c[10],
               True, c[-1]) for c in MEGA_CASES + MEGA_F32
              if c[6] > 96 or c[0] == "d5-d6" + F32_TAG]
    return cases


def sweep2_phase(gen):
    """The A/B of sweep 2 (``sweep_times.sweep2_ab``) at ``sweep2_cases``
    on a generator of its own: the designed kernel must take each shape,
    hold to the twin, and beat the CUDA-core gate_project_generic in every
    turn; then sweep 2's ms per 512px f32 request on "flat-all" by design
    and the designed one's share of the byte bound at the decoder's
    shapes."""
    import torch
    from arbitrarystyletransfer_tpu_torch.scripts.sweep_times import (
        sweep2_ab,
    )

    gen2 = torch.Generator(device=DEVICE).manual_seed(SEED + F32_SEED + 2)
    records = sweep2_ab(gen2, sweep2_cases(), DEVICE, log)
    per_req = {"generic": 0.0, "tf32": 0.0}
    for r in records:
        new = "mma" if r["dtype"] == "bfloat16" else "tf32"
        ran = sorted(set(r) & set(SWEEP2_DESIGNS.values()))
        check(new in r and "generic" in r,
              f"sweep 2 {r['sweep2_ab']}: the designs that ran: {ran}")
        for design in ("generic", new):
            check(r[design]["err"] <= r["tol"], f"sweep 2 {r['sweep2_ab']} "
                  f"{design}: err {r[design]['err']} > {r['tol']}")
        check(max(r[new]["ms"]) < min(r["generic"]["ms"]),
              f"sweep 2 {r['sweep2_ab']}: {new} {r[new]['ms']} ms is not "
              f"faster than generic {r['generic']['ms']}")
        if new == "tf32" and not r["yt"]:  # the flat-all request's blocks
            for design in per_req:
                per_req[design] += r["per_request"] * r[design]["ms_median"]
    log("sweep 2 per 512px batch-8 f32 request on flat-all (15 flat_block, 2 "
        "flat_s2_block): " + ", ".join(f"{k} {v:.4f} ms"
                                       for k, v in per_req.items()))
    log("sweep 2 tf32 share of the byte bound at the 512px decoder shapes: "
        + ", ".join(f"{r['sweep2_ab']} {r['tf32']['bytes_share']:.3f}"
                    for r in records if "tf32" in r and r["per_request"]
                    and r["sweep2_ab"].startswith("d") and not r["yt"]))
    return records


def one_hot_attention(gen, b, nc, ns, dtype):
    """(q, k, v, t) whose softmax is one-hot: key j is the unit vector e_j
    (Ns <= 128), and query i has the logit 0 at its key t[i] and -256 at
    every other, where exp underflows to 0 in f32.  Then mean = v[t] and
    ev2 = v[t]^2 exactly, and std = 0 exactly, in any arithmetic that feeds
    v^2 in exactly.  Where v^2 is rounded to bf16 instead (one product over
    [v, bf16(v^2)], as SDPA on cat([v, v*v]) does), std = sqrt(bf16(v^2) -
    v^2) > 0 wherever the rounding went up: up to |v| / 16, and inside
    ``adaattn_fwd_error_bound``, which allows sqrt(2^-8 v^2) there."""
    import torch
    import torch.nn.functional as F

    t = torch.randint(ns, (b, nc), generator=gen, device=DEVICE)
    q = (-256.0 * (1.0 - F.one_hot(t, 128).float())).to(dtype)
    k = torch.eye(ns, 128, device=DEVICE).expand(b, ns, 128).to(dtype)
    v = torch.randn(b, ns, 128, generator=gen, device=DEVICE).to(dtype)
    return q, k.contiguous(), v, t


def one_hot_check(gen):
    """``adaattn_fwd`` on ``one_hot_attention``'s inputs at each case of
    ``ONE_HOT_CASES`` and dtype: mean must equal v[t] and std must be 0, bit
    for bit, and m = 0, l = 1."""
    import torch
    from arbitrarystyletransfer_tpu_torch.ops.kernels.adaattn_fwd import (
        adaattn_fwd,
    )

    for b, nc, ns in ONE_HOT_CASES:
        for dt in (torch.bfloat16, torch.float32):
            q, k, v, t = one_hot_attention(gen, b, nc, ns, dt)
            mean, std, m, l = adaattn_fwd(q, k, v)
            torch.cuda.synchronize()
            want = torch.gather(v, 1, t[..., None].expand(b, nc, 128))
            exact = (torch.equal(mean, want) and bool((std == 0).all())
                     and bool((m == 0).all()) and bool((l == 1).all()))
            log(f"adaattn_fwd one-hot ({b}, {nc}, {ns}) {dt}: mean == v[t] "
                f"{torch.equal(mean, want)}, std max {float(std.max()):.4g} "
                f"({int((std != 0).sum())} of {std.numel()} nonzero), "
                f"m == 0 {bool((m == 0).all())}, l == 1 "
                f"{bool((l == 1).all())}")
            check(exact, f"adaattn_fwd one-hot ({b}, {nc}, {ns}) {dt}: not "
                  "the exact answer")
            del q, k, v, t, mean, std, m, l, want


def adaattn_phase(gen, gen_own):
    import torch
    from arbitrarystyletransfer_tpu_torch.ops.kernels.adaattn_fwd import (
        adaattn_fwd,
        adaattn_fwd_error_bound,
        adaattn_fwd_reference,
    )

    worst = 0.0
    ms = plain_ms = library_ms = None
    bound = Bound()
    for name, b, nc, ns, dtype, scale, main in ADAATTN_CASES:
        dt = getattr(torch, dtype)
        dev = dict(device=DEVICE,
                   generator=gen_own if name in ADAATTN_OWN_GEN else gen)
        q = (scale * torch.randn(b, nc, 128, **dev)).to(dt)
        k = (scale * torch.randn(b, ns, 128, **dev)).to(dt)
        v = torch.randn(b, ns, 128, **dev).to(dt)
        out = adaattn_fwd(q, k, v)
        torch.cuda.synchronize()
        ref = adaattn_fwd_reference(q, k, v)
        bounds, errs = None, []
        # bf16 mean and std: elementwise within the bound of the kernel's
        # rounding of P; m and l (f32 sums of exact products) and every f32
        # output: within a stated share of their largest value.
        if dt == torch.bfloat16:
            bounds = adaattn_fwd_error_bound(q, k, v)
            for what, o, r, bd in zip(("mean", "std"), out, ref, bounds):
                err = (o.float() - r.float()).abs()
                ratio = float((err / bd).max())
                errs.append(f"{what} err {float(err.max()):.4g} (err/bound "
                            f"max {ratio:.3f}, bound max "
                            f"{float(bd.max()):.4g})")
                check(ratio <= 1.0, f"adaattn_fwd {name} {what} exceeds "
                      "its bound")
                if main:
                    worst = max(worst, float(err.max()))
            tols = (("m", out[2], ref[2], F32_TOL),
                    ("l", out[3], ref[3], L_TOL))
        else:
            tols = tuple(zip(("mean", "std", "m", "l"), out, ref,
                             (F32_TOL, F32_TOL, F32_TOL, L_TOL)))
        for what, o, r, tol_rel in tols:
            err = max_err(o, r)
            tol = tol_rel * float(r.float().abs().max()) + 1e-6
            errs.append(f"{what} err {err:.4g} (tol {tol:.4g})")
            check(err <= tol, f"adaattn_fwd {name} {what} differs")
        check(all(o.dtype == r.dtype and o.shape == r.shape
                  for o, r in zip(out, ref)), f"adaattn_fwd {name}: dtypes")
        del out
        t_k = timed_ms(lambda: adaattn_fwd(q, k, v), iters=5)
        t_p = timed_ms(lambda: adaattn_fwd_reference(q, k, v), iters=3,
                       warmup=1)
        extra = ""
        if main:
            ms, plain_ms = t_k, t_p
            size = q.element_size()
            bound.add(size * b * (3 * nc + 2 * ns) * 128 + 8 * b * nc,
                      6 * b * nc * ns * 128, PEAK_BF16)
            library_ms, what = sdpa_yardstick(q, k, v)
            extra = (f"; library (sdpa {what}, forward)"
                     f" {library_ms:.4f} ms (kernel/sdpa "
                     f"{t_k / library_ms:.3f}); bound "
                     f"{bound.ms():.4f} ms "
                     f"({bound.by()}), {6 * b * nc * ns * 128 / t_k / 1e9:.1f}"
                     f" TFLOP/s of the function's work")
        log(f"adaattn_fwd {name:10s} q={tuple(q.shape)} Ns={ns} {dtype} "
            f"scale {scale}: " + ", ".join(errs) + f"; kernel {t_k:.4f} ms, "
            f"plain {t_p:.4f} ms" + extra)
        del q, k, v, ref, bounds
        torch.cuda.empty_cache()
    one_hot_check(torch.Generator(device=DEVICE).manual_seed(SEED + 7))
    f32 = serve_phase(torch.Generator(device=DEVICE).manual_seed(SEED + 22))
    return worst, ms, plain_ms, bound, library_ms, f32


def serve_phase(gen):
    """``adaattn_fwd``'s f32 serving form at ``SERVE_CASES`` and the
    one-hot rows: its outputs against the twin and the float64 form (the
    gates of ``SERVE_CASES``), each form's and the twin's distance to
    float64 logged, and at every case but the one-hot rows the ms of the
    serving form, the float64 form and the twin (one JSON line).  Returns
    the "taps-f32" call's figures, those of one 512px f32 request (ms,
    twin ms, Bound, worst mean or std error against the twin, SDPA f32
    forward ms, float64 form ms)."""
    import torch
    from arbitrarystyletransfer_tpu_torch.ops.kernels.adaattn_fwd import (
        adaattn_fwd,
        adaattn_fwd_reference,
        serve_splits,
    )

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = [(name, b, nc, ns, (scale, off)) for name, b, nc, ns, scale, off
             in SERVE_CASES]
    cases += [(f"one-hot-{ns}", b, nc, ns, None)
              for b, nc, ns in ONE_HOT_CASES]
    out, times = None, {}
    for name, b, nc, ns, draw in cases:
        if draw is None:
            q, k, v, _ = one_hot_attention(gen, b, nc, ns, torch.float32)
        else:
            scale, off = draw
            dev = dict(device=DEVICE, generator=gen)
            q = scale * torch.randn(b, nc, 128, **dev)
            k = scale * torch.randn(b, ns, 128, **dev)
            v = off + torch.randn(b, ns, 128, **dev)
        got = adaattn_fwd(q, k, v, serve=True)
        torch.cuda.synchronize()
        ref = adaattn_fwd_reference(q, k, v)
        exact = adaattn_fwd(q, k, v)[:2]
        errs, worst = [], 0.0
        for i, what in enumerate(("mean", "std", "m", "l")):
            err = max_err(got[i], ref[i])
            tol = ((L_TOL if what == "l" else F32_TOL)
                   * float(ref[i].abs().max()) + 1e-6)
            check(got[i].dtype == torch.float32
                  and got[i].shape == ref[i].shape,
                  f"adaattn_fwd serving {name} {what}: {got[i].dtype}")
            line, gated = f"{what} err {err:.4g} (tol {tol:.4g})", True
            if i < 2:
                worst = max(worst, err)
                own = max_err(ref[i], exact[i])
                mine = max_err(got[i], exact[i])
                line += (f", vs float64 {mine:.4g} (the twin's {own:.4g}, "
                         f"ratio {mine / own if own else float(mine > 0):.3f})")
                check(mine <= SERVE_TWIN_FACTOR * own,
                      f"adaattn_fwd serving {name} {what}: {mine:.4g} from "
                      f"float64, over {SERVE_TWIN_FACTOR}x the twin's "
                      f"{own:.4g}")
                if own > tol:
                    gated = False
                    line += " (the twin outside the gate: held to float64)"
            errs.append(line)
            if gated:
                check(err <= tol, f"adaattn_fwd serving {name} {what} "
                      "differs from the twin")
        del got, ref, exact
        extra = ""
        if draw is not None:
            t_s = timed_ms(lambda: adaattn_fwd(q, k, v, serve=True), iters=5)
            t_f = timed_ms(lambda: adaattn_fwd(q, k, v), iters=3)
            t_p = timed_ms(lambda: adaattn_fwd_reference(q, k, v), iters=3,
                           warmup=1)
            times[name] = {"serve": t_s, "f64": t_f, "plain": t_p}
            splits = serve_splits(b, nc, ns, sms)[0]
            extra = (f"; serving {t_s:.4f} ms, float64 form {t_f:.4f} ms "
                     f"({t_f / t_s:.2f}x), plain {t_p:.4f} ms; style axis "
                     f"in {splits} chunk(s)")
            if name in SERVE_FASTER:
                check(t_s < t_f, f"adaattn_fwd serving {name}: not faster "
                      "than the float64 form")
            if name == "taps-f32":
                bound = Bound()
                bound.add(4 * b * (3 * nc + 2 * ns) * 128 + 8 * b * nc,
                          6 * b * nc * ns * 128, PEAK_TF32 / 3)
                lib, what = sdpa_yardstick(q, k, v)
                out = (t_s, t_p, bound, worst, lib, t_f)
                extra += (f"; bound {bound.ms():.4f} ms ({bound.by()}, a "
                          f"third of the TF32 peak), {bound.ms() / t_s:.3f} "
                          f"of it; library (sdpa {what}, forward) "
                          f"{lib:.4f} ms (serving/sdpa {t_s / lib:.3f})")
        log(f"adaattn_fwd serving {name:10s} ({b}, {nc}, {ns}) "
            + ("one-hot" if draw is None else
               f"scale {draw[0]} offset {draw[1]}") + ": "
            + ", ".join(errs) + extra)
        del q, k, v
        torch.cuda.empty_cache()
    log(json.dumps({"adaattn_serve_ms": times}))
    return out


def random_block(gen, c_in, e, c_out, k, bn, expand=True):
    """Random weights of one block as the kernels take them (folded BN):
    (w_expand, w_dw, se_params, w_proj), biases (b_expand, b_dw, proj)."""
    import torch
    from arbitrarystyletransfer_tpu_torch.weights import make_divisible

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=DEVICE)

    s = make_divisible(e // 4, 8)  # the SE width of weights.init_params
    se = {"Dense_0": {"kernel": rand(e, s) / math.sqrt(e),
                      "bias": 0.1 * rand(s)},
          "Dense_1": {"kernel": rand(s, e) / math.sqrt(s),
                      "bias": 0.5 + 0.1 * rand(e)}}
    weights = (rand(c_in, e) / math.sqrt(c_in) if expand else None,
               rand(k, k, e) / k, se, rand(e, c_out) / math.sqrt(e))
    biases = ((0.1 * rand(e) if bn and expand else None,
               0.1 * rand(e) if bn else None, 0.1 * rand(c_out) if bn
               else None))
    return weights, biases


def sweep2_design(kernel):
    """The sweep-2 design ("generic", "mma", "tf32") of ``kernel``'s last
    launch ("flat_block", "flat_s2_block" or "mega_block")."""
    from arbitrarystyletransfer_tpu_torch.ops.kernels._build import (
        load_library,
    )

    return SWEEP2_DESIGNS.get(
        getattr(load_library(), f"{kernel}_last_sweep2")())


def check_sweep2(kernel, label, dtype, per_req):
    """The path's rows (the 512px and 1024px/720px blocks, bf16 and f32)
    take sweep 2's designed kernel of their dtype; returns the design."""
    design = sweep2_design(kernel)
    if per_req or size_case(label) or f32_row(label):
        want = "mma" if dtype == "bfloat16" else "tf32"
        check(design == want, f"{kernel} {label}: sweep 2 took {design}, "
              f"not {want}")
    return design


def flat_kernel_phase(gen, name, fn, ref_fn, cases, stride):
    """One flat kernel against its twin at each case; returns the worst y
    error of the path's cases, the device ms per request of "flat-all"
    (kernel, twin) and of "auto" (kernel, twin), their bounds, and the
    same per f32 request (the f32 path rows, ``f32_row``, summed apart):
    {"flat-all": (kernel, twin, bound), "auto": ...}.  flat_block's sweep
    1 must take the design the mirror names (``sweep1_check``)."""
    import torch
    from arbitrarystyletransfer_tpu_torch.scripts.sweep_times import (
        last_staging,
    )

    worst = worst_f32 = 0.0
    per_route = {"flat-all": [0.0, 0.0], "auto": [0.0, 0.0]}
    bounds = {"flat-all": Bound(), "auto": Bound()}
    per_f32 = {"flat-all": [0.0, 0.0], "auto": [0.0, 0.0]}
    bounds_f32 = {"flat-all": Bound(), "auto": Bound()}
    auto_total = 0
    gen_own = torch.Generator(device=DEVICE).manual_seed(SEED + 8)
    big = torch.Generator(device=DEVICE).manual_seed(SEED + SIZE_CASES_SEED)
    gen32 = torch.Generator(device=DEVICE).manual_seed(SEED + F32_SEED)
    for case in cases:
        label, n, hw, c_in, e, c_out, k, bn = case[:8]
        residual = case[8] if stride == 1 else False
        dtype, per_all = case[-2:]
        per_auto = (auto_case_launches(label.removesuffix(F32_TAG),
                                       "flat" if stride == 1 else "flat2")
                    if per_all else 0)
        if not f32_row(label):
            auto_total += per_auto
        dt = getattr(torch, dtype)
        expand = label != "expand1"
        g = (gen32 if f32_row(label) else gen_own if label in FLAT_OWN_GEN
             else big if size_case(label) else gen)
        x = torch.randn(n, hw, hw, c_in, generator=g, device=DEVICE).to(dt)
        (we, wd, se, wp), (be, bd, pb) = random_block(g, c_in, e, c_out, k,
                                                      bn, expand)
        kw = dict(b_expand=be, b_dw=bd, proj_bias=pb)
        if stride == 1:
            kw.update(pre_act=expand, identity=residual)
        args = (x, we, wd, se, wp, k)
        y, sums = fn(*args, **kw)
        torch.cuda.synchronize()
        staging = last_staging(name) if stride == 2 else None
        design = "sweep 1 %s, %s x boxes per halo; sweep 2 %s" % (
            *sweep1_check(name, label, dtype, c_in, k, expand),
            check_sweep2(name, label, dtype, per_all or per_auto))
        if stride == 2 and (per_all or per_auto or size_case(label)
                            or f32_row(label)):
            # the path's shapes stage x as TMA boxes, at bf16 and f32
            check(staging == "async", f"{name} {label}: x staged {staging}")
        repeat_check(name, label, lambda xx: fn(xx, *args[1:], **kw), x,
                     (y, sums))
        r_y, r_sums = ref_fn(*args, **kw)
        err_y, err_s = max_err(y, r_y), max_err(sums, r_sums)
        if f32_row(label) and (per_all or per_auto):
            pre_act = kw.get("pre_act", True)
            exact_y, exact_s = block_f64(x, we, wd, k, pre_act, be, bd, se,
                                         wp, pb, residual, stride)
            tf32_vs_f64(name, label, y, r_y, exact_y)
            tf32_vs_f64(name, label + " sums", sums, r_sums, exact_s)
            del exact_y, exact_s
            if stride == 1:
                sweep2_vs_f64(label, x, we, wd, k, pre_act, be, bd, se, wp,
                              pb, residual)
        rel = BF16_TOL if dt == torch.bfloat16 else F32_TOL
        tol_y = rel * float(r_y.float().abs().max())
        tol_s = SUMS_TOL * float(r_sums.abs().max())
        if (per_all or per_auto) and not f32_row(label):
            worst = max(worst, err_y)
        elif per_all or per_auto:
            worst_f32 = max(worst_f32, err_y)
        check(tuple(y.shape) == tuple(r_y.shape) and y.dtype == dt,
              f"{name} {label}: output {tuple(y.shape)} {y.dtype}")
        del y, sums, r_y, r_sums
        t_k = timed_ms(lambda: fn(*args, **kw))
        t_p = timed_ms(lambda: ref_fn(*args, **kw), iters=3, warmup=1)
        ho = hw // stride
        size = x.element_size()
        nbytes = size * n * (hw * hw * c_in + ho * ho * c_out) + 4 * n * e
        mm = 2 * n * (hw * hw * c_in * e * expand + ho * ho * e * c_out)
        dw = 2 * n * ho * ho * e * k * k
        sums_by, bounds_by = ((per_f32, bounds_f32) if f32_row(label)
                              else (per_route, bounds))
        for route, per_req in (("flat-all", per_all), ("auto", per_auto)):
            sums_by[route][0] += per_req * t_k
            sums_by[route][1] += per_req * t_p
            bounds_by[route].add_block(nbytes, mm, dw, size, per_req)
        log(f"{name} {label:8s} x={tuple(x.shape)} E={e} C_out={c_out} "
            f"k={k} bn={bn} res={residual} {dtype}: y err {err_y:.4g} (tol "
            f"{tol_y:.4g}), sums err {err_s:.4g} (tol {tol_s:.4g}); kernel "
            f"{t_k:.4f} ms, plain {t_p:.4f} ms; {design}"
            + (f", x staged {staging}" if staging else ""))
        check(err_y <= tol_y and err_s <= tol_s, f"{name} {label} differs")
        torch.cuda.empty_cache()
    for route, (t_k, t_p) in per_route.items():
        if t_k:  # the route runs some of these cases
            log(f"{name} per {route} request: kernel {t_k:.4f} ms, plain "
                f"{t_p:.4f} ms, bound {bounds[route].ms():.4f} ms "
                f"({bounds[route].by()})")
    for route, (t_k, t_p) in per_f32.items():
        if t_k:
            log(f"{name} per {route} f32 request: kernel {t_k:.4f} ms, "
                f"plain {t_p:.4f} ms, bound {bounds_f32[route].ms():.4f} ms "
                f"({bounds_f32[route].by()})")
    if any(case[-1] for case in cases):  # the path's cases: every block
        planned = route_launches("auto")[name]
        check(auto_total == planned, f"{name}: the cases hold {auto_total} "
              f"of \"auto\"'s launches, its plan {planned}")
    f32 = {route: (*per_f32[route], bounds_f32[route], worst_f32)
           for route in per_f32}
    return worst, per_route, bounds, f32


def block_cost(n, h, w, c_in, e, c_out, k, size, expand=True):
    """(bytes, 1x1 operations, depthwise operations) of one whole stride-1
    block: x read, y written, the sums; the expand and the projection; the
    depthwise."""
    nbytes = size * n * h * w * (c_in + c_out) + 4 * n * e
    return (nbytes, 2 * n * h * w * e * (c_in * expand + c_out),
            2 * n * h * w * e * k * k)


def mega_phase(gen, cases=MEGA_CASES + MEGA_F32):
    """mega_block against its twin at every case, with flat_block timed on
    the same block (NHWC) beside it, and the sweep-1 design and boxes each
    must take (``sweep1_check``); returns the worst y error of the path's
    cases, (kernel, twin) device ms per "mega" request and the bound
    (bf16), and the same per f32 request (the f32 path rows) as (kernel,
    twin, bound, worst y error)."""
    import torch
    from arbitrarystyletransfer_tpu_torch.ops.kernels.flat_block import (
        flat_block,
    )
    from arbitrarystyletransfer_tpu_torch.ops.kernels.mega_block import (
        mega_block,
        mega_block_reference,
    )
    from arbitrarystyletransfer_tpu_torch.scripts.sweep_times import (
        last_staging,
    )

    worst, ms, plain_ms, bound = 0.0, 0.0, 0.0, Bound()
    ms32, plain32, bound32, worst32 = 0.0, 0.0, Bound(), 0.0
    big = torch.Generator(device=DEVICE).manual_seed(SEED + SIZE_CASES_SEED)
    gen32 = torch.Generator(device=DEVICE).manual_seed(SEED + F32_SEED)
    for (label, n, h, w, c_in, e, c_out, k, bn, residual, dtype,
         per_req) in cases:
        dt = getattr(torch, dtype)
        expand = label != "expand1"
        g = gen32 if f32_row(label) else big if size_case(label) else gen
        xt = torch.randn(n, h, c_in, w, generator=g, device=DEVICE).to(dt)
        (we, wd, se, wp), (be, bd, pb) = random_block(g, c_in, e, c_out, k,
                                                      bn, expand)
        kw = dict(pre_act=expand, b_expand=be, b_dw=bd, proj_bias=pb,
                  identity=residual)
        args = (we, wd, se, wp, k)
        y, sums = mega_block(xt, *args, **kw)
        torch.cuda.synchronize()
        # Sweep 1 stages x as TMA boxes at every shape of the path, bf16
        # and f32, and with plain loads where the map cannot take W (W % 8
        # != 0).
        staging = last_staging("mega_block")
        design = "sweep 1 %s, %s x boxes per halo; sweep 2 %s" % (
            *sweep1_check("mega_block", label, dtype, c_in, k, expand,
                          "xt" if w % 8 == 0 else "xt_rows"),
            check_sweep2("mega_block", label, dtype, per_req))
        want = ("async" if per_req or size_case(label) or f32_row(label)
                else "sync" if w % 8 else None)
        check(want is None or staging == want,
              f"mega_block {label}: x staged {staging}, not {want}")
        repeat_check("mega_block", label,
                     lambda xx: mega_block(xx, *args, **kw), xt, (y, sums))
        r_y, r_sums = mega_block_reference(xt, *args, **kw)
        err_y, err_s = max_err(y, r_y), max_err(sums, r_sums)
        if f32_row(label) and per_req:
            exact_y, exact_s = block_f64(
                xt.permute(0, 1, 3, 2), we, wd, k, expand, be, bd, se, wp,
                pb, residual)
            tf32_vs_f64("mega_block", label, y, r_y,
                        exact_y.permute(0, 1, 3, 2))
            tf32_vs_f64("mega_block", label + " sums", sums, r_sums,
                        exact_s)
            del exact_y, exact_s
        rel = BF16_TOL if dt == torch.bfloat16 else F32_TOL
        tol_y = rel * float(r_y.float().abs().max())
        tol_s = SUMS_TOL * float(r_sums.abs().max())
        check(tuple(y.shape) == (n, h, c_out, w) and y.dtype == dt,
              f"mega_block {label}: output {tuple(y.shape)} {y.dtype}")
        if per_req and not f32_row(label):
            worst = max(worst, err_y)
        elif per_req:
            worst32 = max(worst32, err_y)
        del y, sums, r_y, r_sums
        t_k = timed_ms(lambda: mega_block(xt, *args, **kw))
        t_p = timed_ms(lambda: mega_block_reference(xt, *args, **kw),
                       iters=3, warmup=1)
        # A/B: the same block on NHWC through flat_block (other rounding
        # points, so times only).
        x = xt.permute(0, 1, 3, 2).contiguous()
        t_f = timed_ms(lambda: flat_block(x, *args, **kw))
        del x
        size = xt.element_size()
        cost = block_cost(n, h, w, c_in, e, c_out, k, size, expand)
        if f32_row(label):
            ms32 += per_req * t_k
            plain32 += per_req * t_p
            bound32.add_block(*cost, size, per_req)
        else:
            ms += per_req * t_k
            plain_ms += per_req * t_p
            bound.add_block(*cost, size, per_req)
        one = Bound()
        one.add_block(*cost, size)
        log(f"mega_block {label:8s} x={tuple(xt.shape)} E={e} C_out={c_out} "
            f"k={k} bn={bn} res={residual} {dtype}: y err {err_y:.4g} (tol "
            f"{tol_y:.4g}), sums err {err_s:.4g} (tol {tol_s:.4g}); kernel "
            f"{t_k:.4f} ms, plain {t_p:.4f} ms, bound {one.ms():.4f} ms "
            f"({one.by()}); A/B flat_block on NHWC {t_f:.4f} ms (mega/flat "
            f"{t_k / t_f:.3f}); x staged {staging}; {design}")
        check(err_y <= tol_y and err_s <= tol_s, f"mega_block {label} differs")
        del xt
        torch.cuda.empty_cache()
    if any(case[-1] for case in cases):
        log(f"mega_block per mega request: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound.ms():.4f} ms ({bound.by()})")
    if ms32:
        log(f"mega_block per mega f32 request: kernel {ms32:.4f} ms, plain "
            f"{plain32:.4f} ms, bound {bound32.ms():.4f} ms "
            f"({bound32.by()})")
    return worst, ms, plain_ms, bound, (ms32, plain32, bound32, worst32)


def project_sweep(label, x, we, wd, k, gate, wp, common, identity, bound):
    """``fused_project`` at one bf16 path shape by part, for both designs
    (``fused_project_cut_launch``: 0 "tile", the first design, one CTA per
    tile, and 1 "persistent", the path's): device ms (median of 3 windows), the share
    of ``block_cost``'s bound, registers, shared memory, CTAs per SM,
    whether the persistent design keeps every chunk's expand weights, and
    ms with the projection's products, the depthwise's FMAs or (persistent)
    the x halo's prefetch and the resident weights cut out (results
    discarded).  One JSON line per design."""
    import ctypes

    import torch
    from arbitrarystyletransfer_tpu_torch.ops.kernels import fused_2pass
    from arbitrarystyletransfer_tpu_torch.ops.kernels._build import (
        load_library,
    )
    from arbitrarystyletransfer_tpu_torch.ops.kernels.flat_block import ptr

    lib = load_library()
    xx, ops = fused_2pass._operands("project_sweep", x, we, wd, k,
                                    common["b_expand"], common["b_dw"])
    n, h, w, c_in = xx.shape
    e, c_out = wp.shape
    wpc = wp.to(device=xx.device, dtype=xx.dtype).contiguous()
    y = torch.empty((n, h, w, c_out), dtype=xx.dtype, device=xx.device)
    stream = torch.cuda.current_stream().cuda_stream
    for design, name in enumerate(("tile", "persistent")):
        occ = (ctypes.c_int * 4)()
        check(lib.fused_project_occupancy(design, k, c_in, e, c_out, occ)
              == 0, f"fused_project {name}: occupancy query failed")

        def run(cut=0, design=design):
            rc = lib.fused_project_cut_launch(
                design, cut, xx.data_ptr(), *map(ptr, ops), gate.data_ptr(),
                wpc.data_ptr(), y.data_ptr(), n, h, w, c_in, e, c_out, k,
                int(common["pre_act"]), int(identity), stream)
            check(rc == 0, f"fused_project {name} cut {cut}: CUDA error "
                  f"{rc}")

        ms = statistics.median(timed_ms(run, iters=10) for _ in range(3))
        rec = {"kernel": "fused_project", "design": name, "shape": label,
               "x": [n, h, w, c_in], "e": e, "c_out": c_out, "k": k,
               "ms": ms, "bound_ms": bound.ms(), "bound_by": bound.by(),
               "share": bound.ms() / ms, "registers": occ[0],
               "smem": occ[1], "ctas_per_sm": occ[2]}
        if design:
            rec["resident_weights"] = bool(occ[3])
        cuts = [(1, "ms_no_proj"), (2, "ms_no_dw")]
        if design:
            cuts.append((3, "ms_sync_staging"))
        for cut, key in cuts:
            rec[key] = timed_ms(lambda cut=cut: run(cut), iters=10)
        log(json.dumps(rec))


def two_pass_phase(gen, cases=None):
    """fused_sums and fused_project against their twins at every case
    (``TWO_PASS_CASES``, then their f32 path rows), and the two-pass block
    timed against the fused route's block (expand_dw + the PyTorch
    epilogue), and ``fused_project`` by part at the path's bf16 shapes
    (``project_sweep``); each launched again (``repeat_check``); returns
    {kernel: [worst error, ms, plain ms, Bound]} summed over the 15
    fused-route blocks of a request, and the same per f32 request under
    kernel + F32_TAG."""
    import torch
    from arbitrarystyletransfer_tpu_torch.ops.basic import se_gate
    from arbitrarystyletransfer_tpu_torch.ops.blocks import matmul_f32
    from arbitrarystyletransfer_tpu_torch.ops.kernels._build import (
        load_library,
    )
    from arbitrarystyletransfer_tpu_torch.ops.kernels.expand_dw import (
        expand_dw,
    )
    from arbitrarystyletransfer_tpu_torch.ops.kernels.fused_2pass import (
        fused_project,
        fused_project_reference,
        fused_sums,
        fused_sums_reference,
    )

    from arbitrarystyletransfer_tpu_torch.ops.kernels import limits

    if cases is None:
        cases = TWO_PASS_CASES + f32_rows(TWO_PASS_CASES)
    out = {name + tag: [0.0, 0.0, 0.0, Bound()]
           for name in ("fused_sums", "fused_project") for tag in ("",
                                                                   F32_TAG)}
    ab = [0.0, 0.0]  # per request: two-pass block, fused route's block
    gen_own = torch.Generator(device=DEVICE).manual_seed(SEED + TWO_PASS_SEED)
    gen32 = torch.Generator(device=DEVICE).manual_seed(
        SEED + TWO_PASS_F32_SEED)
    for (label, n, hw, c_in, e, c_out, k, bn, residual, dtype,
         per_req) in cases:
        dt = getattr(torch, dtype)
        expand = label != "expand1"
        tag = F32_TAG if f32_row(label) else ""
        g = (gen32 if tag else gen_own if label in TWO_PASS_OWN_GEN
             else gen)
        x = torch.randn(n, hw, hw, c_in, generator=g, device=DEVICE).to(dt)
        (we, wd, se, wp), (be, bd, pb) = random_block(g, c_in, e, c_out, k,
                                                      bn, expand)
        common = dict(pre_act=expand, b_expand=be, b_dw=bd)
        # With a projection bias the residual is added after the kernel.
        in_kernel = residual and pb is None
        sums = fused_sums(x, we, wd, k, **common)
        torch.cuda.synchronize()
        r_sums = fused_sums_reference(x, we, wd, k, **common)
        gate = se_gate(r_sums, hw * hw, se)
        y = fused_project(x, we, wd, k, gate, wp, identity=in_kernel,
                          **common)
        torch.cuda.synchronize()
        # Every bf16 shape of the path and the ragged ones take the
        # persistent design, the others the one the mirror names.
        design = {1: "persistent", 0: "tile"}.get(
            load_library().fused_project_last_design())
        bf16 = dt == torch.bfloat16
        want = limits.check_fused_project(
            k, c_in, c_out, bf16, limits.tensor_core_expand(bf16, c_in,
                                                            expand),
            expand)["design"]
        check(design == want and (not per_req or tag
                                  or design == "persistent"),
              f"fused_project {label}: the {design} design ran, not {want}")
        repeat_check("fused_sums", label, lambda xx: (
            fused_sums(xx, we, wd, k, **common),), x, (sums,))
        repeat_check("fused_project", label, lambda xx: (fused_project(
            xx, we, wd, k, gate[:len(xx)].contiguous(), wp,
            identity=in_kernel, **common),), x, (y,))
        r_y = fused_project_reference(x, we, wd, k, gate, wp,
                                      identity=in_kernel, **common)
        err_s, err_y = max_err(sums, r_sums), max_err(y, r_y)
        rel = BF16_TOL if dt == torch.bfloat16 else F32_TOL
        tol_y = rel * float(r_y.float().abs().max())
        tol_s = SUMS_TOL * float(r_sums.abs().max())
        check(tuple(y.shape) == (n, hw, hw, c_out) and y.dtype == dt,
              f"fused_project {label}: output {tuple(y.shape)} {y.dtype}")
        if tag and per_req:
            tf32_vs_f64("fused_sums", label, sums, r_sums,
                        block_f64(x, we, wd, k, expand, be, bd)[1])
        if per_req:
            out["fused_sums" + tag][0] = max(out["fused_sums" + tag][0],
                                             err_s)
            out["fused_project" + tag][0] = max(
                out["fused_project" + tag][0], err_y)
        del sums, r_sums, y, r_y

        def two_pass():
            g = se_gate(fused_sums(x, we, wd, k, **common), hw * hw, se)
            yy = fused_project(x, we, wd, k, g, wp, identity=in_kernel,
                               **common)
            if pb is not None:
                yy = (yy.float() + pb).to(dt)
                if residual:
                    yy = yy + x
            return yy

        def fused_route():  # ops/fused_block.fused_block_apply's body
            hidden, s = expand_dw(x, we, wd, k, **common)
            g = se_gate(s, hw * hw, se)
            yy = matmul_f32(hidden * g[:, None, None, :].to(dt), wp.to(dt),
                            pb).to(dt)
            return yy + x if residual else yy

        times = {
            "fused_sums": (timed_ms(lambda: fused_sums(x, we, wd, k,
                                                       **common)),
                           timed_ms(lambda: fused_sums_reference(
                               x, we, wd, k, **common), iters=3, warmup=1)),
            "fused_project": (
                timed_ms(lambda: fused_project(x, we, wd, k, gate, wp,
                                               identity=in_kernel, **common)),
                timed_ms(lambda: fused_project_reference(
                    x, we, wd, k, gate, wp, identity=in_kernel, **common),
                    iters=3, warmup=1)),
        }
        t_2p, t_fr = timed_ms(two_pass), timed_ms(fused_route)
        if not tag:
            ab[0] += per_req * t_2p
            ab[1] += per_req * t_fr
        size, pix = x.element_size(), n * hw * hw
        costs = {
            "fused_sums": (size * pix * c_in + 4 * n * e,
                           2 * pix * e * c_in * expand, 2 * pix * e * k * k),
            "fused_project": block_cost(n, hw, hw, c_in, e, c_out, k, size,
                                        expand),
        }
        report = []
        for name, (t_k, t_p) in times.items():
            out[name + tag][1] += per_req * t_k
            out[name + tag][2] += per_req * t_p
            out[name + tag][3].add_block(*costs[name], size, per_req)
            one = Bound()
            one.add_block(*costs[name], size)
            report.append(f"{name} {t_k:.4f} ms (plain {t_p:.4f}, bound "
                          f"{one.ms():.4f} {one.by()})")
        log(f"fused_2pass {label:8s} x={tuple(x.shape)} E={e} C_out={c_out} "
            f"k={k} bn={bn} res={residual} {dtype}: sums err {err_s:.4g} "
            f"(tol {tol_s:.4g}), y err {err_y:.4g} (tol {tol_y:.4g}), "
            f"{design} design; " + ", ".join(report)
            + f"; A/B block: two-pass {t_2p:.4f} ms, expand_dw + epilogue "
            f"{t_fr:.4f} ms")
        check(err_s <= tol_s and err_y <= tol_y, f"fused_2pass {label} "
              "differs")
        if per_req and not tag:
            one = Bound()
            one.add_block(*costs["fused_project"], size)
            project_sweep(label, x, we, wd, k, gate, wp, common, in_kernel,
                          one)
        del x
        torch.cuda.empty_cache()
    if any(case[-1] for case in cases):
        for name, (_, t_k, t_p, b) in out.items():
            if t_k:
                log(f"{name} over the 15 fused-route blocks: kernel "
                    f"{t_k:.4f} ms, plain {t_p:.4f} ms, bound {b.ms():.4f} "
                    f"ms ({b.by()})")
        log(f"A/B per request (15 fused-route blocks): two-pass block "
            f"{ab[0]:.4f} ms, expand_dw + epilogue {ab[1]:.4f} ms")
    return out


def _rate_tol(dtype, op, steps):
    """Relative tolerance of a probe_rate tile against its twin: bf16 one
    ulp; f32 fma, whose fmaf rounds once where the twin rounds the product
    and the sum, two f32 ulps per dependent step (measured: about half of
    that); the other f32 ops round as the twin does (exact)."""
    if dtype == "bf16":
        return BF16_TOL
    return steps * 2.0 ** -22 if op == "fma" else 0.0


def dw_sweep(name, key, x, wd, shape, nbytes):
    """One JSON line for a depthwise probe at one shape: its occupancy
    (registers, spill bytes a thread, shared memory a CTA, CTAs per SM,
    tiles, grid, waves of the card), its ms by ``probe_mega2.timed`` (best
    of 3 windows of 20 calls, inputs cycled past L2) as launched, with its
    FMAs cut out (``ms_no_fma``: the staging and the stores alone) and with
    every tile staged by plain loads (``ms_sync_staging``), its bound and
    share of it, the rate of the cut without FMAs and the taps a second."""
    import torch
    from arbitrarystyletransfer_tpu_torch.ops.kernels import probes as P
    from arbitrarystyletransfer_tpu_torch.scripts import probe_mega2

    th, c, w, k = shape
    occ = P.probe_dw_occupancy(name, th, c, w, k)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    xs = probe_mega2.l2_copies(x)
    ms = {cut: probe_mega2.timed(lambda v: P.probe_dw_cut(name, v, wd, cut),
                                 xs) for cut in P.DW_CUTS}
    bound = nbytes / HBM_BYTES_S * 1e3
    log(json.dumps({
        "dw_sweep": name, "shape": key, "ms": ms["none"],
        "ms_no_fma": ms["fma"], "ms_sync_staging": ms["async"],
        "bound_ms": bound, "share": bound / ms["none"],
        "no_fma_TBps": nbytes / ms["fma"] / 1e9,
        "taps_per_s": k * k * th * c * w / ms["none"] * 1e3, **occ,
        "waves": occ["tiles"] / (occ["ctas_per_sm"] * sms)}))


def mm_yardstick(x, wt):
    """Device ms (the probe driver's slope between 12 and 3 chained calls)
    of the faster of two PyTorch calls that compute the product probes'
    function, y (R, E, W) = einsum('rcw,ce->rew', x, w) in bf16 with f32
    accumulation: ``torch.einsum`` and ``torch.matmul(w.t(), x)`` ((E, C) @
    (R, C, W), one batched cuBLAS product).  A yardstick only; the port
    never calls it.  Returns (ms, its call, {call: ms})."""
    import torch
    from arbitrarystyletransfer_tpu_torch.scripts import probe_vpu_rate

    calls = {"torch.einsum": lambda: torch.einsum("rcw,ce->rew", x, wt),
             "torch.matmul(w.t(), x)": lambda: torch.matmul(wt.t(), x)}
    times = {k: probe_vpu_rate.per_call_ms(fn) for k, fn in calls.items()}
    best = min(times, key=times.get)
    return times[best], best, times


def mm_sweep(name, key, x, wt, shape, nbytes):
    """One JSON line for a product schedule at one probe_mega2 shape: its
    occupancy (registers, spill bytes a thread, shared memory a CTA, CTAs
    per SM, items, grid, ring slots, waves of the card) and its ms by two
    clocks, stated apart.  In L2, by the driver's method (the slope between
    12 and 3 chained calls, the inputs resident in L2: the figure that
    compares with the parent's row): as launched (``ms``), with the product
    cut out (``ms_no_mma``: the staging and the stores alone) and with x and
    the weight staged by plain loads (``ms_sync_staging``).  Past L2
    (``probe_mega2.timed``: best of 3 windows of at least as many calls as
    ``l2_copies(x)`` has copies, each call writing a y of its own, so that
    each window reads more than twice L2 and writes more than L2): as
    launched (``ms_past_l2``) and without the product
    (``ms_no_mma_past_l2``).  Then the HBM bound, its share of the past-L2
    time and the TB/s of the past-L2 cut without the product."""
    import torch
    from arbitrarystyletransfer_tpu_torch.ops.kernels import probes as P
    from arbitrarystyletransfer_tpu_torch.scripts import (
        probe_mega2,
        probe_vpu_rate,
    )

    r, c, e, w = shape
    occ = P.probe_mm_occupancy(name, r, c, e, w)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    in_l2 = {cut: probe_vpu_rate.per_call_ms(
        lambda: P.probe_mm_cut(name, x, wt, cut)) for cut in P.MM_CUTS}
    # Past L2 each call reads its own copy of x and writes its own y, so
    # that neither the reads nor the writes stay in L2.
    xs = probe_mega2.l2_copies(x)
    pairs = [(v, torch.empty(r, e, w, dtype=x.dtype, device=x.device))
             for v in xs]
    iters = max(20, len(xs))
    past = {cut: probe_mega2.timed(
        lambda p: P.probe_mm_cut(name, p[0], wt, cut, out=p[1]), pairs,
        iters) for cut in ("none", "mma")}
    del pairs
    bound = nbytes / HBM_BYTES_S * 1e3
    log(json.dumps({
        "mm_sweep": name, "shape": key, "ms": in_l2["none"],
        "ms_no_mma": in_l2["mma"], "ms_sync_staging": in_l2["async"],
        "ms_past_l2": past["none"], "ms_no_mma_past_l2": past["mma"],
        "l2_copies": len(xs), "iters": iters, "bound_ms": bound,
        "share_past_l2": bound / past["none"],
        "no_mma_TBps": nbytes / past["mma"] / 1e9, **occ,
        "waves": occ["items"] / (occ["ctas_per_sm"] * sms)}))


def mm_ragged(gen):
    """Both product schedules against their twin at ``MM_RAGGED``'s shapes
    (``BF16_TOL`` of the largest value), as launched (staged "async") and
    under the "async" cut (staged "sync"); then ``MM_CHAIN``: calls of both
    schedules launched back to back, each reading the last one's y through a
    permutation weight, held bit for bit to the permuted input (a call that
    read its input, or wrote a y buffer the allocator handed on, before the
    last call ended would differ)."""
    import torch
    from arbitrarystyletransfer_tpu_torch.ops.kernels import probes as P

    for r, c, e, w in MM_RAGGED:
        x = torch.randn(r, c, w, generator=gen, device=DEVICE).bfloat16()
        wt = (torch.randn(c, e, generator=gen, device=DEVICE)
              / math.sqrt(c)).bfloat16()
        ref = P.probe_mm_reference(x, wt)
        tol = BF16_TOL * float(ref.float().abs().max())
        for name in P.MM_SCHEDULES:
            for cut, want in (("none", "async"), ("async", "sync")):
                y = P.probe_mm_cut(name, x, wt, cut)
                torch.cuda.synchronize()
                staging = P.probe_mm_last_staging(name)
                err = max_err(y, ref)
                log(f"{name} ragged (R, C, E, W) {(r, c, e, w)} cut {cut}: "
                    f"err {err:.4g} (tol {tol:.4g}), staging {staging}")
                check(tuple(y.shape) == tuple(ref.shape) and err <= tol,
                      f"{name} ragged {(r, c, e, w)} cut {cut} differs")
                check(staging == want, f"{name} ragged {(r, c, e, w)} cut "
                      f"{cut} staged {staging}, expected {want}")
    for (r, c, w), calls in MM_CHAIN:
        x = torch.randn(r, c, w, generator=gen, device=DEVICE).bfloat16()
        perms = [torch.randperm(c, generator=gen, device=DEVICE)
                 for _ in range(calls)]
        weights = []
        for perm in perms:
            wt = torch.zeros(c, c, dtype=torch.bfloat16, device=DEVICE)
            wt[perm, torch.arange(c, device=DEVICE)] = 1.0
            weights.append(wt)
        torch.cuda.synchronize()
        y = x
        for i, wt in enumerate(weights):
            y = getattr(P, P.MM_SCHEDULES[i % 2])(y, wt)
        torch.cuda.synchronize()
        want = x
        for perm in perms:
            want = want[:, perm]
        exact = torch.equal(y, want)
        occ = {name: P.probe_mm_occupancy(name, r, c, c, w)
               for name in P.MM_SCHEDULES}
        log(f"probe_mm chained {calls} calls (R, C = E, W) {(r, c, w)}: "
            f"bit-exact {exact}; (items, grid, slots) "
            + ", ".join(f"{k} {(o['items'], o['grid'], o['slots'])}"
                        for k, o in occ.items()))
        check(exact, "probe_mm chained calls differ from the permuted input")
    mm_limits()


def mm_first_smem(c, e):
    """Shared memory a CTA of the products' first design took: the weight
    at a row stride of E + 8 (E + 16 where that has an even count of 16-byte
    chunks), two x tiles and one y tile at rows of 72 bf16."""
    cp = (c + 15) // 16 * 16
    ld = e + 8 if (e // 8 + 1) % 2 else e + 16
    return (cp * ld + 2 * cp * 72 + e * 72) * 2


def mm_limits():
    """Both product schedules must take every (C, E) of ``MM_LIMIT_C`` x
    ``MM_LIMIT_E`` whose first design fit in a CTA's shared memory: each
    shape's occupancy query (the launch's own geometry) succeeds within
    ``SMEM_OPT_IN``."""
    from arbitrarystyletransfer_tpu_torch.ops.kernels import probes as P

    shapes = [(c, e) for c in MM_LIMIT_C for e in MM_LIMIT_E
              if mm_first_smem(c, e) <= SMEM_OPT_IN]
    failed, most = [], 0
    for name in P.MM_SCHEDULES:
        for c, e in shapes:
            try:
                occ = P.probe_mm_occupancy(name, 1, c, e, 64)
            except RuntimeError:
                failed.append((name, c, e))
                continue
            most = max(most, occ["smem"])
            if occ["smem"] > SMEM_OPT_IN or occ["ctas_per_sm"] < 1:
                failed.append((name, c, e))
    log(f"probe_mm limits: {len(shapes)} (C, E) shapes a schedule, the most "
        f"shared memory {most} B; failed {failed[:8]}")
    check(not failed, f"probe_mm takes not every (C, E) its first design "
          f"took: {failed[:8]}")


def probes_phase(gen):
    """Every probe entry point against its twin at the JAX probe scripts'
    default shapes, with its bound, its plain time and its library call;
    then the two probe drivers as a user runs them, each with the launch
    counters reset just before and read just after.  Returns ({kernel:
    (worst error, ms, plain ms, Bound, library ms)}, {driver: {kernel:
    launches}}).  ms is the drivers' (copy and depthwise: best of 3 windows
    of 20 calls, the depthwise inputs cycled past L2; products and rates:
    the slope between 12 and 3 chained calls), summed over the scripts' two
    shapes for copy, products and depthwise, the fma f32 par 8 case for the
    rate row; so are the copy's library times (``x * 1.0``, timed by the
    driver).  The phase times the products' and depthwise's library calls
    by the drivers' methods, on its own inputs.  Each depthwise kernel is
    also timed by part at probe_mega2's shapes (``dw_sweep``) and held to its
    twin at ``DW_RAGGED``'s shapes, with the staging each shape must take.
    Each product schedule is timed by part at probe_mega2's shapes
    (``mm_sweep``), must stage both asynchronously, and is held to its twin
    at ``MM_RAGGED``'s shapes and in a chain of calls (``mm_ragged``, its
    own generator); the products' library time is the faster of
    ``torch.einsum`` and ``torch.matmul(w.t(), x)`` per shape
    (``mm_yardstick``)."""
    import torch
    import torch.nn.functional as F
    from arbitrarystyletransfer_tpu_torch.ops.kernels import (
        LAUNCHES,
        reset_launches,
    )
    from arbitrarystyletransfer_tpu_torch.ops.kernels import probes as P
    from arbitrarystyletransfer_tpu_torch.scripts import (
        probe_mega2,
        probe_vpu_rate,
    )

    timed = probe_mega2.timed
    # {kernel: [worst error, plain ms, Bound, library ms]}, over both shapes
    out = {name: [0.0, 0.0, Bound(), 0.0] for name in (
        "probe_copy", "probe_mm_einsum", "probe_mm_rowloop", "probe_dw_t",
        "probe_dw_nhwc")}

    def add(name, err, plain_ms, lib_ms):
        row = out[name]
        row[0] = max(row[0], err)
        row[1] += plain_ms
        row[3] += lib_ms

    for _, key, fn, shape in probe_mega2.PROBES:
        if fn is probe_mega2.p1_dma_copy:
            b, h, c, w, th, dt = shape
            x = torch.randn(b, h, c, w, generator=gen, device=DEVICE).to(dt)
            y = P.probe_copy(x, th)
            torch.cuda.synchronize()
            exact = torch.equal(y, x)
            del y
            t_p = timed_ms(lambda: P.probe_copy_reference(x), iters=3,
                           warmup=1)
            nbytes = x.numel() * x.element_size()
            out["probe_copy"][2].add(2 * nbytes, 0, PEAK_BF16)
            add("probe_copy", 0.0 if exact else float("inf"), t_p, 0.0)
            log(f"probe_copy {key}: bit-exact {exact}; plain {t_p:.4f} ms, "
                f"bound {2 * nbytes / HBM_BYTES_S * 1e3:.4f} ms")
            check(exact, f"probe_copy {key}: the copy differs from x")
            del x
        elif fn is probe_mega2.p2_matmul:
            r, c, e, w, dt = shape
            x = torch.randn(r, c, w, generator=gen, device=DEVICE).to(dt)
            wt = (torch.randn(c, e, generator=gen, device=DEVICE)
                  / math.sqrt(c)).to(dt)
            ref = P.probe_mm_reference(x, wt)
            tol = BF16_TOL * float(ref.float().abs().max())
            t_l, what, lib_times = mm_yardstick(x, wt)
            t_p = timed_ms(lambda: P.probe_mm_reference(x, wt), iters=3,
                           warmup=1)
            for name in P.MM_SCHEDULES:
                y = getattr(P, name)(x, wt)
                torch.cuda.synchronize()
                staging = P.probe_mm_last_staging(name)
                err = max_err(y, ref)
                nbytes = 2 * (x.numel() + wt.numel() + y.numel())
                out[name][2].add(nbytes, 2 * r * c * e * w, PEAK_BF16)
                add(name, err, t_p, t_l)
                log(f"{name} {key}: err {err:.4g} (tol {tol:.4g}), staging "
                    f"{staging}; plain {t_p:.4f} ms, library ({what}, bf16) "
                    f"{t_l * 1e3:.3f} us of "
                    + ", ".join(f"{k} {v * 1e3:.3f} us"
                                for k, v in lib_times.items()))
                check(tuple(y.shape) == (r, e, w) and y.dtype == dt
                      and err <= tol, f"{name} {key} differs")
                check(staging == "async", f"{name} {key} staged {staging}")
                del y
                mm_sweep(name, key, x, wt, (r, c, e, w), nbytes)
        else:
            th, c, w, k = shape
            pad = (k - 1) // 2
            x_t, x_n, wd = probe_mega2.dw_inputs(th, c, w, k, DEVICE, gen)
            weight = wd.permute(2, 0, 1)[:, None].contiguous()  # (C,1,k,k)
            lib_t = F.pad(x_t.permute(1, 0, 2)[None], (pad, pad, 0, 0),
                          mode="circular").contiguous()
            lib_n = x_n.permute(2, 0, 1)[None].contiguous()
            for name, kern, twin, x, lib_x, layout in (
                    ("probe_dw_t", P.probe_dw_t, P.probe_dw_t_reference, x_t,
                     lib_t, (1, 0, 2)),
                    ("probe_dw_nhwc", P.probe_dw_nhwc,
                     P.probe_dw_nhwc_reference, x_n, lib_n, (1, 2, 0))):
                y = kern(x, wd)
                torch.cuda.synchronize()
                staging = P.probe_dw_last_staging(name)
                ref = twin(x, wd)
                err = max_err(y, ref)
                tol = F32_TOL * float(ref.abs().max())
                lib_err = max_err(F.conv2d(lib_x, weight, groups=c)[0]
                                  .permute(*layout), ref)
                t_p = timed_ms(lambda: twin(x, wd), iters=3, warmup=1)
                t_l = timed(lambda v: F.conv2d(v, weight, groups=c),
                            probe_mega2.l2_copies(lib_x))
                nbytes = 4 * (x.numel() + y.numel() + wd.numel())
                out[name][2].add(nbytes, 2 * k * k * y.numel(), PEAK_F32)
                add(name, err, t_p, t_l)
                log(f"{name} {key}: err {err:.4g} (tol {tol:.4g}), staging "
                    f"{staging}; plain "
                    f"{t_p:.4f} ms, library (conv2d groups=C, NCHW, inputs "
                    f"cycled past L2) {t_l * 1e3:.2f} us (its err "
                    f"{lib_err:.3g}), bound "
                    f"{nbytes / HBM_BYTES_S * 1e3 * 1e3:.2f} us")
                check(tuple(y.shape) == tuple(ref.shape) and err <= tol,
                      f"{name} {key} differs")
                check(staging == "async", f"{name} {key} staged {staging}")
                del y
                dw_sweep(name, key, x, wd, shape, nbytes)
            del x_t, x_n, lib_t, lib_n
        torch.cuda.empty_cache()

    # probe_rate: every case of the JAX script at its default tile.
    c, lanes, reps = RATE_SHAPE
    for op, dt_name, dt, par in probe_vpu_rate.CASES:
        x = probe_vpu_rate.rate_input(c, lanes, dt, DEVICE, gen)
        y = P.probe_rate(x, op, par, reps)
        torch.cuda.synchronize()
        ref = P.probe_rate_reference(x, op, par, reps)
        tol = _rate_tol(dt_name, op, reps // par)
        ok = bool(((y - ref).abs() <= tol * ref.abs()).all())
        rel = float(((y - ref).abs() / ref.abs().clamp_min(1e-30)).max())
        log(f"probe_rate {op} {dt_name} par={par}: [0, 0] {float(y[0, 0]):.9g}"
            f" vs twin {float(ref[0, 0]):.9g}; tile max rel err {rel:.3g} "
            f"(tol {tol:.3g})")
        check(ok, f"probe_rate {op} {dt_name} par={par} differs")
        if (op, dt_name, par) == RATE_ROW:
            rate_plain = timed_ms(
                lambda: P.probe_rate_reference(x, op, par, reps), iters=3,
                warmup=1)
            rate_ops = c * lanes * (reps // par * par)
            rate_bound = Bound()
            rate_bound.add(8 * c * lanes, 2 * rate_ops, PEAK_F32)
            rate_err = max_err(y, ref)

    for name, shapes in DW_RAGGED.items():
        kern, twin = getattr(P, name), getattr(P, f"{name}_reference")
        for th, c, w, k in shapes:
            x_t, x_n, wd = probe_mega2.dw_inputs(th, c, w, k, DEVICE, gen)
            x = x_t if name == "probe_dw_t" else x_n
            y = kern(x, wd)
            torch.cuda.synchronize()
            staging = P.probe_dw_last_staging(name)
            want = "sync" if name == "probe_dw_t" and w % 4 else "async"
            ref = twin(x, wd)
            err, tol = max_err(y, ref), F32_TOL * float(ref.abs().max())
            log(f"{name} ragged (th, C, W, k) {(th, c, w, k)}: err {err:.4g} "
                f"(tol {tol:.4g}), staging {staging}")
            check(tuple(y.shape) == tuple(ref.shape) and err <= tol,
                  f"{name} ragged {(th, c, w, k)} differs")
            check(staging == want, f"{name} ragged {(th, c, w, k)} staged "
                  f"{staging}, expected {want}")

    mm_ragged(torch.Generator(device=DEVICE).manual_seed(SEED + 12))

    # The drivers, as a user runs them (their own seeded inputs).
    launches, results = {}, {}
    for (driver, expected), module in zip(PROBE_DRIVERS,
                                          (probe_mega2, probe_vpu_rate)):
        reset_launches()
        results[driver] = module.run(module.parse_args(["--device", DEVICE]))
        launches[driver] = dict(LAUNCHES)
        log(json.dumps(results[driver]))
        log(f"{driver} launches: {launches[driver]}")
        check(launches[driver] == expected, f"{driver} launched "
              f"{launches[driver]}, expected {expected}")

    res = results["probe_mega2"]
    keys = {fn: [key for _, key, f, _ in probe_mega2.PROBES if f is fn]
            for fn in (probe_mega2.p1_dma_copy, probe_mega2.p2_matmul,
                       probe_mega2.p3_dw)}
    ms = {
        "probe_copy": sum(res[k]["kernel_ms"]
                          for k in keys[probe_mega2.p1_dma_copy]),
        "probe_mm_einsum": sum(res[k]["einsum"]["ms"]
                               for k in keys[probe_mega2.p2_matmul]),
        "probe_mm_rowloop": sum(res[k]["rowloop"]["ms"]
                                for k in keys[probe_mega2.p2_matmul]),
        "probe_dw_t": sum(res[k]["transposed_ms"]
                          for k in keys[probe_mega2.p3_dw]),
        "probe_dw_nhwc": sum(res[k]["nhwc_ms"]
                             for k in keys[probe_mega2.p3_dw]),
    }
    out["probe_copy"][3] = sum(res[k]["torch_ms"]
                               for k in keys[probe_mega2.p1_dma_copy])
    rows = {name: (err, ms[name], plain, bound, lib)
            for name, (err, plain, bound, lib) in out.items()}
    op, dt_name, par = RATE_ROW
    gops = results["probe_vpu_rate"][f"{op}_{dt_name}_p{par}_Gops"]
    rows["probe_rate"] = (rate_err, rate_ops / gops / 1e6, rate_plain,
                          rate_bound, None)
    for name, (err, t_k, t_p, bound, t_l) in rows.items():
        log(f"{name}: kernel {t_k:.5f} ms (driver), plain {t_p:.4f} ms, "
            f"library {t_l} ms, bound {bound.ms():.5f} ms ({bound.by()}), "
            f"max err {err:.4g}")
    return rows, launches


def random_state(cfg, seed):
    """init_params' tree, redrawn as in the parity tests: fan-in normal
    kernels (x5 on non-residual projections, x0.35 on AdaAttN q and k), SE
    excitation biases near 0.5, BN scale near 1, running var in
    [0.5, 1.5]."""
    import torch
    from arbitrarystyletransfer_tpu_torch.weights import init_params

    gen = torch.Generator().manual_seed(seed)
    state = init_params(cfg, gen)

    def redraw(node, path):
        for key, val in node.items():
            if isinstance(val, dict):
                redraw(val, path + (key,))
                continue
            shape, parent = val.shape, path[-1]
            if key == "kernel":
                gain = 0.35 if parent in ("W_q", "W_k") else 1.0
                std = gain / math.sqrt(math.prod(shape[:-1]))
                node[key] = torch.randn(shape, generator=gen) * std
            elif key == "bias":
                base = 0.5 if parent == "Dense_1" else 0.0
                node[key] = base + 0.1 * torch.randn(shape, generator=gen)
            elif key == "scale":
                node[key] = 1.0 + 0.1 * torch.randn(shape, generator=gen)
            elif key == "mean":
                node[key] = 0.1 * torch.randn(shape, generator=gen)
            elif key == "var":
                node[key] = 0.5 + torch.rand(shape, generator=gen)
        if "DepthwiseConv2D_0" in node:
            proj = "Conv_1" if "Conv_1" in node else "Conv_0"
            w = node[proj]["kernel"]
            c_in = node["Conv_0"]["kernel"].shape[2]
            if c_in != w.shape[3]:
                node[proj]["kernel"] = w * 5.0

    redraw(state, ())
    return state


@contextlib.contextmanager
def table_less():
    """The planner without a table (``AST_TUNED_POLICY`` at a missing
    file), inside the block."""
    import os

    from arbitrarystyletransfer_tpu_torch.ops import policy

    saved = os.environ.get("AST_TUNED_POLICY")
    os.environ["AST_TUNED_POLICY"] = "/nonexistent/tuned_policy.json"
    policy.clear_cache()
    try:
        yield
    finally:
        if saved is None:
            del os.environ["AST_TUNED_POLICY"]
        else:
            os.environ["AST_TUNED_POLICY"] = saved
        policy.clear_cache()


def policy_phase():
    """The shipped dispatch table on this card: measured on it, in use,
    covering every block at POLICY_SIZES; "auto"'s plan at each size beside
    the table-less plan; then the port's tuner as a user runs it (a
    subprocess at the last size, POLICY_TUNE_ITERS calls a window, into a
    temporary file), its rows checked and its verdicts counted against the
    table's (information only: close verdicts are noise)."""
    import os
    import tempfile

    import torch
    from arbitrarystyletransfer_tpu_torch import ModelConfig
    from arbitrarystyletransfer_tpu_torch.ops import flatblock, policy
    from arbitrarystyletransfer_tpu_torch.ops.flatblock_s2 import s2_eligible
    from arbitrarystyletransfer_tpu_torch.scripts.autotune_blocks import (
        enumerate_blocks,
    )

    card = torch.cuda.get_device_name(0)
    path = os.environ.get("AST_TUNED_POLICY")
    check(path in (None, str(policy.DEFAULT_PATH)),
          f"AST_TUNED_POLICY={path}: not the shipped table")
    shipped = policy.read_table(policy.DEFAULT_PATH)
    meta = shipped.get("meta", {})
    check(meta.get("device") == card, f"the shipped table was measured on "
          f"{meta.get('device')!r}, this card is {card!r}")
    check(policy.load_policy(DEVICE) == shipped["cases"],
          "the planner does not read the shipped table")
    log(f"policy: the shipped table, {len(shipped['cases'])} rows, meta "
        f"{json.dumps(meta)}")
    cfg = ModelConfig()

    def blocks_of(launches):
        return {k: n for k, n in launches.items() if n}

    for size in POLICY_SIZES:
        missing = [policy.block_key(*c) for c in enumerate_blocks(cfg, size)
                   if "best" not in shipped["cases"].get(
                       policy.block_key(*c), {})]
        check(not missing, f"the shipped table lacks {missing}")
        plan, launches = auto_plan(size)
        with table_less():
            bare = flatblock.planned_chains(cfg, size, "auto", "auto",
                                            device=DEVICE)
            bare_launches = flatblock.planned_launches(cfg, size, "auto",
                                                       "auto", device=DEVICE)
        log(f"policy {size}px: \"auto\" {plan}, launches "
            f"{blocks_of(launches)}; without the table {bare}, launches "
            f"{blocks_of(bare_launches)}")

    size = POLICY_SIZES[-1]
    with tempfile.TemporaryDirectory() as tmp:
        out = f"{tmp}/tuned_policy.json"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m",
             "arbitrarystyletransfer_tpu_torch.scripts.autotune_blocks",
             "--size", str(size), "--iters", str(POLICY_TUNE_ITERS),
             "--out", out], capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
        check(proc.returncode == 0, f"the tuner exited {proc.returncode}: "
              f"{proc.stderr[-3000:]}")
        tuned = policy.read_table(out)
    check(tuned.get("meta", {}).get("device") == card,
          f"the tuner's meta: {tuned.get('meta')}")
    same, rows = 0, 0
    for c in enumerate_blocks(cfg, size):
        c_in, _, stride, _, _, h, w = c
        key = policy.block_key(*c)
        row = tuned["cases"].get(key, {})
        need = (["xla"] + (["flat2"] if s2_eligible(h, w) else [])
                if stride == 2 else
                ["xla", "fused"] + (["flat"] if flatblock.stride_ok(w)
                                    else []))
        if c_in == 2 * cfg.enc_out_channels:
            # ada_out (no chain reads its row): expand_dw takes C_in 256
            # (its x box in channel chunks).
            log(f"policy: the tuner's {key}: fused_ms "
                f"{row.get('fused_ms')}")
        check(all(math.isfinite(row.get(f"{n}_ms", math.nan)) for n in need)
              and row.get("best") in need, f"the tuner's row {key}: {row}")
        rows += 1
        same += row["best"] == shipped["cases"][key]["best"]
    log(f"policy: the tuner at {size}px, {POLICY_TUNE_ITERS} calls a "
        f"window, {seconds:.1f} s: {rows} rows, each with its routes' "
        f"times and a verdict; {same} of {rows} verdicts equal the shipped "
        "table's")


def routes_phase(gen):
    """Drives every route; returns {route: {kernel: launches}}."""
    import torch
    from arbitrarystyletransfer_tpu_torch import ModelConfig
    from arbitrarystyletransfer_tpu_torch import engine
    from arbitrarystyletransfer_tpu_torch.infer import StylePipeline

    cfg = ModelConfig(encoder_eval_stats=True, use_pallas_adaattn=True,
                      compute_dtype="bfloat16")
    state = random_state(cfg, SEED)
    shape = (BATCH, SIZE, SIZE, 3)
    requests = [(torch.rand(shape, generator=gen, device=DEVICE),
                 torch.rand(shape, generator=gen, device=DEVICE), a)
                for a in ALPHAS]

    # Normalize the head on request 1 so the clamped image is not
    # saturated: per-channel pre-clamp mean 0.5, spatial std 0.05 (the
    # other requests' images spread up to 4x further than request 1's).
    # Every route shares the head.
    pipe = StylePipeline(cfg, engine="fused", device=DEVICE, state=state)
    with torch.inference_mode():
        pre = engine.stylize_fused(
            pipe.state, *requests[0][:2], requests[0][2], cfg=cfg,
            dtype=pipe.dtype, exporting=False).double()
    head = pipe.state["params"]["dec"]["img_out"]
    std = pre.std(dim=(1, 2)).mean(dim=0)
    check(bool((std > 1e-3).all()), f"flat pre-clamp image: {std.tolist()}")
    scale = 0.05 / std
    head["kernel"] = (head["kernel"] * scale.float()).contiguous()
    head["bias"] = (0.5 - scale * (pre.mean(dim=(0, 1, 2)) - head["bias"])
                    ).float()
    del pre

    launches, ms, ms32 = {}, {}, {}
    for impl, n_requests, _ in ROUTES:
        route = StylePipeline(cfg, engine="fused", device=DEVICE,
                              state=pipe.state, encoder_impl=impl,
                              decoder_impl=impl)
        launches[impl], ms[impl], launches[f"{impl}-f32"], ms32[impl] = \
            drive_route(route, impl, requests[:n_requests],
                        route_launches(impl))
        torch.cuda.empty_cache()
    from arbitrarystyletransfer_tpu_torch.ops import flatblock
    from arbitrarystyletransfer_tpu_torch.ops.kernels import LAUNCHES

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    for impl in F32_ONLY_ROUTES:
        pipe32 = StylePipeline(cfg32, engine="fused", device=DEVICE,
                               state=pipe.state, encoder_impl=impl,
                               decoder_impl=impl)
        expected = counts(adaattn_fwd=1, **flatblock.planned_launches(
            cfg, SIZE, impl, impl, device=DEVICE))
        out32, times32, launches[f"{impl}-f32"] = f32_requests(
            pipe32, requests, expected, impl)
        plain32, _ = run_plain(pipe32, *requests[0], repeats=1)
        check(dict(LAUNCHES) == launches[f"{impl}-f32"],
              "the plain run launched a kernel")
        f32_image_gate(impl, out32, plain32)
        ms32[impl] = statistics.median(times32[1:])
        del out32, plain32
        torch.cuda.empty_cache()
    log(f"auto's plan at {SIZE}px (the shipped table): {auto_plan()[0]}")
    log(f"routes at {SIZE}px batch {BATCH}, median ms per request (img/s), "
        "this run: " + ", ".join(f"{impl} {t:.3f} ({BATCH * 1000 / t:.2f})"
                                 for impl, t in ms.items()))
    log(f"routes at {SIZE}px batch {BATCH} f32, median ms per request of "
        f"requests 2-{ROUTE_F32_REQUESTS} (img/s), this run: "
        + ", ".join(f"{impl} {t:.3f} ({BATCH * 1000 / t:.2f})"
                    for impl, t in ms32.items()))
    return launches


def served_again(label, pipe, request, first):
    """``request`` served again by ``pipe`` gives ``first``'s bytes.  The
    launch counters and ``adaattn_fwd``'s f32 forms are put back as they
    were: a check's launches count on no path."""
    import torch
    from arbitrarystyletransfer_tpu_torch.ops.kernels import LAUNCHES
    from arbitrarystyletransfer_tpu_torch.ops.kernels.adaattn_fwd import (
        F32_FORMS,
    )

    counted, forms = dict(LAUNCHES), dict(F32_FORMS)
    again = pipe.stylize(*request)
    torch.cuda.synchronize()
    LAUNCHES.clear()
    LAUNCHES.update(counted)
    F32_FORMS.clear()
    F32_FORMS.update(forms)
    check(torch.equal(again, first), f"{label}: request 1 served again "
          f"differs (max abs {max_err(again, first):.4g})")
    log(f"{label}: request 1 served again, the same bytes")


def f32_image_gate(impl, out32, plain32):
    """Request 1's f32 image through the kernels against the plain twins',
    within ``IMAGE_F32_TOL`` (max abs, mean abs)."""
    d = (out32 - plain32).abs()
    k32 = float(d.max()), float(d.mean())
    log(f"{impl} request 1, f32, kernels vs plain twins: max abs {k32[0]:.4g} "
        f"(tol {IMAGE_F32_TOL[0]}), mean abs {k32[1]:.4g} (tol "
        f"{IMAGE_F32_TOL[1]})")
    check(k32[0] <= IMAGE_F32_TOL[0] and k32[1] <= IMAGE_F32_TOL[1],
          f"{impl}: f32 kernel path and plain path disagree")


def f32_requests(pipe32, requests, expected, impl):
    """ROUTE_F32_REQUESTS f32 requests on ``pipe32``, cycling through
    ``requests``: each one's device ms (CUDA events) and launches, held to
    ``expected``.  Returns (request 1's image, the ms, the launches)."""
    import torch
    from arbitrarystyletransfer_tpu_torch.ops.kernels import (
        LAUNCHES,
        reset_launches,
    )

    reset_launches()
    first, times = None, []
    for i in range(ROUTE_F32_REQUESTS):
        content, style, alpha = requests[i % len(requests)]
        before, forms = dict(LAUNCHES), f32_forms()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = pipe32.stylize(content, style, alpha)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        n = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        check(n == expected, f"{impl} f32 request {i + 1} launched {n}, "
              f"expected {expected}")
        check_forms(forms, "serve", expected["adaattn_fwd"],
                    f"{impl} f32 request {i + 1}")
        check(bool(torch.isfinite(out).all()), f"{impl} f32: non-finite")
        if first is None:
            first = out
    log(f"{impl} f32 requests: {[round(t, 3) for t in times]} ms (the "
        "first a warm-up)")
    served_again(f"{impl} f32", pipe32, requests[0], first)
    return first, times, dict(LAUNCHES)


def drive_route(pipe, impl, requests, expected):
    """The route's requests with the counters reset just before and read
    just after; then its checks, its times and its profile."""
    import torch
    from arbitrarystyletransfer_tpu_torch.infer import StylePipeline
    from arbitrarystyletransfer_tpu_torch.ops.kernels import (
        LAUNCHES,
        reset_launches,
    )

    shape = (BATCH, SIZE, SIZE, 3)
    torch.cuda.reset_peak_memory_stats()
    outs, times, per_request = [], [], []
    reset_launches()
    for content, style, alpha in requests:
        before = dict(LAUNCHES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = pipe.stylize(content, style, alpha)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        per_request.append({k: LAUNCHES[k] - before[k] for k in LAUNCHES})
        outs.append(out)
    launches = dict(LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    for i, (out, n) in enumerate(zip(outs, per_request)):
        sat = float(((out == 0) | (out == 1)).float().mean())
        log(f"{impl} request {i + 1}: alpha {requests[i][2]}, "
            f"{times[i]:.3f} ms, launches {n}, mean {float(out.mean()):.4f} "
            f"std {float(out.std()):.4f}, saturated {sat:.4%}")
        check(tuple(out.shape) == shape, f"output shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), f"{impl}: non-finite output")
        check(sat < 0.5, f"{impl}: {sat:.1%} of the output is 0 or 1")
        check(n == expected, f"{impl} request {i + 1} launched {n}, "
              f"expected {expected}")
    check(launches == {k: v * len(requests) for k, v in expected.items()},
          f"{impl}: launches {launches}")
    served_again(f"{impl} bf16", pipe, requests[0], outs[0])

    # Request 1 again through the plain twins (bf16 and f32), and through
    # the kernels at f32.
    content, style, alpha = requests[0]
    plain, plain_times = run_plain(pipe, content, style, alpha, repeats=3)
    check(dict(LAUNCHES) == launches, "the plain run launched a kernel")
    pipe32 = StylePipeline(
        dataclasses.replace(pipe.cfg, compute_dtype="float32"),
        engine="fused", device=DEVICE, state=pipe.state,
        encoder_impl=impl, decoder_impl=impl)
    out32, times32, launches32 = f32_requests(pipe32, requests, expected,
                                              impl)
    plain32, _ = run_plain(pipe32, content, style, alpha, repeats=1)

    def errs(a, b):
        d = (a - b).abs()
        return float(d.max()), float(d.mean())

    f32_image_gate(impl, out32, plain32)
    k16 = errs(outs[0], plain)
    floor16 = errs(plain, plain32)
    del out32, plain32
    log(f"{impl} request 1, bf16, kernels vs plain twins: max abs "
        f"{k16[0]:.4g}, mean abs {k16[1]:.4g}; the bf16 plain path's own "
        f"error vs f32: max abs {floor16[0]:.4g}, mean abs {floor16[1]:.4g} "
        f"(tol {IMAGE_BF16_FACTOR}x that)")
    check(k16[0] <= IMAGE_BF16_FACTOR * floor16[0]
          and k16[1] <= IMAGE_BF16_FACTOR * floor16[1],
          f"{impl}: bf16 kernel path differs from the plain path by more "
          "than bf16 itself does")

    ms = statistics.median(times[1:])
    ms32 = statistics.median(times32[1:])
    plain_ms = statistics.median(plain_times[1:])
    ab = adaattn_route_ab(pipe32, requests[-1])
    log(f"route {impl} A/B at f32, ms per request in turns (f64, serve, f64, "
        f"serve): adaattn_fwd on its float64 form {ab['f64']}, on the "
        f"serving form {ab['serve']}")
    log(f"route {impl}: median {ms:.3f} ms/request over requests "
        f"2-{len(requests)} ({BATCH * 1000 / ms:.2f} img/s at {SIZE}px "
        f"batch {BATCH}); plain twins {plain_ms:.3f} ms/request "
        f"({BATCH * 1000 / plain_ms:.2f} img/s); peak memory "
        f"{peak_gib:.2f} GiB; f32 median {ms32:.3f} ms/request over "
        f"requests 2-{ROUTE_F32_REQUESTS} ({BATCH * 1000 / ms32:.2f} img/s)")
    profile_request(pipe, impl, content, style, alpha,
                    top=15 if impl in (MAIN_ROUTE, "mega") else 8)
    return launches, ms, launches32, ms32


def sizes_phase(gen):
    """Every route at each of SIZES, batch SIZES_BATCH, bf16: each request
    launches what ``planned_launches`` plans (the counters reset just
    before each), its image finite, unsaturated and within the routes'
    bf16 gate of the same route through the plain twins (IMAGE_BF16_FACTOR
    times the plain bf16 path's distance to the plain f32 path); prints ms
    per request (the median of the timed requests, and their range), img/s
    and peak memory beside the plain twins' ms (one pass).
    Returns {kernel: launches} over the phase."""
    import torch
    from arbitrarystyletransfer_tpu_torch import ModelConfig, engine
    from arbitrarystyletransfer_tpu_torch.infer import StylePipeline
    from arbitrarystyletransfer_tpu_torch.ops.flatblock import (
        planned_chains,
        planned_launches,
    )
    from arbitrarystyletransfer_tpu_torch.ops.kernels import (
        LAUNCHES,
        reset_launches,
    )

    cfg = ModelConfig(encoder_eval_stats=True, use_pallas_adaattn=True,
                      compute_dtype="bfloat16")
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    pipe = StylePipeline(cfg, engine="fused", device=DEVICE,
                         state=random_state(cfg, SEED))
    total, table = counts(), []

    def plain_chunks(route, content, style, alpha):
        outs, ms = [], 0.0
        for i in range(0, content.shape[0], SIZES_PLAIN_CHUNK):
            out, times = run_plain(route, content[i:i + SIZES_PLAIN_CHUNK],
                                   style[i:i + SIZES_PLAIN_CHUNK], alpha,
                                   repeats=1)
            outs.append(out)
            ms += times[-1]
        return torch.cat(outs), ms

    def errs(a, b):
        d = (a.float() - b.float()).abs()
        return float(d.max()), float(d.mean())

    for size in SIZES:
        shape = (SIZES_BATCH, size, size, 3)
        content = torch.rand(shape, generator=gen, device=DEVICE)
        style = torch.rand(shape, generator=gen, device=DEVICE)
        alpha = 1.0
        # The head normalized on this size's request, as the routes phase
        # does at 512px (pre-clamp mean 0.5, spatial std 0.05).
        with torch.inference_mode():
            pre = engine.stylize_fused(pipe.state, content, style, alpha,
                                       cfg=cfg, dtype=pipe.dtype,
                                       exporting=False).double()
        head = pipe.state["params"]["dec"]["img_out"]
        std = pre.std(dim=(1, 2)).mean(dim=0)
        check(bool((std > 1e-3).all()), f"{size}px pre-clamp image: "
              f"{std.tolist()}")
        scale = 0.05 / std
        head["kernel"] = (head["kernel"] * scale.float()).contiguous()
        head["bias"] = (0.5 - scale * (pre.mean(dim=(0, 1, 2))
                                       - head["bias"])).float()
        del pre
        for impl in SIZES_ROUTES:
            route = StylePipeline(cfg, engine="fused", device=DEVICE,
                                  state=pipe.state, encoder_impl=impl,
                                  decoder_impl=impl)
            expected = counts(adaattn_fwd=1, **planned_launches(
                cfg, size, impl, impl, device=DEVICE))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(SIZES_REQUESTS):
                reset_launches()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = route.stylize(content, style, alpha)
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
                launched = dict(LAUNCHES)
                check(launched == expected, f"{size}px {impl}: launched "
                      f"{launched}, planned {expected}")
                total = {k: total[k] + launched[k] for k in total}
            peak = torch.cuda.max_memory_allocated() / 2**30
            sat = float(((out == 0) | (out == 1)).float().mean())
            check(tuple(out.shape) == shape, f"{size}px {impl}: output "
                  f"shape {tuple(out.shape)}")
            check(bool(torch.isfinite(out).all()),
                  f"{size}px {impl}: non-finite output")
            check(sat < 0.5, f"{size}px {impl}: {sat:.1%} of the output is "
                  "0 or 1")
            plain, plain_ms = plain_chunks(route, content, style, alpha)
            route32 = StylePipeline(cfg32, engine="fused", device=DEVICE,
                                    state=pipe.state, encoder_impl=impl,
                                    decoder_impl=impl)
            plain32, _ = plain_chunks(route32, content, style, alpha)
            check(dict(LAUNCHES) == launched, "the plain runs launched a "
                  "kernel")
            k16, floor16 = errs(out, plain), errs(plain, plain32)
            del plain, plain32
            timed = times[1:]
            ms = statistics.median(timed)
            log(f"sizes {size}px {impl}: plan "
                f"{planned_chains(cfg, size, impl, impl, device=DEVICE)}, "
                f"launches per request "
                f"{ {k: n for k, n in launched.items() if n} }; "
                f"{ms:.3f} ms/request, median of {len(timed)} "
                f"({min(timed):.3f}-{max(timed):.3f}; "
                f"{SIZES_BATCH * 1000 / ms:.2f} img/s; warm-up "
                f"{times[0]:.3f} ms), plain twins "
                f"{plain_ms:.3f} ms ({SIZES_BATCH * 1000 / plain_ms:.2f} "
                f"img/s, {SIZES_PLAIN_CHUNK} images a call), peak "
                f"{peak:.2f} GiB; bf16 kernels vs plain twins max abs "
                f"{k16[0]:.4g} mean abs {k16[1]:.4g}, the plain bf16 path "
                f"vs f32 max abs {floor16[0]:.4g} mean abs {floor16[1]:.4g} "
                f"(tol {IMAGE_BF16_FACTOR}x that); saturated {sat:.4%}")
            check(k16[0] <= IMAGE_BF16_FACTOR * floor16[0]
                  and k16[1] <= IMAGE_BF16_FACTOR * floor16[1],
                  f"{size}px {impl}: bf16 kernel path differs from the "
                  "plain path by more than bf16 itself does")
            table.append({"size": size, "route": impl, "ms": round(ms, 3),
                          "ms_min": round(min(timed), 3),
                          "ms_max": round(max(timed), 3),
                          "img_s": round(SIZES_BATCH * 1000 / ms, 2),
                          "plain_ms": round(plain_ms, 3),
                          "peak_gib": round(peak, 2),
                          "max_abs": k16[0], "floor_max_abs": floor16[0]})
            del out, route, route32
            torch.cuda.empty_cache()
    log(json.dumps({"sizes": table}))
    return total


def adaattn_route_ab(pipe, request):
    """ms of ``pipe.stylize(*request)`` (an f32 pipeline) with the AdaAttN
    statistics through ``adaattn_fwd``'s float64 form ("f64", what every
    f32 path ran before the serving form) and as served ("serve"), in
    turns."""
    import torch
    from arbitrarystyletransfer_tpu_torch.ops.kernels import (
        adaattn_fwd as adaattn_mod,
    )

    served = adaattn_mod.adaattn_statistics
    times = {"f64": [], "serve": []}
    for label in ("f64", "serve", "f64", "serve"):
        if label == "f64":
            adaattn_mod.adaattn_statistics = (
                lambda q, k, v: adaattn_mod.adaattn_fwd(q, k, v)[:2])
        try:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            pipe.stylize(*request)
            end.record()
            torch.cuda.synchronize()
        finally:
            adaattn_mod.adaattn_statistics = served
        times[label].append(round(start.elapsed_time(end), 3))
    return times


def run_plain(pipe, content, style, alpha, repeats):
    """``pipe.stylize`` with every kernel wrapper replaced by its plain
    twin; returns the last output and each call's ms (CUDA events)."""
    import torch
    from arbitrarystyletransfer_tpu_torch.ops import flatblock, flatblock_s2
    from arbitrarystyletransfer_tpu_torch.ops import fused_block, megablock
    from arbitrarystyletransfer_tpu_torch.ops.kernels import (
        adaattn_fwd as adaattn_mod,
        expand_dw as expand_mod,
        flat_block as flat_mod,
        flat_s2 as flat_s2_mod,
        mega_block as mega_mod,
    )

    saved = (fused_block.expand_dw, adaattn_mod.adaattn_statistics,
             flatblock.flat_block, flatblock_s2.flat_s2_block,
             megablock.mega_block)
    fused_block.expand_dw = expand_mod.expand_dw_reference
    adaattn_mod.adaattn_statistics = (
        lambda q, k, v: adaattn_mod.adaattn_fwd_reference(q, k, v)[:2])
    flatblock.flat_block = flat_mod.flat_block_reference
    flatblock_s2.flat_s2_block = flat_s2_mod.flat_s2_block_reference
    megablock.mega_block = mega_mod.mega_block_reference
    times = []
    try:
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = pipe.stylize(content, style, alpha)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
    finally:
        (fused_block.expand_dw, adaattn_mod.adaattn_statistics,
         flatblock.flat_block, flatblock_s2.flat_s2_block,
         megablock.mega_block) = saved
    return out, times


def profile_request(pipe, impl, content, style, alpha, top=15):
    """Device time over one request (torch.profiler): by kernel, and by
    PyTorch op and input shape."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        start.record()
        pipe.stylize(content, style, alpha)
        end.record()
        torch.cuda.synchronize()
    wall = start.elapsed_time(end)
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1000
    log(f"{impl} profile of one request: {wall:.3f} ms wall (CUDA events, "
        f"profiler on), {busy:.3f} ms of device kernels ({busy / wall:.1%} "
        f"busy), {len(events)} distinct kernels")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"  {e.self_device_time_total / 1000:9.3f} ms  x{e.count:<4d} "
            f"{e.key[:90]}")
    ops = [e for e in prof.key_averages(group_by_input_shape=True)
           if e.device_type == torch.autograd.DeviceType.CPU
           and e.self_device_time_total > 0]
    log(f"{impl} by op and input shapes (self device time):")
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"  {e.self_device_time_total / 1000:9.3f} ms  x{e.count:<4d} "
            f"{e.key} {str(e.input_shapes)[:100]}")
    # Layout copies and pads (the NHWC pads should leave few).
    for name in ("aten::copy_", "aten::reflection_pad2d",
                 "aten::replication_pad2d"):
        evs = sorted((e for e in ops if e.key == name),
                     key=lambda e: -e.self_device_time_total)
        total = sum(e.self_device_time_total for e in evs) / 1000
        log(f"{impl} {name}: {total:.3f} ms over "
            f"{sum(e.count for e in evs)} calls"
            + "".join(f"; {e.self_device_time_total / 1000:.3f} ms x"
                      f"{e.count} {str(e.input_shapes)[:70]}"
                      for e in evs[:4]))

def _to_device(tree):
    if isinstance(tree, dict):
        return {k: _to_device(v) for k, v in tree.items()}
    return tree.to(DEVICE)


def plain_route_phase(gen):
    """e2 at 512px (the stride-2 block that "fused" and "mega" run on the
    plain route; "auto" takes the route its plan gives it, the shipped
    table's ``flat_s2_block``) in bf16, timed in turns as it is now and as
    it was
    before its repairs: products rounded to bf16 before the folded-BN bias
    (``torch.matmul`` in bf16), and the reflect pad on the NCHW view
    (``F.pad``, an NCHW-contiguous result that the conv copies back)."""
    import torch
    import torch.nn.functional as F
    from arbitrarystyletransfer_tpu_torch import ModelConfig
    from arbitrarystyletransfer_tpu_torch.ops import blocks

    state = _to_device(random_state(ModelConfig(encoder_eval_stats=True),
                                    SEED))
    params = state["params"]["enc"]["mob_net_2"]
    stats = state["batch_stats"]["enc"]["mob_net_2"]
    x = torch.randn(2 * BATCH, SIZE, SIZE, 16, generator=gen,
                    device=DEVICE).bfloat16()

    def nchw_pad(t, pad):
        return F.pad(t.permute(0, 3, 1, 2), (pad,) * 4,
                     mode="reflect").permute(0, 2, 3, 1)

    variants = {
        "now": {},
        "bf16 products": {"matmul_f32": lambda a, w, bias=None: (
            torch.matmul(a, w).float() + (0.0 if bias is None else bias))},
        "NCHW pad": {"reflect_pad": nchw_pad},
    }
    variants["earlier"] = {**variants["bf16 products"],
                           **variants["NCHW pad"]}

    def run(label):
        saved = {name: getattr(blocks, name) for name in variants[label]}
        for name, fn in variants[label].items():
            setattr(blocks, name, fn)
        try:
            return blocks.plain_block_apply(params, x, 3, 2, 6, stats=stats,
                                            dtype=torch.bfloat16)
        finally:
            for name, fn in saved.items():
                setattr(blocks, name, fn)

    y_now, y_earlier = run("now"), run("earlier")
    diff = float(((y_now.float() - y_earlier.float()).abs() > 0)
                 .float().mean())
    times = {label: [] for label in variants}
    for label in ("earlier", "now", "bf16 products", "NCHW pad", "now",
                  "earlier"):
        times[label].append(round(timed_ms(lambda: run(label), iters=5), 4))
    log(f"plain route e2 x={tuple(x.shape)} -> {tuple(y_now.shape)} bf16, "
        f"device ms per call in turns: {times}; {diff:.1%} of the outputs "
        "moved with the rounding")
    del x, y_now, y_earlier
    torch.cuda.empty_cache()


def bwd_bounds(b, nc, ns, size, dsize):
    """{kernel: Bound} of rows 6-7 at one shape: q, k, v, vbar, dm1, dm2, m,
    l (f32) and D (f64) read once and the gradients written once, against
    the float64 products (the logits, 2 B Nc Ns C FLOPs as the f32
    forward forms them, and T, 4 B Nc Ns C; for dkv also P^T dm1 and P^T
    dm2, 4 B Nc Ns C) at the f64 peak and the other products (2 for dq: dS
    k; 2 for dkv: dS^T q) at a third of the TF32 peak (3xTF32: f32
    accuracy)."""
    work = b * nc * ns * 128
    in_bytes = ((size * (nc + 2 * ns) + 2 * dsize * nc) * b * 128
                + 16 * b * nc + 4 * b * 128)
    out = {}
    for kernel, out_rows, f64, rest in (("adaattn_dq", nc, 6, 2),
                                        ("adaattn_dkv", 2 * ns, 10, 2)):
        bound = Bound()
        bound.add(in_bytes + size * b * out_rows * 128, f64 * work, PEAK_F64)
        bound.add(0, rest * work, PEAK_TF32 / 3)
        out[kernel] = bound
    return out


def dense_grads_f64(q, k, v, dmean, dstd):
    """dq, dk, dv of sum(mean dmean + std dstd) through the dense
    statistics in float64 (autograd)."""
    import torch
    from arbitrarystyletransfer_tpu_torch.ops.stats import safe_sqrt

    with torch.enable_grad():
        q64, k64, v64 = (t.detach().double().requires_grad_()
                         for t in (q, k, v))
        attn = torch.softmax(q64 @ k64.transpose(1, 2), dim=-1)
        mean = attn @ v64
        std = safe_sqrt(attn @ v64.square() - mean.square())
        return torch.autograd.grad(
            (mean * dmean.double()).sum() + (std * dstd.double()).sum(),
            (q64, k64, v64))


def dv_f64(q, k, v, vbar, dm1, dm2, m, l):
    """dv of ``adaattn_dkv``'s function on the same inputs in float64
    (autograd): the gradient in v of sum P (dm1 . vc + dm2 . vc^2), with P =
    exp(q k^T - m) / l held fixed and vc = v - vbar."""
    import torch

    with torch.enable_grad():
        v64 = v.detach().double().requires_grad_()
        p = torch.exp(q.double() @ k.double().transpose(1, 2)
                      - m.double()[..., None]) / l.double()[..., None]
        vc = v64 - vbar.double()[:, None, :]
        return torch.autograd.grad(
            (dm1.double() * (p @ vc)).sum()
            + (dm2.double() * (p @ vc.square())).sum(), v64)[0]


def bwd_sweep(name, args, bounds):
    """Rows 6-7 at one f32 shape by part: device ms (median of 3 windows),
    the share of the bound, the f32-accurate work's TFLOP/s, registers,
    shared memory and CTAs per SM, the chunks of the reduction axis, ms
    with one part cut out (``adaattn_bwd_cut_launch``: the tensor-core
    products, the TMA ring's prefetch, the f64 logits and, for dkv, the
    f64 dv products; results discarded) and ms at the chunkings
    ``BWD_SWEEP_SPLITS``.  One JSON line per kernel."""
    import ctypes

    import torch
    from arbitrarystyletransfer_tpu_torch.ops.kernels import adaattn_bwd
    from arbitrarystyletransfer_tpu_torch.ops.kernels._build import (
        load_library,
    )

    lib = load_library()
    q, k, v = args[:3]
    b, nc, _ = q.shape
    ns = k.shape[1]
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.contiguous().data_ptr() for t in args]
    for which, kernel in enumerate(("adaattn_dq", "adaattn_dkv")):
        occ = (ctypes.c_int * 3)()
        check(lib.adaattn_bwd_occupancy(which, occ) == 0,
              f"{kernel}: occupancy query failed")
        fn = getattr(adaattn_bwd, kernel)
        if which == 0:
            splits = lib.adaattn_dq_splits(b, nc, ns)
            outs = (torch.empty_like(q), torch.empty(0, device=DEVICE))
            part = torch.empty(splits * b * nc * 128, device=DEVICE)
        else:
            splits = lib.adaattn_dkv_splits(b, nc, ns)
            outs = (torch.empty_like(k), torch.empty_like(v))
            part = torch.empty(2 * splits * b * ns * 128, device=DEVICE)
        ms = statistics.median(timed_ms(lambda: fn(*args), iters=10)
                               for _ in range(3))
        rec = {"kernel": kernel, "shape": name, "b": b, "nc": nc, "ns": ns,
               "ms": ms, "bound_ms": bounds[kernel].ms(),
               "bound_by": bounds[kernel].by(),
               "share": bounds[kernel].ms() / ms,
               "tflops": bounds[kernel].flops / ms / 1e9,
               "registers": occ[0], "smem": occ[1], "ctas_per_sm": occ[2],
               "splits": splits,
               "ctas": b * splits * (-(-nc // 32) if which == 0
                                     else -(-ns // 64))}
        cuts = [(1, "ms_no_mma"), (2, "ms_sync_staging"),
                (3, "ms_no_logits")] + ([(4, "ms_no_dv")] if which else [])
        for cut, label in cuts:
            def run(cut=cut):
                rc = lib.adaattn_bwd_cut_launch(
                    which, cut, *ptrs, outs[0].data_ptr(),
                    outs[1].data_ptr(), part.data_ptr(), b, nc, ns, splits,
                    stream)
                check(rc == 0, f"{kernel} cut {cut}: CUDA error {rc}")

            rec[label] = timed_ms(run, iters=10)
        # The same kernel at other chunkings of the reduction axis.
        rec["ms_by_splits"] = {
            n: timed_ms(lambda n=n: fn(*args, splits=n), iters=10)
            for n in BWD_SWEEP_SPLITS}
        log(json.dumps(rec))


def adaattn_bwd_phase(gen):
    """adaattn_dq and adaattn_dkv against their twins at every case (the
    "offset" case also against float64 autograd; the training shape also
    at forced chunkings of the reduction axis, and run twice for equal
    bits), with the forward kernel's time at the training buckets and rows
    6-7 by part at ``BWD_SWEEP_CASES``; returns {kernel: (worst error, ms,
    plain ms, Bound, library ms)} per 160px training step."""
    import torch
    from arbitrarystyletransfer_tpu_torch.ops.kernels.adaattn_bwd import (
        adaattn_dkv,
        adaattn_dkv_reference,
        adaattn_dq,
        adaattn_dq_reference,
    )
    from arbitrarystyletransfer_tpu_torch.ops.kernels.adaattn_fwd import (
        adaattn_fwd,
        adaattn_fwd_reference,
        fold_cotangents,
    )

    gen_own = torch.Generator(device=DEVICE).manual_seed(SEED + 9)
    out = {name: [0.0, 0.0, 0.0, Bound(), None]
           for name in ("adaattn_dq", "adaattn_dkv")}
    for name, b, nc, ns, dtype, dm_dtype, per_step in BWD_CASES:
        dt, dmt = getattr(torch, dtype), getattr(torch, dm_dtype)
        dev = dict(device=DEVICE,
                   generator=gen_own if name in BWD_OWN_GEN else gen)
        scale = BWD_QK_SCALE.get(name, 0.3)
        q = (scale * torch.randn(b, nc, 128, **dev)).to(dt)
        k = (scale * torch.randn(b, ns, 128, **dev)).to(dt)
        if name in BWD_OFFSET_RATIO:
            v = (30.0 + 0.1 * torch.randn(b, ns, 128, **dev)).to(dt)
            mean, std, m, l = adaattn_fwd(q, k, v)
        else:
            v = torch.randn(b, ns, 128, **dev).to(dt)
            mean, std, m, l = adaattn_fwd_reference(q, k, v)
        dmean = torch.randn(b, nc, 128, **dev)
        dstd = torch.randn(b, nc, 128, **dev)
        vbar, dm1, dm2, d_row = fold_cotangents(mean, std, dmean, dstd, v)
        args = (q, k, v, vbar, dm1.to(dmt), dm2.to(dmt), m, l, d_row)
        got = (adaattn_dq(*args), *adaattn_dkv(*args))
        torch.cuda.synchronize()
        ref = (adaattn_dq_reference(*args), *adaattn_dkv_reference(*args))
        rel = BWD_F32_TOL if dt == torch.float32 else BF16_TOL
        errs = []
        for what, o, r in zip(("dq", "dk", "dv"), got, ref):
            err = max_err(o, r)
            tol = rel * float(r.float().abs().max()) + 1e-6
            errs.append(f"{what} err {err:.4g} (tol {tol:.4g})")
            check(o.dtype == dt and tuple(o.shape) == tuple(r.shape),
                  f"adaattn bwd {name} {what}: {o.dtype} {tuple(o.shape)}")
            check(err <= tol, f"adaattn bwd {name} {what} differs")
            if name == "160px":
                kernel = "adaattn_dq" if what == "dq" else "adaattn_dkv"
                out[kernel][0] = max(out[kernel][0], err)
        if name in BWD_OWN_GEN:
            live = std > 0  # a one-hot row's std is 0
            ratio = float((mean.double().square()
                           / std.double().square())[live].max())
            errs.append(f"max (mean / std)^2 {ratio:.4g} (std > 0)")
            check(ratio >= BWD_OFFSET_RATIO[name],
                  f"adaattn bwd {name}: (mean / std)^2 only {ratio:.4g}")
        if name == "offset-1e8":
            r = dv_f64(q, k, v, vbar, dm1, dm2, m, l)
            err = max_err(got[2], r)
            tol = BWD_F32_TOL * float(r.abs().max())
            errs.append(f"dv vs float64 autograd of the same function "
                        f"{err:.4g} (tol {tol:.4g})")
            check(err <= tol, f"adaattn bwd {name} dv differs from float64 "
                  "autograd of the same function")
        if name == "offset":
            for what, o, r in zip(("dq", "dk", "dv"), got,
                                  dense_grads_f64(q, k, v, dmean, dstd)):
                err = max_err(o, r)
                tol = BWD_F32_TOL * float(r.abs().max()) + 1e-6
                errs.append(f"{what} vs float64 autograd {err:.4g} (tol "
                            f"{tol:.4g})")
                check(err <= tol, f"adaattn bwd {name} {what} differs from "
                      "float64 autograd")
        if name == "160px":
            again = (adaattn_dq(*args), *adaattn_dkv(*args))
            check(all(torch.equal(a, g) for a, g in zip(again, got)),
                  "adaattn bwd: a second run gave other bits")
            for splits in (1, 2, 3, 5, 13):
                forced = (adaattn_dq(*args, splits=splits),
                          *adaattn_dkv(*args, splits=splits))
                for what, o, r in zip(("dq", "dk", "dv"), forced, ref):
                    err = max_err(o, r)
                    tol = rel * float(r.float().abs().max()) + 1e-6
                    check(err <= tol, f"adaattn bwd {name} {what} at "
                          f"{splits} chunks differs ({err:.4g}, tol "
                          f"{tol:.4g})")
                errs.append(f"{splits} chunks ok")
            del again, forced
        del got, ref
        t_dq = timed_ms(lambda: adaattn_dq(*args), iters=5)
        t_dkv = timed_ms(lambda: adaattn_dkv(*args), iters=5)
        t_pdq = timed_ms(lambda: adaattn_dq_reference(*args), iters=3,
                         warmup=1)
        t_pdkv = timed_ms(lambda: adaattn_dkv_reference(*args), iters=3,
                          warmup=1)
        lib_fb, what_fb = sdpa_yardstick(q, k, v, backward=True)
        lib_f, _ = sdpa_yardstick(q, k, v)
        fwd = ""
        if (dtype == dm_dtype == "float32" and name != "ragged"
                and name not in BWD_OWN_GEN):
            t_f = timed_ms(lambda: adaattn_fwd(q, k, v), iters=5)
            t_pf = timed_ms(lambda: adaattn_fwd_reference(q, k, v), iters=3,
                            warmup=1)
            fwd = f"; adaattn_fwd kernel {t_f:.4f} ms, plain {t_pf:.4f} ms"
        bounds = bwd_bounds(b, nc, ns, q.element_size(),
                            dm1.to(dmt).element_size())
        log(f"adaattn bwd {name:7s} B={b} Nc={nc} Ns={ns} {dtype} (dm "
            f"{dm_dtype}): " + ", ".join(errs)
            + f"; adaattn_dq {t_dq:.4f} ms (plain {t_pdq:.4f}, bound "
            f"{bounds['adaattn_dq'].ms():.4f}), adaattn_dkv {t_dkv:.4f} ms "
            f"(plain {t_pdkv:.4f}, bound {bounds['adaattn_dkv'].ms():.4f}); "
            f"library sdpa {what_fb}: forward+backward {lib_fb:.4f} ms, "
            f"forward {lib_f:.4f} ms (median of 5 windows of 10)" + fwd)
        if name in BWD_SWEEP_CASES:
            bwd_sweep(name, args, bounds)
        if per_step:
            for kernel, t_k, t_p in (("adaattn_dq", t_dq, t_pdq),
                                     ("adaattn_dkv", t_dkv, t_pdkv)):
                out[kernel][1] += per_step * t_k
                out[kernel][2] += per_step * t_p
                out[kernel][3].merge(bounds[kernel], per_step)
                # The sdpa backward computes dq, dk and dv at once: its
                # forward+backward less its forward stands for both rows.
                out[kernel][4] = per_step * (lib_fb - lib_f)
        del args, q, k, v, dm1, dm2
        torch.cuda.empty_cache()
    return out


def _uniform_batches(gen, size):
    import torch

    shape = (TRAIN_BATCH, size, size, 3)
    while True:
        yield (torch.rand(shape, generator=gen, device=DEVICE),
               torch.rand(shape, generator=gen, device=DEVICE))


def seeded_batch(seed):
    """A uniform (content, style) batch at the last training size from a
    generator of its own."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    size = TRAIN_SIZES[-1]
    shape = (TRAIN_BATCH, size, size, 3)
    return (torch.rand(shape, generator=gen, device=DEVICE),
            torch.rand(shape, generator=gen, device=DEVICE))


def train_phase(gen):
    """ASTTrainer on the card: warm-up, timed steps with their launches,
    the kernel-vs-twin step, the checkpoint round trip and a profile.
    Returns the launches of the timed steps."""
    import tempfile

    import torch
    from arbitrarystyletransfer_tpu_torch import weights
    from arbitrarystyletransfer_tpu_torch.ops.kernels import (
        LAUNCHES,
        reset_launches,
    )
    from arbitrarystyletransfer_tpu_torch.train import checkpoint as ckpt

    with tempfile.TemporaryDirectory() as tmp:
        batches = {size: _uniform_batches(gen, size) for size in TRAIN_SIZES}
        trainer = make_trainer(tmp, batches[TRAIN_SIZES[-1]])
        for _ in range(STEP_BATCHES):
            kernel_vs_twin_step(trainer, next(batches[TRAIN_SIZES[-1]]))
        for seed in TRAIN_OWN_SEEDS:
            log(f"train gate, standing batch (seed {seed}):")
            GATE_FIGURES.clear()
            dist = kernel_vs_twin_step(trainer, seeded_batch(seed))
            log(json.dumps({"standing_batch": seed, "gates": GATE_FIGURES}))
            check(dist["ratio"] >= TRAIN_OWN_RATIO,
                  f"standing batch {seed}: (mean / std)^2 only "
                  f"{dist['ratio']:.4g}")
        log(f"train step at bf16 (seed {TRAIN_BF16_SEED}):")
        bf16_step_case(trainer, seeded_batch(TRAIN_BF16_SEED))
        for seed in TRAIN_WATCH_SEEDS:
            log(f"train gate, open fault's batch (seed {seed}), not held:")
            dist = kernel_vs_twin_step(trainer, seeded_batch(seed), gate=False)
            log(f"  open fault's batch {seed}: (mean / std)^2 "
                f"{dist['ratio']:.4g}; outside the gate: {dist['failed']}")
        buffers0 = [b.clone() for b in trainer.buffers]
        for size in TRAIN_SIZES:
            t0 = time.perf_counter()
            # The last bucket's warm-up step taken twice from one state
            # (the trainer goes on from the second): the same bits.
            aux = (repeat_step("train", trainer, *next(batches[size]))
                   if size == TRAIN_SIZES[-1] else
                   trainer.train_step(*next(batches[size])))
            torch.cuda.synchronize()
            log(f"train warm-up {size}px: {time.perf_counter() - t0:.3f} s, "
                f"loss {float(aux['loss']):.6g}")

        torch.cuda.reset_peak_memory_stats()
        times, per_step, losses = [], [], []
        reset_launches()
        forms = f32_forms()
        for _ in range(TRAIN_STEPS):
            content, style = next(batches[TRAIN_SIZES[-1]])
            before = dict(LAUNCHES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            aux = trainer.train_step(content, style)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
            per_step.append({k: LAUNCHES[k] - before[k] for k in LAUNCHES})
            losses.append(float(aux["loss"]))
            check(bool(aux["finite"]), "train step: non-finite gradient norm")
        launches = dict(LAUNCHES)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        for i, (n, t) in enumerate(zip(per_step, times)):
            check(n == TRAIN_LAUNCHES, f"train step {i + 1} launched {n}, "
                  f"expected {TRAIN_LAUNCHES}")
        # Autograd records the step's AdaAttN calls: the float64 form.
        check_forms(forms, "f64", TRAIN_STEPS * TRAIN_LAUNCHES["adaattn_fwd"],
                    "train steps")
        check(all(math.isfinite(x) for x in losses), f"losses {losses}")
        check(int(trainer.step) == len(TRAIN_SIZES) + TRAIN_STEPS,
              f"step counter {int(trainer.step)}")
        check(any(not torch.equal(a, b)
                  for a, b in zip(buffers0, trainer.buffers)),
              "the BatchNorm running buffers did not move")
        ms = statistics.median(times)
        log(f"train step {TRAIN_SIZES[-1]}px batch {TRAIN_BATCH} f32: step "
            f"ms {[round(t, 3) for t in times]}, median {ms:.3f} ms "
            f"({1000 / ms:.3f} steps/s); losses {losses}; launches per step "
            f"{per_step[0]}; peak memory {peak_gib:.2f} GiB")

        path = f"{tmp}/round_trip.pt"
        ckpt.save_checkpoint(path, weights.module_state(trainer.ast),
                             trainer.opt.state_dict(), trainer.step)
        back = ckpt.restore_checkpoint(path, DEVICE)
        saved = {"params": weights.module_state(trainer.ast)["params"],
                 "batch_stats": weights.module_state(trainer.ast)[
                     "batch_stats"],
                 "opt_state": trainer.opt.state_dict(), "step": trainer.step}
        flat_a, flat_b = _flat(saved), _flat(back)
        check(flat_a.keys() == flat_b.keys()
              and all(torch.equal(flat_a[k], flat_b[k]) for k in flat_a),
              "checkpoint round trip changed a tensor")
        log(f"checkpoint round trip: {len(flat_a)} tensors equal")

        profile_train_step(trainer, next(batches[TRAIN_SIZES[-1]]))
    return launches, ms, peak_gib


def gan_phase(gen, train_ms):
    """``ASTTrainer`` with ``use_dis`` on the card: the kernel-vs-twin step
    with the GAN terms, warm-up through the first R1 step, timed steps with
    their launches, R1's cadence and their device time by phase, a
    save/resume that continues the run bit for bit, and a profile by
    kernel.  Returns the launches of the timed steps, the median ms without
    R1, the R1 steps' ms and the peak memory."""
    import tempfile

    import torch
    from arbitrarystyletransfer_tpu_torch import weights
    from arbitrarystyletransfer_tpu_torch.ops.kernels import (
        LAUNCHES,
        reset_launches,
    )
    from arbitrarystyletransfer_tpu_torch.train import gan

    with tempfile.TemporaryDirectory() as tmp:
        batches = {size: _uniform_batches(gen, size) for size in TRAIN_SIZES}
        trainer = make_trainer(tmp, batches[TRAIN_SIZES[-1]], use_dis=True)
        log(f"gan: discriminator of {sum(p.numel() for p in trainer.dis_opt.params)}"
            " parameters, dropout "
            f"{trainer.disc.mobnet.dropout_rate}")
        log("gan gate (kernels vs twins, with the GAN terms):")
        kernel_vs_twin_step(trainer, next(batches[TRAIN_SIZES[-1]]))
        sizes = list(TRAIN_SIZES[:-1]) + [TRAIN_SIZES[-1]] * (
            gan.R1_EVERY - len(TRAIN_SIZES) + 1)
        for size in sizes:
            dis_step = trainer.host_dis_step
            t0 = time.perf_counter()
            batch = next(batches[size])
            # The last bucket's first warm-up step and the R1 step each
            # taken twice from one state (the trainer goes on from the
            # second): the same bits, with R1's double backward too.
            twice = size == TRAIN_SIZES[-1] and (
                dis_step == len(TRAIN_SIZES) - 1 or gan.r1_due(dis_step))
            aux = (repeat_step(f"gan at dis step {dis_step}", trainer, *batch)
                   if twice else trainer.train_step(*batch))
            torch.cuda.synchronize()
            log(f"gan warm-up {size}px at dis step {dis_step}: "
                f"{time.perf_counter() - t0:.3f} s, loss "
                f"{float(aux['loss']):.6g}, dis_loss "
                f"{float(aux['dis_loss']):.6g}, r1_loss "
                f"{float(aux['r1_loss']):.6g}")
        check(gan.r1_due(dis_step), f"the last warm-up step (dis step "
              f"{dis_step}) is no R1 step")

        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        plain, r1_steps, rows, marks = [], [], [], []
        phases = {False: [], True: []}

        def mark(name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((name, ev))

        for _ in range(GAN_STEPS):
            content, style = next(batches[TRAIN_SIZES[-1]])
            dis_step = trainer.host_dis_step
            counters = (int(trainer.step), int(trainer.dis_step))
            dis_buffers = [b.clone() for b in trainer.dis_buffers]
            before = dict(LAUNCHES)
            marks.clear()
            end = torch.cuda.Event(enable_timing=True)
            mark("start")
            aux = trainer.train_step(content, style, mark=mark)
            end.record()
            torch.cuda.synchronize()
            ms = marks[0][1].elapsed_time(end)
            n = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
            row = {k: float(aux[k]) for k in (
                "loss", "gen_adv_loss", "dis_loss", "r1_loss",
                "dis_grad_norm")}
            due = gan.r1_due(dis_step)
            rows.append((dis_step, round(ms, 3), row))
            (r1_steps if due else plain).append(ms)
            phases[due].append({name: a.elapsed_time(b) for (_, a), (name, b)
                                in zip(marks, marks[1:])})
            check(n == TRAIN_LAUNCHES, f"gan step at dis step {dis_step} "
                  f"launched {n}, expected {TRAIN_LAUNCHES}")
            check(bool(aux["finite"]), f"gan step at dis step {dis_step}: "
                  f"not finite {row}")
            check(all(math.isfinite(row[k]) for k in (
                "loss", "gen_adv_loss", "dis_loss")), f"gan losses {row}")
            check((int(trainer.step), int(trainer.dis_step))
                  == (counters[0] + 1, counters[1] + 1),
                  f"gan step counters {counters} -> "
                  f"{int(trainer.step), int(trainer.dis_step)}")
            check(any(not torch.equal(a, b) for a, b in
                      zip(dis_buffers, trainer.dis_buffers)),
                  "the discriminator's BatchNorm buffers did not move")
            check((row["r1_loss"] != 0) == due,
                  f"r1_loss {row['r1_loss']} at dis step {dis_step} (due: "
                  f"{due})")
        launches = dict(LAUNCHES)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        check(len(r1_steps) == GAN_STEPS // gan.R1_EVERY,
              f"{len(r1_steps)} R1 steps among the timed steps")
        ms_plain = statistics.median(plain)
        log(f"gan steps (dis step, ms, values): {rows}")
        log(f"gan step {TRAIN_SIZES[-1]}px batch {TRAIN_BATCH} f32: median "
            f"{ms_plain:.3f} ms without R1 ({len(plain)} steps), R1 steps "
            f"{[round(t, 3) for t in r1_steps]} ms (median "
            f"{statistics.median(r1_steps):.3f}); the plain train step "
            f"{train_ms:.3f} ms in this run; launches per step "
            f"{TRAIN_LAUNCHES}; peak memory {peak_gib:.2f} GiB")
        for due, label in ((False, f"median of the {len(plain)} steps "
                            "without R1"), (True, "the R1 steps")):
            split = {name: [p[name] for p in phases[due]]
                     for name in phases[due][0]}
            log(f"gan step device time by phase (CUDA events at the "
                f"trainer's marks), {label}: " + ", ".join(
                    f"{name} {statistics.median(t):.3f} ms" if not due else
                    f"{name} {[round(x, 3) for x in t]} ms"
                    for name, t in split.items()))

        # Save, resume in a second trainer, and take the same step in both:
        # equal bit for bit, dropout masks included, under the cuDNN
        # settings the run has (the trainers choose their own).
        trainer.save()
        resumed = make_resumed(tmp, trainer)
        batch = next(batches[TRAIN_SIZES[-1]])
        aux_a, aux_b = (t.train_step(*batch) for t in (trainer, resumed))
        diff = {k: float((aux_a[k] - aux_b[k]).abs()) for k in (
            "loss", "gen_adv_loss", "dis_loss", "grad_norm",
            "dis_grad_norm")}
        flat_a = weights.flatten(weights.module_state(trainer.disc))
        flat_b = weights.flatten(weights.module_state(resumed.disc))
        flat_a.update(weights.flatten(weights.module_state(trainer.ast)))
        flat_b.update(weights.flatten(weights.module_state(resumed.ast)))
        unequal = [k for k in flat_a if not torch.equal(flat_a[k], flat_b[k])]
        log(f"gan resume: ast_dis.pt step {int(resumed.dis_step) - 1}, "
            f"the resumed step against the run's: |diff| {diff}, "
            f"{len(unequal)} of {len(flat_a)} tensors unequal")
        check(not any(diff.values()) and not unequal,
              f"the resumed step differs: {diff}, {unequal[:5]}")
        del resumed
        profile_train_step(trainer, next(batches[TRAIN_SIZES[-1]]),
                           label="gan")
    return launches, ms_plain, r1_steps, peak_gib


def make_resumed(tmp, trainer):
    """A trainer like ``trainer`` that resumes from its checkpoints under
    ``tmp`` (``ast.pt``, ``ast_dis.pt``)."""
    import dataclasses

    from arbitrarystyletransfer_tpu_torch.train.ast_trainer import ASTTrainer

    resumed = ASTTrainer(dataclasses.replace(trainer.cfg, load=True),
                         iter(()), model_cfg=trainer.ast.cfg, seed=SEED,
                         preview_dir=None, device=DEVICE,
                         log_fn=lambda *a: None)
    check((resumed.host_step, resumed.host_dis_step)
          == (trainer.host_step, trainer.host_dis_step),
          f"resumed at {resumed.host_step, resumed.host_dis_step}")
    return resumed


def make_trainer(tmp, batches, use_dis=False):
    """The train phase's ``ASTTrainer`` (saving under ``tmp``), with the
    parity tests' weights and its head normalized on the first batch of
    ``batches``, which it also trains on; with ``use_dis``, the GAN
    phase's (the discriminator at its seeded init)."""
    from arbitrarystyletransfer_tpu_torch import ModelConfig, weights
    from arbitrarystyletransfer_tpu_torch.config import ASTTrainConfig
    from arbitrarystyletransfer_tpu_torch.train.ast_trainer import ASTTrainer

    tcfg = ASTTrainConfig(batch_size=TRAIN_BATCH, save_dir=tmp, ae_model="",
                          use_dis=use_dis)
    model_cfg = ModelConfig(use_pallas_adaattn=True)
    trainer = ASTTrainer(tcfg, batches, model_cfg=model_cfg, seed=SEED,
                         preview_dir=None, device=DEVICE, log_fn=log)
    check(trainer.vgg_weights_path is None,
          f"a VGG weight file was used: {trainer.vgg_weights_path}")
    # The parity tests' redrawn weights (``random_state``: AdaAttN logits
    # of std ~1.4, SE gates open), and the head normalized so that the
    # image lies inside [0, 1].  With the reference init the unscaled
    # logits have std ~11 and the closed SE gates flatten the maps:
    # std = sqrt(ev2 - mean^2) is rounding noise and so is its gradient
    # (dstd / 2 std), in the twins as in the kernels.  And an image
    # at the clip bounds puts the 1e8-weighted out-of-range term's
    # gradient (proportional to the overshoot) on rounding noise too.
    weights.load_state(trainer.ast, random_state(model_cfg, SEED))
    normalize_train_head(trainer, next(batches))
    return trainer


def normalize_train_head(trainer, batch):
    """Scale the decoder head of ``trainer.ast`` (a trainer's, or a graph
    engine pipeline's) so that the stylized image of ``batch`` has a
    per-channel mean 0.5 and spatial std 0.05 (as ``routes_phase`` does).
    The AdaAttN statistics of that forward take ``adaattn_fwd``'s float64
    form, as the train steps do, and not the serving form that ``no_grad``
    would pick: the head, and every loss and gradient the train, GAN, dp
    and train-gate steps compute from it, is then what it was before the
    serving form existed (those steps' losses are chaotic at ~1e-6 under
    such changes of the state)."""
    import torch
    from arbitrarystyletransfer_tpu_torch.ops.kernels import (
        adaattn_fwd as fwd_mod,
    )

    ast = trainer.ast
    served = fwd_mod.adaattn_statistics
    fwd_mod.adaattn_statistics = (
        lambda q, k, v: fwd_mod.adaattn_fwd(q, k, v)[:2])
    try:
        with torch.no_grad():
            pre = ast.dec(ast.encode(*batch, detach=True)).double()
    finally:
        fwd_mod.adaattn_statistics = served
    with torch.no_grad():
        head = ast.dec.img_out
        std = pre.std(dim=(1, 2)).mean(dim=0)
        check(bool((std > 1e-3).all()), f"train pre-clamp image: {std}")
        scale = 0.05 / std
        head.kernel.mul_(scale.float())
        head.bias.copy_(0.5 - scale * (pre.mean(dim=(0, 1, 2)) - head.bias))


def step_state(trainer):
    """Every tensor a train step of ``trainer`` (``ASTTrainer``, with or
    without its discriminator, or ``AutoencoderTrainer``) changes, by name:
    the parameters, the running buffers, the optimizers' moments and counts
    and the step counters."""
    out = {}
    model = trainer.ast if hasattr(trainer, "ast") else trainer.model
    nets = [("", model, trainer.opt, "step")]
    if getattr(trainer, "disc", None) is not None:
        nets.append(("dis/", trainer.disc, trainer.dis_opt, "dis_step"))
    for prefix, net, opt, counter in nets:
        for name, t in (*net.named_parameters(), *net.named_buffers()):
            out[prefix + name] = t
        for key in ("mu", "nu", "count"):
            out[f"{prefix}opt/{key}"] = getattr(opt, key)
        out[prefix + counter] = getattr(trainer, counter)
    return out


def step_snapshot(trainer):
    """A copy of ``step_state`` and the host step mirrors."""
    mirrors = {k: getattr(trainer, k) for k in ("host_step", "host_dis_step")
               if hasattr(trainer, k)}
    return ({k: t.detach().clone() for k, t in step_state(trainer).items()},
            mirrors)


def step_restore(trainer, snap):
    """Put ``trainer`` back to ``step_snapshot``'s state: the parameters,
    buffers and counters in place, the optimizers' moments (which a step
    replaces) as new tensors."""
    import torch

    tensors, mirrors = snap
    opts = {"": trainer.opt}
    if getattr(trainer, "disc", None) is not None:
        opts["dis/"] = trainer.dis_opt
    with torch.no_grad():
        for name, t in step_state(trainer).items():
            prefix = "dis/" if name.startswith("dis/") else ""
            key = name.removeprefix(prefix)
            if key.startswith("opt/"):
                setattr(opts[prefix], key[4:], tensors[name].clone())
            else:
                t.copy_(tensors[name])
    for k, v in mirrors.items():
        setattr(trainer, k, v)


def repeat_step(label, trainer, *batch):
    """One train step of ``trainer`` on ``batch`` taken twice from the same
    state: its gradients (every optimizer's, as it receives them), its
    aux values and the updated state must be equal bit for bit.  Leaves the
    trainer where the second step left it; returns the aux."""
    import torch

    grads = []
    opts = [trainer.opt]
    if getattr(trainer, "disc", None) is not None:
        opts.append(trainer.dis_opt)
    applies = [opt.apply_if_finite for opt in opts]

    def recording(opt, apply):
        def apply_if_finite(g):
            grads[-1].append((opt, [None if t is None else t.clone()
                                    for t in g]))
            return apply(g)
        return apply_if_finite

    for opt, apply in zip(opts, applies):
        opt.apply_if_finite = recording(opt, apply)
    snap = step_snapshot(trainer)
    runs = []
    try:
        for i in range(2):
            if i:
                step_restore(trainer, snap)
            grads.append([])
            aux = trainer.train_step(*batch)
            runs.append(({k: t.clone() for k, t in aux.items()
                          if isinstance(t, torch.Tensor)},
                         {k: t.clone() for k, t in
                          step_state(trainer).items()}))
    finally:
        for opt in opts:
            del opt.apply_if_finite
    torch.cuda.synchronize()

    def same(a, b):
        return (a is None and b is None) or (
            a is not None and b is not None and torch.equal(a, b))

    unequal = []
    for (opt, ga), (_, gb) in zip(*grads):
        # backward order: the last parameter's gradient is formed first
        for name, a, b in reversed(list(zip(opt.names, ga, gb))):
            if not same(a, b):
                unequal.append(f"grad {name}")
    (aux_a, state_a), (aux_b, state_b) = runs
    unequal += [f"aux {k}" for k in aux_a if not same(aux_a[k], aux_b[k])]
    unequal += [k for k in state_a if not same(state_a[k], state_b[k])]
    n = sum(len(g) for _, g in grads[0]) + len(aux_a) + len(state_a)
    log(f"{label}: one step twice from the same state, {len(unequal)} of "
        f"{n} gradients, aux values and state tensors unequal"
        + (f" (first in backward order: {unequal[:4]})" if unequal else ""))
    check(not unequal, f"{label}: the step is not bit-reproducible: "
          f"{unequal[:8]}")
    return aux


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def adaattn_statistics_f64(q, k, v):
    """The dense AdaAttN statistics in float64 (autograd), returned in
    float32: the reference of the step's AdaAttN stage."""
    import torch
    from arbitrarystyletransfer_tpu_torch.ops.stats import safe_sqrt

    qd, kd, vd = q.double(), k.double(), v.double()
    attn = torch.softmax(qd @ kd.transpose(1, 2), dim=-1)
    mean = attn @ vd
    std = safe_sqrt(attn @ vd.square() - mean.square())
    return mean.float(), std.float()


def kernel_vs_twin_step(trainer, batch, variants=None, gate=True):
    """One step's loss and AdaAttN projection gradients through the kernels
    (A), through the kernel forward with the twins' backward (C), through
    the twins (B) and with the AdaAttN stage in float64 (D), from the same
    state and batch.

    The gradients are held A against C at ``STEP_GRAD_TOL`` of their max
    (this isolates the backward kernels); the loss and the gradients A
    against D at the larger of ``STEP_LOSS_TOL`` (``STEP_GRAD_TOL`` of the
    max) and ``STEP_OWN_FACTOR`` times B's distance to D.  That second
    bound follows the batch's conditioning: the backward's row term D = sum(dm1
    mean + dm2 (std^2 + mean^2)) (the JAX package's formulation) cancels
    against P (dm1 v^T + dm2 (v^2)^T) with an error of ~eps (mean / std)^2,
    so the f32 rounding of the AdaAttN stage, the twins' as the kernels',
    reaches these gradients amplified by the largest (mean / std)^2, which
    is logged.  A fixed share held the kernels to the twins' own rounding.
    Every comparison is logged before any is checked (none with ``gate``
    false).  With a discriminator, its terms (``gan_gates``) and the
    projection gradients of ``dis_lam`` times the adversarial term alone
    are held too, the latter like the step's at limits of their own size.
    ``variants`` ({name: statistics function}) adds the loss of
    the step with each as its AdaAttN stage, against D.  Returns the
    distances: {"loss": relative distance of A, "own": of B, "ratio": the
    largest (mean / std)^2, "variants": {name: relative distance},
    "failed": [what failed]}."""
    import torch
    from arbitrarystyletransfer_tpu_torch.ops.kernels import (
        LAUNCHES,
        adaattn_bwd as bwd_mod,
        adaattn_fwd as fwd_mod,
    )

    buffers = [b.clone() for b in trainer.buffers]
    names = [f"ada_att_{i}/W_{w}/kernel" for i in (1, 2) for w in "qkv"]
    index = {n: i for i, n in enumerate(trainer.opt.names)}
    ratio = []

    def fold(mean, std, dmean, dstd, v):
        ratio.append(float((mean.square() / std.square().clamp_min(
            1e-30)).max()))
        return fold_real(mean, std, dmean, dstd, v)

    def run(adversarial_only=False, **patch):
        """The step with ``patch``'s attributes of ``fwd_mod``/``bwd_mod``
        replaced.  With a discriminator, also its terms on the step's fake
        batch (``discriminator_terms``), which the last item holds; with
        ``adversarial_only``, the step's loss is ``dis_lam`` times the
        adversarial term alone (every other weight 0)."""
        mods = {name: fwd_mod if hasattr(fwd_mod, name) else bwd_mod
                for name in patch}
        saved = {name: getattr(mods[name], name) for name in patch}
        for name, fn in patch.items():
            setattr(mods[name], name, fn)
        cfg = trainer.cfg
        if adversarial_only:
            trainer.cfg = dataclasses.replace(cfg, **{
                k: 0.0 for k in ("content_lam", "style_lam", "lf_lam",
                                 "tv_lam", "hist_lam", "org_img_lam",
                                 "out_of_range_lam")})
        before = dict(LAUNCHES)
        gens = trainer.step_generators() if trainer.disc is not None else [
            None]
        try:
            loss, aux, grads = trainer.loss_and_grads(
                *batch, dis_generator=gens[0])
        finally:
            trainer.cfg = cfg
            for name, fn in saved.items():
                setattr(mods[name], name, fn)
        for b, saved_b in zip(trainer.buffers, buffers):
            b.copy_(saved_b)
        launched = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        dis = (None if trainer.disc is None or adversarial_only else
               discriminator_terms(trainer, batch[0], aux, gens))
        return float(loss.detach()), grads, launched, dis

    twin_bwd = dict(adaattn_dq=bwd_mod.adaattn_dq_reference,
                    adaattn_dkv=bwd_mod.adaattn_dkv_reference)
    fold_real = fwd_mod.fold_cotangents
    loss_a, grads_a, n_a, dis_a = run(fold_cotangents=fold)
    loss_c, grads_c, n_c, dis_c = run(**twin_bwd)
    loss_b, grads_b, n_b, dis_b = run(
        adaattn_fwd=fwd_mod.adaattn_fwd_reference, **twin_bwd)
    loss_d, grads_d, n_d, dis_d = run(
        adaattn_statistics=adaattn_statistics_f64)
    check(n_a == TRAIN_LAUNCHES, f"the kernel step launched {n_a}")
    check(n_c["adaattn_dq"] == n_c["adaattn_dkv"] == 0
          and n_c["adaattn_fwd"] == TRAIN_LAUNCHES["adaattn_fwd"],
          f"the mixed step launched {n_c}")
    check(not any(n_b.values()), f"the twin step launched {n_b}")
    check(not any(n_d.values()), f"the float64 step launched {n_d}")
    check(all(g is None or bool(torch.isfinite(g).all()) for g in grads_a),
          "a gradient of the kernel step is not finite")
    rel, own = (abs(x - loss_d) / abs(loss_d) for x in (loss_a, loss_b))
    tol_loss = max(STEP_LOSS_TOL, STEP_OWN_FACTOR * own)
    log(f"train step, kernels vs the float64 AdaAttN stage: loss {loss_a:.9g}"
        f" vs {loss_d:.9g} (relative {rel:.3g}, tol {tol_loss:.3g}; the "
        f"twins' step {loss_b:.9g}, {own:.3g} from it); kernel forward with "
        f"the twin backward: {loss_c:.9g}; max (mean / std)^2 of the "
        f"AdaAttN statistics {max(ratio):.4g}")
    dist = {"loss": rel, "own": own, "ratio": max(ratio), "variants": {}}
    for name, fn in (variants or {}).items():
        loss_v = run(adaattn_statistics=fn)[0]
        dist["variants"][name] = abs(loss_v - loss_d) / abs(loss_d)
        log(f"  loss with the AdaAttN stage {name}: {loss_v:.9g} (relative "
            f"{dist['variants'][name]:.3g} from the float64 step's)")
    failed = [] if rel <= tol_loss else ["the kernel step's loss differs"]
    failed += projection_gates(
        "grad", [[g[index[n]] for n in names]
                 for g in (grads_a, grads_b, grads_c, grads_d)], names)
    if dis_a is not None:
        failed += gan_gates(dis_a, dis_b, dis_c, dis_d)
        # The adversarial term alone (every other weight 0): its share of
        # the gradients above is far below their limits, so it is held to
        # limits of its own size here.
        adv = [run(adversarial_only=True, **patch) for patch in (
            dict(), dict(adaattn_fwd=fwd_mod.adaattn_fwd_reference,
                         **twin_bwd),
            twin_bwd, dict(adaattn_statistics=adaattn_statistics_f64))]
        check(adv[0][2] == TRAIN_LAUNCHES,
              f"the adversarial-only kernel step launched {adv[0][2]}")
        grads = [[g[index[n]] for n in names] for _, g, _, _ in adv]
        missing = [n for n, g in zip(names, grads[0])
                   if g is None or not bool((g != 0).any())]
        if missing:
            failed.append("the adversarial cotangent does not reach "
                          f"{missing}")
        else:
            failed += projection_gates("adversarial grad", grads, names)
    dist["failed"] = failed
    if gate:
        check(not failed, "; ".join(failed))
    return dist


def bf16_step_case(trainer, batch):
    """The train step at bf16 (``ModelConfig(compute_dtype="bfloat16")``,
    the trainer's state) through the kernels (A) and through the twins (B),
    and the f32 kernel step (F) on the same state and batch, each on a fresh
    copy of the AST: A must launch the f32 step's kernels, and its loss and
    AdaAttN projection gradients lie within TRAIN_BF16_FACTOR times B's
    distance to F (floored at the f32 gate's tolerances).  The CPU tests
    hold the bf16 step to JAX's (tests/test_torch_train_step.py)."""
    import torch
    from arbitrarystyletransfer_tpu_torch import ModelConfig, weights
    from arbitrarystyletransfer_tpu_torch.models.ast import AST
    from arbitrarystyletransfer_tpu_torch.ops.kernels import (
        LAUNCHES,
        adaattn_bwd as bwd_mod,
        adaattn_fwd as fwd_mod,
    )
    from arbitrarystyletransfer_tpu_torch.train.ast_trainer import ast_loss

    state = weights.module_state(trainer.ast)
    names = [f"ada_att_{i}.W_{w}.kernel" for i in (1, 2) for w in "qkv"]
    twins = dict(adaattn_fwd=fwd_mod.adaattn_fwd_reference,
                 adaattn_dq=bwd_mod.adaattn_dq_reference,
                 adaattn_dkv=bwd_mod.adaattn_dkv_reference)

    def run(dtype, **patch):
        ast = AST(ModelConfig(use_pallas_adaattn=True,
                              compute_dtype=dtype)).to(DEVICE)
        weights.load_state(ast, state)
        mods = {n: fwd_mod if hasattr(fwd_mod, n) else bwd_mod
                for n in patch}
        saved = {n: getattr(mods[n], n) for n in patch}
        for n, fn in patch.items():
            setattr(mods[n], n, fn)
        before = dict(LAUNCHES)
        try:
            total, aux = ast_loss(ast, trainer.vgg, trainer.cfg, *batch)
            params = dict(ast.named_parameters())
            grads = torch.autograd.grad(total, [params[n] for n in names])
        finally:
            for n, fn in saved.items():
                setattr(mods[n], n, fn)
        launched = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        log(f"  {dtype}{' twins' if patch else ''}: " + ", ".join(
            f"{k} {float(v):.6g}" for k, v in aux.items() if v.numel() == 1))
        return float(total.detach()), grads, launched

    loss_a, grads_a, n_a = run("bfloat16")
    loss_b, grads_b, n_b = run("bfloat16", **twins)
    loss_f, grads_f, _ = run("float32")
    check(n_a == TRAIN_LAUNCHES, f"the bf16 kernel step launched {n_a}")
    check(not any(n_b.values()), f"the bf16 twin step launched {n_b}")
    check(math.isfinite(loss_a) and all(bool(torch.isfinite(g).all())
                                        for g in grads_a),
          "the bf16 kernel step is not finite")
    failed = []
    rel, own = (abs(x - loss_f) / abs(loss_f) for x in (loss_a, loss_b))
    tol = max(STEP_LOSS_TOL, TRAIN_BF16_FACTOR * own)
    log(f"train step bf16: loss {loss_a:.9g}, {rel:.4g} from the f32 step's "
        f"{loss_f:.9g} (tol {tol:.4g}; the bf16 twins' {loss_b:.9g}, "
        f"{own:.4g} from it)")
    if rel > tol:
        failed.append("the bf16 kernel step's loss")
    for name, ga, gb, gf in zip(names, grads_a, grads_b, grads_f):
        scale = float(gf.abs().max())
        err, own = max_err(ga, gf), max_err(gb, gf)
        tol = max(STEP_GRAD_TOL * scale, TRAIN_BF16_FACTOR * own)
        log(f"  bf16 grad {name}: kernels {err:.4g} from the f32 step "
            f"(tol {tol:.4g}; the twins' {own:.4g}, max |g| {scale:.4g})")
        if err > tol:
            failed.append(f"the bf16 kernel step's gradient of {name}")
    check(not failed, "; ".join(failed))


# The figures of the last ``projection_gates`` calls, for the standing
# batches' JSON lines (exact values: a step repeats bit for bit, so two
# runs of the script print the same).
GATE_FIGURES = []


def projection_gates(label, grads, names):
    """``kernel_vs_twin_step``'s gates on the AdaAttN projection gradients
    ``grads`` (four lists over ``names``: A kernels, B twins, C kernel
    forward with the twins' backward, D the float64 AdaAttN stage): A
    against C at ``STEP_GRAD_TOL`` of C's max, A against D at the larger of
    ``STEP_GRAD_TOL`` of D's max and ``STEP_OWN_FACTOR`` times B's distance
    to D.  Logs each; returns what failed."""
    failed = []
    for name, ga, gb, gc, gd in zip(names, *grads):
        err, err_d, own = max_err(ga, gc), max_err(ga, gd), max_err(gb, gd)
        tol = STEP_GRAD_TOL * float(gc.abs().max())
        tol_d = max(STEP_GRAD_TOL * float(gd.abs().max()),
                    STEP_OWN_FACTOR * own)
        GATE_FIGURES.append({"grad": f"{label} {name}", "a_vs_c": err,
                             "tol": tol, "a_vs_d": err_d, "tol_d": tol_d})
        log(f"  {label} {name}: kernels vs twin backward max abs err "
            f"{err:.4g} (tol {tol:.4g}); vs the float64 step {err_d:.4g} "
            f"(tol {tol_d:.4g}; the twins' step {own:.4g} from it, the "
            f"kernels' {max_err(ga, gb):.4g} from the twins'); max |g| "
            f"{float(gc.abs().max()):.4g}")
        if err > tol:
            failed.append(f"the kernel step's {label} of {name} differs")
        if err_d > tol_d:
            failed.append(f"the kernel step's {label} of {name} differs "
                          "from the float64 step's")
    return failed


def discriminator_terms(trainer, content, aux, gens):
    """The discriminator's loss and gradients at the trainer's next
    discriminator step on the fake batch of ``aux`` (``loss_and_grads``'s),
    its BatchNorm buffers put back: {"gen_adv_loss", "dis_loss" (floats),
    "grads"}."""
    import torch
    from arbitrarystyletransfer_tpu_torch.train import gan

    saved = [b.clone() for b in trainer.dis_buffers]
    total, dis_aux = gan.discriminator_loss_terms(
        trainer.disc, trainer.cfg, trainer._batch(content), aux["fake"],
        gens[1], gens[2], trainer.host_dis_step)
    grads = torch.autograd.grad(total, trainer.dis_opt.params)
    with torch.no_grad():
        torch._foreach_copy_(trainer.dis_buffers, saved)
    return {"gen_adv_loss": float(aux["gen_adv_loss"]),
            "dis_loss": float(dis_aux["dis_loss"]), "grads": grads}


def gan_gates(dis_a, dis_b, dis_c, dis_d):
    """``kernel_vs_twin_step``'s gates on the GAN terms of its four steps
    (A kernels, B twins, C kernel forward with the twins' backward, D the
    float64 AdaAttN stage): gen_adv_loss and dis_loss A against D at the
    larger of ``STEP_LOSS_TOL`` and ``STEP_OWN_FACTOR`` times B's distance
    to D; each of the discriminator's gradients A against C at
    ``STEP_GRAD_TOL`` of its max (C's fake batch is A's: the same forward)
    and A against D at the larger of ``STEP_GRAD_TOL`` of the max and
    ``STEP_OWN_FACTOR`` times B's distance.  Logs the worst share of each
    limit; returns what failed."""
    failed = []
    for key in ("gen_adv_loss", "dis_loss"):
        a, b, d = dis_a[key], dis_b[key], dis_d[key]
        rel, own = (abs(x - d) / max(abs(d), 1e-30) for x in (a, b))
        tol = max(STEP_LOSS_TOL, STEP_OWN_FACTOR * own)
        log(f"  {key}: kernels {a:.9g} vs the float64 step {d:.9g} "
            f"(relative {rel:.3g}, tol {tol:.3g}; the twins' {b:.9g}, "
            f"{own:.3g} from it)")
        if rel > tol:
            failed.append(f"the kernel step's {key} differs")
    worst_c = worst_d = 0.0
    for ga, gb, gc, gd in zip(dis_a["grads"], dis_b["grads"],
                              dis_c["grads"], dis_d["grads"]):
        tol = STEP_GRAD_TOL * max(float(gc.abs().max()), 1e-30)
        tol_d = max(STEP_GRAD_TOL * float(gd.abs().max()),
                    STEP_OWN_FACTOR * max_err(gb, gd), 1e-30)
        worst_c = max(worst_c, max_err(ga, gc) / tol)
        worst_d = max(worst_d, max_err(ga, gd) / tol_d)
    log(f"  discriminator gradients ({len(dis_a['grads'])} tensors): worst "
        f"share of the limit, kernels vs the twin backward {worst_c:.3g}, "
        f"vs the float64 step {worst_d:.3g}")
    if worst_c > 1:
        failed.append("the kernel step's discriminator gradients differ "
                      "from the twin backward's")
    if worst_d > 1:
        failed.append("the kernel step's discriminator gradients differ "
                      "from the float64 step's")
    return failed


def profile_train_step(trainer, batch, top=12, label="train"):
    """Device time of one step by phase (CUDA events at the trainer's
    marks) and by kernel (torch.profiler), with the AdaAttN kernels'
    share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        mark("start")
        trainer.train_step(*batch, mark=mark)
        torch.cuda.synchronize()
    wall = marks[0][1].elapsed_time(marks[-1][1])
    phases = ", ".join(f"{name} {a.elapsed_time(b):.3f} ms"
                       for (_, a), (name, b) in zip(marks, marks[1:]))
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1000
    att = sum(e.self_device_time_total for e in events
              if "adaattn" in e.key) / 1000
    log(f"{label} profile of one step: {wall:.3f} ms (CUDA events, profiler "
        f"on): {phases}; {busy:.3f} ms of device kernels ({busy / wall:.1%} "
        f"busy), AdaAttN kernels {att:.3f} ms ({att / max(busy, 1e-9):.1%} of device "
        f"time), {len(events)} distinct kernels")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"  {e.self_device_time_total / 1000:9.3f} ms  x{e.count:<4d} "
            f"{e.key[:90]}")
    ops = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CPU
           and e.self_device_time_total > 0]
    log(f"{label} step by op (self device time):")
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"  {e.self_device_time_total / 1000:9.3f} ms  x{e.count:<4d} "
            f"{e.key[:90]}")


def write_images(root, seed):
    """LIFE_IMAGES content and LIFE_IMAGES // 2 style PNGs (gradients, a
    random sinusoid texture and noise, 300-640px a side) under ``root``;
    returns the two folders."""
    import os

    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    dirs = []
    for sub, n in (("content", LIFE_IMAGES), ("style", LIFE_IMAGES // 2)):
        d = os.path.join(root, sub)
        os.makedirs(d)
        for i in range(n):
            h, w = rng.integers(300, 641, 2)
            yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
            f = rng.uniform(2, 30, 3)
            img = np.stack([
                rng.uniform(0.2, 0.8) * xx + (1 - xx) * rng.uniform(),
                0.5 + 0.4 * np.sin(f[0] * xx * 6.28 + f[1] * yy),
                rng.uniform(0, 1, (h, w)) * rng.uniform(0.2, 1.0)], -1)
            img = np.clip(img + rng.normal(0, 0.05, img.shape), 0, 1)
            Image.fromarray((img * 255).astype(np.uint8)).save(
                os.path.join(d, f"img_{i}.png"))
        dirs.append(d)
    return dirs


def ae_state(state):
    """The autoencoder's tree of an AST state: its encoder, ada_out and
    decoder."""
    p, s = state["params"], state["batch_stats"]
    return {"params": {"encoder": p["enc"], "ada_out": p["ada_out"],
                       "decoder": p["dec"]},
            "batch_stats": {"encoder": s["enc"]}}


def seeded_order(dataset, seed):
    """``dataset`` with its image lists in an order set by ``seed`` alone:
    the loaders shuffle the directory listing, whose order is the file
    system's."""
    for name in ("content_paths", "style_paths"):
        if hasattr(dataset, name):
            paths = sorted(getattr(dataset, name))
            random.Random(seed).shuffle(paths)
            setattr(dataset, name, paths)
    return dataset


def ae_loss_copy(trainer, batch, dtype, rows=None):
    """The loss of ``trainer``'s step on ``batch`` (its ``rows`` in that
    order, default as they are) through ``dtype`` copies of the model and
    VGG (the model's float32 casts keep float64)."""
    import copy

    import torch
    from arbitrarystyletransfer_tpu_torch.train.ae_trainer import ae_loss

    model = copy.deepcopy(trainer.model).to(dtype)
    vgg = copy.deepcopy(trainer.vgg).to(dtype)
    x = torch.as_tensor(batch, dtype=dtype, device=DEVICE)
    if rows is not None:
        x = x[list(rows)]
    with torch.no_grad():
        total, aux = ae_loss(model, vgg, trainer.cfg, x)
    check(all(a.dtype == dtype for a in aux.values()),
          f"the {dtype} loss ran in {[a.dtype for a in aux.values()]}")
    return float(total)


def timed_steps(trainer):
    """Wraps ``trainer.train_step`` to record each step's device ms (CUDA
    events, synchronized), its aux and the launches it made."""
    import torch
    from arbitrarystyletransfer_tpu_torch.ops.kernels import LAUNCHES

    step, record = trainer.train_step, {"ms": [], "aux": [], "launches": []}

    def timed(*batch):
        before = dict(LAUNCHES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        aux = step(*batch)
        end.record()
        torch.cuda.synchronize()
        record["ms"].append(start.elapsed_time(end))
        record["aux"].append(aux)
        record["launches"].append({k: LAUNCHES[k] - before[k]
                                   for k in LAUNCHES})
        return aux

    trainer.train_step = timed
    return record


def life_ae(tmp, dirs):
    """Stage 1: AutoencoderTrainer, LIFE_AE_STEPS steps through
    ``ContentBatchLoader``; its first step's loss against the float64 step.
    Returns ``ae.pt``'s path and the median ms per step."""
    import itertools

    import torch
    from arbitrarystyletransfer_tpu_torch import ModelConfig, weights
    from arbitrarystyletransfer_tpu_torch.config import AETrainConfig
    from arbitrarystyletransfer_tpu_torch.data.pipeline import (
        ContentBatchLoader,
        FlatFolderDatasetAE,
    )
    from arbitrarystyletransfer_tpu_torch.train.ae_trainer import (
        AutoencoderTrainer,
    )

    cfg = AETrainConfig(train_iter=LIFE_AE_STEPS, batch_size=LIFE_AE_BATCH,
                        ae_imsize=LIFE_AE_SIZE, save_dir=f"{tmp}/ae")
    loader = ContentBatchLoader(
        seeded_order(FlatFolderDatasetAE(dirs), SEED),
        batch_size=cfg.batch_size,
        imsize=cfg.ae_imsize, num_workers=LIFE_WORKERS, seed=SEED,
        augment=False,
        worker_mode="thread")
    try:
        first = next(loader)
        trainer = AutoencoderTrainer(cfg, itertools.chain([first], loader),
                                     seed=SEED, device=DEVICE, log_fn=log)
        check(trainer.vgg_weights_path is None,
              f"a VGG weight file was used: {trainer.vgg_weights_path}")
        # The parity tests' weights (``random_state``): at the reference
        # initialization the encoder's eval-stats drift is unbounded, so
        # no recalibration could serve it, and the closed SE gates make the
        # decoder's image a constant that hides every difference.
        weights.load_state(trainer.model,
                           ae_state(random_state(ModelConfig(), SEED)))
        t0 = time.perf_counter()
        loss64 = ae_loss_copy(trainer, first, torch.float64)
        spread = max(abs(ae_loss_copy(trainer, first, torch.float32, rows)
                         - loss64) / abs(loss64)
                     for rows in dp_orders(len(first)))
        f64_s = time.perf_counter() - t0
        f64_gib = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        record = timed_steps(trainer)
        trainer.train(log_fn=log)
        steps_gib = torch.cuda.max_memory_allocated() / 2**30
    finally:
        loader.close()
    losses = [float(a["loss"]) for a in record["aux"]]
    check(len(losses) == LIFE_AE_STEPS and all(map(math.isfinite, losses)),
          f"AE losses {losses}")
    rel = abs(losses[0] - loss64) / abs(loss64)
    tol = max(AE_LOSS_TOL, AE_ORDER_FACTOR * spread)
    check(rel <= tol, f"AE step 1 loss {losses[0]} vs float64 {loss64}: "
          f"{rel:.3g} relative, limit {tol:.3g}")
    check(int(trainer.step) == LIFE_AE_STEPS and all(
        n == counts() for n in record["launches"]),
        f"AE step {int(trainer.step)}, launches {record['launches']}")
    # The first batch's step taken twice from the state the run ended in:
    # the same bits; then that state back (``ae.pt`` is written).  The
    # first step of a process at a shape may take other cuDNN algorithms
    # than the later ones (PERF.md §7), so the pair follows the run.
    del trainer.train_step  # timed_steps' wrapper
    snap = step_snapshot(trainer)
    repeat_step("lifecycle AE", trainer, first)
    step_restore(trainer, snap)
    del snap
    ms = statistics.median(record["ms"][1:])
    log(f"lifecycle AE {LIFE_AE_SIZE}px batch {LIFE_AE_BATCH} f32: step ms "
        f"{[round(t, 3) for t in record['ms']]}, median of steps 2-"
        f"{LIFE_AE_STEPS} {ms:.3f} ms; losses {losses}; step 1 loss vs "
        f"float64 {loss64:.9g}: {rel:.3g} relative (tol {tol:.3g}: "
        f"{AE_ORDER_FACTOR} x the float32 loss's spread over "
        f"{len(dp_orders(len(first)))} row orders, {spread:.3g}, floored at "
        f"{AE_LOSS_TOL}); "
        f"peak memory {steps_gib:.2f} GiB in the steps, {f64_gib:.2f} GiB in "
        f"the float64 loss ({f64_s:.1f} s)")
    return trainer.save_file, ms


def life_ast(tmp, dirs, ae_path):
    """Stage 2: ASTTrainer warm-started from ``ae_path``, LIFE_AST_STEPS
    steps through ``PairedBatchLoader``.  Returns ``ast.pt``'s path and the
    launches of its steps."""
    import torch
    from arbitrarystyletransfer_tpu_torch import ModelConfig, weights
    from arbitrarystyletransfer_tpu_torch.config import ASTTrainConfig
    from arbitrarystyletransfer_tpu_torch.data.pipeline import (
        FlatFolderDataset,
        PairedBatchLoader,
    )
    from arbitrarystyletransfer_tpu_torch.ops.kernels import (
        LAUNCHES,
        reset_launches,
    )
    from arbitrarystyletransfer_tpu_torch.train import checkpoint as ckpt
    from arbitrarystyletransfer_tpu_torch.train.ast_trainer import ASTTrainer

    tcfg = ASTTrainConfig(train_iter=LIFE_AST_STEPS,
                          batch_size=LIFE_AST_BATCH, save_dir=f"{tmp}/ast",
                          ae_model=ae_path.removesuffix(".pt"))
    model_cfg = ModelConfig(use_pallas_adaattn=True)
    loader = PairedBatchLoader(
        seeded_order(FlatFolderDataset([dirs[0]], [dirs[1]]), SEED),
        LIFE_AST_BATCH,
        img_sizes=(LIFE_AST_SIZE,), num_workers=LIFE_WORKERS, seed=SEED,
        worker_mode="thread")
    try:
        trainer = ASTTrainer(tcfg, loader, model_cfg=model_cfg, seed=SEED,
                             preview_dir=None, device=DEVICE, log_fn=log)
        ae = weights.flatten(ckpt.restore_checkpoint(ae_path, DEVICE))
        ast = weights.flatten(weights.module_state(trainer.ast))
        names = {"encoder": "enc", "ada_out": "ada_out", "decoder": "dec"}

        def ast_key(key):
            collection, tree, rest = key.split("/", 2)
            return f"{collection}/{names[tree]}/{rest}"

        check(all(torch.equal(t, ast[ast_key(k)]) for k, t in ae.items()),
              "the AST's enc, ada_out and dec are not the AE's tensors")
        # The AdaAttN projections at the parity tests' scale (q and k gain
        # 0.35: logits of std ~1.4), as the train phase has them: with the
        # reference init the logits' std is ~11 and the std statistic is
        # rounding noise in the twins and the kernels alike.
        own = random_state(model_cfg, SEED)["params"]
        with torch.no_grad():
            for name in ("ada_att_1", "ada_att_2"):
                for w in ("W_q", "W_k", "W_v"):
                    getattr(getattr(trainer.ast, name), w).kernel.copy_(
                        own[name][w]["kernel"])
        record = timed_steps(trainer)
        reset_launches()
        trainer.train(log_fn=log)
        launches = dict(LAUNCHES)
    finally:
        loader.close()
    losses = [float(a["loss"]) for a in record["aux"]]
    check(all(map(math.isfinite, losses)), f"AST losses {losses}")
    for i, n in enumerate(record["launches"]):
        check(n == TRAIN_LAUNCHES, f"warm-started AST step {i + 1} launched "
              f"{n}, expected {TRAIN_LAUNCHES}")
    check(int(trainer.step) == LIFE_AST_STEPS,
          f"AST step counter {int(trainer.step)}")
    log(f"lifecycle AST warm-started from {len(ae)} AE tensors (equal bit "
        f"for bit), {LIFE_AST_SIZE}px batch {LIFE_AST_BATCH}: step ms "
        f"{[round(t, 3) for t in record['ms']]}, losses {losses}, launches "
        f"per step {record['launches'][0]}")
    return trainer.save_file, launches


def run_requests(pipe, requests, expected, label):
    """``pipe.stylize`` over ``requests`` with the counters reset just
    before and read just after: (outputs, ms each, launches)."""
    import torch
    from arbitrarystyletransfer_tpu_torch.ops.kernels import (
        LAUNCHES,
        reset_launches,
    )

    outs, times = [], []
    reset_launches()
    for i, (content, style, alpha) in enumerate(requests):
        before = dict(LAUNCHES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = pipe.stylize(content, style, alpha)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        n = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        sat = float(((out == 0) | (out == 1)).float().mean())
        log(f"{label} request {i + 1}: alpha {alpha}, {times[-1]:.3f} ms, "
            f"launches {n}, mean {float(out.mean()):.4f} std "
            f"{float(out.std()):.4f}, saturated {sat:.4%}")
        check(tuple(out.shape) == (BATCH, SIZE, SIZE, 3),
              f"{label}: output shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), f"{label}: non-finite output")
        check(sat < 0.5, f"{label}: {sat:.1%} of the output is 0 or 1")
        check(n == expected, f"{label} request {i + 1} launched {n}, "
              f"expected {expected}")
        outs.append(out)
    return outs, times, dict(LAUNCHES)


def image_errs(a, b):
    d = (a.float() - b.float()).abs()
    return float(d.max()), float(d.mean())


def life_graph(ast_path, requests):
    """Serve ``ast_path`` through the graph engine (f32, the AdaAttN
    kernel), held against the same pipeline with the AdaAttN stage in plain
    PyTorch.  Returns the launches and the median ms per request."""
    import torch
    from arbitrarystyletransfer_tpu_torch import ModelConfig
    from arbitrarystyletransfer_tpu_torch.infer import StylePipeline
    from arbitrarystyletransfer_tpu_torch.ops.kernels import LAUNCHES
    from arbitrarystyletransfer_tpu_torch.ops.kernels import (
        adaattn_fwd as fwd_mod,
    )

    cfg = ModelConfig(use_pallas_adaattn=True)
    pipe = StylePipeline.from_checkpoint(ast_path.removesuffix(".pt"), cfg,
                                         device=DEVICE)
    check(pipe.engine == "flax" and not pipe.cfg.encoder_eval_stats,
          f"engine {pipe.engine}, {pipe.cfg}")
    normalize_train_head(pipe, requests[0][:2])
    forms = f32_forms()
    outs, times, launches = run_requests(pipe, requests, GRAPH_LAUNCHES,
                                         "lifecycle flax")
    check_forms(forms, "serve", len(requests) * GRAPH_LAUNCHES["adaattn_fwd"],
                "lifecycle flax")
    served_again("lifecycle flax", pipe, requests[0], outs[0])
    # Served at f32 the statistics take the serving form (3xTF32, no more
    # than twice the f32 twin's distance to float64: the adaattn_fwd
    # phase), held here to the same pipeline with the AdaAttN stage in
    # float64, rounded (adaattn_statistics_f64), at the f32 image gate.
    # The dense float32 twin's distance to it is logged: this checkpoint's
    # decoder amplifies the twin's own rounding.
    saved = fwd_mod.adaattn_statistics
    fwd_mod.adaattn_statistics = adaattn_statistics_f64
    try:
        plain = pipe.stylize(*requests[0])
    finally:
        fwd_mod.adaattn_statistics = saved
    dense = StylePipeline(dataclasses.replace(cfg, use_pallas_adaattn=False),
                          device=DEVICE, state=pipe.state).stylize(
                              *requests[0])
    check(dict(LAUNCHES) == launches, "the plain versions launched a kernel")
    err, own = image_errs(outs[0], plain), image_errs(dense, plain)
    log(f"lifecycle flax request 1, f32, kernel vs the float64 AdaAttN "
        f"stage: max abs {err[0]:.4g} (tol {IMAGE_F32_TOL[0]}), mean abs "
        f"{err[1]:.4g} (tol {IMAGE_F32_TOL[1]}); the dense float32 twin vs "
        f"the same: max abs {own[0]:.4g}, mean abs {own[1]:.4g}")
    check(err[0] <= IMAGE_F32_TOL[0] and err[1] <= IMAGE_F32_TOL[1],
          "graph engine: the AdaAttN kernel and its plain version disagree")
    ms = statistics.median(times[1:])
    log(f"lifecycle flax: median {ms:.3f} ms/request over requests 2-"
        f"{len(requests)} ({BATCH * 1000 / ms:.2f} img/s at {SIZE}px batch "
        f"{BATCH}, f32)")
    del plain, dense
    torch.cuda.empty_cache()
    return launches, ms


def folding_gaps(state, cfg, content, style, dtype):
    """The graph engine against the fused engine's plain route (BatchNorm
    folded), both in ``dtype``, as relative distances: stage by stage on
    the same inputs ("encoder": the taps of both images; "attend": the
    AdaAttN pair and the ada_out fuse on the graph's taps; "decoder": the
    unclamped image from the graph's fused map), then the whole unclamped
    alpha-1 image ("image"), and the graph image's own response to a
    one-ulp relative perturbation of its taps ("ulp")."""
    import torch
    from arbitrarystyletransfer_tpu_torch import engine, weights
    from arbitrarystyletransfer_tpu_torch.models.ast import AST
    from arbitrarystyletransfer_tpu_torch.ops.fused_block import (
        block_apply,
        decode_fused,
        encode_fused,
    )

    def rel(out, ref):
        out, ref = out.double(), ref.double()
        check(bool(torch.isfinite(out).all()),
              f"folding_gaps {dtype}: a folded output is not finite")
        return float((out - ref).norm() / ref.norm())

    cfg = dataclasses.replace(cfg, compute_dtype="float32",
                              use_pallas_adaattn=False)
    ast = AST(cfg).to(DEVICE, dtype).requires_grad_(False)
    weights.load_state(ast, state)
    tree = weights.module_state(ast)
    params, stats = tree["params"], tree["batch_stats"]
    c, s = content.to(dtype), style.to(dtype)
    b, ubs, plain = c.shape[0], not cfg.encoder_eval_stats, 10**9
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)

    def ulp(maps):
        eps = torch.finfo(dtype).eps
        return [m * (1 + eps * (2 * torch.rand(
            m.shape, generator=gen, device=DEVICE, dtype=dtype) - 1))
            for m in maps]

    gaps = {}
    with torch.inference_mode():
        cm, sm = ast._taps(c, False, ubs), ast._taps(s, False, ubs)
        # No block reaches min_fused_size: every block takes the plain
        # route.
        both = encode_fused(params["enc"], stats["enc"], torch.cat([c, s]),
                            cfg.enc_conv_shapes, cfg.enc_out_layers,
                            expand_ratio=cfg.expand_ratio, dtype=dtype,
                            min_fused_size=plain)
        gaps["encoder"] = max(rel(m, torch.cat([g, h]))
                              for m, g, h in zip(both, cm, sm))
        t = ast._attend(cm, sm)[2]
        sm1, sm2 = engine.adaattn_apply_pair(
            params["ada_att_1"], params["ada_att_2"], cm, sm,
            use_kernel=False, dtype=dtype)
        gaps["attend"] = rel(block_apply(
            params["ada_out"], torch.cat([sm1, sm2], dim=-1), 3,
            cfg.expand_ratio, use_identity=False, dtype=dtype,
            min_fused_size=plain), t)
        graph = ast.dec(t)
        gaps["decoder"] = rel(decode_fused(
            params["dec"], t, cfg.decoder_conv_shapes, exporting=False,
            dtype=dtype, min_fused_size=plain), graph)
        gaps["image"] = rel(engine.stylize_fused(
            tree, c, s, 1.0, cfg=cfg, dtype=dtype, min_fused_size=plain,
            exporting=False), graph)
        gaps["ulp"] = rel(ast.dec(ast._attend(ulp(cm), ulp(sm))[2]), graph)
    return gaps


def shadowed(pipe, content, style, alpha):
    """``pipe.stylize`` (bf16) with each kernel wrapper of the path
    shadowed by its plain twin: every launch's outputs are held against the
    twin's on the same inputs, at the bf16 kernel phases' limits (y or
    hidden one bf16 ulp of the largest value, the SE sums ``SUMS_TOL`` of
    theirs, the AdaAttN statistics within ``adaattn_fwd_error_bound``).
    Returns {kernel: (launches, largest error / limit)}."""
    import torch
    from arbitrarystyletransfer_tpu_torch.ops import (
        flatblock,
        flatblock_s2,
        fused_block,
    )
    from arbitrarystyletransfer_tpu_torch.ops.kernels import (
        adaattn_fwd as adaattn_mod,
        expand_dw as expand_mod,
        flat_block as flat_mod,
        flat_s2 as flat_s2_mod,
    )

    seen = {}

    def share(o, r, rel):
        return max_err(o, r) / (rel * float(r.float().abs().max()) + 1e-30)

    def block_share(out, ref):
        return max(share(out[0], ref[0], BF16_TOL),
                   share(out[1], ref[1], SUMS_TOL))

    def adaattn_share(out, ref, q, k, v):
        bounds = adaattn_mod.adaattn_fwd_error_bound(q, k, v)
        return max(float(((o.float() - r.float()).abs() / b).max())
                   for o, r, b in zip(out, ref, bounds))

    slots = (
        ("expand_dw", fused_block, "expand_dw", expand_mod.expand_dw_reference,
         block_share),
        ("adaattn_fwd", adaattn_mod, "adaattn_statistics",
         lambda q, k, v: adaattn_mod.adaattn_fwd_reference(q, k, v)[:2],
         None),
        ("flat_block", flatblock, "flat_block", flat_mod.flat_block_reference,
         block_share),
        ("flat_s2_block", flatblock_s2, "flat_s2_block",
         flat_s2_mod.flat_s2_block_reference, block_share),
    )

    def shadow(name, kernel, twin, judge):
        def run(*args, **kw):
            out = kernel(*args, **kw)
            ref = twin(*args, **kw)
            e = (adaattn_share(out, ref, *args) if judge is None
                 else judge(out, ref))
            n, worst = seen.get(name, (0, 0.0))
            seen[name] = (n + 1, max(worst, e))
            return out
        return run

    check(pipe.dtype == torch.bfloat16, f"shadowed at {pipe.dtype}")
    saved = [(mod, attr, getattr(mod, attr)) for _, mod, attr, _, _ in slots]
    for (name, mod, attr, twin, judge), (_, _, kernel) in zip(slots, saved):
        setattr(mod, attr, shadow(name, kernel, twin, judge))
    try:
        pipe.stylize(content, style, alpha)
    finally:
        for mod, attr, kernel in saved:
            setattr(mod, attr, kernel)
    return seen


def life_fused(ast_path, dirs, requests):
    """Serve ``ast_path`` recalibrated through the fused engine's "auto"
    route (bf16): the folding held in float64 against the graph engine,
    each launch against its plain twin, and the image against the plain
    twins and the graph engine.  Returns the launches, the drift and the
    seconds recalibration took."""
    import warnings

    import torch
    from arbitrarystyletransfer_tpu_torch import ModelConfig, weights
    from arbitrarystyletransfer_tpu_torch.data.pipeline import (
        ContentBatchLoader,
        FlatFolderDatasetAE,
    )
    from arbitrarystyletransfer_tpu_torch.infer import StylePipeline
    from arbitrarystyletransfer_tpu_torch.train import checkpoint as ckpt
    from arbitrarystyletransfer_tpu_torch.train import recalibrate as recal

    # The CLI's loader (stylize.py: seed 0, no augmentation), on one thread.
    loader = ContentBatchLoader(seeded_order(FlatFolderDatasetAE(dirs), 0),
                                batch_size=8, imsize=RECAL_SIZE,
                                num_workers=LIFE_WORKERS, seed=0,
                                augment=False, worker_mode="thread")
    try:
        batches = [next(loader) for _ in range(RECAL_BATCHES)]
    finally:
        loader.close()

    # The drift from_checkpoint will measure (its split: the last two
    # batches held out), to decide allow_unstable before the call; and the
    # reference initialization's, for the record.
    def drift_of(state):
        enc = weights.to_device({"params": state["params"],
                                 "batch_stats": state["batch_stats"]},
                                DEVICE)
        stats = recal.recalibrate_encoder_stats(
            enc["params"]["enc"], enc["batch_stats"]["enc"], batches[:-2])
        return recal.eval_stats_drift(enc["params"]["enc"], stats,
                                      batches[-2:])

    drift = drift_of(ckpt.restore_checkpoint(ast_path))
    ref_drift = drift_of(weights.init_params(
        ModelConfig(), torch.Generator().manual_seed(SEED)))
    allow = not math.isfinite(drift)
    cfg = ModelConfig(use_pallas_adaattn=True, compute_dtype="bfloat16")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        pipe = StylePipeline.from_checkpoint(
            ast_path.removesuffix(".pt"), cfg, engine="fused",
            encoder_impl="auto", decoder_impl="auto",
            recalibrate_with=batches, allow_unstable=allow, device=DEVICE)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    warned = [str(w.message) for w in caught if "drifts" in str(w.message)]
    check(bool(warned) == (allow or drift > recal.EVAL_DRIFT_SAFE),
          f"drift {drift}: warnings {warned}")
    check(pipe.engine == "fused" and pipe.cfg.encoder_eval_stats,
          f"recalibrated pipeline: {pipe.engine}, {pipe.cfg}")
    log(f"lifecycle recalibration: {RECAL_BATCHES} batches of 8 at "
        f"{RECAL_SIZE}px (last 2 held out), from_checkpoint {seconds:.3f} s; "
        f"drift {drift!r} (EVAL_DRIFT_SAFE {recal.EVAL_DRIFT_SAFE}): "
        + ("not finite, served with allow_unstable=True" if allow else
           "finite, allow_unstable not passed")
        + f", {'warned' if warned else 'no warning'}, not refused; the "
        f"reference initialization's drift on the same batches "
        f"{ref_drift!r}")

    # The folding, in float64 and float32, on the recalibrated state with
    # the checkpoint's head: each stage on the same inputs in float64 within
    # FOLD_F64_TOL; the whole image's distance is the state's amplification
    # of the encoder's rounding, and is logged beside its response to one
    # ulp on the taps.
    content, style = requests[0][:2]
    gaps64, gaps32 = (folding_gaps(pipe.state, pipe.cfg, content, style, dt)
                      for dt in (torch.float64, torch.float32))
    log(f"lifecycle recalibrated state, graph engine vs the fused engine's "
        f"plain route, relative: float64 {gaps64}, float32 {gaps32} (tol "
        f"{FOLD_F64_TOL} on the float64 encoder, attend and decoder)")
    for stage in ("encoder", "attend", "decoder"):
        check(gaps64[stage] <= FOLD_F64_TOL, f"the folded and unfolded "
              f"{stage} disagree in float64: {gaps64[stage]}")

    # The head normalized on the graph engine's f32 image (as routes_phase
    # does), then the route's requests, counted.
    cfg32 = dataclasses.replace(pipe.cfg, compute_dtype="float32")
    graph = StylePipeline(cfg32, device=DEVICE, state=pipe.state)
    normalize_train_head(graph, requests[0][:2])
    pipe.load_state(graph.state["params"], graph.state["batch_stats"])
    expected = route_launches("auto")
    outs, times, launches = run_requests(
        pipe, requests[:LIFE_FUSED_REQUESTS], expected,
        "lifecycle recalibrated-auto")

    # Request 1 again, each launch held to its twin on the same inputs.
    seen = shadowed(pipe, *requests[0])
    log(f"lifecycle recalibrated-auto request 1, each launch vs its plain "
        f"twin on the same inputs (launches, largest error / limit): {seen}")
    check({k: n for k, (n, _) in seen.items()}
          == {k: n for k, n in expected.items() if n},
          f"recalibrated auto route: shadowed launches {seen}")
    check(all(e <= 1.0 for _, e in seen.values()),
          "recalibrated auto route: a launch differs from its twin")

    # The image at bf16 against the graph engine at f32, within
    # IMAGE_BF16_FACTOR of the bf16 twins' distance to it (the bf16 gate).
    ref32 = graph.stylize(*requests[0])
    plain16, _ = run_plain(pipe, *requests[0], repeats=1)
    k = image_errs(outs[0], ref32)
    kp = image_errs(outs[0], plain16)
    floor16 = image_errs(plain16, ref32)
    log(f"lifecycle recalibrated-auto request 1, bf16 vs the graph engine at "
        f"f32: kernels max abs {k[0]:.4g}, mean abs {k[1]:.4g}; plain twins "
        f"max abs {floor16[0]:.4g}, mean abs {floor16[1]:.4g}; kernels vs "
        f"plain twins max abs {kp[0]:.4g}, mean abs {kp[1]:.4g} (tol "
        f"{IMAGE_BF16_FACTOR}x the twins' distance to f32)")
    for what, e in (("kernels vs graph f32", k), ("kernels vs twins", kp)):
        check(e[0] <= IMAGE_BF16_FACTOR * floor16[0]
              and e[1] <= IMAGE_BF16_FACTOR * floor16[1],
              f"recalibrated auto route, {what}: {e}, bf16 floor "
              f"{floor16}")
    log(f"lifecycle recalibrated-auto: median "
        f"{statistics.median(times[1:]):.3f} ms/request over requests 2-"
        f"{len(times)}")
    return launches, drift, seconds


def lifecycle_phase(gen, card):
    """From training to serving on the card: the autoencoder, the AST
    warm-started from its checkpoint, the AST checkpoint through the graph
    engine and, recalibrated, through the fused engine.  Returns the
    launches by path."""
    import tempfile

    import torch

    shape = (BATCH, SIZE, SIZE, 3)
    requests = [(torch.rand(shape, generator=gen, device=DEVICE),
                 torch.rand(shape, generator=gen, device=DEVICE), a)
                for a in ALPHAS[:LIFE_GRAPH_REQUESTS]]
    launches, peaks = {}, {}

    def stage(name, fn, *args):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = fn(*args)
        peaks[name] = (round(time.perf_counter() - t, 1),
                       round(torch.cuda.max_memory_allocated() / 2**30, 2))
        return out

    with tempfile.TemporaryDirectory() as tmp:
        dirs = write_images(tmp, SEED + 13)
        ae_path, ae_ms = stage("ae", life_ae, tmp, dirs)
        ast_path, launches["warm-started-ast"] = stage(
            "ast", life_ast, tmp, dirs, ae_path)
        launches["flax"], graph_ms = stage("flax", life_graph, ast_path,
                                           requests)
        launches["recalibrated-auto"], drift, seconds = stage(
            "recalibrated-auto", life_fused, ast_path, dirs, requests)
    log(f"lifecycle stages (s, peak GiB): {peaks}")
    log(f"lifecycle on {card}: AE {ae_ms:.3f} ms per {LIFE_AE_SIZE}px batch-"
        f"{LIFE_AE_BATCH} f32 step; graph engine {graph_ms:.3f} ms per "
        f"{SIZE}px batch-{BATCH} f32 request; recalibration (from_checkpoint) "
        f"{seconds:.3f} s; drift {drift:.6g}")
    return launches


def dp_plan():
    """(backend, device, the sentence printed about it): 2 ranks over NCCL
    on two cards where there are two, else over gloo on one card (NCCL
    refuses two ranks on one GPU)."""
    import torch

    if torch.cuda.device_count() >= DP_RANKS:
        return "nccl", "cuda", (f"{DP_RANKS} ranks over nccl, rank r on "
                                "cuda:r")
    return "gloo", "cuda:0", (
        f"{DP_RANKS} ranks over gloo, both on cuda:0 (one card: the times "
        "test the sharded path, not its speed)")


@contextlib.contextmanager
def counted_collectives():
    """{name: calls} of the ``torch.distributed`` calls made in the
    block."""
    import torch.distributed as dist

    calls = {}
    saved = {name: getattr(dist, name) for name in DP_COLLECTIVES
             if hasattr(dist, name)}

    def wrap(name, fn):
        def counted(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kwargs)
        return counted

    for name, fn in saved.items():
        setattr(dist, name, wrap(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def recorded_step(trainer, batch, dis_step=None, patch=None, restore=True,
                  order=None):
    """One ``trainer.train_step`` on ``batch`` (rows on the trainer's
    device), the AdaAttN stage's functions replaced by ``patch`` ({name:
    function} of ``adaattn_fwd``/``adaattn_bwd``) and the discriminator at
    step ``dis_step``: the values the dp gates compare ("loss",
    "gen_adv_loss", "dis_loss", the gradients the optimizers were given,
    the state after: parameters, running buffers).  With ``restore`` the
    trainer is put back as it was.  ``order`` (a permutation of the
    batch's rows) reorders the batch and with it the rows of the dropout
    masks: the same step with its batch sums in another order."""
    import torch
    from arbitrarystyletransfer_tpu_torch import weights
    from arbitrarystyletransfer_tpu_torch.models import mobilenetv2
    from arbitrarystyletransfer_tpu_torch.ops.kernels import (
        adaattn_bwd as bwd_mod,
        adaattn_fwd as fwd_mod,
    )

    patch = patch or {}
    mods = {name: fwd_mod if hasattr(fwd_mod, name) else bwd_mod
            for name in patch}
    saved_fns = {name: getattr(mods[name], name) for name in patch}
    opts = [("grads", trainer, "opt")] + (
        [("dis_grads", trainer, "dis_opt")] if trainer.disc is not None
        else [])
    models = [("state", trainer.ast)] + (
        [("dis_state", trainer.disc)] if trainer.disc is not None else [])
    snap = {key: {k: v.clone() for k, v in weights.flatten(
        weights.module_state(m)).items()} for key, m in models}
    opt_snap = [(getattr(t, a).mu, getattr(t, a).nu, getattr(t, a).count)
                for _, t, a in opts]
    counters = [trainer.step.clone()] + (
        [trainer.dis_step.clone()] if trainer.disc is not None else [])
    hosts = (trainer.host_step, trainer.host_dis_step)
    out = {}
    real_apply = []
    for key, t, a in opts:
        opt = getattr(t, a)
        real_apply.append((opt, opt.apply_if_finite))

        def apply(grads, key=key, opt=opt, real=opt.apply_if_finite):
            out[key] = dict(zip(opt.names, (g.detach().clone()
                                            for g in grads)))
            return real(grads)

        opt.apply_if_finite = apply
    if dis_step is not None:
        trainer.host_dis_step = dis_step
    for name, fn in patch.items():
        setattr(mods[name], name, fn)
    dropout = mobilenetv2.dropout
    if order is not None:
        order = torch.as_tensor(order, device=batch[0].device)
        back = torch.argsort(order)
        batch = tuple(t[order] for t in batch)
        mobilenetv2.dropout = lambda x, *a, **k: dropout(
            x[back], *a, **k)[order]
    try:
        aux = trainer.train_step(*batch)
    finally:
        mobilenetv2.dropout = dropout
        for name, fn in saved_fns.items():
            setattr(mods[name], name, fn)
        for opt, real in real_apply:
            opt.apply_if_finite = real
    out.update({k: float(aux[k]) for k in ("loss", "gen_adv_loss",
                                           "dis_loss") if k in aux})
    out["finite"] = bool(aux["finite"])
    for key, m in models:
        out[key] = {k: v.clone() for k, v in weights.flatten(
            weights.module_state(m)).items()}
    if trainer.disc is not None:
        # The discriminator's parameters and running buffers are held
        # apart (``dp_gates``): the parameters floored at the largest.
        state = out.pop("dis_state")
        out["dis_params"] = {k: v for k, v in state.items()
                             if k.startswith("params/")}
        out["dis_stats"] = {k: v for k, v in state.items()
                            if k.startswith("batch_stats/")}
    if restore:
        for key, m in models:
            weights.load_state(m, weights.unflatten(snap[key]))
        for (_, t, a), (mu, nu, count) in zip(opts, opt_snap):
            opt = getattr(t, a)
            opt.mu, opt.nu, opt.count = mu, nu, count
        trainer.step.copy_(counters[0])
        if trainer.disc is not None:
            trainer.dis_step.copy_(counters[1])
        trainer.host_step, trainer.host_dis_step = hosts
    return out


def dp_orders(n):
    """The batch orders of the dp gates' yardstick: the rows rolled by 1,
    2, 3, n - 3 and n / 2 (the halves swapped), reversed, the even rows
    first, the odd rows first.  Over seeds (scripts/dp_gate_spread.py)
    the worst share of a limit was 0.926 with all eight; with the first
    five, 1.148 (the AE's gradients)."""
    rows = list(range(n))
    rolled = [rows[k:] + rows[:k] for k in (1, 2, 3, n - 3, n // 2)]
    return (*rolled, rows[::-1], rows[0::2] + rows[1::2],
            rows[1::2] + rows[0::2])


def dp_variants(trainer, batch, dis_step=None):
    """``recorded_step`` through the kernels (A), on the batch in each of
    ``dp_orders`` (P0, P1, ...), through the twins (B) and with the AdaAttN
    stage in float64 (D), each from the trainer's state."""
    from arbitrarystyletransfer_tpu_torch.ops.kernels import (
        adaattn_bwd as bwd_mod,
        adaattn_fwd as fwd_mod,
    )

    twins = dict(adaattn_fwd=fwd_mod.adaattn_fwd_reference,
                 adaattn_dq=bwd_mod.adaattn_dq_reference,
                 adaattn_dkv=bwd_mod.adaattn_dkv_reference)
    return {"A": recorded_step(trainer, batch, dis_step),
            **{f"P{i}": recorded_step(trainer, batch, dis_step, order=order)
               for i, order in enumerate(dp_orders(batch[0].shape[0]))},
            "B": recorded_step(trainer, batch, dis_step, twins),
            "D": recorded_step(trainer, batch, dis_step,
                               dict(adaattn_statistics=adaattn_statistics_f64))}


def dp_scale(tensors, name, floor):
    """The scale of ``tensors[name]`` in the dp gates: its max, floored at
    ``floor``; for a running mean at least BatchNorm's momentum (0.1) times
    the running std: the running mean of zero-centred activations is a sum
    that cancels, known to a share of their spread, not of itself (the
    CPU tests' rule)."""
    scale = max(float(tensors[name].abs().max()), floor, 1e-30)
    if name.startswith("batch_stats/") and name.endswith("/mean"):
        var = tensors[name[:-len("mean")] + "var"]
        scale = max(scale, 0.1 * float(var.sqrt().max()))
    return scale


def dp_distances(out, ref, floors):
    """{kind: worst relative distance of ``out`` to ``ref``}: each loss
    relative to itself, each tensor to its ``dp_scale`` (``floors``: {kind:
    floor}; the gradients' at ``DP_GRAD_FLOOR`` of the largest, the
    discriminator's parameters at the largest)."""
    dist = {}
    for key in ("loss", "gen_adv_loss", "dis_loss"):
        if key in ref:
            dist[key] = abs(out[key] - ref[key]) / max(abs(ref[key]), 1e-30)
    for kind in ("grads", "dis_grads", "state", "dis_params", "dis_stats",
                 "stats"):
        if kind in ref:
            dist[kind], dist[kind + "_at"] = max(
                (max_err(out[kind][n].to(r.device), r)
                 / dp_scale(ref[kind], n, floors.get(kind, 0.0)), n)
                for n, r in ref[kind].items())
    return dist


def dp_gates(label, dp, refs, own, hold=True):
    """The dp step ``dp`` against the one-process step ``refs["A"]`` on the
    same global batch, kind by kind (the losses; the gradients, the state
    after the step, the running buffers, each as the worst tensor relative
    to its ``dp_scale``): within the larger of the train gate's fixed tolerance
    (``STEP_LOSS_TOL``, ``STEP_GRAD_TOL``) and ``STEP_OWN_FACTOR`` times
    the larger of two one-process distances of the same step: ``own`` (the
    twins' step to the float64 AdaAttN stage's, the train gate's yardstick;
    for the AE the f32 step to the float64 one) and the spread of the step
    over the order of the batch's rows: the farthest pair among "A" and the
    steps on the global batch in the orders of ``dp_orders`` (the dropout
    masks reordered with it), which differ only in the order of the
    batch's sums, as the dp step differs from "A".  Returns {kind:
    [distance, limit]}; with ``hold`` raises past a limit."""
    ref = refs["A"]
    floors = {kind: DP_GRAD_FLOOR * max(float(g.abs().max())
                                        for g in ref[kind].values())
              for kind in ("grads", "dis_grads") if kind in ref}
    if "dis_params" in ref:
        # The discriminator's BatchNorm biases that another BatchNorm
        # follows get rounding noise for a gradient, which Adam's first
        # step turns into updates of +-dis_lr on biases that start at 0:
        # each parameter is held relative to the largest one.
        floors["dis_params"] = max(float(p.abs().max())
                                   for p in ref["dis_params"].values())
    d_dp = dp_distances(dp, ref, floors)
    ordered = [ref] + [v for k, v in refs.items() if k.startswith("P")]
    pairs = [dp_distances(a, b, floors) for i, b in enumerate(ordered)
             for a in ordered[i + 1:]]
    d_perm = {k: max(p[k] for p in pairs) for k in d_dp
              if not k.endswith("_at")}
    d_own = dp_distances(refs[own[0]], refs[own[1]], floors)
    gates = {}
    for kind, d in d_dp.items():
        if kind.endswith("_at"):
            continue
        fixed = STEP_LOSS_TOL if kind.endswith("loss") else STEP_GRAD_TOL
        gates[kind] = [d, max(fixed, STEP_OWN_FACTOR * max(d_perm[kind],
                                                           d_own[kind]))]
    log(f"dp gate {label}: " + "; ".join(
        f"{k} {v[0]:.4g}" + (f" at {d_dp[k + '_at']}" if k + "_at" in d_dp
                             else "")
        + f" (limit {v[1]:.4g}; reordered batch {d_perm[k]:.4g}, {own[0]} "
        f"vs {own[1]} {d_own[k]:.4g})" for k, v in gates.items()))
    failed = [k for k, v in gates.items() if v[0] > v[1]]
    check(not (hold and failed), f"dp {label}: {failed} past their limits")
    return gates


def ae_step_f64(trainer, batch):
    """``recorded_step``'s values of the autoencoder's step on ``batch``
    through float64 copies of the model and VGG (no update)."""
    import copy

    import torch
    from arbitrarystyletransfer_tpu_torch import weights
    from arbitrarystyletransfer_tpu_torch.train.ae_trainer import ae_loss

    model = copy.deepcopy(trainer.model).double()
    vgg = copy.deepcopy(trainer.vgg).double()
    total, _ = ae_loss(model, vgg, trainer.cfg,
                       batch.to(DEVICE, torch.float64))
    grads = torch.autograd.grad(total, list(model.parameters()),
                                allow_unused=True)
    names = [n.replace(".", "/") for n, _ in model.named_parameters()]
    return {"loss": float(total.detach()),
            "grads": {n: g.float() for n, g in zip(names, grads)},
            "stats": {k: v.float() for k, v in weights.flatten(
                weights.module_state(model)).items()
                if k.startswith("batch_stats/")}}


def ae_recorded(trainer, batch):
    """The autoencoder's step on ``batch``: loss, the gradients Adam was
    given, the running buffers after."""
    from arbitrarystyletransfer_tpu_torch import weights

    out, real = {}, trainer.opt.apply_if_finite

    def apply(grads):
        out["grads"] = dict(zip(trainer.opt.names,
                                (g.detach().clone() for g in grads)))
        return real(grads)

    trainer.opt.apply_if_finite = apply
    try:
        aux = trainer.train_step(batch)
    finally:
        trainer.opt.apply_if_finite = real
    out["loss"], out["finite"] = float(aux["loss"]), bool(aux["finite"])
    out["stats"] = {k: v.clone() for k, v in weights.flatten(
        weights.module_state(trainer.model)).items()
        if k.startswith("batch_stats/")}
    return out


def dp_trainer(tmp, mesh, seed, use_dis=False):
    """The dp phase's ``ASTTrainer`` (on ``mesh`` when given, else one
    process on the card) with the phase's initial AST state; ``seed`` draws
    the discriminator."""
    import torch
    from arbitrarystyletransfer_tpu_torch import ModelConfig, weights
    from arbitrarystyletransfer_tpu_torch.config import ASTTrainConfig
    from arbitrarystyletransfer_tpu_torch.train.ast_trainer import ASTTrainer

    tcfg = ASTTrainConfig(batch_size=DP_BATCH, save_dir=f"{tmp}/ckpt",
                          ae_model="", use_dis=use_dis)
    trainer = ASTTrainer(tcfg, None, ModelConfig(use_pallas_adaattn=True),
                         seed=seed, preview_dir=None,
                         device=DEVICE if mesh is None else mesh.device,
                         log_fn=lambda *a: None, mesh=mesh)
    weights.load_state(trainer.ast, weights.unflatten(
        torch.load(f"{tmp}/ast_init.pt")))
    return trainer


def dp_rank(mesh, tmp):
    """One rank of the dp phase (the spec and the batches in ``tmp``):
    the training gate step, the GAN and AE steps, then (once the CLI's
    resume has ended: ``dp_cli_resume``) warm-up and timed steps and the
    fused and graph engines' requests.  Returns what the parent checks."""
    import os

    import torch
    from arbitrarystyletransfer_tpu_torch import ModelConfig, infer, weights
    from arbitrarystyletransfer_tpu_torch.infer import StylePipeline
    from arbitrarystyletransfer_tpu_torch.ops.kernels import (
        LAUNCHES,
        _build,
        reset_launches,
    )
    from arbitrarystyletransfer_tpu_torch.parallel import shard_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = torch.load(f"{tmp}/spec.pt")

    def rows(batch):
        return tuple(shard_batch(mesh, t if mesh.rank == 0 else None)
                     for t in batch)

    out = {"device": str(mesh.device)}
    if torch.cuda.device_count() >= 2 and mesh.device.index == 1:
        # The launch device check: a tensor on another card than the
        # current one must raise, not launch there.
        try:
            _build.launch_stream(torch.empty(1, device="cuda:0"))
            out["launch_check"] = "no error"
        except RuntimeError:
            out["launch_check"] = "raised"

    # The gate steps (all with ``spec["light"]``): training, GAN, AE.
    trainer = dp_trainer(tmp, mesh, spec["seed"])
    with counted_collectives() as calls:
        out["gate"] = recorded_step(trainer, rows(spec["gate"]),
                                    restore=False)
    out["collectives_per_step"] = dict(calls)
    gan = dp_trainer(tmp, mesh, spec["seed"], use_dis=True)
    out["gan"] = recorded_step(gan, rows(spec["gan"]), DP_GAN_DIS_STEP,
                               restore=False)
    del gan
    out["ae"] = dp_ae_step(tmp, mesh, spec)
    if spec["light"]:
        return out
    # The CLI's resume ran beside the steps above, which are not timed.
    deadline = time.monotonic() + DP_TIMEOUT
    while not os.path.exists(f"{tmp}/cli_done"):
        check(time.monotonic() < deadline, "dp: the CLI's resume never ended")
        time.sleep(0.1)
    torch.cuda.empty_cache()
    # Training goes on from the gate step: one warm-up step per other
    # bucket, then the timed steps.
    for batch in spec["warmup"]:
        trainer.train_step(*rows(batch))
    reset_launches()
    out["step_ms"], out["step_launches"], out["losses"] = [], [], []
    for batch in spec["timed"]:
        batch = rows(batch)
        before = dict(LAUNCHES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        aux = trainer.train_step(*batch)
        end.record()
        torch.cuda.synchronize()
        out["step_ms"].append(start.elapsed_time(end))
        out["step_launches"].append({k: LAUNCHES[k] - before[k]
                                     for k in LAUNCHES})
        out["losses"].append(float(aux["loss"]))
        check(bool(aux["finite"]), "dp train step: not finite")
    out["train_launches"] = dict(LAUNCHES)
    out["final"] = {k: v.clone() for k, v in weights.flatten(
        weights.module_state(trainer.ast)).items()}
    del trainer
    torch.cuda.empty_cache()

    # Serving: the fused engine's "auto" route (bf16), then the graph
    # engine with batch-statistics BatchNorm (f32).
    cfg = ModelConfig(encoder_eval_stats=True, use_pallas_adaattn=True,
                      compute_dtype="bfloat16")
    state = torch.load(f"{tmp}/serve_state.pt")
    pipe = StylePipeline(cfg, engine="fused", device=mesh.device,
                         state=state, encoder_impl="auto",
                         decoder_impl="auto", mesh=mesh)
    engine_calls = []
    sharded = infer.stylize_fused_sharded

    def counted_engine(*args, **kwargs):
        with counted_collectives() as calls:
            result = sharded(*args, **kwargs)
        engine_calls.append(dict(calls))
        return result

    infer.stylize_fused_sharded = counted_engine
    label = f"dp rank {mesh.rank}"
    try:
        with torch.inference_mode():
            outs, ms, total = run_requests(pipe, spec["serve"],
                                           route_launches("auto"),
                                           f"{label} auto")
    finally:
        infer.stylize_fused_sharded = sharded
    out["serve"] = {"outs": [o.cpu() for o in outs], "ms": ms,
                    "total": total}
    out["engine_collectives"] = engine_calls
    del pipe
    gcfg = dataclasses.replace(cfg, encoder_eval_stats=False,
                               compute_dtype="float32")
    graph = StylePipeline(gcfg, engine="flax", device=mesh.device,
                          state=torch.load(f"{tmp}/graph_state.pt"),
                          mesh=mesh)
    with torch.inference_mode():
        outs, ms, total = run_requests(graph, spec["graph"], GRAPH_LAUNCHES,
                                       f"{label} graph")
    out["graph"] = {"outs": [o.cpu() for o in outs], "ms": ms,
                    "total": total}
    return out


def dp_ae_step(tmp, mesh, spec):
    """The dp phase's autoencoder step on this rank's rows."""
    import torch
    from arbitrarystyletransfer_tpu_torch import weights
    from arbitrarystyletransfer_tpu_torch.config import AETrainConfig
    from arbitrarystyletransfer_tpu_torch.parallel import shard_batch
    from arbitrarystyletransfer_tpu_torch.train.ae_trainer import (
        AutoencoderTrainer,
    )

    ae = AutoencoderTrainer(
        AETrainConfig(batch_size=DP_BATCH, save_dir=f"{tmp}/ae_ckpt"), None,
        seed=spec["seed"], device=mesh.device, log_fn=lambda *a: None,
        mesh=mesh)
    weights.load_state(ae.model, weights.unflatten(
        torch.load(f"{tmp}/ae_init.pt")))
    return ae_recorded(ae, shard_batch(mesh, spec["ae"] if mesh.rank == 0
                                       else None))


def dp_cli(tmp, backend, resume=False):
    """``torchrun --nproc_per_node 2 -m arbitrarystyletransfer_tpu_torch
    .train`` for DP_CLI_STEPS steps at DP_CLI_SIZE over the lifecycle's
    synthetic PNGs, or with ``resume`` a 2-rank ``--load`` resume of one
    step from that run's checkpoint: (the checkpoint's step after it,
    seconds)."""
    import os

    from arbitrarystyletransfer_tpu_torch.train import checkpoint as ckpt

    t = time.perf_counter()
    dirs = ([f"{tmp}/pngs/content", f"{tmp}/pngs/style"] if resume
            else write_images(f"{tmp}/pngs", SEED + 15))
    save = f"{tmp}/cli"
    base = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            f"--nproc_per_node={DP_RANKS}", "-m",
            "arbitrarystyletransfer_tpu_torch.train", "--pallas",
            "--device", DEVICE, "--dist_backend", backend, "--img_sizes", str(DP_CLI_SIZE),
            "--batch_size", str(DP_BATCH), "--content_dir", dirs[0],
            "--style_dir", dirs[1], "--save_dir", save, "--ae_model",
            f"{tmp}/none", "--num_workers", "1", "--worker_mode", "thread",
            "--preview_dir", f"{tmp}/previews"]
    extra = (["--train_iter", "1", "--load"] if resume
             else ["--train_iter", str(DP_CLI_STEPS)])
    proc = subprocess.run(base + extra, capture_output=True, text=True,
                          timeout=300,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    check(proc.returncode == 0, f"dp CLI {extra}: {proc.stderr[-3000:]}")
    check(proc.stdout.count("NUM AST PARAMETERS") == 1,
          f"dp CLI: the ranks' log\n{proc.stdout[-2000:]}")
    step = int(ckpt.restore_checkpoint(f"{save}/ast.pt")["step"])
    check(step == DP_CLI_STEPS + resume, f"dp CLI {extra}: checkpoint step "
          f"{step}")
    return step, round(time.perf_counter() - t, 1)


def dp_cli_resume(tmp, backend):
    """``dp_cli``'s resume, then the file that lets the ranks' timed steps
    start (``dp_rank`` waits for it), also when the resume failed."""
    try:
        return dp_cli(tmp, backend, resume=True)
    finally:
        open(f"{tmp}/cli_done", "w").close()


def dp_graph_spread(graph, requests, refs):
    """The graph engine's own spread over the order of the batch's rows:
    the farthest pair (max abs, mean abs) among each request's output and
    its outputs on the batch in the orders of ``dp_orders``, put back in
    order."""
    import torch

    worst = (0.0, 0.0)
    for (content, style, alpha), ref in zip(requests, refs):
        outs = [ref]
        for order in dp_orders(content.shape[0]):
            order = torch.as_tensor(order, device=content.device)
            outs.append(graph.stylize(content[order], style[order],
                                      alpha)[torch.argsort(order)])
        for i, a in enumerate(outs):
            for b in outs[i + 1:]:
                e = image_errs(a, b)
                worst = (max(worst[0], e[0]), max(worst[1], e[1]))
    return worst


def dp_all_gates(ranks, ref, gan_ref, ae_ref, hold=True):
    """``dp_gates`` of the train, GAN and AE steps on every rank."""
    gates = {}
    for name, dp_key, refs, own in (
            ("train", "gate", ref, ("B", "D")),
            ("gan", "gan", gan_ref, ("B", "D")),
            ("ae", "ae", ae_ref, ("A", "D"))):
        for r, rank in zip(ranks, range(DP_RANKS)):
            check(r[dp_key]["finite"], f"dp {name} step on rank {rank}: not "
                  "finite")
            gates[f"{name}/rank{rank}"] = dp_gates(
                f"{name}, rank {rank}", r[dp_key], refs, own, hold)
    return gates


def dp_phase(gen, card, train_ms, light=False):
    """Data parallelism on the card: 2 ranks (``dp_plan``) train (the
    first step held against the one-process step on the same global
    batch, then warm-up and timed steps with their launches), take a GAN
    step and an AE step against one process, serve "auto" requests (no
    collective inside the engine) and graph-engine requests against one
    process, and the train CLI under torchrun.  Returns the launches by
    path ("dp-train", "dp-serve", "dp-graph": summed over the ranks).  With
    ``light`` only the three gate steps run, none held: returns their
    gates (``scripts/dp_gate_spread.py``)."""
    import concurrent.futures
    import os
    import tempfile

    import torch
    from arbitrarystyletransfer_tpu_torch import ModelConfig, engine, weights
    from arbitrarystyletransfer_tpu_torch.config import AETrainConfig
    from arbitrarystyletransfer_tpu_torch.infer import StylePipeline
    from arbitrarystyletransfer_tpu_torch.parallel.launch import run_ranks
    from arbitrarystyletransfer_tpu_torch.train.ae_trainer import (
        AutoencoderTrainer,
    )

    backend, device, sentence = dp_plan()
    log(f"dp: {sentence}")

    def batch(size, n=DP_BATCH):
        shape = (n, size, size, 3)
        return (torch.rand(shape, generator=gen, device=DEVICE),
                torch.rand(shape, generator=gen, device=DEVICE))

    def cpu(b):
        return tuple(t.cpu() for t in b)

    with tempfile.TemporaryDirectory() as tmp, \
            concurrent.futures.ThreadPoolExecutor(1) as pool:
        # The torchrun CLI runs in processes of its own beside what is not
        # timed: its first run beside the one-process references, its
        # resume beside the ranks' gate steps.
        cli_run = None if light else pool.submit(dp_cli, tmp, backend)
        t = time.perf_counter()
        # The initial states, the batches and the one-process references.
        first = batch(TRAIN_SIZES[-1])
        trainer = make_trainer(tmp, iter([first]))
        torch.save({k: v.cpu() for k, v in weights.flatten(
            weights.module_state(trainer.ast)).items()}, f"{tmp}/ast_init.pt")
        ref = dp_variants(trainer, first)
        del trainer
        gan_batch = batch(TRAIN_SIZES[-1])
        gan = dp_trainer(tmp, None, SEED, use_dis=True)
        gan_ref = dp_variants(gan, gan_batch, DP_GAN_DIS_STEP)
        del gan
        ae = AutoencoderTrainer(
            AETrainConfig(batch_size=DP_BATCH, save_dir=f"{tmp}/ae1"),
            None, seed=SEED, device=DEVICE, log_fn=lambda *a: None)
        weights.load_state(ae.model, ae_state(random_state(
            ModelConfig(), SEED + 15)))
        torch.save({k: v.cpu() for k, v in weights.flatten(
            weights.module_state(ae.model)).items()}, f"{tmp}/ae_init.pt")
        ae_batch = torch.rand((DP_BATCH, DP_AE_SIZE, DP_AE_SIZE, 3),
                              generator=gen, device=DEVICE)
        ae_ref = {"D": ae_step_f64(ae, ae_batch)}
        for key, b in [("A", ae_batch)] + [
                (f"P{i}", ae_batch[order]) for i, order in
                enumerate(dp_orders(DP_BATCH))]:
            ae_ref[key] = ae_recorded(ae, b)
            weights.load_state(ae.model, weights.unflatten(torch.load(
                f"{tmp}/ae_init.pt")))
            ae.opt = type(ae.opt)(
                [(n.replace(".", "/"), p) for n, p in
                 ae.model.named_parameters()], ae.cfg.lr, ae.cfg.adam_b1,
                ae.cfg.adam_b2, ae.cfg.adam_eps, ae.cfg.grad_clip_norm)
            ae.step.zero_()
        del ae

        log(f"dp: the one-process gate steps took "
            f"{time.perf_counter() - t:.1f} s")
        spec = {"seed": SEED, "light": light, "gate": cpu(first),
                "gan": cpu(gan_batch), "ae": ae_batch.cpu()}
        if light:
            torch.save(spec, f"{tmp}/spec.pt")
            ranks = run_ranks(dp_rank, DP_RANKS, tmp, backend=backend,
                              device=device, timeout=DP_TIMEOUT)
            return dp_all_gates(ranks, ref, gan_ref, ae_ref, hold=False)

        # Serving: the routes phase's state with its head normalized on
        # request 1 ("auto", bf16), and the graph engine at f32.
        cfg = ModelConfig(encoder_eval_stats=True, use_pallas_adaattn=True,
                          compute_dtype="bfloat16")
        shape = (BATCH, SIZE, SIZE, 3)
        serve = [(torch.rand(shape, generator=gen, device=DEVICE),
                  torch.rand(shape, generator=gen, device=DEVICE), a)
                 for a in ALPHAS[:DP_REQUESTS]]
        pipe = StylePipeline(cfg, engine="fused", device=DEVICE,
                             state=random_state(cfg, SEED),
                             encoder_impl="auto", decoder_impl="auto")
        with torch.inference_mode():
            pre = engine.stylize_fused(
                pipe.state, *serve[0][:2], serve[0][2], cfg=cfg,
                dtype=pipe.dtype, exporting=False).double()
        head = pipe.state["params"]["dec"]["img_out"]
        scale = 0.05 / pre.std(dim=(1, 2)).mean(dim=0)
        head["kernel"].mul_(scale.float())
        head["bias"].copy_(0.5 - scale * (pre.mean(dim=(0, 1, 2))
                                          - head["bias"]))
        del pre
        state = weights.to_device(pipe.state, "cpu")
        torch.save(state, f"{tmp}/serve_state.pt")
        with torch.inference_mode():
            serve_ref = [pipe.stylize(*r) for r in serve]
            plain, _ = run_plain(pipe, *serve[0], repeats=1)
            pipe32 = StylePipeline(
                dataclasses.replace(cfg, compute_dtype="float32"),
                engine="fused", device=DEVICE, state=pipe.state,
                encoder_impl="auto", decoder_impl="auto")
            plain32, _ = run_plain(pipe32, *serve[0], repeats=1)
            floor16 = image_errs(plain, plain32)
            del plain, plain32, pipe32
            gcfg = dataclasses.replace(cfg, encoder_eval_stats=False,
                                       compute_dtype="float32")
            graph = StylePipeline(gcfg, engine="flax", device=DEVICE,
                                  state=state)
            graph_req = serve[:DP_GRAPH_REQUESTS]
            # The graph normalizes with batch statistics: its head is
            # normalized on request 1 as the lifecycle's graph engine's is.
            normalize_train_head(graph, graph_req[0][:2])
            torch.save(weights.to_device(graph.state, "cpu"),
                       f"{tmp}/graph_state.pt")
            graph_ref = [graph.stylize(*r) for r in graph_req]
            graph_spread = dp_graph_spread(graph, graph_req, graph_ref)
        log(f"dp: the one-process references took "
            f"{time.perf_counter() - t:.1f} s")
        cli_first = cli_run.result()
        log(f"dp: the CLI's first run (step, s): {cli_first}; the CLI and "
            f"the references {time.perf_counter() - t:.1f} s")
        with torch.inference_mode():
            # Timed alone on the card, the CLI done.
            one_auto_ms = timed_ms(lambda: pipe.stylize(*serve[0]), iters=3,
                                   warmup=1)
        del pipe, graph
        torch.cuda.empty_cache()

        spec.update({
            "warmup": [cpu(batch(s)) for s in TRAIN_SIZES[:-1]],
            "timed": [cpu(batch(TRAIN_SIZES[-1])) for _ in range(DP_STEPS)],
            "serve": [(c.cpu(), s.cpu(), a) for c, s, a in serve],
            "graph": [(c.cpu(), s.cpu(), a) for c, s, a in graph_req]})
        torch.save(spec, f"{tmp}/spec.pt")
        t = time.perf_counter()
        resume_run = pool.submit(dp_cli_resume, tmp, backend)
        ranks = run_ranks(dp_rank, DP_RANKS, tmp, backend=backend,
                          device=device, timeout=DP_TIMEOUT)
        rank_s = round(time.perf_counter() - t, 1)
        cli = {"steps": [cli_first, resume_run.result()],
               "files": sorted(os.listdir(f"{tmp}/cli")),
               "previews": len(os.listdir(f"{tmp}/previews"))}
        log(f"dp: the ranks' run took {rank_s} s; the CLI's resume (step, "
            f"s) {cli['steps'][1]}")
        check(cli["files"] == ["ast.pt", "ast_train_dict.json"],
              f"dp CLI files {cli['files']}")

    result = {"backend": backend, "ranks": DP_RANKS,
              "devices": [r["device"] for r in ranks], "card": card,
              "ranks_seconds": rank_s, "cli": cli}
    if "launch_check" in ranks[-1]:
        result["launch_check"] = ranks[-1]["launch_check"]
        check(ranks[-1]["launch_check"] == "raised",
              "a launch on another card than the current one did not raise")
    result["gates"] = dp_all_gates(ranks, ref, gan_ref, ae_ref)
    for key in ("state", "grads"):
        check(all(torch.equal(ranks[0]["gate"][key][k], ranks[1]["gate"][key][k])
                  for k in ranks[0]["gate"][key]), f"dp train gate: {key} differ "
              "across the ranks")
    unequal = [k for k in ranks[0]["final"]
               if not torch.equal(ranks[0]["final"][k], ranks[1]["final"][k])]
    check(not unequal, f"dp: parameters or buffers differ across the ranks "
          f"after the timed steps: {unequal[:5]}")
    for r in ranks:
        for i, n in enumerate(r["step_launches"]):
            check(n == TRAIN_LAUNCHES, f"dp step {i + 1} on {r['device']} "
                  f"launched {n}, expected {TRAIN_LAUNCHES}")
        check(all(math.isfinite(x) for x in r["losses"]), f"dp losses "
              f"{r['losses']}")
    check(ranks[0]["losses"] == ranks[1]["losses"], "dp: the ranks' losses "
          "differ")

    serve_err, bit_equal = [], True
    for r in ranks:
        check(all(not any(c.values()) for c in r["engine_collectives"]),
              f"dp: collectives inside the engine {r['engine_collectives']}")
        for out, ref_out in zip(r["serve"]["outs"], serve_ref):
            ref_out = ref_out.cpu()
            bit_equal &= torch.equal(out, ref_out)
            serve_err.append(image_errs(out, ref_out))
    # Each rank's rows through the same kernels at half the batch: equal
    # where every op of the route computes an image independently of the
    # batch (cuDNN may pick another algorithm for the plain convs at
    # batch 4); else within the routes phase's bf16 gate.
    worst = (max(e[0] for e in serve_err), max(e[1] for e in serve_err))
    check(bit_equal or (worst[0] <= IMAGE_BF16_FACTOR * floor16[0]
                        and worst[1] <= IMAGE_BF16_FACTOR * floor16[1]),
          f"dp serving: {worst} past the bf16 gate ({floor16})")
    # The graph engine's BatchNorm statistics are the global batch's sums,
    # whose order the ranks change: held to the f32 image gate or twice
    # the one-process engine's own spread over the batch's order.
    graph_err = [image_errs(out, ref_out.cpu()) for r in ranks
                 for out, ref_out in zip(r["graph"]["outs"], graph_ref)]
    g_worst = (max(e[0] for e in graph_err), max(e[1] for e in graph_err))
    g_limit = [max(tol, STEP_OWN_FACTOR * spread)
               for tol, spread in zip(IMAGE_F32_TOL, graph_spread)]
    log(f"dp graph engine against one process: max abs {g_worst[0]:.4g}, "
        f"mean abs {g_worst[1]:.4g} (limits {g_limit}; one process over "
        f"the batch's order: {graph_spread})")
    check(g_worst[0] <= g_limit[0] and g_worst[1] <= g_limit[1],
          f"dp graph engine: {g_worst} past its limits {g_limit}")
    result["serve"] = {"bit_equal": bool(bit_equal), "max_abs": worst[0],
                       "mean_abs": worst[1],
                       "bf16_limit": [IMAGE_BF16_FACTOR * f for f in floor16]}
    result["graph"] = {"max_abs": g_worst[0], "mean_abs": g_worst[1],
                       "limit": g_limit, "order_spread": list(graph_spread)}
    result["launches_per_rank"] = {
        "train_step": ranks[0]["step_launches"][0],
        "request": route_launches("auto"),
        "graph_request": GRAPH_LAUNCHES}
    result["collectives_per_step"] = ranks[0]["collectives_per_step"]
    result["ms"] = {
        "train_step_per_rank": [statistics.median(r["step_ms"])
                                for r in ranks],
        "train_step_one_process": train_ms,
        "request_per_rank": [statistics.median(r["serve"]["ms"][1:])
                             for r in ranks],
        "request_one_process": one_auto_ms,
        "graph_request_per_rank": [statistics.median(r["graph"]["ms"][1:])
                                   for r in ranks]}
    log(json.dumps({"dp": result}))
    return {"dp-train": {k: sum(r["train_launches"][k] for r in ranks)
                         for k in KERNELS},
            "dp-serve": {k: sum(r["serve"]["total"][k] for r in ranks)
                         for k in KERNELS},
            "dp-graph": {k: sum(r["graph"]["total"][k] for r in ranks)
                         for k in KERNELS}}


# Phases that ``--phase`` runs alone: {name: (generator seed offset, or
# None for none; whether the whole run runs it under inference mode)}.
# Alone, each draws from a fresh generator of the seed it draws from in the
# whole run, and the GAN and dp phases get a train step time of 0.
ALONE = {
    "expand_dw": (0, True), "adaattn_fwd": (0, True),
    "flat_block": (0, True), "flat_s2_block": (0, True),
    "mega_block": (4, True), "fused_2pass": (4, True), "probes": (5, True),
    "plain_route": (6, True), "ragged": (7, True), "sweeps": (7, True),
    "split": (SPLIT_SEED, True),
    "adaattn_bwd": (0, False), "policy": (None, False),
    "routes": (0, False), "sizes": (SIZES_SEED, False),
    "train": (0, False), "gan": (14, False),
    "lifecycle": (13, False), "dp": (15, False),
}


def run_alone(name, card):
    """One phase of the whole run in a process of its own."""
    import torch
    from arbitrarystyletransfer_tpu_torch.ops.kernels.flat_block import (
        flat_block,
        flat_block_reference,
    )
    from arbitrarystyletransfer_tpu_torch.ops.kernels.flat_s2 import (
        flat_s2_block,
        flat_s2_block_reference,
    )

    offset, inference = ALONE[name]
    gen = (None if offset is None else
           torch.Generator(device=DEVICE).manual_seed(SEED + offset))
    calls = {
        "expand_dw": lambda: expand_dw_phase(gen),
        "adaattn_fwd": lambda: adaattn_phase(gen, torch.Generator(
            device=DEVICE).manual_seed(SEED + 6)),
        "flat_block": lambda: flat_kernel_phase(
            gen, "flat_block", flat_block, flat_block_reference,
            FLAT_BLOCK_CASES + FLAT_BLOCK_F32, 1),
        "flat_s2_block": lambda: flat_kernel_phase(
            gen, "flat_s2_block", flat_s2_block, flat_s2_block_reference,
            FLAT_S2_CASES + FLAT_S2_F32, 2),
        "mega_block": lambda: mega_phase(gen),
        "fused_2pass": lambda: two_pass_phase(gen),
        "probes": lambda: probes_phase(gen),
        "plain_route": lambda: plain_route_phase(gen),
        "ragged": lambda: ragged_phase(gen),
        "split": lambda: split_phase(gen),
        "sweeps": lambda: sweeps_phase(gen),
        "adaattn_bwd": lambda: adaattn_bwd_phase(gen),
        "policy": policy_phase,
        "routes": lambda: routes_phase(gen),
        "sizes": lambda: sizes_phase(gen),
        "train": lambda: train_phase(gen),
        "gan": lambda: gan_phase(gen, 0.0),
        "lifecycle": lambda: lifecycle_phase(gen, card),
        "dp": lambda: dp_phase(gen, card, 0.0),
    }
    with torch.inference_mode(inference):
        calls[name]()


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase", choices=tuple(ALONE),
                    help="run this phase alone (after the build), not the "
                    "whole script")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port's kernels need "
              "an NVIDIA GPU (sm_90a)", file=sys.stderr)
        return 2
    from arbitrarystyletransfer_tpu_torch.ops.kernels import _build
    from arbitrarystyletransfer_tpu_torch.ops.kernels.flat_block import (
        flat_block,
        flat_block_reference,
    )
    from arbitrarystyletransfer_tpu_torch.ops.kernels.flat_s2 import (
        flat_s2_block,
        flat_s2_block_reference,
    )

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.load_library(ptxas_verbose=True)
    log(f"build: {time.perf_counter() - t0:.1f} s -> "
        f"{_build.build_info['path']}")
    for line in _build.build_info["log"].splitlines():
        if any(w in line for w in ("Used", "spill", "Compiling entry",
                                   "Performance Loss")):
            log("  ptxas:", line.strip().removeprefix("ptxas info    : "))

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.phase:
        t = time.perf_counter()
        run_alone(args.phase, card)
        if TF32_VS_F64:
            tf32_gate()
        log(f"phase {args.phase} alone: "
            f"{time.perf_counter() - t:.1f} s")
        log(card)
        log(json.dumps({"ok": True, "phase": args.phase}))
        return 0
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    seconds = {}

    def phase(name, fn, *args):
        t = time.perf_counter()
        try:
            return fn(*args)
        finally:
            seconds[name] = round(time.perf_counter() - t, 1)
            log(f"phase {name}: {seconds[name]} s")

    with torch.inference_mode():
        e_worst, e_ms, e_plain, e_bound, e_f32 = phase(
            "expand_dw", expand_dw_phase, gen)
        gen6 = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
        a_worst, a_ms, a_plain, a_bound, a_lib, a_f32 = phase(
            "adaattn_fwd", adaattn_phase, gen, gen6)
        f_worst, f_ms, f_bound, f_f32 = phase(
            "flat_block", flat_kernel_phase, gen, "flat_block", flat_block,
            flat_block_reference, FLAT_BLOCK_CASES + FLAT_BLOCK_F32, 1)
        s_worst, s_ms, s_bound, s_f32 = phase(
            "flat_s2_block", flat_kernel_phase, gen, "flat_s2_block",
            flat_s2_block, flat_s2_block_reference,
            FLAT_S2_CASES + FLAT_S2_F32, 2)
        # Slice 4's kernel phases draw from a generator of their own, so
        # that every other phase gets the inputs it got before them.
        gen4 = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
        m_worst, m_ms, m_plain, m_bound, m_f32 = phase(
            "mega_block", mega_phase, gen4)
        two_pass = phase("fused_2pass", two_pass_phase, gen4)
        # So do slice 5's probes.
        gen5 = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
        probe_rows, probe_launches = phase("probes", probes_phase, gen5)
        phase("plain_route", plain_route_phase, gen6)
        # So do the ragged shapes and the per-sweep times.
        gen7 = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
        phase("ragged", ragged_phase, gen7)
        # The chunked boxes draw from a generator of their own.
        phase("split", split_phase, torch.Generator(
            device=DEVICE).manual_seed(SEED + SPLIT_SEED))
        phase("sweeps", sweeps_phase, gen7)
    tf32_gate()
    bwd = phase("adaattn_bwd", adaattn_bwd_phase, gen)
    phase("policy", policy_phase)
    launches = phase("routes", routes_phase, gen)
    # The sizes phase draws from a generator of its own.
    gen18 = torch.Generator(device=DEVICE).manual_seed(SEED + SIZES_SEED)
    launches["sizes"] = phase("sizes", sizes_phase, gen18)
    torch.cuda.empty_cache()
    launches["train"], train_ms, train_peak = phase("train", train_phase, gen)
    # The GAN phase draws from a generator of its own.
    gen14 = torch.Generator(device=DEVICE).manual_seed(SEED + 14)
    launches["gan"], gan_ms, gan_r1_ms, gan_peak = phase(
        "gan", gan_phase, gen14, train_ms)
    # The lifecycle phase draws from a generator of its own.
    gen13 = torch.Generator(device=DEVICE).manual_seed(SEED + 13)
    launches.update(phase("lifecycle", lifecycle_phase, gen13, card))
    # The dp phase draws from a generator of its own.
    gen15 = torch.Generator(device=DEVICE).manual_seed(SEED + 15)
    torch.cuda.empty_cache()
    launches.update(phase("dp", dp_phase, gen15, card, train_ms))
    launches.update(probe_launches)
    log(f"phase seconds: {seconds}")

    pallas = "arbitrarystyletransfer_tpu/ops/pallas/"

    def row(name, source, replaces, worst, ms, plain_ms, bound, library_ms,
            f32=None):
        """``replaces`` is the TPU kernel's file:line from the repo root;
        ``f32``: (kernel ms, twin ms, Bound, worst error[, library ms,
        another form's ms]) per 512px f32 request of the same route."""
        by_route = {impl: counts[name] for impl, counts in launches.items()}
        out = {"name": name, "route": "cuda",
               "source": f"arbitrarystyletransfer_tpu_torch/csrc/{source}",
               "replaces": replaces,
               "launches": sum(by_route.values()),
               "launches_by_route": by_route, "max_abs_err": worst,
               "ms": ms, "plain_ms": plain_ms, "bound_ms": bound.ms(),
               "bound_by": bound.by(), "library_ms": library_ms}
        if f32 is not None:
            out["f32_request"] = {
                "ms": f32[0], "plain_ms": f32[1], "bound_ms": f32[2].ms(),
                "bound_by": f32[2].by(), "max_abs_err": f32[3]}
            if len(f32) > 4:
                out["f32_request"].update(
                    library_ms=f32[4], f64_form_ms=f32[5],
                    launches=F32_FORM_LAUNCHES["serve"])
        return out

    kernels = [
        row("expand_dw", "expand_dw.cu", pallas + "fused_block.py:68",
            e_worst, e_ms, e_plain, e_bound, None,
            (e_f32["ms"], e_f32["plain_ms"], e_f32["bound"], e_f32["worst"])),
        row("adaattn_fwd", "adaattn_fwd.cu", pallas + "adaattn_kernel.py:57",
            a_worst, a_ms, a_plain, a_bound, a_lib, a_f32),
        row("flat_block", "flat_block.cu", pallas + "flatblock.py:92",
            f_worst, *f_ms[MAIN_ROUTE], f_bound[MAIN_ROUTE], None,
            f_f32[MAIN_ROUTE]),
        row("flat_s2_block", "flat_s2.cu", pallas + "flatblock_s2.py:121",
            s_worst, *s_ms[MAIN_ROUTE], s_bound[MAIN_ROUTE], None,
            s_f32[MAIN_ROUTE]),
        row("adaattn_dq", "adaattn_bwd.cu", pallas + "adaattn_kernel.py:183",
            *bwd["adaattn_dq"]),
        row("adaattn_dkv", "adaattn_bwd.cu",
            pallas + "adaattn_kernel.py:220", *bwd["adaattn_dkv"]),
        row("mega_block", "mega_block.cu", pallas + "megablock.py:117",
            m_worst, m_ms, m_plain, m_bound, None, m_f32),
        row("fused_sums", "fused_2pass.cu", pallas + "fused_block.py:68",
            *two_pass["fused_sums"], None,
            two_pass["fused_sums" + F32_TAG][1:] + [
                two_pass["fused_sums" + F32_TAG][0]]),
        row("fused_project", "fused_2pass.cu", pallas + "fused_block.py:68",
            *two_pass["fused_project"], None,
            two_pass["fused_project" + F32_TAG][1:] + [
                two_pass["fused_project" + F32_TAG][0]]),
    ] + [row(name, source, "scripts/" + replaces, *probe_rows[name])
         for name, source, replaces in PROBE_ROWS]
    log("kernels: launches = sum over the routes' requests, the sizes "
        "phase's 1024px and 720px requests (sizes), the timed "
        "train steps, the GAN phase's timed steps (gan), the lifecycle "
        "phase's runs (warm-started-ast: its AST "
        "steps; flax: the graph engine's requests; recalibrated-auto: the "
        "recalibrated fused engine's requests), the dp phase's runs summed "
        "over its 2 ranks (dp-train: the timed steps; dp-serve: the \"auto\" "
        "requests; dp-graph: the graph engine's requests) and the two probe "
        "drivers' "
        "runs (counted per route, path or driver); for the stylize kernels "
        "max_abs_err is the worst output error over their 512px bf16 cases "
        "(f32_request, on expand_dw, flat_block, flat_s2_block and "
        "mega_block: the same per 512px batch-8 f32 request, the f32 path "
        "rows; on adaattn_fwd: its f32 serving form at the taps-f32 call, "
        "with library_ms the sdpa f32 forward, f64_form_ms the float64 "
        "form's ms on the same inputs and launches the serving form's f32 "
        "launches over the run's counted paths) "
        "(hidden for expand_dw, mean/std of the AdaAttN taps case) and ms, "
        "plain_ms, bound_ms are device ms per 512px batch-8 request (fused "
        "route for expand_dw, the AdaAttN taps call for adaattn_fwd, the "
        f"{MAIN_ROUTE} route for the flat kernels, the mega route for "
        "mega_block); fused_sums and fused_project (modes \"sums\" and "
        "\"project\" of the same TPU kernel) run on no route, so their "
        "launches are 0, and their ms, plain_ms and bound_ms are the sums "
        "over the 15 blocks of the fused route's request at those shapes, "
        "max_abs_err over their sums (resp. y) there; for adaattn_dq/dkv they "
        f"are per {TRAIN_SIZES[-1]}px batch-{TRAIN_BATCH} f32 train step (2 "
        "launches), max_abs_err over dq (resp. dk, dv) at that shape, and "
        "library_ms is the sdpa backward (forward+backward less forward), "
        "which computes dq, dk and dv at once; library_ms of adaattn_fwd is "
        "the sdpa forward of the taps call; bounds at the H100 SXM peaks "
        "(bf16 989 TFLOP/s, f32 67 TFLOP/s, HBM 3.35 TB/s), the block "
        "kernels' f32 depthwise at the f32 peak, adaattn_dq/dkv's float64 "
        "logits and T at the f64 peak (67 TFLOP/s) and their other products "
        "at a third of the TF32 peak (495 TFLOP/s; 3xTF32); the probe rows "
        "run on no "
        "route, their launches are the probe drivers' (probe_mega2 for "
        "copy, products and depthwise, probe_vpu_rate for the rates) and "
        "their ms the drivers' measurements; for probe_copy, probe_mm_* and "
        "probe_dw_* ms, plain_ms, bound_ms and library_ms are sums over the "
        "JAX probe script's two default shapes (copy: best of 3 windows of "
        "20 calls, bit-exact, max_abs_err 0, library x * 1.0; products: the "
        "slope between 12 and 3 chained calls, L2-resident, max_abs_err over "
        "both shapes, library the faster of torch.einsum and "
        "torch.matmul(w.t(), x) in bf16 at each shape (the probes phase "
        "names it); depthwise: best of 3 "
        "windows with the inputs cycled past L2, f32, library "
        "F.conv2d(groups=C) on NCHW, circular in W for probe_dw_t); "
        "probe_rate is the fma f32 par 8 case at (256, 4096), 512 reps "
        "(slope method; its max_abs_err over the whole tile, library "
        "null)")
    log(f"train: {train_ms:.3f} ms per {TRAIN_SIZES[-1]}px batch-"
        f"{TRAIN_BATCH} f32 step ({1000 / train_ms:.3f} steps/s), peak "
        f"memory {train_peak:.2f} GiB")
    log(f"gan: {gan_ms:.3f} ms per {TRAIN_SIZES[-1]}px batch-{TRAIN_BATCH} "
        f"f32 GAN step without R1, {[round(t, 3) for t in gan_r1_ms]} ms "
        f"with R1, peak memory {gan_peak:.2f} GiB; on {card}")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
