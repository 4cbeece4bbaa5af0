#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py

1. Refuses to run without CUDA; prints the card's name and power limit.
2. Builds the port's kernels from ``arbitrarystyletransfer_tpu_torch/csrc``.
3. Kernel phase: each kernel's wrapper against its plain PyTorch twin on the
   card, at every shape the 512px batch-8 stylize routes and the training
   step give it (and a few off-path shapes that take the kernels' other
   code paths), with the max error against a stated tolerance and the
   device times (CUDA events) of the kernel, the twin and, where one
   PyTorch call computes the same function, that call (the SDPA yardstick
   of the AdaAttN kernels; never on the port's path).  The bf16
   ``adaattn_fwd`` (tensor cores) is held elementwise to
   ``adaattn_fwd_error_bound``, and at both dtypes to the exact answer of a
   one-hot softmax (std exactly 0: the check that sees v^2 fed in exactly),
   and timed against the CUDA-core kernel it replaced.  Two A/B times per
   shape: ``mega_block`` against ``flat_block`` on the same block
   (the (N, H, C, W) layout against NHWC), and the two-pass block
   (``fused_sums`` + ``fused_project``) against the fused route's block
   (``expand_dw`` + the PyTorch epilogue).  Then the probe kernels
   (``ops/kernels/probes.py``: copy, the two product schedules, the two
   depthwise layouts, the issue rates) at the JAX probe scripts' default
   shapes, each against its twin (the copy bit-exact), with a library call
   beside all but the rates; then the two probe drivers as a user runs
   them, the counters reset just before each and read just after (each
   must launch exactly its kernels' expected counts), their JSON lines,
   and the probe rows' times taken from them.  Then e2 on the plain route at 512px, timed
   as it is and with its two repairs undone (bf16 products before the
   bias, the NCHW pad).  Then rows 1 and 4 by sweep at every path shape
   (``sweeps_phase``: each sweep's device ms, bound, share of it, rates,
   registers and CTAs per SM), after ragged shapes off the path through
   every sweep-1 mode and both sweep-2 layouts (H, W, E not multiples of
   the sweeps' tiles and channel chunks), held to the same gates.
4. Routes: ``StylePipeline`` in bfloat16 with the AdaAttN kernel answers
   requests of 8 content/style pairs at 512x512 through four block routes:
   "fused"/"fused" (3 requests), "flat-all" (4; every block the flat kernels
   take), "auto" (2; the CLI's default) and "mega" (3; 13 ``mega_block``
   and 2 ``expand_dw`` launches).  For each route the launch
   counters are reset just before its requests and read just after, and
   each request must launch exactly the route's kernels; outputs must be
   finite and unsaturated; request 1 is held against the same pipeline
   forced through the plain twins (bf16, and f32 through both).  Prints ms
   per request, img/s, the A/B of ``adaattn_fwd`` against the CUDA-core
   kernel it replaced (in turns, on one request) and a profiler breakdown
   of one request per route, with its layout copies and pads.
5. Training: ``ASTTrainer`` (full-width ``ModelConfig`` with the AdaAttN
   kernels, f32, batch 8, the seeded random VGG, in-memory uniform batches,
   no previews).  The step through the kernels is held against the step
   with the AdaAttN stage in float64 (the loss and the AdaAttN projection
   gradients, as close as the twins' step or within a stated share) and
   against the kernel forward with the twins' backward (the gradients; see
   ``kernel_vs_twin_step``); one warm-up step per bucket (96, 128, 160px),
   then timed steps at 160px, each of which must launch exactly 2
   ``adaattn_fwd``, 2 ``adaattn_dq`` and 2 ``adaattn_dkv`` and nothing else,
   with a finite loss, a step counter that advances and BatchNorm buffers
   that move; a checkpoint save/restore round trip; a profile of one step
   by phase and by kernel.
6. Prints each phase's seconds, one JSON line per the kernels (with each
   kernel's bound: the larger of its bytes over the HBM rate and its
   operations over the peak of their type), the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.  Any failure raises: exit code != 0.

Weights are random from a seed.  They are drawn at fan-in scale with the
SE gates mostly open and the head normalized (as in tests/test_torch_*.py),
because the reference initialization closes the SE gates and the decoder
then emits a constant image that would hide any difference.
"""

from __future__ import annotations

import dataclasses
import json
import math
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


# Kernel launches per 512px batch-8 request, by route: (encoder_impl and
# decoder_impl, requests, {kernel: launches}).  "mega" (slice 4): 13
# mega_block (e1, e3, d3-d13), 2 expand_dw (e5, e6 at 128px).
ROUTES = (
    ("fused", 3, counts(expand_dw=15, adaattn_fwd=1)),
    ("flat-all", 4, counts(adaattn_fwd=1, flat_block=15, flat_s2_block=2)),
    ("auto", 2, counts(expand_dw=10, adaattn_fwd=1, flat_block=5,
                       flat_s2_block=1)),
    ("mega", 3, counts(expand_dw=2, adaattn_fwd=1, mega_block=13)),
)
MAIN_ROUTE = "flat-all"  # the stylize routes' main path (slice 2)

# Training (slice 3's main path): ASTTrainer, full-width ModelConfig with the
# AdaAttN kernels, f32, batch 8, one warm-up step per bucket, then timed
# steps at the last bucket.  Launches per step: one forward and one backward
# per AdaAttN module (two modules), nothing else.
TRAIN_BATCH, TRAIN_SIZES, TRAIN_STEPS = 8, (96, 128, 160), 6
# Batches on which the kernel step is held against the twins' and the
# float64 step (``kernel_vs_twin_step``): their conditioning differs.
STEP_BATCHES = 3
TRAIN_LAUNCHES = counts(adaattn_fwd=2, adaattn_dq=2, adaattn_dkv=2)
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
)
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
# bf16 tensor cores, f32 on the CUDA cores, HBM3.
PEAK_BF16, PEAK_F32, HBM_BYTES_S = 989e12, 67e12, 3.35e12

# Every distinct expand_dw shape of the 512px batch-8 request: name, batch
# (the encoder runs content and style stacked: 16), H=W, C_in, E, k,
# folded-BN biases, launches per request on the fused route.
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
)
# flat_block shapes: name, batch, H=W, C_in, E, C_out, k, folded-BN biases,
# residual, dtype, launches per request on "flat-all" and on "auto".  The
# last four are off the 512px path: the CLI's 320px width, the f32 path,
# the expand==1 form, and a C_in that is not a multiple of 8 with an odd
# C_out and size (the CUDA-core expand and projection, partial tiles).
FLAT_BLOCK_CASES = (
    ("e1", 16, 512, 16, 96, 16, 3, True, True, "bfloat16", 1, 1),
    ("e3", 16, 256, 24, 144, 24, 3, True, True, "bfloat16", 1, 1),
    ("e5-e6", 16, 128, 40, 160, 40, 5, True, True, "bfloat16", 2, 0),
    ("d3", 8, 128, 96, 288, 96, 5, False, True, "bfloat16", 1, 0),
    ("d4", 8, 128, 96, 384, 80, 5, False, False, "bfloat16", 1, 0),
    ("d5-d6", 8, 256, 80, 320, 80, 3, False, True, "bfloat16", 2, 0),
    ("d7", 8, 256, 80, 320, 40, 3, False, False, "bfloat16", 1, 0),
    ("d8-d9", 8, 512, 40, 160, 40, 5, False, True, "bfloat16", 2, 0),
    ("d10", 8, 512, 40, 240, 24, 5, False, False, "bfloat16", 1, 0),
    ("d11", 8, 512, 24, 144, 24, 3, False, True, "bfloat16", 1, 1),
    ("d12", 8, 512, 24, 144, 16, 3, False, False, "bfloat16", 1, 1),
    ("d13", 8, 512, 16, 96, 16, 3, False, True, "bfloat16", 1, 1),
    ("d10@320", 8, 320, 40, 240, 24, 5, False, False, "bfloat16", 0, 0),
    ("e1-f32", 2, 128, 16, 96, 16, 3, True, True, "float32", 0, 0),
    ("expand1", 2, 128, 40, 40, 40, 3, True, True, "bfloat16", 0, 0),
    ("cin12", 2, 37, 12, 48, 13, 5, True, False, "bfloat16", 0, 0),
)
# flat_s2_block shapes: name, batch, input H=W, C_in, E, C_out, k, biases,
# dtype, launches per request on "flat-all" and on "auto"; the last two are
# off the path (the f32 path with its 8x8 tiles; the CUDA-core expand and
# projection with partial tiles).
FLAT_S2_CASES = (
    ("e2", 16, 512, 16, 96, 24, 3, True, "bfloat16", 1, 0),
    ("e4", 16, 256, 24, 144, 40, 5, True, "bfloat16", 1, 1),
    ("e4-f32", 2, 64, 24, 144, 40, 5, True, "float32", 0, 0),
    ("cin12", 2, 36, 12, 48, 13, 3, True, "bfloat16", 0, 0),
)
# mega_block shapes (x is (N, H, C_in, W)): name, batch, H, W, C_in, E,
# C_out, k, folded-BN biases, residual, dtype, launches per "mega" request.
# The 11 rows of the 512px path, then off the path: the f32 path, the
# expand==1 form, a C_out that is not a multiple of 16, an odd H, an H below
# the 16-row tile, and a C_in that is not a multiple of 8 with an odd C_out
# and a W whose last tile is partial (the scalar staging).
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
)
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
)
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
        ("rag-k3", 2, 37, 16, 48, 16, 3, True, True, "bfloat16", 0, 0),
        ("rag-k5", 2, 37, 40, 48, 24, 5, False, False, "bfloat16", 0, 0)),
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
# AdaAttN: both taps stacked (2B = 16 images of 64x64 = 4096 positions).
# name, B, Nc, Ns, dtype, scale of q and k (logits of std 128^0.5 scale^2:
# ~1 at 0.3, ~3.4 at 0.55, a peaked softmax), the main path's call.  The
# bf16 cases take the tensor-core kernel, held to adaattn_fwd_error_bound;
# ragged-nc has partial query and key tiles; ragged-f32 takes the CUDA-core
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
        """A block kernel's launches: its 1x1 products at the peak of the
        I/O dtype of ``size`` bytes (bf16 tensor cores, or f32), its
        depthwise at the f32 peak (it runs in f32 at every dtype, as the
        TPU kernels' semantics ask)."""
        self.add(nbytes, mm_flops, PEAK_BF16 if size == 2 else PEAK_F32,
                 times)
        self.add(0, dw_flops, PEAK_F32, times)

    def ms(self):
        return 1e3 * max(self.nbytes / HBM_BYTES_S, self.ops_s)

    def by(self):
        return ("bytes" if self.nbytes / HBM_BYTES_S >= self.ops_s
                else "operations")


def sdpa_yardstick(q, k, v, backward=False, iters=5):
    """Device ms of one ``F.scaled_dot_product_attention(q, k, cat([v,
    v*v]), scale=1.0)`` call (with ``backward``: forward plus the gradients
    of q, k, v under autograd): A [v, v^2] and its gradients, the function
    of the AdaAttN kernels.  A yardstick only; the port never calls it.
    Tries the fused backends in the inputs' dtype, then in bf16, then the
    math backend; returns (ms, what was timed)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    fused = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
             SDPBackend.CUDNN_ATTENTION]
    attempts = [(q.dtype, fused, "fused")]
    if q.dtype != torch.bfloat16:
        attempts.append((torch.bfloat16, fused, "fused"))
    attempts.append((q.dtype, [SDPBackend.MATH], "math"))
    for dt, backends, label in attempts:
        qq, kk, vv = (t.detach().to(dt)[:, None].requires_grad_(backward)
                      for t in (q, k, v))
        g = (torch.randn(*qq.shape[:-1], 2 * qq.shape[-1], device=q.device,
                         dtype=dt) if backward else None)

        def run():
            with sdpa_kernel(backends):
                out = F.scaled_dot_product_attention(
                    qq, kk, torch.cat([vv, vv * vv], dim=-1), scale=1.0)
                if backward:
                    torch.autograd.grad(out, (qq, kk, vv), g)

        try:
            run()
            torch.cuda.synchronize()
        except RuntimeError as exc:
            log(f"  sdpa {label} {dt}: refused ({str(exc).splitlines()[0][:100]})")
            continue
        return timed_ms(run, iters=iters, warmup=1), f"{label} {dt}"
    raise AssertionError("no SDPA backend took the yardstick")


def expand_dw_phase(gen, cases=None):
    import torch
    from arbitrarystyletransfer_tpu_torch.ops.kernels.expand_dw import (
        expand_dw,
        expand_dw_reference,
    )

    worst = 0.0
    ms = plain_ms = 0.0
    bound = Bound()
    # Off the main path: the expand==1 form, and a C_in that is not a
    # multiple of 8 (the CUDA-core expand instead of the tensor cores).
    if cases is None:
        cases = EXPAND_DW_CASES + (("expand1", 2, 128, 40, 40, 3, True, 0),
                                   ("cin12", 2, 37, 12, 40, 5, True, 0))
    for name, n, hw, c_in, e, k, bn, per_req in cases:
        expand = name != "expand1"
        dev = dict(device=DEVICE)
        x = torch.randn(n, hw, hw, c_in, generator=gen, **dev).bfloat16()
        we = (torch.randn(c_in, e, generator=gen, **dev) / math.sqrt(c_in)
              if expand else None)
        wd = torch.randn(k, k, e, generator=gen, **dev) / k
        be = 0.1 * torch.randn(e, generator=gen, **dev) if bn else None
        bd = 0.1 * torch.randn(e, generator=gen, **dev) if bn else None
        args = (x, we, wd, k, expand, be, bd)
        hidden, sums = expand_dw(*args)
        torch.cuda.synchronize()
        r_hidden, r_sums = expand_dw_reference(*args)
        err_h, err_s = max_err(hidden, r_hidden), max_err(sums, r_sums)
        tol_h = BF16_TOL * float(r_hidden.float().abs().max())
        tol_s = SUMS_TOL * float(r_sums.abs().max())
        worst = max(worst, err_h)
        del hidden, sums, r_hidden, r_sums
        t_k = timed_ms(lambda: expand_dw(*args))
        t_p = timed_ms(lambda: expand_dw_reference(*args), iters=3, warmup=1)
        ms += per_req * t_k
        plain_ms += per_req * t_p
        bound.add_block(2 * n * hw * hw * (c_in + e) + 4 * n * e,
                        2 * n * hw * hw * e * c_in * expand,
                        2 * n * hw * hw * e * k * k, 2, per_req)
        log(f"expand_dw {name:8s} x={tuple(x.shape)} E={e} k={k} bn={bn}: "
            f"hidden err {err_h:.4g} (tol {tol_h:.4g}), sums err "
            f"{err_s:.4g} (tol {tol_s:.4g}); kernel {t_k:.4f} ms, "
            f"plain {t_p:.4f} ms")
        check(err_h <= tol_h and err_s <= tol_s, f"expand_dw {name} differs")
        torch.cuda.empty_cache()
    return worst, ms, plain_ms, bound


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


def sweeps_phase(gen):
    """Rows 1 and 4 by sweep at every shape of their path: each sweep's
    device ms (a profiler trace), its own bound (sweep 1: the f32
    depthwise at the f32 peak and the expand at the bf16 peak against x,
    the hidden and the sums at HBM; sweep 2: the hidden, the sums, y and
    the residual at HBM against the projection at the bf16 peak), its
    share of it, its TFLOP/s and TB/s, its kernel's registers, shared
    memory and CTAs per SM (``scripts/sweep_times.py``, one JSON line per
    shape and sweep); then each sweep's ms per request."""
    from arbitrarystyletransfer_tpu_torch.scripts.sweep_times import (
        time_sweeps,
    )

    records = time_sweeps(
        gen, [c for c in EXPAND_DW_CASES if c[-1]],
        [c for c in FLAT_BLOCK_CASES if c[-2] or c[-1]], DEVICE, log)
    per_req = {}
    for r in records:
        key = f"{r['kernel']} {r['sweep']}"
        per_req[key] = per_req.get(key, 0.0) + r["ms"] * r["per_request"]
    log("sweeps per request (expand_dw on \"fused\", flat_block on "
        "\"flat-all\"): " + ", ".join(f"{k} {v:.4f} ms"
                                       for k, v in per_req.items()))
    return per_req


def adaattn_simt(is_bf16):
    """``adaattn_fwd`` through ``adaattn_fwd_simt_launch``, the CUDA-core
    kernel (at bf16 the kernel the tensor-core one replaced), for A/B
    timing only: it counts no launch."""
    import torch
    from arbitrarystyletransfer_tpu_torch.ops.kernels._build import (
        check,
        load_library,
    )

    def run(q, k, v):
        b, nc, _ = q.shape
        mean, std = torch.empty_like(q), torch.empty_like(q)
        m = torch.empty(b, nc, device=q.device)
        l = torch.empty(b, nc, device=q.device)
        check(load_library().adaattn_fwd_simt_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mean.data_ptr(),
            std.data_ptr(), m.data_ptr(), l.data_ptr(), b, nc, k.shape[1],
            128, int(is_bf16), torch.cuda.current_stream().cuda_stream),
            "adaattn_fwd_simt_launch")
        return mean, std, m, l

    return run


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
    simt = adaattn_simt(True)
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
            # A/B in turns on the same inputs: the CUDA-core kernel that
            # this one replaced.
            t_s = timed_ms(lambda: simt(q, k, v), iters=3, warmup=1)
            t_k2 = timed_ms(lambda: adaattn_fwd(q, k, v), iters=5)
            extra = (f", again {t_k2:.4f} ms; library (sdpa {what}, forward)"
                     f" {library_ms:.4f} ms (kernel/sdpa "
                     f"{t_k / library_ms:.3f}); A/B: the CUDA-core kernel it "
                     f"replaced {t_s:.4f} ms ({t_s / t_k:.2f}x); bound "
                     f"{bound.ms():.4f} ms "
                     f"({bound.by()}), {6 * b * nc * ns * 128 / t_k / 1e9:.1f}"
                     f" TFLOP/s of the function's work")
        log(f"adaattn_fwd {name:10s} q={tuple(q.shape)} Ns={ns} {dtype} "
            f"scale {scale}: " + ", ".join(errs) + f"; kernel {t_k:.4f} ms, "
            f"plain {t_p:.4f} ms" + extra)
        del q, k, v, ref, bounds
        torch.cuda.empty_cache()
    one_hot_check(torch.Generator(device=DEVICE).manual_seed(SEED + 7))
    return worst, ms, plain_ms, bound, library_ms


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


def flat_kernel_phase(gen, name, fn, ref_fn, cases, stride):
    """One flat kernel against its twin at each case; returns the worst y
    error of the path's cases and the device ms per request of "flat-all"
    (kernel, twin) and of "auto" (kernel, twin)."""
    import torch

    worst = 0.0
    per_route = {"flat-all": [0.0, 0.0], "auto": [0.0, 0.0]}
    bounds = {"flat-all": Bound(), "auto": Bound()}
    for case in cases:
        label, n, hw, c_in, e, c_out, k, bn = case[:8]
        residual = case[8] if stride == 1 else False
        dtype, per_all, per_auto = case[-3:]
        dt = getattr(torch, dtype)
        expand = label != "expand1"
        x = torch.randn(n, hw, hw, c_in, generator=gen, device=DEVICE).to(dt)
        (we, wd, se, wp), (be, bd, pb) = random_block(gen, c_in, e, c_out, k,
                                                      bn, expand)
        kw = dict(b_expand=be, b_dw=bd, proj_bias=pb)
        if stride == 1:
            kw.update(pre_act=expand, identity=residual)
        args = (x, we, wd, se, wp, k)
        y, sums = fn(*args, **kw)
        torch.cuda.synchronize()
        r_y, r_sums = ref_fn(*args, **kw)
        err_y, err_s = max_err(y, r_y), max_err(sums, r_sums)
        rel = BF16_TOL if dt == torch.bfloat16 else F32_TOL
        tol_y = rel * float(r_y.float().abs().max())
        tol_s = SUMS_TOL * float(r_sums.abs().max())
        if per_all or per_auto:
            worst = max(worst, err_y)
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
        for route, per_req in (("flat-all", per_all), ("auto", per_auto)):
            per_route[route][0] += per_req * t_k
            per_route[route][1] += per_req * t_p
            bounds[route].add_block(nbytes, mm, dw, size, per_req)
        log(f"{name} {label:8s} x={tuple(x.shape)} E={e} C_out={c_out} "
            f"k={k} bn={bn} res={residual} {dtype}: y err {err_y:.4g} (tol "
            f"{tol_y:.4g}), sums err {err_s:.4g} (tol {tol_s:.4g}); kernel "
            f"{t_k:.4f} ms, plain {t_p:.4f} ms")
        check(err_y <= tol_y and err_s <= tol_s, f"{name} {label} differs")
        torch.cuda.empty_cache()
    for route, (t_k, t_p) in per_route.items():
        if t_k:  # the route runs some of these cases
            log(f"{name} per {route} request: kernel {t_k:.4f} ms, plain "
                f"{t_p:.4f} ms, bound {bounds[route].ms():.4f} ms "
                f"({bounds[route].by()})")
    return worst, per_route, bounds


def block_cost(n, h, w, c_in, e, c_out, k, size, expand=True):
    """(bytes, 1x1 operations, depthwise operations) of one whole stride-1
    block: x read, y written, the sums; the expand and the projection; the
    depthwise."""
    nbytes = size * n * h * w * (c_in + c_out) + 4 * n * e
    return (nbytes, 2 * n * h * w * e * (c_in * expand + c_out),
            2 * n * h * w * e * k * k)


def mega_phase(gen, cases=MEGA_CASES):
    """mega_block against its twin at every case, with flat_block timed on
    the same block (NHWC) beside it; returns the worst y error of the
    path's cases, (kernel, twin) device ms per "mega" request and the
    bound."""
    import torch
    from arbitrarystyletransfer_tpu_torch.ops.kernels.flat_block import (
        flat_block,
    )
    from arbitrarystyletransfer_tpu_torch.ops.kernels.mega_block import (
        mega_block,
        mega_block_reference,
    )

    worst, ms, plain_ms, bound = 0.0, 0.0, 0.0, Bound()
    for (label, n, h, w, c_in, e, c_out, k, bn, residual, dtype,
         per_req) in cases:
        dt = getattr(torch, dtype)
        expand = label != "expand1"
        xt = torch.randn(n, h, c_in, w, generator=gen, device=DEVICE).to(dt)
        (we, wd, se, wp), (be, bd, pb) = random_block(gen, c_in, e, c_out, k,
                                                      bn, expand)
        kw = dict(pre_act=expand, b_expand=be, b_dw=bd, proj_bias=pb,
                  identity=residual)
        args = (we, wd, se, wp, k)
        y, sums = mega_block(xt, *args, **kw)
        torch.cuda.synchronize()
        r_y, r_sums = mega_block_reference(xt, *args, **kw)
        err_y, err_s = max_err(y, r_y), max_err(sums, r_sums)
        rel = BF16_TOL if dt == torch.bfloat16 else F32_TOL
        tol_y = rel * float(r_y.float().abs().max())
        tol_s = SUMS_TOL * float(r_sums.abs().max())
        check(tuple(y.shape) == (n, h, c_out, w) and y.dtype == dt,
              f"mega_block {label}: output {tuple(y.shape)} {y.dtype}")
        if per_req:
            worst = max(worst, err_y)
        del y, sums, r_y, r_sums
        t_k = timed_ms(lambda: mega_block(xt, *args, **kw))
        t_p = timed_ms(lambda: mega_block_reference(xt, *args, **kw),
                       iters=3, warmup=1)
        # A/B: the same block on NHWC through flat_block (other rounding
        # points, so times only).
        x = xt.permute(0, 1, 3, 2).contiguous()
        t_f = timed_ms(lambda: flat_block(x, *args, **kw))
        del x
        ms += per_req * t_k
        plain_ms += per_req * t_p
        size = xt.element_size()
        cost = block_cost(n, h, w, c_in, e, c_out, k, size, expand)
        bound.add_block(*cost, size, per_req)
        one = Bound()
        one.add_block(*cost, size)
        log(f"mega_block {label:8s} x={tuple(xt.shape)} E={e} C_out={c_out} "
            f"k={k} bn={bn} res={residual} {dtype}: y err {err_y:.4g} (tol "
            f"{tol_y:.4g}), sums err {err_s:.4g} (tol {tol_s:.4g}); kernel "
            f"{t_k:.4f} ms, plain {t_p:.4f} ms, bound {one.ms():.4f} ms "
            f"({one.by()}); A/B flat_block on NHWC {t_f:.4f} ms (mega/flat "
            f"{t_k / t_f:.3f})")
        check(err_y <= tol_y and err_s <= tol_s, f"mega_block {label} differs")
        del xt
        torch.cuda.empty_cache()
    if any(case[-1] for case in cases):
        log(f"mega_block per mega request: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound.ms():.4f} ms ({bound.by()})")
    return worst, ms, plain_ms, bound


def two_pass_phase(gen, cases=TWO_PASS_CASES):
    """fused_sums and fused_project against their twins at every case, and
    the two-pass block timed against the fused route's block (expand_dw +
    the PyTorch epilogue); returns {kernel: [worst error, ms, plain ms,
    Bound]} summed over the 15 fused-route blocks of a request."""
    import torch
    from arbitrarystyletransfer_tpu_torch.ops.basic import se_gate
    from arbitrarystyletransfer_tpu_torch.ops.blocks import matmul_f32
    from arbitrarystyletransfer_tpu_torch.ops.kernels.expand_dw import (
        expand_dw,
    )
    from arbitrarystyletransfer_tpu_torch.ops.kernels.fused_2pass import (
        fused_project,
        fused_project_reference,
        fused_sums,
        fused_sums_reference,
    )

    out = {name: [0.0, 0.0, 0.0, Bound()]
           for name in ("fused_sums", "fused_project")}
    ab = [0.0, 0.0]  # per request: two-pass block, fused route's block
    for (label, n, hw, c_in, e, c_out, k, bn, residual, dtype,
         per_req) in cases:
        dt = getattr(torch, dtype)
        expand = label != "expand1"
        x = torch.randn(n, hw, hw, c_in, generator=gen, device=DEVICE).to(dt)
        (we, wd, se, wp), (be, bd, pb) = random_block(gen, c_in, e, c_out, k,
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
        r_y = fused_project_reference(x, we, wd, k, gate, wp,
                                      identity=in_kernel, **common)
        err_s, err_y = max_err(sums, r_sums), max_err(y, r_y)
        rel = BF16_TOL if dt == torch.bfloat16 else F32_TOL
        tol_y = rel * float(r_y.float().abs().max())
        tol_s = SUMS_TOL * float(r_sums.abs().max())
        check(tuple(y.shape) == (n, hw, hw, c_out) and y.dtype == dt,
              f"fused_project {label}: output {tuple(y.shape)} {y.dtype}")
        if per_req:
            out["fused_sums"][0] = max(out["fused_sums"][0], err_s)
            out["fused_project"][0] = max(out["fused_project"][0], err_y)
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
            out[name][1] += per_req * t_k
            out[name][2] += per_req * t_p
            out[name][3].add_block(*costs[name], size, per_req)
            one = Bound()
            one.add_block(*costs[name], size)
            report.append(f"{name} {t_k:.4f} ms (plain {t_p:.4f}, bound "
                          f"{one.ms():.4f} {one.by()})")
        log(f"fused_2pass {label:8s} x={tuple(x.shape)} E={e} C_out={c_out} "
            f"k={k} bn={bn} res={residual} {dtype}: sums err {err_s:.4g} "
            f"(tol {tol_s:.4g}), y err {err_y:.4g} (tol {tol_y:.4g}); "
            + ", ".join(report) + f"; A/B block: two-pass {t_2p:.4f} ms, "
            f"expand_dw + epilogue {t_fr:.4f} ms")
        check(err_s <= tol_s and err_y <= tol_y, f"fused_2pass {label} "
              "differs")
        del x
        torch.cuda.empty_cache()
    if any(case[-1] for case in cases):
        for name, (_, t_k, t_p, b) in out.items():
            log(f"{name} over the 15 fused-route blocks: kernel {t_k:.4f} "
                f"ms, plain {t_p:.4f} ms, bound {b.ms():.4f} ms ({b.by()})")
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
    by the drivers' methods, on its own inputs."""
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

    timed, per_call = probe_mega2.timed, probe_vpu_rate.per_call_ms
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
            t_l = per_call(lambda: torch.einsum("rcw,ce->rew", x, wt))
            t_p = timed_ms(lambda: P.probe_mm_reference(x, wt), iters=3,
                           warmup=1)
            for name, kern in (("probe_mm_einsum", P.probe_mm_einsum),
                               ("probe_mm_rowloop", P.probe_mm_rowloop)):
                y = kern(x, wt)
                torch.cuda.synchronize()
                err = max_err(y, ref)
                out[name][2].add(2 * (x.numel() + wt.numel() + y.numel()),
                                 2 * r * c * e * w, PEAK_BF16)
                add(name, err, t_p, t_l)
                log(f"{name} {key}: err {err:.4g} (tol {tol:.4g}); plain "
                    f"{t_p:.4f} ms, library (einsum bf16) {t_l * 1e3:.2f} us")
                check(tuple(y.shape) == (r, e, w) and y.dtype == dt
                      and err <= tol, f"{name} {key} differs")
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
                log(f"{name} {key}: err {err:.4g} (tol {tol:.4g}); plain "
                    f"{t_p:.4f} ms, library (conv2d groups=C, NCHW, inputs "
                    f"cycled past L2) {t_l * 1e3:.2f} us (its err "
                    f"{lib_err:.3g}), bound "
                    f"{nbytes / HBM_BYTES_S * 1e3 * 1e3:.2f} us")
                check(tuple(y.shape) == tuple(ref.shape) and err <= tol,
                      f"{name} {key} differs")
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

    launches = {}
    for impl, n_requests, expected in ROUTES:
        route = StylePipeline(cfg, engine="fused", device=DEVICE,
                              state=pipe.state, encoder_impl=impl,
                              decoder_impl=impl)
        launches[impl] = drive_route(route, impl, requests[:n_requests],
                                     expected)
        torch.cuda.empty_cache()
    return launches


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

    # Request 1 again through the plain twins (bf16 and f32), and through
    # the kernels at f32.
    content, style, alpha = requests[0]
    plain, plain_times = run_plain(pipe, content, style, alpha, repeats=3)
    check(dict(LAUNCHES) == launches, "the plain run launched a kernel")
    pipe32 = StylePipeline(
        dataclasses.replace(pipe.cfg, compute_dtype="float32"),
        engine="fused", device=DEVICE, state=pipe.state,
        encoder_impl=impl, decoder_impl=impl)
    out32 = pipe32.stylize(content, style, alpha)
    plain32, _ = run_plain(pipe32, content, style, alpha, repeats=1)

    def errs(a, b):
        d = (a - b).abs()
        return float(d.max()), float(d.mean())

    k32 = errs(out32, plain32)
    k16 = errs(outs[0], plain)
    floor16 = errs(plain, plain32)
    del out32, plain32
    log(f"{impl} request 1, f32, kernels vs plain twins: max abs {k32[0]:.4g} "
        f"(tol {IMAGE_F32_TOL[0]}), mean abs {k32[1]:.4g} (tol "
        f"{IMAGE_F32_TOL[1]})")
    log(f"{impl} request 1, bf16, kernels vs plain twins: max abs "
        f"{k16[0]:.4g}, mean abs {k16[1]:.4g}; the bf16 plain path's own "
        f"error vs f32: max abs {floor16[0]:.4g}, mean abs {floor16[1]:.4g} "
        f"(tol {IMAGE_BF16_FACTOR}x that)")
    check(k32[0] <= IMAGE_F32_TOL[0] and k32[1] <= IMAGE_F32_TOL[1],
          f"{impl}: f32 kernel path and plain path disagree")
    check(k16[0] <= IMAGE_BF16_FACTOR * floor16[0]
          and k16[1] <= IMAGE_BF16_FACTOR * floor16[1],
          f"{impl}: bf16 kernel path differs from the plain path by more "
          "than bf16 itself does")

    ms = statistics.median(times[1:])
    plain_ms = statistics.median(plain_times[1:])
    ab = adaattn_route_ab(pipe, requests[-1])
    log(f"route {impl} A/B, ms per request in turns (earlier, now, earlier, "
        f"now): adaattn_fwd on the CUDA-core kernel it replaced "
        f"{ab['earlier']}, on the tensor-core kernel {ab['now']}")
    log(f"route {impl}: median {ms:.3f} ms/request over requests "
        f"2-{len(requests)} ({BATCH * 1000 / ms:.2f} img/s at {SIZE}px "
        f"batch {BATCH}); plain twins {plain_ms:.3f} ms/request "
        f"({BATCH * 1000 / plain_ms:.2f} img/s); peak memory "
        f"{peak_gib:.2f} GiB")
    profile_request(pipe, impl, content, style, alpha,
                    top=15 if impl in (MAIN_ROUTE, "mega") else 8)
    return launches


def adaattn_route_ab(pipe, request):
    """ms of ``pipe.stylize(*request)`` with ``adaattn_fwd`` through the
    CUDA-core kernel that the tensor-core one replaced at bf16 ("earlier")
    and through the kernel ("now"), in turns."""
    import torch
    from arbitrarystyletransfer_tpu_torch.ops.kernels import (
        adaattn_fwd as adaattn_mod,
    )

    kernel = adaattn_mod.adaattn_fwd
    earlier = adaattn_simt(pipe.dtype == torch.bfloat16)
    times = {"earlier": [], "now": []}
    for label in ("earlier", "now", "earlier", "now"):
        adaattn_mod.adaattn_fwd = earlier if label == "earlier" else kernel
        try:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            pipe.stylize(*request)
            end.record()
            torch.cuda.synchronize()
        finally:
            adaattn_mod.adaattn_fwd = kernel
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
    """e2 at 512px (the stride-2 block that "fused", "auto" and "mega" run
    on the plain route) in bf16, timed in turns as it is now and as it was
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


def adaattn_bwd_phase(gen):
    """adaattn_dq and adaattn_dkv against their twins at every case, with
    the forward kernel's time at the training buckets; returns
    {kernel: (worst error, ms, plain ms, Bound, library ms)} per 160px
    training step."""
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

    out = {name: [0.0, 0.0, 0.0, Bound(), None]
           for name in ("adaattn_dq", "adaattn_dkv")}
    for name, b, nc, ns, dtype, dm_dtype, per_step in BWD_CASES:
        dt, dmt = getattr(torch, dtype), getattr(torch, dm_dtype)
        dev = dict(device=DEVICE)
        q = (0.3 * torch.randn(b, nc, 128, generator=gen, **dev)).to(dt)
        k = (0.3 * torch.randn(b, ns, 128, generator=gen, **dev)).to(dt)
        v = torch.randn(b, ns, 128, generator=gen, **dev).to(dt)
        mean, std, m, l = adaattn_fwd_reference(q, k, v)
        dm1, dm2, d_row = fold_cotangents(
            mean, std, torch.randn(b, nc, 128, generator=gen, **dev),
            torch.randn(b, nc, 128, generator=gen, **dev))
        args = (q, k, v, dm1.to(dmt), dm2.to(dmt), m, l, d_row)
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
        if dtype == dm_dtype == "float32" and name != "ragged":
            t_f = timed_ms(lambda: adaattn_fwd(q, k, v), iters=5)
            t_pf = timed_ms(lambda: adaattn_fwd_reference(q, k, v), iters=3,
                            warmup=1)
            fwd = f"; adaattn_fwd kernel {t_f:.4f} ms, plain {t_pf:.4f} ms"
        size, dsize = q.element_size(), dm1.to(dmt).element_size()
        in_bytes = (size * (nc + 2 * ns) + 2 * dsize * nc) * b * 128 \
            + 12 * b * nc
        bounds = {"adaattn_dq": Bound(), "adaattn_dkv": Bound()}
        bounds["adaattn_dq"].add(in_bytes + size * b * nc * 128,
                                 8 * b * nc * ns * 128, PEAK_F32)
        bounds["adaattn_dkv"].add(in_bytes + 2 * size * b * ns * 128,
                                  12 * b * nc * ns * 128, PEAK_F32)
        log(f"adaattn bwd {name:7s} B={b} Nc={nc} Ns={ns} {dtype} (dm "
            f"{dm_dtype}): " + ", ".join(errs)
            + f"; adaattn_dq {t_dq:.4f} ms (plain {t_pdq:.4f}, bound "
            f"{bounds['adaattn_dq'].ms():.4f}), adaattn_dkv {t_dkv:.4f} ms "
            f"(plain {t_pdkv:.4f}, bound {bounds['adaattn_dkv'].ms():.4f}); "
            f"library sdpa {what_fb}: forward+backward {lib_fb:.4f} ms, "
            f"forward {lib_f:.4f} ms" + fwd)
        if per_step:
            for kernel, t_k, t_p in (("adaattn_dq", t_dq, t_pdq),
                                     ("adaattn_dkv", t_dkv, t_pdkv)):
                out[kernel][1] += per_step * t_k
                out[kernel][2] += per_step * t_p
                out[kernel][3].add(bounds[kernel].nbytes,
                                   bounds[kernel].flops, PEAK_F32, per_step)
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


def train_phase(gen):
    """ASTTrainer on the card: warm-up, timed steps with their launches,
    the kernel-vs-twin step, the checkpoint round trip and a profile.
    Returns the launches of the timed steps."""
    import tempfile

    import torch
    from arbitrarystyletransfer_tpu_torch import ModelConfig, weights
    from arbitrarystyletransfer_tpu_torch.config import ASTTrainConfig
    from arbitrarystyletransfer_tpu_torch.ops.kernels import (
        LAUNCHES,
        reset_launches,
    )
    from arbitrarystyletransfer_tpu_torch.train import checkpoint as ckpt
    from arbitrarystyletransfer_tpu_torch.train.ast_trainer import ASTTrainer

    with tempfile.TemporaryDirectory() as tmp:
        tcfg = ASTTrainConfig(batch_size=TRAIN_BATCH, save_dir=tmp,
                              ae_model="")
        model_cfg = ModelConfig(use_pallas_adaattn=True)
        batches = {size: _uniform_batches(gen, size) for size in TRAIN_SIZES}
        trainer = ASTTrainer(tcfg, batches[TRAIN_SIZES[-1]],
                             model_cfg=model_cfg, seed=SEED, preview_dir=None,
                             device=DEVICE, log_fn=log)
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
        normalize_train_head(trainer, next(batches[TRAIN_SIZES[-1]]))
        for _ in range(STEP_BATCHES):
            kernel_vs_twin_step(trainer, next(batches[TRAIN_SIZES[-1]]))
        buffers0 = [b.clone() for b in trainer.buffers]
        for size in TRAIN_SIZES:
            t0 = time.perf_counter()
            aux = trainer.train_step(*next(batches[size]))
            torch.cuda.synchronize()
            log(f"train warm-up {size}px: {time.perf_counter() - t0:.3f} s, "
                f"loss {float(aux['loss']):.6g}")

        torch.cuda.reset_peak_memory_stats()
        times, per_step, losses = [], [], []
        reset_launches()
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


def normalize_train_head(trainer, batch):
    """Scale the decoder head so that the stylized image of ``batch`` has a
    per-channel mean 0.5 and spatial std 0.05 (as ``routes_phase`` does)."""
    import torch

    ast = trainer.ast
    with torch.no_grad():
        pre = ast.dec(ast.encode(*batch, detach=True)).double()
        head = ast.dec.img_out
        std = pre.std(dim=(1, 2)).mean(dim=0)
        check(bool((std > 1e-3).all()), f"train pre-clamp image: {std}")
        scale = 0.05 / std
        head.kernel.mul_(scale.float())
        head.bias.copy_(0.5 - scale * (pre.mean(dim=(0, 1, 2)) - head.bias))


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


def kernel_vs_twin_step(trainer, batch):
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
    Every comparison is logged before any is checked."""
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

    def fold(mean, std, dmean, dstd):
        ratio.append(float((mean.square() / std.square().clamp_min(
            1e-30)).max()))
        return fold_real(mean, std, dmean, dstd)

    def run(**patch):
        """The step with ``patch``'s attributes of ``fwd_mod``/``bwd_mod``
        replaced."""
        mods = {name: fwd_mod if hasattr(fwd_mod, name) else bwd_mod
                for name in patch}
        saved = {name: getattr(mods[name], name) for name in patch}
        for name, fn in patch.items():
            setattr(mods[name], name, fn)
        before = dict(LAUNCHES)
        try:
            loss, _, grads = trainer.loss_and_grads(*batch)
        finally:
            for name, fn in saved.items():
                setattr(mods[name], name, fn)
        for b, saved_b in zip(trainer.buffers, buffers):
            b.copy_(saved_b)
        launched = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        return float(loss.detach()), grads, launched

    twin_bwd = dict(adaattn_dq=bwd_mod.adaattn_dq_reference,
                    adaattn_dkv=bwd_mod.adaattn_dkv_reference)
    fold_real = fwd_mod.fold_cotangents
    loss_a, grads_a, n_a = run(fold_cotangents=fold)
    loss_c, grads_c, n_c = run(**twin_bwd)
    loss_b, grads_b, n_b = run(adaattn_fwd=fwd_mod.adaattn_fwd_reference,
                               **twin_bwd)
    loss_d, grads_d, n_d = run(adaattn_statistics=adaattn_statistics_f64)
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
    failed = [] if rel <= tol_loss else ["the kernel step's loss differs"]
    for name in names:
        ga, gb, gc, gd = (g[index[name]]
                          for g in (grads_a, grads_b, grads_c, grads_d))
        err, err_d, own = max_err(ga, gc), max_err(ga, gd), max_err(gb, gd)
        tol = STEP_GRAD_TOL * float(gc.abs().max())
        tol_d = max(STEP_GRAD_TOL * float(gd.abs().max()),
                    STEP_OWN_FACTOR * own)
        log(f"  grad {name}: kernels vs twin backward max abs err "
            f"{err:.4g} (tol {tol:.4g}); vs the float64 step {err_d:.4g} "
            f"(tol {tol_d:.4g}; the twins' step {own:.4g} from it, the "
            f"kernels' {max_err(ga, gb):.4g} from the twins'); max |g| "
            f"{float(gc.abs().max()):.4g}")
        if err > tol:
            failed.append(f"the kernel step's gradient of {name} differs")
        if err_d > tol_d:
            failed.append(f"the kernel step's gradient of {name} differs "
                          "from the float64 step's")
    check(not failed, "; ".join(failed))


def profile_train_step(trainer, batch, top=12):
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
    log(f"train profile of one step: {wall:.3f} ms (CUDA events, profiler "
        f"on): {phases}; {busy:.3f} ms of device kernels ({busy / wall:.1%} "
        f"busy), AdaAttN kernels {att:.3f} ms ({att / max(busy, 1e-9):.1%} of device "
        f"time), {len(events)} distinct kernels")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"  {e.self_device_time_total / 1000:9.3f} ms  x{e.count:<4d} "
            f"{e.key[:90]}")
    ops = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CPU
           and e.self_device_time_total > 0]
    log("train step by op (self device time):")
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"  {e.self_device_time_total / 1000:9.3f} ms  x{e.count:<4d} "
            f"{e.key[:90]}")


def main() -> int:
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
        e_worst, e_ms, e_plain, e_bound = phase("expand_dw", expand_dw_phase,
                                                gen)
        gen6 = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
        a_worst, a_ms, a_plain, a_bound, a_lib = phase(
            "adaattn_fwd", adaattn_phase, gen, gen6)
        f_worst, f_ms, f_bound = phase(
            "flat_block", flat_kernel_phase, gen, "flat_block", flat_block,
            flat_block_reference, FLAT_BLOCK_CASES, 1)
        s_worst, s_ms, s_bound = phase(
            "flat_s2_block", flat_kernel_phase, gen, "flat_s2_block",
            flat_s2_block, flat_s2_block_reference, FLAT_S2_CASES, 2)
        # Slice 4's kernel phases draw from a generator of their own, so
        # that every other phase gets the inputs it got before them.
        gen4 = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
        m_worst, m_ms, m_plain, m_bound = phase("mega_block", mega_phase,
                                                gen4)
        two_pass = phase("fused_2pass", two_pass_phase, gen4)
        # So do slice 5's probes.
        gen5 = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
        probe_rows, probe_launches = phase("probes", probes_phase, gen5)
        phase("plain_route", plain_route_phase, gen6)
        # So do the ragged shapes and the per-sweep times.
        gen7 = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
        phase("ragged", ragged_phase, gen7)
        phase("sweeps", sweeps_phase, gen7)
    bwd = phase("adaattn_bwd", adaattn_bwd_phase, gen)
    launches = phase("routes", routes_phase, gen)
    launches["train"], train_ms, train_peak = phase("train", train_phase, gen)
    launches.update(probe_launches)
    log(f"phase seconds: {seconds}")

    pallas = "arbitrarystyletransfer_tpu/ops/pallas/"

    def row(name, source, replaces, worst, ms, plain_ms, bound, library_ms):
        """``replaces`` is the TPU kernel's file:line from the repo root."""
        by_route = {impl: counts[name] for impl, counts in launches.items()}
        return {"name": name, "route": "cuda",
                "source": f"arbitrarystyletransfer_tpu_torch/csrc/{source}",
                "replaces": replaces,
                "launches": sum(by_route.values()),
                "launches_by_route": by_route, "max_abs_err": worst,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound.ms(),
                "bound_by": bound.by(), "library_ms": library_ms}

    kernels = [
        row("expand_dw", "expand_dw.cu", pallas + "fused_block.py:68",
            e_worst, e_ms, e_plain, e_bound, None),
        row("adaattn_fwd", "adaattn_fwd.cu", pallas + "adaattn_kernel.py:57",
            a_worst, a_ms, a_plain, a_bound, a_lib),
        row("flat_block", "flat_block.cu", pallas + "flatblock.py:92",
            f_worst, *f_ms[MAIN_ROUTE], f_bound[MAIN_ROUTE], None),
        row("flat_s2_block", "flat_s2.cu", pallas + "flatblock_s2.py:121",
            s_worst, *s_ms[MAIN_ROUTE], s_bound[MAIN_ROUTE], None),
        row("adaattn_dq", "adaattn_bwd.cu", pallas + "adaattn_kernel.py:183",
            *bwd["adaattn_dq"]),
        row("adaattn_dkv", "adaattn_bwd.cu",
            pallas + "adaattn_kernel.py:220", *bwd["adaattn_dkv"]),
        row("mega_block", "mega_block.cu", pallas + "megablock.py:117",
            m_worst, m_ms, m_plain, m_bound, None),
        row("fused_sums", "fused_2pass.cu", pallas + "fused_block.py:68",
            *two_pass["fused_sums"], None),
        row("fused_project", "fused_2pass.cu", pallas + "fused_block.py:68",
            *two_pass["fused_project"], None),
    ] + [row(name, source, "scripts/" + replaces, *probe_rows[name])
         for name, source, replaces in PROBE_ROWS]
    log("kernels: launches = sum over the routes' requests, the timed "
        "train steps and the two probe drivers' runs (counted per route or "
        "driver); for the stylize kernels "
        "max_abs_err is the worst output error over their 512px bf16 cases "
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
        "kernels' f32 depthwise at the f32 peak; the probe rows run on no "
        "route, their launches are the probe drivers' (probe_mega2 for "
        "copy, products and depthwise, probe_vpu_rate for the rates) and "
        "their ms the drivers' measurements; for probe_copy, probe_mm_* and "
        "probe_dw_* ms, plain_ms, bound_ms and library_ms are sums over the "
        "JAX probe script's two default shapes (copy: best of 3 windows of "
        "20 calls, bit-exact, max_abs_err 0, library x * 1.0; products: the "
        "slope between 12 and 3 chained calls, L2-resident, max_abs_err over "
        "both shapes, library torch.einsum in bf16; depthwise: best of 3 "
        "windows with the inputs cycled past L2, f32, library "
        "F.conv2d(groups=C) on NCHW, circular in W for probe_dw_t); "
        "probe_rate is the fma f32 par 8 case at (256, 4096), 512 reps "
        "(slope method; its max_abs_err over the whole tile, library "
        "null)")
    log(f"train: {train_ms:.3f} ms per {TRAIN_SIZES[-1]}px batch-"
        f"{TRAIN_BATCH} f32 step ({1000 / train_ms:.3f} steps/s), peak "
        f"memory {train_peak:.2f} GiB")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
