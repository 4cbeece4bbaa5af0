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
   of the AdaAttN kernels; never on the port's path).
4. Routes: ``StylePipeline`` in bfloat16 with the AdaAttN kernel answers
   requests of 8 content/style pairs at 512x512 through three block routes:
   "fused"/"fused" (3 requests), "flat-all" (4; every block the flat kernels
   take) and "auto" (2; the CLI's default).  For each route the launch
   counters are reset just before its requests and read just after, and
   each request must launch exactly the route's kernels; outputs must be
   finite and unsaturated; request 1 is held against the same pipeline
   forced through the plain twins (bf16, and f32 through both).  Prints ms
   per request, img/s and a profiler breakdown of one request per route.
5. Training: ``ASTTrainer`` (full-width ``ModelConfig`` with the AdaAttN
   kernels, f32, batch 8, the seeded random VGG, in-memory uniform batches,
   no previews).  The step through the kernels is held against the twins
   (the loss; the AdaAttN projection gradients against the kernel forward
   with the twins' backward and against the twins' whole step, see
   ``kernel_vs_twin_step``); one warm-up step per bucket (96, 128, 160px),
   then timed steps at 160px, each of which must launch exactly 2
   ``adaattn_fwd``, 2 ``adaattn_dq`` and 2 ``adaattn_dkv`` and nothing else,
   with a finite loss, a step counter that advances and BatchNorm buffers
   that move; a checkpoint save/restore round trip; a profile of one step
   by phase and by kernel.
6. Prints one JSON line per the kernels (with each kernel's bound: the
   larger of its bytes over the HBM rate and its operations over the peak
   of their type), the nvidia-smi line, and last ``{"ok": true, "device":
   {...}}``.  Any failure raises: exit code != 0.

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

# Kernel launches per 512px batch-8 request, by route: (encoder_impl and
# decoder_impl, requests, {kernel: launches}).
_NO_BWD = {"adaattn_dq": 0, "adaattn_dkv": 0}
ROUTES = (
    ("fused", 3, {"expand_dw": 15, "adaattn_fwd": 1, "flat_block": 0,
                  "flat_s2_block": 0, **_NO_BWD}),
    ("flat-all", 4, {"expand_dw": 0, "adaattn_fwd": 1, "flat_block": 15,
                     "flat_s2_block": 2, **_NO_BWD}),
    ("auto", 2, {"expand_dw": 10, "adaattn_fwd": 1, "flat_block": 5,
                 "flat_s2_block": 1, **_NO_BWD}),
)
MAIN_ROUTE = "flat-all"  # the stylize routes' main path (slice 2)

# Training (slice 3's main path): ASTTrainer, full-width ModelConfig with the
# AdaAttN kernels, f32, batch 8, one warm-up step per bucket, then timed
# steps at the last bucket.  Launches per step: one forward and one backward
# per AdaAttN module (two modules), nothing else.
TRAIN_BATCH, TRAIN_SIZES, TRAIN_STEPS = 8, (96, 128, 160), 6
TRAIN_LAUNCHES = {"expand_dw": 0, "adaattn_fwd": 2, "flat_block": 0,
                  "flat_s2_block": 0, "adaattn_dq": 2, "adaattn_dkv": 2}
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
# The training step through the kernels vs through the plain twins, from
# the same state and batch: the loss (relative) and the AdaAttN projection
# gradients (relative to the largest of each).
STEP_LOSS_TOL, STEP_GRAD_TOL = 1e-5, 1e-4

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
# AdaAttN: both taps stacked (2B = 16 images of 64x64 = 4096 positions).
ADAATTN_CASES = (
    ("taps", 16, 4096, 4096, "bfloat16", True),
    ("ragged-ns", 16, 4096, 4000, "bfloat16", False),
    ("ragged-f32", 2, 1000, 777, "float32", False),
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


def expand_dw_phase(gen):
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
        bound.add(2 * n * hw * hw * (c_in + e) + 4 * n * e,
                  2 * n * hw * hw * e * ((c_in if expand else 0) + k * k),
                  PEAK_BF16, per_req)
        log(f"expand_dw {name:8s} x={tuple(x.shape)} E={e} k={k} bn={bn}: "
            f"hidden err {err_h:.4g} (tol {tol_h:.4g}), sums err "
            f"{err_s:.4g} (tol {tol_s:.4g}); kernel {t_k:.4f} ms, "
            f"plain {t_p:.4f} ms")
        check(err_h <= tol_h and err_s <= tol_s, f"expand_dw {name} differs")
        torch.cuda.empty_cache()
    return worst, ms, plain_ms, bound


def adaattn_phase(gen):
    import torch
    from arbitrarystyletransfer_tpu_torch.ops.kernels.adaattn_fwd import (
        adaattn_fwd,
        adaattn_fwd_reference,
    )

    worst = 0.0
    ms = plain_ms = library_ms = None
    bound = Bound()
    for name, b, nc, ns, dtype, main in ADAATTN_CASES:
        dt = getattr(torch, dtype)
        dev = dict(device=DEVICE)
        # q, k ~ N(0, 0.3): logits of std ~1, as in the parity tests.
        q = (0.3 * torch.randn(b, nc, 128, generator=gen, **dev)).to(dt)
        k = (0.3 * torch.randn(b, ns, 128, generator=gen, **dev)).to(dt)
        v = torch.randn(b, ns, 128, generator=gen, **dev).to(dt)
        out = adaattn_fwd(q, k, v)
        torch.cuda.synchronize()
        ref = adaattn_fwd_reference(q, k, v)
        rel = BF16_TOL if dt == torch.bfloat16 else F32_TOL
        errs = []
        for what, o, r, tol_rel in zip(("mean", "std", "m", "l"), out, ref,
                                       (rel, rel, F32_TOL, L_TOL)):
            err = max_err(o, r)
            tol = tol_rel * float(r.float().abs().max()) + 1e-6
            errs.append(f"{what} err {err:.4g} (tol {tol:.4g})")
            check(err <= tol, f"adaattn_fwd {name} {what} differs")
            if main and what in ("mean", "std"):
                worst = max(worst, err)
        del out, ref
        t_k = timed_ms(lambda: adaattn_fwd(q, k, v), iters=5)
        t_p = timed_ms(lambda: adaattn_fwd_reference(q, k, v), iters=3,
                       warmup=1)
        lib = ""
        if main:
            ms, plain_ms = t_k, t_p
            size = q.element_size()
            bound.add(size * b * (3 * nc + 2 * ns) * 128 + 8 * b * nc,
                      6 * b * nc * ns * 128, PEAK_BF16)
            library_ms, what = sdpa_yardstick(q, k, v)
            lib = f", library (sdpa {what}, forward) {library_ms:.4f} ms"
        log(f"adaattn_fwd {name:10s} q={tuple(q.shape)} Ns={ns} {dtype}: "
            + ", ".join(errs) + f"; kernel {t_k:.4f} ms, plain {t_p:.4f} ms"
            + lib)
        torch.cuda.empty_cache()
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
        flops = 2 * n * (hw * hw * c_in * e * expand
                         + ho * ho * e * (k * k + c_out))
        for route, per_req in (("flat-all", per_all), ("auto", per_auto)):
            per_route[route][0] += per_req * t_k
            per_route[route][1] += per_req * t_p
            bounds[route].add(nbytes, flops, PEAK_BF16 if size == 2
                              else PEAK_F32, per_req)
        log(f"{name} {label:8s} x={tuple(x.shape)} E={e} C_out={c_out} "
            f"k={k} bn={bn} res={residual} {dtype}: y err {err_y:.4g} (tol "
            f"{tol_y:.4g}), sums err {err_s:.4g} (tol {tol_s:.4g}); kernel "
            f"{t_k:.4f} ms, plain {t_p:.4f} ms")
        check(err_y <= tol_y and err_s <= tol_s, f"{name} {label} differs")
        torch.cuda.empty_cache()
    for route, (t_k, t_p) in per_route.items():
        log(f"{name} per {route} request: kernel {t_k:.4f} ms, plain "
            f"{t_p:.4f} ms, bound {bounds[route].ms():.4f} ms "
            f"({bounds[route].by()})")
    return worst, per_route, bounds


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
    log(f"route {impl}: median {ms:.3f} ms/request over requests "
        f"2-{len(requests)} ({BATCH * 1000 / ms:.2f} img/s at {SIZE}px "
        f"batch {BATCH}); plain twins {plain_ms:.3f} ms/request "
        f"({BATCH * 1000 / plain_ms:.2f} img/s); peak memory "
        f"{peak_gib:.2f} GiB")
    profile_request(pipe, impl, content, style, alpha,
                    top=15 if impl == MAIN_ROUTE else 8)
    return launches


def run_plain(pipe, content, style, alpha, repeats):
    """``pipe.stylize`` with every kernel wrapper replaced by its plain
    twin; returns the last output and each call's ms (CUDA events)."""
    import torch
    from arbitrarystyletransfer_tpu_torch.ops import flatblock, flatblock_s2
    from arbitrarystyletransfer_tpu_torch.ops import fused_block
    from arbitrarystyletransfer_tpu_torch.ops.kernels import (
        adaattn_fwd as adaattn_mod,
        expand_dw as expand_mod,
        flat_block as flat_mod,
        flat_s2 as flat_s2_mod,
    )

    saved = (fused_block.expand_dw, adaattn_mod.adaattn_statistics,
             flatblock.flat_block, flatblock_s2.flat_s2_block)
    fused_block.expand_dw = expand_mod.expand_dw_reference
    adaattn_mod.adaattn_statistics = (
        lambda q, k, v: adaattn_mod.adaattn_fwd_reference(q, k, v)[:2])
    flatblock.flat_block = flat_mod.flat_block_reference
    flatblock_s2.flat_s2_block = flat_s2_mod.flat_s2_block_reference
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
         flatblock.flat_block, flatblock_s2.flat_s2_block) = saved
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


def kernel_vs_twin_step(trainer, batch):
    """One step's loss and AdaAttN projection gradients through the kernels
    (A), through the kernel forward with the twins' backward (C), and
    through the twins (B), from the same state and batch.

    The loss is held A against B (``STEP_LOSS_TOL``), the gradients A
    against C and A against B at ``STEP_GRAD_TOL`` of their max.  A against
    C isolates the backward kernels; A against B is the harder of the two:
    the backward's row term D = sum(dm1 mean + dm2 (std^2 + mean^2)) (the
    JAX package's formulation) cancels against P (dm1 v^T + dm2 (v^2)^T)
    with an error of ~eps (mean / std)^2, so the two forwards' rounding
    reaches these gradients amplified by the largest (mean / std)^2, which
    is logged."""
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

    def run(fwd, dq, dkv):
        saved = (fwd_mod.adaattn_fwd, bwd_mod.adaattn_dq, bwd_mod.adaattn_dkv)
        fwd_mod.adaattn_fwd, bwd_mod.adaattn_dq, bwd_mod.adaattn_dkv = (
            fwd, dq, dkv)
        before = dict(LAUNCHES)
        try:
            loss, _, grads = trainer.loss_and_grads(*batch)
        finally:
            fwd_mod.adaattn_fwd, bwd_mod.adaattn_dq, bwd_mod.adaattn_dkv = (
                saved)
        for b, saved_b in zip(trainer.buffers, buffers):
            b.copy_(saved_b)
        launched = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        return float(loss.detach()), grads, launched

    kernels = (fwd_mod.adaattn_fwd, bwd_mod.adaattn_dq, bwd_mod.adaattn_dkv)
    fold_real = fwd_mod.fold_cotangents
    fwd_mod.fold_cotangents = fold
    try:
        loss_a, grads_a, n_a = run(*kernels)
    finally:
        fwd_mod.fold_cotangents = fold_real
    loss_c, grads_c, n_c = run(kernels[0], bwd_mod.adaattn_dq_reference,
                               bwd_mod.adaattn_dkv_reference)
    loss_b, grads_b, n_b = run(fwd_mod.adaattn_fwd_reference,
                               bwd_mod.adaattn_dq_reference,
                               bwd_mod.adaattn_dkv_reference)
    check(n_a == TRAIN_LAUNCHES, f"the kernel step launched {n_a}")
    check(n_c["adaattn_dq"] == n_c["adaattn_dkv"] == 0
          and n_c["adaattn_fwd"] == TRAIN_LAUNCHES["adaattn_fwd"],
          f"the mixed step launched {n_c}")
    check(not any(n_b.values()), f"the twin step launched {n_b}")
    check(all(g is None or bool(torch.isfinite(g).all()) for g in grads_a),
          "a gradient of the kernel step is not finite")
    rel = abs(loss_a - loss_b) / abs(loss_b)
    log(f"train step, kernels vs twins: loss {loss_a:.9g} vs {loss_b:.9g} "
        f"(relative {rel:.3g}, tol {STEP_LOSS_TOL}); kernel forward with "
        f"the twin backward: {loss_c:.9g}; max (mean / std)^2 of the "
        f"AdaAttN statistics {max(ratio):.4g}")
    check(rel <= STEP_LOSS_TOL, "the kernel step's loss differs")
    for name in names:
        ga, gb, gc = (g[index[name]] for g in (grads_a, grads_b, grads_c))
        err, err_b = max_err(ga, gc), max_err(ga, gb)
        tol = STEP_GRAD_TOL * float(gc.abs().max())
        tol_b = STEP_GRAD_TOL * float(gb.abs().max())
        log(f"  grad {name}: kernels vs twin backward max abs err "
            f"{err:.4g} (tol {tol:.4g}); vs the twins' step {err_b:.4g} "
            f"(tol {tol_b:.4g}); max |g| {float(gc.abs().max()):.4g}")
        check(err <= tol, f"the kernel step's gradient of {name} differs")
        check(err_b <= tol_b,
              f"the kernel step's gradient of {name} differs from the twins'")


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
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            log("  ptxas:", line.strip().removeprefix("ptxas info    : "))

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    with torch.inference_mode():
        e_worst, e_ms, e_plain, e_bound = expand_dw_phase(gen)
        a_worst, a_ms, a_plain, a_bound, a_lib = adaattn_phase(gen)
        f_worst, f_ms, f_bound = flat_kernel_phase(
            gen, "flat_block", flat_block, flat_block_reference,
            FLAT_BLOCK_CASES, stride=1)
        s_worst, s_ms, s_bound = flat_kernel_phase(
            gen, "flat_s2_block", flat_s2_block, flat_s2_block_reference,
            FLAT_S2_CASES, stride=2)
    bwd = adaattn_bwd_phase(gen)
    launches = routes_phase(gen)
    launches["train"], train_ms, train_peak = train_phase(gen)

    def row(name, source, replaces, worst, ms, plain_ms, bound, library_ms):
        by_route = {impl: counts[name] for impl, counts in launches.items()}
        return {"name": name, "route": "cuda",
                "source": f"arbitrarystyletransfer_tpu_torch/csrc/{source}",
                "replaces": f"arbitrarystyletransfer_tpu/ops/pallas/{replaces}",
                "launches": sum(by_route.values()),
                "launches_by_route": by_route, "max_abs_err": worst,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound.ms(),
                "bound_by": bound.by(), "library_ms": library_ms}

    kernels = [
        row("expand_dw", "expand_dw.cu", "fused_block.py:68", e_worst, e_ms,
            e_plain, e_bound, None),
        row("adaattn_fwd", "adaattn_fwd.cu", "adaattn_kernel.py:57", a_worst,
            a_ms, a_plain, a_bound, a_lib),
        row("flat_block", "flat_block.cu", "flatblock.py:92", f_worst,
            *f_ms[MAIN_ROUTE], f_bound[MAIN_ROUTE], None),
        row("flat_s2_block", "flat_s2.cu", "flatblock_s2.py:121", s_worst,
            *s_ms[MAIN_ROUTE], s_bound[MAIN_ROUTE], None),
        row("adaattn_dq", "adaattn_bwd.cu", "adaattn_kernel.py:183",
            *bwd["adaattn_dq"]),
        row("adaattn_dkv", "adaattn_bwd.cu", "adaattn_kernel.py:220",
            *bwd["adaattn_dkv"]),
    ]
    log("kernels: launches = sum over the routes' requests and the timed "
        "train steps (counted per route); for the stylize kernels "
        "max_abs_err is the worst output error over their 512px bf16 cases "
        "(hidden for expand_dw, mean/std of the AdaAttN taps case) and ms, "
        "plain_ms, bound_ms are device ms per 512px batch-8 request (fused "
        "route for expand_dw, the AdaAttN taps call for adaattn_fwd, the "
        f"{MAIN_ROUTE} route for the flat kernels); for adaattn_dq/dkv they "
        f"are per {TRAIN_SIZES[-1]}px batch-{TRAIN_BATCH} f32 train step (2 "
        "launches), max_abs_err over dq (resp. dk, dv) at that shape, and "
        "library_ms is the sdpa backward (forward+backward less forward), "
        "which computes dq, dk and dv at once; library_ms of adaattn_fwd is "
        "the sdpa forward of the taps call; bounds at the H100 SXM peaks "
        "(bf16 989 TFLOP/s, f32 67 TFLOP/s, HBM 3.35 TB/s)")
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
