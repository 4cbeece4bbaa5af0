#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py

1. Refuses to run without CUDA; prints the card's name and power limit.
2. Builds the port's kernels from ``arbitrarystyletransfer_tpu_torch/csrc``.
3. Kernel phase: each kernel's wrapper against its plain PyTorch twin on the
   card, at every shape the 512px batch-8 stylize routes give it (and a few
   off-path shapes that take the kernels' other code paths), with the max
   error against a stated tolerance and both times (CUDA events).
4. Routes: ``StylePipeline`` in bfloat16 with the AdaAttN kernel answers
   requests of 8 content/style pairs at 512x512 through three block routes:
   "fused"/"fused" (3 requests), "flat-all" (4; every block the flat kernels
   take) and "auto" (2; the CLI's default).  For each route the launch
   counters are reset just before its requests and read just after, and
   each request must launch exactly the route's kernels; outputs must be
   finite and unsaturated; request 1 is held against the same pipeline
   forced through the plain twins (bf16, and f32 through both).  Prints ms
   per request, img/s and a profiler breakdown of one request per route.
5. Prints one JSON line per the kernels, the nvidia-smi line, and last
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

# Kernel launches per 512px batch-8 request, by route: (encoder_impl and
# decoder_impl, requests, {kernel: launches}).
ROUTES = (
    ("fused", 3, {"expand_dw": 15, "adaattn_fwd": 1, "flat_block": 0,
                  "flat_s2_block": 0}),
    ("flat-all", 4, {"expand_dw": 0, "adaattn_fwd": 1, "flat_block": 15,
                     "flat_s2_block": 2}),
    ("auto", 2, {"expand_dw": 10, "adaattn_fwd": 1, "flat_block": 5,
                 "flat_s2_block": 1}),
)
MAIN_ROUTE = "flat-all"  # the slice's main path

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


def expand_dw_phase(gen):
    import torch
    from arbitrarystyletransfer_tpu_torch.ops.kernels.expand_dw import (
        expand_dw,
        expand_dw_reference,
    )

    worst = 0.0
    ms = plain_ms = 0.0
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
        log(f"expand_dw {name:8s} x={tuple(x.shape)} E={e} k={k} bn={bn}: "
            f"hidden err {err_h:.4g} (tol {tol_h:.4g}), sums err "
            f"{err_s:.4g} (tol {tol_s:.4g}); kernel {t_k:.4f} ms, "
            f"plain {t_p:.4f} ms")
        check(err_h <= tol_h and err_s <= tol_s, f"expand_dw {name} differs")
        torch.cuda.empty_cache()
    return worst, ms, plain_ms


def adaattn_phase(gen):
    import torch
    from arbitrarystyletransfer_tpu_torch.ops.kernels.adaattn_fwd import (
        adaattn_fwd,
        adaattn_fwd_reference,
    )

    worst = 0.0
    ms = plain_ms = None
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
        if main:
            ms, plain_ms = t_k, t_p
        log(f"adaattn_fwd {name:10s} q={tuple(q.shape)} Ns={ns} {dtype}: "
            + ", ".join(errs) + f"; kernel {t_k:.4f} ms, plain {t_p:.4f} ms")
        torch.cuda.empty_cache()
    return worst, ms, plain_ms


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
        for route, per_req in (("flat-all", per_all), ("auto", per_auto)):
            per_route[route][0] += per_req * t_k
            per_route[route][1] += per_req * t_p
        log(f"{name} {label:8s} x={tuple(x.shape)} E={e} C_out={c_out} "
            f"k={k} bn={bn} res={residual} {dtype}: y err {err_y:.4g} (tol "
            f"{tol_y:.4g}), sums err {err_s:.4g} (tol {tol_s:.4g}); kernel "
            f"{t_k:.4f} ms, plain {t_p:.4f} ms")
        check(err_y <= tol_y and err_s <= tol_s, f"{name} {label} differs")
        torch.cuda.empty_cache()
    for route, (t_k, t_p) in per_route.items():
        log(f"{name} per {route} request: kernel {t_k:.4f} ms, plain "
            f"{t_p:.4f} ms")
    return worst, per_route


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
        e_worst, e_ms, e_plain = expand_dw_phase(gen)
        a_worst, a_ms, a_plain = adaattn_phase(gen)
        f_worst, f_ms = flat_kernel_phase(
            gen, "flat_block", flat_block, flat_block_reference,
            FLAT_BLOCK_CASES, stride=1)
        s_worst, s_ms = flat_kernel_phase(
            gen, "flat_s2_block", flat_s2_block, flat_s2_block_reference,
            FLAT_S2_CASES, stride=2)
    launches = routes_phase(gen)

    def row(name, source, replaces, worst, ms, plain_ms):
        by_route = {impl: launches[impl][name] for impl, _, _ in ROUTES}
        return {"name": name, "route": "cuda",
                "source": f"arbitrarystyletransfer_tpu_torch/csrc/{source}",
                "replaces": f"arbitrarystyletransfer_tpu/ops/pallas/{replaces}",
                "launches": sum(by_route.values()),
                "launches_by_route": by_route, "max_abs_err": worst,
                "ms": ms, "plain_ms": plain_ms}

    kernels = [
        row("expand_dw", "expand_dw.cu", "fused_block.py:68", e_worst, e_ms,
            e_plain),
        row("adaattn_fwd", "adaattn_fwd.cu", "adaattn_kernel.py:57", a_worst,
            a_ms, a_plain),
        row("flat_block", "flat_block.cu", "flatblock.py:92", f_worst,
            *f_ms[MAIN_ROUTE]),
        row("flat_s2_block", "flat_s2.cu", "flatblock_s2.py:121", s_worst,
            *s_ms[MAIN_ROUTE]),
    ]
    log("kernels: launches = sum over the routes' requests (counted per "
        "route); max_abs_err = worst output error over the kernel's 512px "
        "bf16 cases (hidden for expand_dw, mean/std of the AdaAttN taps "
        "case); ms, plain_ms = device ms per 512px batch-8 request, on the "
        f"fused route for expand_dw and the {MAIN_ROUTE} route for the flat "
        "kernels")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
