#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py

1. Refuses to run without CUDA; prints the card's name and power limit.
2. Builds the port's kernels from ``arbitrarystyletransfer_tpu_torch/csrc``.
3. Kernel phase: each kernel's wrapper against its plain PyTorch twin on the
   card, at every shape the 512px batch-8 stylize path gives it, with the
   max error against a stated tolerance and both times (CUDA events).
4. Main path: ``StylePipeline(engine="fused")`` in bfloat16 with the AdaAttN
   kernel answers 4 requests of 8 content/style pairs at 512x512; checks the
   launch counts (15 expand_dw, 1 adaattn_fwd per request), that outputs are
   finite and unsaturated, and request 1 against the same pipeline forced
   through the plain twins (bf16, and f32 through both); prints ms per
   request, img/s and a profiler breakdown of one request.
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
EXPAND_DW_LAUNCHES, ADAATTN_LAUNCHES = 15, 1

# Every distinct expand_dw shape of the 512px batch-8 request: name, batch
# (the encoder runs content and style stacked: 16), H=W, C_in, E, k,
# folded-BN biases, launches per request.
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
# AdaAttN: both taps stacked (2B = 16 images of 64x64 = 4096 positions).
ADAATTN_CASES = (
    ("taps", 16, 4096, 4096, "bfloat16", True),
    ("ragged-ns", 16, 4096, 4000, "bfloat16", False),
    ("ragged-f32", 2, 1000, 777, "float32", False),
)
# One bf16 ulp of the largest value: each hidden/mean/std element is
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


def main_path_phase(gen):
    import torch
    from arbitrarystyletransfer_tpu_torch import ModelConfig
    from arbitrarystyletransfer_tpu_torch import engine
    from arbitrarystyletransfer_tpu_torch.infer import StylePipeline
    from arbitrarystyletransfer_tpu_torch.ops.kernels import (
        LAUNCHES,
        reset_launches,
    )

    cfg = ModelConfig(encoder_eval_stats=True, use_pallas_adaattn=True,
                      compute_dtype="bfloat16")
    pipe = StylePipeline(cfg, engine="fused", device=DEVICE,
                         state=random_state(cfg, SEED))
    shape = (BATCH, SIZE, SIZE, 3)
    requests = [(torch.rand(shape, generator=gen, device=DEVICE),
                 torch.rand(shape, generator=gen, device=DEVICE), a)
                for a in ALPHAS]

    # Normalize the head on request 1 so the clamped image is not
    # saturated: per-channel pre-clamp mean 0.5, spatial std 0.05 (the
    # other requests' images spread up to 4x further than request 1's).
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

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    outs, times = [], []
    for i, (content, style, alpha) in enumerate(requests):
        before = dict(LAUNCHES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = pipe.stylize(content, style, alpha)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        n_exp = LAUNCHES["expand_dw"] - before["expand_dw"]
        n_att = LAUNCHES["adaattn_fwd"] - before["adaattn_fwd"]
        sat = float(((out == 0) | (out == 1)).float().mean())
        log(f"request {i + 1}: alpha {alpha}, {times[-1]:.3f} ms, "
            f"launches expand_dw {n_exp} adaattn_fwd {n_att}, "
            f"mean {float(out.mean()):.4f} std {float(out.std()):.4f}, "
            f"saturated {sat:.4%}")
        check(tuple(out.shape) == shape, f"output shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), "non-finite output")
        check(sat < 0.5, f"{sat:.1%} of the output is 0 or 1")
        check(n_exp == EXPAND_DW_LAUNCHES and n_att == ADAATTN_LAUNCHES,
              f"request {i + 1} launched {n_exp} expand_dw, {n_att} adaattn")
        outs.append(out)
    launches = dict(LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    # Request 1 again through the plain twins (bf16 and f32), and through
    # the kernels at f32.
    content, style, alpha = requests[0]
    plain, plain_times = run_plain(pipe, content, style, alpha, repeats=3)
    check(dict(LAUNCHES) == launches, "the plain run launched a kernel")
    pipe32 = StylePipeline(dataclasses.replace(cfg, compute_dtype="float32"),
                           engine="fused", device=DEVICE, state=pipe.state)
    out32 = pipe32.stylize(content, style, alpha)
    plain32, _ = run_plain(pipe32, content, style, alpha, repeats=1)

    def errs(a, b):
        d = (a - b).abs()
        return float(d.max()), float(d.mean())

    k32 = errs(out32, plain32)
    k16 = errs(outs[0], plain)
    floor16 = errs(plain, plain32)
    log(f"request 1, f32, kernels vs plain twins: max abs {k32[0]:.4g} (tol "
        f"{IMAGE_F32_TOL[0]}), mean abs {k32[1]:.4g} (tol {IMAGE_F32_TOL[1]})")
    log(f"request 1, bf16, kernels vs plain twins: max abs {k16[0]:.4g}, "
        f"mean abs {k16[1]:.4g}; the bf16 plain path's own error vs f32: "
        f"max abs {floor16[0]:.4g}, mean abs {floor16[1]:.4g} (tol "
        f"{IMAGE_BF16_FACTOR}x that)")
    check(k32[0] <= IMAGE_F32_TOL[0] and k32[1] <= IMAGE_F32_TOL[1],
          "f32 kernel path and plain path disagree")
    check(k16[0] <= IMAGE_BF16_FACTOR * floor16[0]
          and k16[1] <= IMAGE_BF16_FACTOR * floor16[1],
          "bf16 kernel path differs from the plain path by more than bf16 "
          "itself does")

    ms = statistics.median(times[1:])
    plain_ms = statistics.median(plain_times[1:])
    log(f"main path: median {ms:.3f} ms/request over requests 2-4 "
        f"({BATCH * 1000 / ms:.2f} img/s at {SIZE}px batch {BATCH}); plain "
        f"twins {plain_ms:.3f} ms/request ({BATCH * 1000 / plain_ms:.2f} "
        f"img/s); peak memory {peak_gib:.2f} GiB")
    profile_request(pipe, content, style, alpha)
    return launches


def run_plain(pipe, content, style, alpha, repeats):
    """``pipe.stylize`` with every kernel wrapper replaced by its plain
    twin; returns the last output and each call's ms (CUDA events)."""
    import torch
    from arbitrarystyletransfer_tpu_torch.ops import fused_block
    from arbitrarystyletransfer_tpu_torch.ops.kernels import (
        adaattn_fwd as adaattn_mod,
        expand_dw as expand_mod,
    )

    saved = (fused_block.expand_dw, adaattn_mod.adaattn_statistics)
    fused_block.expand_dw = expand_mod.expand_dw_reference
    adaattn_mod.adaattn_statistics = (
        lambda q, k, v: adaattn_mod.adaattn_fwd_reference(q, k, v)[:2])
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
        fused_block.expand_dw, adaattn_mod.adaattn_statistics = saved
    return out, times


def profile_request(pipe, content, style, alpha, top=15):
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
    log(f"profile of one request: {wall:.3f} ms wall (CUDA events, profiler "
        f"on), {busy:.3f} ms of device kernels ({busy / wall:.1%} busy), "
        f"{len(events)} distinct kernels")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"  {e.self_device_time_total / 1000:9.3f} ms  x{e.count:<4d} "
            f"{e.key[:90]}")
    ops = [e for e in prof.key_averages(group_by_input_shape=True)
           if e.device_type == torch.autograd.DeviceType.CPU
           and e.self_device_time_total > 0]
    log("by op and input shapes (self device time):")
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
    launches = main_path_phase(gen)

    kernels = [
        {"name": "expand_dw", "route": "cuda",
         "source": "arbitrarystyletransfer_tpu_torch/csrc/expand_dw.cu",
         "replaces": "arbitrarystyletransfer_tpu/ops/pallas/fused_block.py:68",
         "launches": launches["expand_dw"], "max_abs_err": e_worst,
         "ms": e_ms, "plain_ms": e_plain},
        {"name": "adaattn_fwd", "route": "cuda",
         "source": "arbitrarystyletransfer_tpu_torch/csrc/adaattn_fwd.cu",
         "replaces":
             "arbitrarystyletransfer_tpu/ops/pallas/adaattn_kernel.py:57",
         "launches": launches["adaattn_fwd"], "max_abs_err": a_worst,
         "ms": a_ms, "plain_ms": a_plain},
    ]
    log("kernels: max_abs_err = worst hidden error over the expand_dw cases, "
        "worst mean/std error of the AdaAttN taps case; ms, plain_ms = device "
        "ms per 512px batch-8 request")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
