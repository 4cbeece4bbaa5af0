"""Per-sweep device times of the whole-block kernels on the card.

    python -m arbitrarystyletransfer_tpu_torch.scripts.sweep_times [--f32]

Run from the repository root (it reads the path shapes from
``chip_smoke.py``'s ``EXPAND_DW_CASES`` and ``FLAT_BLOCK_CASES``).  Builds
the kernel library with the compiler's register report, then for every
shape of the 512px batch-8 path: ``expand_dw`` (sweep 1 in the fused mode)
and ``flat_block`` (sweep 1 in the flat mode, then sweep 2), each sweep's
device ms from a ``torch.profiler`` trace (kernels ``expand_dw_kernel``;
``se_gate_kernel`` or ``se_gate_staged`` and ``gate_project``), its own
bound, its share of that bound, its achieved rates and (where the library
answers the query) the
registers, shared memory and resident CTAs per SM of its kernel at that
shape; with ``--f32``, ``expand_dw`` and ``flat_block`` at the same
shapes in float32 after them, then ``mega_block`` and ``flat_s2_block``
at theirs (the stylize CLI's dtype: the 3xTF32 sweep 1).  Then the
registers and spills of each sweep's kernels from the compiler's report
and their opcode counts (``sass_ops``).  Prints one JSON
object per shape and sweep, then a summary (ms per request by kernel,
sweep and dtype).  Needs CUDA; fails without it.  The shapes come from
the bf16 rows, so an older ``chip_smoke.py`` serves too: run from a
parent's tree with this file copied in, it times the parent's kernels.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
from pathlib import Path

# H100 SXM peaks (NVIDIA's data sheet, dense, at 700 W), as chip_smoke.py.
PEAK_BF16, PEAK_F32, HBM_BYTES_S = 989e12, 67e12, 3.35e12
PEAK_TF32 = 495e12
# Sweep 2's designs by gate_project_launch's `design` (0, 1) and by the
# value of *_last_sweep2 (0, 1, 2); each one's peak for its own bound: the
# generic kernel's f32 FMAs, gate_project_mma's bf16 products,
# gate_project_tf32's three TF32 products per f32 one.
SWEEP2_NAMES = {0: "generic", 1: "mma", 2: "tf32"}
SWEEP2_PEAK = {"generic": (PEAK_F32, 1), "mma": (PEAK_BF16, 1),
               "tf32": (PEAK_TF32, 3)}
# The kernels of each sweep, by name: sweep 2 is the gate kernel and the
# projection.
SWEEPS = {"sweep1": ("expand_dw_kernel",),
          "sweep2": ("se_gate", "gate_project")}


def sweep_costs(n, hw, c_in, e, c_out, k, residual, size=2):
    """{sweep: (bytes, bf16 tensor-core flops, f32 flops)} of one flat
    block: sweep 1 reads x, writes the hidden and the sums and runs the
    expand (tensor cores) and the f32 depthwise; sweep 2 reads the hidden,
    the sums and the residual, writes y and runs the projection."""
    pix = n * hw * hw
    return {
        "sweep1": (size * pix * (c_in + e) + 4 * n * e,
                   2 * pix * c_in * e, 2 * pix * e * k * k),
        "sweep2": (size * pix * (e + c_out * (1 + residual)) + 4 * n * e,
                   2 * pix * e * c_out, 0),
    }


def s2_sweep_costs(n, hw, c_in, e, c_out, k, size=2):
    """``sweep_costs`` of one stride-2 block at input size ``hw``: sweep 1
    reads x and runs the expand at input resolution, writes the hidden and
    runs the depthwise at output resolution; sweep 2 as a flat block's at
    output resolution, without residual."""
    pix, opix = n * hw * hw, n * (hw // 2) ** 2
    return {
        "sweep1": (size * (pix * c_in + opix * e) + 4 * n * e,
                   2 * pix * c_in * e, 2 * opix * e * k * k),
        "sweep2": sweep_costs(n, hw // 2, c_in, e, c_out, k, False,
                              size)["sweep2"],
    }


def bound_ms(nbytes, mm, dw, mm_peak=PEAK_BF16):
    """(bound ms, "bytes" or "operations"): the products at ``mm_peak``
    (bf16's tensor-core peak; f32's at a third of TF32's, 3xTF32), the
    depthwise at the f32 peak."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = mm / mm_peak + dw / PEAK_F32
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def profile_sweeps(fn, iters=10):
    """{sweep: device ms per call} of ``fn``'s launches, from a profiler
    trace of ``iters`` calls after a warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {s: 0.0 for s in SWEEPS}
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total", None)
        if us is None:
            us = evt.cuda_time_total
        for sweep, names in SWEEPS.items():
            if any(name in evt.key for name in names):
                out[sweep] += us / 1e3 / iters
    return out


def sweep_record(label, kernel, sweep, ms, cost, per_req, occ, size=2):
    nbytes, mm, dw = cost
    b, by = bound_ms(nbytes, mm, dw,
                     PEAK_BF16 if size == 2 else PEAK_TF32 / 3)
    regs, smem, ctas = occ.get(sweep, (None, None, None))
    return {"shape": label, "kernel": kernel, "sweep": sweep,
            "ms": ms, "bound_ms": b, "bound_by": by,
            "registers": regs, "smem_bytes": smem, "ctas_per_sm": ctas,
            "share_of_bound": b / ms if ms else None,
            "tflops": (mm + dw) / ms / 1e9 if ms else None,
            "f32_tflops": dw / ms / 1e9 if ms else None,
            "tbytes_s": nbytes / ms / 1e9 if ms else None,
            "per_request": per_req, "dtype": "bfloat16" if size == 2
            else "float32"}


def occupancy(kernel, k, c_in, e=0, c_out=0, residual=False, bf16=True):
    """{sweep: (registers, shared memory bytes, resident CTAs per SM)} of
    the kernels of ``kernel`` ("expand_dw", "flat_block", "mega_block" or
    "flat_s2_block") at this shape, from the runtime (f32: sweep 1's 3xTF32
    kernel, ``*_f32_occupancy``, and sweep 2's ``gate_project_tf32``); {}
    where the library has no such query."""
    import ctypes

    from arbitrarystyletransfer_tpu_torch.ops.kernels import _build

    lib = _build.load_library()
    out = (ctypes.c_int * 6)()
    ptr = ctypes.cast(out, ctypes.c_void_p)
    if not bf16:
        name = ("flat_s2_f32_occupancy" if kernel == "flat_s2_block"
                else f"{kernel}_f32_occupancy")
        fn = getattr(lib, name, None)
        if fn is None:
            return {}
        _build.check(fn(k, c_in, ptr), name)
        occ = {"sweep1": tuple(out[:3])}
        if kernel != "expand_dw":
            _build.check(lib.gate_project_occupancy(
                1, e, c_out, int(residual), int(kernel == "mega_block"), 0,
                ptr), "gate_project_occupancy")
            occ["sweep2"] = tuple(out[:3])
        return occ
    name, args = {
        "expand_dw": ("expand_dw_occupancy", (k, c_in)),
        "flat_block": ("flat_block_occupancy",
                       (k, c_in, e, c_out, int(residual))),
        "mega_block": ("mega_block_occupancy",
                       (k, c_in, e, c_out, int(residual))),
        "flat_s2_block": ("flat_s2_occupancy", (k, c_in, e, c_out)),
    }[kernel]
    fn = getattr(lib, name, None)
    if fn is None:
        return {}
    _build.check(fn(*args, ptr), name)
    if kernel == "expand_dw":
        return {"sweep1": tuple(out[:3])}
    return {"sweep1": tuple(out[:3]), "sweep2": tuple(out[3:])}


def last_staging(kernel):
    """"async" (the x halo as a TMA box) or "sync" (plain loads): how the
    last launch of ``kernel`` ("mega_block" or "flat_s2_block") staged x;
    None where the library has no such query."""
    from arbitrarystyletransfer_tpu_torch.ops.kernels import _build

    fn = getattr(_build.load_library(), f"{kernel}_last_staging", None)
    if fn is None:
        return None
    return {1: "async", 0: "sync"}.get(fn())


def random_se(rand, e):
    from arbitrarystyletransfer_tpu_torch.weights import make_divisible

    s = make_divisible(e // 4, 8)
    return {"Dense_0": {"kernel": rand(e, s) / math.sqrt(e),
                        "bias": 0.1 * rand(s)},
            "Dense_1": {"kernel": rand(s, e) / math.sqrt(s),
                        "bias": 0.5 + 0.1 * rand(e)}}


def time_sweeps(gen, expand_cases, flat_cases, device="cuda", log=print,
                mega_cases=(), s2_cases=(), expand_dtype="bfloat16"):
    """Per-sweep records of expand_dw at ``expand_cases`` (x of
    ``expand_dtype``), flat_block at ``flat_cases`` (x of each case's
    dtype), mega_block at ``mega_cases`` and flat_s2_block at ``s2_cases``
    (x of each case's dtype; ``chip_smoke.py``'s tuples); returns the
    list."""
    import torch
    from arbitrarystyletransfer_tpu_torch.ops.kernels.expand_dw import (
        expand_dw,
    )
    from arbitrarystyletransfer_tpu_torch.ops.kernels.flat_block import (
        flat_block,
    )
    from arbitrarystyletransfer_tpu_torch.ops.kernels.flat_s2 import (
        flat_s2_block,
    )
    from arbitrarystyletransfer_tpu_torch.ops.kernels.mega_block import (
        mega_block,
    )

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    records = []

    def emit(name, kernel, ms, costs, per_req, occ, staging=None, size=2):
        for sweep in ms:
            rec = sweep_record(name, kernel, sweep, ms[sweep], costs[sweep],
                               per_req, occ, size)
            if staging is not None and sweep == "sweep1":
                rec["staging"] = staging
            records.append(rec)
            log(json.dumps(rec))
        torch.cuda.empty_cache()

    for name, n, hw, c_in, e, k, bn, per_req in expand_cases:
        x = rand(n, hw, hw, c_in).to(getattr(torch, expand_dtype))
        size = x.element_size()
        we, wd = rand(c_in, e) / math.sqrt(c_in), rand(k, k, e) / k
        be = 0.1 * rand(e) if bn else None
        bd = 0.1 * rand(e) if bn else None
        ms = profile_sweeps(lambda: expand_dw(x, we, wd, k, True, be, bd))
        del x
        emit(name, "expand_dw", {"sweep1": ms["sweep1"]},
             sweep_costs(n, hw, c_in, e, 0, k, False, size), per_req,
             occupancy("expand_dw", k, c_in, bf16=size == 2), size=size)

    def block(c_in, e, c_out, k, bn):
        we, wd = rand(c_in, e) / math.sqrt(c_in), rand(k, k, e) / k
        se, wp = random_se(rand, e), rand(e, c_out) / math.sqrt(e)
        kw = dict(b_expand=0.1 * rand(e) if bn else None,
                  b_dw=0.1 * rand(e) if bn else None,
                  proj_bias=0.1 * rand(c_out) if bn else None)
        return (we, wd, se, wp, k), kw

    for case in flat_cases:
        name, n, hw, c_in, e, c_out, k, bn, residual = case[:9]
        x = rand(n, hw, hw, c_in).to(getattr(torch, case[9]))
        size = x.element_size()
        args, kw = block(c_in, e, c_out, k, bn)
        ms = profile_sweeps(lambda: flat_block(
            x, *args, pre_act=True, identity=residual, **kw))
        del x
        emit(name, "flat_block", ms,
             sweep_costs(n, hw, c_in, e, c_out, k, residual, size), case[-1],
             occupancy("flat_block", k, c_in, e, c_out, residual,
                       bf16=size == 2), size=size)
    for case in mega_cases:
        name, n, h, w, c_in, e, c_out, k, bn, residual = case[:10]
        assert h == w, "the path's mega shapes are square"
        xt = rand(n, h, c_in, w).to(getattr(torch, case[10]))
        size = xt.element_size()
        args, kw = block(c_in, e, c_out, k, bn)
        ms = profile_sweeps(lambda: mega_block(
            xt, *args, pre_act=True, identity=residual, **kw))
        del xt
        emit(name, "mega_block", ms,
             sweep_costs(n, h, c_in, e, c_out, k, residual, size), case[-1],
             occupancy("mega_block", k, c_in, e, c_out, residual,
                       bf16=size == 2),
             last_staging("mega_block"), size=size)
    for case in s2_cases:
        name, n, hw, c_in, e, c_out, k, bn = case[:8]
        x = rand(n, hw, hw, c_in).to(getattr(torch, case[8]))
        size = x.element_size()
        args, kw = block(c_in, e, c_out, k, bn)
        ms = profile_sweeps(lambda: flat_s2_block(x, *args, **kw))
        del x
        emit(name, "flat_s2_block", ms,
             s2_sweep_costs(n, hw, c_in, e, c_out, k, size), case[-1],
             occupancy("flat_s2_block", k, c_in, e, c_out, bf16=size == 2),
             last_staging("flat_s2_block"), size=size)
    return records


def sweep2_ab(gen, cases, device="cuda", log=print, turns=2, iters=10):
    """Sweep 2 alone (``gate_project_launch``) at each case, its CUDA-core
    ``gate_project_generic`` (design 0) against the designed kernel of the
    dtype (design 1) on the same inputs, in turns (generic, new, generic,
    new), each held to ``gate_project_reference`` (one bf16 ulp of the
    largest output; f32 1e-5).  ``cases``: (label, n, h, w, e, c_out,
    residual, dtype, yt, launches per request).  One JSON line per case:
    each design's ms (every turn), its own bound (the bytes at HBM against
    its products at its peak, ``SWEEP2_PEAK``) and share of it, the byte
    bound's share, registers, shared memory, CTAs per SM and ring slots
    (``gate_project_occupancy``).  Returns the records."""
    import ctypes
    import statistics

    import torch

    from arbitrarystyletransfer_tpu_torch.ops.kernels import _build
    from arbitrarystyletransfer_tpu_torch.ops.kernels.flat_block import (
        gate_project_reference,
    )

    lib = _build.load_library()
    stream = torch.cuda.current_stream().cuda_stream

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    records = []
    for label, n, h, w, e, c_out, residual, dtype, yt, per_req in cases:
        dt = getattr(torch, dtype)
        hidden = rand(n, h, w, e).to(dt)
        sums = hidden.float().sum(dim=(1, 2))
        se = random_se(rand, e)
        wp, pb = rand(e, c_out) / math.sqrt(e), 0.1 * rand(c_out)
        res = rand(n, h, w, c_out).to(dt) if residual else None
        ref = gate_project_reference(hidden, sums, se, wp, pb, res)
        d0t = se["Dense_0"]["kernel"].t().contiguous()
        d0b, d1b = se["Dense_0"]["bias"], se["Dense_1"]["bias"]
        d1k = se["Dense_1"]["kernel"].contiguous()
        wpt = wp.to(dt).t().contiguous()
        if yt:  # y and the residual (N, H, C, W)
            res = None if res is None else res.permute(0, 1, 3, 2).contiguous()
            ref = ref.permute(0, 1, 3, 2)
        gate = torch.empty(n, e, device=device)
        y = torch.empty(ref.shape, dtype=dt, device=device)
        s_ = d0t.shape[0]

        def run(design):
            rc = lib.gate_project_launch(
                design, hidden.data_ptr(), sums.data_ptr(), d0t.data_ptr(),
                d0b.data_ptr(), d1k.data_ptr(), d1b.data_ptr(),
                wpt.data_ptr(), pb.data_ptr(),
                None if res is None else res.data_ptr(), gate.data_ptr(),
                y.data_ptr(), n, h * w, e, s_, c_out, w, int(yt),
                int(dt == torch.bfloat16), stream)
            _build.check(rc, f"gate_project {label} design {design}")

        names, errs = {}, {}
        for design in (0, 1):
            run(design)
            torch.cuda.synchronize()
            names[design] = SWEEP2_NAMES[lib.flat_block_last_sweep2()]
            errs[design] = float((y.float() - ref.float()).abs().max())
        times = {0: [], 1: []}
        for _ in range(turns):
            for design in (0, 1):
                for _ in range(2):
                    run(design)  # warm-up
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(iters):
                    run(design)
                end.record()
                torch.cuda.synchronize()
                times[design].append(start.elapsed_time(end) / iters)
        size = hidden.element_size()
        nbytes = size * n * h * w * (e + c_out * (1 + residual)) + 4 * n * e
        flops = 2 * n * h * w * e * c_out
        t_bytes = 1e3 * nbytes / HBM_BYTES_S
        tol = (2.0 ** -7 if dt == torch.bfloat16 else 1e-5) * float(
            ref.float().abs().max())
        rec = {"sweep2_ab": label, "dtype": dtype, "yt": yt,
               "x": [n, h, w, e], "c_out": c_out, "residual": residual,
               "per_request": per_req, "tol": tol, "bytes_bound_ms": t_bytes}
        out = (ctypes.c_int * 4)()
        for design in (0, 1):
            name = names[design]
            peak, factor = SWEEP2_PEAK[name]
            bound = max(t_bytes, 1e3 * factor * flops / peak)
            ms = statistics.median(times[design])
            rc = lib.gate_project_occupancy(
                design, e, c_out, int(residual), int(yt),
                int(dt == torch.bfloat16), ctypes.cast(out, ctypes.c_void_p))
            rec[name] = {
                "ms": times[design], "ms_median": ms, "bound_ms": bound,
                "share": bound / ms, "bytes_share": t_bytes / ms,
                "err": errs[design], "registers": out[0] if rc == 0 else None,
                "smem": out[1] if rc == 0 else None,
                "ctas_per_sm": out[2] if rc == 0 else None,
                "slots": out[3] if rc == 0 else None}
        records.append(rec)
        log(json.dumps(rec))
        del hidden, res, ref, y
        torch.cuda.empty_cache()
    return records


def ptxas_report(build_log, patterns=sum(SWEEPS.values(), ())):
    """[(kernel, registers, spill stores, spill loads)] of every kernel of
    the compiler's report whose mangled name contains one of
    ``patterns``."""
    rows, current, spills = [], None, (0, 0)
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = m.group(1)
            continue
        if current is None or not any(p in current for p in patterns):
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rows.append((current, int(m.group(1))) + spills)
            current = None
    return rows


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--f32", action="store_true",
                    help="also time the four kernels in float32")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_times: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke
    from arbitrarystyletransfer_tpu_torch.ops.kernels import _build
    from arbitrarystyletransfer_tpu_torch.scripts import sass_ops

    _build.load_library(ptxas_verbose=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    expand_cases = [c for c in chip_smoke.EXPAND_DW_CASES if c[-1]]
    flat_cases = [c for c in chip_smoke.FLAT_BLOCK_CASES if c[-1]]
    mega_cases = [c for c in chip_smoke.MEGA_CASES if c[-1]]
    s2_cases = [c for c in chip_smoke.FLAT_S2_CASES if c[-1]]
    with torch.inference_mode():
        records = time_sweeps(gen, expand_cases, flat_cases,
                              mega_cases=mega_cases, s2_cases=s2_cases)
        if args.f32:
            records += time_sweeps(
                gen, expand_cases,
                [c[:9] + ("float32",) + c[10:] for c in flat_cases],
                mega_cases=[c[:10] + ("float32",) + c[11:]
                            for c in mega_cases],
                s2_cases=[c[:8] + ("float32",) + c[9:] for c in s2_cases],
                expand_dtype="float32")
    per_req = {}
    for r in records:
        key = f"{r['kernel']} {r['sweep']} {r['dtype']}"
        per_req[key] = per_req.get(key, 0.0) + r["ms"] * r["per_request"]
    print(json.dumps({"per_request_ms": per_req}))
    for kernel, regs, st, ld in ptxas_report(_build.build_info["log"]):
        print(json.dumps({"ptxas": kernel, "registers": regs,
                          "spill_stores": st, "spill_loads": ld}))
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass",
                           _build.build_info["path"]], capture_output=True,
                          text=True, check=True).stdout
    for pattern in sum(SWEEPS.values(), ()):
        for kernel, ops in sass_ops.opcode_counts(sass, pattern).items():
            keep = {op: c for op, c in ops.items()
                    if op.split(".")[0] in ("FFMA", "LDS", "STS", "BAR",
                                            "HMMA", "LDG", "STG", "LDSM",
                                            "LDGSTS", "UTMALDG", "SYNCS",
                                            "HMUL2", "HFMA2", "RED",
                                            "LDL", "STL")}
            print(json.dumps({"sass": kernel, "ops": keep}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
