"""Per-sweep device times of the whole-block kernels on the card.

    python -m arbitrarystyletransfer_tpu_torch.scripts.sweep_times

Run from the repository root (it reads the path shapes from
``chip_smoke.py``'s ``EXPAND_DW_CASES`` and ``FLAT_BLOCK_CASES``).  Builds
the kernel library with the compiler's register report, then for every
shape of the 512px batch-8 path: ``expand_dw`` (sweep 1 in the fused mode)
and ``flat_block`` (sweep 1 in the flat mode, then sweep 2), each sweep's
device ms from a ``torch.profiler`` trace (kernels ``expand_dw_kernel``;
``se_gate_kernel`` and ``gate_project``), its own bound, its share of that
bound, its achieved rates and (where the library answers the query) the
registers, shared memory and resident CTAs per SM of its kernel at that
shape.  Then the registers and spills of each sweep's kernels from the
compiler's report and their opcode counts (``sass_ops``).  Prints one JSON
object per shape and sweep, then a summary.  Needs CUDA; fails without it.
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
# The kernels of each sweep, by name: sweep 2 is the gate kernel and the
# projection.
SWEEPS = {"sweep1": ("expand_dw_kernel",),
          "sweep2": ("se_gate_kernel", "gate_project")}


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


def bound_ms(nbytes, mm, dw):
    """(bound ms, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = mm / PEAK_BF16 + dw / PEAK_F32
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


def sweep_record(label, kernel, sweep, ms, cost, per_req, occ):
    nbytes, mm, dw = cost
    b, by = bound_ms(nbytes, mm, dw)
    regs, smem, ctas = occ.get(sweep, (None, None, None))
    return {"shape": label, "kernel": kernel, "sweep": sweep,
            "ms": ms, "bound_ms": b, "bound_by": by,
            "registers": regs, "smem_bytes": smem, "ctas_per_sm": ctas,
            "share_of_bound": b / ms if ms else None,
            "tflops": (mm + dw) / ms / 1e9 if ms else None,
            "f32_tflops": dw / ms / 1e9 if ms else None,
            "tbytes_s": nbytes / ms / 1e9 if ms else None,
            "per_request": per_req}


def occupancy(kernel, k, c_in, e=0, c_out=0, residual=False):
    """{sweep: (registers, shared memory bytes, resident CTAs per SM)} of
    the bf16 kernels of ``kernel`` ("expand_dw" or "flat_block") at this
    shape, from the runtime; {} where the library has no such query."""
    import ctypes

    from arbitrarystyletransfer_tpu_torch.ops.kernels import _build

    lib = _build.load_library()
    out = (ctypes.c_int * 6)()
    if kernel == "expand_dw":
        fn = getattr(lib, "expand_dw_occupancy", None)
        if fn is None:
            return {}
        _build.check(fn(k, c_in, ctypes.cast(out, ctypes.c_void_p)),
                     "expand_dw_occupancy")
        return {"sweep1": tuple(out[:3])}
    fn = getattr(lib, "flat_block_occupancy", None)
    if fn is None:
        return {}
    _build.check(fn(k, c_in, e, c_out, int(residual),
                    ctypes.cast(out, ctypes.c_void_p)),
                 "flat_block_occupancy")
    return {"sweep1": tuple(out[:3]), "sweep2": tuple(out[3:])}


def time_sweeps(gen, expand_cases, flat_cases, device="cuda", log=print):
    """Per-sweep records of expand_dw at ``expand_cases`` and flat_block
    at ``flat_cases`` (``chip_smoke.py``'s tuples); returns the list."""
    import torch
    from arbitrarystyletransfer_tpu_torch.ops.kernels.expand_dw import (
        expand_dw,
    )
    from arbitrarystyletransfer_tpu_torch.ops.kernels.flat_block import (
        flat_block,
    )
    from arbitrarystyletransfer_tpu_torch.weights import make_divisible

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    records = []
    for name, n, hw, c_in, e, k, bn, per_req in expand_cases:
        x = rand(n, hw, hw, c_in).bfloat16()
        we, wd = rand(c_in, e) / math.sqrt(c_in), rand(k, k, e) / k
        be = 0.1 * rand(e) if bn else None
        bd = 0.1 * rand(e) if bn else None
        ms = profile_sweeps(lambda: expand_dw(x, we, wd, k, True, be, bd))
        cost = sweep_costs(n, hw, c_in, e, 0, k, False)["sweep1"]
        rec = sweep_record(name, "expand_dw", "sweep1", ms["sweep1"], cost,
                           per_req, occupancy("expand_dw", k, c_in))
        records.append(rec)
        log(json.dumps(rec))
        del x
        torch.cuda.empty_cache()
    for case in flat_cases:
        name, n, hw, c_in, e, c_out, k, bn, residual = case[:9]
        per_req = case[-2]
        x = rand(n, hw, hw, c_in).bfloat16()
        s = make_divisible(e // 4, 8)
        se = {"Dense_0": {"kernel": rand(e, s) / math.sqrt(e),
                          "bias": 0.1 * rand(s)},
              "Dense_1": {"kernel": rand(s, e) / math.sqrt(s),
                          "bias": 0.5 + 0.1 * rand(e)}}
        we, wd = rand(c_in, e) / math.sqrt(c_in), rand(k, k, e) / k
        wp = rand(e, c_out) / math.sqrt(e)
        kw = dict(b_expand=0.1 * rand(e) if bn else None,
                  b_dw=0.1 * rand(e) if bn else None,
                  proj_bias=0.1 * rand(c_out) if bn else None,
                  pre_act=True, identity=residual)
        ms = profile_sweeps(lambda: flat_block(x, we, wd, se, wp, k, **kw))
        costs = sweep_costs(n, hw, c_in, e, c_out, k, residual)
        occ = occupancy("flat_block", k, c_in, e, c_out, residual)
        for sweep in SWEEPS:
            rec = sweep_record(name, "flat_block", sweep, ms[sweep],
                               costs[sweep], per_req, occ)
            records.append(rec)
            log(json.dumps(rec))
        del x
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
    import torch

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
    flat_cases = [c for c in chip_smoke.FLAT_BLOCK_CASES
                  if c[-2] or c[-1]]
    with torch.inference_mode():
        records = time_sweeps(gen, expand_cases, flat_cases)
    per_req = {}
    for r in records:
        key = f"{r['kernel']} {r['sweep']}"
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
