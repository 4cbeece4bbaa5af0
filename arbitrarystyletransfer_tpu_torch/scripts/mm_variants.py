"""Design alternatives of the product probes, timed in turns.

    python -m arbitrarystyletransfer_tpu_torch.scripts.mm_variants

Run from the repository root on the card's machine.  Each variant below is
a copy of ``csrc/probe_mm.cu`` with one choice of its launch or staging
changed, written to ``build/mm_variants/<variant>/`` (git-ignored),
compiled alone into a library of its own (one ``nvcc`` each, all started
together) and loaded with ``ctypes``; then at each shape below both
schedules are timed by the ``probe_mega2`` driver's method (the slope
between 12 and 3 chained calls, inputs in L2) for every variant in turn,
three times over.  Prints one JSON line per shape: per variant and
schedule the three times in microseconds, shared memory a CTA asks for,
CTAs per SM, grid, and whether its output held the plain twin (one bf16
ulp of the largest value).  The variants:

* ``as_is``: the kernels as they are;
* ``packed``: where one wave holds every item, the CTAs per SM the CTA's
  own shared memory allows, not ceil(items / SMs);
* ``in_place``: the weight's bulk copy always lands at the end of its own
  area (where E / 8 is even) and moves forward in place, never in the y
  staging tiles.

Needs CUDA; fails without it.
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

SOURCE = Path("arbitrarystyletransfer_tpu_torch/csrc/probe_mm.cu")
VARIANTS = {
    "as_is": [],
    "packed": [("const int want = (a.items + sms - 1) / sms;",
                "const int want = 1 << 30;")],
    "in_place": [("if (a.c * a.e <= a.yslots * y_rows(a) * WT)",
                  "if (false)")],
}
# (R, C, E, W): probe_mega2's two product shapes, then one of 4096 items.
SHAPES = ((32, 40, 160, 512), (32, 240, 24, 512), (64, 40, 160, 4096))
SCHEDULES = ("einsum", "rowloop")


def build(root: Path) -> dict:
    """{variant: ctypes library}, each compiled from its edited copy."""
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = str(Path(CUDA_HOME) / "bin" / "nvcc")
    src = SOURCE.read_text()
    jobs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: the text to edit is gone: "
                                   f"{old!r}")
            text = text.replace(old, new)
        out = root / name
        out.mkdir(parents=True, exist_ok=True)
        (out / "probe_mm.cu").write_text(text)
        jobs[name] = subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-Xcompiler", "-fPIC", "-shared", "-I",
             str(SOURCE.parent), "-o", str(out / "lib.so"),
             str(out / "probe_mm.cu"), "-lcuda"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, job in jobs.items():
        log, _ = job.communicate()
        if job.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed:\n{log}")
        lib = ctypes.CDLL(str(root / name / "lib.so"))
        for sch in SCHEDULES:
            getattr(lib, f"probe_mm_{sch}_launch").argtypes = (
                [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                + [ctypes.c_void_p])
        lib.probe_mm_occupancy.argtypes = [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        libs[name] = lib
    return libs


def main(argv=None) -> int:
    import torch

    from .probe_vpu_rate import per_call_ms

    if not torch.cuda.is_available():
        print("mm_variants: CUDA is not available", file=sys.stderr)
        return 2
    libs = build(Path.cwd() / "build" / "mm_variants")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for r, c, e, w in SHAPES:
        x = torch.randn(r, c, w, generator=gen, device="cuda").bfloat16()
        wt = (torch.randn(c, e, generator=gen, device="cuda")
              / math.sqrt(c)).bfloat16()
        ref = torch.einsum("rcw,ce->rew", x.float(), wt.float()).bfloat16()
        tol = 2.0 ** -7 * float(ref.float().abs().max())
        y = torch.empty(r, e, w, dtype=torch.bfloat16, device="cuda")
        out = {}
        for _ in range(3):
            for name, lib in libs.items():
                for i, sch in enumerate(SCHEDULES):
                    fn = getattr(lib, f"probe_mm_{sch}_launch")

                    def call():
                        rc = fn(x.data_ptr(), wt.data_ptr(), y.data_ptr(), r,
                                c, e, w,
                                torch.cuda.current_stream().cuda_stream)
                        if rc != 0:
                            raise RuntimeError(f"{name}: CUDA error {rc}")

                    key = f"{name}/{sch}"
                    if key not in out:
                        call()
                        torch.cuda.synchronize()
                        occ = (ctypes.c_int * 7)()
                        lib.probe_mm_occupancy(i, r, c, e, w, occ)
                        err = float((y.float() - ref.float()).abs().max())
                        out[key] = {"us": [], "smem": occ[2],
                                    "ctas_per_sm": occ[3], "grid": occ[5],
                                    "ok": err <= tol}
                    out[key]["us"].append(per_call_ms(call) * 1e3)
        print(json.dumps({"shape": [r, c, e, w], "variants": out}),
              flush=True)
        del x, y
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
