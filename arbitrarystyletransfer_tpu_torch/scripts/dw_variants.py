"""Design alternatives of the depthwise probes, timed in turns.

    python -m arbitrarystyletransfer_tpu_torch.scripts.dw_variants

Run from the repository root on the card's machine.  Each variant below is
a copy of ``csrc/probe_dw.cu`` with one choice of its schedule changed,
written to ``build/dw_variants/<variant>/`` (git-ignored), compiled alone
into a library of its own (one ``nvcc`` each, all started together) and
loaded with ``ctypes``; then at each of ``probe_mega2``'s two depthwise
shapes each layout is timed as ``probe_mega2.timed`` times it (best of 3
windows of 20 calls, the inputs cycled past L2) for every variant in
turn, twice over.  Prints one JSON line per layout and shape: per variant
the two times, registers, local (spill) bytes a thread, CTAs per SM,
tiles, grid, and whether its output held the plain twin (1e-5 of the
largest value).  The variants:

* ``as_is``: the kernels as they are;
* ``two_ctas_k5``: no floor of three CTAs per SM at k5 (the compiler's
  choice of registers, two CTAs per SM);
* ``three_slots``: a ring of three slots;
* ``lookahead_1``: one tile staged ahead instead of two;
* ``rows8_k3``: 8 output rows a tile at k3, as at k5 (and a floor of four
  CTAs per SM instead of seven, which its registers allow);
* ``rows4_k5``: 4 output rows a tile at k5, as at k3 (and a floor of four
  CTAs per SM instead of three);
* ``pads_always``: dw_t stages the 4 columns past each side with two more
  bulk copies a row also where a tile is whole rows.

Needs CUDA; fails without it.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

SOURCE = Path("arbitrarystyletransfer_tpu_torch/csrc/probe_dw.cu")
VARIANTS = {
    "as_is": [],
    "two_ctas_k5": [("__launch_bounds__(NT, K == 5 ? 3 : 7)",
                     "__launch_bounds__(NT, K == 5 ? 1 : 7)")],
    "three_slots": [("constexpr int SLOTS = 2;", "constexpr int SLOTS = 3;")],
    "lookahead_1": [("constexpr int LOOKAHEAD = 2;",
                     "constexpr int LOOKAHEAD = 1;")],
    "rows8_k3": [("K == 5 ? 8 : 4;", "K == 5 ? 8 : 8;"),
                 ("K == 5 ? 3 : 7)", "K == 5 ? 3 : 4)")],
    "rows4_k5": [("K == 5 ? 8 : 4;", "K == 5 ? 4 : 4;"),
                 ("K == 5 ? 3 : 7)", "K == 5 ? 4 : 7)")],
    "pads_always": [("const bool pads = !a.whole;",
                     "const bool pads = true;"),
                    ("x0, lane, a.w, a.whole, v);",
                     "x0, lane, a.w, false, v);")],
}
# probe_mega2's P3 shapes: th, C, W, k.
SHAPES = ((32, 160, 512, 5), (32, 96, 512, 3))


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
        (out / "probe_dw.cu").write_text(text)
        jobs[name] = subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-Xcompiler", "-fPIC", "-shared", "-I",
             str(SOURCE.parent), "-o", str(out / "lib.so"),
             str(out / "probe_dw.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, job in jobs.items():
        log, _ = job.communicate()
        if job.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed:\n{log}")
        lib = ctypes.CDLL(str(root / name / "lib.so"))
        for fn in ("probe_dw_t_launch", "probe_dw_nhwc_launch"):
            getattr(lib, fn).argtypes = ([ctypes.c_void_p] * 3
                                         + [ctypes.c_int] * 4
                                         + [ctypes.c_void_p])
        lib.probe_dw_occupancy.argtypes = [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        libs[name] = lib
    return libs


def main(argv=None) -> int:
    import torch

    from ..ops.kernels.probes import (
        probe_dw_nhwc_reference,
        probe_dw_t_reference,
    )
    from .probe_mega2 import dw_inputs, l2_copies, timed

    if not torch.cuda.is_available():
        print("dw_variants: CUDA is not available", file=sys.stderr)
        return 2
    libs = build(Path.cwd() / "build" / "dw_variants")
    gen = torch.Generator(device="cuda").manual_seed(0)
    keys = ("registers", "local_bytes", "smem", "ctas_per_sm", "tiles",
            "grid")
    for th, c, w, k in SHAPES:
        x_t, x_n, wd = dw_inputs(th, c, w, k, "cuda", gen)
        for layout, x, twin, shape in (
                (0, x_t, probe_dw_t_reference, (th, c, w)),
                (1, x_n, probe_dw_nhwc_reference, (th, w, c))):
            ref = twin(x, wd)
            xs = l2_copies(x)
            y = torch.empty(shape, device="cuda")
            out = {}
            for _ in range(2):
                for name, lib in libs.items():
                    fn = (lib.probe_dw_t_launch if layout == 0
                          else lib.probe_dw_nhwc_launch)

                    def call(v):
                        rc = fn(v.data_ptr(), wd.data_ptr(), y.data_ptr(), th,
                                c, w, k, torch.cuda.current_stream()
                                .cuda_stream)
                        if rc != 0:
                            raise RuntimeError(f"{name}: CUDA error {rc}")

                    if name not in out:
                        call(x)
                        torch.cuda.synchronize()
                        occ = (ctypes.c_int * 6)()
                        lib.probe_dw_occupancy(layout, th, c, w, k, occ)
                        err = float((y - ref).abs().max())
                        out[name] = {"ms": [], **dict(zip(keys, occ)),
                                     "ok": err <= 1e-5 * float(
                                         ref.abs().max())}
                    out[name]["ms"].append(timed(call, xs))
            name = ("probe_dw_t", "probe_dw_nhwc")[layout]
            print(json.dumps({"layout": name, "shape": [th, c, w, k],
                              "variants": out}), flush=True)
            del xs
        del x_t, x_n
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
