"""Where sweep 1's time goes: ``expand_dw``, ``mega_block`` and (f32)
``flat_s2_block`` with one part cut out.

    python -m arbitrarystyletransfer_tpu_torch.scripts.sweep_ablation [--f32]

Run from the repository root on the card's machine.  For each cut below it
copies the package into ``build/ablation/<cut>/`` (git-ignored), edits
that copy's ``csrc/expand_dw.cuh`` (or ``csrc/flat_s2.cu``; the results
are wrong on purpose: only the times mean anything), builds it into its
own library, and times
``expand_dw`` (CUDA events, mean of 10 calls after 2) at seven shapes of
the 512px batch-8 path and ``mega_block`` (both sweeps; the cuts touch
sweep 1) at three; it prints one JSON line per cut with the ms per shape
and the compiler's spills of the edited kernels.  The cuts:

* ``none``: the kernel as it is;
* ``dw_fma``: the depthwise keeps one tap per output, so most of its
  FMAs and reads go;
* ``expand_mma``: no ``mma.sync`` in the expand (and so none of its
  fragment reads);
* ``x_stage``: no TMA box of the NHWC x halo (the expand reads stale x);
* ``xt_stage``: no TMA box of the (N, H, C, W) x halo (``mega_block``'s
  kXBox staging; the expand reads stale x);
* ``hidden_store``: no store of the hidden to HBM;
* ``k3_three_ctas``: not a cut: ``__launch_bounds__`` asks for three
  CTAs per SM at k3 (at most 85 registers) instead of two.

With ``--f32`` it times the float32 sweep 1 instead (the 3xTF32 expand,
``tf32_products``): ``expand_dw`` at the ten shapes of the 512px f32
"fused" request (``F32_SHAPES``), ``mega_block`` (both sweeps; its
sweep 1 from the (N, H, C, W) f32 box) at the eleven of the f32 "mega"
request (``MEGA_F32_SHAPES``) and ``flat_s2_block`` (both sweeps) at e2
and e4 (``S2_F32_SHAPES``), under the cuts of ``TF32_CUTS``; each line
adds the x boxes per halo and the design each shape took, and the ms per
request of each kernel (each shape's ms times its launches):

* ``none``: the kernels as they are;
* ``tf32_small``: only the hi hi product of each k8 step (1xTF32);
* ``tf32_mma``: none of the three products (their fragment reads stay);
* ``one_cta``, ``two_cta``: not cuts: ``tf32_sized`` sizes every shape's
  x chunks for one CTA per SM, or for two where any chunking lets two
  share an SM, instead of choosing between the two (every f32 design);
* ``s2_tile_8x16``: not a cut: ``flat_s2.cu``'s f32 output tile 8 x 16
  (each thread's depthwise block 4 x 4, as the bf16 sweep's) instead of
  4 x 16, its larger f32 halo leaving one CTA per SM at e4 (which
  ``__launch_bounds__`` then asks for at k5) and two at e2 only with the
  box in two chunks.

``--cuts`` runs the named cuts only (comma-separated; default all).

Needs CUDA; fails without it.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

HEADER = Path("arbitrarystyletransfer_tpu_torch/csrc/expand_dw.cuh")
S2_SOURCE = Path("arbitrarystyletransfer_tpu_torch/csrc/flat_s2.cu")
CUTS = {
    "none": [],
    "dw_fma": [(
        "if (di >= 0 && di < K) o[r][j] = fmaf(v, wk[di * K + dj], o[r][j]);",
        "if (di == 0 && dj == 0) o[r][j] = fmaf(v, wk[0], o[r][j]);")],
    "expand_mma": [("      mma_bf16(acc[0], a, b);\n", ""),
                   ("        mma_bf16(acc[i], a, b0);\n"
                    "        mma_bf16(acc[i + 1], a, b1);\n", "")],
    "x_stage": [("      mbar_expect_tx(bar, HP * ldx * 2);\n"
                 "      tma_load_4d(xs, xmap, ch0, tx0 - P, ty0 - P, n, bar);",
                 "      mbar_arrive(bar);")],
    "xt_stage": [(
        "      mbar_expect_tx(bar, G::HH * cin16 * G::BW * 2);\n"
        "      tma_load_4d(xs, xmap, tx0 - P, ch0, ty0 - P, n, bar);",
        "      mbar_arrive(bar);")],
    "hidden_store": [("          *reinterpret_cast<uint4*>(dst) =\n"
                      "              *reinterpret_cast<const uint4*>(src);",
                      "          (void)src;")],
    "k3_three_ctas": [("__launch_bounds__(NTHREADS, MMA ? 2 : 1)",
                       "__launch_bounds__(NTHREADS, MMA ? (K == 3 ? 3 : 2) "
                       ": 1)")],
}
_TF = ("    for (int i = 0; i < NTN; ++i) "
       "mma_tf32(part[i], {}, {}[i][0], {}[i][1]);\n")
_SIZING = "  return two > 0 && chunks(two) <= chunks(one) + 1 ? two : one;"
TF32_CUTS = {
    "none": [],
    "tf32_small": [(_TF.format("al", "bh", "bh"), ""),
                   (_TF.format("ah", "bl", "bl"), "")],
    "tf32_mma": [(_TF.format("al", "bh", "bh"), ""),
                 (_TF.format("ah", "bl", "bl"), ""),
                 (_TF.format("ah", "bh", "bh"), "")],
    "one_cta": [(_SIZING, "  return one;")],
    "two_cta": [(_SIZING, "  return two > 0 ? two : one;")],
    # (file, old, new): an edit of another source than HEADER
    "s2_tile_8x16": [
        (S2_SOURCE, "constexpr int OH_TF = 4;", "constexpr int OH_TF = 8;"),
        (S2_SOURCE, "__launch_bounds__(NTHREADS, MMA || TF ? 2 : 1)",
         "__launch_bounds__(NTHREADS, MMA || (TF && K == 3) ? 2 : 1)")],
}
# name, batch, H=W, C_in, E, k, launches per 512px f32 "fused" request
# (chip_smoke.py's EXPAND_DW_CASES rows of the path).
F32_SHAPES = (("e1", 16, 512, 16, 96, 3, 1), ("e3", 16, 256, 24, 144, 3, 1),
              ("e5-e6", 16, 128, 40, 160, 5, 2),
              ("d3", 8, 128, 96, 288, 5, 1), ("d4", 8, 128, 96, 384, 5, 1),
              ("d5-d7", 8, 256, 80, 320, 3, 3),
              ("d8-d9", 8, 512, 40, 160, 5, 2),
              ("d10", 8, 512, 40, 240, 5, 1),
              ("d11-d12", 8, 512, 24, 144, 3, 2),
              ("d13", 8, 512, 16, 96, 3, 1))
# name, batch, H=W, C_in, E, C_out, k, launches per 512px f32 "mega"
# request (chip_smoke.py's MEGA_CASES rows of the path).
MEGA_F32_SHAPES = (("e1", 16, 512, 16, 96, 16, 3, 1),
                   ("e3", 16, 256, 24, 144, 24, 3, 1),
                   ("d3", 8, 128, 96, 288, 96, 5, 1),
                   ("d4", 8, 128, 96, 384, 80, 5, 1),
                   ("d5-d6", 8, 256, 80, 320, 80, 3, 2),
                   ("d7", 8, 256, 80, 320, 40, 3, 1),
                   ("d8-d9", 8, 512, 40, 160, 40, 5, 2),
                   ("d10", 8, 512, 40, 240, 24, 5, 1),
                   ("d11", 8, 512, 24, 144, 24, 3, 1),
                   ("d12", 8, 512, 24, 144, 16, 3, 1),
                   ("d13", 8, 512, 16, 96, 16, 3, 1))
# name, batch, H=W (input), C_in, E, C_out, k, launches per 512px f32
# "flat-all" request (chip_smoke.py's FLAT_S2_CASES rows of the path).
S2_F32_SHAPES = (("e2", 16, 512, 16, 96, 24, 3, 1),
                 ("e4", 16, 256, 24, 144, 40, 5, 1))
# name, batch, H=W, C_in, E, k (chip_smoke.py's EXPAND_DW_CASES rows).
SHAPES = (("e1", 16, 512, 16, 96, 3), ("e3", 16, 256, 24, 144, 3),
          ("d5-d7", 8, 256, 80, 320, 3), ("d8-d9", 8, 512, 40, 160, 5),
          ("d10", 8, 512, 40, 240, 5), ("d11-d12", 8, 512, 24, 144, 3),
          ("d13", 8, 512, 16, 96, 3))
# name, batch, H=W, C_in, E, C_out, k (chip_smoke.py's MEGA_CASES rows).
MEGA_SHAPES = (("e1", 16, 512, 16, 96, 16, 3),
               ("d5-d6", 8, 256, 80, 320, 80, 3),
               ("d10", 8, 512, 40, 240, 24, 5))
# Runs inside each copy: times expand_dw and reports the spills.
TIMER = r"""
import json, math, sys, torch
from arbitrarystyletransfer_tpu_torch.ops.kernels import _build
from arbitrarystyletransfer_tpu_torch.ops.kernels.expand_dw import expand_dw
from arbitrarystyletransfer_tpu_torch.ops.kernels.mega_block import mega_block
from arbitrarystyletransfer_tpu_torch.ops.kernels.flat_s2 import flat_s2_block
from arbitrarystyletransfer_tpu_torch.scripts.sweep_times import ptxas_report
_build.load_library(ptxas_verbose=True)
spills = sorted({st for _, _, st, _ in
                 ptxas_report(_build.build_info["log"], ("expand_dw_kernel",))
                 if st})
g = torch.Generator(device="cuda").manual_seed(0)


def rand(*shape):
    return torch.randn(*shape, generator=g, device="cuda")


def timed(fn):
    with torch.inference_mode():
        for _ in range(2):
            fn()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(10):
            fn()
        b.record()
        torch.cuda.synchronize()
    return a.elapsed_time(b) / 10


shapes, mega_shapes, s2_shapes, dtype = json.loads(sys.argv[1])
dt = getattr(torch, dtype)
lib = _build.load_library()
ms, mega_ms, s2_ms, boxes, design = {}, {}, {}, {}, {}


def se_of(e):
    return {"Dense_0": {"kernel": rand(e, 16) / math.sqrt(e),
                        "bias": rand(16)},
            "Dense_1": {"kernel": rand(16, e) / 4.0, "bias": rand(e)}}


for name, n, hw, cin, e, k in shapes:
    x = rand(n, hw, hw, cin).to(dt)
    we, wd = rand(cin, e) / math.sqrt(cin), rand(k, k, e) / k
    ms[name] = timed(lambda: expand_dw(x, we, wd, k))
    boxes[name] = lib.expand_dw_last_boxes()
    design[name] = lib.expand_dw_last_sweep1()
    del x
    torch.cuda.empty_cache()
for name, n, hw, cin, e, cout, k in mega_shapes:
    xt = rand(n, hw, cin, hw).to(dt)
    we, wd = rand(cin, e) / math.sqrt(cin), rand(k, k, e) / k
    se, wp = se_of(e), rand(e, cout) / math.sqrt(e)
    mega_ms[name] = timed(lambda: mega_block(xt, we, wd, se, wp, k))
    boxes["mega_block " + name] = lib.mega_block_last_boxes()
    design["mega_block " + name] = lib.mega_block_last_sweep1()
    del xt
    torch.cuda.empty_cache()
for name, n, hw, cin, e, cout, k in s2_shapes:
    x = rand(n, hw, hw, cin).to(dt)
    we, wd = rand(cin, e) / math.sqrt(cin), rand(k, k, e) / k
    se, wp = se_of(e), rand(e, cout) / math.sqrt(e)
    s2_ms[name] = timed(lambda: flat_s2_block(x, we, wd, se, wp, k))
    boxes["flat_s2_block " + name] = lib.flat_s2_block_last_boxes()
    design["flat_s2_block " + name] = lib.flat_s2_block_last_sweep1()
    del x
    torch.cuda.empty_cache()
print(json.dumps({"ms": ms, "mega_block_ms": mega_ms,
                  "flat_s2_block_ms": s2_ms, "boxes": boxes,
                  "design": design, "spill_bytes": spills}))
"""


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--f32", action="store_true",
                    help="time the f32 sweep 1 (expand_dw, mega_block, "
                    "flat_s2_block) under TF32_CUTS")
    ap.add_argument("--cuts", default=None,
                    help="comma-separated names of the cuts to run")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_ablation: CUDA is not available", file=sys.stderr)
        return 2
    root = Path.cwd()
    cuts = TF32_CUTS if args.f32 else CUTS
    if args.cuts:
        unknown = set(args.cuts.split(",")) - set(cuts)
        if unknown:
            ap.error(f"unknown cuts {sorted(unknown)}")
        cuts = {c: cuts[c] for c in args.cuts.split(",")}
    what = ([[s[:6] for s in F32_SHAPES], [s[:7] for s in MEGA_F32_SHAPES],
             [s[:7] for s in S2_F32_SHAPES], "float32"] if args.f32
            else [SHAPES, MEGA_SHAPES, [], "bfloat16"])
    for cut, edits in cuts.items():
        copy = root / "build" / "ablation" / (cut + "_f32" * args.f32)
        shutil.rmtree(copy, ignore_errors=True)
        shutil.copytree(root / "arbitrarystyletransfer_tpu_torch",
                        copy / "arbitrarystyletransfer_tpu_torch")
        for edit in edits:
            path, old, new = edit if len(edit) == 3 else (HEADER, *edit)
            src = (copy / path).read_text()
            if old not in src:
                raise RuntimeError(f"{cut}: the text to cut is gone: {old!r}")
            (copy / path).write_text(src.replace(old, new))
        env = dict(os.environ, PYTHONPATH=str(copy),
                   AST_TORCH_BUILD_DIR=str(copy / "kernels"))
        run = subprocess.run([sys.executable, "-c", TIMER,
                              json.dumps(what)], env=env,
                             cwd=copy,
                             capture_output=True, text=True)
        if run.returncode != 0:
            raise RuntimeError(f"{cut}: {run.stderr[-2000:]}")
        rec = json.loads(run.stdout)
        if args.f32:
            rec["per_request_ms"] = sum(rec["ms"][s[0]] * s[6]
                                        for s in F32_SHAPES)
            rec["mega_block_per_request_ms"] = sum(
                rec["mega_block_ms"][s[0]] * s[7] for s in MEGA_F32_SHAPES)
            rec["flat_s2_block_per_request_ms"] = sum(
                rec["flat_s2_block_ms"][s[0]] * s[7] for s in S2_F32_SHAPES)
        print(json.dumps({"cut": cut, **rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
