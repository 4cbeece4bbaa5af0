"""Where sweep 1's time goes: ``expand_dw`` with one part cut out.

    python -m arbitrarystyletransfer_tpu_torch.scripts.sweep_ablation

Run from the repository root on the card's machine.  For each cut below it
copies the package into ``build/ablation/<cut>/`` (git-ignored), edits
that copy's ``csrc/expand_dw.cuh`` (the results are wrong on purpose:
only the times mean anything), builds it into its own library, and times
``expand_dw`` (CUDA events, mean of 10 calls after 2) at seven shapes of
the 512px batch-8 path; it prints one JSON line per cut with the ms per
shape and the compiler's spills of the edited kernels.  The cuts:

* ``none``: the kernel as it is;
* ``dw_fma``: the depthwise keeps one tap per output, so most of its
  FMAs and reads go;
* ``expand_mma``: no ``mma.sync`` in the expand (and so none of its
  fragment reads);
* ``x_stage``: no TMA box of the x halo (the expand reads stale x);
* ``hidden_store``: no store of the hidden to HBM;
* ``k3_three_ctas``: not a cut: ``__launch_bounds__`` asks for three
  CTAs per SM at k3 (at most 85 registers) instead of two.

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
CUTS = {
    "none": [],
    "dw_fma": [(
        "if (di >= 0 && di < K) o[r][j] = fmaf(v, wk[di * K + dj], o[r][j]);",
        "if (di == 0 && dj == 0) o[r][j] = fmaf(v, wk[0], o[r][j]);")],
    "expand_mma": [("      mma_bf16(acc[0], a, b);\n", ""),
                   ("        mma_bf16(acc[i], a, b0);\n"
                    "        mma_bf16(acc[i + 1], a, b1);\n", "")],
    "x_stage": [("      mbar_expect_tx(bar, HP * ldx * 2);\n"
                 "      tma_load_4d(xs, xmap, 0, tx0 - P, ty0 - P, n, bar);",
                 "      mbar_arrive(bar);")],
    "hidden_store": [("          *reinterpret_cast<uint4*>(dst) =\n"
                      "              *reinterpret_cast<const uint4*>(src);",
                      "          (void)src;")],
    "k3_three_ctas": [("__launch_bounds__(NTHREADS, MMA ? 2 : 1)",
                       "__launch_bounds__(NTHREADS, MMA ? (K == 3 ? 3 : 2) "
                       ": 1)")],
}
# name, batch, H=W, C_in, E, k (chip_smoke.py's EXPAND_DW_CASES rows).
SHAPES = (("e1", 16, 512, 16, 96, 3), ("e3", 16, 256, 24, 144, 3),
          ("d5-d7", 8, 256, 80, 320, 3), ("d8-d9", 8, 512, 40, 160, 5),
          ("d10", 8, 512, 40, 240, 5), ("d11-d12", 8, 512, 24, 144, 3),
          ("d13", 8, 512, 16, 96, 3))
# Runs inside each copy: times expand_dw and reports the spills.
TIMER = r"""
import json, math, sys, torch
from arbitrarystyletransfer_tpu_torch.ops.kernels import _build
from arbitrarystyletransfer_tpu_torch.ops.kernels.expand_dw import expand_dw
from arbitrarystyletransfer_tpu_torch.scripts.sweep_times import ptxas_report
_build.load_library(ptxas_verbose=True)
spills = sorted({st for _, _, st, _ in
                 ptxas_report(_build.build_info["log"], ("expand_dw_kernel",))
                 if st})
g = torch.Generator(device="cuda").manual_seed(0)
ms = {}
for name, n, hw, cin, e, k in json.loads(sys.argv[1]):
    x = torch.randn(n, hw, hw, cin, generator=g, device="cuda").bfloat16()
    we = torch.randn(cin, e, generator=g, device="cuda") / math.sqrt(cin)
    wd = torch.randn(k, k, e, generator=g, device="cuda") / k
    with torch.inference_mode():
        for _ in range(2):
            expand_dw(x, we, wd, k)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(10):
            expand_dw(x, we, wd, k)
        b.record()
        torch.cuda.synchronize()
    ms[name] = a.elapsed_time(b) / 10
    del x
    torch.cuda.empty_cache()
print(json.dumps({"ms": ms, "spill_bytes": spills}))
"""


def main(argv=None) -> int:
    import torch

    if not torch.cuda.is_available():
        print("sweep_ablation: CUDA is not available", file=sys.stderr)
        return 2
    root = Path.cwd()
    for cut, edits in CUTS.items():
        copy = root / "build" / "ablation" / cut
        shutil.rmtree(copy, ignore_errors=True)
        shutil.copytree(root / "arbitrarystyletransfer_tpu_torch",
                        copy / "arbitrarystyletransfer_tpu_torch")
        src = (copy / HEADER).read_text()
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"{cut}: the text to cut is gone: {old!r}")
            src = src.replace(old, new)
        (copy / HEADER).write_text(src)
        env = dict(os.environ, PYTHONPATH=str(copy),
                   AST_TORCH_BUILD_DIR=str(copy / "kernels"))
        run = subprocess.run([sys.executable, "-c", TIMER,
                              json.dumps(SHAPES)], env=env, cwd=copy,
                             capture_output=True, text=True)
        if run.returncode != 0:
            raise RuntimeError(f"{cut}: {run.stderr[-2000:]}")
        print(json.dumps({"cut": cut, **json.loads(run.stdout)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
