"""Two trees' 512px route and row times in turns, pooled.

    python -m arbitrarystyletransfer_tpu_torch.scripts.route_turns \\
        PARENT CHANGE [--order CPPCPCCP] [--out chiprun_out/route_turns] \\
        [--f32]

Run on the card's machine.  PARENT and CHANGE are checkouts of the repo
(each with its own ``chip_smoke.py``); for each letter of ``--order`` it
runs ``python3 chip_smoke.py --phase routes`` in that tree (C the change,
P the parent), then this tree's ``sweep_times.py`` against that tree's
package (the bf16 rows' device ms per request by kernel and sweep; with
``--f32`` the f32 rows' too, ``sweep_times.py --f32``), one process at a
time, and keeps their logs in ``--out``.  The routes phase
times each route's bf16 requests (the first a warm-up) and four f32
requests (the first a warm-up), and two more of each in its
``adaattn_fwd`` A/B as served: bf16 ("on the tensor-core kernel") in a
tree from before the f32 serving form, f32 ("on the serving form") since.  One JSON line per route,
dtype and side follows: the phase's own median of each run, and the
median and range of every timed request of every run pooled, so that one
run's host stall moves the pooled median by one request, not a run; then
one per row sweep and side: each run's ms per request, their median and
range.  Fails if a run fails.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
from pathlib import Path

_NUM = r"[0-9.]+"
_REQUEST = re.compile(rf"^(\S+) request (\d+): alpha {_NUM}, ({_NUM}) ms,")
_AB = re.compile(r"^route (\S+) A/B, .*on the tensor-core kernel \[([^]]*)\]")
_AB32 = re.compile(r"^route (\S+) A/B at f32, .*on the serving form "
                   r"\[([^]]*)\]")
_F32 = re.compile(r"^(\S+) f32 requests: \[([^]]*)\] ms")
SWEEP_TIMES = Path(__file__).resolve().with_name("sweep_times.py")
_RUN = re.compile(r"^routes at \d+px batch \d+( f32)?, median ms per "
                  r"request.*this run: (.*)$")


def parse(log: str) -> dict:
    """{(route, dtype): {"run": the phase's median, "timed": [ms, ...]}}
    of one routes-phase log."""
    out: dict = {}

    def entry(route, dtype):
        return out.setdefault((route, dtype), {"run": None, "timed": []})

    for line in log.splitlines():
        if m := _REQUEST.match(line):
            if int(m[2]) > 1:
                entry(m[1], "bf16")["timed"].append(float(m[3]))
        elif m := _AB.match(line):
            entry(m[1], "bf16")["timed"] += [float(v) for v in m[2].split(",")]
        elif m := _AB32.match(line):
            entry(m[1], "f32")["timed"] += [float(v) for v in m[2].split(",")]
        elif m := _F32.match(line):
            entry(m[1], "f32")["timed"] += [float(v)
                                            for v in m[2].split(",")[1:]]
        elif m := _RUN.match(line):
            for route, ms in re.findall(rf"(\S+) ({_NUM}) \(", m[2]):
                entry(route, "f32" if m[1] else "bf16")["run"] = float(ms)
    return out


def pool(runs: list[dict]) -> list[dict]:
    """One record per route, dtype and side from the parsed runs (each
    with its "side")."""
    by: dict = {}
    for run in runs:
        for (route, dtype), d in run["routes"].items():
            rec = by.setdefault((route, dtype, run["side"]), {
                "route": route, "dtype": dtype, "side": run["side"],
                "run_medians": [], "timed": []})
            if d["run"] is not None:
                rec["run_medians"].append(d["run"])
            rec["timed"] += d["timed"]
    records = []
    for rec in by.values():
        timed = rec.pop("timed")
        rec.update(pooled_median=statistics.median(timed),
                   pooled_n=len(timed), pooled_range=[min(timed), max(timed)])
        if rec["run_medians"]:
            rec["median_of_runs"] = statistics.median(rec["run_medians"])
        records.append(rec)
    return records


def run_logged(cmd, tree: Path, log: Path, env=None) -> str:
    """``cmd`` in ``tree``, its output kept in ``log``; its stdout, or
    RuntimeError where it fails."""
    run = subprocess.run(cmd, cwd=tree, capture_output=True, text=True,
                         env=env)
    log.write_text(run.stdout + run.stderr)
    if run.returncode != 0:
        raise RuntimeError(f"{log.name}: rc {run.returncode}")
    return run.stdout


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("change", type=Path)
    ap.add_argument("--order", default="CPPCPCCP")
    ap.add_argument("--out", type=Path, default=Path("chiprun_out/route_turns"))
    ap.add_argument("--f32", action="store_true",
                    help="also time the rows in float32 (sweep_times --f32)")
    args = ap.parse_args(argv)
    if set(args.order) - {"C", "P"}:
        ap.error("--order takes the letters C and P")
    args.out.mkdir(parents=True, exist_ok=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip(), flush=True)
    runs, rows = [], {}
    for i, side in enumerate(args.order, 1):
        tree = (args.change if side == "C" else args.parent).resolve()
        out = run_logged([sys.executable, "chip_smoke.py", "--phase",
                          "routes"], tree, args.out / f"{i:02d}{side}.log")
        runs.append({"side": side, "routes": parse(out)})
        out = run_logged([sys.executable, str(SWEEP_TIMES)]
                         + ["--f32"] * args.f32, tree,
                         args.out / f"{i:02d}{side}_sweeps.log",
                         env=dict(os.environ, PYTHONPATH=str(tree)))
        per = [json.loads(line)["per_request_ms"] for line in
               out.splitlines() if line.startswith('{"per_request_ms"')][-1]
        for key, ms in per.items():
            rows.setdefault((key, side), []).append(ms)
        print(f"turn {i} ({side}) done", flush=True)
    for rec in sorted(pool(runs), key=lambda r: (r["dtype"], r["route"],
                                                 r["side"])):
        print(json.dumps(rec), flush=True)
    for (key, side), ms in sorted(rows.items()):
        print(json.dumps({"row": key, "side": side, "runs": ms,
                          "median": statistics.median(ms),
                          "range": [min(ms), max(ms)]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
