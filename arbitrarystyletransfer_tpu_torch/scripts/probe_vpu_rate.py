"""Issue-rate microbenchmark of the card: FMA with one and with several
accumulator chains, roll, select, hswish and the bf16 round trip, f32 and
bf16.

    python -m arbitrarystyletransfer_tpu_torch.scripts.probe_vpu_rate \\
        [--c 256] [--lanes 4096] [--reps 512] [--iters 3] [--device cuda]

Why: the block kernels' depthwise is k^2 f32 FMAs per hidden value on the
CUDA cores, and their bound charges it at the 67 TFLOP/s spec peak.  Whether
that peak is reached, and with how many independent accumulator chains per
thread (``par`` times the four elements each thread holds, so at least
four), is what this probe measures.

Each case is one launch of the ``probe_rate`` kernel over a (C, L) tile
running ``reps`` operations per element as ``par`` chains of ``reps // par``
dependent steps (``csrc/probe_rate.cu`` says how each op maps to the card).
A single timed launch measures the launch as much as the kernel, so each
measurement chains ``n`` launches between two CUDA events, behind a spin
kernel that keeps the card busy while the host enqueues them, and the
per-call time is the slope between n = 12 and n = 3.  Inputs are drawn
from a generator seeded with ``SEED``.  Prints one line per case and one
JSON object with the JAX script's keys (``<op>_<dtype>_p<par>_Gops``,
operations per second / 1e9, unrounded).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..ops.kernels.probes import probe_rate

CASES = (("fma", "f32", torch.float32, 1), ("fma", "f32", torch.float32, 8),
         ("fma", "bf16", torch.bfloat16, 8),
         ("roll", "f32", torch.float32, 8),
         ("select", "f32", torch.float32, 8),
         ("hswish", "f32", torch.float32, 4),
         ("cast", "f32", torch.float32, 4))
SPIN_CYCLES = 4_000_000  # ~2 ms at the H100's clock: longer than the enqueue
SEED = 0


def device_of(name: str) -> torch.device:
    """The probes' device: CUDA unless the caller asks for the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("probe: --device cuda, but CUDA is not available "
                         "(pass --device cpu to run the plain twins)")
    return device


def chain_time(fn, n, iters=3):
    """Best device ms of ``n`` chained calls (CUDA events around them,
    enqueued behind a spin kernel)."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def per_call_ms(fn, n_hi=12, n_lo=3, iters=3):
    """Device ms per call: the slope between n_hi and n_lo chained calls."""
    hi = chain_time(fn, n_hi, iters)
    lo = chain_time(fn, n_lo, iters)
    return (hi - lo) / (n_hi - n_lo)


def rate_input(c, lanes, dtype, device, gen):
    """Uniform [0.5, 1) in ``dtype``, as the JAX probe draws it."""
    return (0.5 + 0.5 * torch.rand(c, lanes, generator=gen, device=device)
            ).to(dtype)


def run(args):
    """{key: value} of the JAX script, the cases' Gops (None on the CPU)."""
    device = device_of(args.device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    c, lanes = args.c, args.lanes
    res = {"c": c, "lanes": lanes, "reps": args.reps}
    for op, dt_name, dt, par in CASES:
        x = rate_input(c, lanes, dt, device, gen)
        reps_eff = args.reps // par * par
        key = f"{op}_{dt_name}_p{par}_Gops"
        if device.type != "cuda":
            probe_rate(x, op, par, args.reps)
            res[key] = None
            print(f"{op:8s} {dt_name} par={par}: plain twin ran (cpu: not "
                  "measured)", flush=True)
            continue
        ms = per_call_ms(lambda: probe_rate(x, op, par, args.reps),
                         iters=args.iters)
        ops_per_s = c * lanes * reps_eff / (ms / 1e3)
        res[key] = ops_per_s / 1e9
        print(f"{op:8s} {dt_name} par={par}: {ms:8.4f} ms/call  "
              f"{ops_per_s / 1e12:6.3f} Tops/s", flush=True)
    return res


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--c", type=int, default=256)
    p.add_argument("--lanes", type=int, default=4096)
    p.add_argument("--reps", type=int, default=512)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--device", default="cuda",
                   help="Torch device (default cuda; never falls back).")
    return p.parse_args(argv)


if __name__ == "__main__":
    print(json.dumps(run(parse_args(sys.argv[1:]))))
