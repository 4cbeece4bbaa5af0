"""Design probes for the block kernels on the card: copy rate through a
two-slot on-chip ring, in-kernel tensor-core products, and the f32 depthwise
in a channel-planar layout against NHWC.

    python -m arbitrarystyletransfer_tpu_torch.scripts.probe_mega2 \\
        [--probes 123] [--iters 20] [--device cuda]

  P1  the ``probe_copy`` kernel (TMA bulk copies through a two-slot ring in
      shared memory) on (B, H, C, W) bf16, against PyTorch's ``x * 1.0``
  P2a ``probe_mm_einsum``: y = einsum('rcw,ce->rew') with f32 accumulation
      on the tensor cores, one launch tiling every (r, w)
  P2b ``probe_mm_rowloop``: the same product, each CTA walking its rows
  P3  f32 depthwise: ``probe_dw_t`` on (th + 2p, C, W), W circular, against
      ``probe_dw_nhwc`` on a pre-padded (th + 2p, W + 2p, C)

P1 and P3 report the best of 3 windows of ``--iters`` calls (CUDA events);
P3 cycles through enough copies of its input that L2 (50 MB) holds none
between calls.  P2's launches take microseconds, so it reports the slope
between 12 and 3 chained calls, as ``probe_vpu_rate`` does.  Inputs are
drawn from a generator seeded with ``SEED``.  Prints one JSON object with
the JAX script's keys (P1's ``xla_*`` are ``torch_*`` here), unrounded.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import torch

from ..ops.kernels.probes import (
    probe_copy,
    probe_dw_nhwc,
    probe_dw_t,
    probe_mm_einsum,
    probe_mm_rowloop,
)
from .probe_vpu_rate import SEED, SPIN_CYCLES, device_of, per_call_ms

L2_BYTES = 50 * 2**20


def timed(fn, inputs, iters=20, windows=3):
    """Best device ms per call over ``windows`` windows of ``iters`` calls,
    the calls cycling through ``inputs``."""
    fn(inputs[0])
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for i in range(iters):
            fn(inputs[i % len(inputs)])
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


# ---------------------------------------------------------------- P1
def p1_dma_copy(b, h, c, w, th, dtype, device, gen, iters=20):
    x = torch.randn(b, h, c, w, generator=gen, device=device).to(dtype)
    if device.type != "cuda":
        probe_copy(x, th)
        return {"kernel_ms": None, "GBps": None, "torch_ms": None,
                "torch_GBps": None}
    ms = timed(lambda v: probe_copy(v, th), [x], iters)
    ms_torch = timed(lambda v: v * 1.0, [x], iters)
    gb = 2 * x.numel() * x.element_size() / 1e9
    return {"kernel_ms": ms, "GBps": gb / ms * 1e3, "torch_ms": ms_torch,
            "torch_GBps": gb / ms_torch * 1e3}


# ---------------------------------------------------------------- P2
def p2_matmul(th, c, e, w, dtype, device, gen, iters=20):
    x = torch.randn(th, c, w, generator=gen, device=device).to(dtype)
    wt = (torch.randn(c, e, generator=gen, device=device)
          / math.sqrt(c)).to(dtype)
    out = {}
    for name, fn in (("einsum", probe_mm_einsum),
                     ("rowloop", probe_mm_rowloop)):
        if device.type != "cuda":
            fn(x, wt)
            out[name] = {"ms": None, "GFLOPs": None}
            continue
        ms = per_call_ms(lambda: fn(x, wt))
        fl = 2 * th * c * e * w / 1e9
        out[name] = {"ms": ms, "GFLOPs": fl / ms * 1e3}
    return out


# ---------------------------------------------------------------- P3
def dw_inputs(th, c, w, k, device, gen):
    """(x_t (th+2p, C, W), x_n (th+2p, W+2p, C), wd (k, k, C)), f32."""
    pad = (k - 1) // 2
    x_t = torch.randn(th + 2 * pad, c, w, generator=gen, device=device)
    x_n = torch.randn(th + 2 * pad, w + 2 * pad, c, generator=gen,
                      device=device)
    wd = torch.randn(k, k, c, generator=gen, device=device) / k
    return x_t, x_n, wd


def l2_copies(x):
    """Copies of x that together exceed L2, to cycle through."""
    n = max(1, math.ceil(2 * L2_BYTES / (x.numel() * x.element_size())))
    return [x] + [x.clone() for _ in range(n - 1)]


def p3_dw(th, c, w, k, device, gen, iters=20):
    x_t, x_n, wd = dw_inputs(th, c, w, k, device, gen)
    if device.type != "cuda":
        probe_dw_t(x_t, wd)
        probe_dw_nhwc(x_n, wd)
        return {"transposed_ms": None, "nhwc_ms": None}
    return {
        "transposed_ms": timed(lambda v: probe_dw_t(v, wd), l2_copies(x_t),
                               iters),
        "nhwc_ms": timed(lambda v: probe_dw_nhwc(v, wd), l2_copies(x_n),
                         iters),
    }


# The JAX script's probes: (flag, key, function, shape arguments).
PROBES = (
    ("1", "p1_copy_b8_h512_c160_w512_bf16_th64", p1_dma_copy,
     (8, 512, 160, 512, 64, torch.bfloat16)),
    ("1", "p1_copy_b8_h512_c96_w512_bf16_th128", p1_dma_copy,
     (8, 512, 96, 512, 128, torch.bfloat16)),
    ("2", "p2_mm_th32_c40_e160_w512_bf16", p2_matmul,
     (32, 40, 160, 512, torch.bfloat16)),
    ("2", "p2_mm_th32_c240_e24_w512_bf16", p2_matmul,
     (32, 240, 24, 512, torch.bfloat16)),
    ("3", "p3_dw_th32_c160_w512_k5", p3_dw, (32, 160, 512, 5)),
    ("3", "p3_dw_th32_c96_w512_k3", p3_dw, (32, 96, 512, 3)),
)


def run(args):
    """{key: result} of the JAX script's probes that ``args.probes``
    names."""
    device = device_of(args.device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    res = {}
    for flag, key, fn, shape in PROBES:
        if flag not in args.probes:
            continue
        res[key] = fn(*shape, device, gen, args.iters)
    return res


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--probes", default="123")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--device", default="cuda",
                   help="Torch device (default cuda; never falls back).")
    return p.parse_args(argv)


if __name__ == "__main__":
    print(json.dumps(run(parse_args(sys.argv[1:])), indent=1))
