"""Time every block route on the card and write the dispatch table of
"auto" (``ops/policy.py``): the twin of the JAX package's
``scripts/autotune_blocks.py``.

    python -m arbitrarystyletransfer_tpu_torch.scripts.autotune_blocks \\
        --size 512 [--batch 8] [--iters 20] [--out PATH] [--skip_existing] \\
        [--device cuda]

Walks every block instance one stylize pass runs at ``--size``
(``enumerate_blocks``: the encoder, the ``ada_out`` fuse block, the decoder
with its upsample schedule) and times each route the planner can give it,
in bf16 at ``--batch`` with fan-in random weights from a seed:

    xla    blocks.plain_block_apply        plain PyTorch
    fused  fused_block.fused_block_apply   expand_dw kernel + epilogue
    flat   flatblock.flat_block_apply      flat_block kernel (stride-1
                                           blocks of an eligible width)
    flat2  flatblock_s2.flat_s2_block_apply  flat_s2_block kernel
                                           (eligible stride-2 blocks,
                                           beside xla)

Each time is the minimum over 3 windows of ``--iters`` calls, CUDA events
around each window, after a warm-up call that builds the kernels; each call
takes the last one's output mixed into its input (``timed``), as JAX's
tuner chains its calls.  A route that raises is written as ``<route>_err``.
Writes JAX's format (``cases`` keyed by ``policy.block_key``: ``*_ms``,
``best``; ``meta``), merged into ``--out`` where it exists (the keys carry
the size, so sizes add up).  Every route of the port is NHWC, so there is
no layout switch to time: ``tp_ms`` is 0 and there is no ``flati_ms``.

``--device cuda`` (the default) fails without a card; ``--device cpu``
times the plain twins with the host's clock, to check the tool's walk and
output, and its times are not the card's.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from ..config import ModelConfig
from ..ops import policy
from ..ops.blocks import plain_block_apply
from ..ops.flatblock import flat_block_apply, halved, stride_ok
from ..ops.flatblock_s2 import flat_s2_block_apply, s2_eligible
from ..ops.fused_block import fused_block_apply
from ..weights import _block, to_device

SEED = 0
LAYOUT_NOTE = ("every route is NHWC: no layout switch to time, so tp_ms is "
               "0 and no flati_ms is written")


def enumerate_blocks(cfg, size: int):
    """(c_in, c_out, stride, k, t, h, w) of every block instance of one
    stylize pass at ``size`` px, deduplicated and sorted (the JAX tuner's
    walk)."""
    cases = {}

    def add(c_in, c_out, stride, k, t, h, w):
        cases[(c_in, c_out, stride, k, t, h, w)] = None

    # The encoder: stride-2 blocks halve the resolution; the final block is
    # built with kernel 3 and expand_ratio.
    shapes = cfg.enc_conv_shapes
    res = size // shapes[0][2]
    for i, row in enumerate(shapes[1:], start=1):
        c_in, c_out, stride, k, t = row
        if i == len(shapes) - 1:
            k, t = 3, cfg.expand_ratio
        add(c_in, c_out, stride, k, t, res, res)
        res = halved(res, stride)

    # The ada_out fuse block: two 128-channel maps at 1/8 resolution.
    r8 = halved(size, 8)
    add(2 * cfg.enc_out_channels, cfg.enc_out_channels, 1, 3,
        cfg.expand_ratio, r8, r8)

    # The decoder: an upsample after block i where c_in != c_out and
    # i + 6 < rows.
    dshapes = cfg.decoder_conv_shapes
    res = r8
    for i, shape in enumerate(dshapes[:-1]):
        c_in, c_out, _, k, t = shape
        add(c_in, c_out, 1, k, t, res, res)
        if c_in != c_out and i + 6 < len(dshapes):
            res *= 2
    return sorted(cases)


class Clock:
    """ms between two marks: CUDA events on the card, the host's clock on
    the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def start(self):
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return event
        return time.perf_counter()

    def ms_since(self, mark) -> float:
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            torch.cuda.synchronize()
            return mark.elapsed_time(end)
        return (time.perf_counter() - mark) * 1e3


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def timed(fn, x, iters: int, clock: Clock) -> float:
    """Minimum over 3 windows of ``iters`` chained calls of ms per call,
    after one warm-up call (which builds the kernels)."""
    fn(x)
    sync(x.device)
    windows = []
    for _ in range(3):
        c = x
        mark = clock.start()
        for _ in range(iters):
            out = fn(c)
            # Each call reads the last one's output: shape-keeping blocks
            # mix it in, shape-changing ones through one of its values.
            c = (x * 0.99 + out * 0.01 if out.shape == x.shape
                 else x + 0.0 * out.reshape(-1)[0])
        windows.append(clock.ms_since(mark) / iters)
    return min(windows)


def routes(params, c_in, c_out, stride, k, t, h, w):
    """{route: fn(x)} of the routes the planner offers this block."""
    identity = c_in == c_out
    dtype = torch.bfloat16
    fns = {"xla": lambda v: plain_block_apply(
        params, v, k, stride, t, use_identity=identity, dtype=dtype)}
    if stride == 2:
        if s2_eligible(h, w):
            fns["flat2"] = lambda v: flat_s2_block_apply(params, v, k, t,
                                                         dtype=dtype)
        return fns
    fns["fused"] = lambda v: fused_block_apply(
        params, v, k, t, use_identity=identity, dtype=dtype)
    if stride_ok(w):
        fns["flat"] = lambda v: flat_block_apply(
            params, v, k, t, use_identity=identity, dtype=dtype)
    return fns


def tune_block(case, batch: int, iters: int, device: torch.device) -> dict:
    """The table row of one block instance."""
    c_in, c_out, stride, k, t, h, w = case
    gen = torch.Generator().manual_seed(SEED)
    params = to_device(_block(gen, c_in, c_out, t, k, use_norm=False)[0],
                       device)
    x = torch.randn(batch, h, w, c_in, generator=gen).to(
        device, torch.bfloat16)
    clock = Clock(device)
    row = {}
    fns = routes(params, *case)
    for name, fn in fns.items():
        try:
            row[f"{name}_ms"] = timed(fn, x, iters, clock)
        except Exception as e:  # noqa: BLE001 — record it, tune the rest
            row[f"{name}_err"] = f"{type(e).__name__}: {e}"[:160]
    row["tp_ms"] = 0.0
    timed_routes = {n: row[f"{n}_ms"] for n in fns if f"{n}_ms" in row}
    if timed_routes:
        row["best"] = min(timed_routes, key=timed_routes.get)
    return row


def card_meta(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"device": str(device), "power_limit": None}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
         f"--id={torch.cuda.current_device()}"],
        capture_output=True, text=True)
    return {"device": torch.cuda.get_device_name(device),
            "power_limit": smi.stdout.strip() or None}


def git_head() -> str | None:
    try:
        out = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                             capture_output=True, text=True)
    except OSError:
        return None
    return out.stdout.strip() or None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--size", type=int, default=512,
                   help="the stylize resolution to tune for")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--out", default=str(policy.DEFAULT_PATH))
    p.add_argument("--skip_existing", action="store_true",
                   help="tune only the blocks the table lacks")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("autotune_blocks: CUDA is not available (the table times the "
              "card's kernels; --device cpu only checks the walk)",
              file=sys.stderr)
        return 2
    prev = policy.read_table(args.out)
    cases = enumerate_blocks(ModelConfig(), args.size)
    if args.skip_existing:
        have = prev.get("cases", {})
        cases = [c for c in cases if policy.block_key(*c) not in have]
    print(f"{len(cases)} unique block instances at {args.size}px",
          flush=True)

    table = {}
    with torch.inference_mode():
        for case in cases:
            key = policy.block_key(*case)
            table[key] = tune_block(case, args.batch, args.iters, device)
            print(json.dumps({key: table[key]}), flush=True)

    # Keys carry the size, so another size's rows stay; re-timed keys are
    # replaced.
    prev_sizes = prev.get("meta", {}).get("sizes") or []
    out = {
        "meta": {"sizes": sorted({*prev_sizes, args.size}),
                 "batch": args.batch, "iters": args.iters, "git": git_head(),
                 **card_meta(device), "layout": LAYOUT_NOTE},
        "cases": {**prev.get("cases", {}), **table},
    }
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1, sort_keys=True)
        fh.write("\n")
    print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
