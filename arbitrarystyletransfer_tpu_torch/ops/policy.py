"""The measured per-block dispatch policy of "auto": the twin of
``arbitrarystyletransfer_tpu/ops/pallas/policy.py``.

A stride-1 block of the flat chains has three routes: the ``expand_dw``
kernel with the PyTorch epilogue ("fused", ``fused_block.block_apply``), the
``flat_block`` kernel ("flat") and plain PyTorch ("xla", the JAX name of
``blocks.plain_block_apply``); an eligible stride-2 block has the
``flat_s2_block`` kernel ("flat2") and the plain route.  Which wins depends
on channels, kernel size, expand ratio and resolution, and only a
measurement on the card says: ``scripts/autotune_blocks.py`` times every
block instance of one stylize pass and writes the table; this module reads
it.  ``flatblock.plan_impls`` in mode "auto" plans each chain with
``plan_chain`` and, where the table lacks a row the chain needs, block by
block with ``best_impl``, then the "tail" heuristic.

The table ships at ``ops/tuned_policy.json``, measured on the card named in
its ``meta.device``; ``AST_TUNED_POLICY`` overrides the path (the JAX
package reads the same variable).  A table measured on another card than
the one a plan is for is not used: the plan is then the table-less one,
with one warning.  On the CPU, where the kernels' plain twins run, the name
is not checked.

The port's routes are all NHWC, so its tuner writes ``tp_ms`` 0 and no
``flati_ms`` (the TPU's NHWC <-> flat NCHW switch and halo chaining have no
counterpart here), and ``plan_chain`` reduces to the fastest route of each
block.  It keeps the whole two-state plan of JAX all the same, so that it
plans a TPU table as JAX does.
"""

from __future__ import annotations

import functools
import json
import os
import warnings
from pathlib import Path

import torch

DEFAULT_PATH = Path(__file__).with_name("tuned_policy.json")


def block_key(c_in: int, c_out: int, stride: int, k: int, t: float, h: int,
              w: int) -> str:
    """The table's key of one block instance (``policy.block_key``); the
    batch is not part of it."""
    return f"{c_in}-{c_out}s{stride}k{k}t{t}@{h}x{w}"


def _device_name(device) -> str | None:
    """The card's name for a CUDA ``device``, None for any other."""
    if device is None:
        return None
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.get_device_name(device)


def read_table(path=None) -> dict:
    """The whole table file at ``path`` (default: ``AST_TUNED_POLICY`` or
    the shipped one), or {} when it is missing or unreadable."""
    path = path or os.environ.get("AST_TUNED_POLICY", str(DEFAULT_PATH))
    try:
        with open(path) as fh:
            return json.load(fh)
    except (OSError, json.JSONDecodeError):
        return {}


@functools.lru_cache(maxsize=None)
def _cases(card: str | None) -> dict:
    data = read_table()
    measured_on = data.get("meta", {}).get("device")
    if card is not None and data and measured_on != card:
        warnings.warn(
            f"the tuned dispatch table was measured on {measured_on!r}, "
            f"this plan is for {card!r}: \"auto\" plans without it")
        return {}
    return data.get("cases", {})


def load_policy(device=None) -> dict:
    """The table's cases for a plan on ``device``, or {} when the file is
    missing or unreadable, or was measured on another card (cached by
    card: ``clear_cache`` after changing ``AST_TUNED_POLICY``)."""
    return _cases(_device_name(device))


def clear_cache() -> None:
    _cases.cache_clear()


def best_impl(c_in: int, c_out: int, stride: int, k: int, t: float, h: int,
              w: int, device=None) -> str | None:
    """The measured fastest route of this block, or None when the table has
    no row for it (the caller falls back to its heuristic)."""
    entry = load_policy(device).get(block_key(c_in, c_out, stride, k, t, h,
                                              w))
    if not entry:
        return None
    return entry.get("best")


def plan_chain(blocks: list[dict], device=None) -> list[str] | None:
    """The two-state plan of a chain of blocks (``policy.plan_chain``): one
    route per block, or None when a stride-1 row the chain needs is missing.

    ``blocks`` rows: ``key``; ``flat_ok`` (the flat kernel's width rule);
    ``stride2`` (its flat-state route is "flat2", which breaks a halo chain);
    ``force_nhwc`` (a stride-2 block no flat kernel takes); ``nhwc_out`` (an
    NHWC copy of the output is read elsewhere); ``est_bytes`` (the transpose
    estimate of an untuned stride-2 row).  The states are JAX's layouts,
    NHWC and flat NCHW; a switch costs the consuming block's ``tp_ms``, and
    a block timed as a halo-chain interior (``flati_ms``) charges half of
    ``flat_ms - flati_ms`` at each boundary of its flat run.  A stride-2 row
    without ``flat2_ms`` costs the same on both routes."""
    table = load_policy(device)
    inf = float("inf")

    # (nhwc routes, (flat-state route, ms) or None, (tp, bnd), block,
    # breaks the chain)
    rows = []
    for blk in blocks:
        row = table.get(blk["key"])
        if blk.get("force_nhwc") or blk.get("stride2"):
            tp = (row or {}).get("tp_ms")
            if tp is None:
                # Two passes of the input at ~300 GB/s (JAX's estimate).
                tp = blk.get("est_bytes", 0) * 2 / 300e9 * 1e3
            if blk.get("force_nhwc"):
                rows.append(({"xla": 0.0}, None, (tp, 0.0), blk, True))
            else:
                xla_ms = (row or {}).get("xla_ms", 0.0)
                rows.append(({"xla": xla_ms},
                             ("flat2", (row or {}).get("flat2_ms", xla_ms)),
                             (tp, 0.0), blk, True))
            continue
        if not row:
            return None
        nhwc_opts = {n: row[f"{n}_ms"] for n in ("fused", "xla")
                     if f"{n}_ms" in row}
        if not nhwc_opts or "tp_ms" not in row:
            return None
        flat_ms = row.get("flat_ms") if blk.get("flat_ok", True) else None
        bnd = 0.0
        if flat_ms is not None and row.get("flati_ms") is not None:
            bnd = max(0.0, (flat_ms - row["flati_ms"]) / 2)
            flat_ms = row["flati_ms"]
        flat_opt = None if flat_ms is None else ("flat", flat_ms)
        rows.append((nhwc_opts, flat_opt, (row["tp_ms"], bnd), blk, False))

    # States 0 = NHWC, 1 = flat; the chain enters and leaves NHWC.  Leaving
    # the flat state pays the previous flat block's boundary share, and so
    # does staying flat through a chain-breaking block.
    cost = [0.0, inf]
    choice: list[list[tuple[str, int] | None]] = []
    prev_bnd = 0.0
    for nhwc_opts, flat_opt, (tp, bnd), blk, brk in rows:
        best_nhwc = min(nhwc_opts, key=nhwc_opts.get)
        nxt = [inf, inf]
        pick: list[tuple[str, int] | None] = [None, None]
        arrive_nhwc = min((cost[0], 0), (cost[1] + tp + prev_bnd, 1),
                          key=lambda p: p[0])
        nxt[0] = arrive_nhwc[0] + nhwc_opts[best_nhwc]
        pick[0] = (best_nhwc, arrive_nhwc[1])
        if flat_opt is not None:
            name, flat_ms = flat_opt
            stay = cost[1] + (prev_bnd if brk else 0.0)
            arrive_flat = min((cost[0] + tp + bnd, 0), (stay, 1),
                              key=lambda p: p[0])
            extra = tp if blk.get("nhwc_out") else 0.0
            nxt[1] = arrive_flat[0] + flat_ms + extra
            pick[1] = (name, arrive_flat[1])
        cost = nxt
        choice.append(pick)
        prev_bnd = 0.0 if brk else bnd

    exit_tp = rows[-1][2][0] + rows[-1][2][1]
    state = 0 if cost[0] <= cost[1] + exit_tp else 1
    impls: list[str] = []
    for pick in reversed(choice):
        sel = pick[state]
        assert sel is not None
        impls.append(sel[0])
        state = sel[1]
    impls.reverse()
    return impls
