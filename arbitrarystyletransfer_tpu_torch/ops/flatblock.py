"""The flat block routes (NHWC): the twin of the host half of
``arbitrarystyletransfer_tpu/ops/pallas/flatblock.py``.

``flat_block_apply`` runs a whole stride-1 block through the ``flat_block``
kernel.  The planner (``plan_impls``, ``planned_chains``) and the chains
(``encode_flat``, ``decode_flat``) keep the JAX routing: which blocks take
the flat kernel, the stride-2 kernel, the fused route or the plain route.
The JAX package's flat NCHW layout, its transposes, halo chaining and row
planning are TPU layout machinery and have no counterpart here.

"auto" plans from the table measured on the card (``ops/policy.py``, written
by ``scripts/autotune_blocks.py``), as JAX's plans from its TPU table: the
whole chain by ``policy.plan_chain``, else block by block by
``policy.best_impl``, else by the "tail" heuristic.  Without a table for
the card it is JAX's table-less plan.
"""

from __future__ import annotations

import torch

from .blocks import (
    block_weights,
    head_apply,
    plain_block_apply,
    stem_apply,
    upsample_smooth_apply,
)
from .flatblock_s2 import LANE, flat_s2_block_apply, round_up, s2_eligible
from .fused_block import MIN_FUSED_SIZE, block_apply, takes_kernel
from .kernels.flat_block import flat_block
from .policy import best_impl, block_key, plan_chain

# engine impl name -> chain mode, as ``engine._FLAT_MODE`` of the JAX package.
FLAT_MODE = {"flat": "tail", "flat-all": "all", "auto": "auto"}


def flat_block_apply(params, x, kernel_size: int, expand_ratio: int,
                     use_identity: bool = True, stats=None,
                     dtype=torch.bfloat16):
    """One stride-1 DepthWiseConv block through the ``flat_block`` kernel,
    folded-BN inference semantics (``flatblock.flat_block_apply``)."""
    c_in = x.shape[-1]
    expand = expand_ratio != 1
    w_exp, b_exp, w_dw, b_dw, w_proj, proj_bias = block_weights(
        params, expand, stats)
    y, _ = flat_block(x.to(dtype), w_exp, w_dw, params["SELayer_0"], w_proj,
                      kernel_size, pre_act=expand, b_expand=b_exp, b_dw=b_dw,
                      proj_bias=proj_bias,
                      identity=use_identity and c_in == w_proj.shape[-1])
    return y


def stride_ok(w: int, lane: int = LANE) -> bool:
    """The JAX width rule (``flatblock._stride_ok``): W rounded up to
    ``lane`` wastes at most 1/3 of the row."""
    ws = round_up(w, lane)
    return 3 * (ws - w) <= ws


def chain_rows(descs, lane: int = LANE) -> list[dict]:
    """``policy.plan_chain``'s block rows for a chain of
    ``encoder_descs``/``decoder_descs`` rows (``flatblock._plan_impls``'s)."""
    return [{
        "key": block_key(d["c_in"], d["c_out"], d.get("stride", 1), d["k"],
                         d["t"], d["h"], d["w"]),
        "flat_ok": stride_ok(d["w"], lane),
        "stride2": d.get("stride", 1) == 2,
        "force_nhwc": d.get("force_nhwc", False),
        "nhwc_out": d.get("nhwc_out", False),
        "est_bytes": 8 * d["c_in"] * d["h"] * d["w"] * 2,
    } for d in descs]


def plan_impls(descs, mode: str, lane: int = LANE, device=None) -> list[str]:
    """One impl per block ("flat" | "flat2" | "fused" | "xla") for a chain
    of ``encoder_descs``/``decoder_descs`` rows, in mode "tail", "all" or
    "auto" (``flatblock._plan_impls``); "auto" reads the table for
    ``device`` (``policy.load_policy``)."""
    if mode not in ("tail", "all", "auto"):
        raise ValueError(f"unknown flat chain mode {mode!r}")
    if mode == "auto":
        planned = plan_chain(chain_rows(descs, lane), device)
        if planned is not None:
            return planned

    def choose(d):
        if d.get("force_nhwc"):
            return "xla"
        if d.get("stride", 1) == 2:
            return "flat2" if mode == "all" or d["k"] == 5 else "xla"
        ok = stride_ok(d["w"], lane)
        if mode == "all":
            return "flat" if ok else "fused"
        if mode == "auto":  # ``flatblock._choose_impl``
            best = best_impl(d["c_in"], d["c_out"], 1, d["k"], d["t"],
                             d["h"], d["w"], device)
            if best is not None and (best != "flat" or ok):
                return best
        return "flat" if ok and d["k"] == 3 and d["c_in"] <= 24 else "fused"

    return [choose(d) for d in descs]


def upsample_after(shapes, i: int) -> bool:
    """The decoder's upsample rule: after blocks 2, 4 and 7."""
    return shapes[i][0] != shapes[i][1] and i + 6 < len(shapes)


def decoder_descs(decoder_conv_shapes, h: int, w: int) -> list[dict]:
    """Per-block rows of the decoder at input (h, w)."""
    shapes = decoder_conv_shapes
    descs = []
    for i, shape in enumerate(shapes[:-1]):
        descs.append(dict(c_in=shape[0], c_out=shape[1], k=shape[3],
                          t=shape[4], h=h, w=w))
        if upsample_after(shapes, i):
            h, w = h * 2, w * 2
    return descs


def encoder_block_kt(enc_conv_shapes, i: int, expand_ratio: int):
    """(stride, k, t) of encoder block i; the final block is built with
    kernel 3 and ``expand_ratio`` (reference models.py:154)."""
    _, _, stride, k, t = enc_conv_shapes[i]
    if i == len(enc_conv_shapes) - 1:
        k, t = 3, expand_ratio
    return stride, k, t


def halved(n: int, stride: int) -> int:
    """The size after a block of ``stride``: ``ceil(n / stride)``, what
    the plain stride-2 conv gives an odd size (the flat stride-2 kernel
    takes even sizes only).  JAX's planner divides by the stride, rounding
    down, so at an odd-sized stride-2 input behind another (345px: e4's
    173) it plans the stride-2 kernel on the odd map; the port plans what
    the engine runs.  At every multiple of 8 (720, 1024) both agree."""
    return -(-n // stride)


def mega_encoder_takes(stride: int, h: int, lane: int = LANE,
                       min_mega_size: int | None = None) -> bool:
    """Whether the "mega" encoder sends a block of input height ``h`` to
    ``mega_block`` (``megablock.encode_mega``): stride 1, at a height that
    is a multiple of ``lane`` and at least ``min_mega_size`` (``2 *
    lane`` unless given: JAX's 256 at the 128-pixel lane)."""
    if min_mega_size is None:
        min_mega_size = 2 * lane
    return stride == 1 and h % lane == 0 and h >= min_mega_size


def mega_decoder_starts(h: int, w: int, lane: int = LANE,
                        min_mega_w: int | None = None) -> bool:
    """Whether the "mega" decoder turns to ``mega_block`` at a block of
    input (h, w) (``megablock.decode_mega``; it stays there after): a
    width that is a multiple of ``min_mega_w`` (``lane`` unless given:
    JAX's 128) and a height of at least ``lane``."""
    if min_mega_w is None:
        min_mega_w = lane
    return w % min_mega_w == 0 and h >= lane


def encoder_descs(enc_conv_shapes, h: int, w: int, out_layers,
                  expand_ratio: int, lane: int = LANE) -> list[dict]:
    """Per-block rows of encoder blocks 1.. at post-stem resolution."""
    descs = []
    for i in range(1, len(enc_conv_shapes)):
        stride, k, t = encoder_block_kt(enc_conv_shapes, i, expand_ratio)
        row = enc_conv_shapes[i]
        descs.append(dict(
            c_in=row[0], c_out=row[1], k=k, t=t, h=h, w=w, stride=stride,
            force_nhwc=stride != 1 and not s2_eligible(h, w, lane),
            nhwc_out=i in out_layers,
        ))
        h, w = halved(h, stride), halved(w, stride)
    return descs


def planned_chains(cfg, size: int, enc_mode: str, dec_mode: str,
                   lane: int = LANE, device=None) -> dict:
    """The plan the engine executes at ``size`` for engine impl names, for
    a request on ``device`` (``flatblock.planned_chains``); "fused"/"mega"
    bypass the planner."""
    out = {}
    if enc_mode in FLAT_MODE:
        out["enc"] = plan_impls(
            encoder_descs(cfg.enc_conv_shapes, size, size, cfg.enc_out_layers,
                          cfg.expand_ratio, lane),
            FLAT_MODE[enc_mode], lane, device)
    else:
        out["enc"] = [enc_mode] * (len(cfg.enc_conv_shapes) - 1)
    if dec_mode in FLAT_MODE:
        out["dec"] = plan_impls(
            decoder_descs(cfg.decoder_conv_shapes, halved(size, 8),
                          halved(size, 8)),
            FLAT_MODE[dec_mode], lane, device)
    else:
        out["dec"] = [dec_mode] * (len(cfg.decoder_conv_shapes) - 1)
    return out


def planned_launches(cfg, size: int, enc_mode: str, dec_mode: str,
                     lane: int = LANE, min_fused_size: int = MIN_FUSED_SIZE,
                     device=None) -> dict:
    """{kernel: launches} of the block kernels in one ``stylize_fused`` call
    at ``size`` on any pair of engine routes: the encoder's and decoder's
    blocks as their routes send them and the ``ada_out`` block ("fused"
    takes ``expand_dw`` where ``block_apply`` does).  Flat routes count
    their planned blocks; "fused" sends every stride-1 block through
    ``block_apply``; "mega" sends the encoder's blocks that
    ``mega_encoder_takes`` to ``mega_block`` (the other stride-1 ones to
    ``block_apply``) and the decoder's from the first that
    ``mega_decoder_starts`` (the earlier ones to the plain route), as
    ``megablock.encode_mega`` and ``decode_mega`` do at the engine's
    thresholds.  The ``mega_block`` key is there when a chain is
    "mega"."""
    for mode in (enc_mode, dec_mode):
        if mode not in FLAT_MODE and mode not in ("fused", "mega"):
            raise ValueError(f"unknown route {mode!r}")
    plan = planned_chains(cfg, size, enc_mode, dec_mode, lane, device)
    enc = encoder_descs(cfg.enc_conv_shapes, size, size, cfg.enc_out_layers,
                        cfg.expand_ratio, lane)
    dec = decoder_descs(cfg.decoder_conv_shapes, halved(size, 8),
                        halved(size, 8))
    routed = []
    for d, impl in zip(enc, plan["enc"]):
        if impl == "mega":
            impl = ("mega" if mega_encoder_takes(d["stride"], d["h"], lane)
                    else "fused")
        routed.append((d, impl))
    mega_from_here = False
    for d, impl in zip(dec, plan["dec"]):
        if impl == "mega":
            mega_from_here = (mega_from_here
                              or mega_decoder_starts(d["h"], d["w"], lane))
            impl = "mega" if mega_from_here else "xla"
        routed.append((d, impl))
    routed.append((dict(t=cfg.expand_ratio, h=halved(size, 8)), "fused"))
    out = {"expand_dw": 0, "flat_block": 0, "flat_s2_block": 0}
    if "mega" in (enc_mode, dec_mode):
        out["mega_block"] = 0
    for d, impl in routed:
        if impl == "flat":
            out["flat_block"] += 1
        elif impl == "flat2":
            out["flat_s2_block"] += 1
        elif impl == "mega":
            out["mega_block"] += 1
        elif impl == "fused" and d.get("stride", 1) == 1:
            out["expand_dw"] += takes_kernel(d["t"], d["h"], min_fused_size)
    return out


def decode_flat(dec_params, z, decoder_conv_shapes, exporting: bool = True,
                dtype=torch.bfloat16, flat_blocks: str = "tail",
                lane: int = LANE, min_fused_size: int = MIN_FUSED_SIZE):
    """The decoder with the planned blocks through the ``flat_block``
    kernel (``flatblock.decode_flat``); "fused" blocks take
    ``fused_block.block_apply`` and upsamples the flax math."""
    shapes = decoder_conv_shapes
    impls = plan_impls(decoder_descs(shapes, z.shape[1], z.shape[2]),
                       flat_blocks, lane, z.device)
    x = z
    for i, shape in enumerate(shapes[:-1]):
        blk = dec_params[f"decoder_blocks_{i}"]
        k, t = shape[3], shape[4]
        if impls[i] == "flat":
            x = flat_block_apply(blk["DepthWiseConv_0"], x, k, t, dtype=dtype)
        elif impls[i] == "xla":
            x = plain_block_apply(blk["DepthWiseConv_0"], x, k, 1, t,
                                  dtype=dtype)
        else:
            x = block_apply(blk["DepthWiseConv_0"], x, k, t, dtype=dtype,
                            min_fused_size=min_fused_size)
        if upsample_after(shapes, i):
            x = upsample_smooth_apply(blk["DepthWiseConv_1"], x, dtype)
    return head_apply(dec_params["img_out"], x, exporting=exporting,
                      dtype=dtype)


def encode_flat(enc_params, enc_stats, x, enc_conv_shapes, out_layers,
                expand_ratio: int = 3, dtype=torch.bfloat16,
                flat_blocks: str = "tail", lane: int = LANE,
                min_fused_size: int = MIN_FUSED_SIZE):
    """The encoder with folded BatchNorm and the planned blocks through the
    ``flat_block`` and ``flat_s2_block`` kernels (``flatblock.encode_flat``);
    returns the feature maps at the ``out_layers`` block indices."""
    shapes = enc_conv_shapes
    h = stem_apply(enc_params["mob_net_0"]["Conv_0"], x, stride=shapes[0][2],
                   dtype=dtype)
    outs = [h] if 0 in out_layers else []
    impls = plan_impls(
        encoder_descs(shapes, h.shape[1], h.shape[2], out_layers,
                      expand_ratio, lane),
        flat_blocks, lane, h.device)
    for i in range(1, len(shapes)):
        stride, k, t = encoder_block_kt(shapes, i, expand_ratio)
        blk, st = enc_params[f"mob_net_{i}"], enc_stats[f"mob_net_{i}"]
        impl = impls[i - 1]
        if impl == "flat2":
            h = flat_s2_block_apply(blk, h, k, t, stats=st, dtype=dtype)
        elif stride != 1 or impl == "xla":
            h = plain_block_apply(blk, h, k, stride, t, stats=st, dtype=dtype)
        elif impl == "flat":
            h = flat_block_apply(blk, h, k, t, stats=st, dtype=dtype)
        else:
            h = block_apply(blk, h, k, t, stats=st, dtype=dtype,
                            min_fused_size=min_fused_size)
        if i in out_layers:
            outs.append(h)
    return outs
