"""The "mega" block route on the (B, H, C, W) layout: the twin of the host
half of ``arbitrarystyletransfer_tpu/ops/pallas/megablock.py``.

``mega_block_apply_t`` runs a whole stride-1 block through the
``mega_block`` kernel on a (B, H, C, W) activation, W contiguous.  The
chains keep the JAX routing and its layout: ``encode_mega`` transposes to
(B, H, C, W) before each run of eligible blocks (e1, e3 at 512px) and back
after it; ``decode_mega`` transposes once, at the first resolution whose
width is a multiple of ``min_mega_w``, stays transposed through the blocks
and the upsample+smooth blocks, and transposes back for the head.

The TPU kernel's VMEM knobs (``row_group``, ``force_resident``,
``chunk_e``) and its HBM row and channel padding are DMA and VMEM machinery
and have no counterpart here.  ``upsample_smooth_apply_t`` computes the
flax graph's upsample + smoothing, as ``ops/blocks.upsample_smooth_apply``
does, not the JAX twin's folded one (ROADMAP queue 3).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .basic import hardswish, se_gate_from_mean
from .blocks import (
    _fold_taps,
    block_weights,
    head_apply,
    plain_block_apply,
    stem_apply,
    upsample_smooth_apply,
)
from .flatblock import (
    encoder_block_kt,
    mega_decoder_starts,
    mega_encoder_takes,
    upsample_after,
)
from .flatblock_s2 import LANE
from .fused_block import MIN_FUSED_SIZE, block_apply
from .kernels.mega_block import mega_block


def to_t(x):
    """NHWC -> (B, H, C, W), contiguous."""
    return x.permute(0, 1, 3, 2).contiguous()


def from_t(xt):
    """(B, H, C, W) -> NHWC, contiguous."""
    return xt.permute(0, 1, 3, 2).contiguous()


def mega_expand_dw_project_t(xt, w_expand, w_dw, se_params, w_proj,
                             kernel_size: int, pre_act: bool = True,
                             b_expand=None, b_dw=None, proj_bias=None,
                             identity: bool = False):
    """The whole block (expand -> dw -> SE -> project [+ id]) on a
    (B, H, C_in, W) activation; returns (B, H, C_out, W).  Arguments as
    ``kernels.mega_block.mega_block``'s."""
    y, _ = mega_block(xt, w_expand, w_dw, se_params, w_proj, kernel_size,
                      pre_act=pre_act, b_expand=b_expand, b_dw=b_dw,
                      proj_bias=proj_bias, identity=identity)
    return y


def mega_block_apply_t(params, xt, kernel_size: int, expand_ratio: int,
                       use_identity: bool = True, stats=None):
    """One stride-1 DepthWiseConv block on a (B, H, C, W) activation, in its
    dtype, with folded-BN inference semantics."""
    expand = expand_ratio != 1
    w_exp, b_exp, w_dw, b_dw, w_proj, proj_bias = block_weights(
        params, expand, stats)
    return mega_expand_dw_project_t(
        xt, w_exp, w_dw, params["SELayer_0"], w_proj, kernel_size,
        pre_act=expand, b_expand=b_exp, b_dw=b_dw, proj_bias=proj_bias,
        identity=use_identity and xt.shape[2] == w_proj.shape[-1])


def mega_block_apply(params, x, kernel_size: int, expand_ratio: int,
                     use_identity: bool = True, stats=None,
                     dtype=torch.bfloat16):
    """NHWC wrapper: transpose, ``mega_block_apply_t``, transpose back."""
    yt = mega_block_apply_t(params, to_t(x.to(dtype)), kernel_size,
                            expand_ratio, use_identity=use_identity,
                            stats=stats)
    return from_t(yt)


def upsample_smooth_apply_t(params, xt, dtype=torch.bfloat16):
    """``ops/blocks.upsample_smooth_apply`` on a (B, H, C, W) activation:
    nearest-x2 upsample + the 3x3 expand==1 smoothing block, folded into
    four 2x2 phase convs at the low resolution; returns (B, 2H, C, 2W)."""
    b, h, c, w = xt.shape
    xt = xt.to(dtype)
    w_dw = params["DepthwiseConv2D_0"]["kernel"][:, :, 0, :]  # (3, 3, C)
    w_proj = params["Conv_0"]["kernel"][0, 0]

    # Edge-pad H and W on a (B, C, H, W) view.
    xe = F.pad(xt.permute(0, 2, 1, 3), (1, 1, 1, 1), mode="replicate")
    xe = xe.permute(0, 2, 1, 3)  # (B, H + 2, C, W + 2)
    row_f = _fold_taps(w_dw)
    phases = {}
    sums = 0.0
    for a in (0, 1):
        col_f = _fold_taps(row_f[a].transpose(0, 1))  # over dj: (2, 2, C)
        for bb in (0, 1):
            wab = col_f[bb].transpose(0, 1).to(dtype)  # [u, v, C]
            acc = None
            for u in (0, 1):
                for v in (0, 1):
                    term = (xe[:, a + u:a + u + h, :, bb + v:bb + v + w]
                            * wab[u, v][:, None])
                    acc = term if acc is None else acc + term
            ph = hardswish(acc.float())
            sums = sums + ph.sum(dim=(1, 3))
            phases[(a, bb)] = ph.to(dtype)

    gate = se_gate_from_mean(sums / (4.0 * h * w), params["SELayer_0"])
    gate = gate[:, None, :, None].to(dtype)
    wpt = w_proj.to(dtype).t()  # (C_out, C)
    outs = {key: torch.matmul(wpt, ph * gate).to(dtype) + xt
            for key, ph in phases.items()}
    cols0 = torch.stack([outs[(0, 0)], outs[(0, 1)]], dim=4)  # (b,h,c,w,2)
    cols1 = torch.stack([outs[(1, 0)], outs[(1, 1)]], dim=4)
    full = torch.stack([cols0.reshape(b, h, c, 2 * w),
                        cols1.reshape(b, h, c, 2 * w)], dim=2)
    return full.reshape(b, 2 * h, c, 2 * w)


def encode_mega(enc_params, enc_stats, x, enc_conv_shapes, out_layers,
                expand_ratio: int = 3, dtype=torch.bfloat16,
                min_mega_size: int | None = None, lane: int = LANE,
                min_fused_size: int = MIN_FUSED_SIZE):
    """The encoder with folded BatchNorm, its stride-1 blocks at a height
    that is a multiple of ``lane`` and at least ``min_mega_size`` (``2 *
    lane`` unless given: JAX's default 256, megablock.py:660) through the
    ``mega_block`` kernel (``megablock.encode_mega``,
    ``flatblock.mega_encoder_takes``); the other stride-1 blocks take
    ``block_apply``, the stride-2 blocks the plain route.
    Returns the feature maps (NHWC) at the ``out_layers`` block indices."""
    shapes = enc_conv_shapes
    h = stem_apply(enc_params["mob_net_0"]["Conv_0"], x, stride=shapes[0][2],
                   dtype=dtype)
    outs = [h] if 0 in out_layers else []
    ht = None  # the (B, H, C, W) form, valid when h is None
    for i in range(1, len(shapes)):
        stride, k, t = encoder_block_kt(shapes, i, expand_ratio)
        blk, st = enc_params[f"mob_net_{i}"], enc_stats[f"mob_net_{i}"]
        size = (h if h is not None else ht).shape[1]
        if mega_encoder_takes(stride, size, lane, min_mega_size):
            if ht is None:
                ht, h = to_t(h.to(dtype)), None
            ht = mega_block_apply_t(blk, ht, k, t, stats=st)
        else:
            if h is None:
                h, ht = from_t(ht), None
            if stride == 1:
                h = block_apply(blk, h, k, t, stats=st, dtype=dtype,
                                min_fused_size=min_fused_size)
            else:
                h = plain_block_apply(blk, h, k, stride, t, stats=st,
                                      dtype=dtype)
        if i in out_layers:
            outs.append(h if h is not None else from_t(ht))
    return outs


def decode_mega(dec_params, z, decoder_conv_shapes, exporting: bool = True,
                dtype=torch.bfloat16, min_mega_w: int | None = None,
                lane: int = LANE):
    """The decoder (``megablock.decode_mega``): plain blocks and
    upsample+smooth blocks (NHWC) until the first block whose input width is
    a multiple of ``min_mega_w`` (``lane`` unless given: JAX's default 128,
    megablock.py:738) and height at least ``lane``
    (``flatblock.mega_decoder_starts``); from there
    every block through the ``mega_block`` kernel and every upsample+smooth
    block on (B, H, C, W); then the head (clamped when ``exporting``)."""
    shapes = decoder_conv_shapes
    x, xt = z, None
    for i, shape in enumerate(shapes[:-1]):
        blk = dec_params[f"decoder_blocks_{i}"]
        k, t = shape[3], shape[4]
        if xt is None and mega_decoder_starts(x.shape[1], x.shape[2], lane,
                                              min_mega_w):
            xt, x = to_t(x.to(dtype)), None
        if xt is not None:
            xt = mega_block_apply_t(blk["DepthWiseConv_0"], xt, k, t)
            if upsample_after(shapes, i):
                xt = upsample_smooth_apply_t(blk["DepthWiseConv_1"], xt,
                                             dtype)
        else:
            x = plain_block_apply(blk["DepthWiseConv_0"], x, k, 1, t,
                                  dtype=dtype)
            if upsample_after(shapes, i):
                x = upsample_smooth_apply(blk["DepthWiseConv_1"], x, dtype)
    if xt is not None:
        x = from_t(xt)
    return head_apply(dec_params["img_out"], x, exporting=exporting,
                      dtype=dtype)
