"""Plain PyTorch block routes: what the JAX package leaves to XLA.

Twins of ``xla_block_apply``, ``upsample_smooth_apply`` and the stem and
head convs of ``arbitrarystyletransfer_tpu/ops/pallas/fused_block.py``.  They
keep the JAX rounding points: a matmul of ``dtype`` operands stands where JAX
writes ``preferred_element_type=float32``.  At float32 that is the same
arithmetic; at bfloat16 torch rounds the product to bfloat16 before a
following f32 bias add, one rounding JAX does not make.
"""

from __future__ import annotations

import torch

from .basic import (
    bn_fold,
    conv2d_nhwc,
    edge_pad,
    hardswish,
    reflect_pad,
    se_gate_from_mean,
)


def block_weights(params, expand: bool, stats=None):
    """A block's weights with BatchNorm running statistics folded in.

    Returns ``(w_exp, b_exp, w_dw, b_dw, w_proj, proj_bias)``: ``w_exp``
    (C_in, E) or None for expand==1, ``w_dw`` (k, k, E), ``w_proj`` (E,
    C_out); the biases are None without ``stats``."""
    w_dw = params["DepthwiseConv2D_0"]["kernel"][:, :, 0, :]
    if expand:
        w_exp = params["Conv_0"]["kernel"][0, 0]
        w_proj = params["Conv_1"]["kernel"][0, 0]
        bn_exp, bn_dw, bn_proj = ("BatchNorm2D_0", "BatchNorm2D_1",
                                  "BatchNorm2D_2")
    else:
        w_exp = None
        w_proj = params["Conv_0"]["kernel"][0, 0]
        bn_exp, bn_dw, bn_proj = None, "BatchNorm2D_0", "BatchNorm2D_1"
    b_exp = b_dw = proj_bias = None
    if stats is not None:
        if expand:
            a, b_exp = bn_fold(params[bn_exp], stats[bn_exp])
            w_exp = w_exp * a[None, :]
        a, b_dw = bn_fold(params[bn_dw], stats[bn_dw])
        w_dw = w_dw * a[None, None, :]
        a, proj_bias = bn_fold(params[bn_proj], stats[bn_proj])
        w_proj = w_proj * a[None, :]
    return w_exp, b_exp, w_dw, b_dw, w_proj, proj_bias


def plain_block_apply(params, x, kernel_size: int, stride: int,
                      expand_ratio: int, use_identity: bool = True,
                      stats=None, dtype=torch.bfloat16):
    """One DepthWiseConv block with folded BN, in plain PyTorch
    (``fused_block.xla_block_apply``): the route for stride-2 blocks,
    blocks below ``MIN_FUSED_SIZE`` and expand==1 blocks."""
    pad = (kernel_size - 1) // 2
    c_in = x.shape[-1]
    x = x.to(dtype)
    expand = expand_ratio != 1
    w_exp, b_exp, w_dw, b_dw, w_proj, proj_bias = block_weights(
        params, expand, stats)

    if expand:
        hid = torch.matmul(x, w_exp.to(dtype)).float()
        if b_exp is not None:
            hid = hid + b_exp
        # Rounded to dtype before the depthwise, as XLA's route does.
        hid = hardswish(hid).to(dtype)
    else:
        hid = x
    out = conv2d_nhwc(reflect_pad(hid, pad), w_dw[:, :, None, :].to(dtype),
                      stride=stride, groups=w_dw.shape[-1])
    if b_dw is not None:
        out = out + b_dw
    out = hardswish(out.float()).to(dtype)
    gate = se_gate_from_mean(out.float().mean(dim=(1, 2)),
                             params["SELayer_0"])
    gated = out * gate[:, None, None, :].to(dtype)
    y = torch.matmul(gated, w_proj.to(dtype))
    if proj_bias is not None:
        y = y.float() + proj_bias
    y = y.to(dtype)
    if use_identity and stride == 1 and c_in == w_proj.shape[-1]:
        y = y + x
    return y


def _fold_taps(wk: torch.Tensor):
    """3-tap kernel along axis 0 -> the two 2-tap phase kernels of a 3x3
    conv over a nearest-x2 upsampled map (``upsample_smooth_apply``)."""
    return {
        0: torch.stack([wk[0], wk[1] + wk[2]]),
        1: torch.stack([wk[0] + wk[1], wk[2]]),
    }


def upsample_smooth_apply(params, x, dtype=torch.bfloat16):
    """Nearest-x2 upsample + the 3x3 expand==1 smoothing block, folded into
    four 2x2 phase convs at the low resolution with edge padding.

    The design of ``fused_block.upsample_smooth_apply``, with the flax
    decoder's math: the JAX twin folds the kernel's row axis twice (a
    clamped index), which ROADMAP queue 3 records."""
    b, h, w, c = x.shape
    x = x.to(dtype)
    w_dw = params["DepthwiseConv2D_0"]["kernel"][:, :, 0, :]  # (3, 3, C)
    w_proj = params["Conv_0"]["kernel"][0, 0]

    xe = edge_pad(x, 1)
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
                    term = xe[:, a + u:a + u + h, bb + v:bb + v + w, :] * wab[u, v]
                    acc = term if acc is None else acc + term
            ph = hardswish(acc.float())
            sums = sums + ph.sum(dim=(1, 2))
            phases[(a, bb)] = ph.to(dtype)

    gate = se_gate_from_mean(sums / (4.0 * h * w), params["SELayer_0"])
    gate = gate[:, None, None, :].to(dtype)
    wp = w_proj.to(dtype)
    outs = {key: torch.matmul(ph * gate, wp).to(dtype) + x
            for key, ph in phases.items()}
    rows0 = torch.stack([outs[(0, 0)], outs[(0, 1)]], dim=3)  # (b,h,w,2,c)
    rows1 = torch.stack([outs[(1, 0)], outs[(1, 1)]], dim=3)
    full = torch.stack([rows0, rows1], dim=2)  # (b, h, 2, w, 2, c)
    return full.reshape(b, 2 * h, 2 * w, c)


def stem_apply(stem_params, x, stride: int = 1, dtype=torch.bfloat16):
    """Encoder stem: reflect pad, 3x3 conv (no bias, no BN), hardswish."""
    h = conv2d_nhwc(reflect_pad(x.to(dtype), 1),
                    stem_params["kernel"].to(dtype), stride=stride)
    return hardswish(h.float()).to(dtype)


def head_apply(head_params, x, exporting: bool = True, dtype=torch.bfloat16):
    """Decoder head: reflect pad, 3x3 conv plus bias, float32 output,
    clamped to [0, 1] when exporting."""
    y = conv2d_nhwc(reflect_pad(x.to(dtype), 1),
                    head_params["kernel"].to(dtype))
    y = (y + head_params["bias"]).float()
    if exporting:
        y = torch.clamp(y, 0.0, 1.0)
    return y
