"""Block modules of the model graph, and the plain block routes.

The ``nn.Module``s (``DepthwiseConv2D``, ``ConvStem``, ``SELayer``,
``DepthWiseConv``) are the twins of the flax blocks in
``arbitrarystyletransfer_tpu/ops/blocks.py``: the trainable graph, with the
JAX tree's child names (``Conv_0``, ``DepthwiseConv2D_0``, ``SELayer_0``,
``BatchNorm2D_0``, ...) and layouts (HWIO kernels, dense (in, out)), so
``weights.load_state`` moves a weights.py state into them one to one.

The functions are the engine's plain routes, twins of ``xla_block_apply``,
``upsample_smooth_apply`` and the stem and head convs of
``arbitrarystyletransfer_tpu/ops/pallas/fused_block.py``.  They keep the JAX
rounding points: a matmul of ``dtype`` operands stands where JAX writes
``preferred_element_type=float32``.  At float32 that is the same arithmetic;
at bfloat16 torch rounds the product to bfloat16 before a following f32 bias
add, one rounding JAX does not make.
"""

from __future__ import annotations

import torch
from torch import nn

from .basic import (
    bn_fold,
    conv2d_nhwc,
    edge_pad,
    hardswish,
    reflect_pad,
    se_gate_from_mean,
)
from .norm import BatchNorm2D


def make_divisible(v: float, divisor: int) -> int:
    """Round a channel count to a multiple of ``divisor`` (at least
    ``divisor``, and not below 90% of ``v``)."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def _compute_dtype(dtype, *tensors):
    """``dtype``, or the promoted dtype of ``tensors`` when it is None
    (flax's promotion with ``dtype=None``)."""
    if dtype is not None:
        return dtype
    out = tensors[0].dtype
    for t in tensors[1:]:
        out = torch.promote_types(out, t.dtype)
    return out


class Conv(nn.Module):
    """A VALID NHWC conv with a flax HWIO ``kernel`` (and ``bias``)."""

    def __init__(self, c_in: int, c_out: int, k: int, stride: int = 1,
                 use_bias: bool = False, dtype=None):
        super().__init__()
        self.stride, self.dtype = stride, dtype
        self.kernel = nn.Parameter(torch.zeros(k, k, c_in, c_out))
        self.bias = nn.Parameter(torch.zeros(c_out)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(self.dtype, x, self.kernel)
        y = conv2d_nhwc(x.to(dt), self.kernel.to(dt), stride=self.stride)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y


class Dense(nn.Module):
    """``x @ kernel + bias`` with a flax (in, out) ``kernel``."""

    def __init__(self, c_in: int, c_out: int, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.zeros(c_in, c_out))
        self.bias = nn.Parameter(torch.zeros(c_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(self.dtype, x, self.kernel)
        return x.to(dt) @ self.kernel.to(dt) + self.bias.to(dt)


class DepthwiseConv2D(nn.Module):
    """Depthwise k x k conv over a pre-padded NHWC input, kernel (k, k, 1,
    C): one grouped ``F.conv2d``.  The JAX module's ``impl`` ("conv" or
    "shifts") is an XLA lowering choice; ``ModelConfig.depthwise_impl``
    accepts it and nothing reads it."""

    def __init__(self, ch: int, kernel_size: int, stride: int = 1,
                 dtype=None):
        super().__init__()
        self.ch, self.stride, self.dtype = ch, stride, dtype
        self.kernel = nn.Parameter(
            torch.zeros(kernel_size, kernel_size, 1, ch))

    def forward(self, xp: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(self.dtype, xp)
        return conv2d_nhwc(xp.to(dt), self.kernel.to(dt), stride=self.stride,
                           groups=self.ch)


class ConvStem(nn.Module):
    """Reflect-padded 3x3 conv (no bias, no norm), then hardswish."""

    def __init__(self, c_in: int, c_out: int, stride: int = 1, dtype=None):
        super().__init__()
        self.Conv_0 = Conv(c_in, c_out, 3, stride=stride, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return hardswish(self.Conv_0(reflect_pad(x, 1)))


class SELayer(nn.Module):
    """Squeeze-and-excitation with a Hardtanh(0, 1) gate; the squeeze mean
    is taken in f32."""

    def __init__(self, channel: int, reduction: int = 4, dtype=None):
        super().__init__()
        hidden = make_divisible(channel // reduction, 8)
        self.Dense_0 = Dense(channel, hidden, dtype=dtype)
        self.Dense_1 = Dense(hidden, channel, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.float().mean(dim=(1, 2)).to(x.dtype)
        y = torch.clamp(self.Dense_1(torch.relu(self.Dense_0(y))), 0.0, 1.0)
        return x * y[:, None, None, :]


class DepthWiseConv(nn.Module):
    """The inverted-residual block with SE (flax ``DepthWiseConv``).

    expand_ratio == 1: reflect pad -> depthwise -> [BN] -> hardswish -> SE
    -> 1x1 project -> [BN]; expand_ratio > 1: 1x1 expand -> [BN] ->
    hardswish -> reflect-padded depthwise (stride s) -> [BN] -> hardswish ->
    SE -> 1x1 project -> [BN].  Residual iff stride 1, C_in == C_out and
    ``use_identity``.  ``train`` gates the running updates and
    ``use_batch_stats`` (default ``train``) picks the BN normalizer; both
    reach every BatchNorm of the block."""

    def __init__(self, c_in: int, c_out: int, stride: int = 1,
                 expand_ratio: float = 1, kernel_size: int = 3,
                 use_norm: bool = False, use_identity: bool = True,
                 dtype=None):
        super().__init__()
        hidden = round(c_in * expand_ratio)
        self.expand = expand_ratio != 1
        self.pad = (kernel_size - 1) // 2
        self.identity = stride == 1 and c_in == c_out and use_identity
        self.use_norm = use_norm
        dw = DepthwiseConv2D(hidden, kernel_size, stride, dtype=dtype)
        se = SELayer(hidden, dtype=dtype)
        if self.expand:
            self.Conv_0 = Conv(c_in, hidden, 1, dtype=dtype)
            self.DepthwiseConv2D_0 = dw
            self.SELayer_0 = se
            self.Conv_1 = Conv(hidden, c_out, 1, dtype=dtype)
            widths = (hidden, hidden, c_out)
        else:
            self.DepthwiseConv2D_0 = dw
            self.SELayer_0 = se
            self.Conv_0 = Conv(hidden, c_out, 1, dtype=dtype)
            widths = (hidden, c_out)
        if use_norm:
            for i, ch in enumerate(widths):
                self.add_module(f"BatchNorm2D_{i}", BatchNorm2D(ch))

    def forward(self, x: torch.Tensor, train: bool = True,
                use_batch_stats: bool | None = None) -> torch.Tensor:
        ubs = train if use_batch_stats is None else use_batch_stats
        bn_i = iter(range(3))

        def bn(h):
            if not self.use_norm:
                return h
            return getattr(self, f"BatchNorm2D_{next(bn_i)}")(
                h, use_batch_stats=ubs, update_stats=train)

        org_x = x
        if self.expand:
            x = hardswish(bn(self.Conv_0(x)))
            x = self.DepthwiseConv2D_0(reflect_pad(x, self.pad))
            x = hardswish(bn(x))
            x = bn(self.Conv_1(self.SELayer_0(x)))
        else:
            x = self.DepthwiseConv2D_0(reflect_pad(x, self.pad))
            x = hardswish(bn(x))
            x = bn(self.Conv_0(self.SELayer_0(x)))
        if self.identity:
            x = x + org_x.to(x.dtype)
        return x


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
