"""Elementwise and small ops shared by the block routes (NHWC).

Twins of the helpers in ``arbitrarystyletransfer_tpu/ops/pallas/fused_block.py``
and ``ops/blocks.py``.  Convolutions go through ``F.conv2d`` on an NCHW view
of the NHWC tensor: that view is channels-last in memory, so cuDNN runs it
without a layout copy.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def hardswish(x: torch.Tensor) -> torch.Tensor:
    """``x * relu6(x + 3) / 6``, written as the JAX package writes it."""
    return x * torch.clamp(x + 3.0, 0.0, 6.0) * (1.0 / 6.0)


def _pad_hw(x: torch.Tensor, pad: int, mode: str) -> torch.Tensor:
    if pad == 0:
        return x
    xc = F.pad(x.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode=mode)
    return xc.permute(0, 2, 3, 1)


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflection-pad the spatial dims of an NHWC tensor."""
    return _pad_hw(x, pad, "reflect")


def edge_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Edge-pad (replicate) the spatial dims of an NHWC tensor."""
    return _pad_hw(x, pad, "replicate")


def hwio_to_oihw(w: torch.Tensor) -> torch.Tensor:
    """Flax conv kernel (kh, kw, in, out) -> torch (out, in, kh, kw).

    A depthwise kernel (k, k, 1, C) becomes (C, 1, k, k), the grouped
    layout ``F.conv2d(..., groups=C)`` takes."""
    return w.permute(3, 2, 0, 1)


def conv2d_nhwc(x: torch.Tensor, w_hwio: torch.Tensor, stride: int = 1,
                groups: int = 1) -> torch.Tensor:
    """VALID conv of a pre-padded NHWC tensor with a flax HWIO kernel."""
    y = F.conv2d(x.permute(0, 3, 1, 2), hwio_to_oihw(w_hwio),
                 stride=stride, groups=groups)
    return y.permute(0, 2, 3, 1)


def bn_fold(bn_params, bn_stats, eps: float = 1e-5):
    """(scale, bias) folding BatchNorm running statistics into the
    preceding conv: ``BN(y) = y * a + c`` with ``a = gamma / sqrt(var + eps)``
    and ``c = beta - mean * a``."""
    a = bn_params["scale"] * torch.rsqrt(bn_stats["var"] + eps)
    c = bn_params["bias"] - bn_stats["mean"] * a
    return a, c


def se_gate_from_mean(mean: torch.Tensor, se_params) -> torch.Tensor:
    """SE gate from the per-channel spatial mean (B, C): Linear, ReLU,
    Linear, then Hardtanh(0, 1)."""
    d0, d1 = se_params["Dense_0"], se_params["Dense_1"]
    y = torch.relu(mean @ d0["kernel"] + d0["bias"])
    return torch.clamp(y @ d1["kernel"] + d1["bias"], 0.0, 1.0)


def se_gate(sums: torch.Tensor, n_pixels: int, se_params) -> torch.Tensor:
    """SE gate from exact per-channel spatial sums (B, C) over ``n_pixels``
    pixels (``fused_block._se_gate``)."""
    return se_gate_from_mean(sums / n_pixels, se_params)
