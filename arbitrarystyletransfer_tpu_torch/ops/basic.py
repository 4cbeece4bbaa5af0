"""Elementwise and small ops shared by the block routes (NHWC).

Twins of the helpers in ``arbitrarystyletransfer_tpu/ops/pallas/fused_block.py``
and ``ops/blocks.py``.  Convolutions go through ``F.conv2d`` on an NCHW view
of the NHWC tensor: that view is channels-last in memory, so cuDNN runs it
(the depthwise convs too) without a layout copy.  The pads therefore build
NHWC-contiguous tensors themselves: ``F.pad`` on the NCHW view would return
an NCHW-contiguous one, and the conv after it would copy it back.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def hardswish(x: torch.Tensor) -> torch.Tensor:
    """``x * relu6(x + 3) / 6``, written as the JAX package writes it."""
    return x * torch.clamp(x + 3.0, 0.0, 6.0) * (1.0 / 6.0)


def _pad_hw(x: torch.Tensor, pad: int, mode: str) -> torch.Tensor:
    """Pad H and W of an NHWC tensor into a new NHWC-contiguous one: the
    interior is copied once, then each border row (over the interior
    columns) and each border column (over all rows, so the corners follow)
    is copied from the padded tensor itself.  Only copies: equal to
    ``F.pad`` bit for bit, and differentiable."""
    if pad == 0:
        return x
    b, h, w, c = x.shape
    if mode == "reflect" and pad >= min(h, w):
        raise ValueError(f"reflect pad {pad} needs H and W above it, got "
                         f"{tuple(x.shape)}")
    out = x.new_empty((b, h + 2 * pad, w + 2 * pad, c))
    out[:, pad:pad + h, pad:pad + w] = x

    def source(i, n):
        """The padded index that border index ``i`` of an axis of length
        ``n`` (padded: ``n + 2 pad``) copies."""
        if i < pad:
            return 2 * pad - i if mode == "reflect" else pad
        return 2 * (pad + n - 1) - i if mode == "reflect" else pad + n - 1

    for i in [*range(pad), *range(pad + h, h + 2 * pad)]:
        out[:, i, pad:pad + w] = out[:, source(i, h), pad:pad + w]
    for j in [*range(pad), *range(pad + w, w + 2 * pad)]:
        out[:, :, j] = out[:, :, source(j, w)]
    return out


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
