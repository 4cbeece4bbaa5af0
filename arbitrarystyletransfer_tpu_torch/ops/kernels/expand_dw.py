"""Fused expand + depthwise kernel: the port of ``_fused_kernel`` "hidden".

Replaces ``arbitrarystyletransfer_tpu/ops/pallas/fused_block.py:68``
``_fused_kernel`` in mode "hidden" (host wrapper ``fused_expand_dw``)::

    hidden = hswish(dw_kxk(reflect_pad(hswish(x @ We + be))) + bd)
    sums   = hidden.sum over H, W          (f32, before rounding)

The CUDA kernel is ``csrc/expand_dw.cu``; ``expand_dw_reference`` is its
plain PyTorch twin with the same rounding points: the expand accumulates in
f32, the depthwise runs in f32 on the unrounded expanded values, and only
the stored hidden is rounded to the input dtype.  Unlike the TPU kernel, the
hidden has exactly E channels (no padding to 128 lanes).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import LAUNCHES
from ._build import check, launch_stream, load_library
from .limits import check_sweep1_design
from ..basic import hardswish, reflect_pad


def expand_reference(x, w_expand, b_expand=None, pre_act: bool = True):
    """The 1x1 expand (identity for ``w_expand=None``), its bias and
    hardswish, in f32 over x's dtype-rounded weights."""
    h = x.float()
    if w_expand is not None:
        h = h @ w_expand.to(x.dtype).float()
    if b_expand is not None:
        h = h + b_expand.float()
    return hardswish(h) if pre_act else h


def depthwise_reference(h, w_dw, b_dw, kernel_size: int, stride: int = 1):
    """``hardswish(dw_kxk(reflect_pad(h)) + b_dw)`` in f32 (NHWC)."""
    pad = (kernel_size - 1) // 2
    hp = reflect_pad(h, pad).permute(0, 3, 1, 2)
    w = w_dw.float().permute(2, 0, 1)[:, None]  # (E, 1, k, k)
    out = F.conv2d(hp, w, stride=stride, groups=w.shape[0])
    out = out.permute(0, 2, 3, 1)
    if b_dw is not None:
        out = out + b_dw.float()
    return hardswish(out)


def expand_dw_reference(x, w_expand, w_dw, kernel_size: int,
                        pre_act: bool = True, b_expand=None, b_dw=None):
    """Plain PyTorch twin of the kernel (NHWC in, NHWC hidden out)."""
    out = depthwise_reference(expand_reference(x, w_expand, b_expand, pre_act),
                              w_dw, b_dw, kernel_size)
    return out.to(x.dtype), out.sum(dim=(1, 2))


def _vec(t, e, device, name):
    if t is None:
        return None
    if (t.shape != (e,) or t.dtype != torch.float32 or t.device != device
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous float32 ({e},) "
                         f"tensor on {device}")
    return t


def expand_dw(x, w_expand, w_dw, kernel_size: int, pre_act: bool = True,
              b_expand=None, b_dw=None):
    """(hidden, sums) of one stride-1 block's expand + depthwise stage.

    Args:
      x: (N, H, W, C_in) NHWC, bfloat16 or float32.
      w_expand: (C_in, E) expand weights, or None for the expand==1 form
        (then E == C_in).
      w_dw: (k, k, E) depthwise weights; k is 3 or 5.
      pre_act: hardswish between the expand and the depthwise.
      b_expand, b_dw: optional (E,) float32 biases (folded BatchNorm).

    Returns:
      hidden (N, H, W, E) in x's dtype and sums (N, E) float32.

    A CPU tensor takes ``expand_dw_reference``; a CUDA tensor launches the
    kernel or raises.
    """
    if x.device.type == "cpu":
        return expand_dw_reference(x, w_expand, w_dw, kernel_size, pre_act,
                                   b_expand, b_dw)
    if x.device.type != "cuda":
        raise ValueError(f"expand_dw: unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32) or x.dim() != 4:
        raise ValueError("expand_dw: x must be a 4-D bfloat16/float32 tensor")
    n, h, w, c_in = x.shape
    k = kernel_size
    e = w_dw.shape[-1]
    if k not in (3, 5) or w_dw.shape != (k, k, e):
        raise ValueError(f"expand_dw: w_dw must be (k, k, E) with k in "
                         f"(3, 5), got {tuple(w_dw.shape)}")
    if min(h, w) <= (k - 1) // 2:
        raise ValueError("expand_dw: reflect padding needs H, W > k // 2")
    x = x.contiguous()
    w_dw = w_dw.to(torch.float32).contiguous()
    if w_expand is not None:
        if w_expand.shape != (c_in, e):
            raise ValueError(f"expand_dw: w_expand must be ({c_in}, {e})")
        w_expand = w_expand.to(x.dtype).contiguous()
    elif e != c_in:
        raise ValueError("expand_dw: expand==1 form needs E == C_in")
    for t in (w_dw, w_expand):
        if t is not None and t.device != x.device:
            raise ValueError("expand_dw: weights must be on x's device")
    b_expand = _vec(b_expand, e, x.device, "b_expand")
    b_dw = _vec(b_dw, e, x.device, "b_dw")
    check_sweep1_design("expand_dw", k, c_in, x.dtype == torch.bfloat16,
                        w_expand is not None, x.data_ptr() % 16 == 0)

    hidden = torch.empty((n, h, w, e), dtype=x.dtype, device=x.device)
    sums = torch.zeros((n, e), dtype=torch.float32, device=x.device)
    lib = load_library()
    rc = lib.expand_dw_launch(
        x.data_ptr(),
        None if w_expand is None else w_expand.data_ptr(),
        w_dw.data_ptr(),
        None if b_expand is None else b_expand.data_ptr(),
        None if b_dw is None else b_dw.data_ptr(),
        hidden.data_ptr(), sums.data_ptr(),
        n, h, w, c_in, e, k, int(pre_act), int(x.dtype == torch.bfloat16),
        launch_stream(x),
    )
    check(rc, "expand_dw")
    LAUNCHES["expand_dw"] += 1
    return hidden, sums


def expand_dw_last_boxes() -> int:
    """The x boxes per halo of the last ``expand_dw`` launch: 1 the whole
    TMA box (or plain loads), C_in16 / 64 its channel chunks (C_in 256 at
    k3: 4), or at f32 the 3xTF32 design's chunks (``limits.tf32_chunk``),
    -1 before any launch."""
    return load_library().expand_dw_last_boxes()
