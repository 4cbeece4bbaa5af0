"""Whole stride-1 block on the (N, H, C, W) layout: the port of
``megablock._mega_kernel_t``.

Replaces ``arbitrarystyletransfer_tpu/ops/pallas/megablock.py:117``
``_mega_kernel_t`` (host wrapper ``mega_expand_dw_project_t``), the block
kernel of the "mega" route.  x and y are (N, H, C, W), W contiguous::

    ex     = hswish(x @ We + be)               (f32, NOT rounded;
                                                 expand==1: x + be)
    hidden = round(hswish(dw_kxk(reflect_pad(ex), Wd) + bd))
    sums   = hidden.sum over H, W               (f32, of the rounded hidden)
    gate   = clip(relu((sums / HW) @ D0 + b0) @ D1 + b1, 0, 1)
    y      = round((hidden * round(gate)) @ Wp [f32 acc] + pb) (+ x)

where ``round`` casts to the I/O dtype.  These rounding points are neither
``_flat_kernel``'s (which rounds ``ex``) nor ``_fused_kernel``'s (which sums
the unrounded hidden).  The CUDA kernel is ``csrc/mega_block.cu``, two
launches: the expand + depthwise sweep reads x in its own layout (on the
tensor cores: bf16, or f32 as 3xTF32) and writes the hidden and its sums,
and ``gate_project`` takes the gate from the sums, projects and writes y
in (N, H, C_out, W); nothing transposes around it.
``mega_block_reference`` is its plain PyTorch twin.
"""

from __future__ import annotations

import torch

from . import LAUNCHES
from ._build import check, launch_stream, load_library
from .expand_dw import depthwise_reference, expand_reference, sums_buffers
from .limits import check_sweep1, sweep1_design
from .flat_block import (
    check_input,
    gate_project_reference,
    kernel_operands,
    ptr,
)


def mega_block_reference(xt, w_expand, w_dw, se_params, w_proj,
                         kernel_size: int, pre_act: bool = True,
                         b_expand=None, b_dw=None, proj_bias=None,
                         identity: bool = False):
    """Plain PyTorch twin of the kernel on (N, H, C, W) tensors (computed on
    an NHWC view); returns (y, sums)."""
    dt = xt.dtype
    x = xt.permute(0, 1, 3, 2)
    ex = expand_reference(x, w_expand, b_expand, pre_act)
    hidden = depthwise_reference(ex, w_dw, b_dw, kernel_size).to(dt)
    sums = hidden.float().sum(dim=(1, 2))
    y = gate_project_reference(hidden, sums, se_params, w_proj, proj_bias,
                               x if identity else None)
    return y.permute(0, 1, 3, 2).contiguous(), sums


def mega_block(xt, w_expand, w_dw, se_params, w_proj, kernel_size: int,
               pre_act: bool = True, b_expand=None, b_dw=None,
               proj_bias=None, identity: bool = False):
    """(y, sums) of one whole stride-1 inverted-residual block.

    Args:
      xt: (N, H, C_in, W), bfloat16 or float32.
      w_expand: (C_in, E) expand weights, or None for the expand==1 form
        (then E == C_in).
      w_dw: (k, k, E) depthwise weights; k is 3 or 5.
      se_params: the block's ``SELayer_0`` subtree.
      w_proj: (E, C_out) projection weights.
      pre_act: hardswish after the expand.
      b_expand, b_dw, proj_bias: optional float32 biases (folded BN).
      identity: add x to the output (C_in == C_out).

    Returns:
      y (N, H, C_out, W) in xt's dtype and the SE sums (N, E) float32.

    A CPU tensor takes ``mega_block_reference``; a CUDA tensor launches the
    kernel or raises.
    """
    if xt.device.type == "cpu":
        return mega_block_reference(xt, w_expand, w_dw, se_params, w_proj,
                                    kernel_size, pre_act, b_expand, b_dw,
                                    proj_bias, identity)
    x = check_input("mega_block", xt, kernel_size, spatial=(1, 3))
    n, h, c_in, w = x.shape
    ops, (e, s, c_out) = kernel_operands(
        x, w_expand, w_dw, se_params, w_proj, kernel_size, b_expand, b_dw,
        proj_bias, "mega_block", channel_dim=2)
    if identity and c_in != c_out:
        raise ValueError("mega_block: identity needs C_in == C_out")
    layout = "xt" if w % 8 == 0 else "xt_rows"
    design = sweep1_design(x.dtype == torch.bfloat16, c_in,
                           w_expand is not None, layout,
                           x.data_ptr() % 16 == 0, kernel_size)
    check_sweep1("mega_block", kernel_size, c_in, layout,
                 mma=design != "core", expand=w_expand is not None,
                 tf32=design == "tf32")
    hidden = torch.empty((n, h, w, e), dtype=x.dtype, device=x.device)
    sums, part, tiles = sums_buffers(n, e, h, w, x.device)
    gate = torch.empty((n, e), dtype=torch.float32, device=x.device)
    y = torch.empty((n, h, c_out, w), dtype=x.dtype, device=x.device)
    rc = load_library().mega_block_launch(
        x.data_ptr(), *map(ptr, ops), hidden.data_ptr(), sums.data_ptr(),
        part.data_ptr(), gate.data_ptr(), y.data_ptr(), n, h, w, c_in, e, s,
        c_out, kernel_size, int(pre_act), int(identity),
        int(x.dtype == torch.bfloat16), tiles,
        launch_stream(x),
    )
    check(rc, "mega_block")
    LAUNCHES["mega_block"] += 1
    return y, sums
