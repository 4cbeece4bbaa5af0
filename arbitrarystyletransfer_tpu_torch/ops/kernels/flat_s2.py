"""Whole stride-2 block kernel: the port of ``flatblock_s2._flat_s2_kernel``.

Replaces ``arbitrarystyletransfer_tpu/ops/pallas/flatblock_s2.py:121``
``_flat_s2_kernel`` (host wrappers ``flat_s2_expand_dw_project`` and
``flat_s2_block_apply_f``): ``flat_block``'s math with a stride-2 depthwise
and no residual.  For x (N, H, W, C_in) with H and W even::

    ex     = round(hswish(x @ We + be))                       (input res.)
    hidden = round(hswish(dw_kxk_stride2(reflect_pad(ex), Wd) + bd))
    sums   = hidden.sum over H/2, W/2
    y      = round((hidden * round(gate(sums))) @ Wp [f32 acc] + pb)

The CUDA kernel is ``csrc/flat_s2.cu``: its first sweep expands each
output tile's input halo into shared memory (on the tensor cores: bf16, or
f32 as 3xTF32), so the input-resolution hidden never reaches device
memory, and its second sweep is ``flat_block``'s ``gate_project``.
``flat_s2_block_reference`` is the plain PyTorch twin.
"""

from __future__ import annotations

import torch

from . import LAUNCHES
from ._build import check, launch_stream, load_library
from .expand_dw import depthwise_reference, expand_reference, sums_buffers
from .limits import check_flat_s2, s2_sweep1_design
from .flat_block import (
    check_input,
    gate_project_reference,
    kernel_operands,
    ptr,
    round_to,
)


def flat_s2_block_reference(x, w_expand, w_dw, se_params, w_proj,
                            kernel_size: int, b_expand=None, b_dw=None,
                            proj_bias=None):
    """Plain PyTorch twin of the kernel; returns (y, sums)."""
    dt = x.dtype
    ex = round_to(expand_reference(x, w_expand, b_expand), dt)
    hidden = depthwise_reference(ex, w_dw, b_dw, kernel_size,
                                 stride=2).to(dt)
    sums = hidden.float().sum(dim=(1, 2))
    return gate_project_reference(hidden, sums, se_params, w_proj,
                                  proj_bias), sums


def flat_s2_block(x, w_expand, w_dw, se_params, w_proj, kernel_size: int,
                  b_expand=None, b_dw=None, proj_bias=None):
    """(y, sums) of one whole stride-2 inverted-residual block.

    Args as ``flat_block.flat_block`` with ``w_expand`` required (every
    stride-2 block of the model expands) and no residual; H and W must be
    even.  Returns y (N, H/2, W/2, C_out) in x's dtype and the SE sums
    (N, E) float32.

    A CPU tensor takes ``flat_s2_block_reference``; a CUDA tensor launches
    the kernel or raises.
    """
    if w_expand is None:
        raise ValueError("flat_s2_block: the stride-2 block always expands")
    if x.device.type == "cpu":
        return flat_s2_block_reference(x, w_expand, w_dw, se_params, w_proj,
                                       kernel_size, b_expand, b_dw,
                                       proj_bias)
    x = check_input("flat_s2_block", x, kernel_size, stride=2)
    n, h, w, c_in = x.shape
    ops, (e, s, c_out) = kernel_operands(
        x, w_expand, w_dw, se_params, w_proj, kernel_size, b_expand, b_dw,
        proj_bias, "flat_s2_block")
    design = s2_sweep1_design(x.dtype == torch.bfloat16, c_in,
                              x.data_ptr() % 16 == 0, kernel_size)
    if design != "core":
        check_flat_s2(kernel_size, c_in, f32=design == "tf32")
    ho, wo = h // 2, w // 2
    hidden = torch.empty((n, ho, wo, e), dtype=x.dtype, device=x.device)
    sums, part, tiles = sums_buffers(n, e, h, w, x.device, stride=2)
    gate = torch.empty((n, e), dtype=torch.float32, device=x.device)
    y = torch.empty((n, ho, wo, c_out), dtype=x.dtype, device=x.device)
    rc = load_library().flat_s2_launch(
        x.data_ptr(), *map(ptr, ops), hidden.data_ptr(), sums.data_ptr(),
        part.data_ptr(), gate.data_ptr(), y.data_ptr(), n, h, w, c_in, e, s,
        c_out, kernel_size, int(x.dtype == torch.bfloat16), tiles,
        launch_stream(x),
    )
    check(rc, "flat_s2_block")
    LAUNCHES["flat_s2_block"] += 1
    return y, sums
