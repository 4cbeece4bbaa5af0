"""The two-pass block kernels: the port of ``_fused_kernel`` "sums" and
"project".

Replace ``arbitrarystyletransfer_tpu/ops/pallas/fused_block.py:68``
``_fused_kernel`` in modes "sums" (``pallas_call`` ``:353``) and "project"
(``:335``), host wrapper ``fused_block_apply_2pass`` (``:489``).  For NHWC
x, with ``out = hswish(dw_kxk(reflect_pad(hswish(x @ We + be))) + bd)`` in
f32::

    fused_sums:    sums = out.sum over H, W       (f32, of the UNROUNDED out)
    fused_project: y    = round(round(round(out) * round(gate)) @ Wp
                                [f32 acc])  (+ x)

where ``round`` casts to the I/O dtype.  ``fused_project`` recomputes the
expand and the depthwise, so the hidden never reaches HBM.  The CUDA kernels
are in ``csrc/fused_2pass.cu``; ``fused_sums_reference`` and
``fused_project_reference`` are their plain PyTorch twins.
"""

from __future__ import annotations

import torch

from . import LAUNCHES
from ._build import check, launch_stream, load_library
from .expand_dw import _vec, depthwise_reference, expand_reference
from .flat_block import check_input, ptr, round_to
from .limits import (check_fused_project, check_sweep1_design,
                     tensor_core_expand)


def _hidden_f32(x, w_expand, w_dw, kernel_size, pre_act, b_expand, b_dw):
    return depthwise_reference(expand_reference(x, w_expand, b_expand,
                                                pre_act),
                               w_dw, b_dw, kernel_size)


def fused_sums_reference(x, w_expand, w_dw, kernel_size: int,
                         pre_act: bool = True, b_expand=None, b_dw=None):
    """Plain PyTorch twin of ``fused_sums``: (N, E) float32."""
    return _hidden_f32(x, w_expand, w_dw, kernel_size, pre_act, b_expand,
                       b_dw).sum(dim=(1, 2))


def fused_project_reference(x, w_expand, w_dw, kernel_size: int, gate,
                            w_proj, pre_act: bool = True, b_expand=None,
                            b_dw=None, identity: bool = False):
    """Plain PyTorch twin of ``fused_project``: (N, H, W, C_out)."""
    dt = x.dtype
    out = _hidden_f32(x, w_expand, w_dw, kernel_size, pre_act, b_expand, b_dw)
    gated = round_to(round_to(out, dt) * round_to(gate, dt)[:, None, None, :],
                     dt)
    y = (gated @ round_to(w_proj, dt)).to(dt)
    if identity:
        y = (y.float() + x.float()).to(dt)
    return y


def _operands(name, x, w_expand, w_dw, kernel_size, b_expand, b_dw):
    """Checked x and (we, wd, be, bd) in the launch functions' layouts."""
    x = check_input(name, x, kernel_size)
    c_in, dev, dt = x.shape[-1], x.device, x.dtype
    e = w_dw.shape[-1]
    if w_dw.shape != (kernel_size, kernel_size, e):
        raise ValueError(f"{name}: w_dw must be (k, k, E), got "
                         f"{tuple(w_dw.shape)}")
    if w_expand is not None:
        if w_expand.shape != (c_in, e):
            raise ValueError(f"{name}: w_expand must be ({c_in}, {e})")
        w_expand = w_expand.to(device=dev, dtype=dt).contiguous()
    elif e != c_in:
        raise ValueError(f"{name}: the expand==1 form needs E == C_in")
    wd = w_dw.to(device=dev, dtype=torch.float32).contiguous()
    return x, (w_expand, wd, _vec(b_expand, e, dev, "b_expand"),
               _vec(b_dw, e, dev, "b_dw"))


def fused_sums(x, w_expand, w_dw, kernel_size: int, pre_act: bool = True,
               b_expand=None, b_dw=None):
    """SE sums (N, E) float32 of one stride-1 block's unrounded hidden,
    without writing the hidden.  Arguments as ``expand_dw``'s.

    A CPU tensor takes ``fused_sums_reference``; a CUDA tensor launches the
    kernel or raises.
    """
    if x.device.type == "cpu":
        return fused_sums_reference(x, w_expand, w_dw, kernel_size, pre_act,
                                    b_expand, b_dw)
    x, ops = _operands("fused_sums", x, w_expand, w_dw, kernel_size,
                       b_expand, b_dw)
    n, h, w, c_in = x.shape
    e = w_dw.shape[-1]
    check_sweep1_design("fused_sums", kernel_size, c_in,
                        x.dtype == torch.bfloat16, w_expand is not None,
                        x.data_ptr() % 16 == 0)
    sums = torch.zeros((n, e), dtype=torch.float32, device=x.device)
    rc = load_library().fused_sums_launch(
        x.data_ptr(), *map(ptr, ops), sums.data_ptr(), n, h, w, c_in, e,
        kernel_size, int(pre_act), int(x.dtype == torch.bfloat16),
        launch_stream(x),
    )
    check(rc, "fused_sums")
    LAUNCHES["fused_sums"] += 1
    return sums


def fused_project(x, w_expand, w_dw, kernel_size: int, gate, w_proj,
                  pre_act: bool = True, b_expand=None, b_dw=None,
                  identity: bool = False):
    """y (N, H, W, C_out) in x's dtype: the block's hidden recomputed,
    gated by ``gate`` (N, E) float32, projected by ``w_proj`` (E, C_out),
    C_out <= 128 (the whole projection of a 256-pixel tile stays on
    chip), plus x with ``identity``.  The other arguments are
    ``expand_dw``'s.

    A CPU tensor takes ``fused_project_reference``; a CUDA tensor launches
    the kernel or raises.
    """
    if x.device.type == "cpu":
        return fused_project_reference(x, w_expand, w_dw, kernel_size, gate,
                                       w_proj, pre_act, b_expand, b_dw,
                                       identity)
    x, ops = _operands("fused_project", x, w_expand, w_dw, kernel_size,
                       b_expand, b_dw)
    n, h, w, c_in = x.shape
    e = w_dw.shape[-1]
    if w_proj.dim() != 2 or w_proj.shape[0] != e:
        raise ValueError(f"fused_project: w_proj must be ({e}, C_out)")
    c_out = w_proj.shape[1]
    check_fused_project(kernel_size, c_in, c_out,
                        bf16=x.dtype == torch.bfloat16,
                        mma=tensor_core_expand(x.dtype == torch.bfloat16,
                                               c_in, w_expand is not None),
                        expand=w_expand is not None)
    if identity and c_in != c_out:
        raise ValueError("fused_project: identity needs C_in == C_out")
    if (gate.shape != (n, e) or gate.dtype != torch.float32
            or gate.device != x.device):
        raise ValueError(f"fused_project: gate must be float32 ({n}, {e}) "
                         f"on {x.device}")
    gate = gate.contiguous()
    wp = w_proj.to(device=x.device, dtype=x.dtype).contiguous()
    y = torch.empty((n, h, w, c_out), dtype=x.dtype, device=x.device)
    rc = load_library().fused_project_launch(
        x.data_ptr(), *map(ptr, ops), gate.data_ptr(), wp.data_ptr(),
        y.data_ptr(), n, h, w, c_in, e, c_out, kernel_size, int(pre_act),
        int(identity), int(x.dtype == torch.bfloat16),
        launch_stream(x),
    )
    check(rc, "fused_project")
    LAUNCHES["fused_project"] += 1
    return y
