"""Whole stride-1 block kernel: the port of ``flatblock._flat_kernel``.

Replaces ``arbitrarystyletransfer_tpu/ops/pallas/flatblock.py:92``
``_flat_kernel`` (host wrappers ``flat_expand_dw_project`` and
``flat_block_apply_f``)::

    ex     = round(hswish(x @ We + be))        (expand==1: round(x))
    hidden = round(hswish(dw_kxk(reflect_pad(ex), Wd) + bd))
    sums   = hidden.sum over H, W               (f32, of the rounded hidden)
    gate   = clip(relu((sums / HW) @ D0 + b0) @ D1 + b1, 0, 1)
    y      = round((hidden * round(gate)) @ Wp [f32 acc] + pb) (+ x)

where ``round`` casts to the I/O dtype, at the TPU kernel's rounding points
(which are not ``_fused_kernel``'s: that one runs the depthwise on the
unrounded expand and sums the unrounded hidden).  The CUDA kernel is
``csrc/flat_block.cu``, two launches: the expand + depthwise sweep writes
the hidden and its sums, and ``gate_project`` takes the gate from the sums
and projects.  ``flat_block_reference`` is its plain PyTorch twin, with the
same rounding points and every product in f32 over rounded operands.
"""

from __future__ import annotations

import torch

from . import LAUNCHES
from ._build import check, launch_stream, load_library
from .expand_dw import depthwise_reference, expand_reference, sums_buffers
from .limits import check_sweep1_design
from ..basic import se_gate


def round_to(t, dtype):
    """``t`` rounded to ``dtype`` and back to float32."""
    return t.to(dtype).float()


def gate_project_reference(hidden, sums, se_params, w_proj, proj_bias=None,
                           residual=None):
    """The second sweep in plain PyTorch: the SE gate from the exact sums,
    the gated projection (f32 accumulation), the bias and the residual."""
    dt = hidden.dtype
    _, h, w, _ = hidden.shape
    gate = round_to(se_gate(sums, h * w, se_params), dt)
    gated = round_to(hidden.float() * gate[:, None, None, :], dt)
    y = gated @ round_to(w_proj, dt)
    if proj_bias is not None:
        y = y + proj_bias.float()
    y = y.to(dt)
    if residual is not None:
        y = (y.float() + residual.float()).to(dt)
    return y


def flat_block_reference(x, w_expand, w_dw, se_params, w_proj,
                         kernel_size: int, pre_act: bool = True,
                         b_expand=None, b_dw=None, proj_bias=None,
                         identity: bool = False):
    """Plain PyTorch twin of the kernel; returns (y, sums)."""
    dt = x.dtype
    ex = round_to(expand_reference(x, w_expand, b_expand, pre_act), dt)
    hidden = depthwise_reference(ex, w_dw, b_dw, kernel_size).to(dt)
    sums = hidden.float().sum(dim=(1, 2))
    y = gate_project_reference(hidden, sums, se_params, w_proj, proj_bias,
                               x if identity else None)
    return y, sums


def _vec(t, n, device, name):
    if t is None:
        return None
    if (t.shape != (n,) or t.dtype != torch.float32 or t.device != device
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous float32 ({n},) "
                         f"tensor on {device}")
    return t


def check_input(name, x, kernel_size, stride=1, spatial=(1, 2)):
    """Raise on what the kernels do not take; returns contiguous x.
    ``spatial`` are the dims of H and W: (1, 2) for NHWC, (1, 3) for
    (N, H, C, W)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32) or x.dim() != 4:
        raise ValueError(f"{name}: x must be a 4-D bfloat16/float32 tensor")
    if kernel_size not in (3, 5):
        raise ValueError(f"{name}: kernel_size must be 3 or 5")
    h, w = (x.shape[d] for d in spatial)
    if min(h, w) <= (kernel_size - 1) // 2:
        raise ValueError(f"{name}: reflect padding needs H, W > k // 2")
    if stride == 2 and (h % 2 or w % 2):
        raise ValueError(f"{name}: stride 2 needs even H and W")
    return x.contiguous()


def kernel_operands(x, w_expand, w_dw, se_params, w_proj, kernel_size,
                    b_expand, b_dw, proj_bias, name, channel_dim=-1):
    """The launch functions' weight operands, checked, in their layouts:
    (we, wd, be, bd, d0t, d0b, d1k, d1b, wpt, pb) and (E, S, C_out)."""
    k = kernel_size
    c_in, dev, dt = x.shape[channel_dim], x.device, x.dtype
    e = w_dw.shape[-1]
    if w_dw.shape != (k, k, e):
        raise ValueError(f"{name}: w_dw must be (k, k, E), got "
                         f"{tuple(w_dw.shape)}")
    if w_expand is not None:
        if w_expand.shape != (c_in, e):
            raise ValueError(f"{name}: w_expand must be ({c_in}, {e})")
        w_expand = w_expand.to(device=dev, dtype=dt).contiguous()
    elif e != c_in:
        raise ValueError(f"{name}: the expand==1 form needs E == C_in")
    if w_proj.dim() != 2 or w_proj.shape[0] != e:
        raise ValueError(f"{name}: w_proj must be ({e}, C_out)")
    c_out = w_proj.shape[1]
    d0, d1 = se_params["Dense_0"], se_params["Dense_1"]
    s = d0["kernel"].shape[1]
    if d0["kernel"].shape != (e, s) or d1["kernel"].shape != (s, e):
        raise ValueError(f"{name}: SE kernels must be ({e}, S) and (S, {e})")

    def f32(t):
        return t.to(device=dev, dtype=torch.float32).contiguous()

    ops = (
        w_expand, f32(w_dw),
        _vec(b_expand, e, dev, "b_expand"), _vec(b_dw, e, dev, "b_dw"),
        f32(d0["kernel"].t()), _vec(f32(d0["bias"]), s, dev, "SE bias 0"),
        f32(d1["kernel"]), _vec(f32(d1["bias"]), e, dev, "SE bias 1"),
        w_proj.to(device=dev, dtype=dt).t().contiguous(),
        _vec(proj_bias, c_out, dev, "proj_bias"),
    )
    return ops, (e, s, c_out)


def ptr(t):
    return None if t is None else t.data_ptr()


def flat_block(x, w_expand, w_dw, se_params, w_proj, kernel_size: int,
               pre_act: bool = True, b_expand=None, b_dw=None,
               proj_bias=None, identity: bool = False):
    """(y, sums) of one whole stride-1 inverted-residual block.

    Args:
      x: (N, H, W, C_in) NHWC, bfloat16 or float32.
      w_expand: (C_in, E) expand weights, or None for the expand==1 form
        (then E == C_in).
      w_dw: (k, k, E) depthwise weights; k is 3 or 5.
      se_params: the block's ``SELayer_0`` subtree (Dense_0 (E, S),
        Dense_1 (S, E), float32 with biases).
      w_proj: (E, C_out) projection weights.
      pre_act: hardswish after the expand.
      b_expand, b_dw, proj_bias: optional float32 biases (folded BN).
      identity: add x to the output (C_in == C_out).

    Returns:
      y (N, H, W, C_out) in x's dtype and the SE sums (N, E) float32.

    A CPU tensor takes ``flat_block_reference``; a CUDA tensor launches the
    kernel or raises.
    """
    if x.device.type == "cpu":
        return flat_block_reference(x, w_expand, w_dw, se_params, w_proj,
                                    kernel_size, pre_act, b_expand, b_dw,
                                    proj_bias, identity)
    x = check_input("flat_block", x, kernel_size)
    n, h, w, c_in = x.shape
    ops, (e, s, c_out) = kernel_operands(
        x, w_expand, w_dw, se_params, w_proj, kernel_size, b_expand, b_dw,
        proj_bias, "flat_block")
    if identity and c_in != c_out:
        raise ValueError("flat_block: identity needs C_in == C_out")
    check_sweep1_design("flat_block", kernel_size, c_in,
                        x.dtype == torch.bfloat16, w_expand is not None,
                        x.data_ptr() % 16 == 0)
    hidden = torch.empty((n, h, w, e), dtype=x.dtype, device=x.device)
    sums, part, tiles = sums_buffers(n, e, h, w, x.device)
    gate = torch.empty((n, e), dtype=torch.float32, device=x.device)
    y = torch.empty((n, h, w, c_out), dtype=x.dtype, device=x.device)
    rc = load_library().flat_block_launch(
        x.data_ptr(), *map(ptr, ops), hidden.data_ptr(), sums.data_ptr(),
        part.data_ptr(), gate.data_ptr(), y.data_ptr(), n, h, w, c_in, e, s,
        c_out, kernel_size, int(pre_act), int(identity),
        int(x.dtype == torch.bfloat16), tiles,
        launch_stream(x),
    )
    check(rc, "flat_block")
    LAUNCHES["flat_block"] += 1
    return y, sums
