"""Streaming AdaAttN statistics kernel: the port of ``_fwd_kernel``, and
the differentiable ``AdaAttnStatistics`` around it.

Replaces ``arbitrarystyletransfer_tpu/ops/pallas/adaattn_kernel.py:57``
``_fwd_kernel`` (host wrapper ``_adaattn_pallas_fwd``).  The CUDA kernel is
``csrc/adaattn_fwd.cu``; ``adaattn_fwd_reference`` is its plain PyTorch twin.
Both compute in float32 whatever the input dtype, with unscaled logits.
``AdaAttnStatistics`` is the counterpart of the ``custom_vjp`` of
``adaattn_statistics_pallas`` (``adaattn_kernel.py:337-371``): this kernel
forward, the backward kernels of ``adaattn_bwd``.
"""

from __future__ import annotations

import torch

from . import LAUNCHES, adaattn_bwd
from ._build import check, load_library

CHANNELS = 128


def adaattn_fwd_reference(q, k, v):
    """Plain PyTorch twin: (mean, std, m, l), materializing the logits."""
    s = q.float() @ k.float().transpose(1, 2)  # (B, Nc, Ns)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    vf = v.float()
    inv_l = (1.0 / l)[..., None]
    mean = (p @ vf) * inv_l
    ev2 = (p @ vf.square()) * inv_l
    std = torch.sqrt(torch.clamp(ev2 - mean.square(), min=0.0))
    return mean.to(q.dtype), std.to(q.dtype), m, l


def adaattn_fwd(q, k, v):
    """(mean, std, m, l) of the attention-weighted style moments.

    Args:
      q: (B, Nc, 128); k, v: (B, Ns, 128); all bfloat16 or all float32.

    Returns:
      mean, std (B, Nc, 128) in the input dtype; m, l (B, Nc) float32, the
      row max and sum of exp of the logits.

    A CPU tensor takes ``adaattn_fwd_reference``; a CUDA tensor launches the
    kernel or raises.
    """
    if q.device.type == "cpu":
        return adaattn_fwd_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"adaattn_fwd: unsupported device {q.device}")
    b, nc, c = q.shape
    ns = k.shape[1]
    if c != CHANNELS or k.shape != (b, ns, c) or v.shape != (b, ns, c):
        raise ValueError(
            f"adaattn_fwd: need q (B, Nc, {CHANNELS}) and k, v (B, Ns, "
            f"{CHANNELS}), got {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}")
    if ns == 0:
        raise ValueError("adaattn_fwd: empty style axis")
    if q.dtype not in (torch.bfloat16, torch.float32) or not (
            k.dtype == v.dtype == q.dtype):
        raise ValueError("adaattn_fwd: q, k, v must share one dtype, "
                         "bfloat16 or float32")
    if not (k.device == v.device == q.device):
        raise ValueError("adaattn_fwd: q, k, v must be on one device")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    mean = torch.empty_like(q)
    std = torch.empty_like(q)
    m = torch.empty((b, nc), dtype=torch.float32, device=q.device)
    l = torch.empty((b, nc), dtype=torch.float32, device=q.device)
    lib = load_library()
    rc = lib.adaattn_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mean.data_ptr(),
        std.data_ptr(), m.data_ptr(), l.data_ptr(), b, nc, ns, c,
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    check(rc, "adaattn_fwd")
    LAUNCHES["adaattn_fwd"] += 1
    return mean, std, m, l


def fold_cotangents(mean, std, dmean, dstd):
    """(dm1, dm2, D) in float32 from the cotangents of (mean, std) (None
    for zero): the elementwise chain of ``_vjp_bwd``.  g2 = dstd / (2 std)
    is 0 where std == 0 (the dense route's ``safe_sqrt`` convention); ev2
    is re-formed as std^2 + mean^2, the clipped second moment; D =
    sum(dm1 mean + dm2 ev2) over the channels."""
    std_f, mean_f = std.float(), mean.float()
    dmean = torch.zeros_like(mean_f) if dmean is None else dmean.float()
    dstd = torch.zeros_like(std_f) if dstd is None else dstd.float()
    pos = std_f > 0
    g2 = torch.where(pos, 0.5 * dstd / torch.where(pos, std_f, 1.0), 0.0)
    dm1 = dmean - 2.0 * mean_f * g2
    ev2 = std_f.square() + mean_f.square()
    d_row = (dm1 * mean_f + g2 * ev2).sum(dim=-1)
    return dm1, g2, d_row


class AdaAttnStatistics(torch.autograd.Function):
    """(mean, std) = ``adaattn_fwd``'s statistics, with the flash backward.

    The backward is ``_vjp_bwd`` of the JAX package: the elementwise chain
    in plain PyTorch (``fold_cotangents``), then the ``adaattn_dq`` and
    ``adaattn_dkv`` kernels, the gradients cast back to the input
    dtypes."""

    @staticmethod
    def forward(ctx, q, k, v):
        mean, std, m, l = adaattn_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, mean, std, m, l)
        return mean, std

    @staticmethod
    def backward(ctx, dmean, dstd):
        q, k, v, mean, std, m, l = ctx.saved_tensors
        dm1, dm2, d_row = fold_cotangents(mean, std, dmean, dstd)
        dq = adaattn_bwd.adaattn_dq(q, k, v, dm1, dm2, m, l, d_row)
        dk, dv = adaattn_bwd.adaattn_dkv(q, k, v, dm1, dm2, m, l, d_row)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def adaattn_statistics(q, k, v):
    """(mean, std) through the kernels, differentiable: the drop-in for the
    dense ``models.adaattn.adaattn_statistics``."""
    return AdaAttnStatistics.apply(q, k, v)
