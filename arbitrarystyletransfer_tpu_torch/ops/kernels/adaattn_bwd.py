"""Streaming AdaAttN backward kernels: the port of ``_dq_kernel`` and
``_dkv_kernel``.

Replace ``arbitrarystyletransfer_tpu/ops/pallas/adaattn_kernel.py:183``
``_dq_kernel`` and ``:220`` ``_dkv_kernel`` (host wrapper
``_adaattn_pallas_bwd``).  The CUDA kernels are ``csrc/adaattn_bwd.cu``;
``adaattn_bwd_reference`` is their plain PyTorch twin, which materializes
the attention matrix.  All compute in float32 whatever the input dtype.

Inputs of both: q (B, Nc, 128), k, v (B, Ns, 128) in one dtype (bfloat16
or float32); the folded cotangents dm1, dm2 (B, Nc, 128), float32 or q's
dtype; the forward's row max m and sum of exp l, and the row term
D = sum(dM o [M1, M2]), each (B, Nc) float32.
"""

from __future__ import annotations

import torch

from . import LAUNCHES
from ._build import check, load_library

CHANNELS = 128
_NEG_INF = -1e30


def _p_and_ds(q, k, v, dm1, dm2, m, l, d_row):
    """P = exp(q k^T - m) / l and dS = P o (dm1 v^T + dm2 (v^2)^T - D)."""
    qf, kf, vf = q.float(), k.float(), v.float()
    s = qf @ kf.transpose(1, 2)
    p = torch.exp(s - m[..., None]) / l[..., None]
    t = dm1.float() @ vf.transpose(1, 2) + dm2.float() @ vf.square().transpose(1, 2)
    return p, p * (t - d_row[..., None])


def adaattn_dq_reference(q, k, v, dm1, dm2, m, l, d_row):
    """Plain twin of ``adaattn_dq``: dq = dS k, in q's dtype."""
    _, ds = _p_and_ds(q, k, v, dm1, dm2, m, l, d_row)
    return (ds @ k.float()).to(q.dtype)


def adaattn_dkv_reference(q, k, v, dm1, dm2, m, l, d_row):
    """Plain twin of ``adaattn_dkv``: dk = dS^T q, dv = P^T dm1 + 2 v o
    (P^T dm2), in k's dtype."""
    p, ds = _p_and_ds(q, k, v, dm1, dm2, m, l, d_row)
    pt = p.transpose(1, 2)
    dk = ds.transpose(1, 2) @ q.float()
    dv = pt @ dm1.float() + 2.0 * v.float() * (pt @ dm2.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def adaattn_bwd_reference(q, k, v, dm1, dm2, m, l, d_row):
    """(dq, dk, dv) through the plain twins."""
    return (adaattn_dq_reference(q, k, v, dm1, dm2, m, l, d_row),
            *adaattn_dkv_reference(q, k, v, dm1, dm2, m, l, d_row))


def _checked(name, q, k, v, dm1, dm2, m, l, d_row):
    """Validate the inputs of a CUDA launch; returns them contiguous and
    the (b, nc, ns, is_bf16, dm_bf16) launch arguments."""
    b, nc, c = q.shape
    ns = k.shape[1]
    if c != CHANNELS or k.shape != (b, ns, c) or v.shape != (b, ns, c):
        raise ValueError(
            f"{name}: need q (B, Nc, {CHANNELS}) and k, v (B, Ns, "
            f"{CHANNELS}), got {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}")
    if dm1.shape != q.shape or dm2.shape != q.shape:
        raise ValueError(f"{name}: dm1, dm2 must have q's shape")
    if any(t.shape != (b, nc) or t.dtype != torch.float32
           for t in (m, l, d_row)):
        raise ValueError(f"{name}: m, l, D must be (B, Nc) float32")
    if ns == 0:
        raise ValueError(f"{name}: empty style axis")
    if q.dtype not in (torch.bfloat16, torch.float32) or not (
            k.dtype == v.dtype == q.dtype):
        raise ValueError(f"{name}: q, k, v must share one dtype, bfloat16 "
                         "or float32")
    if dm1.dtype != dm2.dtype or dm1.dtype not in (torch.float32, q.dtype):
        raise ValueError(f"{name}: dm1, dm2 must be float32 or q's dtype")
    tensors = (q, k, v, dm1, dm2, m, l, d_row)
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: all inputs must be on one device")
    tensors = tuple(t.contiguous() for t in tensors)
    flags = (b, nc, ns, int(q.dtype == torch.bfloat16),
             int(dm1.dtype == torch.bfloat16))
    return tensors, flags


def _device_path(name, q):
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    return True


def adaattn_dq(q, k, v, dm1, dm2, m, l, d_row):
    """dq (B, Nc, 128) in q's dtype.  A CPU tensor takes
    ``adaattn_dq_reference``; a CUDA tensor launches the kernel or raises."""
    if not _device_path("adaattn_dq", q):
        return adaattn_dq_reference(q, k, v, dm1, dm2, m, l, d_row)
    ins, (b, nc, ns, is_bf16, dm_bf16) = _checked(
        "adaattn_dq", q, k, v, dm1, dm2, m, l, d_row)
    dq = torch.empty_like(ins[0])
    rc = load_library().adaattn_dq_launch(
        *(t.data_ptr() for t in ins), dq.data_ptr(), b, nc, ns, CHANNELS,
        is_bf16, dm_bf16, torch.cuda.current_stream(q.device).cuda_stream)
    check(rc, "adaattn_dq")
    LAUNCHES["adaattn_dq"] += 1
    return dq


def adaattn_dkv(q, k, v, dm1, dm2, m, l, d_row):
    """(dk, dv), each (B, Ns, 128) in k's dtype.  A CPU tensor takes
    ``adaattn_dkv_reference``; a CUDA tensor launches the kernel or
    raises."""
    if not _device_path("adaattn_dkv", q):
        return adaattn_dkv_reference(q, k, v, dm1, dm2, m, l, d_row)
    ins, (b, nc, ns, is_bf16, dm_bf16) = _checked(
        "adaattn_dkv", q, k, v, dm1, dm2, m, l, d_row)
    dk = torch.empty_like(ins[1])
    dv = torch.empty_like(ins[2])
    rc = load_library().adaattn_dkv_launch(
        *(t.data_ptr() for t in ins), dk.data_ptr(), dv.data_ptr(), b, nc,
        ns, CHANNELS, is_bf16, dm_bf16,
        torch.cuda.current_stream(q.device).cuda_stream)
    check(rc, "adaattn_dkv")
    LAUNCHES["adaattn_dkv"] += 1
    return dk, dv
