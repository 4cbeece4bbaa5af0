"""Streaming AdaAttN backward kernels: the port of ``_dq_kernel`` and
``_dkv_kernel``.

Replace ``arbitrarystyletransfer_tpu/ops/pallas/adaattn_kernel.py:183``
``_dq_kernel`` and ``:220`` ``_dkv_kernel`` (host wrapper
``_adaattn_pallas_bwd``).  The CUDA kernels are ``csrc/adaattn_bwd.cu``;
``adaattn_bwd_reference`` is their plain PyTorch twin, which materializes
the attention matrix.  All compute in float32 whatever the input dtype.

Both take the style values centred by their mean over the keys: q (B, Nc,
128), k, v (B, Ns, 128) in one dtype (bfloat16 or float32); vbar (B, 128)
float32, the shift (``fold_cotangents`` uses v's mean); the cotangents folded
with the centred mean (``adaattn_fwd.fold_cotangents``) dm1, dm2 (B, Nc, 128),
float32 or q's dtype; the forward's row max m and sum of exp l (B, Nc)
float32, and the row term D (B, Nc) float64.  The gradients are those of
the uncentred form (the JAX kernels').  Like the kernels, the twins form
the logits and T - D = dm1 vc^T + dm2 (vc^2)^T - D in float64 (T and D
cancel by up to the square of the style values' spread over their
attention-weighted std: ``csrc/adaattn_bwd.cu`` says why), and dv = P^T dm1
+ 2 vc o (P^T dm2) in float64 (its terms cancel by up to that spread over
the std), and everything else in float32.
"""

from __future__ import annotations

import torch

from . import LAUNCHES
from ._build import check, launch_stream, load_library

CHANNELS = 128
# The CUDA kernels' tiles along the reduction axis that a split never cuts:
# 32 keys (adaattn_dq), 32 queries (adaattn_dkv).
SPLIT_TILE = 32


def split_bounds(n, splits, tile=SPLIT_TILE):
    """[(start, stop)] of each of ``splits`` chunks of an axis of length n,
    in whole tiles, as the CUDA kernels cut it (chunk s: tiles s T / S to
    (s + 1) T / S, T = ceil(n / tile))."""
    tiles = -(-n // tile)
    splits = max(1, min(splits, tiles))
    return [(min(n, tile * (s * tiles // splits)),
             min(n, tile * ((s + 1) * tiles // splits)))
            for s in range(splits)]


def _p_and_ds(q, k, v, vbar, dm1, dm2, m, l, d_row):
    """P = exp(q k^T - m) / l (logits in float64, the rest in float32) and
    dS = P o (dm1 vc^T + dm2 (vc^2)^T - D) (T - D in float64), vc = v -
    vbar, and vc in float64."""
    s = q.double() @ k.double().transpose(1, 2)
    p = torch.exp((s - m.double()[..., None]).float()) / l[..., None]
    vc = v.double() - vbar.double()[:, None, :]
    t = (dm1.double() @ vc.transpose(1, 2)
         + dm2.double() @ vc.square().transpose(1, 2))
    return p, p * (t - d_row.double()[..., None]).float(), vc


def adaattn_dq_reference(q, k, v, vbar, dm1, dm2, m, l, d_row, splits=1):
    """Plain twin of ``adaattn_dq``: dq = dS k, in q's dtype.  With
    ``splits`` > 1 the keys are cut as the kernel's chunks
    (``split_bounds``) and the chunks' f32 sums added in order."""
    _, ds, _ = _p_and_ds(q, k, v, vbar, dm1, dm2, m, l, d_row)
    kf = k.float()
    dq = None
    for a, b in split_bounds(k.shape[1], splits):
        part = ds[..., a:b] @ kf[:, a:b]
        dq = part if dq is None else dq + part
    return dq.to(q.dtype)


def adaattn_dkv_reference(q, k, v, vbar, dm1, dm2, m, l, d_row, splits=1):
    """Plain twin of ``adaattn_dkv``: dk = dS^T q, dv = P^T dm1 + 2 vc o
    (P^T dm2), in k's dtype; ``splits`` cuts the queries as
    ``adaattn_dq_reference`` cuts the keys.  dv's two products and their
    sum are float64 from the f32 P and dm, each chunk's rounded once to f32
    (the two terms cancel by up to |vc| / std), as in the kernel."""
    p, ds, vc = _p_and_ds(q, k, v, vbar, dm1, dm2, m, l, d_row)
    qf, d1, d2 = q.float(), dm1.double(), dm2.double()
    dk = dv = None
    for a, b in split_bounds(q.shape[1], splits):
        pt = p[:, a:b].transpose(1, 2).double()
        part_k = ds[:, a:b].transpose(1, 2) @ qf[:, a:b]
        part_v = (pt @ d1[:, a:b] + 2.0 * vc * (pt @ d2[:, a:b])).float()
        dk = part_k if dk is None else dk + part_k
        dv = part_v if dv is None else dv + part_v
    return dk.to(k.dtype), dv.to(v.dtype)


def adaattn_bwd_reference(q, k, v, vbar, dm1, dm2, m, l, d_row):
    """(dq, dk, dv) through the plain twins."""
    args = (q, k, v, vbar, dm1, dm2, m, l, d_row)
    return (adaattn_dq_reference(*args), *adaattn_dkv_reference(*args))


def _checked(name, q, k, v, vbar, dm1, dm2, m, l, d_row):
    """Validate the inputs of a CUDA launch; returns them contiguous and
    the (b, nc, ns, is_bf16, dm_bf16) launch arguments."""
    b, nc, c = q.shape
    ns = k.shape[1]
    if c != CHANNELS or k.shape != (b, ns, c) or v.shape != (b, ns, c):
        raise ValueError(
            f"{name}: need q (B, Nc, {CHANNELS}) and k, v (B, Ns, "
            f"{CHANNELS}), got {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}")
    if vbar.shape != (b, c) or vbar.dtype != torch.float32:
        raise ValueError(f"{name}: vbar must be (B, {CHANNELS}) float32")
    if dm1.shape != q.shape or dm2.shape != q.shape:
        raise ValueError(f"{name}: dm1, dm2 must have q's shape")
    if any(t.shape != (b, nc) or t.dtype != torch.float32 for t in (m, l)):
        raise ValueError(f"{name}: m, l must be (B, Nc) float32")
    if d_row.shape != (b, nc) or d_row.dtype != torch.float64:
        raise ValueError(f"{name}: D must be (B, Nc) float64")
    if ns == 0:
        raise ValueError(f"{name}: empty style axis")
    if q.dtype not in (torch.bfloat16, torch.float32) or not (
            k.dtype == v.dtype == q.dtype):
        raise ValueError(f"{name}: q, k, v must share one dtype, bfloat16 "
                         "or float32")
    if dm1.dtype != dm2.dtype or dm1.dtype not in (torch.float32, q.dtype):
        raise ValueError(f"{name}: dm1, dm2 must be float32 or q's dtype")
    tensors = (q, k, v, vbar, dm1, dm2, m, l, d_row)
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


def _scratch(shape, splits, device):
    """The kernels' f32 scratch of chunk sums (empty at one chunk)."""
    if splits <= 1:
        return torch.empty(0, dtype=torch.float32, device=device)
    return torch.empty(shape, dtype=torch.float32, device=device)


def adaattn_dq(q, k, v, vbar, dm1, dm2, m, l, d_row, splits=None):
    """dq (B, Nc, 128) in q's dtype.  A CPU tensor takes
    ``adaattn_dq_reference``; a CUDA tensor launches the kernel or raises.
    ``splits`` forces the number of key chunks (default: the kernel's own
    choice for the shape)."""
    if not _device_path("adaattn_dq", q):
        return adaattn_dq_reference(q, k, v, vbar, dm1, dm2, m, l, d_row,
                                    splits or 1)
    ins, (b, nc, ns, is_bf16, dm_bf16) = _checked(
        "adaattn_dq", q, k, v, vbar, dm1, dm2, m, l, d_row)
    lib = load_library()
    splits = len(split_bounds(ns, splits or lib.adaattn_dq_splits(b, nc, ns)))
    dq = torch.empty_like(ins[0])
    part = _scratch((splits, b, nc, CHANNELS), splits, q.device)
    rc = lib.adaattn_dq_launch(
        *(t.data_ptr() for t in ins), dq.data_ptr(), part.data_ptr(), b, nc,
        ns, CHANNELS, splits, is_bf16, dm_bf16,
        launch_stream(q))
    check(rc, "adaattn_dq")
    LAUNCHES["adaattn_dq"] += 1
    return dq


def adaattn_dkv(q, k, v, vbar, dm1, dm2, m, l, d_row, splits=None):
    """(dk, dv), each (B, Ns, 128) in k's dtype.  A CPU tensor takes
    ``adaattn_dkv_reference``; a CUDA tensor launches the kernel or
    raises.  ``splits`` forces the number of query chunks."""
    if not _device_path("adaattn_dkv", q):
        return adaattn_dkv_reference(q, k, v, vbar, dm1, dm2, m, l, d_row,
                                     splits or 1)
    ins, (b, nc, ns, is_bf16, dm_bf16) = _checked(
        "adaattn_dkv", q, k, v, vbar, dm1, dm2, m, l, d_row)
    lib = load_library()
    splits = (len(split_bounds(nc, splits
                               or lib.adaattn_dkv_splits(b, nc, ns)))
              if nc else 1)
    dk = torch.empty_like(ins[1])
    dv = torch.empty_like(ins[2])
    # dk's chunks, then dv's.
    part = _scratch((2, splits, b, ns, CHANNELS), splits, q.device)
    rc = lib.adaattn_dkv_launch(
        *(t.data_ptr() for t in ins), dk.data_ptr(), dv.data_ptr(),
        part.data_ptr(), b, nc, ns, CHANNELS, splits, is_bf16, dm_bf16,
        launch_stream(q))
    check(rc, "adaattn_dkv")
    LAUNCHES["adaattn_dkv"] += 1
    return dk, dv
