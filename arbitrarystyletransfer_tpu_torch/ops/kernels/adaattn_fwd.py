"""Streaming AdaAttN statistics kernel: the port of ``_fwd_kernel``, and
the differentiable ``AdaAttnStatistics`` around it.

Replaces ``arbitrarystyletransfer_tpu/ops/pallas/adaattn_kernel.py:57``
``_fwd_kernel`` (host wrapper ``_adaattn_pallas_fwd``).  The CUDA kernel is
``csrc/adaattn_fwd.cu``; ``adaattn_fwd_reference`` is its plain PyTorch twin,
in float32 whatever the input dtype, with unscaled logits.  At float32 the
kernel computes every stage in float64 on the CUDA cores (the logits as one
fma chain of exact products, the exponentials, the sums) and rounds once,
so its outputs are the float64 statistics rounded to float32: the training
step's loss is chaotic under 1-ulp changes of them (PERF.md), and its gate
holds the step to the one with the AdaAttN stage in float64.  At bfloat16
it runs on the tensor cores: the logits and sums stay exact products in
float32, and the probabilities are rounded to bfloat16 for the product
with [v, v^2];
``adaattn_fwd_error_bound`` is the elementwise tolerance that rounding
implies.
``AdaAttnStatistics`` is the counterpart of the ``custom_vjp`` of
``adaattn_statistics_pallas`` (``adaattn_kernel.py:337-371``): this kernel
forward, the backward kernels of ``adaattn_bwd``.
"""

from __future__ import annotations

import torch

from . import LAUNCHES, adaattn_bwd
from ._build import check, launch_stream, load_library

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


# Relative error of one probability in the bf16 kernel's product with
# [v, v^2]: its rounding to bfloat16 (unit roundoff 2^-8), and 2^-10 for the
# float32 parts (exp2 of pre-scaled logits, the online rescaling and the
# accumulation order; each stays below 2^-12 of the same sums at Ns = 4096).
P_ROUND, F32_SUMS = 2.0 ** -8, 2.0 ** -10
BF16_ULP = 2.0 ** -7  # one bf16 ulp of |x| is at most 2^-7 |x|


def adaattn_fwd_error_bound(q, k, v):
    """Elementwise bounds (mean, std) on |kernel - twin| for bf16 inputs.

    From the twin's float32 p and l: rounding each p to bf16 moves
    ``mean`` by at most ``P_ROUND (p @ |v|) / l`` and ``ev2`` by at most
    ``P_ROUND (p @ v^2) / l`` (plus ``F32_SUMS`` of the same sums), so
    std^2 = ev2 - mean^2 moves by at most ``D = |d ev2| + 2 |mean| |d mean|
    + d mean^2``, and std by at most ``min(sqrt(D), D / std)`` (|sqrt(a') -
    sqrt(a)| <= |a' - a| / (sqrt(a') + sqrt(a))).  Each bound adds one bf16
    ulp for the rounding of the output.  Returns float32 tensors of the
    outputs' shape."""
    s = q.float() @ k.float().transpose(1, 2)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    inv_l = 1.0 / p.sum(dim=-1, keepdim=True)
    vf = v.float()
    mean = (p @ vf) * inv_l
    ev2 = (p @ vf.square()) * inv_l
    rel = P_ROUND + F32_SUMS
    d_mean = rel * (p @ vf.abs()) * inv_l
    d_ev2 = rel * ev2
    d_sq = d_ev2 + 2.0 * mean.abs() * d_mean + d_mean.square()
    std = torch.sqrt(torch.clamp(ev2 - mean.square(), min=0.0))
    d_std = torch.minimum(torch.sqrt(d_sq), d_sq / std.clamp_min(1e-30))
    return (d_mean + BF16_ULP * (mean.abs() + d_mean),
            d_std + BF16_ULP * (std + d_std))


def adaattn_fwd(q, k, v):
    """(mean, std, m, l) of the attention-weighted style moments.

    Args:
      q: (B, Nc, 128); k, v: (B, Ns, 128); all bfloat16 or all float32.

    Returns:
      mean, std (B, Nc, 128) in the input dtype; m, l (B, Nc) float32, the
      row max and sum of exp of the logits.

    A CPU tensor takes ``adaattn_fwd_reference``; a CUDA tensor launches the
    kernel (bf16: tensor cores, within ``adaattn_fwd_error_bound`` of the
    twin; f32: CUDA cores, float64 inside) or raises.
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
        launch_stream(q),
    )
    check(rc, "adaattn_fwd")
    LAUNCHES["adaattn_fwd"] += 1
    return mean, std, m, l


def fold_cotangents(mean, std, dmean, dstd, v):
    """(vbar, dm1, dm2, D) from the cotangents of (mean, std) (None for
    zero): the elementwise chain of ``_vjp_bwd``, on the style values
    centred by vbar = v's mean over the keys (B, 128) float32.  g2 =
    dstd / (2 std) is 0 where std == 0 (the dense route's ``safe_sqrt``
    convention); with mean' = mean - vbar, dm1 = dmean - 2 mean' g2 and
    dm2 = g2 (float32), and D = sum(dm1 mean' + g2 (std^2 + mean'^2)) over
    the channels (the clipped second moment of v - vbar) in float64 from
    those float32 values, as the backward forms T - D (``adaattn_bwd``).
    The backward kernels take vbar and subtract it from v: the gradients
    are the uncentred chain's, but T and D no longer carry the mean's
    offset (``csrc/adaattn_bwd.cu``)."""
    std_f = std.float()
    vbar = v.float().mean(dim=1)
    mean_c = mean.double() - vbar.double()[:, None, :]
    dmean = torch.zeros_like(std_f) if dmean is None else dmean.float()
    dstd = torch.zeros_like(std_f) if dstd is None else dstd.float()
    pos = std_f > 0
    g2 = torch.where(pos, 0.5 * dstd / torch.where(pos, std_f, 1.0), 0.0)
    dm1 = (dmean.double() - 2.0 * mean_c * g2.double()).float()
    ev2 = std_f.double().square() + mean_c.square()
    d_row = (dm1.double() * mean_c + g2.double() * ev2).sum(dim=-1)
    return vbar, dm1, g2, d_row


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
        folded = fold_cotangents(mean, std, dmean, dstd, v)
        dq = adaattn_bwd.adaattn_dq(q, k, v, *folded[:3], m, l, folded[3])
        dk, dv = adaattn_bwd.adaattn_dkv(q, k, v, *folded[:3], m, l,
                                         folded[3])
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def adaattn_statistics(q, k, v):
    """(mean, std) through the kernels, differentiable: the drop-in for the
    dense ``models.adaattn.adaattn_statistics``."""
    return AdaAttnStatistics.apply(q, k, v)
