"""Streaming AdaAttN statistics kernel: the port of ``_fwd_kernel``, and
the differentiable ``AdaAttnStatistics`` around it.

Replaces ``arbitrarystyletransfer_tpu/ops/pallas/adaattn_kernel.py:57``
``_fwd_kernel`` (host wrapper ``_adaattn_pallas_fwd``).  The CUDA kernels
are in ``csrc/adaattn_fwd.cu``; ``adaattn_fwd_reference`` is their plain
PyTorch twin, in float32 whatever the input dtype, with unscaled logits.
At float32 there are two forms, and ``adaattn_statistics`` takes one by
whether autograd records the call (``statistics_form``):

- training (recorded): the kernel computes every stage in float64 (the
  logits as one fma chain of exact products, the exponentials, the sums)
  and rounds once, so its outputs are the float64 statistics rounded to
  float32: the training step's loss is chaotic under 1-ulp changes of
  them (PERF.md), and its gate holds the step to the one with the AdaAttN
  stage in float64.
- serving (not recorded: ``torch.inference_mode``, ``no_grad``, inputs
  without grad): ``adaattn_fwd(..., serve=True)``, 3xTF32 on the tensor
  cores, with the second moment about the values' mean over the keys and
  v, (v - vbar)^2 and P carried so that a one-hot row is exact
  (``adaattn_serve_emulation`` is its arithmetic on the CPU, for the
  tests).

At bfloat16 the kernel runs on the tensor cores: the logits and sums stay
exact products in float32, and the probabilities are rounded to bfloat16
for the product with [v, v^2]; ``adaattn_fwd_error_bound`` is the
elementwise tolerance that rounding implies.
``AdaAttnStatistics`` is the counterpart of the ``custom_vjp`` of
``adaattn_statistics_pallas`` (``adaattn_kernel.py:337-371``): the
training forward, the backward kernels of ``adaattn_bwd``.
"""

from __future__ import annotations

import math

import torch

from . import LAUNCHES, adaattn_bwd
from ._build import check, launch_stream, load_library

CHANNELS = 128
# f32 launches of ``adaattn_fwd`` by form (both also count in LAUNCHES):
# "serve" the 3xTF32 serving kernel, "f64" the float64 one.
F32_FORMS = {"serve": 0, "f64": 0}
# The serving kernel's query rows per CTA and keys per tile, and the
# fewest tiles a chunk of the style axis takes (``serve_splits``).
SERVE_ROWS, SERVE_KEYS, SERVE_MIN_TILES = 128, 32, 8
H100_SMS = 132


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


def serve_splits(b, nc, ns, sms=H100_SMS):
    """(chunks, keys per chunk) of the style axis for the serving kernel:
    one chunk where the (image, 128-row) CTAs fill the card's ``sms`` SMs,
    else as many as fill it, each at least ``SERVE_MIN_TILES`` tiles of
    ``SERVE_KEYS`` keys (the CLI's 320px graph request, (1, 1600, 1600):
    13 CTAs, 6 chunks of 288 keys).  The chunks are merged by a second
    kernel (``adaattn_fwd_serve_combine``)."""
    ctas = b * math.ceil(nc / SERVE_ROWS)
    tiles = math.ceil(ns / SERVE_KEYS)
    want = max(1, min(sms // max(ctas, 1), tiles // SERVE_MIN_TILES))
    per = math.ceil(tiles / want) * SERVE_KEYS
    return math.ceil(ns / per), per


def adaattn_fwd(q, k, v, serve=False):
    """(mean, std, m, l) of the attention-weighted style moments.

    Args:
      q: (B, Nc, 128); k, v: (B, Ns, 128); all bfloat16 or all float32.
      serve: float32 inputs take the serving kernel (3xTF32 on the tensor
        cores) instead of the float64 one; set only by
        ``adaattn_statistics`` and ``chip_smoke.py``.  bfloat16 ignores it.

    Returns:
      mean, std (B, Nc, 128) in the input dtype; m, l (B, Nc) float32, the
      row max and sum of exp of the logits.

    A CPU tensor takes ``adaattn_fwd_reference``; a CUDA tensor launches a
    kernel (bf16: tensor cores, within ``adaattn_fwd_error_bound`` of the
    twin; f32: float64 inside, or the serving form) or raises.
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
    if serve and q.dtype == torch.float32:
        vbar = v.mean(dim=1)
        splits, per = serve_splits(
            b, nc, ns,
            torch.cuda.get_device_properties(q.device).multi_processor_count)
        part = (torch.empty(splits * b * nc * (2 * c + 2),
                            dtype=torch.float32, device=q.device)
                if splits > 1 else None)
        rc = lib.adaattn_fwd_serve_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), vbar.data_ptr(),
            mean.data_ptr(), std.data_ptr(), m.data_ptr(), l.data_ptr(),
            None if part is None else part.data_ptr(), b, nc, ns, c,
            splits, per, launch_stream(q))
        check(rc, "adaattn_fwd (serving)")
        F32_FORMS["serve"] += 1
    else:
        rc = lib.adaattn_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mean.data_ptr(),
            std.data_ptr(), m.data_ptr(), l.data_ptr(), b, nc, ns, c,
            int(q.dtype == torch.bfloat16),
            launch_stream(q),
        )
        check(rc, "adaattn_fwd")
        if q.dtype == torch.float32:
            F32_FORMS["f64"] += 1
    LAUNCHES["adaattn_fwd"] += 1
    return mean, std, m, l


TF32_MASK = -8192  # 0xffffe000 as int32: the bits a TF32 value keeps


def _tf32(x, nearest=False):
    """x's top 19 bits (what the tensor cores read of an f32 operand), or
    x rounded to them (``split_tf32``'s hi: an add and a mask on the
    bits)."""
    bits = x.contiguous().view(torch.int32)
    if nearest:
        bits = bits + 0x1000
    return (bits & TF32_MASK).view(torch.float32)


def _split(x):
    """``split_tf32``: hi to nearest, lo = x - hi as the cores read it."""
    hi = _tf32(x, nearest=True)
    return hi, _tf32(x - hi)


def _pieces3(x):
    """``tf32_pieces3``: x as three truncated TF32 pieces, exactly."""
    a = _tf32(x)
    r = x - a
    b = _tf32(r)
    return a, b, r - b


def _mma(acc, a, b):
    """One m16n8k8 TF32 step: acc + a @ b summed exactly (float64 holds
    the products of TF32 values), rounded toward zero to f32, as the
    tensor cores add."""
    exact = acc.double() + a.double() @ b.double()
    out = exact.float()
    over = out.double().abs() > exact.abs()
    return torch.where(over, torch.nextafter(out, torch.zeros_like(out)), out)


def _fma(a, b, c):
    """f32 fmaf(a, b, c): one rounding."""
    return (a.double() * b.double() + c.double()).float()


def _serve_chunk(qh, ql, k, v, vc2):
    """One CTA's chunk of the style axis: (A v, A vc^2 unnormalized, m,
    l), in the kernel's order."""
    b, nc, c = qh.shape
    bk = SERVE_KEYS
    m = torch.full((b, nc), -1e30)
    l4 = torch.zeros(b, nc, 4)  # the quad's threads' own sums
    om, os_ = torch.zeros(b, nc, c), torch.zeros(b, nc, c)
    for k0 in range(0, k.shape[1], bk):
        n = min(bk, k.shape[1] - k0)
        pad = (0, 0, 0, bk - n)
        kh, kl = _split(torch.nn.functional.pad(k[:, k0:k0 + n], pad))
        vt = torch.nn.functional.pad(v[:, k0:k0 + n], pad)
        v2t = torch.nn.functional.pad(vc2[:, k0:k0 + n], pad)
        sc = torch.zeros(b, nc, bk)
        for step, c0 in enumerate(range(0, c, 8)):
            if step % 2 == 0:
                sp = torch.zeros(b, nc, bk)
            ch = slice(c0, c0 + 8)
            for a, w in ((ql, kh), (qh, kl), (qh, kh)):
                sp = _mma(sp, a[..., ch], w[..., ch].transpose(1, 2))
            if step % 2 == 1:
                sc = sc + sp
        sc[..., n:] = -1e30
        mx = torch.maximum(m, sc.amax(dim=-1))
        corr = torch.exp(m - mx)
        m = mx
        p = torch.exp(sc - mx[..., None])
        ph = _tf32(p, nearest=True)
        pl = _tf32(p - ph)
        # Thread t of a quad adds keys 8 n + 2 t, then 8 n + 2 t + 1.
        pp = (ph + pl).reshape(b, nc, 4, 4, 2)
        l4 = l4 * corr[..., None]
        for i in range(4):
            for j in range(2):
                l4 = l4 + pp[:, :, i, :, j]
        om = om * corr[..., None]
        os_ = os_ * corr[..., None]
        for k8 in range(0, bk, 8):
            ks = slice(k8, k8 + 8)
            for which, x in ((0, vt), (1, v2t)):
                x1, x2, x3 = _pieces3(x[:, ks])
                d = torch.zeros(b, nc, c)
                for a, w in ((ph, x3), (ph, x2), (pl, x1), (ph, x1)):
                    d = _mma(d, a[..., ks], w)
                if which == 0:
                    om = om + d
                else:
                    os_ = os_ + d
    l = (l4[..., 0] + l4[..., 1]) + (l4[..., 2] + l4[..., 3])
    return om, os_, m, l


def adaattn_serve_emulation(q, k, v, sms=H100_SMS):
    """The serving kernel's arithmetic on the CPU: (mean, std, m, l), f32.

    vbar = v's mean over the keys; the logits as lo hi + hi lo + hi hi
    TF32 products of q and k (``split_tf32``) in partials of two k8 steps
    from zero; per 32-key tile the online softmax in f32, P as hi (to
    nearest) + lo (truncated), l the sum of hi + lo; A v and A vc^2 (vc =
    v - vbar) from the exact three-piece splits of v and vc^2, each k8
    step's four products from zero added to nearest; the style axis in
    ``serve_splits``' chunks for a card of ``sms`` SMs, merged as
    ``adaattn_fwd_serve_combine`` merges them; mean = A v, std =
    sqrt(max(A vc^2 - (mean - vbar)^2, 0)).  Each MMA is modelled as the
    exact sum of its products and accumulator rounded toward zero
    (``_mma``).  For the tests; nothing on the main path calls it."""
    q, k, v = q.float(), k.float(), v.float()
    b, nc, c = q.shape
    ns = k.shape[1]
    vbar = v.mean(dim=1)
    vc = v - vbar[:, None]
    vc2 = vc * vc
    qh, ql = _split(q)
    _, per = serve_splits(b, nc, ns, sms)
    chunks = [_serve_chunk(qh, ql, k[:, s:s + per], v[:, s:s + per],
                           vc2[:, s:s + per]) for s in range(0, ns, per)]
    om, os_, m, l = chunks[0]
    if len(chunks) > 1:
        m = torch.stack([ch[2] for ch in chunks]).amax(dim=0)
        l = torch.zeros(b, nc)
        om, os_ = torch.zeros(b, nc, c), torch.zeros(b, nc, c)
        for o1, o2, m_s, l_s in chunks:
            w = torch.exp(m_s - m)
            l = _fma(w, l_s, l)
            om = _fma(w[..., None], o1, om)
            os_ = _fma(w[..., None], o2, os_)
    inv_l = (1.0 / l)[..., None]
    mean = om * inv_l
    mc = mean - vbar[:, None]
    ev2 = os_ * inv_l
    std = torch.sqrt(torch.clamp(ev2 - mc * mc, min=0.0))
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


def statistics_form(q, k, v):
    """The form ``adaattn_statistics`` takes on these inputs: "autograd"
    where autograd records the call (grad enabled and some input requires
    grad: the train, GAN and data-parallel steps), which runs
    ``AdaAttnStatistics`` (at f32 the float64 forward, with the backward
    kernels); else "serve" (``torch.inference_mode``, ``no_grad``, inputs
    without grad: every serving path), which runs ``adaattn_fwd(...,
    serve=True)`` (at f32 the 3xTF32 serving kernel; at bf16 the same
    tensor-core kernel either way)."""
    recorded = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    return "autograd" if recorded else "serve"


def adaattn_statistics(q, k, v):
    """(mean, std) through the kernels, differentiable where autograd
    records the call (``statistics_form``): the drop-in for the dense
    ``models.adaattn.adaattn_statistics``."""
    if statistics_form(q, k, v) == "autograd":
        return AdaAttnStatistics.apply(q, k, v)
    return adaattn_fwd(q, k, v, serve=True)[:2]
