"""Kernels 6 and 7 on the centred style values: the fold and the plain twins
against JAX's uncentred backward, against float64 autograd where the
uncentred form cancels, and the chunked (split) twins against the unsplit.

The Pallas kernels run under ``pltpu.force_tpu_interpret_mode()`` on the
CPU.  The CUDA kernels are checked on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from arbitrarystyletransfer_tpu.ops.pallas.adaattn_kernel import _vjp_bwd

from arbitrarystyletransfer_tpu_torch.ops.kernels.adaattn_bwd import (
    adaattn_bwd_reference,
    adaattn_dkv_reference,
    adaattn_dq_reference,
    split_bounds,
)
from arbitrarystyletransfer_tpu_torch.ops.kernels.adaattn_fwd import (
    adaattn_fwd_reference,
    fold_cotangents,
)
from arbitrarystyletransfer_tpu_torch.ops.stats import safe_sqrt

from test_torch_ops import assert_close


def _inputs(b, nc, ns, seed, scale=0.25, offset=0.0, spread=1.0):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, scale, (b, nc, 128)).astype(np.float32)
    k = rng.normal(0, scale, (b, ns, 128)).astype(np.float32)
    v = (offset + spread * rng.normal(0, 1, (b, ns, 128))).astype(np.float32)
    dmean, dstd = (rng.normal(0, 1, (b, nc, 128)).astype(np.float32)
                   for _ in range(2))
    return tuple(map(torch.from_numpy, (q, k, v, dmean, dstd)))


@pytest.mark.parametrize("b,nc,ns", [
    (2, 64, 64),
    (1, 100, 77),    # ragged query and style axes
    (2, 144, 144),   # the 96px training bucket's shape
])
def test_centred_twins_match_jax_vjp(b, nc, ns):
    """The centred fold and twins against JAX's ``_vjp_bwd`` (the uncentred
    fold and the Pallas backward kernels) from the same residuals."""
    q, k, v, dmean, dstd = _inputs(b, nc, ns, seed=3 * nc + ns)
    mean, std, m, l = adaattn_fwd_reference(q, k, v)
    vbar, dm1, dm2, d_row = fold_cotangents(mean, std, dmean, dstd, v)
    got = adaattn_bwd_reference(q, k, v, vbar, dm1, dm2, m, l, d_row)
    res = tuple(jnp.asarray(t.numpy()) for t in (q, k, v, mean, std, m, l))
    with pltpu.force_tpu_interpret_mode():
        ref = _vjp_bwd(res, (jnp.asarray(dmean.numpy()),
                             jnp.asarray(dstd.numpy())))
    for what, g, r in zip(("dq", "dk", "dv"), got, ref):
        # The same gradients; the sums run in other orders, and the JAX
        # chain's T - D cancels by (mean / std)^2, which is ~1-10 here.
        assert_close(g, r, 1e-5, what)


def _f64_stage(q, k, v):
    """The dense statistics in float64 (autograd), with m and l."""
    s = q.double() @ k.double().transpose(1, 2)
    attn = torch.softmax(s, dim=-1)
    mean = attn @ v.double()
    std = safe_sqrt(attn @ v.double().square() - mean.square())
    m = s.amax(dim=-1)
    l = torch.exp(s - m[..., None]).sum(dim=-1)
    return mean, std, m, l


@pytest.mark.parametrize("b,nc,ns,seed", [
    (2, 50, 37, 0),
    (1, 96, 128, 1),
    (2, 64, 100, 2),
])
def test_centring_on_ill_conditioned_values(b, nc, ns, seed):
    """v = 30 + 0.1 N(0, 1): the port's backward (T - D in float64, the
    rest in float32, on centred values) stays within f32 rounding of
    float64 autograd; JAX's (uncentred, T - D in f32) does not; and without
    the centring the port's backward, dv in float64, stays within it too."""
    q, k, v, dmean, dstd = _inputs(b, nc, ns, seed, offset=30.0, spread=0.1)
    q64, k64, v64 = (t.double().requires_grad_() for t in (q, k, v))
    mean, std, m, l = _f64_stage(q64, k64, v64)
    ratio = float((mean.square() / std.square()).max().detach())
    assert ratio >= 1e5, ratio
    ref = torch.autograd.grad(
        (mean * dmean.double()).sum() + (std * dstd.double()).sum(),
        (q64, k64, v64))
    # The residuals as the f32 forward kernel leaves them: the float64
    # statistics rounded once, m rounded and l rescaled to it.
    m32 = m.detach().float()
    l32 = (l.detach() * torch.exp(m.detach() - m32.double())).float()
    res = (mean.detach().float(), std.detach().float())

    def grads(shift):
        vbar, dm1, dm2, d_row = fold_cotangents(*res, dmean, dstd, shift)
        return adaattn_bwd_reference(q, k, v, vbar, dm1, dm2, m32, l32,
                                     d_row)

    def errors(got):
        return [float((torch.from_numpy(np.array(g)).double() - r).abs().max()
                      / r.abs().max()) for g, r in zip(got, ref)]

    centred, uncentred = errors(grads(v)), errors(grads(torch.zeros_like(v)))
    with pltpu.force_tpu_interpret_mode():
        jax_f32 = errors(_vjp_bwd(
            tuple(jnp.asarray(t.numpy()) for t in (q, k, v, *res, m32, l32)),
            (jnp.asarray(dmean.numpy()), jnp.asarray(dstd.numpy()))))
    # Centred: the f32 products and the rounding of mean and std to f32
    # (the forward's outputs, whose rounding moves mean - vbar by ~1e-6 of
    # std here); measured up to ~1e-5 of each gradient's largest value.
    assert max(centred) <= 5e-5, (centred, uncentred, jax_f32)
    # T and D each carry f32 rounding of ~eps (mean / std)^2 times their
    # difference: JAX's dq and dk land 1e-2-scale away (measured 1.4e-2 to
    # 3.2e-2).
    assert min(jax_f32[:2]) >= 1e-3, (centred, jax_f32)
    # Uncentred, dv = P^T dm1 + 2 v o (P^T dm2) cancels by |mean| / std: in
    # f32 that cost 12-26 times the centred form's error; with dv's products
    # and their sum in float64 the uncentred form stays within the same
    # bound (measured up to 1.3e-5).
    assert max(uncentred) <= 5e-5, (centred, uncentred)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dv_on_ill_conditioned_values(seed):
    """v = 30 + 0.1 N(0, 1) under a peaked softmax (logits of std ~11), so
    (mean / std)^2 >= 1e8: dv = P^T dm1 + 2 vc o (P^T dm2) cancels by up to
    |vc| / std.  The twin's dv against a float64 autograd yardstick of the
    same function on the same inputs (the f32 residuals and folded
    cotangents: the gradient in v of sum P (dm1 . vc + dm2 . vc^2) with P
    fixed) at 1e-4 of its largest value.  With dv's products and their sum
    in f32 it missed by 2.1e-4 to 1.7e-3 of it on these seeds; in float64
    it lands ~6e-8 away (P's own f32 rounding, which the cancellation does
    not amplify)."""
    q, k, v, dmean, dstd = _inputs(2, 64, 100, seed=seed, scale=1.0,
                                   offset=30.0, spread=0.1)
    mean, std, m, l = _f64_stage(q.double(), k.double(), v.double())
    live = std > 0
    assert float((mean.square() / std.square())[live].max()) >= 1e8
    m32 = m.float()
    l32 = (l * torch.exp(m - m32.double())).float()
    vbar, dm1, dm2, d_row = fold_cotangents(mean.float(), std.float(), dmean,
                                            dstd, v)
    _, dv = adaattn_dkv_reference(q, k, v, vbar, dm1, dm2, m32, l32, d_row)
    v64 = v.double().requires_grad_()
    s = q.double() @ k.double().transpose(1, 2)
    p = torch.exp(s - m32.double()[..., None]) / l32.double()[..., None]
    vc = v64 - vbar.double()[:, None, :]
    ref, = torch.autograd.grad((dm1.double() * (p @ vc)).sum()
                               + (dm2.double() * (p @ vc.square())).sum(),
                               v64)
    err = float((dv.double() - ref).abs().max() / ref.abs().max())
    assert err <= 1e-4, err


@pytest.mark.parametrize("splits", [1, 2, 3, 4, 5])
def test_split_twins_equal_unsplit(splits):
    """The twins with the reduction axis cut as the kernels' chunks (whole
    32-row tiles, ragged tails: Nc = 100 and Ns = 77 leave partial last
    tiles) and the chunk sums added in order, against the unsplit twins."""
    q, k, v, dmean, dstd = _inputs(2, 100, 77, seed=11)
    mean, std, m, l = adaattn_fwd_reference(q, k, v)
    vbar, dm1, dm2, d_row = fold_cotangents(mean, std, dmean, dstd, v)
    args = (q, k, v, vbar, dm1, dm2, m, l, d_row)
    # A grouping of the same f32 sums: within a few ulps of the largest.
    assert_close(adaattn_dq_reference(*args, splits=splits),
                 adaattn_dq_reference(*args), 2e-6, "dq")
    for what, g, r in zip(("dk", "dv"),
                          adaattn_dkv_reference(*args, splits=splits),
                          adaattn_dkv_reference(*args)):
        assert_close(g, r, 2e-6, what)


@pytest.mark.parametrize("n,splits", [(77, 1), (77, 2), (77, 3), (77, 9),
                                      (100, 4), (400, 5), (400, 13)])
def test_split_bounds_cover_the_axis(n, splits):
    """Chunks are whole 32-row tiles, in order, cover [0, n) once and are
    never empty (at most one chunk per tile)."""
    bounds = split_bounds(n, splits)
    tiles = -(-n // 32)
    assert len(bounds) == min(splits, tiles)
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    for (a, b), (c, _) in zip(bounds, bounds[1:]):
        assert b == c
    for a, b in bounds:
        assert a % 32 == 0 and b > a
