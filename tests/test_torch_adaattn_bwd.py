"""Kernels 6 and 7 (adaattn_dq, adaattn_dkv): their plain twins against the
TPU backward kernels, and ``AdaAttnStatistics``'s gradients against JAX.

The Pallas kernels run under ``pltpu.force_tpu_interpret_mode()`` on the
CPU, as ``tests/test_torch_adaattn.py`` runs the forward.  Everything is
float32; the CUDA kernels themselves are checked on the card by
``chip_smoke.py``.  Tolerances are relative to the reference's largest
magnitude: the sums over the style and content axes run in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from arbitrarystyletransfer_tpu.ops.pallas.adaattn_kernel import (
    _adaattn_pallas_bwd,
    _adaattn_pallas_fwd,
    adaattn_statistics_pallas,
)

from arbitrarystyletransfer_tpu_torch.models.adaattn import (
    adaattn_statistics as port_dense,
)
from arbitrarystyletransfer_tpu_torch.ops.kernels import LAUNCHES
from arbitrarystyletransfer_tpu_torch.ops.kernels.adaattn_bwd import (
    adaattn_bwd_reference,
    adaattn_dkv,
    adaattn_dq,
)
from arbitrarystyletransfer_tpu_torch.ops.kernels.adaattn_fwd import (
    adaattn_fwd_reference,
    adaattn_statistics,
    fold_cotangents,
)

from test_torch_ops import assert_close


def _inputs(b, nc, ns, seed, scale=0.25):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(0, s, (b, n, 128)).astype(np.float32)
               for s, n in ((scale, nc), (scale, ns), (1.0, ns)))
    dmean, dstd = (rng.normal(0, 1, (b, nc, 128)).astype(np.float32)
                   for _ in range(2))
    return q, k, v, dmean, dstd


@pytest.mark.parametrize("b,nc,ns", [
    (2, 64, 64),
    (1, 100, 77),    # ragged query and style axes
    (2, 144, 144),   # the 96px training bucket's shape
])
def test_backward_twins_match_pallas(b, nc, ns):
    q, k, v, dmean, dstd = _inputs(b, nc, ns, seed=nc + ns)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    mean, std, m, l = adaattn_fwd_reference(tq, tk, tv)
    vbar, dm1, dm2, d_row = fold_cotangents(
        mean, std, torch.from_numpy(dmean), torch.from_numpy(dstd), tv)
    args = (tq, tk, tv, vbar, dm1, dm2, m, l, d_row)
    dq, dk, dv = adaattn_dq(*args), *adaattn_dkv(*args)
    # The centred inputs through the Pallas kernels: v - vbar for v (the
    # same gradients; tests/test_torch_adaattn_bwd_centred.py holds them
    # against the uncentred chain too).
    pallas_args = (tq, tk, tv - vbar[:, None], dm1, dm2, m, l, d_row.float())
    with pltpu.force_tpu_interpret_mode():
        ref = _adaattn_pallas_bwd(*(jnp.asarray(a.numpy())
                                    for a in pallas_args))
    for what, out, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        # Sums over up to 144 style and content positions in another order.
        assert_close(out, r, 1e-5, what)
    for out, r in zip((dq, dk, dv), adaattn_bwd_reference(*args)):
        assert torch.equal(out, r)


def _jax_grads(fn, q, k, v, wm, ws):
    def loss(q, k, v):
        mean, std = fn(q, k, v)
        return jnp.sum(mean * wm) + jnp.sum(std * ws)

    return jax.grad(loss, argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))


def _port_grads(fn, q, k, v, wm, ws):
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    mean, std = fn(tq, tk, tv)
    loss = (mean * torch.from_numpy(wm)).sum() + (std * torch.from_numpy(
        ws)).sum()
    return torch.autograd.grad(loss, (tq, tk, tv))


@pytest.mark.parametrize("b,nc,ns,clipped", [
    (2, 50, 40, False),
    (1, 30, 70, True),   # v zero in some channels: std == 0 there
])
def test_statistics_gradients_match_jax_and_dense(b, nc, ns, clipped):
    q, k, v, wm, ws = _inputs(b, nc, ns, seed=nc)
    if clipped:
        # mean = ev2 = 0: std is exactly 0 in every implementation.  (A
        # constant nonzero channel would give std = sqrt(rounding noise),
        # whose gradient dstd / (2 std) no two implementations share.)
        v[..., :16] = 0.0
    before = dict(LAUNCHES)
    grads = _port_grads(adaattn_statistics, q, k, v, wm, ws)
    assert LAUNCHES == before  # CPU tensors take the twins
    with pltpu.force_tpu_interpret_mode():
        ref = _jax_grads(adaattn_statistics_pallas, q, k, v, wm, ws)
    dense = _port_grads(port_dense, q, k, v, wm, ws)
    for what, g, r, d in zip(("dq", "dk", "dv"), grads, ref, dense):
        assert bool(torch.isfinite(g).all()), what
        # The kernel formulation and the dense autograd differ in rounding
        # (and in the D row term's re-formed second moment): 1e-4 of max.
        assert_close(g, r, 1e-4, f"{what} vs jax")
        assert_close(g, d, 1e-4, f"{what} vs dense")
    if clipped:
        _, std = adaattn_statistics(*map(torch.from_numpy, (q, k, v)))
        assert float(std[..., :16].abs().max()) == 0.0
        # The zero-gradient convention: where std was clipped to 0, its
        # cotangent reaches nothing.
        ws[..., :16] = 0.0
        for g, g0 in zip(grads, _port_grads(adaattn_statistics, q, k, v,
                                            wm, ws)):
            assert torch.equal(g, g0)


def test_forward_saved_terms_match_pallas():
    """m and l, which the backward recomputes P from, are the Pallas
    forward's (for a peaked softmax, where l ~ 1)."""
    q, k, v, _, _ = _inputs(2, 40, 90, seed=5, scale=0.6)
    _, _, m, l = adaattn_fwd_reference(*map(torch.from_numpy, (q, k, v)))
    with pltpu.force_tpu_interpret_mode():
        _, _, r_m, r_l = _adaattn_pallas_fwd(*map(jnp.asarray, (q, k, v)))
    assert_close(m, r_m, 1e-6, "m")
    assert_close(l, r_l, 1e-5, "l")
    assert float(l.min()) >= 1.0
