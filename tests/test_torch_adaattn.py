"""Kernel 2 (adaattn_fwd): its plain twin against the TPU kernel and the
dense golden, and the paired AdaAttN against JAX's.

The Pallas forward runs under ``pltpu.force_tpu_interpret_mode()`` on the
CPU.  All comparisons are float32; the CUDA kernel itself is checked on the
card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from arbitrarystyletransfer_tpu import engine as jengine
from arbitrarystyletransfer_tpu.models.adaattn import (
    adaattn_statistics as jax_dense,
)
from arbitrarystyletransfer_tpu.ops.pallas.adaattn_kernel import (
    _adaattn_pallas_fwd,
)

from arbitrarystyletransfer_tpu_torch import engine
from arbitrarystyletransfer_tpu_torch.models.adaattn import (
    adaattn_statistics as port_dense,
)
from arbitrarystyletransfer_tpu_torch.ops.kernels import LAUNCHES
from arbitrarystyletransfer_tpu_torch.ops.kernels.adaattn_fwd import (
    adaattn_fwd,
    adaattn_fwd_error_bound,
    adaattn_fwd_reference,
    adaattn_statistics,
)

from test_torch_ops import assert_close, ast_variables, to_jax, to_port


def _qkv(b, nc, ns, seed=0, scale=0.25):
    # scale 0.25: logits ~ N(0, 8), a softmax as peaked as a trained one's.
    rng = np.random.default_rng(seed)
    return [rng.normal(0, scale, (b, n, 128)).astype(np.float32)
            for n in (nc, ns, ns)]


@pytest.mark.parametrize("b,nc,ns", [
    (2, 64, 64),
    (1, 100, 77),    # ragged query and style axes
])
def test_reference_matches_pallas_and_dense(b, nc, ns):
    q, k, v = _qkv(b, nc, ns, seed=nc)
    mean, std, m, l = adaattn_fwd(*map(torch.from_numpy, (q, k, v)))
    with pltpu.force_tpu_interpret_mode():
        r_mean, r_std, r_m, r_l = _adaattn_pallas_fwd(
            *map(jnp.asarray, (q, k, v)))
    d_mean, d_std = jax_dense(*map(jnp.asarray, (q, k, v)))
    # Same f32 math, summed in another order; std cancels (ev2 ~ mean^2),
    # so it is held to max |std| instead of elementwise.
    for ref_mean, ref_std in ((r_mean, r_std), (d_mean, d_std)):
        assert_close(mean, ref_mean, 1e-5, "mean")
        assert_close(std, ref_std, 1e-4, "std")
    assert_close(m, r_m, 1e-6, "row max")
    assert_close(l, r_l, 1e-5, "row sum-exp")


def _bf16_kernel_emulation(q, k, v, bk=64, exact_square=True):
    """The bf16 kernel's arithmetic on the CPU: an online softmax over
    ``bk``-key tiles in f32, each tile's probabilities rounded to bf16 for
    the product with [v, v^2] (v^2 of a bf16 v is exact in f32, as the
    kernel's hi + lo is), the outputs rounded to bf16.  With
    ``exact_square`` off, v^2 is rounded to bf16 as well: one product over
    [v, bf16(v^2)], the design without the hi/lo split."""
    qf, kf, vf = q.float(), k.float(), v.float()
    b, nc, c = qf.shape
    m = torch.full((b, nc), -torch.inf)
    l = torch.zeros(b, nc)
    acc_m, acc_s = torch.zeros(b, nc, c), torch.zeros(b, nc, c)
    for k0 in range(0, kf.shape[1], bk):
        s = qf @ kf[:, k0:k0 + bk].transpose(1, 2)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        pb = p.bfloat16().float()
        vt = vf[:, k0:k0 + bk]
        acc_m = acc_m * corr[..., None] + pb @ vt
        v2 = vt.square() if exact_square else vt.square().bfloat16().float()
        acc_s = acc_s * corr[..., None] + pb @ v2
        m = m_new
    mean, ev2 = acc_m / l[..., None], acc_s / l[..., None]
    std = torch.sqrt(torch.clamp(ev2 - mean.square(), min=0.0))
    return mean.bfloat16(), std.bfloat16(), m, l


@pytest.mark.parametrize("b,nc,ns", [(2, 96, 128), (1, 70, 77)])
@pytest.mark.parametrize("scale", [0.3, 0.55])
def test_bf16_rounding_within_error_bound(b, nc, ns, scale):
    """``adaattn_fwd_error_bound`` holds the bf16 kernel's only new rounding
    (P to bf16, tile by tile) and its output rounding: an emulation of that
    arithmetic stays within it of the Pallas forward (f32, on the same
    bf16-valued inputs), elementwise, for a flat softmax (scale 0.3: logits
    of std ~1) and a peaked one (0.55: std ~3.4), with a ragged style tail
    (Ns = 77: one 64-key tile and 13 keys)."""
    q, k, _ = _qkv(b, nc, ns, seed=ns, scale=scale)
    v = np.random.default_rng(ns + 1).normal(0, 1, (b, ns, 128))
    q, k, v = (torch.from_numpy(a.astype(np.float32)).bfloat16()
               for a in (q, k, v))
    logits = q.float() @ k.float().transpose(1, 2)
    assert float(logits.std()) >= (3.0 if scale > 0.5 else 0.5)
    mean, std, m, l = _bf16_kernel_emulation(q, k, v)
    with pltpu.force_tpu_interpret_mode():
        r_mean, r_std, r_m, r_l = _adaattn_pallas_fwd(
            *(jnp.asarray(t.float().numpy()) for t in (q, k, v)))
    b_mean, b_std = adaattn_fwd_error_bound(q, k, v)
    for what, out, ref, bound in (("mean", mean, r_mean, b_mean),
                                  ("std", std, r_std, b_std)):
        err = (out.float() - torch.from_numpy(np.array(ref))).abs()
        assert bool((err <= bound).all()), (
            f"{what}: err/bound up to {float((err / bound).max()):.3g}")
        assert float(err.max()) > 0  # the rounding is there to bound
    assert_close(m, r_m, 1e-6, "row max")
    assert_close(l, r_l, 1e-5, "row sum-exp")


@pytest.mark.parametrize("ns", [128, 100])
def test_one_hot_attention_is_exact(ns):
    """A one-hot softmax (key j is e_j; query i has the logit 0 at its key
    t[i] and -256 elsewhere, where exp underflows to 0) has mean = v[t] and
    std = 0 exactly: the Pallas forward, the port's twin and the bf16
    kernel's emulation give exactly that (``chip_smoke.py`` holds the CUDA
    kernels to it).  With v^2 rounded to bf16 instead of fed in as hi + lo,
    std is nonzero, yet within ``adaattn_fwd_error_bound``: the bound cannot
    tell the two designs apart, and this check can.  Ns = 100 leaves a
    ragged style tail."""
    b, nc = 2, 96
    rng = np.random.default_rng(ns)
    t = rng.integers(0, ns, (b, nc))
    q = -256.0 * (1.0 - np.eye(128, dtype=np.float32)[t])
    k = np.broadcast_to(np.eye(ns, 128, dtype=np.float32), (b, ns, 128))
    q = torch.from_numpy(q).bfloat16()
    k = torch.from_numpy(k.copy()).bfloat16()
    v = torch.from_numpy(rng.normal(0, 1, (b, ns, 128)).astype(
        np.float32)).bfloat16()
    want = torch.gather(v.float(), 1, torch.from_numpy(t)[..., None].expand(
        b, nc, 128))
    with pltpu.force_tpu_interpret_mode():
        r_mean, r_std, _, r_l = _adaattn_pallas_fwd(
            *(jnp.asarray(x.float().numpy()) for x in (q, k, v)))
    outs = {"pallas": (torch.from_numpy(np.array(r_mean)),
                       torch.from_numpy(np.array(r_std))),
            "twin": adaattn_fwd(q, k, v)[:2],
            "emulation": _bf16_kernel_emulation(q, k, v)[:2]}
    for what, (mean, std) in outs.items():
        assert torch.equal(mean.float(), want), what
        assert bool((std == 0).all()), what
    np.testing.assert_array_equal(np.array(r_l), 1.0)
    mean, std, _, _ = _bf16_kernel_emulation(q, k, v, exact_square=False)
    assert torch.equal(mean.float(), want)
    assert float(std.float().max()) > 2.0 ** -5 * float(want.abs().max())
    b_mean, b_std = adaattn_fwd_error_bound(q, k, v)
    assert bool((std.float() <= b_std).all())


def test_dense_golden_matches_jax():
    q, k, v = _qkv(2, 50, 40, seed=3, scale=0.5)
    mean, std = port_dense(*map(torch.from_numpy, (q, k, v)))
    r_mean, r_std = jax_dense(*map(jnp.asarray, (q, k, v)))
    assert_close(mean, r_mean, 1e-5, "mean")
    assert_close(std, r_std, 1e-4, "std")


def test_statistics_on_cpu_launch_nothing():
    before = dict(LAUNCHES)
    q, k, v = map(torch.from_numpy, _qkv(1, 16, 16))
    mean, std = adaattn_statistics(q, k, v)
    r_mean, r_std, _, _ = adaattn_fwd_reference(q, k, v)
    assert torch.equal(mean, r_mean) and torch.equal(std, r_std)
    assert LAUNCHES == before


@pytest.mark.parametrize("use_kernel", [True, False])
def test_apply_pair_matches_jax(use_kernel):
    params = ast_variables(seed=2)["params"]
    rng = np.random.default_rng(6)
    maps = [rng.normal(0, 1, (2, 6, 5, 128)).astype(np.float32)
            for _ in range(4)]
    out = engine.adaattn_apply_pair(
        to_port(params["ada_att_1"]), to_port(params["ada_att_2"]),
        [torch.from_numpy(m) for m in maps[:2]],
        [torch.from_numpy(m) for m in maps[2:]],
        use_kernel=use_kernel, dtype=torch.float32)
    ref = jengine.adaattn_apply_pair(
        to_jax(params["ada_att_1"]), to_jax(params["ada_att_2"]),
        [jnp.asarray(m) for m in maps[:2]], [jnp.asarray(m) for m in maps[2:]],
        use_pallas=False, dtype=jnp.float32)
    for o, r in zip(out, ref):
        assert_close(o, r, 1e-4, "stylized map")
