"""The f32 serving form of kernel 2 (adaattn_fwd), on the CPU.

``csrc/adaattn_fwd.cu``'s serving kernel forms the AdaAttN statistics of
f32 inputs on the tensor cores in 3xTF32; ``adaattn_serve_emulation`` is
its arithmetic in plain PyTorch (the TF32 splits, the one P of l, A v and
A vc^2, the second moment about the values' mean over the keys, the
truncating tensor-core adds, the chunks of the style axis).  Here the
emulation is held to JAX's Pallas forward (interpret mode) and to the
float64 statistics, at scale 0.3, a peaked scale, offset values, one-hot
rows and ragged axes; and ``adaattn_statistics`` is shown to pick the
serving form exactly where autograd does not record the call.  The kernel
itself is checked on the card by ``chip_smoke.py``.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from arbitrarystyletransfer_tpu.ops.pallas.adaattn_kernel import (
    _adaattn_pallas_fwd,
)

from arbitrarystyletransfer_tpu_torch.ops.kernels import LAUNCHES
from arbitrarystyletransfer_tpu_torch.ops.kernels import (
    adaattn_fwd as fwd_mod,
)
from arbitrarystyletransfer_tpu_torch.ops.kernels.adaattn_fwd import (
    F32_FORMS,
    adaattn_fwd_reference,
    adaattn_serve_emulation,
    adaattn_statistics,
    serve_splits,
    statistics_form,
)

from test_torch_ops import assert_close  # (also caps torch's threads)

CSRC = Path(fwd_mod.__file__).resolve().parents[2] / "csrc"
# Against the Pallas forward, as tests/test_torch_adaattn.py holds the f32
# twin to it (of the largest value): mean 1e-5, std 1e-4 (std = sqrt(ev2
# - mean^2) cancels, and the Pallas forward's own f32 std lies up to ~1e-5
# of its largest value from float64 in the peaked and offset cases), m
# 1e-6, l 1e-5.
PALLAS_TOL = {"mean": 1e-5, "std": 1e-4, "m": 1e-6, "l": 1e-5}
# chip_smoke.py's gates against the f32 twin: 1e-5 of the largest value
# (+ 1e-6) for mean, std and m, 1e-4 for l (a sum of up to 4096 exps in
# another order).
F32_TOL, L_TOL = 1e-5, 1e-4
# The serving form may lie at most this factor farther from the float64
# statistics than the f32 twin does, in max abs, for mean and for std.
TWIN_FACTOR = 2.0

# (label, B, Nc, Ns, q and k scale, value offset, value scale).  Logits
# have std ~128^0.5 scale^2: ~1 at 0.3, ~3.4 at 0.55 (chip_smoke.py's
# "peaked"), ~11 at 1.0, where most rows are nearly one-hot.  "offset"
# centres the values at 3 (mean / std ~ 3).  (2, 256, 512) takes two
# chunks of the style axis (serve_splits), the ragged shape one with a
# partial tile.  In F64_ONLY's cases std = sqrt(ev2 - mean^2) cancels in
# f32: the Pallas forward's own mean or std lies farther from float64 than
# PALLAS_TOL (checked), so there mean and std are held to float64 alone
# (the rule below) and only m and l to Pallas.
CASES = (
    ("scale-0.3", 2, 256, 512, 0.3, 0.0, 1.0),
    ("peaked", 2, 256, 512, 0.55, 0.0, 1.0),
    ("one-hot-ish", 2, 256, 512, 1.0, 0.0, 1.0),
    ("offset", 2, 256, 512, 0.3, 3.0, 1.0),
    ("offset-peaked", 2, 256, 512, 0.55, 3.0, 1.0),
    ("ragged", 1, 100, 77, 0.3, 0.0, 1.0),
)
F64_ONLY = ("one-hot-ish", "offset-peaked")


def _inputs(b, nc, ns, scale, offset, vscale, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, scale, (b, nc, 128))
    k = rng.normal(0, scale, (b, ns, 128))
    v = offset + vscale * rng.normal(0, 1, (b, ns, 128))
    return [x.astype(np.float32) for x in (q, k, v)]


def _one_hot(b, nc, ns, seed):
    """chip_smoke.one_hot_attention's inputs: key j the unit vector e_j,
    query i the logit 0 at its key t[i] and -256 elsewhere."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, ns, (b, nc))
    q = -256.0 * (1.0 - np.eye(128)[t])
    k = np.broadcast_to(np.eye(ns, 128), (b, ns, 128))
    v = rng.normal(0, 1, (b, ns, 128))
    return [np.ascontiguousarray(x, np.float32) for x in (q, k, v)], t


def _float64(q, k, v):
    """The statistics in float64 from the f32 inputs."""
    q, k, v = (torch.from_numpy(x).double() for x in (q, k, v))
    s = q @ k.transpose(1, 2)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    mean = (p @ v) / l
    ev2 = (p @ v.square()) / l
    return mean, torch.sqrt(torch.clamp(ev2 - mean.square(), min=0.0))


def _max_abs(a, b):
    return float((torch.as_tensor(np.array(a)).double()
                  - torch.as_tensor(np.array(b)).double()).abs().max())


@pytest.mark.parametrize("label,b,nc,ns,scale,offset,vscale", CASES,
                         ids=[c[0] for c in CASES])
def test_emulation_against_pallas_and_float64(label, b, nc, ns, scale,
                                              offset, vscale):
    q, k, v = _inputs(b, nc, ns, scale, offset, vscale, seed=nc + ns)
    emu = adaattn_serve_emulation(*map(torch.from_numpy, (q, k, v)))
    with pltpu.force_tpu_interpret_mode():
        pallas = [np.asarray(r) for r in _adaattn_pallas_fwd(
            *map(jnp.asarray, (q, k, v)))]
    exact = _float64(q, k, v)
    for what, o, r in zip(("mean", "std", "m", "l"), emu, pallas):
        if label in F64_ONLY and what in ("mean", "std"):
            continue
        assert_close(o, r, PALLAS_TOL[what], f"{label} {what}")
    own = [_max_abs(r, x) / (PALLAS_TOL[w] * float(np.abs(r).max()))
           for w, r, x in zip(("mean", "std"), pallas, exact)]
    assert (max(own) > 1.0) == (label in F64_ONLY), (label, own)
    twin = adaattn_fwd_reference(*map(torch.from_numpy, (q, k, v)))
    for what, o, t, r in zip(("mean", "std"), emu, twin, exact):
        err, own_twin = _max_abs(o, r), _max_abs(t, r)
        assert err <= TWIN_FACTOR * own_twin, (label, what, err, own_twin)


@pytest.mark.parametrize("b,nc,ns", [(2, 128, 100), (1, 64, 128)])
def test_one_hot_rows_are_exact(b, nc, ns):
    """mean = v[t], std = 0, m = 0 and l = 1 bit for bit: what the exact
    three-piece splits of v and vc^2 and the uncentred mean buy (two
    pieces leave std ~2^-11 |v| there; the mean as vbar + A vc misses v
    by an ulp).  The f32 twin is exact there too, so this is also the
    rule of at most twice its distance to float64."""
    (q, k, v), t = _one_hot(b, nc, ns, seed=b + nc)
    mean, std, m, l = adaattn_serve_emulation(
        *map(torch.from_numpy, (q, k, v)))
    want = np.take_along_axis(v, t[..., None], axis=1)
    assert torch.equal(mean, torch.from_numpy(want))
    assert bool((std == 0).all()) and bool((m == 0).all())
    assert bool((l == 1).all())


def test_style_axis_chunks():
    """``serve_splits`` at the main path's shapes: the taps and graph
    calls at 512px fill the card in one chunk; the CLI's 320px graph
    request (1 x 1600 queries, 13 CTAs) and the ragged case take several,
    each a whole number of 32-key tiles, the last holding the rest."""
    assert serve_splits(16, 4096, 4096) == (1, 4096)
    assert serve_splits(8, 4096, 4096) == (1, 4096)
    assert serve_splits(1, 1600, 1600) == (6, 288)
    assert serve_splits(2, 1000, 777) == (3, 288)
    for b, nc, ns in ((1, 1600, 1600), (2, 1000, 777), (1, 100, 77),
                      (2, 256, 512), (16, 4096, 128)):
        splits, per = serve_splits(b, nc, ns)
        assert per % 32 == 0 and (splits - 1) * per < ns <= splits * per


def test_chunks_match_one_pass():
    """The same inputs in one chunk and in the chunks of a 132-SM card:
    both within the gates of the twin (the merge scales each chunk's sums
    by exp(m_s - m), fma in chunk order)."""
    q, k, v = map(torch.from_numpy, _inputs(2, 256, 512, 0.55, 0.0, 1.0, 3))
    assert serve_splits(2, 256, 512)[0] == 2
    one = adaattn_serve_emulation(q, k, v, sms=1)
    two = adaattn_serve_emulation(q, k, v)
    twin = adaattn_fwd_reference(q, k, v)
    for a, b_, r, tol in zip(one, two, twin, (F32_TOL,) * 3 + (L_TOL,)):
        bound = tol * float(r.abs().max()) + 1e-6
        assert _max_abs(a, r) <= bound and _max_abs(b_, r) <= bound


def _calls(monkeypatch):
    """Records the ``serve`` keyword of every adaattn_fwd call."""
    seen = []
    real = fwd_mod.adaattn_fwd

    def spy(q, k, v, serve=False):
        seen.append(serve)
        return real(q, k, v, serve=serve)

    monkeypatch.setattr(fwd_mod, "adaattn_fwd", spy)
    return seen


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dispatch_by_autograd(monkeypatch, dtype):
    """``adaattn_statistics`` takes the serving form under
    ``torch.inference_mode`` and ``no_grad`` and on inputs without grad,
    and ``AdaAttnStatistics`` (the float64 form at f32, with the
    backward) where autograd records the call.  On the CPU neither form
    launches a kernel: both are the twin, and no count moves."""
    seen = _calls(monkeypatch)
    q, k, v = (torch.from_numpy(x).to(dtype)
               for x in _inputs(1, 40, 30, 0.3, 0.0, 1.0, 7))
    launches, forms = dict(LAUNCHES), dict(F32_FORMS)
    ref = adaattn_fwd_reference(q, k, v)[:2]
    with torch.inference_mode():
        assert statistics_form(q, k, v) == "serve"
        out = adaattn_statistics(q, k, v)
    with torch.no_grad():
        qg = q.clone().requires_grad_(True)
        assert statistics_form(qg, k, v) == "serve"
        adaattn_statistics(qg, k, v)
    assert statistics_form(q, k, v) == "serve"
    adaattn_statistics(q, k, v)
    assert seen == [True, True, True]
    for o, r in zip(out, ref):
        assert torch.equal(o, r)
    qg = q.clone().requires_grad_(True)
    assert statistics_form(qg, k, v) == "autograd"
    mean, std = adaattn_statistics(qg, k, v)
    assert seen == [True, True, True, False]
    assert mean.requires_grad and std.requires_grad
    (mean.float().sum() + std.float().sum()).backward()
    assert qg.grad is not None and bool(torch.isfinite(qg.grad).all())
    assert dict(LAUNCHES) == launches and dict(F32_FORMS) == forms


def test_kernel_constants_match_the_emulation():
    """The serving kernel's tile sizes and product order, read from its
    source, are the emulation's: 128 query rows and 32-key tiles per CTA
    (``SERVE_ROWS``, ``SERVE_KEYS``), logits in partials of two k8 steps,
    each 8-key step of A v and A vc^2 as P_hi x3, P_hi x2, P_lo x1, P_hi
    x1 from zero."""
    src = (CSRC / "adaattn_fwd.cu").read_text()
    sv = src[src.index("namespace sv {"):src.index("}  // namespace sv")]
    assert re.search(r"constexpr int BQ = (\d+);", sv)[1] == str(
        fwd_mod.SERVE_ROWS)
    assert re.search(r"constexpr int BK = (\d+);", sv)[1] == str(
        fwd_mod.SERVE_KEYS)
    step = sv[sv.index("void pv_step"):sv.index("void finish")]
    order = re.findall(r"mma_tf32\(d, (p[hl]), w0\[(\d)\], w1\[(\d)\]\)",
                       step)
    assert order == [("ph", "2", "2"), ("ph", "1", "1"), ("pl", "0", "0"),
                     ("ph", "0", "0")]
    assert "if ((c0 & 8) == 0)" in sv and "if (c0 & 8)" in sv
