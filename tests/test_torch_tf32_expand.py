"""The f32 sweep 1's expand as the 3xTF32 kernel computes it, on the CPU.

``csrc/expand_dw.cuh`` expands f32 NHWC x on the tensor cores
(``expand_mtile_tf32``): each x value is split into TF32 hi and lo parts as
its fragment is loaded (``split_tf32``: hi rounded to nearest on the bits,
lo = x - hi, of which the tensor cores read the top 19 bits), the weights
once per CTA (hi and lo both rounded to nearest); each k8 step takes the
lo hi, hi lo and hi hi products (``mma.sync m16n8k8``, which adds in f32
rounding toward zero) into a partial of ``TF_PAIR`` steps from zero, and
each partial is added to the accumulator in f32 to nearest.  The x box
comes in ``limits.tf32_chunk``'s channel chunks, whose sums are added in f32
to nearest (``store_pass``).  This file emulates that arithmetic in plain
PyTorch and holds it to JAX's f32 expand (``jnp.dot(...,
preferred_element_type=jnp.float32)``, ``ops/pallas/flatblock.py``) and to
float64, at the 512px decoder's shapes (d8-d10: C_in 40, k5; d11-d12: 24;
d13: 16), before any run on the card.

Each MMA's sum is modelled as the exact sum of its products and the
accumulator, truncated to f32.  Under that model the expand cannot be as
close to float64 as a dot product rounded to nearest at every add is at
C_in 16-40 (JAX's f32 expand on the CPU lies closer in max abs); it stays
within the error bound of any f32 dot product, C_in * 2^-24 * |x| @ |w|
elementwise, as JAX's does, and within 1e-5 of JAX's largest value.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arbitrarystyletransfer_tpu_torch.ops.kernels import limits

import test_torch_ops  # noqa: F401  (caps torch's threads)

TF_PAIR = 2  # expand_dw.cuh's k8 steps per partial
MASK = -8192  # 0xffffe000 as int32: a TF32 value's bits
CSRC = Path(limits.__file__).resolve().parents[2] / "csrc"
PIXELS = 400  # one k5 halo
# (label, C_in, E, k) of the 512px decoder's blocks.
CASES = (("d8-d9", 40, 160, 5), ("d10", 40, 240, 5),
         ("d11-d12", 24, 144, 3), ("d13", 16, 96, 3))


def _bits(t):
    return t.contiguous().view(torch.int32)


def tf32_rna(t):
    """``split_tf32``'s hi: f32 rounded to TF32 on the bits (add, mask)."""
    return ((_bits(t) + 0x1000) & MASK).view(torch.float32)


def tf32_read(t):
    """What the tensor cores read of an f32 operand: its top 19 bits."""
    return (_bits(t) & MASK).view(torch.float32)


def mma_rz(acc, a, b):
    """One m16n8k8 step: acc + a @ b summed exactly (float64: the products
    of TF32 values are exact), rounded toward zero to f32."""
    exact = acc.double() + a.double() @ b.double()
    out = exact.float()
    over = out.double().abs() > exact.abs()
    return torch.where(over, torch.nextafter(out, torch.zeros_like(out)), out)


def split_x(x, rounded=True):
    """x's TF32 parts as the kernel loads them (``split_tf32``, or with
    ``rounded=False`` ``split_tf32_trunc``), lo as the tensor cores read it."""
    hi = tf32_rna(x) if rounded else tf32_read(x)
    return hi, tf32_read(x - hi)


def split_w(w):
    """The weights' TF32 parts as ``stage_weights`` stores them."""
    hi = tf32_rna(w)
    return hi, tf32_rna(w - hi)


def tf32_expand(x, w, chunk, pair=TF_PAIR, rounded=True):
    """x (P, C_in) @ w (C_in, E) as the kernel forms it: chunks of
    ``chunk`` input channels, each a sum of partials of ``pair`` k8 steps
    (three truncating MMAs per step: lo hi, hi lo, hi hi), partials and
    chunks added in f32 to nearest."""
    xh, xl = split_x(x, rounded)
    wh, wl = split_w(w)
    c_in = x.shape[1]
    out = None
    for c0 in range(0, c_in, chunk):
        acc = torch.zeros(x.shape[0], w.shape[1])
        steps = range(c0, min(c0 + chunk, c_in), 8)
        for i, k0 in enumerate(steps):
            if i % pair == 0:
                part = torch.zeros_like(acc)
            k = slice(k0, k0 + 8)
            for a, b in ((xl, wh), (xh, wl), (xh, wh)):
                part = mma_rz(part, a[:, k], b[k])
            if i % pair == pair - 1 or i == len(steps) - 1:
                acc = acc + part
        out = acc if out is None else acc + out
    return out


def _operands(c_in, e, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (PIXELS, c_in)).astype(np.float32)
    w = (rng.normal(0, 1, (c_in, e)) / np.sqrt(c_in)).astype(np.float32)
    return x, w


def _jax_expand(x, w):
    """JAX's f32 expand, (E, C_in) @ (C_in, pixels) as the flat kernel
    takes it, back to (pixels, E)."""
    out = jnp.dot(jnp.asarray(w.T), jnp.asarray(x.T),
                  preferred_element_type=jnp.float32)
    return np.asarray(out).T


def _f64(x, w):
    return x.astype(np.float64) @ w.astype(np.float64)


def _dot_bound(x, w):
    """The error bound of an f32 dot product of length C_in, elementwise."""
    return x.shape[1] * 2.0 ** -24 * (np.abs(x).astype(np.float64)
                                      @ np.abs(w).astype(np.float64))


@pytest.mark.parametrize("label,c_in,e,k", CASES)
def test_3xtf32_expand_matches_jax_f32(label, c_in, e, k):
    """Within 1e-5 of JAX's largest value, and within the f32 dot
    product's error bound of float64 wherever JAX's is."""
    x, w = _operands(c_in, e, seed=c_in + e)
    chunk = limits.tf32_chunk(k, c_in)
    assert chunk % 8 == 0 and chunk > 0
    out = tf32_expand(torch.from_numpy(x), torch.from_numpy(w),
                      chunk).numpy().astype(np.float64)
    ref = _jax_expand(x, w).astype(np.float64)
    f64, bound = _f64(x, w), _dot_bound(x, w)
    err = np.abs(out - ref).max()
    assert err <= 1e-5 * np.abs(ref).max(), f"{label}: {err:.3g} from JAX"
    assert (np.abs(ref - f64) <= bound).all(), f"{label}: JAX's f32"
    share = (np.abs(out - f64) / bound).max()
    assert share <= 1.0, f"{label}: {share:.3f} of the f32 dot bound"


@pytest.mark.parametrize("label,c_in,e,k", CASES)
def test_pairs_bring_the_expand_closer_to_float64(label, c_in, e, k):
    """Partials of TF_PAIR k8 steps added to nearest lie no farther from
    float64 (max abs) than every product of a chunk accumulated in the
    tensor cores' truncating f32, and closer on average where a chunk holds
    more than one pair; the rounded split of x (``split_tf32``) no farther
    than the truncated one (``split_tf32_trunc``), and closer on
    average."""
    x, w = _operands(c_in, e, seed=c_in + e + 1)
    chunk = limits.tf32_chunk(k, c_in)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    f64 = _f64(x, w)

    def dist(**kw):
        d = np.abs(tf32_expand(xt, wt, chunk, **kw).numpy() - f64)
        return d.max(), d.mean()

    paired, unpaired, truncated = dist(), dist(pair=c_in), dist(rounded=False)
    assert paired[0] <= unpaired[0], (paired, unpaired)
    if min(chunk, c_in) > 8 * TF_PAIR:
        assert paired[1] < unpaired[1], (paired, unpaired)
    assert paired[0] <= truncated[0] and paired[1] < truncated[1]


def test_the_split_is_exact_where_it_must_be():
    """hi + lo == x in f32 (lo = x - hi is exact), the weights' parts are
    TF32 values (the tensor cores read them whole), and x's lo loses at
    most its two lowest bits to the tensor cores' read."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(0, 3, 4096).astype(np.float32))
    hi = tf32_rna(x)
    assert torch.equal(hi + (x - hi), x)
    wh, wl = split_w(x)
    assert torch.equal(tf32_read(wh), wh) and torch.equal(tf32_read(wl), wl)
    _, lo_read = split_x(x)
    lo = (x - hi).double()
    assert ((lo - lo_read.double()).abs() <= lo.abs() * 2.0 ** -10).all()


def test_the_emulation_keeps_the_kernels_arithmetic():
    """The constants and splits above are the kernel's own: TF_PAIR is
    ``expand_dw.cuh``'s, ``split_tf32`` (``common.cuh``) rounds hi on the
    bits as ``tf32_rna`` does and ``split_tf32_trunc`` masks as
    ``tf32_read`` does, x's fragments take the rounded split
    (``split_x``'s default) and the weights two rounded splits
    (``split_w``)."""
    edw = (CSRC / "expand_dw.cuh").read_text()
    common = (CSRC / "common.cuh").read_text()
    pair = re.search(r"constexpr int TF_PAIR = (\d+);", edw)
    assert pair and int(pair.group(1)) == TF_PAIR

    def body(name):
        m = re.search(r"void " + name + r"\(float x, uint32_t& hi,.*?\n\}",
                      common, re.S)
        assert m, name
        return " ".join(m.group(0).split())

    assert MASK & 0xFFFFFFFF == 0xFFFFE000
    assert ("hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;"
            in body("split_tf32"))
    assert "hi = __float_as_uint(x) & 0xffffe000u;" in body("split_tf32_trunc")
    assert "lo = __float_as_uint(x - __uint_as_float(hi));" in body(
        "split_tf32")
    assert re.search(r"split_tf32\(__uint_as_float\(a\[m\]\), ah\[m\], "
                     r"al\[m\]\)", edw), "x's fragments"
    assert "split_tf32_trunc(" not in edw
    assert re.search(r"split_tf32\(v, hi, lo\);\s+split_tf32\("
                     r"__uint_as_float\(lo\), lo_hi, lo_lo\);", edw), \
        "the weights"
