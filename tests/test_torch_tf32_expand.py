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
d13: 16), before any run on the card.  ``mega_block``'s f32 sweep 1 (the
(N, H, C, W) box, ``expand_mtile_tf32_t``) and ``flat_s2_block``'s
(``csrc/flat_s2.cu``) take the same products and pairs in their own
chunks (``limits.tf32_chunk(..., "xt")``, ``limits.s2_tf32_chunk``):
mega's C_in 80 (d5-d7) and 96 (d3-d4), stride 2's e2 and e4.

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
# (label, C_in, E, k, layout) of the 512px decoder's blocks (NHWC: the
# flat and fused routes), mega_block's at C_in 80 and 96 ("xt": its (N,
# H, C, W) box) and the stride-2 blocks e2 and e4 ("s2": flat_s2_block).
CASES = (("d8-d9", 40, 160, 5, "nhwc"), ("d10", 40, 240, 5, "nhwc"),
         ("d11-d12", 24, 144, 3, "nhwc"), ("d13", 16, 96, 3, "nhwc"),
         ("mega-d5-d7", 80, 320, 3, "xt"), ("mega-d3-d4", 96, 384, 5, "xt"),
         ("e2", 16, 96, 3, "s2"), ("e4", 24, 144, 5, "s2"))
IDS = ["-".join(map(str, c[:4])) for c in CASES]


def _chunk(k, c_in, layout):
    """The channels per x box the kernel of ``layout`` takes."""
    if layout == "s2":
        return limits.s2_tf32_chunk(k, c_in)
    return limits.tf32_chunk(k, c_in, layout)


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


@pytest.mark.parametrize("label,c_in,e,k,layout", CASES, ids=IDS)
def test_3xtf32_expand_matches_jax_f32(label, c_in, e, k, layout):
    """Within 1e-5 of JAX's largest value, and within the f32 dot
    product's error bound of float64 wherever JAX's is."""
    x, w = _operands(c_in, e, seed=c_in + e)
    chunk = _chunk(k, c_in, layout)
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


@pytest.mark.parametrize("label,c_in,e,k,layout", CASES, ids=IDS)
def test_pairs_bring_the_expand_closer_to_float64(label, c_in, e, k, layout):
    """Partials of TF_PAIR k8 steps added to nearest lie no farther from
    float64 (max abs) than every product of a chunk accumulated in the
    tensor cores' truncating f32, and closer on average where a chunk holds
    more than one pair; the rounded split of x (``split_tf32``) no farther
    than the truncated one (``split_tf32_trunc``), and closer on
    average."""
    x, w = _operands(c_in, e, seed=c_in + e + 1)
    chunk = _chunk(k, c_in, layout)
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


def _function(src, name):
    """The text of the C++ function ``name`` of ``src``, from its name to
    the first line that closes a top-level brace."""
    m = re.search(r"\b" + name + r"\(.*?\n\}", src, re.S)
    assert m, name
    return m.group(0)


def test_the_emulation_keeps_the_kernels_arithmetic():
    """The constants and splits above are the kernels' own: TF_PAIR is
    ``expand_dw.cuh``'s, ``split_tf32`` (``common.cuh``) rounds hi on the
    bits as ``tf32_rna`` does and ``split_tf32_trunc`` masks as
    ``tf32_read`` does, x's fragments take the rounded split
    (``split_x``'s default) and the weights two rounded splits
    (``split_w``).  Every f32 sweep 1 forms its products in
    ``tf32_products`` (the NHWC box's ``expand_mtile_tf32``, which
    ``flat_s2.cu`` calls, and the (N, H, C, W) box's
    ``expand_mtile_tf32_t``, whose A values are channels ks + t and ks + t
    + 4 as ``mma_tf32`` takes them), splits its weights in
    ``stage_weights_tf32`` and sizes its chunks by ``tf32_sized``."""
    edw = (CSRC / "expand_dw.cuh").read_text()
    s2 = (CSRC / "flat_s2.cu").read_text()
    common = (CSRC / "common.cuh").read_text()
    products = _function(edw, "void tf32_products")
    assert "split_tf32(__uint_as_float(a[m]), ah[m], al[m])" in products
    assert products.count("mma_tf32(part[i], ") == 3
    for name in ("void expand_mtile_tf32", "void expand_mtile_tf32_t"):
        assert "tf32_products<NTN>(" in _function(edw, name), name
    xt = " ".join(_function(edw, "void expand_mtile_tf32_t").split())
    for a in ("a[0] = __float_as_uint(a0[ks * G::BW]);",
              "a[1] = __float_as_uint(a1[ks * G::BW]);",
              "a[2] = __float_as_uint(a0[(ks + 4) * G::BW]);",
              "a[3] = __float_as_uint(a1[(ks + 4) * G::BW]);"):
        assert a in xt, a
    assert "edw::expand_mtile_tf32<float, NTN, false, PASS>(" in s2
    assert "edw::stage_weights_tf32(" in s2
    assert "stage_weights_tf32(" in _function(edw, "void stage_weights")
    assert "return edw::tf32_sized(" in _function(s2, "int s2_tf32_chunk")
    assert "return tf32_sized(" in _function(edw, "int tf32_chunk")
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
