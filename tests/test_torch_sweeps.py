"""The rounding the whole-block sweeps rely on, against the TPU kernels.

``csrc/expand_dw.cuh`` (sweep 1) tiles the image into 16x16 output tiles,
expands each tile's reflect-indexed halo, and sums each depthwise output's
k*k taps in row-major order (row di, then column dj) with one fmaf each;
``csrc/gate_project.cuh`` (sweep 2) multiplies the hidden by the rounded
gate as packed bf16 products on its A fragments.  Neither runs here (no
GPU), so these tests emulate both in torch, in float32 with each fmaf
rounded once, and hold the emulation against the Pallas kernels run in
interpret mode: ``_flat_kernel`` (``flat_expand_dw_project``) and
``_fused_kernel`` "hidden" (``fused_expand_dw``), at a ragged size
(H = W = 37: partial tiles; E = 48: a partial 32-channel chunk).
Tolerances: one bf16 ulp of the largest value for every bf16 output (each
is rounded once from f32 sums taken in another order: the TPU kernel adds
its taps column-major without fusing, so a rounding may flip); at f32 1e-5
of the largest value; the SE sums 1e-5 of the largest (f32 sums of up to
37^2 values in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arbitrarystyletransfer_tpu.ops.pallas import flatblock as jflat
from arbitrarystyletransfer_tpu.ops.pallas import fused_block as jfb
from arbitrarystyletransfer_tpu.ops.pallas import megablock as jmega

from arbitrarystyletransfer_tpu_torch.ops.basic import hardswish, se_gate
from arbitrarystyletransfer_tpu_torch.ops.kernels.flat_block import (
    flat_block_reference,
)

from test_torch_ops import assert_close

BF16_ULP = 2.0 ** -7
TILE = 16  # expand_dw.cuh's TH = TW
SIZE, E = 37, 48


def fmaf(a, b, c):
    """float32 fma: the exact a * b + c rounded once (the product of two
    f32 values is exact in float64; the sum then rounds to float64 before
    float32, which differs from one rounding only on ties of the float64
    sum, far below the tolerances here)."""
    return (a.double() * b.double() + c.double()).float()


def reflect(i, n):
    """expand_dw.cuh's reflect_idx: torch ReflectionPad, then clamped (only
    halo positions that feed dropped outputs of a partial tile clamp)."""
    i = np.abs(i)
    i = np.where(i >= n, 2 * n - 2 - i, i)
    return np.clip(i, 0, n - 1)


def emulate_sweep1(x, we, wd, k, round_ex, sum_rounded, be=None, bd=None):
    """(hidden, sums) as the new sweep 1 computes them, tile by tile: the
    expand of each tile's reflect-indexed halo in f32 (exact products of the
    I/O dtype's values, f32 sums), its bias and hswish, rounded to x's dtype
    with ``round_ex`` (the flat mode); the depthwise's taps in row-major
    order, one fmaf each; its bias and hswish; the hidden rounded to x's
    dtype; the sums of the rounded hidden with ``sum_rounded``, else of the
    f32 values."""
    dt = x.dtype
    n, h, w, _ = x.shape
    p = (k - 1) // 2
    wdf = wd.float()
    hidden = torch.empty(n, h, w, we.shape[1], dtype=dt)
    sums = torch.zeros(n, we.shape[1], dtype=torch.float64)
    for ty0 in range(0, h, TILE):
        for tx0 in range(0, w, TILE):
            rows = reflect(np.arange(ty0 - p, ty0 + TILE + p), h)
            cols = reflect(np.arange(tx0 - p, tx0 + TILE + p), w)
            halo = x[:, rows][:, :, cols].float()
            ex = halo @ we.to(dt).float()
            if be is not None:
                ex = ex + be
            ex = hardswish(ex)
            if round_ex:
                ex = ex.to(dt).float()
            acc = torch.zeros(n, TILE, TILE, ex.shape[-1])
            for di in range(k):
                for dj in range(k):
                    acc = fmaf(ex[:, di:di + TILE, dj:dj + TILE], wdf[di, dj],
                               acc)
            if bd is not None:
                acc = acc + bd
            out = hardswish(acc)[:, :h - ty0, :w - tx0]
            hv = out.to(dt)
            hidden[:, ty0:ty0 + out.shape[1], tx0:tx0 + out.shape[2]] = hv
            sums += (hv.float() if sum_rounded else out).double().sum((1, 2))
    return hidden, sums.float()


def gate_product(hidden, gate):
    """The packed bf16 product of sweep 2's A fragments:
    fma.rn.bf16x2(h, round(g), -0), the exact product rounded once."""
    g = gate.to(torch.bfloat16).double()
    return (hidden.double() * g + (-0.0)).to(torch.bfloat16)


def emulate_sweep2(hidden, sums, se, wp, pb=None, residual=None):
    """y as the new sweep 2 computes it: the gate (f32) from the exact sums,
    the gated hidden as packed bf16 products, the projection in f32 over
    the rounded operands, the bias in f32, the cast, the residual in the
    I/O dtype."""
    dt = hidden.dtype
    _, h, w, _ = hidden.shape
    gate = se_gate(sums, h * w, se)
    gated = gate_product(hidden, gate[:, None, None, :]).float()
    y = gated @ wp.to(dt).float()
    if pb is not None:
        y = y + pb
    y = y.to(dt)
    if residual is not None:
        y = (y.float() + residual.float()).to(dt)
    return y


def random_block(c_in, k, seed, bn=True):
    rng = np.random.default_rng(seed)

    def rand(*shape, scale=1.0):
        return torch.from_numpy(rng.normal(0, scale, shape).astype(np.float32))

    s = 16
    x = rand(2, SIZE, SIZE, c_in)
    we = rand(c_in, E, scale=c_in ** -0.5)
    wd = rand(k, k, E, scale=1.0 / k)
    se = {"Dense_0": {"kernel": rand(E, s, scale=E ** -0.5),
                      "bias": rand(s, scale=0.1)},
          "Dense_1": {"kernel": rand(s, E, scale=s ** -0.5),
                      "bias": 0.5 + rand(E, scale=0.1)}}
    wp = rand(E, c_in, scale=E ** -0.5)
    biases = ((rand(E, scale=0.1), rand(E, scale=0.1), rand(c_in, scale=0.1))
              if bn else (None, None, None))
    return x, we, wd, se, wp, biases


def j(t):
    if t is None:
        return None
    if isinstance(t, dict):
        return {key: j(v) for key, v in t.items()}
    return jnp.asarray(t.numpy())


CASES = [(12, 3), (12, 5), (40, 3), (40, 5)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("c_in,k", CASES)
def test_flat_emulation_matches_flat_kernel(c_in, k, dtype):
    """Sweep 1 in the flat mode (kFlat: the expanded halo rounded, the sums
    of the rounded hidden) and sweep 2, emulated, against ``_flat_kernel``
    in interpret mode: the whole block's y, with the residual."""
    tdt = getattr(torch, dtype)
    x, we, wd, se, wp, (be, bd, pb) = random_block(c_in, k, seed=c_in + k)
    x = x.to(tdt)
    hidden, sums = emulate_sweep1(x, we, wd, k, True, True, be, bd)
    if tdt == torch.bfloat16:
        y = emulate_sweep2(hidden, sums, se, wp, pb, residual=x)
    else:  # the packed product is bf16 only; at f32 the gate is f32
        gate = se_gate(sums, SIZE * SIZE, se)
        y = (hidden * gate[:, None, None, :]) @ wp + pb + x
    jdt = getattr(jnp, dtype)
    xf = jnp.asarray(x.float().numpy()).astype(jdt)
    xf = jnp.transpose(xf, (0, 3, 1, 2)).reshape(2, c_in, SIZE * SIZE)
    ref = jflat.flat_expand_dw_project(
        xf, j(we).astype(jdt), j(wd), j(se), j(wp).astype(jdt), k, SIZE,
        b_expand=j(be), b_dw=j(bd), proj_bias=j(pb), identity=True,
        interpret=True, w_dim=SIZE)
    ref = np.asarray(jnp.asarray(ref, jnp.float32)).reshape(
        2, c_in, SIZE, SIZE).transpose(0, 2, 3, 1)
    rel = BF16_ULP if tdt == torch.bfloat16 else 1e-5
    assert_close(y.float().numpy(), ref, rel, f"flat y c_in={c_in} k={k}")
    # The port's plain twin agrees with the emulation on the hidden's
    # products, so it holds the kernel to the same rounding on the card.
    twin, twin_sums = flat_block_reference(x, we, wd, se, wp, k,
                                           b_expand=be, b_dw=bd,
                                           proj_bias=pb, identity=True)
    assert_close(y.float().numpy(), twin.float().numpy(), rel, "twin y")
    assert_close(sums.numpy(), twin_sums.numpy(), 1e-5, "twin sums")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("c_in,k", CASES)
def test_fused_emulation_matches_fused_kernel(c_in, k, dtype):
    """Sweep 1 in the fused mode (kFused: the depthwise on the unrounded
    f32 expand, the sums before the hidden is rounded), emulated, against
    ``_fused_kernel`` "hidden" in interpret mode."""
    tdt = getattr(torch, dtype)
    x, we, wd, _, _, (be, bd, _) = random_block(c_in, k, seed=c_in * k)
    x = x.to(tdt)
    hidden, sums = emulate_sweep1(x, we, wd, k, False, False, be, bd)
    jdt = getattr(jnp, dtype)
    ref_h, ref_s = jfb.fused_expand_dw(
        jnp.asarray(x.float().numpy()).astype(jdt), j(we).astype(jdt),
        j(wd), k, interpret=True, b_expand=j(be), b_dw=j(bd))
    ref_h = np.asarray(jnp.asarray(ref_h, jnp.float32))[..., :E]
    rel = BF16_ULP if tdt == torch.bfloat16 else 1e-5
    assert_close(hidden.float().numpy(), ref_h, rel,
                 f"fused hidden c_in={c_in} k={k}")
    assert_close(sums.numpy(), np.asarray(ref_s)[:, :E], 1e-5, "fused sums")


def test_gate_product_equals_flatblock_rounding():
    """``round(h * round(g))`` of two bf16 values, as ``_flat_kernel``'s
    sweep 2 writes it (``hv * gate.astype(out_dtype)`` in bf16), equals the
    packed bf16 product sweep 2 runs on its A fragments (the exact product
    rounded once, plus -0) bit for bit: every bf16 gate in [0, 1] against
    hidden values of every binade the model's hswish outputs reach, signed
    zeros included.  XLA on the CPU (like the TPU) flushes subnormal bf16
    inputs and results to zero, and the card does not, so those products
    are compared with the kernel that sweep 2 replaced (the f32 product of
    the two bf16 values, exact, rounded once): bit for bit everywhere."""
    gates = torch.arange(0, 0x3F81, dtype=torch.int32).to(torch.int16).view(
        torch.bfloat16)  # every bf16 in [0, 1]
    rng = np.random.default_rng(0)
    mags = np.concatenate([2.0 ** rng.uniform(-40, 12, 250), [0.0]])
    hv = np.concatenate([mags, -mags[:120], [-0.0]]).astype(np.float32)
    h = torch.from_numpy(hv).to(torch.bfloat16)
    ours = gate_product(h[:, None], gates[None, :].float())
    ref = np.asarray(jnp.asarray(h.float().numpy(), jnp.bfloat16)[:, None]
                     * jnp.asarray(gates.float().numpy(), jnp.float32)
                     .astype(jnp.bfloat16)[None, :])
    ours_bits = ours.view(torch.int16).numpy()
    ref_bits = ref.view(np.int16)
    assert ours_bits.shape == ref_bits.shape == (h.numel(), gates.numel())
    tiny = float(torch.finfo(torch.bfloat16).tiny)
    prod = (h.double()[:, None] * gates.double()[None, :]).abs().numpy()
    normal = ((gates.float()[None, :] == 0) | (gates.float()[None, :] >= tiny)
              ).numpy() & ((prod == 0) | (prod >= tiny))
    assert normal.mean() > 0.8
    differ = (ours_bits != ref_bits) & normal
    assert not differ.any(), f"{differ.sum()} products differ"
    old = (h.float()[:, None] * gates.float()[None, :]).to(torch.bfloat16)
    assert (old.view(torch.int16).numpy() == ours_bits).all()


def test_row_major_fma_taps_are_not_the_tpu_order():
    """The new depthwise's tap order (row-major, fused) is not the TPU
    kernel's (column-major, unfused adds): on the same f32 inputs the two
    differ in the last bits, which is why the bf16 gates allow one ulp."""
    rng = np.random.default_rng(1)
    ex = torch.from_numpy(rng.normal(0, 1, (4096, 5, 5)).astype(np.float32))
    wk = torch.from_numpy(rng.normal(0, 0.2, (5, 5)).astype(np.float32))
    ours = torch.zeros(4096)
    for di in range(5):
        for dj in range(5):
            ours = fmaf(ex[:, di, dj], wk[di, dj], ours)
    tpu = None
    for dj in range(5):
        for di in range(5):
            term = ex[:, di, dj] * wk[di, dj]
            tpu = term if tpu is None else tpu + term
    diff = (ours - tpu).abs()
    assert diff.max() > 0
    assert diff.max() <= 1e-5 * ours.abs().max() + 1e-6


# -- the mega mode and the halo boxes ---------------------------------------

MEGA_W = 128  # _mega_kernel_t takes W only as a multiple of 128


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("c_in,k", CASES)
def test_mega_emulation_matches_mega_kernel(c_in, k, dtype):
    """Sweep 1 in the mega mode (kMega: the depthwise on the unrounded f32
    expand, the sums of the rounded hidden), emulated on x given as (N, H,
    C, W), and sweep 2 with the residual, against ``_mega_kernel_t``
    (``mega_expand_dw_project_t``) in interpret mode: the whole block's y,
    at H = 37 (a partial 16-row tile) and E = 48 (a partial chunk); W is
    128, the width the TPU kernel takes."""
    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(100 + c_in + k)
    _, we, wd, se, wp, (be, bd, pb) = random_block(c_in, k, seed=c_in * k + 1)
    xt = torch.from_numpy(rng.normal(0, 1, (2, SIZE, c_in, MEGA_W))
                          .astype(np.float32)).to(tdt)
    x = xt.permute(0, 1, 3, 2).contiguous()  # the emulation's NHWC view
    hidden, sums = emulate_sweep1(x, we, wd, k, False, True, be, bd)
    if tdt == torch.bfloat16:
        y = emulate_sweep2(hidden, sums, se, wp, pb, residual=x)
    else:
        gate = se_gate(sums, SIZE * MEGA_W, se)
        y = (hidden * gate[:, None, None, :]) @ wp + pb + x
    jdt = getattr(jnp, dtype)
    ref = jmega.mega_expand_dw_project_t(
        jnp.asarray(xt.float().numpy()).astype(jdt), j(we).astype(jdt),
        j(wd), j(se), j(wp).astype(jdt), k, pre_act=True, b_expand=j(be),
        b_dw=j(bd), proj_bias=j(pb), identity=True, interpret=True)
    ref = np.asarray(jnp.asarray(ref, jnp.float32)).transpose(0, 1, 3, 2)
    rel = BF16_ULP if tdt == torch.bfloat16 else 1e-5
    assert_close(y.float().numpy(), ref, rel, f"mega y c_in={c_in} k={k}")


def box_load(img, y0, x0, rows, cols):
    """A TMA box of ``rows`` x ``cols`` pixels of img (H, W, C) from image
    row y0, column x0: zeros outside the image."""
    h, w, c = img.shape
    box = np.zeros((rows, cols, c), img.dtype)
    ys, xs = np.arange(y0, y0 + rows), np.arange(x0, x0 + cols)
    iy, ix = (ys >= 0) & (ys < h), (xs >= 0) & (xs < w)
    box[np.ix_(iy, ix)] = img[np.ix_(ys[iy], xs[ix])]
    return box


def reflect_nhwc(box, p, h, w, y0, x0):
    """expand_dw.cuh's reflect_box, loop for loop, on a [pixel][ldx] box of
    hh x hw pixels seen as 16-byte vectors (8 values): the P halo rows above
    row 0 and below row h - 1 copied from their reflections, then the P
    columns left of 0 and right of w - 1, each from inside the image."""
    hh, hw, ldx = box.shape
    vpp = ldx // 8
    v = box.reshape(-1, 8)
    for idx in range(2 * p * hw * vpp):
        j, rest = divmod(idx, hw * vpp)
        y = j - p if j < p else h + (j - p)
        hr, hs = y - y0, int(reflect(y, h)) - y0
        if 0 <= hr < hh and 0 <= hs < hh:
            v[hr * hw * vpp + rest] = v[hs * hw * vpp + rest]
    for idx in range(2 * p * hh * vpp):
        j, rest = divmod(idx, hh * vpp)
        hr, q = divmod(rest, vpp)
        x = j - p if j < p else w + (j - p)
        hc, hs = x - x0, int(reflect(x, w)) - x0
        if 0 <= hc < hw and 0 <= hs < hw:
            v[(hr * hw + hc) * vpp + q] = v[(hr * hw + hs) * vpp + q]
    return box


def reflect_xt(box, p, h, w, y0, x0, hw):
    """expand_dw.cuh's wait_xt, loop for loop, on a [row][channel][BW] box
    (halo columns the first hw of BW): whole channel planes for the rows,
    then in each (row, channel) line the 2P columns' values."""
    hh, cin16, bw = box.shape
    vpr = cin16 * bw // 8
    v = box.reshape(-1, 8)
    for idx in range(2 * p * vpr):
        j, rest = divmod(idx, vpr)
        y = j - p if j < p else h + (j - p)
        hr, hs = y - y0, int(reflect(y, h)) - y0
        if 0 <= hr < hh and 0 <= hs < hh:
            v[hr * vpr + rest] = v[hs * vpr + rest]
    hc, hs = [], []
    for j in range(2 * p):
        x = j - p if j < p else w + (j - p)
        hc.append(x - x0)
        hs.append(int(reflect(x, w)) - x0)
        if not (0 <= hc[j] < hw and 0 <= hs[j] < hw):
            hc[j] = -1
    flat = box.reshape(-1)
    for row in range(hh * cin16):
        for j in range(2 * p):
            if hc[j] >= 0:
                flat[row * bw + hc[j]] = flat[row * bw + hs[j]]
    return box


# (layout, H, W): the 16x16 tiles' NHWC box, kXBox's (N, H, C, W) box of 24
# columns (H = 9: below one tile), and flat_s2.cu's stride-2 box of 8x16
# output tiles (input sizes even).
BOX_CASES = [("nhwc", 37, 37), ("nhwc", 9, 128), ("xt", 37, 37),
             ("xt", 9, 128), ("s2", 74, 74), ("s2", 10, 128)]


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("layout,h,w", BOX_CASES)
def test_box_with_reflected_edges_is_reflect_idx(layout, h, w, k):
    """A halo box loaded zero-filled outside the image, then its edge rows
    and columns copied in shared memory as the kernels do, equals the
    reflect-indexed halo the kernels used to gather (``reflect_idx``) at
    every tile origin, wherever a halo position feeds an output inside the
    image (rows and columns -P..H-1+P, -P..W-1+P); positions further out
    feed only dropped outputs.  The (N, H, C, W) box is [row][channel]
    [24 columns], of which the halo's first 16 + 2P are used; the NHWC
    boxes are [pixel][C_in16 + 8] (three channels of C_in16 = 16 real)."""
    p = (k - 1) // 2
    c, cin16 = 3, 16
    img = np.zeros((h, w, cin16), np.float32)
    img[..., :c] = np.random.default_rng(h * w + k).normal(0, 1, (h, w, c))
    if layout == "s2":
        oh, ow = 8, 16
        hh, hw = 2 * oh - 1 + 2 * p, 2 * ow - 1 + 2 * p
        origins = [(2 * oy - p, 2 * ox - p) for oy in range(0, h // 2, oh)
                   for ox in range(0, w // 2, ow)]
    else:
        # kXBox's tile grid starts at column P - 8, so that every box
        # starts at a multiple of 8 columns (16-byte aligned).
        hh = hw = TILE + 2 * p
        shift = p - 8 if layout == "xt" else 0
        origins = [(ty - p, tx - p) for ty in range(0, h, TILE)
                   for tx in range(shift, w, TILE)]
        if layout == "xt":
            assert all(x0 % 8 == 0 for _, x0 in origins)
    ys_all = np.arange(-p, h + p)
    for y0, x0 in origins:
        if layout == "xt":
            box = box_load(img, y0, x0, hh, 24).transpose(0, 2, 1).copy()
            got = reflect_xt(box, p, h, w, y0, x0, hw).transpose(0, 2, 1)
        else:
            box = np.zeros((hh, hw, cin16 + 8), np.float32)
            box[..., :cin16] = box_load(img, y0, x0, hh, hw)
            got = reflect_nhwc(box, p, h, w, y0, x0)[..., :cin16]
        got = got[:, :hw]
        ys, xs = np.arange(y0, y0 + hh), np.arange(x0, x0 + hw)
        want = img[np.ix_(reflect(ys, h), reflect(xs, w))]
        used = np.isin(ys, ys_all)[:, None] & \
            ((xs >= -p) & (xs <= w - 1 + p))[None, :]
        assert np.array_equal(got[used], want[used]), (y0, x0)
