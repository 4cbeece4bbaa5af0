"""The depthwise probes' tile schedule, against the TPU kernels.

``csrc/probe_dw.cu`` runs ``probe_dw_t`` and ``probe_dw_nhwc`` as one
schedule: persistent CTAs walk a tile list (row group fastest; 8 output
rows a tile at k5, 4 at k3), stage each
tile's halo in a ring of shared-memory slots (dw_t: 16-byte-aligned bulk
copies per input row, the circular wrap read from the staged row, or from 4
staged columns each side where W takes more than one 512-column segment;
dw_nhwc: a TMA box that fills zeros past the edges; plain loads where dw_t's
W is not a multiple of 4), and each thread reads its (RG + 2p) x (CW + 2p)
window once and sums each output's taps dj outer, di inner, one fmaf each.
None of it runs here (no GPU), so these tests emulate it in torch, tile by
tile and thread strip by thread strip, with each fmaf rounded once, and hold
the emulation against the plain twins and against the probe script's Pallas
kernels in interpret mode (``_dw_t_kernel`` with its roll shift taken mod W,
as ``tests/test_torch_probe_mega2.py`` runs it), at k3 and k5 and at sizes
that are not multiples of the tiles (th, C and W).  Tolerance: 1e-5 of the
largest value (the twin and the TPU kernels round each product and each
sum).  Against a whole-array fmaf chain in the same tap order the emulation
is exact, so the tiling changes no rounding.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arbitrarystyletransfer_tpu_torch.ops.kernels.probes import (
    probe_dw_nhwc_reference,
    probe_dw_t_reference,
)

from test_torch_ops import assert_close
from test_torch_probe_mega2 import _dw_t_kernel_mod_w, _interpret, _rand, jpm

# probe_dw.cu's schedule
NT, CW, SLOTS = 128, 4, 2
PADT = 4            # dw_t: staged columns past each side (16 bytes)
TWT = NT * CW       # dw_t: columns per tile
CB = 32             # dw_nhwc: channels per tile, one a lane
TWN = NT // 32 * CW  # dw_nhwc: columns per tile

# (th, C, W): ragged against every tile dimension.  dw_t: W % 4 == 0 takes
# the bulk copies (516: a second, 4-column segment that wraps to column 0),
# else plain loads; dw_nhwc: C a multiple of 4, not of 32.
T_CASES = [(11, 5, 516), (9, 3, 20), (13, 4, 37), (5, 2, 3)]
N_CASES = [(11, 36, 21), (13, 68, 37), (9, 4, 3)]


def fmaf(a, b, c):
    """float32 fma: the exact a * b + c rounded once (see
    test_torch_sweeps.fmaf)."""
    return (a.double() * b.double() + c.double()).float()


def rows_of(k):
    """Output rows a tile (and a thread): 8 at k5, 4 at k3."""
    return 8 if k == 5 else 4


def geometry(layout, k):
    """(p, staged rows, staged columns) of a slot."""
    p = (k - 1) // 2
    return p, rows_of(k) + 2 * p, (TWT + 2 * PADT if layout == "t"
                                   else TWN + 2 * p)


def tile_list(layout, th, c, w, k):
    """The kernel's tiles (r0, w0, c0) in order: t % ng is the row group,
    then the column segment, then the channel (dw_t) or channel block."""
    tw, rg = TWT if layout == "t" else TWN, rows_of(k)
    ng, ns = -(-th // rg), -(-w // tw)
    nc = c if layout == "t" else -(-c // CB)
    return [(t % ng * rg, t // ng % ns * tw,
             t // ng // ns * (1 if layout == "t" else CB))
            for t in range(ng * ns * nc)]


def cta_walk(n_tiles, grid):
    """CTA b's tiles b, b + grid, ..., each with its ring slot and the
    parity of that slot's fill."""
    return [[(t, i % SLOTS, (i // SLOTS) & 1)
             for i, t in enumerate(range(b, n_tiles, grid))]
            for b in range(grid)]


def whole_rows(w):
    """dw_t: a tile holds whole rows (one segment, W % 4 == 0), staged
    without the 4 columns past each side."""
    return w <= TWT and w % 4 == 0


def bulk_copies(th, c, w, k, tile):
    """dw_t's copies of a tile: (staged row, staged column, flat offset into
    x, floats) for each input row, as the first warp starts them."""
    p = (k - 1) // 2
    r0, w0, c0 = tile
    rows, tw = min(rows_of(k) + 2 * p, th + 2 * p - r0), min(TWT, w - w0)
    out = []
    for r in range(rows):
        base = ((r0 + r) * c + c0) * w
        out.append((r, PADT, base + w0, tw))
        if not whole_rows(w):
            out += [(r, 0, base + (w0 - PADT + w) % w, PADT),
                    (r, PADT + tw, base + (w0 + tw) % w, PADT)]
    return out


def stage_t(x, k, tile, bulk):
    """dw_t's slot (HR, 4 + 512 + 4) for a tile; NaN where nothing is
    written.  ``bulk``: the bulk copies (W % 4 == 0), else the plain loads'
    index, column (w0 - 4 + j) mod W, zeros past the last input row."""
    t2, c, w = x.shape
    p, hr, hc = geometry("t", k)
    r0, w0, c0 = tile
    slot = torch.full((hr, hc), float("nan"))
    if bulk:
        flat = x.reshape(-1)
        for r, j, off, n in bulk_copies(t2 - 2 * p, c, w, k, tile):
            assert off % 4 == 0 and n % 4 == 0 and j % 4 == 0  # 16 bytes
            slot[r, j:j + n] = flat[off:off + n]
        return slot
    r, j = torch.arange(hr)[:, None], torch.arange(hc)[None]
    ok = (r0 + r < t2) & (j < min(TWT, w - w0) + 2 * PADT)
    return torch.where(ok, x[(r0 + r).clamp(max=t2 - 1), c0,
                             (w0 - PADT + j) % w], 0.0)


def stage_nhwc(x, k, tile):
    """dw_nhwc's TMA box (HR, 16 + 2p, 32) at (c0, w0, r0) of the padded x,
    zeros past its edges."""
    t2, wp, c = x.shape
    p, hr, hc = geometry("nhwc", k)
    r0, w0, c0 = tile
    box = torch.zeros(hr, hc, CB)
    part = x[r0:r0 + hr, w0:w0 + hc, c0:c0 + CB]
    box[:part.shape[0], :part.shape[1], :part.shape[2]] = part
    return box


def strip_reads(slot, w):
    """(HR, NT, 12): the three float4 each dw_t thread reads per staged
    row, tile columns x0 - 4 .. x0 + 7, at staged columns x0, x0 + 4,
    x0 + 8; in a tile of whole rows the first strip reads columns
    W - 4 .. W - 1 (staged at W) and the last strip columns 0 .. 3 (staged
    at 4) instead of the pads."""
    x0 = CW * torch.arange(NT)
    at = torch.stack([x0, x0 + 4, x0 + 8], 1)
    if whole_rows(w):
        at[x0 == 0, 0] = w
        at[x0 + CW >= w, 2] = PADT
    cols = (at[:, :, None] + torch.arange(4)).reshape(NT, 12)
    return slot[:, cols]


def taps(v, wk, k):
    """Each thread's RG x CW outputs from its windows v (..., RG + 2p,
    CW + 2p), dj outer, di inner, one fmaf per tap; wk (..., k, k)."""
    rg = rows_of(k)
    o = torch.zeros(v.shape[:-2] + (rg, CW))
    for dj in range(k):
        for di in range(k):
            o = fmaf(v[..., di:di + rg, dj:dj + CW],
                     wk[..., di, dj, None, None], o)
    return o


def emulate_t(x, wd, bulk):
    """probe_dw_t as the kernel computes it."""
    t2, c, w = x.shape
    k = wd.shape[0]
    p = (k - 1) // 2
    th = t2 - 2 * p
    y = torch.full((th, c, w), float("nan"))
    rg = rows_of(k)
    for tile in tile_list("t", th, c, w, k):
        r0, w0, c0 = tile
        # thread i's window: columns 4i - p .. 4i + 3 + p of what it reads
        buf = strip_reads(stage_t(x, k, tile, bulk), w)  # (HR, NT, 12)
        v = buf[..., PADT - p:PADT - p + CW + 2 * p].permute(1, 0, 2)
        o = taps(v, wd[:, :, c0].expand(NT, k, k), k)  # (NT, RG, CW)
        rows, cols = min(rg, th - r0), min(TWT, w - w0)
        strips = o.permute(1, 0, 2).reshape(rg, NT * CW)
        y[r0:r0 + rows, c0, w0:w0 + cols] = strips[:rows, :cols]
    return y


def emulate_nhwc(x, wd):
    """probe_dw_nhwc as the kernel computes it: warp q's strip starts at
    column 4q, lane l is channel c0 + l."""
    t2, wp, c = x.shape
    k = wd.shape[0]
    p = (k - 1) // 2
    th, w = t2 - 2 * p, wp - 2 * p
    y = torch.full((th, w, c), float("nan"))
    wpad = torch.zeros(k, k, c + CB)
    wpad[:, :, :c] = wd
    rg = rows_of(k)
    for tile in tile_list("nhwc", th, c, w, k):
        r0, w0, c0 = tile
        box = stage_nhwc(x, k, tile)
        x0 = CW * torch.arange(NT // 32)
        v = box[:, x0[:, None] + torch.arange(CW + 2 * p)]  # HR, warp, j, l
        v = v.permute(1, 3, 0, 2)  # warp, lane, HR, CW + 2p
        o = taps(v, wpad[:, :, c0:c0 + CB].permute(2, 0, 1), k)
        o = o.permute(2, 0, 3, 1).reshape(rg, TWN, CB)  # rows, cols, lanes
        rows, cols, chans = min(rg, th - r0), min(TWN, w - w0), min(CB,
                                                                   c - c0)
        y[r0:r0 + rows, w0:w0 + cols, c0:c0 + chans] = o[:rows, :cols, :chans]
    return y


def fmaf_chain(x, wd, layout, di_outer=False):
    """The whole array summed with one fmaf per tap, no tiles: dj outer,
    di inner (or the other order)."""
    k = wd.shape[0]
    p = (k - 1) // 2
    th = x.shape[0] - 2 * p
    if layout == "t":
        w = x.shape[2]
        shifted = [torch.roll(x, p - dj, dims=2) for dj in range(k)]
        term = lambda di, dj: (shifted[dj][di:di + th],  # noqa: E731
                               wd[di, dj][None, :, None])
    else:
        w = x.shape[1] - 2 * p
        term = lambda di, dj: (x[di:di + th, dj:dj + w],  # noqa: E731
                               wd[di, dj])
    order = [(di, dj) for dj in range(k) for di in range(k)]
    if di_outer:
        order = [(di, dj) for di in range(k) for dj in range(k)]
    o = torch.zeros_like(term(0, 0)[0])
    for di, dj in order:
        v, wk = term(di, dj)
        o = fmaf(v, wk, o)
    return o


def inputs(layout, th, c, w, k, seed=0):
    p = (k - 1) // 2
    shape = ((th + 2 * p, c, w) if layout == "t"
             else (th + 2 * p, w + 2 * p, c))
    return torch.from_numpy(_rand(seed, *shape)), torch.from_numpy(
        _rand(seed + 1, k, k, c) / k)


def pallas(layout, x, wd):
    k = wd.shape[0]
    p = (k - 1) // 2
    th = x.shape[0] - 2 * p
    if layout == "t":
        w = x.shape[2]
        kern, out = _dw_t_kernel_mod_w, (th, x.shape[1], w)
    else:
        w = x.shape[1] - 2 * p
        kern, out = jpm._dw_nhwc_kernel, (th, w, x.shape[2])
    return _interpret(functools.partial(kern, k=k, th=th, w=w),
                      jax.ShapeDtypeStruct(out, jnp.float32),
                      jnp.asarray(x.numpy()), jnp.asarray(wd.numpy()))


# ---------------------------------------------------------------- tiles
@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("grid", [1, 7, 396])
@pytest.mark.parametrize("layout,th,c,w", [("t", *s) for s in T_CASES]
                         + [("nhwc", *s) for s in N_CASES])
def test_tile_walk_covers_every_output_once(layout, th, c, w, grid, k):
    tiles = tile_list(layout, th, c, w, k)
    tw = TWT if layout == "t" else TWN
    cb = 1 if layout == "t" else CB
    rg = rows_of(k)
    ng = -(-th // rg)
    seen = np.zeros((th, c, w), np.int64)
    walks = cta_walk(len(tiles), min(grid, len(tiles)))
    for walk in walks:
        for i, (t, slot, parity) in enumerate(walk):
            assert slot == i % SLOTS and parity == (i // SLOTS) & 1
            r0, w0, c0 = tiles[t]
            seen[r0:r0 + rg, c0:c0 + cb, w0:w0 + tw] += 1
    assert (seen == 1).all()
    # Row group fastest: a tile's row neighbour is the next tile, so the
    # two run in one wave and share their halo rows through L2.
    for t in range(len(tiles) - 1):
        if tiles[t][0] + rg < th:
            assert tiles[t + 1] == (tiles[t][0] + rg, *tiles[t][1:])
    assert sum(len(walk) for walk in walks) == len(tiles) == (
        ng * -(-w // tw) * -(-c // cb))


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("th,c,w", [(11, 5, 516), (9, 3, 20), (32, 2, 512),
                                    (5, 2, 4)])
def test_dw_t_bulk_copies_stage_the_circular_halo(th, c, w, k):
    """The 16-byte copies of each row (asserted in ``stage_t``: the
    segment, and 4 columns past each side where W takes two segments) put
    input column (w0 - 4 + j) mod W at staged column j, as the plain loads
    do; what each thread then reads is tile columns x0 - 4 .. x0 + 7 mod W,
    the wrap of a tile of whole rows read from the row itself."""
    x, _ = inputs("t", th, c, w, k)
    p = (k - 1) // 2
    for tile in tile_list("t", th, c, w, k):
        r0, w0, c0 = tile
        bulk = stage_t(x, k, tile, bulk=True)
        plain = stage_t(x, k, tile, bulk=False)
        written = ~torch.isnan(bulk)
        assert torch.equal(bulk[written], plain[written])
        tw = min(TWT, w - w0)
        rows = min(rows_of(k) + 2 * p, th + 2 * p - r0)
        side = 0 if whole_rows(w) else PADT
        assert written[:rows, PADT - side:PADT + tw + side].all()
        assert written.sum() == rows * (tw + 2 * side)
        live = CW * torch.arange(NT) < tw  # threads with outputs
        reads = strip_reads(bulk, w)[:rows, live]
        cols = (w0 + CW * torch.arange(NT)[live, None] - PADT
                + torch.arange(12)) % w
        assert torch.equal(reads, x[r0:r0 + rows, c0][:, cols])


# ---------------------------------------------------------------- outputs
@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("th,c,w", T_CASES)
def test_dw_t_emulation_matches_twin_and_pallas(th, c, w, k):
    x, wd = inputs("t", th, c, w, k)
    y = emulate_t(x, wd, bulk=w % 4 == 0)
    assert not torch.isnan(y).any()
    assert torch.equal(y, fmaf_chain(x, wd, "t"))
    assert_close(y, probe_dw_t_reference(x, wd), 1e-5, f"twin k{k}")
    assert_close(y, pallas("t", x, wd), 1e-5, f"pallas k{k}")


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("th,c,w", N_CASES)
def test_dw_nhwc_emulation_matches_twin_and_pallas(th, c, w, k):
    x, wd = inputs("nhwc", th, c, w, k)
    y = emulate_nhwc(x, wd)
    assert not torch.isnan(y).any()
    assert torch.equal(y, fmaf_chain(x, wd, "nhwc"))
    assert_close(y, probe_dw_nhwc_reference(x, wd), 1e-5, f"twin k{k}")
    assert_close(y, pallas("nhwc", x, wd), 1e-5, f"pallas k{k}")


@pytest.mark.parametrize("layout", ["t", "nhwc"])
def test_tap_order_shows_in_the_fmaf_chain(layout):
    """dj outer, di inner rounds otherwise than di outer, dj inner: the
    exact equality above would see a kernel that summed in the other
    order."""
    x, wd = inputs(layout, 9, 36, 21, 5, seed=4)
    assert not torch.equal(fmaf_chain(x, wd, layout),
                           fmaf_chain(x, wd, layout, di_outer=True))
