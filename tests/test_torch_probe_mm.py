"""The product probes' schedule, against the TPU kernels.

``csrc/probe_mm.cu`` runs ``probe_mm_einsum`` and ``probe_mm_rowloop`` as
one kernel: persistent CTAs walk (row r, 64-pixel tile of W) items (einsum:
CTA b takes items b, b + grid, ... r-major; rowloop: a contiguous run of
items, row fastest within a tile), stage the weight once (one bulk copy of
the contiguous (C, E) array; where E / 8 is even its rows move to a stride
of E + 8, from the y staging tiles or, where they cannot hold it, forward
in place from the end of the weight's area), stage each item's x tile as TMA boxes of 64 pixels x kc rows of C
into a ring of slots (zeros past C and past W; two boxes where C rounded up
to 16 exceeds 256), sum each output in f32 over k-steps of 16 rows of C in
order (passes of 64 columns of E), round once to bf16 and store the [e][w]
tile as TMA boxes (two where E > 256; nothing past W).  None of it runs
here (no GPU), so these tests emulate it in torch, item by item, and hold
the emulation against the plain twin (bf16: one bf16 ulp of the largest
value, the twin summing in another order), against the probe script's
Pallas kernels in interpret mode at f32 (1e-5 of the largest value; a bf16
dot does not run there), and bit for bit against a whole-array f32 sum over
the same k-steps, so the tiling changes no rounding.  Change the constants
below with the kernel's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arbitrarystyletransfer_tpu_torch.ops.kernels.probes import (
    probe_mm_reference,
)

from test_torch_ops import assert_close
from test_torch_probe_mega2 import _interpret, _rand, jpm

# probe_mm.cu's schedule
WT = 64          # pixels an item: one 128-byte row of bf16
BOX = 256        # the most elements a TMA box dimension takes
EC = 64          # E columns an accumulator pass
MAX_SLOTS = 4    # the x ring's slots at most
NT = 128         # threads a CTA
RB = 8           # 16-byte chunks a thread holds in a batch of restage()
SMEM_MAX = 232448  # shared memory a CTA may have on an H100
STATIC = 64      # bytes of it the kernel's mbarriers take, at most
BF16_ULP = 2.0 ** -7

# (R, C, E, W): probe_mega2's two shapes at a reduced R, and shapes off the
# tiles: C not a multiple of 16, C > 256 (two x boxes), E > 256 (two y
# boxes), E / 8 even (a restaged weight) and odd, W not a multiple of 64.
DRIVER = [(2, 40, 160, 512), (2, 240, 24, 512)]
RAGGED = [(5, 17, 8, 72), (3, 300, 24, 520), (7, 40, 264, 136), (1, 1, 8, 8),
          (2, 240, 240, 64), (2, 160, 320, 64)]
SHAPES = DRIVER + RAGGED
SCHEDULES = ["einsum", "rowloop"]


def up(v, m):
    return -(-v // m) * m


def geometry(c, e):
    """The launcher's sizes: c16 = C rounded up to 16; nkb x boxes of kc
    rows of C (kc a multiple of 16, at most 256) covering kp = nkb * kc
    rows; nyb y boxes of ye rows of E (a multiple of 8, at most 256); the
    staged weight's row stride ld."""
    c16 = up(c, 16)
    nkb = -(-c16 // BOX)
    kc = up(-(-c16 // nkb), 16)
    nyb = -(-e // BOX)
    ye = up(-(-e // nyb), 8)
    ld = e if (e // 8) % 2 else e + 8
    return dict(c16=c16, nkb=nkb, kc=kc, kp=nkb * kc, nyb=nyb, ye=ye, ld=ld)


def item_of(schedule, t, r, ntw):
    """Item t's (row, first pixel): rowloop row fastest, einsum tile
    fastest."""
    if schedule == "rowloop":
        return t % r, t // r * WT
    return t // ntw, t % ntw * WT


def cta_items(schedule, items, grid, b):
    """CTA b's items in the order it walks them."""
    if schedule == "rowloop":
        return list(range(b * items // grid, (b + 1) * items // grid))
    return list(range(b, items, grid))


def ring_slots(items, grid):
    """The ring's depth where it fits: the most items a CTA walks."""
    return min(MAX_SLOTS, -(-items // grid))


def x_boxes(x, r, w0, g):
    """The TMA boxes of item (r, w0): (first row of C, the box), each kc
    rows x 64 pixels of x[r], zeros past C and past W."""
    c, w = x.shape[1], x.shape[2]
    out = []
    for kb in range(g["nkb"]):
        c0 = kb * g["kc"]
        box = torch.zeros(g["kc"], WT, dtype=x.dtype)
        part = x[r, c0:min(c0 + g["kc"], c), w0:min(w0 + WT, w)]
        box[:part.shape[0], :part.shape[1]] = part
        out.append((c0, box))
    return out


def stage_x(x, r, w0, g):
    """The x tile (kp, 64) as the boxes land, one after another."""
    return torch.cat([box for _, box in x_boxes(x, r, w0, g)])


def stage_weight(wt, g):
    """ws[c16][ld]: the bulk copy's rows c < C at stride ld, zero rows C ..
    c16 - 1 (the columns E .. ld - 1 are never read: zeros here)."""
    c, e = wt.shape
    ws = torch.zeros(g["c16"], g["ld"], dtype=wt.dtype)
    ws[:c, :e] = wt
    return ws


def smem_bytes(c, e, slots=1, yslots=2):
    """Shared memory a CTA takes: the weight [c16][ld] rounded up to 1024
    bytes, the x ring's slots of kp rows, the y staging slots of nyb * ye
    rows (rows of 128 bytes), 1024 bytes of alignment slack."""
    g = geometry(c, e)
    return (up(g["c16"] * g["ld"] * 2, 1024)
            + (slots * g["kp"] + yslots * g["nyb"] * g["ye"]) * 2 * WT + 1024)


def first_design_smem(c, e):
    """Shared memory a CTA of the products' first design took: the weight
    at a row stride of E + 8 (E + 16 where that has an even count of
    16-byte chunks), two x tiles and one y tile at rows of 72 bf16."""
    ld = e + 8 if (e // 8 + 1) % 2 else e + 16
    return (up(c, 16) * ld + 2 * up(c, 16) * 72 + e * 72) * 2


def lands_in_place(c, e, g, yslots=2):
    """Whether the weight's bulk copy lands in its own area and moves in
    place: E / 8 even and the y staging tiles too small to hold it."""
    return g["ld"] != e and c * e > yslots * g["nyb"] * g["ye"] * WT


def restage(wt, g):
    """The weight's area [c16 * ld] after restage() where the rows move in
    place: the bulk copy lands the packed (C, E) rows at the area's end, and
    chunk q
    (8 elements) of row c moves to 8 q + 8 c, in batches of RB * NT chunks,
    each read whole before any of it is written; then rows C .. c16 - 1 are
    zeroed.  Asserts that no write reaches a chunk not yet read."""
    c, e = wt.shape
    area = torch.full((g["c16"] * g["ld"],), float("nan"), dtype=wt.dtype)
    land = 0 if g["ld"] == e else g["c16"] * g["ld"] - c * e
    area[land:land + c * e] = wt.reshape(-1)
    if g["ld"] != e:
        n, per_row = c * e // 8, e // 8
        for q0 in range(0, n, RB * NT):
            q1 = min(n, q0 + RB * NT)
            held = [area[land + 8 * q:land + 8 * q + 8].clone()
                    for q in range(q0, q1)]
            unread = land + 8 * q1  # chunks q1 .. n - 1 lie past here
            for q, v in zip(range(q0, q1), held):
                at = q // per_row * g["ld"] + q % per_row * 8
                assert q1 == n or at + 8 <= unread
                area[at:at + 8] = v
    area[c * g["ld"]:] = 0
    return area.reshape(g["c16"], g["ld"])


def kstep(acc, a, b):
    """One mma k-step: the 16 products, exact, summed and added to the f32
    sums, rounded once to f32."""
    return (acc.double() + a.double() @ b.double()).float()


def product(xt, ws, e, g):
    """The item's y tile [e][w] (E, 64) in xt's dtype: passes of EC columns,
    f32 sums over k-steps of 16 rows of C in order."""
    out = []
    for e0 in range(0, e, EC):
        n = min(EC, e - e0)
        acc = torch.zeros(WT, n)
        for k in range(0, g["c16"], 16):
            acc = kstep(acc, xt[k:k + 16].T, ws[k:k + 16, e0:e0 + n])
        out.append(acc.T)
    return torch.cat(out).to(xt.dtype)


def y_boxes(tile, w0, w, g):
    """The TMA stores of a y tile: (first row of E, first pixel, the part
    that lands), the rows past E and the pixels past W dropped."""
    e = tile.shape[0]
    out = []
    for yb in range(g["nyb"]):
        e0 = yb * g["ye"]
        out.append((e0, w0, tile[e0:min(e0 + g["ye"], e), :max(0, w - w0)]))
    return out


def emulate(schedule, x, wt, grid):
    """probe_mm as the kernel computes it with ``grid`` CTAs; asserts that
    each item finds its own tile in its ring slot at the parity it waits
    for, and that each output is stored once."""
    r, c, w = x.shape
    e = wt.shape[1]
    g = geometry(c, e)
    ntw = -(-w // WT)
    items = r * ntw
    grid = min(grid, items)
    slots = ring_slots(items, grid)
    ws = stage_weight(wt, g)
    y = torch.full((r, e, w), float("nan"), dtype=x.dtype)
    stores = torch.zeros((r, e, w), dtype=torch.int64)
    for b in range(grid):
        its = cta_items(schedule, items, grid, b)
        ring, fills = [None] * slots, [0] * slots

        def issue(i):
            ring[i % slots] = its[i]
            fills[i % slots] += 1

        for i in range(min(slots, len(its))):
            issue(i)
        for i, t in enumerate(its):
            s = i % slots
            assert ring[s] == t and (fills[s] - 1) & 1 == (i // slots) & 1
            row, w0 = item_of(schedule, t, r, ntw)
            tile = product(stage_x(x, row, w0, g), ws, e, g)
            for e0, p0, part in y_boxes(tile, w0, w, g):
                rows, cols = part.shape
                y[row, e0:e0 + rows, p0:p0 + cols] = part
                stores[row, e0:e0 + rows, p0:p0 + cols] += 1
            if i + slots < len(its):
                issue(i + slots)  # after the item's product: its slot
    assert (stores == 1).all()
    return y


def kstep_chain(x, wt):
    """The whole array summed in f32 over the same k-steps, no tiles."""
    r, c, w = x.shape
    e = wt.shape[1]
    c16 = up(c, 16)
    xp = torch.zeros(r, c16, w, dtype=x.dtype)
    xp[:, :c] = x
    wp = torch.zeros(c16, e, dtype=wt.dtype)
    wp[:c] = wt
    acc = torch.zeros(r, w, e)
    for k in range(0, c16, 16):
        acc = kstep(acc, xp[:, k:k + 16].transpose(1, 2), wp[k:k + 16])
    return acc.transpose(1, 2).to(x.dtype)


def inputs(r, c, e, w, dtype=torch.bfloat16, seed=0):
    x = torch.from_numpy(_rand(seed, r, c, w)).to(dtype)
    wt = torch.from_numpy(_rand(seed + 1, c, e) / np.sqrt(c)).to(dtype)
    return x, wt


def pallas(schedule, x, wt):
    r, c, w = x.shape
    e = wt.shape[1]
    kern = (jpm._einsum_kernel if schedule == "einsum"
            else functools.partial(jpm._rowloop_kernel, th=r))
    return _interpret(kern, jax.ShapeDtypeStruct((r, e, w), jnp.float32),
                      jnp.asarray(x.numpy()), jnp.asarray(wt.numpy()))


# ---------------------------------------------------------------- items
@pytest.mark.parametrize("grid", [1, 7, 132, 396])
@pytest.mark.parametrize("r,c,e,w", SHAPES)
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_item_lists_cover_every_tile_once(schedule, r, c, e, w, grid):
    ntw = -(-w // WT)
    items = r * ntw
    grid = min(grid, items)
    seen = np.zeros((r, ntw), np.int64)
    walks = [cta_items(schedule, items, grid, b) for b in range(grid)]
    for walk in walks:
        assert walk  # no CTA idles: the grid never exceeds the items
        for t in walk:
            row, w0 = item_of(schedule, t, r, ntw)
            seen[row, w0 // WT] += 1
        if schedule == "rowloop":
            # Consecutive rows of one tile, but where a run crosses tiles.
            for t0, t1 in zip(walk, walk[1:]):
                r0, p0 = item_of(schedule, t0, r, ntw)
                r1, p1 = item_of(schedule, t1, r, ntw)
                want = (r0 + 1, p0) if r0 + 1 < r else (0, p0 + WT)
                assert (r1, p1) == want
    assert (seen == 1).all()
    # The walks differ in length by at most one item (the ring's depth).
    lengths = [len(walk) for walk in walks]
    assert max(lengths) - min(lengths) <= 1
    assert max(lengths) == -(-items // grid)


@pytest.mark.parametrize("grid", [1, 3, 132])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_ring_holds_each_item_at_its_parity(schedule, grid):
    """More items than slots: each wait finds its own tile, a slot refilled
    only after its item's product (asserted in ``emulate``)."""
    x, wt = inputs(9, 24, 8, 200)  # 36 items: 36 or 12 a CTA, or 1
    y = emulate(schedule, x, wt, grid)
    assert not torch.isnan(y.float()).any()


# ---------------------------------------------------------------- boxes
@pytest.mark.parametrize("r,c,e,w", SHAPES)
def test_x_boxes_fill_zeros_past_c_and_w(r, c, e, w):
    """The TMA boxes of every item: kc a multiple of 16 within the 256 a
    box dimension takes, two boxes where C rounded up to 16 exceeds 256;
    rows past C and pixels past W are zeros, never the next row's data."""
    x, _ = inputs(r, c, e, w)
    x = x + 1  # no zeros of its own
    g = geometry(c, e)
    assert g["kc"] % 16 == 0 and g["kc"] <= BOX and g["kp"] >= g["c16"]
    assert g["nkb"] == (2 if up(c, 16) > BOX else 1)
    for row in range(r):
        for w0 in range(0, w, WT):
            tile = stage_x(x, row, w0, g)
            assert tile.shape == (g["kp"], WT)  # kp x 128 bytes: expect_tx
            cols = min(WT, w - w0)
            assert torch.equal(tile[:c, :cols], x[row, :, w0:w0 + cols])
            assert (tile[c:] == 0).all() and (tile[:, cols:] == 0).all()


@pytest.mark.parametrize("r,c,e,w", SHAPES)
def test_y_boxes_drop_past_w_and_split_e(r, c, e, w):
    """The y stores: ye a multiple of 8 within 256, two boxes where E
    exceeds 256, covering E once; nothing lands past W."""
    g = geometry(c, e)
    assert g["ye"] % 8 == 0 and g["ye"] <= BOX
    assert g["nyb"] == (2 if e > BOX else 1)
    assert g["nyb"] * g["ye"] >= e > (g["nyb"] - 1) * g["ye"]
    tile = torch.arange(e * WT, dtype=torch.float32).reshape(e, WT)
    for w0 in range(0, w, WT):
        rows = 0
        for e0, p0, part in y_boxes(tile, w0, w, g):
            assert e0 == rows and p0 == w0
            assert part.shape[1] == min(WT, w - w0) and p0 + part.shape[1] <= w
            assert torch.equal(part, tile[e0:e0 + part.shape[0],
                                          :part.shape[1]])
            rows += part.shape[0]
        assert rows == e


@pytest.mark.parametrize("e", [8, 24, 160, 264, 800])
def test_staged_rows_fall_in_distinct_banks(e):
    """An ldmatrix reads 8 rows of 16 bytes: the weight's rows at stride ld
    (E, or E + 8 where E / 8 is even) and the swizzled x and y rows (chunk
    q stored at q ^ (row % 8)) fall in 8 distinct 16-byte bank groups."""
    ld = geometry(1, e)["ld"]
    assert (ld // 8) % 2 == 1 and ld - e in (0, 8)
    for c0 in range(0, 16, 8):
        groups = {((c0 + i) * ld * 2 // 16) % 8 for i in range(8)}
        assert len(groups) == 8
    for q in range(8):
        assert len({(q ^ (row % 8)) for row in range(8)}) == 8


@pytest.mark.parametrize("c,e", [(40, 160), (240, 240), (160, 320),
                                 (1, 16), (300, 272), (64, 64), (17, 8)])
def test_weight_moves_in_place_to_its_stride(c, e):
    """The weight landed packed and moved forward to stride ld in place
    holds the staged layout (rows < C at stride ld, zero rows C .. c16 - 1)
    and never overwrites a chunk before it is read."""
    x = torch.from_numpy(_rand(7, c, e)).to(torch.bfloat16) + 2
    g = geometry(c, e)
    area = restage(x, g)
    assert torch.equal(area[:, :e], stage_weight(x, g)[:, :e])


def test_only_weights_the_y_tiles_cannot_hold_move_in_place():
    """probe_mega2's C 40, E 160 weight lands in the y staging tiles; the
    (240, 240) and (160, 320) weights, which they cannot hold, in place; an
    odd E / 8 lands where it stays."""
    assert not lands_in_place(40, 160, geometry(40, 160))
    assert lands_in_place(240, 240, geometry(240, 240))
    assert lands_in_place(160, 320, geometry(160, 320))
    assert not lands_in_place(240, 24, geometry(240, 24))


def test_shared_memory_takes_every_shape_the_first_design_took():
    """Every (C, E) whose first design fit in a CTA's shared memory fits
    with one ring slot and, failing two, one y staging slot; the weight
    takes no more than its staged rows."""
    for c in list(range(1, 600)) + list(range(600, 1500, 7)):
        for e in range(8, 1700, 8):
            if first_design_smem(c, e) > SMEM_MAX:
                continue
            assert min(smem_bytes(c, e), smem_bytes(c, e, yslots=1)) \
                <= SMEM_MAX - STATIC, (c, e)
    assert smem_bytes(240, 240) < first_design_smem(240, 240)
    assert smem_bytes(160, 320, yslots=1) < first_design_smem(160, 320)


# ---------------------------------------------------------------- outputs
@pytest.mark.parametrize("r,c,e,w", SHAPES)
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_emulation_bf16_matches_twin_and_kstep_chain(schedule, r, c, e, w):
    x, wt = inputs(r, c, e, w)
    y = emulate(schedule, x, wt, 132)
    assert y.dtype == torch.bfloat16 and not torch.isnan(y.float()).any()
    assert torch.equal(y, kstep_chain(x, wt))
    assert_close(y.float(), probe_mm_reference(x, wt).float(), BF16_ULP,
                 f"{schedule} bf16 twin")


@pytest.mark.parametrize("r,c,e,w", SHAPES)
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_emulation_f32_matches_twin_and_pallas(schedule, r, c, e, w):
    x, wt = inputs(r, c, e, w, torch.float32, seed=3)
    y = emulate(schedule, x, wt, 7)
    assert_close(y, probe_mm_reference(x, wt), 1e-5, f"{schedule} f32 twin")
    assert_close(y, pallas(schedule, x, wt), 1e-5, f"{schedule} f32 pallas")


def test_kstep_order_shows_in_the_chain():
    """Summing the k-steps in f32 rounds otherwise than one f32 rounding of
    the exact sum, so the exact equality above would see a kernel that
    summed its k-steps otherwise."""
    x, wt = inputs(2, 240, 24, 64, seed=5)
    x, wt = x.float(), wt.float()  # bf16 values: exact products
    whole = torch.einsum("rcw,ce->rew", x.double(), wt.double()).float()
    assert not torch.equal(kstep_chain(x, wt), whole)
