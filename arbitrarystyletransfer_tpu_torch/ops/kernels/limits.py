"""The block shapes the kernels' x staging takes, checked before a launch.

A pure mirror (no torch, no CUDA) of the shared-memory arithmetic of the
first sweeps: ``Smem`` and ``c_split`` of ``csrc/expand_dw.cuh``
(``expand_dw``, ``flat_block``'s and ``fused_sums``' sweep 1, NHWC x;
``mega_block``'s, (N, H, C, W) x; the f32 design ``kTf32`` on either
layout and its ``tf32_chunk``), ``Smem``, ``s2_split`` and
``s2_tf32_chunk`` of ``csrc/flat_s2.cu``, and the two designs of
``csrc/fused_2pass.cu``'s
``fused_project`` (``WsSmem``, the tile ``Smem``).  Each stages its x box
whole where it can and in channel chunks where it cannot (wider than a
TMA box, or past shared memory).  Beside them, the design that sweep 2
(``csrc/gate_project.cuh``) takes for a shape and its shared memory
(``sweep2_staging``): ``gate_project_mma`` (bf16), ``gate_project_tf32``
(f32, its ring slots from ``tf32_slots``) or the CUDA-core
``gate_project_generic``.  A wrapper calls ``check_*`` before it
launches, so a shape that a kernel cannot take raises ``ValueError``
naming the shape and the limit, not a CUDA error.  The limits are an
H100's: a TMA box has at most 256 elements along each dimension, and a
CTA at most 232,448 bytes of dynamic shared memory (the kernels read it
from the device, ``expand_dw.cuh`` ``max_smem``).  ``sweep1_design``
names the design of a sweep 1: bf16 x takes the tensor-core expand
(``mma``), f32 x the 3xTF32 one (``tf32``, its box in channel chunks;
(N, H, C, W) x at W % 8 == 0); NHWC x at C_in % 8 != 0, (N, H, C, W) x
at W % 8 != 0 (f32), an unaligned x and the expand==1 form take the
CUDA-core expand (``core``: ``mma=False``), which stages x in steps of 32
channels without a box and keeps the expand weights in f32.
``s2_sweep1_design`` does the same for ``flat_s2_block``.
``sum_tiles`` sizes the sweeps' SE partials (one row of E f32 values per
output tile, which a small kernel adds per image in a fixed order): at
least the tiles per image of every sweep-1 design of a shape.
``chip_smoke.py``'s split phase holds these numbers to what the kernels'
``*_occupancy`` entry points report on the card.
"""

from __future__ import annotations

import functools

MAX_BOX = 256          # elements along one dimension of a TMA box
SMEM_OPT_IN = 232448   # dynamic shared memory a CTA may have on an H100
CE = 32                # hidden channels per CTA
NWARPS = 8
CCH = 64               # expand_dw.cuh kCSplit's channels per box
CCH2 = 32              # flat_s2.cu's channels per split box
TH = TW = 16           # expand_dw.cuh's output tile
S2_OH, S2_OW = 8, 16   # flat_s2.cu's output tile
S2_TF_OH = 4           # its rows in the f32 3xTF32 design (OH_TF)
MAX_COUT = 128         # fused_2pass.cu's MAX_NT * 8 (the tile design)
WS_MAX_COUT = 96       # its WS_NT * 8 (the persistent design)
TP, HS_LD = 256, 40    # fused_2pass.cu's tile pixels, hidden row (bf16)
HS_F32_LD = 33         # fused_2pass.cu's f32 hidden row (CUDA-core projection)
SM_SMEM = 233472       # shared memory of an H100 SM ...
CTA_RESERVED = 1024    # ... of which the runtime keeps this much per CTA
GP_TP, GP_BOX = 128, 16384   # gate_project.cuh's TP, BOX_BYTES
GP_SLOTS, GP_YS_LD = 4, 40   # its SLOTS, YS_LD
GP_MAX_COUT = 128            # its MAX_NT * 8
GP_GTP, GP_GKC = 32, 32      # gate_project_generic's pixels, channels
# The sweep-1 designs by the value of ``*_last_sweep1``.
SWEEP1_DESIGNS = {0: "core", 1: "mma", 2: "tf32"}


def _up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def sum_tiles(h: int, w: int, stride: int = 1) -> int:
    """Rows of SE partials per image a sweep 1 of output H x W maps may
    write (``expand_dw.cuh`` ``SumsOut``; the launchers refuse more): one per
    output tile.  Stride 1: 16 x 16 tiles, whose grid the (N, H, C, W) box
    starts up to 8 columns left of the image (``XSHIFT``), so a row may hold
    one more.  Stride 2 (``flat_s2.cu``, on the H/2 x W/2 output): 8 x 16
    tiles, 4 x 16 in the f32 design; the smaller counts."""
    if stride == 1:
        return -(-h // TH) * (-(-w // TW) + 1)
    return -(-(h // 2) // S2_TF_OH) * -(-(w // 2) // S2_OW)


def _halo(k: int):
    p = (k - 1) // 2
    hh, hw = TH + 2 * p, TW + 2 * p
    return hh, hw, hh * hw


def _with_ctas(st: dict) -> dict:
    """``st`` with "ctas": the CTAs per SM its shared memory lets share an
    SM, up to the two that the kernels' ``__launch_bounds__`` ask for."""
    return dict(st, ctas=min(2, SM_SMEM // (st["smem"] + CTA_RESERVED)))


def _edw_tf32_smem(k: int, c_in: int, bch: int,
                   layout: str = "nhwc") -> dict:
    """``expand_dw.cuh`` ``Smem<K, true, true, XB>(c_in, bch)``: kTf32
    (XB 4, NHWC x: f32 words, the x box ``bch`` channels wide (+ 4)) or,
    with ``layout`` "xt", kTf32 with kXBox (XB 5: the (N, H, C, W) box,
    [halo row][bch][24] words); the weights' TF32 hi and lo parts
    [32][C_in8 + 4] each."""
    hh, hw, hp = _halo(k)
    cin8 = _up(c_in, 8)
    if layout == "xt":
        bw = _up(hw, 8)
        xs, box = hh * bch * bw * 4, (bw, bch, hh)
    else:
        ldxs = bch + 4
        xs, box = (hp + 15) // 16 * 16 * ldxs * 4, (ldxs, hw, hh)
    total = (hp * CE * 4 + xs + 2 * CE * (cin8 + 4) * 4 + NWARPS * 32 * 4
             + CE * 4 + 8 + 128)
    return _with_ctas({"smem": total, "box": box,
                       "boxes": -(-cin8 // bch), "chunk": bch})


def _s2_tf32_smem(k: int, c_in: int, bch: int) -> dict:
    """``flat_s2.cu`` ``Smem<float, K, false, false, true>(c_in, bch)``:
    the f32 expanded halo (4 x 16 outputs' input halo at stride 2), the f32
    x box ``bch`` channels wide (+ 4), the split weights."""
    p = (k - 1) // 2
    hsh, hsw = 2 * S2_TF_OH - 1 + 2 * p, 2 * S2_OW - 1 + 2 * p
    hp = hsh * hsw
    cin8, ldxs = _up(c_in, 8), bch + 4
    total = (_up(hp * CE * 4, 128) + (hp + 15) // 16 * 16 * ldxs * 4
             + 2 * CE * (cin8 + 4) * 4 + NWARPS * 32 * 4 + CE * 4 + 8 + 128)
    return _with_ctas({"smem": total, "box": (ldxs, hsw, hsh),
                       "boxes": -(-cin8 // bch), "chunk": bch})


def _tf32_fit(c_in: int, want: int, staging) -> int:
    """``expand_dw.cuh`` ``tf32_fit``: the channels per box of the fewest
    chunks with which ``want`` CTAs share an SM, or 0; ``staging(b)`` is
    the layout's dict with a box of ``b`` channels."""
    cin8 = _up(c_in, 8)
    for chunks in range(1, cin8 // 8 + 1):
        b = _up(-(-cin8 // chunks), 8)
        st = staging(b)
        if max(st["box"]) > MAX_BOX:
            continue
        t = st["smem"]
        if t <= SMEM_OPT_IN and want * (t + CTA_RESERVED) <= SM_SMEM:
            return b
    return 0


def _tf32_sized(c_in: int, staging) -> int:
    """``expand_dw.cuh`` ``tf32_sized`` on an H100: two CTAs per SM where
    that costs at most one chunk more than one CTA's fewest, else one."""
    one, two = _tf32_fit(c_in, 1, staging), _tf32_fit(c_in, 2, staging)
    cin8 = _up(c_in, 8)
    if two and -(-cin8 // two) <= (-(-cin8 // one) if one else 0) + 1:
        return two
    return one


def tf32_chunk(k: int, c_in: int, layout: str = "nhwc") -> int:
    """``expand_dw.cuh`` ``tf32_chunk`` on an H100: the channels per x box
    of the 3xTF32 design (``layout`` "nhwc" or "xt", mega_block's (N, H,
    C, W) box), sized for two CTAs per SM where that costs at most one
    chunk more than one CTA's fewest, else for one; 0 where no chunk fits
    (the shape takes the CUDA-core expand)."""
    return _tf32_sized(c_in, lambda b: _edw_tf32_smem(k, c_in, b, layout))


def s2_tf32_chunk(k: int, c_in: int) -> int:
    """``flat_s2.cu`` ``s2_tf32_chunk``: ``tf32_chunk``'s rule on the f32
    stride-2 sweep's layout."""
    return _tf32_sized(c_in, lambda b: _s2_tf32_smem(k, c_in, b))


def sweep1_design(bf16: bool, c_in: int, expand: bool = True,
                  layout: str = "nhwc", aligned: bool = True,
                  k: int = 3) -> str:
    """The design of a sweep 1 of ``expand_dw.cuh`` (``dispatch_k``):
    "mma" (bf16: the tensor-core expand; NHWC x at C_in % 8 == 0 and
    aligned, every (N, H, C, W) x), "tf32" (f32: NHWC x at C_in % 8 == 0,
    (N, H, C, W) x at W % 8 == 0 (``layout`` "xt"), aligned, within shared
    memory: ``tf32_chunk``) or "core" (the CUDA-core expand: the rest, and
    the expand==1 form)."""
    if not expand:
        return "core"
    if bf16:
        return "mma" if layout != "nhwc" or (c_in % 8 == 0 and aligned) \
            else "core"
    if layout == "xt" and aligned and tf32_chunk(k, c_in, "xt"):
        return "tf32"
    if (layout == "nhwc" and c_in % 8 == 0 and aligned
            and tf32_chunk(k, c_in)):
        return "tf32"
    return "core"


def s2_sweep1_design(bf16: bool, c_in: int, aligned: bool = True,
                     k: int = 3) -> str:
    """The design of ``flat_s2.cu``'s sweep 1 (``dispatch_k``): "mma"
    (bf16), "tf32" (f32, within shared memory: ``s2_tf32_chunk``), each at
    C_in % 8 == 0 and an aligned x; else "core"."""
    if c_in % 8 or not aligned:
        return "core"
    if bf16:
        return "mma"
    return "tf32" if s2_tf32_chunk(k, c_in) else "core"


def _edw_smem(k: int, c_in: int, xb: int, mma: bool = True,
              expand: bool = True) -> dict:
    """``expand_dw.cuh`` ``Smem<K, expand, mma, XB>(c_in)``: its bytes and
    the x box (innermost dimension first; none without ``mma``)."""
    hh, hw, hp = _halo(k)
    if not mma:  # f32 staging in the halo buffer, f32 weights [cin4][32]
        wbytes = _up(c_in, 4) * CE * 4 if expand else 0
        total = hp * CE * 4 + _up(wbytes, 16) + NWARPS * 32 * 4 + CE * 4 \
            + 8 + 128
        return {"smem": total, "box": (), "boxes": 0}
    mt = (hp + 15) // 16
    bw = _up(hw, 8)
    cin16 = _up(c_in, 16)
    bch = (_up(cin16 // 2, 16) if xb == 2 else CCH if xb == 3 else cin16)
    if xb == 2:
        cin16 = 2 * bch
    if xb == 3:
        cin16 = _up(c_in, CCH)
    ldx = cin16 + 8
    ldxs = bch + 8 if xb == 3 else ldx
    xs = hp * CE * 4
    ws = xs + (hh * bch * bw * 2 if xb in (1, 2) else mt * 16 * ldxs * 2)
    red = ws + _up(CE * ldx * 2, 16)
    total = red + NWARPS * 32 * 4 + CE * 4 + 8 + 128
    box = (bw, bch, hh) if xb in (1, 2) else (ldxs, hw, hh)
    boxes = 2 if xb == 2 else cin16 // bch if xb == 3 else 1
    return {"smem": total, "box": box, "boxes": boxes}


def sweep1_staging(k: int, c_in: int, layout: str = "nhwc",
                   mma: bool = True, expand: bool = True,
                   tf32: bool = False) -> dict:
    """How a sweep 1 of ``expand_dw.cuh`` stages x for a block of kernel
    ``k`` and ``c_in`` channels: {"smem": bytes per CTA, "box": the TMA
    box's dims, innermost first, "boxes": boxes per halo}.  ``mma``: the
    bf16 tensor-core expand (``tensor_core_expand``); without it, no box,
    any layout.  ``tf32`` (with ``mma``): the f32 3xTF32 design, x in
    ``tf32_chunk``'s chunks (and "chunk": its channels per box, "ctas": the
    CTAs per SM its shared memory allows, up to two).  ``layout`` "nhwc"
    (expand_dw, flat_block, fused_sums; the whole box unless it is wider
    than a box may be or would not fit, then kCSplit's chunks) or "xt"
    ((N, H, C, W) x at W % 8 == 0: mega_block's kXBox, halves from C_in16
    64) or "xt_rows" (W % 8 != 0: plain loads into the NHWC layout's
    buffer, no box)."""
    if k not in (3, 5):
        raise ValueError(f"kernel_size must be 3 or 5, got {k}")
    if layout not in ("nhwc", "xt", "xt_rows"):
        raise ValueError(f"unknown layout {layout!r}")
    if not mma:
        return _edw_smem(k, c_in, 0, False, expand)
    if tf32:
        if layout == "xt_rows":
            raise ValueError("the 3xTF32 sweep 1 takes NHWC x or (N, H, C, "
                             "W) x at W % 8 == 0")
        bch = tf32_chunk(k, c_in, layout)
        if not bch:
            raise ValueError(
                f"k {k}, C_in {c_in}: the 3xTF32 sweep 1 fits no x chunk "
                f"in a CTA's {SMEM_OPT_IN} bytes of shared memory")
        return _edw_tf32_smem(k, c_in, bch, layout)
    if layout == "xt":
        return _edw_smem(k, c_in, 2 if _up(c_in, 16) >= 64 else 1)
    if layout == "xt_rows":
        return dict(_edw_smem(k, c_in, 0), box=(), boxes=0)
    whole = _edw_smem(k, c_in, 0)
    if whole["box"][0] > MAX_BOX or whole["smem"] > SMEM_OPT_IN:
        return _edw_smem(k, c_in, 3)
    return whole


def _s2_smem(k: int, c_in: int, split: bool) -> dict:
    p = (k - 1) // 2
    hsh, hsw = 2 * S2_OH - 1 + 2 * p, 2 * S2_OW - 1 + 2 * p
    hp = hsh * hsw
    mt = (hp + 15) // 16
    cin16 = _up(c_in, CCH2) if split else _up(c_in, 16)
    bch = CCH2 if split else cin16
    ldx, ldxs = cin16 + 8, bch + 8
    xs = _up(hp * CE * 2, 128)
    ws = xs + mt * 16 * ldxs * 2
    prt = ws + _up(CE * ldx * 2, 16)
    red = prt + (hp * CE * 4 if split else 0)
    total = red + NWARPS * 32 * 4 + CE * 4 + 8 + 128
    return {"smem": total, "box": (ldxs, hsw, hsh), "boxes": cin16 // bch}


def flat_s2_staging(k: int, c_in: int, f32: bool = False) -> dict:
    """``flat_s2.cu`` ``Smem<bf16, K, true, SPLIT>(c_in)``: its bytes and
    its x box per tile (8 x 16 outputs, the input halo at stride 2): the
    whole box, or (``s2_split``) chunks of 32 channels with f32 partial
    sums.  ``f32``: the 3xTF32 sweep (``Smem<float, K, false, false,
    true>``), the f32 box in ``s2_tf32_chunk``'s chunks ("chunk": its
    channels per box, "ctas": the CTAs per SM its shared memory allows, up
    to two); ``ValueError`` where no chunk fits."""
    if k not in (3, 5):
        raise ValueError(f"kernel_size must be 3 or 5, got {k}")
    if f32:
        bch = s2_tf32_chunk(k, c_in)
        if not bch:
            raise ValueError(
                f"k {k}, C_in {c_in}: the f32 stride-2 sweep 1 fits no x "
                f"chunk in a CTA's {SMEM_OPT_IN} bytes of shared memory")
        return _s2_tf32_smem(k, c_in, bch)
    whole = _s2_smem(k, c_in, False)
    if whole["box"][0] > MAX_BOX or whole["smem"] > SMEM_OPT_IN:
        return _s2_smem(k, c_in, True)
    return whole


def _tile_smem(st: dict, c_out: int, pmma: bool) -> int:
    """The tile design's bytes (``fused_2pass.cu``'s tile ``Smem``) on top
    of its sweep 1's ``st``: the hidden chunk and the projection weights'
    chunk for NT * 8 outputs (NT 12 up to C_out 96, else 16), bf16 for
    PMMA, else f32 (the weights 16-byte aligned)."""
    co = WS_MAX_COUT if c_out <= WS_MAX_COUT else MAX_COUT
    if pmma:
        return st["smem"] + TP * HS_LD * 2 + co * HS_LD * 2
    return _up(st["smem"] + TP * HS_F32_LD * 4, 16) + CE * co * 4


def fused_project_staging(k: int, c_in: int, c_out: int, bf16: bool = True,
                          mma: bool = True, expand: bool = True,
                          e: int | None = None) -> dict:
    """The design ``fused_project`` takes for a block and its shared
    memory: the persistent one (bf16 with the tensor-core expand, C_out a
    multiple of 8 up to 96, the whole box, and room beside it for the
    hidden and weight slots; without ``e`` its least, else with every
    chunk's expand weights where they fit, ``ws_resident``), else the tile
    design (``fused_2pass.cu`` ``persistent_ok``, ``tile_k``).
    The tile design projects on the tensor cores (PMMA: bf16 and an even
    C_out; a bf16 hidden chunk and W_p's rows) or on the CUDA cores (f32
    hidden chunk and weights, each pixel's outputs in registers), and
    stages the tensor-core expand's box in chunks where the whole box
    cannot be one or leaves no room for those (``tile_split``)."""
    pmma = bf16 and c_out % 2 == 0
    if not mma:
        st = _edw_smem(k, c_in, 0, False, expand)
        return dict(st, smem=_tile_smem(st, c_out, pmma), design="tile")
    whole = _edw_smem(k, c_in, 0)
    fits = whole["box"][0] <= MAX_BOX and whole["smem"] <= SMEM_OPT_IN
    bar = whole["smem"] - 136  # Smem's bar offset
    persistent = (_up(bar + 8, 128) + 2 * TP * HS_LD * 2
                  + 2 * CE * c_out * 2 + 3 * 2 * 8 + 128)
    if (fits and c_out % 8 == 0 and c_out <= WS_MAX_COUT
            and persistent <= SMEM_OPT_IN):
        e32 = _up(e or 0, CE)
        resident = persistent + e32 * (_up(c_in, 16) + 8) * 2 + e32 * 4
        if e is not None and resident <= SMEM_OPT_IN:
            persistent = resident
        return dict(whole, smem=persistent, design="persistent")
    st = whole if fits and _tile_smem(whole, c_out, pmma) <= SMEM_OPT_IN \
        else _edw_smem(k, c_in, 3)
    return dict(st, smem=_tile_smem(st, c_out, pmma), design="tile")


def _tf32_smem(e: int, c_out: int, slots: int) -> int:
    """``gate_project.cuh`` ``TfSmem(e, c_out, slots).total``."""
    ep = _up(e, 32)
    return 1024 + slots * GP_BOX + _up(c_out, 8) * ep * 4 + ep * 4 \
        + 2 * GP_SLOTS * 8


def tf32_slots(e: int, c_out: int) -> int:
    """``gate_project.cuh`` ``tf32_slots`` on an H100: up to C_out 48 the
    most ring slots of 4, 3, 2 with which two CTAs share an SM, else the
    most with which one fits, else 0."""
    for slots in range(GP_SLOTS, 1, -1):
        t = _tf32_smem(e, c_out, slots)
        if (c_out <= 48 and t <= SMEM_OPT_IN
                and 2 * (t + CTA_RESERVED) <= SM_SMEM):
            return slots
    for slots in range(GP_SLOTS, 1, -1):
        if _tf32_smem(e, c_out, slots) <= SMEM_OPT_IN:
            return slots
    return 0


def mma_warps(c_out: int) -> int:
    """``gate_project.cuh`` ``mma_warps``: gate_project_mma's consumer
    warps, 8 of 16 pixels past C_out 96, else 4 of 32."""
    return 8 if c_out > WS_MAX_COUT else 4


def sweep2_staging(e: int, c_out: int, bf16: bool = True,
                   yt: bool = False) -> dict:
    """The kernel that sweep 2 (``gate_project.cuh`` ``launch``) takes for
    a hidden of E channels and C_out outputs, contiguous tensors, and its
    shared memory: {"design": "mma" (bf16, E % 8 == 0, within a CTA's
    shared memory), "tf32" (f32, E % 4 == 0, ring slots that fit) or
    "generic", "smem": bytes per CTA,
    "slots": ring slots (0 for the generic kernel)}.  The designs take an
    even C_out up to 128; ``yt``: y in (N, H, C, W) (the mega route)."""
    if c_out % 2 == 0 and c_out <= GP_MAX_COUT:
        ep = _up(e, 64)
        wbytes = (ep // 64 * 128 * 128 if c_out > WS_MAX_COUT  # wgmma's B
                  else _up(c_out, 8) * (ep + 8) * 2)
        smem = (1024 + GP_SLOTS * GP_BOX + wbytes + ep * 2
                + (mma_warps(c_out) * 8 * GP_YS_LD * 2 if yt else 0)
                + 2 * GP_SLOTS * 8)
        if bf16 and e % 8 == 0 and smem <= SMEM_OPT_IN:
            return {"design": "mma", "smem": smem, "slots": GP_SLOTS}
        slots = tf32_slots(e, c_out) if not bf16 and e % 4 == 0 else 0
        if slots:
            return {"design": "tf32", "smem": _tf32_smem(e, c_out, slots),
                    "slots": slots}
    return {"design": "generic",
            "smem": (_up(e, 4) + GP_GTP * (GP_GKC + 1) + GP_GKC * c_out) * 4,
            "slots": 0}


def tensor_core_expand(dtype_is_bf16: bool, c_in: int,
                       expand: bool = True) -> bool:
    """Whether a bf16 NHWC sweep 1 expands on the tensor cores from a TMA
    box (``expand_dw.cuh`` ``use_mma``, for the contiguous tensors the
    wrappers pass): bf16, an expand, C_in % 8 == 0.  (f32's 3xTF32 design:
    ``sweep1_design``.)"""
    return dtype_is_bf16 and expand and c_in % 8 == 0


def _refuse(name: str, shape: str, st: dict) -> None:
    if max(st["box"], default=0) > MAX_BOX:
        raise ValueError(
            f"{name}: {shape} needs an x box of {st['box']} elements, more "
            f"than a TMA box's {MAX_BOX} along one dimension")
    if st["smem"] > SMEM_OPT_IN:
        raise ValueError(
            f"{name}: {shape} needs {st['smem']} bytes of shared memory per "
            f"CTA, more than the {SMEM_OPT_IN} a CTA may have")


def check_sweep1(name: str, k: int, c_in: int, layout: str = "nhwc",
                 mma: bool = True, expand: bool = True,
                 tf32: bool = False) -> dict:
    """``sweep1_staging`` or ``ValueError`` where the kernel cannot take
    the shape (NHWC x past C_in 1856 at k5 and 2176 at k3, where the expand
    weights beside the chunks outgrow shared memory; (N, H, C, W) x past
    C_in 512; the CUDA-core expand past C_in 1404 at k5 and 1480 at k3,
    its f32 weights; the 3xTF32 design takes C_in only where
    ``tf32_chunk`` fits one, ``sweep1_design`` sends the rest to the
    CUDA-core expand)."""
    st = sweep1_staging(k, c_in, layout, mma, expand, tf32)
    kind = ("3xTF32" if tf32 else f"{layout} x") if mma \
        else "CUDA-core expand"
    _refuse(name, f"k {k}, C_in {c_in} ({kind})", st)
    return st


@functools.lru_cache(maxsize=None)
def check_sweep1_design(name: str, k: int, c_in: int, bf16: bool,
                        expand: bool = True, aligned: bool = True) -> str:
    """``check_sweep1`` of the design ``sweep1_design`` names for an NHWC
    block (the wrappers of ``expand_dw``, ``flat_block``, ``fused_sums``,
    on every launch: cached, so a shape costs its arithmetic once);
    returns the design."""
    design = sweep1_design(bf16, c_in, expand, aligned=aligned, k=k)
    check_sweep1(name, k, c_in, mma=design != "core", expand=expand,
                 tf32=design == "tf32")
    return design


def check_flat_s2(k: int, c_in: int, f32: bool = False) -> dict:
    """``flat_s2_staging`` or ``ValueError`` (bf16: C_in past 736 at k5
    and 1184 at k3, where the expand weights beside the chunks outgrow
    shared memory; f32: where ``s2_tf32_chunk`` fits none, which
    ``s2_sweep1_design`` sends to the CUDA-core expand)."""
    st = flat_s2_staging(k, c_in, f32)
    _refuse("flat_s2_block", f"k {k}, C_in {c_in}"
            + (" (3xTF32)" if f32 else ""), st)
    return st


def check_fused_project(k: int, c_in: int, c_out: int, bf16: bool = True,
                        mma: bool = True, expand: bool = True,
                        e: int | None = None) -> dict:
    """``fused_project_staging`` or ``ValueError``: C_out at most 128 (its
    projection tiles), and the design's shared memory within a CTA's (past
    the C_in that sweep 1's chunks take: ``check_sweep1``)."""
    if c_out > MAX_COUT:
        raise ValueError(f"fused_project: C_out {c_out} > {MAX_COUT}")
    st = fused_project_staging(k, c_in, c_out, bf16, mma, expand, e)
    _refuse("fused_project", f"k {k}, C_in {c_in}, C_out {c_out} "
            f"({st['design']} design)", st)
    return st
