"""Design probes of the card: copy, in-kernel product, depthwise layout and
issue rate, each a CUDA kernel beside its plain PyTorch twin.

They replace the TPU probes of the repository's ``scripts/``:

- ``probe_copy`` (``csrc/probe_copy.cu``): ``probe_mega2.py:47
  _copy_kernel``, a (B, H, C, W) copy through a ring of on-chip slots;
- ``probe_mm_einsum``, ``probe_mm_rowloop`` (``csrc/probe_mm.cu``):
  ``probe_mega2.py:111 _einsum_kernel`` and ``:118 _rowloop_kernel``,
  y[r, e, w] = sum_c x[r, c, w] w[c, e] with f32 accumulation, two schedules
  of one kernel: persistent CTAs, as many as the runtime's occupancy allows,
  walk (row, 64-pixel tile) items (einsum: spread across the card; rowloop:
  consecutive rows of one tile), the weight staged once per CTA by one bulk
  copy, x by TMA boxes issued ahead into a ring, the product on the tensor
  cores, y by TMA stores, each launch a programmatic dependent of the
  previous kernel.  ``probe_mm_cut`` times the schedule with its product or
  its asynchronous staging cut out, ``probe_mm_occupancy`` reports what a
  shape launches;
- ``probe_dw_t``, ``probe_dw_nhwc`` (``csrc/probe_dw.cu``):
  ``probe_mega2.py:152 _dw_t_kernel`` (channel-planar, circular in W) and
  ``:165 _dw_nhwc_kernel`` (NHWC, valid over a pre-padded input), f32, on
  one schedule that differs in the layout alone: persistent CTAs stage
  each tile's halo asynchronously into a two-slot ring in shared memory
  (dw_t: bulk copies of whole rows, the circular wrap an index; dw_nhwc: a
  TMA box) and each thread reads its window once into registers.
  ``probe_dw_cut`` times the schedule with its FMAs or its asynchronous
  staging cut out, ``probe_dw_occupancy`` reports what a shape launches;
- ``probe_rate`` (``csrc/probe_rate.cu``): ``probe_vpu_rate.py:70 kernel``,
  ``reps`` elementwise ops as ``par`` accumulator chains, the whole tile out.

A CPU tensor takes the twin (``*_reference``); a CUDA tensor launches the
kernel or raises.  The drivers that time them are
``arbitrarystyletransfer_tpu_torch.scripts.probe_mega2`` and
``...scripts.probe_vpu_rate``.
"""

from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES
from ._build import check, launch_stream, load_library

# The depthwise kernels' layouts and the parts ``probe_dw_cut`` can cut out:
# "fma" (y is the centre tap: the staging and the stores alone) and "async"
# (each tile staged by plain loads instead of the ring's copies).
# The product kernels' schedules and the parts ``probe_mm_cut`` can cut out:
# "mma" (y = 0: the staging and the stores alone) and "async" (x and the
# weight staged by plain loads instead of TMA boxes and a bulk copy).
MM_SCHEDULES = ("probe_mm_einsum", "probe_mm_rowloop")
MM_CUTS = ("none", "mma", "async")
DW_LAYOUTS = ("probe_dw_t", "probe_dw_nhwc")
DW_CUTS = ("none", "fma", "async")
RATE_OPS = ("fma", "roll", "select", "hswish", "cast")
# The (op, par) pairs of the JAX probe's cases, the only ones the kernel is
# built for (bf16: fma at par 8).
RATE_PAIRS = (("fma", 1), ("fma", 8), ("roll", 8), ("select", 8),
              ("hswish", 4), ("cast", 4))




def _on_card(name, *tensors, dtypes, dims):
    """Raise on what the kernels do not take; returns the tensors
    contiguous."""
    out = []
    for t, dim in zip(tensors, dims):
        if t.device.type != "cuda":
            raise ValueError(f"{name}: unsupported device {t.device}")
        if t.dtype not in dtypes or t.dim() != dim:
            raise ValueError(f"{name}: expected a {dim}-D tensor of "
                             f"{dtypes}, got {t.dim()}-D {t.dtype}")
        out.append(t.contiguous())
    return out


# ---------------------------------------------------------------- copy
def probe_copy_reference(x):
    """y = x."""
    return x.clone()


def probe_copy(x, th: int):
    """A copy of x (B, H, C, W).  ``th`` is the TPU probe's slab height: it
    names the JAX probe's case and must divide H, and nothing else depends
    on it (the kernel streams its own 32 KB tiles; any dtype, the byte count
    a multiple of 16)."""
    if x.dim() != 4 or th <= 0 or x.shape[1] % th:
        raise ValueError(f"probe_copy: x must be (B, H, C, W) with H a "
                         f"multiple of th={th}, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return probe_copy_reference(x)
    (x,) = _on_card("probe_copy", x, dtypes=(torch.bfloat16, torch.float32),
                    dims=(4,))
    nbytes = x.numel() * x.element_size()
    if nbytes % 16:
        raise ValueError("probe_copy: the byte count must be a multiple of 16")
    y = torch.empty_like(x)
    check(load_library().probe_copy_launch(x.data_ptr(), y.data_ptr(), nbytes,
                                           launch_stream(x)), "probe_copy")
    LAUNCHES["probe_copy"] += 1
    return y


# ---------------------------------------------------------------- product
def probe_mm_reference(x, w):
    """einsum('rcw,ce->rew') over f32 values, rounded to x's dtype."""
    return torch.einsum("rcw,ce->rew", x.float(),
                        w.to(x.dtype).float()).to(x.dtype)


def _mm(name, x, w, cut=None, out=None):
    """Launches ``name``'s kernel (counted), or with ``cut`` the same
    schedule with that part cut out (``MM_CUTS``; timing only, uncounted)
    into ``out`` where given."""
    x, w = _on_card(name, x, w.to(device=x.device, dtype=x.dtype),
                    dtypes=(torch.bfloat16,), dims=(3, 2))
    r, c, width = x.shape
    if w.shape[0] != c or w.shape[1] % 8 or width % 8:
        raise ValueError(f"{name}: needs w (C={c}, E) with E and W multiples "
                         f"of 8, got x {tuple(x.shape)}, w {tuple(w.shape)}")
    e = w.shape[1]
    if out is None:
        y = torch.empty((r, e, width), dtype=x.dtype, device=x.device)
    elif (tuple(out.shape) != (r, e, width) or out.dtype != x.dtype
          or out.device != x.device or not out.is_contiguous()):
        raise ValueError(f"{name}: out must be a contiguous {x.dtype} "
                         f"({r}, {e}, {width}) tensor on {x.device}")
    else:
        y = out
    lib = load_library()
    args = (x.data_ptr(), w.data_ptr(), y.data_ptr(), r, c, e, width,
            launch_stream(x))
    if cut is not None:
        check(lib.probe_mm_cut_launch(MM_SCHEDULES.index(name),
                                      MM_CUTS.index(cut), *args), name)
        return y
    check(getattr(lib, f"{name}_launch")(*args), name)
    LAUNCHES[name] += 1
    return y


def probe_mm_einsum(x, w):
    """y (R, E, W) = einsum('rcw,ce->rew', x, w), f32 accumulation, in x's
    dtype (bf16 on the card): the (r, w) items spread across the card."""
    if x.device.type == "cpu":
        return probe_mm_reference(x, w)
    return _mm("probe_mm_einsum", x, w)


def probe_mm_rowloop(x, w):
    """The same product, each CTA walking consecutive rows of one W tile
    with the weight staged once (the same twin)."""
    if x.device.type == "cpu":
        return probe_mm_reference(x, w)
    return _mm("probe_mm_rowloop", x, w)


def probe_mm_cut(name, x, w, cut, out=None):
    """``name``'s kernel on a CUDA tensor with the part ``cut`` of its
    schedule cut out (``MM_CUTS``; "none" is the entry's kernel), for
    timing only: its output is not the product for "mma", and it counts no
    launch.  ``out``: a (R, E, W) tensor to write y into (a new one if
    None)."""
    return _mm(name, x, w, cut, out)


def probe_mm_occupancy(name, r, c, e, w):
    """What ``name``'s kernel would launch for x (R, C, W) and a (C, E)
    weight: {registers, local_bytes (spill), smem (a CTA), ctas_per_sm,
    items, grid, slots (of the x ring)} (launches nothing)."""
    out = (ctypes.c_int * 7)()
    check(load_library().probe_mm_occupancy(MM_SCHEDULES.index(name), r, c,
                                            e, w, out), name)
    return dict(zip(("registers", "local_bytes", "smem", "ctas_per_sm",
                     "items", "grid", "slots"), out))


def probe_mm_last_staging(name):
    """How ``name``'s last launch staged x and the weight: "async" (TMA
    boxes and a bulk copy; every shape the kernel takes), "sync" (plain
    loads: the "async" cut) or None."""
    code = load_library().probe_mm_last_staging(MM_SCHEDULES.index(name))
    return {1: "async", 0: "sync"}.get(code)


# ---------------------------------------------------------------- depthwise
def _dw_size(name, x, wd):
    k = wd.shape[0]
    if x.dim() != 3 or wd.dim() != 3 or wd.shape[1] != k or k not in (3, 5):
        raise ValueError(f"{name}: needs a 3-D x and wd (k, k, C), k 3 or 5")
    return k, (k - 1) // 2


def probe_dw_t_reference(x, wd):
    """x (th + 2p, C, W) -> (th, C, W): the rows valid, W circular, summed
    dj outer, di inner (the TPU kernel's lane rolls, shift mod W)."""
    k, p = _dw_size("probe_dw_t", x, wd)
    th = x.shape[0] - 2 * p
    out = None
    for dj in range(k):
        hj = torch.roll(x, p - dj, dims=2)
        for di in range(k):
            term = hj[di:di + th] * wd[di, dj][None, :, None]
            out = term if out is None else out + term
    return out


def probe_dw_nhwc_reference(x, wd):
    """x (th + 2p, W + 2p, C) -> (th, W, C): a valid k x k depthwise,
    summed dj outer, di inner."""
    k, p = _dw_size("probe_dw_nhwc", x, wd)
    th, w = x.shape[0] - 2 * p, x.shape[1] - 2 * p
    out = None
    for dj in range(k):
        hj = x[:, dj:dj + w]
        for di in range(k):
            term = hj[di:di + th] * wd[di, dj]
            out = term if out is None else out + term
    return out


def _dw(name, x, wd, out_shape, size, cut=None):
    """Launches ``name``'s kernel (counted), or with ``cut`` the same
    schedule with that part cut out (``DW_CUTS``; timing only, uncounted)."""
    _dw_size(name, x, wd)
    x, wd = _on_card(name, x, wd.to(x.device), dtypes=(torch.float32,),
                     dims=(3, 3))
    y = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    lib = load_library()
    args = (x.data_ptr(), wd.data_ptr(), y.data_ptr(), *size, wd.shape[0],
            launch_stream(x))
    if cut is not None:
        check(lib.probe_dw_cut_launch(DW_LAYOUTS.index(name),
                                      DW_CUTS.index(cut), *args), name)
        return y
    check(getattr(lib, f"{name}_launch")(*args), name)
    LAUNCHES[name] += 1
    return y


def probe_dw_t(x, wd):
    """The channel-planar depthwise, circular in W (f32)."""
    if x.device.type == "cpu":
        return probe_dw_t_reference(x, wd)
    k, p = _dw_size("probe_dw_t", x, wd)
    t2, c, w = x.shape
    if wd.shape[2] != c or w <= p:
        raise ValueError(f"probe_dw_t: wd must be (k, k, {c}) and W > {p}")
    return _dw("probe_dw_t", x, wd, (t2 - 2 * p, c, w), (t2 - 2 * p, c, w))


def probe_dw_nhwc(x, wd):
    """The NHWC depthwise over a pre-padded input (f32; C a multiple of
    4)."""
    if x.device.type == "cpu":
        return probe_dw_nhwc_reference(x, wd)
    k, p = _dw_size("probe_dw_nhwc", x, wd)
    t2, wp, c = x.shape
    if wd.shape[2] != c or c % 4:
        raise ValueError(f"probe_dw_nhwc: wd must be (k, k, {c}), C a "
                         "multiple of 4")
    th, w = t2 - 2 * p, wp - 2 * p
    return _dw("probe_dw_nhwc", x, wd, (th, w, c), (th, c, w))


def probe_dw_cut(name, x, wd, cut):
    """``name``'s kernel on a CUDA tensor with the part ``cut`` of its
    schedule cut out (``DW_CUTS``; "none" is the entry's kernel), for
    timing only: its output is not the depthwise for "fma", and it counts
    no launch."""
    k, p = _dw_size(name, x, wd)
    t2, a, b = x.shape
    if name == "probe_dw_t":  # x (th + 2p, C, W)
        out, size = (t2 - 2 * p, a, b), (t2 - 2 * p, a, b)
    else:  # x (th + 2p, W + 2p, C)
        out, size = (t2 - 2 * p, a - 2 * p, b), (t2 - 2 * p, b, a - 2 * p)
    return _dw(name, x, wd, out, size, cut)


def probe_dw_occupancy(name, th, c, w, k):
    """What ``name``'s kernel would launch for output (th, C, W) at this
    k: {registers, local_bytes (spill), smem (a CTA), ctas_per_sm, tiles,
    grid} (launches nothing)."""
    out = (ctypes.c_int * 6)()
    check(load_library().probe_dw_occupancy(DW_LAYOUTS.index(name), th, c,
                                            w, k, out), name)
    return dict(zip(("registers", "local_bytes", "smem", "ctas_per_sm",
                     "tiles", "grid"), out))


def probe_dw_last_staging(name):
    """How ``name``'s last launch staged its tiles: "async" (dw_t's bulk
    copies, dw_nhwc's TMA box), "sync" (plain loads: dw_t at W % 4 != 0)
    or None."""
    code = load_library().probe_dw_last_staging(DW_LAYOUTS.index(name))
    return {1: "async", 0: "sync"}.get(code)


# ---------------------------------------------------------------- rate
def _rate_args(op, par, reps):
    if (op, par) not in RATE_PAIRS or reps < par:
        raise ValueError(f"probe_rate: (op, par) in {RATE_PAIRS}, reps >= "
                         f"par; got {op}, {par}, {reps}")
    return reps // par


def probe_rate_reference(x, op: str, par: int, reps: int):
    """The (C, L) tile of the sum of the ``par`` chains after ``reps //
    par`` steps of ``op`` each, in x's dtype, as f32.  Constants are
    tensors of x's dtype (1.000001 is 1.0 in bf16), every op rounds."""
    steps = _rate_args(op, par, reps)
    dt = x.dtype

    def const(v):
        return torch.tensor(v, dtype=dt, device=x.device)

    w, b, three, six = const(1.000001), const(1e-7), const(3.0), const(6.0)
    accs = [x * const(1.0 + i * 1e-6) for i in range(par)]
    col = torch.arange(x.shape[1], device=x.device)[None]
    for i in range(steps):
        if op == "fma":
            accs = [a * w + b for a in accs]
        elif op == "roll":
            accs = [torch.roll(a, 1, dims=1) for a in accs]
        elif op == "select":
            accs = [torch.where(col == i % x.shape[1], a * w, a)
                    for a in accs]
        elif op == "hswish":
            accs = [a * torch.clamp(a + three, 0, six) / six for a in accs]
        else:
            accs = [a.to(torch.bfloat16).to(torch.float32) * w for a in accs]
    if op == "roll":
        accs = [a * w for a in accs]
    out = accs[0]
    for a in accs[1:]:
        out = out + a
    return out.float()


def probe_rate(x, op: str, par: int, reps: int):
    """``probe_rate_reference``'s tile; element [0, 0] is the TPU probe's
    scalar.  x (C, L): f32 for every pair of ``RATE_PAIRS``, bf16 for fma at
    par 8; L a multiple of 128, at most 4096."""
    if x.device.type == "cpu":
        return probe_rate_reference(x, op, par, reps)
    _rate_args(op, par, reps)
    (x,) = _on_card("probe_rate", x, dtypes=(torch.float32, torch.bfloat16),
                    dims=(2,))
    c, lanes = x.shape
    if lanes % 128 or lanes > 4096 or (x.dtype == torch.bfloat16
                                       and (op, par) != ("fma", 8)):
        raise ValueError("probe_rate: L must be a multiple of 128 up to 4096,"
                         " and a bf16 tile takes fma at par 8 only")
    out = torch.empty((c, lanes), dtype=torch.float32, device=x.device)
    check(load_library().probe_rate_launch(
        x.data_ptr(), out.data_ptr(), c, lanes, reps, RATE_OPS.index(op), par,
        int(x.dtype == torch.bfloat16), launch_stream(x)), "probe_rate")
    LAUNCHES["probe_rate"] += 1
    return out
