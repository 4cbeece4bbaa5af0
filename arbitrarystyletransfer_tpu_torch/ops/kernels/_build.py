"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` for ``sm_90a``,
all started together, and the objects are linked into one shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers: a build
takes seconds, not minutes).  The library is named by a hash of the sources
and flags, so an edited source is rebuilt; it lives in ``build/kernels/``
beside the package (``AST_TORCH_BUILD_DIR`` overrides), which ``.gitignore``
lists.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argtypes (every one returns a cudaError_t as int).
_SIGNATURES = {
    # x, w_expand, w_dw, b_expand, b_dw, hidden, sums,
    # n, h, w, c_in, e, k, pre_act, is_bf16, stream
    "expand_dw_launch": [_P] * 7 + [_I] * 8 + [_P],
    # q, k, v, mean, std, m, l, b, nc, ns, c, is_bf16, stream
    "adaattn_fwd_launch": [_P] * 7 + [_I] * 5 + [_P],
    # q, k, v, vbar, mean, std, m, l, part (scratch), b, nc, ns, c, splits,
    # keys per split, stream: the f32 serving form
    "adaattn_fwd_serve_launch": [_P] * 9 + [_I] * 6 + [_P],
    # x, w_expand, w_dw, b_expand, b_dw, d0t, d0b, d1k, d1b, wpt, pb,
    # hidden, sums, gate (scratch), y, n, h, w, c_in, e, s, c_out, k,
    # pre_act, identity, is_bf16, stream
    "flat_block_launch": [_P] * 15 + [_I] * 11 + [_P],
    # the same without pre_act and identity
    "flat_s2_launch": [_P] * 15 + [_I] * 9 + [_P],
    # flat_block_launch's arguments, with x and y in (N, H, C, W)
    "mega_block_launch": [_P] * 15 + [_I] * 11 + [_P],
    # design (0 gate_project_generic, 1 the dtype's designed kernel),
    # hidden, sums, d0t, d0b, d1k, d1b, wpt, pb, res, gate (scratch), y, n,
    # hw, e, s, c_out, w, yt, is_bf16, stream: sweep 2 alone (A/B timing)
    "gate_project_launch": [_I] + [_P] * 11 + [_I] * 8 + [_P],
    # design, e, c_out, res, yt, is_bf16, out[4]: registers, shared
    # memory, CTAs per SM, ring slots of that sweep-2 kernel (no launch)
    "gate_project_occupancy": [_I] * 6 + [_P],
    # no arguments: the sweep-2 design of the last launch of each source
    # (0 generic, 1 gate_project_mma, 2 gate_project_tf32, -1 none yet;
    # flat_block's also covers gate_project_launch)
    "flat_block_last_sweep2": [],
    "mega_block_last_sweep2": [],
    "flat_s2_block_last_sweep2": [],
    # x, w_expand, w_dw, b_expand, b_dw, sums, n, h, w, c_in, e, k, pre_act,
    # is_bf16, stream
    "fused_sums_launch": [_P] * 6 + [_I] * 8 + [_P],
    # x, w_expand, w_dw, b_expand, b_dw, gate, w_proj (e, c_out), y, n, h,
    # w, c_in, e, c_out, k, pre_act, identity, is_bf16, stream
    "fused_project_launch": [_P] * 8 + [_I] * 10 + [_P],
    # design (0 tile, 1 persistent), cut, then fused_project_launch's
    # arguments without is_bf16 (bf16 only; timing only)
    "fused_project_cut_launch": [_I] * 2 + [_P] * 8 + [_I] * 9 + [_P],
    # design, k, c_in, e, c_out, out[4]: registers, shared memory, CTAs per
    # SM, resident expand weights (no launch)
    "fused_project_occupancy": [_I] * 5 + [_P],
    # no arguments: the design of the last fused_project launch (1
    # persistent, 0 tile, -1 none yet)
    "fused_project_last_design": [],
    # q, k, v, vbar, dm1, dm2, m, l, d (f64), dq, part, b, nc, ns, c, splits,
    # is_bf16, dm_bf16, stream
    "adaattn_dq_launch": [_P] * 11 + [_I] * 7 + [_P],
    # q, k, v, vbar, dm1, dm2, m, l, d, dk, dv, part, b, nc, ns, c, splits,
    # is_bf16, dm_bf16, stream
    "adaattn_dkv_launch": [_P] * 12 + [_I] * 7 + [_P],
    # b, nc, ns: the kernels' chunks of the reduction axis for the shape
    "adaattn_dq_splits": [_I] * 3,
    "adaattn_dkv_splits": [_I] * 3,
    # which, cut, q, k, v, vbar, dm1, dm2, m, l, d, out1, out2, part, b, nc,
    # ns, splits, stream (f32, one part cut out: timing only)
    "adaattn_bwd_cut_launch": [_I] * 2 + [_P] * 12 + [_I] * 4 + [_P],
    # which, out[3]: registers, shared memory, CTAs per SM (no launch)
    "adaattn_bwd_occupancy": [_I, _P],
    # k, c_in, out[3]: registers, shared memory, CTAs per SM (no launch)
    "expand_dw_occupancy": [_I, _I, _P],
    # no arguments: the dynamic shared memory a CTA may have on the device
    "max_smem_optin": [],
    # no arguments: the x boxes per halo of the last expand_dw launch (1
    # the whole box, more its channel chunks, -1 none yet)
    "expand_dw_last_boxes": [],
    # no arguments: the sweep-1 design of the last launch of each source
    # (0 the CUDA-core expand, 1 bf16 tensor-core, 2 f32 3xTF32, -1 none)
    "expand_dw_last_sweep1": [],
    "flat_block_last_sweep1": [],
    "mega_block_last_sweep1": [],
    "flat_s2_block_last_sweep1": [],
    # no arguments: the x boxes per halo of the last flat_block (mega_block)
    # launch
    "flat_block_last_boxes": [],
    "mega_block_last_boxes": [],
    # k, c_in, out[5]: registers, shared memory, CTAs per SM, x boxes per
    # halo, channels per box of the f32 3xTF32 sweep 1 (no launch)
    "expand_dw_f32_occupancy": [_I, _I, _P],
    "flat_block_f32_occupancy": [_I, _I, _P],
    "mega_block_f32_occupancy": [_I, _I, _P],
    "flat_s2_f32_occupancy": [_I, _I, _P],
    # k, c_in, e, c_out, identity, out[6]: the same of both sweeps
    "flat_block_occupancy": [_I] * 5 + [_P],
    "mega_block_occupancy": [_I] * 5 + [_P],
    # k, c_in, e, c_out, out[6]
    "flat_s2_occupancy": [_I] * 4 + [_P],
    # no arguments: how the last launch staged x in sweep 1 (1 a TMA box,
    # 0 plain loads, -1 none yet)
    "mega_block_last_staging": [],
    "flat_s2_block_last_staging": [],
    # no arguments: the x boxes per halo of the last flat_s2 launch (1 the
    # whole box, more its channel chunks, -1 none yet)
    "flat_s2_block_last_boxes": [],
    # x, y, nbytes, stream
    "probe_copy_launch": [_P, _P, ctypes.c_longlong, _P],
    # x, w, y, r, c, e, width, stream (both schedules)
    "probe_mm_einsum_launch": [_P] * 3 + [_I] * 4 + [_P],
    "probe_mm_rowloop_launch": [_P] * 3 + [_I] * 4 + [_P],
    # schedule (0 einsum, 1 rowloop), cut, then the launches' arguments (one
    # part cut out: timing only)
    "probe_mm_cut_launch": [_I] * 2 + [_P] * 3 + [_I] * 4 + [_P],
    # schedule, r, c, e, width, out[7]: registers, local bytes, shared
    # memory, CTAs per SM, items, grid, ring slots (no launch)
    "probe_mm_occupancy": [_I] * 5 + [_P],
    # schedule: how its last launch staged x (1 async, 0 plain loads, -1
    # none)
    "probe_mm_last_staging": [_I],
    # x, wd, y, th, c, w, k, stream (both layouts)
    "probe_dw_t_launch": [_P] * 3 + [_I] * 4 + [_P],
    "probe_dw_nhwc_launch": [_P] * 3 + [_I] * 4 + [_P],
    # layout (0 dw_t, 1 dw_nhwc), cut, then the launches' arguments (one
    # part cut out: timing only)
    "probe_dw_cut_launch": [_I] * 2 + [_P] * 3 + [_I] * 4 + [_P],
    # layout, th, c, w, k, out[6]: registers, local bytes, shared memory,
    # CTAs per SM, tiles, grid (no launch)
    "probe_dw_occupancy": [_I] * 5 + [_P],
    # layout: how its last launch staged x (1 async, 0 plain loads, -1 none)
    "probe_dw_last_staging": [_I],
    # x, out, c, l, reps, op, par, is_bf16, stream
    "probe_rate_launch": [_P] * 2 + [_I] * 6 + [_P],
}

_lib = None
build_info: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build "
                           "the port's kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _compile(sources, flags, target: Path) -> str:
    """One nvcc per source in parallel, then one link; returns the log."""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        jobs = []
        for src in sources:
            obj = Path(tmp) / f"{src.stem}.o"
            cmd = [nvcc, *flags, "-c", "-o", str(obj), str(src)]
            jobs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = "", []
        for src, _, proc in jobs:
            out, _ = proc.communicate()
            log += f"-- {src.name}\n{out}"
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        so = Path(tmp) / target.name
        cmd = [nvcc, *ARCH, "-shared", "-o", str(so),
               *(str(obj) for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{log}")
        os.replace(so, target)
    return log


def build_library(ptxas_verbose: bool = False) -> tuple[Path, str]:
    """(the library's path, the compiler's log): compiled unless a library
    of these sources and flags is there (``ptxas_verbose`` asks for the
    compiler's report, which changes no code, so it does not name the
    library: a process that asks for none loads the one built with it).
    Processes that start together (the ranks of a mesh) compile once: the
    first takes a file lock and compiles into a temporary name that it
    renames onto the target; the others wait for the lock, find the
    target and compile nothing (log "")."""
    sources = sorted(CSRC.glob("*.cu"))
    flags = NVCC_FLAGS + (("-Xptxas", "-v") if ptxas_verbose else ())
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out_dir = Path(os.environ.get("AST_TORCH_BUILD_DIR",
                                  _PKG.parent / "build" / "kernels"))
    out_dir.mkdir(parents=True, exist_ok=True)
    target = out_dir / f"libast_kernels_{digest.hexdigest()[:16]}.so"
    if target.exists():
        return target, ""
    with open(target.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if target.exists():
            return target, ""
        return target, _compile(sources, flags, target)


def load_library(ptxas_verbose: bool = False) -> ctypes.CDLL:
    """Compile (if the sources changed) and load the kernel library.

    ``build_info`` records the build seconds and, with ``ptxas_verbose``,
    the compiler's per-kernel register and shared-memory report."""
    global _lib
    if _lib is not None:
        return _lib
    t0 = time.perf_counter()
    target, log = build_library(ptxas_verbose)
    lib = ctypes.CDLL(str(target))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    build_info.update(seconds=time.perf_counter() - t0, log=log,
                      path=str(target))
    _lib = lib
    return lib


def launch_stream(t) -> int:
    """The handle of the current stream of ``t``'s card, for a launch on
    ``t``.  The library launches on the runtime's current device, so
    ``t`` must be on it: a tensor on another card raises (set the device
    first, ``torch.cuda.set_device``), and nothing switches silently."""
    import torch

    current = torch.cuda.current_device()
    if t.device.index != current:
        raise RuntimeError(f"a kernel launch on {t.device}, but the current "
                           f"device is cuda:{current}: call "
                           "torch.cuda.set_device first")
    return torch.cuda.current_stream(t.device).cuda_stream


def check(rc: int, name: str) -> None:
    """Raise when a launch function returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
