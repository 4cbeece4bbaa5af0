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
    # q, k, v, mean, std, m, l, b, nc, ns, c, is_bf16, stream (the simt
    # entry: the CUDA-core kernel at either dtype, for A/B timing)
    "adaattn_fwd_launch": [_P] * 7 + [_I] * 5 + [_P],
    "adaattn_fwd_simt_launch": [_P] * 7 + [_I] * 5 + [_P],
    # x, w_expand, w_dw, b_expand, b_dw, d0t, d0b, d1k, d1b, wpt, pb,
    # hidden, sums, gate (scratch), y, n, h, w, c_in, e, s, c_out, k,
    # pre_act, identity, is_bf16, stream
    "flat_block_launch": [_P] * 15 + [_I] * 11 + [_P],
    # the same without pre_act and identity
    "flat_s2_launch": [_P] * 15 + [_I] * 9 + [_P],
    # flat_block_launch's arguments, with x and y in (N, H, C, W)
    "mega_block_launch": [_P] * 15 + [_I] * 11 + [_P],
    # x, w_expand, w_dw, b_expand, b_dw, sums, n, h, w, c_in, e, k, pre_act,
    # is_bf16, stream
    "fused_sums_launch": [_P] * 6 + [_I] * 8 + [_P],
    # x, w_expand, w_dw, b_expand, b_dw, gate, wpt, y, n, h, w, c_in, e,
    # c_out, k, pre_act, identity, is_bf16, stream
    "fused_project_launch": [_P] * 8 + [_I] * 10 + [_P],
    # q, k, v, dm1, dm2, m, l, d, dq, b, nc, ns, c, is_bf16, dm_bf16, stream
    "adaattn_dq_launch": [_P] * 9 + [_I] * 6 + [_P],
    # q, k, v, dm1, dm2, m, l, d, dk, dv, b, nc, ns, c, is_bf16, dm_bf16,
    # stream
    "adaattn_dkv_launch": [_P] * 10 + [_I] * 6 + [_P],
    # k, c_in, out[3]: registers, shared memory, CTAs per SM (no launch)
    "expand_dw_occupancy": [_I, _I, _P],
    # k, c_in, e, c_out, identity, out[6]: the same of both sweeps
    "flat_block_occupancy": [_I] * 5 + [_P],
    # x, y, nbytes, stream
    "probe_copy_launch": [_P, _P, ctypes.c_longlong, _P],
    # x, w, y, r, c, e, width, stream (both schedules)
    "probe_mm_einsum_launch": [_P] * 3 + [_I] * 4 + [_P],
    "probe_mm_rowloop_launch": [_P] * 3 + [_I] * 4 + [_P],
    # x, wd, y, th, c, w, k, stream (both layouts)
    "probe_dw_t_launch": [_P] * 3 + [_I] * 4 + [_P],
    "probe_dw_nhwc_launch": [_P] * 3 + [_I] * 4 + [_P],
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


def load_library(ptxas_verbose: bool = False) -> ctypes.CDLL:
    """Compile (if the sources changed) and load the kernel library.

    ``build_info`` records the build seconds and, with ``ptxas_verbose``,
    the compiler's per-kernel register and shared-memory report."""
    global _lib
    if _lib is not None:
        return _lib
    sources = sorted(CSRC.glob("*.cu"))
    flags = NVCC_FLAGS + (("-Xptxas", "-v") if ptxas_verbose else ())
    digest = hashlib.sha256(" ".join(flags).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out_dir = Path(os.environ.get("AST_TORCH_BUILD_DIR",
                                  _PKG.parent / "build" / "kernels"))
    out_dir.mkdir(parents=True, exist_ok=True)
    target = out_dir / f"libast_kernels_{digest.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    log = "" if target.exists() else _compile(sources, flags, target)
    lib = ctypes.CDLL(str(target))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    build_info.update(seconds=time.perf_counter() - t0, log=log,
                      path=str(target))
    _lib = lib
    return lib


def check(rc: int, name: str) -> None:
    """Raise when a launch function returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
