"""Tracing and timing helpers: the twins of
``arbitrarystyletransfer_tpu/utils/profiling.py`` over ``torch.profiler``.

``profile_trace(log_dir)`` records the CPU (and, with a card, the CUDA)
activity of its block and writes a Chrome trace (``trace.json``, readable by
Perfetto or ``chrome://tracing``) into ``log_dir``.  ``log_compile_time``
times the first call of a function (with the kernels' build and cuDNN's
plans when they are new) against a second.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Profile the block and write ``<log_dir>/trace.json``; yields the
    ``torch.profiler.profile`` object."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _sync(out) -> None:
    """Wait for the card when ``out`` (a tensor, or a tuple, list or dict
    of them) has a tensor on it."""
    if isinstance(out, dict):
        out = list(out.values())
    leaves = out if isinstance(out, (tuple, list)) else [out]
    if any(isinstance(t, torch.Tensor) and t.is_cuda for t in leaves):
        torch.cuda.synchronize()


def log_compile_time(fn, *args, label: str = "fn", log_fn=print):
    """(output, first-call seconds, steady seconds) of ``fn(*args)`` called
    twice, each synchronized with the card when the output is on it."""
    t0 = time.perf_counter()
    out = fn(*args)
    _sync(out)
    first = time.perf_counter() - t0

    t0 = time.perf_counter()
    out = fn(*args)
    _sync(out)
    steady = time.perf_counter() - t0
    log_fn(f"{label}: first call {first * 1e3:.1f} ms, "
           f"steady {steady * 1e3:.1f} ms")
    return out, first, steady
