"""Run a function on the ranks of a mesh from one Python process: the
counterpart of JAX's virtual devices for the port's tests, the dry run and
the smoke run.

``run_ranks(fn, n, *args)`` starts ``n`` processes ("spawn"), joins them
over a ``file://`` rendezvous in a temporary directory, calls ``fn(mesh,
*args)`` on each and returns the ranks' results in rank order.  A rank that
raises, dies or outlives ``timeout`` fails the call (the others are killed),
so a hung collective never hangs the caller.  Results travel through
``torch.save`` files, so they may hold tensors (moved to the CPU first).
"""

from __future__ import annotations

import os
import tempfile
import time
import traceback

import torch
import torch.multiprocessing as mp

from .mesh import create_mesh, destroy_mesh


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def _rank_main(fn, rank, n, tmp, backend, device, threads, args):
    out = os.path.join(tmp, f"rank{rank}.pt")
    mesh = None
    try:
        torch.set_num_threads(threads)
        mesh = create_mesh(device, backend, rank=rank, world_size=n,
                           local_rank=rank,
                           init_method=f"file://{tmp}/rendezvous")
        result = fn(mesh, *args)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        torch.save({"ok": True, "result": _to_cpu(result)}, out)
    except BaseException:  # noqa: BLE001 - reported to the parent
        torch.save({"ok": False, "error": traceback.format_exc()}, out)
        raise SystemExit(1)
    finally:
        destroy_mesh(mesh)


def run_ranks(fn, n: int, *args, backend: str = "gloo", device="cpu",
              timeout: float = 300.0):
    """``[fn(mesh, *args) for each rank]``, run in ``n`` processes.

    ``fn`` must be importable by name (a module-level function).
    ``device`` is every rank's device ("cuda" gives rank r ``cuda:r``).
    Each rank takes an equal share of this process's intra-op threads."""
    threads = max(1, torch.get_num_threads() // n)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank_main, args=(
            fn, r, n, tmp, backend, device, threads, args), daemon=False)
            for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.join(max(deadline - time.monotonic(), 0.0))
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        reports = []
        for r in range(n):
            path = os.path.join(tmp, f"rank{r}.pt")
            reports.append(torch.load(path, weights_only=False)
                           if os.path.exists(path) else None)
    errors = [f"rank {r}:\n{rep['error']}" for r, rep in enumerate(reports)
              if rep is not None and not rep["ok"]]
    if errors:
        raise RuntimeError("a rank failed\n" + "\n".join(errors))
    if hung:
        raise TimeoutError(f"ranks {hung} of {n} still ran after "
                           f"{timeout} s")
    missing = [r for r, rep in enumerate(reports) if rep is None]
    if missing:
        raise RuntimeError(f"ranks {missing} died without a result "
                           f"(exit codes {[p.exitcode for p in procs]})")
    return [rep["result"] for rep in reports]
