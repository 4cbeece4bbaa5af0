"""Data parallelism over ``torch.distributed``: the twin of
``arbitrarystyletransfer_tpu/parallel/mesh.py``.

JAX runs one program over a 1-D ``Mesh(('data',))``: parameters replicated,
the batch sharded on its leading axis, and GSPMD inserting the all-reduces
that make the sharded step the one-device step on the global batch.  Here
each device is a process (``torchrun``, one rank per GPU), and the same
contract is kept by hand:

  * ``create_mesh`` joins the process group (NCCL between cards; gloo on the
    CPU, or on cards when asked for) and returns a ``Mesh`` record;
  * ``shard_batch`` hands each rank its rows of rank 0's host batch;
  * ``replicate`` broadcasts rank 0's tensors;
  * ``all_reduce_sum`` is a differentiable sum over the ranks (its backward
    all-reduces the cotangent), which BatchNorm's global statistics use;
  * ``all_reduce_grads`` sums the ranks' gradients in one collective.

Only ``all_reduce`` and ``broadcast`` are used: gloo runs both on CUDA
tensors too.  A mesh of size 1 issues no collective, and a module whose
``mesh`` attribute is None (the default) runs the one-device code.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import os

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a 1-D data-parallel mesh.

    The device's tensors go over the default group; ``host_group`` is a
    gloo group for host tensors (the batch's header and bytes, the
    barrier)."""

    rank: int
    size: int
    device: torch.device
    host_group: object = None


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name)
    return default if value in (None, "") else int(value)


def _rank_device(device, backend: str, local_rank: int, size: int):
    """The torch device of this rank: ``cuda`` means ``cuda:<local rank>``;
    two ranks on one card are allowed under gloo only."""
    device = torch.device(device)
    if device.type == "cpu":
        if backend != "gloo":
            raise ValueError(f"a CPU mesh needs the gloo backend, not "
                             f"{backend!r}")
        return device
    if device.type != "cuda":
        raise ValueError(f"unsupported mesh device {device}")
    if not torch.cuda.is_available():
        raise RuntimeError("mesh device cuda, but CUDA is not available")
    cards = torch.cuda.device_count()
    if device.index is None:
        if local_rank < cards:
            return torch.device("cuda", local_rank)
        if backend == "nccl":
            raise RuntimeError(
                f"nccl needs one card per rank: local rank {local_rank} of "
                f"{size} ranks, but {cards} card(s) (two ranks on one card "
                "need --dist_backend gloo)")
        return torch.device("cuda", local_rank % cards)
    if backend == "nccl" and size > 1:
        raise RuntimeError(f"nccl needs one card per rank, but every rank "
                           f"was given {device}; pass the device without an "
                           "index, or ask for gloo")
    return device


def create_mesh(device="cuda", backend: str | None = None,
                rank: int | None = None, world_size: int | None = None,
                local_rank: int | None = None,
                init_method: str | None = None) -> Mesh:
    """This process's rank of the data-parallel mesh.

    ``rank``, ``world_size`` and ``local_rank`` default to torchrun's
    ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` (0, 1, 0 without them).
    With one rank nothing is initialized and no collective will run.
    ``backend`` defaults to nccl on cuda and gloo on cpu; ``init_method``
    to ``env://`` (torchrun's ``MASTER_ADDR``/``MASTER_PORT``).  A cuda
    rank selects its card (``torch.cuda.set_device``) before anything else
    touches it."""
    rank = _env_int("RANK", 0) if rank is None else rank
    size = _env_int("WORLD_SIZE", 1) if world_size is None else world_size
    local_rank = (_env_int("LOCAL_RANK", rank) if local_rank is None
                  else local_rank)
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}; nccl or gloo")
    if size == 1:
        return Mesh(0, 1, device)
    device = _rank_device(device, backend, local_rank, size)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=size)
    host_group = dist.new_group(backend="gloo") if backend != "gloo" else None
    return Mesh(rank, size, device, host_group)


def destroy_mesh(mesh: Mesh | None) -> None:
    """Leave the process group (nothing for a mesh of size 1)."""
    if mesh is not None and mesh.size > 1 and dist.is_initialized():
        dist.destroy_process_group()


def is_sharded(mesh: Mesh | None) -> bool:
    """Whether ``mesh`` spans more than one rank (only then do collectives
    run)."""
    return mesh is not None and mesh.size > 1


def barrier(mesh: Mesh | None) -> None:
    """Wait for every rank (an all-reduce of one host value)."""
    if is_sharded(mesh):
        dist.all_reduce(torch.zeros(1), group=mesh.host_group)


# -- the batch ----------------------------------------------------------------

_DTYPES = (np.float32, np.float64, np.float16, np.uint8, np.int32, np.int64,
           np.bool_)


def _broadcast_host(mesh: Mesh | None, host):
    """Rank 0's numpy array (or tensor) on every rank, as numpy: its dtype
    and shape, then its bytes, over the host group.  Other ranks pass
    anything (None)."""
    if not is_sharded(mesh):
        return np.asarray(host)
    header = torch.full((9,), -1, dtype=torch.int64)
    if mesh.rank == 0:
        host = np.ascontiguousarray(np.asarray(
            host.cpu() if isinstance(host, torch.Tensor) else host))
        kinds = [np.dtype(t) for t in _DTYPES]
        if host.dtype in kinds and 1 <= host.ndim <= 7:
            header[0] = kinds.index(host.dtype)
            header[1] = host.ndim
            header[2:2 + host.ndim] = torch.tensor(host.shape)
    dist.broadcast(header, 0, group=mesh.host_group)
    if header[0] < 0:  # every rank raises, none waits for the bytes
        raise ValueError("shard_batch: rank 0's batch is not a 1-7 "
                         "dimensional array of " + ", ".join(
                             np.dtype(t).name for t in _DTYPES))
    dtype = np.dtype(_DTYPES[int(header[0])])
    shape = tuple(int(s) for s in header[2:2 + int(header[1])])
    buf = (torch.from_numpy(host.reshape(-1).view(np.uint8)) if mesh.rank == 0
           else torch.empty(int(np.prod(shape)) * dtype.itemsize,
                            dtype=torch.uint8))
    dist.broadcast(buf, 0, group=mesh.host_group)
    return buf.numpy().view(dtype).reshape(shape)


def shard_rows(mesh: Mesh, batch: int) -> slice:
    """This rank's rows of a global batch of ``batch``; a batch that the
    ranks cannot share equally raises ``ValueError`` (JAX's
    ``device_put`` does too)."""
    if batch % mesh.size:
        raise ValueError(f"a global batch of {batch} does not split over "
                         f"{mesh.size} ranks")
    per = batch // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_batch(mesh: Mesh, host_batch) -> torch.Tensor:
    """This rank's rows ``[r B / W, (r + 1) B / W)`` of rank 0's host batch
    (numpy, leading axis the batch), on the rank's device.  The other ranks'
    arguments are ignored.  With one rank: the batch on the device."""
    host = _broadcast_host(mesh, host_batch)
    if is_sharded(mesh):
        host = host[shard_rows(mesh, host.shape[0])]
    return torch.as_tensor(np.ascontiguousarray(host), device=mesh.device)


def gather_batch(mesh: Mesh | None, local: torch.Tensor) -> torch.Tensor:
    """The whole batch on every rank from each rank's equal rows: an
    all-reduce into a zeroed buffer (gloo runs no all-gather on CUDA)."""
    if not is_sharded(mesh):
        return local
    b = local.shape[0]
    full = torch.zeros((b * mesh.size, *local.shape[1:]), dtype=local.dtype,
                       device=local.device)
    full[mesh.rank * b:(mesh.rank + 1) * b] = local
    dist.all_reduce(full)
    return full


# -- the state ----------------------------------------------------------------

@torch.no_grad()
def replicate(mesh: Mesh | None, tensors) -> None:
    """Overwrite ``tensors`` (parameters, buffers, optimizer moments) with
    rank 0's values: one broadcast per dtype over a flat buffer."""
    if not is_sharded(mesh):
        return
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in group])
        dist.broadcast(flat, 0)
        torch._foreach_copy_(group, [f.view_as(t) for f, t in zip(
            flat.split([t.numel() for t in group]), group)])


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the backward sums the cotangent over the ranks
    too (differentiably, for a double backward)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        y = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad.contiguous(), ctx.mesh), None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """``x`` summed over the ranks, differentiable: a gradient that flows
    into the sum reaches every rank's ``x``.  ``x`` itself with one rank."""
    if not is_sharded(mesh):
        return x
    return _AllReduceSum.apply(x, mesh)


@torch.no_grad()
def all_reduce_grads(mesh: Mesh | None, grads, params=None):
    """The ranks' gradients summed, in one all-reduce over one flat
    buffer.  A None gradient goes in as zeros of its parameter's shape
    (``params``, in order; needed only when a gradient is None), so the
    ranks' buffers line up, and comes back as None."""
    if not is_sharded(mesh):
        return grads
    grads = list(grads)
    dtype = next(g.dtype for g in grads if g is not None)
    shapes = [p.shape if g is None else g.shape
              for g, p in zip(grads, params or grads)]
    flat = torch.cat([
        torch.zeros(math.prod(s), dtype=dtype, device=mesh.device)
        if g is None else g.reshape(-1) for g, s in zip(grads, shapes)])
    dist.all_reduce(flat)
    parts = flat.split([math.prod(s) for s in shapes])
    return [None if g is None else f.view(s)
            for g, f, s in zip(grads, parts, shapes)]


@torch.no_grad()
def all_reduce_values(mesh: Mesh | None, values: dict, op: str = "sum"):
    """``values`` ({name: scalar tensor}) reduced over the ranks (``op``
    "sum", "min" or "max") in one all-reduce."""
    if not is_sharded(mesh) or not values:
        return values
    names = list(values)
    dtype = functools.reduce(torch.promote_types,
                             (v.dtype for v in values.values()))
    stacked = torch.stack([values[k].detach().to(mesh.device, dtype)
                           for k in names])
    reduce_op = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
                 "max": dist.ReduceOp.MAX}[op]
    dist.all_reduce(stacked, op=reduce_op)
    return {k: v.to(values[k].dtype) for k, v in zip(names, stacked)}


def batch_share(mesh: Mesh | None):
    """The factor that turns a batch mean over this rank's rows into its
    share of the global batch's mean (1 / ranks); None with one rank."""
    return 1.0 / mesh.size if is_sharded(mesh) else None


def shared(term, share):
    """``term`` times ``share`` (``batch_share``); ``term`` itself, as it
    is, without one."""
    return term if share is None else term * share


# -- modules ------------------------------------------------------------------

def set_mesh(module: torch.nn.Module, mesh: Mesh | None) -> None:
    """Give every submodule that takes a mesh (``BatchNorm2D``'s global
    statistics, ``MobileNetV2``'s dropout masks) ``mesh``."""
    for m in module.modules():
        if hasattr(type(m), "mesh"):
            m.mesh = mesh


@contextlib.contextmanager
def local(module: torch.nn.Module):
    """Run ``module`` on this rank alone for the block (a preview, an
    interpolation: what JAX computes on one device), then give its mesh
    back."""
    saved = [(m, m.mesh) for m in module.modules() if hasattr(type(m),
                                                                "mesh")]
    try:
        for m, _ in saved:
            m.mesh = None
        yield module
    finally:
        for m, mesh in saved:
            m.mesh = mesh
