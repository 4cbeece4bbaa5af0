"""Reading the JAX trainers' orbax checkpoints, without JAX.

The JAX trainers save ``StandardCheckpointer`` directories (``save_dir/ae``,
``save_dir/ast``, ``save_dir/ast_dis``; JAX ``train/checkpoint.py``) of the
tree {"params", "batch_stats", "opt_state", "step"}.  Such a directory is
an OCDBT key-value store of zarr arrays: its ``_METADATA`` names every leaf
by its key path (``tree_metadata``), and ``tensorstore`` reads each leaf at
``".".join(key path)``.  So reading is a key map, and needs neither
``jax``, ``orbax`` nor ``flax``: ``read_orbax`` imports ``tensorstore``
alone, inside the call.

What it returns is the port's checkpoint format (``train/checkpoint.py``):
params and batch_stats under the JAX tree's names and layouts (the port's
weights.py state already uses them), opt_state as ``Adam.state_dict()``
({"mu", "nu", "count"}: optax's ``ScaleByAdamState``, wherever the chain put
it, with or without the clip before it; the empty states of the clip and
the chain's tail are dropped), and step.

A machine without ``tensorstore`` (the card's has none) cannot read the
directory: there ``read_orbax`` raises ``ImportError`` naming
``python -m arbitrarystyletransfer_tpu_torch.convert_orbax SAVE_DIR``,
which writes the same trees as ``.pt`` files on a machine that has it.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

CONVERT = "python -m arbitrarystyletransfer_tpu_torch.convert_orbax SAVE_DIR"


def is_orbax_checkpoint(path: str) -> bool:
    """Whether ``path`` is an orbax checkpoint directory (``_METADATA``)."""
    return os.path.isfile(os.path.join(path, "_METADATA"))


def _tensorstore():
    try:
        import tensorstore
    except ImportError as e:
        raise ImportError(
            "reading an orbax checkpoint needs the tensorstore package, "
            "which this machine lacks.  On the machine the JAX trainer ran "
            f"on, run `{CONVERT}` (it writes ae.pt, ast.pt and ast_dis.pt "
            "beside the ae, ast and ast_dis directories) and copy the .pt "
            "files here.") from e
    return tensorstore


def _to_torch(a: np.ndarray) -> torch.Tensor:
    """A numpy leaf as a tensor; bfloat16 (``ml_dtypes``) through a uint16
    view, never through float32."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _read_leaves(path: str) -> dict:
    """{key path (tuple of str): tensor} of every array leaf of the orbax
    checkpoint at ``path``, from its ``_METADATA``; leaves with nothing
    stored (optax's empty states) are left out."""
    ts = _tensorstore()
    path = os.path.abspath(path)
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    driver = "zarr3" if meta.get("use_zarr3") else "zarr"
    entries = []
    for entry in meta["tree_metadata"].values():
        value = entry["value_metadata"]
        if value.get("skip_deserialize") or value.get("value_type") == "None":
            continue
        keys = tuple(str(k["key"]) for k in entry["key_metadata"])
        name = ".".join(keys)
        kvstore = ({"driver": "ocdbt", "base": f"file://{path}/",
                    "path": name} if meta.get("use_ocdbt", True)
                   else {"driver": "file", "path": os.path.join(path, name)})
        entries.append((keys, value.get("write_shape"),
                        {"driver": driver, "kvstore": kvstore}))
    # Every open, then every read, in flight at once (tensorstore's futures).
    opened = [ts.open(spec, open=True, read=True) for _, _, spec in entries]
    reads = [f.result().read() for f in opened]
    leaves = {}
    for (keys, shape, _), r in zip(entries, reads):
        t = _to_torch(r.result())
        # Scalars (the step, Adam's count) are stored as (1,) arrays.
        leaves[keys] = t if shape is None else t.reshape(shape)
    return leaves


def _nest(leaves: dict) -> dict:
    tree: dict = {}
    for keys, t in leaves.items():
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = t
    return tree


def _flat(tree: dict, prefix: str = "") -> dict:
    """{"enc/mob_net_1/Conv_0/kernel": tensor, ...}: ``Adam``'s names."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _adam_state(node):
    """``Adam.state_dict()`` of the {"count", "mu", "nu"} node under an
    optax opt_state subtree (chain states are indexed "0", "1", ...): the
    moments by parameter name, or None."""
    if not isinstance(node, dict):
        return None
    if {"count", "mu", "nu"} <= set(node):
        return {"mu": _flat(node["mu"]), "nu": _flat(node["nu"]),
                "count": node["count"]}
    found = [s for s in (_adam_state(v) for v in node.values())
             if s is not None]
    if len(found) > 1:
        raise ValueError("the optimizer state holds more than one Adam "
                         "state")
    return found[0] if found else None


def read_orbax(path: str) -> dict:
    """{"params", "batch_stats", "opt_state", "step"} of the JAX trainer's
    orbax checkpoint directory ``path``, in the port's checkpoint format:
    tensors on the CPU, bit for bit the stored values (bfloat16 kept
    bfloat16); ``opt_state`` ``Adam.state_dict()``'s layout, or None when
    the checkpoint holds no Adam state.  Raises ``ImportError`` (naming the
    converter) without ``tensorstore``."""
    tree = _nest(_read_leaves(path))
    missing = {"params", "step"} - set(tree)
    if missing:
        raise ValueError(f"{path}: not a trainer checkpoint (no "
                         f"{sorted(missing)})")
    return {"params": tree["params"],
            "batch_stats": tree.get("batch_stats", {}),
            "opt_state": _adam_state(tree.get("opt_state")),
            "step": tree["step"]}
