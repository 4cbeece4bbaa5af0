"""Checkpoints, the loss history and the AE -> AST warm start: the twin of
``train/checkpoint.py``, with a torch-native file in place of orbax.

A checkpoint is one ``torch.save`` file holding {"params", "batch_stats"}
(a weights.py state: the JAX tree's names and layouts, so it serves through
``infer.StylePipeline`` as it is), "opt_state" (``Adam.state_dict``) and
"step".  It is written to a temporary file beside the target and moved
into place with ``os.replace``, so a reader never sees half a checkpoint,
and read back with ``weights_only=True`` (tensors and containers only).
Reading an orbax checkpoint of the JAX trainer is not ported (ROADMAP
queue 1 item 9).
"""

from __future__ import annotations

import json
import os
import tempfile

import torch


def save_checkpoint(path: str, state, opt_state, step) -> None:
    """Atomically write {params, batch_stats, opt_state, step} at ``path``."""
    tree = {"params": state["params"], "batch_stats": state["batch_stats"],
            "opt_state": opt_state, "step": torch.as_tensor(step).cpu()}
    tree = _map(lambda t: t.detach().cpu(), tree)
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(tree, f)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def restore_checkpoint(path: str, device="cpu"):
    """{"params", "batch_stats", "opt_state", "step"} of a checkpoint, with
    every tensor on ``device``."""
    tree = torch.load(path, map_location="cpu", weights_only=True)
    return _map(lambda t: t.to(device), tree)


def checkpoint_exists(path: str) -> bool:
    return os.path.isfile(path)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def save_history(path: str, history: dict) -> None:
    """The loss history (a dict of lists) as JSON, replaced atomically."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(history, f)
    os.replace(tmp, path)


def load_history(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


_AE_TO_AST = {"encoder": "enc", "ada_out": "ada_out", "decoder": "dec"}


def transplant_ae_to_ast(ae_params, ae_batch_stats, ast_params,
                         ast_batch_stats):
    """The AST trees with the AE's encoder, ada_out and decoder subtrees
    copied in as enc, ada_out and dec; the AdaAttN modules keep theirs."""
    new_params = dict(ast_params)
    new_stats = dict(ast_batch_stats) if ast_batch_stats else {}
    for ae_key, ast_key in _AE_TO_AST.items():
        if ae_key in ae_params:
            new_params[ast_key] = ae_params[ae_key]
        if ae_batch_stats and ae_key in ae_batch_stats:
            new_stats[ast_key] = ae_batch_stats[ae_key]
    return new_params, new_stats
