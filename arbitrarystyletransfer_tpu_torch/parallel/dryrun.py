"""The multi-device dry run: the twin of ``__graft_entry__.dryrun_multichip``.

    python -m arbitrarystyletransfer_tpu_torch.parallel.dryrun [n] [device]

``dryrun_multigpu(n)`` starts ``n`` ranks (gloo on the CPU by default; nccl,
one card each, with ``device="cuda"``) and runs one full-width AST training
step at 32px on them, one example per rank, through ``ASTTrainer`` with the
mesh; the loss must be finite and equal on every rank.
"""

from __future__ import annotations

import math
import sys
import tempfile

import numpy as np

from .launch import run_ranks
from .mesh import shard_batch

SIZE = 32


def _dryrun_rank(mesh, save_dir):
    from ..config import ASTTrainConfig, ModelConfig
    from ..train.ast_trainer import ASTTrainer

    cfg = ASTTrainConfig(batch_size=mesh.size, save_dir=save_dir,
                         ae_model="")
    trainer = ASTTrainer(cfg, None, ModelConfig(), preview_dir=None,
                         log_fn=lambda *a: None, mesh=mesh)
    content = style = None
    if mesh.rank == 0:
        rng = np.random.default_rng(0)
        content, style = rng.uniform(
            0, 1, (2, mesh.size, SIZE, SIZE, 3)).astype(np.float32)
    content, style = shard_batch(mesh, content), shard_batch(mesh, style)
    aux = trainer.train_step(content, style)
    return float(aux["loss"]), bool(aux["finite"])


def dryrun_multigpu(n: int, device="cpu", timeout: float = 600.0) -> float:
    """One full AST step over an ``n``-rank mesh; returns the loss."""
    backend = "gloo" if str(device) == "cpu" else "nccl"
    with tempfile.TemporaryDirectory() as tmp:
        results = run_ranks(_dryrun_rank, n, tmp, backend=backend,
                            device=device, timeout=timeout)
    losses = [loss for loss, _ in results]
    if not all(finite for _, finite in results):
        raise FloatingPointError(f"dry run: a non-finite gradient norm "
                                 f"({losses})")
    if not math.isfinite(losses[0]) or len(set(losses)) != 1:
        raise FloatingPointError(f"dry run: losses {losses}")
    print(f"dryrun_multigpu({n}): ok, loss={losses[0]:.4f}")
    return losses[0]


if __name__ == "__main__":
    dryrun_multigpu(int(sys.argv[1]) if len(sys.argv) > 1 else 2,
                    sys.argv[2] if len(sys.argv) > 2 else "cpu")
