"""Batched stylization: the port's
``arbitrarystyletransfer_tpu/infer.StylePipeline``, on one device or, with a
``parallel`` mesh, one process per device.

Two engines serve the same weights.  "flax" (the default, as in JAX) runs
the module graph ``models/ast.AST`` (``AST.stylize``), whose encoder
normalizes with batch statistics unless ``encoder_eval_stats``; "fused"
runs ``engine.stylize_fused``, which folds the BatchNorm running statistics
into the convs and so serves only ``encoder_eval_stats=True``.  The weights
live once, in the pipeline's ``AST`` module: ``state`` is a weights.py view
of the module's own tensors, so ``load_state`` moves both engines at once.

``from_checkpoint`` serves a trainer checkpoint (``<path>.pt``, or the
JAX trainer's orbax directory ``<path>``); with
``recalibrate_with`` it rebuilds the encoder's BatchNorm statistics from
data first (``train/recalibrate.py``), JAX's route from a checkpoint trained
with the default batch statistics to the fused engine.

With a ``mesh`` of more than one rank every rank calls the same methods:
rank 0's batch is sharded over the ranks (the others' arguments are
ignored), the fused engine runs on each rank's rows
(``engine.stylize_fused_sharded``, no collective inside), the graph engine's
BatchNorms take the global batch's statistics where they use batch
statistics, and ``stylize`` / ``export_forward`` return the whole batch on
every rank, as JAX returns the global array.  The weights are rank 0's
(broadcast at construction and at ``load_state``); recalibration runs on
each rank alone, as JAX's has no mesh.
"""

from __future__ import annotations

import dataclasses
import math
import warnings

import torch

from . import weights
from .config import ModelConfig, torch_dtype
from .engine import stylize_fused, stylize_fused_sharded
from .models.ast import AST
from .parallel.mesh import (
    Mesh,
    gather_batch,
    is_sharded,
    replicate,
    set_mesh,
    shard_batch,
)
from .train import checkpoint as ckpt
from .train.recalibrate import (
    EVAL_DRIFT_SAFE,
    eval_stats_drift,
    recalibrate_encoder_stats,
)

ENGINES = ("flax", "fused")


def _device(device) -> torch.device:
    """``device`` as a torch device; CUDA must be present when asked for
    (the pipeline never falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("StylePipeline: device cuda, but CUDA is not "
                           "available (pass device='cpu' to run on the CPU)")
    return device


class StylePipeline:
    """Alpha-interpolated stylization of NHWC [0, 1] batches."""

    def __init__(self, model_cfg: ModelConfig = ModelConfig(),
                 engine: str = "flax", device="cuda", state=None,
                 seed: int = 0, decoder_impl: str = "fused",
                 encoder_impl: str = "fused", mesh: Mesh | None = None):
        """``state`` is a weights.py state (a seeded ``init_params`` one
        when None), copied into the pipeline.  ``device`` defaults to the
        card and never falls back: a CPU run asks for ``device="cpu"``; with
        a ``mesh`` of more than one rank the pipeline runs on the mesh's
        device.
        ``decoder_impl`` and ``encoder_impl`` choose the fused engine's
        block routes ("fused", "mega", "flat", "flat-all", "auto"; see
        ``engine.stylize_fused``).  The fused engine folds BatchNorm running
        statistics, so with it a config with ``encoder_eval_stats=False`` is
        refused, as in the JAX pipeline: a checkpoint trained with batch
        statistics would be served with different encoder math
        (``from_checkpoint(recalibrate_with=...)`` is the route there)."""
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}; one of {ENGINES}")
        if engine == "fused" and not model_cfg.encoder_eval_stats:
            raise ValueError(
                "engine='fused' folds BatchNorm running statistics "
                "(encoder_eval_stats=True semantics), but this ModelConfig "
                "has encoder_eval_stats=False (batch-stats inference, the "
                "training default).  Either use engine='flax', recalibrate "
                "(from_checkpoint(recalibrate_with=...)), or construct the "
                "pipeline with dataclasses.replace(cfg, "
                "encoder_eval_stats=True) only for a checkpoint trained or "
                "validated with eval-stats semantics.")
        self.cfg, self.engine = model_cfg, engine
        self.decoder_impl, self.encoder_impl = decoder_impl, encoder_impl
        self.mesh = mesh if is_sharded(mesh) else None
        self.device = _device(device if self.mesh is None
                              else self.mesh.device)
        self.dtype = torch_dtype(model_cfg)
        if state is None:
            state = weights.init_params(model_cfg,
                                        torch.Generator().manual_seed(seed))
        self.ast = AST(model_cfg).to(self.device).requires_grad_(False)
        weights.load_state(self.ast, state)
        self.state = weights.module_state(self.ast)
        if self.mesh is not None:
            set_mesh(self.ast, self.mesh)
            self._replicate()

    def _replicate(self):
        replicate(self.mesh, [*self.ast.parameters(), *self.ast.buffers()])

    # -- weights -----------------------------------------------------------

    @classmethod
    def from_npz(cls, path, model_cfg: ModelConfig = ModelConfig(), **kw):
        """A pipeline over a state written by ``weights.save_npz``."""
        return cls(model_cfg, state=weights.load_npz(path), **kw)

    @classmethod
    def from_checkpoint(cls, path: str,
                        model_cfg: ModelConfig = ModelConfig(),
                        engine: str = "flax", decoder_impl: str = "fused",
                        encoder_impl: str = "fused", recalibrate_with=None,
                        allow_unstable: bool = False, device="cuda",
                        mesh: Mesh | None = None):
        """A pipeline over the params and batch_stats of the trainer
        checkpoint ``<path>.pt`` (else the orbax directory ``<path>``).

        ``recalibrate_with``: NHWC image batches.  With them (and the
        batch-stats training default in ``model_cfg``) the encoder's BN
        running statistics are rebuilt from the batches and the pipeline is
        built with eval-stats semantics: the route from a default-trained
        checkpoint to the fused engine.  With 8 or more batches the last 2
        are held out for the drift check (``eval_stats_drift``); with fewer
        it runs in-sample on the first 4.  A drift that is not finite raises
        ``ValueError`` unless ``allow_unstable``; one that is not finite or
        above ``EVAL_DRIFT_SAFE`` warns.  With a ``mesh`` every rank reads
        the checkpoint and recalibrates from the batches it was given (pass
        the same on every rank); rank 0's result is served."""
        kw = dict(engine=engine, decoder_impl=decoder_impl,
                  encoder_impl=encoder_impl, mesh=mesh)
        if recalibrate_with is None or model_cfg.encoder_eval_stats:
            pipe = cls(model_cfg, device=device, **kw)
            pipe.load_state(*cls._restore(path))
            return pipe
        device = _device(device if not is_sharded(mesh) else mesh.device)
        params, batch_stats = (weights.to_device(tree, device)
                               for tree in cls._restore(path))
        all_batches = list(recalibrate_with)
        # Hold out batches for the drift check, so that it is not measured
        # on the data the statistics came from (in-sample understates it);
        # with too few to spare, measure in-sample and say so.
        if len(all_batches) >= 8:
            recal_batches = all_batches[:-2]
            drift_batches, in_sample = all_batches[-2:], False
        else:
            recal_batches = all_batches
            drift_batches, in_sample = all_batches[:4], True
        new_stats = dict(batch_stats)
        new_stats["enc"] = recalibrate_encoder_stats(
            params["enc"], batch_stats["enc"], recal_batches, model_cfg)
        drift = eval_stats_drift(params["enc"], new_stats["enc"],
                                 drift_batches, model_cfg)
        if not math.isfinite(drift) and not allow_unstable:
            raise ValueError(
                f"recalibrated checkpoint drifts {drift} between eval-stats "
                "and batch-stats encoding: the folded engine would serve "
                "non-finite outputs.  Serve with engine='flax', train with "
                "encoder_eval_stats=True, or pass allow_unstable=True to "
                "serve the clamped outputs anyway.")
        if not math.isfinite(drift) or drift > EVAL_DRIFT_SAFE:
            warnings.warn(
                f"recalibrated checkpoint drifts {drift:.3g} (relative "
                "Frobenius at the deepest tap"
                + (", measured in-sample" if in_sample else "")
                + f") > EVAL_DRIFT_SAFE={EVAL_DRIFT_SAFE} between "
                "eval-stats and batch-stats encoding: its BN chain amplifies "
                "the eval/batch residual, so the fused engine may not "
                "reproduce the training-validated graph.  Serve with "
                "engine='flax', or train with encoder_eval_stats=True.",
                stacklevel=2)
        return cls(dataclasses.replace(model_cfg, encoder_eval_stats=True),
                   device=device,
                   state={"params": params, "batch_stats": new_stats}, **kw)

    @staticmethod
    def _restore(path: str):
        """(params, batch_stats) of the trainer checkpoint ``<path>.pt``,
        else of the JAX trainer's orbax directory ``<path>`` (tensors on
        the CPU); the optimizer state is not used, as JAX's
        ``with_opt_state=False``."""
        tree = ckpt.restore_checkpoint(ckpt.require_checkpoint(path))
        return tree["params"], tree["batch_stats"]

    def load_state(self, params, batch_stats) -> None:
        """Copy new weights into the pipeline (both engines serve them);
        with a mesh, rank 0's."""
        weights.load_state(self.ast, {"params": params,
                                      "batch_stats": batch_stats})
        if self.mesh is not None:
            self._replicate()

    # -- inference ---------------------------------------------------------

    def _inputs(self, content, style):
        """The batches on the device as float32; with a mesh, this rank's
        rows of rank 0's."""
        if self.mesh is not None:
            content, style = (shard_batch(self.mesh, x)
                              for x in (content, style))
        return (torch.as_tensor(content, dtype=torch.float32,
                                device=self.device),
                torch.as_tensor(style, dtype=torch.float32,
                                device=self.device))

    @torch.inference_mode()
    def stylize(self, content, style, alpha: float = 1.0) -> torch.Tensor:
        """Stylized (B, H, W, 3) float32 batch on the pipeline's device
        (the whole batch on every rank with a mesh)."""
        content, style = self._inputs(content, style)
        if self.engine == "flax":
            return gather_batch(self.mesh,
                                self.ast.stylize(content, style, alpha))
        kw = dict(cfg=self.cfg, dtype=self.dtype,
                  decoder_impl=self.decoder_impl,
                  encoder_impl=self.encoder_impl)
        if self.mesh is None:
            return stylize_fused(self.state, content, style, alpha, **kw)
        return gather_batch(self.mesh, stylize_fused_sharded(
            self.state, content, style, alpha, self.mesh, **kw))

    @torch.inference_mode()
    def export_forward(self, content, style) -> torch.Tensor:
        """The exporting path of the graph (``AST.export``): the clamped
        stylization, no blend, whichever the engine."""
        return gather_batch(self.mesh,
                            self.ast.export(*self._inputs(content, style)))
