"""Batched stylization on one device: the fused-engine half of
``arbitrarystyletransfer_tpu/infer.StylePipeline``.

Checkpoint restore from the trainers' format and BatchNorm recalibration
come with the serving work (ROADMAP queue 1 item 6).
"""

from __future__ import annotations

import torch

from .config import ModelConfig, torch_dtype
from .engine import stylize_fused
from .weights import init_params, load_npz, to_device


class StylePipeline:
    """Alpha-interpolated stylization of NHWC [0, 1] batches."""

    def __init__(self, model_cfg: ModelConfig = ModelConfig(),
                 engine: str = "fused", device="cuda", state=None,
                 seed: int = 0, decoder_impl: str = "fused",
                 encoder_impl: str = "fused"):
        """``state`` is a weights.py state (a seeded ``init_params`` one
        when None), for instance the params and batch_stats of a trainer
        checkpoint.  ``device`` defaults to the card and never falls back:
        a CPU run asks for ``device="cpu"``.  ``decoder_impl`` and
        ``encoder_impl`` choose the engine's block routes ("fused", "flat",
        "flat-all", "auto"; see ``engine.stylize_fused``).  The fused engine folds BatchNorm running
        statistics, so a config with ``encoder_eval_stats=False`` is
        refused, as in the JAX pipeline: a checkpoint trained with batch
        statistics would be served with different encoder math."""
        if engine != "fused":
            raise NotImplementedError(
                f"engine={engine!r}: the port serves the fused engine only; "
                "the flax-graph engine is ROADMAP queue 1 item 7")
        if not model_cfg.encoder_eval_stats:
            raise ValueError(
                "engine='fused' folds BatchNorm running statistics "
                "(encoder_eval_stats=True semantics), but this ModelConfig "
                "has encoder_eval_stats=False (batch-stats inference, the "
                "training default).  Construct the pipeline with "
                "dataclasses.replace(cfg, encoder_eval_stats=True) only for "
                "a checkpoint trained or validated with eval-stats "
                "semantics.")
        self.cfg = model_cfg
        self.decoder_impl, self.encoder_impl = decoder_impl, encoder_impl
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("StylePipeline: device cuda, but CUDA is not "
                               "available (pass device='cpu' to run on the "
                               "CPU)")
        self.dtype = torch_dtype(model_cfg)
        if state is None:
            state = init_params(model_cfg, torch.Generator().manual_seed(seed))
        self.state = to_device(state, self.device)

    @classmethod
    def from_npz(cls, path, model_cfg: ModelConfig = ModelConfig(), **kw):
        """A pipeline over a state written by ``weights.save_npz``."""
        return cls(model_cfg, state=load_npz(path), **kw)

    @torch.inference_mode()
    def stylize(self, content, style, alpha: float = 1.0) -> torch.Tensor:
        """Stylized (B, H, W, 3) float32 batch on the pipeline's device."""
        content = torch.as_tensor(content, dtype=torch.float32,
                                  device=self.device)
        style = torch.as_tensor(style, dtype=torch.float32,
                                device=self.device)
        return stylize_fused(self.state, content, style, alpha,
                             cfg=self.cfg, dtype=self.dtype,
                             decoder_impl=self.decoder_impl,
                             encoder_impl=self.encoder_impl)
