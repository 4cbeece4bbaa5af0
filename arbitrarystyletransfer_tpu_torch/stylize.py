"""Stylization CLI of the port: the twin of the repo-root ``stylize.py``.

    python -m arbitrarystyletransfer_tpu_torch.stylize \\
        --content c.png --style s.png --model models/ast/ast

It keeps the JAX CLI's flags and defaults (``--model models/ast/ast``,
``--engine flax``, ``--imsize 320``, ``--encoder auto --decoder auto``,
``--recalibrate_dir``, ``--recalibrate_batches 16``), with these
differences:

- ``--model <path>`` reads the trainer checkpoint ``<path>.pt`` (the port's
  trainers write ``<save_dir>/ast.pt``), else the JAX trainer's orbax
  directory ``<path>`` (where ``tensorstore`` is installed; elsewhere
  convert it first: ``python -m arbitrarystyletransfer_tpu_torch.
  convert_orbax SAVE_DIR``).  ``--weights <npz>`` (a ``weights.save_npz``
  state) takes its place when given.
- ``--device`` defaults to ``cuda`` and fails, before any file is read,
  when CUDA is absent: the CLI never falls back to the CPU by itself
  (``--device cpu`` asks for it).
- The AdaAttN statistics take the ``adaattn_fwd`` kernel (its plain twin on
  the CPU) in both engines; the compute dtype stays ``ModelConfig``'s
  float32.
- ``--encoder/--decoder mega`` sends blocks to the ``mega_block`` kernel
  only at sizes that are a multiple of 128 (512 and 256, not the default
  320), as the JAX route does.

``--engine fused`` serves a checkpoint trained with the default batch
statistics only after ``--recalibrate_dir`` has rebuilt its encoder's
running statistics (or with ``--encoder_eval_stats`` for a checkpoint
trained that way).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch
from PIL import Image

from .config import ModelConfig
from .data.pipeline import ContentBatchLoader, FlatFolderDatasetAE
from .infer import StylePipeline

IMSIZE = 320  # the JAX package's config.IMSIZE
IMPLS = ("fused", "mega", "flat", "flat-all", "auto")


def image_loader(path, imsize: int) -> np.ndarray:
    """(1, imsize, imsize, 3) float32 in [0, 1]: the JAX package's
    ``data.pipeline.image_loader`` (RGB, bilinear resize of the 8-bit
    image)."""
    img = np.asarray(Image.open(str(path)).convert("RGB"),
                     dtype=np.float32) / 255.0
    img = Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))
    img = img.resize((imsize, imsize), Image.BILINEAR)
    return (np.asarray(img, dtype=np.float32) / 255.0)[None]


def to_uint8(out: torch.Tensor) -> np.ndarray:
    """The first image of a stylized batch as 8-bit RGB."""
    return (np.clip(out[0].float().cpu().numpy(), 0, 1) * 255).astype(np.uint8)


def recalibration_batches(dirs, imsize: int, n: int):
    """``n`` batches of 8 content images at ``imsize`` from ``dirs`` (the
    JAX CLI's loader: seed 0, no augmentation, two threads)."""
    loader = ContentBatchLoader(FlatFolderDatasetAE(dirs, seed=0),
                                batch_size=8, imsize=imsize, num_workers=2,
                                seed=0, augment=False, worker_mode="thread")
    try:
        return [next(loader) for _ in range(n)]
    finally:
        loader.close()


def main(args) -> None:
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("stylize: --device cuda, but CUDA is not available "
                         "(pass --device cpu to run on the CPU)")
    cfg = ModelConfig(encoder_eval_stats=args.encoder_eval_stats,
                      use_pallas_adaattn=True)
    kw = dict(engine=args.engine, device=device, decoder_impl=args.decoder,
              encoder_impl=args.encoder)
    if args.weights:
        pipeline = StylePipeline.from_npz(args.weights, cfg, **kw)
    else:
        recalibrate_with = None
        if args.recalibrate_dir:
            recalibrate_with = recalibration_batches(
                args.recalibrate_dir, args.imsize, args.recalibrate_batches)
        pipeline = StylePipeline.from_checkpoint(
            args.model, cfg, recalibrate_with=recalibrate_with, **kw)
    content = image_loader(args.content, args.imsize)
    style = image_loader(args.style, args.imsize)
    out = pipeline.stylize(content, style, alpha=args.alpha)
    Image.fromarray(to_uint8(out)).save(args.output)
    print(f"wrote {args.output}")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--content", required=True, help="Content image path.")
    parser.add_argument("--style", required=True, help="Style image path.")
    parser.add_argument("--output", default="stylized.png")
    parser.add_argument("--model", default="models/ast/ast",
                        help="AST trainer checkpoint: <model>.pt, else "
                             "the JAX trainer's orbax directory <model>.")
    parser.add_argument("--weights", default=None,
                        help="A weights.save_npz state, read in place of "
                             "--model.")
    parser.add_argument("--alpha", type=float, default=1.0,
                        help="Style interpolation strength (0 = content "
                             "identity).")
    parser.add_argument("--imsize", type=int, default=IMSIZE,
                        help="Inference resolution.")
    parser.add_argument("--decoder", default="auto", choices=IMPLS,
                        help="Decoder block routes (see "
                             "engine.stylize_fused); mega takes its kernel "
                             "only at sizes that are a multiple of 128.")
    parser.add_argument("--encoder", default="auto", choices=IMPLS,
                        help="Encoder block routes (same choices).")
    parser.add_argument("--engine", default="flax",
                        choices=["flax", "fused"],
                        help="Inference engine: the module graph or the "
                             "fused engine (running-stats encoder "
                             "semantics: --encoder_eval_stats or "
                             "--recalibrate_dir).")
    parser.add_argument("--recalibrate_dir", nargs="*", default=[],
                        help="Image directories for BN recalibration: "
                             "rebuilds the encoder's running statistics so "
                             "that a default-trained --model can use "
                             "--engine fused.")
    parser.add_argument("--recalibrate_batches", type=int, default=16,
                        help="Number of batch-8 recalibration batches.")
    parser.add_argument("--encoder_eval_stats",
                        action=argparse.BooleanOptionalAction, default=False,
                        help="Normalize encoder BN with running statistics; "
                             "must match how the checkpoint was trained.")
    parser.add_argument("--device", default="cuda",
                        help="Torch device (default cuda; never falls back).")
    args = parser.parse_args(argv)
    if args.weights and args.recalibrate_dir:
        parser.error("--recalibrate_dir recalibrates a --model checkpoint, "
                     "not --weights")
    return args


if __name__ == "__main__":
    main(parse_args(sys.argv[1:]))
