"""Stylization CLI of the port: the twin of the repo-root ``stylize.py``.

    python -m arbitrarystyletransfer_tpu_torch.stylize \\
        --content c.png --style s.png --weights ast.npz --encoder_eval_stats

It keeps the JAX CLI's flags and defaults (``--imsize 320``, ``--encoder
auto --decoder auto``), with these differences:

- ``--weights <npz>`` (a ``weights.save_npz`` state) stands where ``--model``
  reads a trainer checkpoint; restoring those is ROADMAP queue 1 item 6.
- ``--device`` defaults to ``cuda`` and fails when CUDA is absent: the CLI
  never falls back to the CPU by itself (``--device cpu`` asks for it).
- ``--engine`` defaults to ``fused``, the only engine the port serves; the
  flax-graph engine and ``--recalibrate_dir`` raise ``NotImplementedError``.
- The AdaAttN statistics take the ``adaattn_fwd`` kernel (its plain twin on
  the CPU); the compute dtype stays ``ModelConfig``'s float32.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch
from PIL import Image

from .config import ModelConfig
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


def main(args) -> None:
    if args.engine != "fused":
        raise NotImplementedError(
            f"--engine {args.engine}: the port serves the fused engine only; "
            "the flax-graph engine is ROADMAP queue 1 item 7")
    if args.recalibrate_dir:
        raise NotImplementedError(
            "--recalibrate_dir: BN recalibration is ROADMAP queue 1 item 6 "
            "(serving)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("stylize: --device cuda, but CUDA is not available "
                         "(pass --device cpu to run on the CPU)")
    cfg = ModelConfig(encoder_eval_stats=args.encoder_eval_stats,
                      use_pallas_adaattn=True)
    pipeline = StylePipeline.from_npz(
        args.weights, cfg, device=device, decoder_impl=args.decoder,
        encoder_impl=args.encoder)
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
    parser.add_argument("--weights", required=True,
                        help="Model state written by weights.save_npz.")
    parser.add_argument("--alpha", type=float, default=1.0,
                        help="Style interpolation strength (0 = content "
                             "identity).")
    parser.add_argument("--imsize", type=int, default=IMSIZE,
                        help="Inference resolution.")
    parser.add_argument("--decoder", default="auto", choices=IMPLS,
                        help="Decoder block routes (see "
                             "engine.stylize_fused).")
    parser.add_argument("--encoder", default="auto", choices=IMPLS,
                        help="Encoder block routes (same choices).")
    parser.add_argument("--engine", default="fused",
                        choices=["flax", "fused"],
                        help="Inference engine; the port has the fused one.")
    parser.add_argument("--recalibrate_dir", nargs="*", default=[],
                        help="Not ported: BN recalibration directories.")
    parser.add_argument("--recalibrate_batches", type=int, default=16,
                        help="Number of batch-8 recalibration batches.")
    parser.add_argument("--encoder_eval_stats",
                        action=argparse.BooleanOptionalAction, default=False,
                        help="Normalize encoder BN with running statistics; "
                             "must match how the weights were trained, and "
                             "the fused engine requires it.")
    parser.add_argument("--device", default="cuda",
                        help="Torch device (default cuda; never falls back).")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args(sys.argv[1:]))
