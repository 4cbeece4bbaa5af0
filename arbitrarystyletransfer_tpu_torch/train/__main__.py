"""Stage-2 AST training CLI of the port: the twin of the repo-root
``train.py``.

    python -m arbitrarystyletransfer_tpu_torch.train --pallas \\
        --content_dir data/content --style_dir data/style

It keeps the JAX CLI's flags and defaults, with these differences:

- ``--device`` defaults to ``cuda`` and fails when CUDA is absent: the CLI
  never falls back to the CPU by itself (``--device cpu`` asks for it).
- One device: there is no mesh (multi-GPU is ROADMAP queue 1 item 11).
- ``--use_dis`` raises ``NotImplementedError``: the GAN step is a later
  slice.  ``--dw_impl`` is accepted and changes nothing (one depthwise).
- ``--ae_model <path>`` warm-starts from ``<path>.pt``, a Stage-1 AE
  checkpoint in the port's format, when that file exists; checkpoints are
  written to ``<save_dir>/ast.pt``.
- ``--pallas`` runs AdaAttN through the hand-written CUDA kernels (forward
  and backward; their plain twins on the CPU).
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..config import ASTTrainConfig, ModelConfig
from ..data.pipeline import FlatFolderDataset, PairedBatchLoader
from .ast_trainer import ASTTrainer


def main(args) -> None:
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train: --device cuda, but CUDA is not available "
                         "(pass --device cpu to train on the CPU)")
    cfg = ASTTrainConfig(
        train_iter=args.train_iter, batch_size=args.batch_size, lr=args.lr,
        dis_lr=args.dis_lr, dis_lam=args.dis_lam,
        content_lam=args.content_lam, org_img_lam=args.org_img_lam,
        style_lam=args.style_lam, tv_lam=args.tv_lam, lf_lam=args.lf_lam,
        r1_lam=args.r1_lam, save_dir=args.save_dir, ae_model=args.ae_model,
        load=args.load, recon_lam=args.recon_lam, perp_lam=args.perp_lam,
        use_dis=args.use_dis)
    model_cfg = ModelConfig(compute_dtype=args.dtype,
                            use_pallas_adaattn=args.pallas,
                            depthwise_impl=args.dw_impl)
    dataset = FlatFolderDataset(args.content_dir, args.style_dir,
                                seed=args.seed)
    content_iter = PairedBatchLoader(
        dataset, batch_size=args.batch_size, img_sizes=tuple(args.img_sizes),
        num_workers=args.num_workers, seed=args.seed,
        worker_mode=args.worker_mode)
    try:
        trainer = ASTTrainer(
            cfg, content_iter, model_cfg=model_cfg, seed=args.seed,
            vgg_weights=args.vgg_weights, preview_dir=args.preview_dir,
            debug_stats=args.debug_stats, device=device)
        trainer.train()
    finally:
        content_iter.close()


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--train_iter", type=int, default=2048000,
                   help="Number of train iterations (batches).")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--lr", type=float, default=2e-4, help="Learning rate.")
    p.add_argument("--dis_lr", type=float, default=1e-5,
                   help="Discriminator learning rate (GAN slice).")
    p.add_argument("--dis_lam", type=float, default=1e-3,
                   help="Discriminator loss weight (GAN slice).")
    p.add_argument("--content_lam", type=float, default=1.25)
    p.add_argument("--org_img_lam", type=float, default=0.5,
                   help="Weight of the identity reconstruction loss.")
    p.add_argument("--style_lam", type=float, default=0.5)
    p.add_argument("--tv_lam", type=float, default=0.0006)
    p.add_argument("--lf_lam", type=float, default=1.0)
    p.add_argument("--r1_lam", type=float, default=5.0)
    p.add_argument("--use_dis", action="store_true",
                   help="Adversarial training; not ported yet (raises).")
    p.add_argument("--save_dir", default="models/ast/")
    p.add_argument("--ae_model", default="models/auto_encoder/ae",
                   help="Stage-1 AE checkpoint; <ae_model>.pt is read if it "
                        "exists.")
    p.add_argument("--load", action="store_true",
                   help="Resume from <save_dir>/ast.pt.")
    p.add_argument("--recon_lam", type=float, default=100.0)
    p.add_argument("--perp_lam", type=float, default=0.01)
    p.add_argument("--content_dir", nargs="+",
                   default=["temp_dataset/content/"])
    p.add_argument("--style_dir", nargs="+", default=["temp_dataset/style/"])
    p.add_argument("--img_sizes", type=int, nargs="+", default=[96, 128, 160],
                   help="Resolution buckets; each batch draws H and W.")
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--worker_mode", default="process",
                   choices=["process", "thread"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="Compute dtype of the conv path (params stay f32).")
    p.add_argument("--pallas", action="store_true",
                   help="AdaAttN through the hand-written kernels.")
    p.add_argument("--dw_impl", default="conv", choices=["conv", "shifts"],
                   help="Accepted for parity; one depthwise either way.")
    p.add_argument("--debug_stats", action="store_true",
                   help="Log tensor ranges and per-parameter |grad| means at "
                        "each log boundary.")
    p.add_argument("--vgg_weights", default=None,
                   help="torchvision vgg19 weights (.pth or .npz).")
    p.add_argument("--preview_dir", default="previews/",
                   help="Directory for alpha-{0,.5,1} preview strips.")
    p.add_argument("--device", default="cuda",
                   help="Torch device (default cuda; never falls back).")
    return p.parse_args(argv)


if __name__ == "__main__":
    main(parse_args(sys.argv[1:]))
