"""Stage-1 autoencoder training CLI of the port: the twin of the repo-root
``train_autoencoder.py``.

    python -m arbitrarystyletransfer_tpu_torch.train_autoencoder \\
        --content_dir data/content --style_dir data/style

It keeps the JAX CLI's flags and defaults: the autoencoder trains over the
content and style directories together, at ``--imsize`` (256) without
augmentation; the ``--val_dir`` loader augments.  Differences:

- ``--device`` defaults to ``cuda`` and fails when CUDA is absent: the CLI
  never falls back to the CPU by itself (``--device cpu`` asks for it).
- Under ``torchrun --nproc_per_node N`` it trains data-parallel, one
  process per card, as the train CLI does (``--batch_size`` the global
  batch, ``--dist_backend`` nccl or gloo; rank 0 reads the data and
  writes).  ``--dw_impl`` is accepted and changes nothing (one depthwise).
- The checkpoint is ``<save_dir>/ae.pt``, which the AST trainer's
  ``--ae_model <save_dir>/ae`` warm-starts from; ``--load`` resumes from it
  or from the JAX trainer's orbax directory ``<save_dir>/ae``.
"""

from __future__ import annotations

import argparse
import sys

import torch

from .config import AETrainConfig, ModelConfig
from .data.pipeline import ContentBatchLoader, FlatFolderDatasetAE
from .parallel.mesh import create_mesh, destroy_mesh
from .train.ae_trainer import AutoencoderTrainer


def main(args) -> None:
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train_autoencoder: --device cuda, but CUDA is not "
                         "available (pass --device cpu to train on the CPU)")
    mesh = create_mesh(device, args.dist_backend)
    try:
        _train(args, mesh)
    finally:
        destroy_mesh(mesh)


def _train(args, mesh) -> None:
    content_iter = val_loader = None
    if mesh.rank == 0:
        # The reference trains the AE over content + style directories
        # combined.
        dataset = FlatFolderDatasetAE(args.content_dir + args.style_dir,
                                      seed=args.seed)
        content_iter = ContentBatchLoader(
            dataset, batch_size=args.batch_size, imsize=args.imsize,
            num_workers=args.num_workers, seed=args.seed, augment=False,
            worker_mode=args.worker_mode)
    elif args.val_dir:
        val_loader = iter(())  # validates; rank 0's batches are read
    try:
        if args.val_dir and mesh.rank == 0:
            val_loader = ContentBatchLoader(
                FlatFolderDatasetAE(args.val_dir, seed=args.seed + 1),
                batch_size=args.batch_size, imsize=args.imsize,
                num_workers=2, seed=args.seed + 1, augment=True,
                worker_mode=args.worker_mode)
        cfg = AETrainConfig(
            train_iter=args.train_iter, batch_size=args.batch_size,
            lr=args.lr, save_dir=args.save_dir, load=args.load,
            recon_lam=args.recon_lam, perp_lam=args.perp_lam,
            ae_imsize=args.imsize)
        model_cfg = ModelConfig(compute_dtype=args.dtype,
                                depthwise_impl=args.dw_impl)
        trainer = AutoencoderTrainer(
            cfg, content_iter, val_loader, model_cfg=model_cfg,
            seed=args.seed, vgg_weights=args.vgg_weights, device=mesh.device,
            mesh=mesh)
        trainer.train()
    finally:
        for loader in (content_iter, val_loader):
            if hasattr(loader, "close"):
                loader.close()


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--train_iter", type=int, default=8192,
                   help="Number of train iterations (batches).")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--lr", type=float, default=2e-4, help="Learning rate.")
    p.add_argument("--save_dir", default="models/auto_encoder/",
                   help="Directory of ae.pt and train_dict.json.")
    p.add_argument("--load", action="store_true",
                   help="Resume from <save_dir>/ae.pt, else from the JAX "
                        "trainer's orbax directory <save_dir>/ae.")
    p.add_argument("--recon_lam", type=float, default=100.0,
                   help="Reconstruction loss weight.")
    p.add_argument("--perp_lam", type=float, default=0.01,
                   help="Perceptual loss weight.")
    p.add_argument("--content_dir", nargs="+",
                   default=["temp_dataset/content/"])
    p.add_argument("--style_dir", nargs="+", default=["temp_dataset/style/"])
    p.add_argument("--val_dir", nargs="*", default=[],
                   help="Validation image directories.")
    p.add_argument("--imsize", type=int, default=256,
                   help="AE training resolution.")
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--worker_mode", default="process",
                   choices=["process", "thread"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--vgg_weights", default=None,
                   help="torchvision vgg19 weights (.pth or .npz).")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="Compute dtype of the conv path (params stay f32).")
    p.add_argument("--dw_impl", default="conv", choices=["conv", "shifts"],
                   help="Accepted for parity; one depthwise either way.")
    p.add_argument("--device", default="cuda",
                   help="Torch device (default cuda; never falls back).")
    p.add_argument("--dist_backend", default=None, choices=["nccl", "gloo"],
                   help="torch.distributed backend under torchrun (default "
                        "nccl on cuda, gloo on cpu).")
    return p.parse_args(argv)


if __name__ == "__main__":
    main(parse_args(sys.argv[1:]))
