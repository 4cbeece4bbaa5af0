"""Where the autoencoder's f32 loss departs from float64, batch by batch, on
the card.

    python -m arbitrarystyletransfer_tpu_torch.scripts.ae_loss_spread \\
        [--batches 8]

Run from the repository root (it uses ``chip_smoke.py``'s lifecycle
helpers).  Builds the lifecycle phase's ``AutoencoderTrainer`` (256px batch
16, the parity tests' weights, the seeded random VGG) and its loader over
the phase's synthetic PNGs, and for each of the loader's first
``--batches`` batches prints one JSON object: the loss's parts (recon,
perceptual, total) in float32 and their relative distance to the same
parts through float64 copies of the model, and the largest distance of
the float32 total over ``dp_orders``' row orders of the batch
(``orders``) with the phase's limit from it.  The phase holds batch 1's
total within ``AE_ORDER_FACTOR`` times that spread, floored at
``AE_LOSS_TOL``; this shows how the other batches' lie.  Needs CUDA.
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
import tempfile
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, default=8)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("ae_loss_spread: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as c

    from arbitrarystyletransfer_tpu_torch import ModelConfig, weights
    from arbitrarystyletransfer_tpu_torch.config import AETrainConfig
    from arbitrarystyletransfer_tpu_torch.data.pipeline import (
        ContentBatchLoader,
        FlatFolderDatasetAE,
    )
    from arbitrarystyletransfer_tpu_torch.train.ae_trainer import (
        AutoencoderTrainer,
        ae_loss,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        dirs = c.write_images(tmp, c.SEED + 13)
        cfg = AETrainConfig(batch_size=c.LIFE_AE_BATCH,
                            ae_imsize=c.LIFE_AE_SIZE, save_dir=f"{tmp}/ae")
        loader = ContentBatchLoader(
            c.seeded_order(FlatFolderDatasetAE(dirs), c.SEED),
            batch_size=cfg.batch_size, imsize=cfg.ae_imsize,
            num_workers=c.LIFE_WORKERS, seed=c.SEED, augment=False,
            worker_mode="thread")
        try:
            batches = [next(loader) for _ in range(args.batches)]
        finally:
            loader.close()
    trainer = AutoencoderTrainer(cfg, iter(()), seed=c.SEED,
                                 device=c.DEVICE, log_fn=lambda *a: None)
    weights.load_state(trainer.model,
                       c.ae_state(c.random_state(ModelConfig(), c.SEED)))

    def parts(batch, dtype, rows=None):
        model = copy.deepcopy(trainer.model).to(dtype)
        vgg = copy.deepcopy(trainer.vgg).to(dtype)
        x = torch.as_tensor(batch, dtype=dtype, device=c.DEVICE)
        with torch.no_grad():
            _, aux = ae_loss(model, vgg, cfg,
                             x if rows is None else x[list(rows)])
        return {k: float(v) for k, v in aux.items()}

    for i, batch in enumerate(batches):
        f32, f64 = parts(batch, torch.float32), parts(batch, torch.float64)
        orders = max(abs(parts(batch, torch.float32, rows)["loss"]
                         - f64["loss"]) / abs(f64["loss"])
                     for rows in c.dp_orders(len(batch)))
        print(json.dumps({
            "batch": i + 1, "f32": f32,
            "relative": {k: (f32[k] - f64[k]) / abs(f64[k]) for k in f64},
            "orders": orders,
            "limit": max(c.AE_LOSS_TOL, c.AE_ORDER_FACTOR * orders)}),
            flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
