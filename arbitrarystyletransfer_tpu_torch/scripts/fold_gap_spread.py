"""How far the graph engine and the fused engine's folded BatchNorm lie
apart in float64, retraining by retraining, on the card.

    python -m arbitrarystyletransfer_tpu_torch.scripts.fold_gap_spread \\
        [--retrainings 10]

Run from the repository root (it uses ``chip_smoke.py``'s lifecycle
helpers).  Each retraining runs the lifecycle phase's autoencoder and AST
stages anew (the card's training is not bitwise repeatable, so each gives
another checkpoint), recalibrates the encoder on the phase's batches as
``StylePipeline.from_checkpoint`` does, and prints one JSON object: the
drift warning, if any, and ``chip_smoke.folding_gaps`` in float64 (the
encoder, attend and decoder stages on the same inputs, which the phase
holds at ``FOLD_F64_TOL``; the whole image; the image's response to one
ulp on the taps).  Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import warnings
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--retrainings", type=int, default=10)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("fold_gap_spread: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as c

    from arbitrarystyletransfer_tpu_torch import ModelConfig
    from arbitrarystyletransfer_tpu_torch.data.pipeline import (
        ContentBatchLoader,
        FlatFolderDatasetAE,
    )
    from arbitrarystyletransfer_tpu_torch.infer import StylePipeline
    from arbitrarystyletransfer_tpu_torch.ops.kernels import _build

    _build.load_library()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=c.DEVICE).manual_seed(c.SEED + 13)
    shape = (c.BATCH, c.SIZE, c.SIZE, 3)
    content = torch.rand(shape, generator=gen, device=c.DEVICE)
    style = torch.rand(shape, generator=gen, device=c.DEVICE)
    cfg = ModelConfig(use_pallas_adaattn=True, compute_dtype="bfloat16")
    with tempfile.TemporaryDirectory() as tmp:
        dirs = c.write_images(tmp, c.SEED + 13)
        loader = ContentBatchLoader(
            c.seeded_order(FlatFolderDatasetAE(dirs), 0), batch_size=8,
            imsize=c.RECAL_SIZE, num_workers=c.LIFE_WORKERS, seed=0,
            augment=False, worker_mode="thread")
        try:
            batches = [next(loader) for _ in range(c.RECAL_BATCHES)]
        finally:
            loader.close()
        for i in range(args.retrainings):
            torch.cuda.empty_cache()
            ae_path, _ = c.life_ae(f"{tmp}/{i}", dirs)
            torch.cuda.empty_cache()
            ast_path, _ = c.life_ast(f"{tmp}/{i}", dirs, ae_path)
            torch.cuda.empty_cache()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                pipe = StylePipeline.from_checkpoint(
                    ast_path.removesuffix(".pt"), cfg, engine="fused",
                    encoder_impl="auto", decoder_impl="auto",
                    recalibrate_with=batches, allow_unstable=True,
                    device=c.DEVICE)
            print(json.dumps({
                "retraining": i + 1,
                "drift_warnings": [str(w.message) for w in caught
                                   if "drifts" in str(w.message)],
                "float64": c.folding_gaps(pipe.state, pipe.cfg, content,
                                          style, torch.float64)}),
                flush=True)
            del pipe
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
