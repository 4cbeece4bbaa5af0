"""The port's path from training to serving through its three CLIs, on the
CPU from a synthetic image folder: ``train_autoencoder`` writes ``ae.pt``,
the AST CLI warm-starts from it and writes ``ast.pt``, and ``stylize
--model`` serves that checkpoint through the graph engine (the default) and
through ``--engine fused --recalibrate_dir``.  Each PNG must equal what the
pipeline gives for the same checkpoint and images.

The autoencoder resumes (``--load``) from a checkpoint of the parity
weights (fan-in, SE gates open): at the reference initialization the
encoder's eval-stats drift is unbounded and the fused route refuses, or
warns, which ``test_torch_serving.py`` holds.  The recalibration folder
holds one image, so every batch the CLI's two loader threads make is the
same, whichever thread is first.
"""

import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from arbitrarystyletransfer_tpu_torch import ModelConfig, weights
from arbitrarystyletransfer_tpu_torch.config import AETrainConfig
from arbitrarystyletransfer_tpu_torch.infer import StylePipeline
from arbitrarystyletransfer_tpu_torch.stylize import (
    image_loader,
    recalibration_batches,
    to_uint8,
)
from arbitrarystyletransfer_tpu_torch.train import checkpoint as ckpt
from arbitrarystyletransfer_tpu_torch.train.ae_trainer import (
    AutoencoderTrainer,
)

from test_torch_autoencoder import ae_variables

REPO = Path(__file__).resolve().parents[1]
# The CLIs' processes share the CPU with the suite's other workers.
CLI_ENV = {**os.environ, "OMP_NUM_THREADS": "2"}
SIZE = 32


def _run(module, *args):
    proc = subprocess.run(
        [sys.executable, "-m", f"arbitrarystyletransfer_tpu_torch.{module}",
         *map(str, args)],
        cwd=REPO, env=CLI_ENV, capture_output=True, text=True, timeout=300)
    return proc


def _write_dataset(root):
    rng = np.random.default_rng(110)
    dirs = {}
    for sub, n in (("content", 4), ("style", 3), ("recal", 1)):
        d = root / sub
        d.mkdir(parents=True)
        for i in range(n):
            h, w = rng.integers(40, 70, 2)
            yy, xx = np.mgrid[0:h, 0:w]
            img = np.stack([xx / w, yy / h, rng.uniform(0, 1, (h, w))], -1)
            Image.fromarray((img * 255).astype(np.uint8)).save(
                d / f"img_{i}.png")
        dirs[sub] = d
    return dirs


def test_train_autoencoder_then_ast_then_stylize(tmp_path):
    dirs = _write_dataset(tmp_path / "data")
    ae_dir = tmp_path / "models" / "ae"
    seed_trainer = AutoencoderTrainer(
        AETrainConfig(save_dir=str(ae_dir)), iter(()), device="cpu",
        log_fn=lambda *a: None)
    v = ae_variables(111)
    weights.load_state(seed_trainer.model, weights.from_jax_tree(
        v["params"], v["batch_stats"]))
    seed_trainer.save()

    proc = _run("train_autoencoder", "--device", "cpu", "--load",
                "--train_iter", 2, "--batch_size", 2, "--imsize", SIZE,
                "--content_dir", dirs["content"], "--style_dir",
                dirs["style"], "--val_dir", dirs["content"], "--save_dir",
                ae_dir, "--num_workers", 1, "--worker_mode", "thread")
    assert proc.returncode == 0, proc.stderr
    assert "WARNING: no VGG-19 weight file" in proc.stdout
    ae = ckpt.restore_checkpoint(str(ae_dir / "ae.pt"))
    assert int(ae["step"]) == 2
    history = ckpt.load_history(str(ae_dir / "train_dict.json"))
    assert len(history["train_loss"]) == 2
    assert np.isfinite(history["train_loss"]).all()

    ast_dir = tmp_path / "models" / "ast"
    proc = _run("train", "--device", "cpu", "--train_iter", 2, "--img_sizes",
                SIZE, "--batch_size", 2, "--content_dir", dirs["content"],
                "--style_dir", dirs["style"], "--save_dir", ast_dir,
                "--ae_model", ae_dir / "ae", "--num_workers", 1,
                "--worker_mode", "thread", "--pallas", "--preview_dir",
                tmp_path / "previews")
    assert proc.returncode == 0, proc.stderr
    ast = ckpt.restore_checkpoint(str(ast_dir / "ast.pt"))
    assert int(ast["step"]) == 2
    # Warm-started: two Adam steps of lr 2e-4 from the autoencoder's
    # tensors (a cold start differs from them by ~1).
    for ae_key, ast_key in (("encoder", "enc"), ("ada_out", "ada_out"),
                            ("decoder", "dec")):
        a = weights.flatten({"params": ae["params"][ae_key],
                             "batch_stats": {}})
        b = weights.flatten({"params": ast["params"][ast_key],
                             "batch_stats": {}})
        assert a.keys() == b.keys()
        assert max(float((a[k] - b[k]).abs().max()) for k in a) < 2e-3

    model = ast_dir / "ast"
    content, style = dirs["content"] / "img_0.png", dirs["style"] / "img_0.png"
    images = (image_loader(content, SIZE), image_loader(style, SIZE))
    cfg = ModelConfig(use_pallas_adaattn=True)
    for engine, extra in (("flax", ()),
                          ("fused", ("--recalibrate_dir", dirs["recal"],
                                     "--recalibrate_batches", 3))):
        out_png = tmp_path / f"{engine}.png"
        proc = _run("stylize", "--device", "cpu", "--imsize", SIZE,
                    "--model", model, "--content", content, "--style", style,
                    "--output", out_png, "--alpha", 0.8, "--engine", engine,
                    *extra)
        assert proc.returncode == 0, proc.stderr
        written = np.asarray(Image.open(out_png))
        assert written.shape == (SIZE, SIZE, 3)
        recalibrate_with = (recalibration_batches([dirs["recal"]], SIZE, 3)
                            if extra else None)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the drift's, if any
            pipe = StylePipeline.from_checkpoint(
                str(model), cfg, engine=engine, device="cpu",
                recalibrate_with=recalibrate_with, decoder_impl="auto",
                encoder_impl="auto")
        assert pipe.cfg.encoder_eval_stats == bool(extra)
        np.testing.assert_array_equal(
            written, to_uint8(pipe.stylize(*images, alpha=0.8)))

    # Without recalibration the fused engine refuses the checkpoint.
    proc = _run("stylize", "--device", "cpu", "--imsize", SIZE, "--model",
                model, "--content", content, "--style", style, "--output",
                tmp_path / "refused.png", "--engine", "fused")
    assert proc.returncode != 0 and "encoder_eval_stats" in proc.stderr


def test_cli_refusals(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal needs none")
    dirs = _write_dataset(tmp_path / "data")
    proc = _run("train_autoencoder", "--content_dir", dirs["content"],
                "--style_dir", dirs["style"], "--train_iter", 1,
                "--worker_mode", "thread")
    assert proc.returncode != 0 and "CUDA is not available" in proc.stderr
    content = dirs["content"] / "img_0.png"
    proc = _run("stylize", "--model", tmp_path / "missing", "--content",
                content, "--style", content)
    assert proc.returncode != 0 and "CUDA is not available" in proc.stderr
    proc = _run("stylize", "--device", "cpu", "--weights", "w.npz",
                "--recalibrate_dir", dirs["recal"], "--content", content,
                "--style", content)
    assert proc.returncode != 0
    assert "--recalibrate_dir recalibrates a --model checkpoint" in (
        proc.stderr)
