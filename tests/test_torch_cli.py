"""The port's stylize CLI (``python -m arbitrarystyletransfer_tpu_torch.stylize``).

It runs in a subprocess on the CPU at 64px and must write the PNG that
``StylePipeline.stylize`` gives for the same images; without CUDA it refuses
the default ``--device cuda``.  Its image loader must equal the JAX
package's.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from arbitrarystyletransfer_tpu.data.pipeline import image_loader as jax_loader

from arbitrarystyletransfer_tpu_torch import ModelConfig, weights
from arbitrarystyletransfer_tpu_torch.infer import StylePipeline
from arbitrarystyletransfer_tpu_torch.stylize import image_loader, to_uint8

from test_torch_ops import ast_variables

REPO = Path(__file__).resolve().parents[1]


def _write_images(tmp_path):
    rng = np.random.default_rng(0)
    paths = []
    for name, (h, w) in (("content.png", (70, 90)), ("style.png", (80, 60))):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        Image.fromarray(img).save(tmp_path / name)
        paths.append(tmp_path / name)
    return paths


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "arbitrarystyletransfer_tpu_torch.stylize",
         *map(str, args)],
        cwd=REPO, capture_output=True, text=True, timeout=300)


def test_image_loader_matches_jax(tmp_path):
    content, _ = _write_images(tmp_path)
    np.testing.assert_array_equal(image_loader(content, 48),
                                  jax_loader(str(content), 48))


@pytest.mark.parametrize("impl", ["auto", "flat-all", "mega"])
def test_cli_writes_the_pipeline_image(tmp_path, impl):
    content, style = _write_images(tmp_path)
    v = ast_variables(seed=10)
    state = weights.from_jax_tree(v["params"], v["batch_stats"])
    weights.save_npz(tmp_path / "w.npz", state)
    out_png = tmp_path / "out.png"
    proc = _cli("--device", "cpu", "--imsize", 64, "--weights",
                tmp_path / "w.npz", "--content", content, "--style", style,
                "--output", out_png, "--alpha", 0.8, "--encoder_eval_stats",
                "--encoder", impl, "--decoder", impl, "--engine", "fused")
    assert proc.returncode == 0, proc.stderr
    written = np.asarray(Image.open(out_png))
    assert written.shape == (64, 64, 3)

    cfg = ModelConfig(encoder_eval_stats=True, use_pallas_adaattn=True)
    pipe = StylePipeline(cfg, engine="fused", state=state, encoder_impl=impl,
                         decoder_impl=impl, device="cpu")
    out = pipe.stylize(image_loader(content, 64), image_loader(style, 64),
                       alpha=0.8)
    np.testing.assert_array_equal(written, to_uint8(out))


def test_cli_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal needs none")
    content, style = _write_images(tmp_path)
    proc = _cli("--weights", tmp_path / "missing.npz", "--content", content,
                "--style", style, "--encoder_eval_stats")
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
