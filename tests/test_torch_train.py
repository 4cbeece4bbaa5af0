"""The port's training pieces on the CPU: the optimizer against optax, the
finite guard, checkpoints (and serving one), the AE -> AST transplant, the
data pipeline against the JAX one, and the training CLI.

Trainers run the full-width ``ModelConfig`` at 32px, batch 2, on the CPU
(``device="cpu"``), with the seeded random VGG.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from arbitrarystyletransfer_tpu.data import pipeline as jax_pipeline
from arbitrarystyletransfer_tpu.train import checkpoint as jax_ckpt

from arbitrarystyletransfer_tpu_torch import ModelConfig, weights
from arbitrarystyletransfer_tpu_torch.config import ASTTrainConfig
from arbitrarystyletransfer_tpu_torch.data import pipeline
from arbitrarystyletransfer_tpu_torch.infer import StylePipeline
from arbitrarystyletransfer_tpu_torch.train import checkpoint as ckpt
from arbitrarystyletransfer_tpu_torch.train.ast_trainer import ASTTrainer
from arbitrarystyletransfer_tpu_torch.train.state import Adam

REPO = Path(__file__).resolve().parents[1]
# The CLI's process shares the CPU with the suite's other workers.
CLI_ENV = {**os.environ, "OMP_NUM_THREADS": "2"}


def _batches(seed, b=2, size=32):
    rng = np.random.default_rng(seed)
    while True:
        yield (rng.uniform(0, 1, (b, size, size, 3)).astype(np.float32),
               rng.uniform(0, 1, (b, size, size, 3)).astype(np.float32))


def _trainer(tmp_path, seed=0, **cfg):
    cfg = ASTTrainConfig(save_dir=str(tmp_path / "ast"), ae_model="",
                         batch_size=2, **cfg)
    return ASTTrainer(cfg, _batches(seed), ModelConfig(use_pallas_adaattn=True),
                      seed=seed, device="cpu", log_fn=lambda *a: None)


@pytest.mark.parametrize("clip", [2.0, None])
def test_adam_matches_optax(clip):
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 3)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    params = {k: torch.tensor(v) for k, v in p0.items()}
    opt = Adam(list(params.items()), 2e-4, 0.9, 0.999, 1e-5, clip)
    chain = [optax.clip_by_global_norm(clip)] if clip else []
    tx = optax.chain(*chain, optax.adam(2e-4, 0.9, 0.999, 1e-5))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    for i in range(5):  # gradients below and above the clip norm
        g = {k: (rng.normal(size=s) * (3.0 if i % 2 else 0.1)).astype(
            np.float32) for k, s in shapes.items()}
        norm, ok = opt.apply_if_finite([torch.tensor(g[k]) for k in params])
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, jp)
        jp = optax.apply_updates(jp, updates)
        assert bool(ok)
        assert float(norm) == pytest.approx(float(optax.global_norm(g)),
                                            rel=1e-6)
        for k in params:
            # The same f32 formulas: within a few ulps.
            np.testing.assert_allclose(params[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)
    adam_state = state[-1][0]
    assert int(opt.count) == int(adam_state.count) == 5
    mu = opt.state_dict()["mu"]
    for k in params:
        np.testing.assert_allclose(mu[k].numpy(), np.asarray(adam_state.mu[k]),
                                   rtol=1e-6, atol=1e-9)


def test_nonfinite_step_changes_nothing(tmp_path):
    trainer = _trainer(tmp_path)
    trainer.train_step(*next(trainer.content_iter))  # moments, step 1
    before = {k: v.clone() for k, v in weights.flatten(
        weights.module_state(trainer.ast)).items()}
    opt_before = (trainer.opt.mu.clone(), trainer.opt.nu.clone(),
                  trainer.opt.count.clone())
    content, style = next(trainer.content_iter)
    content[0, 3, 4, 1] = np.nan
    aux = trainer.train_step(content, style)
    assert not bool(aux["finite"])
    after = weights.flatten(weights.module_state(trainer.ast))
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert any(k.startswith("batch_stats/") for k in before)
    for old, new in zip(opt_before, (trainer.opt.mu, trainer.opt.nu,
                                     trainer.opt.count)):
        assert torch.equal(old, new)
    assert int(trainer.step) == 1
    with pytest.raises(FloatingPointError, match="update was skipped"):
        trainer._drain_aux([aux], first_iter=2)


def test_checkpoint_round_trip_and_serving(tmp_path):
    trainer = _trainer(tmp_path, seed=3, save_every=2, log_every=1)
    trainer.train(num_iters=2, log_fn=lambda *a: None)
    assert ckpt.checkpoint_exists(trainer.save_file)
    history = ckpt.load_history(trainer.train_dict_file)
    assert all(len(history[k]) == 2 for k in history)

    resumed = _trainer(tmp_path, seed=4, load=True)
    saved = weights.flatten(weights.module_state(trainer.ast))
    loaded = weights.flatten(weights.module_state(resumed.ast))
    assert saved.keys() == loaded.keys()
    assert all(torch.equal(saved[k], loaded[k]) for k in saved)
    for key in ("mu", "nu", "count"):
        assert torch.equal(getattr(trainer.opt, key),
                           getattr(resumed.opt, key))
    assert int(resumed.step) == 2 and resumed.train_dict == history

    # The checkpoint's params and batch_stats are a weights.py state: they
    # serve through the pipeline as they are.
    tree = ckpt.restore_checkpoint(trainer.save_file)
    cfg = ModelConfig(encoder_eval_stats=True)
    pipe = StylePipeline(cfg, device="cpu", state={
        "params": tree["params"], "batch_stats": tree["batch_stats"]})
    content, style = next(_batches(5))
    out = pipe.stylize(content, style, 0.5)
    assert out.shape == (2, 32, 32, 3) and bool(torch.isfinite(out).all())


def test_transplant_matches_jax():
    rng = np.random.default_rng(6)

    def tree(*names):
        return {n: {"w": rng.normal(size=3).astype(np.float32)}
                for n in names}

    ae_p, ae_s = tree("encoder", "ada_out", "decoder"), tree("encoder")
    ast_p = tree("enc", "ada_att_1", "ada_att_2", "ada_out", "dec")
    ast_s = tree("enc")
    got = ckpt.transplant_ae_to_ast(ae_p, ae_s, ast_p, ast_s)
    ref = jax_ckpt.transplant_ae_to_ast(ae_p, ae_s, ast_p, ast_s)
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        assert all(g[k] is r[k] for k in g)


def test_ae_warm_start(tmp_path):
    donor = _trainer(tmp_path, seed=7)
    state = weights.module_state(donor.ast)
    ae = {"params": {"encoder": state["params"]["enc"],
                     "ada_out": state["params"]["ada_out"],
                     "decoder": state["params"]["dec"]},
          "batch_stats": {"encoder": state["batch_stats"]["enc"]}}
    ckpt.save_checkpoint(str(tmp_path / "ae.pt"), ae, {}, 0)
    cfg = ASTTrainConfig(save_dir=str(tmp_path / "ast"),
                         ae_model=str(tmp_path / "ae"))
    warm = ASTTrainer(cfg, _batches(8), ModelConfig(), seed=9, device="cpu",
                      log_fn=lambda *a: None)
    got = weights.flatten(weights.module_state(warm.ast))
    donor_flat = weights.flatten(state)
    fresh = weights.flatten(weights.module_state(_trainer(tmp_path, 9).ast))
    for key, value in got.items():
        expected = fresh[key] if "/ada_att_" in key else donor_flat[key]
        assert torch.equal(value, expected), key


def _write_dataset(root, n=4):
    rng = np.random.default_rng(10)
    for sub in ("content", "style"):
        d = root / sub
        d.mkdir(parents=True)
        for i in range(n):
            h, w = rng.integers(40, 70, 2)
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                            ).save(d / f"img_{i}.png")
    return [str(root / "content")], [str(root / "style")]


@pytest.mark.parametrize("augment", [True, False])
def test_pipeline_batches_match_jax(tmp_path, augment):
    content_dirs, style_dirs = _write_dataset(tmp_path)
    loaders = [mod.PairedBatchLoader(
        mod.FlatFolderDataset(content_dirs, style_dirs, seed=11),
        batch_size=3, img_sizes=(24, 32), num_workers=1, seed=11,
        augment=augment, worker_mode="thread")
        for mod in (pipeline, jax_pipeline)]
    try:
        for _ in range(3):
            (c, s), (rc, rs) = (next(loader) for loader in loaders)
            assert c.dtype == np.float32 and c.shape[0] == 3
            np.testing.assert_array_equal(c, rc)
            np.testing.assert_array_equal(s, rs)
    finally:
        for loader in loaders:
            loader.close()


def test_cli_trains_and_writes_a_checkpoint(tmp_path):
    content_dirs, style_dirs = _write_dataset(tmp_path / "data")
    save_dir = tmp_path / "models"
    proc = subprocess.run(
        [sys.executable, "-m", "arbitrarystyletransfer_tpu_torch.train",
         "--device", "cpu", "--train_iter", "2", "--img_sizes", "32",
         "--batch_size", "2", "--content_dir", *content_dirs,
         "--style_dir", *style_dirs, "--save_dir", str(save_dir),
         "--ae_model", str(tmp_path / "none"), "--num_workers", "1",
         "--worker_mode", "thread", "--pallas",
         "--preview_dir", str(tmp_path / "previews")],
        cwd=REPO, env=CLI_ENV, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "WARNING: no VGG-19 weight file" in proc.stdout
    tree = ckpt.restore_checkpoint(str(save_dir / "ast.pt"))
    assert int(tree["step"]) == 2
    history = ckpt.load_history(str(save_dir / "ast_train_dict.json"))
    assert len(history["content_loss"]) == 2
    assert np.isfinite(history["content_loss"]).all()
    assert len(list((tmp_path / "previews").glob("preview_*.png"))) == 1


def test_cli_refuses_cuda_without_a_card_and_the_gan_step(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal needs none")
    content_dirs, style_dirs = _write_dataset(tmp_path / "data")
    base = [sys.executable, "-m", "arbitrarystyletransfer_tpu_torch.train",
            "--content_dir", *content_dirs, "--style_dir", *style_dirs,
            "--train_iter", "1", "--worker_mode", "thread"]
    proc = subprocess.run(base, cwd=REPO, env=CLI_ENV, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0 and "CUDA is not available" in proc.stderr
    proc = subprocess.run(base + ["--device", "cpu", "--use_dis"], cwd=REPO,
                          env=CLI_ENV, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert "NotImplementedError" in proc.stderr and "ROADMAP" in proc.stderr
