"""Serving a trainer checkpoint: the port's ``StylePipeline`` graph engine
and ``from_checkpoint`` (with and without BN recalibration) against the JAX
package's ``StylePipeline``.

Checkpoints are written by the port's ``train/checkpoint.save_checkpoint``
from numpy variables (flax ``AST.init``'s, or ``ast_variables``: fan-in
weights, SE gates open) and read back as ``<path>.pt``; 32px batches,
float32 on the CPU.  The flax reference runs ``AST.stylize`` /
``AST.export`` with the batch-statistics default, as JAX's default "flax"
engine does.
"""

import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arbitrarystyletransfer_tpu import config as jax_config
from arbitrarystyletransfer_tpu.models import AST as JaxAST

from arbitrarystyletransfer_tpu_torch import ModelConfig, engine, infer
from arbitrarystyletransfer_tpu_torch import weights
from arbitrarystyletransfer_tpu_torch.infer import StylePipeline
from arbitrarystyletransfer_tpu_torch.models.ast import AST
from arbitrarystyletransfer_tpu_torch.train import checkpoint as ckpt
from arbitrarystyletransfer_tpu_torch.train import recalibrate as recal
from arbitrarystyletransfer_tpu_torch.train.ae_trainer import (
    AutoencoderTrainer,
)

from test_torch_ops import assert_close, ast_variables

CFG = ModelConfig(use_pallas_adaattn=True)
EVAL = dataclasses.replace(CFG, encoder_eval_stats=True)


def _images(seed, b=2, size=32):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, (b, size, size, 3)).astype(np.float32)
            for _ in range(2)]


def _batches(seed, n, b=8, size=32):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.0, 1.0, (n, b, 1, 1, 3))
    noise = rng.normal(0.0, 0.15, (n, b, size, size, 3))
    return list(np.clip(base + noise, 0.0, 1.0).astype(np.float32))


def _flax_init_variables(seed):
    d = jnp.zeros((1, 32, 32, 3), jnp.float32)
    v = JaxAST(jax_config.ModelConfig()).init(jax.random.PRNGKey(seed), d, d,
                                              train=False)
    return jax.tree.map(np.asarray, {"params": v["params"],
                                     "batch_stats": v["batch_stats"]})


def _write_checkpoint(tmp_path, variables):
    """``<tmp>/ast.pt`` holding ``variables``; returns its ``<path>``."""
    state = weights.from_jax_tree(variables["params"],
                                  variables["batch_stats"])
    ckpt.save_checkpoint(str(tmp_path / "ast.pt"), state, {}, 0)
    return str(tmp_path / "ast")


def _pre_clamp_max(pipe, content, style):
    """The largest |value| of the graph's unclamped image (alpha 1)."""
    with torch.no_grad():
        c, s = torch.from_numpy(content), torch.from_numpy(style)
        return float(pipe.ast.dec(pipe.ast.encode(c, s, train=False)).abs()
                     .max())


def _assert_images_close(out, ref, pre_clamp_max, what):
    """Within 1e-4 of the largest pre-clamp value (test_torch_ast.py's
    tolerance): the clamp lowers the max, not the error of the values it
    keeps."""
    ref = np.asarray(ref)
    assert_close(out, ref, 1e-4 * pre_clamp_max / max(np.abs(ref).max(),
                                                        1e-6), what)


@functools.partial(jax.jit, static_argnames=("method",))
def _flax(variables, content, style, alpha, method):
    model = JaxAST(jax_config.ModelConfig())
    if method == "export":
        return model.apply(variables, content, style, method=JaxAST.export)
    return model.apply(variables, content, style, alpha,
                       method=JaxAST.stylize)


@pytest.mark.parametrize("init", ["flax_init", "parity"])
@pytest.mark.parametrize("method", ["stylize", "export"])
def test_graph_engine_from_checkpoint_matches_flax(tmp_path, init, method):
    v = (_flax_init_variables(60) if init == "flax_init"
         else ast_variables(seed=61))
    pipe = StylePipeline.from_checkpoint(_write_checkpoint(tmp_path, v), CFG,
                                         device="cpu")
    assert pipe.engine == "flax" and not pipe.cfg.encoder_eval_stats
    content, style = _images(62)
    alpha = 0.6
    out = (pipe.stylize(content, style, alpha) if method == "stylize"
           else pipe.export_forward(content, style))
    ref = _flax(jax.tree.map(jnp.asarray, v), jnp.asarray(content),
                jnp.asarray(style), alpha, method)
    assert out.shape == (2, 32, 32, 3) and out.dtype == torch.float32
    if init == "parity":  # the reference init's image is a constant
        assert 0.0 < float(out.mean()) < 1.0 and float(out.std()) > 0.0
    _assert_images_close(out, ref, _pre_clamp_max(pipe, content, style),
                         method)


def test_pipeline_defaults_to_the_flax_engine_on_the_card(tmp_path):
    """The graph engine is the default; without CUDA the default device
    raises before any file is read."""
    assert StylePipeline(CFG, device="cpu").engine == "flax"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal needs none")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StylePipeline.from_checkpoint(str(tmp_path / "missing"), CFG)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StylePipeline.from_checkpoint(str(tmp_path / "missing"), CFG,
                                      engine="fused",
                                      recalibrate_with=_batches(63, 1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AutoencoderTrainer(None, iter(()))


def test_unknown_engine_raises():
    with pytest.raises(ValueError, match="unknown engine"):
        StylePipeline(CFG, engine="graph", device="cpu")


@pytest.mark.parametrize("engine_name", ["flax", "fused"])
def test_load_state_moves_both_views(engine_name):
    """``state`` is a view of the module's own tensors, so new weights reach
    both engines at once: a pipeline after ``load_state`` serves what a
    pipeline built over those weights serves."""
    v = ast_variables(seed=64)
    new = weights.from_jax_tree(v["params"], v["batch_stats"])
    pipe = StylePipeline(EVAL, engine=engine_name, device="cpu", seed=1)
    pipe.load_state(new["params"], new["batch_stats"])
    module = weights.flatten(weights.module_state(pipe.ast))
    view = weights.flatten(pipe.state)
    assert module.keys() == view.keys()
    assert all(view[k].data_ptr() == module[k].data_ptr() for k in view)
    assert all(torch.equal(view[k], t) for k, t in
               weights.flatten(new).items())
    fresh = StylePipeline(EVAL, engine=engine_name, device="cpu", state=new)
    content, style = _images(65)
    assert torch.equal(pipe.stylize(content, style, 0.5),
                       fresh.stylize(content, style, 0.5))
    assert torch.equal(pipe.export_forward(content, style),
                       fresh.export_forward(content, style))


def test_engines_agree_at_eval_stats():
    """At ``encoder_eval_stats=True`` the graph engine and the fused engine
    (BatchNorm folded) serve the same image; ``export_forward`` is the
    graph's in both."""
    v = ast_variables(seed=66)
    state = weights.from_jax_tree(v["params"], v["batch_stats"])
    graph = StylePipeline(EVAL, device="cpu", state=state)
    fused = StylePipeline(EVAL, engine="fused", device="cpu", state=state)
    content, style = _images(67)
    # Folded BN and the phase-folded upsample round differently.
    _assert_images_close(fused.stylize(content, style, 0.7),
                         graph.stylize(content, style, 0.7),
                         _pre_clamp_max(graph, content, style), "image")
    assert torch.equal(fused.export_forward(content, style),
                       graph.export_forward(content, style))


def _float64_images(state, content, style):
    """The unclamped alpha-1 image of ``state`` through the graph engine
    and through the fused engine's plain route (BatchNorm folded), both in
    float64."""
    cfg = dataclasses.replace(EVAL, use_pallas_adaattn=False)
    ast = AST(cfg).double().requires_grad_(False)
    weights.load_state(ast, state)
    c, s = (torch.from_numpy(x).double() for x in (content, style))
    with torch.no_grad():
        graph = ast.dec(ast.encode(c, s, train=False))
        fused = engine.stylize_fused(
            weights.module_state(ast), c, s, 1.0, cfg=cfg,
            dtype=torch.float64, min_fused_size=10**9, exporting=False)
    assert graph.dtype == fused.dtype == torch.float64
    return graph, fused


@pytest.mark.parametrize("stats", ["checkpoint", "recalibrated"])
def test_engines_agree_in_float64(stats):
    """Folding BatchNorm changes only the rounding: in float64 the two
    engines serve the same unclamped image, also over recalibrated
    statistics whose eval-stats encoder drifts past ``EVAL_DRIFT_SAFE``
    (where float32 rounding, amplified, parts their images)."""
    v = ast_variables(seed=66 if stats == "checkpoint" else 69)
    state = weights.from_jax_tree(v["params"], v["batch_stats"])
    if stats == "recalibrated":
        batches = _batches(70, 8)
        enc = recal.recalibrate_encoder_stats(
            state["params"]["enc"], state["batch_stats"]["enc"],
            batches[:-2])
        drift = recal.eval_stats_drift(state["params"]["enc"], enc,
                                       batches[-2:])
        assert drift > recal.EVAL_DRIFT_SAFE
        state = {"params": state["params"], "batch_stats": {"enc": enc}}
    graph, fused = _float64_images(state, *_images(67))
    rel = float((fused - graph).norm() / graph.norm())
    assert rel <= 1e-9, rel


# -- from_checkpoint with recalibration (tests/test_recalibrate.py) ---------


def test_fused_engine_refuses_a_default_checkpoint(tmp_path):
    path = _write_checkpoint(tmp_path, ast_variables(seed=68))
    with pytest.raises(ValueError, match="encoder_eval_stats"):
        StylePipeline.from_checkpoint(path, CFG, engine="fused",
                                      device="cpu")


def test_recalibration_lifts_the_refusal(tmp_path):
    """The recalibrated pipeline serves eval-stats semantics over the
    checkpoint's params and the statistics rebuilt from all but the last two
    batches."""
    v = ast_variables(seed=69)
    path = _write_checkpoint(tmp_path, v)
    batches = _batches(70, 8)
    with pytest.warns(UserWarning, match="drifts") as record:
        pipe = StylePipeline.from_checkpoint(
            path, CFG, engine="fused", recalibrate_with=batches,
            device="cpu")
    assert "in-sample" not in str(record[0].message)
    assert pipe.engine == "fused" and pipe.cfg.encoder_eval_stats
    state = weights.from_jax_tree(v["params"], v["batch_stats"])
    expected = recal.recalibrate_encoder_stats(
        state["params"]["enc"], state["batch_stats"]["enc"], batches[:-2])
    got = weights.flatten(pipe.state)
    want = weights.flatten({"params": state["params"],
                            "batch_stats": {"enc": expected}})
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    out = pipe.stylize(*_images(71), 1.0)
    assert out.shape == (2, 32, 32, 3) and bool(torch.isfinite(out).all())


def _spy(monkeypatch, drift):
    """Record the batches each recalibration step is given; the drift check
    returns ``drift``."""
    seen = {}

    def recalibrate(params, stats, batches, cfg):
        seen["recal"] = list(batches)
        return recal.recalibrate_encoder_stats(params, stats, batches, cfg)

    def measure(params, stats, batches, cfg):
        seen["drift"] = list(batches)
        return drift

    monkeypatch.setattr(infer, "recalibrate_encoder_stats", recalibrate)
    monkeypatch.setattr(infer, "eval_stats_drift", measure)
    return seen


@pytest.mark.parametrize("n", [8, 9, 5, 2])
def test_hold_out_split_follows_the_8_batch_rule(tmp_path, monkeypatch, n):
    seen = _spy(monkeypatch, 0.5)
    batches = _batches(72, n, b=2)
    with pytest.warns(UserWarning, match="drifts 0.5") as record:
        StylePipeline.from_checkpoint(
            _write_checkpoint(tmp_path, ast_variables(seed=73)), CFG,
            engine="fused", recalibrate_with=batches, device="cpu")
    ident = [id(b) for b in batches]
    if n >= 8:
        assert [id(b) for b in seen["recal"]] == ident[:-2]
        assert [id(b) for b in seen["drift"]] == ident[-2:]
        assert "in-sample" not in str(record[0].message)
    else:
        assert [id(b) for b in seen["recal"]] == ident
        assert [id(b) for b in seen["drift"]] == ident[:4]
        assert "measured in-sample" in str(record[0].message)


@pytest.mark.parametrize("drift", [float("nan"), float("inf")])
def test_non_finite_drift_raises_unless_allow_unstable(tmp_path,
                                                       monkeypatch, drift):
    _spy(monkeypatch, drift)
    path = _write_checkpoint(tmp_path, ast_variables(seed=74))
    batches = _batches(75, 8, b=2)
    with pytest.raises(ValueError, match="allow_unstable"):
        StylePipeline.from_checkpoint(path, CFG, engine="fused",
                                      recalibrate_with=batches, device="cpu")
    with pytest.warns(UserWarning, match="drifts"):
        pipe = StylePipeline.from_checkpoint(
            path, CFG, engine="fused", recalibrate_with=batches,
            allow_unstable=True, device="cpu")
    assert pipe.cfg.encoder_eval_stats


def test_small_drift_serves_without_a_warning(tmp_path, monkeypatch):
    _spy(monkeypatch, recal.EVAL_DRIFT_SAFE / 2)
    path = _write_checkpoint(tmp_path, ast_variables(seed=76))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pipe = StylePipeline.from_checkpoint(
            path, CFG, engine="fused", recalibrate_with=_batches(77, 8, b=2),
            device="cpu")
    assert pipe.cfg.encoder_eval_stats


def test_reference_init_checkpoint_drifts_without_bound(tmp_path):
    """A checkpoint at the reference initialization drifts by orders of
    magnitude under eval-stats encoding (its BN chain amplifies the
    eval/batch residual block by block; at larger sizes the deepest tap's
    norm overflows float32 and the drift is not finite), so the fused route
    warns, or refuses where the drift is not finite; the graph engine
    serves it."""
    state = weights.init_params(ModelConfig(),
                                torch.Generator().manual_seed(78))
    ckpt.save_checkpoint(str(tmp_path / "ast.pt"), state, {}, 0)
    path = str(tmp_path / "ast")
    batches = _batches(79, 8)
    stats = recal.recalibrate_encoder_stats(
        state["params"]["enc"], state["batch_stats"]["enc"], batches[:-2])
    drift = recal.eval_stats_drift(state["params"]["enc"], stats,
                                   batches[-2:])
    assert drift > 1e6  # finite at 32px: 2.4e16
    with pytest.warns(UserWarning, match="drifts"):
        StylePipeline.from_checkpoint(path, CFG, engine="fused",
                                      recalibrate_with=batches, device="cpu")
    out = StylePipeline.from_checkpoint(path, CFG, device="cpu").stylize(
        *_images(80))
    assert bool(torch.isfinite(out).all())


def test_eval_stats_config_skips_recalibration(tmp_path, monkeypatch):
    """A config that already asks for eval statistics serves the
    checkpoint's own running statistics, as in JAX."""
    seen = _spy(monkeypatch, 0.0)
    v = ast_variables(seed=81)
    pipe = StylePipeline.from_checkpoint(
        _write_checkpoint(tmp_path, v), EVAL, engine="fused",
        recalibrate_with=_batches(82, 8, b=2), device="cpu")
    assert not seen
    state = weights.flatten(weights.from_jax_tree(v["params"],
                                                  v["batch_stats"]))
    assert all(torch.equal(t, state[k])
               for k, t in weights.flatten(pipe.state).items())


def test_stylize_fused_of_the_recalibrated_state_is_the_pipelines(tmp_path):
    """The pipeline's fused engine is ``engine.stylize_fused`` over its
    state."""
    path = _write_checkpoint(tmp_path, ast_variables(seed=83))
    with pytest.warns(UserWarning):
        pipe = StylePipeline.from_checkpoint(
            path, CFG, engine="fused", recalibrate_with=_batches(84, 8),
            device="cpu")
    content, style = _images(85)
    ref = engine.stylize_fused(pipe.state, torch.from_numpy(content),
                               torch.from_numpy(style), 0.5, cfg=pipe.cfg,
                               dtype=torch.float32)
    assert torch.equal(pipe.stylize(content, style, 0.5), ref)
