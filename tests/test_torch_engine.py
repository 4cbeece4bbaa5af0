"""The whole slice: the port's fused stylize engine against the JAX package.

Full-width ``ModelConfig`` at 64px, batch 2, float32.  The port runs with
``min_fused_size=16``, so the blocks that take the ``expand_dw`` kernel at
512px take it here too (each kernel through its plain twin on the CPU), and
with ``use_pallas_adaattn`` on.  The reference is the flax graph
``AST.stylize`` with running-statistics BatchNorm, which JAX's
``engine.stylize_fused`` documents as its math; JAX's own fused engine is
not used for the image because its folded upsample+smooth blocks differ
from that graph (see test_torch_ops.test_upsample_smooth_matches_unfolded_block).

The head is normalized first (same shift and scale on both sides) so the
pre-clamp image has mean 0.5 and spatial std ~0.25: with raw random weights
the clamp saturates every pixel and two different programs compare equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arbitrarystyletransfer_tpu import config as jax_config
from arbitrarystyletransfer_tpu.models import AST
from arbitrarystyletransfer_tpu.ops.pallas import fused_block as jfb

from arbitrarystyletransfer_tpu_torch import ModelConfig, engine, weights
from arbitrarystyletransfer_tpu_torch.infer import StylePipeline
from arbitrarystyletransfer_tpu_torch.ops import fused_block as pfb
from arbitrarystyletransfer_tpu_torch.ops.kernels import LAUNCHES

from test_torch_ops import assert_close, ast_variables, to_jax

CFG = ModelConfig(encoder_eval_stats=True, use_pallas_adaattn=True)
JCFG = jax_config.ModelConfig(encoder_eval_stats=True)
MIN_FUSED = 16  # 64px / 8: the 512px routing (MIN_FUSED_SIZE 128) at 1/8


def _images(seed, size=64, b=2):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, (b, size, size, 3)).astype(np.float32)
            for _ in range(2)]


def _normalize_head(variables, content, style, alpha):
    """Rescale and shift the head in ``variables`` (in place) so the port's
    pre-clamp image has per-channel mean 0.5 and spatial std 0.25."""
    state = weights.from_jax_tree(variables["params"],
                                  variables["batch_stats"])
    pre = engine.stylize_fused(
        state, torch.from_numpy(content), torch.from_numpy(style), alpha,
        cfg=CFG, dtype=torch.float32, min_fused_size=MIN_FUSED,
        exporting=False).double().numpy()
    head = variables["params"]["dec"]["img_out"]
    std = pre.std(axis=(1, 2)).mean(axis=0)
    assert np.all(std > 1e-3), f"random weights gave a flat image: {std}"
    scale = 0.25 / std
    head["kernel"] = (head["kernel"] * scale).astype(np.float32)
    head["bias"] = (0.5 - scale * (pre.mean(axis=(0, 1, 2)) - head["bias"])
                    ).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _flax_stylize():
    return jax.jit(lambda v, c, s, a: AST(JCFG).apply(
        v, c, s, a, method=AST.stylize))


def test_stylize_matches_flax_graph():
    content, style = _images(0)
    alpha = 0.7
    v = ast_variables(seed=0)
    _normalize_head(v, content, style, alpha)
    state = weights.from_jax_tree(v["params"], v["batch_stats"])

    before = dict(LAUNCHES)
    out = engine.stylize_fused(
        state, torch.from_numpy(content), torch.from_numpy(style), alpha,
        cfg=CFG, dtype=torch.float32, min_fused_size=MIN_FUSED).numpy()
    assert LAUNCHES == before  # CPU tensors: plain twins, no launches
    ref = np.asarray(_flax_stylize()(to_jax(v), jnp.asarray(content),
                                     jnp.asarray(style), alpha))
    assert out.shape == (2, 64, 64, 3) and np.isfinite(out).all()
    saturated = np.mean((out == 0.0) | (out == 1.0))
    assert saturated < 0.5, f"{saturated:.0%} of the image is clamped"
    assert out.std() > 0.1
    # f32 through ~35 blocks and a peaked softmax, sums in other orders.
    assert_close(out, ref, 1e-4, "stylized image")


def test_decoder_matches_jax_unfolded_decoder():
    """The pre-clamp decoder output against JAX decode_fused on its
    all-XLA, unfolded-upsample route (the flax decoder's math)."""
    v = ast_variables(seed=1)
    dec = weights.from_jax_tree(v["params"], {})["params"]["dec"]
    z = np.random.default_rng(1).normal(0, 1, (2, 8, 8, 128))
    z = z.astype(np.float32)
    out = pfb.decode_fused(dec, torch.from_numpy(z),
                           CFG.decoder_conv_shapes, exporting=False,
                           dtype=torch.float32, min_fused_size=MIN_FUSED)
    ref = jfb.decode_fused(to_jax(v["params"]["dec"]), jnp.asarray(z),
                           JCFG.decoder_conv_shapes, exporting=False,
                           dtype=jnp.float32, min_fused_size=10**6,
                           fold_upsample=False)
    assert float(out.std()) > 1e-3
    assert_close(out, ref, 1e-4, "pre-clamp decoder output")


def test_encoder_matches_jax():
    v = ast_variables(seed=2)
    state = weights.from_jax_tree(v["params"], v["batch_stats"])
    x = _images(2)[0]
    outs = pfb.encode_fused(
        state["params"]["enc"], state["batch_stats"]["enc"],
        torch.from_numpy(x), CFG.enc_conv_shapes, CFG.enc_out_layers,
        expand_ratio=CFG.expand_ratio, dtype=torch.float32,
        min_fused_size=MIN_FUSED)
    refs = jfb.encode_fused(
        to_jax(v["params"]["enc"]), to_jax(v["batch_stats"]["enc"]),
        jnp.asarray(x), JCFG.enc_conv_shapes, JCFG.enc_out_layers,
        expand_ratio=JCFG.expand_ratio, dtype=jnp.float32,
        min_fused_size=10**6)
    assert len(outs) == 2
    for o, r in zip(outs, refs):
        assert_close(o, r, 1e-5, "encoder tap")


def test_route_sends_15_blocks_to_expand_dw(monkeypatch):
    """At 1/8 of the 512px size and threshold, the routing sends exactly
    the 15 blocks of the 512px main path through the kernel wrapper."""
    calls = []
    real = pfb.expand_dw
    monkeypatch.setattr(pfb, "expand_dw",
                        lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    content, style = map(torch.from_numpy, _images(3, b=1))
    state = weights.init_params(CFG, torch.Generator().manual_seed(0))
    engine.stylize_fused(state, content, style, cfg=CFG, dtype=torch.float32,
                         min_fused_size=MIN_FUSED)
    assert len(calls) == 15
    assert sorted({s[1] for s in calls}) == [16, 32, 64]


@pytest.mark.parametrize("impl", ["flat", "flat-all", "auto", "mega"])
def test_unported_routes_raise(impl):
    state = weights.init_params(CFG, torch.Generator().manual_seed(0))
    x = torch.zeros(1, 16, 16, 3)
    for kw in ({"encoder_impl": impl}, {"decoder_impl": impl}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            engine.stylize_fused(state, x, x, cfg=CFG, **kw)


def test_pipeline_refuses_batch_stats_config():
    with pytest.raises(ValueError, match="encoder_eval_stats"):
        StylePipeline(ModelConfig(encoder_eval_stats=False))


def test_pipeline_from_npz_matches_engine(tmp_path):
    v = ast_variables(seed=4)
    state = weights.from_jax_tree(v["params"], v["batch_stats"])
    weights.save_npz(tmp_path / "w.npz", state)
    pipe = StylePipeline.from_npz(tmp_path / "w.npz", CFG)
    content, style = _images(4, size=32, b=1)
    out = pipe.stylize(content, style, 0.5)
    ref = engine.stylize_fused(
        state, torch.from_numpy(content), torch.from_numpy(style), 0.5,
        cfg=CFG, dtype=torch.float32)
    assert torch.equal(out, ref)
