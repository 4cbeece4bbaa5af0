"""The whole slice: the port's stylize engine against the JAX package.

Full-width ``ModelConfig`` at 64px, batch 2, float32.  The port runs with
``min_fused_size=16`` and, on the flat routes, ``lane=16``, so the blocks
that take a kernel at 512px take it here too (each kernel through its plain
twin on the CPU), and with ``use_pallas_adaattn`` on.  The reference is the flax graph
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
from arbitrarystyletransfer_tpu.ops.pallas import flatblock as jflat
from arbitrarystyletransfer_tpu.ops.pallas import fused_block as jfb
from arbitrarystyletransfer_tpu.ops.pallas import policy as jpolicy

from arbitrarystyletransfer_tpu_torch import ModelConfig, engine, weights
from arbitrarystyletransfer_tpu_torch.infer import StylePipeline
from arbitrarystyletransfer_tpu_torch.ops import flatblock as pflat
from arbitrarystyletransfer_tpu_torch.ops import flatblock_s2 as ps2
from arbitrarystyletransfer_tpu_torch.ops import fused_block as pfb
from arbitrarystyletransfer_tpu_torch.ops import policy as ppolicy
from arbitrarystyletransfer_tpu_torch.ops.kernels import LAUNCHES

from test_torch_ops import assert_close, ast_variables, to_jax

CFG = ModelConfig(encoder_eval_stats=True, use_pallas_adaattn=True)
JCFG = jax_config.ModelConfig(encoder_eval_stats=True)
MIN_FUSED = 16  # 64px / 8: the 512px routing (MIN_FUSED_SIZE 128) at 1/8
LANE = 16       # the flat routes' lane rule (128 at 512px) at 1/8
FLAT_IMPLS = ("flat", "flat-all", "auto")


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


def _jax_plain_route(part, dtype):
    """JAX's encoder taps or pre-clamp decoder output on its all-XLA route
    (``min_fused_size=10**6``, the decoder unfolded), at ``dtype``."""
    if part == "encoder":
        v = ast_variables(seed=2)
        return jfb.encode_fused(
            to_jax(v["params"]["enc"]), to_jax(v["batch_stats"]["enc"]),
            jnp.asarray(_images(2)[0]), JCFG.enc_conv_shapes,
            JCFG.enc_out_layers, expand_ratio=JCFG.expand_ratio, dtype=dtype,
            min_fused_size=10**6)
    v = ast_variables(seed=1)
    z = np.random.default_rng(1).normal(0, 1, (2, 8, 8, 128))
    return [jfb.decode_fused(to_jax(v["params"]["dec"]),
                             jnp.asarray(z.astype(np.float32)),
                             JCFG.decoder_conv_shapes, exporting=False,
                             dtype=dtype, min_fused_size=10**6,
                             fold_upsample=False)]


@pytest.mark.parametrize("part", ["encoder", "decoder"])
def test_bf16_plain_route_matches_jax(part):
    """bf16 through the plain route on both sides: the port with
    ``min_fused_size=10**6`` against ``_jax_plain_route``, as the f32 tests
    above.  Each block rounds where JAX rounds
    (test_torch_ops.test_plain_block_bf16_matches_xla_block), but the few
    one-ulp flips of a block grow through the ~14 blocks after it, as any
    bf16 difference does.  So the port is held to JAX's own bf16 error:
    its distance to JAX bf16 is at most twice JAX bf16's distance to JAX
    f32, in max and in mean (the image gate of chip_smoke.py)."""
    if part == "encoder":
        v = ast_variables(seed=2)
        state = weights.from_jax_tree(v["params"], v["batch_stats"])
        outs = pfb.encode_fused(
            state["params"]["enc"], state["batch_stats"]["enc"],
            torch.from_numpy(_images(2)[0]), CFG.enc_conv_shapes,
            CFG.enc_out_layers, expand_ratio=CFG.expand_ratio,
            dtype=torch.bfloat16, min_fused_size=10**6)
    else:
        v = ast_variables(seed=1)
        dec = weights.from_jax_tree(v["params"], {})["params"]["dec"]
        z = np.random.default_rng(1).normal(0, 1, (2, 8, 8, 128))
        outs = [pfb.decode_fused(dec, torch.from_numpy(z.astype(np.float32)),
                                 CFG.decoder_conv_shapes, exporting=False,
                                 dtype=torch.bfloat16,
                                 min_fused_size=10**6)]
    refs = _jax_plain_route(part, jnp.bfloat16)
    refs32 = _jax_plain_route(part, jnp.float32)
    for o, r, r32 in zip(outs, refs, refs32):
        o = o.float().numpy()
        r = np.asarray(r.astype(jnp.float32))
        own = np.abs(r - np.asarray(r32))
        err = np.abs(o - r)
        assert o.shape == r.shape and own.max() > 0
        assert err.max() <= 2.0 * own.max(), (err.max(), own.max())
        assert err.mean() <= 2.0 * own.mean(), (err.mean(), own.mean())


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


@pytest.mark.parametrize("impl", ["mega"])
def test_ported_routes_run(impl):
    """The mega route runs in the engine and through the pipeline, as the
    encoder route, the decoder route or both; an unknown route raises."""
    state = weights.init_params(CFG, torch.Generator().manual_seed(0))
    content, style = _images(13, size=32, b=1)
    for kw in ({"encoder_impl": impl}, {"decoder_impl": impl},
               {"encoder_impl": impl, "decoder_impl": impl}):
        pipe = StylePipeline(CFG, engine="fused", state=state, device="cpu",
                             **kw)
        out = pipe.stylize(content, style, 0.5)
        ref = engine.stylize_fused(
            state, torch.from_numpy(content), torch.from_numpy(style), 0.5,
            cfg=CFG, dtype=torch.float32, **kw)
        assert out.shape == (1, 32, 32, 3) and torch.equal(out, ref)
    with pytest.raises(ValueError, match="unknown decoder_impl"):
        engine.stylize_fused(state, torch.from_numpy(content),
                             torch.from_numpy(style), cfg=CFG,
                             decoder_impl="megakernel")


def test_pipeline_refuses_batch_stats_config():
    with pytest.raises(ValueError, match="encoder_eval_stats"):
        StylePipeline(ModelConfig(encoder_eval_stats=False), engine="fused")


def test_pipeline_defaults_to_the_card():
    """Without a device the pipeline runs on CUDA; a CPU-only host raises
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal needs none")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StylePipeline(CFG)


def test_pipeline_from_npz_matches_engine(tmp_path):
    v = ast_variables(seed=4)
    state = weights.from_jax_tree(v["params"], v["batch_stats"])
    weights.save_npz(tmp_path / "w.npz", state)
    pipe = StylePipeline.from_npz(tmp_path / "w.npz", CFG, engine="fused",
                                  device="cpu")
    content, style = _images(4, size=32, b=1)
    out = pipe.stylize(content, style, 0.5)
    ref = engine.stylize_fused(
        state, torch.from_numpy(content), torch.from_numpy(style), 0.5,
        cfg=CFG, dtype=torch.float32)
    assert torch.equal(out, ref)


# -- the flat routes -------------------------------------------------------


@pytest.mark.parametrize("impl", ["flat-all", "auto"])
def test_flat_route_matches_flax_graph(impl):
    content, style = _images(5)
    alpha = 0.6
    v = ast_variables(seed=5)
    _normalize_head(v, content, style, alpha)
    state = weights.from_jax_tree(v["params"], v["batch_stats"])
    out = engine.stylize_fused(
        state, torch.from_numpy(content), torch.from_numpy(style), alpha,
        cfg=CFG, dtype=torch.float32, min_fused_size=MIN_FUSED,
        encoder_impl=impl, decoder_impl=impl, lane=LANE).numpy()
    ref = np.asarray(_flax_stylize()(to_jax(v), jnp.asarray(content),
                                     jnp.asarray(style), alpha))
    assert out.shape == (2, 64, 64, 3) and np.isfinite(out).all()
    saturated = np.mean((out == 0.0) | (out == 1.0))
    assert saturated < 0.5, f"{saturated:.0%} of the image is clamped"
    # f32 through ~35 blocks and a peaked softmax, sums in other orders.
    assert_close(out, ref, 1e-4, f"stylized image, {impl}")


@pytest.mark.parametrize("mode", ["all", "tail"])
def test_encode_flat_matches_jax(mode):
    """The taps against JAX encode_fused on its all-XLA route."""
    v = ast_variables(seed=6)
    state = weights.from_jax_tree(v["params"], v["batch_stats"])
    x = _images(6)[0]
    outs = pflat.encode_flat(
        state["params"]["enc"], state["batch_stats"]["enc"],
        torch.from_numpy(x), CFG.enc_conv_shapes, CFG.enc_out_layers,
        expand_ratio=CFG.expand_ratio, dtype=torch.float32, flat_blocks=mode,
        lane=LANE, min_fused_size=MIN_FUSED)
    refs = jfb.encode_fused(
        to_jax(v["params"]["enc"]), to_jax(v["batch_stats"]["enc"]),
        jnp.asarray(x), JCFG.enc_conv_shapes, JCFG.enc_out_layers,
        expand_ratio=JCFG.expand_ratio, dtype=jnp.float32,
        min_fused_size=10**6)
    assert len(outs) == 2
    for o, r in zip(outs, refs):
        assert_close(o, r, 1e-5, "encoder tap")


@pytest.mark.parametrize("mode", ["all", "tail"])
def test_decode_flat_matches_jax_unfolded_decoder(mode):
    v = ast_variables(seed=7)
    dec = weights.from_jax_tree(v["params"], {})["params"]["dec"]
    z = np.random.default_rng(7).normal(0, 1, (2, 8, 8, 128))
    z = z.astype(np.float32)
    out = pflat.decode_flat(dec, torch.from_numpy(z), CFG.decoder_conv_shapes,
                            exporting=False, dtype=torch.float32,
                            flat_blocks=mode, lane=LANE,
                            min_fused_size=MIN_FUSED)
    ref = jfb.decode_fused(to_jax(v["params"]["dec"]), jnp.asarray(z),
                           JCFG.decoder_conv_shapes, exporting=False,
                           dtype=jnp.float32, min_fused_size=10**6,
                           fold_upsample=False)
    assert float(out.std()) > 1e-3
    assert_close(out, ref, 1e-4, "pre-clamp decoder output")


@pytest.mark.parametrize("impl,flat,flat_s2,fused", [
    ("flat-all", 15, 2, 0),   # e1 e3 e5 e6 d3-d13; e2 e4
    ("auto", 5, 1, 10),       # e1 e3 d11-d13; e4; e5 e6 d3-d10
])
def test_flat_route_kernel_calls(jax_without_table, monkeypatch, impl, flat,
                                 flat_s2, fused):
    """At 1/8 of the 512px size, lane and threshold, each route calls each
    kernel wrapper as often as a 512px request does (without a table: the
    table's keys carry the size)."""
    calls = {"flat": 0, "flat_s2": 0, "fused": 0}

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(pflat, "flat_block",
                        counted("flat", pflat.flat_block))
    monkeypatch.setattr(ps2, "flat_s2_block",
                        counted("flat_s2", ps2.flat_s2_block))
    monkeypatch.setattr(pfb, "expand_dw", counted("fused", pfb.expand_dw))
    content, style = map(torch.from_numpy, _images(8, b=1))
    state = weights.init_params(CFG, torch.Generator().manual_seed(0))
    engine.stylize_fused(state, content, style, cfg=CFG, dtype=torch.float32,
                         min_fused_size=MIN_FUSED, encoder_impl=impl,
                         decoder_impl=impl, lane=LANE)
    assert calls == {"flat": flat, "flat_s2": flat_s2, "fused": fused}
    assert pflat.planned_launches(CFG, 64, impl, impl, lane=LANE,
                                  min_fused_size=MIN_FUSED) == {
        "flat_block": flat, "flat_s2_block": flat_s2, "expand_dw": fused}


@pytest.fixture
def jax_without_table(monkeypatch, tmp_path):
    """Both planners with no tuned table (their "auto" falls back to the
    "tail" heuristic): ``AST_TUNED_POLICY`` names a missing file."""
    monkeypatch.setenv("AST_TUNED_POLICY", str(tmp_path / "missing.json"))
    jpolicy.load_policy.cache_clear()
    ppolicy.clear_cache()
    yield
    jpolicy.load_policy.cache_clear()
    ppolicy.clear_cache()


@pytest.mark.parametrize("size", [512, 320, 256])
@pytest.mark.parametrize("impl", FLAT_IMPLS)
def test_planned_chains_match_jax_without_table(jax_without_table, impl,
                                                size):
    assert jpolicy.load_policy() == {} == ppolicy.load_policy()
    ours = pflat.planned_chains(CFG, size, impl, impl)
    assert ours == jflat.planned_chains(JCFG, size, impl, impl)
    assert "flat" in ours["enc"] and "flat" in ours["dec"]


@pytest.mark.parametrize("impl", FLAT_IMPLS)
def test_planned_chains_at_64px_with_lane_16_equal_512px(jax_without_table,
                                                        impl):
    assert (pflat.planned_chains(CFG, 64, impl, impl, lane=LANE)
            == pflat.planned_chains(CFG, 512, impl, impl))


@pytest.mark.parametrize("encoder_impl,decoder_impl", [
    ("flat-all", "auto"),
    ("auto", "flat"),
])
def test_pipeline_routes_match_engine(monkeypatch, encoder_impl,
                                      decoder_impl):
    modes = []
    real = pflat.plan_impls
    monkeypatch.setattr(pflat, "plan_impls",
                        lambda d, m, lane, device=None: modes.append(m)
                        or real(d, m, lane, device))
    v = ast_variables(seed=9)
    state = weights.from_jax_tree(v["params"], v["batch_stats"])
    pipe = StylePipeline(CFG, engine="fused", state=state,
                         encoder_impl=encoder_impl,
                         decoder_impl=decoder_impl, device="cpu")
    content, style = _images(9, size=32, b=1)
    out = pipe.stylize(content, style, 0.5)
    assert modes == [pflat.FLAT_MODE[encoder_impl],
                     pflat.FLAT_MODE[decoder_impl]]
    ref = engine.stylize_fused(
        state, torch.from_numpy(content), torch.from_numpy(style), 0.5,
        cfg=CFG, dtype=torch.float32, encoder_impl=encoder_impl,
        decoder_impl=decoder_impl)
    assert torch.equal(out, ref)
