"""The port's dispatch policy (``ops/policy.py``), its "auto" plan and its
tuner (``scripts/autotune_blocks.py``) against the JAX package's.

Both planners read the table named by ``AST_TUNED_POLICY``, so one setting
drives both: the synthetic tables of ``tests/test_policy.py``, JAX's TPU
table and the port's H100 table.  On the CPU the port checks no card name;
the card check is exercised with a mocked CUDA device name.
"""

import functools
import importlib.util
import json
import warnings
from pathlib import Path

import pytest
import torch

from arbitrarystyletransfer_tpu import config as jax_config
from arbitrarystyletransfer_tpu.ops.pallas import flatblock as jflat
from arbitrarystyletransfer_tpu.ops.pallas import policy as jpolicy

from arbitrarystyletransfer_tpu_torch import ModelConfig
from arbitrarystyletransfer_tpu_torch.ops import flatblock as pflat
from arbitrarystyletransfer_tpu_torch.ops import policy as ppolicy
from arbitrarystyletransfer_tpu_torch.ops.flatblock_s2 import s2_eligible
from arbitrarystyletransfer_tpu_torch.scripts import autotune_blocks as tuner

ROOT = Path(__file__).resolve().parents[1]
JAX_TABLE = ROOT / "arbitrarystyletransfer_tpu/ops/pallas/tuned_policy.json"
PORT_TABLE = ppolicy.DEFAULT_PATH
CARD = "NVIDIA H100 80GB HBM3"
SIZES = (512, 320, 256)
FLAT_IMPLS = ("flat", "flat-all", "auto")
CFG = ModelConfig()
JCFG = jax_config.ModelConfig()


def _clear():
    jpolicy.load_policy.cache_clear()
    ppolicy.clear_cache()


@pytest.fixture
def table(tmp_path, monkeypatch):
    """Points both planners at a table: a path, or synthetic cases."""

    def use(source, meta=None):
        if isinstance(source, dict):
            path = tmp_path / "policy.json"
            path.write_text(json.dumps({"meta": meta or {},
                                        "cases": source}))
            source = path
        monkeypatch.setenv("AST_TUNED_POLICY", str(source))
        _clear()

    yield use
    _clear()


def _key(*args):
    return jpolicy.block_key(*args)


K_A = _key(40, 40, 1, 5, 4, 512, 512)
K_B = _key(40, 24, 1, 5, 6, 512, 512)
K_C = _key(24, 24, 1, 3, 6, 512, 512)
K_16 = _key(16, 16, 1, 3, 6, 512, 512)
K_S2 = _key(16, 24, 2, 3, 6, 512, 512)
K_C256 = _key(24, 24, 1, 3, 6, 256, 256)
FLAT_BASE = {
    K_16: {"flat_ms": 10.0, "fused_ms": 18.0, "xla_ms": 25.0, "tp_ms": 1.2},
    K_C256: {"flat_ms": 4.0, "fused_ms": 8.0, "xla_ms": 10.0, "tp_ms": 0.6},
}
S2_CHAIN = [{"key": K_16}, {"key": K_S2, "stride2": True},
            {"key": K_C256}]

# (table, chains planned on it): every synthetic table and chain of
# tests/test_policy.py.
SYNTHETIC = {
    "transitions": ({
        K_A: {"flat_ms": 16.0, "fused_ms": 18.0, "xla_ms": 25.0,
              "tp_ms": 1.2},
        K_B: {"flat_ms": 20.0, "fused_ms": 19.0, "xla_ms": 29.0,
              "tp_ms": 1.2},
        K_C: {"flat_ms": 8.0, "fused_ms": 10.0, "xla_ms": 18.0,
              "tp_ms": 0.8},
    }, [[{"key": K_A}, {"key": K_B}, {"key": K_C}],
        [{"key": K_A}, {"key": K_B, "flat_ok": False}, {"key": K_C}],
        [{"key": K_A, "nhwc_out": True}, {"key": K_B}, {"key": K_C}],
        [{"key": "unknown"}]]),
    "isolated": ({K_A: {"flat_ms": 17.5, "fused_ms": 18.0, "xla_ms": 25.0,
                        "tp_ms": 1.2}},
                 [[{"key": K_A}]]),
    "force_nhwc": ({K_A: {"flat_ms": 10.0, "fused_ms": 18.0,
                          "xla_ms": 25.0, "tp_ms": 1.2}},
                   [[{"key": K_A},
                     {"key": "s2", "force_nhwc": True,
                      "est_bytes": int(300e6)},
                     {"key": K_A}]]),
    "flat2_wins": ({**FLAT_BASE, K_S2: {"xla_ms": 12.5, "flat2_ms": 3.1,
                                        "tp_ms": 1.2}}, [S2_CHAIN]),
    "flat2_loses": ({**FLAT_BASE, K_S2: {"xla_ms": 2.0, "flat2_ms": 30.0,
                                         "tp_ms": 1.2}}, [S2_CHAIN]),
    "flat2_untuned": (FLAT_BASE, [S2_CHAIN,
                                  [{"key": K_16},
                                   {"key": K_S2, "stride2": True,
                                    "est_bytes": int(3e9)}]]),
    "chain_break": ({
        K_16: {"flat_ms": 15.0, "flati_ms": 9.0, "fused_ms": 10.0,
               "xla_ms": 25.0, "tp_ms": 1.2},
        K_S2: {"xla_ms": 3.0, "flat2_ms": 3.0, "tp_ms": 1.2},
    }, [[{"key": K_16}, {"key": K_S2, "stride2": True}]]),
    "verdicts": ({
        _key(16, 16, 1, 3, 6, 512, 512): {"best": "xla"},
        _key(80, 80, 1, 3, 4, 256, 256): {"best": "flat"},
        _key(16, 16, 1, 3, 6, 64, 64): {"best": "flat"},
    }, [[{"key": _key(16, 16, 1, 3, 6, 512, 512)}]]),
}


def _args(key):
    """block_key's arguments back from a key."""
    chans, rest = key.split("s", 1)
    c_in, c_out = map(int, chans.split("-"))
    stride, rest = rest.split("k", 1)
    k, rest = rest.split("t", 1)
    t, hw = rest.split("@")
    h, w = map(int, hw.split("x"))
    t = float(t) if "." in t else int(t)
    return c_in, c_out, int(stride), int(k), t, h, w


@pytest.mark.parametrize("name", sorted(SYNTHETIC))
def test_policy_functions_match_jax_on_synthetic_tables(table, name):
    cases, chains = SYNTHETIC[name]
    table(cases)
    assert ppolicy.load_policy() == jpolicy.load_policy() == cases
    for key in cases:
        args = _args(key)
        assert ppolicy.block_key(*args) == jpolicy.block_key(*args) == key
        assert ppolicy.best_impl(*args) == jpolicy.best_impl(*args)
    assert ppolicy.best_impl(1, 2, 1, 3, 3, 8, 8) is None
    for chain in chains:
        assert ppolicy.plan_chain(chain) == jpolicy.plan_chain(chain)


def test_synthetic_plans_are_jax_s_verdicts(table):
    """The plans test_policy.py pins hold for the port too."""
    table(SYNTHETIC["transitions"][0])
    assert ppolicy.plan_chain(SYNTHETIC["transitions"][1][0]) == [
        "flat", "flat", "flat"]
    table(SYNTHETIC["isolated"][0])
    assert ppolicy.plan_chain([{"key": K_A}]) == ["fused"]
    table(SYNTHETIC["force_nhwc"][0])
    assert ppolicy.plan_chain(SYNTHETIC["force_nhwc"][1][0]) == [
        "flat", "xla", "flat"]
    assert ppolicy.plan_chain([{"key": "unknown"}]) is None
    table(SYNTHETIC["flat2_wins"][0])
    assert ppolicy.plan_chain(S2_CHAIN) == ["flat", "flat2", "flat"]
    table(SYNTHETIC["flat2_loses"][0])
    assert ppolicy.plan_chain(S2_CHAIN)[1] == "xla"
    table(SYNTHETIC["chain_break"][0])
    assert ppolicy.plan_chain(SYNTHETIC["chain_break"][1][0])[0] != "flat"


@pytest.mark.parametrize("desc,expected", [
    (dict(c_in=16, c_out=16, k=3, t=6, h=512, w=512), "xla"),
    (dict(c_in=80, c_out=80, k=3, t=4, h=256, w=256), "flat"),
    # A "flat" verdict on a width the flat kernel does not take falls back.
    (dict(c_in=16, c_out=16, k=3, t=6, h=64, w=64), "fused"),
    (dict(c_in=24, c_out=24, k=3, t=6, h=512, w=512), "flat"),
    (dict(c_in=40, c_out=40, k=5, t=4, h=512, w=512), "fused"),
])
def test_auto_per_block_verdicts_match_jax(table, desc, expected):
    """Block by block (the chain lacks rows): ``best_impl`` clamped to the
    width rule, else the "tail" heuristic, as ``_choose_impl``."""
    table(SYNTHETIC["verdicts"][0])
    ours = pflat.plan_impls([desc], "auto")
    assert ours == jflat._plan_impls([desc], "auto") == [expected]


def _chain_blocks(size):
    """The block rows both planners build for the encoder and decoder at
    ``size`` (``flatblock._plan_impls``'s)."""
    return [pflat.chain_rows(pflat.encoder_descs(
                CFG.enc_conv_shapes, size, size, CFG.enc_out_layers,
                CFG.expand_ratio)),
            pflat.chain_rows(pflat.decoder_descs(
                CFG.decoder_conv_shapes, size // 8, size // 8))]


@pytest.mark.parametrize("source", ["jax", "port"])
def test_policy_functions_match_jax_on_shipped_tables(table, source):
    table(JAX_TABLE if source == "jax" else PORT_TABLE)
    cases = ppolicy.load_policy()
    assert cases and cases == jpolicy.load_policy()
    for key in cases:
        assert ppolicy.best_impl(*_args(key)) == jpolicy.best_impl(
            *_args(key))
    for size in SIZES:
        for blocks in _chain_blocks(size):
            ours = ppolicy.plan_chain(blocks)
            assert ours == jpolicy.plan_chain(blocks)
            assert ours is not None


@pytest.mark.parametrize("source", ["jax", "port"])
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("impl", FLAT_IMPLS)
def test_planned_chains_match_jax_with_table(table, source, size, impl):
    table(JAX_TABLE if source == "jax" else PORT_TABLE)
    assert (pflat.planned_chains(CFG, size, impl, impl)
            == jflat.planned_chains(JCFG, size, impl, impl))


def test_the_port_plans_from_its_shipped_table_by_default(monkeypatch):
    monkeypatch.delenv("AST_TUNED_POLICY", raising=False)
    _clear()
    try:
        shipped = json.loads(PORT_TABLE.read_text())
        assert ppolicy.load_policy() == shipped["cases"]
        plan = pflat.planned_chains(CFG, 512, "auto", "auto")
    finally:
        _clear()
    # Every block planned from a measured row: the chains' plans are the
    # table's per-block minima (its rows carry no layout switch).
    for blocks, impls in zip(_chain_blocks(512), (plan["enc"],
                                                  plan["dec"])):
        for blk, impl in zip(blocks, impls):
            if blk["force_nhwc"]:
                assert impl == "xla"
                continue
            row = shipped["cases"][blk["key"]]
            assert impl == row["best"], blk["key"]


def test_missing_or_unreadable_table_is_empty(tmp_path, monkeypatch):
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    for path in (tmp_path / "missing.json", bad):
        monkeypatch.setenv("AST_TUNED_POLICY", str(path))
        _clear()
        assert ppolicy.load_policy() == {}
        assert ppolicy.best_impl(16, 16, 1, 3, 6, 512, 512) is None
    _clear()


@pytest.fixture
def card(monkeypatch):
    """A mocked CUDA device name."""
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: CARD)


def test_a_table_of_another_card_plans_as_with_none(table, card):
    table("/nonexistent/tuned_policy.json")
    bare = {s: pflat.planned_chains(CFG, s, "auto", "auto") for s in SIZES}
    table(JAX_TABLE)  # meta.device "TPU v5 lite0"
    assert json.loads(JAX_TABLE.read_text())["meta"]["device"] != CARD
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        plans = {s: pflat.planned_chains(CFG, s, "auto", "auto",
                                         device="cuda") for s in SIZES}
        assert ppolicy.load_policy("cuda:0") == {}
    assert plans == bare
    assert plans != {s: pflat.planned_chains(CFG, s, "auto", "auto")
                     for s in SIZES}  # the CPU reads it
    named = [w for w in caught if "TPU v5 lite0" in str(w.message)
             and CARD in str(w.message)]
    assert len(named) == len(caught) == 1


def test_the_card_s_own_table_is_used_on_it(table, card):
    table(PORT_TABLE)
    assert json.loads(PORT_TABLE.read_text())["meta"]["device"] == CARD
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert ppolicy.load_policy("cuda") == ppolicy.load_policy()
        assert (pflat.planned_chains(CFG, 512, "auto", "auto",
                                     device="cuda")
                == pflat.planned_chains(CFG, 512, "auto", "auto"))


@functools.lru_cache(maxsize=None)
def _jax_tuner():
    """The JAX package's tuner script, loaded from ``scripts/``."""
    spec = importlib.util.spec_from_file_location(
        "jax_autotune_blocks", ROOT / "scripts/autotune_blocks.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("size", SIZES)
def test_enumerate_blocks_matches_jax(size):
    ours = tuner.enumerate_blocks(CFG, size)
    assert ours == _jax_tuner().enumerate_blocks(JCFG, size)
    assert len(ours) > 15


def _need(case):
    """The routes the tuner must time for a block instance."""
    _, _, stride, _, _, h, w = case
    if stride == 2:
        return ["xla"] + (["flat2"] if s2_eligible(h, w) else [])
    return ["xla", "fused"] + (["flat"] if pflat.stride_ok(w) else [])


@pytest.mark.parametrize("size", SIZES + (1024,))
def test_shipped_table_covers_every_block(size):
    data = json.loads(PORT_TABLE.read_text())
    meta = data["meta"]
    assert meta["device"] == CARD and meta["batch"] == 8
    assert set(SIZES) <= set(meta["sizes"])
    for case in tuner.enumerate_blocks(CFG, size):
        row = data["cases"][ppolicy.block_key(*case)]
        need = _need(case)
        # ada_out (C_in 256) too: expand_dw stages its x box in channel
        # chunks, so its row holds a fused time.
        assert "fused_err" not in row, (case, row)
        assert all(row[f"{n}_ms"] > 0 for n in need), (case, row)
        assert row["best"] in need and row["tp_ms"] == 0.0
        assert row[f"{row['best']}_ms"] == min(row[f"{n}_ms"] for n in need)
        assert "flati_ms" not in row


def test_tuner_on_the_cpu_writes_every_key(tmp_path):
    out = tmp_path / "tuned.json"
    for size in (64, 32):
        assert tuner.main(["--device", "cpu", "--size", str(size),
                           "--batch", "1", "--iters", "1",
                           "--out", str(out)]) == 0
    data = json.loads(out.read_text())
    meta = data["meta"]
    assert meta["sizes"] == [32, 64] and meta["device"] == "cpu"
    assert {"batch", "iters", "git", "power_limit", "layout"} <= set(meta)
    cases = [c for s in (32, 64) for c in tuner.enumerate_blocks(CFG, s)]
    assert sorted(data["cases"]) == sorted({ppolicy.block_key(*c)
                                            for c in cases})
    for case in cases:
        row = data["cases"][ppolicy.block_key(*case)]
        assert all(row[f"{n}_ms"] > 0 for n in _need(case)), row
        assert row["best"] in _need(case) and row["tp_ms"] == 0.0
    # Incremental: nothing left to tune.
    assert tuner.main(["--device", "cpu", "--size", "32", "--iters", "1",
                       "--batch", "1", "--out", str(out),
                       "--skip_existing"]) == 0
    assert json.loads(out.read_text())["cases"] == data["cases"]


def test_tuner_refuses_to_run_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "tuned.json"
    assert tuner.main(["--size", "32", "--out", str(out)]) != 0
    assert not out.exists()


def test_the_engine_follows_the_table(table, monkeypatch):
    """Under a table whose verdicts differ from the table-less plan (keys at
    64px, the width rules at lane 16, as a 512px request routes), the
    engine calls each kernel wrapper as ``planned_launches`` says, and its
    image is the table-less route's up to f32 rounding: a plan changes the
    route, never the math."""
    from arbitrarystyletransfer_tpu_torch import engine, weights
    from arbitrarystyletransfer_tpu_torch.ops import flatblock_s2 as ps2
    from arbitrarystyletransfer_tpu_torch.ops import fused_block as pfb

    from test_torch_ops import assert_close, ast_variables

    size, lane, min_fused = 64, 16, 16
    cfg = ModelConfig(encoder_eval_stats=True, use_pallas_adaattn=True)
    v = ast_variables(seed=12)
    state = weights.from_jax_tree(v["params"], v["batch_stats"])
    rng = torch.Generator().manual_seed(12)
    content, style = (torch.rand(1, size, size, 3, generator=rng)
                      for _ in range(2))

    def run():
        calls = {"flat_block": 0, "flat_s2_block": 0, "expand_dw": 0}

        def counted(name, fn):
            def wrapper(*a, **k):
                calls[name] += 1
                return fn(*a, **k)
            return wrapper

        with monkeypatch.context() as m:
            m.setattr(pflat, "flat_block",
                      counted("flat_block", pflat.flat_block))
            m.setattr(ps2, "flat_s2_block",
                      counted("flat_s2_block", ps2.flat_s2_block))
            m.setattr(pfb, "expand_dw", counted("expand_dw", pfb.expand_dw))
            out = engine.stylize_fused(
                state, content, style, 0.8, cfg=cfg, dtype=torch.float32,
                min_fused_size=min_fused, encoder_impl="auto",
                decoder_impl="auto", lane=lane, exporting=False)
        return out, calls

    table("/nonexistent/tuned_policy.json")
    bare_plan = pflat.planned_chains(cfg, size, "auto", "auto", lane=lane)
    bare, bare_calls = run()

    # Each block's verdict: the routes it may take in turn.
    cases = {}
    for i, (c_in, c_out, stride, k, t, h, w) in enumerate(
            tuner.enumerate_blocks(CFG, size)):
        routes = (["xla"] + (["flat2"] if s2_eligible(h, w, lane) else [])
                  if stride == 2 else
                  ["xla", "fused"] + (["flat"] if pflat.stride_ok(w, lane)
                                      else []))
        best = routes[i % len(routes)]
        row = {f"{r}_ms": 1.0 if r == best else 2.0 for r in routes}
        cases[ppolicy.block_key(c_in, c_out, stride, k, t, h, w)] = {
            **row, "tp_ms": 0.0, "best": best}
    table(cases)
    plan = pflat.planned_chains(cfg, size, "auto", "auto", lane=lane)
    assert plan != bare_plan
    out, calls = run()
    assert calls == pflat.planned_launches(cfg, size, "auto", "auto",
                                           lane=lane,
                                           min_fused_size=min_fused)
    assert calls != bare_calls
    assert float(bare.std()) > 1e-3
    assert_close(out, bare, 1e-4, "pre-clamp image, tabled vs table-less")
