"""The port's BatchNorm recalibration (``train/recalibrate.py``) against the
JAX package's.

The same numpy encoder weights (``ast_variables``' encoder: fan-in weights,
SE gates open) and the same 32px batches (structured images, so that the BN
moments differ per channel) go to both; float32 on the CPU.  JAX recovers
the batch moments by inverting one EMA update, the port reads them from a
momentum-1 copy of the encoder: both are the mean over batches of the batch
mean and of the unbiased variance, then the variance floor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arbitrarystyletransfer_tpu import config as jax_config
from arbitrarystyletransfer_tpu.train import recalibrate as jax_recal

from arbitrarystyletransfer_tpu_torch import ModelConfig, weights
from arbitrarystyletransfer_tpu_torch.ops.norm import BatchNorm2D
from arbitrarystyletransfer_tpu_torch.train import recalibrate as recal

from test_torch_ops import assert_close, ast_variables

CFG = ModelConfig()
JCFG = jax_config.ModelConfig()


def _images(rng, n=8, s=32):
    base = rng.uniform(0.0, 1.0, (n, 1, 1, 3))
    noise = rng.normal(0.0, 0.15, (n, s, s, 3))
    return np.clip(base + noise, 0.0, 1.0).astype(np.float32)


def _encoder_vars(seed):
    """(numpy enc params, numpy enc stats, the same as a port state)."""
    v = ast_variables(seed=seed)
    p, s = v["params"]["enc"], v["batch_stats"]["enc"]
    return p, s, weights.from_jax_tree(p, s)


def _flat_stats(tree):
    return weights.flatten({"params": {}, "batch_stats": jax.tree.map(
        lambda t: torch.as_tensor(np.array(t)), tree)})


def _assert_trees_close(got, ref, rtol, atol):
    got, ref = _flat_stats(got), _flat_stats(ref)
    assert sorted(got) == sorted(ref)
    for key in ref:
        np.testing.assert_allclose(got[key].numpy(), ref[key].numpy(),
                                   rtol=rtol, atol=atol, err_msg=key)


@pytest.mark.parametrize("n_batches,floor", [(1, 1e-3), (3, 1e-3), (3, 0.0)])
def test_recalibration_matches_jax(n_batches, floor):
    p, s, state = _encoder_vars(41)
    rng = np.random.default_rng(42)
    batches = [_images(rng) for _ in range(n_batches)]
    got = recal.recalibrate_encoder_stats(state["params"],
                                          state["batch_stats"], batches, CFG,
                                          var_floor_rel=floor)
    ref = jax_recal.recalibrate_encoder_stats(
        jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, s),
        [jnp.asarray(b) for b in batches], JCFG, var_floor_rel=floor)
    _assert_trees_close(got, ref, rtol=1e-4, atol=1e-5)


def test_batch_moments_are_exact():
    """At one BatchNorm, the momentum-1 buffers are numpy's moments of its
    input: the mean and the unbiased variance."""
    rng = np.random.default_rng(43)
    x = rng.normal(1.5, 2.0, (8, 6, 6, 16)).astype(np.float32)
    bn = BatchNorm2D(16, momentum=1.0)
    bn.mean.fill_(1e6)  # running values the result must not depend on
    bn.var.fill_(-7.0)
    bn(torch.from_numpy(x), use_batch_stats=True, update_stats=True)
    xs = x.astype(np.float64).reshape(-1, 16)
    np.testing.assert_allclose(bn.mean.numpy(), xs.mean(0), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(bn.var.numpy(), xs.var(0, ddof=1), rtol=1e-4,
                               atol=1e-5)


def test_recalibration_is_independent_of_seed_stats():
    _, _, state = _encoder_vars(44)
    x = _images(np.random.default_rng(45))
    skewed = weights._map_tree(lambda t: t * 3.0 + 0.7, state["batch_stats"])
    a = recal.recalibrate_encoder_stats(state["params"],
                                        state["batch_stats"], [x])
    b = recal.recalibrate_encoder_stats(state["params"], skewed, [x])
    flat_a, flat_b = _flat_stats(a), _flat_stats(b)
    assert all(torch.equal(flat_a[k], flat_b[k]) for k in flat_a)


def test_recalibration_averages_batches():
    """K identical batches give the result of one (a plain mean)."""
    _, _, state = _encoder_vars(46)
    x = _images(np.random.default_rng(47))
    one = recal.recalibrate_encoder_stats(state["params"],
                                          state["batch_stats"], [x])
    three = recal.recalibrate_encoder_stats(state["params"],
                                            state["batch_stats"], [x, x, x])
    _assert_trees_close(three, one, rtol=1e-6, atol=0)


def test_variance_floor_is_applied():
    """Each site's variances end at or above 1e-3 of their channel mean, and
    the floor moves only the variances that were below it: four expand
    channels of block 1 are made dead (zero kernel, variance 0)."""
    _, _, state = _encoder_vars(48)
    params, stats = state["params"], state["batch_stats"]
    params["mob_net_1"]["Conv_0"]["kernel"][..., :4] = 0.0
    batches = [_images(np.random.default_rng(49))]
    raw = _flat_stats(recal.recalibrate_encoder_stats(
        params, stats, batches, var_floor_rel=0.0))
    floored = _flat_stats(recal.recalibrate_encoder_stats(
        params, stats, batches))
    lifted = 0
    for key, var in raw.items():
        if not key.endswith("/var"):
            assert torch.equal(floored[key], var)
            continue
        floor = 1e-3 * var.mean()
        assert torch.equal(floored[key], torch.maximum(var, floor))
        assert bool((floored[key] >= floor).all())
        lifted += int((var < floor).sum())
    assert lifted >= 4


def test_floor_matches_jax():
    rng = np.random.default_rng(57)
    tree = {"a": {"mean": rng.normal(size=8).astype(np.float32),
                  "var": (10.0 ** rng.uniform(-6, 1, 8)).astype(np.float32)},
            "b": {"c": {"mean": rng.normal(size=5).astype(np.float32),
                        "var": (10.0 ** rng.uniform(-6, 1, 5)).astype(
                            np.float32)}}}
    got = recal._floor_variances(weights._map_tree(torch.from_numpy, tree),
                                 1e-3)
    ref = jax_recal._floor_variances(jax.tree.map(jnp.asarray, tree), 1e-3)
    _assert_trees_close(got, ref, rtol=0, atol=0)


def test_recalibration_leaves_the_callers_tensors_alone():
    _, _, state = _encoder_vars(50)
    before = {k: v.clone() for k, v in weights.flatten(state).items()}
    recal.recalibrate_variables({"params": {"enc": state["params"]},
                                 "batch_stats": {"enc": state["batch_stats"]}},
                                [_images(np.random.default_rng(51))])
    after = weights.flatten(state)
    assert all(torch.equal(before[k], after[k]) for k in before)


def test_recalibrate_variables_replaces_the_encoder_stats_only():
    v = ast_variables(seed=52)
    state = weights.from_jax_tree(v["params"], v["batch_stats"])
    state["batch_stats"]["other"] = {"mean": torch.ones(3)}
    batches = [_images(np.random.default_rng(53))]
    out = recal.recalibrate_variables(state, batches)
    assert out["params"] is state["params"]
    assert out["batch_stats"]["other"] is state["batch_stats"]["other"]
    ref = recal.recalibrate_encoder_stats(
        state["params"]["enc"], state["batch_stats"]["enc"], batches)
    _assert_trees_close(out["batch_stats"]["enc"], ref, rtol=0, atol=0)


@pytest.mark.parametrize("recalibrated", [True, False])
def test_drift_matches_jax(recalibrated):
    p, s, state = _encoder_vars(54)
    rng = np.random.default_rng(55)
    batches = [_images(rng) for _ in range(3)]
    stats = state["batch_stats"]
    if recalibrated:
        stats = recal.recalibrate_encoder_stats(state["params"], stats,
                                                batches[:2])
    got = recal.eval_stats_drift(state["params"], stats, batches[2:], CFG)
    ref = jax_recal.eval_stats_drift(
        jax.tree.map(jnp.asarray, p),
        jax.tree.map(lambda t: jnp.asarray(np.asarray(t)), stats),
        [jnp.asarray(b) for b in batches[2:]], JCFG)
    assert np.isfinite(got) and got > 0
    assert_close(got, ref, 1e-4, "drift")


def test_recalibration_needs_batches():
    _, _, state = _encoder_vars(56)
    with pytest.raises(ValueError, match="at least one batch"):
        recal.recalibrate_encoder_stats(state["params"],
                                        state["batch_stats"], [])
    with pytest.raises(ValueError, match="at least one batch"):
        recal.eval_stats_drift(state["params"], state["batch_stats"], [])
