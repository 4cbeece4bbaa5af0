"""PyTorch port vs the JAX package: config, basic ops, plain block routes,
weights.

Inputs and parameters are made with numpy from a seed and fed to both
packages; everything runs at float32 on the CPU.  Tolerances are stated per
test, relative to the reference's largest magnitude where the values pass
through several summations in different orders.

The parameter helpers here (``fill_variables``, ``ast_variables``,
``block_params``) are shared by the other ``test_torch_*`` files.
"""

import dataclasses
import functools
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arbitrarystyletransfer_tpu import config as jax_config
from arbitrarystyletransfer_tpu.models import AST
from arbitrarystyletransfer_tpu.ops import stats as jax_stats
from arbitrarystyletransfer_tpu.ops.pallas import fused_block as jfb

from arbitrarystyletransfer_tpu_torch import config as port_config
from arbitrarystyletransfer_tpu_torch import weights
from arbitrarystyletransfer_tpu_torch.ops import basic, blocks, stats

# The suite runs in several worker processes on one CPU: torch's default of
# one intra-op thread per core in each of them oversubscribes it many times.
torch.set_num_threads(max(1, (os.cpu_count() or 1) // 4))

# A non-residual block's projection kernels are scaled up by this factor so
# that random weights keep the signal's spatial variation alive through the
# whole network (at fan-in scale it shrinks ~7x per such block, and the
# image would be a constant that hides every difference).
PROJ_GAIN = 5.0
# AdaAttN's logits are unscaled: with fan-in q and k projections they have
# std ~sqrt(128), and the output moves ~1000x any relative change of its
# input, which no f32 comparison survives.  This gain gives logits of std
# ~1.4, a softmax that is peaked but well conditioned.
QK_GAIN = 0.35


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32).copy())


def fill_variables(shape_tree, rng, proj_gain=PROJ_GAIN):
    """numpy arrays for a flax variable-shape tree: fan-in scaled normal
    kernels, SE excitation biases near 0.5 (gates mostly open), BN scale
    near 1 and running variance in [0.5, 1.5]; non-residual projections get
    ``proj_gain`` and the AdaAttN q and k projections ``QK_GAIN``."""
    def leaf(path, sd):
        names = [p.key for p in path]
        name, shape = names[-1], sd.shape
        if name == "kernel":
            gain = QK_GAIN if names[-2] in ("W_q", "W_k") else 1.0
            std = gain / math.sqrt(math.prod(shape[:-1]))
            return rng.normal(0.0, std, shape).astype(np.float32)
        if name == "bias":
            base = 0.5 if names[-2] == "Dense_1" else 0.0
            return (base + rng.normal(0.0, 0.1, shape)).astype(np.float32)
        if name == "scale":
            return (1.0 + rng.normal(0.0, 0.1, shape)).astype(np.float32)
        if name == "mean":
            return rng.normal(0.0, 0.1, shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        raise KeyError("/".join(names))

    tree = jax.tree_util.tree_map_with_path(leaf, shape_tree)

    def boost(node):
        if not isinstance(node, dict):
            return
        proj = "Conv_1" if "Conv_1" in node else "Conv_0"
        if "DepthwiseConv2D_0" in node:
            w_proj = node[proj]["kernel"]
            c_in = (node["Conv_0"]["kernel"].shape[2] if proj == "Conv_1"
                    else w_proj.shape[2])
            if c_in != w_proj.shape[3]:
                node[proj]["kernel"] = w_proj * np.float32(proj_gain)
            return
        for child in node.values():
            boost(child)

    boost(tree.get("params", tree))
    return tree


@functools.lru_cache(maxsize=None)
def _ast_shapes():
    cfg = jax_config.ModelConfig(encoder_eval_stats=True)
    d = jnp.zeros((1, 32, 32, 3), jnp.float32)
    return jax.eval_shape(functools.partial(AST(cfg).init, train=False),
                          jax.random.PRNGKey(0), d, d)


def ast_variables(seed=0, proj_gain=PROJ_GAIN):
    """Filled AST variables {"params", "batch_stats"} (nested numpy dicts),
    from the JAX tree's shapes (``jax.eval_shape``, no flax init)."""
    return fill_variables(
        {"params": _ast_shapes()["params"],
         "batch_stats": _ast_shapes()["batch_stats"]},
        np.random.default_rng(seed), proj_gain)


def block_params(c_in, c_out, k, t, use_norm, seed=0):
    """(params, stats) numpy subtrees of one DepthWiseConv block."""
    hidden = round(c_in * t)
    red = weights.make_divisible(hidden // 4, 8)
    shapes = {"DepthwiseConv2D_0": {"kernel": (k, k, 1, hidden)},
              "SELayer_0": {"Dense_0": {"kernel": (hidden, red),
                                        "bias": (red,)},
                            "Dense_1": {"kernel": (red, hidden),
                                        "bias": (hidden,)}}}
    bns = ["BatchNorm2D_0", "BatchNorm2D_1"]
    if t == 1:
        shapes["Conv_0"] = {"kernel": (1, 1, hidden, c_out)}
        bn_ch = [hidden, c_out]
    else:
        shapes["Conv_0"] = {"kernel": (1, 1, c_in, hidden)}
        shapes["Conv_1"] = {"kernel": (1, 1, hidden, c_out)}
        bns.append("BatchNorm2D_2")
        bn_ch = [hidden, hidden, c_out]
    stats_shapes = None
    if use_norm:
        stats_shapes = {}
        for name, ch in zip(bns, bn_ch):
            shapes[name] = {"scale": (ch,), "bias": (ch,)}
            stats_shapes[name] = {"mean": (ch,), "var": (ch,)}
    to_sd = functools.partial(
        jax.tree.map, lambda s: jax.ShapeDtypeStruct(s, jnp.float32),
        is_leaf=lambda s: isinstance(s, tuple))
    tree = fill_variables(
        {"params": to_sd(shapes),
         "batch_stats": to_sd(stats_shapes) if use_norm else {}},
        np.random.default_rng(seed))
    return tree["params"], (tree["batch_stats"] if use_norm else None)


def to_port(tree):
    return None if tree is None else weights.from_jax_tree(tree, {})["params"]


def to_jax(tree):
    return None if tree is None else jax.tree.map(jnp.asarray, tree)


def assert_close(out, ref, rel, what=""):
    """max |out - ref| <= rel * max |ref| (+ a floor for all-zero refs)."""
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    bound = rel * max(np.abs(ref).max(), 1e-6)
    err = np.abs(out - ref).max()
    assert err <= bound, f"{what}: max abs err {err:.3g} > {bound:.3g}"


# -- config ----------------------------------------------------------------


def test_config_copy_matches_jax_config():
    assert (dataclasses.asdict(port_config.ModelConfig())
            == dataclasses.asdict(jax_config.ModelConfig()))
    for name in ("ENC_CONV_SHAPES", "DECODER_CONV_SHAPES", "EXPAND_RATIO",
                 "ENC_OUT_LAYERS", "ENC_OUT_CHANNELS", "VGG_CONTENT_LAYERS"):
        assert getattr(port_config, name) == getattr(jax_config, name), name


def test_train_config_copy_matches_jax_config():
    assert (dataclasses.asdict(port_config.ASTTrainConfig())
            == dataclasses.asdict(jax_config.ASTTrainConfig()))
    assert port_config.IMG_SIZES == jax_config.IMG_SIZES


@pytest.mark.parametrize("name,dtype", [("float32", torch.float32),
                                        ("bfloat16", torch.bfloat16)])
def test_torch_dtype(name, dtype):
    cfg = port_config.ModelConfig(compute_dtype=name)
    assert port_config.torch_dtype(cfg) == dtype


def test_port_imports_no_jax():
    """Every port module imports without jax or the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import arbitrarystyletransfer_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "             ('jax', 'flax', 'optax', 'orbax',\n"
        "              'arbitrarystyletransfer_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


# -- stats and basic ops ---------------------------------------------------


def test_stats_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(0.3, 2.0, (2, 5, 7, 6)).astype(np.float32)
    v = rng.normal(0.0, 1.0, (50,)).astype(np.float32)
    # Same formula, same f32 arithmetic: a few ulps.
    assert_close(stats.instance_norm(_t(x)),
                 jax_stats.instance_norm(jnp.asarray(x)), 1e-6, "IN")
    assert_close(stats.safe_sqrt(_t(v)), jax_stats.safe_sqrt(jnp.asarray(v)),
                 1e-7, "safe_sqrt")


def test_basic_ops_match_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(0.0, 3.0, (2, 6, 5, 4)).astype(np.float32)
    xj = jnp.asarray(x)
    np.testing.assert_array_equal(basic.hardswish(_t(x)),
                                  jfb._hardswish(xj))
    for pad in (1, 2):
        np.testing.assert_array_equal(
            basic.reflect_pad(_t(x), pad),
            jnp.pad(xj, ((0, 0), (pad, pad), (pad, pad), (0, 0)),
                    mode="reflect"))
    np.testing.assert_array_equal(
        basic.edge_pad(_t(x), 1),
        jnp.pad(xj, ((0, 0), (1, 1), (1, 1), (0, 0)), mode="edge"))

    p, s = block_params(8, 8, 3, 3, use_norm=True)
    a, c = basic.bn_fold(to_port(p)["BatchNorm2D_0"],
                         to_port(s)["BatchNorm2D_0"])
    ja, jc = jfb.bn_fold(to_jax(p)["BatchNorm2D_0"], to_jax(s)["BatchNorm2D_0"])
    assert_close(a, ja, 1e-6, "bn scale")
    assert_close(c, jc, 1e-6, "bn bias")

    sums = rng.uniform(0.0, 30.0, (2, 24)).astype(np.float32)
    gate = basic.se_gate(_t(sums), 30, to_port(p)["SELayer_0"])
    ref = jfb._se_gate(jnp.asarray(sums), 30, to_jax(p)["SELayer_0"], 24)
    assert_close(gate, ref, 1e-6, "se gate")
    assert 0.0 < float(gate.mean()) < 1.0


# -- plain block routes ----------------------------------------------------


@pytest.mark.parametrize(
    "c_in,c_out,k,stride,t,use_norm",
    [
        (16, 16, 3, 1, 6, True),    # e1 shape, residual, folded BN
        (24, 40, 5, 2, 6, True),    # e4: stride 2, folded BN
        (16, 24, 3, 2, 6, False),   # stride 2 without stats
        (40, 24, 5, 1, 6, False),   # d10 shape, decoder (no BN)
        (96, 96, 3, 1, 1, False),   # expand==1
        (40, 40, 3, 1, 1, True),    # expand==1 with folded BN
    ],
)
def test_plain_block_matches_xla_block(c_in, c_out, k, stride, t, use_norm):
    p, s = block_params(c_in, c_out, k, t, use_norm, seed=c_in + k)
    x = np.random.default_rng(2).normal(0, 1, (2, 11, 13, c_in))
    x = x.astype(np.float32)
    out = blocks.plain_block_apply(to_port(p), _t(x), k, stride, t,
                                   stats=to_port(s), dtype=torch.float32)
    ref = jfb.xla_block_apply(to_jax(p), jnp.asarray(x), k, stride, t,
                              stats=to_jax(s), dtype=jnp.float32)
    # Conv and matmul sums in another order: well inside 1e-5 of max.
    assert_close(out, ref, 1e-5, "plain block")


def test_upsample_smooth_matches_unfolded_block():
    """The phase-folded upsample + smoothing block equals a nearest-x2
    upsample followed by the expand==1 block (the flax decoder's math).

    The JAX package's three folded twins (fused_block.py:630,
    flatblock.py:733, megablock.py:587) fold the second axis of the 3x3
    kernel along the wrong axis (a clamped index), so they are not the
    reference here; ROADMAP queue 3 records the fault."""
    p, _ = block_params(40, 40, 3, 1, use_norm=False, seed=3)
    x = np.random.default_rng(3).normal(0, 1, (2, 7, 9, 40))
    x = x.astype(np.float32)
    out = blocks.upsample_smooth_apply(to_port(p), _t(x), dtype=torch.float32)
    up = jfb.nearest_upsample_2x(jnp.asarray(x))
    ref = jfb.xla_block_apply(to_jax(p), up, 3, 1, 1, dtype=jnp.float32)
    # Pre-summed phase weights round differently from the unfolded conv.
    assert_close(out, ref, 1e-5, "upsample+smooth")


@pytest.mark.parametrize("stride", [1, 2])
def test_stem_and_head_match_jax(stride):
    rng = np.random.default_rng(4)
    w = rng.normal(0, 0.3, (3, 3, 3, 16)).astype(np.float32)
    x = rng.uniform(0, 1, (2, 12, 10, 3)).astype(np.float32)
    out = blocks.stem_apply({"kernel": _t(w)}, _t(x), stride=stride,
                            dtype=torch.float32)
    xp = jnp.pad(jnp.asarray(x), ((0, 0), (1, 1), (1, 1), (0, 0)),
                 mode="reflect")
    ref = jfb._hardswish(jax.lax.conv_general_dilated(
        xp, jnp.asarray(w), (stride,) * 2, "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    assert_close(out, ref, 1e-6, "stem")

    head = {"kernel": rng.normal(0, 0.3, (3, 3, 16, 3)).astype(np.float32),
            "bias": np.array([0.5, 0.2, 0.8], np.float32)}
    z = rng.normal(0, 1, (2, 12, 10, 16)).astype(np.float32)
    for exporting in (False, True):
        out = blocks.head_apply(to_port(head), _t(z), exporting=exporting,
                                dtype=torch.float32)
        zp = jnp.pad(jnp.asarray(z), ((0, 0), (1, 1), (1, 1), (0, 0)),
                     mode="reflect")
        ref = jax.lax.conv_general_dilated(
            zp, jnp.asarray(head["kernel"]), (1, 1), "VALID",
            dimension_numbers=("NHWC", "HWIO", "NHWC")) + head["bias"]
        if exporting:
            ref = jnp.clip(ref, 0.0, 1.0)
        assert_close(out, ref, 1e-6, f"head exporting={exporting}")


# -- weights ---------------------------------------------------------------


def _shape_tree(tree):
    if isinstance(tree, dict):
        return {k: _shape_tree(v) for k, v in tree.items()}
    return tuple(tree.shape)


def test_init_params_has_the_jax_tree():
    state = weights.init_params(port_config.ModelConfig(),
                                torch.Generator().manual_seed(0))
    shapes = _ast_shapes()
    assert _shape_tree(state["params"]) == _shape_tree(dict(shapes["params"]))
    assert (_shape_tree(state["batch_stats"])
            == _shape_tree(dict(shapes["batch_stats"])))
    flat = weights.flatten(state)
    assert all(float(v.min()) > 0 for k, v in flat.items()
               if k.endswith("/var"))
    again = weights.init_params(port_config.ModelConfig(),
                                torch.Generator().manual_seed(0))
    assert all(torch.equal(v, weights.flatten(again)[k])
               for k, v in flat.items())


def test_npz_round_trip(tmp_path):
    v = ast_variables(seed=1)
    state = weights.from_jax_tree(v["params"], v["batch_stats"])
    path = tmp_path / "state.npz"
    weights.save_npz(path, state)
    loaded = weights.load_npz(path)
    flat, flat2 = weights.flatten(state), weights.flatten(loaded)
    assert "params/enc/mob_net_1/Conv_0/kernel" in flat2
    assert flat.keys() == flat2.keys()
    assert all(torch.equal(flat[k], flat2[k]) for k in flat)
