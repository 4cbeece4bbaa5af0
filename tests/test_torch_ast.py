"""The port's ``AST`` module against the flax ``AST``, and against the port's
own fused engine.

The same numpy variables (``ast_variables``: fan-in weights, SE gates open,
AdaAttN logits of std ~1.4) go to both; batches are seeded uniform images at
32px; float32 on the CPU.  The port runs AdaAttN through the kernel route
(its twins on the CPU), the flax graph through the dense function: the two
are held equal in ``test_torch_adaattn_bwd.py``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arbitrarystyletransfer_tpu import config as jax_config
from arbitrarystyletransfer_tpu.models import AST as JaxAST

from arbitrarystyletransfer_tpu_torch import ModelConfig, engine, weights
from arbitrarystyletransfer_tpu_torch.models.ast import AST

from test_torch_ops import assert_close, ast_variables

CFG = ModelConfig(use_pallas_adaattn=True)


def _images(seed, b=2, size=32):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, (b, size, size, 3)).astype(np.float32)
            for _ in range(2)]


def _port(v, cfg=CFG):
    ast = AST(cfg)
    weights.load_state(ast, weights.from_jax_tree(v["params"],
                                                  v["batch_stats"]))
    return ast


@functools.partial(jax.jit, static_argnames=("cfg", "method", "train"))
def _flax(variables, content, style, alpha, cfg, method, train=False):
    model = JaxAST(cfg)
    if method == "forward":
        return model.apply(variables, content, style, alpha, train=train,
                           mutable=["batch_stats"])
    if method == "export":
        return model.apply(variables, content, style, method=JaxAST.export)
    return model.apply(variables, content, style, alpha,
                       method=JaxAST.stylize)


@pytest.mark.parametrize("encoder_eval_stats", [False, True])
def test_training_forward_and_stats_match_flax(encoder_eval_stats):
    v = ast_variables(seed=21)
    cfg = dataclasses.replace(CFG, encoder_eval_stats=encoder_eval_stats)
    ast = _port(v, cfg)
    content, style = _images(22)
    t_cs, (sm1, sm2), org_out = ast(torch.from_numpy(content),
                                    torch.from_numpy(style), 1.0, train=True)
    jcfg = jax_config.ModelConfig(encoder_eval_stats=encoder_eval_stats)
    (r_t, (r_sm1, r_sm2), r_org), mutated = _flax(
        v, jnp.asarray(content), jnp.asarray(style), 1.0, jcfg, "forward",
        train=True)
    # ~35 blocks of convs summed in another order: 1e-4 of max.
    for what, out, ref in (("t_cs", t_cs, r_t), ("sm1", sm1, r_sm1),
                           ("sm2", sm2, r_sm2), ("org_out", org_out, r_org)):
        assert_close(out.detach(), ref, 1e-4, what)
    flat = weights.flatten(weights.module_state(ast))
    ref_stats = weights.flatten(weights.from_jax_tree(
        {}, jax.tree.map(np.asarray, mutated["batch_stats"])))
    stat_keys = [k for k in flat if k.startswith("batch_stats/")]
    assert sorted(stat_keys) == sorted(ref_stats)
    orig = weights.flatten(weights.from_jax_tree({}, v["batch_stats"]))
    moved = 0
    for key in stat_keys:
        assert_close(flat[key], ref_stats[key], 1e-5, key)
        moved += not torch.equal(flat[key], orig[key])
    assert moved == len(stat_keys)  # the identity encode updated them all


@pytest.mark.parametrize("method,alpha", [("stylize", 0.6),
                                          ("export", 1.0)])
def test_inference_matches_flax(method, alpha):
    v = ast_variables(seed=23)
    ast = _port(v)
    content, style = _images(24)
    before = weights.flatten(weights.module_state(ast))
    with torch.no_grad():
        c, s = torch.from_numpy(content), torch.from_numpy(style)
        out = ast.stylize(c, s, alpha) if method == "stylize" else (
            ast.export(c, s))
        pre_clamp = ast.dec(ast.encode(c, s, train=False))
    ref = _flax(v, jnp.asarray(content), jnp.asarray(style), alpha,
                jax_config.ModelConfig(), method)
    assert out.shape == (2, 32, 32, 3)
    assert 0.0 <= float(out.min()) and float(out.max()) <= 1.0
    assert 0.0 < float(out.mean()) < 1.0
    # 1e-4 of the largest pre-clamp value: the clamp lowers the max, not
    # the error of the values it keeps.
    rel = 1e-4 * float(pre_clamp.abs().max()) / float(jnp.abs(ref).max())
    assert_close(out, ref, rel, method)
    after = weights.flatten(weights.module_state(ast))
    assert all(torch.equal(before[k], after[k]) for k in before)


def test_stylize_matches_the_fused_engine():
    """At encoder_eval_stats=True the module graph and the engine (BatchNorm
    folded into the convs) compute the same image."""
    v = ast_variables(seed=25)
    cfg = dataclasses.replace(CFG, encoder_eval_stats=True)
    ast = _port(v, cfg)
    content, style = map(torch.from_numpy, _images(26))
    with torch.no_grad():
        out = ast.stylize(content, style, 0.7)
    ref = engine.stylize_fused(weights.module_state(ast), content, style,
                               0.7, cfg=cfg, dtype=torch.float32)
    # Folded BN and the phase-folded upsample round differently.
    assert_close(out, ref, 1e-4, "image")
