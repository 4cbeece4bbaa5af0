"""One whole Stage-2 train step of the port against the JAX
``make_ast_train_step``: the loss, each aux term, every gradient and the
new BatchNorm running statistics, from the same variables and batch.

The full-width ``ModelConfig``, 32px, batch 2, the seeded random VGG given
to both as numpy.  The port runs AdaAttN through the kernel route (the CUDA
kernels' twins on the CPU), JAX through its dense function, which its own
tests hold equal to the Pallas route (``test_torch_adaattn_bwd.py`` holds
the port's backward against the Pallas one).  The decoder head is rescaled
so that the image lies in [0, 1], as a trained one does: an image far out
of range puts the 1e8-weighted out-of-range term and the pixel gram
matrices on values of ~30 and loses digits to cancellation.  The JAX step's
optimizer is replaced by a transform that stores the gradients in the
optimizer state and leaves the parameters as they are, so the step returns
its gradients.

The yardstick is the JAX step in float64: its explicit float32 casts are
made float64 for the trace (``jnp.float32`` is rebound while it traces), as
the port's ``.float()`` casts are for the port's float64 step.  The two
float64 steps agree to rounding, which checks every formula of the step
(detaches, tap weights, the order of the statistics updates).  The port's
float32 step is then held against it with fixed limits: on this random
network the JAX float32 CPU step is ~2e-3 of a tensor's max away from
float64 in the worst tensor, the port's ~1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from arbitrarystyletransfer_tpu import config as jax_config
from arbitrarystyletransfer_tpu.models import AST as JaxAST
from arbitrarystyletransfer_tpu.models import VGG19Features as JaxVGG
from arbitrarystyletransfer_tpu.train import create_train_state
from arbitrarystyletransfer_tpu.train import make_ast_train_step

from arbitrarystyletransfer_tpu_torch import ModelConfig, weights
from arbitrarystyletransfer_tpu_torch.config import ASTTrainConfig
from arbitrarystyletransfer_tpu_torch.models.ast import AST
from arbitrarystyletransfer_tpu_torch.models.vgg import (
    VGG19Features,
    init_vgg_params,
)
from arbitrarystyletransfer_tpu_torch.train.ast_trainer import ast_loss

from test_torch_ops import assert_close, ast_variables

AUX_KEYS = ("content_loss", "style_loss", "lf_loss", "tv_loss",
            "org_img_loss", "hist_loss", "out_of_range_loss", "loss")


def _grab_gradients():
    """An optax transform whose state after a step is the gradients."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (
            jax.tree.map(jnp.zeros_like, grads), grads))


def _normalize_head(v, ast, content, style):
    """Rescale the head (in ``v``) so the stylized image has a per-channel
    mean 0.5 and spatial std 0.05."""
    with torch.no_grad():
        pre = ast.dec(ast.encode(torch.from_numpy(content),
                                 torch.from_numpy(style), detach=True))
    pre = pre.double().numpy()
    head = v["params"]["dec"]["img_out"]
    scale = 0.05 / pre.std(axis=(1, 2)).mean(axis=0)
    head["kernel"] = (head["kernel"] * scale).astype(np.float32)
    head["bias"] = (0.5 - scale * (pre.mean(axis=(0, 1, 2)) - head["bias"])
                    ).astype(np.float32)


def _port_step(v, vgg_params, content, style, dtype=torch.float32):
    """(module, aux, gradients) of one port step in ``dtype``."""
    ast = AST(ModelConfig(use_pallas_adaattn=True))
    weights.load_state(ast, weights.from_jax_tree(v["params"],
                                                  v["batch_stats"]))
    vgg = VGG19Features()
    vgg.load_params(vgg_params)
    ast.to(dtype)
    vgg.to(dtype)
    total, aux = ast_loss(ast, vgg, ASTTrainConfig(),
                          torch.from_numpy(content).to(dtype),
                          torch.from_numpy(style).to(dtype))
    return ast, aux, torch.autograd.grad(total, list(ast.parameters()))


def _jax_step_f64(v, vgg_params, content, style):
    """(aux, gradients, batch_stats) of the JAX step in float64, the
    gradients and statistics as flat float64 numpy dicts."""
    f32 = jnp.float32
    with jax.enable_x64(True):
        jnp.float32 = jnp.float64
        try:
            step = make_ast_train_step(JaxAST(jax_config.ModelConfig()),
                                       JaxVGG(), jax_config.ASTTrainConfig())

            def cast(x):
                return jnp.asarray(x, jnp.float64)

            state = create_train_state(jax.tree.map(cast, v["params"]),
                                       jax.tree.map(cast, v["batch_stats"]),
                                       _grab_gradients())
            new_state, aux = step(state, jax.tree.map(cast, vgg_params),
                                  cast(content), cast(style))
            aux = {k: np.float64(aux[k]) for k in (*AUX_KEYS, "finite")}
            grads = weights.flatten({
                "params": jax.tree.map(np.asarray, new_state.opt_state),
                "batch_stats": {}})
            stats = weights.flatten({
                "params": {},
                "batch_stats": jax.tree.map(np.asarray,
                                            new_state.batch_stats)})
        finally:
            jnp.float32 = f32
    assert all(g.dtype == np.float64 for g in grads.values())
    return aux, grads, stats


@functools.lru_cache(maxsize=None)
def _reference():
    """(variables with the head normalized, VGG params, content, style, the
    JAX float64 step's (aux, gradients, batch_stats)): the inputs and the
    yardstick of the float32 and the bf16 step tests (computed once)."""
    v = ast_variables(seed=31, proj_gain=1.0)
    vgg_params = init_vgg_params(generator=torch.Generator().manual_seed(32))
    rng = np.random.default_rng(33)
    content, style = (rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
                      for _ in range(2))

    ast = AST(ModelConfig())
    weights.load_state(ast, weights.from_jax_tree(v["params"],
                                                  v["batch_stats"]))
    _normalize_head(v, ast, content, style)
    return (v, vgg_params, content, style,
            _jax_step_f64(v, vgg_params, content, style))


def test_train_step_matches_jax(monkeypatch):
    v, vgg_params, content, style, ref = _reference()
    ref_aux, ref_grads, ref_stats = ref
    assert bool(ref_aux["finite"])

    ast, aux, grads = _port_step(v, vgg_params, content, style)
    to_f32 = torch.Tensor.float
    monkeypatch.setattr(torch.Tensor, "float", lambda t, *a, **k: (
        t if t.dtype == torch.float64 else to_f32(t, *a, **k)))
    ast64, aux64, grads64 = _port_step(v, vgg_params, content, style,
                                       torch.float64)
    monkeypatch.undo()
    assert all(g.dtype == torch.float64 for g in grads64)

    names = [f"params/{n.replace('.', '/')}" for n, _ in
             ast.named_parameters()]
    assert sorted(ref_grads) == sorted(names)
    largest = max(float(np.abs(r).max()) for r in ref_grads.values())

    for key in AUX_KEYS:
        # Both float64 steps: the same sums in another order (measured
        # <= 3.2e-15).
        assert_close(aux64[key], ref_aux[key], 1e-12, key)
        # The float32 step: ~35 blocks, 6 VGG taps and the loss in f32;
        # lf_loss, through the re-encode of the stylized image, is the
        # farthest (~8e-6).
        assert_close(aux[key], ref_aux[key], 1e-5, key)

    for name, g, g64 in zip(names, grads, grads64):
        ref = ref_grads[name]
        # Relative to the tensor's largest gradient, floored at 1e-4 of the
        # largest of all: the last BatchNorm bias of each encoder block has
        # a gradient of ~1e-8, rounding noise (the next block's BatchNorm
        # removes a shift).
        scale = max(float(np.abs(ref).max()), 1e-4 * largest)
        rel = scale / max(float(np.abs(ref).max()), 1e-30)
        # float64: measured <= 5.4e-13 of the scale.
        assert_close(g64.numpy(), ref, 1e-10 * rel, name)
        # float32: measured <= 9.2e-5 of the scale.
        assert_close(g, ref, 5e-4 * rel, name)

    flat = weights.flatten(weights.module_state(ast))
    flat64 = weights.flatten(weights.module_state(ast64))
    assert sorted(ref_stats) == sorted(k for k in flat
                                       if k.startswith("batch_stats/"))
    for key, ref in ref_stats.items():
        # float64: measured <= 9.2e-14.
        assert_close(flat64[key].numpy(), ref, 1e-11, key)
        # The running variance averages a batch variance of ~35 blocks'
        # activations in f32: measured <= 5.2e-5.
        assert_close(flat[key], ref, 1e-4, key)


# -- bfloat16 ----------------------------------------------------------------

# The bf16 steps (compute_dtype "bfloat16": convs and products in bf16,
# parameters, statistics and losses f32) lie far from float64: each of ~35
# blocks rounds to 8 bits.  On this network (32px, batch 2) the AST
# step's gradients lie a median 0.30 of their floored scale from the
# float64 step's for both the port and JAX
# (port 0.304, JAX 0.305; the worst tensor 0.83 and 1.34), its loss terms
# 1.5e-3 to 4.2e-2 (JAX 7.5e-4 to 4.5e-2; per term the port up to 2.1x
# JAX); the autoencoder's a median 0.010 (JAX 0.009), the worst 0.49 (JAX
# 0.58), its losses 6.7e-5 to 1.4e-4 (0.95x JAX).  The port's distance to
# JAX's bf16 step is as large as either's to float64 (AST median 0.32, AE
# 0.011): two independent roundings.  So the gates hold the port to JAX's
# own bf16 error, with the stated headroom over what was measured:
BF16_TERM_FACTOR = 3.0     # a loss term: 3x JAX's distance (measured 2.1x),
BF16_TERM_FLOOR = 2.0 ** -7  # floored at two bf16 ulps (relative)
BF16_GRAD_FACTOR = 1.5     # gradients: the median and the worst tensor
                           # (measured <= 1.08x and <= 0.85x), and the
                           # median distance to JAX's bf16 step against
                           # JAX's to float64 (measured <= 1.18x)


def _grad_distances(grads, other, ref_grads):
    """{name: max |g - other| over the float64 gradient's scale, floored at
    1e-4 of the largest float64 gradient} (the float32 test's scale)."""
    largest = max(float(np.abs(r).max()) for r in ref_grads.values())
    return {n: float(np.abs(np.asarray(grads[n], np.float64)
                            - np.asarray(other[n], np.float64)).max())
            / max(float(np.abs(r).max()), 1e-4 * largest)
            for n, r in ref_grads.items()}


def check_bf16_step(port, jax_bf16, ref, keys):
    """Holds the port's bf16 step (aux, {name: gradient}) to JAX's bf16 step
    and both to the float64 step ``ref`` (aux, gradients): each loss term
    within ``BF16_TERM_FACTOR`` times JAX's distance to float64 (floored at
    ``BF16_TERM_FLOOR``; a term that is 0 in float64 stays 0); the median
    and the worst gradient distance within ``BF16_GRAD_FACTOR`` times
    JAX's; the median gradient distance to JAX's bf16 step within
    ``BF16_GRAD_FACTOR`` times JAX's median distance to float64."""
    (aux, grads), (jaux, jgrads), (raux, rgrads) = port, jax_bf16, ref
    for key in keys:
        if raux[key] == 0:
            assert aux[key] == 0 == jaux[key], key
            continue
        ours = abs(aux[key] - raux[key]) / abs(raux[key])
        theirs = abs(jaux[key] - raux[key]) / abs(raux[key])
        assert ours <= max(BF16_TERM_FACTOR * theirs, BF16_TERM_FLOOR), (
            key, ours, theirs)
    ours = _grad_distances(grads, rgrads, rgrads)
    theirs = _grad_distances(jgrads, rgrads, rgrads)
    apart = _grad_distances(grads, jgrads, rgrads)
    assert sorted(ours) == sorted(grads)
    med, jmed = np.median(list(ours.values())), np.median(
        list(theirs.values()))
    assert med <= BF16_GRAD_FACTOR * jmed, (med, jmed)
    assert max(ours.values()) <= BF16_GRAD_FACTOR * max(theirs.values()), (
        max(ours.values()), max(theirs.values()))
    assert np.median(list(apart.values())) <= BF16_GRAD_FACTOR * jmed, (
        np.median(list(apart.values())), jmed)


def jax_step_bf16(make_step, model_cls, train_cfg, v, vgg_params, *batch):
    """(aux, gradients) of a JAX train step with compute_dtype "bfloat16"
    (``make_step(model, vgg, cfg)``), as float64 numpy."""
    step = make_step(model_cls(jax_config.ModelConfig(
        compute_dtype="bfloat16")), JaxVGG(), train_cfg)
    state = create_train_state(jax.tree.map(jnp.asarray, v["params"]),
                               jax.tree.map(jnp.asarray, v["batch_stats"]),
                               _grab_gradients())
    new_state, aux = step(state, jax.tree.map(jnp.asarray, vgg_params),
                          *map(jnp.asarray, batch))[:2]
    grads = weights.flatten({"params": jax.tree.map(
        lambda a: np.asarray(a, np.float64), new_state.opt_state),
        "batch_stats": {}})
    return {k: float(a) for k, a in aux.items()}, grads


def port_grads(model, total):
    """{name: gradient} of ``total`` over ``model``'s parameters."""
    names = [f"params/{n.replace('.', '/')}"
             for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(total, list(model.parameters()))
    return {n: g.double().numpy() for n, g in zip(names, grads)}


def test_bf16_train_step_matches_jax():
    """The bf16 step (compute_dtype "bfloat16", the AdaAttN kernels' twins)
    against JAX's bf16 step (dense AdaAttN), both against JAX's float64
    step (``check_bf16_step``)."""
    v, vgg_params, content, style, (ref_aux, ref_grads, _) = _reference()
    ast = AST(ModelConfig(use_pallas_adaattn=True, compute_dtype="bfloat16"))
    weights.load_state(ast, weights.from_jax_tree(v["params"],
                                                  v["batch_stats"]))
    vgg = VGG19Features()
    vgg.load_params(vgg_params)
    total, aux = ast_loss(ast, vgg, ASTTrainConfig(),
                          torch.from_numpy(content), torch.from_numpy(style))
    assert total.dtype == torch.float32 and bool(torch.isfinite(total))
    port = ({k: float(a) for k, a in aux.items()}, port_grads(ast, total))
    jax_bf16 = jax_step_bf16(make_ast_train_step, JaxAST,
                             jax_config.ASTTrainConfig(), v, vgg_params,
                             content, style)
    check_bf16_step(port, jax_bf16, (ref_aux, ref_grads), AUX_KEYS)
