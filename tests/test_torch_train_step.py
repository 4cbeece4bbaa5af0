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


def test_train_step_matches_jax(monkeypatch):
    v = ast_variables(seed=31, proj_gain=1.0)
    vgg_params = init_vgg_params(generator=torch.Generator().manual_seed(32))
    rng = np.random.default_rng(33)
    content, style = (rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
                      for _ in range(2))

    ast = AST(ModelConfig())
    weights.load_state(ast, weights.from_jax_tree(v["params"],
                                                  v["batch_stats"]))
    _normalize_head(v, ast, content, style)
    ref_aux, ref_grads, ref_stats = _jax_step_f64(v, vgg_params, content,
                                                  style)
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
