"""The port's adversarial step against the JAX package's, on the CPU.

The discriminator runs at 64px: its stride is 32, and at 32px the head map
is 1x1, where the instance norm gives 0 and the output is sigmoid(bias) for
every input, which hides every difference.  Its dropout is 0 where the port
is held to JAX (flax's masks are not torch's bits, and the JAX package's own
fidelity tests run at 0 too); the port's masks are tested for determinism
across a save and a resume.

The yardstick of the gradients is JAX in float64: its explicit float32 casts
are made float64 while it traces (``jnp.float32`` is rebound), as the
port's ``.float()`` casts are for the port's float64 run.  The two float64
runs agree to rounding, which checks every formula; the port's float32 run
is held to them with the fixed limits stated at each check.
"""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arbitrarystyletransfer_tpu import config as jax_config
from arbitrarystyletransfer_tpu import losses as jax_losses
from arbitrarystyletransfer_tpu.models import AST as JaxAST
from arbitrarystyletransfer_tpu.models import VGG19Features as JaxVGG
from arbitrarystyletransfer_tpu.models.mobilenetv2 import (
    Discriminator as JaxDiscriminator,
    MobileNetV2 as JaxMobileNetV2,
)
from arbitrarystyletransfer_tpu.ops import blocks as jax_blocks
from arbitrarystyletransfer_tpu.train import create_train_state
from arbitrarystyletransfer_tpu.train import gan as jax_gan
from arbitrarystyletransfer_tpu.train import make_ast_train_step

from arbitrarystyletransfer_tpu_torch import ModelConfig, losses, weights
from arbitrarystyletransfer_tpu_torch.config import ASTTrainConfig
from arbitrarystyletransfer_tpu_torch.models.mobilenetv2 import (
    Discriminator,
    MobileNetV2,
)
from arbitrarystyletransfer_tpu_torch.models.vgg import init_vgg_params
from arbitrarystyletransfer_tpu_torch.ops import blocks
from arbitrarystyletransfer_tpu_torch.train import gan
from arbitrarystyletransfer_tpu_torch.train.ast_trainer import ASTTrainer
from arbitrarystyletransfer_tpu_torch.train.state import Adam

from test_torch_ops import assert_close, ast_variables
from test_torch_train_step import AUX_KEYS, _grab_gradients, _normalize_head

S, B = 64, 2
DIS_AUX = ("dis_loss", "true_loss", "fake_loss", "r1_loss")


def _images(seed, n=2, b=B, size=S):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, (b, size, size, 3)).astype(np.float32)
            for _ in range(n)]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_disc_vars():
    """The JAX Discriminator's variables (numpy), from its own init."""
    variables = jax.jit(functools.partial(
        JaxDiscriminator(dropout_rate=0.0).init, train=False))(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, S, S, 3)))
    return _np_tree(variables["params"]), _np_tree(variables["batch_stats"])


def _port(module, params, stats):
    weights.load_state(module, weights.from_jax_tree(params, stats))
    return module


def _stats_of(module):
    return {k: v for k, v in weights.flatten(
        weights.module_state(module)).items() if k.startswith("batch_stats/")}


def _flat_stats(stats):
    return weights.flatten({"params": {}, "batch_stats": _np_tree(stats)})


def _assert_stats_close(ours, ref, rel, what=""):
    """New running statistics against the reference's: each "var" relative
    to its max, each "mean" relative to the larger of its max and the
    momentum (0.1) times the running std (the running mean of zero-centred
    activations is a sum that cancels, known to a fraction of their
    spread, not of itself)."""
    assert ours.keys() == ref.keys()
    for key, r in ref.items():
        r = np.asarray(r, np.float64)
        err = np.abs(np.asarray(ours[key], np.float64) - r).max()
        scale = np.abs(r).max()
        if key.endswith("/mean"):
            var = np.asarray(ref[key[:-len("mean")] + "var"], np.float64)
            scale = max(scale, 0.1 * np.sqrt(var).max())
        bound = rel * max(scale, 1e-6)
        assert err <= bound, (
            f"{what} {key}: max abs err {err:.3g} > {bound:.3g}")


@contextlib.contextmanager
def _jax_float64():
    """JAX with x64 on and ``jnp.float32`` rebound to float64 (for code
    traced inside the block)."""
    f32 = jnp.float32
    with jax.enable_x64(True):
        jnp.float32 = jnp.float64
        try:
            yield lambda tree: jax.tree.map(
                lambda a: jnp.asarray(a, jnp.float64), tree)
        finally:
            jnp.float32 = f32


@contextlib.contextmanager
def _port_float64(monkeypatch):
    """The port's ``.float()`` keeps float64 tensors as they are."""
    to_f32 = torch.Tensor.float
    monkeypatch.setattr(torch.Tensor, "float", lambda t, *a, **k: (
        t if t.dtype == torch.float64 else to_f32(t, *a, **k)))
    try:
        yield
    finally:
        monkeypatch.undo()


# -- the module tree -----------------------------------------------------------


def test_jax_discriminator_loads_into_the_port(jax_disc_vars):
    params, stats = jax_disc_vars
    state = weights.from_jax_tree(params, stats)
    flat = weights.flatten(state)
    n_params = [k for k in flat if k.startswith("params/")]
    # The JAX tree: 154 params leaves, 100 batch_stats leaves, no head_bn
    # (flax never calls it in the discriminator, so it has no variables).
    assert (len(n_params), len(flat) - len(n_params)) == (154, 100)
    assert sum(flat[k].numel() for k in n_params) == 2_222_529
    assert not any("head_bn" in k for k in flat)
    # blocks_0 (expand 1): the depthwise and the projection only.
    assert set(weights.flatten({"params": state["params"]["mobnet"][
        "blocks_0"], "batch_stats": {}})) == {
        "params/Conv_0/kernel", "params/Conv_1/kernel",
        "params/BatchNorm2D_0/scale", "params/BatchNorm2D_0/bias",
        "params/BatchNorm2D_1/scale", "params/BatchNorm2D_1/bias"}
    disc = Discriminator()
    weights.load_state(disc, state)  # no missing or extra key
    back = weights.flatten(weights.module_state(disc))
    assert back.keys() == flat.keys()
    assert all(torch.equal(back[k], flat[k]) for k in flat)

    # The seeded init: the same tree, drawn from the JAX initializers'
    # distributions.
    init = weights.flatten(weights.init_dis_params(
        torch.Generator().manual_seed(2)))
    assert init.keys() == flat.keys()
    for key, value in init.items():
        assert value.shape == flat[key].shape, key
        leaf = key.rsplit("/", 1)[-1]
        if key.endswith("classifier/kernel"):
            assert abs(float(value.std()) - 0.01) < 0.002, key
        elif leaf == "kernel":
            k, _, _, c_out = value.shape
            want = (2.0 / (k * k * c_out)) ** 0.5
            if value.numel() >= 1000:  # std of >= 1000 draws: within 10%
                assert abs(float(value.std()) / want - 1) < 0.1, key
        else:
            fill = 1.0 if leaf in ("scale", "var") else 0.0
            assert bool((value == fill).all()), key
    weights.load_state(Discriminator(), weights.unflatten(init))


# -- forwards ------------------------------------------------------------------


@pytest.mark.parametrize("case", ["discriminator", "classifier", "features"])
def test_forward_matches_jax(case, jax_disc_vars):
    """Train-mode forwards (with their BatchNorm updates) of the
    discriminator and of the plain classifier (head BN, 10 classes), and
    the tapped features in eval mode, at 64px batch 2."""
    (x,) = _images(41, n=1)
    if case == "discriminator":
        params, stats = jax_disc_vars
        jmod, mod = JaxDiscriminator(dropout_rate=0.0), Discriminator(0.0)
        apply = dict(train=True, mutable=["batch_stats"])
        run = lambda m, inp: m(inp, train=True)  # noqa: E731
    else:
        jmod = JaxMobileNetV2(num_classes=10, dropout_rate=0.0)
        mod = MobileNetV2(num_classes=10, dropout_rate=0.0)
        variables = jmod.init(
            {"params": jax.random.PRNGKey(3),
             "dropout": jax.random.PRNGKey(4)},
            jnp.zeros((1, S, S, 3)), method=JaxMobileNetV2.predict_class,
            train=False)
        params = _np_tree(variables["params"])
        # Running statistics away from (0, 1), which eval mode reads.
        rng = np.random.default_rng(5)
        stats = jax.tree.map(lambda a: (rng.uniform(-0.2, 0.2, a.shape)
                                        + (a > 0.5)).astype(np.float32),
                             _np_tree(variables["batch_stats"]))
        if case == "classifier":
            apply = dict(method=JaxMobileNetV2.predict_class, train=True,
                         mutable=["batch_stats"])
            run = lambda m, inp: m.predict_class(inp, train=True)  # noqa
        else:
            layers = (0, 1, 4, 11, 17)
            apply = dict(out_layers=layers, train=False)
            run = lambda m, inp: m(inp, layers, train=False)  # noqa: E731
    out = jmod.apply({"params": params, "batch_stats": stats}, x, **apply)
    ref, new_stats = ((out[0], out[1]["batch_stats"]) if "mutable" in apply
                      else (out, stats))
    _port(mod, params, stats)
    with torch.no_grad():
        got = run(mod, torch.from_numpy(x))
    refs = ref if isinstance(ref, list) else [ref]
    gots = got if isinstance(got, list) else [got]
    assert len(gots) == len(refs)
    for g, r in zip(gots, refs):
        # f32 through up to 17 blocks, each renormalized by its BNs:
        # measured <= 2.0e-5 of the max (the classifier's logits, a sum of
        # 1280 terms that cancels).
        assert_close(g, np.asarray(r), 1e-4, case)
    _assert_stats_close(_stats_of(mod), _flat_stats(new_stats), 2e-5, case)


@pytest.mark.parametrize("c_in,c_out,stride,t", [
    (32, 16, 1, 1), (16, 16, 2, 1), (16, 24, 2, 6), (24, 24, 1, 6)])
def test_inverted_residual_matches_jax(c_in, c_out, stride, t):
    """Both strides, with and without the expand, the residual
    (24 -> 24) included; a 9 x 9 map (odd, so stride 2 meets the zero
    pad's edge)."""
    rng = np.random.default_rng(c_in + c_out + stride + t)
    x = rng.normal(size=(2, 9, 9, c_in)).astype(np.float32)
    jmod = jax_blocks.InvertedResidual(c_in, c_out, stride, t)
    variables = jmod.init(jax.random.PRNGKey(c_in), x)
    params = _np_tree(variables["params"])
    stats = jax.tree.map(
        lambda a: (a + rng.uniform(0, 0.5, a.shape)).astype(np.float32),
        _np_tree(variables["batch_stats"]))
    names = set(params)
    n = 3 if t != 1 else 2
    assert names == {f"{m}_{i}" for m in ("Conv", "BatchNorm2D")
                     for i in range(n)}
    for train in (True, False):
        out = jmod.apply({"params": params, "batch_stats": stats}, x,
                         train=train, mutable=["batch_stats"])
        ref, new_stats = out
        mod_t = _port(blocks.InvertedResidual(c_in, c_out, stride, t),
                      params, stats)
        with torch.no_grad():
            got = mod_t(torch.from_numpy(x), train=train)
        # Three convs and BNs in f32: measured <= 5e-7 of the max.
        assert_close(got, np.asarray(ref), 1e-5, f"train={train}")
        _assert_stats_close(_stats_of(mod_t),
                            _flat_stats(new_stats["batch_stats"]), 1e-5,
                            f"train={train}")


def test_reshape_element_mapping_matches_jax():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 4, 5, 12)).astype(np.float32)
    jmod = jax_blocks.Reshape(num_channels=3)
    params = _np_tree(jmod.init(jax.random.PRNGKey(8), x)["params"])
    ref = np.asarray(jmod.apply({"params": params}, x))
    mod = _port(blocks.Reshape(3), params, {})
    got = mod(torch.from_numpy(x)).detach().numpy()
    assert got.shape == ref.shape == (2, 8, 10, 3)
    # One f32 add, then a permutation: bit for bit.
    np.testing.assert_array_equal(got, ref)
    # Not a pixel shuffle: the raw row-major view of the NCHW tensor.
    nchw = (x + params["pos_enc"]).transpose(0, 3, 1, 2)
    np.testing.assert_array_equal(
        got, nchw.reshape(2, 3, 8, 10).transpose(0, 2, 3, 1))


# -- losses ----------------------------------------------------------------------


@pytest.mark.parametrize("case", ["interior", "clip", "saturated", "r1"])
def test_discriminator_and_r1_losses_match_jax(case):
    """The BCE inside (0, 1), at the clip's lower end (1e-13 -> 1e-12), at
    an output of 1 (the upper clip rounds to 1.0 in f32: log(0) for a
    smoothed label gives inf, and 0 * log(0) for label 1 gives nan, in both
    packages), and the R1 penalty of a small function with its gradient
    (the double backward)."""
    rng = np.random.default_rng(9)
    if case != "r1":
        out = rng.uniform(0.05, 0.95, (6, 1)).astype(np.float32)
        label = rng.choice([0.0, 0.8, 1.0], (6, 1)).astype(np.float32)
        if case == "clip":
            out[:3] = 1e-13
        elif case == "saturated":
            out[:] = 1.0
        ref = np.asarray(jax_losses.discriminator_loss(out, label))
        got = losses.discriminator_loss(torch.from_numpy(out),
                                        torch.from_numpy(label))
        assert got.dtype == torch.float32
        if case == "saturated":
            assert not np.isfinite(ref)
        # Elementwise logs and one mean: within 2 ulps (nan == nan).
        np.testing.assert_allclose(got.numpy(), ref, rtol=3e-7)
        return
    x = rng.uniform(0, 1, (3, 4, 5, 2)).astype(np.float32)
    w = rng.normal(size=(2, 3)).astype(np.float32)

    def jax_r1(w):
        return jax_losses.r1_loss(
            lambda im: jax.nn.sigmoid(jnp.tanh(im @ w).sum(axis=(1, 2, 3))),
            x, 5.0)

    ref, ref_grad = jax.value_and_grad(jax_r1)(w)
    wt = torch.from_numpy(w).requires_grad_(True)
    got = losses.r1_loss(
        lambda im: torch.sigmoid(torch.tanh(im @ wt).sum(dim=(1, 2, 3))),
        torch.from_numpy(x), 5.0)
    (grad,) = torch.autograd.grad(got, wt)
    # Small f32 sums in another order: measured <= 1e-7 relative.
    assert_close(got.detach(), np.asarray(ref), 1e-6, "r1")
    assert_close(grad, np.asarray(ref_grad), 1e-5, "dr1/dw")


# -- the discriminator's objective ------------------------------------------------


def _port_dis_terms(params, stats, real, fake, step, dtype):
    disc = _port(Discriminator(0.0), params, stats).to(dtype)
    total, aux = gan.discriminator_loss_terms(
        disc, ASTTrainConfig(), torch.from_numpy(real).to(dtype),
        torch.from_numpy(fake).to(dtype), None, None, step)
    names = [f"params/{n.replace('.', '/')}" for n, _ in
             disc.named_parameters()]
    grads = torch.autograd.grad(total, list(disc.parameters()))
    return aux, dict(zip(names, grads)), _stats_of(disc)


@pytest.mark.parametrize("step", [6, 7], ids=["plain", "r1"])
def test_discriminator_loss_terms_match_jax(step, jax_disc_vars,
                                            monkeypatch):
    """JAX ``discriminator_loss_terms`` at the discriminator's steps 6
    (plain) and 7 (R1: ``(step + 1) % 8 == 0``): the loss terms, the
    gradients (R1's through the double backward) and the BN buffers after
    the real-then-fake forwards."""
    params, stats = jax_disc_vars
    real, fake = _images(43)
    assert gan.r1_due(step) == (step == 7)
    with _jax_float64() as f64:
        def loss_fn(p):
            return jax_gan.discriminator_loss_terms(
                JaxDiscriminator(dropout_rate=0.0),
                jax_config.ASTTrainConfig(), p, f64(stats), f64(real),
                f64(fake), jax.random.PRNGKey(0), jnp.asarray(step))

        (_, (ref_aux, ref_stats)), ref_grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(f64(params))
        ref_aux = {k: np.float64(ref_aux[k]) for k in DIS_AUX}
        ref_grads = weights.flatten({"params": _np_tree(ref_grads),
                                     "batch_stats": {}})
        ref_stats = _flat_stats(ref_stats)
    assert all(g.dtype == np.float64 for g in ref_grads.values())
    aux, grads, new_stats = _port_dis_terms(params, stats, real, fake, step,
                                            torch.float32)
    with _port_float64(monkeypatch):
        aux64, grads64, stats64 = _port_dis_terms(params, stats, real, fake,
                                                  step, torch.float64)
    assert (float(aux["r1_loss"]) != 0) == (step == 7)
    assert ref_grads.keys() == grads.keys()
    for key in DIS_AUX:
        # float64 both: measured <= 2e-15.
        assert_close(aux64[key], ref_aux[key], 1e-12, key)
        # f32: the BCE terms measured <= 3e-7; R1, the squared input
        # gradient, 3.4e-5.
        assert_close(aux[key], ref_aux[key], 2e-4 if key == "r1_loss"
                     else 1e-5, key)
    largest = max(float(np.abs(g).max()) for g in ref_grads.values())
    for key, ref in ref_grads.items():
        # Relative to the tensor's max, floored at 1e-4 of the largest of
        # all (BN biases followed by another BN have gradients of rounding
        # size).
        scale = max(float(np.abs(ref).max()), 1e-4 * largest)
        rel = scale / max(float(np.abs(ref).max()), 1e-30)
        # float64: measured <= 1e-12 of the scale.
        assert_close(grads64[key].numpy(), ref, 1e-10 * rel, key)
        # f32: measured <= 5.5e-4 of the scale: BatchNorm over batch 2 down
        # to 2 x 2 maps in f32.
        assert_close(grads[key], ref, 2e-3 * rel, key)
    _assert_stats_close(stats64, ref_stats, 1e-12, "float64")
    _assert_stats_close(new_stats, ref_stats, 1e-5, "float32")


# -- the whole step ----------------------------------------------------------------


class _GrabGradients:
    """An optimizer for the trainer that stores the gradients and updates
    nothing (so the step returns them, as ``_grab_gradients`` does in
    JAX)."""

    def __init__(self, opt: Adam):
        self.names, self.params = opt.names, opt.params
        self.grads = None

    def apply_if_finite(self, grads):
        self.grads = dict(zip(self.names, grads))
        g = torch.cat([x.reshape(-1) for x in grads if x is not None])
        norm = torch.linalg.vector_norm(g)
        return norm, torch.isfinite(norm)


def _port_gan_step(tmp_path, v, dis_vars, vgg_params, content, style, step,
                   dtype):
    trainer = ASTTrainer(
        ASTTrainConfig(save_dir=str(tmp_path), ae_model="", batch_size=B,
                       use_dis=True),
        iter(()), ModelConfig(use_pallas_adaattn=True), device="cpu",
        log_fn=lambda *a: None)
    _port(trainer.ast, v["params"], v["batch_stats"])
    _port(trainer.disc, *dis_vars)
    trainer.disc.mobnet.dropout_rate = 0.0
    trainer.vgg.load_params(vgg_params)
    for m in (trainer.ast, trainer.vgg, trainer.disc):
        m.to(dtype)
    trainer._batch = lambda x: torch.as_tensor(x, dtype=dtype)
    trainer.opt = _GrabGradients(trainer.opt)
    trainer.dis_opt = _GrabGradients(trainer.dis_opt)
    trainer.host_dis_step = step
    aux = trainer.train_step(content, style)
    grads = {f"params/{n}": g for n, g in trainer.opt.grads.items()}
    dis_grads = {f"params/{n}": g for n, g in trainer.dis_opt.grads.items()}
    return (trainer, aux, grads, dis_grads, _stats_of(trainer.ast),
            _stats_of(trainer.disc))


def _jax_gan_step_f64(v, dis_vars, vgg_params, content, style, step):
    with _jax_float64() as f64:
        train_step = make_ast_train_step(
            JaxAST(jax_config.ModelConfig()), JaxVGG(),
            jax_config.ASTTrainConfig(),
            disc=JaxDiscriminator(dropout_rate=0.0))
        state = create_train_state(f64(v["params"]), f64(v["batch_stats"]),
                                   _grab_gradients())
        dis_state = create_train_state(
            f64(dis_vars[0]), f64(dis_vars[1]), _grab_gradients()).replace(
                step=jnp.asarray(step, jnp.int32))
        new_state, new_dis, aux = train_step(
            state, dis_state, f64(vgg_params), f64(content), f64(style),
            jax.random.PRNGKey(0))
        aux = {k: np.float64(v) for k, v in aux.items()}

        def flat(tree, collection):
            other = "batch_stats" if collection == "params" else "params"
            return weights.flatten({collection: _np_tree(tree), other: {}})

        return (aux, flat(new_state.opt_state, "params"),
                flat(new_dis.opt_state, "params"),
                flat(new_state.batch_stats, "batch_stats"),
                flat(new_dis.batch_stats, "batch_stats"))


def test_gan_step_matches_jax(tmp_path, jax_disc_vars, monkeypatch):
    """One whole ``--use_dis`` step of ``ASTTrainer`` (the generator with
    its adversarial term, then the discriminator on the pre-step weights,
    here at its step 7, an R1 step) against JAX ``make_ast_train_step(...,
    disc=Discriminator(dropout_rate=0.0))``: the full-width ModelConfig,
    64px, batch 2.  Both optimizers store the gradients and update
    nothing."""
    step = 7
    v = ast_variables(seed=51, proj_gain=1.0)
    vgg_params = init_vgg_params(generator=torch.Generator().manual_seed(52))
    content, style = _images(53)
    from arbitrarystyletransfer_tpu_torch.models.ast import AST

    ast = _port(AST(ModelConfig()), v["params"], v["batch_stats"])
    _normalize_head(v, ast, content, style)

    ref_aux, ref_g, ref_dg, ref_stats, ref_dstats = _jax_gan_step_f64(
        v, jax_disc_vars, vgg_params, content, style, step)
    assert bool(ref_aux["finite"])
    out32 = _port_gan_step(tmp_path / "f32", v, jax_disc_vars, vgg_params,
                           content, style, step, torch.float32)
    with _port_float64(monkeypatch):
        out64 = _port_gan_step(tmp_path / "f64", v, jax_disc_vars,
                               vgg_params, content, style, step,
                               torch.float64)
    trainer, aux, grads, dis_grads, stats, dstats = out32
    _, aux64, grads64, dis_grads64, stats64, dstats64 = out64
    assert bool(aux["finite"]) and float(aux["r1_loss"]) != 0
    assert int(trainer.step) == int(trainer.dis_step) == 1
    assert all(g.dtype == torch.float64 for g in grads64.values())

    keys = (*AUX_KEYS, "gen_adv_loss", *DIS_AUX, "grad_norm",
            "dis_grad_norm")
    assert set(keys) <= set(ref_aux) and set(keys) <= set(aux)
    # The gradient norms and R1 (a squared input gradient) carry the
    # gradients' own error; the losses, one forward's.
    through_grads = ("grad_norm", "dis_grad_norm", "r1_loss")
    for key in keys:
        # float64 both: the same sums in another order (measured <= 1.7e-12
        # for the norms, 1e-12 for R1, <= 4e-15 for the losses).
        assert_close(aux64[key], ref_aux[key],
                     1e-10 if key in through_grads else 1e-12, key)
        # f32: ~35 blocks, 6 VGG taps, the discriminator; measured <= 1.1e-3
        # (dis_grad_norm), 5e-4 (r1_loss), 1.1e-4 (grad_norm) and 9e-6
        # for the losses.
        assert_close(aux[key], ref_aux[key],
                     5e-3 if key in through_grads else 2e-5, key)

    for ours, ours64, ref in ((grads, grads64, ref_g),
                              (dis_grads, dis_grads64, ref_dg)):
        assert ours.keys() == ref.keys()
        largest = max(float(np.abs(r).max()) for r in ref.values())
        for name, r in ref.items():
            scale = max(float(np.abs(r).max()), 1e-4 * largest)
            rel = scale / max(float(np.abs(r).max()), 1e-30)
            # float64: measured <= 1e-12 of the scale.
            assert_close(ours64[name].numpy(), r, 1e-10 * rel, name)
            # f32: measured <= 1.25e-3 of the scale (the AdaAttN q and k
            # kernels: their f32 rounding is amplified by (mean / std)^2 of
            # the attention statistics; the discriminator's <= 1.23e-3, its
            # fake batch carrying the generator's f32 error).
            assert_close(ours[name], r, 3e-3 * rel, name)

    for ours, ours64, ref in ((stats, stats64, ref_stats),
                              (dstats, dstats64, ref_dstats)):
        _assert_stats_close(ours64, ref, 1e-11, "float64")
        # The generator's running variances average ~35 blocks'
        # activations in f32: measured <= 5e-5.
        _assert_stats_close(ours, ref, 1e-4, "float32")


# -- the trainer -------------------------------------------------------------------


def _gan_trainer(tmp_path, load=False, **cfg):
    """A ``use_dis`` trainer at 64px batch 2 with the parity weights (so
    that the stylized image, and with it the discriminator's pass, is not a
    constant)."""
    trainer = ASTTrainer(
        ASTTrainConfig(save_dir=str(tmp_path), ae_model="", batch_size=B,
                       use_dis=True, load=load, **cfg),
        iter(()), ModelConfig(use_pallas_adaattn=True), device="cpu",
        log_fn=lambda *a: None)
    if not load:
        v = ast_variables(seed=61)
        _port(trainer.ast, v["params"], v["batch_stats"])
    return trainer


def _dis_snapshot(trainer):
    opt = trainer.dis_opt
    return ([t.clone() for t in trainer.disc.parameters()]
            + [t.clone() for t in trainer.disc.buffers()]
            + [opt.mu.clone(), opt.nu.clone(), opt.count.clone(),
               trainer.dis_step.clone()])


@pytest.mark.parametrize("cause", ["nan_penalty", "nan_fake"])
def test_non_finite_discriminator_step_is_a_no_op(cause, tmp_path,
                                                  monkeypatch):
    """A discriminator step whose gradient norm is not finite keeps its
    parameters, moments, step and BN buffers bit for bit (the NaN fake
    also poisons the buffers in the forward); the generator's step still
    applies, ``finite`` is false and the drain raises."""
    trainer = _gan_trainer(tmp_path)
    if cause == "nan_penalty":
        trainer.cfg = dataclasses.replace(trainer.cfg,
                                          r1_lam=float("nan"))
        trainer.host_dis_step = 7
    else:
        real = trainer.loss_and_grads

        def poisoned(*args, **kwargs):
            total, aux, grads = real(*args, **kwargs)
            aux["fake"] = torch.full_like(aux["fake"], float("nan"))
            return total, aux, grads

        monkeypatch.setattr(trainer, "loss_and_grads", poisoned)
    before = _dis_snapshot(trainer)
    aux = trainer.train_step(*_images(62))
    assert not bool(aux["finite"])
    assert not np.isfinite(float(aux["dis_grad_norm"]))
    assert np.isfinite(float(aux["grad_norm"])) and int(trainer.step) == 1
    after = _dis_snapshot(trainer)
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    with pytest.raises(FloatingPointError):
        trainer._drain_aux([aux], 1)


def test_dropout_stream_continues_across_save_and_resume(tmp_path):
    """Three steps in one run against two, a save, and the third step of a
    resumed run: the third step is equal bit for bit, dropout masks
    included (the masks depend on the step)."""
    batches = [_images(70 + i) for i in range(3)]
    run = _gan_trainer(tmp_path / "a")
    for content, style in batches[:2]:
        run.train_step(content, style)
    run.save()
    resumed = _gan_trainer(tmp_path / "a", load=True)
    assert (resumed.host_step, resumed.host_dis_step) == (2, 2)
    aux_a = run.train_step(*batches[2])
    aux_b = resumed.train_step(*batches[2])
    for key in ("loss", "gen_adv_loss", "dis_loss", "true_loss",
                "fake_loss", "grad_norm", "dis_grad_norm"):
        assert torch.equal(aux_a[key], aux_b[key]), key
    for mod in ("ast", "disc"):
        a = weights.flatten(weights.module_state(getattr(run, mod)))
        b = weights.flatten(weights.module_state(getattr(resumed, mod)))
        assert all(torch.equal(a[k], b[k]) for k in a), mod

    # The masks matter: the discriminator's output moves with the step's
    # generators, and each step has its own.
    x = torch.from_numpy(batches[0][0])
    with torch.no_grad():
        outs = [run.disc(x, train=True, generator=gan.step_generators(0, s)[1])
                for s in (2, 2, 3)]
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])
