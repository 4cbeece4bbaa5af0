"""The Stage-1 autoencoder of the port against the JAX package: the model
(``models/autoencoder.AutoEncoder``), its seeded tree, one whole train step
against ``make_ae_train_step``, the trainer (checkpoints, the finite guard,
the loop's cadence, validation and the latent utilities) and the
content-only data path.

Full-width ``ModelConfig``, 32px, batch 2, float32 on the CPU; the same
numpy variables (``fill_variables``: fan-in weights, SE gates open) and
the same seeded random VGG go to both.  The step's yardstick is the JAX
step in float64, as in ``test_torch_train_step.py``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from arbitrarystyletransfer_tpu import config as jax_config
from arbitrarystyletransfer_tpu.data import pipeline as jax_pipeline
from arbitrarystyletransfer_tpu.models import VGG19Features as JaxVGG
from arbitrarystyletransfer_tpu.models.autoencoder import (
    AutoEncoder as JaxAE,
)
from arbitrarystyletransfer_tpu.train import create_train_state
from arbitrarystyletransfer_tpu.train import make_ae_train_step

from arbitrarystyletransfer_tpu_torch import ModelConfig, weights
from arbitrarystyletransfer_tpu_torch.config import AETrainConfig
from arbitrarystyletransfer_tpu_torch.data import pipeline
from arbitrarystyletransfer_tpu_torch.models.autoencoder import AutoEncoder
from arbitrarystyletransfer_tpu_torch.models.vgg import (
    VGG19Features,
    init_vgg_params,
)
from arbitrarystyletransfer_tpu_torch.train import checkpoint as ckpt
from arbitrarystyletransfer_tpu_torch.train.ae_trainer import (
    AutoencoderTrainer,
    ae_loss,
)

from test_torch_ops import (
    _shape_tree,
    assert_close,
    fill_variables,
)
from test_torch_train_step import (
    _grab_gradients,
    check_bf16_step,
    jax_step_bf16,
    port_grads,
)

AUX_KEYS = ("train_loss", "perp_loss", "loss")


@functools.lru_cache(maxsize=None)
def _ae_shapes():
    d = jnp.zeros((1, 32, 32, 3), jnp.float32)
    return jax.eval_shape(functools.partial(JaxAE(jax_config.ModelConfig())
                                            .init, train=False),
                          jax.random.PRNGKey(0), d)


def ae_variables(seed, proj_gain=5.0):
    """Filled AutoEncoder variables {"params", "batch_stats"} (numpy)."""
    shapes = _ae_shapes()
    return fill_variables({"params": shapes["params"],
                           "batch_stats": shapes["batch_stats"]},
                          np.random.default_rng(seed), proj_gain)


def _port(v, cfg=ModelConfig()):
    ae = AutoEncoder(cfg)
    weights.load_state(ae, weights.from_jax_tree(v["params"],
                                                 v["batch_stats"]))
    return ae


def _images(seed, b=2, size=32):
    return np.random.default_rng(seed).uniform(
        0, 1, (b, size, size, 3)).astype(np.float32)


def test_ae_train_config_copy_matches_jax_config():
    assert (dataclasses.asdict(AETrainConfig())
            == dataclasses.asdict(jax_config.AETrainConfig()))


def test_init_ae_params_has_the_jax_tree():
    state = weights.init_ae_params(ModelConfig(),
                                   torch.Generator().manual_seed(0))
    shapes = _ae_shapes()
    assert _shape_tree(state["params"]) == _shape_tree(dict(shapes["params"]))
    assert (_shape_tree(state["batch_stats"])
            == _shape_tree(dict(shapes["batch_stats"])))
    again = weights.init_ae_params(ModelConfig(),
                                   torch.Generator().manual_seed(0))
    a, b = weights.flatten(state), weights.flatten(again)
    assert all(torch.equal(a[k], b[k]) for k in a)
    # The AST's init draws the same encoder.
    ast = weights.flatten(weights.init_params(
        ModelConfig(), torch.Generator().manual_seed(0)))
    for key, value in a.items():
        if "/encoder/" in key:
            assert torch.equal(value, ast[key.replace("/encoder/", "/enc/")])


@pytest.mark.parametrize("train,eval_stats", [(True, False), (False, False),
                                              (False, True)])
def test_forward_matches_flax(train, eval_stats):
    v = ae_variables(90)
    cfg = ModelConfig(encoder_eval_stats=eval_stats)
    ae = _port(v, cfg)
    x = _images(91)
    with torch.no_grad():
        out = ae(torch.from_numpy(x), train=train)
    model = JaxAE(jax_config.ModelConfig(encoder_eval_stats=eval_stats))
    ref, mutated = model.apply(jax.tree.map(jnp.asarray, v), jnp.asarray(x),
                               train=train, mutable=["batch_stats"])
    # ~30 blocks of convs summed in another order: 1e-4 of max.
    assert_close(out, ref, 1e-4, "reconstruction")
    flat = weights.flatten(weights.module_state(ae))
    ref_stats = weights.flatten(weights.from_jax_tree(
        {}, jax.tree.map(np.asarray, mutated["batch_stats"])))
    orig = weights.flatten(weights.from_jax_tree({}, v["batch_stats"]))
    for key, ref_value in ref_stats.items():
        assert_close(flat[key], ref_value, 1e-5, key)
        # Train mode moves every running statistic; eval mode none.
        assert torch.equal(flat[key], orig[key]) != train


def test_latents_match_flax():
    v = ae_variables(92)
    ae = _port(v)
    x = _images(93)
    model = JaxAE(jax_config.ModelConfig())
    jv = jax.tree.map(jnp.asarray, v)
    with torch.no_grad():
        z = ae.encode_latent(torch.from_numpy(x))
        recon = ae.decode_latent(z)
    ref_z = model.apply(jv, jnp.asarray(x), method=JaxAE.encode_latent)
    ref_recon = model.apply(jv, jnp.asarray(z.numpy()),
                            method=JaxAE.decode_latent)
    assert z.shape == (2, 4, 4, 128)
    assert_close(z, ref_z, 1e-4, "latent")
    assert_close(recon, ref_recon, 1e-4, "decoded latent")


def _port_step(v, vgg_params, x, dtype=torch.float32):
    """(module, aux, gradients) of one port step in ``dtype``."""
    ae = _port(v)
    vgg = VGG19Features()
    vgg.load_params(vgg_params)
    ae.to(dtype)
    vgg.to(dtype)
    total, aux = ae_loss(ae, vgg, AETrainConfig(),
                         torch.from_numpy(x).to(dtype))
    return ae, aux, torch.autograd.grad(total, list(ae.parameters()))


def _jax_step_f64(v, vgg_params, x):
    """(aux, gradients, batch_stats) of the JAX step in float64, as flat
    float64 numpy dicts (``test_torch_train_step._jax_step_f64``)."""
    f32 = jnp.float32
    with jax.enable_x64(True):
        jnp.float32 = jnp.float64
        try:
            step = make_ae_train_step(JaxAE(jax_config.ModelConfig()),
                                      JaxVGG(), jax_config.AETrainConfig())

            def cast(a):
                return jnp.asarray(a, jnp.float64)

            state = create_train_state(jax.tree.map(cast, v["params"]),
                                       jax.tree.map(cast, v["batch_stats"]),
                                       _grab_gradients())
            new_state, aux, _ = step(state, jax.tree.map(cast, vgg_params),
                                     cast(x))
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
    """(variables, VGG params, batch, the JAX float64 step's (aux,
    gradients, batch_stats)): the inputs and the yardstick of the float32
    and the bf16 step tests (computed once)."""
    v = ae_variables(94, proj_gain=1.0)
    vgg_params = init_vgg_params(generator=torch.Generator().manual_seed(95))
    x = _images(96)
    return v, vgg_params, x, _jax_step_f64(v, vgg_params, x)


def test_ae_train_step_matches_jax():
    v, vgg_params, x, (ref_aux, ref_grads, ref_stats) = _reference()
    assert bool(ref_aux["finite"])

    ae, aux, grads = _port_step(v, vgg_params, x)
    # The model's float32 casts keep a float64 tensor in float64.
    ae64, aux64, grads64 = _port_step(v, vgg_params, x, torch.float64)
    assert all(g.dtype == torch.float64 for g in grads64)
    assert all(a.dtype == torch.float64 for a in aux64.values())

    names = [f"params/{n.replace('.', '/')}" for n, _ in
             ae.named_parameters()]
    assert sorted(ref_grads) == sorted(names)
    largest = max(float(np.abs(r).max()) for r in ref_grads.values())
    for key in AUX_KEYS:
        assert_close(aux64[key], ref_aux[key], 1e-12, key)
        assert_close(aux[key], ref_aux[key], 1e-5, key)
    for name, g, g64 in zip(names, grads, grads64):
        ref = ref_grads[name]
        # Relative to the tensor's largest gradient, floored at 1e-4 of the
        # largest of all (test_torch_train_step.py's limits).
        scale = max(float(np.abs(ref).max()), 1e-4 * largest)
        rel = scale / max(float(np.abs(ref).max()), 1e-30)
        assert_close(g64.numpy(), ref, 1e-10 * rel, name)
        assert_close(g, ref, 5e-4 * rel, name)
    flat = weights.flatten(weights.module_state(ae))
    flat64 = weights.flatten(weights.module_state(ae64))
    assert sorted(ref_stats) == sorted(k for k in flat
                                       if k.startswith("batch_stats/"))
    for key, ref in ref_stats.items():
        assert_close(flat64[key].numpy(), ref, 1e-11, key)
        assert_close(flat[key], ref, 1e-4, key)


def test_bf16_ae_train_step_matches_jax():
    """The bf16 step (compute_dtype "bfloat16") against JAX's bf16 step,
    both against JAX's float64 step (``check_bf16_step``)."""
    v, vgg_params, x, (ref_aux, ref_grads, _) = _reference()
    ae = _port(v, ModelConfig(compute_dtype="bfloat16"))
    vgg = VGG19Features()
    vgg.load_params(vgg_params)
    total, aux = ae_loss(ae, vgg, AETrainConfig(), torch.from_numpy(x))
    assert total.dtype == torch.float32 and bool(torch.isfinite(total))
    port = ({k: float(a) for k, a in aux.items()}, port_grads(ae, total))
    jax_bf16 = jax_step_bf16(make_ae_train_step, JaxAE,
                             jax_config.AETrainConfig(), v, vgg_params, x)
    check_bf16_step(port, jax_bf16, (ref_aux, ref_grads), AUX_KEYS)


# -- the trainer -------------------------------------------------------------


def _batches(seed, b=2, size=32):
    rng = np.random.default_rng(seed)
    while True:
        yield rng.uniform(0, 1, (b, size, size, 3)).astype(np.float32)


def _trainer(tmp_path, seed=0, val=False, **cfg):
    cfg = AETrainConfig(save_dir=str(tmp_path / "ae"), batch_size=2, **cfg)
    return AutoencoderTrainer(cfg, _batches(seed),
                              _batches(seed + 100) if val else None,
                              seed=seed, device="cpu",
                              log_fn=lambda *a: None)


def test_trainer_round_trip(tmp_path):
    """Save and load keep the model, the optimizer state, the step and the
    history."""
    trainer = _trainer(tmp_path, seed=97, val=True, save_every=2,
                       validate_every=2)
    trainer.train(num_iters=3, log_fn=lambda *a: None)
    history = ckpt.load_history(trainer.train_dict_file)
    assert len(history["train_loss"]) == len(history["perp_loss"]) == 3
    assert len(history["val_loss"]) == 1  # validated at iter 2 only
    assert np.isfinite(history["train_loss"]).all()

    resumed = _trainer(tmp_path, seed=98, load=True)
    saved = weights.flatten(weights.module_state(trainer.model))
    loaded = weights.flatten(weights.module_state(resumed.model))
    assert saved.keys() == loaded.keys()
    assert all(torch.equal(saved[k], loaded[k]) for k in saved)
    for key in ("mu", "nu", "count"):
        assert torch.equal(getattr(trainer.opt, key),
                           getattr(resumed.opt, key))
    assert int(resumed.step) == 3 and resumed.train_dict == history
    tree = ckpt.restore_checkpoint(trainer.save_file)
    assert sorted(tree["params"]) == ["ada_out", "decoder", "encoder"]
    assert sorted(tree["batch_stats"]) == ["encoder"]


def test_non_finite_step_changes_nothing(tmp_path):
    trainer = _trainer(tmp_path, seed=99)
    before = {k: v.clone() for k, v in weights.flatten(
        weights.module_state(trainer.model)).items()}
    mu = trainer.opt.mu.clone()
    batch = next(_batches(99))
    batch[0, 0, 0, 0] = np.nan
    aux = trainer.train_step(batch)
    assert not bool(aux["finite"])
    after = weights.flatten(weights.module_state(trainer.model))
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert torch.equal(trainer.opt.mu, mu) and int(trainer.step) == 0
    with pytest.raises(FloatingPointError, match="update was skipped"):
        trainer._drain_aux([aux], first_iter=1)
    aux = trainer.train_step(next(_batches(100)))
    assert bool(aux["finite"]) and int(trainer.step) == 1


def test_validate_and_latent_utilities_match_flax(tmp_path):
    trainer = _trainer(tmp_path, seed=101, val=True)
    v = ae_variables(102)
    weights.load_state(trainer.model, weights.from_jax_tree(
        v["params"], v["batch_stats"]))
    model = JaxAE(jax_config.ModelConfig())
    jv = jax.tree.map(jnp.asarray, v)

    x = next(_batches(201))  # the validation loader's first batch
    ref_l1 = float(jnp.mean(jnp.abs(x - model.apply(jv, jnp.asarray(x),
                                                      train=False))))
    assert_close(trainer.validate(), ref_l1, 1e-4, "val L1")
    assert_close(trainer.train_dict["val_loss"][-1], ref_l1 / 2, 1e-4,
                 "val_loss")

    a, b = _images(103), _images(104)
    got = trainer.interpolate(a, b, 0.3)
    z1, z2 = (model.apply(jv, jnp.asarray(i), method=JaxAE.encode_latent)
              for i in (a, b))
    ref = model.apply(jv, 0.3 * z1 + 0.7 * z2, method=JaxAE.decode_latent)
    assert_close(got, ref, 1e-4, "interpolation")

    gen = _batches(101)  # the trainer's content batches
    zs = [model.apply(jv, jnp.asarray(next(gen)),
                      method=JaxAE.encode_latent) for _ in range(3)]
    ref = jnp.sum(sum(jnp.sum(z, axis=0) for z in zs) / (2 * 3), axis=0)
    assert_close(trainer.get_distr(num_samples=3), ref, 1e-4, "mean latent")


# -- the content-only data path ----------------------------------------------


def _write_images(root, n=5):
    rng = np.random.default_rng(105)
    root.mkdir(parents=True)
    for i in range(n):
        h, w = rng.integers(40, 70, 2)
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                        ).save(root / f"img_{i}.png")
    return [str(root)]


@pytest.mark.parametrize("augment", [True, False])
@pytest.mark.parametrize("worker_mode", ["thread", "process"])
def test_content_batches_match_jax(tmp_path, augment, worker_mode):
    dirs = _write_images(tmp_path / "content")
    loaders = [mod.ContentBatchLoader(
        mod.FlatFolderDatasetAE(dirs, seed=106), batch_size=3, imsize=24,
        num_workers=1, seed=106, augment=augment, worker_mode=worker_mode)
        for mod in (pipeline, jax_pipeline)]
    try:
        for _ in range(3):
            x, ref = (next(loader) for loader in loaders)
            assert x.dtype == np.float32 and x.shape == (3, 24, 24, 3)
            np.testing.assert_array_equal(x, ref)
    finally:
        for loader in loaders:
            loader.close()


def test_content_dataset_refuses_an_empty_folder(tmp_path):
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="empty"):
        pipeline.FlatFolderDatasetAE([str(tmp_path / "empty")])


def test_close_stops_the_thread_workers(tmp_path):
    """After ``close`` no worker thread is left: one still drawing when
    its folder is removed would retry the missing files forever, at full
    speed (it held a core of every later test and phase)."""
    dirs = _write_images(tmp_path / "content", n=3)
    loader = pipeline.ContentBatchLoader(
        pipeline.FlatFolderDatasetAE(dirs), batch_size=2, imsize=32,
        num_workers=2, worker_mode="thread")
    next(loader)
    threads = list(loader._threads)
    assert len(threads) == 2 and all(t.is_alive() for t in threads)
    loader.close()
    assert not any(t.is_alive() for t in threads)
