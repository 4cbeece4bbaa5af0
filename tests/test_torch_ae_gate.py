"""The yardstick of ``chip_smoke.py``'s autoencoder gate: how far the
autoencoder's float32 loss lies from float64 for the port and for JAX, on
the lifecycle phase's batches at a small size.

The phase holds its first step's float32 loss against the same loss in
float64.  On the card that distance reached 7.98e-4 on some of the loader's
batches (``scripts/ae_loss_spread.py`` in the port), above the phase's
first limit of 1e-4.  Here the same weights (the parity redraw) and the same
synthetic images through the same loader show the same spread in JAX's
float32 loss, so it is the model's conditioning on these batches (train-mode
BatchNorm over a small batch), not the port: the port lies at most twice as
far as JAX (the worst over 8 batches: 1.05x at 32px batch 2 with JAX's own
float64 loss, ``tests/torch_ae_loss_spread.py``; 1.23x here, 32px batch 4,
1.60e-3 against 1.30e-3).  The phase now holds the loss within twice the
largest distance of the float32 loss over ``dp_orders``' row orders of the
same batch (floored at 1e-4).  Batch by batch JAX's float32 loss lay inside
that limit here (the worst at 0.975 of it); the test holds the two scales,
the worst over the batches, which thread counts move less.

The float64 yardstick is the port's float64 loss: it equals JAX's to
~1e-12 (the script prints both; ``test_torch_autoencoder``'s float64 step
holds them to 1e-12), and JAX's float64 loss takes minutes on the CPU.
"""

import functools
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke as c
from arbitrarystyletransfer_tpu import config as jax_config
from arbitrarystyletransfer_tpu.losses import huber_loss
from arbitrarystyletransfer_tpu.models import VGG19Features as JaxVGG
from arbitrarystyletransfer_tpu.models.autoencoder import AutoEncoder as JaxAE

from arbitrarystyletransfer_tpu_torch import ModelConfig, weights
from arbitrarystyletransfer_tpu_torch.config import AETrainConfig
from arbitrarystyletransfer_tpu_torch.data.pipeline import (
    ContentBatchLoader,
    FlatFolderDatasetAE,
)
from arbitrarystyletransfer_tpu_torch.models.autoencoder import AutoEncoder
from arbitrarystyletransfer_tpu_torch.models.vgg import (
    VGG19Features,
    init_vgg_params,
)
from arbitrarystyletransfer_tpu_torch.train.ae_trainer import ae_loss

VGG_SEED = 1  # the trainers' random VGG (``ast_trainer.load_vgg``)


def lifecycle_batches(n, size, batch):
    """The first ``n`` batches of the lifecycle phase's content loader over
    its synthetic PNGs (one thread, the seed's file order), at ``size`` px
    and ``batch`` images, as float32 numpy."""
    with tempfile.TemporaryDirectory() as tmp:
        dirs = c.write_images(tmp, c.SEED + 13)
        loader = ContentBatchLoader(
            c.seeded_order(FlatFolderDatasetAE(dirs), c.SEED),
            batch_size=batch, imsize=size, num_workers=c.LIFE_WORKERS,
            seed=c.SEED, augment=False, worker_mode="thread")
        try:
            return [np.asarray(next(loader), np.float32) for _ in range(n)]
        finally:
            loader.close()


def phase_weights():
    """(the phase's autoencoder state, its JAX variables, the VGG params)."""
    state = c.ae_state(c.random_state(ModelConfig(), c.SEED))
    variables = jax.tree.map(lambda t: t.numpy(), state)
    vgg_params = init_vgg_params(ModelConfig().vgg_content_layers,
                                 torch.Generator().manual_seed(VGG_SEED))
    return state, variables, vgg_params


@functools.lru_cache(maxsize=None)
def _jax_loss_fn():
    """The JAX AE step's loss (``make_ae_train_step``'s ``loss_fn``) of
    each of a stack of batches, jitted once (``lax.map``)."""
    tcfg = jax_config.AETrainConfig()
    ae, vgg = JaxAE(jax_config.ModelConfig()), JaxVGG()

    def loss(v, vp, x):
        recon, _ = ae.apply(v, x, train=True, mutable=["batch_stats"])
        taps = vgg.apply({"params": vp}, jnp.concatenate([x, recon], 0))
        b = x.shape[0]
        perp = sum(huber_loss(t[b:], t[:b]) for t in taps)
        return (tcfg.recon_lam * huber_loss(recon, x)
                + tcfg.perp_lam * perp)

    return jax.jit(lambda v, vp, xs: jax.lax.map(
        lambda x: loss(v, vp, x), xs))


def jax_losses(variables, vgg_params, batches, f64=False):
    """The JAX loss of each batch in float32 or, with ``f64``, in float64
    (``jnp.float32`` rebound while it traces)."""
    fn = _jax_loss_fn()
    xs = np.stack(batches)
    if not f64:
        return [float(v) for v in fn(variables, vgg_params, xs)]
    f32 = jnp.float32
    with jax.enable_x64(True):
        jnp.float32 = jnp.float64
        try:
            def cast(a):
                return jnp.asarray(a, jnp.float64)

            out = fn(jax.tree.map(cast, variables),
                     jax.tree.map(cast, vgg_params), cast(xs))
            return [float(v) for v in out]
        finally:
            jnp.float32 = f32


def port_loss(state, vgg_params, batch, dtype, rows=None):
    """The port's loss of one train-mode forward in ``dtype`` over the
    batch's ``rows`` in that order (default: as they are)."""
    if rows is not None:
        batch = batch[list(rows)]
    model = AutoEncoder(ModelConfig())
    weights.load_state(model, state)
    vgg = VGG19Features()
    vgg.load_params(vgg_params)
    model.to(dtype)
    vgg.to(dtype)
    with torch.no_grad():
        total, _ = ae_loss(model, vgg, AETrainConfig(),
                           torch.from_numpy(batch).to(dtype))
    return float(total)


def order_spread(state, vgg_params, batch, loss64):
    """The largest relative distance to ``loss64`` of the port's float32
    loss over ``dp_orders``' row orders of ``batch`` (none the identity)."""
    orders = c.dp_orders(len(batch))
    assert list(range(len(batch))) not in [list(o) for o in orders]
    return max(abs(port_loss(state, vgg_params, batch, torch.float32, rows)
                   - loss64) / abs(loss64) for rows in orders)


def test_ae_loss_f32_distance_matches_jax():
    batches = lifecycle_batches(8, 32, 4)
    state, variables, vgg_params = phase_weights()
    ours, theirs, spread = [], [], []
    for x, j32 in zip(batches, jax_losses(variables, vgg_params, batches)):
        p32, p64 = (port_loss(state, vgg_params, x, dt)
                    for dt in (torch.float32, torch.float64))
        ours.append(abs(p32 - p64) / abs(p64))
        theirs.append(abs(j32 - p64) / abs(p64))
        spread.append(order_spread(state, vgg_params, x, p64))
    # Not a fault of the port: it lies at most twice as far as JAX.
    assert max(ours) <= 2 * max(theirs), (ours, theirs)
    # The phase's limit is on JAX's scale (measured 0.38 of it).
    assert max(theirs) <= c.AE_ORDER_FACTOR * max(spread), (theirs, spread)
