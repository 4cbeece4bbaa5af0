"""Data-parallel GAN and autoencoder steps of the port on the CPU (2 gloo
ranks, spawned by ``run_ranks``): the ``--use_dis`` step against one
process, the autoencoder step against one process and against JAX's
``make_ae_train_step`` over a 2-device mesh, and its validation, at
``test_torch_parallel_train.py``'s limits (the running means relative to
their spread, as ``test_torch_gan.py`` holds them).
"""

import torch

from arbitrarystyletransfer_tpu import config as jax_config
from arbitrarystyletransfer_tpu.models import VGG19Features as JaxVGG
from arbitrarystyletransfer_tpu.models.autoencoder import AutoEncoder as JaxAE
from arbitrarystyletransfer_tpu.train import make_ae_train_step

from arbitrarystyletransfer_tpu_torch import ModelConfig, weights
from arbitrarystyletransfer_tpu_torch.models.ast import AST
from arbitrarystyletransfer_tpu_torch.models.vgg import init_vgg_params
from arbitrarystyletransfer_tpu_torch.parallel.launch import run_ranks

import torch_parallel_workers as workers
from test_torch_autoencoder import ae_variables
from test_torch_ops import assert_close, ast_variables
from test_torch_parallel_train import (
    AE_AUX,
    RANKS,
    TIMEOUT,
    _check_against_jax,
    _check_against_one_process,
    _images,
    _jax_f64_step,
)
from test_torch_train_step import AUX_KEYS, _normalize_head


# -- the GAN step --------------------------------------------------------------


def test_gan_step_over_two_ranks_matches_one_process(tmp_path):
    """One ``--use_dis`` step at 64px (global batch 2, the parity weights,
    dropout 0.2, the discriminator's step 7: an R1 step) on 2 ranks
    against one process, in float64: the dropout masks, the losses, both
    models' gradients and states."""
    v = ast_variables(seed=51, proj_gain=1.0)
    vgg_params = init_vgg_params(generator=torch.Generator().manual_seed(52))
    content, style = _images(53, size=64)
    ast = AST(ModelConfig())
    weights.load_state(ast, weights.from_jax_tree(v["params"],
                                                  v["batch_stats"]))
    _normalize_head(v, ast, content, style)
    args = (v, vgg_params, content, style, 7, torch.float64)
    ranks = run_ranks(workers.gan_step_rank, RANKS, str(tmp_path / "dp"),
                      *args, timeout=TIMEOUT)
    one = workers.gan_step_rank(workers.one_rank(), str(tmp_path / "one"),
                                *args)
    for i in range(3):
        assert torch.equal(torch.cat([r["masks"][i] for r in ranks]),
                           one["masks"][i])
    assert float(one["aux"]["r1_loss"]) != 0
    keys = (*AUX_KEYS, "gen_adv_loss", "dis_loss", "true_loss", "fake_loss")
    for r in ranks:
        assert r["steps"] == (1, 1)
        # The gradient norms and R1 (a squared input gradient) carry the
        # gradients' own rounding (test_torch_gan.py's float64 limits).
        for key in ("grad_norm", "dis_grad_norm", "r1_loss"):
            assert_close(r["aux"][key], one["aux"][key], 1e-10, key)
    _check_against_one_process(ranks, one, keys)
    # The discriminator: its gradients, running buffers and parameters.
    dis = [{"aux": r["aux"], "grads": r["dis_grads"],
            "stats": {k: t for k, t in r["dis_state"].items()
                      if k.startswith("batch_stats/")}}
           for r in (*ranks, one)]
    _check_against_one_process(dis[:2], dis[2], (), state="stats")
    # Each parameter after the step relative to the larger of its max and
    # the discriminator's largest parameter (as the gradients are floored):
    # the gradients of the BatchNorm biases that another BatchNorm follows
    # are rounding noise (~1e-14, the shift is normalized away), which
    # Adam's g / (|g| + eps) turns into updates of ~1e-11 that differ with
    # any order of the sums, on zero-initialized biases.  A step of dis_lr
    # (1e-5) missing or wrong is 1e5 times the limit.
    params = {k: t for k, t in one["dis_state"].items()
              if k.startswith("params/")}
    largest = max(float(t.abs().max()) for t in params.values())
    for r in ranks:
        for key, value in params.items():
            own = max(float(value.abs().max()), 1e-6)
            assert_close(r["dis_state"][key], value,
                         1e-10 * max(own, largest) / own, key)
    for key in ranks[0]["dis_state"]:
        assert torch.equal(ranks[0]["dis_state"][key],
                           ranks[1]["dis_state"][key]), key


# -- the autoencoder step ------------------------------------------------------


def test_ae_step_over_two_ranks_matches_jax_and_one_process():
    v = ae_variables(94, proj_gain=1.0)
    vgg_params = init_vgg_params(generator=torch.Generator().manual_seed(95))
    x = _images(96)[0]
    ranks = run_ranks(workers.ae_steps_rank, RANKS, v, vgg_params, x,
                      [torch.float64, torch.float32], timeout=TIMEOUT)
    ref = _jax_f64_step(
        lambda: make_ae_train_step(JaxAE(jax_config.ModelConfig()), JaxVGG(),
                                   jax_config.AETrainConfig()),
        v, vgg_params, (x,))
    assert bool(ref[0]["finite"])
    r64, r32 = [r[0] for r in ranks], [r[1] for r in ranks]
    one32 = workers.ae_step_rank(workers.one_rank(), v, vgg_params, x,
                                 torch.float32)
    _check_against_jax(r64, r32, ref, AE_AUX, one32)
    one = workers.ae_step_rank(workers.one_rank(), v, vgg_params, x,
                               torch.float64)
    _check_against_one_process(r64, one, AE_AUX)


def test_ae_validate_over_two_ranks_takes_the_global_batch(tmp_path):
    """``validate`` on 2 ranks: the L1 of rank 0's whole validation batch
    (batch statistics over both ranks' rows), and the history's entry
    divided by the global batch size, as one process computes them."""
    v = ae_variables(97, proj_gain=1.0)
    x_val = _images(98, b=4)[0]
    ranks = run_ranks(workers.ae_validate_rank, RANKS, str(tmp_path / "dp"),
                      v, x_val, timeout=TIMEOUT)
    one = workers.ae_validate_rank(workers.one_rank(),
                                   str(tmp_path / "one"), v, x_val)
    for l1, history in ranks:
        # f32: the batch statistics and the mean summed in another order.
        assert_close(l1, one[0], 1e-5, "val L1")
        assert_close(history, one[1], 1e-5, "val_loss")
    assert ranks[0] == ranks[1]
