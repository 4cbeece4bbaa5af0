"""The port's losses and loss statistics against the JAX package's, as
values and as gradients.

Inputs come from a seeded numpy generator; float32 on the CPU.  Each case
is a loss of one or two NHWC tensors; the gradient is taken with respect
to the first, as the trainer differentiates through the stylized image.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arbitrarystyletransfer_tpu import losses as jl
from arbitrarystyletransfer_tpu.ops import stats as js

from arbitrarystyletransfer_tpu_torch import losses as pl
from arbitrarystyletransfer_tpu_torch.ops import stats as ps

from test_torch_ops import assert_close


def _sum_stats(stats_fn):
    def loss(x, _):
        mean, std = stats_fn(x)
        return (mean * 1.3).sum() + (std * 0.7).sum()
    return loss


# name: (port loss, JAX loss, image-like inputs in [0, 1])
CASES = {
    "huber": (pl.huber_loss, jl.huber_loss, False),
    "gram": (lambda x, _: pl.gram_matrix(x).square().sum(),
             lambda x, _: jnp.sum(jnp.square(jl.gram_matrix(x))), False),
    "style": (pl.compute_style_loss, jl.compute_style_loss, False),
    "tv": (lambda x, _: pl.tv_loss(x), lambda x, _: jl.tv_loss(x), True),
    "soft_histogram": (
        lambda x, _: (pl.soft_histogram(x) * torch.linspace(0, 1, 256)).sum(),
        lambda x, _: jnp.sum(jl.soft_histogram(x) * jnp.linspace(0, 1, 256)),
        True),
    "emd": (lambda x, y: pl.earth_movers_distance(
                pl.soft_histogram(x), pl.soft_histogram(y)).sum(),
            lambda x, y: jnp.sum(jl.earth_movers_distance(
                jl.soft_histogram(x), jl.soft_histogram(y))), True),
    "hist": (pl.compute_hist_loss, jl.compute_hist_loss, True),
    "channel_stats": (_sum_stats(ps.channel_stats),
                      _sum_stats(js.channel_stats), False),
    "calc_mean_std": (_sum_stats(ps.calc_mean_std),
                      _sum_stats(js.calc_mean_std), False),
    "mean_variance_norm": (
        lambda x, y: pl.huber_loss(ps.mean_variance_norm(x),
                                   ps.mean_variance_norm(y)),
        lambda x, y: jl.huber_loss(js.mean_variance_norm(x),
                                   js.mean_variance_norm(y)), False),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_value_and_gradient_match_jax(name):
    port_fn, jax_fn, image = CASES[name]
    rng = np.random.default_rng(len(name))
    shape = (2, 9, 7, 5)
    if image:
        x, y = (rng.uniform(0, 1, shape).astype(np.float32) for _ in "xy")
    else:
        x, y = (rng.normal(0.2, 1.5, shape).astype(np.float32) for _ in "xy")
    tx = torch.from_numpy(x).requires_grad_()
    value = port_fn(tx, torch.from_numpy(y))
    (grad,) = torch.autograd.grad(value, tx)
    ref, ref_grad = jax.value_and_grad(jax_fn)(jnp.asarray(x), jnp.asarray(y))
    # Reductions in another order: 1e-5 of the value, 1e-5 of max |grad|.
    assert_close(value.detach(), ref, 1e-5, f"{name} value")
    assert_close(grad, ref_grad, 1e-5, f"{name} grad")


def test_stats_eps_quirks():
    """channel_stats: unbiased std, no eps; calc_mean_std: sqrt(unbiased
    var + 1e-5); a constant map gives 0 and sqrt(1e-5)."""
    x = torch.full((1, 4, 4, 2), 3.0)
    _, std = ps.channel_stats(x)
    _, std_eps = ps.calc_mean_std(x)
    assert float(std.abs().max()) == 0.0
    assert torch.allclose(std_eps, torch.tensor(1e-5).sqrt())
    x = torch.arange(32.0).reshape(1, 4, 4, 2)
    _, std = ps.channel_stats(x)
    assert torch.allclose(std.flatten(), x.reshape(16, 2).std(dim=0))
