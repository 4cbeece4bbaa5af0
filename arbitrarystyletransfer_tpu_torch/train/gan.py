"""The adversarial step: the twin of ``arbitrarystyletransfer_tpu/train/gan.py``.

  * real samples are the content images, labels smoothed to 1 - 0.2;
  * fake samples are the detached stylized images, labels 0;
  * an R1 gradient penalty on the real batch when ``(step + 1) % R1_EVERY
    == 0``, ``step`` being the discriminator's own step counter.  JAX
    decides that on the device (``lax.cond``); here the caller passes the
    step as a host integer, since the graph differs.

One real forward serves both the BCE term and the penalty, as in JAX, and
the BatchNorm running buffers move through the real forward, then the fake
one.  The generator's pass through the discriminator runs in train mode
with batch statistics, and its running update is undone: JAX discards it.

With a mesh of more than one rank, ``real`` and ``fake`` are this rank's
rows: the discriminator's BatchNorms and dropout masks are the global
batch's (its ``mesh``, set by the trainer), each BCE mean and the R1 mean
enter as this rank's share (``parallel.batch_share``), the gradients are
summed over the ranks and aux holds the global values.  The R1 cadence
mirror is per process and equal on every rank.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..config import ASTTrainConfig
from ..losses import discriminator_loss, r1_penalty
from ..models.mobilenetv2 import Discriminator
from ..parallel.mesh import (
    Mesh,
    all_reduce_grads,
    all_reduce_values,
    batch_share,
    shared,
)
from .state import Adam, deterministic_algorithms, keep_if

R1_EVERY = 8
REAL_LABEL = 1.0 - 0.2


def _no_mark(name: str) -> None:
    del name


def r1_due(step: int) -> bool:
    """Whether the discriminator step ``step`` (counted from 0) takes the
    R1 penalty."""
    return (step + 1) % R1_EVERY == 0


def step_generators(seed: int, step: int, device="cpu"):
    """Three independent generators on ``device`` for the step ``step`` of
    a run seeded ``seed``: the generator's pass through the discriminator,
    the real pass and the fake pass (JAX's ``rng_gen``, ``rng_t``,
    ``rng_f`` of ``fold_in(PRNGKey(seed + 1), step)``).  A function of the
    step alone, so a resumed run continues the stream."""
    seeds = np.random.SeedSequence([seed + 1, step]).generate_state(
        3, dtype=np.uint64)
    return tuple(torch.Generator(device=device).manual_seed(int(s))
                 for s in seeds)


def discriminator_loss_terms(disc: Discriminator, cfg: ASTTrainConfig,
                             real: torch.Tensor, fake: torch.Tensor,
                             gen_t: torch.Generator | None,
                             gen_f: torch.Generator | None, step: int,
                             mark: Callable[[str], None] = _no_mark,
                             mesh: Mesh | None = None):
    """(total, aux) of the discriminator's objective: label-smoothed BCE on
    ``real`` plus BCE-zero on the detached ``fake`` plus R1 when due.  Moves
    ``disc``'s running buffers (real pass, then fake pass).  ``mark`` is
    called after the two forwards ("dis_forward") and, when due, after the
    penalty ("r1").  With a ``mesh``: this rank's share of the objective,
    aux global."""
    share = batch_share(mesh)
    b = real.shape[0]
    due = r1_due(step)
    x = real.detach().requires_grad_(True) if due else real
    pred_real = disc(x, train=True, generator=gen_t)
    true_loss = discriminator_loss(
        pred_real, torch.full((b, 1), REAL_LABEL, dtype=pred_real.dtype,
                              device=real.device))
    pred_fake = disc(fake.detach(), train=True, generator=gen_f)
    fake_loss = discriminator_loss(pred_fake, torch.zeros_like(pred_fake))
    mark("dis_forward")
    if due:
        r1 = r1_penalty(pred_real, x, cfg.r1_lam)
        mark("r1")
    else:
        r1 = torch.zeros((), dtype=pred_real.dtype, device=real.device)
    # Three batch means (the two BCEs, R1's mean over the images): each
    # rank's share.
    true_loss, fake_loss, r1 = (shared(t, share)
                                for t in (true_loss, fake_loss, r1))
    total = true_loss + fake_loss + r1
    aux = {"dis_loss": total, "true_loss": true_loss, "fake_loss": fake_loss,
           "r1_loss": r1}
    return total, all_reduce_values(mesh, {k: v.detach()
                                           for k, v in aux.items()})


@deterministic_algorithms()
def discriminator_step(disc: Discriminator, opt: Adam, cfg: ASTTrainConfig,
                       real, fake, gen_t, gen_f, step: int,
                       mark: Callable[[str], None] = _no_mark,
                       mesh: Mesh | None = None):
    """One update of ``disc`` by ``opt`` (an ``Adam`` over its parameters,
    in order); returns (aux, ok) with "dis_grad_norm" in aux.  A step whose
    gradient norm is not finite changes nothing: the parameters, the
    moments and the running buffers keep their values."""
    buffers = list(disc.buffers())
    before = torch.cat([t.reshape(-1) for t in buffers])
    total, aux = discriminator_loss_terms(disc, cfg, real, fake, gen_t, gen_f,
                                          step, mark, mesh)
    grads = all_reduce_grads(mesh, torch.autograd.grad(total, opt.params))
    mark("dis_backward")
    norm, ok = opt.apply_if_finite(grads)
    keep_if(ok, buffers, before)
    aux["dis_grad_norm"] = norm
    mark("dis_optimizer")
    return aux, ok


def generator_adversarial_loss(disc: Discriminator, stylized: torch.Tensor,
                               generator: torch.Generator | None):
    """The generator's fooling loss BCE(D(stylized), 1): the discriminator
    in train mode, its running buffers left as they were."""
    buffers = list(disc.buffers())
    saved = [t.clone() for t in buffers]
    pred = disc(stylized, train=True, generator=generator)
    with torch.no_grad():
        torch._foreach_copy_(buffers, saved)
    return discriminator_loss(pred, torch.ones_like(pred))
