"""Post-training BatchNorm recalibration: the twin of
``arbitrarystyletransfer_tpu/train/recalibrate.py``.

Training defaults to ``ModelConfig.encoder_eval_stats=False`` (the encoder
normalizes with batch statistics), so a checkpoint's BN running averages are
whatever the momentum-0.1 EMA landed on, never validated, and the fused
engine, which folds running statistics into the convs, refuses it
(``infer.StylePipeline``).  Recalibration rebuilds the encoder's running
statistics from real batches: the encoder runs in train mode (batch
statistics normalize, so every layer sees the activations of the
batch-statistics graph), and each BN site's running mean and variance
become the average over the batches of that batch's mean and unbiased
variance, then the variance is floored.

JAX recovers the batch moments by inverting one EMA update.  Here a
throwaway copy of the encoder runs its BatchNorms at momentum 1, so that
after each forward their buffers hold that batch's moments exactly: the
result does not depend on the running statistics the checkpoint carries,
and the caller's modules and buffers are never touched.

Recalibration cannot make every checkpoint eval-stable: the residual
between eval-stats and batch-stats normalization propagates through the
eval graph linearly, and on a BN chain with gain > 1 it compounds whatever
the statistics.  ``eval_stats_drift`` measures it; ``infer.StylePipeline.
from_checkpoint`` refuses or warns on it against ``EVAL_DRIFT_SAFE``.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from .. import weights
from ..config import ModelConfig
from ..models.encoder import Encoder
from ..ops.norm import BatchNorm2D

# A checkpoint whose eval-stats encoding drifts more than this (relative
# Frobenius distance at the deepest tap, ``eval_stats_drift``) from its
# batch-stats encoding is not eval-stable: the folded fused engine would not
# reproduce the graph it was trained and validated with.  The JAX package's
# constant (its measured boundary of interchangeable graphs).
EVAL_DRIFT_SAFE = 0.1


def _encoder(enc_params, enc_stats, cfg: ModelConfig):
    """(a fresh encoder holding copies of ``enc_params`` and ``enc_stats``,
    the parameters' device)."""
    device = enc_params["mob_net_0"]["Conv_0"]["kernel"].device
    enc = Encoder(cfg).to(device)
    weights.load_state(enc, {"params": enc_params, "batch_stats": enc_stats})
    return enc, device


def _floor_variances(stats_tree, rel_floor: float):
    """Each BN site's variances clamped to ``rel_floor`` times the site's
    channel-mean variance.

    Eval-stats normalization multiplies a channel by rsqrt(var + eps), up
    to ~316x where a dead channel's variance collapses toward zero, and
    that gain compounds across the encoder's BN layers.  A dead channel
    carries no information, so bounding its gain costs nothing."""
    def clamp(tree):
        return {k: clamp(v) if isinstance(v, dict) else (
            torch.maximum(v, rel_floor * v.mean()) if k == "var" else v)
            for k, v in tree.items()}

    return clamp(stats_tree)


@torch.no_grad()
def recalibrate_encoder_stats(enc_params, enc_stats,
                              batches: Iterable[np.ndarray],
                              cfg: ModelConfig = ModelConfig(),
                              var_floor_rel: float = 1e-3):
    """The encoder's BN running statistics rebuilt from data batches: for
    each site, the mean over the batches of the batch mean and of the
    unbiased batch variance, then ``_floor_variances`` (0 disables it).

    ``enc_params`` / ``enc_stats`` are the ``params["enc"]`` /
    ``batch_stats["enc"]`` subtrees of a state; ``enc_stats`` only gives the
    tree's shape.  ``batches`` are NHWC images in [0, 1], content and style
    alike (the encoder serves both); ~16 or more for serving.  Returns a new
    ``batch_stats["enc"]`` tree on the parameters' device."""
    enc, device = _encoder(enc_params, enc_stats, cfg)
    for m in enc.modules():
        if isinstance(m, BatchNorm2D):
            # new = 0 * old + batch: the batch's moments, whatever (finite)
            # value the buffer held; reset, so that a non-finite one too.
            m.momentum = 1.0
            m.mean.zero_()
            m.var.fill_(1.0)
    sums, n = {}, 0
    for x in batches:
        enc(torch.as_tensor(x, dtype=torch.float32, device=device),
            auto_enc=True, train=True)
        for key, t in weights.flatten(weights.module_state(enc)).items():
            if key.startswith("batch_stats/"):
                sums[key] = sums[key] + t if key in sums else t.clone()
        n += 1
    if n == 0:
        raise ValueError("recalibration needs at least one batch")
    mean_tree = weights.unflatten({k: v / n for k, v in sums.items()})[
        "batch_stats"]
    if var_floor_rel:
        mean_tree = _floor_variances(mean_tree, var_floor_rel)
    return mean_tree


@torch.no_grad()
def eval_stats_drift(enc_params, enc_stats, batches: Iterable[np.ndarray],
                     cfg: ModelConfig = ModelConfig()) -> float:
    """How far the eval-stats encoder drifts from the batch-stats encoder:
    the mean over ``batches`` of ||taps_eval - taps_batch||_F /
    ||taps_batch||_F at the deepest tap.  ``EVAL_DRIFT_SAFE`` or below: the
    folded engine is a faithful drop-in; far above it (or not finite): the
    BN chain amplifies the eval/batch residual.  Pass batches held out from
    the recalibration set for an unbiased reading."""
    enc, device = _encoder(enc_params, enc_stats, cfg)
    taps = (cfg.enc_out_layers[-1],)
    vals = []
    for x in batches:
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
        e = enc(x, out_layers=taps, train=False, use_batch_stats=False)[0]
        b = enc(x, out_layers=taps, train=False, use_batch_stats=True)[0]
        num = torch.linalg.vector_norm((e - b).float())
        den = torch.linalg.vector_norm(b.float())
        vals.append(float(num / (den + 1e-12)))
    if not vals:
        raise ValueError("drift check needs at least one batch")
    return float(np.mean(vals))


def recalibrate_variables(variables: dict, batches: Iterable[np.ndarray],
                          cfg: ModelConfig = ModelConfig()) -> dict:
    """A copy of ``variables`` ({"params", "batch_stats"}) with
    ``batch_stats["enc"]`` recalibrated from ``batches``."""
    new_stats = dict(variables["batch_stats"])
    new_stats["enc"] = recalibrate_encoder_stats(
        variables["params"]["enc"], variables["batch_stats"]["enc"],
        batches, cfg)
    out = dict(variables)
    out["batch_stats"] = new_stats
    return out
