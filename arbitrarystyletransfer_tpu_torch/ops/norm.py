"""BatchNorm with the statistics source and the running update decoupled:
the twin of ``arbitrarystyletransfer_tpu/ops/norm.py``.

``use_batch_stats`` picks the normalizer (batch statistics or the running
buffers); ``update_stats`` says whether the running buffers move.  The AST
training step needs them apart: its detached encode normalizes with batch
statistics (or the running ones, ``encoder_eval_stats``) and updates
nothing, while the identity encode and the re-encode update.  As in torch,
the biased variance normalizes and the unbiased one feeds the running
average, with momentum 0.1 in torch's convention and eps 1e-5.

On a mesh of more than one rank (``mesh``, set by the trainer or the
pipeline through ``parallel.set_mesh``) the batch statistics are the global
batch's, as under JAX's GSPMD: mean = sum over the ranks of sum(x) / N and
var = sum over the ranks of sum((x - mean)^2) / N, two passes as
``jnp.var`` takes them, N the global count (the ranks hold equal shards).
Without one the module runs the one-device code and issues no collective.
"""

from __future__ import annotations

import torch
from torch import nn

from ..parallel.mesh import all_reduce_sum, is_sharded
from .stats import at_least_f32


class BatchNorm2D(nn.Module):
    """BatchNorm over an NHWC tensor; parameters ``scale``, ``bias`` and
    buffers ``mean``, ``var`` as in the JAX ``batch_stats`` tree."""

    mesh = None  # a parallel.Mesh: the statistics over its ranks

    def __init__(self, channels: int, momentum: float = 0.1,
                 epsilon: float = 1e-5):
        super().__init__()
        self.momentum, self.epsilon = momentum, epsilon
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor, use_batch_stats: bool,
                update_stats: bool) -> torch.Tensor:
        in_dtype = x.dtype
        x = at_least_f32(x)  # statistics and normalization in f32
        if use_batch_stats and is_sharded(self.mesh):
            n = x.shape[0] * x.shape[1] * x.shape[2] * self.mesh.size
            mean = all_reduce_sum(x.sum(dim=(0, 1, 2)), self.mesh) / n
            var = all_reduce_sum((x - mean).square().sum(dim=(0, 1, 2)),
                                 self.mesh) / n  # biased
        elif use_batch_stats:
            n = x.shape[0] * x.shape[1] * x.shape[2]
            mean = x.mean(dim=(0, 1, 2))
            var = (x - mean).square().mean(dim=(0, 1, 2))  # biased
        if use_batch_stats:
            if update_stats:
                m = self.momentum
                with torch.no_grad():
                    unbiased = var * (n / max(n - 1, 1))
                    self.mean.copy_((1 - m) * self.mean + m * mean)
                    self.var.copy_((1 - m) * self.var + m * unbiased)
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + self.epsilon)
        return ((x - mean) * inv * self.scale + self.bias).to(in_dtype)
