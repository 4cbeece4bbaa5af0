"""BatchNorm with the statistics source and the running update decoupled:
the twin of ``arbitrarystyletransfer_tpu/ops/norm.py``.

``use_batch_stats`` picks the normalizer (batch statistics or the running
buffers); ``update_stats`` says whether the running buffers move.  The AST
training step needs them apart: its detached encode normalizes with batch
statistics (or the running ones, ``encoder_eval_stats``) and updates
nothing, while the identity encode and the re-encode update.  As in torch,
the biased variance normalizes and the unbiased one feeds the running
average, with momentum 0.1 in torch's convention and eps 1e-5.
"""

from __future__ import annotations

import torch
from torch import nn

from .stats import at_least_f32


class BatchNorm2D(nn.Module):
    """BatchNorm over an NHWC tensor; parameters ``scale``, ``bias`` and
    buffers ``mean``, ``var`` as in the JAX ``batch_stats`` tree."""

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
        if use_batch_stats:
            mean = x.mean(dim=(0, 1, 2))
            var = (x - mean).square().mean(dim=(0, 1, 2))  # biased
            if update_stats:
                n = x.shape[0] * x.shape[1] * x.shape[2]
                m = self.momentum
                with torch.no_grad():
                    unbiased = var * (n / max(n - 1, 1))
                    self.mean.copy_((1 - m) * self.mean + m * mean)
                    self.var.copy_((1 - m) * self.var + m * unbiased)
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + self.epsilon)
        return ((x - mean) * inv * self.scale + self.bias).to(in_dtype)
