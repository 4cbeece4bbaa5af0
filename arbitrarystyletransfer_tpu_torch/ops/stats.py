"""Per-channel statistics (NHWC), twins of ``arbitrarystyletransfer_tpu/ops/stats.py``."""

from __future__ import annotations

import torch


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """``sqrt(max(x, 0))`` with a zero gradient where ``x <= 0``."""
    pos = x > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Non-affine instance norm over the spatial dims of an NHWC tensor,
    in float32 with the biased variance (torch ``InstanceNorm2d``)."""
    x = x.float()
    mean = x.mean(dim=(1, 2), keepdim=True)
    var = x.var(dim=(1, 2), keepdim=True, unbiased=False)
    return (x - mean) * torch.reciprocal(torch.sqrt(var + eps))
