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


def channel_stats(x: torch.Tensor):
    """Per-(N, C) spatial mean and unbiased std (no eps), keepdims: the
    reference's ``model_util`` stats, with ``safe_sqrt``'s zero gradient."""
    mean = x.mean(dim=(1, 2), keepdim=True)
    n = x.shape[1] * x.shape[2]
    var = (x - mean).square().sum(dim=(1, 2), keepdim=True) / (n - 1)
    return mean, safe_sqrt(var)


def calc_mean_std(x: torch.Tensor, eps: float = 1e-5):
    """Per-(N, C) spatial mean and ``sqrt(unbiased var + eps)``, keepdims."""
    mean = x.mean(dim=(1, 2), keepdim=True)
    var = x.var(dim=(1, 2), keepdim=True, unbiased=True)
    return mean, torch.sqrt(var + eps)


def mean_variance_norm(x: torch.Tensor) -> torch.Tensor:
    """Zero mean, unit std per (N, C) over the spatial dims."""
    mean, std = calc_mean_std(x)
    return (x - mean) / std
