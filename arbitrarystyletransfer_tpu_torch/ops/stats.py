"""Per-channel statistics (NHWC), twins of ``arbitrarystyletransfer_tpu/ops/stats.py``."""

from __future__ import annotations

import torch


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or as it is if it is float64: where the model
    widens to float32 (statistics, products, the image), a float64
    reference run stays in float64."""
    return x if x.dtype == torch.float64 else x.float()


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """``sqrt(max(x, 0))`` with a zero gradient where ``x <= 0``."""
    pos = x > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Non-affine instance norm over the spatial dims of an NHWC tensor,
    in float32 with the biased variance (torch ``InstanceNorm2d``)."""
    x = at_least_f32(x)
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
