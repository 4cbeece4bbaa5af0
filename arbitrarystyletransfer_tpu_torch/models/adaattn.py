"""AdaAttN (NHWC): the twin of ``models/adaattn.py``.

``adaattn_statistics`` is the dense golden, which materializes the (Nc, Ns)
attention matrix; the kernel route (``ops.kernels.adaattn_fwd``) is held
against it.  Logits are unscaled and v is squared in float32.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.blocks import Conv
from ..ops.stats import channel_stats, instance_norm, safe_sqrt


def adaattn_statistics(q, k, v):
    """Attention-weighted per-position style (mean, std), each (B, Nc, C)
    float32, from q (B, Nc, C) and k, v (B, Ns, C)."""
    logits = q.float() @ k.float().transpose(1, 2)
    attn = torch.softmax(logits, dim=-1)
    v = v.float()
    moments = attn @ torch.cat([v, v.square()], dim=-1)
    c = v.shape[-1]
    mean, ev2 = moments[..., :c], moments[..., c:]
    return mean, safe_sqrt(ev2 - mean.square())


class AdaAttN(nn.Module):
    """Attention-weighted adaptive instance norm:
    ``std * IN(content) + mean``, with q and k projected (1x1, no bias) from
    the instance-normed maps and v from the raw style map.  ``use_pallas``
    routes the statistics through the kernels (``AdaAttnStatistics``), else
    through the dense function."""

    def __init__(self, inp_size: int, use_pallas: bool = False, dtype=None):
        super().__init__()
        self.inp_size, self.use_pallas = inp_size, use_pallas
        self.W_q = Conv(inp_size, inp_size, 1, dtype=dtype)
        self.W_k = Conv(inp_size, inp_size, 1, dtype=dtype)
        self.W_v = Conv(inp_size, inp_size, 1, dtype=dtype)

    def forward(self, content_map: torch.Tensor,
                style_map: torch.Tensor) -> torch.Tensor:
        b, h, w, c = content_map.shape
        if c != self.inp_size:
            raise ValueError(f"AdaAttN: {c} channels, built for "
                             f"{self.inp_size}")
        normed_content = instance_norm(content_map)
        q = self.W_q(normed_content).reshape(b, h * w, c)
        k = self.W_k(instance_norm(style_map)).reshape(b, -1, c)
        v = self.W_v(style_map).reshape(b, -1, c)
        if self.use_pallas:
            from ..ops.kernels.adaattn_fwd import adaattn_statistics as stats
        else:
            stats = adaattn_statistics
        mean, std = stats(q, k, v)
        return std.reshape(b, h, w, c) * normed_content + mean.reshape(
            b, h, w, c)


class AdaIN(nn.Module):
    """Adaptive instance norm with the intended unpack order: the content
    map normalized by its own (mean, std) and re-scaled by the style map's
    (``channel_stats``: unbiased std, no eps)."""

    def forward(self, content_map: torch.Tensor,
                style_map: torch.Tensor) -> torch.Tensor:
        style_mean, style_std = channel_stats(style_map)
        content_mean, content_std = channel_stats(content_map)
        normalized = (content_map - content_mean) / content_std
        return normalized * style_std + style_mean
