"""Dense AdaAttN statistics, the twin of ``models/adaattn.adaattn_statistics``.

The golden the kernel route is held against: it materializes the (Nc, Ns)
attention matrix.  Logits are unscaled and v is squared in float32.
"""

from __future__ import annotations

import torch

from ..ops.stats import safe_sqrt


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
