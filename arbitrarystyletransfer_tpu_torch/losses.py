"""Loss functions (NHWC): the twins of ``arbitrarystyletransfer_tpu/losses.py``.

Huber (delta 1, mean) and the content loss built on it, the mean/std/gram
style loss, total variation (a sum), the soft histogram (normalized by the
true element count) and its squared-CDF earth mover's distance, the
alternative sigmoid histogram, and the discriminator's BCE and R1 penalty.
"""

from __future__ import annotations

import torch

from .ops.stats import channel_stats

HIST_K = 256


def huber_loss(inp: torch.Tensor, tgt: torch.Tensor,
               delta: float = 1.0) -> torch.Tensor:
    err = inp - tgt
    abs_err = err.abs()
    quad = 0.5 * err * err
    lin = delta * (abs_err - 0.5 * delta)
    return torch.where(abs_err <= delta, quad, lin).mean()


def compute_content_loss(inp: torch.Tensor,
                         tgt: torch.Tensor) -> torch.Tensor:
    """The Huber content loss."""
    return huber_loss(inp, tgt)


def gram_matrix(x: torch.Tensor) -> torch.Tensor:
    """(B, C, C) gram of an NHWC tensor over its pixels, / (C H W)."""
    b, h, w, c = x.shape
    flat = x.reshape(b, h * w, c).float()
    return flat.transpose(1, 2) @ flat / (c * h * w)


def compute_style_loss(t_cs_map: torch.Tensor,
                       style_map: torch.Tensor) -> torch.Tensor:
    """Mean and std matching (x1.25 each) plus gram matching (x10)."""
    enc_mean, enc_std = channel_stats(t_cs_map)
    style_mean, style_std = channel_stats(style_map)
    mean_loss = huber_loss(enc_mean, style_mean) * 1.25
    std_loss = huber_loss(enc_std, style_std) * 1.25
    gram_loss = huber_loss(gram_matrix(t_cs_map),
                           gram_matrix(style_map)) * 10.0
    return mean_loss + std_loss + gram_loss


def tv_loss(img: torch.Tensor) -> torch.Tensor:
    """Anisotropic total variation, summed."""
    w_var = (img[:, :, :-1, :] - img[:, :, 1:, :]).square().sum()
    h_var = (img[:, :-1, :, :] - img[:, 1:, :, :]).square().sum()
    return h_var + w_var


def soft_histogram(x: torch.Tensor, k: int = HIST_K) -> torch.Tensor:
    """(B, K) sigmoid-bump histogram of all values of each batch element,
    normalized by the element count."""
    l, w = 1.0 / k, (1.0 / k) / 2.5
    mu_k = l * (torch.arange(k, dtype=x.dtype, device=x.device) + 0.5)
    b = x.shape[0]
    flat = x.reshape(b, 1, -1)
    n = flat.shape[-1]
    d = flat - mu_k[None, :, None]
    pj = torch.sigmoid((d + l / 2) / w) - torch.sigmoid((d - l / 2) / w)
    return pj.sum(dim=2) / n


def earth_movers_distance(x_hist: torch.Tensor,
                          y_hist: torch.Tensor) -> torch.Tensor:
    """Squared-CDF EMD per batch element."""
    return (x_hist.cumsum(dim=1) - y_hist.cumsum(dim=1)).square().sum(dim=1)


def compute_hist_loss(t_cs: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
    """Mean EMD between the soft histograms of the two batches."""
    return earth_movers_distance(soft_histogram(t_cs),
                                 soft_histogram(style)).mean()


def soft_histogram_alt(x: torch.Tensor, bins: int = 255, vmin: float = 0.0,
                       vmax: float = 1.0, sigma: float = 3.0) -> torch.Tensor:
    """The alternative sigmoid soft histogram of the last axis of a (..., N)
    input: (..., bins), unnormalized."""
    delta = float(vmax - vmin) / float(bins)
    centers = vmin + delta * (
        torch.arange(bins, dtype=x.dtype, device=x.device) + 0.5)
    d = x[..., None, :] - centers[..., :, None]  # (..., bins, N)
    vals = (torch.sigmoid(sigma * (d + delta / 2))
            - torch.sigmoid(sigma * (d - delta / 2)))
    return vals.sum(dim=-1)


def discriminator_loss(output: torch.Tensor,
                       label: torch.Tensor) -> torch.Tensor:
    """Binary cross entropy on sigmoid outputs, the output clipped to
    [1e-12, 1 - 1e-12] as the JAX package writes it: in float32 the upper
    bound rounds to 1.0, and that is kept."""
    eps = 1e-12
    out = torch.clamp(output, eps, 1.0 - eps)
    return -(label * torch.log(out)
             + (1.0 - label) * torch.log(1.0 - out)).mean()


def r1_loss(disc_apply, real_sample: torch.Tensor,
            r1_lam: float = 5.0) -> torch.Tensor:
    """The R1 gradient penalty ``r1_lam * mean(per-sample sum of
    (dD/dx)^2)``, differentiable (``create_graph``): ``disc_apply`` maps an
    image batch to per-sample predictions."""
    x = real_sample if real_sample.requires_grad else (
        real_sample.detach().requires_grad_(True))
    return r1_penalty(disc_apply(x), x, r1_lam)


def r1_penalty(pred: torch.Tensor, x: torch.Tensor,
               r1_lam: float) -> torch.Tensor:
    """``r1_lam * mean(per-sample sum of (d sum(pred) / dx)^2)`` for
    predictions ``pred`` already computed from ``x`` (one forward serving
    both the BCE term and the penalty)."""
    (grad,) = torch.autograd.grad(pred.sum(), x, create_graph=True)
    return r1_lam * grad.reshape(grad.shape[0], -1).square().sum(dim=1).mean()
