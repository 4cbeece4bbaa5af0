"""Differentiable sRGB <-> CIELAB conversions (NHWC): the twins of
``arbitrarystyletransfer_tpu/ops/color.py``.

Every function takes and returns a float tensor with the channels on the
last axis; the matrices and the white point are the JAX module's.
"""

from __future__ import annotations

import torch

_RGB2XYZ = (
    (0.412453, 0.357580, 0.180423),
    (0.212671, 0.715160, 0.072169),
    (0.019334, 0.119193, 0.950227),
)
_XYZ2RGB = (
    (3.24048134, -1.53715152, -0.49853633),
    (-0.96925495, 1.87599, 0.04155593),
    (0.05564664, -0.20404134, 1.05731107),
)
_WHITE = (0.95047, 1.0, 1.08883)


def _const(values, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=like.dtype, device=like.device)


def rgb2xyz(rgb: torch.Tensor) -> torch.Tensor:
    """sRGB in [0, 1] -> XYZ."""
    mask = (rgb > 0.04045).to(rgb.dtype)
    lin = (((rgb + 0.055) / 1.055) ** 2.4) * mask + rgb / 12.92 * (1 - mask)
    return torch.einsum("...c,dc->...d", lin, _const(_RGB2XYZ, rgb))


def xyz2rgb(xyz: torch.Tensor) -> torch.Tensor:
    """XYZ -> sRGB; negatives are clamped to 0 before the 1/2.4 power."""
    rgb = torch.einsum("...c,dc->...d", xyz, _const(_XYZ2RGB, xyz))
    rgb = torch.clamp(rgb, min=0.0)
    mask = (rgb > 0.0031308).to(rgb.dtype)
    return ((1.055 * (rgb ** (1.0 / 2.4)) - 0.055) * mask
            + 12.92 * rgb * (1 - mask))


def xyz2lab(xyz: torch.Tensor) -> torch.Tensor:
    """XYZ -> CIELAB."""
    scaled = xyz / _const(_WHITE, xyz)
    mask = (scaled > 0.008856).to(xyz.dtype)
    f = ((scaled ** (1.0 / 3.0)) * mask
         + (7.787 * scaled + 16.0 / 116.0) * (1 - mask))
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    return torch.stack([116.0 * fy - 16.0, 500.0 * (fx - fy),
                        200.0 * (fy - fz)], dim=-1)


def lab2xyz(lab: torch.Tensor) -> torch.Tensor:
    """CIELAB -> XYZ."""
    y = (lab[..., 0] + 16.0) / 116.0
    x = lab[..., 1] / 500.0 + y
    z = torch.clamp(y - lab[..., 2] / 200.0, min=0.0)
    f = torch.stack([x, y, z], dim=-1)
    mask = (f > 0.2068966).to(lab.dtype)
    out = (f ** 3.0) * mask + (f - 16.0 / 116.0) / 7.787 * (1 - mask)
    return out * _const(_WHITE, lab)


def rgb2lab(rgb: torch.Tensor) -> torch.Tensor:
    """sRGB in [0, 1] -> LAB rescaled to about [0, 1]: ``(lab / 100 + 1) /
    2``."""
    return (xyz2lab(rgb2xyz(rgb)) / 100.0 + 1.0) / 2.0


def lab2rgb(lab_rs: torch.Tensor) -> torch.Tensor:
    """The inverse of ``rgb2lab``."""
    return xyz2rgb(lab2xyz((lab_rs * 2.0 - 1.0) * 100.0))
