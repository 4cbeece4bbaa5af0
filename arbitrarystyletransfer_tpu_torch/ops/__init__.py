"""Tensor ops of the port: plain PyTorch routes, the kernel wrappers and
the sRGB <-> CIELAB conversions (``color``)."""

from . import color

__all__ = ["color"]
