"""The mirrored upsampling decoder (NHWC): the twin of ``models/decoder.py``.

14 decoder blocks without BatchNorm; blocks 2, 4 and 7 (where the width
changes within the first 9) upsample by nearest x2 and smooth with an
expand==1 block.  The head is a reflect-padded 3x3 conv with bias, in f32,
clamped to [0, 1] only when ``exporting``: training sees the unclamped
image.  This is the flax graph's math (not the engine's phase-folded
upsample, whose JAX twin is wrong: ROADMAP queue 3).
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import ModelConfig
from ..ops.basic import reflect_pad
from ..ops.blocks import Conv, DepthWiseConv
from ..ops.stats import at_least_f32
from .encoder import module_dtype


def nearest_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour x2 spatial upsample of an NHWC tensor."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


class DecoderBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, stride: int,
                 kernel_size: int = 3, upsample: bool = False,
                 expand_ratio: int = 6, dtype=None):
        super().__init__()
        self.upsample = upsample
        self.DepthWiseConv_0 = DepthWiseConv(
            c_in, c_out, stride, expand_ratio, kernel_size=kernel_size,
            use_norm=False, dtype=dtype)
        if upsample:
            self.DepthWiseConv_1 = DepthWiseConv(
                c_out, c_out, 1, 1, use_norm=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.DepthWiseConv_0(x, train=False)
        if self.upsample:
            x = self.DepthWiseConv_1(nearest_upsample_2x(x), train=False)
        return x


class Decoder(nn.Module):
    def __init__(self, cfg: ModelConfig = ModelConfig()):
        super().__init__()
        shapes = cfg.decoder_conv_shapes
        dtype = module_dtype(cfg)
        self.n_blocks = len(shapes) - 1
        for i, shape in enumerate(shapes[:-1]):
            upsample = shape[0] != shape[1] and i + 6 < len(shapes)
            self.add_module(f"decoder_blocks_{i}", DecoderBlock(
                shape[0], shape[1], shape[2], kernel_size=shape[3],
                expand_ratio=shape[4], upsample=upsample, dtype=dtype))
        self.img_out = Conv(shapes[-1][0], shapes[-1][1], 3, use_bias=True,
                            dtype=dtype)

    def forward(self, x: torch.Tensor, exporting: bool = False) -> torch.Tensor:
        for i in range(self.n_blocks):
            x = getattr(self, f"decoder_blocks_{i}")(x)
        x = at_least_f32(self.img_out(reflect_pad(x, 1)))
        if exporting:
            x = torch.clamp(x, 0.0, 1.0)
        return x
