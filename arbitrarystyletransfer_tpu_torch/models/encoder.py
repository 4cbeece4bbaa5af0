"""The trainable encoder (NHWC): the twin of ``models/encoder.py``.

A reflect-padded conv stem and 14 inverted-residual blocks with BatchNorm,
stride 2 at blocks 2, 4 and 7 (x8 downsample).  Taps are the outputs of
the blocks in ``out_layers``.  The last block is built from the last shape
row with ``cfg.expand_ratio`` and k=3, as the JAX encoder builds it.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..config import ModelConfig, torch_dtype
from ..ops.blocks import ConvStem, DepthWiseConv


def module_dtype(cfg: ModelConfig):
    """The compute dtype the modules cast to: None (promotion) at f32."""
    dt = torch_dtype(cfg)
    return None if dt == torch.float32 else dt


class Encoder(nn.Module):
    def __init__(self, cfg: ModelConfig = ModelConfig()):
        super().__init__()
        shapes = cfg.enc_conv_shapes
        dtype = module_dtype(cfg)
        self.n_blocks = len(shapes)
        self.mob_net_0 = ConvStem(shapes[0][0], shapes[0][1],
                                  stride=shapes[0][2], dtype=dtype)
        for i, (c_in, c_out, stride, k, t) in enumerate(shapes[1:], start=1):
            if i == len(shapes) - 1:
                k, t = 3, cfg.expand_ratio
            self.add_module(f"mob_net_{i}", DepthWiseConv(
                c_in, c_out, stride, t, kernel_size=k, use_norm=True,
                dtype=dtype))

    def forward(self, x: torch.Tensor, out_layers: Sequence[int] = (),
                auto_enc: bool = False, train: bool = True,
                use_batch_stats: bool | None = None):
        """The taps at ``out_layers`` (a list), or the last block's output
        with ``auto_enc``.  ``train`` gates the BatchNorm running updates;
        ``use_batch_stats`` overrides the normalizer (None follows
        ``train``)."""
        outs = []
        x = self.mob_net_0(x)
        if 0 in out_layers:
            outs.append(x)
        for i in range(1, self.n_blocks):
            x = getattr(self, f"mob_net_{i}")(
                x, train=train, use_batch_stats=use_batch_stats)
            if i in out_layers:
                outs.append(x)
        return x if auto_enc else outs
