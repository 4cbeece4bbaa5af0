"""The MobileNetV2 classifier and the GAN discriminator built on it: the
twins of ``arbitrarystyletransfer_tpu/models/mobilenetv2.py`` (NHWC).

The children carry the flax tree's names (``stem_conv``, ``blocks_0`` ..
``blocks_16``, ``head_conv``, ``head_bn``, ``classifier``; the
discriminator's ``mobnet``), so ``weights.load_state`` moves the JAX
variables in one to one.  Flax creates a module's variables only when it is
called: the discriminator's head is instance-normalized, its ``head_bn`` is
never called and has no variables, so here it is not built.

  stem:          reflect pad 1, 3x3 stride-2 VALID conv (no bias, no BN),
                 then hardswish, or a non-affine instance norm in the
                 discriminator
  features:      the stem (layer 0), then the 17 inverted-residual blocks
                 (layers 1-17)
  predict_class: features, [dropout], 1x1 head conv, BN or instance norm,
                 dropout, hardswish, global mean, dense classifier

Dropout draws its keep mask from the ``generator`` passed in (``torch.rand``
takes one, ``F.dropout`` does not): keep with probability 1 - p, scale by
1 / (1 - p), as flax's ``Dropout`` does.  The masks are not JAX's bits; the
parity tests run at ``dropout_rate=0``, as the JAX package's own do.  On a
mesh of more than one rank (``MobileNetV2.mesh``) each rank draws the mask
of the global batch and keeps its own rows, so that the masks are the
one-process step's.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.basic import hardswish, reflect_pad
from ..ops.blocks import Conv, Dense, InvertedResidual, make_divisible
from ..ops.norm import BatchNorm2D
from ..ops.stats import instance_norm
from ..parallel.mesh import is_sharded, shard_rows

# (t, c, n, s) inverted-residual settings.
MOBILENETV2_CFGS = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: torch.Generator | None, mesh=None) -> torch.Tensor:
    """Flax ``Dropout``: the identity when not training or at rate 0, else
    ``where(keep, x / (1 - rate), 0)`` with ``keep`` drawn from
    ``generator`` (on ``x``'s device).  With a ``mesh`` of more than one
    rank ``x`` is this rank's rows: the mask is drawn for the global batch
    and sliced to them."""
    if not train or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    if is_sharded(mesh):
        rows = shard_rows(mesh, x.shape[0] * mesh.size)
        keep = torch.rand((x.shape[0] * mesh.size, *x.shape[1:]),
                          generator=generator, device=x.device,
                          dtype=x.dtype)[rows] < keep_prob
    else:
        keep = torch.rand(x.shape, generator=generator, device=x.device,
                          dtype=x.dtype) < keep_prob
    return torch.where(keep, x / keep_prob, 0.0)


class MobileNetV2(nn.Module):
    """The classifier; ``stem_instance_norm`` / ``head_instance_norm``
    replace the stem's hardswish and the head's BN with a non-affine
    instance norm, and ``extra_feature_dropout`` adds a dropout after the
    features (the discriminator's swaps).  ``mesh``
    (``parallel.set_mesh``) slices the dropout masks of the global batch to
    this rank's rows."""

    mesh = None

    def __init__(self, num_classes: int = 1000, width_mult: float = 1.0,
                 stem_instance_norm: bool = False,
                 head_instance_norm: bool = False,
                 extra_feature_dropout: bool = False,
                 dropout_rate: float = 0.2):
        super().__init__()
        self.stem_instance_norm = stem_instance_norm
        self.head_instance_norm = head_instance_norm
        self.extra_feature_dropout = extra_feature_dropout
        self.dropout_rate = dropout_rate
        divisor = 4 if width_mult == 0.1 else 8
        input_channel = make_divisible(32 * width_mult, divisor)
        self.stem_conv = Conv(3, input_channel, 3, stride=2)
        self.num_blocks = 0
        for t, c, n, s in MOBILENETV2_CFGS:
            output_channel = make_divisible(c * width_mult, divisor)
            for i in range(n):
                self.add_module(f"blocks_{self.num_blocks}", InvertedResidual(
                    input_channel, output_channel, s if i == 0 else 1, t))
                self.num_blocks += 1
                input_channel = output_channel
        last_channel = (make_divisible(1280 * width_mult, divisor)
                        if width_mult > 1.0 else 1280)
        self.head_conv = Conv(input_channel, last_channel, 1)
        if not head_instance_norm:
            self.head_bn = BatchNorm2D(last_channel)
        self.classifier = Dense(last_channel, num_classes)

    def _stem(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem_conv(reflect_pad(x, 1))
        return instance_norm(x) if self.stem_instance_norm else hardswish(x)

    def features(self, x: torch.Tensor, out_layers: Sequence[int] = (),
                 train: bool = True):
        """(the maps of ``out_layers``, the last map): layer 0 is the stem,
        1-17 the blocks."""
        outs = []
        x = self._stem(x)
        if 0 in out_layers:
            outs.append(x)
        for i in range(self.num_blocks):
            x = getattr(self, f"blocks_{i}")(x, train=train)
            if i + 1 in out_layers:
                outs.append(x)
        return outs, x

    def forward(self, x: torch.Tensor, out_layers: Sequence[int] = (),
                train: bool = True):
        return self.features(x, out_layers, train)[0]

    def predict_class(self, x: torch.Tensor, train: bool = True,
                      generator: torch.Generator | None = None):
        """The logits (B, num_classes); ``generator`` draws the dropout
        masks (two: the features', when present, then the head's)."""
        _, x = self.features(x, (), train)
        if self.extra_feature_dropout:
            x = dropout(x, self.dropout_rate, train, generator, self.mesh)
        x = self.head_conv(x)
        if self.head_instance_norm:
            x = instance_norm(x)
        else:
            x = self.head_bn(x, use_batch_stats=train, update_stats=train)
        x = dropout(x, self.dropout_rate, train, generator, self.mesh)
        x = hardswish(x)
        return self.classifier(x.mean(dim=(1, 2)))


class Discriminator(nn.Module):
    """``sigmoid(MobileNetV2(num_classes=1).predict_class)`` with the stem
    and head instance-normalized and the extra feature dropout."""

    def __init__(self, dropout_rate: float = 0.2):
        super().__init__()
        self.mobnet = MobileNetV2(
            num_classes=1, stem_instance_norm=True, head_instance_norm=True,
            extra_feature_dropout=True, dropout_rate=dropout_rate)

    def forward(self, x: torch.Tensor, train: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        return torch.sigmoid(self.mobnet.predict_class(x, train, generator))
