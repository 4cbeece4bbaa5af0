"""Architecture tables, ``ModelConfig`` and ``ASTTrainConfig`` for the port.

The tables and the dataclasses are a copy of the JAX package's
``arbitrarystyletransfer_tpu/config.py`` (same names, values and field
defaults), so that the port and its chip run import nothing of the JAX
package.  ``tests/test_torch_ops.py`` holds the copies equal, so the
architecture cannot drift.  Layout is NHWC at every public function, as in
the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

# (c_in, c_out, stride, kernel_size, expand_ratio) per encoder block; block 0
# is the stem conv, block 14 is built with expand_ratio=cfg.expand_ratio and
# kernel 3 (reference models.py:145-154).
ENC_CONV_SHAPES: Tuple[Tuple[int, int, int, int, int], ...] = (
    (3, 16, 1, 3, 1),
    (16, 16, 1, 3, 6),
    (16, 24, 2, 3, 6),
    (24, 24, 1, 3, 6),
    (24, 40, 2, 5, 6),
    (40, 40, 1, 5, 4),
    (40, 40, 1, 5, 4),
    (40, 80, 2, 3, 4),
    (80, 80, 1, 3, 4),
    (80, 80, 1, 3, 4),
    (80, 96, 1, 5, 4),
    (96, 96, 1, 5, 3),
    (96, 128, 1, 3, 3),
    (128, 128, 1, 3, 3),
    (128, 128, 1, 3, 3),
)

# (c_in, c_out, stride, kernel_size, expand_ratio); the final row is the
# (in_ch, out_ch) of the 3x3 image-output conv.
DECODER_CONV_SHAPES: Tuple[Tuple[int, ...], ...] = (
    (128, 128, 1, 3, 3),
    (128, 128, 1, 3, 3),
    (128, 96, 1, 3, 3),
    (96, 96, 1, 5, 3),
    (96, 80, 1, 5, 4),
    (80, 80, 1, 3, 4),
    (80, 80, 1, 3, 4),
    (80, 40, 1, 3, 4),
    (40, 40, 1, 5, 4),
    (40, 40, 1, 5, 4),
    (40, 24, 1, 5, 6),
    (24, 24, 1, 3, 6),
    (24, 16, 1, 3, 6),
    (16, 16, 1, 3, 6),
    (16, 3, 1),
)

EXPAND_RATIO = 3
ENC_OUT_LAYERS: Tuple[int, ...] = (12, 14)
ENC_OUT_CHANNELS = 128

VGG_CONTENT_LAYERS: Tuple[str, ...] = (
    "conv_1", "conv_3", "conv_5", "conv_9", "conv_13", "relu_15",
)

# Multi-resolution training sizes (the AST trainer's resolution buckets).
IMG_SIZES: Tuple[int, ...] = (96, 128, 160)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static architecture config; the fields of the JAX ``ModelConfig``."""

    enc_conv_shapes: Tuple[Tuple[int, int, int, int, int], ...] = ENC_CONV_SHAPES
    decoder_conv_shapes: Tuple[Tuple[int, ...], ...] = DECODER_CONV_SHAPES
    expand_ratio: int = EXPAND_RATIO
    enc_out_layers: Tuple[int, ...] = ENC_OUT_LAYERS
    enc_out_channels: int = ENC_OUT_CHANNELS
    vgg_content_layers: Tuple[str, ...] = VGG_CONTENT_LAYERS
    # Run the AdaAttN statistics through the hand-written kernel.
    use_pallas_adaattn: bool = False
    # True: the encoder normalizes with BatchNorm running statistics
    # (foldable, the only semantics the fused engine serves).
    encoder_eval_stats: bool = False
    # Compute dtype of the conv path (parameters are always float32).
    compute_dtype: str = "float32"
    # Depthwise lowering of the JAX flax graph; the port has one lowering.
    depthwise_impl: str = "conv"


@dataclasses.dataclass(frozen=True)
class ASTTrainConfig:
    """Stage-2 AST training flags; the fields of the JAX ``ASTTrainConfig``."""

    train_iter: int = 2_048_000
    batch_size: int = 8
    lr: float = 2e-4
    dis_lr: float = 1e-5
    dis_lam: float = 1e-3
    # The adversarial step is not ported (ROADMAP queue 1 item 9).
    use_dis: bool = False
    dis_adam_b1: float = 0.5
    dis_adam_b2: float = 0.99
    content_lam: float = 1.25
    org_img_lam: float = 0.5
    style_lam: float = 0.5
    tv_lam: float = 0.0006
    lf_lam: float = 1.0
    r1_lam: float = 5.0
    save_dir: str = "models/ast/"
    ae_model: str = "models/auto_encoder/ae"
    load: bool = False
    recon_lam: float = 100.0
    perp_lam: float = 0.01
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-5
    grad_clip_norm: float = 2.0
    # Fixed inner weights of the loss assembly.
    pixel_content_weight: float = 0.1
    pixel_style_weight: float = 1.0
    hist_lam: float = 1e-5
    out_of_range_lam: float = 1e8
    identity_mse_weight: float = 100.0
    save_every: int = 32
    log_every: int = 8


_DTYPES = {None: torch.float32, "float32": torch.float32,
           "bfloat16": torch.bfloat16}


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    """The torch dtype of ``cfg.compute_dtype``."""
    try:
        return _DTYPES[cfg.compute_dtype]
    except KeyError:
        raise ValueError(
            f"unsupported compute_dtype {cfg.compute_dtype!r}"
        ) from None
