"""The fused stylize engine: ``engine.stylize_fused`` of the JAX package.

Parameter tree in, image out (NHWC): one encoder pass over the stacked
[content; style] batch with BatchNorm running statistics folded in, both
AdaAttN taps in one attention call over 2B images, one stacked ``ada_out``
block, the alpha blend, then the decoder with the export clamp.

``encoder_impl``/``decoder_impl`` choose the block routes, as in JAX:
"fused" sends the high-resolution stride-1 blocks through the ``expand_dw``
kernel; "flat", "flat-all" and "auto" plan each block onto the
``flat_block`` and ``flat_s2_block`` kernels, the fused route or the plain
route (``ops/flatblock.py``).  With ``cfg.use_pallas_adaattn`` the
attention statistics run the ``adaattn_fwd`` kernel.
"""

from __future__ import annotations

import torch

from .config import ModelConfig
from .ops.flatblock import FLAT_MODE, LANE, decode_flat, encode_flat
from .ops.fused_block import (
    MIN_FUSED_SIZE,
    block_apply,
    decode_fused,
    encode_fused,
)
from .ops.stats import instance_norm

# Block routes of the JAX engine that this port does not have yet, and the
# ROADMAP entry that brings each.
_LATER_IMPLS = {
    "mega": "ROADMAP queue 2 item 8 (megablock._mega_kernel_t)",
}


def _check_impl(name: str, value: str) -> None:
    if value == "fused" or value in FLAT_MODE:
        return
    if value in _LATER_IMPLS:
        raise NotImplementedError(
            f"{name}={value!r} is not ported yet: see {_LATER_IMPLS[value]}")
    raise ValueError(f"unknown {name} {value!r}")


def adaattn_apply_pair(att1_params, att2_params, content_maps, style_maps,
                       use_kernel: bool = True, dtype=torch.bfloat16):
    """Both AdaAttN modules in one attention call over the stacked 2B
    images (``engine.adaattn_apply_pair``); returns the two stylized maps
    in float32."""
    b, h, w, c = content_maps[0].shape
    cm = torch.cat(list(content_maps), dim=0)
    sm = torch.cat(list(style_maps), dim=0)
    normed_c = instance_norm(cm)
    normed_s = instance_norm(sm)

    def project(x, name):
        wk = torch.stack([att1_params[name]["kernel"][0, 0],
                          att2_params[name]["kernel"][0, 0]]).to(dtype)
        x2 = x.to(dtype).reshape(2, b, -1, c)
        return torch.matmul(x2, wk[:, None]).reshape(2 * b, -1, c)

    q = project(normed_c, "W_q")
    k = project(normed_s, "W_k")
    v = project(sm, "W_v")
    if use_kernel:
        from .ops.kernels.adaattn_fwd import adaattn_statistics
    else:
        from .models.adaattn import adaattn_statistics
    mean, std = adaattn_statistics(q, k, v)
    mean = mean.reshape(2 * b, h, w, c).float()
    std = std.reshape(2 * b, h, w, c).float()
    out = std * normed_c + mean
    return out[:b], out[b:]


def stylize_fused(state, content_img, style_img, alpha: float = 1.0,
                  cfg: ModelConfig = ModelConfig(), dtype=torch.bfloat16,
                  min_fused_size: int = MIN_FUSED_SIZE,
                  decoder_impl: str = "fused", encoder_impl: str = "fused",
                  exporting: bool = True, lane: int = LANE):
    """Alpha-interpolated stylization of NHWC [0, 1] batches.

    ``state`` is ``{"params": ..., "batch_stats": ...}`` (see weights.py).
    ``exporting=False`` skips the final clamp (the pre-clamp image).
    ``lane`` and ``min_fused_size`` scale the routing rules, so that a test
    at a small size routes its blocks as the full size does."""
    _check_impl("encoder_impl", encoder_impl)
    _check_impl("decoder_impl", decoder_impl)
    params, stats = state["params"], state["batch_stats"]
    b = content_img.shape[0]
    both = torch.cat([content_img, style_img], dim=0)
    if encoder_impl in FLAT_MODE:
        both_maps = encode_flat(
            params["enc"], stats["enc"], both, cfg.enc_conv_shapes,
            cfg.enc_out_layers, expand_ratio=cfg.expand_ratio, dtype=dtype,
            flat_blocks=FLAT_MODE[encoder_impl], lane=lane,
            min_fused_size=min_fused_size,
        )
    else:
        both_maps = encode_fused(
            params["enc"], stats["enc"], both, cfg.enc_conv_shapes,
            cfg.enc_out_layers, expand_ratio=cfg.expand_ratio, dtype=dtype,
            min_fused_size=min_fused_size,
        )
    content_maps = [m[:b] for m in both_maps]
    style_maps = [m[b:] for m in both_maps]

    sm1, sm2 = adaattn_apply_pair(
        params["ada_att_1"], params["ada_att_2"], content_maps, style_maps,
        use_kernel=cfg.use_pallas_adaattn, dtype=dtype,
    )
    # One ada_out pass over the stacked [stylized; content] maps.
    fuse_in = torch.cat([torch.cat([sm1, sm2], dim=-1),
                         torch.cat(content_maps, dim=-1)], dim=0)
    fused = block_apply(params["ada_out"], fuse_in, 3, cfg.expand_ratio,
                        use_identity=False, dtype=dtype,
                        min_fused_size=min_fused_size)
    t, content_map = fused[:b], fused[b:]
    t = alpha * t + (1.0 - alpha) * content_map
    if decoder_impl in FLAT_MODE:
        return decode_flat(params["dec"], t, cfg.decoder_conv_shapes,
                           exporting=exporting, dtype=dtype,
                           flat_blocks=FLAT_MODE[decoder_impl], lane=lane,
                           min_fused_size=min_fused_size)
    return decode_fused(params["dec"], t, cfg.decoder_conv_shapes,
                        exporting=exporting, dtype=dtype,
                        min_fused_size=min_fused_size)
