"""Fused block routes and the functional encoder and decoder (NHWC).

Twin of the runtime half of ``arbitrarystyletransfer_tpu/ops/pallas/
fused_block.py``: ``fused_block_apply`` runs the expand + depthwise stage
through the ``expand_dw`` kernel and leaves the SE gate, the gated
projection, the bias and the residual to plain PyTorch, as the JAX package
leaves them to XLA.  ``block_apply`` keeps the JAX routing rule.
"""

from __future__ import annotations

import torch

from .basic import se_gate
from .blocks import (
    block_weights,
    head_apply,
    plain_block_apply,
    stem_apply,
    upsample_smooth_apply,
)
from .kernels.expand_dw import expand_dw

# Smallest block resolution sent to the kernel; the value of the JAX
# package's MIN_FUSED_SIZE (ops/pallas/fused_block.py:709), where it was
# measured on a TPU v5e.  The port keeps the routing unchanged.
MIN_FUSED_SIZE = 128


def fused_block_apply(params, x, kernel_size: int, expand_ratio: int,
                      use_identity: bool = True, stats=None,
                      dtype=torch.bfloat16):
    """One stride-1 DepthWiseConv block: folded BN, the expand_dw kernel,
    the SE gate from its exact sums, then the gated projection epilogue."""
    _, h, w, c_in = x.shape
    expand = expand_ratio != 1
    x = x.to(dtype)
    w_exp, b_exp, w_dw, b_dw, w_proj, proj_bias = block_weights(
        params, expand, stats)
    hidden, sums = expand_dw(x, w_exp, w_dw, kernel_size, pre_act=expand,
                             b_expand=b_exp, b_dw=b_dw)
    gate = se_gate(sums, h * w, params["SELayer_0"])
    gated = hidden * gate[:, None, None, :].to(hidden.dtype)
    y = torch.matmul(gated, w_proj.to(dtype))
    if proj_bias is not None:
        y = y.float() + proj_bias
    y = y.to(dtype)
    if use_identity and c_in == w_proj.shape[-1]:
        y = y + x
    return y


def block_apply(params, x, kernel_size: int, expand_ratio: int,
                use_identity: bool = True, stats=None, dtype=torch.bfloat16,
                min_fused_size: int = MIN_FUSED_SIZE):
    """The kernel route for expand blocks at ``H >= min_fused_size``
    (``min_fused_size=0`` sends every block there), the plain route
    elsewhere (``fused_block.block_apply``)."""
    if (expand_ratio != 1 or min_fused_size == 0) and (
            x.shape[1] >= min_fused_size):
        return fused_block_apply(params, x, kernel_size, expand_ratio,
                                 use_identity=use_identity, stats=stats,
                                 dtype=dtype)
    return plain_block_apply(params, x, kernel_size, 1, expand_ratio,
                             use_identity=use_identity, stats=stats,
                             dtype=dtype)


def decode_fused(dec_params, z, decoder_conv_shapes, exporting: bool = True,
                 dtype=torch.bfloat16, min_fused_size: int = MIN_FUSED_SIZE):
    """The decoder over the 'dec' parameter subtree: blocks by
    ``block_apply``, each nearest-x2 upsample folded into its smoothing
    block, then the head (clamped when ``exporting``)."""
    shapes = decoder_conv_shapes
    x = z
    for i, shape in enumerate(shapes[:-1]):
        blk = dec_params[f"decoder_blocks_{i}"]
        should_upsample = shape[0] != shape[1] and i + 6 < len(shapes)
        x = block_apply(blk["DepthWiseConv_0"], x, shape[3], shape[4],
                        dtype=dtype, min_fused_size=min_fused_size)
        if should_upsample:
            x = upsample_smooth_apply(blk["DepthWiseConv_1"], x, dtype)
    return head_apply(dec_params["img_out"], x, exporting=exporting,
                      dtype=dtype)


def encode_fused(enc_params, enc_stats, x, enc_conv_shapes, out_layers,
                 expand_ratio: int = 3, dtype=torch.bfloat16,
                 min_fused_size: int = MIN_FUSED_SIZE):
    """The encoder with BatchNorm running statistics folded into the conv
    weights; returns the feature maps at the ``out_layers`` block indices."""
    shapes = enc_conv_shapes
    h = stem_apply(enc_params["mob_net_0"]["Conv_0"], x, stride=shapes[0][2],
                   dtype=dtype)
    outs = [h] if 0 in out_layers else []
    for i, row in enumerate(shapes[1:], start=1):
        _, _, stride, k, t = row
        if i == len(shapes) - 1:
            # Final block: kernel 3, expand_ratio from the config
            # (reference models.py:154).
            k, t = 3, expand_ratio
        blk = enc_params[f"mob_net_{i}"]
        st = enc_stats[f"mob_net_{i}"]
        if stride == 1:
            h = block_apply(blk, h, k, t, stats=st, dtype=dtype,
                            min_fused_size=min_fused_size)
        else:
            h = plain_block_apply(blk, h, k, stride, t, stats=st, dtype=dtype)
        if i in out_layers:
            outs.append(h)
    return outs
