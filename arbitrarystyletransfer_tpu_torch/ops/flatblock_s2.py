"""The stride-2 flat block route (NHWC): the twin of the host half of
``arbitrarystyletransfer_tpu/ops/pallas/flatblock_s2.py``.

The JAX package feeds its kernel space-to-depth parity planes in a flat
NCHW layout; those exist for the TPU's lanes, and the port's kernel indexes
the stride directly on NHWC, so only the block semantics and the routing
rule carry over.
"""

from __future__ import annotations

import torch

from .blocks import block_weights
from .kernels.flat_s2 import flat_s2_block

LANE = 128  # the TPU lane tile of the JAX eligibility rules


def round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def s2_eligible(h_in: int, w_in: int, lane: int = LANE) -> bool:
    """The JAX routing rule (``flatblock_s2.s2_eligible``): even spatial
    dims and pad-column waste of the output row stride, rounded up to
    ``lane``, at most 1/3.  ``lane`` scales the rule for small test sizes."""
    if h_in % 2 or w_in % 2:
        return False
    ws = round_up(w_in // 2, lane)
    return 3 * (ws - w_in // 2) <= ws


def flat_s2_block_apply(params, x, kernel_size: int, expand_ratio: int,
                        stats=None, dtype=torch.bfloat16):
    """One stride-2 DepthWiseConv block through the ``flat_s2_block``
    kernel, folded-BN inference semantics (``flat_s2_block_apply_f``);
    expand path only."""
    if expand_ratio == 1:
        raise ValueError("stride-2 blocks always expand")
    w_exp, b_exp, w_dw, b_dw, w_proj, proj_bias = block_weights(
        params, True, stats)
    y, _ = flat_s2_block(x.to(dtype), w_exp, w_dw, params["SELayer_0"],
                         w_proj, kernel_size, b_expand=b_exp, b_dw=b_dw,
                         proj_bias=proj_bias)
    return y
