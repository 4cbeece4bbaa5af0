"""Kernel 4 (flat_s2_block): its plain twin against the TPU kernel.

The port's ``flat_s2_block_apply`` (on a CPU tensor the ``flat_s2_block``
wrapper takes ``flat_s2_block_reference``) is held against the JAX
package's ``flatblock_s2.flat_s2_block_apply_f``, whose Pallas
``_flat_s2_kernel`` runs in interpret mode on the CPU, at (2, 16, 256): the
output width is the TPU kernel's lane tile.  Tolerances as in
``test_torch_flatblock.py``.  The CUDA kernel itself is checked on the card
by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arbitrarystyletransfer_tpu.ops.pallas import flatblock_s2 as js2

from arbitrarystyletransfer_tpu_torch.ops import flatblock_s2 as ps2
from arbitrarystyletransfer_tpu_torch.ops.blocks import (
    block_weights,
    plain_block_apply,
)
from arbitrarystyletransfer_tpu_torch.ops.kernels import LAUNCHES
from arbitrarystyletransfer_tpu_torch.ops.kernels.flat_s2 import (
    flat_s2_block,
    flat_s2_block_reference,
)

from test_torch_flatblock import DTYPES, _np
from test_torch_ops import assert_close, block_params, to_jax, to_port


@pytest.mark.parametrize("c_in,c_out,k,use_norm,dtype", [
    (16, 24, 3, True, "float32"),    # e2
    (24, 40, 5, True, "float32"),    # e4
    (24, 40, 5, False, "float32"),   # no BN biases
    (16, 24, 3, True, "bfloat16"),
    (24, 40, 5, True, "bfloat16"),
])
def test_flat_s2_block_matches_pallas_kernel(c_in, c_out, k, use_norm, dtype):
    tdt, jdt, rel = DTYPES[dtype]
    p, s = block_params(c_in, c_out, k, 6, use_norm, seed=k)
    x = np.random.default_rng(k).normal(0, 1, (2, 16, 256, c_in))
    x = x.astype(np.float32)
    out = ps2.flat_s2_block_apply(to_port(p), torch.from_numpy(x), k, 6,
                                  stats=to_port(s), dtype=tdt)
    # The JAX kernel takes the flat NCHW layout (B, C, H*W).
    xf = jnp.asarray(x).astype(jdt).transpose(0, 3, 1, 2).reshape(
        2, c_in, 16 * 256)
    ref = js2.flat_s2_block_apply_f(to_jax(p), xf, 16, k, 6,
                                    stats=to_jax(s), interpret=True)
    ref = ref.reshape(2, c_out, 8, 128).transpose(0, 2, 3, 1)
    assert out.dtype == tdt and out.shape == (2, 8, 128, c_out)
    assert_close(_np(out), _np(ref), rel, f"stride-2 block {dtype}")


@pytest.mark.parametrize("h,w,k", [(10, 14, 3), (12, 6, 5), (2, 4, 3)])
def test_flat_s2_block_matches_plain_route_at_f32(h, w, k):
    """At f32 the block equals the plain stride-2 route, reflect edges
    included, at sizes the TPU kernel would not take."""
    p, s = block_params(24, 40, k, 6, True, seed=h)
    x = torch.from_numpy(np.random.default_rng(h).normal(
        0, 1, (2, h, w, 24)).astype(np.float32))
    out = ps2.flat_s2_block_apply(to_port(p), x, k, 6, stats=to_port(s),
                                  dtype=torch.float32)
    ref = plain_block_apply(to_port(p), x, k, 2, 6, stats=to_port(s),
                            dtype=torch.float32)
    assert out.shape == (2, h // 2, w // 2, 40)
    assert_close(out, ref, 1e-5, "stride-2 block vs plain route")


@pytest.mark.parametrize("h,w,lane,eligible", [
    (512, 512, 128, True),    # e2 at 512px: output width 256
    (256, 256, 128, True),    # e4 at 512px
    (128, 128, 128, False),   # e7 at 512px: output width 64 wastes 1/2
    (320, 320, 128, False),   # e2 at 320px: 160 -> 256 wastes 3/8
    (64, 64, 16, True),       # e2 at 64px with the lane scaled by 1/8
    (16, 16, 16, False),      # e7 at 64px, scaled
    (30, 32, 16, True),
    (31, 32, 16, False),      # odd height
])
def test_s2_eligible_is_the_jax_rule(h, w, lane, eligible):
    assert ps2.s2_eligible(h, w, lane) == eligible
    if lane == 128:
        assert js2.s2_eligible(h, w) == eligible


def test_cpu_tensor_takes_the_plain_twin():
    p, s = block_params(16, 24, 3, 6, True, seed=1)
    w_exp, b_exp, w_dw, b_dw, w_proj, pb = block_weights(to_port(p), True,
                                                          to_port(s))
    args = (torch.randn(1, 8, 8, 16, generator=torch.Generator().manual_seed(1)),
            w_exp, w_dw, to_port(p)["SELayer_0"], w_proj, 3)
    kw = dict(b_expand=b_exp, b_dw=b_dw, proj_bias=pb)
    before = dict(LAUNCHES)
    out = flat_s2_block(*args, **kw)
    ref = flat_s2_block_reference(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert out[0].shape == (1, 4, 4, 24) and out[1].shape == (1, 96)
    assert LAUNCHES == before


def test_other_devices_and_odd_sizes_raise():
    p, _ = block_params(16, 24, 3, 6, False, seed=2)
    w_exp, _, w_dw, _, w_proj, _ = block_weights(to_port(p), True)
    se = to_port(p)["SELayer_0"]
    x = torch.empty(1, 8, 8, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flat_s2_block(x, w_exp, w_dw, se, w_proj, 3)
    with pytest.raises(ValueError, match="always expands"):
        flat_s2_block(torch.zeros(1, 8, 8, 16), None, w_dw, se, w_proj, 3)
