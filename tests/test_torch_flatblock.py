"""Kernel 3 (flat_block): its plain twin against the TPU kernel.

The port's ``flat_block_apply`` (on a CPU tensor the ``flat_block`` wrapper
takes ``flat_block_reference``) is held against the JAX package's
``flatblock.flat_block_apply``, whose Pallas ``_flat_kernel`` runs in
interpret mode on the CPU, at (2, 8, 128): the width is the TPU kernel's lane
tile.  Tolerances: at float32 1e-5 of the largest value (sums in other
orders); at bfloat16 one bf16 ulp of it, since a value rounded once from f32
sums taken in different orders may flip by one ulp.  The CUDA kernel itself
is checked on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arbitrarystyletransfer_tpu.ops.pallas import flatblock as jflat

from arbitrarystyletransfer_tpu_torch.ops import flatblock as pflat
from arbitrarystyletransfer_tpu_torch.ops.blocks import (
    block_weights,
    plain_block_apply,
)
from arbitrarystyletransfer_tpu_torch.ops.kernels import LAUNCHES
from arbitrarystyletransfer_tpu_torch.ops.kernels.flat_block import (
    flat_block,
    flat_block_reference,
)

from test_torch_ops import assert_close, block_params, to_jax, to_port

BF16_ULP = 2.0 ** -7  # relative to the largest value
DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, BF16_ULP)}


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("c_in,c_out,k,t,use_norm,identity,dtype", [
    (16, 16, 3, 6, True, True, "float32"),     # e1: BN biases, residual
    (40, 24, 5, 6, False, True, "float32"),    # d10: no BN, no residual
    (16, 16, 3, 6, True, False, "float32"),    # residual switched off
    (16, 16, 3, 1, True, True, "float32"),     # expand==1
    (16, 16, 3, 6, True, True, "bfloat16"),
    (40, 24, 5, 6, False, True, "bfloat16"),
])
def test_flat_block_matches_pallas_kernel(c_in, c_out, k, t, use_norm,
                                          identity, dtype):
    tdt, jdt, rel = DTYPES[dtype]
    p, s = block_params(c_in, c_out, k, t, use_norm, seed=k + t)
    x = np.random.default_rng(k).normal(0, 1, (2, 8, 128, c_in))
    x = x.astype(np.float32)
    out = pflat.flat_block_apply(to_port(p), torch.from_numpy(x), k, t,
                                 use_identity=identity, stats=to_port(s),
                                 dtype=tdt)
    ref = jflat.flat_block_apply(to_jax(p), jnp.asarray(x), k, t,
                                 use_identity=identity, stats=to_jax(s),
                                 interpret=True, dtype=jdt)
    assert out.dtype == tdt and out.shape == (2, 8, 128, c_out)
    assert_close(_np(out), _np(ref), rel, f"flat block {dtype}")


@pytest.mark.parametrize("c_in,c_out,k,t,use_norm", [
    (24, 24, 3, 6, True),
    (96, 80, 5, 4, False),
])
def test_flat_block_matches_plain_route_at_f32(c_in, c_out, k, t, use_norm):
    """At f32 the flat rounding points vanish: the block equals the plain
    route (``xla_block_apply``'s twin), here at a width the TPU kernel
    would not take (H, W not multiples of 8)."""
    p, s = block_params(c_in, c_out, k, t, use_norm, seed=3)
    x = torch.from_numpy(np.random.default_rng(3).normal(
        0, 1, (2, 11, 13, c_in)).astype(np.float32))
    out = pflat.flat_block_apply(to_port(p), x, k, t, stats=to_port(s),
                                 dtype=torch.float32)
    ref = plain_block_apply(to_port(p), x, k, 1, t, stats=to_port(s),
                            dtype=torch.float32)
    assert_close(out, ref, 1e-5, "flat block vs plain route")


def test_cpu_tensor_takes_the_plain_twin():
    p, s = block_params(16, 16, 3, 6, True, seed=1)
    w_exp, b_exp, w_dw, b_dw, w_proj, pb = block_weights(to_port(p), True,
                                                          to_port(s))
    args = (torch.randn(1, 8, 8, 16, generator=torch.Generator().manual_seed(1)),
            w_exp, w_dw, to_port(p)["SELayer_0"], w_proj, 3)
    kw = dict(b_expand=b_exp, b_dw=b_dw, proj_bias=pb, identity=True)
    before = dict(LAUNCHES)
    out = flat_block(*args, **kw)
    ref = flat_block_reference(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert LAUNCHES == before


def test_other_devices_raise():
    p, _ = block_params(16, 16, 3, 6, False, seed=2)
    w_exp, _, w_dw, _, w_proj, _ = block_weights(to_port(p), True)
    x = torch.empty(1, 8, 8, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flat_block(x, w_exp, w_dw, to_port(p)["SELayer_0"], w_proj, 3)
