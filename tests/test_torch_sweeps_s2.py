"""The rounding ``flat_s2_block``'s sweep 1 relies on, against the TPU
kernel.

``csrc/flat_s2.cu`` expands each 8x16 output tile's input halo (rounded to
the I/O dtype: the flat rounding), then sums each output's k*k stride-2
taps in row-major order (row di, then column dj), one fmaf each; sweep 2 is
``gate_project``.  Neither runs here (no GPU), so this test emulates both in
torch (float32, each fmaf rounded once) and holds the emulation against
``_flat_s2_kernel`` (``flat_s2_expand_dw_project``) in interpret mode, at
an input of 20 x 256 (output 10 x 128: a partial 8-row tile; the TPU kernel
takes output widths of 128) and E = 48 (a partial 32-channel chunk).
Tolerances: one bf16 ulp of the largest value at bf16 (each output is
rounded once from f32 sums taken in another order), 1e-5 of it at f32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arbitrarystyletransfer_tpu.ops.pallas import flatblock_s2 as js2

from arbitrarystyletransfer_tpu_torch.ops.basic import hardswish, se_gate
from arbitrarystyletransfer_tpu_torch.ops.kernels.flat_s2 import (
    flat_s2_block_reference,
)

from test_torch_ops import assert_close
from test_torch_sweeps import (
    BF16_ULP,
    E,
    emulate_sweep2,
    fmaf,
    j,
    reflect,
)

H, W = 20, 256


def emulate_s2_sweep1(x, we, wd, k, be=None, bd=None):
    """(hidden, sums) as flat_s2.cu's sweep 1 computes them: the expand in
    f32 (exact products of the I/O dtype's values), its bias and hswish,
    rounded to x's dtype; the reflect-indexed halo; each output's k*k
    stride-2 taps in row-major order, one fmaf each; its bias and hswish;
    the hidden rounded; the sums of the rounded hidden."""
    dt = x.dtype
    n, h, w, _ = x.shape
    p = (k - 1) // 2
    ex = x.float() @ we.to(dt).float()
    if be is not None:
        ex = ex + be
    ex = hardswish(ex).to(dt).float()
    ho, wo = h // 2, w // 2
    rows = reflect(np.arange(-p, h + p), h)
    cols = reflect(np.arange(-p, w + p), w)
    exp = ex[:, rows][:, :, cols]
    wdf = wd.float()
    acc = torch.zeros(n, ho, wo, ex.shape[-1])
    for di in range(k):
        for dj in range(k):
            acc = fmaf(exp[:, di:di + 2 * ho:2, dj:dj + 2 * wo:2],
                       wdf[di, dj], acc)
    if bd is not None:
        acc = acc + bd
    hidden = hardswish(acc).to(dt)
    return hidden, hidden.float().double().sum((1, 2)).float()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("c_in,k", [(16, 3), (16, 5), (24, 3), (24, 5)])
def test_s2_emulation_matches_flat_s2_kernel(c_in, k, dtype):
    """Sweep 1 of the stride-2 block, emulated, and sweep 2, against
    ``_flat_s2_kernel`` in interpret mode: the whole block's y."""
    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(c_in * 10 + k)

    def rand(*shape, scale=1.0):
        return torch.from_numpy(rng.normal(0, scale, shape).astype(np.float32))

    s, c_out = 16, 24
    x = rand(2, H, W, c_in).to(tdt)
    we, wd = rand(c_in, E, scale=c_in ** -0.5), rand(k, k, E, scale=1.0 / k)
    se = {"Dense_0": {"kernel": rand(E, s, scale=E ** -0.5),
                      "bias": rand(s, scale=0.1)},
          "Dense_1": {"kernel": rand(s, E, scale=s ** -0.5),
                      "bias": 0.5 + rand(E, scale=0.1)}}
    wp = rand(E, c_out, scale=E ** -0.5)
    be, bd, pb = rand(E, scale=0.1), rand(E, scale=0.1), rand(c_out, scale=0.1)
    hidden, sums = emulate_s2_sweep1(x, we, wd, k, be, bd)
    if tdt == torch.bfloat16:
        y = emulate_sweep2(hidden, sums, se, wp, pb)
    else:  # the packed product is bf16 only; at f32 the gate is f32
        gate = se_gate(sums, (H // 2) * (W // 2), se)
        y = (hidden * gate[:, None, None, :]) @ wp + pb
    jdt = getattr(jnp, dtype)
    xf = jnp.asarray(x.float().numpy()).astype(jdt)
    xf = jnp.transpose(xf, (0, 3, 1, 2)).reshape(2, c_in, H * W)
    ref = js2.flat_s2_expand_dw_project(
        xf, j(we).astype(jdt), j(wd), j(se), j(wp).astype(jdt), k, H,
        b_expand=j(be), b_dw=j(bd), proj_bias=j(pb), interpret=True)
    ref = np.asarray(jnp.asarray(ref, jnp.float32)).reshape(
        2, c_out, H // 2, W // 2).transpose(0, 2, 3, 1)
    rel = BF16_ULP if tdt == torch.bfloat16 else 1e-5
    assert_close(y.float().numpy(), ref, rel, f"s2 y c_in={c_in} k={k}")
    # The plain twin, which holds the kernel on the card, agrees.
    twin, twin_sums = flat_s2_block_reference(x, we, wd, se, wp, k,
                                              b_expand=be, b_dw=bd,
                                              proj_bias=pb)
    assert_close(y.float().numpy(), twin.float().numpy(), rel, "twin y")
    assert_close(sums.numpy(), twin_sums.numpy(), 1e-5, "twin sums")
