"""Kernel 1 (expand_dw): its plain twin against the TPU kernel.

``expand_dw_reference`` is held against the Pallas ``fused_expand_dw`` run
in interpret mode on the CPU, and the port's ``fused_block_apply`` against
JAX's, at float32.  On a CPU tensor the wrapper takes the twin and launches
nothing; the CUDA kernel itself is checked on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arbitrarystyletransfer_tpu.ops.pallas import fused_block as jfb

from arbitrarystyletransfer_tpu_torch.ops import fused_block as pfb
from arbitrarystyletransfer_tpu_torch.ops.kernels import LAUNCHES
from arbitrarystyletransfer_tpu_torch.ops.kernels.expand_dw import (
    expand_dw,
    expand_dw_reference,
)

from test_torch_ops import assert_close, block_params, to_jax, to_port


@pytest.mark.parametrize(
    "h,w,c_in,e,k,expand,biases",
    [
        (16, 16, 8, 48, 3, True, False),
        (16, 16, 8, 48, 5, True, True),
        (13, 10, 8, 24, 3, True, True),    # H, W not multiples of 8
        (9, 11, 16, 16, 5, False, False),  # expand==1
        (12, 12, 16, 16, 3, False, True),  # expand==1 with biases
    ],
)
def test_reference_matches_pallas_kernel(h, w, c_in, e, k, expand, biases):
    rng = np.random.default_rng(k + e)
    x = rng.normal(0, 1, (2, h, w, c_in)).astype(np.float32)
    we = rng.normal(0, 0.3, (c_in, e)).astype(np.float32) if expand else None
    wd = rng.normal(0, 0.3, (k, k, e)).astype(np.float32)
    be = rng.normal(0, 0.2, (e,)).astype(np.float32) if biases else None
    bd = rng.normal(0, 0.2, (e,)).astype(np.float32) if biases else None

    def t(a):
        return None if a is None else torch.from_numpy(a)

    def j(a):
        return None if a is None else jnp.asarray(a)

    hidden, sums = expand_dw(t(x), t(we), t(wd), k, pre_act=expand,
                             b_expand=t(be), b_dw=t(bd))
    ref_h, ref_s = jfb.fused_expand_dw(
        j(x), j(we), j(wd), k, pre_act=expand, interpret=True,
        b_expand=j(be), b_dw=j(bd))
    # The TPU hidden is zero-padded to its channel chunk; the port's is not.
    assert hidden.shape == (2, h, w, e)
    # f32 both sides; the sums over H*W pixels round in another order.
    assert_close(hidden, np.asarray(ref_h)[..., :e], 1e-5, "hidden")
    assert_close(sums, np.asarray(ref_s)[:, :e], 1e-5, "sums")


@pytest.mark.parametrize("c_in,c_out,k,t,use_norm", [
    (16, 16, 3, 6, True),    # e1: residual, folded BN biases
    (40, 24, 5, 6, False),   # d10: decoder, no biases
])
def test_fused_block_matches_jax(c_in, c_out, k, t, use_norm):
    p, s = block_params(c_in, c_out, k, t, use_norm, seed=k)
    x = np.random.default_rng(5).normal(0, 1, (2, 12, 12, c_in))
    x = x.astype(np.float32)
    out = pfb.fused_block_apply(to_port(p), torch.from_numpy(x), k, t,
                                stats=to_port(s), dtype=torch.float32)
    ref = jfb.fused_block_apply(to_jax(p), jnp.asarray(x), k, t,
                                stats=to_jax(s), interpret=True,
                                dtype=jnp.float32)
    assert_close(out, ref, 1e-5, "fused block")


def test_cpu_tensor_takes_the_plain_twin():
    before = dict(LAUNCHES)
    x = torch.randn(1, 8, 8, 4, generator=torch.Generator().manual_seed(0))
    we = torch.randn(4, 12)
    wd = torch.randn(3, 3, 12)
    out = expand_dw(x, we, wd, 3)
    ref = expand_dw_reference(x, we, wd, 3)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert LAUNCHES == before


def test_other_devices_raise():
    x = torch.empty(1, 8, 8, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        expand_dw(x, None, torch.empty(3, 3, 4, device="meta"), 3)


@pytest.mark.parametrize("h,t,min_fused,kernel", [
    (16, 6, 16, True),     # expand block at the threshold: kernel route
    (8, 6, 16, False),     # below it: plain route
    (16, 1, 16, False),    # expand==1: plain route
    (16, 1, 0, True),      # min_fused_size=0 forces the kernel route
])
def test_block_apply_routing(monkeypatch, h, t, min_fused, kernel):
    calls = []
    monkeypatch.setattr(pfb, "expand_dw",
                        lambda *a, **k: calls.append(1) or expand_dw(*a, **k))
    p, _ = block_params(16, 16, 3, t, use_norm=False)
    x = torch.randn(1, h, h, 16, generator=torch.Generator().manual_seed(1))
    pfb.block_apply(to_port(p), x, 3, t, dtype=torch.float32,
                    min_fused_size=min_fused)
    assert bool(calls) == kernel
