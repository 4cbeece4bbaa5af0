"""Kernels 8-9 (fused_sums, fused_project): their plain twins and the
two-pass block against the TPU kernel.

``fused_sums_reference`` and ``fused_project_reference`` are held against
the Pallas ``fused_expand_dw`` in modes "sums" and "project", and the port's
``fused_block_apply_2pass`` (on a CPU tensor the wrappers take the twins)
against JAX's, all in interpret mode on the CPU.  Tolerances: at float32
1e-5 of the largest value (sums in other orders); at bfloat16 one bf16 ulp of
it, since a value rounded once from f32 sums taken in different orders may
flip by one ulp.  The CUDA kernels themselves are checked on the card by
``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arbitrarystyletransfer_tpu.ops.pallas import fused_block as jfb

from arbitrarystyletransfer_tpu_torch.ops import fused_block as pfb
from arbitrarystyletransfer_tpu_torch.ops.basic import se_gate
from arbitrarystyletransfer_tpu_torch.ops.blocks import block_weights
from arbitrarystyletransfer_tpu_torch.ops.kernels import LAUNCHES
from arbitrarystyletransfer_tpu_torch.ops.kernels.flat_block import round_to
from arbitrarystyletransfer_tpu_torch.ops.kernels.fused_2pass import (
    _hidden_f32,
    fused_project,
    fused_project_reference,
    fused_sums,
    fused_sums_reference,
)

from test_torch_ops import assert_close, block_params, to_jax, to_port

BF16_ULP = 2.0 ** -7  # relative to the largest value
DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, BF16_ULP)}


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _x(c_in, seed, h=12, w=12):
    return np.random.default_rng(seed).normal(
        0, 1, (2, h, w, c_in)).astype(np.float32)


@pytest.mark.parametrize("c_in,c_out,k,t,use_norm,identity,dtype", [
    (16, 16, 3, 6, True, True, "float32"),     # e1: folded BN, residual
    (40, 24, 5, 6, False, True, "float32"),    # d10: no BN, no residual
    (16, 16, 3, 6, False, True, "float32"),    # residual in the kernel
    (16, 16, 3, 6, True, False, "float32"),    # residual switched off
    (16, 16, 3, 1, True, True, "float32"),     # expand==1
    (16, 16, 3, 6, True, True, "bfloat16"),    # bias added after rounding
    (16, 16, 3, 6, False, True, "bfloat16"),   # residual in the kernel
    (40, 24, 5, 6, False, True, "bfloat16"),
    # an odd C_out past C_in 48 (the tile design's CUDA-core projection,
    # its outputs in registers, on the card)
    (56, 13, 3, 6, False, False, "bfloat16"),
])
def test_two_pass_block_matches_jax(c_in, c_out, k, t, use_norm, identity,
                                    dtype):
    tdt, jdt, rel = DTYPES[dtype]
    p, s = block_params(c_in, c_out, k, t, use_norm, seed=k + t + c_in)
    x = _x(c_in, seed=k)
    out = pfb.fused_block_apply_2pass(to_port(p), torch.from_numpy(x), k, t,
                                      use_identity=identity,
                                      stats=to_port(s), dtype=tdt)
    ref = jfb.fused_block_apply_2pass(to_jax(p), jnp.asarray(x), k, t,
                                      use_identity=identity, stats=to_jax(s),
                                      interpret=True, dtype=jdt)
    assert out.dtype == tdt and out.shape == (2, 12, 12, c_out)
    assert_close(_np(out), _np(ref), rel, f"two-pass block {dtype}")


def _kernel_args(c_in, e, k, expand, biases, seed):
    rng = np.random.default_rng(seed)
    we = rng.normal(0, 0.3, (c_in, e)).astype(np.float32) if expand else None
    wd = rng.normal(0, 0.3, (k, k, e)).astype(np.float32)
    be = rng.normal(0, 0.2, (e,)).astype(np.float32) if biases else None
    bd = rng.normal(0, 0.2, (e,)).astype(np.float32) if biases else None
    return we, wd, be, bd


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("c_in,e,k,expand,biases", [
    (8, 48, 3, True, True),
    (8, 24, 5, True, False),
    (16, 16, 3, False, True),  # expand==1
])
def test_sums_twin_matches_pallas_sums_mode(c_in, e, k, expand, biases):
    we, wd, be, bd = _kernel_args(c_in, e, k, expand, biases, seed=e + k)
    x = _x(c_in, seed=e, h=13, w=10)
    sums = fused_sums(_t(x), _t(we), _t(wd), k, pre_act=expand,
                      b_expand=_t(be), b_dw=_t(bd))
    ref = jfb.fused_expand_dw(_j(x), _j(we), _j(wd), k, pre_act=expand,
                              interpret=True, b_expand=_j(be), b_dw=_j(bd),
                              mode="sums")
    assert sums.shape == (2, e)
    assert_close(sums, np.asarray(ref)[:, :e], 1e-5, "sums")


# (C_in, E, C_out, k, H = W) of the project-mode cases; the last ones are
# the shapes the CUDA kernels' tiling must get right: E not a multiple of
# the 32-channel chunk, an odd C_out (the tile design's CUDA-core
# projection), and 37 x 37 at k5 (partial 16 x 16 tiles, reflected edges).
SMALL = (16, 64, 16, 3, 12)


@pytest.mark.parametrize("dtype,identity,expand,shape", [
    pytest.param("float32", True, True, SMALL, id="float32-True-True"),
    pytest.param("bfloat16", True, True, SMALL, id="bfloat16-True-True"),
    pytest.param("bfloat16", False, True, SMALL, id="bfloat16-False-True"),
    pytest.param("float32", True, False, (16, 16, 16, 3, 12),  # expand==1
                 id="float32-True-False"),
    pytest.param("bfloat16", False, True, (16, 48, 24, 3, 12),
                 id="bfloat16-e48"),
    pytest.param("bfloat16", False, True, (16, 64, 13, 3, 12),
                 id="bfloat16-cout13"),
    pytest.param("bfloat16", True, True, (40, 48, 40, 5, 37),
                 id="bfloat16-hw37-k5"),
    pytest.param("float32", False, True, (40, 48, 24, 5, 37),
                 id="float32-hw37-k5"),
])
def test_project_twin_matches_pallas_project_mode(dtype, identity, expand,
                                                  shape):
    tdt, jdt, rel = DTYPES[dtype]
    c_in, e, c_out, k, hw = shape
    we, wd, be, bd = _kernel_args(c_in, e, k, expand, True, seed=9)
    rng = np.random.default_rng(10)
    gate = rng.uniform(0, 1, (2, e)).astype(np.float32)
    wp = rng.normal(0, 0.2, (e, c_out)).astype(np.float32)
    x = _x(c_in, seed=11, h=hw, w=hw)
    y = fused_project(torch.from_numpy(x).to(tdt), _t(we), _t(wd), k,
                      torch.from_numpy(gate), torch.from_numpy(wp),
                      pre_act=expand, b_expand=_t(be), b_dw=_t(bd),
                      identity=identity)
    ref = jfb.fused_expand_dw(jnp.asarray(x, jdt), _j(we), _j(wd), k,
                              pre_act=expand, interpret=True,
                              b_expand=_j(be), b_dw=_j(bd), mode="project",
                              gate=jnp.asarray(gate), w_proj=jnp.asarray(wp),
                              identity=identity)
    assert y.dtype == tdt and y.shape == (2, hw, hw, c_out)
    assert_close(_np(y), _np(ref), rel, f"project {dtype}")


def test_bias_is_added_after_the_rounding():
    """With a folded projection bias JAX rounds the projection, adds the
    bias in f32 and rounds again.  At bf16 the port agrees with it on
    almost every element; a twin that adds the bias before the one rounding
    (as the fused route does) differs on many."""
    p, s = block_params(16, 16, 3, 6, True, seed=12)
    x = _x(16, seed=12)
    xb = torch.from_numpy(x).bfloat16()
    out = pfb.fused_block_apply_2pass(to_port(p), xb, 3, 6, stats=to_port(s),
                                      dtype=torch.bfloat16)
    ref = _np(jfb.fused_block_apply_2pass(
        to_jax(p), jnp.asarray(x), 3, 6, stats=to_jax(s), interpret=True,
        dtype=jnp.bfloat16))

    w_exp, b_exp, w_dw, b_dw, w_proj, pb = block_weights(to_port(p), True,
                                                         to_port(s))
    out_f = _hidden_f32(xb, w_exp, w_dw, 3, True, b_exp, b_dw)
    gate = se_gate(out_f.sum(dim=(1, 2)), 144, to_port(p)["SELayer_0"])
    dt = torch.bfloat16
    gated = round_to(round_to(out_f, dt) * round_to(gate, dt)[:, None, None],
                     dt)
    once = ((gated @ round_to(w_proj, dt) + pb).to(dt) + xb)

    def differs(a):
        return float(np.mean(_np(a) != ref))

    assert differs(out) < 0.02
    assert differs(once) > 0.1


def test_cpu_tensors_take_the_plain_twins():
    we, wd, be, bd = map(_t, _kernel_args(4, 12, 3, True, True, seed=13))
    x = torch.randn(1, 8, 8, 4, generator=torch.Generator().manual_seed(13))
    gate = torch.rand(1, 12, generator=torch.Generator().manual_seed(14))
    wp = torch.randn(12, 4, generator=torch.Generator().manual_seed(15))
    before = dict(LAUNCHES)
    assert torch.equal(fused_sums(x, we, wd, 3, b_expand=be, b_dw=bd),
                       fused_sums_reference(x, we, wd, 3, b_expand=be,
                                            b_dw=bd))
    assert torch.equal(
        fused_project(x, we, wd, 3, gate, wp, identity=True),
        fused_project_reference(x, we, wd, 3, gate, wp, identity=True))
    assert LAUNCHES == before


def test_other_devices_raise():
    x = torch.empty(1, 8, 8, 4, device="meta")
    wd = torch.empty(3, 3, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_sums(x, None, wd, 3)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_project(x, None, wd, 3, torch.empty(1, 4, device="meta"),
                      torch.empty(4, 4, device="meta"))
