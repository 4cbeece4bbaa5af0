"""Kernel 7 (mega_block) and the "mega" route against the JAX package.

The port's ``mega_block_apply_t`` (on a CPU tensor the ``mega_block``
wrapper takes ``mega_block_reference``) is held against JAX's
``megablock.mega_block_apply_t``, whose Pallas ``_mega_kernel_t`` runs in
interpret mode on the CPU, on (B, H, C, W) inputs at the shapes of
``tests/test_megablock.py``.  Tolerances: at float32 1e-5 of the largest
value (sums in other orders); at bfloat16 one bf16 ulp of it, since a value
rounded once from f32 sums taken in different orders may flip by one ulp.

The route tests check which blocks the chains send to the kernel (against
JAX's chains, traced with recording stubs under ``jax.eval_shape``) and the
whole route at 64px, with ``lane=16`` so that the blocks route as at 512px,
against the flax graph ``AST.stylize``.  The CUDA kernel itself is checked
on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arbitrarystyletransfer_tpu import config as jax_config
from arbitrarystyletransfer_tpu.ops.pallas import fused_block as jfb
from arbitrarystyletransfer_tpu.ops.pallas import megablock as jmega

from arbitrarystyletransfer_tpu_torch import ModelConfig, engine, weights
from arbitrarystyletransfer_tpu_torch.ops import blocks
from arbitrarystyletransfer_tpu_torch.ops import fused_block as pfb
from arbitrarystyletransfer_tpu_torch.ops import megablock as pmega
from arbitrarystyletransfer_tpu_torch.ops.kernels import LAUNCHES
from arbitrarystyletransfer_tpu_torch.ops.kernels.mega_block import (
    mega_block,
    mega_block_reference,
)

from test_torch_engine import _flax_stylize, _images, _normalize_head
from test_torch_ops import (
    assert_close,
    ast_variables,
    block_params,
    to_jax,
    to_port,
)

BF16_ULP = 2.0 ** -7  # relative to the largest value
DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, BF16_ULP)}
CFG = ModelConfig(encoder_eval_stats=True, use_pallas_adaattn=True)
JCFG = jax_config.ModelConfig(encoder_eval_stats=True)
MIN_FUSED = 16  # 64px / 8: the 512px routing (MIN_FUSED_SIZE 128) at 1/8
LANE = 16       # the lane rule (128 at 512px) at 1/8

# (c_in, c_out, k, t, H, W, use_norm): tests/test_megablock.py's CASES.
CASES = [
    (16, 16, 3, 6, 24, 128, False),   # identity path
    (40, 24, 5, 6, 24, 128, False),   # k5, c_out != c_in
    (24, 24, 3, 1, 33, 128, False),   # expand==1, odd H (tail masking)
    (40, 40, 5, 4, 24, 256, True),    # folded BN, W=256
    (16, 8, 3, 6, 16, 128, True),     # c_out not a multiple of 16
    (8, 16, 3, 3, 9, 128, True),      # H below the TPU row group
]


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _block_and_input(case, seed=0):
    c_in, c_out, k, t, h, w, use_norm = case
    p, s = block_params(c_in, c_out, k, t, use_norm, seed=seed + k + t)
    xt = np.random.default_rng(seed + h).normal(0, 1, (2, h, c_in, w))
    return p, s, xt.astype(np.float32)


def _case_id(c):
    return f"{c[0]}-{c[1]}k{c[2]}t{c[3]}_{c[4]}x{c[5]}{'n' if c[6] else ''}"


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_mega_block_matches_pallas_kernel_f32(case):
    c_in, c_out, k, t, h, w, _ = case
    p, s, xt = _block_and_input(case)
    out = pmega.mega_block_apply_t(to_port(p), torch.from_numpy(xt), k, t,
                                   stats=to_port(s))
    ref = jmega.mega_block_apply_t(to_jax(p), jnp.asarray(xt), k, t,
                                   stats=to_jax(s), interpret=True)
    assert out.dtype == torch.float32 and out.shape == (2, h, c_out, w)
    assert_close(out, ref, 1e-5, "mega block f32")


@pytest.mark.parametrize("case", [CASES[0], CASES[1]], ids=_case_id)
def test_mega_block_matches_pallas_kernel_bf16(case):
    k, t = case[2], case[3]
    p, s, xt = _block_and_input(case, seed=1)
    x16 = torch.from_numpy(xt).bfloat16()
    out = pmega.mega_block_apply_t(to_port(p), x16, k, t, stats=to_port(s))
    ref = jmega.mega_block_apply_t(to_jax(p), jnp.asarray(xt, jnp.bfloat16),
                                   k, t, stats=to_jax(s), interpret=True)
    assert out.dtype == torch.bfloat16
    assert_close(_np(out), _np(ref), BF16_ULP, "mega block bf16")


def test_mega_block_matches_the_hbm_hidden_mode():
    """The TPU kernel's non-resident mode (the hidden through HBM, which
    the CUDA kernel takes) gives the same block."""
    case = (24, 24, 3, 6, 32, 128, True)
    p, s, xt = _block_and_input(case, seed=2)
    out = pmega.mega_block_apply_t(to_port(p), torch.from_numpy(xt), 3, 6,
                                   stats=to_port(s))
    ref = jmega.mega_block_apply_t(to_jax(p), jnp.asarray(xt), 3, 6,
                                   stats=to_jax(s), interpret=True,
                                   row_group=8, force_resident=False)
    assert_close(out, ref, 1e-5, "mega block, HBM hidden")


def test_nhwc_wrapper_matches_jax():
    case = (16, 16, 3, 6, 16, 128, True)
    p, s, xt = _block_and_input(case, seed=3)
    x = np.ascontiguousarray(xt.transpose(0, 1, 3, 2))
    out = pmega.mega_block_apply(to_port(p), torch.from_numpy(x), 3, 6,
                                 stats=to_port(s), dtype=torch.float32)
    ref = jmega.mega_block_apply(to_jax(p), jnp.asarray(x), 3, 6,
                                 stats=to_jax(s), interpret=True,
                                 dtype=jnp.float32)
    assert out.shape == (2, 16, 128, 16)
    assert_close(out, ref, 1e-5, "mega block NHWC")


def test_mega_rounding_points():
    """At bf16 the twin keeps the expanded values in f32 (``_mega_kernel_t``)
    and sums the rounded hidden; rounding ``ex`` instead (the flat kernel's
    rounding) gives another block."""
    from arbitrarystyletransfer_tpu_torch.ops.kernels.flat_block import (
        flat_block_reference,
    )

    p, _ = block_params(16, 24, 3, 6, False, seed=4)
    w_exp, _, w_dw, _, w_proj, _ = blocks.block_weights(to_port(p), True)
    xt = torch.from_numpy(np.random.default_rng(4).normal(
        0, 1, (2, 16, 16, 128)).astype(np.float32)).bfloat16()
    args = (w_exp, w_dw, to_port(p)["SELayer_0"], w_proj, 3)
    y, sums = mega_block_reference(xt, *args)
    y_flat, sums_flat = flat_block_reference(xt.permute(0, 1, 3, 2), *args)
    ref = jmega.mega_block_apply_t(
        to_jax(p), jnp.asarray(_np(xt), jnp.bfloat16), 3, 6, interpret=True)
    assert_close(_np(y), _np(ref), BF16_ULP, "mega rounding")
    assert np.abs(_np(y_flat.permute(0, 1, 3, 2)) - _np(y)).max() > 0
    assert float((sums - sums_flat).abs().max()) > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_upsample_smooth_transposed_equals_nhwc(dtype):
    tdt, _, rel = DTYPES[dtype]
    p, _ = block_params(40, 40, 3, 1, use_norm=False, seed=5)
    x = torch.from_numpy(np.random.default_rng(5).normal(
        0, 1, (2, 7, 9, 40)).astype(np.float32))
    ref = blocks.upsample_smooth_apply(to_port(p), x, dtype=tdt)
    out = pmega.upsample_smooth_apply_t(to_port(p), pmega.to_t(x), dtype=tdt)
    assert out.shape == (2, 14, 40, 18) and out.dtype == tdt
    assert_close(_np(pmega.from_t(out)), _np(ref), rel, "upsample+smooth")


def test_cpu_tensor_takes_the_plain_twin():
    p, s = block_params(16, 16, 3, 6, True, seed=6)
    w_exp, b_exp, w_dw, b_dw, w_proj, pb = blocks.block_weights(
        to_port(p), True, to_port(s))
    xt = torch.randn(1, 8, 16, 8, generator=torch.Generator().manual_seed(6))
    args = (xt, w_exp, w_dw, to_port(p)["SELayer_0"], w_proj, 3)
    kw = dict(b_expand=b_exp, b_dw=b_dw, proj_bias=pb, identity=True)
    before = dict(LAUNCHES)
    out = mega_block(*args, **kw)
    ref = mega_block_reference(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert LAUNCHES == before


def test_other_devices_raise():
    p, _ = block_params(16, 16, 3, 6, False, seed=7)
    w_exp, _, w_dw, _, w_proj, _ = blocks.block_weights(to_port(p), True)
    xt = torch.empty(1, 8, 16, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        mega_block(xt, w_exp, w_dw, to_port(p)["SELayer_0"], w_proj, 3)


# -- the route plan ----------------------------------------------------------


def _c_out(params, t):
    return params["Conv_1" if t != 1 else "Conv_0"]["kernel"].shape[-1]


def _jax_plan(monkeypatch, size):
    """(kernel, H) of every block JAX's chains send to the mega kernel or to
    ``block_apply`` at ``size``, traced with recording stubs."""
    calls = []

    def mega(params, xt, k, t, stats=None, interpret=False, **_):
        calls.append(("mega", xt.shape[1]))
        return jnp.zeros(xt.shape[:2] + (_c_out(params, t), xt.shape[3]),
                         xt.dtype)

    def fused(params, x, k, t, stats=None, interpret=False,
              dtype=jnp.bfloat16, **_):
        calls.append(("block_apply", x.shape[1]))
        return jnp.zeros(x.shape[:3] + (_c_out(params, t),), dtype)

    monkeypatch.setattr(jmega, "mega_block_apply_t", mega)
    monkeypatch.setattr(jfb, "block_apply", fused)
    v = ast_variables(seed=0)
    enc = (to_jax(v["params"]["enc"]), to_jax(v["batch_stats"]["enc"]))
    jax.eval_shape(
        lambda x: jmega.encode_mega(*enc, x, JCFG.enc_conv_shapes,
                                    JCFG.enc_out_layers,
                                    expand_ratio=JCFG.expand_ratio),
        jax.ShapeDtypeStruct((1, size, size, 3), jnp.float32))
    c = JCFG.decoder_conv_shapes[0][0]
    jax.eval_shape(
        lambda z: jmega.decode_mega(to_jax(v["params"]["dec"]), z,
                                    JCFG.decoder_conv_shapes),
        jax.ShapeDtypeStruct((1, size // 8, size // 8, c), jnp.bfloat16))
    return calls


def _port_plan(monkeypatch, size, lane=pmega.LANE, min_fused_size=128):
    """The same for the port's chains, run on the meta device (shapes only)
    through the engine, with recording stubs for the two block calls."""
    calls = []

    def mega(params, xt, k, t, use_identity=True, stats=None):
        calls.append(("mega", xt.shape[1]))
        return torch.empty(xt.shape[:2] + (_c_out(params, t), xt.shape[3]),
                           dtype=xt.dtype, device=xt.device)

    def fused(params, x, k, t, stats=None, dtype=torch.bfloat16, **_):
        calls.append(("block_apply", x.shape[1]))
        return torch.empty(x.shape[:3] + (_c_out(params, t),), dtype=dtype,
                           device=x.device)

    monkeypatch.setattr(pmega, "mega_block_apply_t", mega)
    monkeypatch.setattr(pmega, "block_apply", fused)
    state = weights.to_device(
        weights.init_params(CFG, torch.Generator().manual_seed(0)), "meta")
    params, stats = state["params"], state["batch_stats"]
    x = torch.empty(1, size, size, 3, device="meta")
    pmega.encode_mega(params["enc"], stats["enc"], x, CFG.enc_conv_shapes,
                      CFG.enc_out_layers, expand_ratio=CFG.expand_ratio,
                      min_mega_size=2 * lane, lane=lane,
                      min_fused_size=min_fused_size)
    z = torch.empty(1, size // 8, size // 8, CFG.decoder_conv_shapes[0][0],
                    dtype=torch.bfloat16, device="meta")
    pmega.decode_mega(params["dec"], z, CFG.decoder_conv_shapes,
                      min_mega_w=lane, lane=lane)
    return calls


@pytest.mark.parametrize("size,n_mega", [(512, 13), (320, 0), (256, 10)])
def test_mega_plan_matches_jax(monkeypatch, size, n_mega):
    ours = _port_plan(monkeypatch, size)
    theirs = _jax_plan(monkeypatch, size)
    assert ours == theirs
    assert sum(kind == "mega" for kind, _ in ours) == n_mega


def test_mega_plan_at_64px_with_lane_16_equals_512px(monkeypatch):
    small = _port_plan(monkeypatch, 64, lane=LANE, min_fused_size=MIN_FUSED)
    full = _port_plan(monkeypatch, 512)
    assert [kind for kind, _ in small] == [kind for kind, _ in full]
    assert [h * 8 for _, h in small] == [h for _, h in full]


def test_mega_route_kernel_calls(monkeypatch):
    """At 1/8 of the 512px size, lane and threshold, the route calls each
    kernel wrapper as often as a 512px request does: 13 mega_block (e1, e3,
    d3-d13) and 2 expand_dw (e5, e6)."""
    calls = {"mega": 0, "fused": 0}

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(pmega, "mega_block", counted("mega", pmega.mega_block))
    monkeypatch.setattr(pfb, "expand_dw", counted("fused", pfb.expand_dw))
    content, style = map(torch.from_numpy, _images(11, b=1))
    state = weights.init_params(CFG, torch.Generator().manual_seed(0))
    engine.stylize_fused(state, content, style, cfg=CFG, dtype=torch.float32,
                         min_fused_size=MIN_FUSED, encoder_impl="mega",
                         decoder_impl="mega", lane=LANE)
    assert calls == {"mega": 13, "fused": 2}


# -- the whole route ---------------------------------------------------------


@pytest.mark.parametrize("encoder_impl,decoder_impl", [
    ("mega", "mega"),
    ("mega", "flat-all"),
    ("flat-all", "mega"),
])
def test_mega_route_matches_flax_graph(encoder_impl, decoder_impl):
    content, style = _images(12)
    alpha = 0.6
    v = ast_variables(seed=12)
    _normalize_head(v, content, style, alpha)
    state = weights.from_jax_tree(v["params"], v["batch_stats"])
    out = engine.stylize_fused(
        state, torch.from_numpy(content), torch.from_numpy(style), alpha,
        cfg=CFG, dtype=torch.float32, min_fused_size=MIN_FUSED,
        encoder_impl=encoder_impl, decoder_impl=decoder_impl,
        lane=LANE).numpy()
    ref = np.asarray(_flax_stylize()(to_jax(v), jnp.asarray(content),
                                     jnp.asarray(style), alpha))
    assert out.shape == (2, 64, 64, 3) and np.isfinite(out).all()
    saturated = np.mean((out == 0.0) | (out == 1.0))
    assert saturated < 0.5, f"{saturated:.0%} of the image is clamped"
    # f32 through ~35 blocks and a peaked softmax, sums in other orders.
    assert_close(out, ref, 1e-4, f"stylized image, {encoder_impl}/"
                                 f"{decoder_impl}")
