"""Every image size the stylize CLI takes, on the CPU: the block shapes that
1024px and up give the kernels, the plans at sizes off the 128-pixel grid,
and the one-tap AdaAttN of the engine.

- ``ada_out`` (C_in 256, E 768, k3, C_out 128) reaches ``expand_dw`` from
  1024px, whose x box the kernel now stages in channel chunks: the twin at
  that shape against JAX ``fused_block_apply`` in interpret mode.
- ``ops/kernels/limits.py`` mirrors the kernels' shared-memory arithmetic:
  every block of the full-width model that a route sends to a kernel
  passes its check at 256-2048px, and the shapes past the limits raise
  ``ValueError`` naming them, before any launch.  Its mirror of sweep 2's
  choice (``sweep2_staging``) sends every block of the model, bf16 and
  f32, to a designed kernel, and only off-model shapes to the CUDA-core
  ``gate_project_generic``.
- ``planned_chains`` at 720px and 1024px against JAX's, plans only, and
  ``planned_launches`` of "fused" and "mega" against the engine's calls
  (the card's ``chip_smoke.py`` ``sizes`` phase checks each request's
  launches against it).
- ``engine.adaattn_apply`` against JAX's, with the kernel's twin and with
  the plain statistics.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from arbitrarystyletransfer_tpu import config as jax_config
from arbitrarystyletransfer_tpu import engine as jengine
from arbitrarystyletransfer_tpu.ops.pallas import flatblock as jflat
from arbitrarystyletransfer_tpu.ops.pallas import fused_block as jfb
from arbitrarystyletransfer_tpu.ops.pallas import policy as jpolicy

from arbitrarystyletransfer_tpu_torch import ModelConfig, engine, weights
from arbitrarystyletransfer_tpu_torch.ops import flatblock as pflat
from arbitrarystyletransfer_tpu_torch.ops import fused_block as pfb
from arbitrarystyletransfer_tpu_torch.ops import megablock as pmega
from arbitrarystyletransfer_tpu_torch.ops import policy as ppolicy
from arbitrarystyletransfer_tpu_torch.ops.kernels import limits
from arbitrarystyletransfer_tpu_torch.scripts.autotune_blocks import (
    enumerate_blocks,
)

from test_torch_ops import assert_close, ast_variables, block_params
from test_torch_ops import to_jax, to_port

CFG = ModelConfig()
JCFG = jax_config.ModelConfig()
BF16_ULP = 2.0 ** -7  # the sweeps' tests' bf16 bound: one ulp of the max
ADA_OUT = (2 * CFG.enc_out_channels, CFG.enc_out_channels, 3,
           CFG.expand_ratio)  # C_in, C_out, k, t
CLI_SIZES = (256, 320, 512, 720, 1024, 2048)
PLAN_SIZES = (720, 1024)
FLAT_IMPLS = ("flat", "flat-all", "auto")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ada_out_block_matches_jax(dtype):
    """The ada_out block through the kernel route (``min_fused_size=0``:
    the twin of ``expand_dw`` and the epilogue) against JAX's kernel route
    in interpret mode at 8 x 8, as it runs from 1024px."""
    c_in, c_out, k, t = ADA_OUT
    p, _ = block_params(c_in, c_out, k, t, use_norm=False, seed=17)
    x = np.random.default_rng(17).normal(0, 1, (2, 8, 8, c_in))
    x = x.astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    out = pfb.block_apply(to_port(p), torch.from_numpy(x), k, t,
                          use_identity=False, dtype=tdt, min_fused_size=0)
    assert pfb.takes_kernel(t, 8, 0)
    ref = jfb.fused_block_apply(to_jax(p), jnp.asarray(x), k, t,
                                use_identity=False, interpret=True,
                                dtype=jdt)
    assert out.shape == (2, 8, 8, c_out) and out.dtype == tdt
    rel = BF16_ULP if dtype == "bfloat16" else 1e-5
    assert_close(out.float(), np.asarray(jnp.asarray(ref, jnp.float32)),
                 rel, f"ada_out {dtype}")


def _kernel_blocks(cfg, size):
    """(c_in, c_out, k, t) of every stride-1 expand block any route may
    send to a sweep-1 kernel at ``size`` (the tuner's walk: encoder,
    ada_out, decoder)."""
    return sorted({(c_in, c_out, k, t) for c_in, c_out, stride, k, t, _, _
                   in enumerate_blocks(cfg, size) if stride == 1 and t != 1})


@pytest.mark.parametrize("size", CLI_SIZES)
def test_every_block_passes_the_kernel_checks(size):
    """Every stride-1 expand block of the full-width model passes the
    NHWC sweep-1 check (expand_dw, flat_block, fused_sums) and the
    (N, H, C, W) one (mega_block, at widths that are multiples of 8 and
    not; every block but ada_out, which no mega chain runs); ada_out alone
    takes the channel chunks; every stride-2 block passes flat_s2_block's
    with its whole box; every block passes fused_project's (the two-pass
    block, on no route): up to C_out 96 on the persistent design, C_out
    128 on the tile design."""
    for c_in, c_out, k, t in _kernel_blocks(CFG, size):
        st = limits.check_sweep1("expand_dw", k, c_in)
        assert st["smem"] <= limits.SMEM_OPT_IN
        assert st["boxes"] == (4 if (c_in, c_out) == ADA_OUT[:2] else 1)
        assert max(st["box"]) <= limits.MAX_BOX
        if (c_in, c_out) != ADA_OUT[:2]:  # no mega chain has ada_out
            limits.check_sweep1("mega_block", k, c_in, "xt")
            limits.check_sweep1("mega_block", k, c_in, "xt_rows")
        st = limits.check_fused_project(k, c_in, c_out)
        want = "persistent" if c_out <= limits.WS_MAX_COUT else "tile"
        assert st["design"] == want, (c_in, c_out, k)
    for c_in, _, stride, k, _, _, _ in enumerate_blocks(CFG, size):
        if stride == 2:
            assert limits.check_flat_s2(k, c_in)["boxes"] == 1


def test_the_smem_mirror_matches_the_header_comments():
    """The layouts the kernels' sources state (expand_dw.cuh: ~100 KB at
    the k5 C_in-40 decoder shapes, 90.9 KB for kXSplit at k3 C_in 80;
    kCSplit at k3 C_in 256 108.0 KB, the whole box 264 channels and
    237.1 KB)."""
    assert limits.sweep1_staging(5, 40)["smem"] == 100872
    assert limits.sweep1_staging(3, 80, "xt")["smem"] == 90888
    whole = limits._edw_smem(3, 256, 0)
    assert whole["box"][0] == 264 and whole["smem"] == 237064
    assert limits.sweep1_staging(3, 256) == {
        "smem": 108040, "box": (72, 18, 18), "boxes": 4}
    # Two CTAs per SM need at most 115,712 bytes each.
    assert limits.sweep1_staging(3, 256)["smem"] <= 115712
    # flat_s2.cu: the whole box to C_in 144 (k3) and 112 (k5), then chunks
    # of 32 channels (the comment of s2_split); fused_project: ada_out's
    # C_in on the tile design in 4 chunks.
    assert limits.flat_s2_staging(3, 144)["boxes"] == 1
    assert limits.flat_s2_staging(3, 152)["boxes"] == 5
    assert limits.flat_s2_staging(5, 112)["boxes"] == 1
    assert limits.flat_s2_staging(5, 120)["boxes"] == 4
    st = limits.fused_project_staging(3, 256, 64)
    assert st["design"] == "tile" and st["boxes"] == 4


@pytest.mark.parametrize("call,match", [
    (lambda: limits.check_sweep1("expand_dw", 5, 1920), "shared memory"),
    (lambda: limits.check_sweep1("mega_block", 3, 520, "xt"), "TMA box"),
    (lambda: limits.check_flat_s2(5, 744), "shared memory"),
    (lambda: limits.check_fused_project(3, 1736, 64), "shared memory"),
    (lambda: limits.check_fused_project(3, 128, 129), "C_out 129 > 128"),
    # An odd C_out's CUDA-core projection beside the f32 CUDA-core expand
    # of C_in 1024 at k5: 233,744 bytes, past a CTA's shared memory (at
    # ada_out's C_in 256 it now fits: the outputs stay in registers).
    (lambda: limits.check_fused_project(5, 1024, 127, bf16=False,
                                        mma=False), "shared memory"),
    (lambda: limits.check_sweep1("expand_dw", 3, 1488, mma=False),
     "CUDA-core expand"),
])
def test_shapes_past_the_limits_raise(call, match):
    with pytest.raises(ValueError, match=match):
        call()


def test_the_mirror_counts_each_projection_and_expand():
    """``fused_project``'s tile design counts the projection it takes: a
    bf16 hidden chunk and W_p's rows at an even C_out (PMMA), the f32
    hidden and weights at an odd one or in f32, the weights 16-byte
    aligned and the outputs in registers (fused_2pass.cu's ``Smem``), for
    96 outputs up to C_out 96, else 128; the CUDA-core expand (f32, C_in %
    8 != 0, expand==1) keeps no x box and its expand weights in f32
    (expand_dw.cuh's ``Smem``); the persistent design with ``e`` counts
    every chunk's expand weights where they fit (``ws_resident``)."""
    whole = limits._edw_smem(3, 16, 0)["smem"]
    assert whole == 60424
    pmma = 256 * 40 * 2 + 96 * 40 * 2

    def f32(base, co=96):
        return -(-(base + 256 * 33 * 4) // 16) * 16 + 32 * co * 4

    st = limits.fused_project_staging(3, 16, 14)  # even, not % 8
    assert st["design"] == "tile" and st["smem"] == whole + pmma
    st = limits.fused_project_staging(3, 16, 13)
    assert st["design"] == "tile" and st["smem"] == f32(whole)
    st = limits.fused_project_staging(3, 16, 128)  # past the persistent's
    assert st["design"] == "tile"
    assert st["smem"] == whole + 256 * 40 * 2 + 128 * 40 * 2
    assert limits.fused_project_staging(3, 16, 127)["smem"] == \
        f32(whole, 128)
    assert limits.fused_project_staging(3, 48, 13)["smem"] <= 232448
    core = limits.sweep1_staging(3, 12, mma=False)
    assert core == {"smem": 324 * 128 + 12 * 128 + 1024 + 128 + 8 + 128,
                    "box": (), "boxes": 0}
    assert limits.sweep1_staging(3, 40, mma=False, expand=False)["smem"] \
        == 324 * 128 + 1288
    st = limits.fused_project_staging(3, 40, 40, bf16=False, mma=False)
    assert st["smem"] == f32(limits.sweep1_staging(3, 40, mma=False)["smem"])
    least = limits.fused_project_staging(3, 40, 40)
    full = limits.fused_project_staging(3, 40, 40, e=160)
    assert least["design"] == full["design"] == "persistent"
    assert full["smem"] - least["smem"] == 160 * 56 * 2 + 160 * 4
    # d3's weights (E 288) do not fit beside its slots: the least.
    assert limits.fused_project_staging(3, 96, 96, e=288) == \
        limits.fused_project_staging(3, 96, 96)


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("c_out", [127, 128, 13, 96])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_fused_project_takes_c_out_128_and_odd_at_c_in_256(k, c_out, dtype):
    """The two-pass block's projection at C_in 256 (ada_out's width, the
    widest of the model) with k3 and k5: C_out 128 and odd C_out on the
    tile design, within a CTA's shared memory, in both dtypes."""
    bf16 = dtype == "bfloat16"
    st = limits.check_fused_project(
        k, 256, c_out, bf16=bf16, mma=limits.tensor_core_expand(bf16, 256))
    assert st["design"] == "tile"
    assert st["smem"] <= limits.SMEM_OPT_IN


def _sweep2_blocks(cfg, size):
    """(E, C_out) of every block whose sweep 2 a flat, flat_s2 or mega
    kernel may run at ``size``: every block of the tuner's walk but
    ada_out (which every route sends to ``expand_dw`` at every size)."""
    return sorted({(round(c_in * t), c_out)
                   for c_in, c_out, _, _, t, _, _ in enumerate_blocks(cfg,
                                                                      size)
                   if (c_in, c_out) != ADA_OUT[:2]})


@pytest.mark.parametrize("size", [256, 320, 512, 720, 1024])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_every_block_takes_a_designed_sweep_2(size, dtype):
    """``sweep2_staging`` (the mirror of ``gate_project.cuh``'s choice)
    sends every block of the model to a designed kernel in both layouts:
    ``gate_project_mma`` in bf16 (its C_out-128 bucket from 1024px, the
    128px stage), ``gate_project_tf32`` in f32 (the stylize CLI's dtype),
    each within a CTA's shared memory with at least two ring slots."""
    bf16 = dtype == "bfloat16"
    blocks = _sweep2_blocks(CFG, size)
    assert blocks
    for e, c_out in blocks:
        for yt in (False, True):
            st = limits.sweep2_staging(e, c_out, bf16, yt)
            assert st["design"] == ("mma" if bf16 else "tf32"), (e, c_out)
            assert st["smem"] <= limits.SMEM_OPT_IN
            assert st["slots"] >= 2
    if size == 1024:
        assert any(c_out == 128 for _, c_out in blocks)


@pytest.mark.parametrize("size", [256, 320, 512, 720, 1024])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_every_block_takes_a_designed_sweep_1(size, dtype):
    """``sweep1_design`` (the mirror of ``expand_dw.cuh``'s ``dispatch_k``)
    sends every NHWC expand block of the model to the bf16 tensor-core
    expand at bf16 and to the 3xTF32 one at f32 (the stylize CLI's dtype),
    each within a CTA's shared memory; the 3xTF32 design's x box comes in
    ``tf32_chunk``'s chunks, sized for two CTAs per SM at C_in 16, 24 (k3)
    and 40 (k5), where that costs at most one chunk more than one CTA's
    sizing, and for one CTA at C_in 80, 96, 128 and 256 (two would take
    three to six chunks).  (N, H, C, W) f32 x (mega_block, W % 8 == 0)
    takes the 3xTF32 design too; the off-model shapes (C_in 12 in NHWC,
    (N, H, C, W) x at W % 8 != 0, an unaligned x, the expand==1 form) take
    the CUDA-core expand."""
    bf16 = dtype == "bfloat16"
    blocks = _kernel_blocks(CFG, size)
    assert blocks
    for c_in, c_out, k, _ in blocks:
        design = limits.sweep1_design(bf16, c_in, k=k)
        assert design == ("mma" if bf16 else "tf32"), (c_in, k)
        st = limits.check_sweep1("expand_dw", k, c_in, tf32=not bf16)
        assert st["smem"] <= limits.SMEM_OPT_IN
        assert max(st["box"]) <= limits.MAX_BOX
        if not bf16:
            two = 2 * (st["smem"] + limits.CTA_RESERVED) <= limits.SM_SMEM
            assert two == (c_in in (16, 24, 40)), (c_in, k)
            assert st["boxes"] == -(-c_in // st["chunk"])
            assert limits.sweep1_design(bf16, c_in, layout="xt", k=k) \
                == "tf32"
            assert limits.sweep1_design(bf16, c_in, layout="xt_rows",
                                        k=k) == "core"
    for c_in, k in ((12, 3), (12, 5)):
        assert limits.sweep1_design(bf16, c_in, k=k) == "core"
    assert limits.sweep1_design(bf16, 40, aligned=False, k=5) == "core"
    assert limits.sweep1_design(bf16, 40, expand=False, k=5) == "core"
    assert limits.sweep1_design(bf16, 40, layout="xt", k=5) == \
        ("mma" if bf16 else "tf32")


@pytest.mark.parametrize("size", [256, 320, 512, 720, 1024])
def test_every_mega_and_stride_2_block_takes_3xtf32(size):
    """At f32 every mega block (the (N, H, C, W) box, at widths that are
    multiples of 8) and every stride-2 block (``flat_s2_block``) of the
    full-width model takes the 3xTF32 sweep 1 within a CTA's shared memory
    and a TMA box's 256 elements, its box rows whole 16-byte multiples and
    its chunks covering C_in; two CTAs share an SM at C_in 16, 24 and 40
    (mega, k3 and k5) and at every stride-2 block (its f32 4 x 16 tile,
    the whole box), one at mega's C_in 80-128."""
    for c_in, c_out, k, _ in _kernel_blocks(CFG, size):
        if (c_in, c_out) == ADA_OUT[:2]:  # no mega chain has ada_out
            continue
        assert limits.sweep1_design(False, c_in, layout="xt", k=k) == "tf32"
        st = limits.check_sweep1("mega_block", k, c_in, "xt", tf32=True)
        assert st["smem"] <= limits.SMEM_OPT_IN
        assert max(st["box"]) <= limits.MAX_BOX
        assert st["box"][0] * 4 % 16 == 0 and st["box"][1] == st["chunk"]
        assert st["boxes"] * st["chunk"] >= c_in > (st["boxes"] - 1) * \
            st["chunk"]
        assert st["ctas"] == (2 if c_in in (16, 24, 40) else 1), (c_in, k)
        assert 2 * (st["smem"] + limits.CTA_RESERVED) <= limits.SM_SMEM \
            or st["ctas"] == 1
    stride2 = {(c_in, k) for c_in, _, stride, k, _, _, _
               in enumerate_blocks(CFG, size) if stride == 2}
    assert stride2 == {(16, 3), (24, 5), (40, 3)}
    for c_in, k in stride2:
        assert limits.s2_sweep1_design(False, c_in, k=k) == "tf32"
        assert limits.s2_sweep1_design(True, c_in, k=k) == "mma"
        st = limits.check_flat_s2(k, c_in, f32=True)
        assert st["smem"] <= limits.SMEM_OPT_IN
        assert max(st["box"]) <= limits.MAX_BOX
        assert st["box"][0] * 4 % 16 == 0
        assert st["boxes"] == 1 and st["ctas"] == 2, (c_in, k)
    assert limits.s2_sweep1_design(False, 12, k=3) == "core"
    assert limits.s2_sweep1_design(False, 16, aligned=False, k=3) == "core"


def test_the_3xtf32_mirror_matches_the_header_comments():
    """The shared memory the f32 designs' sources state: mega_block's (N,
    H, C, W) box (``expand_dw.cuh``: k5 C_in 40 two chunks of 24 in
    109,832 B against the whole box's 140,552; k3 C_in 16 and 24 75,528 and
    91,400 B; k3 C_in 80 202,504 B; k5 C_in 96 two chunks of 48 in 170,248
    B) and flat_s2_block's 4 x 16 f32 tile (``flat_s2.cu``: e2 68,744 B,
    e4 102,536 B, the whole box)."""
    def xt(k, c_in, b=None):
        return limits._edw_tf32_smem(k, c_in, b or limits.tf32_chunk(
            k, c_in, "xt"), "xt")

    assert (xt(5, 40)["smem"], xt(5, 40)["chunk"]) == (109832, 24)
    assert xt(5, 40, 40)["smem"] == 140552
    assert (xt(3, 16)["smem"], xt(3, 24)["smem"]) == (75528, 91400)
    assert (xt(3, 80)["smem"], xt(3, 80)["boxes"]) == (202504, 1)
    assert (xt(5, 96)["smem"], xt(5, 96)["chunk"]) == (170248, 48)
    e2 = limits.flat_s2_staging(3, 16, f32=True)
    e4 = limits.flat_s2_staging(5, 24, f32=True)
    assert (e2["smem"], e2["chunk"], e2["boxes"]) == (68744, 16, 1)
    assert (e4["smem"], e4["chunk"], e4["boxes"]) == (102536, 24, 1)
    # Two CTAs per SM need at most 115,712 bytes each.
    assert xt(5, 40)["smem"] <= 115712 < xt(5, 40, 40)["smem"]
    assert max(e2["smem"], e4["smem"]) <= 115712


@pytest.mark.parametrize("e,c_out,bf16", [
    (48, 13, True),    # cin12: odd C_out
    (48, 13, False),
    (44, 16, True),    # E % 8 != 0 in bf16
    (42, 16, False),   # E % 4 != 0 in f32
    (384, 130, True),  # past C_out 128
    (768, 128, True),  # ada_out's block: the matrix past shared memory
])
def test_off_model_shapes_take_the_generic_sweep_2(e, c_out, bf16):
    """The shapes the designs do not take go to gate_project_generic."""
    st = limits.sweep2_staging(e, c_out, bf16)
    assert st["design"] == "generic" and st["slots"] == 0


def test_the_sweep_2_mirror_matches_the_card():
    """``sweep2_staging``'s bytes and slots at shapes whose
    ``gate_project_occupancy`` the card reported (NVIDIA H100 80GB HBM3):
    the C_out-128 wgmma bucket, f32 with two CTAs per SM (4 and 3 slots),
    one CTA with 4 slots, and C_out 128 x E 384 with 2."""
    assert limits.sweep2_staging(384, 128) == {
        "design": "mma", "smem": 165696, "slots": 4}
    assert limits.sweep2_staging(320, 80) == {
        "design": "mma", "smem": 119744, "slots": 4}
    assert limits.sweep2_staging(160, 40, False) == {
        "design": "tf32", "smem": 92864, "slots": 4}
    assert limits.sweep2_staging(320, 40, False) == {
        "design": "tf32", "smem": 102720, "slots": 3}
    assert limits.sweep2_staging(320, 80, False) == {
        "design": "tf32", "smem": 170304, "slots": 4}
    assert limits.sweep2_staging(384, 128, False) == {
        "design": "tf32", "smem": 232000, "slots": 2}
    assert limits.sweep2_staging(384, 128, True, True)["smem"] == \
        165696 + 8 * 8 * 40 * 2


def test_the_sweep_1_mirror_matches_the_card():
    """The 3xTF32 sweep 1's bytes, x boxes and CTAs per SM at shapes whose
    ``expand_dw_f32_occupancy`` / ``flat_block_f32_occupancy`` the card
    reported (NVIDIA H100 80GB HBM3, 700.00 W; ``chip_smoke.py``'s sweeps
    phase): the 512px decoder's k5 C_in 40 (two chunks of 24 channels, two
    CTAs per SM), k5 C_in 96 (two chunks of 48, one CTA), k3 C_in 80 (the
    whole box, one CTA) and k3 C_in 16 (the whole box, two CTAs)."""
    card = {(5, 40): (108552, 2, 2), (5, 96): (161288, 2, 1),
            (3, 80): (177160, 1, 1), (3, 16): (74760, 1, 2)}
    for (k, c_in), (smem, boxes, ctas) in card.items():
        st = limits.sweep1_staging(k, c_in, tf32=True)
        assert (st["smem"], st["boxes"]) == (smem, boxes), (k, c_in)
        fit = (limits.SM_SMEM // (st["smem"] + limits.CTA_RESERVED))
        assert min(fit, 2) == ctas, (k, c_in)


def test_mega_rules_at_the_lane_are_jax_defaults():
    """``flatblock.mega_encoder_takes`` and ``mega_decoder_starts``, the
    one rule that the mega chains and ``planned_launches`` share, take
    JAX's defaults (``min_mega_size`` 256, ``min_mega_w`` 128) at the
    128-pixel lane and scale with a test's smaller lane."""
    import inspect

    from arbitrarystyletransfer_tpu.ops.pallas import megablock as jmega

    size = inspect.signature(jmega.encode_mega).parameters["min_mega_size"]
    width = inspect.signature(jmega.decode_mega).parameters["min_mega_w"]
    assert (size.default, width.default) == (256, 128)
    for h in (128, 256, 384, 512, 640, 1024):
        assert pflat.mega_encoder_takes(1, h) == (h % 128 == 0 and h >= 256)
        assert pflat.mega_encoder_takes(1, h // 8, 16) == \
            pflat.mega_encoder_takes(1, h)
        assert not pflat.mega_encoder_takes(2, h)
        for w in (h, h + 8):
            assert pflat.mega_decoder_starts(h, w) == (w % 128 == 0)
    assert not pflat.mega_decoder_starts(64, 128)


@pytest.fixture
def jax_without_table(monkeypatch, tmp_path):
    """Both planners with no tuned table: ``AST_TUNED_POLICY`` names a
    missing file."""
    monkeypatch.setenv("AST_TUNED_POLICY", str(tmp_path / "missing.json"))
    jpolicy.load_policy.cache_clear()
    ppolicy.clear_cache()
    yield
    jpolicy.load_policy.cache_clear()
    ppolicy.clear_cache()


@pytest.mark.parametrize("size", PLAN_SIZES)
@pytest.mark.parametrize("impl", ["flat", "flat-all"])
def test_planned_chains_match_jax_without_a_table(jax_without_table, size,
                                                  impl):
    assert (pflat.planned_chains(CFG, size, impl, impl)
            == jflat.planned_chains(JCFG, size, impl, impl))


@pytest.mark.parametrize("source", ["jax", "port"])
@pytest.mark.parametrize("size", PLAN_SIZES)
def test_auto_plans_match_jax_on_the_same_table(monkeypatch, size, source):
    """"auto" from the same table on both sides (JAX's TPU table or the
    port's H100 table), as test_torch_policy.py holds it at 512-256px."""
    root = ppolicy.DEFAULT_PATH.parents[2]
    path = (root / "arbitrarystyletransfer_tpu/ops/pallas/tuned_policy.json"
            if source == "jax" else ppolicy.DEFAULT_PATH)
    monkeypatch.setenv("AST_TUNED_POLICY", str(path))
    jpolicy.load_policy.cache_clear()
    ppolicy.clear_cache()
    try:
        assert json.loads(path.read_text())["cases"]
        assert (pflat.planned_chains(CFG, size, "auto", "auto")
                == jflat.planned_chains(JCFG, size, "auto", "auto"))
    finally:
        jpolicy.load_policy.cache_clear()
        ppolicy.clear_cache()


@pytest.mark.parametrize("size,impl,expand_dw_n,mega_n", [
    (128, "fused", 26, 0),  # 1024px at 1/8: every stride-1 block
    (128, "mega", 8, 18),   # e1 e3 e5 e6 d0-d13 mega; e8-e14, ada_out
    # 720px's rules at 88px (its maps 88, 44, 22, 11 even down to the
    # decoder, no width a multiple of 16, as 720, 360, 180, 90 of 128):
    (88, "fused", 15, 0),   # e1 e3 e5 e6 d3-d13
    (88, "mega", 4, 0),     # no mega_block: e1 e3 e5 e6
])
def test_fused_and_mega_launches_are_planned(monkeypatch, size, impl,
                                             expand_dw_n, mega_n):
    """At 1/8 of the size, lane (16) and threshold (16), the engine calls
    ``expand_dw`` and ``mega_block`` as ``planned_launches`` says, as the
    1024px and 720px requests do on the card (at 1/8 of 720px the maps
    turn odd, which 720px's do not: 88px keeps its rules)."""
    lane, min_fused = 16, 16
    calls = {"expand_dw": 0, "mega_block": 0}

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(pfb, "expand_dw", counted("expand_dw", pfb.expand_dw))
    monkeypatch.setattr(pmega, "mega_block",
                        counted("mega_block", pmega.mega_block))
    cfg = ModelConfig(encoder_eval_stats=True)
    state = weights.init_params(cfg, torch.Generator().manual_seed(0))
    rng = torch.Generator().manual_seed(1)
    content, style = (torch.rand(1, size, size, 3, generator=rng)
                      for _ in range(2))
    engine.stylize_fused(state, content, style, cfg=cfg,
                         dtype=torch.float32, min_fused_size=min_fused,
                         encoder_impl=impl, decoder_impl=impl, lane=lane)
    planned = pflat.planned_launches(cfg, size, impl, impl, lane=lane,
                                     min_fused_size=min_fused)
    assert calls == {"expand_dw": expand_dw_n, "mega_block": mega_n}
    assert planned == {"expand_dw": expand_dw_n, "flat_block": 0,
                       "flat_s2_block": 0,
                       **({"mega_block": mega_n} if impl == "mega" else {})}


@pytest.mark.parametrize("use_kernel", [True, False])
def test_adaattn_apply_matches_jax(use_kernel):
    """One AdaAttN tap (content 8 x 8, style 6 x 10, f32) against JAX
    ``engine.adaattn_apply``: the kernel's twin against the Pallas kernel
    in interpret mode, or the plain statistics on both sides."""
    v = ast_variables(seed=19)
    att = v["params"]["ada_att_1"]
    rng = np.random.default_rng(19)
    content = rng.normal(0, 1, (2, 8, 8, 128)).astype(np.float32)
    style = rng.normal(0, 1, (2, 6, 10, 128)).astype(np.float32)
    out = engine.adaattn_apply(to_port(att), torch.from_numpy(content),
                               torch.from_numpy(style),
                               use_kernel=use_kernel, dtype=torch.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = jengine.adaattn_apply(to_jax(att), jnp.asarray(content),
                                    jnp.asarray(style),
                                    use_pallas=use_kernel,
                                    dtype=jnp.float32)
    assert out.shape == (2, 8, 8, 128) and out.dtype == torch.float32
    # f32; the statistics' sums in another order (the adaattn tests' 1e-5).
    assert_close(out, np.asarray(ref), 1e-5, "adaattn_apply")


@pytest.mark.parametrize("size", [45, 90])
def test_odd_maps_take_the_plain_stride_2_route(monkeypatch, size):
    """A size whose maps turn odd (here at 1/8 lane, as 345px and 722px do
    at 128): "flat-all" plans the stride-2 kernel only on even maps (the
    flat kernel takes no other) and the plain route on the odd ones; the
    engine calls each kernel as ``planned_launches`` says, and every
    ``flat_s2_block`` call gets an even map."""
    from arbitrarystyletransfer_tpu_torch.ops import flatblock_s2 as ps2

    lane, min_fused = 16, 16
    calls = {"flat_block": 0, "flat_s2_block": 0, "expand_dw": 0}

    def counted(name, fn):
        def wrapper(x, *a, **k):
            calls[name] += 1
            if name == "flat_s2_block":
                assert x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0, x.shape
            return fn(x, *a, **k)
        return wrapper

    monkeypatch.setattr(pflat, "flat_block",
                        counted("flat_block", pflat.flat_block))
    monkeypatch.setattr(ps2, "flat_s2_block",
                        counted("flat_s2_block", ps2.flat_s2_block))
    monkeypatch.setattr(pfb, "expand_dw", counted("expand_dw", pfb.expand_dw))
    cfg = ModelConfig(encoder_eval_stats=True)
    plan = pflat.planned_chains(cfg, size, "flat-all", "flat-all",
                                lane=lane)
    # e2, e4, e7 (plan indices 1, 3, 6) at inputs 45, 23, 12 (45px) or
    # 90, 45, 23 (90px): flat2 only at 90 (12 fails the width rule).
    # Rounding the halved sizes down, as JAX's planner does, plans flat2
    # on e4's 23 at 45px (its rows: 22).
    assert [plan["enc"][i] for i in (1, 3, 6)] == (
        ["xla", "xla", "xla"] if size == 45 else ["flat2", "xla", "xla"])
    state = weights.init_params(cfg, torch.Generator().manual_seed(0))
    rng = torch.Generator().manual_seed(2)
    content, style = (torch.rand(1, size, size, 3, generator=rng)
                      for _ in range(2))
    out = engine.stylize_fused(state, content, style, cfg=cfg,
                               dtype=torch.float32,
                               min_fused_size=min_fused,
                               encoder_impl="flat-all",
                               decoder_impl="flat-all", lane=lane)
    assert out.shape == (1, 8 * -(-size // 8), 8 * -(-size // 8), 3)
    assert calls == pflat.planned_launches(cfg, size, "flat-all",
                                           "flat-all", lane=lane,
                                           min_fused_size=min_fused)
