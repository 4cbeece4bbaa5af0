"""The port's model graph (``nn.Module``s) against the flax modules.

The same numpy variables go to both, the port's through the weights bridge
(``weights.from_jax_tree`` then ``weights.load_state``); inputs come from a
seeded numpy generator; everything is float32 on the CPU.  Tolerances are
relative to the reference's largest magnitude: the two frameworks sum
convolutions and reductions in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from arbitrarystyletransfer_tpu import config as jax_config
from arbitrarystyletransfer_tpu.models import adaattn as jax_adaattn
from arbitrarystyletransfer_tpu.models.decoder import Decoder as JaxDecoder
from arbitrarystyletransfer_tpu.models.encoder import Encoder as JaxEncoder
from arbitrarystyletransfer_tpu.models.vgg import VGG19Features as JaxVGG
from arbitrarystyletransfer_tpu.models.vgg import (
    load_torch_vgg19_state_dict as jax_load_vgg,
)
from arbitrarystyletransfer_tpu.ops import blocks as jax_blocks
from arbitrarystyletransfer_tpu.ops.norm import BatchNorm2D as JaxBN

from arbitrarystyletransfer_tpu_torch import ModelConfig, weights
from arbitrarystyletransfer_tpu_torch.models.adaattn import AdaAttN, AdaIN
from arbitrarystyletransfer_tpu_torch.models.decoder import Decoder
from arbitrarystyletransfer_tpu_torch.models.encoder import Encoder
from arbitrarystyletransfer_tpu_torch.models.vgg import (
    VGG19Features,
    init_vgg_params,
    load_torch_vgg19_state_dict,
)
from arbitrarystyletransfer_tpu_torch.ops.blocks import DepthWiseConv
from arbitrarystyletransfer_tpu_torch.ops.norm import BatchNorm2D

from test_torch_ops import assert_close, ast_variables, block_params

CFG = ModelConfig()
JCFG = jax_config.ModelConfig()


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32).copy())


def _module(mod, params, stats=None):
    weights.load_state(mod, weights.from_jax_tree(params, stats or {}))
    return mod


def _buffers(mod):
    return weights.module_state(mod)["batch_stats"]


def _assert_tree_close(out, ref, rel, what):
    flat_o = weights.flatten({"params": {}, "batch_stats": out})
    flat_r = weights.flatten({"params": {}, "batch_stats": jax.tree.map(
        np.asarray, ref)})
    assert flat_o.keys() == flat_r.keys()
    for key in flat_o:
        assert_close(flat_o[key], flat_r[key], rel, f"{what} {key}")


def _x(shape, seed, lo=None):
    rng = np.random.default_rng(seed)
    if lo is not None:
        return rng.uniform(lo, 1.0, shape).astype(np.float32)
    return rng.normal(0.3, 1.5, shape).astype(np.float32)


@pytest.mark.parametrize("use_batch_stats", [True, False])
@pytest.mark.parametrize("update_stats", [True, False])
def test_batchnorm_matches_flax(use_batch_stats, update_stats):
    rng = np.random.default_rng(1)
    params = {"scale": rng.uniform(0.5, 1.5, 6).astype(np.float32),
              "bias": rng.normal(0, 0.5, 6).astype(np.float32)}
    stats = {"mean": rng.normal(0, 0.5, 6).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, 6).astype(np.float32)}
    x = _x((3, 5, 4, 6), 2)
    bn = _module(BatchNorm2D(6), params, stats)
    y = bn(_t(x), use_batch_stats=use_batch_stats, update_stats=update_stats)
    ref, mutated = JaxBN().apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x),
        use_batch_stats=use_batch_stats, update_stats=update_stats,
        mutable=["batch_stats"])
    # Same formula, reductions in another order.
    assert_close(y.detach(), ref, 1e-5, "y")
    _assert_tree_close(_buffers(bn), mutated["batch_stats"], 1e-6, "stats")
    moved = not np.allclose(bn.mean.numpy(), stats["mean"])
    assert moved == (use_batch_stats and update_stats)


@pytest.mark.parametrize("c_in,c_out,k,stride,t,use_norm", [
    (16, 16, 3, 1, 6, True),    # expand, residual, BN (an encoder block)
    (24, 40, 5, 2, 6, True),    # stride 2 with BN
    (40, 24, 5, 1, 4, False),   # decoder block, no BN, no residual
    (96, 96, 3, 1, 1, False),   # expand==1 (the upsample smoothing block)
    (40, 40, 3, 2, 1, True),    # expand==1, stride 2, BN
])
def test_depthwise_block_matches_flax(c_in, c_out, k, stride, t, use_norm):
    p, s = block_params(c_in, c_out, k, t, use_norm, seed=c_in + k)
    x = _x((2, 11, 13, c_in), 3)
    mod = _module(DepthWiseConv(c_in, c_out, stride, t, kernel_size=k,
                                use_norm=use_norm), p, s)
    jmod = jax_blocks.DepthWiseConv(c_in, c_out, stride, t, kernel_size=k,
                                    use_norm=use_norm)
    variables = {"params": p, **({"batch_stats": s} if use_norm else {})}
    for train, ubs in ((True, None), (False, True), (False, False)):
        if not use_norm and ubs is False:
            continue
        out = mod(_t(x), train=train, use_batch_stats=ubs)
        ref, mutated = jmod.apply(variables, jnp.asarray(x), train=train,
                                  use_batch_stats=ubs, mutable=["batch_stats"])
        assert_close(out.detach(), ref, 1e-5, f"train={train} ubs={ubs}")
        if use_norm:
            _assert_tree_close(_buffers(mod), mutated["batch_stats"], 1e-5,
                               f"train={train}")
            mod = _module(mod, p, s)  # back to the original buffers


def test_encoder_taps_match_flax():
    v = ast_variables(seed=3)
    enc = _module(Encoder(CFG), v["params"]["enc"], v["batch_stats"]["enc"])
    x = _x((2, 32, 32, 3), 4, lo=0.0)
    taps = enc(_t(x), out_layers=CFG.enc_out_layers, train=True)
    ref, mutated = JaxEncoder(JCFG).apply(
        {"params": v["params"]["enc"], "batch_stats": v["batch_stats"]["enc"]},
        jnp.asarray(x), out_layers=JCFG.enc_out_layers, train=True,
        mutable=["batch_stats"])
    assert len(taps) == len(ref) == 2
    for o, r in zip(taps, ref):
        assert_close(o.detach(), r, 1e-4, "tap")
    _assert_tree_close(_buffers(enc), mutated["batch_stats"], 1e-5, "enc")
    enc = _module(enc, v["params"]["enc"], v["batch_stats"]["enc"])
    last = enc(_t(x), auto_enc=True, train=False, use_batch_stats=False)
    ref_last = JaxEncoder(JCFG).apply(
        {"params": v["params"]["enc"], "batch_stats": v["batch_stats"]["enc"]},
        jnp.asarray(x), auto_enc=True, train=False, use_batch_stats=False)
    assert_close(last.detach(), ref_last, 1e-4, "auto_enc")


@pytest.mark.parametrize("exporting", [False, True])
def test_decoder_matches_flax(exporting):
    v = ast_variables(seed=5)
    dec = _module(Decoder(CFG), v["params"]["dec"])
    z = _x((1, 4, 4, 128), 6)
    out = dec(_t(z), exporting=exporting)
    jdec = JaxDecoder(JCFG)
    ref = jdec.apply({"params": v["params"]["dec"]}, jnp.asarray(z),
                     exporting=exporting)
    unclamped = jdec.apply({"params": v["params"]["dec"]}, jnp.asarray(z))
    assert out.shape == (1, 32, 32, 3) and out.dtype == torch.float32
    # 1e-4 of the largest pre-clamp value (the clamp lowers the max, not
    # the error of the values it keeps).
    rel = 1e-4 * float(jnp.abs(unclamped).max() / jnp.abs(ref).max())
    assert_close(out.detach(), ref, rel, "image")


@pytest.mark.parametrize("use_pallas", [False, True])
def test_adaattn_matches_flax(use_pallas):
    params = ast_variables(seed=7)["params"]["ada_att_1"]
    content, style = _x((2, 5, 6, 128), 8), _x((2, 4, 7, 128), 9)
    mod = _module(AdaAttN(128, use_pallas=use_pallas), params)
    out = mod(_t(content), _t(style))
    jmod = jax_adaattn.AdaAttN(128, use_pallas=use_pallas)
    with pltpu.force_tpu_interpret_mode():
        ref = jmod.apply({"params": params}, jnp.asarray(content),
                         jnp.asarray(style))
    assert_close(out.detach(), ref, 1e-4, "stylized map")


def test_adain_matches_flax():
    content, style = _x((2, 5, 6, 8), 10), _x((2, 7, 4, 8), 11)
    out = AdaIN()(_t(content), _t(style))
    ref = jax_adaattn.AdaIN().apply({}, jnp.asarray(content),
                                    jnp.asarray(style))
    assert_close(out, ref, 1e-5, "AdaIN")


def test_vgg_taps_match_flax():
    params = init_vgg_params(generator=torch.Generator().manual_seed(2))
    vgg = VGG19Features()
    vgg.load_params(params)
    x = _x((2, 32, 32, 3), 12, lo=0.0)
    taps = vgg(_t(x))
    ref = JaxVGG().apply({"params": jax.tree.map(jnp.asarray, params)},
                         jnp.asarray(x))
    assert [tuple(t.shape) for t in taps] == [r.shape for r in ref]
    assert [t.shape[-1] for t in taps] == [64, 128, 256, 512, 512, 512]
    for o, r in zip(taps, ref):
        assert_close(o, r, 1e-4, "tap")
    assert not any(p.requires_grad for p in vgg.parameters())


@pytest.mark.parametrize("suffix", [".pth", ".npz"])
def test_vgg_state_dict_loader_matches_jax(tmp_path, suffix):
    rng = np.random.default_rng(13)
    cfg = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
           512, 512, 512, 512, "M", 512, 512, 512, 512, "M")
    sd, c_in, idx = {}, 3, 0
    for v in cfg:
        if v == "M":
            idx += 1
            continue
        sd[f"features.{idx}.weight"] = rng.normal(
            0, 0.1, (v, c_in, 3, 3)).astype(np.float32)
        sd[f"features.{idx}.bias"] = rng.normal(0, 0.1, v).astype(np.float32)
        c_in, idx = v, idx + 2
    path = str(tmp_path / f"vgg{suffix}")
    if suffix == ".npz":
        np.savez(path, **sd)
    else:
        torch.save({k: torch.from_numpy(a) for k, a in sd.items()}, path)
    got = load_torch_vgg19_state_dict(path)
    ref = jax_load_vgg(path)
    assert got.keys() == ref.keys() and len(got) == 16
    for name in ref:
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(got[name][leaf],
                                          np.asarray(ref[name][leaf]))
    VGG19Features().load_params(got)  # the module takes the tree
