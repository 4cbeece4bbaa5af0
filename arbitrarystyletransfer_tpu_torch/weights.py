"""The port's model state: the JAX variable tree, as torch tensors.

``state = {"params": ..., "batch_stats": ...}`` keeps the JAX package's
names, nesting and layouts (conv kernels HWIO, depthwise (k, k, 1, C), dense
(in, out)), so a JAX checkpoint converts leaf by leaf and the port's
functions read the same keys as their JAX twins.  The ops convert a conv
kernel to torch's OIHW where they call ``F.conv2d`` (``ops.basic.hwio_to_oihw``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .config import ModelConfig
from .ops.blocks import make_divisible

_COLLECTIONS = ("params", "batch_stats")


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def from_jax_tree(params, batch_stats):
    """State from JAX variables given as nested dicts of numpy arrays (or
    anything ``np.asarray`` takes); every leaf becomes a float32 tensor."""
    def leaf(a):
        return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))

    return {"params": _map_tree(leaf, params),
            "batch_stats": _map_tree(leaf, batch_stats)}


def to_device(state, device):
    """A copy of ``state`` with every tensor on ``device``."""
    return _map_tree(lambda t: t.to(device), state)


def flatten(state):
    """``{"params/enc/mob_net_1/Conv_0/kernel": tensor, ...}``."""
    flat = {}

    def walk(prefix, tree):
        for k, v in tree.items():
            key = f"{prefix}/{k}"
            if isinstance(v, dict):
                walk(key, v)
            else:
                flat[key] = v

    for name in _COLLECTIONS:
        walk(name, state[name])
    return flat


def unflatten(flat):
    state = {name: {} for name in _COLLECTIONS}
    for key, value in flat.items():
        *path, leaf = key.split("/")
        node = state
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return state


def save_npz(path, state) -> None:
    """Write ``state`` as one float32 array per flattened key."""
    np.savez(path, **{k: v.detach().cpu().numpy()
                      for k, v in flatten(state).items()})


def load_npz(path):
    """Read a state written by ``save_npz`` (tensors on the CPU)."""
    with np.load(path) as data:
        return unflatten({k: torch.from_numpy(data[k]) for k in data.files})


# -- seeded initialization ---------------------------------------------------
# The JAX package's initializers (ops/blocks.py): conv kernels ~ N(0,
# sqrt(2 / (k*k*c_out))), SE dense kernels ~ N(0, 0.01), zero biases, BN scale
# 1 and bias 0, running mean 0 and var 1; the AdaAttN projections and the
# image head use flax's default conv init (LeCun normal, truncated at 2 std).


def _normal(gen, shape, std):
    return torch.randn(shape, generator=gen) * std


def _he(gen, k, c_in, c_out):
    return _normal(gen, (k, k, c_in, c_out), math.sqrt(2.0 / (k * k * c_out)))


def _lecun(gen, shape):
    fan_in = math.prod(shape[:-1])
    # Truncated normal on [-2, 2], rescaled to unit variance as flax does.
    z = torch.nn.init.trunc_normal_(torch.empty(shape), 0.0, 1.0, -2.0, 2.0,
                                    generator=gen)
    return z / 0.87962566103423978 * math.sqrt(1.0 / fan_in)


def _block(gen, c_in, c_out, expand_ratio, k, use_norm):
    """One DepthWiseConv block's (params, batch_stats) subtrees."""
    hidden = round(c_in * expand_ratio)
    red = make_divisible(hidden // 4, 8)
    p, s = {}, {}

    def bn(name, ch):
        p[name] = {"scale": torch.ones(ch), "bias": torch.zeros(ch)}
        s[name] = {"mean": torch.zeros(ch), "var": torch.ones(ch)}

    se = {"Dense_0": {"kernel": _normal(gen, (hidden, red), 0.01),
                      "bias": torch.zeros(red)},
          "Dense_1": {"kernel": _normal(gen, (red, hidden), 0.01),
                      "bias": torch.zeros(hidden)}}
    dw = {"kernel": _he(gen, k, 1, hidden)}
    if expand_ratio == 1:
        p["DepthwiseConv2D_0"] = dw
        p["SELayer_0"] = se
        p["Conv_0"] = {"kernel": _he(gen, 1, hidden, c_out)}
        if use_norm:
            bn("BatchNorm2D_0", hidden)
            bn("BatchNorm2D_1", c_out)
    else:
        p["Conv_0"] = {"kernel": _he(gen, 1, c_in, hidden)}
        p["DepthwiseConv2D_0"] = dw
        p["SELayer_0"] = se
        p["Conv_1"] = {"kernel": _he(gen, 1, hidden, c_out)}
        if use_norm:
            bn("BatchNorm2D_0", hidden)
            bn("BatchNorm2D_1", hidden)
            bn("BatchNorm2D_2", c_out)
    return p, s


def init_params(cfg: ModelConfig = ModelConfig(), generator=None):
    """A seeded state with the JAX AST tree's names and shapes (CPU)."""
    gen = generator if generator is not None else torch.Generator()
    enc_p, enc_s = {}, {}
    shapes = cfg.enc_conv_shapes
    enc_p["mob_net_0"] = {"Conv_0": {
        "kernel": _he(gen, 3, shapes[0][0], shapes[0][1])}}
    for i, (c_in, c_out, _, k, t) in enumerate(shapes[1:], start=1):
        if i == len(shapes) - 1:
            k, t = 3, cfg.expand_ratio
        enc_p[f"mob_net_{i}"], enc_s[f"mob_net_{i}"] = _block(
            gen, c_in, c_out, t, k, use_norm=True)

    c = cfg.enc_out_channels
    params = {"enc": enc_p}
    for name in ("ada_att_1", "ada_att_2"):
        params[name] = {w: {"kernel": _lecun(gen, (1, 1, c, c))}
                        for w in ("W_q", "W_k", "W_v")}
    params["ada_out"], _ = _block(gen, 2 * c, c, cfg.expand_ratio, 3,
                                  use_norm=False)

    dec = {}
    dshapes = cfg.decoder_conv_shapes
    for i, shape in enumerate(dshapes[:-1]):
        blk = {}
        blk["DepthWiseConv_0"], _ = _block(gen, shape[0], shape[1], shape[4],
                                           shape[3], use_norm=False)
        if shape[0] != shape[1] and i + 6 < len(dshapes):
            blk["DepthWiseConv_1"], _ = _block(gen, shape[1], shape[1], 1, 3,
                                               use_norm=False)
        dec[f"decoder_blocks_{i}"] = blk
    c_in, c_out = dshapes[-1][:2]
    dec["img_out"] = {"kernel": _lecun(gen, (3, 3, c_in, c_out)),
                      "bias": torch.zeros(c_out)}
    params["dec"] = dec
    return {"params": params, "batch_stats": {"enc": enc_s}}


# -- the nn.Module bridge ----------------------------------------------------
# A module built with the JAX tree's child names (models/, ops/blocks.py) has
# parameter "enc.mob_net_1.Conv_0.kernel" for the state key
# "params/enc/mob_net_1/Conv_0/kernel", and BatchNorm buffer
# "enc.mob_net_1.BatchNorm2D_0.mean" for "batch_stats/enc/.../mean".  So JAX
# variables (numpy) -> ``from_jax_tree`` -> ``load_state`` -> the module is
# one path, and ``module_state`` gives back a state that the functional
# engine (and ``save_npz``) takes.


def _module_entries(module):
    """{state key: tensor} of a module's parameters and persistent
    buffers."""
    params = {name for name, _ in module.named_parameters()}
    return {("params/" if name in params else "batch_stats/")
            + name.replace(".", "/"): t
            for name, t in module.state_dict(keep_vars=True).items()}


def load_state(module, state) -> None:
    """Copy a weights.py state into ``module``'s parameters and buffers.

    Every parameter and buffer must be in ``state`` with its shape, and
    ``state`` may hold nothing else."""
    flat = flatten(state)
    entries = _module_entries(module)
    missing = sorted(set(entries) - set(flat))
    extra = sorted(set(flat) - set(entries))
    if missing or extra:
        raise KeyError(f"state does not match the module: missing "
                       f"{missing[:5]}, unexpected {extra[:5]}")
    with torch.no_grad():
        for key, target in entries.items():
            value = torch.as_tensor(flat[key])
            if tuple(value.shape) != tuple(target.shape):
                raise ValueError(f"{key}: shape {tuple(value.shape)}, module "
                                 f"has {tuple(target.shape)}")
            target.copy_(value)


def module_state(module):
    """The module's parameters and buffers as a weights.py state (detached
    tensors that share the module's storage)."""
    return unflatten({k: v.detach()
                      for k, v in _module_entries(module).items()})
