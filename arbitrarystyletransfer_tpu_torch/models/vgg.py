"""The frozen VGG-19 perceptual network (NHWC): the twin of ``models/vgg.py``.

An ImageNet-normalization front, then torchvision's VGG-19 ``features``
stack walked with the names ``conv_i``/``relu_i``/``pool_i``, stopping once
every requested tap is collected.  ``conv_i`` taps are taken before the
ReLU, ``relu_i`` after it.  Parameters keep the JAX tree: ``conv_i`` with an
HWIO ``kernel`` and a ``bias``.

No pretrained weights ship with the repository and nothing is downloaded:
``load_torch_vgg19_state_dict`` reads a local ``.pth`` or ``.npz`` of
torchvision's ``vgg19().features`` (``find_vgg_weights`` looks for one).
Without one the trainer uses a seeded He-normal init, a random-projection
perceptual loss that is fine for tests but not for loss curves that match
the reference.
"""

from __future__ import annotations

import math
import os
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import VGG_CONTENT_LAYERS
from ..ops.basic import hwio_to_oihw
from ..ops.blocks import Conv

# torchvision vgg19 'features': 64,64,M, 128,128,M, 256x4,M, 512x4,M, 512x4,M
_VGG19_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M")
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def _walk(content_layers):
    """The (name, width) walk up to the last requested tap: ("conv_i", ch),
    ("relu_i", None), ("pool_i", None)."""
    wanted, found, steps, i = set(content_layers), set(), [], 0
    for v in _VGG19_CFG:
        if v == "M":
            names = [(f"pool_{i}", None)]
        else:
            i += 1
            names = [(f"conv_{i}", v), (f"relu_{i}", None)]
        for name, ch in names:
            steps.append((name, ch))
            found |= {name} & wanted
            if found == wanted:
                return steps
    return steps


class VGG19Features(nn.Module):
    """VGG-19 taps of an NHWC [0, 1] batch, in the order of the walk."""

    def __init__(self, content_layers: Sequence[str] = VGG_CONTENT_LAYERS):
        super().__init__()
        self.wanted = set(content_layers)
        self.steps = _walk(content_layers)
        c_in = 3
        for name, ch in self.steps:
            if ch is not None:
                self.add_module(name, Conv(c_in, ch, 3, use_bias=True))
                c_in = ch
        self.register_buffer("img_mean", torch.tensor(_IMAGENET_MEAN),
                             persistent=False)
        self.register_buffer("img_std", torch.tensor(_IMAGENET_STD),
                             persistent=False)
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor):
        x = (x - self.img_mean.to(x.dtype)) / self.img_std.to(x.dtype)
        outs = []
        for name, ch in self.steps:
            if ch is not None:
                conv = getattr(self, name)
                # The flax conv's zero padding of 1, on the NCHW view.
                x = F.conv2d(x.permute(0, 3, 1, 2), hwio_to_oihw(conv.kernel),
                             conv.bias, padding=1).permute(0, 2, 3, 1)
            elif name.startswith("relu"):
                x = torch.relu(x)
            else:
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(
                    0, 2, 3, 1)
            if name in self.wanted:
                outs.append(x)
        return outs

    def load_params(self, params) -> None:
        """Load a JAX-layout tree ({"conv_i": {"kernel", "bias"}}, numpy or
        tensors); convs past the last tap are ignored."""
        from ..weights import from_jax_tree, load_state

        own = {name for name, ch in self.steps if ch is not None}
        load_state(self, from_jax_tree(
            {k: v for k, v in params.items() if k in own}, {}))


def init_vgg_params(content_layers: Sequence[str] = VGG_CONTENT_LAYERS,
                    generator=None):
    """Seeded He-normal (flax ``he_normal``: truncated normal, fan-in)
    kernels and zero biases for the convs of the walk."""
    gen = generator if generator is not None else torch.Generator()
    params, c_in = {}, 3
    for name, ch in _walk(content_layers):
        if ch is None:
            continue
        z = torch.nn.init.trunc_normal_(torch.empty(3, 3, c_in, ch), 0.0,
                                        1.0, -2.0, 2.0, generator=gen)
        std = math.sqrt(2.0 / (9 * c_in)) / 0.87962566103423978
        params[name] = {"kernel": (z * std).numpy(),
                        "bias": np.zeros(ch, np.float32)}
        c_in = ch
    return params


def load_torch_vgg19_state_dict(path: str):
    """torchvision vgg19 ``features`` weights from a local ``.pth`` (torch
    state dict, keys ``features.N.weight``/``.bias`` or bare ``N.weight``) or
    an ``.npz`` with the same keys, as the JAX tree: {"conv_i": {"kernel":
    HWIO numpy, "bias": numpy}} for the 16 convs."""
    path = str(path)
    if path.endswith(".npz"):
        with np.load(path) as data:
            raw = {k: data[k] for k in data.files}
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        raw = {k: v.numpy() for k, v in sd.items()}

    cleaned = {}
    for key, value in raw.items():
        for prefix in ("features.", "module.features.", "_vgg_layers."):
            if key.startswith(prefix):
                key = key[len(prefix):]
        cleaned[key] = value

    params, seq_idx, conv_i = {}, 0, 0
    for v in _VGG19_CFG:
        if v == "M":
            seq_idx += 1
            continue
        conv_i += 1
        w_key, b_key = f"{seq_idx}.weight", f"{seq_idx}.bias"
        if w_key not in cleaned:
            raise KeyError(f"missing {w_key} in vgg weight file {path}")
        params[f"conv_{conv_i}"] = {
            "kernel": np.transpose(np.asarray(cleaned[w_key]), (2, 3, 1, 0)),
            "bias": np.asarray(cleaned[b_key]),
        }
        seq_idx += 2
    return params


def find_vgg_weights(search_paths: Sequence[str] = ()) -> str | None:
    """A local VGG-19 weight file, if there is one."""
    candidates = list(search_paths) + [
        os.environ.get("VGG19_WEIGHTS", ""),
        "weights/vgg19_features.npz",
        "weights/vgg19.pth",
        os.path.expanduser("~/.cache/torch/hub/checkpoints/vgg19-dcbb9e9d.pth"),
    ]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    return None
