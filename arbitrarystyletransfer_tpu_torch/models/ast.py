"""AST, the whole style transfer model: the twin of ``models/ast.py``.

The trainable encoder, two AdaAttN modules on its two taps, the 256->128
``ada_out`` fuse (a DepthWiseConv without norm or residual) and the decoder,
with the JAX tree's child names (``enc``, ``ada_att_1``, ``ada_att_2``,
``ada_out``, ``dec``).  ``weights.load_state`` / ``weights.module_state``
move a weights.py state in and out.

  forward (training): sm1, sm2, t = encode(content, style, detach=True)
                      content_map = ada_out(cat(enc(content)))  train=True
                      t = alpha t + (1 - alpha) content_map
                      returns (dec(t), (sm1, sm2), dec(content_map))
  export:             dec(encode(content, style, train=False)), clamped
  stylize:            the alpha blend with the content taps encoded once,
                      clamped
  reencode:           the encoder taps of an image (train mode)

The detached encode runs the encoder with ``train=False`` (no running
update) and the normalizer ``use_batch_stats = not cfg.encoder_eval_stats``,
under ``torch.no_grad``: the JAX ``stop_gradient`` of the maps.  The
identity encode runs ``train=True`` and updates the running statistics.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import ModelConfig
from ..ops.blocks import DepthWiseConv
from .adaattn import AdaAttN
from .decoder import Decoder
from .encoder import Encoder, module_dtype


class AST(nn.Module):
    def __init__(self, cfg: ModelConfig = ModelConfig()):
        super().__init__()
        self.cfg = cfg
        c = cfg.enc_out_channels
        dtype = module_dtype(cfg)
        self.enc = Encoder(cfg)
        self.dec = Decoder(cfg)
        self.ada_att_1 = AdaAttN(c, use_pallas=cfg.use_pallas_adaattn,
                                 dtype=dtype)
        self.ada_att_2 = AdaAttN(c, use_pallas=cfg.use_pallas_adaattn,
                                 dtype=dtype)
        self.ada_out = DepthWiseConv(2 * c, c, 1, cfg.expand_ratio,
                                     use_norm=False, use_identity=False,
                                     dtype=dtype)

    def _taps(self, img, train, use_batch_stats=None):
        return self.enc(img, out_layers=self.cfg.enc_out_layers, train=train,
                        use_batch_stats=use_batch_stats)

    def _attend(self, content_maps, style_maps):
        """(sm1, sm2, the ada_out fuse of both) from the two taps."""
        sm1 = self.ada_att_1(content_maps[0], style_maps[0])
        sm2 = self.ada_att_2(content_maps[1], style_maps[1])
        return sm1, sm2, self.ada_out(torch.cat([sm1, sm2], dim=-1),
                                      train=False)

    def encode(self, content_img, style_img, detach: bool = False,
               return_maps: bool = False, train: bool = True):
        """The stylized feature map (and the two AdaAttN outputs with
        ``return_maps``)."""
        eval_ubs = not self.cfg.encoder_eval_stats
        if detach:
            with torch.no_grad():
                content_maps = self._taps(content_img, False, eval_ubs)
                style_maps = self._taps(style_img, False, eval_ubs)
        else:
            ubs = None if train else eval_ubs
            content_maps = self._taps(content_img, train, ubs)
            style_maps = self._taps(style_img, train, ubs)
        sm1, sm2, stylized = self._attend(content_maps, style_maps)
        if return_maps:
            return sm1, sm2, stylized
        return stylized

    def forward(self, content_img, style_img, alpha: float = 1.0,
                train: bool = True):
        """The training forward: (t_cs, (sm1, sm2), org_out)."""
        sm1, sm2, t = self.encode(content_img, style_img, detach=True,
                                  return_maps=True)
        content_map = self.ada_out(
            torch.cat(self._taps(content_img, train), dim=-1), train=False)
        t = alpha * t + (1.0 - alpha) * content_map
        org_out = self.dec(content_map)
        t_cs = self.dec(t)
        return t_cs, (sm1, sm2), org_out

    def export(self, content_img, style_img):
        """The clamped stylized image only."""
        return self.dec(self.encode(content_img, style_img, train=False),
                        exporting=True)

    def stylize(self, content_img, style_img, alpha: float = 1.0):
        """Alpha-interpolated inference with the export clamp; the content
        taps feed both the attention queries and the identity blend."""
        ubs = not self.cfg.encoder_eval_stats
        content_maps = self._taps(content_img, False, ubs)
        _, _, t = self._attend(content_maps,
                               self._taps(style_img, False, ubs))
        content_map = self.ada_out(torch.cat(content_maps, dim=-1),
                                   train=False)
        t = alpha * t + (1.0 - alpha) * content_map
        return self.dec(t, exporting=True)

    def reencode(self, img, train: bool = True):
        """The encoder taps of an image (the local-feature loss's
        re-encode of the stylized image)."""
        return self._taps(img, train)
