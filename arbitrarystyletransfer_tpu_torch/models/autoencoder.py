"""The Stage-1 pretraining autoencoder (NHWC): the twin of
``models/autoencoder.py``.

Encoder -> concat of the two tapped 128-channel maps (256 channels) ->
``ada_out`` DepthWiseConv(256->128) bottleneck fuse -> Decoder, with the JAX
tree's child names (``encoder``, ``ada_out``, ``decoder``), so
``weights.load_state`` / ``weights.module_state`` move a state in and out
and ``train/checkpoint.transplant_ae_to_ast`` warm-starts the AST from it.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import ModelConfig
from ..ops.blocks import DepthWiseConv
from .decoder import Decoder
from .encoder import Encoder, module_dtype


class AutoEncoder(nn.Module):
    def __init__(self, cfg: ModelConfig = ModelConfig()):
        super().__init__()
        self.cfg = cfg
        c = cfg.enc_out_channels
        self.encoder = Encoder(cfg)
        self.ada_out = DepthWiseConv(2 * c, c, 1, cfg.expand_ratio,
                                     use_norm=False, use_identity=False,
                                     dtype=module_dtype(cfg))
        self.decoder = Decoder(cfg)

    def _use_batch_stats(self, train: bool):
        """Training normalizes with batch statistics (and updates the
        running ones); inference follows ``cfg.encoder_eval_stats``."""
        return None if train else not self.cfg.encoder_eval_stats

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        """The unclamped reconstruction of ``x``."""
        taps = self.encoder(x, out_layers=self.cfg.enc_out_layers,
                            train=train,
                            use_batch_stats=self._use_batch_stats(train))
        return self.decoder(self.ada_out(torch.cat(taps, dim=-1),
                                         train=False))

    def encode_latent(self, x: torch.Tensor,
                      train: bool = False) -> torch.Tensor:
        """The last encoder block's output."""
        return self.encoder(x, auto_enc=True, train=train,
                            use_batch_stats=self._use_batch_stats(train))

    def decode_latent(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z)
