"""Stage-1 autoencoder reconstruction pretraining: the twin of
``arbitrarystyletransfer_tpu/train/ae_trainer.py``.

  loss = recon_lam * huber(recon, x)
       + perp_lam * sum_i huber(VGG_i(recon), detach(VGG_i(x)))

with the two VGG passes taken as one over the 2B batch [x; recon].  The
port's ``Adam`` (global-norm clip 10, then Adam(2e-4, 0.9, 0.99, 1e-7) by
``AETrainConfig``) with the finite guard: a step whose gradient norm is not
finite changes nothing (parameters, moments, step, BatchNorm buffers) and
raises at the next drain.  Saves ``<save_dir>/ae.pt`` (the
``train/checkpoint`` format, which the AST trainer warm-starts from) and the
history ``<save_dir>/train_dict.json`` ({train_loss, val_loss, perp_loss})
every ``save_every`` steps and at the end; validates every
``validate_every``.  Eagerly, as ``ASTTrainer``, and with a ``mesh``
data-parallel as it is: rank 0's batches sharded, global BatchNorm
statistics, each rank's share of the loss, summed gradients, rank 0
writing; ``validate`` takes the global validation batch.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np
import torch

from .. import weights
from ..config import AETrainConfig, ModelConfig
from ..losses import huber_loss
from ..models.autoencoder import AutoEncoder
from ..models.vgg import VGG19Features
from ..parallel.mesh import (
    Mesh,
    all_reduce_grads,
    all_reduce_values,
    barrier,
    batch_share,
    is_sharded,
    local,
    replicate,
    set_mesh,
    shard_batch,
    shared,
)
from . import checkpoint as ckpt
from .ast_trainer import _no_log, load_vgg
from .state import Adam, keep_if

HISTORY_KEYS = ("train_loss", "val_loss", "perp_loss")


def ae_loss(ae: AutoEncoder, vgg: VGG19Features, cfg: AETrainConfig,
            batch: torch.Tensor, mesh: Mesh | None = None):
    """(total, aux) of one batch: the JAX step's ``loss_fn``.  Runs the
    model in train mode, so the encoder's running statistics move.  With a
    ``mesh`` of more than one rank, ``batch`` is this rank's rows, ``total``
    its share of the global loss and aux global."""
    share = batch_share(mesh)
    recon = ae(batch, train=True)
    recon_loss = huber_loss(recon, batch)
    taps = vgg(torch.cat([batch, recon], dim=0))
    b = batch.shape[0]
    perp_loss = 0.0
    for tap in taps:
        perp_loss = perp_loss + huber_loss(tap[b:], tap[:b].detach())
    # Both terms are Huber means over the batch: each rank's share.
    recon_loss, perp_loss = shared(recon_loss, share), shared(perp_loss, share)
    total = cfg.recon_lam * recon_loss + cfg.perp_lam * perp_loss
    aux = {"train_loss": recon_loss, "perp_loss": perp_loss, "loss": total}
    return total, all_reduce_values(mesh, {k: v.detach()
                                           for k, v in aux.items()})


class AutoencoderTrainer:
    """Builds the autoencoder (seeded init) and the frozen VGG and trains
    with the reconstruction and perceptual losses.  Runs on ``device``
    (CUDA by default) and never falls back to another; with a ``mesh`` of
    more than one rank, on the mesh's device, the loaders read on rank 0
    only (the others may pass None)."""

    def __init__(self, cfg: AETrainConfig,
                 content_iter: Iterator[np.ndarray],
                 val_loader: Iterator[np.ndarray] | None = None,
                 model_cfg: ModelConfig = ModelConfig(), seed: int = 0,
                 vgg_weights: str | None = None, device="cuda",
                 log_fn=print, mesh: Mesh | None = None):
        self.mesh = mesh if is_sharded(mesh) else None
        self.device = torch.device(device if self.mesh is None
                                   else self.mesh.device)
        if self.mesh is not None and self.mesh.rank != 0:
            log_fn = _no_log
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("AutoencoderTrainer: device cuda, but CUDA is "
                               "not available (pass device='cpu' to train on "
                               "the CPU)")
        self.cfg = cfg
        self.content_iter = content_iter
        self.val_loader = val_loader

        self.model = AutoEncoder(model_cfg)
        weights.load_state(self.model, weights.init_ae_params(
            model_cfg, torch.Generator().manual_seed(seed)))
        self.model.to(self.device)
        self.vgg, self.vgg_weights_path = load_vgg(
            model_cfg, vgg_weights, self.device, log_fn)

        self.params = list(self.model.parameters())
        self.buffers = list(self.model.buffers())
        self.opt = Adam(
            [(n.replace(".", "/"), p) for n, p in
             self.model.named_parameters()],
            cfg.lr, cfg.adam_b1, cfg.adam_b2, cfg.adam_eps,
            cfg.grad_clip_norm)
        self.step = torch.zeros((), dtype=torch.int64, device=self.device)

        self.save_file = os.path.join(cfg.save_dir, "ae.pt")
        self.train_dict_file = os.path.join(cfg.save_dir, "train_dict.json")
        self.train_dict = {k: [] for k in HISTORY_KEYS}
        if cfg.load:
            self.load()
        self.num_params = sum(p.numel() for p in self.params)
        if self.mesh is not None:
            set_mesh(self.model, self.mesh)
            replicate(self.mesh, [*self.params, *self.buffers, self.opt.mu,
                                  self.opt.nu, self.opt.count, self.step,
                                  *self.vgg.parameters()])

    def _batch(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    # -- the step ------------------------------------------------------------

    def train_step(self, batch):
        """One optimizer step; returns the aux dict (device tensors), with
        "grad_norm" and "finite" added."""
        before = torch.cat([b.reshape(-1) for b in self.buffers])
        _, aux, grads = self.loss_and_grads(batch)
        norm, ok = self.opt.apply_if_finite(grads)
        keep_if(ok, self.buffers, before)
        with torch.no_grad():
            self.step += ok.to(self.step.dtype)
        aux["grad_norm"], aux["finite"] = norm, ok
        return aux

    def loss_and_grads(self, batch):
        """(total, aux, grads) of one batch, grads one per parameter.
        Moves the BatchNorm running buffers; updates nothing else.  With a
        mesh: this rank's rows and share, the gradients summed."""
        total, aux = ae_loss(self.model, self.vgg, self.cfg,
                             self._batch(batch), self.mesh)
        grads = torch.autograd.grad(total, self.params, allow_unused=True)
        return total, aux, all_reduce_grads(self.mesh, grads, self.params)

    def next_batch(self, loader):
        """``loader``'s next batch; with a mesh, this rank's rows of rank
        0's, on the device."""
        if self.mesh is None:
            return next(loader)
        return shard_batch(self.mesh,
                           next(loader) if self.mesh.rank == 0 else None)

    # -- persistence ---------------------------------------------------------

    def save(self):
        """Write the checkpoint and the history (rank 0 only; every rank
        waits for it)."""
        if self.mesh is None or self.mesh.rank == 0:
            ckpt.save_checkpoint(self.save_file,
                                 weights.module_state(self.model),
                                 self.opt.state_dict(), self.step)
            ckpt.save_history(self.train_dict_file, self.train_dict)
        barrier(self.mesh)

    def load(self):
        """Resume from ``ae.pt``, or the JAX trainer's orbax directory
        ``ae`` in the same ``save_dir``, and the history."""
        tree = ckpt.restore_checkpoint(
            ckpt.require_checkpoint(self.save_file), self.device)
        weights.load_state(self.model, tree)
        self.opt.load_state_dict(tree["opt_state"])
        self.step = tree["step"].to(self.device, torch.int64)
        if os.path.exists(self.train_dict_file):
            self.train_dict = ckpt.load_history(self.train_dict_file)

    # -- validation and the latent utilities ---------------------------------

    @torch.no_grad()
    def validate(self):
        """The L1 of one validation batch's reconstruction (``train=False``);
        the history gets it divided by the batch size, as the reference's
        curves do.  With a mesh: the global batch's mean and size (rank 0
        reads its loader; the others pass any loader but None)."""
        if self.val_loader is None:
            return None
        x = self._batch(self.next_batch(self.val_loader))
        l1 = shared((x - self.model(x, train=False)).abs().mean(),
                    batch_share(self.mesh))
        val_l1 = float(all_reduce_values(self.mesh, {"l1": l1})["l1"])
        batch = x.shape[0] * (1 if self.mesh is None else self.mesh.size)
        self.train_dict["val_loss"].append(val_l1 / batch)
        return val_l1

    @torch.no_grad()
    def get_distr(self, num_samples: int = 16):
        """The reference's mean latent over ``num_samples`` batches: the
        sum of per-image last-block latents divided by batch_size *
        num_samples, then summed over the batch axis."""
        enc_sum = None
        for _ in range(num_samples):
            z = self.model.encode_latent(
                self._batch(self.next_batch(self.content_iter)))
            s = all_reduce_values(self.mesh, {"s": z.sum(dim=0)})["s"]
            enc_sum = s if enc_sum is None else enc_sum + s
        return (enc_sum / (self.cfg.batch_size * num_samples)).sum(dim=0)

    @torch.no_grad()
    def interpolate(self, img_1, img_2, alpha: float = 0.5):
        """decode(alpha * enc(img_1) + (1 - alpha) * enc(img_2)), on this
        rank alone (as JAX computes it on one device)."""
        with local(self.model):
            z1 = self.model.encode_latent(self._batch(img_1))
            z2 = self.model.encode_latent(self._batch(img_2))
            return self.model.decode_latent(alpha * z1 + (1.0 - alpha) * z2)

    # -- the loop ------------------------------------------------------------

    def _drain_aux(self, pending, first_iter):
        """Bring the buffered per-step values to the host in one copy; raise
        if a buffered step saw a non-finite gradient (it applied nothing).
        Returns the last step's (train_loss, perp_loss)."""
        if not pending:
            return None
        keys = ("train_loss", "perp_loss", "grad_norm", "finite")
        host = torch.stack([torch.stack([a[k].float() for k in keys])
                            for a in pending]).cpu().numpy()
        pending.clear()
        for i, (train_loss, perp_loss, norm, finite) in enumerate(host):
            if not finite:
                raise FloatingPointError(
                    f"non-finite gradient norm at iter {first_iter + i}: "
                    f"{norm} (update was skipped, not applied)")
            self.train_dict["train_loss"].append(float(train_loss))
            self.train_dict["perp_loss"].append(float(perp_loss))
        return host[-1, 0], host[-1, 1]

    def train(self, num_iters: int | None = None, log_fn=print):
        cfg = self.cfg
        iters = num_iters if num_iters is not None else cfg.train_iter
        if self.mesh is not None and self.mesh.rank != 0:
            log_fn = _no_log
        log_fn(f"NUM AutoEncoder PARAMETERS: {self.num_params}")
        last_aux, pending, drained_through = None, [], 0
        for cur_iter in range(iters):
            last_aux = self.train_step(self.next_batch(self.content_iter))
            pending.append(last_aux)
            if (cur_iter + 1) % cfg.save_every == 0 or cur_iter + 1 == iters:
                # Drained first: a non-finite step raised here, so a
                # poisoned state is never saved.
                train_loss, perp_loss = self._drain_aux(
                    pending, drained_through + 1)
                drained_through = cur_iter + 1
                log_fn(f"iter {cur_iter + 1}: recon_loss "
                       f"{train_loss * cfg.recon_lam:.6f} perp_loss "
                       f"{perp_loss * cfg.perp_lam:.6f}")
                self.save()
                if (cur_iter + 1) % cfg.validate_every == 0:
                    self.validate()
        return last_aux
