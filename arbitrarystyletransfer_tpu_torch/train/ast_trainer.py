"""Stage-2 AST training: the loss assembly and the trainer, the twin of
``arbitrarystyletransfer_tpu/train/ast_trainer.py``.

The loss is the JAX step's, term for term:

  L = content_lam * L_content + style_lam * L_style + lf_lam * L_localfeat
    + tv_lam * TV(t_cs) + hist_lam * EMD-hist(t_cs, style)
    + org_img_lam * L_identity
    + out_of_range_lam * huber(t_cs, clip(detach(t_cs), 0, 1))

over six VGG taps taken in one 4B-batch pass over [content, style, t_cs,
org_out], with the tap weights 1, 0.75 (fifth) and 0.5 (last) in the style
loss.  ``detach`` stands where JAX writes ``stop_gradient``: the content and
style taps, the re-encode input, the out-of-range target and the re-encoded
maps.  The running statistics update in the JAX order: the identity encode
(inside ``AST.forward``), then the re-encode of the stylized image.

One device, eagerly: the step is a forward, ``torch.autograd.grad`` and the
optimizer, with no host sync; per-step values stay on the device until a
log or save boundary drains them.  A step whose global gradient norm is not
finite changes nothing (parameters, moments, step, BatchNorm buffers) and
raises at the next drain, as in JAX.
"""

from __future__ import annotations

import os
from typing import Callable, Iterator

import numpy as np
import torch

from .. import weights
from ..config import ASTTrainConfig, ModelConfig
from ..losses import compute_hist_loss, compute_style_loss, huber_loss, tv_loss
from ..models.ast import AST
from ..models.vgg import (
    VGG19Features,
    find_vgg_weights,
    init_vgg_params,
    load_torch_vgg19_state_dict,
)
from ..ops.stats import mean_variance_norm
from . import checkpoint as ckpt
from .state import Adam

TRAIN_DICT_KEYS = ("content_loss", "style_loss", "lf_loss", "tv_loss",
                   "org_img_loss")
VGG_WARNING = ("WARNING: no VGG-19 weight file found — perceptual losses use "
               "seeded random init (pass --vgg_weights or set VGG19_WEIGHTS)")


def _no_mark(name: str) -> None:
    del name


def ast_loss(ast: AST, vgg: VGG19Features, cfg: ASTTrainConfig,
             content: torch.Tensor, style: torch.Tensor,
             debug_stats: bool = False,
             mark: Callable[[str], None] = _no_mark):
    """(total, aux) of one batch: the JAX ``loss_fn``.  Runs the model in
    train mode, so the encoder's running statistics move.  ``mark(name)``
    is called at the end of each phase ("forward", "vgg", "losses")."""
    t_cs, (sm1, sm2), org_out = ast(content, style, 1.0, train=True)
    with torch.no_grad():
        enc_stylized = ast.reencode(t_cs.detach(), train=True)
    mark("forward")

    b = content.shape[0]
    taps = vgg(torch.cat([content, style, t_cs, org_out], dim=0))
    mark("vgg")

    content_loss = style_loss = org_img_loss = 0.0
    n_taps = len(taps)
    for i, tap in enumerate(taps):
        content_map = tap[:b].detach()
        style_map = tap[b:2 * b].detach()
        t_cs_map = tap[2 * b:3 * b]
        org_out_map = tap[3 * b:]
        content_loss = content_loss + huber_loss(
            mean_variance_norm(t_cs_map), mean_variance_norm(content_map))
        if i == n_taps - 1:
            style_weight = 0.5
        elif i == n_taps - 2:
            style_weight = 0.75
        else:
            style_weight = 1.0
        style_loss = style_loss + style_weight * compute_style_loss(
            t_cs_map, style_map)
        org_img_loss = org_img_loss + huber_loss(org_out_map, content_map)

    content_loss = content_loss + huber_loss(
        mean_variance_norm(t_cs), mean_variance_norm(content)
    ) * cfg.pixel_content_weight
    out_of_range_loss = huber_loss(
        t_cs, torch.clamp(t_cs.detach(), 0.0, 1.0)) * cfg.out_of_range_lam
    hist_loss = compute_hist_loss(t_cs, style) * cfg.hist_lam
    org_img_loss = org_img_loss + (
        (content - org_out).square().mean() * cfg.identity_mse_weight)
    org_img_loss = org_img_loss * cfg.org_img_lam
    style_loss = style_loss + compute_style_loss(
        t_cs, style) * cfg.pixel_style_weight

    local_f_loss = 0.0
    for t_map, enc_map in zip((sm1, sm2), enc_stylized):
        local_f_loss = local_f_loss + huber_loss(
            mean_variance_norm(t_map), mean_variance_norm(enc_map.detach()))

    cur_tv_loss = tv_loss(t_cs)
    total = (cfg.content_lam * content_loss + cfg.style_lam * style_loss
             + cfg.lf_lam * local_f_loss + cfg.tv_lam * cur_tv_loss
             + hist_loss + org_img_loss + out_of_range_loss)
    aux = {"content_loss": content_loss, "style_loss": style_loss,
           "lf_loss": local_f_loss, "tv_loss": cur_tv_loss,
           "org_img_loss": org_img_loss, "hist_loss": hist_loss,
           "out_of_range_loss": out_of_range_loss, "loss": total}
    if debug_stats:
        aux.update(t_cs_min=t_cs.min(), t_cs_max=t_cs.max(),
                   sm1_max=sm1.abs().max(), sm2_max=sm2.abs().max(),
                   enc_styl_max=enc_stylized[1].abs().max(),
                   org_out_min=org_out.min(), org_out_max=org_out.max())
    aux = {k: v.detach() for k, v in aux.items()}
    mark("losses")
    return total, aux


class ASTTrainer:
    """Builds the AST (seeded init) and the frozen VGG, warm-starts from a
    Stage-1 AE checkpoint of the port unless resuming, and trains with the
    full loss; saves the model, optimizer and history every ``save_every``
    steps and at the end, and renders alpha-{0, 0.5, 1} previews to files
    when ``preview_dir`` is set.  Runs on ``device`` (CUDA by default) and
    never falls back to another."""

    def __init__(self, cfg: ASTTrainConfig,
                 content_iter: Iterator[tuple[np.ndarray, np.ndarray]],
                 model_cfg: ModelConfig = ModelConfig(), seed: int = 0,
                 vgg_weights: str | None = None,
                 preview_dir: str | None = None, debug_stats: bool = False,
                 device="cuda", log_fn=print):
        if cfg.use_dis:
            raise NotImplementedError(
                "use_dis: the adversarial step is the GAN slice of the port, "
                "ROADMAP queue 1 item 9")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ASTTrainer: device cuda, but CUDA is not "
                               "available (pass device='cpu' to train on the "
                               "CPU)")
        self.cfg = cfg
        self.content_iter = content_iter
        self.preview_dir = preview_dir
        self.debug_stats = debug_stats

        self.ast = AST(model_cfg)
        weights.load_state(self.ast, weights.init_params(
            model_cfg, torch.Generator().manual_seed(seed)))
        self.ast.to(self.device)
        self.vgg = VGG19Features(model_cfg.vgg_content_layers)
        # The file the perceptual losses use; None for the seeded init.
        self.vgg_weights_path = vgg_path = vgg_weights or find_vgg_weights()
        if vgg_path:
            vgg_params = load_torch_vgg19_state_dict(vgg_path)
        else:
            log_fn(VGG_WARNING)
            vgg_params = init_vgg_params(model_cfg.vgg_content_layers,
                                         torch.Generator().manual_seed(1))
        self.vgg.load_params(vgg_params)
        self.vgg.to(self.device)

        self.params = list(self.ast.parameters())
        self.buffers = list(self.ast.buffers())
        self._new_optimizer()
        self.step = torch.zeros((), dtype=torch.int64, device=self.device)

        self.save_file = os.path.join(cfg.save_dir, "ast.pt")
        self.train_dict_file = os.path.join(cfg.save_dir,
                                            "ast_train_dict.json")
        self.train_dict = {k: [] for k in TRAIN_DICT_KEYS}
        if cfg.load:
            self.load()
        elif cfg.ae_model and ckpt.checkpoint_exists(cfg.ae_model + ".pt"):
            self.load_ae(cfg.ae_model + ".pt")
        self.num_params = sum(p.numel() for p in self.params)

    def _new_optimizer(self):
        c = self.cfg
        self.opt = Adam(
            [(n.replace(".", "/"), p) for n, p in self.ast.named_parameters()],
            c.lr, c.adam_b1, c.adam_b2, c.adam_eps, c.grad_clip_norm)

    # -- the step ------------------------------------------------------------

    def _batch(self, x) -> torch.Tensor:
        """A numpy batch (or tensor) as a float32 tensor on the device."""
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def loss_and_grads(self, content, style, mark=_no_mark):
        """(total, aux, grads) of one batch, grads one per parameter (None
        for a parameter the loss does not reach).  Moves the BatchNorm
        running buffers; updates nothing else."""
        content, style = self._batch(content), self._batch(style)
        total, aux = ast_loss(self.ast, self.vgg, self.cfg, content, style,
                              self.debug_stats, mark)
        grads = torch.autograd.grad(total, self.params, allow_unused=True)
        mark("backward")
        return total, aux, grads

    def train_step(self, content, style, mark=_no_mark):
        """One optimizer step; returns the aux dict (device tensors), with
        "grad_norm" and "finite" added."""
        before = torch.cat([b.reshape(-1) for b in self.buffers])
        _, aux, grads = self.loss_and_grads(content, style, mark)
        norm, ok = self.opt.apply_if_finite(grads)
        with torch.no_grad():
            after = torch.cat([b.reshape(-1) for b in self.buffers])
            kept = torch.where(ok, after, before)
            torch._foreach_copy_(self.buffers, [
                t.view_as(b) for t, b in
                zip(kept.split([b.numel() for b in self.buffers]),
                    self.buffers)])
            self.step += ok.to(self.step.dtype)
        if self.debug_stats:
            aux["grad_absmean"] = {
                n: g.abs().mean() for n, g in zip(self.opt.names, grads)
                if g is not None}
        aux["grad_norm"], aux["finite"] = norm, ok
        mark("optimizer")
        return aux

    # -- persistence ---------------------------------------------------------

    def save(self):
        ckpt.save_checkpoint(self.save_file, weights.module_state(self.ast),
                             self.opt.state_dict(), self.step)
        ckpt.save_history(self.train_dict_file, self.train_dict)

    def load(self):
        tree = ckpt.restore_checkpoint(self.save_file, self.device)
        weights.load_state(self.ast, tree)
        self.opt.load_state_dict(tree["opt_state"])
        self.step = tree["step"].to(self.device, torch.int64)
        if os.path.exists(self.train_dict_file):
            self.train_dict = ckpt.load_history(self.train_dict_file)

    def load_ae(self, ae_path: str):
        """Warm-start enc, ada_out and dec from a Stage-1 AE checkpoint in
        the port's format (trees "encoder", "ada_out", "decoder"), with a
        fresh optimizer."""
        ae = ckpt.restore_checkpoint(ae_path, self.device)
        cur = weights.module_state(self.ast)
        params, stats = ckpt.transplant_ae_to_ast(
            ae["params"], ae["batch_stats"], cur["params"],
            cur["batch_stats"])
        weights.load_state(self.ast, {"params": params, "batch_stats": stats})
        self._new_optimizer()

    # -- previews ------------------------------------------------------------

    @torch.no_grad()
    def render_previews(self, content, style, step: int):
        if self.preview_dir is None:
            return
        from PIL import Image

        os.makedirs(self.preview_dir, exist_ok=True)
        c = self._batch(content)[:1]
        s = self._batch(style)[:1]
        panels = [c[0], s[0]] + [self.ast.stylize(c, s, alpha)[0]
                                 for alpha in (0.0, 0.5, 1.0)]
        strip = torch.cat(panels, dim=1).cpu().numpy()
        img = Image.fromarray((np.clip(strip, 0, 1) * 255).astype(np.uint8))
        img.save(os.path.join(self.preview_dir, f"preview_{step:08d}.png"))

    # -- the loop ------------------------------------------------------------

    def _drain_aux(self, pending, first_iter, log_fn=None):
        """Bring the buffered per-step values to the host in one copy; raise
        if a buffered step saw a non-finite gradient (it applied nothing)."""
        if not pending:
            return
        keys = TRAIN_DICT_KEYS + ("grad_norm", "finite")
        host = torch.stack([torch.stack([a[k].float() for k in keys])
                            for a in pending]).cpu().numpy()
        last = pending[-1]
        pending.clear()
        for i, row in enumerate(host):
            if not row[-1]:
                raise FloatingPointError(
                    f"non-finite gradient norm at iter {first_iter + i}: "
                    f"{row[-2]} (update was skipped, not applied)")
            for k, value in zip(TRAIN_DICT_KEYS, row):
                self.train_dict[k].append(float(value))
        if log_fn is not None:
            it = first_iter + len(host) - 1
            log_fn(f"iter {it}: " + " ".join(
                f"{k}={v:.5f}" for k, v in zip(TRAIN_DICT_KEYS, host[-1])))
            for name, v in sorted(last.get("grad_absmean", {}).items()):
                log_fn(f"  grad|{name}|.mean = {float(v):.4e}")

    def train(self, num_iters: int | None = None, log_fn=print):
        cfg = self.cfg
        iters = num_iters if num_iters is not None else cfg.train_iter
        log_fn(f"NUM AST PARAMETERS: {self.num_params}")
        last_aux, pending, drained_through = None, [], 0
        for j in range(iters):
            content, style = next(self.content_iter)
            last_aux = self.train_step(content, style)
            pending.append(last_aux)
            log_now = (j + 1) % cfg.log_every == 0
            save_now = (j + 1) % cfg.save_every == 0
            if log_now or save_now or j + 1 == iters:
                self._drain_aux(pending, drained_through + 1,
                                log_fn if log_now else None)
                drained_through = j + 1
            if save_now or j + 1 == iters:
                # Drained first: a non-finite step raised above, so a
                # poisoned state is never saved.
                self.save()
                self.render_previews(content, style, j + 1)
        return last_aux
