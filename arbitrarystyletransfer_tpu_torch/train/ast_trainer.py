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

With ``use_dis`` the step is JAX's adversarial variant (``train/gan.py``):
the generator's objective gains ``dis_lam * BCE(D(t_cs), 1)``, and the
discriminator then trains on (real = content, fake = the detached t_cs of
the same forward) with Adam(dis_lr, dis_adam_b1, dis_adam_b2, eps 1e-8)
and no clip.  Both updates use the discriminator as it was before the step.
Its dropout masks come from generators that are a function of the step
counter (``gan.step_generators``), so a resumed run continues the stream.

Eagerly: the step is a forward, ``torch.autograd.grad`` and the optimizer,
with no host sync; per-step values stay on the device until a log or save
boundary drains them.  A step whose global gradient norm is not finite
changes nothing (parameters, moments, step, BatchNorm buffers) and raises
at the next drain, as in JAX.

With a ``mesh`` (``parallel.create_mesh``, one process per device) the step
is JAX's sharded step: rank 0's loader batch is sharded over the ranks
(``--batch_size`` is the global batch), the BatchNorms take the global
batch's statistics, each rank's loss is its share of the global loss
(``ast_loss``), the gradients are summed over the ranks, and every rank
then takes the same update, so the state stays replicated bit for bit.
Only rank 0 writes checkpoints, the history and previews.
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
from ..models.mobilenetv2 import Discriminator
from ..models.vgg import (
    VGG19Features,
    find_vgg_weights,
    init_vgg_params,
    load_torch_vgg19_state_dict,
)
from ..ops.stats import mean_variance_norm
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
from . import gan
from .state import Adam, keep_if

TRAIN_DICT_KEYS = ("content_loss", "style_loss", "lf_loss", "tv_loss",
                   "org_img_loss")
VGG_WARNING = ("WARNING: no VGG-19 weight file found — perceptual losses use "
               "seeded random init (pass --vgg_weights or set VGG19_WEIGHTS)")


def load_vgg(model_cfg: ModelConfig, vgg_weights: str | None, device,
             log_fn=print):
    """(the frozen VGG of the perceptual losses on ``device``, the weight
    file it read): ``vgg_weights`` or the file ``find_vgg_weights`` finds,
    else the seeded random init (seed 1) with ``VGG_WARNING`` (the path is
    then None)."""
    vgg = VGG19Features(model_cfg.vgg_content_layers)
    path = vgg_weights or find_vgg_weights()
    if path:
        vgg_params = load_torch_vgg19_state_dict(path)
    else:
        log_fn(VGG_WARNING)
        vgg_params = init_vgg_params(model_cfg.vgg_content_layers,
                                     torch.Generator().manual_seed(1))
    vgg.load_params(vgg_params)
    return vgg.to(device), path


def _no_mark(name: str) -> None:
    del name


def _no_log(*args) -> None:
    del args


def ast_loss(ast: AST, vgg: VGG19Features, cfg: ASTTrainConfig,
             content: torch.Tensor, style: torch.Tensor,
             debug_stats: bool = False,
             mark: Callable[[str], None] = _no_mark,
             adversary: Callable[[torch.Tensor], torch.Tensor] | None = None,
             mesh: Mesh | None = None):
    """(total, aux) of one batch: the JAX ``loss_fn``.  Runs the model in
    train mode, so the encoder's running statistics move.  ``mark(name)``
    is called at the end of each phase ("forward", "vgg", "losses", and
    "adversary" with one).  ``adversary(t_cs)``, when given, is the
    generator's adversarial loss: the total gains ``dis_lam`` times it, aux
    its value as "gen_adv_loss" and the detached stylized batch as "fake"
    (the discriminator's fake batch).

    With a ``mesh`` of more than one rank, ``content`` and ``style`` are
    this rank's rows and ``total`` is this rank's share of the global loss:
    the ranks' totals sum to the loss of the global batch, so their
    gradients are summed (``parallel.all_reduce_grads``).  aux holds the
    global values (one all-reduce)."""
    share = batch_share(mesh)
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
    # Each rank's share of the global loss.  Batch means (1 / ranks): the
    # content loss (Huber means of the taps and the pixels), the style loss
    # (Huber means of per-image statistics and grams), the local-feature
    # loss (Huber means), the histogram loss (mean EMD), the identity loss
    # (Huber means and the pixel MSE mean), the out-of-range loss (a Huber
    # mean), and below the adversarial term (a BCE mean).  The TV loss is a
    # sum over the batch: it is the ranks' sum as it stands (weight 1).
    content_loss, style_loss, local_f_loss, hist_loss, org_img_loss, \
        out_of_range_loss = (shared(t, share) for t in (
            content_loss, style_loss, local_f_loss, hist_loss,
            org_img_loss, out_of_range_loss))
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
    if adversary is not None:
        gen_adv_loss = shared(adversary(t_cs), share)
        total = total + cfg.dis_lam * gen_adv_loss
        aux["gen_adv_loss"] = gen_adv_loss.detach()
        aux["loss"] = total.detach()
        mark("adversary")
    if is_sharded(mesh):
        ops = {k: k.rpartition("_")[2] if k.endswith(("_min", "_max"))
               else "sum" for k in aux}
        for op in ("sum", "min", "max"):
            aux.update(all_reduce_values(mesh, {
                k: v for k, v in aux.items() if ops[k] == op}, op))
    if adversary is not None:
        aux["fake"] = t_cs.detach()
    return total, aux


class ASTTrainer:
    """Builds the AST (seeded init) and the frozen VGG, warm-starts from a
    Stage-1 AE checkpoint of the port unless resuming, and trains with the
    full loss; saves the model, optimizer and history every ``save_every``
    steps and at the end, and renders alpha-{0, 0.5, 1} previews to files
    when ``preview_dir`` is set.  With ``cfg.use_dis`` it also trains the
    discriminator (seeded init, seed + 2) and saves it to
    ``<save_dir>/ast_dis.pt``.  Runs on ``device`` (CUDA by default) and
    never falls back to another.  With a ``mesh`` of more than one rank it
    runs on the mesh's device, data-parallel; ``content_iter`` is read on
    rank 0 only (the others may pass None), and rank 0's state is
    broadcast to the others once built."""

    def __init__(self, cfg: ASTTrainConfig,
                 content_iter: Iterator[tuple[np.ndarray, np.ndarray]],
                 model_cfg: ModelConfig = ModelConfig(), seed: int = 0,
                 vgg_weights: str | None = None,
                 preview_dir: str | None = None, debug_stats: bool = False,
                 device="cuda", log_fn=print, mesh: Mesh | None = None):
        self.mesh = mesh if is_sharded(mesh) else None
        self.device = torch.device(device if self.mesh is None
                                   else self.mesh.device)
        if self.mesh is not None and self.mesh.rank != 0:
            log_fn = _no_log
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ASTTrainer: device cuda, but CUDA is not "
                               "available (pass device='cpu' to train on the "
                               "CPU)")
        self.cfg = cfg
        self.seed = seed
        self.content_iter = content_iter
        self.preview_dir = preview_dir
        self.debug_stats = debug_stats

        self.ast = AST(model_cfg)
        weights.load_state(self.ast, weights.init_params(
            model_cfg, torch.Generator().manual_seed(seed)))
        self.ast.to(self.device)
        self.vgg, self.vgg_weights_path = load_vgg(
            model_cfg, vgg_weights, self.device, log_fn)

        self.params = list(self.ast.parameters())
        self.buffers = list(self.ast.buffers())
        self._new_optimizer()
        self.step = torch.zeros((), dtype=torch.int64, device=self.device)

        self.disc = None
        if cfg.use_dis:
            self.disc = Discriminator()
            weights.load_state(self.disc, weights.init_dis_params(
                torch.Generator().manual_seed(seed + 2)))
            self.disc.to(self.device)
            self.dis_buffers = list(self.disc.buffers())
            self.dis_opt = Adam(
                [(n.replace(".", "/"), p)
                 for n, p in self.disc.named_parameters()],
                cfg.dis_lr, cfg.dis_adam_b1, cfg.dis_adam_b2, 1e-8, None)
            self.dis_step = torch.zeros((), dtype=torch.int64,
                                        device=self.device)
        # Host mirrors of the two step counters: the dropout stream and the
        # R1 cadence must be known before the step's graph is built, and
        # reading the device counters would sync every step.  Set from the
        # counters here, at load and at every drain.
        self.host_step = self.host_dis_step = 0

        self.save_file = os.path.join(cfg.save_dir, "ast.pt")
        self.dis_save_file = os.path.join(cfg.save_dir, "ast_dis.pt")
        self.train_dict_file = os.path.join(cfg.save_dir,
                                            "ast_train_dict.json")
        self.history_keys = TRAIN_DICT_KEYS + (
            ("dis_loss",) if cfg.use_dis else ())
        self.train_dict = {k: [] for k in self.history_keys}
        if cfg.load:
            self.load()
        elif cfg.ae_model and ckpt.find_checkpoint(cfg.ae_model):
            self.load_ae(ckpt.find_checkpoint(cfg.ae_model))
        self.num_params = sum(p.numel() for p in self.params)
        if self.mesh is not None:
            self._replicate()

    def _replicate(self):
        """Rank 0's models, optimizer states and counters on every rank,
        and the mesh given to the models' BatchNorms and dropouts."""
        set_mesh(self.ast, self.mesh)
        state = [*self.params, *self.buffers, self.opt.mu, self.opt.nu,
                 self.opt.count, self.step, *self.vgg.parameters()]
        if self.disc is not None:
            set_mesh(self.disc, self.mesh)
            state += [*self.dis_opt.params, *self.dis_buffers,
                      self.dis_opt.mu, self.dis_opt.nu, self.dis_opt.count,
                      self.dis_step]
        replicate(self.mesh, state)

    def _new_optimizer(self):
        c = self.cfg
        self.opt = Adam(
            [(n.replace(".", "/"), p) for n, p in self.ast.named_parameters()],
            c.lr, c.adam_b1, c.adam_b2, c.adam_eps, c.grad_clip_norm)

    # -- the step ------------------------------------------------------------

    def _batch(self, x) -> torch.Tensor:
        """A numpy batch (or tensor) as a float32 tensor on the device."""
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def step_generators(self):
        """This step's dropout generators (the generator's discriminator
        pass, the real pass, the fake pass), from the host step mirror."""
        return gan.step_generators(self.seed, self.host_step, self.device)

    def loss_and_grads(self, content, style, mark=_no_mark,
                       dis_generator=None):
        """(total, aux, grads) of one batch, grads one per parameter of the
        AST (None for a parameter the loss does not reach).  Moves the AST's
        BatchNorm running buffers; updates nothing else.  With the
        discriminator the loss holds the adversarial term, its dropout
        drawn from ``dis_generator`` (required then), and aux holds "fake",
        the detached stylized batch."""
        content, style = self._batch(content), self._batch(style)
        adversary = None
        if self.disc is not None:
            if dis_generator is None:
                raise ValueError("the adversarial term needs its dropout "
                                 "generator (step_generators()[0])")

            def adversary(t_cs):
                return gan.generator_adversarial_loss(self.disc, t_cs,
                                                      dis_generator)

        total, aux = ast_loss(self.ast, self.vgg, self.cfg, content, style,
                              self.debug_stats, mark, adversary, self.mesh)
        grads = torch.autograd.grad(total, self.params, allow_unused=True)
        grads = all_reduce_grads(self.mesh, grads, self.params)
        mark("backward")
        return total, aux, grads

    def train_step(self, content, style, mark=_no_mark):
        """One optimizer step (and one of the discriminator, with one);
        returns the aux dict (device tensors), with "grad_norm" and
        "finite" added."""
        content, style = self._batch(content), self._batch(style)
        gens = self.step_generators() if self.disc is not None else [None]
        before = torch.cat([b.reshape(-1) for b in self.buffers])
        _, aux, grads = self.loss_and_grads(content, style, mark, gens[0])
        fake = aux.pop("fake", None)
        norm, ok = self.opt.apply_if_finite(grads)
        keep_if(ok, self.buffers, before)
        with torch.no_grad():
            self.step += ok.to(self.step.dtype)
        if self.debug_stats:
            aux["grad_absmean"] = {
                n: g.abs().mean() for n, g in zip(self.opt.names, grads)
                if g is not None}
        aux["grad_norm"], aux["finite"] = norm, ok
        mark("optimizer")
        if self.disc is not None:
            dis_aux, dis_ok = gan.discriminator_step(
                self.disc, self.dis_opt, self.cfg, content, fake, gens[1],
                gens[2], self.host_dis_step, mark=mark, mesh=self.mesh)
            with torch.no_grad():
                self.dis_step += dis_ok.to(self.dis_step.dtype)
            aux.update(dis_aux)
            aux["finite"] = ok & dis_ok
            # The mirror runs ahead of a counter only after a skipped step,
            # and that raises at the next drain, before any save.
            self.host_dis_step += 1
        self.host_step += 1
        return aux

    # -- persistence ---------------------------------------------------------

    def save(self):
        """Write the checkpoints and the history (rank 0 only; every rank
        waits for it)."""
        if self.mesh is None or self.mesh.rank == 0:
            ckpt.save_checkpoint(self.save_file,
                                 weights.module_state(self.ast),
                                 self.opt.state_dict(), self.step)
            if self.disc is not None:
                ckpt.save_checkpoint(self.dis_save_file,
                                     weights.module_state(self.disc),
                                     self.dis_opt.state_dict(),
                                     self.dis_step)
            ckpt.save_history(self.train_dict_file, self.train_dict)
        barrier(self.mesh)

    def load(self):
        """Resume from ``ast.pt`` (and ``ast_dis.pt`` when it exists), or
        the JAX trainer's orbax directories ``ast`` (and ``ast_dis``) in
        the same ``save_dir``, and the history."""
        tree = ckpt.restore_checkpoint(
            ckpt.require_checkpoint(self.save_file), self.device)
        weights.load_state(self.ast, tree)
        self.opt.load_state_dict(tree["opt_state"])
        self.step = tree["step"].to(self.device, torch.int64)
        dis_file = ckpt.find_checkpoint(self.dis_save_file)
        if self.disc is not None and dis_file is not None:
            tree = ckpt.restore_checkpoint(dis_file, self.device)
            weights.load_state(self.disc, tree)
            self.dis_opt.load_state_dict(tree["opt_state"])
            self.dis_step = tree["step"].to(self.device, torch.int64)
        self._sync_host_steps()
        if os.path.exists(self.train_dict_file):
            self.train_dict = ckpt.load_history(self.train_dict_file)
            for k in self.history_keys:
                self.train_dict.setdefault(k, [])

    def _sync_host_steps(self):
        self.host_step = int(self.step)
        if self.disc is not None:
            self.host_dis_step = int(self.dis_step)

    def load_ae(self, ae_path: str):
        """Warm-start enc, ada_out and dec from a Stage-1 AE checkpoint
        (trees "encoder", "ada_out", "decoder": the port's ``ae.pt`` or the
        JAX trainer's orbax directory), with a fresh optimizer."""
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
        """The alpha-{0, 0.5, 1} strip of the first image of the batch
        (rank 0's first row with a mesh, stylized on rank 0 alone)."""
        if self.preview_dir is None or (self.mesh is not None
                                        and self.mesh.rank != 0):
            return
        from PIL import Image

        os.makedirs(self.preview_dir, exist_ok=True)
        c = self._batch(content)[:1]
        s = self._batch(style)[:1]
        with local(self.ast):
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
        keys = self.history_keys + ("grad_norm", "finite")
        host = torch.stack([torch.stack([a[k].float() for k in keys])
                            for a in pending]).cpu().numpy()
        last = pending[-1]
        pending.clear()
        for i, row in enumerate(host):
            if not row[-1]:
                raise FloatingPointError(
                    f"non-finite gradient norm at iter {first_iter + i}: "
                    f"{row[-2]} (update was skipped, not applied)")
            for k, value in zip(self.history_keys, row):
                self.train_dict[k].append(float(value))
        self._sync_host_steps()
        if log_fn is not None:
            it = first_iter + len(host) - 1
            log_fn(f"iter {it}: " + " ".join(
                f"{k}={v:.5f}" for k, v in zip(self.history_keys, host[-1])))
            for name, v in sorted(last.get("grad_absmean", {}).items()):
                log_fn(f"  grad|{name}|.mean = {float(v):.4e}")

    def next_batch(self):
        """The loader's next (content, style); with a mesh, this rank's
        rows of rank 0's batch, on the device."""
        if self.mesh is None:
            return next(self.content_iter)
        host = (next(self.content_iter) if self.mesh.rank == 0
                else (None, None))
        return tuple(shard_batch(self.mesh, h) for h in host)

    def train(self, num_iters: int | None = None, log_fn=print):
        cfg = self.cfg
        iters = num_iters if num_iters is not None else cfg.train_iter
        if self.mesh is not None and self.mesh.rank != 0:
            log_fn = _no_log
        log_fn(f"NUM AST PARAMETERS: {self.num_params}")
        last_aux, pending, drained_through = None, [], 0
        for j in range(iters):
            content, style = self.next_batch()
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
