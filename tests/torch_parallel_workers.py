"""Rank functions of the port's multi-process tests (test_torch_parallel*.py).

``parallel.launch.run_ranks`` starts each rank in a fresh "spawn" process,
which imports the function by name: they live here, in a module that
imports neither JAX nor the test modules.  Each takes the rank's ``Mesh``
first; rank 0 hands its host batch to ``shard_batch`` and the other ranks
pass None, as the trainers do.  The same functions run the one-process
reference with a mesh of size 1 (``one_rank``), which issues no collective.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from arbitrarystyletransfer_tpu_torch import ModelConfig, engine, weights
from arbitrarystyletransfer_tpu_torch.config import (
    AETrainConfig,
    ASTTrainConfig,
)
from arbitrarystyletransfer_tpu_torch.models.ast import AST
from arbitrarystyletransfer_tpu_torch.models.autoencoder import AutoEncoder
from arbitrarystyletransfer_tpu_torch.models.mobilenetv2 import dropout
from arbitrarystyletransfer_tpu_torch.models.vgg import VGG19Features
from arbitrarystyletransfer_tpu_torch.ops.norm import BatchNorm2D
from arbitrarystyletransfer_tpu_torch.parallel import (
    all_reduce_grads,
    create_mesh,
    set_mesh,
    shard_batch,
)
from arbitrarystyletransfer_tpu_torch.train import checkpoint as ckpt
from arbitrarystyletransfer_tpu_torch.train.ae_trainer import ae_loss
from arbitrarystyletransfer_tpu_torch.train.ast_trainer import (
    ASTTrainer,
    ast_loss,
)
from arbitrarystyletransfer_tpu_torch.train.state import Adam

COLLECTIVES = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
               "reduce_scatter", "reduce_scatter_tensor", "all_to_all",
               "all_to_all_single", "reduce", "gather", "scatter", "barrier",
               "send", "recv", "isend", "irecv", "broadcast_object_list",
               "all_gather_object")


def one_rank():
    """A CPU mesh of size 1 (no process group)."""
    return create_mesh("cpu", world_size=1)


@contextlib.contextmanager
def counted_collectives():
    """{name: calls} of the ``torch.distributed`` collectives made inside
    the block."""
    calls = {name: 0 for name in COLLECTIVES}
    saved = {name: getattr(dist, name) for name in COLLECTIVES
             if hasattr(dist, name)}

    def wrap(name, fn):
        def counted(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return counted

    for name, fn in saved.items():
        setattr(dist, name, wrap(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


@contextlib.contextmanager
def float64_casts(dtype):
    """The port's ``.float()`` keeps a float64 tensor in float64 when
    ``dtype`` is float64 (as the one-process float64 tests run it)."""
    if dtype != torch.float64:
        yield
        return
    to_f32 = torch.Tensor.float
    torch.Tensor.float = lambda t, *a, **k: (
        t if t.dtype == torch.float64 else to_f32(t, *a, **k))
    try:
        yield
    finally:
        torch.Tensor.float = to_f32


def _host(mesh, x):
    return x if mesh.rank == 0 else None


def _flat_state(module):
    return {k: v.clone() for k, v in
            weights.flatten(weights.module_state(module)).items()}


# -- BatchNorm and the batch --------------------------------------------------


def batchnorm_rank(mesh, x, cot, scale, bias):
    """A float64 ``BatchNorm2D`` in train mode on this rank's rows of ``x``:
    (output rows, input gradient rows, summed scale and bias gradients,
    running mean and var), the cotangent ``cot``'s rows fed back."""
    bn = BatchNorm2D(x.shape[-1]).double()
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    set_mesh(bn, mesh)
    xs = shard_batch(mesh, _host(mesh, x)).requires_grad_(True)
    cs = shard_batch(mesh, _host(mesh, cot))
    y = bn(xs, use_batch_stats=True, update_stats=True)
    dx, ds, db = torch.autograd.grad((y * cs).sum(), [xs, bn.scale, bn.bias])
    ds, none, db = all_reduce_grads(mesh, [ds, None, db],
                                    [bn.scale, bn.mean, bn.bias])
    return {"y": y.detach(), "dx": dx, "dscale": ds, "dbias": db,
            "mean": bn.mean.clone(), "var": bn.var.clone(),
            "none_kept": none is None}


def shard_rank(mesh, batches):
    """This rank's rows of each of rank 0's ``batches``, and for each
    whether ``shard_batch`` raised ``ValueError``."""
    rows, raised = [], []
    for b in batches:
        try:
            rows.append(shard_batch(mesh, _host(mesh, b)))
            raised.append(False)
        except ValueError:
            rows.append(None)
            raised.append(True)
    return rows, raised


# -- the training steps -------------------------------------------------------


def ast_steps_rank(mesh, v, vgg_params, content, style, cases):
    """``ast_step_rank`` for each (dtype, cfg_kw) of ``cases``."""
    return [ast_step_rank(mesh, v, vgg_params, content, style, *case)
            for case in cases]


def ast_step_rank(mesh, v, vgg_params, content, style, dtype, cfg_kw):
    """One AST step (``ast_loss``, the gradients summed, one Adam update)
    in ``dtype`` from the variables ``v``: {"aux", "grads" (by name),
    "state" (the flat state after the update), "collectives"}."""
    cfg = ASTTrainConfig(**cfg_kw)
    ast = AST(ModelConfig(use_pallas_adaattn=True))
    weights.load_state(ast, weights.from_jax_tree(v["params"],
                                                  v["batch_stats"]))
    vgg = VGG19Features()
    vgg.load_params(vgg_params)
    ast.to(dtype)
    vgg.to(dtype)
    set_mesh(ast, mesh)
    c = shard_batch(mesh, _host(mesh, content)).to(dtype)
    s = shard_batch(mesh, _host(mesh, style)).to(dtype)
    named = [(n.replace(".", "/"), p) for n, p in ast.named_parameters()]
    opt = Adam(named, cfg.lr, cfg.adam_b1, cfg.adam_b2, cfg.adam_eps,
               cfg.grad_clip_norm)
    with float64_casts(dtype), counted_collectives() as calls:
        total, aux = ast_loss(ast, vgg, cfg, c, s, mesh=mesh)
        params = [p for _, p in named]
        grads = all_reduce_grads(mesh, torch.autograd.grad(
            total, params, allow_unused=True), params)
        _, ok = opt.apply_if_finite(grads)
    return {"aux": aux, "finite": bool(ok),
            "grads": {f"params/{n}": g for (n, _), g in zip(named, grads)},
            "state": _flat_state(ast), "collectives": dict(calls)}


def ae_steps_rank(mesh, v, vgg_params, x, dtypes):
    """``ae_step_rank`` for each of ``dtypes``."""
    return [ae_step_rank(mesh, v, vgg_params, x, dtype) for dtype in dtypes]


def ae_validate_rank(mesh, save_dir, v, x_val):
    """``AutoencoderTrainer.validate`` on rank 0's validation batch
    ``x_val``: (the L1 it returns, the history's entry)."""
    from arbitrarystyletransfer_tpu_torch.train.ae_trainer import (
        AutoencoderTrainer,
    )

    trainer = AutoencoderTrainer(
        AETrainConfig(save_dir=save_dir, batch_size=x_val.shape[0]), None,
        iter([x_val]) if mesh.rank == 0 else iter(()), device="cpu",
        log_fn=lambda *a: None, mesh=mesh)
    weights.load_state(trainer.model, weights.from_jax_tree(
        v["params"], v["batch_stats"]))
    return trainer.validate(), trainer.train_dict["val_loss"]


def ae_step_rank(mesh, v, vgg_params, x, dtype):
    """One autoencoder step (``ae_loss``, the gradients summed, one Adam
    update): as ``ast_step_rank``."""
    cfg = AETrainConfig()
    ae = AutoEncoder(ModelConfig())
    weights.load_state(ae, weights.from_jax_tree(v["params"],
                                                 v["batch_stats"]))
    vgg = VGG19Features()
    vgg.load_params(vgg_params)
    ae.to(dtype)
    vgg.to(dtype)
    set_mesh(ae, mesh)
    batch = shard_batch(mesh, _host(mesh, x)).to(dtype)
    named = [(n.replace(".", "/"), p) for n, p in ae.named_parameters()]
    opt = Adam(named, cfg.lr, cfg.adam_b1, cfg.adam_b2, cfg.adam_eps,
               cfg.grad_clip_norm)
    with float64_casts(dtype):
        total, aux = ae_loss(ae, vgg, cfg, batch, mesh)
        params = [p for _, p in named]
        grads = all_reduce_grads(mesh, torch.autograd.grad(
            total, params, allow_unused=True), params)
        _, ok = opt.apply_if_finite(grads)
    return {"aux": aux, "finite": bool(ok),
            "grads": {f"params/{n}": g for (n, _), g in zip(named, grads)},
            "state": _flat_state(ae)}


class _Recording:
    """An optimizer that records the gradients it is given, then applies
    them."""

    def __init__(self, opt):
        self.opt, self.grads = opt, None

    def __getattr__(self, name):
        return getattr(self.opt, name)

    def apply_if_finite(self, grads):
        self.grads = {f"params/{n}": g.clone()
                      for n, g in zip(self.opt.names, grads)}
        return self.opt.apply_if_finite(grads)


def gan_step_rank(mesh, save_dir, v, vgg_params, content, style, dis_step,
                  dtype):
    """One ``--use_dis`` step of ``ASTTrainer`` (the discriminator at its
    seeded init, dropout 0.2) in ``dtype`` at the discriminator step
    ``dis_step``: the aux, both models' gradients and states after the
    step, and the dropout masks of the step's three generators on a tensor
    of ones (this rank's rows)."""
    trainer = ASTTrainer(
        ASTTrainConfig(save_dir=save_dir, ae_model="", use_dis=True,
                       batch_size=content.shape[0]),
        None, ModelConfig(use_pallas_adaattn=True), device="cpu",
        log_fn=lambda *a: None, mesh=mesh)
    weights.load_state(trainer.ast, weights.from_jax_tree(
        v["params"], v["batch_stats"]))
    trainer.vgg.load_params(vgg_params)
    for m in (trainer.ast, trainer.vgg, trainer.disc):
        m.to(dtype)
    trainer.buffers = list(trainer.ast.buffers())
    trainer.dis_buffers = list(trainer.disc.buffers())
    trainer._batch = lambda x: torch.as_tensor(x, dtype=dtype)
    trainer.opt = _Recording(trainer.opt)
    trainer.dis_opt = _Recording(trainer.dis_opt)
    trainer.host_dis_step = dis_step
    c = shard_batch(mesh, _host(mesh, content))
    s = shard_batch(mesh, _host(mesh, style))
    ones = torch.ones((c.shape[0], 4, 4, 8), dtype=dtype)
    masks = [dropout(ones, 0.2, True, g, mesh)
             for g in trainer.step_generators()]
    with float64_casts(dtype):
        aux = trainer.train_step(c, s)
    return {"aux": {k: v for k, v in aux.items() if k != "fake"},
            "grads": trainer.opt.grads, "dis_grads": trainer.dis_opt.grads,
            "state": _flat_state(trainer.ast),
            "dis_state": _flat_state(trainer.disc), "masks": masks,
            "steps": (int(trainer.step), int(trainer.dis_step))}


def finite_guard_rank(mesh, save_dir, content, style):
    """An ``inf`` in rank 1's rows: the step's ``finite``, whether the
    state (models, moments, counters, buffers) is unchanged, and whether
    the drain raised."""
    trainer = ASTTrainer(
        ASTTrainConfig(save_dir=save_dir, ae_model="",
                       batch_size=content.shape[0]),
        None, ModelConfig(use_pallas_adaattn=True), device="cpu",
        log_fn=lambda *a: None, mesh=mesh)

    def snapshot():
        return [t.clone() for t in (*trainer.params, *trainer.buffers,
                                    trainer.opt.mu, trainer.opt.nu,
                                    trainer.opt.count, trainer.step)]

    before = snapshot()
    poisoned = content.copy()
    poisoned[content.shape[0] // mesh.size, 3, 3, 0] = np.inf
    aux = trainer.train_step(shard_batch(mesh, _host(mesh, poisoned)),
                             shard_batch(mesh, _host(mesh, style)))
    unchanged = all(torch.equal(a, b) for a, b in zip(before, snapshot()))
    try:
        trainer._drain_aux([aux], 1)
        raised = False
    except FloatingPointError:
        raised = True
    return {"finite": bool(aux["finite"]), "unchanged": unchanged,
            "raised": raised, "step": int(trainer.step),
            "count": int(trainer.opt.count)}


def resume_rank(mesh, save_dir, batches):
    """``ASTTrainer.train`` over two of ``batches`` (rank 0's loader),
    saving under ``save_dir``; a trainer resumed from that checkpoint and
    the first one then take a step on the third.  Returns the checkpoint
    writes this rank made in the first two steps, both states after the
    third (models, moments, step) and the first's history."""
    writes = []
    real_save = ckpt.save_checkpoint

    def counted_save(path, *args, **kwargs):
        writes.append(os.path.basename(path))
        return real_save(path, *args, **kwargs)

    def trainer(load, loader):
        return ASTTrainer(
            ASTTrainConfig(save_dir=save_dir, ae_model="", load=load,
                           batch_size=batches[0][0].shape[0]),
            loader if mesh.rank == 0 else None,
            ModelConfig(use_pallas_adaattn=True), device="cpu",
            preview_dir=None, log_fn=lambda *a: None, mesh=mesh)

    def state(t):
        flat = _flat_state(t.ast)
        flat.update({"opt/mu": t.opt.mu, "opt/nu": t.opt.nu,
                     "step": t.step})
        return flat

    loader = iter(batches)
    whole = trainer(False, loader)
    ckpt.save_checkpoint = counted_save
    try:
        whole.train(2, log_fn=lambda *a: None)
    finally:
        ckpt.save_checkpoint = real_save
    resumed = trainer(True, iter(batches[2:]))
    whole.train(1, log_fn=lambda *a: None)
    resumed.train(1, log_fn=lambda *a: None)
    return {"writes": writes, "whole": state(whole),
            "resumed": state(resumed), "history": whole.train_dict}


# -- serving ------------------------------------------------------------------


def serve_rank(mesh, state, content, style, alpha, kw):
    """This rank's rows through ``engine.stylize_fused_sharded`` (the
    collectives it made counted) and the whole batch through
    ``parallel.gather_batch``."""
    from arbitrarystyletransfer_tpu_torch.parallel import gather_batch

    state = weights.to_device(state, "cpu")
    c = shard_batch(mesh, _host(mesh, content))
    s = shard_batch(mesh, _host(mesh, style))
    with counted_collectives() as calls:
        t = time.perf_counter()
        out = engine.stylize_fused_sharded(state, c, s, alpha, mesh, **kw)
        seconds = time.perf_counter() - t
    return {"rows": out, "collectives": dict(calls), "seconds": seconds,
            "gathered": gather_batch(mesh, out)}


def pipeline_rank(mesh, params, batch_stats, content, style, alpha):
    """``StylePipeline(engine="flax")`` with batch-statistics BatchNorm
    over the mesh, the weights given through ``load_state``: ``stylize``
    at ``alpha`` and 1 and ``export_forward`` (the whole batch on every
    rank)."""
    from arbitrarystyletransfer_tpu_torch.infer import StylePipeline

    pipe = StylePipeline(ModelConfig(use_pallas_adaattn=True),
                         engine="flax", device="cpu", mesh=mesh)
    pipe.load_state(params, batch_stats)
    c, s = _host(mesh, content), _host(mesh, style)
    return {"stylize": pipe.stylize(c, s, alpha),
            "stylize_1": pipe.stylize(c, s, 1.0),
            "export": pipe.export_forward(c, s)}


# -- the kernel library's build -----------------------------------------------


def build_once(mesh, out_dir, log_path):
    """``_build.build_library`` with a fake compile that takes a second and
    logs each call, started on every rank at once: the path it returned."""
    from pathlib import Path

    from arbitrarystyletransfer_tpu_torch.ops.kernels import _build
    from arbitrarystyletransfer_tpu_torch.parallel import barrier

    os.environ["AST_TORCH_BUILD_DIR"] = out_dir

    def fake_compile(sources, flags, target: Path):
        with open(log_path, "a") as f:
            f.write(f"{os.getpid()}\n")
        time.sleep(1.0)
        tmp = target.with_name(target.name + ".tmp")
        tmp.write_bytes(b"fake library")
        os.replace(tmp, target)
        return "compiled"

    _build._compile = fake_compile
    barrier(mesh)
    path, log = _build.build_library()
    return str(path), log
