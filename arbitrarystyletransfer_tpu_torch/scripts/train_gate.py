"""Where the f32 train step departs from float64, batch by batch, on the card.

    python -m arbitrarystyletransfer_tpu_torch.scripts.train_gate \\
        [--smoke-gen] [--seeds 16] [--contrasts 1,0.5,0.25] [--out PATH]
        [--dump-seeds 108,115]
    python -m arbitrarystyletransfer_tpu_torch.scripts.train_gate \\
        --analyze build/bwd_inputs_108.pt

Run from the repository root (it drives ``chip_smoke.py``'s train phase).
Builds the train phase's ``ASTTrainer`` (the parity tests' weights, the
head normalized), then for each batch:

* the step through the kernels against the step whose AdaAttN stage runs
  in float64 (``chip_smoke.kernel_vs_twin_step`` without its gate), with
  the loss of the step under plain variants of the AdaAttN stage that
  change one stage of the f32 forward at a time: the logits (a float32
  product, the f32 kernel's summation order emulated, float64 rounded to
  float32, float64), the exponentials (float32 or float64) and the sums
  (float32 or float64);
* the forward's stages on each AdaAttN module's (q, k, v) of that step:
  the distance to float64 of the logits, m, l, mean and std of the kernel,
  of its twin and of the variants, and each row's (mean / std)^2 beside
  the rows with the largest errors.

Batches: with ``--smoke-gen``, the train phase's own (its head batch and
its ``STEP_BATCHES``) from ``chip_smoke.py``'s shared generator as it
stands when the train phase starts with ``FLAT_OWN_GEN = ()``, which
means running the phases that draw from it first; then ``--seeds``
uniform batches, each from a generator of its own (seed 100 + i), at each
style contrast of ``--contrasts`` (style = 0.5 + c (u - 0.5)).  One JSON
object per batch goes to ``--out``.  ``--dump-seeds`` saves the backward
inputs of those seeds' batches; ``--analyze`` reads such files on the CPU
and prints how far the backward lands from float64 with T - D in float32
and in float64 (``analyze_dump``).  Runs need CUDA and fail without it.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

SEED_BASE = 100


def stage(logits="f32", exp64=False, sums64=True):
    """A plain AdaAttN statistics function (q, k, v) -> (mean, std) in
    float32, differentiable: logits "f32" (one float32 product), "dot4"
    (the f32 kernel's order: four-channel fma chains added in turn),
    "f64r" (float64, rounded to float32) or "f64"; exp in float32 unless
    ``exp64``; the sums in float64 if ``sums64``.  Also returns m and l
    when called with ``full=True``."""
    import torch

    from arbitrarystyletransfer_tpu_torch.ops.stats import safe_sqrt

    def fn(q, k, v, full=False):
        s = LOGITS[logits](q, k)
        m = s.amax(dim=-1, keepdim=True)
        z = s - m
        if not exp64:
            z = z.float()
        p = torch.exp(z)
        acc = torch.float64 if sums64 else torch.float32
        p = p.to(acc)
        vv = v.to(acc)
        l = p.sum(dim=-1, keepdim=True)
        mean = (p @ vv) / l
        ev2 = (p @ vv.square()) / l
        std = safe_sqrt(ev2 - mean.square())
        if full:
            return mean.float(), std.float(), m[..., 0].float(), l[..., 0]
        return mean.float(), std.float()

    return fn


def _logits_f32(q, k):
    return q.float() @ k.float().transpose(1, 2)


def _logits_f64(q, k):
    return q.double() @ k.double().transpose(1, 2)


def _logits_dot4(q, k):
    """q k^T summed as ``csrc/common.cuh``'s ``adaattn_logits``: for each
    four channels d..d+3, t = fma(a3, b3, fma(a2, b2, fma(a1, b1, a0 b0)))
    in float32, then s += t.  A float32 fma is its float64 result rounded
    once (the float64 product of two float32 values is exact)."""
    qd, kd = q.double(), k.double().transpose(1, 2)
    s = None
    for d in range(0, q.shape[-1], 4):
        t = (qd[..., d, None] * kd[:, None, d]).float()
        for e in range(1, 4):
            t = (qd[..., d + e, None] * kd[:, None, d + e]
                 + t.double()).float()
        s = t if s is None else s + t
    return s


LOGITS = {"f32": _logits_f32, "f64": _logits_f64, "dot4": _logits_dot4,
          "f64r": lambda q, k: _logits_f64(q, k).float()}
VARIANTS = {
    "f64 logits, f64 exp, f64 sums": stage("f64", exp64=True),
    "f32 logits, f32 exp, f64 sums": stage("f32"),
    "dot4 logits, f32 exp, f64 sums": stage("dot4"),
    "f64 logits rounded, f32 exp, f64 sums": stage("f64r"),
    "f64 logits, f32 exp, f64 sums": stage("f64"),
    "f64 logits, f64 exp, f32 sums": stage("f64", exp64=True, sums64=False),
}


def capture_inputs(trainer, batch):
    """Each AdaAttN module's (q, k, v) in the kernel step on ``batch``;
    the BatchNorm buffers are restored."""
    import torch

    from arbitrarystyletransfer_tpu_torch.ops.kernels import adaattn_fwd
    from arbitrarystyletransfer_tpu_torch.train.ast_trainer import ast_loss

    seen = []
    real = adaattn_fwd.adaattn_statistics

    def grab(q, k, v):
        seen.append(tuple(t.detach().clone() for t in (q, k, v)))
        return real(q, k, v)

    buffers = [b.clone() for b in trainer.buffers]
    adaattn_fwd.adaattn_statistics = grab
    try:
        with torch.no_grad():
            ast_loss(trainer.ast, trainer.vgg, trainer.cfg,
                     *(trainer._batch(x) for x in batch))
    finally:
        adaattn_fwd.adaattn_statistics = real
        for b, saved in zip(trainer.buffers, buffers):
            b.copy_(saved)
    return seen


def stage_distances(q, k, v):
    """{form: {stage: distance}} to float64 of the kernel, the twin and the
    variants, with the rows of the largest errors and their (mean /
    std)^2."""
    import torch

    from arbitrarystyletransfer_tpu_torch.ops.kernels.adaattn_fwd import (
        adaattn_fwd,
        adaattn_fwd_reference,
    )

    mean64, std64, m64, l64 = stage("f64", exp64=True)(q, k, v, full=True)
    # (mean / std)^2 per row from the float64 stage, unrounded.
    s64 = _logits_f64(q, k)
    p = torch.exp(s64 - s64.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    mu = p @ v.double()
    var = (p @ v.double().square() - mu.square()).clamp_min(1e-300)
    ratio = (mu.square() / var).amax(dim=-1)  # (B, Nc)
    vmax = float(v.abs().max())
    forms = {"kernel": adaattn_fwd(q, k, v),
             "twin": adaattn_fwd_reference(q, k, v)}
    for name in ("f32", "dot4", "f64r"):
        forms[f"{name} logits, f64 sums"] = stage(name)(q, k, v, full=True)
    out = {"ratio_max": float(ratio.max()),
           "logits": {name: float((LOGITS[name](q, k).double()
                                   - s64).abs().max())
                      for name in ("f32", "dot4", "f64r")}}
    dot4_m = _logits_dot4(q, k).amax(dim=-1)
    out["kernel_m_equals_dot4"] = float(
        (forms["kernel"][2] == dot4_m).float().mean())
    for name, (mean, std, m, l) in forms.items():
        e_mean = (mean.double() - mean64.double()).abs().amax(dim=-1) / vmax
        e_std = (std.double() - std64.double()).abs().amax(dim=-1) / vmax
        rec = {"m": float((m.double() - m64.double()).abs().max()),
               "l": float(((l.double() - l64.double()) / l64.double()).abs()
                          .max()),
               "mean": float(e_mean.max()), "std": float(e_std.max())}
        for what, e in (("mean", e_mean), ("std", e_std)):
            top = torch.topk(e.flatten(), 3).indices
            rec[f"{what}_worst_rows"] = [
                [float(e.flatten()[i]), float(ratio.flatten()[i])]
                for i in top]
        rec["std_at_max_ratio"] = float(e_std.flatten()[ratio.argmax()])
        out[name] = rec
    return out


def dump_backward_inputs(trainer, batch, path):
    """Saves each AdaAttN module's backward inputs in the kernel step on
    ``batch`` (q, k, v, the forward's mean, std, m, l and the cotangents
    dmean, dstd) to ``path``; the BatchNorm buffers are restored."""
    import torch

    from arbitrarystyletransfer_tpu_torch.ops.kernels import adaattn_bwd
    from arbitrarystyletransfer_tpu_torch.ops.kernels import adaattn_fwd

    seen, folds = [], []
    real_fold, real_dq = adaattn_fwd.fold_cotangents, adaattn_bwd.adaattn_dq

    def fold(mean, std, dmean, dstd, v):
        folds.append({"mean": mean, "std": std, "dmean": dmean,
                      "dstd": dstd})
        return real_fold(mean, std, dmean, dstd, v)

    def dq(q, k, v, vbar, dm1, dm2, m, l, d_row, splits=None):
        seen.append({"q": q, "k": k, "v": v, "m": m, "l": l})
        return real_dq(q, k, v, vbar, dm1, dm2, m, l, d_row, splits)

    buffers = [b.clone() for b in trainer.buffers]
    adaattn_fwd.fold_cotangents, adaattn_bwd.adaattn_dq = fold, dq
    try:
        trainer.loss_and_grads(*batch)
    finally:
        adaattn_fwd.fold_cotangents = real_fold
        adaattn_bwd.adaattn_dq = real_dq
        for b, saved in zip(trainer.buffers, buffers):
            b.copy_(saved)
    torch.save([{k: t.detach().cpu() for k, t in {**a, **f}.items()}
                for a, f in zip(seen, folds)], path)


def analyze_dump(path):
    """For each module of a ``dump_backward_inputs`` file (CPU is enough):
    the largest (mean / std)^2, and dq, dk, dv's distance (relative to the
    largest of each) to the backward in float64 from the same residuals,
    of the centred backward with T - D in float32 and in float64 (the
    logits in float64, P and the products in float32 otherwise, as the
    kernels form them).  Returns one dict per module."""
    import torch

    from arbitrarystyletransfer_tpu_torch.ops.kernels.adaattn_fwd import (
        fold_cotangents,
    )

    out = []
    for d in torch.load(path):
        q, k, v, m, l = (d[n] for n in ("q", "k", "v", "m", "l"))
        vbar, dm1, dm2, d_row = fold_cotangents(d["mean"], d["std"],
                                                d["dmean"], d["dstd"], v)
        s = q.double() @ k.double().transpose(1, 2) - m.double()[..., None]
        vc = v.double() - vbar.double()[:, None]

        def grads(p, t_minus_d, dt):
            ds = (p.double() * t_minus_d).to(dt)
            pt = p.to(dt).transpose(1, 2)
            return (ds @ k.to(dt), ds.transpose(1, 2) @ q.to(dt),
                    pt @ dm1.to(dt) + 2 * vc.to(dt) * (pt @ dm2.to(dt)))

        def t_minus_d(dt):
            t = dm1.to(dt) @ vc.to(dt).transpose(1, 2) + dm2.to(dt) @ (
                vc.to(dt).square().transpose(1, 2))
            return t.double() - d_row.to(dt).double()[..., None]

        ref = grads(torch.exp(s) / l.double()[..., None], t_minus_d(
            torch.float64), torch.float64)
        p32 = torch.exp(s.float()) / l[..., None]
        rec = {"ratio": float((d["mean"].double().square()
                               / d["std"].double().square().clamp_min(1e-300)
                               ).max())}
        for name, dt in (("T-D f32", torch.float32),
                         ("T-D f64", torch.float64)):
            got = grads(p32, t_minus_d(dt), torch.float32)
            rec[name] = [float((g.double() - r).abs().max() / r.abs().max())
                         for g, r in zip(got, ref)]
        out.append(rec)
    return out


def smoke_generator(smoke):
    """chip_smoke's shared generator as the train phase finds it with
    ``FLAT_OWN_GEN = ()``: runs the phases that draw from it (the routes
    phase only draws its requests)."""
    import torch

    from arbitrarystyletransfer_tpu_torch.ops.kernels import _build
    from arbitrarystyletransfer_tpu_torch.ops.kernels.flat_block import (
        flat_block,
        flat_block_reference,
    )
    from arbitrarystyletransfer_tpu_torch.ops.kernels.flat_s2 import (
        flat_s2_block,
        flat_s2_block_reference,
    )

    smoke.FLAT_OWN_GEN = ()
    _build.load_library()
    gen = torch.Generator(device=smoke.DEVICE).manual_seed(smoke.SEED)
    gen6 = torch.Generator(device=smoke.DEVICE).manual_seed(smoke.SEED + 6)
    with torch.inference_mode():
        smoke.expand_dw_phase(gen)
        smoke.adaattn_phase(gen, gen6)
        smoke.flat_kernel_phase(gen, "flat_block", flat_block,
                                flat_block_reference, smoke.FLAT_BLOCK_CASES,
                                1)
        smoke.flat_kernel_phase(gen, "flat_s2_block", flat_s2_block,
                                flat_s2_block_reference, smoke.FLAT_S2_CASES,
                                2)
    smoke.adaattn_bwd_phase(gen)
    shape = (smoke.BATCH, smoke.SIZE, smoke.SIZE, 3)
    for _ in range(2 * len(smoke.ALPHAS)):  # routes_phase's requests
        torch.rand(shape, generator=gen, device=smoke.DEVICE)
    return gen


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke-gen", action="store_true")
    ap.add_argument("--seeds", type=int, default=16)
    ap.add_argument("--contrasts", default="1,0.5,0.25")
    ap.add_argument("--out", default="build/train_gate.jsonl")
    ap.add_argument("--dump-seeds", default="",
                    help="comma-separated seeds whose batches' backward "
                    "inputs go to bwd_inputs_<seed>.pt beside --out")
    ap.add_argument("--analyze", nargs="*", default=[],
                    help="dump files of --dump-seeds to analyze on the CPU "
                    "(analyze_dump), instead of a run")
    args = ap.parse_args(argv)

    import torch

    if args.analyze:
        for path in args.analyze:
            for i, rec in enumerate(analyze_dump(path)):
                print(json.dumps({"dump": path, "module": i, **rec}))
        return 0
    if not torch.cuda.is_available():
        print("train_gate: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    size = smoke.TRAIN_SIZES[-1]

    def seeded(seed, contrast):
        content, style = smoke.seeded_batch(seed)
        if contrast == 1.0:
            return content, style
        return content, 0.5 + contrast * (style - 0.5)

    if args.smoke_gen:
        head = smoke._uniform_batches(smoke_generator(smoke), size)
    else:
        head = iter([seeded(SEED_BASE - 1, 1.0)])
    jobs = []
    if args.smoke_gen:
        jobs += [(f"smoke step batch {i + 1}", None)
                 for i in range(smoke.STEP_BATCHES)]
    for c in (float(x) for x in args.contrasts.split(",")):
        n = args.seeds if c == 1.0 else max(args.seeds // 2, 1)
        jobs += [(f"seed {SEED_BASE + i} contrast {c}",
                  (SEED_BASE + i, c)) for i in range(n)]
    out_dir = Path(args.out).parent
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp, open(args.out, "w") as out:
        trainer = smoke.make_trainer(tmp, head)
        for seed in filter(None, args.dump_seeds.split(",")):
            dump_backward_inputs(trainer, smoke.seeded_batch(int(seed)),
                                 out_dir / f"bwd_inputs_{seed}.pt")
        for label, src in jobs:
            batch = next(head) if src is None else seeded(*src)
            smoke.log(f"== {label}")
            rec = {"batch": label}
            rec["step"] = smoke.kernel_vs_twin_step(
                trainer, batch, variants=VARIANTS, gate=False)
            rec["stages"] = [stage_distances(*qkv)
                             for qkv in capture_inputs(trainer, batch)]
            for i, st in enumerate(rec["stages"]):
                smoke.log(f"  module {i + 1} stages: {json.dumps(st)}")
            out.write(json.dumps(rec) + "\n")
            out.flush()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
