"""Data-parallel training of the port on the CPU (2 gloo ranks, spawned by
``run_ranks``): the AST step against JAX's ``make_ast_train_step`` over a
2-device mesh and against one process, the finite guard, checkpoints and
resume (the GAN and autoencoder steps: test_torch_parallel_steps.py).

Each rank holds half of the global batch; under GSPMD JAX's sharded step is
its one-device step on the global batch, and so must the port's be: the
losses, every gradient, the updated parameters and the BatchNorm running
buffers, with the parameters equal bit for bit across the ranks.  float64
is held at ``test_torch_train_step.py``'s limits (1e-12 for the losses,
1e-10 of each gradient's scale, floored at 1e-4 of the largest), float32
at 1e-5 (losses) and 1e-4 of that scale (gradients), or twice the one-process
float32 step's own distance on the gradient where that is larger (see
``_check_against_jax``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from arbitrarystyletransfer_tpu import config as jax_config
from arbitrarystyletransfer_tpu import parallel as jax_parallel
from arbitrarystyletransfer_tpu.models import AST as JaxAST
from arbitrarystyletransfer_tpu.models import VGG19Features as JaxVGG
from arbitrarystyletransfer_tpu.train import create_train_state
from arbitrarystyletransfer_tpu.train import make_ast_train_step

from arbitrarystyletransfer_tpu_torch import ModelConfig, weights
from arbitrarystyletransfer_tpu_torch.models.ast import AST
from arbitrarystyletransfer_tpu_torch.models.vgg import init_vgg_params
from arbitrarystyletransfer_tpu_torch.parallel.launch import run_ranks

import torch_parallel_workers as workers
from test_torch_ops import assert_close, ast_variables
from test_torch_train_step import AUX_KEYS, _grab_gradients, _normalize_head

RANKS = 2
TIMEOUT = 300.0
# A TV weight at which the TV term moves the loss and the gradients by far
# more than the limits: its weight over the ranks (1, it is a sum) is
# pinned, where the batch means take 1 / ranks.
TV_LAM = 0.05
AE_AUX = ("train_loss", "perp_loss", "loss")


def _images(seed, b=2, size=32):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, (b, size, size, 3)).astype(np.float32)
            for _ in range(2)]


def _jax_f64_step(make_step, v, vgg_params, batches):
    """(aux, gradients, batch_stats) of a JAX step in float64 over a
    2-device mesh (``test_torch_train_step._jax_step_f64`` with the state
    replicated and the batches sharded), flat float64 numpy dicts."""
    f32 = jnp.float32
    mesh = jax_parallel.create_mesh(jax.devices()[:RANKS])
    with jax.enable_x64(True):
        jnp.float32 = jnp.float64
        try:
            step = make_step()

            def cast(x):
                return jnp.asarray(x, jnp.float64)

            state = jax_parallel.replicate(mesh, create_train_state(
                jax.tree.map(cast, v["params"]),
                jax.tree.map(cast, v["batch_stats"]), _grab_gradients()))
            out = step(state, jax_parallel.replicate(
                mesh, jax.tree.map(cast, vgg_params)),
                *(jax_parallel.shard_batch(mesh, np.asarray(b, np.float64))
                  for b in batches))
            new_state, aux = out[0], out[1]
            aux = {k: np.float64(a) for k, a in aux.items()}
            grads = weights.flatten({
                "params": jax.tree.map(np.asarray, new_state.opt_state),
                "batch_stats": {}})
            stats = weights.flatten({
                "params": {},
                "batch_stats": jax.tree.map(np.asarray,
                                            new_state.batch_stats)})
        finally:
            jnp.float32 = f32
    return aux, grads, stats


def _grad_limits(ref_grads):
    """{name: scale factor}: each gradient is held relative to its own max,
    floored at 1e-4 of the largest of all (test_torch_train_step.py)."""
    largest = max(float(np.abs(r).max()) for r in ref_grads.values())
    return {name: max(float(np.abs(r).max()), 1e-4 * largest)
            / max(float(np.abs(r).max()), 1e-30)
            for name, r in ref_grads.items()}


def _check_against_jax(ranks64, ranks32, ref, aux_keys, one32):
    """The ranks' float64 and float32 steps against JAX's float64 step
    ``ref``; ``one32`` is the one-process float32 step on the global
    batch."""
    ref_aux, ref_grads, ref_stats = ref
    limits = _grad_limits(ref_grads)
    # float32: 1e-4 of each gradient's scale, or twice the one-process
    # float32 step's own distance there where that is larger.  At the AST
    # test's state one process is 8.8e-4 of the max from float64 on
    # enc/mob_net_11's BatchNorm (the TV case), and the 2 ranks reach up to
    # 0.575 of this limit over 1, 2 and 4 threads per rank
    # (torch_parallel_f32_spread.py).
    limits32 = {}
    for name, rel in limits.items():
        scale = rel * max(float(np.abs(ref_grads[name]).max()), 1e-6)
        own = float(np.abs(np.asarray(one32["grads"][name], np.float64)
                           - ref_grads[name]).max()) / scale
        limits32[name] = rel * max(1e-4, 2 * own)
    for r64, r32 in zip(ranks64, ranks32):
        assert r64["finite"] and r32["finite"]
        for key in aux_keys:
            assert_close(r64["aux"][key], ref_aux[key], 1e-12, key)
            assert_close(r32["aux"][key], ref_aux[key], 1e-5, key)
        assert sorted(r64["grads"]) == sorted(ref_grads)
        for name, rel in limits.items():
            assert_close(r64["grads"][name].numpy(), ref_grads[name],
                         1e-10 * rel, name)
            assert_close(r32["grads"][name], ref_grads[name],
                         limits32[name], name)
        for key, stat in ref_stats.items():
            assert_close(r64["state"][key].numpy(), stat, 1e-11, key)
            assert_close(r32["state"][key], stat, 1e-4, key)
    _assert_replicated(ranks64 + ranks32)


def _assert_replicated(results):
    """The ranks' states after the update are equal bit for bit (results
    come in rank-major pairs of the same case)."""
    for a, b in zip(results[::2], results[1::2]):
        for key in a["state"]:
            assert torch.equal(a["state"][key], b["state"][key]), key


def _rel_scale(state, key):
    """1, or for a running mean the factor that holds it relative to the
    larger of its max and 0.1 (the momentum) times the running std: the
    running mean of zero-centred activations is a sum that cancels, known
    to a share of their spread, not of itself (test_torch_gan.py)."""
    if not (key.startswith("batch_stats/") and key.endswith("/mean")):
        return 1.0
    mean = state[key].abs().max().item()
    std = state[key[:-len("mean")] + "var"].sqrt().max().item()
    return max(mean, 0.1 * std, 1e-6) / max(mean, 1e-6)


def _check_against_one_process(ranks, ref, aux_keys, state="state"):
    """2 ranks against one process in float64: aux, every gradient, the
    state after the update (parameters and running buffers; ``state``
    names it in the results)."""
    limits = _grad_limits({k: g.numpy() for k, g in ref["grads"].items()})
    for r in ranks:
        for key in aux_keys:
            assert_close(r["aux"][key], ref["aux"][key], 1e-12, key)
        for name, rel in limits.items():
            assert_close(r["grads"][name], ref["grads"][name], 1e-10 * rel,
                         name)
        for key, value in ref[state].items():
            assert_close(r[state][key], value, 1e-10 * _rel_scale(
                ref[state], key), key)
    for key in ref[state]:
        assert torch.equal(ranks[0][state][key], ranks[1][state][key]), key


# -- the AST step --------------------------------------------------------------


def test_ast_step_over_two_ranks_matches_jax_and_one_process():
    v = ast_variables(seed=41, proj_gain=1.0)
    vgg_params = init_vgg_params(generator=torch.Generator().manual_seed(42))
    content, style = _images(43)
    ast = AST(ModelConfig())
    weights.load_state(ast, weights.from_jax_tree(v["params"],
                                                  v["batch_stats"]))
    _normalize_head(v, ast, content, style)

    cases = [(torch.float64, {"tv_lam": TV_LAM}),
             (torch.float32, {"tv_lam": TV_LAM}),
             (torch.float64, {})]
    ranks = run_ranks(workers.ast_steps_rank, RANKS, v, vgg_params, content,
                      style, cases, timeout=TIMEOUT)
    per_case = list(zip(*ranks))  # case -> (rank 0, rank 1)
    for results in per_case:
        counts = [r["collectives"] for r in results]
        assert counts[0] == counts[1] and counts[0]["all_reduce"] > 0
        assert not counts[0]["broadcast"]  # the batch was sharded before

    ref = _jax_f64_step(
        lambda: make_ast_train_step(
            JaxAST(jax_config.ModelConfig()), JaxVGG(),
            jax_config.ASTTrainConfig(tv_lam=TV_LAM)),
        v, vgg_params, (content, style))
    assert bool(ref[0]["finite"])
    one32 = workers.ast_step_rank(workers.one_rank(), v, vgg_params, content,
                                  style, torch.float32, {"tv_lam": TV_LAM})
    _check_against_jax(list(per_case[0]), list(per_case[1]), ref, AUX_KEYS,
                       one32)

    one = workers.ast_step_rank(workers.one_rank(), v, vgg_params, content,
                                style, torch.float64, {})
    _check_against_one_process(list(per_case[2]), one, AUX_KEYS)
    # The TV term: its weight is not divided over the ranks.
    tv = per_case[0][0]["aux"]["tv_loss"]
    assert float(TV_LAM * tv) > 1e-3 * float(per_case[0][0]["aux"]["loss"])


# -- the guard, the checkpoints ------------------------------------------------


def test_non_finite_shard_skips_the_step_on_every_rank(tmp_path):
    """An ``inf`` in rank 1's rows: no rank applies the step (parameters,
    buffers, moments and counters unchanged and equal), and the drain
    raises."""
    content, style = _images(60)
    ranks = run_ranks(workers.finite_guard_rank, RANKS, str(tmp_path),
                      content, style, timeout=TIMEOUT)
    for r in ranks:
        assert r == {"finite": False, "unchanged": True, "raised": True,
                     "step": 0, "count": 0}


def test_checkpoint_written_once_and_resume_continues_bit_for_bit(tmp_path):
    """2 ranks, 2 steps: ``ast.pt`` is written once, by rank 0.  A 2-rank
    trainer resumed from it takes step 3 bit for bit as the run that goes
    on does."""
    batches = [tuple(_images(70 + i)) for i in range(3)]
    ranks = run_ranks(workers.resume_rank, RANKS, str(tmp_path), batches,
                      timeout=TIMEOUT)
    assert [r["writes"] for r in ranks] == [["ast.pt"], []]
    for r in ranks:
        assert int(r["resumed"]["step"]) == int(r["whole"]["step"]) == 3
        for key, value in r["whole"].items():
            assert torch.equal(r["resumed"][key], value), key
    assert ranks[0]["history"] == ranks[1]["history"]
