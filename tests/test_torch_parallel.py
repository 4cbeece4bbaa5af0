"""The port's data parallelism (``arbitrarystyletransfer_tpu_torch.parallel``)
on the CPU: ranks are "spawn" processes over gloo (``run_ranks``, a
``file://`` rendezvous in a temporary directory, a timeout on the join), the
kernels run through their plain twins, and the JAX side runs on the
conftest's virtual CPU devices over a 2-device mesh.

BatchNorm's global statistics against one process in float64, the batch's
sharding, a mesh of size 1 (no collective, the one-device results bit for
bit), the sharded fused engine and the graph pipeline against JAX over its
mesh, the dry run, the kernel library's build under concurrency, the
launch device check, and the train CLI under torchrun's environment.
"""

import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from arbitrarystyletransfer_tpu import config as jax_config
from arbitrarystyletransfer_tpu import parallel as jax_parallel
from arbitrarystyletransfer_tpu.infer import StylePipeline as JaxPipeline
from arbitrarystyletransfer_tpu.models import AST as JaxAST

from arbitrarystyletransfer_tpu_torch import ModelConfig, parallel, weights
from arbitrarystyletransfer_tpu_torch.config import ASTTrainConfig
from arbitrarystyletransfer_tpu_torch.models.ast import AST
from arbitrarystyletransfer_tpu_torch.ops.kernels import _build
from arbitrarystyletransfer_tpu_torch.ops.norm import BatchNorm2D
from arbitrarystyletransfer_tpu_torch.parallel.dryrun import dryrun_multigpu
from arbitrarystyletransfer_tpu_torch.parallel.launch import run_ranks
from arbitrarystyletransfer_tpu_torch.train import checkpoint as ckpt
from arbitrarystyletransfer_tpu_torch.train.ast_trainer import ASTTrainer

import torch_parallel_workers as workers
from test_torch_engine import (
    CFG,
    LANE,
    MIN_FUSED,
    _flax_stylize,
    _images,
    _normalize_head,
)
from test_torch_ops import assert_close, ast_variables, to_jax
from test_torch_train import CLI_ENV, REPO, _write_dataset

RANKS = 2
TIMEOUT = 300.0


def _jax_mesh():
    return jax_parallel.create_mesh(jax.devices()[:RANKS])


# -- BatchNorm -----------------------------------------------------------------


def test_batchnorm_over_two_ranks_equals_one_process():
    """Half the batch on each rank: the outputs, the input and parameter
    gradients (summed by ``all_reduce_grads``) and the running buffers
    equal one process's ``BatchNorm2D`` on the whole batch, in float64 to
    1e-12."""
    rng = np.random.default_rng(0)
    x = rng.normal(0.3, 2.0, (4, 5, 6, 8))
    cot = rng.normal(0, 1, x.shape)
    scale, bias = rng.normal(1, 0.1, 8), rng.normal(0, 0.1, 8)
    ranks = run_ranks(workers.batchnorm_rank, RANKS, x, cot, scale, bias,
                      timeout=TIMEOUT)
    ref = workers.batchnorm_rank(workers.one_rank(), x, cot, scale, bias)
    for key in ("y", "dx"):
        out = torch.cat([r[key] for r in ranks])
        assert_close(out, ref[key], 1e-12, key)
    for key in ("dscale", "dbias", "mean", "var"):
        for r in ranks:
            assert_close(r[key], ref[key], 1e-12, key)
        assert torch.equal(ranks[0][key], ranks[1][key]), key
    # A None gradient goes through the gradients' all-reduce as zeros and
    # comes back as None.
    assert all(r["none_kept"] for r in ranks)


# -- the batch -----------------------------------------------------------------


def test_shard_batch_splits_rank_zeros_batch():
    """The ranks' rows put together are rank 0's batch bit for bit (f32
    and uint8); a batch the ranks cannot share raises on every rank."""
    rng = np.random.default_rng(1)
    f32 = rng.normal(0, 1, (6, 3, 4, 3)).astype(np.float32)
    u8 = rng.integers(0, 256, (4, 5, 3), dtype=np.uint8)
    odd = np.zeros((3, 2), np.float32)
    ranks = run_ranks(workers.shard_rank, RANKS, [f32, u8, odd],
                      timeout=TIMEOUT)
    for i, host in enumerate((f32, u8)):
        joined = torch.cat([rows[i] for rows, _ in ranks]).numpy()
        assert joined.dtype == host.dtype
        assert np.array_equal(joined, host)
        assert [rows[i].shape[0] for rows, _ in ranks] == [len(host) // 2] * 2
    assert [raised for _, raised in ranks] == [[False, False, True]] * 2


def test_mesh_of_one_issues_no_collective_and_changes_nothing(tmp_path):
    """Without torchrun's environment ``create_mesh`` gives a mesh of size
    1: its helpers call no ``torch.distributed`` function, and a trainer
    given it takes the one-device step bit for bit."""
    mesh = parallel.create_mesh("cpu")
    assert (mesh.rank, mesh.size) == (0, 1)
    rng = np.random.default_rng(2)
    content, style = (rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
                      for _ in range(2))

    def trainer(sub, mesh=None):
        cfg = ASTTrainConfig(save_dir=str(tmp_path / sub), ae_model="",
                             batch_size=2)
        return ASTTrainer(cfg, None, ModelConfig(use_pallas_adaattn=True),
                          device="cpu", log_fn=lambda *a: None,
                          **({} if mesh is None else {"mesh": mesh}))

    plain = trainer("plain")
    aux_plain = plain.train_step(content, style)
    with workers.counted_collectives() as calls:
        t = torch.ones(3, requires_grad=True)
        parallel.all_reduce_sum(t, mesh).sum().backward()
        parallel.replicate(mesh, [t])
        parallel.all_reduce_grads(mesh, [t.grad, None])
        parallel.gather_batch(mesh, t)
        parallel.barrier(mesh)
        bn = BatchNorm2D(3)
        parallel.set_mesh(bn, mesh)
        bn(parallel.shard_batch(mesh, content), True, True)
        meshed = trainer("mesh", mesh)
        aux_mesh = meshed.train_step(
            parallel.shard_batch(mesh, content),
            parallel.shard_batch(mesh, style))
        meshed.save()
    assert not any(calls.values()), calls
    assert meshed.mesh is None
    for key, value in aux_plain.items():
        if isinstance(value, torch.Tensor):
            assert torch.equal(aux_mesh[key], value), key
    a = weights.flatten(weights.module_state(plain.ast))
    b = weights.flatten(weights.module_state(meshed.ast))
    assert all(torch.equal(a[k], b[k]) for k in a)


# -- serving -------------------------------------------------------------------


def test_sharded_fused_engine_matches_flax_over_a_mesh():
    """``stylize_fused_sharded`` over 2 ranks (the "auto" route, f32, 64px
    routed as 512px) against JAX's flax ``AST.stylize`` over a 2-device
    mesh; no collective runs inside the engine, and the gathered batch is
    the ranks' rows."""
    content, style = _images(20)
    alpha = 0.8
    v = ast_variables(seed=20)
    _normalize_head(v, content, style, alpha)
    state = weights.from_jax_tree(v["params"], v["batch_stats"])
    kw = dict(cfg=CFG, dtype=torch.float32, min_fused_size=MIN_FUSED,
              encoder_impl="auto", decoder_impl="auto", lane=LANE)
    ranks = run_ranks(workers.serve_rank, RANKS, state, content, style,
                      alpha, kw, timeout=TIMEOUT)
    mesh = _jax_mesh()
    ref = np.asarray(_flax_stylize()(
        jax_parallel.replicate(mesh, to_jax(v)),
        jax_parallel.shard_batch(mesh, content),
        jax_parallel.shard_batch(mesh, style), alpha))
    out = torch.cat([r["rows"] for r in ranks]).numpy()
    for r in ranks:
        assert not any(r["collectives"].values()), r["collectives"]
        assert torch.equal(r["gathered"], torch.from_numpy(out))
    assert out.shape == (2, 64, 64, 3) and np.isfinite(out).all()
    assert np.mean((out == 0.0) | (out == 1.0)) < 0.5
    # test_torch_engine.py's limit for the same route on one device.
    assert_close(out, ref, 1e-4, "sharded stylized image")


def _normalize_graph_head(v, content, style):
    """Rescale and shift the head in ``v`` (in place) so that the port's
    graph with batch-statistics BatchNorm gives a pre-clamp image of
    per-channel mean 0.5 and spatial std 0.25 (``_normalize_head``'s rule
    for the folded engine)."""
    ast = AST(ModelConfig())
    weights.load_state(ast, weights.from_jax_tree(v["params"],
                                                  v["batch_stats"]))
    with torch.no_grad():
        pre = ast.dec(ast.encode(torch.from_numpy(content),
                                 torch.from_numpy(style), train=False))
    pre = pre.double().numpy()
    head = v["params"]["dec"]["img_out"]
    scale = 0.25 / pre.std(axis=(1, 2)).mean(axis=0)
    head["kernel"] = (head["kernel"] * scale).astype(np.float32)
    head["bias"] = (0.5 - scale * (pre.mean(axis=(0, 1, 2)) - head["bias"])
                    ).astype(np.float32)


def test_graph_pipeline_with_batch_statistics_matches_jax_over_a_mesh():
    """``StylePipeline(engine="flax", mesh=)`` with the default
    batch-statistics BatchNorm (global over the ranks) against JAX's
    ``StylePipeline(mesh=<2 devices>)`` after ``load_state`` of the same
    weights, the whole batch on every rank; ``export_forward`` equals
    ``stylize`` at alpha 1 bit for bit (the same graph)."""
    content, style = _images(21)
    alpha = 0.6
    v = ast_variables(seed=21)
    _normalize_graph_head(v, content, style)
    state = weights.from_jax_tree(v["params"], v["batch_stats"])
    ranks = run_ranks(workers.pipeline_rank, RANKS, state["params"],
                      state["batch_stats"], content, style, alpha,
                      timeout=TIMEOUT)
    jv = to_jax(v)
    # The JAX pipeline's own seeded init (an eager flax init, about a
    # minute on the CPU) gives way to the weights it then loads.
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxAST, "init", lambda self, *a, **k: jv)
        jpipe = JaxPipeline(jax_config.ModelConfig(), mesh=_jax_mesh())
    jpipe.load_state(jv["params"], jv["batch_stats"])
    ref = np.asarray(jpipe.stylize(content, style, alpha))
    for key in ("stylize", "export", "stylize_1"):
        assert torch.equal(ranks[0][key], ranks[1][key]), key
    assert torch.equal(ranks[0]["export"], ranks[0]["stylize_1"])
    out = ranks[0]["stylize"].numpy()
    assert out.shape == (2, 64, 64, 3) and np.isfinite(out).all()
    assert np.mean((out == 0.0) | (out == 1.0)) < 0.5
    # test_torch_engine.py's limit for the graph on one device.
    assert_close(out, ref, 1e-4, "stylized image, batch statistics")


# -- the dry run, the build, the launch device ---------------------------------


def test_dryrun_multigpu():
    assert np.isfinite(dryrun_multigpu(RANKS, timeout=TIMEOUT))


def test_concurrent_builds_compile_once(tmp_path):
    """Two processes that build the kernel library at once compile it once
    and load the same file."""
    log = tmp_path / "compiles.log"
    ranks = run_ranks(workers.build_once, RANKS, str(tmp_path / "build"),
                      str(log), timeout=TIMEOUT)
    assert ranks[0][0] == ranks[1][0]
    assert sorted(text for _, text in ranks) == ["", "compiled"]
    assert len(log.read_text().split()) == 1


def test_launch_on_another_card_raises(monkeypatch):
    """A kernel launch on a tensor that is not on the runtime's current
    device raises instead of launching on the wrong card."""
    class OnCard1:
        device = torch.device("cuda", 1)

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(RuntimeError, match="set_device"):
        _build.launch_stream(OnCard1())


def test_create_mesh_refuses_a_missing_card_and_nccl_on_the_cpu():
    """No rank carries on on the CPU when it was given the card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal needs none")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        parallel.create_mesh("cuda", "nccl", rank=1, world_size=2)
    with pytest.raises(ValueError, match="gloo"):
        parallel.create_mesh("cpu", "nccl", rank=1, world_size=2)


@pytest.mark.parametrize("cards", [1, 2, 4])
def test_rank_device_takes_one_card_per_nccl_rank(monkeypatch, cards):
    """With ``cards`` cards: under nccl rank r takes ``cuda:r``, a rank
    past the last card and a device with an index on every rank raise;
    under gloo ranks past the last card share the cards."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    rank_device = parallel.mesh._rank_device
    for r in range(cards):
        assert rank_device("cuda", "nccl", r, cards) == torch.device("cuda", r)
    with pytest.raises(RuntimeError, match="one card per rank"):
        rank_device("cuda", "nccl", cards, cards + 1)
    with pytest.raises(RuntimeError, match="without an index"):
        rank_device("cuda:0", "nccl", 1, 2)
    assert rank_device("cuda:0", "nccl", 0, 1) == torch.device("cuda", 0)
    for r in range(2 * cards):
        assert (rank_device("cuda", "gloo", r, 2 * cards)
                == torch.device("cuda", r % cards))
    assert rank_device("cuda:0", "gloo", 1, 2) == torch.device("cuda", 0)


# -- the CLI -----------------------------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_cli_under_torchrun_environment(tmp_path):
    """``python -m arbitrarystyletransfer_tpu_torch.train --device cpu
    --dist_backend gloo`` in 2 processes with torchrun's environment: one
    ``ast.pt`` and a history equal to the one-process run's (f32: the
    global BatchNorm statistics and gradients are summed in another
    order)."""
    content_dirs, style_dirs = _write_dataset(tmp_path / "data")

    def cli(save_dir):
        return [sys.executable, "-m", "arbitrarystyletransfer_tpu_torch.train",
                "--device", "cpu", "--dist_backend", "gloo",
                "--train_iter", "2", "--img_sizes", "32", "--batch_size", "2",
                "--content_dir", *content_dirs, "--style_dir", *style_dirs,
                "--save_dir", str(save_dir), "--ae_model",
                str(tmp_path / "none"), "--num_workers", "1",
                "--worker_mode", "thread", "--pallas", "--preview_dir",
                str(tmp_path / f"previews_{save_dir.name}")]

    port = str(_free_port())
    procs = [subprocess.Popen(
        cli(tmp_path / "dp"), env={
            **CLI_ENV, "OMP_NUM_THREADS": "1", "RANK": str(r),
            "LOCAL_RANK": str(r), "WORLD_SIZE": str(RANKS),
            "MASTER_ADDR": "localhost", "MASTER_PORT": port},
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(RANKS)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=TIMEOUT))
        finally:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], [e for _, e in outs]
    assert "NUM AST PARAMETERS" in outs[0][0]
    assert "NUM AST PARAMETERS" not in outs[1][0]  # rank 0 logs
    one = subprocess.run(cli(tmp_path / "one"), env=CLI_ENV, cwd=REPO,
                         capture_output=True, text=True, timeout=TIMEOUT)
    assert one.returncode == 0, one.stderr
    assert sorted(os.listdir(tmp_path / "dp")) == sorted(
        os.listdir(tmp_path / "one")) == ["ast.pt", "ast_train_dict.json"]
    assert int(ckpt.restore_checkpoint(str(tmp_path / "dp" / "ast.pt"))[
        "step"]) == 2
    dp = ckpt.load_history(str(tmp_path / "dp" / "ast_train_dict.json"))
    ref = ckpt.load_history(str(tmp_path / "one" / "ast_train_dict.json"))
    assert dp.keys() == ref.keys()
    for key in ref:
        assert len(dp[key]) == len(ref[key]) == 2
        assert_close(dp[key], ref[key], 1e-5, key)
