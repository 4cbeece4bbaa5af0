"""The JAX trainers' orbax checkpoints in the port (``train/orbax.py``,
``convert_orbax``, and the readers that take them: ``restore_checkpoint``,
``StylePipeline.from_checkpoint``, the trainers' ``--load`` and
``--ae_model``).

JAX's own ``save_checkpoint`` writes the states the JAX trainers save: an
AST ``TrainState`` (Adam after the 2.0 clip), an autoencoder state (clip
10), a discriminator state (Adam without a clip) and an AST state in
bfloat16 without the clip, from the full-width ``ModelConfig``'s variables
(the port's tests' model; 32px images), with random Adam moments, count
and step so that nothing matches by accident.  The port reads them back
bit for bit, serves and resumes from them as JAX does, and imports no JAX
module while it reads.
"""

import functools
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arbitrarystyletransfer_tpu import config as jax_config
from arbitrarystyletransfer_tpu.infer import StylePipeline as JaxPipeline
from arbitrarystyletransfer_tpu.models import AST as JaxAST
from arbitrarystyletransfer_tpu.models import VGG19Features as JaxVGG
from arbitrarystyletransfer_tpu.models.mobilenetv2 import (
    Discriminator as JaxDiscriminator,
)
from arbitrarystyletransfer_tpu.train import checkpoint as jax_ckpt
from arbitrarystyletransfer_tpu.train import create_train_state
from arbitrarystyletransfer_tpu.train import make_ast_train_step
from arbitrarystyletransfer_tpu.train.state import make_optimizer

from arbitrarystyletransfer_tpu_torch import ModelConfig, convert_orbax
from arbitrarystyletransfer_tpu_torch import weights
from arbitrarystyletransfer_tpu_torch.config import (
    AETrainConfig,
    ASTTrainConfig,
)
from arbitrarystyletransfer_tpu_torch.infer import StylePipeline
from arbitrarystyletransfer_tpu_torch.models.vgg import init_vgg_params
from arbitrarystyletransfer_tpu_torch.train import checkpoint as ckpt
from arbitrarystyletransfer_tpu_torch.train.ae_trainer import (
    AutoencoderTrainer,
)
from arbitrarystyletransfer_tpu_torch.train.ast_trainer import ASTTrainer
from arbitrarystyletransfer_tpu_torch.train.orbax import read_orbax

from test_torch_autoencoder import ae_variables
from test_torch_ops import assert_close, ast_variables
from test_torch_serving import _assert_images_close, _pre_clamp_max
from test_torch_train_step import (
    AUX_KEYS,
    _jax_step_f64,
    _normalize_head,
)

REPO = Path(__file__).resolve().parents[1]
CFG = ModelConfig(use_pallas_adaattn=True)


def _jax_state(v, clip, seed, dtype=jnp.float32):
    """A JAX TrainState of variables ``v`` (numpy) under the optimizer the
    trainers build (``make_optimizer``: Adam after ``clip``), its moments,
    count and step random."""
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda a: jnp.asarray(a, dtype), v["params"])
    stats = jax.tree.map(jnp.asarray, v["batch_stats"])
    state = create_train_state(params, stats,
                               make_optimizer(2e-4, 0.9, 0.999, 1e-5, clip))

    def fill(path, leaf):
        if jnp.issubdtype(leaf.dtype, jnp.integer):
            return jnp.full(leaf.shape, 3, leaf.dtype)
        x = rng.normal(0.0, 1e-3, leaf.shape)
        if any(getattr(k, "name", None) == "nu" for k in path):
            x = x * x
        return jnp.asarray(x, leaf.dtype)

    return state.replace(
        opt_state=jax.tree_util.tree_map_with_path(fill, state.opt_state),
        step=jnp.asarray(3, jnp.int32))


def _ast_vars(seed=41):
    return ast_variables(seed=seed)


def _ae_vars():
    return ae_variables(seed=42)


def _dis_vars():
    """The JAX Discriminator's variables (numpy), from its own init."""
    v = JaxDiscriminator(dropout_rate=0.0).init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, 64, 64, 3)), train=False)
    return jax.tree.map(np.asarray, {"params": v["params"],
                                     "batch_stats": v["batch_stats"]})


# name -> (variables, clip, dtype) of the saved states.
STATES = {
    "ast": (_ast_vars, 2.0, jnp.float32),
    "ae": (_ae_vars, 10.0, jnp.float32),
    "ast_dis": (_dis_vars, None, jnp.float32),
    "ast_bf16_noclip": (_ast_vars, None, jnp.bfloat16),
}


def _save(directory, name, seed=0):
    """JAX's ``save_checkpoint`` of STATES[name] at ``directory/name``;
    returns (the path, the JAX state)."""
    make, clip, dtype = STATES[name]
    state = _jax_state(make(), clip, seed, dtype)
    path = os.path.join(directory, name)
    jax_ckpt.save_checkpoint(path, state)
    return path, state


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A JAX trainer's save_dir, written once for the module: {name: (the
    orbax directory, the JAX state)} of every state of STATES."""
    directory = str(tmp_path_factory.mktemp("save_dir"))
    return {name: _save(directory, name, seed=i)
            for i, name in enumerate(sorted(STATES))}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _assert_bits(got, ref, what):
    """``got`` (a tensor) holds exactly ``ref`` (a JAX array): its dtype,
    shape and bits."""
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape, what
    if ref.dtype == jnp.bfloat16:
        assert got.dtype == torch.bfloat16, what
        assert np.array_equal(got.view(torch.int16).numpy(),
                              ref.view(np.int16)), what
    else:
        assert got.numpy().dtype == ref.dtype, what
        assert np.array_equal(got.numpy(), ref), what


def _assert_tree_bits(got, ref, what):
    got, ref = _flat(got), _flat(jax.tree.map(np.asarray, ref))
    assert got.keys() == ref.keys(), what
    for key in ref:
        _assert_bits(got[key], ref[key], f"{what}/{key}")


def _adam(state):
    """optax's ScaleByAdamState of a trainer state's chain."""
    found = [s for s in jax.tree.leaves(
        state.opt_state, is_leaf=lambda s: hasattr(s, "mu"))
        if hasattr(s, "mu")]
    assert len(found) == 1
    return found[0]


@pytest.mark.parametrize("name", sorted(STATES))
def test_read_orbax_returns_every_leaf_bit_for_bit(saved, name):
    path, state = saved[name]
    tree = read_orbax(path)
    assert set(tree) == {"params", "batch_stats", "opt_state", "step"}
    _assert_tree_bits(tree["params"], state.params, "params")
    _assert_tree_bits(tree["batch_stats"], state.batch_stats, "batch_stats")
    adam = _adam(state)
    assert set(tree["opt_state"]) == {"mu", "nu", "count"}
    for key in ("mu", "nu"):
        ref = _flat(jax.tree.map(np.asarray, getattr(adam, key)))
        assert tree["opt_state"][key].keys() == ref.keys()
        for k, r in ref.items():
            _assert_bits(tree["opt_state"][key][k], r, f"{key}/{k}")
    _assert_bits(tree["opt_state"]["count"], adam.count, "count")
    _assert_bits(tree["step"], state.step, "step")


def test_restore_checkpoint_and_convert_orbax_agree(saved, tmp_path,
                                                    capsys):
    """``restore_checkpoint`` takes the directory as it takes a ``.pt``
    file; ``convert_orbax`` writes ``ae.pt``, ``ast.pt`` and ``ast_dis.pt``
    beside the directories, which read back equal to them."""
    for name in ("ae", "ast", "ast_dis"):
        shutil.copytree(saved[name][0], tmp_path / name)
    assert convert_orbax.main([str(tmp_path)]) == 0
    printed = capsys.readouterr().out.split()
    assert printed == [str(tmp_path / f"{n}.pt")
                       for n in ("ae", "ast", "ast_dis")]
    for name in ("ae", "ast", "ast_dis"):
        directory = ckpt.restore_checkpoint(str(tmp_path / name))
        converted = ckpt.restore_checkpoint(str(tmp_path / f"{name}.pt"))
        a, b = _flat(directory), _flat(converted)
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype and torch.equal(
                a[key], b[key]), key
        assert ckpt.find_checkpoint(str(tmp_path / name)) == str(
            tmp_path / f"{name}.pt")
    with pytest.raises(SystemExit):
        convert_orbax.main([str(tmp_path / "ast")])


def test_read_imports_no_jax(saved, tmp_path):
    """A read in a fresh interpreter leaves no ``jax``, ``jaxlib``,
    ``orbax``, ``flax`` or JAX-package module in ``sys.modules``."""
    path, state = saved["ast"]
    code = (
        "import sys\n"
        "from arbitrarystyletransfer_tpu_torch.train.orbax import "
        "read_orbax\n"
        f"tree = read_orbax({path!r})\n"
        "assert int(tree['step']) == 3\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'orbax', 'flax', 'optax', "
        "'arbitrarystyletransfer_tpu'))\n"
        "print(bad)\n")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(tmp_path), timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_missing_tensorstore_names_the_converter(saved, monkeypatch):
    path, _ = saved["ast"]
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(ImportError,
                       match="arbitrarystyletransfer_tpu_torch.convert_orbax"):
        read_orbax(path)
    with pytest.raises(ImportError, match="convert_orbax"):
        StylePipeline.from_checkpoint(path, CFG, device="cpu")


def test_missing_checkpoint_names_both_places(tmp_path):
    with pytest.raises(FileNotFoundError, match="ast.pt"):
        StylePipeline.from_checkpoint(str(tmp_path / "ast"), CFG,
                                      device="cpu")


def test_graph_engine_serves_the_orbax_directory_as_jax_does(saved):
    """Port ``from_checkpoint(<orbax dir>)`` against JAX
    ``StylePipeline.from_checkpoint(engine="flax")`` on the same directory,
    within the serving tests' tolerance."""
    path, _ = saved["ast"]
    pipe = StylePipeline.from_checkpoint(path, CFG, device="cpu")
    ref_pipe = JaxPipeline.from_checkpoint(path, jax_config.ModelConfig(),
                                           engine="flax")
    # A batch that JAX's pipeline can shard over its 8 CPU devices.
    rng = np.random.default_rng(43)
    content, style = (rng.uniform(0, 1, (8, 32, 32, 3)).astype(np.float32)
                      for _ in range(2))
    out = pipe.stylize(content, style, 0.6)
    ref = ref_pipe.stylize(jnp.asarray(content), jnp.asarray(style), 0.6)
    assert out.shape == (8, 32, 32, 3)
    assert float(out.std()) > 0.0
    _assert_images_close(out, ref, _pre_clamp_max(pipe, content, style),
                         "stylize")


def _batches(seed, b=2, size=32):
    rng = np.random.default_rng(seed)
    while True:
        yield (rng.uniform(0, 1, (b, size, size, 3)).astype(np.float32),
               rng.uniform(0, 1, (b, size, size, 3)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _resume_inputs():
    """(variables with the head normalized, VGG params, content, style)."""
    from arbitrarystyletransfer_tpu_torch.models.ast import AST

    v = ast_variables(seed=44, proj_gain=1.0)
    vgg_params = init_vgg_params(generator=torch.Generator().manual_seed(45))
    content, style = next(_batches(46))
    ast = AST(ModelConfig())
    weights.load_state(ast, weights.from_jax_tree(v["params"],
                                                  v["batch_stats"]))
    _normalize_head(v, ast, content, style)
    return v, vgg_params, content, style


def test_ast_trainer_resumes_from_the_jax_save_dir(tmp_path):
    """``--load`` from a JAX trainer's ``save_dir``: JAX takes two steps
    from a fresh state (Adam after the 2.0 clip) and saves its orbax
    ``ast``; the port resumes from it and takes the third step.  Its
    yardstick is JAX's third step from the restored state in float64
    (test_torch_train_step's), held at that test's f32 tolerances: the
    loss terms at 1e-5, the gradient (the change of Adam's first moment
    over 1 - b1, against JAX's float64 gradient after the clip) at 5e-4 of
    each tensor's scale (its largest gradient floored at 1e-4 of the
    largest of all) or, where JAX's own float32 step from the same
    directory lies farther from float64, at twice JAX's distance (after
    the two steps both float32 steps lie farther from float64 than at
    test_torch_train_step's fresh state: measured, the port up to 2.9e-3
    of a tensor's scale, JAX up to 8.3e-3, the decoder's SE weights the
    farthest), the BatchNorm statistics at 1e-4.  The second moment
    and the parameters follow from the loaded moments and count (to f32
    rounding), and the count and step go on from 2."""
    v, vgg_params, content, style = _resume_inputs()
    batches = _batches(48)
    step = make_ast_train_step(JaxAST(jax_config.ModelConfig()), JaxVGG(),
                               jax_config.ASTTrainConfig())
    jvgg = jax.tree.map(jnp.asarray, vgg_params)
    state = create_train_state(
        jax.tree.map(jnp.asarray, v["params"]),
        jax.tree.map(jnp.asarray, v["batch_stats"]),
        make_optimizer(2e-4, 0.9, 0.999, 1e-5, 2.0))
    for _ in range(2):
        state, aux = step(state, jvgg, *map(jnp.asarray, next(batches)))[:2]
        assert bool(aux["finite"])
    jax_ckpt.save_checkpoint(str(tmp_path / "ast"), state)
    restored_jax = jax_ckpt.restore_checkpoint(str(tmp_path / "ast"), state)
    restored = jax.tree.map(lambda a: np.array(a, copy=True), restored_jax)
    ref_aux, ref_grads, ref_stats = _jax_step_f64(
        {"params": restored.params, "batch_stats": restored.batch_stats},
        vgg_params, content, style)
    norm = np.sqrt(sum(float(np.sum(g * g)) for g in ref_grads.values()))
    ref_grads = {k[len("params/"):]: g * min(1.0, 2.0 / norm)
                 for k, g in ref_grads.items()}
    old = _adam(restored)
    mu0, nu0 = (_flat(jax.tree.map(np.asarray, m)) for m in (old.mu, old.nu))
    # JAX's float32 step from the restored state (its gradient as the
    # port's is read: from the first moment).
    jax_state, _ = step(restored_jax, jvgg, jnp.asarray(content),
                        jnp.asarray(style))[:2]
    mu_jax = _flat(jax.tree.map(np.asarray, _adam(jax_state).mu))

    cfg = ASTTrainConfig(save_dir=str(tmp_path), ae_model="", batch_size=2,
                         load=True)
    trainer = ASTTrainer(cfg, _batches(0), CFG, device="cpu",
                         log_fn=lambda *a: None)
    assert int(trainer.step) == 2 and int(trainer.opt.count) == 2
    trainer.vgg.load_params(vgg_params)
    before = {k: t.clone() for k, t in
              weights.flatten(weights.module_state(trainer.ast)).items()}
    port_aux = trainer.train_step(content, style)
    assert bool(port_aux["finite"])
    for key in AUX_KEYS:
        assert_close(float(port_aux[key]), ref_aux[key], 1e-5, key)
    assert int(trainer.step) == 3 and int(trainer.opt.count) == 3

    after = weights.flatten(weights.module_state(trainer.ast))
    for key, ref in ref_stats.items():
        assert_close(after[key], ref, 1e-4, key)
    opt = trainer.opt.state_dict()
    assert opt["mu"].keys() == ref_grads.keys()
    largest = max(float(np.abs(g).max()) for g in ref_grads.values())
    lr, b1, b2, eps = 2e-4, 0.9, 0.999, 1e-5
    for name, ref in ref_grads.items():
        mu = opt["mu"][name].double().numpy()
        nu = opt["nu"][name].double().numpy()
        grad = (mu - b1 * mu0[name]) / (1 - b1)
        jax_grad = (mu_jax[name] - b1 * mu0[name]) / (1 - b1)
        scale = max(float(np.abs(ref).max()), 1e-4 * largest)
        tol = max(5e-4 * scale, 2 * float(np.abs(jax_grad - ref).max()))
        assert float(np.abs(grad - ref).max()) <= tol, name
        assert_close(nu, b2 * nu0[name] + (1 - b2) * grad * grad, 1e-5,
                     f"nu/{name}")
        update = (mu / (1 - b1 ** 3)) / (np.sqrt(nu / (1 - b2 ** 3)) + eps)
        # The step moves each parameter by -lr * update, to 1e-3 of the
        # tensor's largest step plus the rounding of the f32 parameter.
        new = after["params/" + name].numpy()
        moved = new.astype(np.float64) - before["params/" + name].double(
            ).numpy()
        limit = 1e-3 * lr * float(np.abs(update).max()) + np.spacing(
            np.abs(new)).astype(np.float64)
        assert bool((np.abs(moved + lr * update) <= limit).all()), name


def test_ast_trainer_loads_the_jax_discriminator(saved):
    """``--load --use_dis`` from a JAX ``save_dir``: the AST state and the
    discriminator's (``ast_dis``), moments and counters, bit for bit."""
    (path, ast_state), (_, dis_state) = saved["ast"], saved["ast_dis"]
    cfg = ASTTrainConfig(save_dir=os.path.dirname(path), ae_model="",
                         batch_size=2, load=True, use_dis=True)
    trainer = ASTTrainer(cfg, _batches(0), CFG, device="cpu",
                         log_fn=lambda *a: None)
    for module, opt, state in ((trainer.ast, trainer.opt, ast_state),
                               (trainer.disc, trainer.dis_opt, dis_state)):
        got = weights.module_state(module)
        _assert_tree_bits(got["params"], state.params, "params")
        _assert_tree_bits(got["batch_stats"], state.batch_stats,
                          "batch_stats")
        adam = _adam(state)
        for name in ("mu", "nu"):
            ours = opt.state_dict()[name]
            for key, r in _flat(jax.tree.map(
                    np.asarray, getattr(adam, name))).items():
                _assert_bits(ours[key], r, f"{name}/{key}")
        _assert_bits(opt.count, adam.count, "count")
    assert int(trainer.step) == int(trainer.dis_step) == 3


def test_ae_model_from_the_jax_ae_directory_is_jaxs_transplant(saved,
                                                              tmp_path):
    """``--ae_model <save_dir>/ae`` (an orbax directory): enc, ada_out and
    dec are the AE's, the AdaAttN modules keep the port's init, as JAX's
    ``transplant_ae_to_ast`` of the same trees gives."""
    path, ae_state = saved["ae"]
    fresh = ASTTrainer(ASTTrainConfig(save_dir=str(tmp_path / "fresh"),
                                      ae_model="", batch_size=2),
                       _batches(0), CFG, seed=5, device="cpu",
                       log_fn=lambda *a: None)
    cur = jax.tree.map(lambda t: t.numpy(),
                       weights.module_state(fresh.ast))
    ref_params, ref_stats = jax_ckpt.transplant_ae_to_ast(
        jax.tree.map(np.asarray, ae_state.params),
        jax.tree.map(np.asarray, ae_state.batch_stats),
        cur["params"], cur["batch_stats"])
    warm = ASTTrainer(ASTTrainConfig(save_dir=str(tmp_path / "warm"),
                                     ae_model=path, batch_size=2),
                      _batches(0), CFG, seed=5, device="cpu",
                      log_fn=lambda *a: None)
    got = weights.module_state(warm.ast)
    _assert_tree_bits(got["params"], ref_params, "params")
    _assert_tree_bits(got["batch_stats"], ref_stats, "batch_stats")
    assert int(warm.opt.count) == 0 and int(warm.step) == 0


def test_autoencoder_trainer_resumes_from_the_jax_ae_directory(saved):
    """``train_autoencoder --load`` from a JAX ``save_dir`` (its orbax
    ``ae``): parameters, statistics, moments, count and step bit for
    bit."""
    path, state = saved["ae"]
    cfg = AETrainConfig(save_dir=os.path.dirname(path), batch_size=2,
                        load=True)
    trainer = AutoencoderTrainer(cfg, iter(()), model_cfg=ModelConfig(),
                                 device="cpu", log_fn=lambda *a: None)
    got = weights.module_state(trainer.model)
    _assert_tree_bits(got["params"], state.params, "params")
    _assert_tree_bits(got["batch_stats"], state.batch_stats, "batch_stats")
    adam = _adam(state)
    for name in ("mu", "nu"):
        for key, r in _flat(jax.tree.map(
                np.asarray, getattr(adam, name))).items():
            _assert_bits(trainer.opt.state_dict()[name][key], r,
                         f"{name}/{key}")
    assert int(trainer.step) == 3 and int(trainer.opt.count) == 3
