"""The issue-rate probe of ``scripts/probe_vpu_rate.py`` and its port.

``probe_rate_reference`` (a CPU tensor takes it through ``probe_rate``) is
held against the TPU probe's Pallas kernel, built by the script's
``make_case`` and run under ``pltpu.force_tpu_interpret_mode()``, for every
case of the script at (8, 128) and its default 512 reps (hswish 256, see
``_reps``): the kernel's one
scalar against the twin's [0, 0], and the twin's whole tile against the
kernel body evaluated over the whole tile with jnp (a copy of the body, in
this file).  Element by element, relative to each element: the eager jnp
body rounds every op as the twin does, so at f32 the tiles agree exactly;
the jitted Pallas kernel agrees exactly on roll, select and cast, and on fma
and hswish within two f32 ulps per dependent step (XLA contracts ``a * w +
b`` into one rounding, as the CUDA kernel does, and reorders hswish's
arithmetic: 1e-6 off after 64 steps); bf16 one ulp.  Every f32 op moves the
tile by more than that tolerance (checked below), so a twin that skipped one
would fail.  The bf16 fma case is a
numeric no-op: w = 1.000001 rounds to 1.0 in bf16 and b = 1e-7 is below one
ulp of the tile's values, so it only checks the bf16 rounding of the
chains' sum.  The drivers' JSON keys are held against the JAX script's,
read from its source.  The CUDA kernel is checked on the card by
``chip_smoke.py``.
"""

import ast
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from arbitrarystyletransfer_tpu_torch.ops.kernels import LAUNCHES
from arbitrarystyletransfer_tpu_torch.ops.kernels.probes import probe_rate
from arbitrarystyletransfer_tpu_torch.scripts import probe_vpu_rate as port
from arbitrarystyletransfer_tpu_torch.scripts import sass_ops

REPO = Path(__file__).resolve().parents[1]
JAX_SCRIPT = REPO / "scripts" / "probe_vpu_rate.py"
C, LANES, REPS = 8, 128, 512
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _load_jax_script():
    spec = importlib.util.spec_from_file_location("jax_probe_vpu_rate",
                                                  JAX_SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jpv = _load_jax_script()


def _jax_cases():
    """(op, dtype name, par) of the script's ``cases`` list in ``main``."""
    tree = ast.parse(JAX_SCRIPT.read_text())
    cases = next(n.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
                 and getattr(n.targets[0], "id", "") == "cases")
    return [(e.elts[0].value, e.elts[1].value, e.elts[3].value)
            for e in cases.elts]


CASES = _jax_cases()


def _inputs(dt_name, seed):
    jdt, tdt = DTYPES[dt_name]
    x = np.random.default_rng(seed).uniform(0.5, 1.0, (C, LANES))
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _jnp_tile(op, a0, reps, par):
    # A copy of the body of scripts/probe_vpu_rate.py `make_case`'s kernel,
    # in jnp over the whole tile (jnp.roll for pltpu.roll), returning `out`
    # before the kernel keeps its [0, 0].
    steps = reps // par
    w = jnp.asarray(1.000001, a0.dtype)
    b = jnp.asarray(1e-7, a0.dtype)
    accs = [a0 * (1.0 + i * 1e-6) for i in range(par)]
    if op == "fma":
        for _ in range(steps):
            accs = [a * w + b for a in accs]
    elif op == "roll":
        for _ in range(steps):
            accs = [jnp.roll(a, 1, 1) for a in accs]
        accs = [a * w for a in accs]
    elif op == "select":
        col = jnp.arange(a0.shape[1])[None]
        for i in range(steps):
            accs = [jnp.where(col == (i % a0.shape[1]), a * w, a)
                    for a in accs]
    elif op == "hswish":
        six = jnp.asarray(6.0, a0.dtype)
        three = jnp.asarray(3.0, a0.dtype)
        for _ in range(steps):
            accs = [a * jnp.clip(a + three, 0, six) / six for a in accs]
    elif op == "cast":
        for _ in range(steps):
            accs = [a.astype(jnp.bfloat16).astype(jnp.float32) * w
                    for a in accs]
    out = accs[0]
    for a in accs[1:]:
        out = out + a
    return np.asarray(out.astype(jnp.float32))


def _reps(op):
    """hswish shrinks the tile by ~0.58 per step: at 512 reps (128 steps
    of par 4) it falls below f32's normal range, where XLA on the CPU
    flushes to zero and the twin does not (nor does the CUDA kernel).  At
    256 reps it stays normal."""
    return 256 if op == "hswish" else REPS


def _rtol(op, dt_name, par, jitted):
    """Relative tolerance per element (see the module's docstring)."""
    if dt_name == "bf16":
        return 2.0 ** -7
    if jitted and op in ("fma", "hswish"):
        return _reps(op) // par * 2.0 ** -22
    return 0.0


def _assert_rel(out, ref, rtol, what):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    err = np.abs(out - ref)
    bad = err > rtol * np.abs(ref)
    assert not bad.any(), (f"{what}: {bad.sum()} elements off, worst rel "
                           f"{(err / np.abs(ref)).max():.3g} > {rtol:.3g}")


def test_the_cases_are_the_jax_scripts():
    assert [(op, dt, par) for op, dt, _, par in port.CASES] == CASES


@pytest.mark.parametrize("op,dt_name,par", CASES)
def test_twin_scalar_matches_the_pallas_kernel(op, dt_name, par):
    jx, tx = _inputs(dt_name, seed=par)
    reps = _reps(op)
    fn, reps_eff = jpv.make_case(op, DTYPES[dt_name][0], C, LANES, reps, par)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(fn(jx))
    assert reps_eff == reps // par * par
    out = probe_rate(tx, op, par, reps)
    assert out.shape == (C, LANES) and out.dtype == torch.float32
    _assert_rel(out[:1, :1], ref, _rtol(op, dt_name, par, jitted=True),
                f"{op} {dt_name}")


@pytest.mark.parametrize("op,dt_name,par", CASES)
def test_twin_tile_matches_the_kernel_body(op, dt_name, par):
    jx, tx = _inputs(dt_name, seed=10 + par)
    ref = _jnp_tile(op, jx, _reps(op), par)
    out = probe_rate(tx, op, par, _reps(op))
    _assert_rel(out, ref, _rtol(op, dt_name, par, jitted=False),
                f"{op} {dt_name} tile")


@pytest.mark.parametrize("op,dt_name,par",
                         [c for c in CASES if c[1] == "f32"])
def test_each_f32_op_moves_the_tile_beyond_its_tolerance(op, dt_name, par):
    # The tile with the op's steps left out (roll keeps its final a * w):
    # the tests above would catch a twin that skipped the op.
    _, tx = _inputs(dt_name, seed=20 + par)
    out = probe_rate(tx, op, par, _reps(op)).double()
    accs = [tx * torch.tensor(1.0 + i * 1e-6) for i in range(par)]
    if op == "roll":
        accs = [a * torch.tensor(1.000001) for a in accs]
    skipped = accs[0]
    for a in accs[1:]:
        skipped = skipped + a
    rel = ((out - skipped.double()).abs() / skipped.double().abs()).numpy()
    tol = _rtol(op, dt_name, par, jitted=True)
    assert rel.max() > 2 * max(tol, 2.0 ** -24), (
        f"{op}: the op moves the tile by {rel.max():.3g} only")


def test_cpu_tensors_take_the_plain_twin_and_other_devices_raise():
    before = dict(LAUNCHES)
    probe_rate(torch.ones(2, 128), "fma", 8, 16)
    assert LAUNCHES == before
    with pytest.raises(ValueError, match="unsupported device"):
        probe_rate(torch.empty(2, 128, device="meta"), "fma", 8, 16)
    for op, par in (("exp", 8), ("fma", 2), ("roll", 4)):
        with pytest.raises(ValueError, match="op, par"):
            probe_rate(torch.ones(2, 128), op, par, 16)


def test_driver_cli_on_the_cpu_prints_the_jax_keys():
    proc = subprocess.run(
        [sys.executable, "-m",
         "arbitrarystyletransfer_tpu_torch.scripts.probe_vpu_rate",
         "--device", "cpu", "--c", str(C), "--lanes", str(LANES), "--reps",
         str(REPS)], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    res = json.loads(proc.stdout.splitlines()[-1])
    assert list(res) == ["c", "lanes", "reps"] + [
        f"{op}_{dt}_p{par}_Gops" for op, dt, par in CASES]
    assert (res["c"], res["lanes"], res["reps"]) == (C, LANES, REPS)
    assert all(res[k] is None for k in list(res)[3:])  # not measured


def test_driver_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal needs none")
    proc = subprocess.run(
        [sys.executable, "-m",
         "arbitrarystyletransfer_tpu_torch.scripts.probe_vpu_rate"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr


def test_sass_opcode_counts_parse_cuobjdump_output():
    sass = """
\tcode for sm_90a
\t\tFunction : _ZN4rate_bf16_fma_kernelILi8EE
\t.headerflags\t@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   HFMA2.BF16_V2 R5, R5, R9.H0_H0, R10 ;
        /*0020*/              @!P0 HFMA2.BF16_V2 R6, R6, R9.H0_H0, R10 ;
        /*0030*/                   EXIT ;
\t\tFunction : _ZN4other_kernelEv
        /*0000*/                   FFMA R2, R2, R3, R4 ;
"""
    assert sass_ops.opcode_counts(sass, "rate_") == {
        "_ZN4rate_bf16_fma_kernelILi8EE": {"HFMA2.BF16_V2": 2, "LDC": 1,
                                          "EXIT": 1}}
    assert set(sass_ops.opcode_counts(sass)) == {
        "_ZN4rate_bf16_fma_kernelILi8EE", "_ZN4other_kernelEv"}
