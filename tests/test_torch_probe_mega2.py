"""The probe kernels of ``scripts/probe_mega2.py`` and their port.

The port's plain twins (``ops/kernels/probes.py``; a CPU tensor takes them)
are held against the Pallas kernels of the JAX probe script, run under
``pltpu.force_tpu_interpret_mode()`` at small shapes:

- copy: equal at 1 and 2 row groups.  At 3 or more the TPU kernel refills a
  slot that the store of row group r - 1 may still be reading (it waits on
  that store only at r + 1); in interpret mode its row group 0 then holds row
  group 2, while the port's copy equals x.  The test pins both.
- products: ``_einsum_kernel`` and ``_rowloop_kernel`` at float32 (rtol
  1e-5 of the largest value; a bf16 x bf16 -> f32 dot does not run on the
  CPU), and the bf16 twins against numpy's f32 sum of the same bf16 values,
  rounded to bf16 (one bf16 ulp of the largest value).
- depthwise: ``_dw_nhwc_kernel`` at k3 and k5 (1e-5); ``_dw_t_kernel`` as
  written where it traces, else a copy of its body with the lane-roll shift
  taken mod W (its negative shift no longer traces), which makes it a
  depthwise that is circular in W.

The drivers' JSON keys are held against the JAX script's, read from its
source.  The CUDA kernels are checked on the card by ``chip_smoke.py``.
"""

import ast
import functools
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from arbitrarystyletransfer_tpu_torch.ops.kernels import LAUNCHES
from arbitrarystyletransfer_tpu_torch.ops.kernels.probes import (
    probe_copy,
    probe_dw_nhwc,
    probe_dw_t,
    probe_mm_einsum,
    probe_mm_rowloop,
)
from arbitrarystyletransfer_tpu_torch.scripts import probe_mega2 as port

from test_torch_ops import assert_close

REPO = Path(__file__).resolve().parents[1]
JAX_SCRIPT = REPO / "scripts" / "probe_mega2.py"
BF16_ULP = 2.0 ** -7  # relative to the largest value


def _load_jax_script():
    spec = importlib.util.spec_from_file_location("jax_probe_mega2",
                                                  JAX_SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jpm = _load_jax_script()


def _interpret(kernel, out_shape, *args, **kw):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(pl.pallas_call(kernel, out_shape=out_shape,
                                         **kw)(*args))


def _rand(seed, *shape):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


# ---------------------------------------------------------------- P1
def _jax_copy(x, th):
    """p1_dma_copy's pallas_call on x (its scratch, semaphores and grid)."""
    b, h, c, w = x.shape
    kern = functools.partial(jpm._copy_kernel, th=th, n_rg=h // th)
    return _interpret(
        kern, jax.ShapeDtypeStruct(x.shape, x.dtype), jnp.asarray(x),
        grid=(b,), in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec(memory_space=pl.ANY),
        scratch_shapes=[pltpu.VMEM((2, th, c, w), x.dtype),
                        pltpu.SemaphoreType.DMA((2,)),
                        pltpu.SemaphoreType.DMA((2,))])


@pytest.mark.parametrize("n_rg", [1, 2, 3, 4])
def test_copy_twin_against_the_tpu_copy(n_rg):
    th = 2
    x = _rand(n_rg, 1, n_rg * th, 8, 16)
    y = probe_copy(torch.from_numpy(x), th)
    np.testing.assert_array_equal(y.numpy(), x)
    ref = _jax_copy(x, th)
    if n_rg <= 2:
        np.testing.assert_array_equal(ref, x)
    else:  # the TPU kernel's write-after-read race, pinned
        np.testing.assert_array_equal(ref[:, :th], x[:, 2 * th:3 * th])
        assert not np.array_equal(ref, x)


# ---------------------------------------------------------------- P2
MM_SHAPES = [(4, 40, 24, 64), (3, 20, 16, 32)]  # (R, C, E, W)


@pytest.mark.parametrize("schedule", ["einsum", "rowloop"])
@pytest.mark.parametrize("r,c,e,w", MM_SHAPES)
def test_product_twin_matches_pallas_f32(schedule, r, c, e, w):
    x, wt = _rand(r + c, r, c, w), _rand(e, c, e)
    if schedule == "einsum":
        ref = _interpret(jpm._einsum_kernel,
                         jax.ShapeDtypeStruct((r, e, w), jnp.float32),
                         jnp.asarray(x), jnp.asarray(wt))
        out = probe_mm_einsum(torch.from_numpy(x), torch.from_numpy(wt))
    else:
        ref = _interpret(functools.partial(jpm._rowloop_kernel, th=r),
                         jax.ShapeDtypeStruct((r, e, w), jnp.float32),
                         jnp.asarray(x), jnp.asarray(wt))
        out = probe_mm_rowloop(torch.from_numpy(x), torch.from_numpy(wt))
    assert out.shape == (r, e, w) and out.dtype == torch.float32
    assert_close(out, ref, 1e-5, f"{schedule} f32")


@pytest.mark.parametrize("fn", [probe_mm_einsum, probe_mm_rowloop])
def test_product_twin_bf16_within_one_ulp(fn):
    r, c, e, w = 4, 40, 24, 64
    x = torch.from_numpy(_rand(1, r, c, w)).bfloat16()
    wt = torch.from_numpy(_rand(2, c, e)).bfloat16()
    exact = np.einsum("rcw,ce->rew", x.float().numpy(), wt.float().numpy())
    ref = torch.from_numpy(exact).bfloat16().float().numpy()
    out = fn(x, wt)
    assert out.dtype == torch.bfloat16
    assert_close(out.float(), ref, BF16_ULP, "bf16 product")


# ---------------------------------------------------------------- P3
def _dw_t_kernel_mod_w(x_ref, wd_ref, y_ref, *, k, th, w):
    # A copy of scripts/probe_mega2.py `_dw_t_kernel` with the roll shift
    # taken mod W: as written, pltpu.roll refuses its negative shift.
    pad = (k - 1) // 2
    h = x_ref[...]
    out = None
    for dj in range(k):
        hj = pltpu.roll(h, (pad - dj) % w, 2) if dj != pad else h
        for di in range(k):
            term = hj[di: di + th] * wd_ref[di, dj][None, :, None]
            out = term if out is None else out + term
    y_ref[...] = out


@pytest.mark.parametrize("k", [3, 5])
def test_dw_t_twin_matches_pallas(k):
    th, c, w = 4, 8, 16
    pad = (k - 1) // 2
    x, wd = _rand(k, th + 2 * pad, c, w), _rand(k + 1, k, k, c)
    out_shape = jax.ShapeDtypeStruct((th, c, w), jnp.float32)
    try:
        ref = _interpret(functools.partial(jpm._dw_t_kernel, k=k, th=th, w=w),
                         out_shape, jnp.asarray(x), jnp.asarray(wd))
    except ValueError as err:
        assert "shift must be non-negative" in str(err)
        ref = _interpret(functools.partial(_dw_t_kernel_mod_w, k=k, th=th,
                                           w=w),
                         out_shape, jnp.asarray(x), jnp.asarray(wd))
    out = probe_dw_t(torch.from_numpy(x), torch.from_numpy(wd))
    assert out.shape == (th, c, w)
    assert_close(out, ref, 1e-5, f"dw_t k{k}")
    # Circular in W: column 0 takes taps from the last columns.
    circ = sum(np.roll(x, pad - dj, axis=2)[di:di + th] * wd[di, dj][:, None]
               for dj in range(k) for di in range(k))
    assert_close(out, circ, 1e-5, "circular in W")


@pytest.mark.parametrize("k", [3, 5])
def test_dw_nhwc_twin_matches_pallas(k):
    th, c, w = 4, 8, 16
    pad = (k - 1) // 2
    x, wd = _rand(k, th + 2 * pad, w + 2 * pad, c), _rand(k + 1, k, k, c)
    ref = _interpret(functools.partial(jpm._dw_nhwc_kernel, k=k, th=th, w=w),
                     jax.ShapeDtypeStruct((th, w, c), jnp.float32),
                     jnp.asarray(x), jnp.asarray(wd))
    out = probe_dw_nhwc(torch.from_numpy(x), torch.from_numpy(wd))
    assert out.shape == (th, w, c)
    assert_close(out, ref, 1e-5, f"dw_nhwc k{k}")


# ---------------------------------------------------------------- wrappers
def test_cpu_tensors_take_the_plain_twins():
    before = dict(LAUNCHES)
    x = torch.randn(1, 4, 3, 8, generator=torch.Generator().manual_seed(0))
    assert torch.equal(probe_copy(x, 2), x)
    probe_mm_einsum(x[0], torch.ones(3, 8))
    probe_mm_rowloop(x[0], torch.ones(3, 8))
    probe_dw_t(x[0], torch.ones(3, 3, 3))
    probe_dw_nhwc(x[0], torch.ones(3, 3, 8))
    assert LAUNCHES == before


@pytest.mark.parametrize("call", [
    lambda m: probe_copy(torch.empty(1, 2, 8, 8, device=m), 2),
    lambda m: probe_mm_einsum(torch.empty(2, 8, 8, device=m,
                                          dtype=torch.bfloat16),
                              torch.empty(8, 8, device=m)),
    lambda m: probe_mm_rowloop(torch.empty(2, 8, 8, device=m,
                                           dtype=torch.bfloat16),
                               torch.empty(8, 8, device=m)),
    lambda m: probe_dw_t(torch.empty(6, 4, 8, device=m),
                         torch.empty(3, 3, 4, device=m)),
    lambda m: probe_dw_nhwc(torch.empty(6, 10, 4, device=m),
                            torch.empty(3, 3, 4, device=m)),
])
def test_other_devices_raise(call):
    with pytest.raises(ValueError, match="unsupported device"):
        call("meta")


# ---------------------------------------------------------------- drivers
def _function(tree, name):
    return next(n for n in ast.walk(tree)
                if isinstance(n, ast.FunctionDef) and n.name == name)


def _stored_keys(node):
    """String keys of ``d["key"] = ...`` inside node, in order."""
    return [t.slice.value for n in ast.walk(node) if isinstance(n, ast.Assign)
            for t in n.targets if isinstance(t, ast.Subscript)
            and isinstance(t.slice, ast.Constant)]


def _dict_keys(node):
    return {k.value for n in ast.walk(node) if isinstance(n, ast.Dict)
            for k in n.keys if isinstance(k, ast.Constant)}


def _jax_keys():
    """The JAX script's JSON keys, read from its source: top-level, P1's,
    P2's schedules and fields, P3's."""
    tree = ast.parse(JAX_SCRIPT.read_text())
    p2 = _function(tree, "p2_matmul")
    loop = next(n for n in ast.walk(p2) if isinstance(n, ast.For))
    return {"top": _stored_keys(_function(tree, "main")),
            "p1": _dict_keys(_function(tree, "p1_dma_copy")),
            "p2": [e.elts[0].value for e in loop.iter.elts],
            "p2_fields": _dict_keys(p2),
            "p3": set(_stored_keys(_function(tree, "p3_dw")))}


def test_driver_probes_are_the_jax_scripts():
    keys = _jax_keys()
    assert [key for _, key, _, _ in port.PROBES] == keys["top"]
    p1 = port.p1_dma_copy(1, 4, 8, 16, 2, torch.bfloat16,
                          torch.device("cpu"), torch.Generator())
    assert set(p1) == {k.replace("xla", "torch") for k in keys["p1"]}
    assert all(v is None for v in p1.values())  # not measured on the CPU


def test_driver_cli_on_the_cpu_prints_the_jax_keys():
    keys = _jax_keys()
    proc = subprocess.run(
        [sys.executable, "-m",
         "arbitrarystyletransfer_tpu_torch.scripts.probe_mega2",
         "--device", "cpu", "--probes", "23", "--iters", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    res = json.loads(proc.stdout)
    assert list(res) == [k for k in keys["top"] if k[:2] in ("p2", "p3")]
    for key, val in res.items():
        if key.startswith("p2"):
            assert list(val) == keys["p2"]
            assert all(set(v) == keys["p2_fields"] - {"err"}
                       for v in val.values())
        else:  # the JAX script's *_err keys are the failed runs' *_ms
            assert set(val) == {k for k in keys["p3"] if k.endswith("_ms")}


def test_driver_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal needs none")
    proc = subprocess.run(
        [sys.executable, "-m",
         "arbitrarystyletransfer_tpu_torch.scripts.probe_mega2"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
