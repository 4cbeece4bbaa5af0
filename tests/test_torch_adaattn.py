"""Kernel 2 (adaattn_fwd): its plain twin against the TPU kernel and the
dense golden, and the paired AdaAttN against JAX's.

The Pallas forward runs under ``pltpu.force_tpu_interpret_mode()`` on the
CPU.  All comparisons are float32; the CUDA kernel itself is checked on the
card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from arbitrarystyletransfer_tpu import engine as jengine
from arbitrarystyletransfer_tpu.models.adaattn import (
    adaattn_statistics as jax_dense,
)
from arbitrarystyletransfer_tpu.ops.pallas.adaattn_kernel import (
    _adaattn_pallas_fwd,
)

from arbitrarystyletransfer_tpu_torch import engine
from arbitrarystyletransfer_tpu_torch.models.adaattn import (
    adaattn_statistics as port_dense,
)
from arbitrarystyletransfer_tpu_torch.ops.kernels import LAUNCHES
from arbitrarystyletransfer_tpu_torch.ops.kernels.adaattn_fwd import (
    adaattn_fwd,
    adaattn_fwd_reference,
    adaattn_statistics,
)

from test_torch_ops import assert_close, ast_variables, to_jax, to_port


def _qkv(b, nc, ns, seed=0, scale=0.25):
    # scale 0.25: logits ~ N(0, 8), a softmax as peaked as a trained one's.
    rng = np.random.default_rng(seed)
    return [rng.normal(0, scale, (b, n, 128)).astype(np.float32)
            for n in (nc, ns, ns)]


@pytest.mark.parametrize("b,nc,ns", [
    (2, 64, 64),
    (1, 100, 77),    # ragged query and style axes
])
def test_reference_matches_pallas_and_dense(b, nc, ns):
    q, k, v = _qkv(b, nc, ns, seed=nc)
    mean, std, m, l = adaattn_fwd(*map(torch.from_numpy, (q, k, v)))
    with pltpu.force_tpu_interpret_mode():
        r_mean, r_std, r_m, r_l = _adaattn_pallas_fwd(
            *map(jnp.asarray, (q, k, v)))
    d_mean, d_std = jax_dense(*map(jnp.asarray, (q, k, v)))
    # Same f32 math, summed in another order; std cancels (ev2 ~ mean^2),
    # so it is held to max |std| instead of elementwise.
    for ref_mean, ref_std in ((r_mean, r_std), (d_mean, d_std)):
        assert_close(mean, ref_mean, 1e-5, "mean")
        assert_close(std, ref_std, 1e-4, "std")
    assert_close(m, r_m, 1e-6, "row max")
    assert_close(l, r_l, 1e-5, "row sum-exp")


def test_dense_golden_matches_jax():
    q, k, v = _qkv(2, 50, 40, seed=3, scale=0.5)
    mean, std = port_dense(*map(torch.from_numpy, (q, k, v)))
    r_mean, r_std = jax_dense(*map(jnp.asarray, (q, k, v)))
    assert_close(mean, r_mean, 1e-5, "mean")
    assert_close(std, r_std, 1e-4, "std")


def test_statistics_on_cpu_launch_nothing():
    before = dict(LAUNCHES)
    q, k, v = map(torch.from_numpy, _qkv(1, 16, 16))
    mean, std = adaattn_statistics(q, k, v)
    r_mean, r_std, _, _ = adaattn_fwd_reference(q, k, v)
    assert torch.equal(mean, r_mean) and torch.equal(std, r_std)
    assert LAUNCHES == before


@pytest.mark.parametrize("use_kernel", [True, False])
def test_apply_pair_matches_jax(use_kernel):
    params = ast_variables(seed=2)["params"]
    rng = np.random.default_rng(6)
    maps = [rng.normal(0, 1, (2, 6, 5, 128)).astype(np.float32)
            for _ in range(4)]
    out = engine.adaattn_apply_pair(
        to_port(params["ada_att_1"]), to_port(params["ada_att_2"]),
        [torch.from_numpy(m) for m in maps[:2]],
        [torch.from_numpy(m) for m in maps[2:]],
        use_kernel=use_kernel, dtype=torch.float32)
    ref = jengine.adaattn_apply_pair(
        to_jax(params["ada_att_1"]), to_jax(params["ada_att_2"]),
        [jnp.asarray(m) for m in maps[:2]], [jnp.asarray(m) for m in maps[2:]],
        use_pallas=False, dtype=jnp.float32)
    for o, r in zip(out, ref):
        assert_close(o, r, 1e-4, "stylized map")
