"""The port gives the same bits on every run, on the CPU against JAX.

* The decoder's upsample as a broadcast view (its backward a fixed-order
  sum, where ``repeat_interleave``'s accumulates with atomics on CUDA):
  ``jnp.repeat``'s bytes, ``jax.vjp``'s gradient, the decoder's forward
  and backward against flax.
* The block kernels' SE sums in a fixed order (``sum_order_emulation``, the
  order of ``csrc/expand_dw.cuh``'s ``tile_sums_kernel`` and of the tiles'
  sums before it): against JAX's ``_fused_kernel`` sums and, through the
  gate, ``_flat_kernel``'s y (interpret mode), and image by image the same
  bits at any batch.
* The trainers' steps: two from the same state give the same state bit for
  bit, and a step leaves the caller's cuDNN settings as it found them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arbitrarystyletransfer_tpu.models.decoder import Decoder as JaxDecoder
from arbitrarystyletransfer_tpu.models.decoder import (
    nearest_upsample_2x as jax_upsample,
)
from arbitrarystyletransfer_tpu.ops.pallas import flatblock as jflat
from arbitrarystyletransfer_tpu.ops.pallas import fused_block as jfb

from arbitrarystyletransfer_tpu_torch import ModelConfig
from arbitrarystyletransfer_tpu_torch.config import AETrainConfig
from arbitrarystyletransfer_tpu_torch.models.decoder import (
    Decoder,
    nearest_upsample_2x,
)
from arbitrarystyletransfer_tpu_torch.ops.basic import se_gate
from arbitrarystyletransfer_tpu_torch.ops.kernels.expand_dw import (
    expand_dw_reference,
    sum_order_emulation,
)
from arbitrarystyletransfer_tpu_torch.train.ae_trainer import (
    AutoencoderTrainer,
)
from arbitrarystyletransfer_tpu_torch.train.state import (
    deterministic_algorithms,
)

from test_torch_model import JCFG, _module, _t, _x
from test_torch_ops import assert_close, ast_variables
from test_torch_sweeps import (
    BF16_ULP,
    SIZE,
    E,
    emulate_sweep1,
    emulate_sweep2,
    j,
    random_block,
)
from test_torch_train import _batches, _trainer

# Sweep 1's tile geometries: (tile, rows per warp, first column) of
# expand_dw.cuh (NHWC; the (N, H, C, W) box's grid at k3 and k5) and of
# flat_s2.cu (bf16 and the f32 design).
GEOMETRIES = {"nhwc": ((16, 16), 8, 0), "xt-k3": ((16, 16), 8, -7),
              "xt-k5": ((16, 16), 8, -6), "s2": ((8, 16), 4, 0),
              "s2-f32": ((4, 16), 2, 0)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_upsample_bytes_are_jnp_repeat(dtype):
    """The broadcast view's forward has the bytes of two ``jnp.repeat``."""
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 5, 7, 3)).astype(np.float32)).to(getattr(torch, dtype))
    out = nearest_upsample_2x(x)
    ref = jax_upsample(jnp.asarray(x.float().numpy()).astype(
        getattr(jnp, dtype)))
    assert out.shape == (2, 10, 14, 3) and out.dtype == x.dtype
    assert np.array_equal(out.float().numpy(),
                          np.asarray(ref.astype(jnp.float32)))


def test_upsample_gradient_is_jax_vjp():
    """Its gradient (each input's four cotangents summed) equals
    ``jax.vjp``'s at f32 within one ulp of each value."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 6, 5, 4)).astype(np.float32)
    cot = rng.normal(size=(2, 12, 10, 4)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    (grad,) = torch.autograd.grad(nearest_upsample_2x(xt),
                                  xt, torch.from_numpy(cot))
    _, vjp = jax.vjp(jax_upsample, jnp.asarray(x))
    (ref,) = vjp(jnp.asarray(cot))
    ref = np.asarray(ref)
    ulp = np.spacing(np.abs(ref).astype(np.float32))
    assert np.all(np.abs(grad.numpy() - ref) <= ulp)


def test_decoder_backward_matches_flax():
    """The decoder (three upsamples) at ``test_decoder_matches_flax``'s
    size: its image and the gradient of a fixed projection of the image
    with respect to its input, against flax's, at that test's 1e-4."""
    v = ast_variables(seed=5)
    dec = _module(Decoder(), v["params"]["dec"])
    z = _x((1, 4, 4, 128), 6)
    cot = np.random.default_rng(2).normal(size=(1, 32, 32, 3)).astype(
        np.float32)
    zt = _t(z).requires_grad_(True)
    out = dec(zt)
    (grad,) = torch.autograd.grad(out, zt, torch.from_numpy(cot))
    jdec = JaxDecoder(JCFG)
    ref, vjp = jax.vjp(
        lambda a: jdec.apply({"params": v["params"]["dec"]}, a),
        jnp.asarray(z))
    (ref_grad,) = vjp(jnp.asarray(cot))
    assert_close(out.detach(), ref, 1e-4, "image")
    assert_close(grad, ref_grad, 1e-4, "input gradient")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [3, 5])
def test_sum_order_matches_fused_kernel_sums(k, dtype):
    """The sums in the kernels' order (``_fused_kernel``'s mode: of the
    unrounded hidden) against JAX ``fused_expand_dw``'s in interpret mode,
    on a 37 x 37 map (partial tiles), within 1e-5 of the largest."""
    tdt = getattr(torch, dtype)
    x, we, wd, _, _, (be, bd, _) = random_block(40, k, seed=3 * k)
    x = x.to(tdt)
    hidden, _ = expand_dw_reference(x.float(), we.to(tdt).float(), wd, k,
                                    b_expand=be, b_dw=bd)
    sums = sum_order_emulation(hidden)
    jdt = getattr(jnp, dtype)
    _, ref = jfb.fused_expand_dw(
        jnp.asarray(x.float().numpy()).astype(jdt), j(we).astype(jdt),
        j(wd), k, interpret=True, b_expand=j(be), b_dw=j(bd))
    assert_close(sums.numpy(), np.asarray(ref)[:, :E], 1e-5, "sums")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_sum_order_gates_flat_kernel(dtype):
    """The flat mode's sums (of the rounded hidden) in the kernels' order,
    through the gate and sweep 2, against ``_flat_kernel``'s y in
    interpret mode (which sums row group by row group)."""
    tdt = getattr(torch, dtype)
    c_in, k = 40, 5
    x, we, wd, se, wp, (be, bd, pb) = random_block(c_in, k, seed=11)
    x = x.to(tdt)
    hidden, exact = emulate_sweep1(x, we, wd, k, True, True, be, bd)
    sums = sum_order_emulation(hidden.float())
    assert_close(sums.numpy(), exact.numpy(), 1e-6, "sums vs float64")
    if tdt == torch.bfloat16:
        y = emulate_sweep2(hidden, sums, se, wp, pb, residual=x)
    else:
        gate = se_gate(sums, SIZE * SIZE, se)
        y = (hidden * gate[:, None, None, :]) @ wp + pb + x
    jdt = getattr(jnp, dtype)
    xf = jnp.asarray(x.float().numpy()).astype(jdt)
    xf = jnp.transpose(xf, (0, 3, 1, 2)).reshape(2, c_in, SIZE * SIZE)
    ref = jflat.flat_expand_dw_project(
        xf, j(we).astype(jdt), j(wd), j(se), j(wp).astype(jdt), k, SIZE,
        b_expand=j(be), b_dw=j(bd), proj_bias=j(pb), identity=True,
        interpret=True, w_dim=SIZE)
    ref = np.asarray(jnp.asarray(ref, jnp.float32)).reshape(
        2, c_in, SIZE, SIZE).transpose(0, 2, 3, 1)
    rel = BF16_ULP if tdt == torch.bfloat16 else 1e-5
    assert_close(y.float().numpy(), ref, rel, "flat y")


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_sum_order_is_the_same_at_any_batch(geometry):
    """Image i's sums at batch 4 equal its sums alone, bit for bit, in
    every tile geometry of the sweeps (and a map of 1 to 300 tiles, so
    that the eight runs are empty, single or long)."""
    tile, rows, shift = GEOMETRIES[geometry]
    rng = np.random.default_rng(4)
    for h, w in ((5, 9), (37, 37), (70, 130), (200, 300)):
        vals = torch.from_numpy(rng.normal(size=(4, h, w, 3)).astype(
            np.float32))
        batch = sum_order_emulation(vals, tile, rows, shift)
        for i in range(4):
            one = sum_order_emulation(vals[i:i + 1], tile, rows, shift)
            assert torch.equal(batch[i:i + 1], one), (geometry, h, w, i)
        exact = vals.double().sum(dim=(1, 2))
        assert_close(batch.numpy(), exact.numpy(), 1e-6, geometry)


def _state(trainer, model):
    return [t.detach().clone() for t in (
        *model.parameters(), *model.buffers(), trainer.opt.mu,
        trainer.opt.nu, trainer.opt.count, trainer.step)]


def test_ast_steps_repeat_bit_for_bit(tmp_path):
    """Two ``ASTTrainer`` steps from the same state on the same batch give
    the same state bit for bit."""
    batch = next(_batches(3))
    states = []
    for run in range(2):
        trainer = _trainer(tmp_path / str(run))
        aux = trainer.train_step(*batch)
        assert bool(aux["finite"])
        states.append(_state(trainer, trainer.ast))
    assert all(torch.equal(a, b) for a, b in zip(*states))


def _ae_trainer(tmp_path):
    cfg = AETrainConfig(save_dir=str(tmp_path / "ae"), batch_size=2,
                        ae_imsize=32)
    return AutoencoderTrainer(cfg, iter(()), device="cpu",
                              log_fn=lambda *a: None)


def test_ae_steps_repeat_bit_for_bit(tmp_path):
    """Two ``AutoencoderTrainer`` steps from the same state on the same
    batch give the same state bit for bit."""
    batch = next(_batches(4))[0]
    states = []
    for run in range(2):
        trainer = _ae_trainer(tmp_path / str(run))
        aux = trainer.train_step(batch)
        assert bool(aux["finite"])
        states.append(_state(trainer, trainer.model))
    assert all(torch.equal(a, b) for a, b in zip(*states))


@pytest.mark.parametrize("kind", ["ast", "ae"])
def test_step_restores_cudnn_settings(tmp_path, kind):
    """A trainer's step runs with cuDNN's deterministic algorithms and no
    benchmarking, and leaves the caller's settings as it found them."""
    if kind == "ast":
        trainer = _trainer(tmp_path)
        batch = next(_batches(5))
    else:
        trainer = _ae_trainer(tmp_path)
        batch = (next(_batches(5))[0],)
    seen = []
    apply = trainer.opt.apply_if_finite

    def recording(grads):
        seen.append((torch.backends.cudnn.deterministic,
                     torch.backends.cudnn.benchmark))
        return apply(grads)

    trainer.opt.apply_if_finite = recording
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    try:
        for caller in ((False, True), (True, False)):
            (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark) = caller
            trainer.train_step(*batch)
            assert seen[-1] == (True, False)
            assert (torch.backends.cudnn.deterministic,
                    torch.backends.cudnn.benchmark) == caller
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved


def test_deterministic_algorithms_restores_on_error():
    """The settings come back when the step raises."""
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    try:
        torch.backends.cudnn.deterministic = False
        torch.backends.cudnn.benchmark = True
        with pytest.raises(RuntimeError):
            with deterministic_algorithms():
                assert torch.backends.cudnn.deterministic
                raise RuntimeError("step failed")
        assert not torch.backends.cudnn.deterministic
        assert torch.backends.cudnn.benchmark
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved
