"""The port's small pieces against their JAX counterparts, on the CPU: the
sRGB <-> CIELAB conversions, the content loss and the alternative soft
histogram, the Gaussian-noise augmentation (bit for bit from the same
``random.Random`` state), ``DataConfig`` and ``default_imsize``, and the
profiling helpers.
"""

import dataclasses
import json
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arbitrarystyletransfer_tpu import config as jax_config
from arbitrarystyletransfer_tpu import losses as jax_losses
from arbitrarystyletransfer_tpu.data import pipeline as jax_pipeline
from arbitrarystyletransfer_tpu.ops import color as jax_color
from arbitrarystyletransfer_tpu.utils import profiling as jax_profiling

from arbitrarystyletransfer_tpu_torch import config as port_config
from arbitrarystyletransfer_tpu_torch import losses
from arbitrarystyletransfer_tpu_torch.data import pipeline
from arbitrarystyletransfer_tpu_torch.ops import color
from arbitrarystyletransfer_tpu_torch.utils import profiling

from test_torch_ops import assert_close


def _color_input(name, rng):
    """An input in the domain of ``name``: sRGB in [0, 1] (with values on
    both sides of the linear segment's knee), XYZ of such colours, LAB of
    them, and rgb2lab's rescaled LAB."""
    rgb = rng.uniform(0, 1, (2, 5, 7, 3)).astype(np.float32)
    rgb[0, 0, :, :] = rng.uniform(0, 0.04, (7, 3))  # below 0.04045
    src = {"rgb2xyz": lambda: rgb, "rgb2lab": lambda: rgb,
           "xyz2rgb": lambda: jax_color.rgb2xyz(rgb),
           "xyz2lab": lambda: jax_color.rgb2xyz(rgb),
           "lab2xyz": lambda: jax_color.xyz2lab(jax_color.rgb2xyz(rgb)),
           "lab2rgb": lambda: jax_color.rgb2lab(rgb)}[name]
    return np.array(src(), np.float32)


@pytest.mark.parametrize("name", ["rgb2xyz", "xyz2rgb", "xyz2lab",
                                  "lab2xyz", "rgb2lab", "lab2rgb"])
def test_color_conversion_matches_jax(name):
    x = _color_input(name, np.random.default_rng(1))
    ref = np.asarray(getattr(jax_color, name)(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = getattr(color, name)(xt)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    # Elementwise powers and a 3 x 3 product in f32: measured <= 4e-7 of
    # the max.
    assert_close(got.detach(), ref, 2e-6, name)
    # Differentiable, as the JAX functions are.
    ref_grad = np.asarray(jax.grad(
        lambda a: getattr(jax_color, name)(a).sum())(x))
    (grad,) = torch.autograd.grad(got.sum(), xt)
    assert_close(grad, ref_grad, 2e-5, f"d{name}")


def test_color_round_trip():
    rgb = np.random.default_rng(2).uniform(0, 1, (1, 4, 4, 3)).astype(
        np.float32)
    back = color.lab2rgb(color.rgb2lab(torch.from_numpy(rgb)))
    assert_close(back, rgb, 1e-4, "lab2rgb(rgb2lab(x))")
    from arbitrarystyletransfer_tpu_torch import ops

    assert ops.color is color


@pytest.mark.parametrize("case", ["content_loss", "soft_histogram_alt",
                                  "soft_histogram_alt_bins"])
def test_losses_match_jax(case):
    rng = np.random.default_rng(3)
    if case == "content_loss":
        a = rng.normal(size=(2, 6, 5, 4)).astype(np.float32) * 2
        b = rng.normal(size=(2, 6, 5, 4)).astype(np.float32)
        ref = jax_losses.compute_content_loss(a, b)
        got = losses.compute_content_loss(torch.from_numpy(a),
                                          torch.from_numpy(b))
    else:
        x = rng.uniform(-0.1, 1.1, (2, 3, 50)).astype(np.float32)
        kw = ({} if case == "soft_histogram_alt"
              else dict(bins=16, vmin=-0.5, vmax=1.5, sigma=10.0))
        ref = jax_losses.soft_histogram_alt(x, **kw)
        got = losses.soft_histogram_alt(torch.from_numpy(x), **kw)
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape
    # f32 sums in another order: measured <= 3e-7 of the max.
    assert_close(got, ref, 2e-6, case)


@pytest.mark.parametrize("seed", range(6))
def test_add_gaussian_noise_is_bit_for_bit(seed):
    """The same ``random.Random`` state gives the same array and leaves the
    same state; the noise fires when the draw exceeds ``p`` (both branches
    are among the seeds at p = 0.5)."""
    x = np.random.default_rng(seed).uniform(0, 1, (9, 7, 3)).astype(
        np.float32)
    r_port, r_jax = random.Random(seed), random.Random(seed)
    fires = random.Random(seed).random() > 0.5
    got = pipeline.add_gaussian_noise(x.copy(), r_port, std=0.1, p=0.5)
    ref = jax_pipeline.add_gaussian_noise(x.copy(), r_jax, std=0.1, p=0.5)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    assert r_port.getstate() == r_jax.getstate()
    assert np.array_equal(got, x) != fires
    assert got.min() >= 0.0 and got.max() <= 1.0


def test_data_config_and_default_imsize(monkeypatch):
    assert (dataclasses.asdict(port_config.DataConfig())
            == dataclasses.asdict(jax_config.DataConfig()))
    assert port_config.IMSIZE == jax_config.IMSIZE
    # This CPU host: 128 in both packages.
    assert not torch.cuda.is_available()
    assert port_config.default_imsize() == jax_config.default_imsize() == 128
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert port_config.default_imsize() == 320


def test_profiling_helpers(tmp_path):
    """``profile_trace`` writes a Chrome trace that holds the block's ops;
    ``log_compile_time`` returns (output, first, steady) and logs the line
    JAX's does."""
    x = torch.ones(64, 64)
    with profiling.profile_trace(str(tmp_path / "trace")):
        (x @ x).sum()
    with open(tmp_path / "trace" / "trace.json") as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("mm" in n for n in names), sorted(names)[:20]

    lines, jax_lines = [], []
    out, first, steady = profiling.log_compile_time(
        lambda a: a * 2, x, label="double", log_fn=lines.append)
    jout, jfirst, jsteady = jax_profiling.log_compile_time(
        jax.jit(lambda a: a * 2), jnp.ones((64, 64)), label="double",
        log_fn=jax_lines.append)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    assert first > 0 and steady > 0 and jfirst > 0 and jsteady > 0
    assert len(lines) == len(jax_lines) == 1
    for line in (lines[0], jax_lines[0]):
        rest = line.removeprefix("double: first call ").removesuffix(" ms")
        first_ms, steady_ms = map(float, rest.split(" ms, steady "))
        assert line == (f"double: first call {first_ms:.1f} ms, "
                        f"steady {steady_ms:.1f} ms")
