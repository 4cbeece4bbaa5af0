"""How far the port's float32 steps lie from JAX's float64 step over a
2-device mesh, gradient by gradient: the 2-rank step at 1, 2 and 4 threads
per rank and the one-process step, on the inputs of
``test_torch_parallel_train.py`` (the AST step with its raised TV weight)
and ``test_torch_parallel_steps.py`` (the autoencoder step).

    python tests/torch_parallel_f32_spread.py ast    # or: ae

Run from the repository root on the CPU (~4 min each).  Prints, per thread
count, the worst distance above and below the gradient floor (each relative
to its floored scale, as ``_grad_limits`` sets it) of the 2-rank step and of
the one-process step, and the worst share of the 2-rank step's distance in
``_check_against_jax``'s float32 limit.
"""

import os
import sys

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [TESTS, os.path.dirname(TESTS)]

import conftest  # noqa: E402,F401  (the virtual CPU devices)
import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_parallel_train as t  # noqa: E402
import torch_parallel_workers as workers  # noqa: E402
from arbitrarystyletransfer_tpu import config as jax_config  # noqa: E402
from arbitrarystyletransfer_tpu.models import AST as JaxAST  # noqa: E402
from arbitrarystyletransfer_tpu.models import (  # noqa: E402
    VGG19Features as JaxVGG,
)
from arbitrarystyletransfer_tpu.models.autoencoder import (  # noqa: E402
    AutoEncoder as JaxAE,
)
from arbitrarystyletransfer_tpu.train import (  # noqa: E402
    make_ae_train_step,
    make_ast_train_step,
)
from arbitrarystyletransfer_tpu_torch import ModelConfig, weights  # noqa: E402
from arbitrarystyletransfer_tpu_torch.models.ast import AST  # noqa: E402
from arbitrarystyletransfer_tpu_torch.models.vgg import (  # noqa: E402
    init_vgg_params,
)
from arbitrarystyletransfer_tpu_torch.parallel.launch import (  # noqa: E402
    run_ranks,
)
from test_torch_autoencoder import ae_variables  # noqa: E402
from test_torch_ops import ast_variables  # noqa: E402
from test_torch_train_step import _normalize_head  # noqa: E402


def distances(out, ref_grads):
    """{name: (distance relative to the floored scale, above the floor)}."""
    result = {}
    for name, rel in t._grad_limits(ref_grads).items():
        ref = ref_grads[name]
        scale = rel * max(float(np.abs(ref).max()), 1e-6)
        err = float(np.abs(np.asarray(out["grads"][name], np.float64)
                           - ref).max())
        result[name] = (err / scale, rel == 1.0)
    return result


def worst(dist, above):
    return max((d, n) for n, (d, a) in dist.items() if a == above)


def main(which):
    if which == "ast":
        v = ast_variables(seed=41, proj_gain=1.0)
        vgg = init_vgg_params(generator=torch.Generator().manual_seed(42))
        content, style = t._images(43)
        ast = AST(ModelConfig())
        weights.load_state(ast, weights.from_jax_tree(v["params"],
                                                      v["batch_stats"]))
        _normalize_head(v, ast, content, style)
        cfg_kw = {"tv_lam": t.TV_LAM}
        ref = t._jax_f64_step(lambda: make_ast_train_step(
            JaxAST(jax_config.ModelConfig()), JaxVGG(),
            jax_config.ASTTrainConfig(**cfg_kw)), v, vgg, (content, style))

        def ranks_step():
            return run_ranks(workers.ast_steps_rank, t.RANKS, v, vgg, content,
                             style, [(torch.float32, cfg_kw)],
                             timeout=600)[0][0]

        def one_step():
            return workers.ast_step_rank(workers.one_rank(), v, vgg, content,
                                         style, torch.float32, cfg_kw)
    else:
        v = ae_variables(94, proj_gain=1.0)
        vgg = init_vgg_params(generator=torch.Generator().manual_seed(95))
        x = t._images(96)[0]
        ref = t._jax_f64_step(lambda: make_ae_train_step(
            JaxAE(jax_config.ModelConfig()), JaxVGG(),
            jax_config.AETrainConfig()), v, vgg, (x,))

        def ranks_step():
            return run_ranks(workers.ae_steps_rank, t.RANKS, v, vgg, x,
                             [torch.float32], timeout=600)[0][0]

        def one_step():
            return workers.ae_step_rank(workers.one_rank(), v, vgg, x,
                                        torch.float32)
    ref_grads = ref[1]
    for per_rank in (1, 2, 4):
        torch.set_num_threads(per_rank * t.RANKS)
        d2 = distances(ranks_step(), ref_grads)
        d1 = distances(one_step(), ref_grads)
        share = max((d / max(1e-4, 2 * d1[n][0]), n)
                    for n, (d, _) in d2.items())
        print(f"{which}, {per_rank} thread(s) per rank: 2 ranks above the "
              f"floor {worst(d2, True)}, below {worst(d2, False)}; one "
              f"process above {worst(d1, True)}, below {worst(d1, False)}; "
              f"worst share of the float32 limit {share}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "ast")
