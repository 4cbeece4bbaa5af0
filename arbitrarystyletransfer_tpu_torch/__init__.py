"""PyTorch/CUDA port of the arbitrary style transfer system, for Hopper.

The JAX package ``arbitrarystyletransfer_tpu`` is the reference; this
package reproduces its fused 512px stylize path (``engine.stylize_fused``
with the fused encoder and decoder) in PyTorch, with the two TPU kernels of
that path rewritten as CUDA C++ kernels for ``sm_90a`` (``csrc/``).

Importing the package builds nothing and needs no GPU: the kernels are
compiled at their first launch on a CUDA tensor (``ops/kernels/_build.py``),
and a CPU tensor takes each kernel's plain PyTorch twin.
"""

from .config import ModelConfig, torch_dtype

__all__ = ["ModelConfig", "torch_dtype"]
