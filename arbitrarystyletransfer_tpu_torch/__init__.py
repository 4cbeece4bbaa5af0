"""PyTorch/CUDA port of the arbitrary style transfer system, for Hopper.

The JAX package ``arbitrarystyletransfer_tpu`` is the reference; this
package reproduces its fused stylize engine (``engine.stylize_fused`` with
the "fused", "flat", "flat-all" and "auto" block routes) and its stylize
CLI in PyTorch, with the TPU kernels of those routes rewritten as CUDA C++
kernels for ``sm_90a`` (``csrc/``).

Importing the package builds nothing and needs no GPU: the kernels are
compiled at their first launch on a CUDA tensor (``ops/kernels/_build.py``),
and a CPU tensor takes each kernel's plain PyTorch twin.
"""

from .config import ModelConfig, torch_dtype

__all__ = ["ModelConfig", "torch_dtype"]
