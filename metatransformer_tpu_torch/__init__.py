"""metatransformer_tpu_torch: the PyTorch and CUDA port of metatransformer_tpu.

The JAX package stays the reference: each module here mirrors the file of
the same relative path there and keeps its parameter layout, so weights
carry across as a plain mapping. The fused transformer sublayers are
hand-written CUDA kernels for Hopper (``ops/csrc``); every other part is
plain PyTorch. This package never imports ``jax``.
"""

__version__ = "0.1.0"

from metatransformer_tpu_torch.core import encoder  # noqa: F401
