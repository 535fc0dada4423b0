"""vega_tpu_torch: the dense tier of vega_tpu ported to PyTorch and CUDA.

A package of its own beside vega_tpu: it imports torch and numpy, never jax
and nothing of vega_tpu. Entry point: Context (context.py). The exchange's
kernels are hand-written CUDA C++ for Hopper (csrc/shuffle_kernels.cu,
built at first use by cuda_kernels.py).
"""

from vega_tpu_torch.context import Context
from vega_tpu_torch.errors import VegaError

__all__ = ["Context", "VegaError"]
