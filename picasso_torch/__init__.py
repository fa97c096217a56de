"""picasso_torch — the PyTorch/CUDA port of picasso_tpu.

Module names mirror ``picasso_tpu`` so each function's JAX reference is
found by name. Public entry points take an explicit ``device=``; the
hand-written CUDA kernels (``picasso_torch/csrc``) build at first use,
never at import. Importing this package touches neither JAX nor CUDA.
"""

__version__ = "0.1.0"
