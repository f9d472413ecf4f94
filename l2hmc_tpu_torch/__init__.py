"""l2hmc_tpu_torch — the PyTorch / CUDA port of l2hmc_tpu for NVIDIA Hopper.

Mirrors the JAX package's module paths. Plain tensor code is PyTorch; each
Pallas kernel of the JAX package becomes a hand-written CUDA kernel under
``csrc/``, built with nvcc at first use (``ops/_cuda.py``).

Importing the package loads neither JAX nor the JAX package, and needs
neither nvcc nor a card.
"""

from l2hmc_tpu_torch import config  # noqa: F401  (TF32 off on import)

__version__ = "0.1.0"
