"""CLIP-EBC in PyTorch with hand-written CUDA kernels for Hopper (sm_90a).

The PyTorch counterpart of ``clip_ebc_tpu`` (the JAX/Flax/Pallas package
beside it, which stays the reference). Module paths mirror the JAX
package so each counterpart is easy to find. This package imports torch
and numpy only: never jax, flax or anything under ``clip_ebc_tpu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
they raise when CUDA is absent and no device was named. The two TPU
kernels of the flagship inference path are CUDA C++ under ``csrc/``,
built with nvcc at first use into ``build/kernels/`` (ops/_build.py).
"""

__version__ = "0.1.0"

from . import config
from .config import get_bins_and_anchors
