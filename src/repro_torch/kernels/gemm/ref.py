"""Plain PyTorch version of the GEMM.

The same function as the JAX package's ``gemm_ref``
(``jnp.dot(a, b, preferred_element_type=float32)``): the inputs' values
taken exactly in float32 and their products summed in float32.  On the
card this needs TF32 off (``torch.backends.cuda.matmul.allow_tf32 =
False``, PyTorch's default), or the product keeps only ~10 bits.
"""
from __future__ import annotations

import torch


def gemm_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a: (M, K), b: (K, N), float32 or bfloat16 -> float32 (M, N)."""
    return torch.matmul(a.float(), b.float())
