"""Plain PyTorch version of the STREAM triad.

The same function as the JAX package's ``stream_triad_ref``: ``a + s*b``
as two operations, each rounded to the arrays' type (float32 or
bfloat16).  Unlike FMA32, XLA does not contract this one, so neither
may the port.
"""
from __future__ import annotations

import torch


def stream_triad_ref(a: torch.Tensor, b: torch.Tensor,
                     scalar: float = 2.0) -> torch.Tensor:
    return a + scalar * b
