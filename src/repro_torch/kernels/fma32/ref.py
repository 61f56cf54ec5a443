"""Plain PyTorch version of FMA32.

The same function as the JAX package's ``fma32_ref``: ``iters`` dependent
``y = y * 1.0000001 + 1e-7`` in float32.  XLA contracts that expression
into one fused multiply-add, so each step rounds once; ``torch.addcmul``
(``b + y * a``) does the same, where ``y * 1.0000001 + 1e-7`` written as
two operations would round twice and miss the reference's rtol 1e-6
after 1024 steps.
"""
from __future__ import annotations

import torch

A, B = 1.0000001, 1e-7


def fma32_ref(x: torch.Tensor, iters: int = 64) -> torch.Tensor:
    """x: float32 of any shape; returns a new tensor."""
    a = torch.tensor(A, dtype=torch.float32, device=x.device)
    b = torch.tensor(B, dtype=torch.float32, device=x.device)
    y = x.clone()
    for _ in range(iters):
        y = torch.addcmul(b, y, a)
    return y
