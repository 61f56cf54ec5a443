"""Plain PyTorch version of one Jacobi-2D sweep.

The same function as the JAX package's ``jacobi2d_ref``: interior cells
get ``0.2 * (c + up + down + left + right)``, summed left to right in
that order (which gives the reference's bits), and boundary rows and
columns keep ``x``.  Returns a new tensor.
"""
from __future__ import annotations

import torch


def jacobi2d_ref(x: torch.Tensor) -> torch.Tensor:
    """x: (H, W) float32."""
    out = x.clone()
    c = x[1:-1, 1:-1]
    out[1:-1, 1:-1] = 0.2 * ((((c + x[:-2, 1:-1]) + x[2:, 1:-1])
                              + x[1:-1, :-2]) + x[1:-1, 2:])
    return out
