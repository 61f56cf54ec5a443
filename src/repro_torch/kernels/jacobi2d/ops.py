"""The Jacobi-2D op: the CUDA kernel for a tensor on the card, the plain
version for a tensor on the CPU.

It drops the JAX op's ``block_h`` (the TPU's VMEM row block; the CUDA
kernel picks its own tiles) and ``interpret`` (Pallas's CPU mode), which
mean nothing on the card.  Unlike the TPU kernel it takes any H, not
only multiples of the block.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import on_card
from repro_torch.kernels.jacobi2d.kernel import jacobi2d_cuda
from repro_torch.kernels.jacobi2d.ref import jacobi2d_ref


def jacobi2d(x: torch.Tensor) -> torch.Tensor:
    """One 5-point sweep of (H, W) float32 ``x``; returns a new tensor."""
    if not on_card(x):
        return jacobi2d_ref(x)
    return jacobi2d_cuda(x.contiguous())
