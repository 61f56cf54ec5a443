"""The FMA32 op: the CUDA kernel for a tensor on the card, the plain
version for a tensor on the CPU.

It keeps the JAX op's data argument ``iters`` and drops ``block`` (the
TPU's VMEM row block) and ``interpret`` (Pallas's CPU mode), which mean
nothing on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import on_card
from repro_torch.kernels.fma32.kernel import fma32_cuda
from repro_torch.kernels.fma32.ref import fma32_ref


def fma32(x: torch.Tensor, iters: int = 64) -> torch.Tensor:
    """``iters`` dependent fused ``y = y * 1.0000001 + 1e-7`` on float32
    ``x`` (M, N); returns a new tensor."""
    if not on_card(x):
        return fma32_ref(x, iters)
    return fma32_cuda(x.contiguous(), iters)
