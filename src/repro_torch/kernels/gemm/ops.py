"""The GEMM op: the CUDA kernel for tensors on the card, the plain
version for tensors on the CPU.

It drops the JAX op's ``block_m``/``block_n``/``block_k`` (the TPU's
VMEM tiles; the CUDA kernel picks its own) and ``interpret`` (Pallas's
CPU mode), which mean nothing on the card.  Unlike the TPU kernel it
takes any M, N, K, not only multiples of the blocks.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import on_card
from repro_torch.kernels.gemm.kernel import gemm_cuda
from repro_torch.kernels.gemm.ref import gemm_ref


def gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ b (K, N) with float32 sums -> float32 (M, N)."""
    if not on_card(a, b):
        return gemm_ref(a, b)
    return gemm_cuda(a.contiguous(), b.contiguous())
