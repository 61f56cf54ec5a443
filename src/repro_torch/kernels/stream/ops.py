"""The STREAM triad op: the CUDA kernel for tensors on the card, the
plain version for tensors on the CPU.

It keeps the JAX op's data argument ``scalar`` and drops ``block`` (the
TPU's VMEM row block) and ``interpret`` (Pallas's CPU mode), which mean
nothing on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import on_card
from repro_torch.kernels.stream.kernel import stream_triad_cuda
from repro_torch.kernels.stream.ref import stream_triad_ref


def stream_triad(a: torch.Tensor, b: torch.Tensor,
                 scalar: float = 2.0) -> torch.Tensor:
    """``a + scalar * b`` for (M, N) float32 or bfloat16 ``a``, ``b``."""
    if not on_card(a, b):
        return stream_triad_ref(a, b, scalar)
    return stream_triad_cuda(a.contiguous(), b.contiguous(), scalar)
