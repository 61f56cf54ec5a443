"""The per-row cache scatter the decode step calls.

``cache_update`` takes caches with any trailing dims — (B, C, KVH, hd)
attention K/V — flattens them to the kernel's (B, C, F) layout and
writes in place: the CUDA kernel for tensors on the card, the plain
version for tensors on the CPU.  The JAX package returned a new buffer
(the Pallas call aliased its input); here the caller's cache itself is
updated, and also returned.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import on_card
from repro_torch.kernels.cache_update.kernel import cache_update_cuda
from repro_torch.kernels.cache_update.ref import cache_update_ref


def cache_update(cache: torch.Tensor, new: torch.Tensor,
                 slots: torch.Tensor) -> torch.Tensor:
    """Write ``new[b, 0]`` at ``cache[b, slots[b]]`` for every batch row.

    cache: (B, C, *rest)   new: (B, 1, *rest)   slots: (B,) int.
    """
    if not on_card(cache, new, slots):
        return cache_update_ref(cache, new, slots)
    b, c = cache.shape[:2]
    cache_update_cuda(cache.view(b, c, -1),
                      new.to(cache.dtype).reshape(b, 1, -1).contiguous(),
                      slots.to(torch.int32).contiguous())
    return cache
