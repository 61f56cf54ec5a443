"""Wrapper of the CUDA per-row scatter (``csrc/cache_update.cu``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import build

# Launches of the kernel since the count was last set to 0.
launches = 0


def cache_update_cuda(cache: torch.Tensor, new: torch.Tensor,
                      slots: torch.Tensor) -> torch.Tensor:
    """cache: (B, C, F) on the card, updated in place; new: (B, 1, F) of
    the cache's dtype; slots: (B,) int32.  Returns ``cache``."""
    global launches
    if not (cache.is_cuda and new.is_cuda and slots.is_cuda):
        raise ValueError("cache_update_cuda takes tensors on the card")
    if cache.dim() != 3 or not cache.is_contiguous():
        raise ValueError(f"cache must be a contiguous (B, C, F) tensor, got "
                         f"{tuple(cache.shape)}")
    b, c, f = cache.shape
    build.dtype_code(cache.dtype)
    if new.dtype != cache.dtype:
        raise ValueError(f"new is {new.dtype}, cache is {cache.dtype}")
    if new.shape != (b, 1, f) or not new.is_contiguous():
        raise ValueError(f"new must be a contiguous {(b, 1, f)} tensor, got "
                         f"{tuple(new.shape)}")
    if slots.dtype != torch.int32 or slots.shape != (b,) \
            or not slots.is_contiguous():
        raise ValueError("slots must be a contiguous (B,) int32 tensor")
    err = build.library().pmt_cache_update(
        cache.data_ptr(), new.data_ptr(), slots.data_ptr(), b, c,
        f * cache.element_size(), torch.cuda.current_stream().cuda_stream)
    build.check(err, "cache_update")
    launches += 1
    return cache
