"""Wrappers of the CUDA cache scatters (``csrc/cache_update.cu``): the
per-row scatter of the contiguous caches and the scatter through a page
table into a shared page pool."""
from __future__ import annotations

import torch

from repro_torch.kernels import build

# Launches of each kernel since its count was last set to 0.
launches = 0            # cache_update_cuda
paged_launches = 0      # paged_cache_update_cuda


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


def _int32_vector(t: torch.Tensor, n: int, name: str) -> None:
    if t.dtype != torch.int32 or t.shape != (n,) or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous ({n},) int32 tensor")


def paged_cache_update_cuda(pool: torch.Tensor, new: torch.Tensor,
                            page_table: torch.Tensor, starts: torch.Tensor,
                            valids: torch.Tensor) -> torch.Tensor:
    """pool: (P, page_size, F) on the card, updated in place; new:
    (B, T, F) of the pool's dtype; page_table: (B, NB) int32 with every
    entry a page of the pool; starts, valids: (B,) int32.  Row ``t`` of
    ``new[b]`` lands at logical position ``min(starts[b] + t,
    NB * page_size - 1)`` of row ``b`` when ``t < valids[b]``; masked rows
    are not written.  Returns ``pool``."""
    global paged_launches
    ts = (pool, new, page_table, starts, valids)
    if not all(t.is_cuda for t in ts):
        raise ValueError("paged_cache_update_cuda takes tensors on the card")
    if pool.dim() != 3 or not pool.is_contiguous():
        raise ValueError(f"pool must be a contiguous (P, page_size, F) "
                         f"tensor, got {tuple(pool.shape)}")
    p, ps, f = pool.shape
    build.dtype_code(pool.dtype)
    if new.dtype != pool.dtype:
        raise ValueError(f"new is {new.dtype}, pool is {pool.dtype}")
    if new.dim() != 3 or new.shape[2] != f or not new.is_contiguous():
        raise ValueError(f"new must be a contiguous (B, T, {f}) tensor, got "
                         f"{tuple(new.shape)}")
    b, t = new.shape[:2]
    if page_table.dtype != torch.int32 or page_table.dim() != 2 \
            or page_table.shape[0] != b or not page_table.is_contiguous():
        raise ValueError(f"page_table must be a contiguous ({b}, NB) int32 "
                         f"tensor")
    _int32_vector(starts, b, "starts")
    _int32_vector(valids, b, "valids")
    nb = page_table.shape[1]
    if nb < 1:
        raise ValueError("empty page table")
    err = build.library().pmt_paged_cache_update(
        pool.data_ptr(), new.data_ptr(), page_table.data_ptr(),
        starts.data_ptr(), valids.data_ptr(), b, t, nb, ps,
        f * pool.element_size(), torch.cuda.current_stream().cuda_stream)
    build.check(err, "paged_cache_update")
    paged_launches += 1
    return pool
