"""Wrappers of the CUDA cache scatters (``csrc/cache_update.cu``): the
per-row scatter of the contiguous caches and the scatter through a page
table into a shared page pool, and their quantizing twins, which write
int8 / fp8_e4m3 codes plus one float32 scale per (row, head)."""
from __future__ import annotations

import torch

from repro_torch.kernels import build, quant

# Launches of each kernel since its count was last set to 0.
launches = 0                # cache_update_cuda
paged_launches = 0          # paged_cache_update_cuda
quant_launches = 0          # quant_cache_update_cuda
quant_paged_launches = 0    # quant_paged_cache_update_cuda


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


def _quant_operands(codes: torch.Tensor, scales: torch.Tensor,
                    new: torch.Tensor, mode: str, what: str):
    """Check a quantizing scatter's code and scale leaves and its source
    rows; returns (H, D, src dtype code, code dtype code)."""
    if codes.dim() != 4 or not codes.is_contiguous():
        raise ValueError(f"{what} must be a contiguous 4-D code tensor, got "
                         f"{tuple(codes.shape)}")
    if codes.dtype != quant.quant_dtype(mode):
        raise ValueError(f"{what} holds {codes.dtype}, mode {mode!r} stores "
                         f"{quant.quant_dtype(mode)}")
    cd = build.dtype_code(codes.dtype, codes=True)
    h, d = codes.shape[2:]
    if scales.dtype != torch.float32 or scales.shape != codes.shape[:3] \
            or not scales.is_contiguous():
        raise ValueError(f"scales must be a contiguous float32 "
                         f"{tuple(codes.shape[:3])} tensor")
    if new.dim() != 4 or new.shape[2:] != (h, d) or not new.is_contiguous():
        raise ValueError(f"new must be a contiguous (B, T, {h}, {d}) tensor, "
                         f"got {tuple(new.shape)}")
    return h, d, build.dtype_code(new.dtype), cd


def quant_cache_update_cuda(cache: torch.Tensor, scales: torch.Tensor,
                            new: torch.Tensor, slots: torch.Tensor,
                            mode: str):
    """cache: (B, C, H, D) codes of ``mode`` and scales: (B, C, H)
    float32, on the card, updated in place; new: (B, 1, H, D) float32 or
    bfloat16; slots: (B,) int32.  Quantizes each ``new[b, 0, h]`` and
    writes its codes at ``cache[b, slots[b], h]`` and its scale at
    ``scales[b, slots[b], h]``.  Returns ``(cache, scales)``."""
    global quant_launches
    if not all(t.is_cuda for t in (cache, scales, new, slots)):
        raise ValueError("quant_cache_update_cuda takes tensors on the card")
    h, d, sd, cd = _quant_operands(cache, scales, new, mode, "cache")
    b, c = cache.shape[:2]
    if new.shape[:2] != (b, 1):
        raise ValueError(f"new must be ({b}, 1, {h}, {d}), got "
                         f"{tuple(new.shape)}")
    _int32_vector(slots, b, "slots")
    err = build.library().pmt_quant_cache_update(
        cache.data_ptr(), scales.data_ptr(), new.data_ptr(),
        slots.data_ptr(), b, c, h, d, sd, cd,
        torch.cuda.current_stream().cuda_stream)
    build.check(err, "quant_cache_update")
    quant_launches += 1
    return cache, scales


def quant_paged_cache_update_cuda(pool: torch.Tensor, scales: torch.Tensor,
                                  new: torch.Tensor, page_table: torch.Tensor,
                                  starts: torch.Tensor, valids: torch.Tensor,
                                  mode: str):
    """pool: (P, page_size, H, D) codes of ``mode`` and scales:
    (P, page_size, H) float32, on the card, updated in place; new:
    (B, T, H, D) float32 or bfloat16; page_table: (B, NB) int32 with
    every entry a page of the pools; starts, valids: (B,) int32.  Row
    ``t`` of ``new[b]`` is quantized per head and lands at logical
    position ``min(starts[b] + t, NB * page_size - 1)`` of row ``b`` when
    ``t < valids[b]``; masked rows are not written.  Returns
    ``(pool, scales)``."""
    global quant_paged_launches
    ts = (pool, scales, new, page_table, starts, valids)
    if not all(t.is_cuda for t in ts):
        raise ValueError("quant_paged_cache_update_cuda takes tensors on the "
                         "card")
    h, d, sd, cd = _quant_operands(pool, scales, new, mode, "pool")
    ps = pool.shape[1]
    b, t = new.shape[:2]
    if page_table.dtype != torch.int32 or page_table.dim() != 2 \
            or page_table.shape[0] != b or page_table.shape[1] < 1 \
            or not page_table.is_contiguous():
        raise ValueError(f"page_table must be a contiguous ({b}, NB >= 1) "
                         f"int32 tensor")
    _int32_vector(starts, b, "starts")
    _int32_vector(valids, b, "valids")
    err = build.library().pmt_quant_paged_cache_update(
        pool.data_ptr(), scales.data_ptr(), new.data_ptr(),
        page_table.data_ptr(), starts.data_ptr(), valids.data_ptr(), b, t,
        page_table.shape[1], ps, h, d, sd, cd,
        torch.cuda.current_stream().cuda_stream)
    build.check(err, "quant_paged_cache_update")
    quant_paged_launches += 1
    return pool, scales
