"""Wrappers of the CUDA cache scatters (``csrc/cache_update.cu``): the
per-row scatter of the contiguous caches and the scatter through a page
table into a shared page pool, and their quantizing twins, which write
int8 / fp8_e4m3 codes plus one float32 scale per (row, head), one leaf
(``quant_cache_update_cuda``, ``quant_paged_cache_update_cuda``) or a
layer's k and v leaves (the ``_pair_cuda`` wrappers) a launch."""
from __future__ import annotations

import torch

from repro_torch.kernels import build, quant

# Launches of each kernel since its count was last set to 0.
launches = 0                # cache_update_cuda
paged_launches = 0          # paged_cache_update_cuda
quant_launches = 0          # quant_cache_update_cuda, ..._pair_cuda
quant_paged_launches = 0    # quant_paged_cache_update_cuda, ..._pair_cuda


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


def _quant_leaves(leaves, what: str):
    """Check a quantizing scatter's leaves, (codes, scales, new) triples
    of one shape and dtype set: codes (N, S, H, D) of one code dtype,
    scales (N, S, H) float32, new (B, T, H, D) float32 or bfloat16, all
    contiguous and on the card.  Returns H, D, the source and code dtype
    codes, and the pointers of two leaves (one leaf's twice)."""
    codes, _, new = leaves[0]
    if not all(t.is_cuda for leaf in leaves for t in leaf):
        raise ValueError(f"{what}_cuda takes tensors on the card")
    for c, s, n in leaves:
        if c.dim() != 4 or not c.is_contiguous():
            raise ValueError(f"codes must be a contiguous 4-D tensor, got "
                             f"{tuple(c.shape)}")
        if c.shape != codes.shape or c.dtype != codes.dtype:
            raise ValueError("the leaves' codes differ in shape or dtype")
        if s.dtype != torch.float32 or s.shape != c.shape[:3] \
                or not s.is_contiguous():
            raise ValueError(f"scales must be a contiguous float32 "
                             f"{tuple(c.shape[:3])} tensor")
        if n.dim() != 4 or n.shape[2:] != c.shape[2:] \
                or not n.is_contiguous():
            raise ValueError(f"new must be a contiguous (B, T, "
                             f"{c.shape[2]}, {c.shape[3]}) tensor, got "
                             f"{tuple(n.shape)}")
        if n.shape != new.shape or n.dtype != new.dtype:
            raise ValueError("the leaves' rows differ in shape or dtype")
    cd = build.dtype_code(codes.dtype, codes=True)
    ptrs = [t.data_ptr() for leaf in leaves for t in leaf]
    return (*codes.shape[2:], build.dtype_code(new.dtype), cd,
            ptrs + ptrs[:3] * (2 - len(leaves)))


def _check_mode(codes: torch.Tensor, mode: str) -> None:
    if codes.dtype != quant.quant_dtype(mode):
        raise ValueError(f"codes hold {codes.dtype}, mode {mode!r} stores "
                         f"{quant.quant_dtype(mode)}")


def _quant_scatter(leaves, slots: torch.Tensor, mode: str) -> None:
    """One launch of the contiguous quantizing scatter over one or two
    leaves."""
    global quant_launches
    h, d, sd, cd, ptrs = _quant_leaves(leaves, "quant_cache_update")
    if not slots.is_cuda:
        raise ValueError("quant_cache_update_cuda takes tensors on the card")
    _check_mode(leaves[0][0], mode)
    b, c = leaves[0][0].shape[:2]
    b_new, t = leaves[0][2].shape[:2]
    if b_new != b or not 1 <= t <= c:
        raise ValueError(f"new must be ({b}, T <= {c}, {h}, {d}), got "
                         f"{tuple(leaves[0][2].shape)}")
    _int32_vector(slots, b, "slots")
    err = build.library().pmt_quant_cache_update(
        *ptrs, len(leaves), slots.data_ptr(), b, t, c, h, d, sd, cd,
        torch.cuda.current_stream().cuda_stream)
    build.check(err, "quant_cache_update")
    quant_launches += 1


def quant_cache_update_cuda(cache: torch.Tensor, scales: torch.Tensor,
                            new: torch.Tensor, slots: torch.Tensor,
                            mode: str):
    """cache: (B, C, H, D) codes of ``mode`` and scales: (B, C, H)
    float32, on the card, updated in place; new: (B, T, H, D) float32 or
    bfloat16, T <= C; slots: (B,) int32.  Quantizes each ``new[b, t, h]``
    and writes its codes at ``cache[b, s + t, h]`` and its scale at
    ``scales[b, s + t, h]``, ``s = slots[b]`` clamped to [0, C - T].
    Returns ``(cache, scales)``."""
    _quant_scatter([(cache, scales, new)], slots, mode)
    return cache, scales


def quant_cache_update_pair_cuda(k: torch.Tensor, k_scale: torch.Tensor,
                                 k_new: torch.Tensor, v: torch.Tensor,
                                 v_scale: torch.Tensor, v_new: torch.Tensor,
                                 slots: torch.Tensor, mode: str):
    """``quant_cache_update_cuda`` for a layer's k and v leaves (the same
    shapes and dtypes) in one launch.  Returns ``((k, k_scale), (v,
    v_scale))``."""
    _quant_scatter([(k, k_scale, k_new), (v, v_scale, v_new)], slots, mode)
    return (k, k_scale), (v, v_scale)


def _quant_paged_scatter(leaves, page_table: torch.Tensor,
                         starts: torch.Tensor, valids: torch.Tensor,
                         mode: str) -> None:
    """One launch of the paged quantizing scatter over one or two
    leaves."""
    global quant_paged_launches
    h, d, sd, cd, ptrs = _quant_leaves(leaves, "quant_paged_cache_update")
    if not all(t.is_cuda for t in (page_table, starts, valids)):
        raise ValueError("quant_paged_cache_update_cuda takes tensors on the "
                         "card")
    _check_mode(leaves[0][0], mode)
    ps = leaves[0][0].shape[1]
    b, t = leaves[0][2].shape[:2]
    if page_table.dtype != torch.int32 or page_table.dim() != 2 \
            or page_table.shape[0] != b or page_table.shape[1] < 1 \
            or not page_table.is_contiguous():
        raise ValueError(f"page_table must be a contiguous ({b}, NB >= 1) "
                         f"int32 tensor")
    _int32_vector(starts, b, "starts")
    _int32_vector(valids, b, "valids")
    err = build.library().pmt_quant_paged_cache_update(
        *ptrs, len(leaves), page_table.data_ptr(), starts.data_ptr(),
        valids.data_ptr(), b, t, page_table.shape[1], ps, h, d, sd, cd,
        torch.cuda.current_stream().cuda_stream)
    build.check(err, "quant_paged_cache_update")
    quant_paged_launches += 1


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
    _quant_paged_scatter([(pool, scales, new)], page_table, starts, valids,
                         mode)
    return pool, scales


def quant_paged_cache_update_pair_cuda(
        k: torch.Tensor, k_scale: torch.Tensor, k_new: torch.Tensor,
        v: torch.Tensor, v_scale: torch.Tensor, v_new: torch.Tensor,
        page_table: torch.Tensor, starts: torch.Tensor, valids: torch.Tensor,
        mode: str):
    """``quant_paged_cache_update_cuda`` for a layer's k and v pools (the
    same shapes and dtypes) in one launch.  Returns ``((k, k_scale), (v,
    v_scale))``."""
    _quant_paged_scatter([(k, k_scale, k_new), (v, v_scale, v_new)],
                         page_table, starts, valids, mode)
    return (k, k_scale), (v, v_scale)
