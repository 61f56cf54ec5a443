"""Wrappers of the CUDA cache scatters (``csrc/cache_update.cu``): the
per-row scatter of the contiguous caches and the scatter through a page
table into a shared page pool, and their quantizing twins, which write
int8 / fp8_e4m3 codes plus one float32 scale per (row, head).  Each
writes one leaf (``cache_update_cuda``, ``paged_cache_update_cuda``,
``quant_cache_update_cuda``, ``quant_paged_cache_update_cuda``) or a
layer's k and v leaves (the ``_pair_cuda`` wrappers) a launch."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, quant

# Launches of each kernel since its count was last set to 0.
launches = 0                # cache_update_cuda, cache_update_pair_cuda
paged_launches = 0          # paged_cache_update_cuda, ..._pair_cuda
quant_launches = 0          # quant_cache_update_cuda, ..._pair_cuda
quant_paged_launches = 0    # quant_paged_cache_update_cuda, ..._pair_cuda


def _copy_leaves(leaves, what: str) -> list:
    """Check a copying scatter's leaves, (cache or pool, new) pairs of one
    shape and dtype: the cache (N, S, F) and new (B, T, F) of its dtype,
    both contiguous and on the card.  Returns the pointers of two leaves
    (one leaf's twice)."""
    cache, new = leaves[0]
    if not all(t.is_cuda for leaf in leaves for t in leaf):
        raise ValueError(f"{what}_cuda takes tensors on the card")
    for c, n in leaves:
        if c.dim() != 3 or not c.is_contiguous():
            raise ValueError(f"the cache must be a contiguous 3-D tensor, "
                             f"got {tuple(c.shape)}")
        if c.shape != cache.shape or c.dtype != cache.dtype:
            raise ValueError("the leaves' caches differ in shape or dtype")
        build.dtype_code(c.dtype)
        if n.dtype != c.dtype:
            raise ValueError(f"new is {n.dtype}, the cache is {c.dtype}")
        if n.dim() != 3 or n.shape[2] != c.shape[2] \
                or not n.is_contiguous():
            raise ValueError(f"new must be a contiguous (B, T, "
                             f"{c.shape[2]}) tensor, got {tuple(n.shape)}")
        if n.shape != new.shape:
            raise ValueError("the leaves' rows differ in shape")
    ptrs = [t.data_ptr() for leaf in leaves for t in leaf]
    return ptrs + ptrs[:2] * (2 - len(leaves))


def _int32_vector(t: torch.Tensor, n: int, name: str) -> None:
    if t.dtype != torch.int32 or t.shape != (n,) or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous ({n},) int32 tensor")


def _scatter(leaves, slots: torch.Tensor) -> None:
    """One launch of the contiguous scatter over one or two leaves."""
    global launches
    ptrs = _copy_leaves(leaves, "cache_update")
    if not slots.is_cuda:
        raise ValueError("cache_update_cuda takes tensors on the card")
    cache, new = leaves[0]
    b, c, f = cache.shape
    if new.shape != (b, 1, f):
        raise ValueError(f"new must be a contiguous {(b, 1, f)} tensor, got "
                         f"{tuple(new.shape)}")
    _int32_vector(slots, b, "slots")
    err = build.library().pmt_cache_update(
        *ptrs, len(leaves), slots.data_ptr(), b, c, f * cache.element_size(),
        torch.cuda.current_stream().cuda_stream)
    build.check(err, "cache_update")
    launches += 1


def cache_update_cuda(cache: torch.Tensor, new: torch.Tensor,
                      slots: torch.Tensor) -> torch.Tensor:
    """cache: (B, C, F) on the card, updated in place; new: (B, 1, F) of
    the cache's dtype; slots: (B,) int32.  Writes ``new[b, 0]`` at
    ``cache[b, s]``, ``s = slots[b]`` clamped to [0, C - 1].  Returns
    ``cache``."""
    _scatter([(cache, new)], slots)
    return cache


def cache_update_pair_cuda(k: torch.Tensor, k_new: torch.Tensor,
                           v: torch.Tensor, v_new: torch.Tensor,
                           slots: torch.Tensor):
    """``cache_update_cuda`` for a layer's k and v caches (the same shapes
    and dtype) in one launch.  Returns ``(k, v)``."""
    _scatter([(k, k_new), (v, v_new)], slots)
    return k, v


def _paged_where(where, b: int, leaves: int, what: str) -> list:
    """Check a paged scatter's (page_table, starts, valids).  ``valids``
    None, which the pair launches take, means every one of the T rows is
    valid (the kernels read a null pointer so); a one-leaf launch needs
    it, as the JAX package's functions do.  Returns NB and the three
    pointers."""
    page_table, starts, valids = where
    if valids is None and leaves == 1:
        raise ValueError(f"{what}_cuda needs valids")
    if not all(t.is_cuda for t in where if t is not None):
        raise ValueError(f"{what}_cuda takes tensors on the card")
    if page_table.dtype != torch.int32 or page_table.dim() != 2 \
            or page_table.shape[0] != b or page_table.shape[1] < 1 \
            or not page_table.is_contiguous():
        raise ValueError(f"page_table must be a contiguous ({b}, NB >= 1) "
                         f"int32 tensor")
    _int32_vector(starts, b, "starts")
    if valids is not None:
        _int32_vector(valids, b, "valids")
    return [page_table.shape[1], page_table.data_ptr(), starts.data_ptr(),
            None if valids is None else valids.data_ptr()]


def _paged_scatter(leaves, where) -> None:
    """One launch of the paged scatter over one or two leaves."""
    global paged_launches
    ptrs = _copy_leaves(leaves, "paged_cache_update")
    pool, new = leaves[0]
    ps, f = pool.shape[1:]
    b, t = new.shape[:2]
    nb, *where_ptrs = _paged_where(where, b, len(leaves),
                                   "paged_cache_update")
    err = build.library().pmt_paged_cache_update(
        *ptrs, len(leaves), *where_ptrs, b, t, nb, ps,
        f * pool.element_size(), torch.cuda.current_stream().cuda_stream)
    build.check(err, "paged_cache_update")
    paged_launches += 1


def paged_cache_update_cuda(pool: torch.Tensor, new: torch.Tensor,
                            page_table: torch.Tensor, starts: torch.Tensor,
                            valids: torch.Tensor) -> torch.Tensor:
    """pool: (P, page_size, F) on the card, updated in place; new:
    (B, T, F) of the pool's dtype; page_table: (B, NB) int32 with every
    entry a page of the pool; starts, valids: (B,) int32.  Row ``t`` of
    ``new[b]`` lands at logical position ``min(starts[b] + t,
    NB * page_size - 1)`` of row ``b`` when ``t < valids[b]``; masked rows
    are not written.  Returns ``pool``."""
    _paged_scatter([(pool, new)], (page_table, starts, valids))
    return pool


def paged_cache_update_pair_cuda(k: torch.Tensor, k_new: torch.Tensor,
                                 v: torch.Tensor, v_new: torch.Tensor,
                                 page_table: torch.Tensor,
                                 starts: torch.Tensor,
                                 valids: Optional[torch.Tensor] = None):
    """``paged_cache_update_cuda`` for a layer's k and v pools (the same
    shapes and dtype) in one launch; ``valids`` None means every one of
    the T rows is valid.  Returns ``(k, v)``."""
    _paged_scatter([(k, k_new), (v, v_new)], (page_table, starts, valids))
    return k, v


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
                         starts: torch.Tensor,
                         valids: Optional[torch.Tensor], mode: str) -> None:
    """One launch of the paged quantizing scatter over one or two
    leaves."""
    global quant_paged_launches
    h, d, sd, cd, ptrs = _quant_leaves(leaves, "quant_paged_cache_update")
    _check_mode(leaves[0][0], mode)
    ps = leaves[0][0].shape[1]
    b, t = leaves[0][2].shape[:2]
    nb, *where_ptrs = _paged_where((page_table, starts, valids), b,
                                   len(leaves), "quant_paged_cache_update")
    err = build.library().pmt_quant_paged_cache_update(
        *ptrs, len(leaves), *where_ptrs, b, t, nb, ps, h, d, sd, cd,
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
        page_table: torch.Tensor, starts: torch.Tensor,
        valids: Optional[torch.Tensor], mode: str):
    """``quant_paged_cache_update_cuda`` for a layer's k and v pools (the
    same shapes and dtypes) in one launch; ``valids`` None means every one
    of the T rows is valid.  Returns ``((k, k_scale), (v, v_scale))``."""
    _quant_paged_scatter([(k, k_scale, k_new), (v, v_scale, v_new)],
                         page_table, starts, valids, mode)
    return (k, k_scale), (v, v_scale)
