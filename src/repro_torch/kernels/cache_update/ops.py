"""The cache scatters the serve steps call.

``cache_update`` takes caches with any trailing dims — (B, C, KVH, hd)
attention K/V — flattens them to the kernel's (B, C, F) layout and
writes in place: the CUDA kernel for tensors on the card, the plain
version for tensors on the CPU.  ``paged_cache_update`` does the same
for (P, page_size, *rest) page pools addressed through a page table.
``quant_cache_update`` and ``quant_paged_cache_update`` are their
quantizing twins for int8 / fp8_e4m3 caches: each (row, head) vector is
quantized to codes plus one float32 scale, both scattered in place; the
contiguous one also takes a prefill chunk's T rows.  The one-leaf ops
write MLA's one ``[latent | rope]`` leaf a layer (``models/mla.py``:
(B, C, 576) rows at deepseek-v3's full width, codes with (B, C) scales
quantized); the ``_pair`` versions of all four write a GQA layer's k and
v leaves in one kernel launch (``models/attention.py``); the paged pairs
take ``valids=None`` for every row valid (a decode step's write).
The JAX package returned a new buffer (the Pallas call aliased its
input); here the caller's cache itself is updated, and also returned.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import on_card
from repro_torch.kernels.cache_update.kernel import (
    cache_update_cuda, cache_update_pair_cuda, paged_cache_update_cuda,
    paged_cache_update_pair_cuda, quant_cache_update_cuda,
    quant_cache_update_pair_cuda, quant_paged_cache_update_cuda,
    quant_paged_cache_update_pair_cuda)
from repro_torch.kernels.cache_update.ref import (
    cache_update_pair_ref, cache_update_ref, paged_cache_update_pair_ref,
    paged_cache_update_ref, quant_cache_update_pair_ref,
    quant_cache_update_ref, quant_paged_cache_update_pair_ref,
    quant_paged_cache_update_ref)


def _i32(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if x is None else x.to(torch.int32).contiguous()


def _given(*tensors) -> list:
    """The tensors that are not None (for ``on_card``)."""
    return [t for t in tensors if t is not None]


def _rows(cache: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """new (B, T, *rest) as the kernels' contiguous (B, T, F) rows of the
    cache's dtype."""
    return new.to(cache.dtype).reshape(*new.shape[:2], -1).contiguous()


def _flat(cache: torch.Tensor) -> torch.Tensor:
    """A cache (B, C, *rest) or pool (P, page_size, *rest) as the kernels'
    (B, C, F) view."""
    return cache.view(*cache.shape[:2], -1)


def cache_update(cache: torch.Tensor, new: torch.Tensor,
                 slots: torch.Tensor) -> torch.Tensor:
    """Write ``new[b, 0]`` at ``cache[b, slots[b]]`` for every batch row
    (row 1; MLA's decode step writes its latent leaf with it).

    cache: (B, C, *rest)   new: (B, 1, *rest)   slots: (B,) int.
    """
    if not on_card(cache, new, slots):
        return cache_update_ref(cache, new, slots)
    cache_update_cuda(_flat(cache), _rows(cache, new), _i32(slots))
    return cache


def cache_update_pair(k: torch.Tensor, k_new: torch.Tensor, v: torch.Tensor,
                      v_new: torch.Tensor, slots: torch.Tensor):
    """``cache_update`` of a layer's k and v caches (the same shapes) in
    one kernel launch.  Returns ``(k, v)``, updated in place."""
    if not on_card(k, k_new, v, v_new, slots):
        return cache_update_pair_ref(k, k_new, v, v_new, slots)
    cache_update_pair_cuda(_flat(k), _rows(k, k_new), _flat(v),
                           _rows(v, v_new), _i32(slots))
    return k, v


def paged_cache_update(pool: torch.Tensor, new: torch.Tensor,
                       page_table: torch.Tensor, starts: torch.Tensor,
                       valids: torch.Tensor) -> torch.Tensor:
    """Write ``new[b, t]`` at logical position ``starts[b] + t`` of row
    ``b``'s paged cache, for ``t < valids[b]``.

    pool: (P, page_size, *rest) physical pages shared by all rows.
    new: (B, T, *rest)   page_table: (B, NB) int   starts/valids: (B,).
    One call covers both paged write paths: decode (T == 1) and chunked
    prefill (T == chunk); MLA's paged layers write their latent pool
    with it (row 4).  Masked rows never touch a real page: the
    plain version routes them to the scratch page 0, the kernel skips
    them (page 0's content is undefined by contract).
    """
    if not on_card(pool, new, page_table, starts, valids):
        return paged_cache_update_ref(pool, new, page_table, starts, valids)
    paged_cache_update_cuda(_flat(pool), _rows(pool, new), _i32(page_table),
                            _i32(starts), _i32(valids))
    return pool


def paged_cache_update_pair(k: torch.Tensor, k_new: torch.Tensor,
                            v: torch.Tensor, v_new: torch.Tensor,
                            page_table: torch.Tensor, starts: torch.Tensor,
                            valids: Optional[torch.Tensor] = None):
    """``paged_cache_update`` of a layer's k and v pools (the same shapes)
    in one kernel launch; ``valids`` None means every one of the T rows
    is valid.  Returns ``(k, v)``, updated in place."""
    if not on_card(*_given(k, k_new, v, v_new, page_table, starts,
                           valids)):
        return paged_cache_update_pair_ref(k, k_new, v, v_new, page_table,
                                           starts, valids)
    paged_cache_update_pair_cuda(_flat(k), _rows(k, k_new), _flat(v),
                                 _rows(v, v_new), _i32(page_table),
                                 _i32(starts), _i32(valids))
    return k, v


def _heads(codes: torch.Tensor) -> torch.Tensor:
    """A code leaf (B, C, *rest) or (P, page_size, *rest) as the kernels'
    4-D view (B, C, H, D): H the product of rest[:-1], 1 for none."""
    return codes.view(*codes.shape[:2], -1, codes.shape[-1])


def _kernel_leaf(codes: torch.Tensor, scales: torch.Tensor,
                 new: torch.Tensor) -> tuple:
    """A leaf's codes, scales and rows in the kernels' 4-D layout."""
    c4 = _heads(codes)
    return (c4, scales.view(c4.shape[:3]),
            new.reshape(*new.shape[:2], *c4.shape[2:]).contiguous())


def quant_cache_update(cache: torch.Tensor, scales: torch.Tensor,
                       new: torch.Tensor, slots: torch.Tensor, mode: str):
    """Quantize ``new[b, t]`` per row and write its codes at
    ``cache[b, s + t]`` and its scales at ``scales[b, s + t]``,
    ``s = slots[b]`` clamped to [0, C - T].

    cache: (B, C, *rest) codes of ``mode``   scales: (B, C, *rest[:-1])
    float32   new: (B, T, *rest) full precision, T <= C (1 at decode)
    slots: (B,) int.  Returns ``(cache, scales)``, updated in place.
    MLA's quantized latent leaf takes it (row 5) at every decode step, at
    a contiguous chunk and for a whole prompt at offset 0.
    """
    if not on_card(cache, scales, new, slots):
        return quant_cache_update_ref(cache, scales, new, slots, mode)
    quant_cache_update_cuda(*_kernel_leaf(cache, scales, new), _i32(slots),
                            mode)
    return cache, scales


def quant_cache_update_pair(k: torch.Tensor, k_scale: torch.Tensor,
                            k_new: torch.Tensor, v: torch.Tensor,
                            v_scale: torch.Tensor, v_new: torch.Tensor,
                            slots: torch.Tensor, mode: str):
    """``quant_cache_update`` of a layer's k and v leaves (the same
    shapes) in one kernel launch.  Returns ``((k, k_scale), (v,
    v_scale))``, updated in place."""
    if not on_card(k, k_scale, k_new, v, v_scale, v_new, slots):
        return quant_cache_update_pair_ref(k, k_scale, k_new, v, v_scale,
                                           v_new, slots, mode)
    quant_cache_update_pair_cuda(*_kernel_leaf(k, k_scale, k_new),
                                 *_kernel_leaf(v, v_scale, v_new),
                                 _i32(slots), mode)
    return (k, k_scale), (v, v_scale)


def quant_paged_cache_update(pool: torch.Tensor, scales: torch.Tensor,
                             new: torch.Tensor, page_table: torch.Tensor,
                             starts: torch.Tensor, valids: torch.Tensor,
                             mode: str):
    """Quantize ``new[b, t]`` per row and write codes and scales at
    logical position ``starts[b] + t`` of row ``b``'s paged cache, for
    ``t < valids[b]``.

    pool: (P, page_size, *rest) codes   scales: (P, page_size, *rest[:-1])
    float32, paged like ``pool``   new: (B, T, *rest)   page_table:
    (B, NB) int   starts/valids: (B,).  Masked rows never touch a real
    page (as ``paged_cache_update``); MLA's quantized paged layers write
    their latent pool with it (row 6).  Returns ``(pool, scales)``.
    """
    if not on_card(pool, scales, new, page_table, starts, valids):
        return quant_paged_cache_update_ref(pool, scales, new, page_table,
                                            starts, valids, mode)
    quant_paged_cache_update_cuda(*_kernel_leaf(pool, scales, new),
                                  _i32(page_table), _i32(starts),
                                  _i32(valids), mode)
    return pool, scales


def quant_paged_cache_update_pair(k: torch.Tensor, k_scale: torch.Tensor,
                                  k_new: torch.Tensor, v: torch.Tensor,
                                  v_scale: torch.Tensor, v_new: torch.Tensor,
                                  page_table: torch.Tensor,
                                  starts: torch.Tensor,
                                  valids: Optional[torch.Tensor], mode: str):
    """``quant_paged_cache_update`` of a layer's k and v pools (the same
    shapes) in one kernel launch; ``valids`` None means every one of the
    T rows is valid.  Returns ``((k, k_scale), (v, v_scale))``, updated in
    place."""
    if not on_card(*_given(k, k_scale, k_new, v, v_scale, v_new, page_table,
                           starts, valids)):
        return quant_paged_cache_update_pair_ref(
            k, k_scale, k_new, v, v_scale, v_new, page_table, starts,
            valids, mode)
    quant_paged_cache_update_pair_cuda(
        *_kernel_leaf(k, k_scale, k_new), *_kernel_leaf(v, v_scale, v_new),
        _i32(page_table), _i32(starts), _i32(valids), mode)
    return (k, k_scale), (v, v_scale)
