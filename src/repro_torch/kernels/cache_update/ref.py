"""Plain PyTorch versions of the cache scatters.

``cache_update_ref``: the same function as the JAX package's
``cache_update_ref`` (one ``dynamic_update_slice`` per batch row),
written as one indexed assignment that updates ``cache`` in place.
Out-of-range slots clamp to the nearest row, as
``dynamic_update_slice`` clamps its start.

``paged_cache_update_ref``: the JAX package's ``paged_cache_update_ref``,
the scatter through a page table into a shared page pool.

``quant_cache_update_ref`` / ``quant_paged_cache_update_ref``: the JAX
package's quantizing twins, quantize then scatter: ``quant.quantize``
over all rows at once, then the scatter for the codes and for the
scales.  Quantization is per row, so quantizing the whole batch here
and one row at a time in the kernels gives the same bits.  The
contiguous one takes T rows a batch row, written from ``slots[b]``
clamped to [0, C - T], as the JAX twin's ``dynamic_update_slice``
clamps its start (at T = 1, ``cache_update_ref``'s clamp).

The ``_pair_ref`` versions are the per-leaf ones for k, then for v: what
the kernels' one launch for both leaves computes.  The paged ones take
``valids=None`` for every one of the T rows valid (a decode step's
write), which the per-leaf ones, as the JAX package's, do not.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import quant


def cache_update_ref(cache: torch.Tensor, new: torch.Tensor,
                     slots: torch.Tensor) -> torch.Tensor:
    """cache: (B, C, *rest)  new: (B, 1, *rest)  slots: (B,) int.
    Writes ``new[b, 0]`` at ``cache[b, slots[b]]``; returns ``cache``."""
    b, c = cache.shape[:2]
    rows = torch.arange(b, device=cache.device)
    cache[rows, slots.long().clamp(0, c - 1)] = new[:, 0].to(cache.dtype)
    return cache


def cache_update_pair_ref(k, k_new, v, v_new, slots: torch.Tensor):
    """``cache_update_ref`` for k, then for v; returns ``(k, v)``."""
    return (cache_update_ref(k, k_new, slots),
            cache_update_ref(v, v_new, slots))


def _all_valid(valids: Optional[torch.Tensor],
               new: torch.Tensor) -> torch.Tensor:
    """``valids``, or for None every one of new's T rows valid."""
    if valids is not None:
        return valids
    return torch.full(new.shape[:1], new.shape[1], dtype=torch.int32,
                      device=new.device)


def paged_cache_update_ref(pool: torch.Tensor, new: torch.Tensor,
                           page_table: torch.Tensor, starts: torch.Tensor,
                           valids: torch.Tensor) -> torch.Tensor:
    """pool: (P, page_size, *rest)  new: (B, T, *rest)
    page_table: (B, NB) int   starts/valids: (B,) int.

    Row ``t`` of ``new[b]`` lands at physical row
    ``page_table[b, pos // ps] * ps + pos % ps`` of the flattened pool,
    ``pos = min(starts[b] + t, NB * ps - 1)``, when ``t < valids[b]``;
    masked rows go to row 0 of the scratch page 0, whose content is
    undefined by contract.  One indexed assignment, in place, as the
    JAX package's ``paged_cache_update_ref`` is one flat scatter.
    Returns ``pool``.
    """
    p, ps = pool.shape[:2]
    b, t = new.shape[:2]
    nb = page_table.shape[1]
    dev = pool.device
    steps = torch.arange(t, device=dev)
    pos = torch.clamp(starts.to(dev).long()[:, None] + steps,
                      max=nb * ps - 1)                          # (B, T)
    ok = steps[None, :] < valids.to(dev).long()[:, None]
    page = torch.where(ok, torch.gather(page_table.to(dev).long(), 1,
                                        pos // ps), 0)
    row = torch.where(ok, pos % ps, 0)
    flat = pool.view(p * ps, -1)
    flat[(page * ps + row).reshape(-1)] = \
        new.reshape(b * t, -1).to(pool.dtype)
    return pool


def paged_cache_update_pair_ref(k, k_new, v, v_new,
                                page_table: torch.Tensor,
                                starts: torch.Tensor,
                                valids: Optional[torch.Tensor] = None):
    """``paged_cache_update_ref`` for k, then for v, ``valids`` None for
    every row valid; returns ``(k, v)``."""
    where = (page_table, starts, _all_valid(valids, k_new))
    return (paged_cache_update_ref(k, k_new, *where),
            paged_cache_update_ref(v, v_new, *where))


def _slice_rows(cache: torch.Tensor, rows: torch.Tensor,
                slots: torch.Tensor) -> torch.Tensor:
    """cache: (B, C, *rest)  rows: (B, T, *rest)  slots: (B,) int.
    Writes ``rows[b, t]`` at ``cache[b, s + t]``, ``s = slots[b]``
    clamped to [0, C - T]; returns ``cache``."""
    b, c = cache.shape[:2]
    t = rows.shape[1]
    dev = cache.device
    start = slots.to(dev).long().clamp(0, c - t)
    cache[torch.arange(b, device=dev)[:, None],
          start[:, None] + torch.arange(t, device=dev)] = \
        rows.to(cache.dtype)
    return cache


def quant_cache_update_ref(cache: torch.Tensor, scales: torch.Tensor,
                           new: torch.Tensor, slots: torch.Tensor,
                           mode: str):
    """cache: (B, C, *rest) codes  scales: (B, C, *rest[:-1]) float32
    new: (B, T, *rest) full precision, T <= C  slots: (B,) int.
    Quantizes ``new`` per row and writes row ``t`` of batch row ``b``
    at slot ``s + t``, ``s = slots[b]`` clamped to [0, C - T], codes and
    scales in place; returns ``(cache, scales)``."""
    codes, s = quant.quantize(new, mode)
    return (_slice_rows(cache, codes, slots), _slice_rows(scales, s, slots))


def quant_cache_update_pair_ref(k, k_scale, k_new, v, v_scale, v_new,
                                slots: torch.Tensor, mode: str):
    """``quant_cache_update_ref`` for k, then for v; returns ``((k,
    k_scale), (v, v_scale))``."""
    return (quant_cache_update_ref(k, k_scale, k_new, slots, mode),
            quant_cache_update_ref(v, v_scale, v_new, slots, mode))


def quant_paged_cache_update_ref(pool: torch.Tensor, scales: torch.Tensor,
                                 new: torch.Tensor, page_table: torch.Tensor,
                                 starts: torch.Tensor, valids: torch.Tensor,
                                 mode: str):
    """pool: (P, page_size, *rest) codes  scales: (P, page_size,
    *rest[:-1]) float32, paged like ``pool``  new: (B, T, *rest)
    page_table: (B, NB)  starts/valids: (B,) int.  Codes land in
    ``pool`` and scales in ``scales`` through the same table, with the
    same masking (masked rows to the scratch page 0).  Returns
    ``(pool, scales)``."""
    codes, s = quant.quantize(new, mode)
    return (paged_cache_update_ref(pool, codes, page_table, starts, valids),
            paged_cache_update_ref(scales, s, page_table, starts, valids))


def quant_paged_cache_update_pair_ref(k, k_scale, k_new, v, v_scale, v_new,
                                      page_table: torch.Tensor,
                                      starts: torch.Tensor,
                                      valids: Optional[torch.Tensor],
                                      mode: str):
    """``quant_paged_cache_update_ref`` for k, then for v, ``valids`` None
    for every row valid; returns ``((k, k_scale), (v, v_scale))``."""
    where = (page_table, starts, _all_valid(valids, k_new), mode)
    return (quant_paged_cache_update_ref(k, k_scale, k_new, *where),
            quant_paged_cache_update_ref(v, v_scale, v_new, *where))
