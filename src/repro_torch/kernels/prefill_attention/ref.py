"""Plain PyTorch versions of chunked-prefill attention, contiguous and
paged.

The blockwise twin of the JAX package's ``prefill_attention_ref``: it
sweeps the cache prefix block by block, then the chunk's own keys block
by block, folding every block into one (m, l, acc) online softmax with
the same operations in the same order.  ``prefill_attention_paged_ref``
gathers a paged cache and runs it with blocks of one page, as the JAX
package's ``prefill_attention_paged_ref`` does.

Semantics (matching the serve engine's chunked admission):

  * Query ``i`` of row ``b`` sits at absolute position ``offs[b] + i``.
  * ``k_cache``/``v_cache`` hold positions ``< offs[b]`` only.
      - ``ring=False`` (a full or a paged cache): slot ``s`` holds
        position ``s``; attendable iff ``s < offs[b]`` (and, with
        ``window``, ``pos_q - s < window``).
      - ``ring=True`` (sliding-window ring of size ``C``): slot ``s``
        holds position ``p = (offs[b]-1) - ((offs[b]-1-s) mod C)``;
        attendable iff ``p >= 0`` and ``pos_q - p < window``.
  * ``k_chunk``/``v_chunk`` are the chunk's own keys at ``offs[b] + j``;
    query ``i`` attends ``j <= i`` (and, windowed, ``i - j < window``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.constants import DEFAULT_BLOCK_K, NEG_INF, \
    pick_block_k
from repro_torch.kernels.decode_attention.ref import fold_block

_SPEC = "bhtgd,bkhd->bhtgk"


def prefill_attention_ref(q, k_chunk, v_chunk, k_cache, v_cache,
                          offs: torch.Tensor, *, ring: bool = False,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None,
                          scale: float = 1.0,
                          block_k: int = DEFAULT_BLOCK_K) -> torch.Tensor:
    """q: (B, KVH, T, G, hdq); k_chunk/v_chunk: (B, T, KVH, hdq/hdv);
    k_cache/v_cache: (B, C, KVH, hdq/hdv); offs: (B,) int.
    Returns (B, KVH, T, G, hdv) in q.dtype."""
    b, kvh, t, g, _ = q.shape
    c = k_cache.shape[1]
    hdv = v_cache.shape[-1]
    dev = q.device
    bk_c = pick_block_k(c, block_k)
    bk_t = pick_block_k(t, block_k)
    qs = q.float() * scale
    off = offs.to(device=dev, dtype=torch.int64).view(b, 1, 1, 1, 1)
    q_idx = torch.arange(t, device=dev).view(1, 1, t, 1, 1)
    q_pos = off + q_idx                                     # (B,1,T,1,1)
    m = torch.full((b, kvh, t, g, 1), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, kvh, t, g, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, kvh, t, g, hdv), dtype=torch.float32, device=dev)
    for lo in range(0, c, bk_c):
        cols = torch.arange(lo, lo + bk_c, device=dev)
        if ring:
            last = off - 1
            pos = last - torch.remainder(last - cols, c)
            valid = (pos >= 0) & (q_pos - pos < window)
        else:
            valid = (cols < off) & torch.ones_like(q_pos, dtype=torch.bool)
            if window is not None:
                valid = valid & (q_pos - cols < window)
        m, l, acc = fold_block(qs, k_cache[:, lo:lo + bk_c],
                               v_cache[:, lo:lo + bk_c], valid, m, l, acc,
                               softcap, _SPEC)
    for lo in range(0, t, bk_t):
        cols = torch.arange(lo, lo + bk_t, device=dev)
        diff = q_idx - cols
        valid = diff >= 0
        if window is not None:
            valid = valid & (diff < window)
        m, l, acc = fold_block(qs, k_chunk[:, lo:lo + bk_t],
                               v_chunk[:, lo:lo + bk_t], valid, m, l, acc,
                               softcap, _SPEC)
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def prefill_attention_paged_ref(q, k_chunk, v_chunk, k_pool, v_pool,
                                page_table: torch.Tensor,
                                offs: torch.Tensor, *,
                                window: Optional[int] = None,
                                softcap: Optional[float] = None,
                                scale: float = 1.0) -> torch.Tensor:
    """Blockwise twin of the paged chunked-prefill, as the JAX package's
    ``prefill_attention_paged_ref``.

    q: (B, KVH, T, G, hdq); k_chunk/v_chunk: (B, T, KVH, hdq/hdv);
    k_pool/v_pool: (P, page_size, KVH, hdq/hdv) physical pages;
    page_table: (B, NB) int; offs: (B,) int chunk start positions.
    Gathers the logical cache through the page table and runs
    ``prefill_attention_ref`` on it unwrapped (``ring=False``, the window
    an explicit mask) with blocks of one page.  Returns
    (B, KVH, T, G, hdv) in q.dtype.
    """
    b, kvh = q.shape[:2]
    ps = k_pool.shape[1]
    nb = page_table.shape[1]
    pt = page_table.to(device=q.device, dtype=torch.int64)
    k_cache = k_pool[pt].reshape(b, nb * ps, kvh, k_pool.shape[-1])
    v_cache = v_pool[pt].reshape(b, nb * ps, kvh, v_pool.shape[-1])
    return prefill_attention_ref(q, k_chunk, v_chunk, k_cache, v_cache, offs,
                                 ring=False, window=window, softcap=softcap,
                                 scale=scale, block_k=ps)
