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

A quantized cache (``k_scale``/``v_scale``: float32 row scales of int8 /
fp8_e4m3 codes) is dequantized per cache block, as in the JAX package's
twin; only the prefix holds codes, the chunk's own k/v are full
precision.  ``v_scale`` defaults to ``k_scale``.

``v_width`` (MLA's aliased latent cache): the values are the first
``v_width`` lanes of v_chunk and v_cache, which may be k_chunk and
k_cache themselves; a quantized alias's one scale tensor serves as
``k_scale`` and ``v_scale`` alike.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.constants import DEFAULT_BLOCK_K, NEG_INF, \
    pick_block_k
from repro_torch.kernels.decode_attention.ref import cache_block, \
    fold_block, gather_pages

_SPEC = "bhtgd,bkhd->bhtgk"


def prefill_attention_ref(q, k_chunk, v_chunk, k_cache, v_cache,
                          offs: torch.Tensor, *, ring: bool = False,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None,
                          scale: float = 1.0,
                          block_k: int = DEFAULT_BLOCK_K, v_width=None,
                          k_scale=None, v_scale=None) -> torch.Tensor:
    """q: (B, KVH, T, G, hdq); k_chunk/v_chunk: (B, T, KVH, hdq/hdv);
    k_cache/v_cache: (B, C, KVH, hdq/hdv) (v wider with ``v_width``);
    offs: (B,) int; k_scale/v_scale: (B, C, KVH) float32 row scales of a
    code cache.  Returns (B, KVH, T, G, hdv) in q.dtype."""
    if k_scale is not None and v_scale is None:
        v_scale = k_scale
    if v_width is not None:
        v_chunk, v_cache = v_chunk[..., :v_width], v_cache[..., :v_width]
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
        m, l, acc = fold_block(qs, cache_block(k_cache, k_scale, lo, bk_c),
                               cache_block(v_cache, v_scale, lo, bk_c),
                               valid, m, l, acc, softcap, _SPEC)
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
                                scale: float = 1.0, v_width=None,
                                k_scale=None, v_scale=None) -> torch.Tensor:
    """Blockwise twin of the paged chunked-prefill, as the JAX package's
    ``prefill_attention_paged_ref``.

    q: (B, KVH, T, G, hdq); k_chunk/v_chunk: (B, T, KVH, hdq/hdv);
    k_pool/v_pool: (P, page_size, KVH, hdq/hdv) physical pages;
    page_table: (B, NB) int; offs: (B,) int chunk start positions.
    Gathers the logical cache (and, for code pools, the k_scale/v_scale
    pools (P, page_size, KVH)) through the page table and runs
    ``prefill_attention_ref`` on it unwrapped (``ring=False``, the window
    an explicit mask) with blocks of one page.  ``v_width`` as there.
    Returns (B, KVH, T, G, hdv) in q.dtype.
    """
    b = q.shape[0]
    ps = k_pool.shape[1]
    c = page_table.shape[1] * ps
    pt = page_table.to(device=q.device, dtype=torch.int64)
    ks = vs = None
    if k_scale is not None:
        ks = gather_pages(k_scale, pt, b, c)
        vs = ks if v_scale is None else gather_pages(v_scale, pt, b, c)
    return prefill_attention_ref(
        q, k_chunk, v_chunk, gather_pages(k_pool, pt, b, c),
        gather_pages(v_pool, pt, b, c), offs, ring=False, window=window,
        softcap=softcap, scale=scale, block_k=ps, v_width=v_width,
        k_scale=ks, v_scale=vs)
