"""Plain PyTorch versions of flash-decode, contiguous and paged.

The blockwise twins of the JAX package's ``decode_attention_ref`` and
``decode_attention_paged_ref``: each sweeps the cache in blocks
(``block_k`` keys, or one page) and folds each into the same (m, l, acc)
online-softmax accumulator with the same operations in the same order.
They process every block; the kernels skip blocks past a row's fill,
which are bit-neutral folds (masked scores are ``NEG_INF``).

Quantized caches (``k_scale``/``v_scale`` given: int8 / fp8_e4m3 codes
with float32 row scales) are dequantized block by block with
``quant.dequantize`` (``codes.float() * scale[..., None]``), the op
order of the JAX package's blockwise twins and of the kernels' tile
loads.  ``v_scale`` defaults to ``k_scale``, as in the JAX package.

``v_width`` (MLA's aliased latent cache): the values are the first
``v_width`` lanes of v, which may be k itself; a quantized alias has one
(B, C, 1) scale tensor that serves as ``k_scale`` and ``v_scale`` alike
(per-row scaling commutes with the lane slice).

Semantics (matching ``models.attention.decode_self_attention``):

  * ``lens[b]`` is the position of row ``b``'s new token; the cache has
    already absorbed its k/v, so valid slots are positions ``<= lens[b]``.
  * ``ring=False``: slot ``s`` holds position ``s``; valid iff
    ``s <= lens[b]``.
  * ``ring=True`` (sliding-window ring of size ``C``): slot ``s`` holds
    the largest position ``p <= cur`` with ``p % C == s``; valid iff
    ``p >= 0``, i.e. ``(cur - s) mod C <= cur``.  The window mask is
    subsumed by the ring size.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import quant
from repro_torch.kernels.constants import DEFAULT_BLOCK_K, NEG_INF, \
    pick_block_k


def cache_block(cache: torch.Tensor, scales, lo: int, n: int):
    """Positions ``lo .. lo + n - 1`` (axis 1) of a cache, dequantized to
    float32 when ``scales`` holds its row scales."""
    blk = cache[:, lo:lo + n]
    return blk if scales is None else quant.dequantize(
        blk, scales[:, lo:lo + n])


def gather_pages(pool: torch.Tensor, pt: torch.Tensor, b: int, c: int):
    """The logical (B, NB * page_size, *rest) view of a page pool through
    the (B, NB) int64 page table ``pt``."""
    return pool[pt].reshape(b, c, *pool.shape[2:])


def fold_block(q, k_blk, v_blk, valid, m, l, acc, softcap, spec: str):
    """Fold one key block into the online-softmax accumulator.

    ``spec`` is the einsum of the scores (e.g. "bhgd,bkhd->bhgk"); the
    value product reuses its operand letters.  q is fp32 and pre-scaled;
    ``valid`` broadcasts against the scores.
    """
    s = torch.einsum(spec, q, k_blk.float())
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(valid, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m_new)
    alpha = torch.exp(m - m_new)
    l_new = alpha * l + p.sum(dim=-1, keepdim=True)
    lhs, out = spec.split("->")
    qs, ks = lhs.split(",")
    pv = f"{out},{ks}->{qs}"
    acc_new = alpha * acc + torch.einsum(pv, p, v_blk.float())
    return m_new, l_new, acc_new


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lens: torch.Tensor, *, ring: bool = False,
                         softcap: Optional[float] = None,
                         scale: float = 1.0,
                         block_k: int = DEFAULT_BLOCK_K, v_width=None,
                         k_scale=None, v_scale=None) -> torch.Tensor:
    """q: (B, KVH, G, hdq), k: (B, C, KVH, hdq), v: (B, C, KVH, hdv)
    (or wider, with ``v_width``), lens: (B,) int; k_scale/v_scale:
    (B, C, KVH) float32 row scales of code caches.  Returns
    (B, KVH, G, hdv) in q.dtype."""
    if k_scale is not None and v_scale is None:
        v_scale = k_scale
    if v_width is not None:
        v = v[..., :v_width]
    b, kvh, g, _ = q.shape
    c = k.shape[1]
    hdv = v.shape[-1]
    bk = pick_block_k(c, block_k)
    qs = q.float() * scale
    cur = lens.to(device=q.device, dtype=torch.int64).view(b, 1, 1, 1)
    m = torch.full((b, kvh, g, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, kvh, g, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kvh, g, hdv), dtype=torch.float32, device=q.device)
    for lo in range(0, c, bk):
        cols = torch.arange(lo, lo + bk, device=q.device)
        if ring:
            valid = torch.remainder(cur - cols, c) <= cur
        else:
            valid = cols <= cur
        m, l, acc = fold_block(qs, cache_block(k, k_scale, lo, bk),
                               cache_block(v, v_scale, lo, bk), valid, m, l,
                               acc, softcap, "bhgd,bkhd->bhgk")
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def decode_attention_paged_ref(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor, page_table: torch.Tensor,
                               lens: torch.Tensor, *,
                               window: Optional[int] = None,
                               softcap: Optional[float] = None,
                               scale: float = 1.0, v_width=None,
                               k_scale=None, v_scale=None) -> torch.Tensor:
    """Blockwise twin of the paged flash-decode, as the JAX package's
    ``decode_attention_paged_ref``.

    q: (B, KVH, G, hdq); k_pool/v_pool: (P, page_size, KVH, hdq/hdv)
    physical pages; page_table: (B, NB) int; lens: (B,) int.  Gathers
    the logical (B, NB * page_size, KVH, *) view through the page table
    and folds it one page per block.  Paged caches are never wrapped:
    slot == position, and a sliding window is the explicit mask
    ``lens[b] - col < window``.  k_scale/v_scale: (P, page_size, KVH)
    float32 scale pools of code pools, gathered through the same table.
    ``v_width``: the values are the first lanes of v_pool (which may be
    k_pool).  Returns (B, KVH, G, hdv) in q.dtype.
    """
    b, kvh, g, _ = q.shape
    ps = k_pool.shape[1]
    nb = page_table.shape[1]
    c = nb * ps
    pt = page_table.to(device=q.device, dtype=torch.int64)
    k, v = gather_pages(k_pool, pt, b, c), gather_pages(v_pool, pt, b, c)
    ks = vs = None
    if k_scale is not None:
        ks = gather_pages(k_scale, pt, b, c)
        vs = ks if v_scale is None else gather_pages(v_scale, pt, b, c)
    if v_width is not None:
        v = v[..., :v_width]
    hdv = v.shape[-1]
    qs = q.float() * scale
    cur = lens.to(device=q.device, dtype=torch.int64).view(b, 1, 1, 1)
    m = torch.full((b, kvh, g, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, kvh, g, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kvh, g, hdv), dtype=torch.float32, device=q.device)
    for lo in range(0, c, ps):
        cols = torch.arange(lo, lo + ps, device=q.device)
        valid = cols <= cur
        if window is not None:
            valid = valid & (cur - cols < window)
        m, l, acc = fold_block(qs, cache_block(k, ks, lo, ps),
                               cache_block(v, vs, lo, ps), valid, m, l, acc,
                               softcap, "bhgd,bkhd->bhgk")
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)
