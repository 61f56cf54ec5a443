"""The chunked-prefill attention ops the model's prefill steps call.

``prefill_attention`` takes the model's layouts — q (B, T, H, hd), the
chunk's own k/v (B, T, KVH, hd) and the (B, C, KVH, hd) caches — packs
q as (B, KVH, T, G, hd) so each kv head's G query heads share its keys,
and runs the CUDA kernel for tensors on the card or the plain version
for tensors on the CPU.  ``prefill_attention_paged`` does the same over
(P, page_size, KVH, hd) page pools and a page table.  Both take a
quantized cache prefix too: int8 / fp8_e4m3 codes with float32 row
scales (``k_scale``/``v_scale``), dequantized inside the kernel, and
MLA's aliased latent cache (``v_width``: the values are the first lanes
of v, which may be k itself).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.kernels import on_card, scale_tensors
from repro_torch.kernels.constants import DEFAULT_BLOCK_K
from repro_torch.kernels.prefill_attention.kernel import (
    prefill_attention_cuda, prefill_attention_paged_cuda)
from repro_torch.kernels.prefill_attention.ref import (
    prefill_attention_paged_ref, prefill_attention_ref)


def _pack(q: torch.Tensor, k_chunk: torch.Tensor, kvh: int, offset):
    """q (B, T, H, hdq) -> (B, KVH, T, G, hdq), and offset as a (B,)
    int32 tensor on q's device."""
    b, t, h, hdq = q.shape
    if k_chunk.shape[1] != t:
        raise ValueError(f"chunk keys cover {k_chunk.shape[1]} tokens but "
                         f"the query chunk has {t}")
    if h % kvh:
        raise ValueError(f"H={h} not divisible by KVH={kvh}")
    qg = q.reshape(b, t, kvh, h // kvh, hdq).permute(0, 2, 1, 3, 4)
    offs = torch.as_tensor(offset, dtype=torch.int32, device=q.device)
    offs = offs.expand(b).contiguous() if offs.dim() == 0 else offs
    return qg, offs


def prefill_attention(q, k_chunk, v_chunk, k_cache, v_cache,
                      offset: Union[int, torch.Tensor], *,
                      ring: bool = False, window: Optional[int] = None,
                      softcap: Optional[float] = None, scale: float = 1.0,
                      block_k: int = DEFAULT_BLOCK_K, v_width=None,
                      k_scale=None, v_scale=None) -> torch.Tensor:
    """Chunked-prefill attention: T chunk queries over [prefix ++ chunk].

    q: (B, T, H, hdq) chunk queries at positions ``offset + i``.
    k_chunk/v_chunk: (B, T, KVH, hdq/hdv), not yet in the cache.
    k_cache/v_cache: (B, C, KVH, hdq/hdv) holding positions
    ``< offset``.  offset: int or (B,) int tensor.  ``ring=True`` for
    sliding-window ring caches, with ``window`` required.  ``block_k``
    is the blocking of the plain version.  ``k_scale``/``v_scale``:
    (B, C, KVH) float32 row scales when the cache holds int8 or
    float8_e4m3fn codes (the chunk's own k/v stay full precision).
    ``v_width``: the values are the first ``v_width`` lanes of v_chunk
    and v_cache, which may be k_chunk and k_cache themselves (MLA's
    latent cache).  Returns (B, T, H, hdv) in q.dtype.
    """
    if ring and window is None:
        raise ValueError("ring caches need an explicit window")
    if window is not None and not ring:
        raise ValueError("window only applies to ring caches here "
                         "(full-cache layers carry no window)")
    qg, offs = _pack(q, k_chunk, k_cache.shape[2], offset)
    b, t, h, _ = q.shape
    kw = dict(ring=ring, window=window, softcap=softcap, scale=scale,
              v_width=v_width, k_scale=k_scale, v_scale=v_scale)
    if on_card(q, k_chunk, v_chunk, k_cache, v_cache, offs,
               *scale_tensors(k_scale, v_scale)):
        out = prefill_attention_cuda(qg.contiguous(), k_chunk.contiguous(),
                                     v_chunk.contiguous(), k_cache, v_cache,
                                     offs, **kw)
    else:
        out = prefill_attention_ref(qg, k_chunk, v_chunk, k_cache, v_cache,
                                    offs, block_k=block_k, **kw)
    return out.permute(0, 2, 1, 3, 4).reshape(b, t, h, out.shape[-1])


def prefill_attention_paged(q, k_chunk, v_chunk, k_pool, v_pool,
                            page_table: torch.Tensor,
                            offset: Union[int, torch.Tensor], *,
                            window: Optional[int] = None,
                            softcap: Optional[float] = None,
                            scale: float = 1.0, v_width=None, k_scale=None,
                            v_scale=None) -> torch.Tensor:
    """Chunked-prefill attention over a *paged* cache prefix.

    q: (B, T, H, hdq) chunk queries at positions ``offset[b] + i``.
    k_chunk/v_chunk: (B, T, KVH, hdq/hdv), not yet in the pools.
    k_pool/v_pool: (P, page_size, KVH, hdq/hdv) physical pages holding
    positions ``< offset[b]`` of every row, addressed through page_table
    (B, NB) int.  offset: int or (B,) int tensor.  Paged caches store
    sliding-window layers unwrapped, so ``window`` is an explicit mask
    (no ``ring``).  ``k_scale``/``v_scale``: (P, page_size, KVH) float32
    scale pools when the pools hold int8 or float8_e4m3fn codes.  Returns
    (B, T, H, hdv) in q.dtype.  ``v_width`` as in
    :func:`prefill_attention`.
    """
    qg, offs = _pack(q, k_chunk, k_pool.shape[2], offset)
    b, t, h, _ = q.shape
    kw = dict(window=window, softcap=softcap, scale=scale, v_width=v_width,
              k_scale=k_scale, v_scale=v_scale)
    if on_card(q, k_chunk, v_chunk, k_pool, v_pool, page_table, offs,
               *scale_tensors(k_scale, v_scale)):
        out = prefill_attention_paged_cuda(
            qg.contiguous(), k_chunk.contiguous(), v_chunk.contiguous(),
            k_pool, v_pool, page_table.to(torch.int32).contiguous(), offs,
            **kw)
    else:
        out = prefill_attention_paged_ref(qg, k_chunk, v_chunk, k_pool,
                                          v_pool, page_table, offs, **kw)
    return out.permute(0, 2, 1, 3, 4).reshape(b, t, h, out.shape[-1])
