"""The decode-attention ops the model's decode steps call.

``decode_attention`` takes the model's layouts — q (B, 1, H, hd) and the
(B, C, KVH, hd) caches — packs the G = H / KVH query heads of each kv
head together, and runs the CUDA kernel for tensors on the card or the
plain version for tensors on the CPU.  ``decode_attention_paged`` does
the same over (P, page_size, KVH, hd) page pools and a page table.
Both take quantized caches too: int8 / fp8_e4m3 codes with float32 row
scales (``k_scale``/``v_scale``), dequantized inside the kernel, and
MLA's aliased latent cache (``v_width``: the values are the first lanes
of v, which may be k itself).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.kernels import on_card, scale_tensors
from repro_torch.kernels.constants import DEFAULT_BLOCK_K
from repro_torch.kernels.decode_attention.kernel import (
    decode_attention_cuda, decode_attention_paged_cuda)
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_paged_ref, decode_attention_ref)


def _pack(q: torch.Tensor, kvh: int, cur_len, name: str):
    """q (B, 1, H, hdq) -> (B, KVH, G, hdq), and cur_len as a (B,) int32
    tensor on q's device."""
    b, sq, h, hdq = q.shape
    if sq != 1:
        raise ValueError(f"{name} takes one query token, got Sq={sq}")
    if h % kvh:
        raise ValueError(f"H={h} not divisible by KVH={kvh}")
    lens = torch.as_tensor(cur_len, dtype=torch.int32, device=q.device)
    lens = lens.expand(b).contiguous() if lens.dim() == 0 else lens
    return q.reshape(b, kvh, h // kvh, hdq), lens


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cur_len: Union[int, torch.Tensor], *,
                     ring: bool = False, softcap: Optional[float] = None,
                     scale: float = 1.0, block_k: int = DEFAULT_BLOCK_K,
                     v_width=None, k_scale=None, v_scale=None
                     ) -> torch.Tensor:
    """One-token decode attention over a full cache.

    q: (B, 1, H, hdq) new-token queries.  k: (B, C, KVH, hdq) and
    v: (B, C, KVH, hdv): the cache *after* the new token's k/v landed at
    its slot.  cur_len: int or (B,) int tensor — the new token's
    position (valid cache positions are ``<= cur_len``).  ``ring=True``
    for sliding-window ring caches.  ``block_k`` is the blocking of the
    plain version.  ``k_scale``/``v_scale``: (B, C, KVH) float32 row
    scales when k/v hold int8 or float8_e4m3fn codes (``v_scale``
    defaults to ``k_scale``).  ``v_width``: the values are the first
    ``v_width`` lanes of v, which may be k itself (MLA's latent cache,
    one kv head read once as key and value; a quantized alias passes its
    one scale tensor as ``k_scale``).  Returns (B, 1, H, hdv) in q.dtype.
    """
    qg, lens = _pack(q, k.shape[2], cur_len, "decode_attention")
    b, _, h, _ = q.shape
    kw = dict(ring=ring, softcap=softcap, scale=scale, v_width=v_width,
              k_scale=k_scale, v_scale=v_scale)
    if on_card(q, k, v, lens, *scale_tensors(k_scale, v_scale)):
        out = decode_attention_cuda(qg.contiguous(), k, v, lens, **kw)
    else:
        out = decode_attention_ref(qg, k, v, lens, block_k=block_k, **kw)
    return out.reshape(b, 1, h, out.shape[-1])


def decode_attention_paged(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           cur_len: Union[int, torch.Tensor], *,
                           window: Optional[int] = None,
                           softcap: Optional[float] = None,
                           scale: float = 1.0, v_width=None, k_scale=None,
                           v_scale=None) -> torch.Tensor:
    """One-token decode attention over a *paged* cache.

    q: (B, 1, H, hdq) new-token queries.  k_pool/v_pool:
    (P, page_size, KVH, hdq/hdv) physical pages shared by all rows,
    *after* the new token's k/v landed (``paged_cache_update``).
    page_table: (B, NB) int logical block -> physical page.  cur_len:
    int or (B,) int tensor.  Paged caches store sliding-window layers
    unwrapped, so ``window`` is an explicit mask here (no ``ring``).
    ``k_scale``/``v_scale``: (P, page_size, KVH) float32 scale pools
    when the pools hold int8 or float8_e4m3fn codes, paged like them.
    ``v_width`` as in :func:`decode_attention`.  Returns (B, 1, H, hdv)
    in q.dtype.
    """
    qg, lens = _pack(q, k_pool.shape[2], cur_len, "decode_attention_paged")
    b, _, h, _ = q.shape
    kw = dict(window=window, softcap=softcap, scale=scale, v_width=v_width,
              k_scale=k_scale, v_scale=v_scale)
    if on_card(q, k_pool, v_pool, page_table, lens,
               *scale_tensors(k_scale, v_scale)):
        out = decode_attention_paged_cuda(
            qg.contiguous(), k_pool, v_pool,
            page_table.to(torch.int32).contiguous(), lens, **kw)
    else:
        out = decode_attention_paged_ref(qg, k_pool, v_pool, page_table,
                                         lens, **kw)
    return out.reshape(b, 1, h, out.shape[-1])
