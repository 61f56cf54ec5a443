"""The chunked-prefill attention op the model's prefill step calls.

``prefill_attention`` takes the model's layouts — q (B, T, H, hd), the
chunk's own k/v (B, T, KVH, hd) and the (B, C, KVH, hd) caches — packs
q as (B, KVH, T, G, hd) so each kv head's G query heads share its keys,
and runs the CUDA kernel for tensors on the card or the plain version
for tensors on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.kernels import on_card
from repro_torch.kernels.constants import DEFAULT_BLOCK_K
from repro_torch.kernels.prefill_attention.kernel import \
    prefill_attention_cuda
from repro_torch.kernels.prefill_attention.ref import prefill_attention_ref


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
    is the blocking of the plain version.  Returns (B, T, H, hdv) in
    q.dtype.

    ``v_width`` (MLA) and ``k_scale``/``v_scale`` (quantized caches)
    come with later slices of the port and raise.
    """
    if v_width is not None:
        raise NotImplementedError("v_width comes with the MLA slice")
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "k_scale/v_scale come with the quantized-cache slice")
    b, t, h, hdq = q.shape
    if k_chunk.shape[1] != t:
        raise ValueError(f"chunk keys cover {k_chunk.shape[1]} tokens but "
                         f"the query chunk has {t}")
    kvh = k_cache.shape[2]
    if h % kvh:
        raise ValueError(f"H={h} not divisible by KVH={kvh}")
    if ring and window is None:
        raise ValueError("ring caches need an explicit window")
    if window is not None and not ring:
        raise ValueError("window only applies to ring caches here "
                         "(full-cache layers carry no window)")
    g = h // kvh
    qg = q.reshape(b, t, kvh, g, hdq).permute(0, 2, 1, 3, 4)
    offs = torch.as_tensor(offset, dtype=torch.int32, device=q.device)
    offs = offs.expand(b).contiguous() if offs.dim() == 0 else offs
    kw = dict(ring=ring, window=window, softcap=softcap, scale=scale)
    if on_card(q, k_chunk, v_chunk, k_cache, v_cache, offs):
        out = prefill_attention_cuda(qg.contiguous(), k_chunk.contiguous(),
                                     v_chunk.contiguous(), k_cache, v_cache,
                                     offs, **kw)
    else:
        out = prefill_attention_ref(qg, k_chunk, v_chunk, k_cache, v_cache,
                                    offs, block_k=block_k, **kw)
    return out.permute(0, 2, 1, 3, 4).reshape(b, t, h, out.shape[-1])
