"""The decode-attention op the model's decode step calls.

``decode_attention`` takes the model's layouts — q (B, 1, H, hd) and the
(B, C, KVH, hd) caches — packs the G = H / KVH query heads of each kv
head together, and runs the CUDA kernel for tensors on the card or the
plain version for tensors on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.kernels import on_card
from repro_torch.kernels.constants import DEFAULT_BLOCK_K
from repro_torch.kernels.decode_attention.kernel import decode_attention_cuda
from repro_torch.kernels.decode_attention.ref import decode_attention_ref


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
    plain version.  Returns (B, 1, H, hdv) in q.dtype.

    ``v_width`` (MLA's aliased latent cache) and ``k_scale``/``v_scale``
    (quantized caches) come with later slices of the port and raise.
    """
    if v_width is not None:
        raise NotImplementedError("v_width comes with the MLA slice")
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "k_scale/v_scale come with the quantized-cache slice")
    b, sq, h, hdq = q.shape
    if sq != 1:
        raise ValueError(f"decode_attention takes one query token, got "
                         f"Sq={sq}")
    kvh = k.shape[2]
    if h % kvh:
        raise ValueError(f"H={h} not divisible by KVH={kvh}")
    g = h // kvh
    qg = q.reshape(b, kvh, g, hdq)
    lens = torch.as_tensor(cur_len, dtype=torch.int32, device=q.device)
    lens = lens.expand(b).contiguous() if lens.dim() == 0 else lens
    if on_card(q, k, v, lens):
        out = decode_attention_cuda(qg.contiguous(), k, v, lens,
                                    ring=ring, softcap=softcap, scale=scale)
    else:
        out = decode_attention_ref(qg, k, v, lens, ring=ring,
                                   softcap=softcap, scale=scale,
                                   block_k=block_k)
    return out.reshape(b, 1, h, out.shape[-1])
