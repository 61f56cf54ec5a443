"""Plain PyTorch version of flash attention: the JAX package's oracle
``flash_attention_ref``, line for line.

q: (BH, Sq, hd), k/v: (BKVH, Skv, hd) with BH % BKVH == 0.  The kv heads
are repeated, scores taken in fp32 from ``q * scale`` and k, tanh
soft-capped, masked (``rows >= cols`` when causal, ``rows - cols <
window`` with a window) with the finite ``NEG_INF``, softmaxed in fp32;
the probabilities are cast to v's dtype before ``p @ v`` and the output
is returned in q's dtype.  ``ops.flash_attention`` differentiates this
function for its backward.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.constants import NEG_INF


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        scale: float = 1.0) -> torch.Tensor:
    """q: (BH, Sq, hd), k/v: (BKVH, Skv, hd) -> (BH, Sq, hd) in q.dtype."""
    bh, sq, _ = q.shape
    bkvh, skv, _ = k.shape
    g = bh // bkvh
    k = torch.repeat_interleave(k, g, dim=0)
    v = torch.repeat_interleave(v, g, dim=0)
    s = torch.einsum("hqd,hkd->hqk", q.float() * scale, k.float())
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    rows = torch.arange(sq, device=q.device)[:, None]
    cols = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= rows >= cols
    if window is not None:
        mask &= rows - cols < window
    s = torch.where(mask[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hqk,hkd->hqd", p.to(v.dtype), v).to(q.dtype)
