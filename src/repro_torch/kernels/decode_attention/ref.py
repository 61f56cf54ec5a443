"""Plain PyTorch version of flash-decode.

The blockwise twin of the JAX package's ``decode_attention_ref``: it
sweeps the cache in ``block_k`` blocks and folds each into the same
(m, l, acc) online-softmax accumulator with the same operations in the
same order.  It processes every block; the kernel skips blocks past a
row's fill, which are bit-neutral folds (masked scores are ``NEG_INF``).

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

from repro_torch.kernels.constants import DEFAULT_BLOCK_K, NEG_INF, \
    pick_block_k


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
                         block_k: int = DEFAULT_BLOCK_K) -> torch.Tensor:
    """q: (B, KVH, G, hdq), k: (B, C, KVH, hdq), v: (B, C, KVH, hdv),
    lens: (B,) int.  Returns (B, KVH, G, hdv) in q.dtype."""
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
        m, l, acc = fold_block(qs, k[:, lo:lo + bk], v[:, lo:lo + bk],
                               valid, m, l, acc, softcap,
                               "bhgd,bkhd->bhgk")
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)
