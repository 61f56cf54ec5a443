"""GQA attention for the serve path: projections, KV caches, decode and
chunked-prefill self-attention.

PyTorch counterparts of the JAX package's ``models/attention.py`` for the
dense GQA layer.  Weights: wq (d, H, hd), wk/wv (d, KVH, hd),
wo (H, hd, d).  Caches: {"k", "v"} of (B, C, KVH, hd), a ring buffer of
size ``window`` for sliding-window layers.

Caches are updated **in place** — the decode scatter
(``kernels/cache_update``) and the prefill chunk write both write into
the tensors they are given, where the JAX package returned new buffers
and donated the old ones.  Decode attention always takes the
length-aware flash path (``kernels/decode_attention``); chunk attention
takes ``kernels/prefill_attention``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.cache_update.ops import cache_update
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.prefill_attention.ops import prefill_attention
from repro_torch.models import layers


def _no_quant(cfg: ModelConfig) -> None:
    if cfg.kv_quant is not None:
        raise NotImplementedError(
            f"kv_quant={cfg.kv_quant!r} comes with the quantized-cache slice")


# -- params -------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ModelConfig):
    """q: (d, H, hd)   k, v: (d, KVH, hd)   o: (H, hd, d)."""
    if cfg.qk_norm:
        raise NotImplementedError("qk_norm comes with the other-archs slice")
    d, h, kvh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {"wq": layers.dense_init(gen, (d, h, hd)),
            "wk": layers.dense_init(gen, (d, kvh, hd)),
            "wv": layers.dense_init(gen, (d, kvh, hd)),
            "wo": layers.dense_init(gen, (h, hd, d), in_axis=(0, 1))}


def attn_scale(cfg: ModelConfig) -> float:
    return 1.0 / math.sqrt(cfg.query_pre_attn_scalar or cfg.head_dim)


def project_qkv(cfg: ModelConfig, p, x: torch.Tensor, rope_tables):
    """Project hidden states (B, S, d) to q (B, S, H, hd) and k, v
    (B, S, KVH, hd), RoPE applied to q and k from ``rope_tables``
    (``layers.rope_tables`` of the tokens' positions)."""
    b, s, d = x.shape
    dt = x.dtype
    q = (x @ p["wq"].to(dt).reshape(d, -1)).view(b, s, cfg.num_heads, -1)
    k = (x @ p["wk"].to(dt).reshape(d, -1)).view(b, s, cfg.num_kv_heads, -1)
    v = (x @ p["wv"].to(dt).reshape(d, -1)).view(b, s, cfg.num_kv_heads, -1)
    q = layers.apply_rope(q, rope_tables)
    k = layers.apply_rope(k, rope_tables)
    return q, k, v


def output_proj(p, o: torch.Tensor) -> torch.Tensor:
    """o: (B, S, H, hd) -> (B, S, d)."""
    b, s = o.shape[:2]
    wo = p["wo"].to(o.dtype)
    return o.reshape(b, s, -1) @ wo.reshape(-1, wo.shape[-1])


# -- KV cache -------------------------------------------------------------------

def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  window: Optional[int] = None,
                  dtype: torch.dtype = torch.bfloat16,
                  device=None) -> Dict[str, torch.Tensor]:
    """Cache for one attention layer: (B, size, KVH, hd) k and v, with
    ``size = min(max_len, window)`` for sliding-window ring layers; on
    the card unless ``device="cpu"``."""
    _no_quant(cfg)
    device = resolve_device(device)
    size = min(max_len, window) if window else max_len
    shape = (batch, size, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_self_attention(cfg: ModelConfig, p, x: torch.Tensor,
                          cache: Dict[str, torch.Tensor],
                          cur_len: torch.Tensor, rope_tables, *,
                          window: Optional[int] = None) -> torch.Tensor:
    """One-token decode against a cache, which is updated in place.

    x: (B, 1, d).  cur_len: (B,) int32 — each row's count of tokens
    already in the cache (the new token's position).  The new k/v land
    at each row's slot through the ``kernels/cache_update`` scatter:
    ``cur % C`` in a ring, else ``min(cur, C - 1)`` (a retired row that
    keeps decoding garbage past the end overwrites the last slot instead
    of writing outside its row).  Attention then runs the length-aware
    ``kernels/decode_attention`` path.  Returns out (B, 1, d).
    """
    _no_quant(cfg)
    q, k_new, v_new = project_qkv(cfg, p, x, rope_tables)
    size = cache["k"].shape[1]
    slots = torch.remainder(cur_len, size) if window \
        else torch.clamp(cur_len, max=size - 1)
    cache_update(cache["k"], k_new, slots)
    cache_update(cache["v"], v_new, slots)
    o = decode_attention(q, cache["k"], cache["v"], cur_len,
                         ring=window is not None, softcap=cfg.attn_softcap,
                         scale=attn_scale(cfg))
    return output_proj(p, o)


def chunk_kv_write(cache: torch.Tensor, new: torch.Tensor,
                   offset: Union[int, torch.Tensor], valid_len: int, *,
                   ring: bool = False) -> torch.Tensor:
    """Write a prefill chunk's KV into a cache in place: ``new[:, t]``
    lands at position ``offset + t`` (slot ``(offset + t) % C`` when
    ``ring``) for every ``t < valid_len``.

    cache: (B, C, *rest).  new: (B, T, *rest).  offset: int (one start
    for every row) or (B,) tensor.  The int offset into a full cache is
    one slice copy of the whole chunk: pad tokens land on slots past the
    prompt, which stay invalid under every decode path's ``cur_len``
    mask until a real decode token overwrites them.  Its start clamps
    like ``dynamic_update_slice``.  Ring caches (where a pad write would
    wrap onto a valid older position) and per-row offsets select, per
    slot, the last valid chunk token that maps there.
    """
    b, t = new.shape[:2]
    c = cache.shape[1]
    new = new.to(cache.dtype)
    if not ring and isinstance(offset, int):
        start = min(max(offset, 0), c - t)
        cache[:, start:start + t] = new
        return cache
    dev = cache.device
    slots = torch.arange(c, device=dev)[None]               # (1, C)
    off = torch.as_tensor(offset, device=dev).long().reshape(-1, 1)
    if ring:
        last_valid = off + valid_len - 1
        i = (valid_len - 1) - torch.remainder(last_valid - slots, c)
        keep_new = i >= 0
    else:
        i = slots - off
        keep_new = (i >= 0) & (i < valid_len)
    i = torch.clamp(i, 0, t - 1).expand(b, c)
    keep_new = keep_new.expand(b, c)
    gathered = new[torch.arange(b, device=dev)[:, None], i]    # (B, C, ...)
    mask = keep_new.reshape(b, c, *([1] * (cache.dim() - 2)))
    cache.copy_(torch.where(mask, gathered, cache))
    return cache


def prefill_chunk_self_attention(cfg: ModelConfig, p, x: torch.Tensor,
                                 cache: Dict[str, torch.Tensor],
                                 offset: Union[int, torch.Tensor],
                                 offs: torch.Tensor, valid_len: int,
                                 rope_tables, *,
                                 window: Optional[int] = None
                                 ) -> torch.Tensor:
    """One chunk of chunked prefill through one attention layer.

    x: (B, T, d) at absolute positions ``offset + i``.  cache holds
    positions ``< offset``; the chunk's KV is written into it in place
    after attention.  ``offs`` is ``offset`` as a (B,) int32 tensor on
    x's device (built once per step by the caller).  ``valid_len``:
    tokens ``>= valid_len`` are a final partial chunk's right-padding.
    Returns out (B, T, d).
    """
    _no_quant(cfg)
    q, k_new, v_new = project_qkv(cfg, p, x, rope_tables)
    ring = window is not None
    o = prefill_attention(q, k_new, v_new, cache["k"], cache["v"], offs,
                          ring=ring, window=window,
                          softcap=cfg.attn_softcap, scale=attn_scale(cfg))
    chunk_kv_write(cache["k"], k_new, offset, valid_len, ring=ring)
    chunk_kv_write(cache["v"], v_new, offset, valid_len, ring=ring)
    return output_proj(p, o)
