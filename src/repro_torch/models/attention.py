"""GQA attention: full-sequence attention for the train path, and for
the serve path projections, KV caches, decode and chunked-prefill
self-attention, over contiguous caches or page pools.

PyTorch counterparts of the JAX package's ``models/attention.py`` for the
dense GQA layer.  Weights: wq (d, H, hd), wk/wv (d, KVH, hd),
wo (H, hd, d).  Caches: {"k", "v"} of (B, C, KVH, hd), a ring buffer of
size ``window`` for sliding-window layers; or, paged, {"k", "v"} pools
of (P, page_size, KVH, hd) shared by every slot through (B, NB) page
tables, sliding-window layers stored unwrapped.  With ``cfg.kv_quant``
("int8" / "fp8_e4m3") the "k", "v" leaves hold codes and two more
leaves, "k_scale" and "v_scale", hold one float32 absmax scale per
(position, kv head): (B, C, KVH), or (P, page_size, KVH) paged exactly
like the code pools.  The attention kernels dequantize inside.

Full-sequence ``attention`` has the JAX package's three impls:
``dense`` (the whole (B, H, Sq, Skv) score tensor), ``chunked`` (query
chunks of ``chunk``, each chunk body under ``torch.utils.checkpoint`` as
JAX wraps it in ``jax.checkpoint``) — both plain PyTorch, as they are
XLA code in JAX — and ``pallas``, the flash-attention kernel
(``kernels/flash_attention``), causal self-attention only.

Caches and pools are updated **in place** — the decode scatters
(``kernels/cache_update``) and the prefill chunk writes all write into
the tensors they are given, where the JAX package returned new buffers
and donated the old ones.  Decode attention takes the length-aware flash
path (``kernels/decode_attention``) or, with ``impl="dense"``, a masked
attend over the whole cache (XLA code in JAX, plain PyTorch here); chunk
attention takes ``kernels/prefill_attention``.  ``prefill_kv_cache``
builds a layer's cache from a whole-prompt prefill's k and v: a slice
copy at slot 0, or with ``cfg.kv_quant`` the quantizing scatter's T rows
at offset 0.  The scatters write a layer's k and
v in one launch (``cache_update_pair``, ``paged_cache_update_pair``),
at every decode step and every paged chunk; a bf16 contiguous chunk is
two slice copies (``chunk_kv_write``), no kernel launch.  Quantized
writes go through the quantizing scatters, likewise one launch a layer
(``quant_cache_update_pair``, ``quant_paged_cache_update_pair``): at
every decode step, at every paged chunk, and at a contiguous chunk with
one int offset and no ring, whose T rows the scatter places as the slice
copy of ``chunk_kv_write`` would (the JAX package quantizes that chunk
with plain ops, which XLA fuses).  A ring cache's or per-row
offsets' chunk is still quantized with ``quant.quantize`` and written
with ``chunk_kv_write``: no served config of the port has either yet.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import quant
from repro_torch.kernels.cache_update.ops import (
    cache_update_pair, paged_cache_update_pair, quant_cache_update_pair,
    quant_paged_cache_update_pair)
from repro_torch.kernels.constants import NEG_INF
from repro_torch.kernels.decode_attention.ops import (decode_attention,
                                                      decode_attention_paged)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.prefill_attention.ops import (
    prefill_attention, prefill_attention_paged)
from repro_torch.models import layers


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


# -- masks and full-sequence attention ------------------------------------------

def make_mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, causal: bool,
              window: Optional[int] = None,
              kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Boolean (B, Sq, Skv) mask; True = attend.

    q_pos: (B, Sq) token positions of the queries; kv_pos: (B, Skv)
    positions of the keys; window: attend iff 0 <= q - k < window;
    kv_valid: (B, Skv) validity of the keys.
    """
    diff = q_pos[:, :, None] - kv_pos[:, None, :]
    mask = torch.ones(diff.shape, dtype=torch.bool, device=diff.device)
    if causal:
        mask &= diff >= 0
    if window is not None:
        mask &= diff < window
    if kv_valid is not None:
        mask &= kv_valid[:, None, :]
    return mask


def _gqa_scores(q: torch.Tensor, k: torch.Tensor,
                softcap: Optional[float]) -> torch.Tensor:
    """(B,Sq,KVH,G,hd) x (B,Skv,KVH,hd) -> fp32 (B,KVH,G,Sq,Skv); the
    product is taken in the inputs' dtype, then widened, as in JAX."""
    s = torch.einsum("bqhgk,bshk->bhgqs", q, k).float()
    return layers.softcap(s, softcap)


def _attend_block(cfg: ModelConfig, q, k, v, mask: torch.Tensor,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Dense attention for one (whole or chunked) query block.

    q: (B,Sq,H,hd) k,v: (B,Skv,KVH,hd) mask: (B,Sq,Skv) -> (B,Sq,H,hd)
    """
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    if scale is None:
        scale = attn_scale(cfg)
    qg = q.reshape(b, sq, kvh, h // kvh, hd) * scale
    s = _gqa_scores(qg, k, cfg.attn_softcap)
    s = torch.where(mask[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqs,bshk->bqhgk", p.to(v.dtype), v)
    return o.reshape(b, sq, h, v.shape[-1])


def attention(cfg: ModelConfig, q, k, v, *, q_pos, kv_pos,
              causal: bool = True, window: Optional[int] = None,
              kv_valid: Optional[torch.Tensor] = None, impl: str = "dense",
              chunk: int = 1024, scale: Optional[float] = None,
              unroll: bool = False,
              causal_kv_trim: bool = False) -> torch.Tensor:
    """Multi-head attention over explicit q (B,Sq,H,hd), k/v (B,Skv,KVH,hd).

    impl="dense"   full score tensor.
    impl="chunked" query chunks of size ``chunk``: the live score tensor
                   is (B, H, chunk, Skv), and each chunk body runs under
                   ``torch.utils.checkpoint`` so backward recomputes its
                   scores instead of saving them.
    impl="pallas"  the flash-attention kernel (causal self-attention
                   only; the JAX package's name for it is kept).

    ``unroll`` and ``causal_kv_trim`` as in the JAX package: with both
    (causal, no ``kv_valid``), each query chunk attends only its
    causally visible key prefix.  Without ``unroll`` JAX scans the chunks
    and ignores the trim; here both are one Python loop.
    """
    if impl == "pallas":
        # The flash kernel derives its mask from row and column indices;
        # it cannot honour a kv_valid mask or non-causal attention.
        if kv_valid is not None:
            raise ValueError(
                "attention(impl='pallas') cannot honor kv_valid masks — "
                "use impl='dense'/'chunked', or the flash-decode kernel "
                "(kernels/decode_attention) for single-token decode")
        if not causal:
            raise ValueError(
                "attention(impl='pallas') is causal self-attention only; "
                "cross-attention must use impl='dense' or 'chunked'")
        if scale is None:
            scale = attn_scale(cfg)
        return flash_attention(q, k, v, causal=causal, window=window,
                               softcap=cfg.attn_softcap, scale=scale)
    if impl == "dense" or q.shape[1] <= chunk:
        mask = make_mask(q_pos, kv_pos, causal, window, kv_valid)
        return _attend_block(cfg, q, k, v, mask, scale)
    if impl != "chunked":
        raise ValueError(f"unknown attention impl {impl!r}")

    sq = q.shape[1]
    n_chunks, rem = divmod(sq, chunk)
    if rem:
        raise ValueError(f"seq {sq} not divisible by chunk {chunk}")

    def chunk_body(qc, qpc, kc, vc, kv_pos_c, kv_valid_c):
        mask = make_mask(qpc, kv_pos_c, causal, window, kv_valid_c)
        return _attend_block(cfg, qc, kc, vc, mask, scale)

    trim = unroll and causal_kv_trim and causal and kv_valid is None
    outs = []
    for i in range(n_chunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        hi = (i + 1) * chunk if trim else k.shape[1]
        outs.append(checkpoint(
            chunk_body, q[:, sl], q_pos[:, sl], k[:, :hi], v[:, :hi],
            kv_pos[:, :hi], kv_valid, use_reentrant=False))
    return torch.cat(outs, dim=1)


def self_attention(cfg: ModelConfig, p, x: torch.Tensor,
                   positions: torch.Tensor, *, causal: bool = True,
                   window: Optional[int] = None, impl: str = "dense",
                   chunk: int = 1024) -> torch.Tensor:
    """Full self-attention of x (B, S, d) at positions (B, S), no cache."""
    tables = layers.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    q, k, v = project_qkv(cfg, p, x, tables)
    o = attention(cfg, q, k, v, q_pos=positions, kv_pos=positions,
                  causal=causal, window=window, impl=impl, chunk=chunk)
    return output_proj(p, o)


# -- KV cache -------------------------------------------------------------------

def kv_leaf_specs(cfg: ModelConfig, lead: tuple,
                  dtype: torch.dtype = torch.bfloat16):
    """{name: (shape, dtype)} of one attention layer's cache leaves whose
    leading dims are ``lead`` ((B, size) or (P, page_size)): k and v of
    ``dtype``, or with ``cfg.kv_quant`` codes of the mode's dtype plus
    float32 k_scale and v_scale (``dtype`` then only names the layout an
    unquantized engine would have used)."""
    shape = (*lead, cfg.num_kv_heads, cfg.head_dim)
    if cfg.kv_quant is None:
        return {"k": (shape, dtype), "v": (shape, dtype)}
    qdt = quant.quant_dtype(cfg.kv_quant)
    return {"k": (shape, qdt), "v": (shape, qdt),
            "k_scale": (shape[:-1], torch.float32),
            "v_scale": (shape[:-1], torch.float32)}


def _zeros(specs, device) -> Dict[str, torch.Tensor]:
    return {name: torch.zeros(shape, dtype=dt, device=device)
            for name, (shape, dt) in specs.items()}


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  window: Optional[int] = None,
                  dtype: torch.dtype = torch.bfloat16,
                  device=None) -> Dict[str, torch.Tensor]:
    """Cache for one attention layer: (B, size, KVH, hd) k and v, with
    ``size = min(max_len, window)`` for sliding-window ring layers, and
    (B, size, KVH) k_scale/v_scale with ``cfg.kv_quant``; on the card
    unless ``device="cpu"``."""
    device = resolve_device(device)
    size = min(max_len, window) if window else max_len
    return _zeros(kv_leaf_specs(cfg, (batch, size), dtype), device)


def prefill_kv_cache(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor,
                     max_len: int, window: Optional[int] = None,
                     dtype: torch.dtype = torch.bfloat16
                     ) -> Dict[str, torch.Tensor]:
    """One layer's cache built from a whole-prompt prefill's k and v
    (B, S, KVH, hd), on their device.

    bf16 / fp32: k and v cast to ``dtype`` at slots 0..S-1 of a
    zero-filled (B, size, KVH, hd) cache, one slice copy each (XLA's
    ``dynamic_update_slice`` in JAX).  With ``cfg.kv_quant`` the
    quantizing scatter writes both leaves' codes and scales in one launch,
    S rows a batch row at offset 0: what ``quant.quantize`` followed by
    that slice copy writes, bit for bit.  A ring layer (``window``) whose
    prompt outruns it keeps the last ``size`` positions, rolled so that
    position p sits at slot p % size (codes quantized once with
    ``quant.quantize``; per-row quantization commutes with the roll)."""
    b, s = k.shape[:2]
    size = min(max_len, window) if window else max_len
    mode = cfg.kv_quant
    if window and s > size:
        if mode is None:
            leaves = {"k": k.to(dtype), "v": v.to(dtype)}
        else:
            (kc, ks), (vc, vs) = (quant.quantize(x, mode) for x in (k, v))
            leaves = {"k": kc, "v": vc, "k_scale": ks, "v_scale": vs}
        start = s - size
        return {name: torch.roll(x[:, start:], start % size, dims=1)
                for name, x in leaves.items()}
    if s > size:
        raise ValueError(f"prefill of {s} positions exceeds the cache's "
                         f"{size}")
    cache = init_kv_cache(cfg, b, max_len, window=window, dtype=dtype,
                          device=k.device)
    if mode is not None:
        offs = torch.zeros((b,), dtype=torch.int32, device=k.device)
        quant_cache_update_pair(cache["k"], cache["k_scale"], k, cache["v"],
                                cache["v_scale"], v, offs, mode)
        return cache
    cache["k"][:, :s] = k
    cache["v"][:, :s] = v
    return cache


def decode_self_attention(cfg: ModelConfig, p, x: torch.Tensor,
                          cache: Dict[str, torch.Tensor],
                          cur_len: torch.Tensor, rope_tables, *,
                          window: Optional[int] = None,
                          impl: str = "flash") -> torch.Tensor:
    """One-token decode against a cache, which is updated in place.

    x: (B, 1, d).  cur_len: (B,) int32 — each row's count of tokens
    already in the cache (the new token's position).  The new k/v land
    at each row's slot through the ``kernels/cache_update`` scatter, k
    and v in one launch: ``cur % C`` in a ring, else ``min(cur, C - 1)``
    (a retired row that keeps decoding garbage past the end overwrites
    the last slot instead of writing outside its row), the slots the
    JAX layer's ``jnp.minimum`` computes.  Outside a ring ``cur_len``
    itself is passed: every scatter, kernel or plain, clamps its slots
    to [0, C - 1], so no clamp is launched here.  A quantized cache takes
    the quantizing scatter.  Attention then runs, by ``impl``: "flash",
    the length-aware ``kernels/decode_attention`` path (a quantized
    cache's scales passed to it); "dense", the JAX layer's masked attend
    over the whole cache against each slot's position (a ring's slot s
    holds the largest position p <= cur with p % C == s; negative p was
    never written), a quantized cache dequantized first and cast to q's
    dtype.  Returns out (B, 1, d).
    """
    q, k_new, v_new = project_qkv(cfg, p, x, rope_tables)
    c = cache["k"].shape[1]
    slots = torch.remainder(cur_len, c) if window else cur_len
    _scatter(cfg, cache, k_new, v_new, cache_update_pair,
             quant_cache_update_pair, slots)
    if impl == "flash":
        o = decode_attention(q, cache["k"], cache["v"], cur_len,
                             ring=window is not None,
                             softcap=cfg.attn_softcap, scale=attn_scale(cfg),
                             k_scale=cache.get("k_scale"),
                             v_scale=cache.get("v_scale"))
        return output_proj(p, o)
    if impl != "dense":
        raise ValueError(f"unknown decode attention impl {impl!r}")
    cols = torch.arange(c, dtype=torch.int32, device=x.device)[None]
    cur_col = cur_len[:, None]                                  # (B, 1)
    if window:
        kv_pos = cur_col - torch.remainder(cur_col - cols, c)
        kv_valid = kv_pos >= 0
        kv_pos = torch.clamp(kv_pos, min=0)
    else:
        kv_pos, kv_valid = cols, cols <= cur_col
    if cfg.kv_quant is not None:
        k_att = quant.dequantize(cache["k"], cache["k_scale"]).to(q.dtype)
        v_att = quant.dequantize(cache["v"], cache["v_scale"]).to(q.dtype)
    else:
        k_att, v_att = cache["k"].to(q.dtype), cache["v"].to(q.dtype)
    o = attention(cfg, q, k_att, v_att, q_pos=cur_col, kv_pos=kv_pos,
                  causal=True, window=window, kv_valid=kv_valid,
                  impl="dense")
    return output_proj(p, o)


def _scatter(cfg: ModelConfig, cache, k_new, v_new, plain, quantizing,
             *where) -> None:
    """Write the new k/v rows into the cache in place, both leaves in one
    call: through the scatter ``plain(k, k_rows, v, v_rows, *where)``, or
    with ``cfg.kv_quant`` through its quantizing twin
    ``quantizing(k, k_scale, k_rows, v, v_scale, v_rows, *where, mode)``."""
    if cfg.kv_quant is None:
        plain(cache["k"], k_new, cache["v"], v_new, *where)
    else:
        quantizing(cache["k"], cache["k_scale"], k_new, cache["v"],
                   cache["v_scale"], v_new, *where, cfg.kv_quant)


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
    slot, the last valid chunk token that maps there.  A quantized
    cache's int-offset chunk goes through ``quant_cache_update_pair``
    instead, which writes the same slots (``prefill_chunk_self_attention``);
    its ring and per-row-offset chunks come here as codes and scales.
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
    A quantized cache with one int offset and no ring (the engine's
    chunks: batch 1) takes the quantizing scatter, k and v in one launch:
    the chunk's T rows from ``offset`` clamped to [0, C - T], pad rows
    included, which is what ``chunk_kv_write``'s slice copy writes, so
    codes and scales are those of ``quant.quantize`` then that copy, bit
    for bit.  A ring or per-row offsets (gemma2's sliding layers; none of
    the port's served configs yet) quantize the chunk's k/v once with
    ``quant.quantize``, and codes and scales (scales are (B, T, KVH)
    rows) take ``chunk_kv_write``'s masked write.  Returns out (B, T, d).
    """
    q, k_new, v_new = project_qkv(cfg, p, x, rope_tables)
    ring = window is not None
    o = prefill_attention(q, k_new, v_new, cache["k"], cache["v"], offs,
                          ring=ring, window=window,
                          softcap=cfg.attn_softcap, scale=attn_scale(cfg),
                          k_scale=cache.get("k_scale"),
                          v_scale=cache.get("v_scale"))
    mode = cfg.kv_quant
    if mode is not None and not ring and isinstance(offset, int):
        quant_cache_update_pair(cache["k"], cache["k_scale"], k_new,
                                cache["v"], cache["v_scale"], v_new, offs,
                                mode)
        return output_proj(p, o)
    rows = {"k": k_new, "v": v_new}
    if mode is not None:
        for name in ("k", "v"):
            rows[name], rows[f"{name}_scale"] = quant.quantize(
                rows[name], mode)
    for name, new in rows.items():
        chunk_kv_write(cache[name], new, offset, valid_len, ring=ring)
    return output_proj(p, o)


# -- paged KV cache (page pools + page tables) ---------------------------------

def init_paged_kv_pools(cfg: ModelConfig, num_pages: int, page_size: int,
                        dtype: torch.dtype = torch.bfloat16,
                        device=None) -> Dict[str, torch.Tensor]:
    """Physical page pools for one attention layer: (P, page_size, KVH,
    hd) k and v, zero-filled, on the card unless ``device="cpu"``.

    Every layer's pool shares ONE page-id space: a request's (NB,) page
    table row addresses the same physical page in every leaf.  Page 0 is
    the scratch page (masked writes may land there; its content is
    undefined).  Sliding-window layers store positions unwrapped
    (slot == position), the window an explicit attention mask, so prefix
    pages are position-stable and shareable across requests.  With
    ``cfg.kv_quant`` the (P, page_size, KVH) k_scale/v_scale pools page
    exactly like the code pools, so a page's scales travel with it.
    """
    device = resolve_device(device)
    return _zeros(kv_leaf_specs(cfg, (num_pages, page_size), dtype), device)


def paged_decode_self_attention(cfg: ModelConfig, p, x: torch.Tensor,
                                cache: Dict[str, torch.Tensor],
                                cur_len: torch.Tensor,
                                page_table: torch.Tensor, rope_tables, *,
                                window: Optional[int] = None
                                ) -> torch.Tensor:
    """One-token decode against paged pools, which are updated in place.

    x: (B, 1, d).  cur_len: (B,) int32 per-row positions.  page_table:
    (B, NB) int32 — rows the scheduler has masked to 0 (mid-prefill or
    dead slots) read and write only the scratch page, so their garbage
    decode tokens cannot touch a live request's pages.  The new k/v land
    at ``cur_len`` through ``paged_cache_update_pair`` (clamped to the
    table's last slot), k and v in one launch, with ``valids`` None: the
    one row of each slot is valid, which the JAX layer says with a vector
    of ones and the scatters without building one.  Then
    ``decode_attention_paged`` reads each row's pages.  Quantized pools
    take the quantizing scatter and pass their scale pools to attention.
    Returns out (B, 1, d).
    """
    q, k_new, v_new = project_qkv(cfg, p, x, rope_tables)
    _scatter(cfg, cache, k_new, v_new, paged_cache_update_pair,
             quant_paged_cache_update_pair, page_table, cur_len, None)
    o = decode_attention_paged(q, cache["k"], cache["v"], page_table,
                               cur_len, window=window,
                               softcap=cfg.attn_softcap,
                               scale=attn_scale(cfg),
                               k_scale=cache.get("k_scale"),
                               v_scale=cache.get("v_scale"))
    return output_proj(p, o)


def paged_prefill_chunk_self_attention(cfg: ModelConfig, p, x: torch.Tensor,
                                       cache: Dict[str, torch.Tensor],
                                       offs: torch.Tensor,
                                       valid_len: torch.Tensor,
                                       page_table: torch.Tensor,
                                       rope_tables, *,
                                       window: Optional[int] = None
                                       ) -> torch.Tensor:
    """One chunk of chunked prefill through one attention layer, paged.

    x: (B, T, d) at positions ``offs[b] + i``; the pools hold positions
    ``< offs[b]`` of every row through page_table (B, NB).  ``offs`` and
    ``valid_len`` are (B,) int32 — rows with ``valid_len == 0`` (slots
    decoding, or idle, during a batched admission dispatch) give garbage
    outputs the caller discards and write nothing.  The chunk attends
    first, then its KV is written into the pools in place (quantized by
    the quantizing scatter with ``cfg.kv_quant``).  Returns out (B, T, d).
    """
    q, k_new, v_new = project_qkv(cfg, p, x, rope_tables)
    o = prefill_attention_paged(q, k_new, v_new, cache["k"], cache["v"],
                                page_table, offs, window=window,
                                softcap=cfg.attn_softcap,
                                scale=attn_scale(cfg),
                                k_scale=cache.get("k_scale"),
                                v_scale=cache.get("v_scale"))
    _scatter(cfg, cache, k_new, v_new, paged_cache_update_pair,
             quant_paged_cache_update_pair, page_table, offs, valid_len)
    return output_proj(p, o)
