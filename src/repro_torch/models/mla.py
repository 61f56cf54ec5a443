"""Multi-head Latent Attention (DeepSeek-V3).

PyTorch counterpart of the JAX package's ``models/mla.py``.  The
full-sequence path (train, whole-prompt prefill) materialises per-head k
and v from the compressed latent; the serve path uses the absorbed-weights
form, so a cache row holds only ``kv_lora_rank + qk_rope_head_dim``
values a token:

  q_lat  = q_nope @ W_UK            (the query moved into latent space)
  score  = q_lat . c_kv + q_rope . k_rope
  ctx    = softmax(score) @ c_kv    (the context in latent space)
  out    = (ctx @ W_UV) @ W_O

Cache layout: one ``"kv"`` leaf of ``[latent | rope key]`` rows, (B, C,
r + rope) or paged (P, page_size, r + rope).  The row is the decode key
(``[q_lat | q_rope] . [c_kv | k_rope]`` is the score) and its first
``kv_lora_rank`` lanes the value, so the attention kernels read it as K
and V at once (``v_width``, one kv head shared by every query head) and
one scatter a layer writes it.  With ``cfg.kv_quant`` the row is
quantized once, codes in ``"kv"`` and one float32 scale a row in
``"kv_scale"`` (B, C) or (P, page_size), which serves as the kernels'
``k_scale`` (and ``v_scale``).

Weights: wq_a (d, q_rank), q_norm (q_rank,), wq_b (q_rank, H, nope +
rope), wkv_a (d, r + rope), kv_norm (r,), wk_b (r, H, nope), wv_b (r, H,
v), wo (H, v, d).  Caches and pools are updated in place, as in
``models/attention.py``.
"""
from __future__ import annotations

import math
from typing import Dict, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import quant
from repro_torch.kernels.cache_update.ops import (
    cache_update, paged_cache_update, quant_cache_update,
    quant_paged_cache_update)
from repro_torch.kernels.constants import NEG_INF
from repro_torch.kernels.decode_attention.ops import (decode_attention,
                                                      decode_attention_paged)
from repro_torch.kernels.prefill_attention.ops import (
    prefill_attention, prefill_attention_paged)
from repro_torch.models import layers
from repro_torch.models.attention import attention, chunk_kv_write


def _rms(x: torch.Tensor, scale: torch.Tensor,
         eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    ms = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(ms + eps) * scale).to(x.dtype)


# -- params -------------------------------------------------------------------

def init_mla(gen: torch.Generator, cfg: ModelConfig):
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
    di = layers.dense_init
    return {
        "wq_a": di(gen, (d, m.q_lora_rank)),
        "q_norm": torch.ones((m.q_lora_rank,), dtype=torch.float32,
                             device=gen.device),
        "wq_b": di(gen, (m.q_lora_rank, h, qk_hd)),
        # the kv down-projection also makes the shared rope key
        "wkv_a": di(gen, (d, m.kv_lora_rank + m.qk_rope_head_dim)),
        "kv_norm": torch.ones((m.kv_lora_rank,), dtype=torch.float32,
                              device=gen.device),
        "wk_b": di(gen, (m.kv_lora_rank, h, m.qk_nope_head_dim)),
        "wv_b": di(gen, (m.kv_lora_rank, h, m.v_head_dim)),
        "wo": di(gen, (h, m.v_head_dim, d), in_axis=(0, 1)),
    }


def _project_q(cfg: ModelConfig, p, x: torch.Tensor, rope_tables):
    """(B, S, d) -> q_nope (B, S, H, nope), q_rope (B, S, H, rope), RoPE
    applied from ``rope_tables`` (``layers.rope_tables`` of the tokens'
    positions at ``layers.rope_dim``)."""
    m = cfg.mla
    dt = x.dtype
    ql = _rms(x @ p["wq_a"].to(dt), p["q_norm"])
    q = torch.einsum("bsr,rhk->bshk", ql, p["wq_b"].to(dt))
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = layers.apply_rope(q[..., m.qk_nope_head_dim:], rope_tables)
    return q_nope, q_rope


def _project_kv_latent(cfg: ModelConfig, p, x: torch.Tensor, rope_tables):
    """(B, S, d) -> the normed latent (B, S, r) and the roped shared key
    (B, S, rope)."""
    m = cfg.mla
    kv = x @ p["wkv_a"].to(x.dtype)
    latent = _rms(kv[..., :m.kv_lora_rank], p["kv_norm"])
    k_rope = layers.apply_rope(kv[..., m.kv_lora_rank:][:, :, None, :],
                               rope_tables)[:, :, 0, :]
    return latent, k_rope


def _scale(cfg: ModelConfig) -> float:
    m = cfg.mla
    return 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)


def _absorbed_query(cfg: ModelConfig, p, x: torch.Tensor, rope_tables):
    """The absorbed query ``[q_nope @ W_UK | q_rope]`` (B, S, H, r + rope)
    and the new tokens' cache rows ``[latent | k_rope]`` (B, S, r + rope)."""
    q_nope, q_rope = _project_q(cfg, p, x, rope_tables)
    latent, k_rope = _project_kv_latent(cfg, p, x, rope_tables)
    q_lat = torch.einsum("bqhk,rhk->bqhr", q_nope, p["wk_b"].to(x.dtype))
    return torch.cat([q_lat, q_rope], dim=-1), torch.cat([latent, k_rope],
                                                         dim=-1)


def _out(p, ctx: torch.Tensor) -> torch.Tensor:
    """The latent context (B, S, H, r) through W_UV and W_O -> (B, S, d)."""
    dt = ctx.dtype
    o = torch.einsum("bqhr,rhk->bqhk", ctx, p["wv_b"].to(dt))
    return torch.einsum("bqhk,hkd->bqd", o, p["wo"].to(dt))


# -- train / whole-prompt prefill ------------------------------------------------

def mla_self_attention(cfg: ModelConfig, p, x: torch.Tensor,
                       positions: torch.Tensor, rope_tables, *,
                       impl: str = "dense", chunk: int = 1024):
    """Full-sequence causal MLA over x (B, S, d) at positions (B, S).
    Returns (out, (latent, k_rope)), from which the serve path builds the
    latent cache.

    ``impl`` "dense" or "chunked" (``models.attention.attention``).  The
    flash kernel ("pallas") takes one head width for q, k and v, and
    MLA's q and k are ``nope + rope`` wide where v is ``v_head_dim``: it
    raises, as the JAX package's kernel does on these shapes."""
    m = cfg.mla
    qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
    if impl == "pallas":
        raise NotImplementedError(
            f"{cfg.name}: attention(impl='pallas') takes one head width "
            f"for q, k and v; MLA's q and k are {qk_hd} wide and v "
            f"{m.v_head_dim} (the JAX package's flash kernel fails on "
            "them too); use impl='dense' or 'chunked'")
    dt = x.dtype
    q_nope, q_rope = _project_q(cfg, p, x, rope_tables)
    latent, k_rope = _project_kv_latent(cfg, p, x, rope_tables)
    k_nope = torch.einsum("bsr,rhk->bshk", latent, p["wk_b"].to(dt))
    v = torch.einsum("bsr,rhk->bshk", latent, p["wv_b"].to(dt))
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        *k_nope.shape[:3], m.qk_rope_head_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    o = attention(cfg, q, k, v, q_pos=positions, kv_pos=positions,
                  causal=True, impl=impl, chunk=chunk, scale=_scale(cfg),
                  unroll=cfg.unroll_time_chunks,
                  causal_kv_trim=cfg.causal_kv_trim)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(dt))
    return out, (latent, k_rope)


# -- the latent cache --------------------------------------------------------------

def mla_leaf_specs(cfg: ModelConfig, lead: tuple,
                   dtype: torch.dtype = torch.bfloat16):
    """{name: (shape, dtype)} of one MLA layer's cache leaves whose leading
    dims are ``lead`` ((B, size) or (P, page_size)): "kv" of ``dtype``, or
    with ``cfg.kv_quant`` codes plus a float32 "kv_scale"."""
    m = cfg.mla
    shape = (*lead, m.kv_lora_rank + m.qk_rope_head_dim)
    if cfg.kv_quant is None:
        return {"kv": (shape, dtype)}
    return {"kv": (shape, quant.quant_dtype(cfg.kv_quant)),
            "kv_scale": (tuple(lead), torch.float32)}


def _zeros(specs, device) -> Dict[str, torch.Tensor]:
    return {name: torch.zeros(shape, dtype=dt, device=device)
            for name, (shape, dt) in specs.items()}


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16,
                   device=None) -> Dict[str, torch.Tensor]:
    """One MLA layer's (B, max_len, r + rope) latent cache (and (B,
    max_len) scales with ``cfg.kv_quant``), zero-filled, on the card
    unless ``device="cpu"``."""
    return _zeros(mla_leaf_specs(cfg, (batch, max_len), dtype),
                  resolve_device(device))


def prefill_mla_cache(cfg: ModelConfig, latent: torch.Tensor,
                      k_rope: torch.Tensor, max_len: int,
                      dtype: torch.dtype = torch.bfloat16
                      ) -> Dict[str, torch.Tensor]:
    """One layer's cache from a whole prompt's latent (B, S, r) and rope
    key (B, S, rope), on their device: the rows cast to ``dtype`` at
    slots 0..S-1 (one slice copy), or with ``cfg.kv_quant`` quantized by
    the quantizing scatter, S rows a batch row at offset 0 (what
    ``quant.quantize`` and that slice copy write, bit for bit)."""
    b, s = latent.shape[:2]
    if s > max_len:
        raise ValueError(f"prefill of {s} positions exceeds the cache's "
                         f"{max_len}")
    cache = init_mla_cache(cfg, b, max_len, dtype, device=latent.device)
    kv = torch.cat([latent, k_rope], dim=-1)
    if cfg.kv_quant is not None:
        offs = torch.zeros((b,), dtype=torch.int32, device=kv.device)
        quant_cache_update(cache["kv"], cache["kv_scale"], kv, offs,
                           cfg.kv_quant)
    else:
        cache["kv"][:, :s] = kv
    return cache


def _scales(cache) -> Union[torch.Tensor, None]:
    """A quantized cache's row scales with the kernels' KVH axis."""
    sc = cache.get("kv_scale")
    return None if sc is None else sc[..., None]


def mla_prefill_chunk(cfg: ModelConfig, p, x: torch.Tensor,
                      cache: Dict[str, torch.Tensor],
                      offset: Union[int, torch.Tensor], offs: torch.Tensor,
                      valid_len: int, rope_tables) -> torch.Tensor:
    """One chunk of chunked prefill through one MLA layer (absorbed).

    x: (B, T, d) at positions ``offset + i``; the cache holds positions
    ``< offset``; ``offs`` is ``offset`` as a (B,) int32 tensor.  The
    chunk attends the cache prefix and its own (not yet written) rows
    through ``prefill_attention`` with the rows as K and V
    (``v_width``), then its rows are written in place: a bf16 cache by
    ``chunk_kv_write``; a quantized one, with one int offset, by the
    quantizing scatter (the chunk's T rows from ``offset`` clamped to
    [0, C - T], what ``quant.quantize`` and ``chunk_kv_write``'s slice
    copy write), else quantized with ``quant.quantize`` and written by
    ``chunk_kv_write``.  Tokens ``>= valid_len`` are right-padding.
    Returns out (B, T, d)."""
    m = cfg.mla
    q_eff, kv_new = _absorbed_query(cfg, p, x, rope_tables)
    kvx = kv_new[:, :, None, :]                               # (B,T,1,r+rr)
    kvc = cache["kv"][:, :, None, :]                          # (B,C,1,r+rr)
    ctx = prefill_attention(q_eff, kvx, kvx, kvc, kvc, offs,
                            scale=_scale(cfg), v_width=m.kv_lora_rank,
                            k_scale=_scales(cache)).to(x.dtype)
    mode = cfg.kv_quant
    if mode is not None and isinstance(offset, int):
        quant_cache_update(cache["kv"], cache["kv_scale"], kv_new, offs,
                           mode)
    elif mode is not None:
        codes, sc = quant.quantize(kv_new, mode)
        chunk_kv_write(cache["kv_scale"], sc, offset, valid_len)
        chunk_kv_write(cache["kv"], codes, offset, valid_len)
    else:
        chunk_kv_write(cache["kv"], kv_new, offset, valid_len)
    return _out(p, ctx)


def mla_decode_attention(cfg: ModelConfig, p, x: torch.Tensor,
                         cache: Dict[str, torch.Tensor],
                         cur_len: torch.Tensor, rope_tables, *,
                         impl: str = "flash") -> torch.Tensor:
    """One-token absorbed-MLA decode, the cache updated in place.

    x: (B, 1, d); cur_len: (B,) int32, each row's new position.  The new
    ``[latent | rope]`` row lands at ``min(cur, C - 1)`` through the
    ``cache_update`` scatter (quantizing with ``cfg.kv_quant``); every
    scatter clamps its slot, so ``cur_len`` itself is passed.  Then, by
    ``impl``: "flash", ``decode_attention`` with the cache as K and V
    (``v_width``; rows past each row's position are never read);
    "dense", the JAX layer's masked attend over the whole cache, the
    latent and rope parts as two products, a quantized cache dequantized
    first.  Returns out (B, 1, d)."""
    m = cfg.mla
    dt = x.dtype
    q_nope, q_rope = _project_q(cfg, p, x, rope_tables)
    latent_new, k_rope_new = _project_kv_latent(cfg, p, x, rope_tables)
    kv_new = torch.cat([latent_new, k_rope_new], dim=-1)     # (B,1,r+rr)
    mode = cfg.kv_quant
    if mode is not None:
        quant_cache_update(cache["kv"], cache["kv_scale"], kv_new, cur_len,
                           mode)
    else:
        cache_update(cache["kv"], kv_new, cur_len)
    q_lat = torch.einsum("bqhk,rhk->bqhr", q_nope, p["wk_b"].to(dt))
    scale = _scale(cfg)
    if impl == "flash":
        kv4 = cache["kv"][:, :, None, :]                      # (B,C,1,r+rr)
        ctx = decode_attention(torch.cat([q_lat, q_rope], dim=-1), kv4, kv4,
                               cur_len, scale=scale, v_width=m.kv_lora_rank,
                               k_scale=_scales(cache)).to(dt)
        return _out(p, ctx)
    if impl != "dense":
        raise ValueError(f"unknown decode attention impl {impl!r}")
    kv = cache["kv"]
    kv_f = quant.dequantize(kv, cache["kv_scale"]) if mode is not None \
        else kv
    latent = kv_f[..., :m.kv_lora_rank].to(dt)
    k_rope = kv_f[..., m.kv_lora_rank:].to(dt)
    s_lat = torch.einsum("bqhr,bsr->bhqs", q_lat, latent)
    s_rope = torch.einsum("bqhk,bsk->bhqs", q_rope, k_rope)
    scores = (s_lat + s_rope).float() * scale
    valid = torch.arange(kv.shape[1], device=x.device)[None, None, None, :] \
        <= cur_len[:, None, None, None]
    probs = torch.softmax(torch.where(valid, scores, NEG_INF), dim=-1)
    ctx = torch.einsum("bhqs,bsr->bqhr", probs.to(dt), latent)
    return _out(p, ctx)


# -- paged (page pools + page tables) ----------------------------------------------

def init_paged_mla_pool(cfg: ModelConfig, num_pages: int, page_size: int,
                        dtype: torch.dtype = torch.bfloat16,
                        device=None) -> Dict[str, torch.Tensor]:
    """One MLA layer's (P, page_size, r + rope) page pool (and (P,
    page_size) scales with ``cfg.kv_quant``), zero-filled, on the card
    unless ``device="cpu"``; the page-id space of
    ``attention.init_paged_kv_pools`` (page 0 is scratch)."""
    return _zeros(mla_leaf_specs(cfg, (num_pages, page_size), dtype),
                  resolve_device(device))


def _paged_write(cfg: ModelConfig, cache, kv_new, page_table, starts,
                 valids) -> None:
    if cfg.kv_quant is not None:
        quant_paged_cache_update(cache["kv"], cache["kv_scale"], kv_new,
                                 page_table, starts, valids, cfg.kv_quant)
    else:
        paged_cache_update(cache["kv"], kv_new, page_table, starts, valids)


def mla_paged_decode_attention(cfg: ModelConfig, p, x: torch.Tensor,
                               cache: Dict[str, torch.Tensor],
                               cur_len: torch.Tensor,
                               page_table: torch.Tensor,
                               rope_tables) -> torch.Tensor:
    """One-token absorbed-MLA decode against a paged latent pool, updated
    in place.  x: (B, 1, d); cur_len: (B,) int32; page_table: (B, NB)
    int32 (masked rows touch only the scratch page).  The new row lands
    through ``paged_cache_update`` (one valid row a batch row, as the
    JAX layer's vector of ones says), then ``decode_attention_paged``
    reads the pool as K and V (``v_width``).  Returns out (B, 1, d)."""
    m = cfg.mla
    q_eff, kv_new = _absorbed_query(cfg, p, x, rope_tables)
    ones = torch.ones((x.shape[0],), dtype=torch.int32, device=x.device)
    _paged_write(cfg, cache, kv_new, page_table, cur_len, ones)
    kv4 = cache["kv"][:, :, None, :]                          # (P,ps,1,r+rr)
    ctx = decode_attention_paged(q_eff, kv4, kv4, page_table, cur_len,
                                 scale=_scale(cfg), v_width=m.kv_lora_rank,
                                 k_scale=_scales(cache)).to(x.dtype)
    return _out(p, ctx)


def mla_paged_prefill_chunk(cfg: ModelConfig, p, x: torch.Tensor,
                            cache: Dict[str, torch.Tensor],
                            offs: torch.Tensor, valid_len: torch.Tensor,
                            page_table: torch.Tensor,
                            rope_tables) -> torch.Tensor:
    """One chunk of chunked prefill through one MLA layer, paged: x (B, T,
    d) at positions ``offs[b] + i``; offs/valid_len (B,) int32 (rows
    with ``valid_len == 0`` write nothing and their outputs are
    discarded).  The chunk attends first, its own rows as separate
    operands, then its rows are scattered into the pool.  Returns out
    (B, T, d)."""
    m = cfg.mla
    q_eff, kv_new = _absorbed_query(cfg, p, x, rope_tables)
    kvx = kv_new[:, :, None, :]                               # (B,T,1,r+rr)
    kvp = cache["kv"][:, :, None, :]                          # (P,ps,1,r+rr)
    ctx = prefill_attention_paged(q_eff, kvx, kvx, kvp, kvp, page_table,
                                  offs, scale=_scale(cfg),
                                  v_width=m.kv_lora_rank,
                                  k_scale=_scales(cache)).to(x.dtype)
    _paged_write(cfg, cache, kv_new, page_table, offs, valid_len)
    return _out(p, ctx)
