"""Per-layer block assembly: the attention + MLP block (kind "A"), over
the full sequence (train path and whole-prompt prefill) or one step
against contiguous caches or page pools (serve path).  Paged decode
always takes the flash kernel, as in the JAX package, whatever
``cfg.decode_attn_impl`` says.

PyTorch counterparts of the kind-"A" branches of the JAX package's
``models/blocks.py``.  The other kinds (mamba "M", xLSTM "m"/"s",
encoder "E", cross-attention "X") come with later slices and raise.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers


def check_supported(cfg: ModelConfig) -> None:
    """Raise for any config feature this slice does not port, naming the
    slice of the port that brings it."""
    later = {
        "moe": (cfg.moe is not None, "the other-archs slice (MoE)"),
        "mla": (cfg.attention != "gqa", "the other-archs slice (MLA)"),
        "state": (cfg.mamba is not None or cfg.xlstm is not None
                  or cfg.family in ("ssm", "hybrid"),
                  "the other-archs slice (mamba / xLSTM)"),
        "encoder-decoder": (cfg.is_encoder_decoder,
                            "the other-archs slice (whisper)"),
        "m_rope": (cfg.m_rope, "the other-archs slice (qwen2-vl)"),
        "pos_embed": (cfg.pos_embed != "rope",
                      "the other-archs slice (sinusoidal / none)"),
        "mtp": (cfg.mtp, "the other-archs slice (deepseek-v3 MTP)"),
    }
    for name, (hit, where) in later.items():
        if hit:
            raise NotImplementedError(f"{cfg.name}: {name} is not ported "
                                      f"yet; it comes with {where}")


def layer_kind(cfg: ModelConfig, idx: int) -> str:
    """The block kind of decoder layer ``idx``, as the JAX package names
    it: "A" attention, "X" cross-attention decoder, a mamba "M" or xLSTM
    "m"/"s" letter of a hybrid or state arch's pattern."""
    if cfg.is_encoder_decoder:
        return "X"
    if cfg.family == "ssm":
        pat = cfg.xlstm.pattern
        return pat[idx % len(pat)]
    if cfg.family == "hybrid":
        return cfg.hybrid_pattern[idx % len(cfg.hybrid_pattern)]
    return "A"


def layer_window(cfg: ModelConfig, idx: int) -> Optional[int]:
    """Sliding-window size for this layer (local/global layer pattern)."""
    if cfg.layer_pattern and cfg.sliding_window:
        kind = cfg.layer_pattern[idx % len(cfg.layer_pattern)]
        return cfg.sliding_window if kind == "L" else None
    return cfg.sliding_window


def attn_impl(cfg: ModelConfig, seq_len: int) -> str:
    """The full-sequence attention impl for ``seq_len``: ``cfg.attn_impl``,
    or for "auto" dense when the sequence is short or not a whole number
    of ``attn_chunk`` chunks, else chunked (never the kernel)."""
    if cfg.attn_impl != "auto":
        return cfg.attn_impl
    if seq_len <= cfg.attn_chunk or seq_len % cfg.attn_chunk:
        return "dense"
    return "chunked"


def decode_attn_impl(cfg: ModelConfig) -> str:
    """The decode attention path of ``cfg.decode_attn_impl``: "auto" and
    "flash" take the flash-decode kernel (its plain version on the CPU),
    "dense" the masked attend over the whole cache.  The JAX package
    resolves "auto" by its backend (flash on the TPU); the port's decode
    kernel runs on the card, so "auto" is flash everywhere."""
    impl = cfg.decode_attn_impl
    if impl == "auto":
        return "flash"
    if impl not in ("dense", "flash"):
        raise ValueError(f"unknown decode_attn_impl {impl!r}")
    return impl


def init_block(gen: torch.Generator, cfg: ModelConfig):
    dev = gen.device
    p = {"norm_1": layers.init_norm(cfg, dev),
         "norm_2": layers.init_norm(cfg, dev)}
    if cfg.post_block_norm:
        p["post_norm_1"] = layers.init_norm(cfg, dev)
        p["post_norm_2"] = layers.init_norm(cfg, dev)
    p["mixer"] = attn.init_attention(gen, cfg)
    p["ffn"] = layers.init_mlp(gen, cfg)
    return p


def init_block_cache(cfg: ModelConfig, idx: int, batch: int, max_len: int,
                     dtype: torch.dtype = torch.bfloat16,
                     device=None) -> Dict[str, torch.Tensor]:
    """Layer ``idx``'s cache, on the card unless ``device="cpu"``."""
    return attn.init_kv_cache(cfg, batch, max_len,
                              window=layer_window(cfg, idx), dtype=dtype,
                              device=device)


def _tail(cfg: ModelConfig, p, x: torch.Tensor, out: torch.Tensor):
    """Post-mixer tail: post-norm, residual, MLP, post-norm, residual."""
    if cfg.post_block_norm:
        out = layers.apply_norm(cfg, p["post_norm_1"], out)
    x = x + out
    h = layers.apply_norm(cfg, p["norm_2"], x)
    out = layers.apply_mlp(cfg, p["ffn"], h)
    if cfg.post_block_norm:
        out = layers.apply_norm(cfg, p["post_norm_2"], out)
    return x + out


def block_forward(cfg: ModelConfig, p, x: torch.Tensor,
                  positions: torch.Tensor, idx: int, *, enc_out=None,
                  encoder: bool = False, collect_kv: bool = False,
                  rope_tables=None):
    """One block over the full sequence: x (B, S, d) at positions (B, S).

    Returns (x, aux_loss, kv): aux_loss is a 0 fp32 scalar (no MoE here),
    kv the layer's (k, v) with ``collect_kv``, else None.
    ``rope_tables`` (``layers.rope_tables`` of ``positions``) may be
    passed to share them across layers.  Only kind "A" decoder blocks are
    ported; encoder and cross-attention blocks raise.
    """
    if encoder or enc_out is not None or layer_kind(cfg, idx) != "A":
        raise NotImplementedError(f"{cfg.name}: block kind of layer {idx} "
                                  "comes with the other-archs slice")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if rope_tables is None:
        rope_tables = layers.rope_tables(positions, cfg.head_dim,
                                         cfg.rope_theta)
    h = layers.apply_norm(cfg, p["norm_1"], x)
    q, k, v = attn.project_qkv(cfg, p["mixer"], h, rope_tables)
    o = attn.attention(cfg, q, k, v, q_pos=positions, kv_pos=positions,
                       causal=True, window=layer_window(cfg, idx),
                       impl=attn_impl(cfg, h.shape[1]), chunk=cfg.attn_chunk,
                       unroll=cfg.unroll_time_chunks,
                       causal_kv_trim=cfg.causal_kv_trim)
    out = attn.output_proj(p["mixer"], o)
    return _tail(cfg, p, x, out), aux, ((k, v) if collect_kv else None)


def block_decode(cfg: ModelConfig, p, x: torch.Tensor, cache,
                 cur_len: torch.Tensor, idx: int, rope_tables):
    """One-token decode through one block; x: (B, 1, d), cur_len: (B,).
    The block's cache is updated in place."""
    h = layers.apply_norm(cfg, p["norm_1"], x)
    out = attn.decode_self_attention(cfg, p["mixer"], h, cache, cur_len,
                                     rope_tables,
                                     window=layer_window(cfg, idx),
                                     impl=decode_attn_impl(cfg))
    return _tail(cfg, p, x, out)


def block_prefill_chunk(cfg: ModelConfig, p, x: torch.Tensor, cache,
                        offset, offs: torch.Tensor, valid_len: int,
                        idx: int, rope_tables):
    """One prefill chunk through one block: x (B, T, d) at positions
    ``offset + i``; the block's cache (positions ``< offset``) gets the
    chunk's KV in place."""
    h = layers.apply_norm(cfg, p["norm_1"], x)
    out = attn.prefill_chunk_self_attention(
        cfg, p["mixer"], h, cache, offset, offs, valid_len, rope_tables,
        window=layer_window(cfg, idx))
    return _tail(cfg, p, x, out)


def prefill_block_cache(cfg: ModelConfig, idx: int, kv, max_len: int,
                        dtype: torch.dtype = torch.bfloat16
                        ) -> Dict[str, torch.Tensor]:
    """Layer ``idx``'s decode cache from the (k, v) that ``block_forward``
    collected over a whole prompt (kind "A" only)."""
    if layer_kind(cfg, idx) != "A":
        raise NotImplementedError(f"{cfg.name}: block kind of layer {idx} "
                                  "comes with the other-archs slice")
    k, v = kv
    return attn.prefill_kv_cache(cfg, k, v, max_len,
                                 window=layer_window(cfg, idx), dtype=dtype)


# -- paged decode / prefill (page pools + page tables) --------------------------

def init_paged_block_cache(cfg: ModelConfig, idx: int, num_pages: int,
                           page_size: int,
                           dtype: torch.dtype = torch.bfloat16,
                           device=None) -> Dict[str, torch.Tensor]:
    """Layer ``idx``'s page pools, on the card unless ``device="cpu"``.
    Only attention layers (kind "A") page: state blocks carry O(1)
    recurrent state and encoder-decoder blocks a one-shot cross cache."""
    if layer_kind(cfg, idx) != "A":
        raise ValueError(f"layer {idx} (kind {layer_kind(cfg, idx)!r}) "
                         "has no paged cache layout")
    return attn.init_paged_kv_pools(cfg, num_pages, page_size, dtype=dtype,
                                    device=device)


def block_paged_decode(cfg: ModelConfig, p, x: torch.Tensor, cache,
                       cur_len: torch.Tensor, page_table: torch.Tensor,
                       idx: int, rope_tables):
    """One-token decode through one block against paged pools, which are
    updated in place.  x: (B, 1, d); cur_len: (B,); page_table: (B, NB)."""
    h = layers.apply_norm(cfg, p["norm_1"], x)
    out = attn.paged_decode_self_attention(
        cfg, p["mixer"], h, cache, cur_len, page_table, rope_tables,
        window=layer_window(cfg, idx))
    return _tail(cfg, p, x, out)


def block_paged_prefill_chunk(cfg: ModelConfig, p, x: torch.Tensor, cache,
                              offs: torch.Tensor, valid_len: torch.Tensor,
                              page_table: torch.Tensor, idx: int,
                              rope_tables):
    """One prefill chunk through one block against paged pools: x
    (B, T, d); offs/valid_len: (B,); page_table: (B, NB)."""
    h = layers.apply_norm(cfg, p["norm_1"], x)
    out = attn.paged_prefill_chunk_self_attention(
        cfg, p["mixer"], h, cache, offs, valid_len, page_table, rope_tables,
        window=layer_window(cfg, idx))
    return _tail(cfg, p, x, out)
