"""Per-layer block assembly: the attention + MLP block (kind "A").

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
        "mtp": (cfg.mtp, "the train slice"),
        "kv_quant": (cfg.kv_quant is not None, "the quantized-cache slice"),
        "dense decode attention": (
            cfg.decode_attn_impl not in ("auto", "flash"),
            "no slice: decode attention always runs the flash kernel"),
    }
    for name, (hit, where) in later.items():
        if hit:
            raise NotImplementedError(f"{cfg.name}: {name} is not ported "
                                      f"yet; it comes with {where}")


def layer_window(cfg: ModelConfig, idx: int) -> Optional[int]:
    """Sliding-window size for this layer (local/global layer pattern)."""
    if cfg.layer_pattern and cfg.sliding_window:
        kind = cfg.layer_pattern[idx % len(cfg.layer_pattern)]
        return cfg.sliding_window if kind == "L" else None
    return cfg.sliding_window


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


def block_decode(cfg: ModelConfig, p, x: torch.Tensor, cache,
                 cur_len: torch.Tensor, idx: int, rope_tables):
    """One-token decode through one block; x: (B, 1, d), cur_len: (B,).
    The block's cache is updated in place."""
    h = layers.apply_norm(cfg, p["norm_1"], x)
    out = attn.decode_self_attention(cfg, p["mixer"], h, cache, cur_len,
                                     rope_tables,
                                     window=layer_window(cfg, idx))
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
