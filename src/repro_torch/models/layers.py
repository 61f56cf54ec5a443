"""Shared layers: RMS norm, SwiGLU MLP, embeddings, RoPE, softcap.

PyTorch counterparts of the JAX package's ``models/layers.py`` for the
dense GQA path.  Weights live in plain dicts of tensors under the JAX
names; initialisers draw from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig


def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype name ("bfloat16", "float32", ...) as a torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


# -- init helpers ------------------------------------------------------------

def dense_init(gen: torch.Generator, shape: Tuple[int, ...],
               in_axis=0) -> torch.Tensor:
    """Truncated-normal fan-in init, as the JAX package's ``dense_init``:
    a standard normal cut at +-2, times 1/sqrt(fan_in)."""
    fan_in = shape[in_axis] if isinstance(in_axis, int) else \
        math.prod(shape[a] for a in in_axis)
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w.mul_(1.0 / math.sqrt(max(1, fan_in)))


def embed_init(gen: torch.Generator, shape: Tuple[int, ...]) -> torch.Tensor:
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    return w.normal_(0.0, 1.0, generator=gen).mul_(0.02)


# -- norms ---------------------------------------------------------------------

def init_norm(cfg: ModelConfig, device):
    if cfg.norm_type != "rmsnorm" or cfg.norm_bf16_io:
        raise NotImplementedError(
            f"norm_type {cfg.norm_type!r} (bf16 io {cfg.norm_bf16_io}) "
            "comes with the other-archs slice")
    return {"scale": torch.ones((cfg.d_model,), dtype=torch.float32,
                                device=device)}


def apply_norm(cfg: ModelConfig, p, x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """RMS norm with an fp32 body: statistics, scale and product in fp32,
    the result cast back to x's dtype."""
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    return (y * p["scale"].float()).to(x.dtype)


# -- softcap -------------------------------------------------------------------

def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


# -- MLP -----------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg: ModelConfig,
             ff: Optional[int] = None):
    """SwiGLU weights of width ``ff`` (default ``cfg.d_ff``)."""
    if cfg.act != "silu":
        raise NotImplementedError(f"act {cfg.act!r} comes with the "
                                  "other-archs slice")
    d, ff = cfg.d_model, ff or cfg.d_ff
    return {"w_up": dense_init(gen, (d, ff)),
            "w_down": dense_init(gen, (ff, d)),
            "w_gate": dense_init(gen, (d, ff))}


def apply_mlp(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: silu(x @ w_gate) * (x @ w_up), then @ w_down."""
    dt = x.dtype
    up = x @ p["w_up"].to(dt)
    up = F.silu(x @ p["w_gate"].to(dt)) * up
    return up @ p["w_down"].to(dt)


# -- embedding / head ------------------------------------------------------------

def init_embedding(gen: torch.Generator, cfg: ModelConfig):
    p = {"embedding": embed_init(gen, (cfg.vocab_size, cfg.d_model))}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size))
    return p


def embed_tokens(cfg: ModelConfig, p, tokens: torch.Tensor) -> torch.Tensor:
    x = p["embedding"][tokens].to(torch_dtype(cfg.dtype))
    if cfg.scale_embeddings:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def logits_from_hidden(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """fp32 logits; tied embeddings reuse the embedding matrix."""
    if cfg.tie_embeddings:
        logits = x @ p["embedding"].to(x.dtype).T
    else:
        logits = x @ p["lm_head"].to(x.dtype)
    return softcap(logits.float(), cfg.final_softcap)


# -- RoPE ----------------------------------------------------------------------------

def default_positions(batch: int, seq: int, offset=0,
                      device=None) -> torch.Tensor:
    """(B, S) int32 positions ``offset + arange(S)`` for every row."""
    pos = torch.arange(seq, dtype=torch.int32, device=device) + offset
    return pos[None].expand(batch, seq)


def rope_dim(cfg: ModelConfig) -> int:
    """The width RoPE rotates: ``head_dim``, or MLA's decoupled rope key
    ``qk_rope_head_dim``."""
    return cfg.mla.qk_rope_head_dim if cfg.attention == "mla" \
        else cfg.head_dim


def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin), each (B, S, 1, hd/2) fp32, for positions (B, S).  The
    model builds them once per step and shares them across layers."""
    inv = rope_frequencies(head_dim, theta, positions.device)
    angles = positions.float()[..., None] * inv
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def apply_rope(x: torch.Tensor, tables) -> torch.Tensor:
    """Rotary embedding, half-split (not interleaved), with fp32 angles.

    x: (B, S, H, hd); ``tables``: :func:`rope_tables` of its positions.
    """
    cos, sin = tables
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
