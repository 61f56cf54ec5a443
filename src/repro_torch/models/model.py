"""Top-level model for the serve path: params, caches, serve steps.

Layer stacks are organised as *units*, the repeating pattern of the
architecture (one layer for dense archs, the local/global pair for a
"LG" pattern), as in the JAX package.  Unit parameters and caches are
stacked on a leading layer axis — always, even for a single unit — so
``params["units"]["r0"]["mixer"]["wq"]`` is (n_units, d, H, hd) and a
layer's cache ``caches["units"]["r0"]["k"][u]`` is a contiguous
(B, C, KVH, hd) view that the kernels update in place.

Entry points:
  init_params(cfg, seed, device)          -> parameter tree (fp32)
  serving_params(cfg, params, device)     -> the tree on the device,
                                             weight matrices in cfg.dtype
  init_caches(cfg, batch, max_len, ...)   -> decode caches
  make_serve_fns(cfg)                     -> ServeFns(decode, prefill_chunk)

The whole-prompt ``prefill`` of the JAX package feeds only the blocking
``prefill_chunk=0`` admission baseline and comes with a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import blocks, layers


@dataclasses.dataclass(frozen=True)
class UnitLayout:
    unit_len: int
    n_units: int


def unit_layout(cfg: ModelConfig) -> UnitLayout:
    blocks.check_supported(cfg)
    ul = len(cfg.layer_pattern) if cfg.layer_pattern else 1
    if cfg.num_layers % ul:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers not divisible "
                         f"by unit pattern length {ul}")
    return UnitLayout(ul, cfg.num_layers // ul)


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def unit_slice(tree, u: int):
    """Unit ``u``'s slice of a stacked params or cache tree (views)."""
    if isinstance(tree, dict):
        return {k: unit_slice(v, u) for k, v in tree.items()}
    return tree[u]


# -- params ------------------------------------------------------------------------

def init_params(cfg: ModelConfig, seed: int = 0, device=None):
    """Random fp32 parameters from ``torch.Generator(seed)``, on the card
    unless ``device="cpu"``.  The numbers differ from the JAX package's
    for the same seed (different generators); ``repro_torch.bridge``
    carries a JAX tree over where equal weights are needed."""
    dev = resolve_device(device)
    lay = unit_layout(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    units = [{f"r{r}": blocks.init_block(gen, cfg)
              for r in range(lay.unit_len)} for _ in range(lay.n_units)]
    return {"embed": layers.init_embedding(gen, cfg),
            "final_norm": layers.init_norm(cfg, dev),
            "units": _stack(units)}


def serving_params(cfg: ModelConfig, params, device=None):
    """The tree on ``device`` with every weight matrix cast once to the
    compute dtype ``cfg.dtype``; norm scales stay fp32.  The model casts
    weights to the activation dtype at each use, as the JAX package
    does; casting once up front gives the same numbers without a cast
    every step."""
    dev = resolve_device(device)
    dt = layers.torch_dtype(cfg.dtype)

    def cast(tree, keep: bool):
        if isinstance(tree, dict):
            return {k: cast(v, keep or k.startswith(
                ("norm", "final_norm", "post_norm"))) for k, v in tree.items()}
        return tree.to(dev) if keep else tree.to(device=dev, dtype=dt)

    return cast(params, False)


# -- caches --------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, batch_size: int, max_len: int,
                dtype: torch.dtype = torch.bfloat16, device=None):
    """Decode caches {"units": {"r<i>": {"k", "v"}}}, each leaf
    (n_units, B, C, KVH, hd), zero-filled, on the card unless
    ``device="cpu"``."""
    dev = resolve_device(device)
    lay = unit_layout(cfg)
    per_unit = [{f"r{r}": blocks.init_block_cache(
        cfg, r, batch_size, max_len, dtype, dev)
        for r in range(lay.unit_len)} for _ in range(lay.n_units)]
    return {"units": _stack(per_unit)}


# -- serve steps -----------------------------------------------------------------------

class ServeFns(NamedTuple):
    """The two serve steps of the continuous-batching engine."""

    decode: Any
    prefill_chunk: Any


def make_serve_fns(cfg: ModelConfig) -> ServeFns:
    """Returns ``ServeFns(decode, prefill_chunk)``.

    decode(params, caches, tokens (B, 1), cur_len) -> logits (B, V)
    prefill_chunk(params, caches, tokens (B, T), offset, last_idx)
        -> logits (B, V) at ``last_idx``

    Both update ``caches`` in place.  ``cur_len`` is an int (every row
    at one position) or a (B,) int tensor of per-slot positions: each
    row's new KV lands at its own slot through the ``cache_update``
    kernel, and decode attention reads each row's valid prefix only.
    ``prefill_chunk`` resumes prefill from a partial cache: the chunk's
    tokens sit at positions ``offset + i`` (``offset`` an int or a (B,)
    tensor), attend the cache prefix plus their own causal keys through
    the ``prefill_attention`` kernel, and write their KV into the cache.
    ``last_idx`` marks the chunk's last real token; the positions past
    it are right-padding whose outputs are discarded.
    """
    lay = unit_layout(cfg)

    def run_units(params, caches, x, step):
        for u in range(lay.n_units):
            up = unit_slice(params["units"], u)
            uc = unit_slice(caches["units"], u)
            for r in range(lay.unit_len):
                x = step(up[f"r{r}"], x, uc[f"r{r}"], u * lay.unit_len + r)
        return x

    def decode_step(params, caches, tokens: torch.Tensor,
                    cur_len: Union[int, torch.Tensor]) -> torch.Tensor:
        b = tokens.shape[0]
        cur = torch.as_tensor(cur_len, dtype=torch.int32,
                              device=tokens.device)
        if cur.dim() == 0:
            cur = cur.expand(b)
        cur = cur.contiguous()
        tables = layers.rope_tables(cur[:, None], cfg.head_dim,
                                    cfg.rope_theta)
        x = layers.embed_tokens(cfg, params["embed"], tokens)
        x = run_units(params, caches, x, lambda p, xx, c, idx:
                      blocks.block_decode(cfg, p, xx, c, cur, idx, tables))
        x = layers.apply_norm(cfg, params["final_norm"], x)
        return layers.logits_from_hidden(cfg, params["embed"], x)[:, 0]

    def prefill_chunk(params, caches, tokens: torch.Tensor,
                      offset: Union[int, torch.Tensor],
                      last_idx: int) -> torch.Tensor:
        b, t = tokens.shape
        dev = tokens.device
        offs = torch.as_tensor(offset, dtype=torch.int32, device=dev)
        offs = (offs.expand(b) if offs.dim() == 0 else offs).contiguous()
        positions = offs[:, None] + torch.arange(t, device=dev,
                                                 dtype=torch.int32)
        tables = layers.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        valid_len = int(last_idx) + 1
        x = layers.embed_tokens(cfg, params["embed"], tokens)
        x = run_units(params, caches, x, lambda p, xx, c, idx:
                      blocks.block_prefill_chunk(cfg, p, xx, c, offset, offs,
                                                 valid_len, idx, tables))
        x = layers.apply_norm(cfg, params["final_norm"], x)
        x_last = x[:, int(last_idx):int(last_idx) + 1]
        return layers.logits_from_hidden(cfg, params["embed"], x_last)[:, 0]

    return ServeFns(decode_step, prefill_chunk)
