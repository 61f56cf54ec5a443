"""Top-level model: params, the full-sequence forward and loss (train
path), caches and serve steps.

Layer stacks are organised as *units*, the repeating pattern of the
architecture (one layer for dense archs, the local/global pair for a
"LG" pattern), as in the JAX package.  Unit parameters and caches are
stacked on a leading layer axis — always, even for a single unit — so
``params["units"]["r0"]["mixer"]["wq"]`` is (n_units, d, H, hd) and a
layer's cache ``caches["units"]["r0"]["k"][u]`` is a contiguous
(B, C, KVH, hd) view that the kernels update in place.

Entry points:
  init_params(cfg, seed, device)          -> parameter tree (fp32)
  build_forward(cfg)                      -> forward(params, batch)
                                             -> (hidden (B, S, d), aux)
  loss_fn(cfg)                            -> loss(params, batch)
                                             -> (scalar, metrics)
  serving_params(cfg, params, device)     -> the tree on the device,
                                             weight matrices in cfg.dtype
  init_caches(cfg, batch, max_len, ...)   -> decode caches
  make_serve_fns(cfg, cache_dtype)        -> ServeFns(prefill, decode,
                                                      prefill_chunk)
  init_paged_caches(cfg, pages, ps, ...)  -> page pools
  make_paged_serve_fns(cfg)               -> PagedServeFns(decode,
                                                           prefill_chunk)

The full-sequence forward runs the stacked units in a Python loop, each
unit under ``torch.utils.checkpoint`` when ``cfg.remat`` asks for it
(``"full"``: recompute everything; ``"dots"``: save the matrix
products, as ``jax.checkpoint_policies.checkpoint_dots``), with the
attention impl of ``blocks.attn_impl`` (``"pallas"``: the
flash-attention kernel).  The loss is the JAX package's chunked
cross-entropy over the tied head.  The serve steps' whole-prompt
``prefill`` runs the same forward, collecting each layer's k and v into
its decode cache, and feeds the blocking ``prefill_chunk=0`` admission
and the wave baseline.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, NamedTuple, Union

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import blocks, layers
from repro_torch.tree import tree_leaves, tree_map


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
    return tree_map(lambda *ts: torch.stack(ts), *trees)


def unit_slice(tree, u: int):
    """Unit ``u``'s slice of a stacked params or cache tree (views)."""
    if isinstance(tree, dict):
        return {k: unit_slice(v, u) for k, v in tree.items()}
    return tree[u]


def reference_layout(cfg: ModelConfig, tree):
    """A parameter-shaped tree as the JAX package lays it out: with a
    single unit the JAX package does not stack, so the units lose the
    port's leading unit axis (views of the same tensors).  Shape-driven
    rules (weight decay on ``ndim >= 2``, Adafactor's factoring) and the
    checkpoint layout read this view."""
    if unit_layout(cfg).n_units == 1:
        return dict(tree, units=unit_slice(tree["units"], 0))
    return tree


def port_layout(cfg: ModelConfig, tree):
    """The inverse of :func:`reference_layout` (views)."""
    if unit_layout(cfg).n_units == 1:
        return dict(tree, units=tree_map(lambda t: t[None], tree["units"]))
    return tree


# -- params ------------------------------------------------------------------------

def init_params(cfg: ModelConfig, seed: int = 0, device=None):
    """Random fp32 parameters from ``torch.Generator(seed)``, on the card
    unless ``device="cpu"``; with ``cfg.mtp`` also the JAX package's
    ``mtp`` subtree (read by its loss alone).  The numbers differ from
    the JAX package's for the same seed (different generators);
    ``repro_torch.bridge`` carries a JAX tree over where equal weights
    are needed."""
    dev = resolve_device(device)
    lay = unit_layout(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    units = [{f"r{r}": blocks.init_block(gen, cfg)
              for r in range(lay.unit_len)} for _ in range(lay.n_units)]
    params = {"embed": layers.init_embedding(gen, cfg),
              "final_norm": layers.init_norm(cfg, dev),
              "units": _stack(units)}
    if cfg.mtp:     # DeepSeek's multi-token prediction head (the loss's)
        params["mtp"] = {
            "proj": layers.dense_init(gen, (2 * cfg.d_model, cfg.d_model)),
            "block": blocks.init_block(gen, cfg),
            "norm": layers.init_norm(cfg, dev)}
    return params


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


# -- full-sequence forward and loss ---------------------------------------------------

def _positions(cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """(B, S) positions of the batch's tokens (M-RoPE's comes with
    qwen2-vl)."""
    b, s = batch["tokens"].shape
    return layers.default_positions(b, s, device=batch["tokens"].device)


def _input_embed(cfg: ModelConfig, params, batch):
    """The tokens' embeddings (patch and frame inputs come with the
    archs that take them)."""
    return layers.embed_tokens(cfg, params["embed"], batch["tokens"])


def _unstack(tree, n: int):
    """The n unit trees of a stacked tree (views through one ``unbind``
    per leaf, so the backward stacks the units' grads in one step)."""
    parts = tree_map(lambda t: t.unbind(0), tree)
    return [tree_map(lambda p: p[u], parts) for u in range(n)]


_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default}


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _run_stack(cfg: ModelConfig, unit_params, n_units: int, unit_fn, x,
               aux):
    """The full-sequence twin of the JAX ``_run_units``: ``unit_fn(x,
    unit_tree) -> (x, aux)`` over the stacked units in a Python loop,
    summing aux.  With ``cfg.remat`` "full" or "dots" and more than one
    unit, each unit runs under ``torch.utils.checkpoint`` (non-reentrant;
    "dots" keeps the matrix products and recomputes the rest)."""
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat {cfg.remat!r}")
    remat = cfg.remat != "none" and n_units > 1
    kw = {}
    if remat and cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)
    for up in _unstack(unit_params, n_units):
        if remat:
            x, a = ckpt.checkpoint(unit_fn, x, up, use_reentrant=False, **kw)
        else:
            x, a = unit_fn(x, up)
        aux = aux + a
    return x, aux


def build_forward(cfg: ModelConfig):
    """Returns forward(params, batch) -> (hidden (B, S, d), aux_loss).

    ``batch["tokens"]`` is (B, S) on the device the params live on; the
    RoPE tables are built once and shared by every layer."""
    lay = unit_layout(cfg)

    def forward(params, batch):
        x = _input_embed(cfg, params, batch)
        pos = _positions(cfg, batch)
        tables = layers.rope_tables(pos, layers.rope_dim(cfg),
                                    cfg.rope_theta)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)

        def unit(xx, up):
            a_sum = torch.zeros((), dtype=torch.float32, device=xx.device)
            for r in range(lay.unit_len):
                xx, a, _ = blocks.block_forward(cfg, up[f"r{r}"], xx, pos, r,
                                                rope_tables=tables)
                a_sum = a_sum + a
            return xx, a_sum

        x, aux = _run_stack(cfg, params["units"], lay.n_units, unit, x, aux)
        return layers.apply_norm(cfg, params["final_norm"], x), aux

    return forward


def _xent_chunk(cfg: ModelConfig, embed_params, h, targets):
    """Summed NLL over one chunk and its count of real targets.
    h: (B, C, d), targets: (B, C) with -1 for padding."""
    logits = layers.logits_from_hidden(cfg, embed_params, h)   # fp32
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.clamp(targets, min=0).long()
    picked = torch.gather(logits, -1, tgt[..., None])[..., 0]
    valid = (targets >= 0).float()
    nll = (lse - picked) * valid
    return nll.sum(), valid.sum()


def _chunked_xent(cfg: ModelConfig, embed_params, hidden, targets):
    s = hidden.shape[1]
    ck = cfg.loss_chunk or s
    nb = math.ceil(s / ck)
    remat = nb > 1 and cfg.remat != "none"
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(nb):
        args = (cfg, embed_params, hidden[:, i * ck:(i + 1) * ck],
                targets[:, i * ck:(i + 1) * ck])
        t, c = ckpt.checkpoint(_xent_chunk, *args, use_reentrant=False) \
            if remat else _xent_chunk(*args)
        total = total + t
        count = count + c
    return total / torch.clamp(count, min=1.0)


def loss_fn(cfg: ModelConfig):
    """Returns loss(params, batch) -> (scalar, metrics dict) with metrics
    ``nll``, ``aux_loss`` and ``loss`` (0-dim tensors).  DeepSeek's
    multi-token-prediction loss (``cfg.mtp``) comes with a later slice
    and raises."""
    if cfg.mtp:
        raise NotImplementedError(f"{cfg.name}: the MTP loss is not ported "
                                  "yet; it comes with the MoE slice")
    forward = build_forward(cfg)

    def loss(params, batch):
        hidden, aux = forward(params, batch)
        nll = _chunked_xent(cfg, params["embed"], hidden, batch["targets"])
        return nll, {"nll": nll, "aux_loss": aux, "loss": nll}

    return loss


# -- caches --------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, batch_size: int, max_len: int,
                dtype: torch.dtype = torch.bfloat16, device=None):
    """Decode caches {"units": {"r<i>": {"k", "v"}}}, each leaf
    (n_units, B, C, KVH, hd), zero-filled, on the card unless
    ``device="cpu"``.  With ``cfg.kv_quant`` k and v hold codes and each
    block also carries (n_units, B, C, KVH) float32 "k_scale" and
    "v_scale" leaves.  An MLA block's cache is one "kv" latent leaf
    (n_units, B, C, r + rope), with ``cfg.kv_quant`` codes plus an
    (n_units, B, C) "kv_scale"."""
    dev = resolve_device(device)
    lay = unit_layout(cfg)
    per_unit = [{f"r{r}": blocks.init_block_cache(
        cfg, r, batch_size, max_len, dtype, dev)
        for r in range(lay.unit_len)} for _ in range(lay.n_units)]
    return {"units": _stack(per_unit)}


# -- serve steps -----------------------------------------------------------------------

def _run_units(lay: UnitLayout, params, caches, x, step):
    """Run ``step(block_params, x, block_cache, layer_idx)`` over every
    layer, unit by unit; each block's cache is updated in place."""
    for u in range(lay.n_units):
        up = unit_slice(params["units"], u)
        uc = unit_slice(caches["units"], u)
        for r in range(lay.unit_len):
            x = step(up[f"r{r}"], x, uc[f"r{r}"], u * lay.unit_len + r)
    return x


class ServeFns(NamedTuple):
    """The serve steps of the engine (see :func:`make_serve_fns`)."""

    prefill: Any
    decode: Any
    prefill_chunk: Any


def make_serve_fns(cfg: ModelConfig,
                   cache_dtype: torch.dtype = torch.bfloat16) -> ServeFns:
    """Returns ``ServeFns(prefill, decode, prefill_chunk)``.

    prefill(params, batch, max_len) -> (logits (B, V) at the last
        position, caches)
    decode(params, caches, tokens (B, 1), cur_len) -> logits (B, V)
    prefill_chunk(params, caches, tokens (B, T), offset, last_idx)
        -> logits (B, V) at ``last_idx``

    ``prefill`` runs the whole prompt ``batch["tokens"]`` (B, S) at
    positions 0..S-1 through the full-sequence forward with the attention
    impl of ``blocks.attn_impl`` (``"pallas"``: the flash-attention
    kernel), and builds (B, max_len) caches of ``cache_dtype`` (codes and
    scales with ``cfg.kv_quant``) from each layer's k and v.  Logits are
    computed at the last position only.
    ``decode`` and ``prefill_chunk`` update ``caches`` in place.
    ``cur_len`` is an int (every row
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
    run_units = functools.partial(_run_units, lay)

    def prefill(params, batch, max_len: int):
        x = _input_embed(cfg, params, batch)
        pos = _positions(cfg, batch)
        tables = layers.rope_tables(pos, layers.rope_dim(cfg),
                                    cfg.rope_theta)
        per_unit = []
        for u in range(lay.n_units):
            up = unit_slice(params["units"], u)
            uc = {}
            for r in range(lay.unit_len):
                x, _, kv = blocks.block_forward(cfg, up[f"r{r}"], x, pos, r,
                                                collect_kv=True,
                                                rope_tables=tables)
                uc[f"r{r}"] = blocks.prefill_block_cache(
                    cfg, r, kv, max_len, dtype=cache_dtype)
            per_unit.append(uc)
        x = layers.apply_norm(cfg, params["final_norm"], x[:, -1:])
        logits = layers.logits_from_hidden(cfg, params["embed"], x)
        return logits[:, 0], {"units": _stack(per_unit)}

    def decode_step(params, caches, tokens: torch.Tensor,
                    cur_len: Union[int, torch.Tensor]) -> torch.Tensor:
        b = tokens.shape[0]
        cur = torch.as_tensor(cur_len, dtype=torch.int32,
                              device=tokens.device)
        if cur.dim() == 0:
            cur = cur.expand(b)
        cur = cur.contiguous()
        tables = layers.rope_tables(cur[:, None], layers.rope_dim(cfg),
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
        tables = layers.rope_tables(positions, layers.rope_dim(cfg),
                                    cfg.rope_theta)
        valid_len = int(last_idx) + 1
        x = layers.embed_tokens(cfg, params["embed"], tokens)
        x = run_units(params, caches, x, lambda p, xx, c, idx:
                      blocks.block_prefill_chunk(cfg, p, xx, c, offset, offs,
                                                 valid_len, idx, tables))
        x = layers.apply_norm(cfg, params["final_norm"], x)
        x_last = x[:, int(last_idx):int(last_idx) + 1]
        return layers.logits_from_hidden(cfg, params["embed"], x_last)[:, 0]

    return ServeFns(prefill, decode_step, prefill_chunk)


# -- serve: paged caches -------------------------------------------------------------

def supports_paged(cfg: ModelConfig) -> bool:
    """Whether this arch can serve from paged KV pools: every layer must
    be kind "A".  State archs carry O(1) recurrent state — nothing to
    page — and encoder-decoder archs a one-shot cross cache; such archs
    keep the contiguous layout."""
    if cfg.is_encoder_decoder or cfg.pos_embed == "sinusoidal":
        return False
    return all(blocks.layer_kind(cfg, i) == "A"
               for i in range(cfg.num_layers))


def init_paged_caches(cfg: ModelConfig, num_pages: int, page_size: int,
                      dtype: torch.dtype = torch.bfloat16, device=None):
    """Page pools with :func:`init_caches`'s tree shape: each leaf
    (n_units, P, page_size, KVH, hd) instead of (n_units, B, C, KVH, hd),
    zero-filled, on the card unless ``device="cpu"``; with
    ``cfg.kv_quant`` also (n_units, P, page_size, KVH) scale pools.
    Every leaf shares one page-id space; page 0 is scratch."""
    if not supports_paged(cfg):
        raise ValueError(f"{cfg.name}: arch does not support paged KV "
                         "(needs all-attention layers, no encoder)")
    dev = resolve_device(device)
    lay = unit_layout(cfg)
    per_unit = [{f"r{r}": blocks.init_paged_block_cache(
        cfg, r, num_pages, page_size, dtype, dev)
        for r in range(lay.unit_len)} for _ in range(lay.n_units)]
    return {"units": _stack(per_unit)}


def paged_page_axes(cfg: ModelConfig) -> list:
    """The page axis of each leaf of :func:`init_paged_caches`, in
    ``tree_leaves`` order: the stacked units' axis, then the leaf's shape
    as ``blocks.cache_leaf_specs`` gives it for the lead (P, page_size).
    The engine's swap path gathers and scatters pages along it."""
    lead = ("pages", "page_size")
    per_unit = {f"r{r}": {name: 1 + shape.index("pages") for name, (shape, _)
                          in blocks.cache_leaf_specs(cfg, r, lead).items()}
                for r in range(unit_layout(cfg).unit_len)}
    return tree_leaves({"units": per_unit})


class PagedServeFns(NamedTuple):
    """The two paged serve steps (see :func:`make_paged_serve_fns`)."""

    decode: Any
    prefill_chunk: Any


def make_paged_serve_fns(cfg: ModelConfig) -> PagedServeFns:
    """Returns ``PagedServeFns(decode, prefill_chunk)``.

    decode(params, caches, tokens (B, 1), cur_len (B,), page_table)
        -> logits (B, V)
    prefill_chunk(params, caches, tokens (B, T), offset (B,),
                  last_idx (B,), page_table) -> logits (B, V)

    ``caches`` are :func:`init_paged_caches` pools, updated in place;
    ``page_table`` is (B, NB) int32 mapping each slot's logical blocks to
    physical pages (rows the scheduler masks to 0 touch only the scratch
    page).  Paged serving is always continuous, so ``cur_len`` and
    ``offset`` are per-row vectors, and — unlike the contiguous
    ``prefill_chunk`` — ``last_idx`` is a (B,) vector too: one (B, T)
    dispatch advances several requests' chunks, each row at its own
    offset with its own fill.  Rows with ``last_idx == -1`` are
    passengers (idle or decoding): their valid length is 0, so they
    write nothing, and their logits row is garbage the caller discards.
    """
    if not supports_paged(cfg):
        raise ValueError(f"{cfg.name}: arch does not support paged KV "
                         "(needs all-attention layers, no encoder)")
    run_units = functools.partial(_run_units, unit_layout(cfg))

    def vector(x, b: int, dev) -> torch.Tensor:
        t = torch.as_tensor(x, dtype=torch.int32, device=dev)
        return (t.expand(b) if t.dim() == 0 else t).contiguous()

    def decode(params, caches, tokens: torch.Tensor, cur_len,
               page_table: torch.Tensor) -> torch.Tensor:
        b, dev = tokens.shape[0], tokens.device
        cur = vector(cur_len, b, dev)
        pt = page_table.to(device=dev, dtype=torch.int32).contiguous()
        tables = layers.rope_tables(cur[:, None], layers.rope_dim(cfg),
                                    cfg.rope_theta)
        x = layers.embed_tokens(cfg, params["embed"], tokens)
        x = run_units(params, caches, x, lambda p, xx, c, idx:
                      blocks.block_paged_decode(cfg, p, xx, c, cur, pt, idx,
                                                tables))
        x = layers.apply_norm(cfg, params["final_norm"], x)
        return layers.logits_from_hidden(cfg, params["embed"], x)[:, 0]

    def prefill_chunk(params, caches, tokens: torch.Tensor, offset,
                      last_idx, page_table: torch.Tensor) -> torch.Tensor:
        b, t = tokens.shape
        dev = tokens.device
        offs = vector(offset, b, dev)
        last = vector(last_idx, b, dev)
        valid_len = torch.clamp(last + 1, min=0)
        pt = page_table.to(device=dev, dtype=torch.int32).contiguous()
        positions = offs[:, None] + torch.arange(t, device=dev,
                                                 dtype=torch.int32)
        tables = layers.rope_tables(positions, layers.rope_dim(cfg),
                                    cfg.rope_theta)
        x = layers.embed_tokens(cfg, params["embed"], tokens)
        x = run_units(params, caches, x, lambda p, xx, c, idx:
                      blocks.block_paged_prefill_chunk(cfg, p, xx, c, offs,
                                                       valid_len, pt, idx,
                                                       tables))
        x = layers.apply_norm(cfg, params["final_norm"], x)
        # each row's last real token (passengers read position 0)
        idx = torch.clamp(last, 0, t - 1).long()
        x_last = x[torch.arange(b, device=dev), idx][:, None]   # (B, 1, d)
        return layers.logits_from_hidden(cfg, params["embed"], x_last)[:, 0]

    return PagedServeFns(decode, prefill_chunk)
