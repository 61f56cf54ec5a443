"""Continuous-batching serve engine with chunked prefill, and its
baselines.

The PyTorch counterpart of the JAX package's ``serve/engine.py``: its
main mode, ``mode="continuous"`` with chunked admission, and the
baselines that mode is measured against: blocking bucketed admission
(``prefill_chunk=0``), synchronized waves (``mode="wave"``), sampled
decoding (``greedy=False``) and the dense decode attention
(``decode_attn_impl="dense"``).

Every batch slot carries its own position counter; one decode step
advances all live slots at their own offsets (per-row KV scatter through
the ``cache_update`` kernel), and a slot whose request finishes is
refilled from the queue on the next step.  Admission is chunked prefill
interleaved with decode: a request's prompt is processed
``prefill_chunk`` tokens at a time, each chunk attending its request's
already-written cache prefix plus its own causal keys through the
``prefill_attention`` kernel, one chunk per decode step while other
requests decode.  With no admission work pending, decode runs on the
device until the next slot retires (one host sync per retirement, not
per token).

Caches are updated **in place**: the decode scatter, the chunk write
into a request's batch-1 cache row, and the insert of that row into the
live batch (an indexed ``copy_``).  The JAX engine donated the buffers
to its jitted steps instead.  The port runs eagerly, so
``compile_counts`` keeps the JAX keys but stays 0.

PMT integration, as in the JAX engine: each admitted request opens a
flat ``serve/req<N>`` span (``nested=False``) closed right after the
fenced step that produced its last token, plus ``serve/req<N>/prefill``
(admission to the last prefill chunk) and ``serve/req<N>/decode``
(first to last decode token) tiling it; the whole ``generate()`` call is
one ``serve/batch<N>`` region counting the generated tokens.  Spans
open through a duck-typed ``session.region(label, tokens=,
nested=False)`` or ``monitor.measure_request`` / ``measure_step``.

``kv_layout="paged"`` serves from page pools instead (``_run_paged``):
one (P, page_size, KVH, hd) pool per cache leaf, allocated once by the
constructor and kept across ``generate()`` calls, per-slot page tables,
a radix prefix tree that maps retired prompts' pages copy-free into new
requests (``serve/paging.py``), every pending admission's chunk batched
into one (B, chunk) dispatch, and a masked page table for decode.  The
three paged kernels carry it: ``paged_cache_update``,
``decode_attention_paged``, ``prefill_attention_paged``.

``cache_dtype="int8"`` or ``"fp8_e4m3"`` quantizes the KV cache in
either layout, as the JAX engine does: it sets ``cfg.kv_quant``, every
cache leaf becomes low-bit codes plus one float32 absmax scale per
(position, kv head), decode writes go through the quantizing scatters
and the attention kernels dequantize inside.

``prefill_chunk=0`` admits a request by one blocking whole-prompt
prefill (``make_serve_fns``' ``prefill``) at its power-of-two bucket
(``prompt_bucket``), the prompt left-padded with token 0, which stays
in context at positions 0..bucket-plen-1 as in the JAX engine; the row
goes live at position ``bucket``.  ``mode="wave"`` serves batch-sized
waves: one prefill of the wave at its longest prompt's bucket, then
every row decodes the wave's most steps at one shared position (rows
past their own count, and unused rows, decode garbage).

``greedy=False`` samples every first token and decode token from
``softmax(logits / temperature)`` through one ``torch.Generator`` on the
engine's device, seeded with ``seed``: the Gumbel-max draw, on the
device, so a decode burst still syncs once.  JAX's PRNG streams cannot
be matched, so a seed gives its own stream, repeatable run to run.

Still to come, each with its slice (see ROADMAP.md), and refused here:
preemption and swap, and the power governor.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import os
import time
from typing import Any, Deque, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.quant import QUANT_MODES
from repro_torch.models import model as model_mod
from repro_torch.models.attention import kv_leaf_specs
from repro_torch.models.blocks import layer_window
from repro_torch.serve.paging import PagePool, RadixPrefixCache
from repro_torch.tree import tree_leaves


def stall_p95(events) -> float:
    """p95 of the engine's ``stall_events`` samples (nearest rank on the
    inclusive index), as the JAX engine reports it."""
    if not events:
        return 0.0
    xs = sorted(events)
    return float(xs[min(len(xs) - 1, int(round(0.95 * (len(xs) - 1))))])


def prompt_bucket(plen: int, min_bucket: int = 8) -> int:
    """A prompt length padded to its power-of-two bucket, at least
    ``min_bucket`` (itself a power of two): the blocking and wave
    prefills' shapes, at most log2(max_len) of them."""
    if plen < 1:
        raise ValueError("empty prompt")
    if min_bucket < 1 or (min_bucket & (min_bucket - 1)):
        raise ValueError(
            f"min_bucket must be a power of two >= 1, got {min_bucket}")
    b = min_bucket
    while b < plen:
        b <<= 1
    return b


def resolve_prefill_chunk(cfg: ModelConfig,
                          prefill_chunk: Optional[int]) -> int:
    """Engine arg beats the ``PMT_PREFILL_CHUNK`` env var beats
    ``cfg.prefill_chunk``; 0 is blocking whole-prompt admission."""
    if prefill_chunk is None:
        env = os.environ.get("PMT_PREFILL_CHUNK")
        prefill_chunk = int(env) if env else cfg.prefill_chunk
    if prefill_chunk < 0:
        raise ValueError(f"prefill_chunk must be >= 0, got {prefill_chunk}")
    return prefill_chunk


@dataclasses.dataclass
class Request:
    """One serve request: prompt in, ``out`` tokens back.

    ``finish_reason`` is None until served, then ``"length"`` (ran to
    ``max_new_tokens``) or ``"timeout"`` (past ``deadline_s``, measured
    from ``generate()`` submission; keeps the tokens generated so far).
    """

    prompt: Sequence[int]
    max_new_tokens: int
    out: List[int] = dataclasses.field(default_factory=list)
    id: Optional[int] = None        # assigned by the engine at admission
    tenant: Optional[str] = None    # recorded in engine.request_tenants
    deadline_s: Optional[float] = None
    finish_reason: Optional[str] = None


@dataclasses.dataclass
class _Prefill:
    """An admission mid-prefill: its slot is reserved and its batch-1
    cache row is being built, chunk by chunk (blocking admission: in one
    whole-prompt prefill, with no ``caches`` or ``toks`` kept here)."""

    req: Request
    slot: int
    caches: Any                     # batch-1 cache tree under construction
    toks: Optional[np.ndarray]      # (1, padded) right-padded prompt
    plen: int
    offset: int = 0


@dataclasses.dataclass
class _PagedPrefill:
    """An admission mid-chunked-prefill on the paged path: its slot and
    pages are reserved; chunks write straight into the shared pools
    through the slot's page-table row.  ``offset`` starts at
    ``matched_tokens`` when the radix prefix tree mapped cached pages
    in: prefill resumes from the match."""

    req: Request
    slot: int
    toks: np.ndarray                # (plen + chunk,) right-zero-padded
    plen: int
    offset: int
    matched_tokens: int = 0


class _Slots:
    """One ``generate()`` call's slot state, shared by both layouts'
    loops: the waiting queue, pending prefills, live decode rows, the
    deadlines, and each slot's ``serve/req<N>`` span with the
    ``/prefill`` and ``/decode`` spans that tile it.

    ``release(j, r, retired)`` is the layout's hook for slot j giving up
    request ``r``: ``retired`` is True when the request retires after
    decoding, False when it is dropped mid-prefill (deadline) or by an
    exception."""

    def __init__(self, eng: "ServeEngine", requests: List[Request],
                 release=None):
        b = eng.batch
        self.eng, self.b = eng, b
        self._release = release or (lambda j, r, retired: None)
        self.waiting = list(requests)
        self.prefills: Deque[Any] = collections.deque()
        self.reserved = [False] * b             # slot held by a prefill
        self.active: List[Optional[Request]] = [None] * b
        self.remaining = [0] * b
        self.tokens = np.zeros((b, 1), np.int64)
        self.pos = np.zeros((b,), np.int32)
        self.req_ctxs: List[Any] = [None] * b
        self.pf_ctxs: List[Any] = [None] * b
        self.dec_ctxs: List[Any] = [None] * b
        self.deadlines = {id(r): time.monotonic() + r.deadline_s
                          for r in requests if r.deadline_s is not None}

    def busy(self) -> bool:
        return bool(self.waiting or self.prefills or self.live())

    def free(self, j: int) -> bool:
        return self.active[j] is None and not self.reserved[j]

    def live(self) -> List[int]:
        return [j for j in range(self.b) if self.active[j] is not None]

    def _open(self, ctxs: List[Any], j: int, rid: int, tokens: int,
              phase: Optional[str] = None) -> None:
        ctxs[j] = self.eng._request_ctx(rid, tokens=tokens, phase=phase)
        ctxs[j].__enter__()

    @staticmethod
    def _close(ctxs: List[Any], j: int) -> None:
        if ctxs[j] is not None:
            ctxs[j].__exit__(None, None, None)
            ctxs[j] = None

    def admit(self, j: int, st, prefill_tokens: int) -> None:
        """``st`` prefills ``waiting[0]`` in slot j.  The slot is reserved
        before anything here can raise, so ``close_all`` releases what
        the layout committed to it."""
        self.reserved[j] = True
        r = self.eng._admit(self.waiting.pop(0))
        self._open(self.req_ctxs, j, r.id, r.max_new_tokens)
        self._open(self.pf_ctxs, j, r.id, prefill_tokens, phase="prefill")
        self.prefills.append(st)

    def go_live(self, st, first: int, next_pos: int) -> None:
        """``st`` finished prefill with ``first`` generated: its slot
        becomes a decode row.  The prefill span closes and the decode
        span opens back to back, so the two tile the request span."""
        j, r = st.slot, st.req
        self.prefills.remove(st)
        self.reserved[j] = False
        self._close(self.pf_ctxs, j)
        self._open(self.dec_ctxs, j, r.id, r.max_new_tokens, phase="decode")
        self.tokens[j, 0] = first
        self.pos[j] = next_pos
        self.remaining[j] = r.max_new_tokens - 1
        self.active[j] = r
        r.out.append(first)
        if self.remaining[j] == 0:
            self.retire(j)

    def retire(self, j: int, reason: str = "length") -> None:
        # The caller already fenced this slot's last token.
        r = self.active[j]
        r.finish_reason = reason
        self._release(j, r, True)
        self._close(self.dec_ctxs, j)
        self._close(self.req_ctxs, j)
        self.active[j] = None

    def sweep_deadlines(self) -> None:
        """Retire every request past its deadline — waiting, mid-prefill
        (free its slot), or mid-decode (keep the tokens generated so
        far)."""
        if not self.deadlines:
            return
        now = time.monotonic()

        def expired(r: Request) -> bool:
            dl = self.deadlines.get(id(r))
            return dl is not None and now > dl

        kept = []
        for r in self.waiting:
            if expired(r):
                r.finish_reason = "timeout"
                self.eng._timeouts += 1
            else:
                kept.append(r)
        self.waiting[:] = kept
        for st in [st for st in self.prefills if expired(st.req)]:
            self.prefills.remove(st)
            self.reserved[st.slot] = False
            self._release(st.slot, st.req, False)
            self._close(self.pf_ctxs, st.slot)
            self._close(self.req_ctxs, st.slot)
            st.req.finish_reason = "timeout"
            self.eng._timeouts += 1
        for j in self.live():
            if expired(self.active[j]):
                self.retire(j, reason="timeout")
                self.eng._timeouts += 1

    def update_gauges(self) -> None:
        eng, chunk = self.eng, self.eng.prefill_chunk
        eng.queue_depth = len(self.waiting)
        eng.live_slots = len(self.live()) + sum(self.reserved)
        eng.pending_prefill_chunks = sum(
            math.ceil(max(0, st.plen - st.offset) / chunk)
            for st in self.prefills) if chunk else 0

    def decode(self, live: List[int], step) -> None:
        """Advance the live rows by a burst of decode steps on the device
        (``step(tokens, pos)`` gives the logits), read every token back
        at once, and retire the rows that are done.

        Retirement is deterministic (exactly ``max_new_tokens`` per
        request), so with no admission work pending the burst runs until
        the next slot retires: one host sync per retirement, not per
        token.  While prefill chunks are pending, decode advances one
        step per chunk.  Rows not in ``live`` decode garbage that only
        their own dead cache rows (contiguous) or the scratch page
        (paged) receive."""
        steps = 1 if self.prefills \
            else min(self.remaining[j] for j in live)
        if steps > 1 and self.deadlines \
                and any(id(self.active[j]) in self.deadlines for j in live):
            # a deadline'd request must pass the sweep between bursts:
            # bound the device-side run.
            steps = min(steps, 8)
        eng = self.eng
        tok_dev = torch.as_tensor(self.tokens, device=eng.device)
        pos_dev = torch.as_tensor(self.pos, device=eng.device)
        outs = []
        for _ in range(steps):
            tok_dev = eng._pick(step(tok_dev, pos_dev))[:, None]
            outs.append(tok_dev)
            pos_dev = pos_dev + 1
        gen = torch.cat(outs, dim=1).cpu().numpy()
        # the host read waited for every step, so spans closed below are
        # fenced.
        for j in live:
            r = self.active[j]
            r.out.extend(gen[j].tolist())
            self.tokens[j, 0] = gen[j, -1]
            self.pos[j] += steps
            self.remaining[j] -= steps
            if self.remaining[j] == 0:
                self.retire(j)

    def close_all(self) -> None:
        """On the way out, exception or not: release what the layout
        still holds for a slot and close every open span (an open span
        pins the shared session's sampler)."""
        for j in range(self.b):
            if self.active[j] is not None or self.reserved[j]:
                self._release(j, self.active[j], False)
        self.prefills.clear()
        self.waiting.clear()
        self.reserved[:] = [False] * self.b
        self.active[:] = [None] * self.b
        self.update_gauges()
        for j in range(self.b):
            self._close(self.pf_ctxs, j)
            self._close(self.dec_ctxs, j)
            self._close(self.req_ctxs, j)


class ServeEngine:
    """Continuous-batching decode over fixed slots with chunked prefill,
    and its baselines.

    Args:
      cfg, params: model config and parameter tree (``init_params`` or
        ``bridge.params_from_numpy``); weight matrices are cast once to
        ``cfg.dtype`` and moved to the engine's device.
      batch_size: number of decode slots.
      max_len: KV-cache capacity per slot.  A chunked request needs
        ``ceil(plen / chunk) * chunk <= max_len`` and
        ``plen + max_new_tokens <= max_len + 1``; a blocking or wave one
        ``prompt_bucket(plen) + max_new_tokens <= max_len + 1``.
      monitor / session: per-request and aggregate energy accounting, as
        in the JAX engine (monitor wins when both are given).
      mode: "continuous" (slot refill) or "wave" (batch-sized waves, one
        ``serve/wave<N>`` region each counting the wave's
        ``sum(max_new_tokens)``; no per-request spans or deadlines).
      decode_attn_impl: None keeps ``cfg.decode_attn_impl``; "auto" or
        "flash" is the flash-decode kernel, "dense" the masked attend
        over the whole cache (contiguous layout; paged decode is flash).
      prefill_chunk: chunk size, or 0 for blocking whole-prompt
        admission; None resolves ``PMT_PREFILL_CHUNK`` then
        ``cfg.prefill_chunk``.
      cache_dtype: KV storage dtype: torch.bfloat16 or torch.float32, or
        its name, or a quantized-KV mode, "int8" or "fp8_e4m3", which
        sets ``cfg.kv_quant`` (codes plus float32 row scales).
      device: where the engine runs; the card unless "cpu" is asked for.
      kv_layout: "contiguous" (default) keeps per-slot (B, max_len, ...)
        caches; "paged" serves from one page pool per cache leaf with
        per-slot page tables: pages are allocated at admission (after a
        radix prefix-tree match maps any cached prompt prefix in
        copy-free) and recycled at retirement, so the cache budget is
        the pool.  Needs chunked prefill and an all-attention arch.
      kv_page_size: tokens per page (default ``cfg.kv_page_size``).
      kv_pool_pages: usable pool capacity in pages (default
        ``batch_size * ceil(max_len / page_size)``); smaller pools make
        admissions wait for pages.
      prefix_cache: keep retired requests' full pages in a radix tree
        for copy-free prefix reuse (paged layout).
      greedy, temperature, seed: decoding policy.  ``greedy=False``
        samples every token (the first of each prefill too) at
        ``temperature`` from one ``torch.Generator`` seeded with ``seed``,
        kept across ``generate()`` calls.
      governor, preempt, swap_store: accepted at their defaults only;
        other values belong to later slices and raise.
    """

    def __init__(self, cfg: ModelConfig, params, batch_size: int,
                 max_len: int, monitor=None, session=None,
                 mode: str = "continuous",
                 decode_attn_impl: Optional[str] = None,
                 prefill_chunk: Optional[int] = None,
                 governor=None, kv_layout: str = "contiguous",
                 kv_page_size: Optional[int] = None,
                 kv_pool_pages: Optional[int] = None,
                 prefix_cache: bool = True,
                 preempt: bool = False, swap_store=None,
                 greedy: bool = True, temperature: float = 1.0,
                 seed: int = 0,
                 cache_dtype: Union[str, torch.dtype] = torch.bfloat16,
                 device=None):
        if mode not in ("continuous", "wave"):
            raise ValueError(f"unknown serve mode {mode!r}")
        if kv_layout not in ("contiguous", "paged"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}")
        if decode_attn_impl is not None:
            cfg = dataclasses.replace(cfg, decode_attn_impl=decode_attn_impl)
        if not greedy and temperature <= 0.0:
            raise ValueError("sampling needs temperature > 0")
        chunk = resolve_prefill_chunk(cfg, prefill_chunk)
        if kv_layout == "paged":
            if mode != "continuous":
                raise ValueError("paged KV requires continuous mode")
            if not chunk:
                raise ValueError("paged KV requires chunked prefill "
                                 "(prefill_chunk > 0)")
        later = {
            "governor": governor is not None,
            "preempt": bool(preempt),
            "swap_store": swap_store is not None,
        }
        for what, hit in later.items():
            if hit:
                raise NotImplementedError(
                    f"{what} is not ported yet (see ROADMAP.md)")
        if isinstance(cache_dtype, str):
            named = {"bfloat16": torch.bfloat16, "float32": torch.float32}
            if cache_dtype in QUANT_MODES:
                cfg = dataclasses.replace(cfg, kv_quant=cache_dtype)
                cache_dtype = torch.bfloat16    # unused by quant leaves
            elif cache_dtype in named:
                cache_dtype = named[cache_dtype]
            else:
                raise ValueError(
                    f"unknown cache_dtype {cache_dtype!r}; expected one of "
                    f"{sorted(named)} or a KV-quant mode {QUANT_MODES}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = model_mod.serving_params(cfg, params, self.device)
        self.batch = batch_size
        self.max_len = max_len
        self.monitor = monitor
        self.session = session
        self.mode = mode
        self.kv_layout = kv_layout
        self.cache_dtype = cache_dtype
        self.prefill_chunk = chunk
        if chunk > max_len:
            if prefill_chunk is not None:
                raise ValueError(f"prefill_chunk {chunk} exceeds max_len "
                                 f"{max_len}")
            self.prefill_chunk = max_len
        self.greedy = greedy
        self.temperature = temperature
        self._gen: Optional[torch.Generator] = None
        if not greedy:
            self._gen = torch.Generator(device=self.device)
            self._gen.manual_seed(seed)
        self._fns = model_mod.make_serve_fns(cfg, cache_dtype=cache_dtype)
        # Scheduler gauges — plain attribute reads, safe from any thread.
        self.live_slots = 0             # decoding + mid-prefill slots
        self.queue_depth = 0            # admitted-nothing-yet backlog
        self.pending_prefill_chunks = 0
        self._batch_count = 0
        self._request_count = 0
        self._timeouts = 0
        self.stall_events: List[float] = []
        self.request_tenants: Dict[int, str] = {}
        self.compile_counts: Dict[str, int] = {"prefill": 0, "decode": 0,
                                               "prefill_chunk": 0}
        # Rows of logits with a NaN or Inf, summed on the device over
        # every decode step and final prefill chunk; read it with
        # ``nonfinite_logit_rows`` (which syncs).
        self._nonfinite = torch.zeros((), dtype=torch.int64,
                                      device=self.device)

        # -- paged KV (page pools + page tables + prefix reuse) ----------
        self.kv_page_size = int(kv_page_size if kv_page_size is not None
                                else cfg.kv_page_size)
        self.prefix_hit_tokens = 0          # prompt tokens served off pages
        self.saved_prefill_joules = 0.0     # priced at the learned J/token
        self._prefill_jpt: Optional[float] = None   # EWMA J per prefill tok
        self.pool_wait_events = 0           # admissions deferred on pages
        self._pool_short = False            # mid-wait episode flag
        self._pool: Optional[PagePool] = None
        self._radix: Optional[RadixPrefixCache] = None
        if kv_layout == "paged":
            if not model_mod.supports_paged(cfg):
                raise ValueError(
                    f"{cfg.name}: paged KV needs an all-attention arch "
                    "(state and encoder-decoder archs keep the contiguous "
                    "layout)")
            ps = self.kv_page_size
            if ps < 1:
                raise ValueError(f"kv_page_size must be >= 1, got {ps}")
            self._pages_per_slot = math.ceil(max_len / ps)
            usable = (int(kv_pool_pages) if kv_pool_pages is not None
                      else batch_size * self._pages_per_slot)
            if usable < self._pages_per_slot:
                raise ValueError(
                    f"kv_pool_pages {usable} cannot hold even one slot "
                    f"({self._pages_per_slot} pages of {ps})")
            # +1: page 0 is the reserved scratch page
            self._pool = PagePool(usable + 1, ps)
            if prefix_cache:
                self._radix = RadixPrefixCache(self._pool)
            # The pools persist across generate() calls: the radix tree
            # owns pages between runs.
            self._paged_caches = model_mod.init_paged_caches(
                cfg, usable + 1, ps, dtype=cache_dtype, device=self.device)
            self._page_table = np.zeros(
                (batch_size, self._pages_per_slot), np.int32)
            self._slot_pages: List[List[int]] = \
                [[] for _ in range(batch_size)]
            self._paged_fns = model_mod.make_paged_serve_fns(cfg)

    # -- measurement contexts ----------------------------------------------
    def _measure_ctx(self, agg_id: int, tokens: int):
        if self.monitor is not None:
            return self.monitor.measure_step(agg_id, tokens=tokens,
                                             blocking=False)
        if self.session is not None:
            label = "wave" if self.mode == "wave" else "batch"
            return self.session.region(f"serve/{label}{agg_id}",
                                       tokens=tokens)
        return contextlib.nullcontext()

    def _request_ctx(self, rid: int, tokens: int,
                     phase: Optional[str] = None):
        if self.monitor is not None:
            return self.monitor.measure_request(rid, tokens=tokens,
                                                blocking=False, phase=phase)
        if self.session is not None:
            label = f"serve/req{rid}" + (f"/{phase}" if phase else "")
            return self.session.region(label, tokens=tokens, nested=False)
        return contextlib.nullcontext()

    # -- public API ----------------------------------------------------------
    def generate(self, requests: List[Request]) -> List[Request]:
        """Serve ``requests``; returns them in input order, ``out`` filled."""
        chunk = self.prefill_chunk if self.mode == "continuous" else 0
        for r in requests:
            if r.max_new_tokens < 1:
                raise ValueError("max_new_tokens must be >= 1")
            if r.deadline_s is not None:
                if r.deadline_s <= 0:
                    raise ValueError(
                        f"deadline_s must be > 0, got {r.deadline_s}")
                if self.mode == "wave":
                    raise ValueError(
                        "deadline_s requires continuous mode (waves have "
                        "no per-request retirement point)")
            if r.finish_reason is not None:
                r.id = None             # a completed request: serve afresh
                r.out = []
            r.finish_reason = None
            plen = len(r.prompt)
            if chunk:
                padded = math.ceil(plen / chunk) * chunk
                if padded > self.max_len \
                        or plen + r.max_new_tokens > self.max_len + 1:
                    raise ValueError(
                        f"request needs "
                        f"{max(padded, plen + r.max_new_tokens - 1)} cache "
                        f"slots (chunk-padded prompt / prompt + "
                        f"max_new_tokens) but max_len is {self.max_len}")
            else:
                need = prompt_bucket(plen) + r.max_new_tokens
                if need > self.max_len + 1:
                    raise ValueError(
                        f"request needs {need} cache slots (bucketed prompt "
                        f"+ max_new_tokens) but max_len is {self.max_len}")
        self.stall_events = []
        if self.mode == "wave":
            done: List[Request] = []
            for i in range(0, len(requests), self.batch):
                done.extend(self._run_wave(requests[i:i + self.batch]))
            return done
        if self.kv_layout == "paged":
            return self._run_paged(requests)
        return self._run_continuous(requests)

    @property
    def nonfinite_logit_rows(self) -> int:
        """Logit rows with a NaN or Inf so far (all slots, live or not)."""
        return int(self._nonfinite.item())

    def stats(self) -> Dict[str, Any]:
        """Scheduler counters snapshot, with the JAX engine's keys."""
        return {
            "mode": self.mode,
            "kv_layout": self.kv_layout,
            "batch_slots": self.batch,
            "requests_admitted": self._request_count,
            "live_slots": self.live_slots,
            "queue_depth": self.queue_depth,
            "pending_prefill_chunks": self.pending_prefill_chunks,
            "stall_events": len(self.stall_events),
            "stall_p95_s": stall_p95(self.stall_events),
            "requests_timed_out": self._timeouts,
            "compile_counts": dict(self.compile_counts),
            "kv_cache": self._kv_cache_stats(),
            "preemption": {
                "enabled": False, "preemptions": 0, "resumes": 0,
                "retries_exhausted": 0, "wasted_tokens": 0,
                "wasted_joules": 0.0, "recovered_tokens": 0,
                "recovered_joules": 0.0, "quarantined": 0,
                "hung_steps": 0, "drains": 0,
            },
        }

    def _kv_cache_stats(self) -> Dict[str, Any]:
        s: Dict[str, Any] = {
            "cache_dtype": (self.cfg.kv_quant if self.cfg.kv_quant is not None
                            else str(self.cache_dtype).replace("torch.", "")),
            "bytes_per_token": self.cache_bytes_per_token(),
        }
        if self._pool is not None:
            s.update(
                page_size=self._pool.page_size,
                pages_total=self._pool.total_pages,
                pages_free=self._pool.free_pages,
                pages_used=self._pool.used_pages,
                pool_wait_events=self.pool_wait_events,
                prefix_cache=self._radix is not None,
                prefix_hit_tokens=self.prefix_hit_tokens,
                saved_prefill_joules=self.saved_prefill_joules)
            if self._radix is not None:
                s.update(
                    prefix_lookups=self._radix.lookups,
                    prefix_hits=self._radix.hits,
                    prefix_hit_rate=self._radix.hit_rate,
                    prefix_evictions=self._radix.evictions,
                    prefix_nodes=self._radix.node_count)
        return s

    def cache_bytes_per_token(self) -> float:
        """KV-cache bytes per cached token position, every leaf of every
        layer summed (a quantized cache: codes and scales).  Contiguous:
        the leaves ``init_caches`` would build, over ``batch * max_len``
        positions (ring layers hold fewer).  Paged: every pool leaf,
        scratch page included, over the usable pages' ``total_pages *
        page_size`` positions."""
        if self._pool is not None:
            total = sum(t.numel() * t.element_size()
                        for t in tree_leaves(self._paged_caches))
            return total / max(1, self._pool.total_pages
                               * self._pool.page_size)
        cfg = self.cfg
        total = 0
        for idx in range(cfg.num_layers):
            window = layer_window(cfg, idx)
            size = min(self.max_len, window) if window else self.max_len
            specs = kv_leaf_specs(cfg, (self.batch, size), self.cache_dtype)
            total += sum(math.prod(shape) * dt.itemsize
                         for shape, dt in specs.values())
        return total / max(1, self.batch * self.max_len)

    def on_record(self, rec) -> None:
        """Session-record subscriber: learns joules per prefill token from
        resolved ``serve/req<N>/prefill`` records — the price of the
        prefill work a prefix-tree hit avoids.  ``saved_prefill_joules``
        accrues at admission from this EWMA."""
        path = getattr(rec, "path", "")
        if not (path.startswith("serve/req") and path.endswith("/prefill")):
            return
        tokens = getattr(rec, "tokens", None)
        joules = getattr(rec, "joules", None)
        if not tokens or joules is None or joules <= 0.0:
            return
        jpt = joules / tokens
        self._prefill_jpt = jpt if self._prefill_jpt is None \
            else 0.8 * self._prefill_jpt + 0.2 * jpt

    # -- continuous batching --------------------------------------------------
    def _admit(self, r: Request) -> Request:
        r.id = self._request_count
        self._request_count += 1
        r.out = []
        if r.tenant is not None:
            self.request_tenants[r.id] = r.tenant
        return r

    def _count_nonfinite(self, logits: torch.Tensor) -> None:
        self._nonfinite += (~torch.isfinite(logits).all(dim=-1)).sum()

    def _pick(self, logits: torch.Tensor) -> torch.Tensor:
        """(B,) next tokens from (B, V) logits, on their device: the
        argmax, or with sampling the Gumbel-max draw from
        ``softmax(logits / temperature)`` (what ``jax.random.categorical``
        computes), its uniforms from the engine's generator."""
        if self.greedy:
            return logits.argmax(dim=-1)
        u = torch.rand(logits.shape, generator=self._gen,
                       device=logits.device)
        gumbel = -torch.log(-torch.log(
            u.clamp_(min=torch.finfo(torch.float32).tiny)))
        return (logits.float() / self.temperature + gumbel).argmax(dim=-1)

    def _prefill_request(self, r: Request):
        """Blocking whole-prompt prefill at the prompt's bucket (the
        ``prefill_chunk=0`` baseline), the prompt left-padded with token 0.
        Returns (first generated token, batch-1 cache row, next position
        == the bucket).  Reading the token fences the prefill."""
        plen = len(r.prompt)
        bucket = prompt_bucket(plen)
        toks = np.zeros((1, bucket), np.int64)
        toks[0, bucket - plen:] = r.prompt          # left-pad
        logits, row = self._fns.prefill(
            self.params, {"tokens": torch.as_tensor(toks, device=self.device)},
            self.max_len)
        self._count_nonfinite(logits)
        return int(self._pick(logits)[0]), row, bucket

    def _start_chunked_prefill(self, r: Request, j: int) -> _Prefill:
        plen = len(r.prompt)
        chunk = self.prefill_chunk
        padded = math.ceil(plen / chunk) * chunk
        toks = np.zeros((1, padded), np.int64)
        toks[0, :plen] = r.prompt                   # right-pad final chunk
        caches = model_mod.init_caches(self.cfg, 1, self.max_len,
                                       dtype=self.cache_dtype,
                                       device=self.device)
        return _Prefill(req=r, slot=j, caches=caches, toks=toks, plen=plen)

    def _step_chunked_prefill(self, st: _Prefill, decode_live: bool
                              ) -> Optional[int]:
        """Run one chunk; returns the first generated token when this was
        the final chunk, else None.  Fenced (the token read waits for the
        device), so the prefill span and the stall sample cover real
        device work."""
        chunk = self.prefill_chunk
        t0 = time.perf_counter()
        last_idx = min(st.plen - 1 - st.offset, chunk - 1)
        toks = torch.as_tensor(st.toks[:, st.offset:st.offset + chunk],
                               device=self.device)
        logits = self._fns.prefill_chunk(self.params, st.caches, toks,
                                         st.offset, last_idx)
        st.offset += chunk
        final = st.offset >= st.toks.shape[1]
        if final:
            self._count_nonfinite(logits)
        tok = int(self._pick(logits)[0])            # fence the chunk
        if decode_live:
            self.stall_events.append(time.perf_counter() - t0)
        return tok if final else None

    def _serve(self, requests: List[Request], slots: _Slots,
               iterate) -> List[Request]:
        """The loop both layouts share: sweep deadlines, then one
        ``iterate()`` (admission, prefill, a decode burst) until every
        request is served, all inside one ``serve/batch<N>`` region."""
        agg_id = self._batch_count
        self._batch_count += 1
        total_tokens = sum(r.max_new_tokens for r in requests)
        with self._measure_ctx(agg_id, tokens=total_tokens):
            try:
                while slots.busy():
                    slots.sweep_deadlines()
                    slots.update_gauges()
                    iterate()
            finally:
                slots.close_all()
        return requests

    def _run_continuous(self, requests: List[Request]) -> List[Request]:
        b = self.batch
        caches = model_mod.init_caches(self.cfg, b, self.max_len,
                                       dtype=self.cache_dtype,
                                       device=self.device)
        cache_leaves = tree_leaves(caches)
        slots = _Slots(self, requests)

        def step(tok_dev, pos_dev):
            logits = self._fns.decode(self.params, caches, tok_dev, pos_dev)
            self._count_nonfinite(logits)
            return logits

        def insert(j: int, row) -> None:
            for live_leaf, leaf in zip(cache_leaves, tree_leaves(row)):
                live_leaf[:, j].copy_(leaf[:, 0])

        def iterate():
            # slot-granular admission: every free slot refills now
            # (blocking) or enters the chunk queue (chunked) instead of
            # waiting for the batch to drain.
            for j in range(b):
                if not (slots.waiting and slots.free(j)):
                    continue
                if self.prefill_chunk:
                    st = self._start_chunked_prefill(slots.waiting[0], j)
                    slots.admit(j, st, st.plen)
                    continue
                # blocking bucketed baseline: the whole prompt now
                r = slots.waiting[0]
                st = _Prefill(req=r, slot=j, caches=None, toks=None,
                              plen=len(r.prompt))
                slots.admit(j, st, st.plen)
                t0 = time.perf_counter()
                first, row, bucket = self._prefill_request(r)
                if slots.live():
                    self.stall_events.append(time.perf_counter() - t0)
                insert(j, row)
                slots.go_live(st, first, bucket)
            slots.update_gauges()
            # one prefill chunk per decode step; with no live decode rows
            # the chunk queue drains back to back.
            if slots.prefills:
                st = slots.prefills[0]
                first = self._step_chunked_prefill(st, bool(slots.live()))
                if first is not None:
                    insert(st.slot, st.caches)
                    slots.go_live(st, first, st.plen)
                slots.update_gauges()
            live = slots.live()
            if live:                    # else everything retired at prefill
                slots.decode(live, step)

        return self._serve(requests, slots, iterate)

    # -- paged continuous batching --------------------------------------------
    def _admit_paged(self, r: Request, j: int) -> Optional[_PagedPrefill]:
        """Reserve slot ``j``'s pages for request ``r``: radix-match the
        prompt (mapping cached prefix pages in copy-free), then allocate
        the rest of ``ceil((plen + max_new - 1) / page_size)`` pages up
        front, so decode never waits for a page mid-request.  Returns
        None when the pool cannot cover it now, even after evicting
        tree pages (the caller leaves the request waiting)."""
        pool, radix = self._pool, self._radix
        ps = self.kv_page_size
        toks_all = list(r.prompt)
        plen = len(toks_all)
        pages_needed = math.ceil((plen + r.max_new_tokens - 1) / ps)
        matched: List[int] = []
        if radix is not None:
            _, mpages = radix.match(toks_all)
            # cap the match one token short of the prompt: the final
            # chunk must re-run >= 1 token for its logits
            use = min(len(mpages), (plen - 1) // ps)
            if use < len(mpages):
                pool.release(mpages[use:])
            matched = mpages[:use]
        fresh = pool.alloc(pages_needed - len(matched))
        if fresh is None and radix is not None:
            radix.evict_for(pages_needed - len(matched))
            fresh = pool.alloc(pages_needed - len(matched))
        if fresh is None:
            if matched:
                pool.release(matched)
            return None
        slot_pages, mt = matched + fresh, len(matched) * ps
        self._slot_pages[j] = slot_pages
        self._page_table[j, :] = 0
        self._page_table[j, :len(slot_pages)] = slot_pages
        self.prefix_hit_tokens += mt
        if mt and self._prefill_jpt is not None:
            self.saved_prefill_joules += mt * self._prefill_jpt
        toks = np.zeros((plen + self.prefill_chunk,), np.int64)
        toks[:plen] = toks_all
        return _PagedPrefill(req=r, slot=j, toks=toks, plen=plen, offset=mt,
                             matched_tokens=mt)

    def _release_slot_pages(self, j: int) -> None:
        if self._slot_pages[j]:
            self._pool.release(self._slot_pages[j])
            self._slot_pages[j] = []
        self._page_table[j, :] = 0

    def _step_paged_prefills(self, slots: _Slots) -> None:
        """Batched chunk admissions: ONE (B, chunk) dispatch advances
        EVERY pending prefill by one chunk, each row at its own offset;
        passenger rows ride with ``last_idx == -1`` and write nothing.
        Fenced (the token read waits for the device)."""
        b, chunk, dev = self.batch, self.prefill_chunk, self.device
        decode_live = bool(slots.live())
        t0 = time.perf_counter()
        ctoks = np.zeros((b, chunk), np.int64)
        offs = np.zeros((b,), np.int32)
        last = np.full((b,), -1, np.int32)
        for st in slots.prefills:
            ctoks[st.slot] = st.toks[st.offset:st.offset + chunk]
            offs[st.slot] = st.offset
            last[st.slot] = min(st.plen - 1 - st.offset, chunk - 1)
        logits = self._paged_fns.prefill_chunk(
            self.params, self._paged_caches,
            torch.as_tensor(ctoks, device=dev),
            torch.as_tensor(offs, device=dev),
            torch.as_tensor(last, device=dev),
            torch.as_tensor(self._page_table, device=dev))
        done = [st.slot for st in slots.prefills
                if st.offset + chunk >= st.plen]
        if done:
            self._count_nonfinite(logits[torch.as_tensor(done, device=dev)])
        tok = self._pick(logits).cpu().numpy()              # fence
        if decode_live:
            self.stall_events.append(time.perf_counter() - t0)
        for st in list(slots.prefills):
            st.offset += chunk
            if st.offset >= st.plen:
                slots.go_live(st, int(tok[st.slot]), st.plen)

    def _run_paged(self, requests: List[Request]) -> List[Request]:
        """Continuous batching over the page pools.

        Differences from ``_run_continuous``: admission reserves pages
        instead of a cache row, and may wait on the pool as well as on
        slots; prefill chunks write straight into the shared pools
        through the slot's page-table row, every pending admission's
        chunk batched into one dispatch (``_step_paged_prefills``);
        decode sees a masked page table (mid-prefill and dead rows read
        and write only the scratch page); retirement adopts the
        request's full pages into the radix prefix tree before releasing
        its references.
        """
        b, dev = self.batch, self.device
        radix, ps = self._radix, self.kv_page_size
        caches = self._paged_caches     # pools persist across generate()s
        self._pool_short = False

        def release(j: int, r: Optional[Request], retired: bool) -> None:
            if retired and radix is not None:
                # Adopt the full pages actually written — the prompt and
                # every generated token fed back (the last one never
                # lands in the cache) — into the prefix tree BEFORE
                # releasing this request's refs, so adopted pages never
                # transit the free list.  Existing nodes win on
                # duplicate content; timeouts contribute their written
                # prefix like any other retirement.
                written = list(r.prompt) + r.out[:-1]
                n_full = len(written) // ps
                if n_full:
                    radix.insert(written[:n_full * ps],
                                 self._slot_pages[j][:n_full])
            self._release_slot_pages(j)

        slots = _Slots(self, requests, release)

        def iterate():
            # Admission: page reservation for each free slot.  A pool too
            # drained to cover the next request defers it — retirements
            # free pages; an idle engine always admits, since one slot's
            # pages fit the pool (checked in __init__) and an idle pool,
            # after prefix-tree eviction, is wholly free.
            for j in range(b):
                if not (slots.waiting and slots.free(j)):
                    continue
                st = self._admit_paged(slots.waiting[0], j)
                if st is None:
                    # count each episode of waiting on pages once
                    if not self._pool_short:
                        self._pool_short = True
                        self.pool_wait_events += 1
                    break
                self._pool_short = False
                # the phase span counts the tokens actually prefilled: a
                # prefix hit shrinks the work
                slots.admit(j, st, st.plen - st.matched_tokens)
            slots.update_gauges()
            if slots.prefills:
                self._step_paged_prefills(slots)
                slots.update_gauges()
            live = slots.live()
            if not live:
                return                  # everything retired at prefill
            # Decode sees a MASKED page table: only decoding rows expose
            # their pages — mid-prefill and dead rows read and write the
            # scratch page only, so their garbage tokens cannot touch
            # pages a prefill is filling.
            mask = np.zeros((b, 1), np.int32)
            mask[live] = 1
            pt_dec = torch.as_tensor(self._page_table * mask, device=dev)
            live_dev = torch.as_tensor(live, device=dev)

            def step(tok_dev, pos_dev):
                logits = self._paged_fns.decode(self.params, caches, tok_dev,
                                                pos_dev, pt_dec)
                self._count_nonfinite(logits[live_dev])
                return logits

            slots.decode(live, step)

        return self._serve(requests, slots, iterate)

    # -- synchronized waves (baseline) ----------------------------------------
    def _run_wave(self, wave: List[Request]) -> List[Request]:
        """One wave: a (B, bucket) prefill of the wave's prompts, each
        left-padded to the longest one's bucket (unused rows all pad),
        then the wave's most decode steps for every row at one shared
        position; each request keeps its first ``max_new_tokens``."""
        b = self.batch
        plen = prompt_bucket(max(len(r.prompt) for r in wave))
        toks = np.zeros((b, plen), np.int64)
        for j, r in enumerate(wave):
            toks[j, plen - len(r.prompt):] = r.prompt   # left-pad
        steps = max(r.max_new_tokens for r in wave)
        # rows share the wave's bucket and its most steps, so a long
        # neighbour can push a short request past max_len although each
        # request passed its own check
        if plen + steps > self.max_len + 1:
            raise ValueError(
                f"wave needs {plen + steps} cache slots (shared prompt "
                f"bucket {plen} + {steps} decode steps) but max_len is "
                f"{self.max_len}; shrink the wave or use continuous mode")
        # J/token divides by the tokens actually generated: padded rows
        # and rows past their count decode but emit nothing
        gen_tokens = sum(r.max_new_tokens for r in wave)
        wave_id = self._batch_count
        self._batch_count += 1
        with self._measure_ctx(wave_id, tokens=gen_tokens):
            logits, caches = self._fns.prefill(
                self.params,
                {"tokens": torch.as_tensor(toks, device=self.device)},
                self.max_len)
            self._count_nonfinite(logits)
            nxt = self._pick(logits)[:, None]
            outs = [nxt]
            # the shared position as a (B,) tensor kept on the device: no
            # host copy a step
            cur = torch.full((b,), plen, dtype=torch.int32,
                             device=self.device)
            for _ in range(steps - 1):
                logits = self._fns.decode(self.params, caches, nxt, cur)
                self._count_nonfinite(logits)
                nxt = self._pick(logits)[:, None]
                outs.append(nxt)
                cur = cur + 1
            gen = torch.cat(outs, dim=1).cpu().numpy()
        for j, r in enumerate(wave):
            r.out = gen[j, :r.max_new_tokens].tolist()
            r.finish_reason = "length"
        return wave
