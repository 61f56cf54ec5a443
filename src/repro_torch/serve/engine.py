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

The paged path carries the JAX engine's preemption plane
(``preempt=True``): when the pool cannot cover a fresh admission even
after radix eviction, the lowest-priority live request is preempted
page-aligned, its written pages parked in a host ``PageSwapStore``
(``serve/swap.py``) or the radix tree, and it rejoins the queue with
exponential backoff; its resume prefills ``prompt + out`` from the
checkpoint that covers more.  Rows whose logits turn non-finite are
quarantined (``"error"``, or retried from scratch with
``retry_errors``), and their pages never reach the tree; a watchdog
counts fenced steps slower than ``watchdog_step_timeout_s``; ``drain()``
checkpoints everything in flight and returns.  Deadlines and backoff
read the module's ``_clock``.

``governor=`` (a ``serve.governor.PowerGovernor``) is consulted by both
continuous loops, as in the JAX engine: at admission (its gate, with a
forced admit when the engine is idle, and a pick of a tenant within its
quota; the paged loop feeds it the pool's free fraction), for the
prefill chunks a loop runs (a forced chunk when nothing decodes), and
before decode (a bounded pause); under a power cap decode runs one step
a loop, so every step passes those checkpoints.  The paged loop also
preempts a live request when the governor asks to shed one, reports
pool waits, and tells it of every preemption, resume and quarantine.
Waves take no governor.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import os
import time
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.quant import QUANT_MODES
from repro_torch.models import model as model_mod
from repro_torch.models.blocks import cache_leaf_specs, layer_window
from repro_torch.serve.paging import PagePool, RadixPrefixCache
from repro_torch.tree import tree_leaves

# The clock of deadlines and retry backoff, and the sleep that waits out
# a backoff (module attributes, so a test can drive them).
_clock = time.monotonic
_sleep = time.sleep


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

    ``finish_reason`` is None until served (or still None after
    ``drain()`` checkpointed it mid-flight: submitting it again resumes
    it), then:

      * ``"length"``: ran to ``max_new_tokens``;
      * ``"timeout"``: past ``deadline_s``, measured from ``generate()``
        submission, waiting, mid-prefill, mid-decode or parked after a
        preemption (timeout outranks retry); keeps the tokens so far;
      * ``"preempted-retry-exhausted"``: preempted more than the
        engine's ``preempt_max_retries`` times; keeps the tokens
        generated before the last preemption;
      * ``"error"``: the step that would have produced its next token
        gave non-finite logits; quarantined (pages dropped, never
        adopted into the prefix tree), unless ``retry_errors`` retries
        it from scratch first.

    ``priority`` orders preemption victims: lower goes first (ties: the
    least progress, then the lowest id).
    """

    prompt: Sequence[int]
    max_new_tokens: int
    out: List[int] = dataclasses.field(default_factory=list)
    id: Optional[int] = None        # assigned by the engine at admission
    tenant: Optional[str] = None    # recorded in engine.request_tenants
    deadline_s: Optional[float] = None
    finish_reason: Optional[str] = None
    priority: int = 0
    # -- engine-managed resume state (opaque to callers) --------------
    _preempts: int = 0                      # times preempted so far
    _retry_at: float = 0.0                  # ``_clock`` re-admission gate
    _progress: int = 0                      # tokens computed at checkpoint
    _swap_handle: Optional[int] = None      # PageSwapStore entry
    _swap_pages: int = 0


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
    in, or a swap snapshot is restored: prefill resumes from there."""

    req: Request
    slot: int
    toks: np.ndarray                # (plen + chunk,) right-zero-padded
    plen: int
    offset: int
    matched_tokens: int = 0
    # (host leaf tensors, n_pages): a swap snapshot awaiting its scatter
    # into the fresh pages (resumes from swap only)
    swap_restore: Optional[Tuple[List[torch.Tensor], int]] = None


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
        self.deadlines = {id(r): _clock() + r.deadline_s
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

    def admit(self, j: int, st, prefill_tokens: int, k: int = 0,
              resume: bool = False) -> None:
        """``st`` prefills ``waiting[k]`` in slot j (a ``resume`` keeps
        its id and tokens).  The slot is reserved before anything here
        can raise, so ``close_all`` releases what the layout committed
        to it."""
        self.reserved[j] = True
        r = self.waiting.pop(k)
        if not resume:
            r = self.eng._admit(r)
            if self.eng.governor is not None:
                self.eng.governor.note_admitted(r)
        self._open(self.req_ctxs, j, r.id, r.max_new_tokens - len(r.out))
        self._open(self.pf_ctxs, j, r.id, prefill_tokens, phase="prefill")
        self.prefills.append(st)

    def go_live(self, st, first: int, next_pos: int) -> None:
        """``st`` finished prefill with ``first`` generated: its slot
        becomes a decode row.  The prefill span closes and the decode
        span opens back to back, so the two tile the request span.  A
        resumed request continues its budget, not a fresh one."""
        j, r = st.slot, st.req
        self.prefills.remove(st)
        self.reserved[j] = False
        self._close(self.pf_ctxs, j)
        left = r.max_new_tokens - len(r.out)
        self._open(self.dec_ctxs, j, r.id, left, phase="decode")
        self.tokens[j, 0] = first
        self.pos[j] = next_pos
        self.remaining[j] = left - 1
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

    def vacate(self, j: int) -> None:
        """Slot j gives its request up without retiring it (preempted,
        drained or quarantined): its spans close and the slot is free.
        The caller has dealt with its pages."""
        self._close(self.pf_ctxs, j)
        self._close(self.dec_ctxs, j)
        self._close(self.req_ctxs, j)
        self.active[j] = None
        self.reserved[j] = False

    def sweep_deadlines(self) -> None:
        """Retire every request past its deadline — waiting (a parked
        one drops its checkpoint), mid-prefill (free its slot), or
        mid-decode (keep the tokens generated so far)."""
        if not self.deadlines:
            return
        now = _clock()

        def expired(r: Request) -> bool:
            dl = self.deadlines.get(id(r))
            return dl is not None and now > dl

        kept = []
        for r in self.waiting:
            if expired(r):
                # timeout outranks retry
                r.finish_reason = "timeout"
                self.eng._drop_resume_state(r)
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
            self.eng._drop_resume_state(st.req)
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

    def decode(self, live: List[int], step, on_poison=None,
               watchdog=None) -> None:
        """Advance the live rows by a burst of decode steps on the device
        (``step(tokens, pos)`` gives the logits and, where the layout
        quarantines, each row's "all finite" flag, else None), read every
        token and flag back in one host copy, and retire the rows that
        are done.  A row with a non-finite step keeps the tokens strictly
        before it and goes to ``on_poison(j)``; ``watchdog(seconds,
        steps)`` sees the burst's time up to the host read.

        Retirement is deterministic (exactly ``max_new_tokens`` per
        request), so with no admission work pending the burst runs until
        the next slot retires: one host sync per retirement, not per
        token.  While prefill chunks are pending, decode advances one
        step per chunk, and under a governor's power cap one step per
        loop, so that every step passes its checkpoints.  Rows not in
        ``live`` decode garbage that only their own dead cache rows
        (contiguous) or the scratch page (paged) receive."""
        gov = self.eng.governor
        governed = gov is not None and gov.cap_watts is not None
        steps = 1 if (self.prefills or governed) \
            else min(self.remaining[j] for j in live)
        if steps > 1 and self.deadlines \
                and any(id(self.active[j]) in self.deadlines for j in live):
            # a deadline'd request must pass the sweep between bursts:
            # bound the device-side run.
            steps = min(steps, 8)
        eng = self.eng
        t0 = time.perf_counter()
        tok_dev = torch.as_tensor(self.tokens, device=eng.device)
        pos_dev = torch.as_tensor(self.pos, device=eng.device)
        outs, oks = [], []
        for _ in range(steps):
            logits, ok = step(tok_dev, pos_dev)
            tok_dev = eng._pick(logits)[:, None]
            outs.append(tok_dev)
            if ok is not None:
                oks.append(ok[:, None].to(tok_dev.dtype))
            pos_dev = pos_dev + 1
        read = torch.cat(outs + oks, dim=1).cpu().numpy()
        gen, okm = read[:, :steps], read[:, steps:].astype(bool)
        # the host read waited for every step, so spans closed below are
        # fenced.
        if watchdog is not None:
            watchdog(time.perf_counter() - t0, steps)
        for j in live:
            r = self.active[j]
            if oks and not okm[j].all():
                good = int(np.argmax(~okm[j]))
                r.out.extend(gen[j, :good].tolist())
                on_poison(j)
                continue
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
      preempt: preemption and resume (paged layout only).  When the
        pool cannot cover a fresh admission even after radix eviction,
        the lowest-priority live request is preempted page-aligned: its
        written full pages go to the swap store when one is given (the
        device pages are freed and a restore is sure), else to the radix
        tree (copy-free, but pool-resident and evictable: a later miss
        recomputes), and it rejoins the queue with a resume point.
      preempt_max_retries: preemptions one request tolerates before it
        retires ``"preempted-retry-exhausted"``.
      retry_backoff_s: base re-admission delay after a preemption (it
        doubles with each preemption of that request); 0 retries at once.
      retry_errors: retry quarantined (non-finite-logit) requests from
        scratch, within the same budget and backoff, instead of retiring
        them ``"error"``.
      swap_store: a ``serve.swap.PageSwapStore`` for preempted pages
        (paged layout only); None: tree or recompute.
      watchdog_step_timeout_s: a fenced prefill chunk or decode step (per
        step of a burst) slower than this counts a ``hung_steps`` and
        emits a ``hung_step`` event (paged layout only).  Detection
        only: a device step cannot be aborted from the host.
      greedy, temperature, seed: decoding policy.  ``greedy=False``
        samples every token (the first of each prefill too) at
        ``temperature`` from one ``torch.Generator`` seeded with ``seed``,
        kept across ``generate()`` calls.
      governor: a ``serve.governor.PowerGovernor`` consulted by both
        continuous loops (admission gate and tenant pick, prefill chunk
        budget, decode pause; the paged loop also sheds, reports pool
        waits and the preemption plane's events); under its watts cap
        decode runs one step a loop.  ``stats()["governor"]`` is its
        ``stats()``.  Wave mode does not consult it.

    ``event_sink``, when set, receives one dict per preempt, resume,
    retry_exhausted, quarantine, hung_step, drain_checkpoint and drain
    event; a sink that raises is ignored.
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
                 preempt: bool = False, preempt_max_retries: int = 8,
                 retry_backoff_s: float = 0.0, retry_errors: bool = False,
                 swap_store=None,
                 watchdog_step_timeout_s: Optional[float] = None,
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
        if kv_layout != "paged":
            if preempt:
                raise ValueError("preempt=True requires kv_layout='paged'")
            if swap_store is not None:
                raise ValueError("swap_store requires kv_layout='paged'")
            if watchdog_step_timeout_s is not None:
                raise ValueError(
                    "watchdog_step_timeout_s requires kv_layout='paged'")
        if watchdog_step_timeout_s is not None \
                and watchdog_step_timeout_s <= 0:
            raise ValueError("watchdog_step_timeout_s must be > 0")
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
        self.governor = governor
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

        # -- preemption, resume, quarantine, watchdog ----------------------
        self.preempt_enabled = bool(preempt)
        self.preempt_max_retries = int(preempt_max_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.retry_errors = bool(retry_errors)
        self.swap_store = swap_store
        self.watchdog_step_timeout_s = watchdog_step_timeout_s
        self.preemptions = 0
        self.preempt_resumes = 0
        self.retries_exhausted = 0
        self.wasted_tokens = 0              # computed once, run again
        self.wasted_joules = 0.0            # ... priced at the learned J/token
        self.recovered_tokens = 0           # restored from the tree or swap
        self.recovered_joules = 0.0
        self.quarantined = 0
        self.hung_steps = 0
        self.drains = 0
        # one entry per preempt and resume, which the stats' totals sum
        self.preempt_log: List[Dict[str, Any]] = []
        # the swap path's host copies: pages, bytes and fenced seconds
        # each way
        self.swap_copies = {"pages_out": 0, "bytes_out": 0,
                            "seconds_out": 0.0, "pages_in": 0,
                            "bytes_in": 0, "seconds_in": 0.0}
        self._drain_requested = False
        self.event_sink: Optional[Any] = None

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
            # the swap path's view of the pools: each leaf with its page
            # axis, and the bytes one page holds over every leaf
            self._pool_leaves = list(zip(
                tree_leaves(self._paged_caches),
                model_mod.paged_page_axes(cfg)))
            self._page_bytes = sum(t.nbytes // t.shape[ax]
                                   for t, ax in self._pool_leaves)
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
                # a completed request is served afresh; one with an id and
                # no finish_reason was drained (or its run raised) mid-
                # flight, and the paged path resumes it
                r.id = None
                r.out = []
                r._preempts = 0
                r._progress = 0
                self._drop_resume_state(r)
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
        if self.governor is not None and self.mode == "continuous":
            self.governor.begin(self)
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
        s = {
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
            "preemption": self._preemption_stats(),
        }
        if self.governor is not None:
            s["governor"] = self.governor.stats()
        return s

    def _preemption_stats(self) -> Dict[str, Any]:
        pre: Dict[str, Any] = {
            "enabled": self.preempt_enabled,
            "preemptions": self.preemptions,
            "resumes": self.preempt_resumes,
            "retries_exhausted": self.retries_exhausted,
            "wasted_tokens": self.wasted_tokens,
            "wasted_joules": self.wasted_joules,
            "recovered_tokens": self.recovered_tokens,
            "recovered_joules": self.recovered_joules,
            "quarantined": self.quarantined,
            "hung_steps": self.hung_steps,
            "drains": self.drains,
        }
        if self.swap_store is not None:
            pre["swap"] = self.swap_store.stats()
        return pre

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
            specs = cache_leaf_specs(cfg, idx, (self.batch, size),
                                     self.cache_dtype)
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

    def drain(self) -> None:
        """Ask for a graceful drain: at its next scheduler checkpoint the
        paged engine checkpoints every request in flight page-aligned
        (to swap or the tree, as a preemption does, charging no retry),
        leaves ``finish_reason`` None on everything unfinished and
        returns from ``generate()``.  Submitting the same ``Request``
        objects again resumes them.  Safe from another thread (one flag
        write)."""
        self._drain_requested = True

    def _emit_event(self, kind: str, rid: Optional[int], **fields) -> None:
        """Hand one preemption-plane event to ``event_sink``; a sink that
        raises never stops serving."""
        sink = self.event_sink
        if sink is None:
            return
        ev = {"kind": kind, "rid": rid, "timestamp_s": time.time()}
        ev.update(fields)
        try:
            sink(ev)
        except Exception:
            pass

    def _drop_resume_state(self, r: Request) -> None:
        """Discard a request's parked swap entry: it will not resume
        (timeout while waiting, retry budget spent, or retirement after
        a resume through the tree)."""
        if r._swap_handle is not None and self.swap_store is not None:
            self.swap_store.drop(r._swap_handle)
        r._swap_handle = None
        r._swap_pages = 0

    # -- page swap (preemption's host-memory path) ---------------------------
    def _fence(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _swap_out(self, pages: List[int]) -> Optional[int]:
        """Copy ``pages`` of every pool leaf to host memory (pinned when
        the pools are on the card) into the swap store; returns its
        handle, or None when the store's budget refuses the entry (then
        nothing is copied).  The copies go through byte views, as
        ``_swap_in``'s do.  Fenced, so the copy's time is measured."""
        store = self.swap_store
        if not store.admits(len(pages) * self._page_bytes):
            return None
        t0 = time.perf_counter()
        idx = torch.as_tensor(pages, dtype=torch.int64, device=self.device)
        data = []
        for leaf, ax in self._pool_leaves:
            part = leaf.view(torch.uint8).index_select(ax, idx)
            if part.is_cuda:
                host = torch.empty(part.shape, dtype=part.dtype,
                                   pin_memory=True)
                host.copy_(part, non_blocking=True)
                part = host
            data.append(part.view(leaf.dtype))
        self._fence()
        handle = store.put(data, len(pages))
        io = self.swap_copies
        io["pages_out"] += len(pages)
        io["bytes_out"] += store.nbytes(data)
        io["seconds_out"] += time.perf_counter() - t0
        return handle

    def _swap_in(self, pages: List[int], data: List[torch.Tensor]) -> None:
        """Scatter a swap snapshot into ``pages`` of every pool leaf.  The
        copies go through byte views: no dtype conversion, and fp8 codes
        copy where ``index_copy_`` has no kernel for their dtype.  Fenced,
        so the copy's time is measured."""
        t0 = time.perf_counter()
        idx = torch.as_tensor(pages, dtype=torch.int64, device=self.device)
        for (leaf, ax), part in zip(self._pool_leaves, data):
            part = part.to(self.device, non_blocking=True)
            leaf.view(torch.uint8).index_copy_(ax, idx,
                                               part.view(torch.uint8))
        self._fence()
        io = self.swap_copies
        io["pages_in"] += len(pages)
        io["bytes_in"] += sum(int(t.nbytes) for t in data)
        io["seconds_in"] += time.perf_counter() - t0

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

    def _chunk_budget(self, decode_live: bool) -> int:
        """Prefill chunks to run before this decode step: 1, or the
        governor's budget, forced to 1 when nothing decodes (a paused
        chunk queue would idle the engine, not save power)."""
        gov = self.governor
        if gov is None:
            return 1
        budget = gov.prefill_chunk_budget(decode_live)
        if budget < 1 and not decode_live:
            budget = 1
            gov.note_forced_chunk()
        return budget

    def _serve(self, requests: List[Request], slots: _Slots,
               iterate, drain=None) -> List[Request]:
        """The loop both layouts share: sweep deadlines, then one
        ``iterate()`` (admission, prefill, a decode burst) until every
        request is served, all inside one ``serve/batch<N>`` region.  A
        requested drain runs ``drain()`` (where the layout has one) and
        returns at the next checkpoint."""
        agg_id = self._batch_count
        self._batch_count += 1
        total_tokens = sum(r.max_new_tokens for r in requests)
        with self._measure_ctx(agg_id, tokens=total_tokens):
            try:
                while slots.busy():
                    if drain is not None and self._drain_requested:
                        self._drain_requested = False
                        drain()
                        break
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
            return logits, None

        def insert(j: int, row) -> None:
            for live_leaf, leaf in zip(cache_leaves, tree_leaves(row)):
                live_leaf[:, j].copy_(leaf[:, 0])

        def iterate():
            gov = self.governor
            # slot-granular admission: every free slot refills now
            # (blocking) or enters the chunk queue (chunked) instead of
            # waiting for the batch to drain.  A governor gates the rate
            # and picks which waiting request (in-quota tenants first);
            # when it blocks while the engine is idle, the engine admits
            # anyway: power can only be idle draw then, and liveness
            # beats an unholdable cap.
            for j in range(b):
                if not (slots.waiting and slots.free(j)):
                    continue
                k = 0
                if gov is not None:
                    if not gov.admission_allowed():
                        if slots.live() or slots.prefills:
                            break
                        gov.note_forced_admit()
                    else:
                        k = next((i for i, w in enumerate(slots.waiting)
                                  if gov.tenant_allowed(w.tenant)), 0)
                r = slots.waiting[k]
                if self.prefill_chunk:
                    st = self._start_chunked_prefill(r, j)
                    slots.admit(j, st, st.plen, k=k)
                    continue
                # blocking bucketed baseline: the whole prompt now
                st = _Prefill(req=r, slot=j, caches=None, toks=None,
                              plen=len(r.prompt))
                slots.admit(j, st, st.plen, k=k)
                t0 = time.perf_counter()
                first, row, bucket = self._prefill_request(r)
                if slots.live():
                    self.stall_events.append(time.perf_counter() - t0)
                insert(j, row)
                slots.go_live(st, first, bucket)
            slots.update_gauges()
            # one prefill chunk per decode step (a governor's budget: 0
            # while it sheds load, forced back to 1 when nothing decodes,
            # more with ample headroom); with no live decode rows the
            # chunk queue drains back to back.
            if slots.prefills:
                decode_live = bool(slots.live())
                for _ in range(self._chunk_budget(decode_live)):
                    if not slots.prefills:
                        break
                    st = slots.prefills[0]
                    first = self._step_chunked_prefill(st, decode_live)
                    if first is not None:
                        insert(st.slot, st.caches)
                        slots.go_live(st, first, st.plen)
                slots.update_gauges()
            live = slots.live()
            if live:                    # else everything retired at prefill
                if gov is not None:
                    # the last-resort lever: duty-cycle decode while power
                    # exceeds the hard-over threshold
                    gov.maybe_pause_decode()
                slots.decode(live, step)

        return self._serve(requests, slots, iterate)

    # -- paged continuous batching --------------------------------------------
    def _admit_paged(self, r: Request, j: int) -> Optional[_PagedPrefill]:
        """Reserve slot ``j``'s pages for request ``r``: radix-match the
        prompt (mapping cached prefix pages in copy-free), then allocate
        the rest of ``ceil((plen + max_new - 1) / page_size)`` pages up
        front, so decode never waits for a page mid-request.  Returns
        None when the pool cannot cover it now, even after evicting
        tree pages (the caller leaves the request waiting).

        A resume (``r.id`` already set: preempted, drained or
        quarantined with a retry) prefills ``prompt + out`` from the
        checkpoint that covers more, the tree's match or the swap
        snapshot (restored by the caller from ``swap_restore``); its
        already-computed tokens past the checkpoint are booked as waste,
        those before it as recovered, both priced at the learned J per
        prefill token."""
        pool, radix = self._pool, self._radix
        ps = self.kv_page_size
        resume = r.id is not None
        toks_all = list(r.prompt) + list(r.out)
        plen = len(toks_all)
        pages_needed = math.ceil((len(r.prompt) + r.max_new_tokens - 1) / ps)
        matched: List[int] = []
        if radix is not None:
            _, mpages = radix.match(toks_all)
            # cap the match one token short of the prompt: the final
            # chunk must re-run >= 1 token for its logits
            use = min(len(mpages), (plen - 1) // ps)
            if use < len(mpages):
                pool.release(mpages[use:])
            matched = mpages[:use]
        # a parked swap snapshot beats a shorter tree match: the matched
        # refs are dropped and the snapshot restored into fresh pages
        use_swap = resume and r._swap_handle is not None \
            and self.swap_store is not None \
            and r._swap_pages > len(matched)
        need = pages_needed if use_swap else pages_needed - len(matched)
        fresh = pool.alloc(need)
        if fresh is None and radix is not None:
            radix.evict_for(need)
            fresh = pool.alloc(need)
        if fresh is None:
            if matched:
                pool.release(matched)
            return None             # a snapshot stays parked for the next try
        swap_restore = None
        if use_swap:
            if matched:
                pool.release(matched)
            n_restore = r._swap_pages
            swap_restore = (self.swap_store.get(r._swap_handle), n_restore)
            r._swap_handle = None
            r._swap_pages = 0
            slot_pages, mt = fresh, n_restore * ps
        else:
            slot_pages, mt = matched + fresh, len(matched) * ps
            if resume:
                self._drop_resume_state(r)  # the tree won; snapshot stale
        self._slot_pages[j] = slot_pages
        self._page_table[j, :] = 0
        self._page_table[j, :len(slot_pages)] = slot_pages
        if resume:
            jpt = self._prefill_jpt or 0.0
            rec = min(mt, r._progress)
            waste = max(0, r._progress - mt)
            self.preempt_resumes += 1
            self.recovered_tokens += rec
            self.recovered_joules += rec * jpt
            self.wasted_tokens += waste
            self.wasted_joules += waste * jpt
            self.preempt_log.append({
                "event": "resume", "rid": r.id,
                "rerun_tokens": waste, "recovered_tokens": rec,
                "wasted_joules": waste * jpt,
                "recovered_joules": rec * jpt,
                "via": "swap" if swap_restore is not None else
                       ("tree" if mt else "recompute")})
            self._emit_event(
                "preempt_resume", r.id, rerun_tokens=waste,
                recovered_tokens=rec, wasted_joules=waste * jpt,
                recovered_joules=rec * jpt)
            if self.governor is not None:
                self.governor.note_preempt_resume(r.id, rec, waste)
        else:
            self.prefix_hit_tokens += mt
            if mt and self._prefill_jpt is not None:
                self.saved_prefill_joules += mt * self._prefill_jpt
        toks = np.zeros((plen + self.prefill_chunk,), np.int64)
        toks[:plen] = toks_all
        return _PagedPrefill(req=r, slot=j, toks=toks, plen=plen, offset=mt,
                             matched_tokens=mt, swap_restore=swap_restore)

    def _release_slot_pages(self, j: int) -> None:
        if self._slot_pages[j]:
            self._pool.release(self._slot_pages[j])
            self._slot_pages[j] = []
        self._page_table[j, :] = 0

    def _note_watchdog(self, dt: float, steps: int, phase: str) -> None:
        wd = self.watchdog_step_timeout_s
        if wd is not None and dt / max(1, steps) > wd:
            self.hung_steps += 1
            self._emit_event("hung_step", None, phase=phase, elapsed_s=dt,
                             steps=steps)

    def _step_paged_prefills(self, slots: _Slots, decode_live: bool
                             ) -> None:
        """Batched chunk admissions: ONE (B, chunk) dispatch advances
        EVERY pending prefill by one chunk, each row at its own offset;
        passenger rows ride with ``last_idx == -1`` and write nothing.
        Fenced (the token read waits for the device); a stall sample
        when ``decode_live``.  A row that finishes its prefill on
        non-finite logits is quarantined."""
        b, chunk, dev = self.batch, self.prefill_chunk, self.device
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
        ok = torch.isfinite(logits).all(dim=-1)
        done = [st.slot for st in slots.prefills
                if st.offset + chunk >= st.plen]
        if done:
            self._nonfinite += (~ok[torch.as_tensor(done, device=dev)]).sum()
        tok = self._pick(logits)
        # tokens and flags in one host copy: the fence
        tok, okp = torch.stack([tok, ok.to(tok.dtype)]).cpu().numpy()
        dt = time.perf_counter() - t0
        self._note_watchdog(dt, 1, "prefill")
        if decode_live:
            self.stall_events.append(dt)
        for st in list(slots.prefills):
            st.offset += chunk
            if st.offset < st.plen:
                continue
            if not okp[st.slot]:
                slots.prefills.remove(st)
                self._quarantine(slots, st.req, st.slot, "prefill")
                continue
            slots.go_live(st, int(tok[st.slot]), st.plen)

    # -- the preemption plane --------------------------------------------------
    def _checkpoint_pages(self, r: Request, written: List[int],
                          pages: List[int]) -> str:
        """Park a checkpointed request's written full pages for a later
        resume: in the swap store when there is one and it has room (the
        device pages are freed, a restore is sure), else in the radix
        tree (copy-free, pool-resident, evictable: a later miss
        recomputes).  Returns where they went."""
        n_full = len(written) // self.kv_page_size
        if not n_full:
            return "none"
        if self.swap_store is not None:
            handle = self._swap_out(pages[:n_full])
            if handle is not None:
                r._swap_handle = handle
                r._swap_pages = n_full
                return "swap"
        if self._radix is not None:
            self._radix.insert(list(written)[:n_full * self.kv_page_size],
                               pages[:n_full])
            return "tree"
        return "dropped"

    def _requeue(self, slots: _Slots, r: Request) -> None:
        """Back to the waiting queue, behind an exponential backoff."""
        backoff = self.retry_backoff_s * (2 ** (r._preempts - 1)) \
            if self.retry_backoff_s > 0.0 else 0.0
        r._retry_at = _clock() + backoff
        slots.waiting.append(r)

    def _preempt_slot(self, slots: _Slots, j: int) -> None:
        """Preempt the decoding request in slot ``j``: checkpoint its
        written pages, free the slot, requeue it (or retire it
        ``"preempted-retry-exhausted"`` past its budget)."""
        r = slots.active[j]
        r._preempts += 1
        if r._preempts > self.preempt_max_retries:
            self.retries_exhausted += 1
            self._emit_event("retry_exhausted", r.id,
                             preempts=r._preempts - 1)
            slots.retire(j, reason="preempted-retry-exhausted")
            return
        written = list(r.prompt) + r.out[:-1]
        dest = self._checkpoint_pages(r, written, self._slot_pages[j])
        r._progress = len(r.prompt) + len(r.out)
        pages_held = len(self._slot_pages[j])
        self._release_slot_pages(j)
        slots.vacate(j)
        self.preemptions += 1
        self._requeue(slots, r)
        self.preempt_log.append({
            "event": "preempt", "rid": r.id, "dest": dest,
            "pages_held": pages_held, "progress_tokens": r._progress})
        self._emit_event("preempt", r.id, dest=dest, pages=pages_held,
                         progress=r._progress)
        if self.governor is not None:
            self.governor.note_preempt(r.id, pages_held, dest)

    @staticmethod
    def _pick_victim(slots: _Slots, cand: Optional[Request]) -> Optional[int]:
        """The lowest-priority decoding slot (ties: the least progress,
        the least recompute; then the lowest id).  Never preempts up the
        priority order for ``cand``."""
        live = slots.live()
        if not live:
            return None
        act = slots.active
        j = min(live, key=lambda x: (act[x].priority,
                                     len(act[x].prompt) + len(act[x].out),
                                     act[x].id))
        if cand is not None and act[j].priority > cand.priority:
            return None
        return j

    def _quarantine(self, slots: _Slots, r: Request, j: int,
                    phase: str) -> None:
        """The step giving ``r``'s next token had non-finite logits: drop
        its pages (never adopted: poison must not seed the prefix tree),
        close its spans, and retry it from scratch with backoff or retire
        it ``"error"``."""
        self.quarantined += 1
        self._emit_event("quarantine", r.id, phase=phase,
                         tokens_kept=len(r.out))
        if self.governor is not None:
            self.governor.note_quarantine(r.id)
        self._release_slot_pages(j)
        slots.vacate(j)
        self._drop_resume_state(r)
        if self.retry_errors and r._preempts < self.preempt_max_retries:
            r._preempts += 1
            r.out = []              # the poisoned run contributes nothing
            r._progress = 0
            self._requeue(slots, r)
        else:
            r.finish_reason = "error"

    def _drain_checkpoint(self, slots: _Slots, requests: List[Request]
                          ) -> None:
        """Checkpoint every request in flight (decoding ones as a
        preemption does but charging no retry, prefilling ones parking
        the chunks already written), leaving ``finish_reason`` None so
        that a later ``generate()`` resumes them."""
        self.drains += 1
        for j in slots.live():
            r = slots.active[j]
            written = list(r.prompt) + r.out[:-1]
            dest = self._checkpoint_pages(r, written, self._slot_pages[j])
            r._progress = len(r.prompt) + len(r.out)
            self._release_slot_pages(j)
            slots.vacate(j)
            self._emit_event("drain_checkpoint", r.id, dest=dest)
        for st in list(slots.prefills):
            r = st.req
            slots.prefills.remove(st)
            dest = self._checkpoint_pages(r, st.toks[:st.offset].tolist(),
                                          self._slot_pages[st.slot])
            r._progress = st.offset
            self._release_slot_pages(st.slot)
            slots.vacate(st.slot)
            self._emit_event("drain_checkpoint", r.id, dest=dest)
        self._emit_event("drain", None, unfinished=sum(
            1 for r in requests if r.finish_reason is None))

    def _run_paged(self, requests: List[Request]) -> List[Request]:
        """Continuous batching over the page pools.

        Differences from ``_run_continuous``: admission reserves pages
        instead of a cache row, and may wait on the pool as well as on
        slots (or, with ``preempt``, preempt a live request for a fresh
        one); requests backing off after a preemption wait their turn;
        prefill chunks write straight into the shared pools through the
        slot's page-table row, every pending admission's chunk batched
        into one dispatch (``_step_paged_prefills``); decode sees a
        masked page table (mid-prefill and dead rows read and write only
        the scratch page) and flags each row's non-finite steps for the
        quarantine; retirement adopts the request's full pages into the
        radix prefix tree before releasing its references.
        """
        b, dev = self.batch, self.device
        pool, radix, ps = self._pool, self._radix, self.kv_page_size
        caches = self._paged_caches     # pools persist across generate()s
        self._pool_short = False

        def release(j: int, r: Optional[Request], retired: bool) -> None:
            if retired:
                self._drop_resume_state(r)
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
            gov = self.governor
            # A governor's shed request preempts (not drops) the
            # lowest-priority live request; it requeues and resumes once
            # pressure clears.
            if self.preempt_enabled and gov is not None \
                    and gov.consume_shed_request():
                victim = self._pick_victim(slots, None)
                if victim is not None:
                    self._preempt_slot(slots, victim)
            # Everything waiting may be backing off with nothing in
            # flight: sleep the shortest backoff off (in slices) rather
            # than spin on admission.
            if slots.waiting and not slots.prefills and not slots.live():
                nxt = min(w._retry_at for w in slots.waiting)
                now = _clock()
                if nxt > now:
                    _sleep(min(nxt - now, 0.05))
            # Admission: the governor's gate (fed the pool's free fraction)
            # and tenant pick, then page reservation for each free slot,
            # in queue order among the requests not backing off.  A pool too
            # drained to cover the next request defers it (or, with
            # preempt, a fresh one preempts a victim once; a resumed one
            # never does: evicting live work to readmit evicted work
            # would thrash).  An idle engine always admits, since one
            # slot's pages fit the pool (checked in __init__) and an
            # idle pool, after prefix-tree eviction, is wholly free.
            for j in range(b):
                if not (slots.waiting and slots.free(j)):
                    continue
                now = _clock()
                elig = [i for i, w in enumerate(slots.waiting)
                        if w._retry_at <= now]
                if not elig:
                    break
                k = elig[0]
                if gov is not None:
                    free_frac = pool.free_pages / max(1, pool.total_pages)
                    if not gov.admission_allowed(pool_free_frac=free_frac):
                        if slots.live() or slots.prefills:
                            break
                        gov.note_forced_admit()
                    else:
                        k = next((i for i in elig if gov.tenant_allowed(
                            slots.waiting[i].tenant)), elig[0])
                cand = slots.waiting[k]
                st = self._admit_paged(cand, j)
                if st is None and self.preempt_enabled and cand.id is None:
                    victim = self._pick_victim(slots, cand)
                    if victim is not None:
                        self._preempt_slot(slots, victim)
                        st = self._admit_paged(cand, j)
                if st is None:
                    # count each episode of waiting on pages once, and
                    # tell the governor of it
                    if not self._pool_short:
                        self._pool_short = True
                        self.pool_wait_events += 1
                        if gov is not None:
                            gov.note_pool_wait(pool.free_pages, math.ceil(
                                (len(cand.prompt) + cand.max_new_tokens
                                 - 1) / ps))
                    break
                if self._pool_short:
                    self._pool_short = False
                    if gov is not None:
                        gov.note_pool_ready()
                # the phase span counts the tokens actually prefilled: a
                # prefix hit or a restore shrinks the work
                slots.admit(j, st, st.plen - st.matched_tokens, k=k,
                            resume=cand.id is not None)
                if st.swap_restore is not None:
                    # the snapshot goes into the fresh pages; prefill then
                    # continues at its edge
                    data, npg = st.swap_restore
                    st.swap_restore = None
                    self._swap_in(self._slot_pages[j][:npg], data)
            slots.update_gauges()
            if slots.prefills:
                decode_live = bool(slots.live())
                for _ in range(self._chunk_budget(decode_live)):
                    if not slots.prefills:
                        break
                    self._step_paged_prefills(slots, decode_live)
                slots.update_gauges()
            live = slots.live()
            if not live:
                return                  # everything retired at prefill
            if gov is not None:
                gov.maybe_pause_decode()
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
                ok = torch.isfinite(logits).all(dim=-1)
                self._nonfinite += (~ok[live_dev]).sum()
                return logits, ok

            slots.decode(
                live, step,
                on_poison=lambda j: self._quarantine(
                    slots, slots.active[j], j, "decode"),
                watchdog=lambda dt, n: self._note_watchdog(dt, n, "decode"))

        return self._serve(requests, slots, iterate,
                           drain=lambda: self._drain_checkpoint(slots,
                                                                requests))

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
