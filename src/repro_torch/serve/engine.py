"""Continuous-batching serve engine with chunked prefill.

The PyTorch counterpart of the JAX package's ``serve/engine.py`` in its
main mode: ``mode="continuous"``, ``kv_layout="contiguous"``, chunked
admission, greedy decoding.

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

Still to come, each with its slice (see ROADMAP.md), and refused here:
sampling (``greedy=False``), the blocking ``prefill_chunk=0`` baseline,
``mode="wave"``, ``kv_layout="paged"``, preemption and swap, quantized
``cache_dtype``, and the power governor.
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
from repro_torch.models import model as model_mod
from repro_torch.models.blocks import layer_window


def stall_p95(events) -> float:
    """p95 of the engine's ``stall_events`` samples (nearest rank on the
    inclusive index), as the JAX engine reports it."""
    if not events:
        return 0.0
    xs = sorted(events)
    return float(xs[min(len(xs) - 1, int(round(0.95 * (len(xs) - 1))))])


def resolve_prefill_chunk(cfg: ModelConfig,
                          prefill_chunk: Optional[int]) -> int:
    """Engine arg beats the ``PMT_PREFILL_CHUNK`` env var beats
    ``cfg.prefill_chunk``."""
    if prefill_chunk is None:
        env = os.environ.get("PMT_PREFILL_CHUNK")
        prefill_chunk = int(env) if env else cfg.prefill_chunk
    if prefill_chunk < 0:
        raise ValueError(f"prefill_chunk must be >= 0, got {prefill_chunk}")
    if prefill_chunk == 0:
        raise NotImplementedError(
            "prefill_chunk=0 (blocking bucketed admission) comes with the "
            "whole-prompt prefill slice")
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
    """An admission mid-chunked-prefill: its slot is reserved and its
    batch-1 cache row is being built chunk by chunk."""

    req: Request
    slot: int
    caches: Any                     # batch-1 cache tree under construction
    toks: np.ndarray                # (1, padded) right-padded prompt
    plen: int
    offset: int = 0


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    return [tree]


class ServeEngine:
    """Continuous-batching decode over fixed slots with chunked prefill.

    Args:
      cfg, params: model config and parameter tree (``init_params`` or
        ``bridge.params_from_numpy``); weight matrices are cast once to
        ``cfg.dtype`` and moved to the engine's device.
      batch_size: number of decode slots.
      max_len: KV-cache capacity per slot.  A request needs
        ``ceil(plen / chunk) * chunk <= max_len`` and
        ``plen + max_new_tokens <= max_len + 1``.
      monitor / session: per-request and aggregate energy accounting, as
        in the JAX engine (monitor wins when both are given).
      prefill_chunk: chunk size; None resolves ``PMT_PREFILL_CHUNK`` then
        ``cfg.prefill_chunk``.
      cache_dtype: KV storage dtype: torch.bfloat16 or torch.float32, or
        its name (the kernels take those two).
      device: where the engine runs; the card unless "cpu" is asked for.
      mode, kv_layout, governor, preempt, swap_store, greedy: accepted
        at their defaults only; other values belong to later slices and
        raise.
    """

    def __init__(self, cfg: ModelConfig, params, batch_size: int,
                 max_len: int, monitor=None, session=None,
                 mode: str = "continuous",
                 prefill_chunk: Optional[int] = None,
                 governor=None, kv_layout: str = "contiguous",
                 preempt: bool = False, swap_store=None,
                 greedy: bool = True,
                 cache_dtype: Union[str, torch.dtype] = torch.bfloat16,
                 device=None):
        later = {
            "mode='wave'": mode != "continuous",
            "kv_layout='paged'": kv_layout != "contiguous",
            "governor": governor is not None,
            "preempt": bool(preempt),
            "swap_store": swap_store is not None,
            "sampling (greedy=False)": not greedy,
        }
        for what, hit in later.items():
            if hit:
                raise NotImplementedError(
                    f"{what} is not ported yet (see ROADMAP.md)")
        if isinstance(cache_dtype, str):
            named = {"bfloat16": torch.bfloat16, "float32": torch.float32}
            if cache_dtype in ("int8", "fp8_e4m3"):
                raise NotImplementedError(
                    f"cache_dtype {cache_dtype!r} comes with the "
                    "quantized-cache slice")
            if cache_dtype not in named:
                raise ValueError(f"unknown cache_dtype {cache_dtype!r}; "
                                 f"expected one of {sorted(named)}")
            cache_dtype = named[cache_dtype]
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = model_mod.serving_params(cfg, params, self.device)
        self.batch = batch_size
        self.max_len = max_len
        self.monitor = monitor
        self.session = session
        self.mode = "continuous"
        self.kv_layout = "contiguous"
        self.cache_dtype = cache_dtype
        self.prefill_chunk = resolve_prefill_chunk(cfg, prefill_chunk)
        if self.prefill_chunk > max_len:
            if prefill_chunk is not None:
                raise ValueError(f"prefill_chunk {self.prefill_chunk} "
                                 f"exceeds max_len {max_len}")
            self.prefill_chunk = max_len
        self._fns = model_mod.make_serve_fns(cfg)
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

    # -- measurement contexts ----------------------------------------------
    def _measure_ctx(self, agg_id: int, tokens: int):
        if self.monitor is not None:
            return self.monitor.measure_step(agg_id, tokens=tokens,
                                             blocking=False)
        if self.session is not None:
            return self.session.region(f"serve/batch{agg_id}", tokens=tokens)
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
        chunk = self.prefill_chunk
        for r in requests:
            if r.max_new_tokens < 1:
                raise ValueError("max_new_tokens must be >= 1")
            if r.deadline_s is not None and r.deadline_s <= 0:
                raise ValueError(f"deadline_s must be > 0, got {r.deadline_s}")
            if r.finish_reason is not None:
                r.id = None             # a completed request: serve afresh
                r.out = []
            r.finish_reason = None
            plen = len(r.prompt)
            padded = math.ceil(plen / chunk) * chunk
            if padded > self.max_len \
                    or plen + r.max_new_tokens > self.max_len + 1:
                raise ValueError(
                    f"request needs {max(padded, plen + r.max_new_tokens - 1)} "
                    f"cache slots (chunk-padded prompt / prompt + "
                    f"max_new_tokens) but max_len is {self.max_len}")
        self.stall_events = []
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
            "kv_cache": {
                "cache_dtype": str(self.cache_dtype).replace("torch.", ""),
                "bytes_per_token": self.cache_bytes_per_token(),
            },
            "preemption": {
                "enabled": False, "preemptions": 0, "resumes": 0,
                "retries_exhausted": 0, "wasted_tokens": 0,
                "wasted_joules": 0.0, "recovered_tokens": 0,
                "recovered_joules": 0.0, "quarantined": 0,
                "hung_steps": 0, "drains": 0,
            },
        }

    def cache_bytes_per_token(self) -> float:
        """KV-cache bytes per cached token position, all layers summed,
        over ``batch * max_len`` positions (ring layers hold fewer)."""
        cfg = self.cfg
        item = torch.empty((), dtype=self.cache_dtype).element_size()
        total = 0
        for idx in range(cfg.num_layers):
            window = layer_window(cfg, idx)
            size = min(self.max_len, window) if window else self.max_len
            total += 2 * self.batch * size * cfg.num_kv_heads \
                * cfg.head_dim * item
        return total / max(1, self.batch * self.max_len)

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
        tok = int(logits.argmax(dim=-1)[0])         # fence the chunk
        if decode_live:
            self.stall_events.append(time.perf_counter() - t0)
        return tok if final else None

    def _run_continuous(self, requests: List[Request]) -> List[Request]:
        b = self.batch
        chunk = self.prefill_chunk
        dev = self.device
        waiting = list(requests)
        caches = model_mod.init_caches(self.cfg, b, self.max_len,
                                       dtype=self.cache_dtype, device=dev)
        cache_leaves = _leaves(caches)
        tokens = np.zeros((b, 1), np.int64)
        pos = np.zeros((b,), np.int32)
        active: List[Optional[Request]] = [None] * b
        remaining = [0] * b
        req_ctxs: List[Any] = [None] * b
        pf_ctxs: List[Any] = [None] * b
        dec_ctxs: List[Any] = [None] * b
        prefills: Deque[_Prefill] = collections.deque()
        reserved = [False] * b                   # slot held by a prefill
        deadlines = {id(r): time.monotonic() + r.deadline_s
                     for r in requests if r.deadline_s is not None}
        total_tokens = sum(r.max_new_tokens for r in requests)
        agg_id = self._batch_count
        self._batch_count += 1

        def open_ctx(rid, tokens_, phase=None):
            ctx = self._request_ctx(rid, tokens=tokens_, phase=phase)
            ctx.__enter__()
            return ctx

        def close_ctx(ctx):
            if ctx is not None:
                ctx.__exit__(None, None, None)

        def activate(j: int, st: _Prefill, first: int) -> None:
            """Request ``st.req`` finished prefill: its row goes live in
            slot j.  The decode span opens before the row insert so the
            prefill/decode spans tile the request span."""
            r = st.req
            dec_ctxs[j] = open_ctx(r.id, r.max_new_tokens, phase="decode")
            for live, row in zip(cache_leaves, _leaves(st.caches)):
                live[:, j].copy_(row[:, 0])
            tokens[j, 0] = first
            pos[j] = st.plen
            remaining[j] = r.max_new_tokens - 1
            active[j] = r
            r.out.append(first)
            if remaining[j] == 0:
                retire(j)

        def retire(j: int, reason: str = "length") -> None:
            # The caller already fenced this slot's last token.
            active[j].finish_reason = reason
            close_ctx(dec_ctxs[j])
            dec_ctxs[j] = None
            close_ctx(req_ctxs[j])
            req_ctxs[j] = None
            active[j] = None

        def sweep_deadlines() -> None:
            """Retire every request past its deadline — waiting, mid-
            prefill (free the reserved slot), or mid-decode (keep the
            tokens generated so far)."""
            if not deadlines:
                return
            now = time.monotonic()

            def expired(r: Request) -> bool:
                dl = deadlines.get(id(r))
                return dl is not None and now > dl

            kept = []
            for r in waiting:
                if expired(r):
                    r.finish_reason = "timeout"
                    self._timeouts += 1
                else:
                    kept.append(r)
            waiting[:] = kept
            for st in [st for st in prefills if expired(st.req)]:
                prefills.remove(st)
                reserved[st.slot] = False
                close_ctx(pf_ctxs[st.slot])
                pf_ctxs[st.slot] = None
                close_ctx(req_ctxs[st.slot])
                req_ctxs[st.slot] = None
                st.req.finish_reason = "timeout"
                self._timeouts += 1
            for j in range(b):
                if active[j] is not None and expired(active[j]):
                    retire(j, reason="timeout")
                    self._timeouts += 1

        def update_gauges():
            self.queue_depth = len(waiting)
            self.live_slots = sum(1 for a in active if a is not None) \
                + sum(reserved)
            self.pending_prefill_chunks = sum(
                max(0, st.toks.shape[1] - st.offset) // chunk
                for st in prefills)

        with self._measure_ctx(agg_id, tokens=total_tokens):
            try:
                while waiting or prefills \
                        or any(r is not None for r in active):
                    sweep_deadlines()
                    update_gauges()
                    # slot-granular admission: every free slot enters the
                    # chunk queue now instead of waiting for the batch to
                    # drain.
                    for j in range(b):
                        if active[j] is not None or reserved[j] \
                                or not waiting:
                            continue
                        r = self._admit(waiting.pop(0))
                        req_ctxs[j] = open_ctx(r.id, r.max_new_tokens)
                        pf_ctxs[j] = open_ctx(r.id, len(r.prompt),
                                              phase="prefill")
                        reserved[j] = True
                        prefills.append(self._start_chunked_prefill(r, j))
                    update_gauges()

                    # one prefill chunk per decode step; with no live
                    # decode rows the chunk queue drains back to back.
                    if prefills:
                        decode_live = any(a is not None for a in active)
                        st = prefills[0]
                        first = self._step_chunked_prefill(st, decode_live)
                        if first is not None:
                            prefills.popleft()
                            reserved[st.slot] = False
                            close_ctx(pf_ctxs[st.slot])
                            pf_ctxs[st.slot] = None
                            activate(st.slot, st, first)
                        update_gauges()

                    live = [j for j in range(b) if active[j] is not None]
                    if not live:
                        continue          # everything retired at prefill
                    # Retirement is deterministic (exactly max_new_tokens
                    # per request), so with no admission work pending
                    # decode runs on the device until the next slot
                    # retires.  While prefill chunks are pending, decode
                    # advances one step per chunk.  Inactive rows decode
                    # garbage into their own (dead) cache rows only.
                    steps = 1 if prefills \
                        else min(remaining[j] for j in live)
                    if steps > 1 and deadlines \
                            and any(id(active[j]) in deadlines
                                    for j in live):
                        # a deadline'd request must pass the sweep
                        # between bursts: bound the device-side run.
                        steps = min(steps, 8)
                    tok_dev = torch.as_tensor(tokens, device=dev)
                    pos_dev = torch.as_tensor(pos, device=dev)
                    outs = []
                    for _ in range(steps):
                        logits = self._fns.decode(self.params, caches,
                                                  tok_dev, pos_dev)
                        self._count_nonfinite(logits)
                        tok_dev = logits.argmax(dim=-1, keepdim=True)
                        outs.append(tok_dev)
                        pos_dev = pos_dev + 1
                    gen = torch.cat(outs, dim=1).cpu().numpy()
                    # the host read waited for every step, so spans
                    # closed below are fenced.
                    for j in live:
                        r = active[j]
                        r.out.extend(gen[j].tolist())
                        tokens[j, 0] = gen[j, -1]
                        pos[j] += steps
                        remaining[j] -= steps
                        if remaining[j] == 0:
                            retire(j)
            finally:
                # An exception mid-loop must not leak open request/phase
                # spans: they pin the shared session's sampler.
                prefills.clear()
                waiting.clear()
                reserved[:] = [False] * b
                active[:] = [None] * b
                update_gauges()
                for j in range(b):
                    close_ctx(pf_ctxs[j])
                    pf_ctxs[j] = None
                    close_ctx(dec_ctxs[j])
                    dec_ctxs[j] = None
                    close_ctx(req_ctxs[j])
                    req_ctxs[j] = None
        return requests
