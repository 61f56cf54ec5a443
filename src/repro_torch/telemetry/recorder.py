"""``PowerRecorder`` — the bounded in-memory store behind the telemetry
plane.

One recorder aggregates three live streams without perturbing any of
them:

  * **Resolved region records** — subscribe the recorder to a session's
    :class:`~repro_torch.core.export.MemoryExporter` (:meth:`attach`); every
    ``RegionRecord`` the background resolver emits lands in an
    append-only bounded ring and fans out to the recorder's own
    subscribers (the SSE stream).  The callback obeys the
    subscriber-exporter contract: append + notify, no blocking work.
  * **Step/request energy** — :meth:`attach_monitor` taps a
    ``PowerMonitor.subscribe`` stream of ``StepEnergy`` records for
    engines measuring through a monitor instead of a raw session.
  * **Watts timelines** — a poll thread copies each backend ring
    sampler's seqlock-read ``timeline()`` tail into a per-backend
    bounded deque.  Readers of a ``RingSampler`` never block its
    writer, so polling is free of measurement-plane side effects.
    Tests (and the governor's deterministic unit tests) can bypass the
    poller entirely with :meth:`add_watts`.

The :class:`~repro_torch.serve.governor.PowerGovernor` reads its control
signal here (:meth:`mean_watts` over a trailing window), and the
:class:`~repro_torch.telemetry.server.TelemetryServer` serves every endpoint
straight off this object — the recorder is the single point of truth
between measurement and both consumers.
"""
from __future__ import annotations

import collections
import json
import math
import re
import threading
import warnings
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

from repro_torch.core.export import MemoryExporter, RegionRecord


class WattsSample(NamedTuple):
    backend: str
    timestamp_s: float
    watts: float


class HealthEvent(NamedTuple):
    """One backend health-state transition (ok/degraded/failed), as
    observed by the recorder's poll loop.  Fans out on the SSE stream
    (``event: health``) and is retained for the ``/health`` endpoint."""

    backend: str
    timestamp_s: float
    state: str           # ok | degraded | failed
    prev_state: str
    detail: str = ""

    def as_json(self) -> str:
        return json.dumps(self._asdict(), sort_keys=True)


class PreemptEvent(NamedTuple):
    """One serve-engine preemption-plane event (preempt, resume,
    quarantine, hung step, drain, ...), ingested via the engine's
    ``event_sink`` hook.  Fans out on the SSE stream
    (``event: preempt``) and is retained for ``/stats`` clients."""

    kind: str            # preempt | preempt_resume | quarantine |
                         # hung_step | retry_exhausted | drain_checkpoint
                         # | drain
    rid: Optional[int]   # request id (None for engine-wide events)
    timestamp_s: float
    fields: Dict[str, Any]

    def as_json(self) -> str:
        d = {"kind": self.kind, "rid": self.rid,
             "timestamp_s": self.timestamp_s}
        d.update(self.fields)
        return json.dumps(d, sort_keys=True)


_REQ_PATH = re.compile(r"^serve/req(\d+)(?:/(\w+))?$")


class PowerRecorder:
    """Bounded, thread-safe aggregation point for live power telemetry.

    Args:
      watts_capacity: per-backend bound on retained watts samples.
      record_capacity: bound on retained resolved records (region and
        step records each get their own ring of this size).  Older
        entries fall off the front; ``stats()`` counts total appends so
        truncation is visible, never silent.
      poll_period_s: sampler poll period for sessions attached via
        :meth:`attach` (clamped to >= 10 ms so a misconfigured poller
        cannot busy-spin against the seqlock).
    """

    def __init__(self, watts_capacity: int = 65536,
                 record_capacity: int = 8192,
                 poll_period_s: float = 0.05):
        self._lock = threading.Lock()
        self._watts_cap = int(watts_capacity)
        self._watts: "collections.OrderedDict[str, collections.deque]" = \
            collections.OrderedDict()
        self._records: collections.deque = \
            collections.deque(maxlen=int(record_capacity))
        self._steps: collections.deque = \
            collections.deque(maxlen=int(record_capacity))
        self._total_records = 0      # appends ever (ring may have dropped)
        self._total_steps = 0
        self._total_watts = 0
        self._subs: List[Callable[[RegionRecord], None]] = []
        # Health events get their own subscriber list: record
        # subscribers (e.g. the governor's quota accounting) index into
        # RegionRecord fields and would break on a HealthEvent.
        self._health_subs: List[Callable[[HealthEvent], None]] = []
        self._health_events: collections.deque = \
            collections.deque(maxlen=1024)
        self._total_health_events = 0
        self._last_health_state: Dict[str, str] = {}
        # Preemption-plane events mirror the health-event design: their
        # own ring + subscriber list (record subscribers index into
        # RegionRecord fields and would break on a PreemptEvent).
        self._preempt_subs: List[Callable[[PreemptEvent], None]] = []
        self._preempt_events: collections.deque = \
            collections.deque(maxlen=1024)
        self._total_preempt_events = 0
        self._unsubs: List[Callable[[], None]] = []
        self._stats_providers: List[Callable[[], Dict[str, Any]]] = []
        self._engine = None
        self._poll_period_s = max(0.010, float(poll_period_s))
        self._poll_stop = threading.Event()
        self._poll_thread: Optional[threading.Thread] = None
        self._poll_sources: List[Tuple[str, Any]] = []
        self._poll_last_t: Dict[str, float] = {}
        self._closed = False

    # -- ingestion ----------------------------------------------------------
    def on_record(self, rec: RegionRecord) -> None:
        """Exporter-subscriber callback: append + fan out, never block."""
        with self._lock:
            self._records.append(rec)
            self._total_records += 1
            subs = list(self._subs)
        for fn in subs:
            try:
                fn(rec)
            except Exception as e:
                self._drop_subscriber(fn)
                warnings.warn(
                    f"PowerRecorder subscriber {fn!r} raised "
                    f"{type(e).__name__}: {e}; subscriber dropped")

    def on_step_energy(self, se) -> None:
        """``PowerMonitor.subscribe`` callback (StepEnergy stream)."""
        with self._lock:
            self._steps.append(se)
            self._total_steps += 1

    def on_preempt_event(self, ev: Dict[str, Any]) -> None:
        """Engine ``event_sink`` callback: one preemption-plane event as
        a plain dict (``kind``/``rid``/``timestamp_s`` + extras).
        Append + fan out, never block — same contract as
        :meth:`on_record`."""
        d = dict(ev)
        pe = PreemptEvent(
            kind=str(d.pop("kind", "unknown")),
            rid=d.pop("rid", None),
            timestamp_s=float(d.pop("timestamp_s", 0.0)),
            fields=d)
        with self._lock:
            self._preempt_events.append(pe)
            self._total_preempt_events += 1
            subs = list(self._preempt_subs)
        for fn in subs:
            try:
                fn(pe)
            except Exception as e:
                warnings.warn(
                    f"PowerRecorder preempt subscriber {fn!r} raised "
                    f"{type(e).__name__}: {e}")

    def add_watts(self, backend: str, timestamp_s: float,
                  watts: float) -> None:
        """Inject one watts sample directly (tests, synthetic traces)."""
        if not math.isfinite(watts):
            return
        with self._lock:
            ring = self._watts.get(backend)
            if ring is None:
                ring = self._watts[backend] = collections.deque(
                    maxlen=self._watts_cap)
            ring.append((float(timestamp_s), float(watts)))
            self._total_watts += 1

    # -- wiring -------------------------------------------------------------
    def attach(self, session, exporter: Optional[MemoryExporter] = None
               ) -> "PowerRecorder":
        """Wire this recorder to ``session``: subscribe to a
        ``MemoryExporter`` (added to the session if not supplied) and
        start polling the session's ring samplers for watts timelines.
        Idempotent per session is *not* attempted — attach once.
        """
        if exporter is None:
            exporter = session.add_exporter(MemoryExporter())
        self._unsubs.append(exporter.subscribe(self.on_record))
        with self._lock:
            self._poll_sources.extend(session.samplers())
        self._ensure_poll_thread()
        return self

    def attach_monitor(self, monitor) -> "PowerRecorder":
        """Tap a ``PowerMonitor``'s settled StepEnergy stream."""
        self._unsubs.append(monitor.subscribe(self.on_step_energy))
        return self

    def attach_engine(self, engine) -> "PowerRecorder":
        """Bind a ``ServeEngine``: its counters join :meth:`stats` and
        its per-request tenant map labels :meth:`request_energy`.  An
        engine exposing ``on_record`` (paged mode's prefill
        joules-per-token estimator behind ``saved_prefill_joules``) is
        additionally subscribed to the resolved-record stream, and an
        engine exposing ``event_sink`` gets its preemption-plane events
        routed into :meth:`on_preempt_event`."""
        self._engine = engine
        self.add_stats_provider(engine.stats)
        if hasattr(engine, "on_record"):
            self._unsubs.append(self.subscribe(engine.on_record))
        if hasattr(engine, "event_sink"):
            engine.event_sink = self.on_preempt_event
        return self

    def add_stats_provider(self, fn: Callable[[], Dict[str, Any]]) -> None:
        """Register a callable contributing keys to :meth:`stats` (the
        serve engine's counters ride in this way)."""
        with self._lock:
            self._stats_providers.append(fn)

    def subscribe(self, fn: Callable[[RegionRecord], None]
                  ) -> Callable[[], None]:
        """Register ``fn`` for every future region record (SSE fan-out);
        returns an unsubscribe.  Same contract as the exporter's:
        called on the resolving thread, must not block, dropped with a
        warning if it raises."""
        with self._lock:
            self._subs.append(fn)

        def unsubscribe() -> None:
            self._drop_subscriber(fn)

        return unsubscribe

    def subscribe_health(self, fn: Callable[[HealthEvent], None]
                         ) -> Callable[[], None]:
        """Register ``fn`` for backend health transitions (SSE fan-out);
        returns an unsubscribe.  Same non-blocking contract as
        :meth:`subscribe`."""
        with self._lock:
            self._health_subs.append(fn)

        def unsubscribe() -> None:
            with self._lock:
                for i, sub in enumerate(self._health_subs):
                    if sub is fn:
                        del self._health_subs[i]
                        break

        return unsubscribe

    def subscribe_preempt(self, fn: Callable[[PreemptEvent], None]
                          ) -> Callable[[], None]:
        """Register ``fn`` for serve-engine preemption-plane events
        (SSE fan-out); returns an unsubscribe.  Same non-blocking
        contract as :meth:`subscribe`."""
        with self._lock:
            self._preempt_subs.append(fn)

        def unsubscribe() -> None:
            with self._lock:
                for i, sub in enumerate(self._preempt_subs):
                    if sub is fn:
                        del self._preempt_subs[i]
                        break

        return unsubscribe

    def _drop_subscriber(self, fn) -> None:
        with self._lock:
            for i, sub in enumerate(self._subs):
                if sub is fn:
                    del self._subs[i]
                    break

    # -- sampler polling ----------------------------------------------------
    def _ensure_poll_thread(self) -> None:
        with self._lock:
            if self._poll_thread is not None or self._closed:
                return
            self._poll_thread = threading.Thread(
                target=self._poll_loop, name="pmt-telemetry-poll",
                daemon=True)
        self._poll_thread.start()

    def _poll_loop(self) -> None:
        while not self._poll_stop.wait(self._poll_period_s):
            self.poll_once()

    def poll_once(self) -> int:
        """Copy each attached sampler's new watts samples in; returns
        how many samples were ingested (also callable directly for
        deterministic tests)."""
        with self._lock:
            sources = list(self._poll_sources)
        n = 0
        for name, sampler in sources:
            try:
                ts, _js, ws = sampler.timeline()
            except Exception:
                continue          # sampler stopped underneath us: stale
            last = self._poll_last_t.get(name, float("-inf"))
            for t, w in zip(ts, ws):
                if t > last and math.isfinite(w):
                    self.add_watts(name, float(t), float(w))
                    n += 1
            if len(ts):
                self._poll_last_t[name] = float(ts[-1])
        self._poll_health(sources)
        return n

    def _poll_health(self, sources) -> None:
        """Watch each sampler's health state; emit a :class:`HealthEvent`
        on every transition (first observation included when not ok)."""
        for name, sampler in sources:
            health_fn = getattr(sampler, "health", None)
            if not callable(health_fn):
                continue
            try:
                h = health_fn()
            except Exception:
                continue          # sampler stopped underneath us
            state = h.get("state", "ok")
            with self._lock:
                prev = self._last_health_state.get(name)
                if prev == state:
                    continue
                self._last_health_state[name] = state
                if prev is None and state == "ok":
                    continue      # don't announce the healthy baseline
                sup = h.get("supervisor") or {}
                ev = HealthEvent(
                    backend=name,
                    timestamp_s=float(sampler.last_ts())
                    if math.isfinite(sampler.last_ts()) else 0.0,
                    state=state, prev_state=prev or "ok",
                    detail=f"read_errors={h.get('read_errors', 0)} "
                           f"gaps={h.get('gaps', 0)} "
                           f"active={sup.get('active_backend', name)}")
                self._health_events.append(ev)
                self._total_health_events += 1
                subs = list(self._health_subs)
            for fn in subs:
                try:
                    fn(ev)
                except Exception as e:
                    warnings.warn(
                        f"PowerRecorder health subscriber {fn!r} raised "
                        f"{type(e).__name__}: {e}")

    # -- reads --------------------------------------------------------------
    def watts_series(self, backend: Optional[str] = None,
                     since: Optional[float] = None
                     ) -> Dict[str, List[List[float]]]:
        """``{backend: [[timestamp_s, watts], ...]}`` power series."""
        with self._lock:
            items = [(b, list(ring)) for b, ring in self._watts.items()
                     if backend is None or b == backend]
        out: Dict[str, List[List[float]]] = {}
        for b, samples in items:
            if since is not None:
                samples = [s for s in samples if s[0] > since]
            out[b] = [[t, w] for t, w in samples]
        return out

    def mean_watts(self, window_s: float, backend: Optional[str] = None,
                   now: Optional[float] = None) -> Optional[float]:
        """Smoothed power over the trailing ``window_s`` seconds —
        the governor's control signal.

        Per backend: the mean of samples newer than ``now - window_s``
        (falling back to the single newest sample when the window is
        empty, so a slow-ticking backend still reports).  Multiple
        backends sum — the cap is a budget on total draw.  Returns
        ``None`` when no backend has any sample yet.
        """
        with self._lock:
            items = [(b, list(ring)) for b, ring in self._watts.items()
                     if backend is None or b == backend]
        total = None
        for _b, samples in items:
            if not samples:
                continue
            if now is None:
                t_now = samples[-1][0]
            else:
                t_now = now
            cut = t_now - window_s
            win = [w for t, w in samples if t >= cut]
            mean = (sum(win) / len(win)) if win else samples[-1][1]
            total = mean if total is None else total + mean
        return total

    def last_watts_ts(self, backend: Optional[str] = None
                      ) -> Optional[float]:
        """Timestamp of the newest watts sample (``None`` if none yet) —
        the governor's signal-TTL staleness check.  With multiple
        backends summed into one control signal, the *oldest* newest
        sample governs: the summed signal is only as fresh as its most
        stale contributor."""
        with self._lock:
            newest = [ring[-1][0] for b, ring in self._watts.items()
                      if ring and (backend is None or b == backend)]
        return min(newest) if newest else None

    def health(self) -> Dict[str, Any]:
        """Measurement-plane health for the ``/health`` endpoint:
        per-backend sampler/supervisor snapshots + recent transitions."""
        with self._lock:
            sources = list(self._poll_sources)
            events = list(self._health_events)
        backends: Dict[str, Any] = {}
        worst = "ok"
        rank = {"ok": 0, "degraded": 1, "failed": 2}
        for name, sampler in sources:
            health_fn = getattr(sampler, "health", None)
            if not callable(health_fn):
                continue
            try:
                h = health_fn()
            except Exception as e:
                h = {"state": "failed", "error": f"{type(e).__name__}: {e}"}
            backends[name] = h
            state = h.get("state", "ok")
            if rank.get(state, 0) > rank[worst]:
                worst = state
        return {
            "state": worst,
            "backends": backends,
            "events": [ev._asdict() for ev in events],
            "health_events": self._total_health_events,
        }

    def health_events(self) -> List[HealthEvent]:
        with self._lock:
            return list(self._health_events)

    def preempt_events(self) -> List[PreemptEvent]:
        with self._lock:
            return list(self._preempt_events)

    def records(self) -> List[RegionRecord]:
        with self._lock:
            return list(self._records)

    def step_records(self) -> List[Any]:
        with self._lock:
            return list(self._steps)

    def request_energy(self, tenant: Optional[str] = None
                       ) -> Dict[int, Dict[str, Any]]:
        """Per-request energy as seen through the recorder.

        Aggregates ``serve/req<N>`` (and ``.../prefill``, ``.../decode``)
        region records — and, for monitor-driven engines, StepEnergy
        records with ``scope == "request"`` — into
        ``{request_id: {joules, seconds, tokens, j_per_token,
        prefill_joules, decode_joules, records: [...]}}``.  ``records``
        holds each contributing region record's ``as_json()`` string, so
        a client can round-trip the exact resolved records
        (``RegionRecord.from_json``) bit-faithfully.

        When an engine is attached (:meth:`attach_engine`) each bucket
        carries the request's ``tenant``, and ``tenant=`` filters the
        result to that tenant's requests.
        """
        out: Dict[int, Dict[str, Any]] = {}
        engine = self._engine
        tenants: Dict[int, str] = {}
        if engine is not None:
            tenants = dict(getattr(engine, "request_tenants", {}))

        def bucket(rid: int) -> Dict[str, Any]:
            return out.setdefault(rid, {
                "joules": 0.0, "seconds": 0.0, "tokens": 0,
                "prefill_joules": 0.0, "decode_joules": 0.0,
                "tenant": tenants.get(rid),
                "records": []})

        for rec in self.records():
            m = _REQ_PATH.match(rec.path)
            if not m:
                continue
            rid, phase = int(m.group(1)), m.group(2)
            d = bucket(rid)
            d["records"].append(rec.as_json())
            if phase is None:
                d["joules"] += rec.joules
                d["seconds"] = max(d["seconds"], rec.seconds)
                d["tokens"] = rec.tokens or d["tokens"]
            else:
                d[f"{phase}_joules"] = d.get(f"{phase}_joules", 0.0) \
                    + rec.joules
        for se in self.step_records():
            if getattr(se, "scope", None) != "request":
                continue
            d = bucket(se.step)
            if se.phase is None:
                d["joules"] += se.joules
                d["seconds"] = max(d["seconds"], se.seconds)
                d["tokens"] = se.tokens or d["tokens"]
            else:
                d[f"{se.phase}_joules"] = d.get(f"{se.phase}_joules", 0.0) \
                    + se.joules
        for d in out.values():
            d["j_per_token"] = d["joules"] / max(d["tokens"], 1)
        if tenant is not None:
            out = {rid: d for rid, d in out.items()
                   if d["tenant"] == tenant}
        return out

    def stats(self) -> Dict[str, Any]:
        """Recorder counters merged with every registered stats
        provider's dict (provider keys win on collision)."""
        with self._lock:
            out: Dict[str, Any] = {
                "records": self._total_records,
                "records_retained": len(self._records),
                "step_records": self._total_steps,
                "watts_samples": self._total_watts,
                "watts_backends": {b: len(ring)
                                   for b, ring in self._watts.items()},
                "subscribers": len(self._subs),
                "health_events": self._total_health_events,
                "preempt_events": self._total_preempt_events,
                "backend_health": dict(self._last_health_state),
            }
            providers = list(self._stats_providers)
        for fn in providers:
            try:
                out.update(fn())
            except Exception as e:
                out.setdefault("stats_provider_errors", []).append(
                    f"{type(e).__name__}: {e}")
        return out

    # -- lifecycle ----------------------------------------------------------
    def close(self) -> None:
        """Stop the poll thread and detach every subscription
        (idempotent).  Retained data stays readable after close."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            thread = self._poll_thread
            self._poll_thread = None
            unsubs, self._unsubs = self._unsubs, []
        self._poll_stop.set()
        if thread is not None:
            thread.join(timeout=5.0)
        for unsub in unsubs:
            try:
                unsub()
            except Exception:
                pass

    def __enter__(self) -> "PowerRecorder":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
