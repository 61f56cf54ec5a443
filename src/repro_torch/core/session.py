"""``pmt.Session`` — the unified measurement facade.

The paper exposes three modes (read-pairs, decorators, dump files); this
reproduction additionally grew a ``PowerMonitor`` for the training loop.
Each of those constructed and polled its own sensors, which means (a)
blocking ``_sample()`` calls on the caller's hot path and (b) N private
copies of the same backend when the serve engine, train loop, and a
decorator all measure at once.

A :class:`Session` inverts that: sensors live in a refcounted
:class:`SensorPool` (one shared, lazily-started background
:class:`~repro_torch.core.sampler.RingSampler` per backend), and consumers open
*regions*::

    with pmt.Session(["cpuutil", "nvml"]) as sess:
        with sess.region("prefill"):
            ...
        with sess.region("decode", tokens=128) as r:
            ...
    print(r.measurements.total_joules())

The measurement hot path allocates nothing durable and reads no sensor:

  * region *entry* reads each backend's clock and pins the span start on
    the ring (so wraparound over it is detectable);
  * region *exit* is O(1) — it reads the clocks again, appends the span
    to a bounded queue, and wakes the background resolver.

Resolution happens off-path in :mod:`repro_torch.core.resolver`: a background
thread batch-resolves many spans per backend with one vectorized pass
(``np.searchsorted`` over all endpoints, fused interpolation of the
cumulative-joules counter) once the ring's timeline covers them, then
fans the records out to exporters.  ``RegionHandle.measurements`` is
future-style — it blocks (resolving synchronously, at most one closing
sample per backend) only if the caller actually asks for the number, so
serve/train loops that just export never wait.  Results therefore become
available either ~one sampling period after region exit (async) or
immediately on ``measurements``/``flush()``/``close()`` (forced).

Regions nest (paths like ``"serve/wave0/prefill"``) and are thread-safe,
so concurrent serve requests can each open their own span against the
same sampler.  A span that outlives the ring capacity resolves with
``window_evicted=True`` (and a ``SamplerWindowEvicted`` warning) instead
of silently under-reporting energy.

Resolved regions flow to pluggable exporters (see repro_torch.core.export).

Subscriber-exporter contract: a :class:`~repro_torch.core.export.MemoryExporter`
subscriber callback (and a ``PowerMonitor.subscribe`` callback) is
invoked on whichever thread resolves the span — normally the session's
background resolver.  The callback **must not block**: while it runs, no
further spans resolve and no other exporter receives records, so a slow
callback back-pressures the whole measurement plane (the bounded span
queue eventually drops the oldest spans from auto-resolution).  Hand the
record to a queue and return — the telemetry server's SSE fan-out does
exactly this.  A callback that raises is dropped with a warning rather
than killing the resolver.

The classic surfaces — ``@pmt.measure``, ``pmt.Region``, ``@pmt.dump``,
``pmt.PowerMonitor`` — are thin shims drawing their sensors from the
process-wide :func:`default_pool`, so everything in one process shares
one sampler per backend.  :func:`default_session` is the implicit
session behind the module-level :func:`region` convenience (and
swappable via :func:`set_default_session`)::

    pmt.region("roi", backends=["cpuutil"])   # implicit-session region
"""
from __future__ import annotations

import atexit
import bisect
import collections
import itertools
import threading
import warnings
from typing import (Any, Callable, Deque, Dict, List, Optional, Sequence,
                    Tuple, Union)

from repro_torch.core import registry
from repro_torch.core import resolver as resolver_mod
from repro_torch.core.export import Exporter, RegionRecord
from repro_torch.core.sampler import make_ring_sampler
from repro_torch.core.sensor import Sensor, SensorError
from repro_torch.core.state import State

BackendSpec = Union[str, Sensor]


# ---------------------------------------------------------------------------
# SensorPool — refcounted shared sensors + ring samplers
# ---------------------------------------------------------------------------

class SensorLease:
    """A consumer's handle on a pooled sensor.

    Holding a lease pins the sensor (and, for sampling leases, its
    background ring sampler) alive; ``release()`` — or releasing the
    owning session — lets the pool stop the sampler once the last
    sampling consumer detaches.
    """

    def __init__(self, pool: "SensorPool", key: Any, sensor: Sensor,
                 sampling: bool):
        self._pool = pool
        self._key = key
        self.sensor = sensor
        self.sampling = sampling
        self._released = False

    @property
    def sampler(self):
        return self._pool._sampler_for(self._key)

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._pool._release(self._key, self.sampling)

    def __repr__(self):
        return (f"<SensorLease {self.sensor.name!r} "
                f"sampling={self.sampling}>")


class _PoolEntry:
    __slots__ = ("sensor", "sampler", "refs", "sampling_refs", "period_s")

    def __init__(self, sensor: Sensor, period_s: Optional[float]):
        self.sensor = sensor
        self.sampler = None
        self.refs = 0
        self.sampling_refs = 0
        self.period_s = period_s


class SensorPool:
    """Refcounted registry of live sensors and their ring samplers.

    Keyed by ``(backend name, construction kwargs)`` — two consumers
    asking for ``"cpuutil"`` get the *same* sensor and the same background
    sampler; passing an existing :class:`Sensor` instance pools by
    identity so framework-owned sensors can be shared too.  The sampler
    starts lazily with the first sampling consumer and stops (joined)
    when the last one releases.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[Any, _PoolEntry] = {}

    @staticmethod
    def _key_for(spec: BackendSpec, kwargs: Dict[str, Any]) -> Any:
        if isinstance(spec, Sensor):
            return ("instance", id(spec))
        try:
            return (spec, tuple(sorted(kwargs.items())))
        except TypeError:
            # unhashable kwarg (rare): fall back to a repr key so at
            # least identical reprs still share.
            return (spec, repr(sorted(kwargs.items(), key=lambda kv: kv[0])))

    def acquire(self, spec: BackendSpec, *, sampling: bool = True,
                period_s: Optional[float] = None,
                **backend_kwargs) -> SensorLease:
        """Check out a shared sensor (and its sampler when ``sampling``)."""
        key = self._key_for(spec, backend_kwargs)
        start_sampler = None
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                sensor = (spec if isinstance(spec, Sensor)
                          else registry.create(spec, **backend_kwargs))
                entry = _PoolEntry(sensor, period_s)
                self._entries[key] = entry
            entry.refs += 1
            if sampling:
                entry.sampling_refs += 1
                if entry.sampler is None:
                    entry.sampler = make_ring_sampler(
                        entry.sensor, period_s=period_s or entry.period_s)
                    start_sampler = entry.sampler
        if start_sampler is not None:
            # Start outside the pool lock; seed one synchronous sample so
            # every span opened after acquire has a left bracket.
            start_sampler.start()
            start_sampler.sample_now()
        return SensorLease(self, key, entry.sensor, sampling)

    def _sampler_for(self, key: Any):
        with self._lock:
            entry = self._entries.get(key)
            return entry.sampler if entry is not None else None

    def _release(self, key: Any, sampling: bool) -> None:
        stop_sampler = None
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return
            entry.refs -= 1
            if sampling:
                entry.sampling_refs -= 1
                if entry.sampling_refs <= 0 and entry.sampler is not None:
                    stop_sampler = entry.sampler
                    entry.sampler = None
            if entry.refs <= 0:
                del self._entries[key]
        if stop_sampler is not None:
            stop_sampler.stop(join=True)

    def live_sampler_count(self) -> int:
        with self._lock:
            return sum(1 for e in self._entries.values()
                       if e.sampler is not None)

    def close(self) -> None:
        """Force-stop every sampler (process shutdown path)."""
        with self._lock:
            samplers = [e.sampler for e in self._entries.values()
                        if e.sampler is not None]
            self._entries.clear()
        for s in samplers:
            s.stop(join=True)


_default_pool = SensorPool()


def default_pool() -> SensorPool:
    """The process-wide pool the implicit default session draws from."""
    return _default_pool


# ---------------------------------------------------------------------------
# Span resolution — interpolate the cumulative-joules counter
# ---------------------------------------------------------------------------

def _joules_at(samples: Sequence[State], ts: Sequence[float], t: float
               ) -> float:
    """Cumulative joules at sensor-clock time ``t``, linearly interpolated.

    The scalar reference for :func:`repro_torch.core.resolver.batch_joules_at`
    (and the resolution path for the ``PMT_LEGACY_RING=1`` list core).
    Clamps outside the sampled range (the resolver takes a closing sample
    first, so clamping only under-counts by less than one period at the
    open end).  Duplicate timestamps (virtual clocks) collapse to the
    later sample, which carries the up-to-date counter.
    """
    if not samples:
        raise SensorError("ring buffer empty; sampler not started?")
    i = bisect.bisect_right(ts, t)
    if i <= 0:
        return samples[0].joules
    if i >= len(samples):
        return samples[-1].joules
    lo, hi = samples[i - 1], samples[i]
    dt = hi.timestamp_s - lo.timestamp_s
    if dt <= 0.0:
        return hi.joules
    frac = (t - lo.timestamp_s) / dt
    return lo.joules + frac * (hi.joules - lo.joules)


class _Span:
    """An unresolved region interval: timestamps only, no sensor data."""

    __slots__ = ("path", "label", "depth", "flops", "tokens",
                 "t0", "t1", "snap", "pins", "resolved", "error",
                 "on_resolved", "seq", "nested")

    def __init__(self, path: str, label: str, depth: int,
                 flops: Optional[float], tokens: Optional[int],
                 t0: Dict[Any, float], snap, pins,
                 on_resolved, nested: bool = True):
        self.path = path
        self.label = label
        self.depth = depth
        self.flops = flops
        self.tokens = tokens
        self.t0 = t0                      # pool key -> entry timestamp
        self.t1: Dict[Any, float] = {}    # pool key -> exit timestamp
        self.snap = snap                  # (key, clock) snapshot at entry
        self.pins = pins                  # pool key -> (sampler, pin token)
        self.resolved = None              # Measurements once resolved
        self.error: Optional[BaseException] = None
        self.on_resolved = on_resolved    # callback(Measurements), once
        self.seq = 0                      # close order (set at close)
        self.nested = nested              # False: span skipped the stack


class RegionHandle:
    """Context manager for one region; resolves asynchronously after exit.

    Entry/exit are non-blocking (clock reads, a ring pin, a queue
    append).  :attr:`measurements` is future-style: if the background
    resolver already finished the span it returns the cached result;
    otherwise it resolves synchronously on the calling thread (taking at
    most one closing sample per sensor).  Either way the span's
    :class:`RegionRecord`\\ s are emitted to the session's exporters
    exactly once.
    """

    def __init__(self, session: "Session", label: Optional[str],
                 flops: Optional[float], tokens: Optional[int],
                 on_resolved=None, nested: bool = True):
        self._session = session
        self._label = label
        self._flops = flops
        self._tokens = tokens
        self._on_resolved = on_resolved
        self._nested = nested
        self._span: Optional[_Span] = None

    def __enter__(self) -> "RegionHandle":
        self._span = self._session._open_span(self._label, self._flops,
                                              self._tokens,
                                              self._on_resolved,
                                              nested=self._nested)
        return self

    def __exit__(self, *exc) -> bool:
        self._session._close_span(self._span)
        return False

    @property
    def resolved(self) -> bool:
        """Whether the background resolver already finished this span
        (non-blocking peek)."""
        return self._span is not None and self._span.resolved is not None

    @property
    def measurements(self) -> "Measurements":
        if self._span is None:
            raise SensorError("region never entered")
        if not self._span.t1:
            raise SensorError("region still open; exit it before resolving")
        return self._session._resolve_blocking(self._span)

    @property
    def measurement(self) -> "Measurement":
        """First sensor's measurement (single-backend convenience)."""
        return self.measurements[0]


class Session:
    """Shared-sampler measurement facade (see module docstring).

    Args:
      backends: backend names or Sensor instances this session measures
        by default.  More can be attached later via :meth:`attach`.
      pool: the SensorPool to draw sensors from; defaults to the
        process-wide pool so independent sessions share samplers.
      period_s: sampling period request, clamped per backend to its
        ``native_period_s`` floor.
      exporters: initial exporter sinks (see :mod:`repro_torch.core.export`).
      max_pending: bound on spans queued for (or awaiting) background
        resolution; on overflow the oldest span is dropped from the
        *auto-resolve* path — its handle still resolves on access, the
        drop is counted in :meth:`stats`, never silent.
    """

    def __init__(self, backends: Sequence[BackendSpec] = (),
                 *, pool: Optional[SensorPool] = None,
                 period_s: Optional[float] = None,
                 exporters: Sequence[Exporter] = (),
                 max_pending: int = 65536):
        self._pool = pool if pool is not None else default_pool()
        self._period_s = period_s
        self._max_pending = max_pending
        self._lock = threading.Lock()
        self._leases: "collections.OrderedDict[Any, SensorLease]" = \
            collections.OrderedDict()
        self._exporters: List[Exporter] = list(exporters)
        # Serialises span resolution (background batches, blocking
        # accesses, flush): exporters see each span exactly once, in
        # close order for the batched path.
        self._resolve_lock = threading.Lock()
        # Closed spans ride _queue (lock-free append on the hot path)
        # until the resolver claims them into _waiting; _waiting holds
        # spans whose rings don't cover t1 yet; background-settled spans
        # park in _flushable so flush() can still return them.  All
        # three under _resolve_lock.
        self._queue: Deque[_Span] = collections.deque()
        self._waiting: List[_Span] = []
        self._flushable: Deque[_Span] = collections.deque(
            maxlen=max_pending)
        self._close_seq = itertools.count(1)
        # Exporter emissions and on_resolved callbacks never run under
        # _resolve_lock (a callback touching the session would
        # self-deadlock): resolution appends to _emit_queue and the
        # resolving thread drains it FIFO after releasing the lock.
        # RLock so a callback that itself forces resolution can drain
        # its own nested emissions.
        self._emit_queue: Deque[tuple] = collections.deque()
        self._emit_lock = threading.RLock()
        self._resolver: Optional[resolver_mod.SpanResolver] = None
        self._stats = {"resolved": 0, "evicted": 0, "degraded": 0,
                       "dropped": 0, "resolve_errors": 0}
        self._tls = threading.local()
        self._anon = itertools.count(1)
        self._closed = False
        # Hot-path snapshot: regions open/close without the session lock
        # (attribute replacement is atomic; a momentarily stale snapshot
        # just measures the backend set as of region entry).  One tuple
        # holds both views so open/close never see mismatched halves:
        #   open3:  (key, clock, sampler) — entry timestamps + ring pins
        #   pairs:  (key, clock)          — exit timestamps
        # pre-bound so a span timestamp is one call, no attribute
        # dispatch.
        self._lease_snapshot: Tuple[SensorLease, ...] = ()
        self._hot_snapshot: Tuple[Tuple, Tuple] = ((), ())
        try:
            for b in backends:
                self.attach(b)
        except BaseException:
            # A later backend failed (typo'd name, probe error): release
            # what was already acquired or its sampler outlives us.
            self._stop_resolver()
            self._release_leases()
            raise

    def _release_leases(self) -> None:
        with self._lock:
            leases = list(self._leases.values())
            self._leases.clear()
            self._lease_snapshot = ()
            self._hot_snapshot = ((), ())
        for lease in leases:
            lease.release()

    def _stop_resolver(self) -> None:
        res = self._resolver
        if res is not None:
            res.stop(join=True)
            if res.is_alive():  # pragma: no cover - stuck sensor I/O
                warnings.warn("pmt resolver thread did not stop within "
                              "timeout; leaking daemon thread")
            self._resolver = None

    # -- sensor management ---------------------------------------------------
    def attach(self, backend: BackendSpec, **backend_kwargs) -> Sensor:
        """Attach a backend to this session (idempotent), return its sensor."""
        if self._closed:
            raise SensorError("session is closed")
        key = SensorPool._key_for(backend, backend_kwargs)
        with self._lock:
            lease = self._leases.get(key)
            if lease is None:
                lease = self._pool.acquire(
                    backend, sampling=True, period_s=self._period_s,
                    **backend_kwargs)
                self._leases[key] = lease
                self._lease_snapshot = tuple(self._leases.values())
                open3 = tuple((l._key, l.sensor._clock, l.sampler)
                              for l in self._lease_snapshot)
                self._hot_snapshot = (
                    open3, tuple((k, clk) for k, clk, _ in open3))
            if self._resolver is None:
                self._resolver = resolver_mod.SpanResolver(self)
                self._resolver.start()
            return lease.sensor

    def _lease_by_key(self, key: Any) -> Optional[SensorLease]:
        with self._lock:
            return self._leases.get(key)

    @property
    def sensors(self) -> List[Sensor]:
        with self._lock:
            return [lease.sensor for lease in self._leases.values()]

    def samplers(self) -> List[Tuple[str, Any]]:
        """``(backend name, ring sampler)`` per attached backend.

        The read-only seam the telemetry plane taps for live power
        timelines: a :class:`~repro_torch.core.sampler.RingSampler`'s
        ``timeline()``/``window_arrays()`` readers are seqlock-based and
        never block the sampling thread, so a poller can copy watts
        series as often as it likes without perturbing measurement.
        Samplers are pool-owned; entries go stale once the session (or
        the last sampling consumer) releases the backend.
        """
        with self._lock:
            return [(lease.sensor.name, lease.sampler)
                    for lease in self._leases.values()
                    if lease.sampler is not None]

    def add_exporter(self, exporter: Exporter) -> Exporter:
        with self._lock:
            self._exporters.append(exporter)
        return exporter

    # -- regions -------------------------------------------------------------
    def region(self, label: Optional[str] = None, *,
               flops: Optional[float] = None,
               tokens: Optional[int] = None,
               on_resolved: Optional[Callable] = None,
               nested: bool = True) -> RegionHandle:
        """Open a (nestable, thread-safe, non-blocking) measured region.

        ``on_resolved`` is called exactly once with the span's
        ``Measurements`` when it resolves — on the background resolver
        thread, or on whichever thread forces resolution first.

        ``nested=False`` opens a *flat* span: it neither reads nor joins
        the thread-local label stack (path == label, depth 0), so many
        spans can be open concurrently on one thread and close in any
        order — the serve engine's per-request spans, whose lifetimes
        interleave as slots retire and refill, need exactly this.
        """
        return RegionHandle(self, label, flops, tokens,
                            on_resolved=on_resolved, nested=nested)

    def _label_stack(self) -> List[str]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _open_span(self, label: Optional[str], flops: Optional[float],
                   tokens: Optional[int], on_resolved,
                   nested: bool = True) -> _Span:
        if self._closed:
            raise SensorError("session is closed")
        open3, pairs = self._hot_snapshot
        if not open3:
            raise SensorError(
                "session has no backends; pass them to Session(...) or "
                "call session.attach(...)")
        if label is None:
            label = f"region{next(self._anon)}"
        if nested:
            stack = self._label_stack()
            path = "/".join(stack + [label]) if stack else label
            depth = len(stack)
        else:
            path, depth = label, 0
        # Spans key their timestamps by pool key, not sensor name — two
        # pooled sensors may share a name (same backend, different kwargs).
        t0: Dict[Any, float] = {}
        pins: Dict[Any, Tuple[Any, int]] = {}
        for k, clk, sampler in open3:
            t = clk()
            t0[k] = t
            pins[k] = (sampler, sampler.pin(t))
        span = _Span(path, label, depth, flops, tokens, t0, pairs,
                     pins, on_resolved, nested=nested)
        if nested:
            stack.append(label)
        return span

    def _close_span(self, span: Optional[_Span]) -> None:
        if span is None:
            return
        pairs = self._hot_snapshot[1]
        if pairs is span.snap:       # common case: backend set unchanged
            span.t1 = {k: clk() for k, clk in pairs}
        else:                        # a backend attached mid-span
            t0 = span.t0
            span.t1 = {k: clk() for k, clk in pairs if k in t0}
        if span.nested:
            stack = self._label_stack()
            if stack and stack[-1] == span.label:
                stack.pop()
        span.seq = next(self._close_seq)
        # O(1) hand-off to the background resolver; no locks, no sensor
        # I/O, no resolution work on the caller's thread.  The wake event
        # stays set while the resolver is busy (it clears only right
        # before a drain), so a burst of closes costs one event set plus
        # an is_set() check per region — and because every clear is
        # followed by a drain, a span appended before the check can
        # never be stranded (no lost wakeup).
        q = self._queue
        if len(q) >= self._max_pending:
            try:
                old = q.popleft()
            except IndexError:      # racing drain emptied it — fine
                pass
            else:
                self._drop_span(old)
        q.append(span)
        res = self._resolver
        if res is not None and not res.wake.is_set():
            res.wake.set()

    def _unpin_span(self, span: _Span) -> None:
        for sampler, tok in span.pins.values():
            sampler.unpin(tok)
        span.pins = {}

    def _drop_span(self, span: _Span) -> None:
        """A span fell off the bounded auto-resolve queue: count it and
        release its ring pins.  Its handle can still resolve on access."""
        if span.resolved is None and span.error is None:
            self._stats["dropped"] += 1
        self._unpin_span(span)

    # -- resolution plumbing (called by repro_torch.core.resolver) -----------------
    def _note_span_resolved(self, span: _Span, evicted: bool,
                            degraded: bool = False) -> None:
        self._stats["resolved"] += 1
        if evicted:
            self._stats["evicted"] += 1
        if degraded:
            self._stats["degraded"] += 1
        self._unpin_span(span)

    def _note_span_error(self, span: _Span) -> None:
        self._stats["resolve_errors"] += 1
        self._unpin_span(span)

    def _enqueue_emission(self, records, on_resolved, measurements) -> None:
        """Queue a resolved span's exporter records + callback (caller
        holds ``_resolve_lock``; actual emission happens in
        :meth:`_drain_emissions` after the lock is released)."""
        self._emit_queue.append((records, on_resolved, measurements))

    def _drain_emissions(self) -> None:
        """Emit queued records/callbacks FIFO, outside ``_resolve_lock``.

        Every resolution path calls this right after releasing the
        resolve lock, so (a) exporters see records exactly once and in
        close order (the queue is FIFO and one drainer runs at a time),
        (b) a blocking ``measurements`` access returns only after its
        span's records reached the exporters *and* callbacks ran — the
        unconditional emit-lock acquisition doubles as a barrier against
        an emission another thread has in flight — and (c) an
        ``on_resolved`` callback may safely call back into the session:
        it runs under no session lock except the re-entrant emit lock.
        """
        while True:
            with self._emit_lock:
                while True:
                    try:
                        records, cb, ms = self._emit_queue.popleft()
                    except IndexError:
                        break
                    with self._lock:
                        exporters = list(self._exporters)
                    for exp in exporters:
                        for rec in records:
                            exp.emit(rec)
                    if cb is not None:
                        cb(ms)
            if not self._emit_queue:
                return

    def _drain_ready(self, force: bool) -> Tuple[int, int]:
        """Claim queued spans and resolve the ones their rings cover.

        The background resolver calls this with ``force=False`` so async
        resolution never issues an extra sensor read: spans ahead of the
        sampler timeline wait in ``_waiting`` for the next tick; settled
        spans park in ``_flushable`` for the next ``flush()``.  Returns
        ``(resolved_now, deferred)`` counts.
        """
        with self._resolve_lock:
            waiting = self._waiting
            while True:
                try:
                    waiting.append(self._queue.popleft())
                except IndexError:
                    break
            if not waiting:
                return 0, 0
            ready: List[_Span] = []
            deferred: List[_Span] = []
            for span in waiting:
                if span.resolved is not None:
                    self._flushable.append(span)   # settled via an access
                    continue
                if span.error is not None:
                    continue
                if force or resolver_mod._covered(self, span):
                    ready.append(span)
                else:
                    deferred.append(span)
            if ready:
                resolver_mod.resolve_spans(self, ready, force=force)
                for span in ready:
                    if span.resolved is not None:
                        self._flushable.append(span)
            if len(deferred) > self._max_pending:
                for span in deferred[:-self._max_pending]:
                    self._drop_span(span)
                deferred = deferred[-self._max_pending:]
            self._waiting = deferred
        self._drain_emissions()
        return len(ready), len(deferred)

    def _resolve_blocking(self, span: _Span) -> "Measurements":
        if span.resolved is None:
            with self._resolve_lock:
                if span.resolved is None and span.error is None:
                    resolver_mod.resolve_spans(self, [span], force=True)
        # Always drain — even when the background resolver resolved the
        # span first, its exporter records / on_resolved callback may
        # still be queued or mid-emission; the drain's lock acquisition
        # barriers on them so a returning ``measurements`` caller can
        # rely on completion side effects (e.g. monitor accounting).
        self._drain_emissions()
        if span.error is not None:
            raise span.error
        return span.resolved

    def flush(self) -> List["Measurements"]:
        """Resolve every pending span now (emitting to exporters); drain.

        Spans join the queue only when their region exits, so everything
        here is closed and resolvable — at most one closing sample per
        backend is taken for spans the ring does not cover yet.  Returns
        the resolved :class:`Measurements` in close order for every span
        closed since the last flush — including spans the background
        resolver or a handle access already settled.  Spans that could
        *not* resolve (their sampler stopped underneath them) are
        surfaced in :meth:`stats` under ``resolve_errors`` rather than
        dropped silently.
        """
        with self._resolve_lock:
            spans = list(self._flushable) + self._waiting
            self._flushable.clear()
            self._waiting = []
            while True:
                try:
                    spans.append(self._queue.popleft())
                except IndexError:
                    break
            resolver_mod.resolve_spans(
                self, [s for s in spans if s.resolved is None], force=True)
            spans.sort(key=lambda s: s.seq)
            out = [s.resolved for s in spans if s.resolved is not None]
        self._drain_emissions()
        return out

    def stats(self) -> Dict[str, int]:
        """Resolution counters: ``resolved``, ``evicted`` (spans flagged
        ``window_evicted``), ``degraded`` (spans that straddled a sensor
        coverage gap), ``dropped`` (fell off the bounded queue — handles
        still resolve on access), ``resolve_errors``, and ``pending``
        (closed spans not yet resolved)."""
        with self._resolve_lock:
            pending = len(self._queue) + sum(
                1 for s in self._waiting
                if s.resolved is None and s.error is None)
            out = dict(self._stats)
        out["pending"] = pending
        return out

    def health(self) -> Dict[str, Any]:
        """Per-backend measurement-plane health, keyed by backend name.

        Each entry is the backend sampler's :meth:`RingSampler.health`
        snapshot (state ok/degraded/failed, read errors, coverage gaps,
        staleness, plus the wrapped supervisor's chain health when the
        backend is a :class:`~repro_torch.core.supervisor.SensorSupervisor`).
        """
        return {name: sampler.health()
                for name, sampler in self.samplers()}

    # -- lifecycle -----------------------------------------------------------
    def close(self, timeout: float = 5.0) -> None:
        """Flush, stop the resolver (bounded join), close exporters,
        release every lease (idempotent).  Never hangs on a wedged
        resolver thread and never drops spans silently: anything still
        unresolved after the drain is reported via a warning +
        :meth:`stats`."""
        if self._closed:
            return
        self.flush()
        self._closed = True
        res = self._resolver
        if res is not None:
            res.stop(join=True, timeout=timeout)
            self._resolver = None
        st = self.stats()
        if st["resolve_errors"] or st["pending"]:
            warnings.warn(
                f"pmt.Session closed with {st['resolve_errors']} "
                f"unresolvable and {st['pending']} unresolved spans "
                f"(see Session.stats())")
        with self._lock:
            exporters = list(self._exporters)
            self._exporters.clear()
        self._release_leases()
        for exp in exporters:
            exp.close()

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def __repr__(self):
        names = [s.name for s in self.sensors]
        return f"<Session backends={names} closed={self._closed}>"


# ---------------------------------------------------------------------------
# Implicit default session — what the legacy shims ride on
# ---------------------------------------------------------------------------

_default_session: Optional[Session] = None
_default_lock = threading.Lock()


def default_session() -> Session:
    """The process-wide implicit session behind module-level ``region``.

    Created lazily with no backends (``region(..., backends=...)``
    attaches what it needs) and torn down at interpreter exit.  It
    draws from the same :func:`default_pool` as the classic shims, so
    everything shares one sampler per backend either way.
    """
    global _default_session
    with _default_lock:
        if _default_session is None or _default_session._closed:
            _default_session = Session(pool=default_pool())
        return _default_session


def region(label: Optional[str] = None, *,
           backends: Sequence[BackendSpec] = (),
           flops: Optional[float] = None,
           tokens: Optional[int] = None) -> RegionHandle:
    """Open a region on the implicit default session::

        with pmt.region("roi", backends=["cpuutil"]) as r:
            work()
        print(r.measurement)

    ``backends`` attach to the default session (idempotent); omit them
    once attached.  For anything beyond quick scripts, construct an
    explicit :class:`Session`.
    """
    sess = default_session()
    for b in backends:
        sess.attach(b)
    return sess.region(label, flops=flops, tokens=tokens)


def set_default_session(session: Optional[Session]) -> Optional[Session]:
    """Swap the implicit default session; returns the previous one."""
    global _default_session
    with _default_lock:
        prev, _default_session = _default_session, session
        return prev


@atexit.register
def _shutdown() -> None:  # pragma: no cover - interpreter teardown
    with _default_lock:
        sess = _default_session
    if sess is not None:
        try:
            sess.close()
        except Exception:
            pass
