"""Asynchronous, vectorized span resolution for ``pmt.Session``.

Region ``__exit__`` is O(1): it records ``(t0, t1, path, flops, ...)``
into a bounded queue and returns.  This module is everything that
happens afterwards, off the caller's hot path:

  * :func:`batch_joules_at` — the vectorized twin of the scalar
    ``_joules_at`` interpolation: one ``np.searchsorted`` over *all* span
    endpoints at once, then a fused linear interpolation of the
    cumulative-joules counter.  Bit-identical arithmetic to the scalar
    path (same clamping, same duplicate-timestamp collapse to the later
    sample), so the two agree to better than 1e-9 — see
    tests/test_array_core.py.
  * :func:`resolve_spans` — batch-resolves many closed spans per backend
    against one seqlock copy of the ring and builds
    ``Measurement``/``RegionRecord`` objects under the session's resolve
    lock; exporter fan-out and per-span completion callbacks are queued
    and run FIFO after the lock is released, so exporters see records
    exactly once and in close order while callbacks remain free to call
    back into the session.
  * :class:`SpanResolver` — the background thread draining the session's
    span queue.  It only resolves spans the ring already covers
    (``sampler.last_ts() >= t1``); spans ahead of the timeline wait for
    the background sampler to pass them instead of forcing an extra
    sensor read, so async resolution never perturbs the measured
    workload.  ``Session.flush()`` / a blocking ``measurements`` access
    force coverage with at most one ``sample_now`` per backend.

When does a result become available?  A span resolves when (a) the
background sampler's timeline covers its ``t1`` and the resolver thread
gets to it (typically within one sampling period), or (b) someone asks —
``handle.measurements``, ``session.flush()``, or ``session.close()`` —
which resolves it synchronously on the asking thread.  Serve/train loops
that only export therefore never wait.
"""
from __future__ import annotations

import threading
import warnings
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.export import RegionRecord
from repro_torch.core.sampler import SamplerCoverageGap, SamplerWindowEvicted
from repro_torch.core.sensor import SensorError
from repro_torch.core.state import State

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.core.session import Session, _Span


def batch_joules_at(ts: np.ndarray, joules: np.ndarray,
                    t: np.ndarray) -> np.ndarray:
    """Cumulative joules at each time in ``t``, linearly interpolated.

    Vectorized mirror of the scalar ``session._joules_at``: clamps
    outside the sampled range, and collapses duplicate timestamps
    (virtual clocks) to the later sample via ``side="right"`` search.
    ``ts`` must be non-decreasing; ``t`` may be in any order.
    """
    n = ts.shape[0]
    if n == 0:
        raise SensorError("ring buffer empty; sampler not started?")
    t = np.asarray(t, dtype=np.float64)
    i = np.searchsorted(ts, t, side="right")
    ii = np.clip(i, 1, n - 1) if n > 1 else np.ones_like(i)
    lo_t = ts[ii - 1]
    lo_j = joules[ii - 1]
    hi_t = ts[np.minimum(ii, n - 1)]
    hi_j = joules[np.minimum(ii, n - 1)]
    dt = hi_t - lo_t
    safe_dt = np.where(dt > 0.0, dt, 1.0)
    # dt <= 0 (duplicate timestamps) -> frac 1.0 -> the later sample,
    # matching the scalar path's "hi.joules" branch.
    frac = np.where(dt > 0.0, (t - lo_t) / safe_dt, 1.0)
    out = lo_j + frac * (hi_j - lo_j)
    out = np.where(i <= 0, joules[0], out)
    out = np.where(i >= n, joules[-1], out)
    return out


def _interp_scalar(ts: np.ndarray, js: np.ndarray, t: float) -> float:
    """Scalar twin of :func:`batch_joules_at` on array storage (same
    clamping and duplicate-timestamp behaviour, same arithmetic —
    float64 -> Python float is exact, so the IEEE ops are identical).
    Extracting the four bracket values via ``.item()`` and doing the
    lerp in Python floats skips ~1 us of NumPy scalar dispatch per op.
    """
    n = ts.shape[0]
    i = int(ts.searchsorted(t, side="right"))
    if i <= 0:
        return js.item(0)
    if i >= n:
        return js.item(n - 1)
    lo_t = ts.item(i - 1)
    dt = ts.item(i) - lo_t
    if dt <= 0.0:
        return js.item(i)
    lo_j = js.item(i - 1)
    return lo_j + (t - lo_t) / dt * (js.item(i) - lo_j)


def _resolve_key_scalar(session: "Session", key, lease, sampler, todo,
                        idxs, per_span_parts, force: bool) -> None:
    """Scalar per-span resolution for the legacy list core (A/B only)."""
    from repro_torch.core.session import _joules_at

    for i in idxs:
        span = todo[i]
        t0, t1 = span.t0[key], span.t1[key]
        samples, ts = sampler.window(t0, t1)
        close_failed = False
        if not samples or ts[-1] < t1:
            if not force:
                continue
            try:
                sampler.sample_now()
            except Exception:   # noqa: BLE001 — resolve from what we have
                close_failed = True
            samples, ts = sampler.window(t0, t1)
        if not samples:
            span.error = SensorError(
                "ring buffer empty; sampler not started?")
            continue
        j0 = _joules_at(samples, ts, t0)
        j1 = _joules_at(samples, ts, t1)
        degraded = sampler.gap_overlaps(t0, t1) \
            or (close_failed and ts[-1] < t1)
        per_span_parts[i][key] = (lease, t0, t1, j0, j1,
                                  bool(ts[0] > t0), degraded)


def _covered(session: "Session", span: "_Span") -> bool:
    """Whether every backend's ring already reaches the span's t1."""
    for key, t1 in span.t1.items():
        lease = session._lease_by_key(key)
        if lease is None:
            continue
        sampler = lease.sampler
        if sampler is None or sampler.last_ts() < t1:
            return False
    return True


def resolve_spans(session: "Session", spans: Sequence["_Span"],
                  force: bool = True) -> None:
    """Resolve ``spans`` in place (caller holds ``session._resolve_lock``).

    Groups spans per backend and resolves each group in one vectorized
    pass: a single seqlock copy of the bracketing window, one
    ``np.searchsorted`` over every endpoint, one fused interpolation.
    ``force=True`` takes at most one closing ``sample_now`` per backend
    when the ring does not cover the latest endpoint yet.  Exporter
    records and ``on_resolved`` callbacks are *queued* on the session —
    the caller must invoke ``session._drain_emissions()`` after
    releasing the resolve lock (exactly-once and close-order are
    guaranteed by the claim under the lock plus the FIFO emit queue).

    Skips spans that are already resolved (idempotent); spans whose
    sampler is gone get a pending :class:`~repro_torch.core.sensor.SensorError`
    raised on access and counted in session stats.
    """
    from repro_torch.core.decorators import Measurement, Measurements

    todo = [s for s in spans if s.resolved is None and s.error is None]
    if not todo:
        return

    # Group span indices by pool key so each backend is copied once.
    by_key: Dict[object, List[int]] = {}
    for idx, span in enumerate(todo):
        for key in span.t1:
            by_key.setdefault(key, []).append(idx)

    # Per-span accumulators, keyed in lease-attach order at build time.
    per_span_parts: List[Dict[object, tuple]] = [dict() for _ in todo]

    for key, idxs in by_key.items():
        lease = session._lease_by_key(key)
        sampler = lease.sampler if lease is not None else None
        if sampler is None:
            for i in idxs:
                todo[i].error = SensorError(
                    f"sampler for span {todo[i].path!r} already stopped")
            continue
        if not getattr(sampler, "VECTORIZED", False):
            # PMT_LEGACY_RING=1 A/B path: the previous revision's scalar
            # per-span resolution (bisect + lerp, one closing sample per
            # uncovered span) — kept bit-identical for benchmarking.
            _resolve_key_scalar(session, key, lease, sampler, todo, idxs,
                                per_span_parts, force)
            continue
        t0_list = [todo[i].t0[key] for i in idxs]
        t1_list = [todo[i].t1[key] for i in idxs]
        t_max = max(t1_list)
        close_failed = False
        if sampler.last_ts() < t_max:
            if not force:
                continue
            # The closing sample can fail mid-blackout; resolve from
            # whatever the ring holds (clamped at the last good sample)
            # and mark the affected spans degraded instead of raising
            # out of flush()/close().
            try:
                sampler.sample_now()
            except Exception:   # noqa: BLE001 — resolve from what we have
                close_failed = True
        ts, js, window_evicted = sampler.window_arrays(min(t0_list), t_max)
        if ts.size == 0:
            for i in idxs:
                todo[i].error = SensorError(
                    "ring buffer empty; sampler not started?")
            continue
        if len(idxs) == 1:
            # Single span: scalar searchsorted (same arithmetic as the
            # batch path) skips the fixed cost of ~10 array ops.
            j0 = (_interp_scalar(ts, js, t0_list[0]),)
            j1 = (_interp_scalar(ts, js, t1_list[0]),)
        else:
            j0 = batch_joules_at(ts, js, np.array(t0_list))
            j1 = batch_joules_at(ts, js, np.array(t1_list))
        oldest = float(ts[0])
        newest = float(ts[-1])
        for pos, i in enumerate(idxs):
            span = todo[i]
            evicted = window_evicted and t0_list[pos] < oldest
            pin = span.pins.get(key)
            if pin is not None and pin[0].pin_evicted(pin[1]):
                evicted = True
            degraded = sampler.gap_overlaps(t0_list[pos], t1_list[pos]) \
                or (close_failed and newest < t1_list[pos])
            per_span_parts[i][key] = (
                lease, t0_list[pos], t1_list[pos],
                float(j0[pos]), float(j1[pos]), bool(evicted),
                bool(degraded))

    for i, span in enumerate(todo):
        if span.error is not None:
            session._note_span_error(span)
            continue
        if len(per_span_parts[i]) < len(span.t1):
            continue             # deferred (force=False, ring not caught up)
        out = Measurements()
        records: List[RegionRecord] = []
        # Iterate in span-key order (== attach order at open time).
        for key in span.t1:
            part = per_span_parts[i].get(key)
            if part is None:
                continue
            lease, t0, t1, j0v, j1v, evicted, degraded = part
            joules = max(0.0, j1v - j0v)
            secs = t1 - t0
            watts = joules / secs if secs > 0 else 0.0
            name = lease.sensor.name
            # States synthesized at the span endpoints, so downstream
            # code written against read()-pair results keeps working.
            out.append(Measurement(
                sensor=name, kind=lease.sensor.kind, joules=joules,
                watts=watts, seconds=secs,
                start=State(timestamp_s=t0, joules=j0v),
                end=State(timestamp_s=t1, joules=j1v),
                label=span.path, window_evicted=evicted,
                degraded=degraded))
            records.append(RegionRecord(
                path=span.path, label=span.label, depth=span.depth,
                sensor=name, kind=lease.sensor.kind, start_s=t0, end_s=t1,
                seconds=secs, joules=joules, watts=watts,
                flops=span.flops, tokens=span.tokens,
                window_evicted=evicted, degraded=degraded))
            if evicted:
                warnings.warn(SamplerWindowEvicted(
                    f"span {span.path!r} outlived the {name!r} ring: "
                    "start bracket evicted; energy resolves from a "
                    "truncated window"))
            if degraded:
                warnings.warn(SamplerCoverageGap(
                    f"span {span.path!r} straddles a {name!r} coverage "
                    "gap (failed sensor reads); energy interpolates "
                    "across the blackout"))
        span.resolved = out
        session._note_span_resolved(
            span,
            evicted=any(r.window_evicted for r in records),
            degraded=any(r.degraded for r in records))
        # Exporter fan-out and the user callback run *after* the caller
        # releases the resolve lock (session._drain_emissions) — a
        # callback is then free to call back into the session.
        session._enqueue_emission(records, span.on_resolved, out)


class SpanResolver(threading.Thread):
    """Background thread draining a session's closed-span queue.

    Woken by the queue's empty->non-empty transition, it claims the
    queue under the session resolve lock, batch-resolves whatever the
    rings already cover, and parks the rest until the samplers catch up,
    polling every ``poll_s`` while work remains (so a burst of closes
    costs one wake + one vectorized resolve, not a wake per close).
    Spans whose clocks never advance (virtual-clock tests, stopped
    workloads) simply wait for a forcing call — ``flush()``,
    ``close()``, or a blocking ``measurements`` access.
    """

    def __init__(self, session: "Session", poll_s: float = 0.02):
        super().__init__(daemon=True,
                         name=f"pmt-resolver-{id(session):x}")
        self._session = session
        self._poll_s = poll_s
        self.wake = threading.Event()
        self._stop_evt = threading.Event()

    def stop(self, join: bool = True, timeout: float = 5.0) -> None:
        self._stop_evt.set()
        self.wake.set()
        if join and self.is_alive():
            self.join(timeout=timeout)

    def run(self) -> None:
        session = self._session
        while True:
            try:
                claimed, deferred = session._drain_ready(force=False)
            except Exception as exc:  # pragma: no cover - backend broke
                # Keep the thread alive: spans still resolve via the
                # forcing paths, and a transient sensor error must not
                # silently kill async resolution for the whole session.
                warnings.warn(f"pmt resolver: background resolve failed "
                              f"({exc!r}); retrying")
                claimed, deferred = 0, 1
            if self._stop_evt.is_set():
                return
            if claimed or deferred:
                # Busy: plain timed sleep.  Waking per close would tax
                # the measured workload with GIL/lock churn — sleeping a
                # poll interval instead batches the next burst of spans
                # into one vectorized resolve.
                self._stop_evt.wait(self._poll_s)
            else:
                # Idle: sleep until the first span of the next burst
                # (region close signals the queue's empty->non-empty
                # transition).
                self.wake.wait()
                self.wake.clear()
