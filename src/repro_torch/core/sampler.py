"""Background sampling thread — PMT's core runtime mechanism.

"PMT library's core consists of a background thread to the profiled
application that communicates and gathers power consumption information
from the selected back end."

Two consumers:

  * :class:`DumpThread` — dump-mode: sample at the backend's native period
    and append records to a dump file (see repro_torch.core.dumpfile).
  * :class:`RingSampler` — in-memory timeline with a preallocated NumPy
    ring buffer, the shared sampling service behind ``pmt.Session``.

Both honour the backend's ``native_period_s`` floor: sampling faster than
the backend updates only duplicates values (the paper's NVML-10ms /
RAPL-500ms observation), so requests below the floor are clamped.

The array core
--------------

:class:`RingSampler` stores samples in a fixed-capacity structured NumPy
ring (columns ``timestamp_s``, ``joules``, ``watts``) written in place by
the background thread.  After warm-up the tick retains **zero** Python
allocations: ``Sensor.read_raw()`` hands back bare floats and the writer
assigns them into preallocated columns — no ``State`` objects, no list
appends, no compaction.

Readers never take a lock the writer holds across sensor I/O.  Instead
they use a seqlock-style retry: read the write sequence counter, copy the
live region, and re-check the counter — if the writer published a row in
between, retry the copy.  The writer bumps the counter to odd before a
row write and back to even after, so a torn row is always detected.

Compaction disappeared with the list core: a sample survives until the
ring genuinely wraps (``capacity`` samples later), instead of the old
"delete the older half" policy that could evict a still-open span's
bracketing sample at half capacity.  Open spans *pin* their ``t0``
(:meth:`RingSampler.pin`); a pin cannot stop a fixed-capacity ring from
eventually wrapping over a span that outlives ``capacity * period_s``,
but it makes that eviction detectable: the writer marks affected pins as
it overwrites their bracket, and resolution raises a clear
``window_evicted`` flag (and a :class:`SamplerWindowEvicted` warning)
instead of silently under-reporting energy.

The list-of-``State`` core from the previous revision is kept as
:class:`LegacyRingSampler` behind ``PMT_LEGACY_RING=1`` for A/B
benchmarking (see benchmarks/bench_overhead.py); it will be removed once
the perf trajectory has a few array-core data points.
"""
from __future__ import annotations

import bisect
import collections
import itertools
import math
import os
import threading
import time
import warnings
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.dumpfile import DumpWriter
from repro_torch.core.sensor import Sensor
from repro_torch.core.state import State
from repro_torch.core.supervisor import DEGRADED, FAILED, OK


class SamplerWindowEvicted(UserWarning):
    """A span outlived the ring: its bracketing start sample was
    overwritten before resolution, so its energy resolves from a
    truncated window (flagged ``window_evicted`` on the measurement)."""


class SamplerReadError(UserWarning):
    """A background sampler read raised; the tick was skipped.  The
    sampler thread survives and keeps ticking — the failed interval is
    recorded as a coverage gap (see :class:`SamplerCoverageGap`).
    Warned once per failure streak, not once per tick."""


class SamplerCoverageGap(UserWarning):
    """A resolved span straddles a sampler coverage gap (a stretch of
    failed reads).  Its energy interpolates *across* the blackout, so
    the measurement is flagged ``degraded`` instead of being silently
    reported as trustworthy."""


class _PeriodicThread(threading.Thread):
    """Base: call ``self._tick()`` every ``period_s`` until stopped."""

    def __init__(self, period_s: float):
        super().__init__(daemon=True)
        self._period_s = period_s
        self._stop_evt = threading.Event()

    def run(self) -> None:
        # Sample immediately, then on the period; a final sample on stop
        # closes the interval so short regions still get >= 2 records.
        self._tick()
        while not self._stop_evt.wait(self._period_s):
            self._tick()
        self._tick()

    def stop(self, join: bool = True) -> None:
        self._stop_evt.set()
        if join and self.is_alive():
            self.join(timeout=10.0)

    def _tick(self) -> None:  # pragma: no cover - overridden
        raise NotImplementedError


def clamp_period(sensor: Sensor, period_s: Optional[float]) -> float:
    """Clamp a requested period to the backend's sustainable floor."""
    if period_s is None:
        return sensor.native_period_s
    return max(float(period_s), sensor.native_period_s)


class DumpThread(_PeriodicThread):
    """Dump-mode engine behind ``Sensor.start_dump_thread``."""

    def __init__(self, sensor: Sensor, filename: str,
                 period_s: Optional[float] = None):
        super().__init__(clamp_period(sensor, period_s))
        self._sensor = sensor
        self._writer = DumpWriter(filename, sensor.name, sensor.kind)
        self._first: Optional[State] = None
        self._prev: Optional[State] = None
        self.read_errors = 0
        self._in_error_streak = False

    def _tick(self) -> None:
        # A transient read failure skips this row (with one warning per
        # failure streak) instead of killing the dump thread mid-file.
        try:
            st = self._sensor.read()
        except Exception as e:   # noqa: BLE001 — any backend fault
            self.read_errors += 1
            if not self._in_error_streak:
                self._in_error_streak = True
                warnings.warn(f"dump read failed ({e!r}); skipping row",
                              SamplerReadError, stacklevel=2)
            return
        self._in_error_streak = False
        if self._first is None:
            self._first = st
        if st.watts is not None:
            w = st.watts
        elif self._prev is not None:
            w = Sensor.watts(self._prev, st)
        else:
            w = 0.0
        self._writer.write(st.timestamp_s - self._first.timestamp_s, w,
                           st.joules)
        self._prev = st

    def stop(self, join: bool = True) -> None:
        super().stop(join=join)
        self._writer.close()


# Logical record schema of one ring row.  The storage is columnar —
# three contiguous float64 arrays, one per field — rather than an
# interleaved structured array: ``np.searchsorted`` (the resolver's
# workhorse) silently copies a strided field view in full on every call,
# which would turn each O(log n) bracket search into an O(n) copy.
RING_DTYPE = np.dtype([("timestamp_s", np.float64),
                       ("joules", np.float64),
                       ("watts", np.float64)])

DEFAULT_RING_CAPACITY = 100_000


class RingSampler(_PeriodicThread):
    """Array-core in-memory sampler (see module docstring).

    Writer side: the background thread (and the rare ``sample_now``
    caller) appends rows in timestamp order.  Writes are serialised by
    ``_write_mutex`` — held across the sensor read *and* the row publish
    so two concurrent ``sample_now`` calls cannot land out of order —
    but readers never touch that mutex, so a slow RAPL/NVML read (~ms)
    can never stall a ``timeline()``/``window_arrays()`` caller.

    Reader side: seqlock retry against ``_wseq``.  ``timeline()`` copies
    the live region seam-unrolled into time order; ``window_arrays``
    slices the copy down to the samples bracketing ``[t0, t1]``.

    ``VECTORIZED`` marks the NumPy interface for the span resolver
    (:mod:`repro_torch.core.resolver`); the legacy core advertises the scalar
    path instead.
    """

    VECTORIZED = True

    def __init__(self, sensor: Sensor, period_s: Optional[float] = None,
                 capacity: int = DEFAULT_RING_CAPACITY):
        super().__init__(clamp_period(sensor, period_s))
        if capacity < 2:
            raise ValueError(f"ring capacity must be >= 2, got {capacity}")
        self._sensor = sensor
        self._cap = int(capacity)
        # Preallocated columns (see RING_DTYPE note); per-tick writes
        # are scalar stores, wraparound overwrites in place.
        self._ts_col = np.zeros(self._cap, np.float64)
        self._j_col = np.zeros(self._cap, np.float64)
        self._w_col = np.zeros(self._cap, np.float64)
        self._count = 0          # total rows ever published
        self._wseq = 0           # seqlock: odd while a row write is in flight
        self._write_mutex = threading.Lock()
        # Pins: open spans register their t0 so wraparound over a span's
        # bracketing sample is detected (not prevented — the ring is
        # fixed-capacity) and surfaced as window_evicted at resolution.
        # Lock-free: single dict/set operations are atomic under the GIL
        # and the writer snapshots items() before iterating; pin/unpin
        # stay cheap enough for the region-open hot path.
        self._pins = {}
        self._pin_ids = itertools.count(1)
        self._evicted_pins = set()
        self._evictions = 0
        # Fault tolerance: failed reads never kill the thread — they
        # open a *coverage gap* from the last good sample until the next
        # successful read, so resolution can mark spans that straddle a
        # blackout as degraded instead of silently interpolating.
        # Mutated only under _write_mutex; read lock-free (GIL-atomic
        # deque/scalar ops) by gap_overlaps()/health().
        self.read_errors = 0
        self._gaps = collections.deque(maxlen=256)   # closed (t0, t1)
        self._gap_open_ts: Optional[float] = None
        self._in_error_streak = False

    @property
    def sensor(self) -> Sensor:
        return self._sensor

    @property
    def capacity(self) -> int:
        return self._cap

    # -- writer side -------------------------------------------------------
    def _tick(self) -> None:
        with self._write_mutex:
            try:
                t, j, w = self._sensor.read_raw()
            except Exception as e:   # noqa: BLE001 — any backend fault
                self._note_read_failure(e)
                return
            self._note_read_success(t)
            self._publish(t, j, w)

    def _note_read_failure(self, e: Exception) -> None:
        """Record one failed read (caller holds ``_write_mutex``)."""
        self.read_errors += 1
        if self._gap_open_ts is None:
            self._gap_open_ts = self.last_ts()
        if not self._in_error_streak:
            self._in_error_streak = True
            warnings.warn(
                f"sampler read failed ({e!r}); coverage gap opened",
                SamplerReadError, stacklevel=3)

    def _note_read_success(self, t: float) -> None:
        """Close any open coverage gap (caller holds ``_write_mutex``)."""
        if self._gap_open_ts is not None:
            self._gaps.append((self._gap_open_ts, t))
            self._gap_open_ts = None
        self._in_error_streak = False

    def _publish(self, t: float, j: float, w: float) -> None:
        """Write one row (caller holds ``_write_mutex``)."""
        cnt = self._count
        idx = cnt - self._cap * (cnt // self._cap)     # cnt % cap
        if cnt >= self._cap and self._pins:
            self._note_overwrite(idx)
        self._wseq += 1          # odd: row write in flight
        self._ts_col[idx] = t
        self._j_col[idx] = j
        self._w_col[idx] = w
        self._count = cnt + 1
        self._wseq += 1          # even: row published

    def _note_overwrite(self, idx: int) -> None:
        """The full ring is about to overwrite slot ``idx`` (the oldest
        sample).  Any pin whose bracketing sample disappears with it —
        i.e. no remaining sample at/before the pinned t0 — is marked
        evicted (sticky until unpinned)."""
        nxt = idx + 1
        if nxt == self._cap:
            nxt = 0
        next_oldest_ts = self._ts_col[nxt]
        for tok, t0 in list(self._pins.items()):
            if t0 < next_oldest_ts and tok not in self._evicted_pins:
                self._evicted_pins.add(tok)
                self._evictions += 1

    def sample_now(self) -> State:
        """Take one sample on the calling thread, off the period.

        Used by span resolution to close an interval the background
        thread has not reached yet.  The sensor read happens inside the
        writer mutex (two concurrent ``sample_now`` calls must publish in
        timestamp order) but outside any reader-visible critical section:
        ``timeline()``/``window_arrays()`` callers never wait on sensor
        I/O, they seqlock-retry around the final row publish only.
        """
        with self._write_mutex:
            try:
                t, j, w = self._sensor.read_raw()
            except Exception as e:   # noqa: BLE001 — any backend fault
                # Record the gap (the caller's span will resolve
                # degraded) but re-raise: the *caller* asked for a
                # sample and must know it didn't get one.
                self._note_read_failure(e)
                raise
            self._note_read_success(t)
            self._publish(t, j, w)
        return State(timestamp_s=t, joules=j,
                     watts=None if math.isnan(w) else w)

    # -- pins --------------------------------------------------------------
    def pin(self, t0: float) -> int:
        """Pin ``t0`` as a live span start; returns a token for unpin."""
        tok = next(self._pin_ids)
        self._pins[tok] = t0
        return tok

    def unpin(self, token: int) -> None:
        self._pins.pop(token, None)
        self._evicted_pins.discard(token)

    def pin_evicted(self, token: int) -> bool:
        """Whether the ring wrapped over this pin's bracketing sample."""
        return token in self._evicted_pins

    @property
    def evictions(self) -> int:
        """Total pinned-bracket evictions observed by the writer."""
        return self._evictions

    # -- reader side (seqlock, never blocks on the writer) -----------------
    def timeline(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Copy of the live region as ``(timestamps, joules, watts)``
        arrays in time order (the ring seam is unrolled).  Consistent
        snapshot via seqlock retry; never waits on sensor I/O."""
        spins = 0
        while True:
            s1 = self._wseq
            cnt = self._count
            if not (s1 & 1):
                if cnt <= self._cap:
                    ts = self._ts_col[:cnt].copy()
                    js = self._j_col[:cnt].copy()
                    ws = self._w_col[:cnt].copy()
                else:
                    head = cnt % self._cap
                    ts = np.concatenate((self._ts_col[head:],
                                         self._ts_col[:head]))
                    js = np.concatenate((self._j_col[head:],
                                         self._j_col[:head]))
                    ws = np.concatenate((self._w_col[head:],
                                         self._w_col[:head]))
                if self._wseq == s1 and self._count == cnt:
                    return ts, js, ws
            spins += 1
            if spins > 64:       # writer mid-row; yield rather than spin
                time.sleep(0.0001)

    def window_arrays(self, t0: float, t1: float
                      ) -> Tuple[np.ndarray, np.ndarray, bool]:
        """``(timestamps, joules, evicted)`` bracketing ``[t0, t1]``: the
        last sample at/before t0 through the first after t1.

        O(log capacity + window): binary-searches the live ring (two
        segments when wrapped) under seqlock retry and copies only the
        bracketing slice — resolution never copies the whole buffer.
        ``evicted`` is True when the ring has wrapped and the oldest
        retained sample is already newer than ``t0`` (the left bracket
        was overwritten)."""
        cap = self._cap
        spins = 0
        while True:
            s1 = self._wseq
            cnt = self._count
            if not (s1 & 1):
                evicted = False
                if cnt == 0:
                    ts = js = np.empty(0, np.float64)
                elif cnt <= cap:
                    seg = self._ts_col[:cnt]
                    lo = int(seg.searchsorted(t0, side="right")) - 1
                    if lo < 0:
                        lo = 0       # never wrapped: nothing was lost
                    hi = min(int(seg.searchsorted(t1, side="right")) + 1,
                             cnt)
                    ts = seg[lo:hi].copy()
                    js = self._j_col[lo:hi].copy()
                else:
                    head = cnt % cap
                    a_ts = self._ts_col[head:]     # oldest segment
                    b_ts = self._ts_col[:head]     # newest segment
                    la = cap - head

                    def vsearch(t):
                        p = int(a_ts.searchsorted(t, side="right"))
                        if p < la:
                            return p
                        return la + int(b_ts.searchsorted(t, side="right"))

                    lo = vsearch(t0) - 1
                    if lo < 0:
                        evicted = True
                        lo = 0
                    hi = min(vsearch(t1) + 1, cap)
                    if hi <= la:
                        ts = a_ts[lo:hi].copy()
                        js = self._j_col[head + lo:head + hi].copy()
                    elif lo >= la:
                        ts = b_ts[lo - la:hi - la].copy()
                        js = self._j_col[lo - la:hi - la].copy()
                    else:
                        ts = np.concatenate((a_ts[lo:], b_ts[:hi - la]))
                        js = np.concatenate((self._j_col[head + lo:],
                                             self._j_col[:hi - la]))
                if self._wseq == s1 and self._count == cnt:
                    return ts, js, evicted
            spins += 1
            if spins > 64:       # writer mid-row; yield rather than spin
                time.sleep(0.0001)

    def last_ts(self) -> float:
        """Timestamp of the newest published sample (``-inf`` if none).
        Lock-free; may trail the writer by one in-flight row."""
        while True:
            s1 = self._wseq
            cnt = self._count
            if not (s1 & 1):
                if cnt == 0:
                    return float("-inf")
                t = float(self._ts_col[(cnt - 1) % self._cap])
                if self._wseq == s1:
                    return t

    # -- fault-tolerance readers ------------------------------------------
    def gap_overlaps(self, t0: float, t1: float) -> bool:
        """Whether ``[t0, t1]`` straddles a coverage gap (a stretch of
        failed reads), including a still-open gap.  Spans for which this
        is true interpolate across a blackout and resolve ``degraded``.
        """
        open_ts = self._gap_open_ts
        if open_ts is not None and t1 > open_ts:
            return True
        for g0, g1 in tuple(self._gaps):
            if g0 < t1 and g1 > t0:
                return True
        return False

    def staleness_s(self, now: Optional[float] = None) -> float:
        """Age of the newest sample on the sensor clock (``inf`` if the
        ring is empty) — the watchdog signal behind governor signal-TTL
        and the ``/health`` endpoint."""
        if now is None:
            now = self._sensor.now()
        return now - self.last_ts()

    def health(self) -> dict:
        """Sampler health snapshot, merged with the sensor's own
        (supervisor) health when the backend exposes one."""
        in_gap = self._gap_open_ts is not None
        h = {"state": FAILED if in_gap else OK,
             "read_errors": self.read_errors,
             "in_gap": in_gap,
             "gaps": len(self._gaps),
             "staleness_s": self.staleness_s()}
        sensor_health = getattr(self._sensor, "health", None)
        if callable(sensor_health):
            sup = sensor_health()
            h["supervisor"] = sup
            if not in_gap and sup.get("state") in (DEGRADED, FAILED):
                h["state"] = sup["state"]
        return h

    # -- State-compat readers (off the hot path) ---------------------------
    def window(self, t0: float, t1: float
               ) -> Tuple[List[State], List[float]]:
        """Samples bracketing ``[t0, t1]`` as ``State`` objects (legacy
        interface; resolution uses :meth:`window_arrays`)."""
        ts, js, ws = self.timeline()
        lo = int(np.searchsorted(ts, t0, side="right")) - 1
        if lo < 0:
            lo = 0
        hi = int(np.searchsorted(ts, t1, side="right")) + 1
        states = [State(timestamp_s=float(t), joules=float(j),
                        watts=None if math.isnan(w) else float(w))
                  for t, j, w in zip(ts[lo:hi], js[lo:hi], ws[lo:hi])]
        return states, [float(t) for t in ts[lo:hi]]

    def snapshot(self) -> List[State]:
        ts, js, ws = self.timeline()
        return [State(timestamp_s=float(t), joules=float(j),
                      watts=None if math.isnan(w) else float(w))
                for t, j, w in zip(ts, js, ws)]

    def last(self) -> Optional[State]:
        states = self.snapshot()
        return states[-1] if states else None

    def __enter__(self) -> "RingSampler":
        self.start()
        return self

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False


class LegacyRingSampler(_PeriodicThread):
    """The previous list-of-``State`` core, kept behind
    ``PMT_LEGACY_RING=1`` for A/B benchmarking only.

    The buffer holds samples in non-decreasing timestamp order — the
    read *and* the append are serialised by ``_sample_lock``, so a slow
    sensor read stalls concurrent ``sample_now`` callers (one of the
    costs the array core removes).  ``_buf_lock`` guards only the list
    mutation.  When the buffer exceeds ``maxlen`` the older half is
    compacted away (amortised O(1)/append) — which can evict a
    still-open span's bracketing start sample at half capacity.
    """

    VECTORIZED = False

    def __init__(self, sensor: Sensor, period_s: Optional[float] = None,
                 maxlen: int = DEFAULT_RING_CAPACITY):
        super().__init__(clamp_period(sensor, period_s))
        self._sensor = sensor
        self._maxlen = maxlen
        self._buf: List[State] = []
        self._ts: List[float] = []
        self._sample_lock = threading.Lock()
        self._buf_lock = threading.Lock()

    @property
    def sensor(self) -> Sensor:
        return self._sensor

    def _tick(self) -> None:
        with self._sample_lock:
            st = self._sensor.read()
            with self._buf_lock:
                self._buf.append(st)
                self._ts.append(st.timestamp_s)
                if len(self._buf) > self._maxlen:
                    half = len(self._buf) // 2
                    del self._buf[:half]
                    del self._ts[:half]

    def sample_now(self) -> State:
        self._tick()
        with self._buf_lock:
            return self._buf[-1]

    # Pins are a no-op on the legacy core: half-compaction evicts
    # regardless, which is exactly the behaviour the A/B measures.
    def pin(self, t0: float) -> int:
        return 0

    def unpin(self, token: int) -> None:
        pass

    def pin_evicted(self, token: int) -> bool:
        return False

    def last_ts(self) -> float:
        with self._buf_lock:
            return self._ts[-1] if self._ts else float("-inf")

    # Coverage-gap tracking is an array-core feature; the legacy core
    # answers the duck-typed API with "no gaps observed".
    def gap_overlaps(self, t0: float, t1: float) -> bool:
        return False

    def staleness_s(self, now: Optional[float] = None) -> float:
        if now is None:
            now = self._sensor.now()
        return now - self.last_ts()

    def health(self) -> dict:
        return {"state": OK, "read_errors": 0, "in_gap": False,
                "gaps": 0, "staleness_s": self.staleness_s()}

    def window(self, t0: float, t1: float
               ) -> Tuple[List[State], List[float]]:
        """Samples bracketing ``[t0, t1]``: the last one at/before t0
        through the first one after t1.  O(log n + window)."""
        with self._buf_lock:
            lo = bisect.bisect_right(self._ts, t0) - 1
            if lo < 0:
                lo = 0
            hi = bisect.bisect_right(self._ts, t1) + 1
            return self._buf[lo:hi], self._ts[lo:hi]

    def window_arrays(self, t0: float, t1: float
                      ) -> Tuple[np.ndarray, np.ndarray, bool]:
        samples, ts = self.window(t0, t1)
        arr_ts = np.array(ts, dtype=np.float64)
        arr_js = np.array([s.joules for s in samples], dtype=np.float64)
        evicted = bool(arr_ts.size and arr_ts[0] > t0)
        return arr_ts, arr_js, evicted

    def snapshot(self) -> List[State]:
        with self._buf_lock:
            return list(self._buf)

    def last(self) -> Optional[State]:
        with self._buf_lock:
            return self._buf[-1] if self._buf else None

    def __enter__(self) -> "LegacyRingSampler":
        self.start()
        return self

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False


def make_ring_sampler(sensor: Sensor, period_s: Optional[float] = None,
                      capacity: Optional[int] = None):
    """Construct the configured ring sampler implementation.

    ``PMT_LEGACY_RING=1`` selects the list core (A/B benchmarking);
    ``PMT_RING_CAPACITY`` overrides the default ring capacity.  Checked
    per construction so a benchmark can flip cores between sessions
    without subprocesses.
    """
    if capacity is None:
        capacity = int(os.environ.get("PMT_RING_CAPACITY",
                                      DEFAULT_RING_CAPACITY))
    if os.environ.get("PMT_LEGACY_RING", "") == "1":
        return LegacyRingSampler(sensor, period_s=period_s, maxlen=capacity)
    return RingSampler(sensor, period_s=period_s, capacity=capacity)
