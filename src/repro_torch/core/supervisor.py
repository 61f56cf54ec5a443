"""Supervised sensor reads: retry, sanitize, circuit-break, fail over.

``RingSampler`` trusts its backend completely — before this module a
single raising read killed the sampling thread, a NaN watt poisoned the
integrated joules counter, and a RAPL-style counter reset showed up as a
huge negative energy.  :class:`SensorSupervisor` wraps a *chain* of
backends (primary first, fallbacks in preference order) and puts a
supervised read path in front of them:

* **deadline** — a read that takes longer than ``deadline_s`` (measured
  on the supervisor clock, so injected hang faults count under a fake
  clock) is treated as a failure;
* **retry** — each backend gets ``retries`` extra attempts with
  exponential backoff + deterministic jitter (injectable ``sleep_fn``,
  so tests assert the exact schedule without sleeping);
* **sanitize** — NaN/inf/negative watts are rejected; a monotonic
  joules counter that goes *backwards* is treated as a reset/wraparound
  (the regression is absorbed into a per-backend offset instead of
  emitting negative energy); a watts sample more than ``spike_sigma``
  robust deviations (MAD) from the recent median is rejected as a
  transient spike;
* **circuit breaker** — ``breaker_threshold`` consecutive failures open
  the breaker for ``breaker_cooldown_s``; while open the backend is
  skipped entirely (no slow timeouts on every tick), then a half-open
  probe either closes it or re-opens it;
* **failover** — when a backend's read fails (or its breaker is open)
  the next backend in the chain is tried; the supervisor reports
  ``DEGRADED`` while off-primary and ``FAILED`` when the whole chain is
  exhausted (the read raises ``SensorError`` — the hardened sampler
  records a coverage gap and keeps ticking).

Joules continuity: each backend's raw counter is rebased through a
per-backend offset so the *supervised* joules counter is one continuous
non-decreasing series across failovers, failbacks, and counter resets —
exactly what span resolution's interpolation assumes.

The supervisor is itself a :class:`Sensor` (it implements ``_sample()``
and inherits the locked read/integration machinery), so it drops into
``SensorPool``/``Session``/``RingSampler`` anywhere a bare backend does.
"""
from __future__ import annotations

import math
import time
from typing import Callable, List, Optional, Sequence

from repro_torch.core.sensor import Sample, Sensor, SensorError

# Health states, in increasing severity.
OK = "ok"
DEGRADED = "degraded"
FAILED = "failed"

_BREAKER_CLOSED = "closed"
_BREAKER_OPEN = "open"
_BREAKER_HALF_OPEN = "half_open"


class _RejectedSample(SensorError):
    """A read that *returned* but failed sanitization (NaN/negative
    watts, spike, non-finite joules).  Distinguished from transport
    failures so the retry loop re-reads immediately — backoff exists to
    let a struggling device recover, not to penalize bad data."""


class _Backend:
    """Per-backend supervision state (breaker + joules rebase)."""

    __slots__ = ("sensor", "breaker", "consecutive_failures", "opened_at",
                 "joules_offset", "last_raw_joules", "failures", "reads",
                 "counter_resets")

    def __init__(self, sensor: Sensor):
        self.sensor = sensor
        self.breaker = _BREAKER_CLOSED
        self.consecutive_failures = 0
        self.opened_at = 0.0
        # supervised_joules = raw_joules + joules_offset; rebased on
        # first use, on failback, and on counter regression.
        self.joules_offset: Optional[float] = None
        self.last_raw_joules: Optional[float] = None
        self.failures = 0
        self.reads = 0
        self.counter_resets = 0


class SensorSupervisor(Sensor):
    """Supervised, fail-over read path over a chain of backends.

    Args:
      backends: primary first, then fallbacks in preference order.
      deadline_s: per-read wall deadline on the supervisor clock
        (None = no deadline).
      retries: extra attempts per backend per supervised read.
      backoff_s: initial retry backoff; doubles per retry.
      backoff_jitter: deterministic jitter fraction folded into each
        backoff interval (keyed off the retry counter, not RNG state).
      breaker_threshold: consecutive failures that open the breaker.
      breaker_cooldown_s: open duration before a half-open probe.
      spike_sigma: reject watts further than this many robust sigmas
        (1.4826 * MAD) from the recent median (None disables the gate).
      clock/sleep_fn: injectable for deterministic tests.
    """

    def __init__(self, backends: Sequence[Sensor],
                 deadline_s: Optional[float] = None,
                 retries: int = 1,
                 backoff_s: float = 0.01,
                 backoff_jitter: float = 0.1,
                 breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 1.0,
                 spike_sigma: Optional[float] = 8.0,
                 spike_window: int = 32,
                 clock: Optional[Callable[[], float]] = None,
                 sleep_fn: Optional[Callable[[float], None]] = None,
                 on_transition: Optional[Callable[[str, str, str],
                                                  None]] = None):
        backends = list(backends)
        if not backends:
            raise ValueError("SensorSupervisor needs at least one backend")
        if retries < 0:
            raise ValueError(f"retries must be >= 0, got {retries}")
        if breaker_threshold < 1:
            raise ValueError("breaker_threshold must be >= 1")
        primary = backends[0]
        super().__init__(clock=clock or primary._clock)
        # Present as the primary to the registry/session layer.
        self.name = primary.name
        self.kind = primary.kind
        self.native_period_s = primary.native_period_s
        self._chain = [_Backend(b) for b in backends]
        self._deadline_s = deadline_s
        self._retries = int(retries)
        self._backoff_s = float(backoff_s)
        self._backoff_jitter = float(backoff_jitter)
        self._breaker_threshold = int(breaker_threshold)
        self._breaker_cooldown_s = float(breaker_cooldown_s)
        self._spike_sigma = spike_sigma
        self._spike_window = int(spike_window)
        self._sleep = sleep_fn or time.sleep
        self._on_transition = on_transition
        self._state = OK
        self._active_index = 0          # backend that served the last read
        self._sup_joules: Optional[float] = None   # last supervised joules
        self._recent_watts: List[float] = []
        self._spike_lo = float("-inf")  # cached accept band
        self._spike_hi = float("inf")
        self._spike_dirty = True
        self._watts_seen = 0            # accepted watts (recompute cadence)
        self._spike_consec = 0          # consecutive out-of-band samples
        self._retry_seq = 0             # deterministic jitter source
        self._counters = {"reads": 0, "failures": 0, "retries": 0,
                          "timeouts": 0, "failovers": 0, "failbacks": 0,
                          "counter_resets": 0, "spikes_rejected": 0,
                          "samples_rejected": 0, "breaker_opens": 0}

    # -- health ------------------------------------------------------------
    @property
    def state(self) -> str:
        return self._state

    def health(self) -> dict:
        """Snapshot of supervisor + per-backend health for telemetry."""
        return {
            "state": self._state,
            "active_backend": self._chain[self._active_index].sensor.name,
            "active_index": self._active_index,
            "counters": dict(self._counters),
            "backends": [
                {"name": be.sensor.name,
                 "breaker": be.breaker,
                 "consecutive_failures": be.consecutive_failures,
                 "reads": be.reads,
                 "failures": be.failures,
                 "counter_resets": be.counter_resets}
                for be in self._chain],
        }

    def _set_state(self, new_state: str, detail: str = "") -> None:
        if new_state == self._state:
            return
        old, self._state = self._state, new_state
        if self._on_transition is not None:
            try:
                self._on_transition(old, new_state, detail)
            except Exception:
                pass   # health reporting must never break the read path

    # -- sanitization ------------------------------------------------------
    def _note_watts(self, w: float) -> None:
        self._recent_watts.append(w)
        if len(self._recent_watts) > self._spike_window:
            del self._recent_watts[:len(self._recent_watts)
                                   - self._spike_window]
        # Recompute the accept band lazily every few accepts (counted,
        # not len-based — the window length pins at capacity): the gate
        # reads two cached floats on the hot path instead of a median.
        self._watts_seen += 1
        if self._spike_dirty or (self._watts_seen & 15) == 0:
            self._recompute_spike_band()

    def _recompute_spike_band(self) -> None:
        self._spike_dirty = False
        if self._spike_sigma is None or len(self._recent_watts) < 8:
            self._spike_lo, self._spike_hi = float("-inf"), float("inf")
            return
        xs = sorted(self._recent_watts)
        n = len(xs)
        med = xs[n // 2] if n & 1 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])
        devs = sorted(abs(x - med) for x in xs)
        mad = devs[n // 2] if n & 1 else 0.5 * (devs[n // 2 - 1]
                                                + devs[n // 2])
        # Floor the robust sigma so a perfectly flat idle trace doesn't
        # reject the first genuine load step as a "spike".
        sigma = max(1.4826 * mad, 0.05 * abs(med), 1e-3)
        half = self._spike_sigma * sigma
        self._spike_lo, self._spike_hi = med - half, med + half

    def _sanitize(self, be: _Backend, s: Sample) -> Sample:
        """Validate one raw sample; raises SensorError on rejection.
        Returns the sample with joules rebased into the supervised
        continuous counter."""
        w = s.watts
        if w is not None:
            if not math.isfinite(w) or w < 0.0:
                self._counters["samples_rejected"] += 1
                raise _RejectedSample(
                    f"backend {be.sensor.name!r} reported invalid watts "
                    f"{w!r}")
            if not (self._spike_lo <= w <= self._spike_hi):
                # A transient outlier is a spike; a *sustained*
                # out-of-band level is a genuine step change (load
                # ramp, frequency shift) — after two consecutive
                # rejections accept it and rebuild the band around the
                # new level instead of rejecting the signal forever.
                self._spike_consec += 1
                if self._spike_consec <= 2:
                    self._counters["spikes_rejected"] += 1
                    self._counters["samples_rejected"] += 1
                    raise _RejectedSample(
                        f"backend {be.sensor.name!r} watts {w:.3f} "
                        f"outside robust band [{self._spike_lo:.3f}, "
                        f"{self._spike_hi:.3f}] (spike)")
                self._spike_consec = 0
                self._recent_watts.clear()
                self._spike_dirty = True
            else:
                self._spike_consec = 0
            self._note_watts(w)

        raw_j = s.joules
        if raw_j is None:
            return s
        if not math.isfinite(raw_j):
            self._counters["samples_rejected"] += 1
            raise _RejectedSample(
                f"backend {be.sensor.name!r} reported invalid joules "
                f"{raw_j!r}")
        # Rebase the raw counter into the continuous supervised series.
        if be.joules_offset is None:
            # First read from this backend (or after failover away and
            # back): continue from wherever the supervised counter is.
            base = self._sup_joules if self._sup_joules is not None \
                else raw_j
            be.joules_offset = base - raw_j
        elif be.last_raw_joules is not None and raw_j < be.last_raw_joules:
            # Counter went backwards: reset/wraparound.  Treat the new
            # raw value as energy accumulated *since* the reset.
            be.counter_resets += 1
            self._counters["counter_resets"] += 1
            base = self._sup_joules if self._sup_joules is not None \
                else 0.0
            be.joules_offset = base - min(raw_j, 0.0)
            # max(raw, 0): a reset to a negative counter still must not
            # roll the supervised series backwards.
        be.last_raw_joules = raw_j
        sup_j = raw_j + be.joules_offset
        if self._sup_joules is not None and sup_j < self._sup_joules:
            # Belt and braces: never publish a regression.
            be.joules_offset += self._sup_joules - sup_j
            sup_j = self._sup_joules
        self._sup_joules = sup_j
        return Sample(joules=sup_j, watts=w, rails=s.rails)

    # -- breaker -----------------------------------------------------------
    def _breaker_allows(self, be: _Backend, now: float) -> bool:
        if be.breaker == _BREAKER_CLOSED:
            return True
        if be.breaker == _BREAKER_OPEN:
            if now - be.opened_at >= self._breaker_cooldown_s:
                be.breaker = _BREAKER_HALF_OPEN
                return True          # one probe allowed
            return False
        return True                  # half-open: probe in flight

    def _record_failure(self, be: _Backend, now: float) -> None:
        be.failures += 1
        be.consecutive_failures += 1
        self._counters["failures"] += 1
        if be.breaker == _BREAKER_HALF_OPEN or \
                be.consecutive_failures >= self._breaker_threshold:
            if be.breaker != _BREAKER_OPEN:
                self._counters["breaker_opens"] += 1
            be.breaker = _BREAKER_OPEN
            be.opened_at = now

    def _record_success(self, be: _Backend) -> None:
        be.reads += 1
        be.consecutive_failures = 0
        be.breaker = _BREAKER_CLOSED

    def _backoff(self, attempt: int) -> float:
        """Deterministic backoff for retry ``attempt`` (0-based)."""
        base = self._backoff_s * (2.0 ** attempt)
        self._retry_seq += 1
        # Deterministic "jitter": a fixed multiplicative pattern keyed
        # off the global retry counter — reproducible in tests, still
        # decorrelates synchronized retry storms across supervisors.
        frac = ((self._retry_seq * 2654435761) & 0xFF) / 255.0
        return base * (1.0 + self._backoff_jitter * frac)

    # -- the supervised read ----------------------------------------------
    def _read_backend(self, be: _Backend) -> Sample:
        """One attempt against one backend, with deadline enforcement."""
        t0 = self._clock()
        s = be.sensor._sample()
        if self._deadline_s is not None \
                and self._clock() - t0 > self._deadline_s:
            self._counters["timeouts"] += 1
            raise SensorError(
                f"backend {be.sensor.name!r} read exceeded deadline "
                f"{self._deadline_s}s")
        return s

    def _sample(self) -> Sample:
        self._counters["reads"] += 1
        be = self._chain[0]
        # Fast path — healthy primary, breaker closed, no deadline: the
        # steady-state supervised read is one backend call plus
        # sanitize, with no clock reads and no retry scaffolding (the
        # <= 1.1x read-overhead budget lives or dies here).
        if self._active_index == 0 and be.breaker == _BREAKER_CLOSED \
                and self._deadline_s is None:
            try:
                s = be.sensor._sample()
                w = s.watts
                # Inlined accept for the dominant shape — a finite,
                # non-negative, in-band watts-only sample.  (NaN fails
                # every comparison; inf fails the w - w == 0.0 check;
                # anything else falls through to the full sanitizer.)
                if w is not None and s.joules is None and w >= 0.0 \
                        and w - w == 0.0 \
                        and self._spike_lo <= w <= self._spike_hi:
                    self._spike_consec = 0
                    rw = self._recent_watts
                    rw.append(w)
                    if len(rw) > self._spike_window:
                        del rw[0]
                    self._watts_seen += 1
                    if (self._watts_seen & 15) == 0 or self._spike_dirty:
                        self._recompute_spike_band()
                else:
                    s = self._sanitize(be, s)
            except Exception as e:     # noqa: BLE001 — any read fault
                self._record_failure(be, self._clock())
                return self._sample_slow(skip=1, last_err=e)
            be.reads += 1
            be.consecutive_failures = 0
            if self._state != OK:
                self._set_state(OK,
                                detail=f"serving from {be.sensor.name!r}")
            return s
        return self._sample_slow()

    def _sample_slow(self, skip: int = 0,
                     last_err: Optional[Exception] = None) -> Sample:
        """Full supervised read: retry with backoff, fail over down the
        chain.  ``skip`` attempts against the primary were already
        consumed (and recorded as failures) by the fast path."""
        for i, be in enumerate(self._chain):
            if not self._breaker_allows(be, self._clock()):
                continue
            for attempt in range(skip if i == 0 else 0,
                                 self._retries + 1):
                if attempt:
                    self._counters["retries"] += 1
                    if not isinstance(last_err, _RejectedSample):
                        self._sleep(self._backoff(attempt - 1))
                try:
                    s = self._sanitize(be, self._read_backend(be))
                except Exception as e:     # noqa: BLE001 — any read fault
                    last_err = e
                    self._record_failure(be, self._clock())
                    if be.breaker == _BREAKER_OPEN:
                        break              # stop retrying an open breaker
                else:
                    self._record_success(be)
                    if i != self._active_index:
                        if i > self._active_index:
                            self._counters["failovers"] += 1
                        else:
                            self._counters["failbacks"] += 1
                        # The backend we're leaving must rebase when it
                        # next serves (its raw counter kept advancing).
                        self._chain[self._active_index].joules_offset = None
                        self._chain[self._active_index].last_raw_joules = \
                            None
                        self._active_index = i
                    self._set_state(
                        OK if i == 0 else DEGRADED,
                        detail=f"serving from {be.sensor.name!r}")
                    return s
        self._set_state(FAILED, detail=str(last_err))
        raise SensorError(
            f"all {len(self._chain)} backend(s) failed; last error: "
            f"{last_err}")

    def __repr__(self):
        names = ">".join(be.sensor.name for be in self._chain)
        return (f"<SensorSupervisor chain={names!r} state={self._state!r} "
                f"active={self._chain[self._active_index].sensor.name!r}>")
