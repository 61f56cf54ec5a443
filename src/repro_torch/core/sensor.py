"""PMT ``Sensor`` abstract base class.

Mirrors the C++ PMT API:

    std::unique_ptr<pmt::pmt> sensor(pmt::nvml::NVML::create());
    pmt::State start = sensor->read();
    ...
    sensor->joules(start, end); sensor->watts(start, end); sensor->seconds(...)

plus the dump-mode entry points ``start_dump_thread`` / ``stop_dump_thread``.

Backend authors implement ``_sample()`` returning a :class:`Sample`; the
base class turns samples into ``State``s, integrating instantaneous power
into a cumulative joules counter when the backend has no native energy
counter.  This mirrors how PMT's core background thread accumulates for
power-only backends like NVML.
"""
from __future__ import annotations

import abc
import dataclasses
import math
import threading
import time
from typing import Callable, Dict, Optional

from repro_torch.core import state as state_mod
from repro_torch.core.state import State


@dataclasses.dataclass(frozen=True)
class Sample:
    """Raw backend sample. At least one of ``joules``/``watts`` is set.

    Attributes:
      joules: cumulative energy counter (already unwrapped), if the
        backend is an energy counter (RAPL-like).
      watts: instantaneous power, if the backend is a power meter
        (NVML-like).
      rails: per-rail cumulative joules.
    """

    joules: Optional[float] = None
    watts: Optional[float] = None
    rails: Dict[str, float] = dataclasses.field(default_factory=dict)


class SensorError(RuntimeError):
    """Raised when a backend is unavailable or misbehaves."""


class Sensor(abc.ABC):
    """Abstract power sensor with PMT semantics.

    Class attributes (overridden per backend):
      name: registry name ("nvml", "cpuutil", "dummy", ...).
      kind: "measured" for physical counters, "modeled" for analytical
        models, "hybrid" for measured-activity x modeled-coefficients.
      native_period_s: fastest sampling period the backend sustains
        (paper: ~10 ms for NVML, ~500 ms for RAPL).
    """

    name: str = "abstract"
    kind: str = "measured"
    native_period_s: float = 0.010

    def __init__(self, clock: Optional[Callable[[], float]] = None):
        # ``clock`` is injectable for deterministic tests; defaults to a
        # monotonic clock so intervals are immune to wall-clock jumps.
        self._clock: Callable[[], float] = clock or time.monotonic
        self._lock = threading.Lock()
        self._accum_joules = 0.0
        self._last_t: Optional[float] = None
        self._last_w: Optional[float] = None
        self._dump_thread = None  # type: Optional[object]

    # -- constructor mirroring pmt::<backend>::create() -----------------
    @classmethod
    def create(cls, **kwargs) -> "Sensor":
        return cls(**kwargs)

    @classmethod
    def is_available(cls) -> bool:
        """Whether this backend can produce readings on this host."""
        return True

    # -- backend hook ----------------------------------------------------
    @abc.abstractmethod
    def _sample(self) -> Sample:
        """Read the backend once. Must be cheap and thread-safe."""

    # -- public PMT API ---------------------------------------------------
    def now(self) -> float:
        """Current time on this sensor's clock (the ``State`` timebase).

        Session regions timestamp their spans with this so they resolve
        against ring-buffer samples taken by the same clock — including
        injected virtual clocks in tests.
        """
        return self._clock()

    def _read_locked(self):
        """One sample under ``self._lock``: ``(timestamp, joules, Sample)``.

        Shared between :meth:`read` (State-building public API) and
        :meth:`read_raw` (the array-ring sampler's allocation-light path).
        """
        t = self._clock()
        s = self._sample()
        if s.joules is not None:
            jl = s.joules
            self._last_t = t
            self._last_w = s.watts
        else:
            if s.watts is None:
                raise SensorError(
                    f"backend {self.name!r} returned neither joules nor watts")
            if not math.isfinite(s.watts) or s.watts < 0.0:
                # A NaN/inf/negative instantaneous watt would poison the
                # cumulative counter forever: drop the interval (no
                # accumulation across it) and carry the last good watts
                # forward so the *next* good interval integrates sanely.
                self._last_t = t
                return t, self._accum_joules, s
            if self._last_t is not None:
                dt = max(0.0, t - self._last_t)
                w_prev = self._last_w if self._last_w is not None else s.watts
                self._accum_joules += 0.5 * (w_prev + s.watts) * dt
            jl = self._accum_joules
            self._last_t = t
            self._last_w = s.watts
        return t, jl, s

    def read(self) -> State:
        """Take one reading, returning a :class:`State`.

        For power-only backends, integrates power trapezoidally between
        consecutive reads into the cumulative joules counter.
        """
        with self._lock:
            t, jl, s = self._read_locked()
            return State(timestamp_s=t, joules=jl, watts=s.watts,
                         rails=dict(s.rails))

    def read_raw(self):
        """Take one reading as bare floats: ``(timestamp_s, joules, watts)``.

        ``watts`` is NaN when the backend reports no instantaneous power.
        This is the sampling hot path used by the array ring sampler: no
        :class:`State` (or any other object meant to outlive the call) is
        constructed, so a steady-state sampler tick retains zero Python
        allocations.  Per-rail readings are not carried — rails stay a
        ``read()``/dump-mode concern.
        """
        with self._lock:
            t, jl, s = self._read_locked()
            return t, jl, (float("nan") if s.watts is None else s.watts)

    # Derivations — instance methods per the C++ API, also importable as
    # free functions from repro_torch.core.state.
    @staticmethod
    def joules(start: State, end: State) -> float:
        return state_mod.joules(start, end)

    @staticmethod
    def watts(start: State, end: State) -> float:
        return state_mod.watts(start, end)

    @staticmethod
    def seconds(start: State, end: State) -> float:
        return state_mod.seconds(start, end)

    # -- dump-mode (paper mode 1) ------------------------------------------
    def start_dump_thread(self, filename: str,
                          period_s: Optional[float] = None) -> None:
        """Start the background dump thread writing to ``filename``.

        Mirrors PMT's ``startDumpThread``. The sampling period defaults to
        the backend's native period.
        """
        # Imported here to avoid a cycle (sampler imports Sensor for typing).
        from repro_torch.core.sampler import DumpThread

        if self._dump_thread is not None:
            raise SensorError("dump thread already running")
        self._dump_thread = DumpThread(
            self, filename, period_s=period_s or self.native_period_s)
        self._dump_thread.start()

    def stop_dump_thread(self) -> None:
        """Stop the background dump thread (no-op if not running)."""
        if self._dump_thread is not None:
            self._dump_thread.stop()
            self._dump_thread = None

    # Pythonic context-manager sugar over dump mode.
    def dumping(self, filename: str, period_s: Optional[float] = None):
        sensor = self

        class _Ctx:
            def __enter__(self_inner):
                sensor.start_dump_thread(filename, period_s)
                return sensor

            def __exit__(self_inner, *exc):
                sensor.stop_dump_thread()
                return False

        return _Ctx()

    def __repr__(self):
        return f"<{type(self).__name__} name={self.name!r} kind={self.kind!r}>"
