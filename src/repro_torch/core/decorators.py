"""Classic PMT surfaces — now thin shims over the implicit default session.

    import repro_torch.core as pmt

    @pmt.measure("rapl")
    def my_application():
        ...

    measures = my_application()
    for m in measures:
        print(m)

Semantics preserved from the paper:

  * the decorated call returns the measurements (a :class:`Measurements`
    list of one :class:`Measurement` per backend); the wrapped function's
    own return value is available as ``measures.result``;
  * decorators stack — ``@pmt.measure("nvml")`` above ``@pmt.measure("cpuutil")``
    yields both measurements in one list (paper Fig. 2 stacks GPU on CPU);
  * ``@pmt.dump(backend, filename=...)`` is measurement's dump-mode twin.

What changed (the ``pmt.Session`` redesign): sensors are no longer
constructed privately per decorated function.  Every shim draws its
sensor from the process-wide default :class:`~repro_torch.core.session.SensorPool`
(the same pool behind ``pmt.Session`` / ``pmt.region``), so a decorator,
the serve engine, and the train loop measuring the same backend all
share one sensor (and, for Region consumers, one background sampler).
``pmt.Region`` resolves against the shared ring buffer instead of
issuing its own reads; its per-backend shim sessions are closed at
interpreter exit.

Deprecation note: these shims stay supported, but new code should use
:class:`pmt.Session` directly — ``with session.region("roi"):`` is
non-blocking on the hot path and nests; ``@pmt.measure`` still performs
two synchronous reads around the call (the paper's Listing 2 contract
requires materialised results at return time).
"""
from __future__ import annotations

import atexit
import dataclasses
import functools
import threading
import weakref
from typing import Any, Dict, List, Optional, Union

from repro_torch.core.sensor import Sensor, SensorError
from repro_torch.core.state import State


@dataclasses.dataclass(frozen=True)
class Measurement:
    """One backend's measurement of one region of interest.

    ``window_evicted`` flags a session region that outlived the sampling
    ring: its bracketing start sample was overwritten before resolution,
    so ``joules`` covers a truncated window (see
    ``repro_torch.core.sampler.SamplerWindowEvicted``).

    ``degraded`` flags a region that straddled a sampler coverage gap
    (failed reads / sensor blackout): ``joules`` interpolates across the
    blackout, so treat the number as a lower-confidence estimate (see
    ``repro_torch.core.sampler.SamplerCoverageGap``).
    """

    sensor: str
    kind: str
    joules: float
    watts: float
    seconds: float
    start: State
    end: State
    label: Optional[str] = None
    window_evicted: bool = False
    degraded: bool = False

    def __str__(self) -> str:
        tag = f"{self.sensor}" + (f"[{self.label}]" if self.label else "")
        return (f"{tag}: {self.joules:.6f} J, {self.watts:.6f} W, "
                f"{self.seconds:.6f} s ({self.kind})")

    @property
    def edp(self) -> float:
        """Energy-delay product, J*s (paper §III)."""
        return self.joules * self.seconds


class Measurements(List[Measurement]):
    """List of measurements; carries the wrapped function's return value."""

    result: Any = None

    def by_sensor(self, name: str) -> Measurement:
        for m in self:
            if m.sensor == name:
                return m
        raise KeyError(name)

    def total_joules(self) -> float:
        return sum(m.joules for m in self)


def _pooled(backend: Union[str, Sensor], sampling: bool = False, **kwargs):
    """A lease on a shared sensor from the default pool."""
    from repro_torch.core.session import default_pool

    return default_pool().acquire(backend, sampling=sampling, **kwargs)


def _adopt_leases(wrapper, leases) -> None:
    """Tie pool leases to a decorated function's lifetime.

    The wrapper holds the leases (so the sensors stay pooled while it
    is callable) and releases them when it is garbage collected —
    without this, dynamically-created decorators would grow the pool
    unboundedly with entries nothing can ever release.
    """
    wrapper.__pmt_leases__ = leases
    wrapper.__pmt_sensors__ = [l.sensor for l in leases]
    for lease in leases:
        weakref.finalize(wrapper, lease.release)


# Single-backend sessions backing the Region shim, one per pool key, so
# Region("dummy") resolves only dummy even when the default session has
# other backends attached.
_shim_sessions: Dict[Any, "object"] = {}
_shim_lock = threading.Lock()


def _shim_session(backend: Union[str, Sensor], **kwargs):
    from repro_torch.core.session import Session, SensorPool, default_pool

    key = SensorPool._key_for(backend, kwargs)
    with _shim_lock:
        sess = _shim_sessions.get(key)
        if sess is None or sess._closed:
            sess = Session(pool=default_pool())
            sess.attach(backend, **kwargs)
            _shim_sessions[key] = sess
        return sess


@atexit.register
def _close_shim_sessions() -> None:  # pragma: no cover - teardown
    with _shim_lock:
        sessions = list(_shim_sessions.values())
        _shim_sessions.clear()
    for sess in sessions:
        try:
            sess.close()
        except Exception:
            pass


def measure(*backends: Union[str, Sensor], label: Optional[str] = None,
            **backend_kwargs):
    """Measurement-mode decorator (paper mode 2) — blocking by contract.

    One pooled sensor per listed backend is read before and after the
    wrapped call.  Multiple backends in one decorator and stacked
    decorators both work and produce a flat :class:`Measurements` list.

    Prefer ``session.region(...)`` for hot paths: this decorator must
    return resolved measurements, so it reads synchronously on the
    caller's thread (see benchmarks/bench_overhead.py for the gap).
    """
    if not backends:
        raise ValueError("pmt.measure requires at least one backend")

    def decorate(fn):
        leases = [_pooled(b, **backend_kwargs) for b in backends]
        sensors = [l.sensor for l in leases]

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            starts = [s.read() for s in sensors]
            inner = fn(*args, **kwargs)
            ends = [s.read() for s in sensors]
            out = Measurements()
            for sensor, st, en in zip(sensors, starts, ends):
                out.append(Measurement(
                    sensor=sensor.name, kind=sensor.kind,
                    joules=Sensor.joules(st, en),
                    watts=Sensor.watts(st, en),
                    seconds=Sensor.seconds(st, en),
                    start=st, end=en, label=label))
            if isinstance(inner, Measurements):
                # Stacked decorator underneath: merge, keep its result.
                out.extend(inner)
                out.result = inner.result
            else:
                out.result = inner
            return out

        _adopt_leases(wrapper, leases)  # __pmt_sensors__ for tests/benchmarks
        return wrapper

    return decorate


def dump(backend: Union[str, Sensor], filename: str,
         period_s: Optional[float] = None, **backend_kwargs):
    """Dump-mode decorator (paper mode 1).

    Runs a background dump thread for the duration of the wrapped call,
    writing the power timeline to ``filename``; the wrapped function's own
    return value passes through unchanged (measurements live in the file).

    The sensor is pooled; the dump thread is private to this decorator,
    so two dump decorators over the same backend coexist (each owns its
    file).
    """

    def decorate(fn):
        from repro_torch.core.sampler import DumpThread

        lease = _pooled(backend, **backend_kwargs)
        sensor = lease.sensor
        running = threading.Lock()

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            # One dump at a time per decorated function: a concurrent
            # second call would truncate and interleave the same file.
            if not running.acquire(blocking=False):
                raise SensorError(
                    f"dump thread already running for {filename!r}")
            thread = DumpThread(sensor, filename, period_s=period_s)
            thread.start()
            try:
                return fn(*args, **kwargs)
            finally:
                thread.stop()
                running.release()

        _adopt_leases(wrapper, [lease])
        return wrapper

    return decorate


class Region:
    """Imperative measurement helper (the C++ Listing 1 shape)::

        with pmt.Region(sensor) as r:
            work()
        print(r.measurement)

    Now a shim over a pooled single-backend session region: entry/exit
    are non-blocking; the measurement resolves against the shared ring
    buffer when the block exits (at most one closing sample).
    """

    def __init__(self, sensor: Union[str, Sensor], label: Optional[str] = None,
                 **backend_kwargs):
        self._session = _shim_session(sensor, **backend_kwargs)
        self._label = label
        self.measurement: Optional[Measurement] = None

    def __enter__(self) -> "Region":
        self._handle = self._session.region(self._label)
        self._handle.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self._handle.__exit__(*exc)
        m = self._handle.measurements[0]
        # Old Region reported the caller's label verbatim (not a path).
        self.measurement = dataclasses.replace(m, label=self._label)
        return False
