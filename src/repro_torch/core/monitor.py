"""PowerMonitor — PMT integrated into the training/serving loop.

This is the framework-facing layer (DESIGN.md §3): per-step energy
attribution over one or more sensors, a CSV energy log, cumulative
accounting that survives checkpoint/restart, and power-based straggler
detection for the fault-tolerance stack.

Since the ``pmt.Session`` redesign the monitor no longer polls sensors
itself: ``measure_step`` opens a session region, so step energy resolves
against the shared background ring sampler.  A monitor can run on its own
session (default; sensors still shared via the process pool) or be handed
an existing one, in which case the serve engine, the train loop, and the
monitor all attach to the same sampler per backend instead of
double-polling.  ``measure_step(..., blocking=False)`` keeps even
resolution off the loop: step exit enqueues the span, the monitor's
records/CSV/cumulative counters update when the session's background
resolver finishes it, and reads of accumulated state settle in-flight
steps first.

Asynchronous launches: CUDA kernels return before the card finishes, so
a step is only attributed the energy between explicit
``torch.cuda.synchronize()`` boundaries — the caller must fence before
the ``measure_step`` block exits, otherwise readings would attribute a step's
tail to its successor.
"""
from __future__ import annotations

import contextlib
import dataclasses
import statistics
import threading
import warnings
from typing import Callable, Dict, List, Optional, Sequence, TextIO, Union

from repro_torch.core.metrics import EfficiencyReport
from repro_torch.core.sensor import Sensor, SensorError
from repro_torch.core.session import Session


@dataclasses.dataclass(frozen=True)
class StepEnergy:
    """Energy record for one step (or serve request), one sensor.

    ``scope`` distinguishes training/serving *steps* from per-request
    serve spans (``measure_request``); ``step`` holds the request id for
    the latter.
    """

    step: int
    sensor: str
    kind: str
    joules: float
    seconds: float
    watts: float
    flops: Optional[float] = None
    tokens: Optional[int] = None
    scope: str = "step"
    # serve phase split: "prefill" / "decode" child spans of a request
    # (None = the whole-request span)
    phase: Optional[str] = None

    def report(self) -> EfficiencyReport:
        return EfficiencyReport(joules=self.joules, seconds=self.seconds,
                                flops=self.flops, tokens=self.tokens)


class PowerMonitor:
    """Attributes per-step energy across a set of sensors.

    Args:
      sensors: backend names or Sensor instances (stacked like the paper's
        multi-decorator usage — e.g. ["cpuutil", "nvml"]).  May be empty
        when ``session`` already has backends attached.
      log_path: optional CSV energy log (append mode, crash-tolerant:
        one flushed line per step).
      initial_joules: cumulative joules carried over from a checkpoint.
      session: an existing :class:`pmt.Session` to measure through; the
        monitor attaches its sensors to it and does NOT close it.  When
        omitted the monitor owns a private session on the shared pool.
    """

    CSV_HEADER = ("step,sensor,kind,joules,seconds,watts,flops,tokens,"
                  "gflops_per_watt,edp\n")

    def __init__(self, sensors: Sequence[Union[str, Sensor]] = (),
                 log_path: Optional[str] = None,
                 initial_joules: float = 0.0,
                 session: Optional[Session] = None):
        self._owns_session = session is None
        self._session = session if session is not None else Session()
        try:
            for s in sensors:
                self._session.attach(s)
        except BaseException:
            if self._owns_session:
                self._session.close()
            raise
        self.sensors: List[Sensor] = self._session.sensors
        if not self.sensors:
            raise ValueError("PowerMonitor needs at least one sensor")
        self._records: List[StepEnergy] = []
        self._cumulative_joules = float(initial_joules)
        self._inflight: set = set()      # non-blocking boxes not yet settled
        self._subs: List[Callable[[StepEnergy], None]] = []
        self._lock = threading.Lock()
        self._log: Optional[TextIO] = None
        if log_path:
            self._log = open(log_path, "a", buffering=1)
            if self._log.tell() == 0:
                self._log.write(self.CSV_HEADER)

    @property
    def session(self) -> Session:
        return self._session

    # -- live record stream -------------------------------------------------
    def subscribe(self, fn: Callable[[StepEnergy], None]):
        """Register ``fn`` for every :class:`StepEnergy` as it settles
        (step *and* request/phase records); returns an unsubscribe.

        The callback runs on whichever thread resolves the span —
        usually the session's background resolver — so it must not
        block; if it raises it is dropped with a warning (mirroring the
        :class:`~repro_torch.core.export.MemoryExporter` subscriber contract).
        The telemetry plane's :class:`~repro_torch.telemetry.PowerRecorder`
        hangs off this to stream per-step/per-request energy live.
        """
        with self._lock:
            self._subs.append(fn)

        def unsubscribe() -> None:
            with self._lock:
                for i, sub in enumerate(self._subs):
                    if sub is fn:
                        del self._subs[i]
                        break

        return unsubscribe

    def _fanout(self, recs: List[StepEnergy]) -> None:
        """Deliver settled records to subscribers (no locks held)."""
        with self._lock:
            subs = list(self._subs)
        for fn in subs:
            for r in recs:
                try:
                    fn(r)
                except Exception as e:
                    with self._lock:
                        for i, sub in enumerate(self._subs):
                            if sub is fn:
                                del self._subs[i]
                                break
                    warnings.warn(
                        f"PowerMonitor subscriber {fn!r} raised "
                        f"{type(e).__name__}: {e}; subscriber dropped")
                    break

    # -- per-step measurement --------------------------------------------
    def measure_step(self, step: int, flops: Optional[float] = None,
                     tokens: Optional[int] = None, blocking: bool = True):
        """Context manager measuring one fenced step across all sensors.

        A thin wrapper over ``session.region(...)`` — entry/exit touch no
        sensors on this thread.  With ``blocking=True`` (the classic
        contract) the step resolves against the shared ring buffer at
        exit and ``box.records`` is materialised before the ``with``
        block returns.  With ``blocking=False`` exit is O(1): the span
        resolves on the session's background resolver thread, the
        monitor's accounting/CSV update when it does, and ``box.records``
        only blocks (resolving synchronously) if actually read — the
        hot-loop mode ``make_measured_train_step`` and the serve engine
        use.

        The caller must ensure device work is complete before the block
        exits (``torch.cuda.synchronize()`` after the step's launches).
        """
        return self._measure(f"step{step}", step, flops, tokens, blocking,
                             nested=True, scope="step")

    def measure_request(self, request_id: int,
                        flops: Optional[float] = None,
                        tokens: Optional[int] = None,
                        blocking: bool = False,
                        phase: Optional[str] = None):
        """Measure one *serve request* end to end (admission -> last token),
        or — with ``phase="prefill"``/``"decode"`` — one phase of it.

        Unlike ``measure_step`` this opens a flat (non-nested) session
        span: the serve engine holds many request spans open at once and
        closes them in completion order, which the thread-local nesting
        stack cannot express.  Records land with ``scope="request"`` and
        ``step=request_id`` (phase spans additionally carry
        ``phase``, under the ``req<N>/<phase>`` label); read them back
        via :meth:`request_records` or :meth:`per_request_energy`
        (J/token per request, with the prefill/decode J split).

        Request spans overlap each other *and* the aggregate
        ``measure_step`` region covering the same wall-clock window, so
        they are attribution views, not additional energy: they are
        excluded from :attr:`cumulative_joules` and the per-step CSV
        log (which both account each joule exactly once, via steps).
        The two phase spans tile the request span, so their joules sum
        to the request total (within sampler interpolation).
        """
        label = f"req{request_id}" + (f"/{phase}" if phase else "")
        return self._measure(label, request_id, flops, tokens,
                             blocking, nested=False, scope="request",
                             phase=phase)

    @contextlib.contextmanager
    def _measure(self, label: str, step: int, flops: Optional[float],
                 tokens: Optional[int], blocking: bool, nested: bool,
                 scope: str, phase: Optional[str] = None):
        box = _StepBox()

        def finish(measurements):
            recs = [StepEnergy(
                step=step, sensor=m.sensor, kind=m.kind, joules=m.joules,
                seconds=m.seconds, watts=m.watts, flops=flops,
                tokens=tokens, scope=scope, phase=phase)
                for m in measurements]
            with self._lock:
                self._records.extend(recs)
                if scope == "step":
                    # request spans overlap the step region measuring
                    # the same window — counting both would double-book
                    # joules in the checkpointable total and the CSV
                    self._cumulative_joules += sum(r.joules for r in recs)
                    for r in recs:
                        self._write_log(r)
                self._inflight.discard(box)
            box._records = recs
            self._fanout(recs)

        handle = self._session.region(label, flops=flops, tokens=tokens,
                                      on_resolved=finish, nested=nested)
        box._handle = handle
        handle.__enter__()
        try:
            yield box
        finally:
            with self._lock:
                self._inflight.add(box)
            handle.__exit__(None, None, None)
            if blocking:
                handle.measurements     # forces resolution -> finish()

    def _write_log(self, r: StepEnergy) -> None:
        # Caller holds self._lock (records may finish on the resolver
        # thread and a user thread concurrently).
        if self._log is None:
            return
        rep = r.report()
        g = rep.gflops_per_watt
        self._log.write(
            f"{r.step},{r.sensor},{r.kind},{r.joules:.6f},{r.seconds:.6f},"
            f"{r.watts:.3f},{'' if r.flops is None else f'{r.flops:.0f}'},"
            f"{'' if r.tokens is None else r.tokens},"
            f"{'' if g is None else f'{g:.3f}'},{rep.edp:.6f}\n")

    def _settle(self) -> None:
        """Resolve any outstanding non-blocking steps (before reading
        accumulated state).  Takes the session resolve path, so call
        *outside* ``self._lock``.  Boxes whose span errored (sampler
        stopped) or fell off the session's auto-resolve queue are
        settled here too — forcing via the handle either recovers the
        records or retires the box, so the in-flight set cannot leak.
        """
        with self._lock:
            boxes = list(self._inflight)
        for box in boxes:
            box.records                  # forces resolution (or [] on error)
            with self._lock:
                self._inflight.discard(box)

    # -- cumulative accounting (checkpointable) -----------------------------
    @property
    def cumulative_joules(self) -> float:
        self._settle()
        with self._lock:
            return self._cumulative_joules

    def state_dict(self) -> Dict[str, float]:
        """Energy state persisted inside checkpoints (DESIGN.md §3)."""
        self._settle()
        with self._lock:
            recent = self._records[-32:]
            j_per_step = (statistics.fmean(r.joules for r in recent)
                          if recent else 0.0)
            return {"cumulative_joules": self._cumulative_joules,
                    "joules_per_step_ema": j_per_step}

    def records(self) -> List[StepEnergy]:
        self._settle()
        with self._lock:
            return list(self._records)

    # -- per-request accounting (serve path) -----------------------------
    def request_records(self) -> List[StepEnergy]:
        """Resolved ``measure_request`` records (scope == "request")."""
        return [r for r in self.records() if r.scope == "request"]

    def per_request_energy(self) -> Dict[int, Dict[str, float]]:
        """Aggregate per-request accounting across sensors.

        Returns ``{request_id: {"joules", "seconds", "tokens",
        "j_per_token", "prefill_joules", "decode_joules"}}`` — joules
        summed over sensors, seconds the max (sensors cover the same
        wall interval), J/token against the request's generated-token
        count.  The phase keys come from the ``serve/req<N>/prefill``
        and ``.../decode`` child spans, which tile the request span:
        their sum matches the request total (within sampler
        interpolation).
        """
        out: Dict[int, Dict[str, float]] = {}
        for r in self.request_records():
            d = out.setdefault(r.step, {"joules": 0.0, "seconds": 0.0,
                                        "tokens": 0,
                                        "prefill_joules": 0.0,
                                        "decode_joules": 0.0})
            if r.phase is None:
                d["joules"] += r.joules
                d["seconds"] = max(d["seconds"], r.seconds)
                d["tokens"] = r.tokens or d["tokens"]
            else:
                key = f"{r.phase}_joules"
                d[key] = d.get(key, 0.0) + r.joules
        for d in out.values():
            d["j_per_token"] = d["joules"] / max(d["tokens"], 1)
        return out

    def close(self) -> None:
        try:
            self._settle()         # flush in-flight async steps first
        except SensorError:        # session already torn down
            pass
        with self._lock:
            if self._log is not None:
                self._log.close()
                self._log = None
        if self._owns_session:
            self._session.close()


class _StepBox:
    """Carries one step's :class:`StepEnergy` records.

    Blocking steps fill it before ``measure_step`` exits.  Non-blocking
    steps fill it when the background resolver finishes the span —
    reading :attr:`records` earlier forces resolution on the calling
    thread (future-style), so a loop that logs every Nth step only pays
    resolution on those steps.
    """

    def __init__(self):
        # Instance attributes, not shared class-level defaults: two
        # concurrent steps must never see each other's records.
        self._records: Optional[List[StepEnergy]] = None
        self._handle = None

    @property
    def records(self) -> List[StepEnergy]:
        if self._records is None:
            if self._handle is not None:
                try:
                    self._handle.measurements   # triggers finish() callback
                except SensorError:
                    pass                        # still open / sampler gone
            if self._records is None:
                self._records = []
        return self._records

    @records.setter
    def records(self, value: List[StepEnergy]) -> None:
        self._records = value


# -- fleet-level straggler detection (fault-tolerance integration) ---------

@dataclasses.dataclass(frozen=True)
class StragglerVerdict:
    host: int
    power_w: float
    step_s: float
    power_z: float
    time_z: float
    is_straggler: bool


def detect_stragglers(host_power_w: Sequence[float],
                      host_step_s: Sequence[float],
                      power_sigma: float = 3.0,
                      time_sigma: float = 3.0) -> List[StragglerVerdict]:
    """Flag hosts whose power deviates while their step time lags.

    A host that is *slow* and *anomalous in power* (low → throttling or a
    dead accelerator; high → a runaway/thermal issue) is a straggler
    candidate.  Power alone is not enough (data skew changes power
    legitimately); time alone is the classic detector — requiring both
    cuts false positives.  Uses robust (median/MAD) z-scores.
    """
    if len(host_power_w) != len(host_step_s):
        raise ValueError("power and step-time vectors must align")
    n = len(host_power_w)
    if n == 0:
        return []

    def robust_z(xs: Sequence[float]) -> List[float]:
        med = statistics.median(xs)
        mad = statistics.median([abs(x - med) for x in xs])
        scale = 1.4826 * mad
        if scale == 0.0:
            # MAD degenerates when >50% of hosts are identical (the
            # common healthy-fleet case) — fall back to the std so a
            # single outlier is still visible.
            scale = statistics.pstdev(xs) if len(xs) > 1 else 0.0
        if scale == 0.0:
            return [0.0] * len(xs)
        return [(x - med) / scale for x in xs]

    pz = robust_z(host_power_w)
    tz = robust_z(host_step_s)
    out = []
    for i in range(n):
        slow = tz[i] > time_sigma
        odd_power = abs(pz[i]) > power_sigma
        out.append(StragglerVerdict(
            host=i, power_w=host_power_w[i], step_s=host_step_s[i],
            power_z=pz[i], time_z=tz[i], is_straggler=bool(slow and odd_power)))
    return out
