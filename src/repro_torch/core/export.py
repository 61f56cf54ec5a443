"""Structured export of resolved session regions.

A :class:`repro_torch.core.session.Session` resolves every finished region into
one :class:`RegionRecord` per attached sensor and hands it to each
registered exporter.  Exporters are deliberately dumb sinks — resolution
(ring-buffer interpolation, nesting paths) happens in the session; an
exporter only serialises.

Built-in exporters:

  * :class:`CsvExporter`   — one flushed CSV row per record (the
    PowerMonitor energy-log format, generalised to arbitrary regions).
  * :class:`JsonlExporter` — one JSON object per line; round-trips via
    :func:`read_jsonl`.
  * :class:`MemoryExporter` — in-memory record stream with subscriber
    callbacks, for dashboards/tests that want records as they resolve.

Exporters must tolerate concurrent ``emit`` calls: sessions resolve
regions from whichever thread first asks for a measurement.
"""
from __future__ import annotations

import csv
import dataclasses
import json
import threading
import warnings
from typing import Callable, List, Optional, TextIO


@dataclasses.dataclass(frozen=True)
class RegionRecord:
    """One sensor's resolved measurement of one session region."""

    path: str            # nesting path, e.g. "serve/wave0/prefill"
    label: str           # leaf label, e.g. "prefill"
    depth: int           # nesting depth (0 = top-level region)
    sensor: str
    kind: str            # measured | modeled | hybrid
    start_s: float       # sensor-clock timestamp at region entry
    end_s: float         # sensor-clock timestamp at region exit
    seconds: float
    joules: float
    watts: float
    flops: Optional[float] = None
    tokens: Optional[int] = None
    # True when the region outlived the sampling ring and resolved from
    # a truncated window (energy under-reported; see SamplerWindowEvicted).
    window_evicted: bool = False
    # True when the region straddled a sampler coverage gap (failed
    # reads): joules interpolates across the blackout, lower confidence
    # (see SamplerCoverageGap).
    degraded: bool = False

    def as_json(self) -> str:
        d = dataclasses.asdict(self)
        return json.dumps(d, sort_keys=True)

    @classmethod
    def from_json(cls, line: str) -> "RegionRecord":
        d = json.loads(line)
        return cls(**d)


class Exporter:
    """Base class: override ``emit``; ``close`` is optional."""

    def emit(self, record: RegionRecord) -> None:  # pragma: no cover
        raise NotImplementedError

    def close(self) -> None:
        pass


class CsvExporter(Exporter):
    """Append-mode CSV sink, one flushed line per record."""

    HEADER = ("path,label,depth,sensor,kind,start_s,end_s,seconds,"
              "joules,watts,flops,tokens,window_evicted,degraded\n")

    def __init__(self, path: str):
        self._lock = threading.Lock()
        self._f: Optional[TextIO] = open(path, "a", buffering=1,
                                         newline="")
        self._writer = csv.writer(self._f, lineterminator="\n")
        if self._f.tell() == 0:
            self._f.write(self.HEADER)

    def emit(self, r: RegionRecord) -> None:
        with self._lock:
            if self._f is None:
                return
            # csv.writer so user-supplied path/label survive commas.
            self._writer.writerow([
                r.path, r.label, r.depth, r.sensor, r.kind,
                f"{r.start_s:.6f}", f"{r.end_s:.6f}", f"{r.seconds:.6f}",
                f"{r.joules:.6f}", f"{r.watts:.3f}",
                "" if r.flops is None else f"{r.flops:.0f}",
                "" if r.tokens is None else r.tokens,
                int(r.window_evicted), int(r.degraded)])

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


class JsonlExporter(Exporter):
    """One JSON object per line; read back with :func:`read_jsonl`."""

    def __init__(self, path: str):
        self._lock = threading.Lock()
        self._f: Optional[TextIO] = open(path, "a", buffering=1)

    def emit(self, r: RegionRecord) -> None:
        with self._lock:
            if self._f is not None:
                self._f.write(r.as_json() + "\n")

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


def read_jsonl(path: str, strict: bool = False) -> List[RegionRecord]:
    """Parse a JSONL export back into records (skips blank lines).

    A live export is appended to concurrently, so the file's last line
    may be mid-write (truncated JSON) when a tailing reader — the
    telemetry plane, a dashboard poller — gets to it.  Malformed lines
    are therefore *skipped with a warning* rather than raised on;
    ``strict=True`` restores the raising behaviour for post-hoc reads
    where corruption should be loud.
    """
    out: List[RegionRecord] = []
    with open(path) as f:
        for lineno, line in enumerate(f, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                out.append(RegionRecord.from_json(line))
            except (json.JSONDecodeError, TypeError, KeyError) as e:
                if strict:
                    raise
                warnings.warn(
                    f"{path}:{lineno}: skipping unparseable JSONL line "
                    f"({type(e).__name__}: {e}); truncated live export?")
    return out


class MemoryExporter(Exporter):
    """In-memory subscriber stream.

    Keeps every emitted record in ``records`` (bounded by ``maxlen``) and
    fans each one out to subscriber callbacks as it resolves — the seam a
    live dashboard or a per-request energy attributor hangs off.

    Thread-safety contract: ``emit`` runs on whichever thread resolves a
    span (usually the session's background resolver), concurrently with
    ``subscribe``/``unsubscribe``/``records`` from e.g. a telemetry
    server thread.  Callbacks are invoked *outside* the exporter lock
    (a blocking callback can therefore stall record delivery but never
    deadlock the exporter), against a snapshot of the subscriber list —
    a subscriber removed mid-emit may see one final record.  A callback
    that raises is warned about and dropped instead of killing the
    resolver thread.
    """

    def __init__(self, maxlen: Optional[int] = None):
        self._lock = threading.Lock()
        self._records: List[RegionRecord] = []
        self._maxlen = maxlen
        self._subs: List[Callable[[RegionRecord], None]] = []

    def subscribe(self, fn: Callable[[RegionRecord], None]) -> Callable[[], None]:
        """Register ``fn`` for future records; returns an unsubscribe.

        ``fn`` runs on the resolving thread and must not block (see
        class docstring); if it raises it is dropped with a warning.
        """
        with self._lock:
            self._subs.append(fn)

        def unsubscribe() -> None:
            self._drop(fn)

        return unsubscribe

    def _drop(self, fn: Callable[[RegionRecord], None]) -> None:
        with self._lock:
            # identity, not equality: bound methods compare equal across
            # instances, and a subscriber may be registered twice.
            for i, sub in enumerate(self._subs):
                if sub is fn:
                    del self._subs[i]
                    break

    def emit(self, r: RegionRecord) -> None:
        with self._lock:
            self._records.append(r)
            if self._maxlen is not None and len(self._records) > self._maxlen:
                del self._records[:len(self._records) - self._maxlen]
            subs = list(self._subs)
        for fn in subs:
            try:
                fn(r)
            except Exception as e:
                # The emitting thread is usually the session's span
                # resolver — one broken dashboard callback must not take
                # the measurement plane down with it.
                self._drop(fn)
                warnings.warn(
                    f"MemoryExporter subscriber {fn!r} raised "
                    f"{type(e).__name__}: {e}; subscriber dropped")

    @property
    def records(self) -> List[RegionRecord]:
        with self._lock:
            return list(self._records)

    def total_joules(self, sensor: Optional[str] = None) -> float:
        return sum(r.joules for r in self.records
                   if sensor is None or r.sensor == sensor)
