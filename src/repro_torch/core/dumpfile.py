"""Dump-mode file format — writer and reader.

The paper's dump-mode "writes into a file timestamps and power
measurements to be able to examine the power consumption over time".

Format (text, one record per line, whitespace-separated):

    # pmt-dump v1 sensor=<name> kind=<kind> t0=<unix epoch seconds>
    <t_rel_seconds> <watts> <joules_cumulative>
    ...

``watts`` is the backend's instantaneous power when it has one, else the
average power since the previous record; ``joules_cumulative`` is the
sensor's unwrapped energy counter.  The reader returns the records and the
header so analyses (benchmarks/, examples/power_timeline.py) can rebuild
absolute timelines and stack multiple sensors (paper Fig. 2).
"""
from __future__ import annotations

import dataclasses
import io
import time
from typing import List, Optional, TextIO, Tuple


@dataclasses.dataclass(frozen=True)
class DumpRecord:
    t_rel_s: float
    watts: float
    joules: float


@dataclasses.dataclass(frozen=True)
class DumpHeader:
    version: int
    sensor: str
    kind: str
    t0: float


class DumpWriter:
    """Line-buffered dump writer. Thread-compatible with one writer."""

    def __init__(self, filename: str, sensor_name: str, sensor_kind: str,
                 t0: Optional[float] = None):
        self._f: TextIO = open(filename, "w", buffering=1)
        self._t0 = time.time() if t0 is None else t0
        self._f.write(f"# pmt-dump v1 sensor={sensor_name} "
                      f"kind={sensor_kind} t0={self._t0:.6f}\n")

    def write(self, t_rel_s: float, watts: float, joules: float) -> None:
        self._f.write(f"{t_rel_s:.6f} {watts:.6f} {joules:.6f}\n")

    def close(self) -> None:
        self._f.close()


def _parse_header(line: str) -> DumpHeader:
    if not line.startswith("# pmt-dump"):
        raise ValueError(f"not a pmt dump file (header: {line[:40]!r})")
    parts = line.split()  # ['#', 'pmt-dump', 'v1', 'sensor=..', ...]
    fields = dict(kv.split("=", 1) for kv in parts[3:])
    version = int(parts[2].lstrip("v"))
    return DumpHeader(version=version, sensor=fields.get("sensor", "?"),
                      kind=fields.get("kind", "?"),
                      t0=float(fields.get("t0", "0")))


def read_dump(filename: str) -> Tuple[DumpHeader, List[DumpRecord]]:
    with open(filename, "r") as f:
        return read_dump_io(f)


def read_dump_io(f: io.TextIOBase) -> Tuple[DumpHeader, List[DumpRecord]]:
    header = _parse_header(f.readline().rstrip("\n"))
    records: List[DumpRecord] = []
    for line in f:
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        t, w, j = line.split()
        records.append(DumpRecord(float(t), float(w), float(j)))
    return header, records


def total_joules(records: List[DumpRecord]) -> float:
    if len(records) < 2:
        return 0.0
    return records[-1].joules - records[0].joules


def average_watts(records: List[DumpRecord]) -> float:
    if len(records) < 2:
        return records[0].watts if records else 0.0
    dt = records[-1].t_rel_s - records[0].t_rel_s
    if dt <= 0:
        return records[0].watts
    return total_joules(records) / dt
