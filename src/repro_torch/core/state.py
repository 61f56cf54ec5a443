"""PMT ``State`` — a single sensor reading.

Mirrors the C++ PMT ``pmt::State``: a timestamp plus the cumulative energy
counter at read time.  The three derivations the paper exposes —
``joules(start, end)``, ``watts(start, end)``, ``seconds(start, end)`` —
are pure functions of two ``State``s and live here so they can be tested
independently of any backend.

Some backends report *per-rail* readings (e.g. RAPL package-0 / dram);
those are carried in ``rails`` as cumulative joules per rail name, with
``joules`` always equal to the backend's chosen total.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class State:
    """One reading of a power sensor.

    Attributes:
      timestamp_s: seconds since an arbitrary (per-sensor, monotonic) epoch.
      joules: cumulative energy counter at read time, in joules.  Backends
        that natively report instantaneous power integrate it into this
        counter (trapezoidal) so that ``joules(a, b)`` always works.
      watts: instantaneous power at read time, if the backend knows it
        (may be ``None`` for pure energy-counter backends such as RAPL,
        where average power must come from ``watts(a, b)``).
      rails: per-rail cumulative joules (empty when the backend is
        single-rail).
    """

    timestamp_s: float
    joules: float
    watts: Optional[float] = None
    rails: Dict[str, float] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.joules < 0:
            raise ValueError(f"cumulative joules must be >= 0, got {self.joules}")


def seconds(start: State, end: State) -> float:
    """Elapsed wall time between two readings, in seconds."""
    return end.timestamp_s - start.timestamp_s


def joules(start: State, end: State) -> float:
    """Energy consumed between two readings, in joules.

    Counter wraparound is a *backend* concern (backends unwrap before
    constructing the ``State``), so this is a plain difference.
    """
    return end.joules - start.joules


def watts(start: State, end: State) -> float:
    """Average power between two readings, in watts.

    Returns 0.0 for a zero-length interval (rather than dividing by zero),
    matching the behaviour expected when two reads race each other.
    """
    dt = seconds(start, end)
    if dt <= 0.0:
        return 0.0
    return joules(start, end) / dt


def rail_joules(start: State, end: State, rail: str) -> float:
    """Energy consumed on a single named rail between two readings."""
    if rail not in start.rails or rail not in end.rails:
        raise KeyError(f"rail {rail!r} not present in both states")
    return end.rails[rail] - start.rails[rail]
