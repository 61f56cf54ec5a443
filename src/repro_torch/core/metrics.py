"""Energy-efficiency metrics (paper §III).

"Users can extract measurements with PMT and derive energy efficiency
metrics such as energy-delay product (EDP) ... and the FLOPs efficiency,
which can be expressed in GFLOP/s/W. Note that the last metric requires
the number of FLOPs computed."

In the port the FLOP count comes from the kernel's shapes (the caller
counts them, as ``launch/fig2.py`` does), replacing the paper's
PAPI/LIKWID counters.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


def edp(joules: float, seconds: float) -> float:
    """Energy-delay product, J*s. Lower is better."""
    return joules * seconds


def ed2p(joules: float, seconds: float) -> float:
    """Energy-delay-squared product, J*s^2 (latency-weighted variant)."""
    return joules * seconds * seconds


def gflops_per_watt(flops: float, joules: float) -> float:
    """FLOPs efficiency in GFLOP/s/W.

    GFLOP/s/W == (flops/seconds)/watts / 1e9 == flops/joules / 1e9 —
    the seconds cancel, so only energy and work are needed.
    """
    if joules <= 0:
        return 0.0
    return flops / joules / 1e9


def joules_per_token(joules: float, tokens: int) -> float:
    if tokens <= 0:
        return 0.0
    return joules / tokens


def tokens_per_joule(joules: float, tokens: int) -> float:
    if joules <= 0:
        return 0.0
    return tokens / joules


@dataclasses.dataclass(frozen=True)
class EfficiencyReport:
    """Bundle of the paper's §III metrics for one region/step."""

    joules: float
    seconds: float
    flops: Optional[float] = None
    tokens: Optional[int] = None

    @property
    def watts(self) -> float:
        return self.joules / self.seconds if self.seconds > 0 else 0.0

    @property
    def edp(self) -> float:
        return edp(self.joules, self.seconds)

    @property
    def ed2p(self) -> float:
        return ed2p(self.joules, self.seconds)

    @property
    def gflops_per_watt(self) -> Optional[float]:
        if self.flops is None:
            return None
        return gflops_per_watt(self.flops, self.joules)

    @property
    def joules_per_token(self) -> Optional[float]:
        if self.tokens is None:
            return None
        return joules_per_token(self.joules, self.tokens)

    def as_csv_row(self) -> str:
        g = self.gflops_per_watt
        jt = self.joules_per_token
        return (f"{self.joules:.6f},{self.seconds:.6f},{self.watts:.3f},"
                f"{self.edp:.6f},"
                f"{'' if g is None else f'{g:.3f}'},"
                f"{'' if jt is None else f'{jt:.9f}'}")

    CSV_HEADER = "joules,seconds,watts,edp,gflops_per_watt,joules_per_token"
