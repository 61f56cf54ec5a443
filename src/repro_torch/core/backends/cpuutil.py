"""CPU-utilization backend (``cpuutil``) — measured activity x TDP model.

On hosts without powercap/RAPL access (unprivileged containers, most
cloud VMs — including this one), the only live CPU activity signal is
``/proc/stat``.  This backend converts utilization into power with a
standard affine model:

    P = idle_w + (tdp_w - idle_w) * utilization

which is the same class of model RAPL itself applies to non-core domains.
``kind = "hybrid"``: the activity is *measured*, the coefficients are
*modeled* — reports always carry that label (DESIGN.md §2).

The procfs root is injectable for unit tests.
"""
from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

from repro_torch.core.registry import register_backend
from repro_torch.core.sensor import Sample, Sensor, SensorError


def _read_proc_stat(path: str) -> Tuple[float, float]:
    """Return (busy_jiffies, total_jiffies) from the aggregate cpu line."""
    with open(path, "r") as f:
        first = f.readline().split()
    if not first or first[0] != "cpu":
        raise SensorError(f"malformed {path}: {first[:3]}")
    vals = [float(v) for v in first[1:]]
    # user nice system idle iowait irq softirq steal [guest guest_nice]
    idle = vals[3] + (vals[4] if len(vals) > 4 else 0.0)  # idle + iowait
    total = sum(vals[:8]) if len(vals) >= 8 else sum(vals)
    return total - idle, total


class CpuUtilSensor(Sensor):
    name = "cpuutil"
    kind = "hybrid"
    native_period_s = 0.050  # jiffy granularity ~10ms; 50ms is robust

    def __init__(self, tdp_w: float = 95.0, idle_w: float = 10.0,
                 procfs: str = "/proc",
                 clock: Optional[Callable[[], float]] = None):
        super().__init__(clock=clock)
        if tdp_w <= idle_w:
            raise ValueError("tdp_w must exceed idle_w")
        self._tdp_w = float(tdp_w)
        self._idle_w = float(idle_w)
        self._stat_path = os.path.join(procfs, "stat")
        # Prime the delta so the first read() has a baseline.
        self._last = _read_proc_stat(self._stat_path)

    @classmethod
    def is_available(cls) -> bool:
        try:
            _read_proc_stat("/proc/stat")
            return True
        except (OSError, SensorError):
            return False

    def utilization(self) -> float:
        """Fraction of CPU time spent busy since the previous call."""
        busy, total = _read_proc_stat(self._stat_path)
        last_busy, last_total = self._last
        self._last = (busy, total)
        dt = total - last_total
        if dt <= 0:
            return 0.0
        return min(1.0, max(0.0, (busy - last_busy) / dt))

    def _sample(self) -> Sample:
        util = self.utilization()
        watts = self._idle_w + (self._tdp_w - self._idle_w) * util
        return Sample(watts=watts)


register_backend("cpuutil", CpuUtilSensor)
