"""RAPL backend — Linux powercap sysfs energy counters.

Reads ``<powercap_root>/intel-rapl:<i>/energy_uj`` cumulative micro-joule
counters (one per package-level domain), handling counter wraparound via
``max_energy_range_uj`` exactly as the C++ PMT RAPL backend does.

Per-rail readings (package, dram, psys, sub-domains like core/uncore) are
exposed in ``State.rails``; the sensor total sums only *top-level* domains
to avoid double counting parent+child zones.

The powercap root is injectable so the parser is unit-testable on hosts
(like this container) that expose no powercap tree.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.registry import register_backend
from repro_torch.core.sensor import Sample, Sensor, SensorError

DEFAULT_ROOT = "/sys/class/powercap"


def _read_file(path: str) -> str:
    with open(path, "r") as f:
        return f.read().strip()


class RaplSensor(Sensor):
    name = "rapl"
    kind = "measured"
    # Paper: "RAPL up to 500 ms" sustained sampling period.
    native_period_s = 0.500

    def __init__(self, root: str = DEFAULT_ROOT,
                 clock: Optional[Callable[[], float]] = None):
        super().__init__(clock=clock)
        self._root = root
        self._domains = self._discover(root)
        if not self._domains:
            raise SensorError(f"no RAPL domains under {root!r}")
        # Per-domain unwrap state: (last_raw_uj, accumulated_wraps_uj).
        self._unwrap: Dict[str, Tuple[float, float]] = {}

    # -- discovery -------------------------------------------------------
    @staticmethod
    def _discover(root: str) -> List[dict]:
        """Find RAPL zones. Top-level zones look like ``intel-rapl:0``;
        sub-zones like ``intel-rapl:0:1`` (child of package 0)."""
        domains = []
        if not os.path.isdir(root):
            return domains
        for entry in sorted(os.listdir(root)):
            if not entry.startswith("intel-rapl:"):
                continue
            zone = os.path.join(root, entry)
            energy = os.path.join(zone, "energy_uj")
            if not os.path.isfile(energy):
                continue
            try:
                label = _read_file(os.path.join(zone, "name"))
            except OSError:
                label = entry
            try:
                max_range = float(_read_file(
                    os.path.join(zone, "max_energy_range_uj")))
            except OSError:
                max_range = 2.0 ** 32  # conservative default
            # ``intel-rapl:0`` has one ':', subzones have two.
            top_level = entry.count(":") == 1
            domains.append(dict(entry=entry, path=energy, label=label,
                                max_range_uj=max_range, top=top_level))
        return domains

    @classmethod
    def is_available(cls) -> bool:
        return bool(cls._discover(DEFAULT_ROOT))

    # -- sampling ----------------------------------------------------------
    def _read_domain_uj(self, dom: dict) -> float:
        """Read one domain's cumulative counter, unwrapped, in uJ."""
        raw = float(_read_file(dom["path"]))
        key = dom["entry"]
        last_raw, wraps = self._unwrap.get(key, (raw, 0.0))
        if raw < last_raw:  # counter wrapped since last read
            wraps += dom["max_range_uj"]
        self._unwrap[key] = (raw, wraps)
        return raw + wraps

    def _sample(self) -> Sample:
        rails: Dict[str, float] = {}
        total_uj = 0.0
        for dom in self._domains:
            uj = self._read_domain_uj(dom)
            rail_name = f"{dom['entry']}:{dom['label']}"
            rails[rail_name] = uj * 1e-6
            if dom["top"]:
                total_uj += uj
        return Sample(joules=total_uj * 1e-6, rails=rails)


register_backend("rapl", RaplSensor)
