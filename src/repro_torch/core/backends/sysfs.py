"""Generic sysfs backend.

The paper: "Some other architectures expose their power usage information
through files in sysfs (the /sys folder)."  This backend reads arbitrary
hwmon-style files:

  * ``power*_input``  — instantaneous power in micro-watts, or
  * ``energy*_input`` — cumulative energy in micro-joules.

By default it scans ``/sys/class/hwmon/hwmon*/`` for both kinds; a file
list can be passed explicitly (also used by the unit tests with a fixture
tree).  Power files are integrated by the Sensor base class; energy files
are summed directly.
"""
from __future__ import annotations

import glob
import os
from typing import Callable, List, Optional, Sequence

from repro_torch.core.registry import register_backend
from repro_torch.core.sensor import Sample, Sensor, SensorError

DEFAULT_HWMON_GLOBS = (
    "/sys/class/hwmon/hwmon*/power*_input",
    "/sys/class/hwmon/hwmon*/energy*_input",
    "/sys/class/hwmon/hwmon*/device/power*_input",
)


def _discover(globs: Sequence[str]) -> List[str]:
    files: List[str] = []
    for pattern in globs:
        files.extend(sorted(glob.glob(pattern)))
    return files


class SysfsSensor(Sensor):
    name = "sysfs"
    kind = "measured"
    native_period_s = 0.100

    def __init__(self, files: Optional[Sequence[str]] = None,
                 globs: Sequence[str] = DEFAULT_HWMON_GLOBS,
                 clock: Optional[Callable[[], float]] = None):
        super().__init__(clock=clock)
        self._files = list(files) if files is not None else _discover(globs)
        if not self._files:
            raise SensorError("no sysfs power/energy files found")
        for f in self._files:
            base = os.path.basename(f)
            if not (base.startswith("power") or base.startswith("energy")):
                raise SensorError(
                    f"unrecognised sysfs power file name {f!r} "
                    "(expected power*_input or energy*_input)")

    @classmethod
    def is_available(cls) -> bool:
        return bool(_discover(DEFAULT_HWMON_GLOBS))

    def _sample(self) -> Sample:
        watts_total = 0.0
        joules_total = 0.0
        have_power = False
        have_energy = False
        rails = {}
        for f in self._files:
            with open(f, "r") as fh:
                val = float(fh.read().strip())
            base = os.path.basename(f)
            if base.startswith("power"):  # micro-watts
                watts_total += val * 1e-6
                have_power = True
            else:  # energy*_input, micro-joules cumulative
                joules_total += val * 1e-6
                rails[f] = val * 1e-6
                have_energy = True
        if have_energy and not have_power:
            return Sample(joules=joules_total, rails=rails)
        if have_power and not have_energy:
            return Sample(watts=watts_total)
        # Mixed trees: prefer the energy counters (exact), report power too.
        return Sample(joules=joules_total, watts=watts_total, rails=rails)


register_backend("sysfs", SysfsSensor)
