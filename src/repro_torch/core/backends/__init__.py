"""PMT backends of the port.

Each module provides one :class:`repro_torch.core.sensor.Sensor` subclass
and registers it with the backend registry at import time (see
``repro_torch.core.registry``).  The set mirrors the paper's Fig. 1 back
ends, on the H100 card:

  rapl     — Linux powercap sysfs energy counters (host CPUs).   measured
  sysfs    — generic hwmon power/energy files.                   measured
  cpuutil  — /proc/stat utilization x calibrated TDP model.      hybrid
  nvml     — the NVIDIA card through libnvidia-ml over ctypes.   measured
  h100     — analytical cost-model sensor of the card.           modeled
  dummy    — deterministic waveform, for tests and examples.     modeled
"""
from repro_torch.core.backends import (cpuutil, dummy, h100, nvml,  # noqa: F401
                                       rapl, sysfs)
