"""PMT backends of the port.

Each module provides one :class:`repro_torch.core.sensor.Sensor` subclass
and registers it with the backend registry at import time (see
``repro_torch.core.registry``):

  cpuutil  — /proc/stat utilization x calibrated TDP model.      hybrid
  nvml     — the NVIDIA card through libnvidia-ml over ctypes.   measured
  dummy    — deterministic waveform, for tests and examples.     modeled

The JAX package's ``rapl``, ``sysfs`` and analytical ``tpu`` backends
are not in the port yet (``ROADMAP.md``).
"""
from repro_torch.core.backends import cpuutil, dummy, nvml  # noqa: F401
