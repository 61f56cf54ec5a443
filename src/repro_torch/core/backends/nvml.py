"""NVML reader over ctypes: the card's name, power, power limit, energy.

The sampling half of the JAX package's ``core/backends/nvml.py``,
written over ``libnvidia-ml.so.1`` (which ships with the NVIDIA driver)
instead of ``pynvml``.  It reads ``nvmlDeviceGetName``,
``nvmlDeviceGetPowerUsage``, ``nvmlDeviceGetEnforcedPowerLimit`` and
``nvmlDeviceGetTotalEnergyConsumption``.

``EnergyMeter`` measures the joules a stretch of work draws: the
difference of the card's total-energy counter, or, where the card
reports that counter unsupported, the trapezoidal integral of power
sampled every 10 ms on a background thread (NVML's sustainable rate) —
and it says which one it used.

``NvmlSensor`` is the PMT ``Sensor`` over the same reader, registered as
the ``"nvml"`` backend: it reports the card's total-energy counter as
the cumulative joules where the card supports it, and instantaneous
power (integrated by the ``Sensor`` base class) where it does not.
"""
from __future__ import annotations

import ctypes
import threading
import time
from typing import Callable, Optional

from repro_torch.core.registry import register_backend
from repro_torch.core.sensor import Sample, Sensor, SensorError

NVML_SUCCESS = 0
NVML_ERROR_NOT_SUPPORTED = 3


class NvmlError(RuntimeError):
    """An NVML call failed, or the library is not there."""


class NvmlReader:
    """One card through NVML.  Raises ``NvmlError`` when the library or
    the card is missing.  ``close()`` shuts NVML down."""

    def __init__(self, index: int = 0, library: str = "libnvidia-ml.so.1"):
        try:
            self._lib = ctypes.CDLL(library)
        except OSError as exc:
            raise NvmlError(f"cannot load {library}: {exc}") from exc
        lib = self._lib
        lib.nvmlInit_v2.restype = ctypes.c_int
        lib.nvmlShutdown.restype = ctypes.c_int
        lib.nvmlDeviceGetHandleByIndex_v2.argtypes = [
            ctypes.c_uint, ctypes.POINTER(ctypes.c_void_p)]
        lib.nvmlDeviceGetName.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                          ctypes.c_uint]
        for fn in ("nvmlDeviceGetPowerUsage",
                   "nvmlDeviceGetEnforcedPowerLimit"):
            getattr(lib, fn).argtypes = [ctypes.c_void_p,
                                         ctypes.POINTER(ctypes.c_uint)]
        lib.nvmlDeviceGetTotalEnergyConsumption.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong)]
        self._check(lib.nvmlInit_v2(), "nvmlInit_v2")
        self._handle = ctypes.c_void_p()
        self._check(lib.nvmlDeviceGetHandleByIndex_v2(
            index, ctypes.byref(self._handle)), "nvmlDeviceGetHandleByIndex")

    @staticmethod
    def _check(rc: int, what: str) -> None:
        if rc != NVML_SUCCESS:
            raise NvmlError(f"{what} returned NVML error {rc}")

    def name(self) -> str:
        buf = ctypes.create_string_buffer(96)
        self._check(self._lib.nvmlDeviceGetName(self._handle, buf, 96),
                    "nvmlDeviceGetName")
        return buf.value.decode()

    def _uint(self, fn: str) -> int:
        out = ctypes.c_uint()
        self._check(getattr(self._lib, fn)(self._handle, ctypes.byref(out)),
                    fn)
        return out.value

    def power_watts(self) -> float:
        return self._uint("nvmlDeviceGetPowerUsage") * 1e-3     # mW

    def power_limit_watts(self) -> float:
        return self._uint("nvmlDeviceGetEnforcedPowerLimit") * 1e-3

    def energy_joules(self) -> Optional[float]:
        """The card's total-energy counter, or None where unsupported."""
        out = ctypes.c_ulonglong()
        rc = self._lib.nvmlDeviceGetTotalEnergyConsumption(
            self._handle, ctypes.byref(out))
        if rc == NVML_ERROR_NOT_SUPPORTED:
            return None
        self._check(rc, "nvmlDeviceGetTotalEnergyConsumption")
        return out.value * 1e-3                                 # mJ

    def close(self) -> None:
        self._lib.nvmlShutdown()


class PowerIntegrator:
    """Trapezoidal integral of ``read_watts()`` sampled every
    ``period_s`` on a daemon thread, between ``start()`` and ``stop()``."""

    def __init__(self, read_watts: Callable[[], float],
                 period_s: float = 0.010,
                 clock: Callable[[], float] = time.monotonic):
        self._read = read_watts
        self._period = period_s
        self._clock = clock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.joules = 0.0
        self.samples = 0
        self._last = None          # (t, watts)

    def _tick(self) -> None:
        t, w = self._clock(), self._read()
        if self._last is not None:
            t0, w0 = self._last
            self.joules += 0.5 * (w0 + w) * (t - t0)
        self._last = (t, w)
        self.samples += 1

    def _run(self) -> None:
        while not self._stop.wait(self._period):
            self._tick()

    def start(self) -> None:
        self._tick()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="nvml-power-integrator")
        self._thread.start()

    def stop(self) -> float:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self._tick()
        return self.joules


class EnergyMeter:
    """Joules drawn by the card between ``start()`` and ``stop()``.

    ``method`` is "energy-counter" when the card's total-energy counter
    was read before and after, or "power-integral-10ms" when the counter
    is unsupported and sampled power was integrated instead.
    """

    def __init__(self, reader: NvmlReader):
        self._reader = reader
        self._e0: Optional[float] = None
        self._integrator: Optional[PowerIntegrator] = None
        self.method: Optional[str] = None

    def start(self) -> None:
        self._e0 = self._reader.energy_joules()
        if self._e0 is None:
            self.method = "power-integral-10ms"
            self._integrator = PowerIntegrator(self._reader.power_watts)
            self._integrator.start()
        else:
            self.method = "energy-counter"

    def stop(self) -> float:
        if self._integrator is not None:
            return self._integrator.stop()
        return self._reader.energy_joules() - self._e0


class NvmlSensor(Sensor):
    """The card as a PMT sensor, read through ``NvmlReader``.

    The total-energy counter is preferred on purpose: in recent NVML
    releases the power reading on Hopper may be an average over about a
    second rather than an instantaneous value, and integrating it over
    a short region would lag the work.  Where the counter is
    unsupported, ``_sample`` returns power only and the ``Sensor`` base
    class integrates it between samples.  ``reader`` lets a test pass
    a stand-in for the NVML library.
    """

    name = "nvml"
    kind = "measured"
    native_period_s = 0.010  # paper: "NVML is able to sustain up to 10 ms"

    def __init__(self, device_index: int = 0,
                 clock: Optional[Callable[[], float]] = None,
                 reader=None):
        super().__init__(clock=clock)
        if reader is None:
            try:
                reader = NvmlReader(device_index)
            except NvmlError as exc:
                raise SensorError(f"NVML backend unavailable: {exc}") \
                    from exc
        self.reader = reader
        # Which quantity the joules come from, fixed at construction.
        self.method = ("energy-counter" if reader.energy_joules() is not None
                       else "power-integral")

    @classmethod
    def is_available(cls) -> bool:
        """True when the NVML library loads and card 0 is present."""
        try:
            NvmlReader(0).close()
        except NvmlError:
            return False
        return True

    def _sample(self) -> Sample:
        power = self.reader.power_watts()
        energy = self.reader.energy_joules()
        if energy is None:
            return Sample(watts=power)
        return Sample(joules=energy, watts=power)


register_backend("nvml", NvmlSensor)
