"""Deterministic dummy backend.

Used by tests, examples, and as the stand-in "physical meter" slot (the
paper's PowerSensor2 interface point).  Produces power from a programmable
waveform ``watts_fn(t_rel)``; with the default constant waveform and an
injected virtual clock the whole PMT stack becomes exactly reproducible.
"""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch.core.registry import register_backend
from repro_torch.core.sensor import Sample, Sensor


class DummySensor(Sensor):
    name = "dummy"
    kind = "modeled"
    native_period_s = 0.001

    def __init__(self, watts: float = 42.0,
                 watts_fn: Optional[Callable[[float], float]] = None,
                 clock: Optional[Callable[[], float]] = None):
        super().__init__(clock=clock)
        self._watts_const = float(watts)
        self._watts_fn = watts_fn
        self._t0: Optional[float] = None

    def _sample(self) -> Sample:
        t = self._clock()
        if self._t0 is None:
            self._t0 = t
        if self._watts_fn is not None:
            w = float(self._watts_fn(t - self._t0))
        else:
            w = self._watts_const
        return Sample(watts=w)


register_backend("dummy", DummySensor)
