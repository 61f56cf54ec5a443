"""Deterministic fault injection for sensor backends.

The measurement plane's robustness claims (supervisor retry/failover,
sampler blackout gaps, governor fail-safe degradation) are only testable
if faults are *scriptable*: the Cray PMDB experience paper shows real
power counters drop samples, reset mid-run, and report garbage, but none
of that reproduces on demand in CI.  :class:`FaultInjectingSensor` wraps
any backend and replays a fault plan — a list of :class:`Fault` windows —
deterministically against either the read index or an injectable clock,
so a chaos test can stage an exact blackout/flap/recovery timeline
without sleeping.

Fault kinds (the fault matrix):

========  ============================================================
kind      effect on the wrapped read
========  ============================================================
error     raise :class:`~repro_torch.core.sensor.SensorError`
hang      sleep ``hang_s`` (injected sleep fn) then read normally —
          with a fake clock this models a slow read, not a real stall
nan       watts replaced with NaN (power-meter poisoning)
negative  watts negated (bogus counter math upstream)
spike     watts multiplied by ``factor`` (transient garbage value)
stuck     joules/watts frozen at their last pre-fault values
reset     joules counter restarts from ``reset_to`` (RAPL wraparound /
          node reboot: the raw counter goes *backwards*)
flap      ``error``, but only on reads where
          ``(i // period) % duty_cycle == 0`` — intermittent failure
========  ============================================================

Windows select by read index (``start``/``count``) or by time
(``t0_s``/``t1_s`` relative to :meth:`FaultInjectingSensor.arm`, or to
the first read if never armed).  Index windows make unit tests
bit-exact; time windows let a live bench stage "blackout from t=1.0s to
t=2.5s" regardless of sampling rate.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence

from repro_torch.core.sensor import Sample, Sensor, SensorError

FAULT_KINDS = ("error", "hang", "nan", "negative", "spike", "stuck",
               "reset", "flap")


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scripted fault window (see module docstring for kinds).

    Exactly one selector must be active: an index window (``start`` +
    ``count``, count=None meaning "forever") or a time window (``t0_s`` +
    ``t1_s`` seconds relative to arm time).
    """

    kind: str
    start: Optional[int] = None       # first read index affected
    count: Optional[int] = None       # reads affected (None = until stopped)
    t0_s: Optional[float] = None      # time window start (relative to arm)
    t1_s: Optional[float] = None      # time window end (None = forever)
    hang_s: float = 0.0               # kind="hang": injected read latency
    factor: float = 10.0              # kind="spike": watts multiplier
    reset_to: float = 0.0             # kind="reset": counter restart value
    period: int = 2                   # kind="flap": cycle length in reads
    duty: int = 1                     # kind="flap": failing reads per cycle

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")
        by_index = self.start is not None
        by_time = self.t0_s is not None
        if by_index == by_time:
            raise ValueError("fault needs exactly one selector: "
                             "start/count (index) or t0_s/t1_s (time)")
        if self.kind == "flap" and not (0 < self.duty <= self.period):
            raise ValueError(f"flap needs 0 < duty <= period, got "
                             f"duty={self.duty} period={self.period}")

    def _active(self, index: int, rel_t: Optional[float]) -> bool:
        if self.start is not None:
            if index < self.start:
                return False
            return self.count is None or index < self.start + self.count
        if rel_t is None:
            return False
        if rel_t < self.t0_s:
            return False
        return self.t1_s is None or rel_t < self.t1_s

    def _fires(self, index: int, rel_t: Optional[float]) -> bool:
        if not self._active(index, rel_t):
            return False
        if self.kind != "flap":
            return True
        return (index % self.period) < self.duty


class FaultInjectingSensor(Sensor):
    """Wrap ``inner`` and replay ``plan`` faults over its samples.

    The wrapper is itself a :class:`Sensor`: it overrides ``_sample()``
    so faults flow through the exact read path the sampler/supervisor
    exercise in production (base-class locking, watts integration, raw
    tuples).  ``clock``/``sleep_fn`` are injectable so a hang fault in a
    test advances a fake clock instead of stalling the suite.
    """

    def __init__(self, inner: Sensor, plan: Sequence[Fault] = (),
                 clock: Optional[Callable[[], float]] = None,
                 sleep_fn: Optional[Callable[[float], None]] = None):
        super().__init__(clock=clock or inner._clock)
        self.name = inner.name
        self.kind = inner.kind
        self.native_period_s = inner.native_period_s
        self._inner = inner
        self._plan: List[Fault] = list(plan)
        self._sleep = sleep_fn or time.sleep
        self._index = 0               # reads attempted so far
        self._t_armed: Optional[float] = None
        self._stuck_sample: Optional[Sample] = None
        self._reset_base: Optional[float] = None   # inner joules at reset
        self._injected = {k: 0 for k in FAULT_KINDS}

    # -- plan control ------------------------------------------------------
    def arm(self, t: Optional[float] = None) -> None:
        """(Re)base time-window faults at ``t`` (default: clock now).

        Call after warmup/build so "blackout at t0_s=1.0" means one
        second into the *measured* run, not one second into the kernel
        build.
        """
        self._t_armed = self._clock() if t is None else t

    def extend(self, *faults: Fault) -> None:
        self._plan.extend(faults)

    @property
    def injected(self) -> dict:
        """Per-kind count of faults actually injected (not just planned)."""
        return dict(self._injected)

    # -- the faulted read path --------------------------------------------
    def _sample(self) -> Sample:
        idx = self._index
        self._index = idx + 1
        now = self._clock()
        if self._t_armed is None:
            self._t_armed = now
        rel_t = now - self._t_armed
        fired = [f for f in self._plan if f._fires(idx, rel_t)]
        for f in fired:
            if f.kind == "hang":
                self._injected["hang"] += 1
                self._sleep(f.hang_s)
        if any(f.kind in ("error", "flap") for f in fired):
            for f in fired:
                if f.kind in ("error", "flap"):
                    self._injected[f.kind] += 1
            raise SensorError(
                f"injected fault on {self.name!r} read #{idx}")
        if any(f.kind == "stuck" for f in fired) \
                and self._stuck_sample is not None:
            self._injected["stuck"] += 1
            return self._stuck_sample

        s = self._inner._sample()
        joules, watts = s.joules, s.watts
        for f in fired:
            if f.kind == "nan" and watts is not None:
                self._injected["nan"] += 1
                watts = float("nan")
            elif f.kind == "negative" and watts is not None:
                self._injected["negative"] += 1
                watts = -abs(watts)
            elif f.kind == "spike" and watts is not None:
                self._injected["spike"] += 1
                watts = watts * f.factor
            elif f.kind == "reset" and joules is not None:
                self._injected["reset"] += 1
                if self._reset_base is None:
                    self._reset_base = joules
                joules = f.reset_to + (joules - self._reset_base)
        if not any(f.kind == "reset" for f in fired):
            self._reset_base = None
        out = Sample(joules=joules, watts=watts, rails=s.rails)
        if not fired:
            self._stuck_sample = out
        return out

    def __repr__(self):
        return (f"<FaultInjectingSensor inner={self._inner!r} "
                f"plan={len(self._plan)} faults>")
