"""Analytical energy model of an accelerator.

PMT's back ends measure where the hardware offers a power API (NVML on
the card); this module models energy where it does not, or beside a
measurement, from the work a step does:

    E_step = flops * pj_per_flop
           + hbm_bytes * pj_per_hbm_byte
           + ici_bytes * pj_per_ici_byte        (dynamic energy)
    E_wall = idle_w * seconds * chips           (static energy)
    E      = E_wall + E_step_total

The pJ coefficients are order-of-magnitude literature values for a
5nm-class accelerator, and are explicitly *modeled* quantities — every
consumer of this module carries the ``kind="modeled"`` label.  A site
with physical calibration (the paper's PowerSensor2 role) can construct a
custom :class:`EnergyModel`.  The shipped :class:`HardwareSpec` is the
H100 SXM card the port runs on (``H100_SXM``).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Per-chip performance envelope (roofline peaks) + power envelope."""

    name: str
    peak_flops: float          # FLOP/s (bf16 matmul)
    hbm_bw: float              # bytes/s
    ici_bw: float              # bytes/s per link
    hbm_bytes: float           # HBM capacity per chip
    idle_w: float              # static board power
    peak_w: float              # max sustained board power


# Peaks from NVIDIA's H100 SXM data sheet: 989 TFLOP/s bf16 dense on the
# tensor cores, 3.35 TB/s HBM3, 80 GB, NVLink 4 at 900 GB/s over 18
# links (50 GB/s per link).  peak_w is the card's 700 W power limit.
# idle_w is the card's own SLEEP row of the port's Fig. 2
# (repro_torch/launch/fig2.py): 121.9, 125.6 and 128.9 W in three runs on
# NVIDIA H100 80GB HBM3, 700.00 W; the middle one.
H100_SXM = HardwareSpec(
    name="h100-sxm",
    peak_flops=989e12,
    hbm_bw=3.35e12,
    ici_bw=50e9,
    hbm_bytes=80e9,
    idle_w=125.6,
    peak_w=700.0,
)


@dataclasses.dataclass(frozen=True)
class EnergyModel:
    """Energy coefficients on top of a :class:`HardwareSpec`."""

    hw: HardwareSpec = H100_SXM
    pj_per_flop: float = 0.55       # bf16 matrix-unit FLOP, incl. datapath
    pj_per_hbm_byte: float = 15.0   # HBM3-class access energy
    pj_per_ici_byte: float = 30.0   # serdes + switch energy

    def dynamic_joules(self, flops: float, hbm_bytes: float,
                       ici_bytes: float = 0.0) -> float:
        """Dynamic (activity-proportional) energy of one step, one chip."""
        return (flops * self.pj_per_flop
                + hbm_bytes * self.pj_per_hbm_byte
                + ici_bytes * self.pj_per_ici_byte) * 1e-12

    def static_joules(self, seconds: float, chips: int = 1) -> float:
        """Idle-floor energy over a wall-clock interval."""
        return self.hw.idle_w * seconds * chips

    def step_joules(self, flops: float, hbm_bytes: float, ici_bytes: float,
                    seconds: float, chips: int = 1) -> float:
        """Total modeled energy for a step spanning ``seconds`` wall time.

        The dynamic component is capped so implied average power never
        exceeds the board envelope — the model must not claim power the
        hardware cannot draw.
        """
        dyn = self.dynamic_joules(flops, hbm_bytes, ici_bytes)
        static = self.static_joules(seconds, chips)
        if seconds > 0:
            cap = (self.hw.peak_w - self.hw.idle_w) * seconds * chips
            dyn = min(dyn, cap)
        return static + dyn

    def step_watts(self, flops: float, hbm_bytes: float, ici_bytes: float,
                   seconds: float, chips: int = 1) -> float:
        if seconds <= 0:
            return self.hw.idle_w * chips
        return self.step_joules(flops, hbm_bytes, ici_bytes, seconds,
                                chips) / seconds
