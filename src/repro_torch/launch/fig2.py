"""Paper Fig. 2 on the card: the paper's kernel set under stacked PMT
sensors, with measured card watts from NVML.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.fig2 [--device cpu] \
      [--smoke] [--seed 0]

The counterpart of the JAX package's ``benchmarks/bench_fig2_kernels.py``,
in its row order: SLEEP, FMA32, STREAM, GRIDDER, DEGRIDDER, GEMM,
JACOBI2D.  Each row is one region of ``Session(["cpuutil", "nvml"])``,
stacking the host (cpuutil: measured utilization times a TDP model) and
the card (nvml: its total-energy counter) as the paper stacks its
sensors.  With ``--device cpu`` the kernels' plain versions run and the
session is ``["cpuutil"]`` alone: there are no card numbers then.

A kernel row warms up and times a few calls, then, inside its region,
launches back to back in batches sized from the time per call until at
least ``min_seconds`` of wall clock have passed (one batch, as a rule),
and synchronizes before the region closes.  SLEEP holds the region open for
``min_seconds`` with the card idle.  On the H100 the card's energy
counter steps every ~100 ms, so each end of a region is uncertain by up
to one step: 5 s rows keep that under ~2% of a row's joules.  Inputs
are made from ``--seed`` with numpy.  The full sizes exceed the H100's 50 MB L2 (``--smoke``
shrinks them for a quick run on the CPU).

Per row it prints seconds per call, host watts, card watts, card joules
per call, the achieved TFLOP/s (FMA32, GRIDDER, DEGRIDDER, GEMM) or TB/s
(STREAM, JACOBI2D) with its share of the card's data-sheet bound,
GFLOP/s/W from ``metrics.EfficiencyReport`` on the card's joules, and
the modeled card watts (``EnergyModel(H100_SXM).step_watts`` at the
measured time per call), the counterpart of the JAX bench's modeled
column, beside the measured ones.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time
from typing import Callable, List, Optional

import numpy as np
import torch

import repro_torch.core as pmt
from repro_torch.device import resolve_device
from repro_torch.kernels.fma32.ops import fma32
from repro_torch.kernels.gemm.ops import gemm
from repro_torch.kernels.gridder.ops import degridder, gridder
from repro_torch.kernels.jacobi2d.ops import jacobi2d
from repro_torch.kernels.stream.ops import stream_triad

# H100 SXM data sheet: HBM rate, and fp32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# FP32 FLOP per (subgrid, pixel, visibility) term of the gridder loops
# as compiled for sm_90a: 12 of the dot, the 2 pi scale and the complex
# multiply-add, 24 of one accurate sincosf (11 FFMA, 2 FMUL).  chip_smoke.py
# counts them from cuobjdump -sass of the built library.
GRIDDER_OPS_PER_TERM = 36
ROW_NAMES = ("SLEEP", "FMA32", "STREAM", "GRIDDER", "DEGRIDDER", "GEMM",
             "JACOBI2D")
# (FMA32 shape, iters), STREAM shape, gridder (P, S, V), GEMM (M, K, N),
# JACOBI2D shape.
FULL = dict(fma32=((8192, 8192), 1024), stream=(16384, 16384),
            gridder=(1024, 1024, 2048), gemm=(8192, 8192, 8192),
            jacobi2d=(16384, 16384), min_seconds=5.0)
SMOKE = dict(fma32=((64, 128), 64), stream=(256, 128), gridder=(256, 4, 512),
             gemm=(64, 96, 128), jacobi2d=(96, 80), min_seconds=0.05)


@dataclasses.dataclass
class Row:
    """One measured row.  ``card_*`` are None without a card;
    ``meter_joules`` is the caller's independent reading of the window."""

    name: str
    calls: int
    seconds: float
    host_watts: float
    card_watts: Optional[float] = None
    card_joules: Optional[float] = None
    flops: float = 0.0               # per call
    nbytes: float = 0.0              # per call
    meter_joules: Optional[float] = None
    card_method: Optional[str] = None    # NvmlSensor.method
    ops: Optional[float] = None      # FP32 operations per call, if not flops

    @property
    def bound_s(self) -> float:
        """Least time the card could take for one call."""
        return max(self._ops / FP32_FLOPS, self.nbytes / HBM_BYTES_PER_S)

    @property
    def bound_by(self) -> str:
        return ("operations" if self._ops / FP32_FLOPS
                >= self.nbytes / HBM_BYTES_PER_S else "bytes")

    @property
    def _ops(self) -> float:
        return self.flops if self.ops is None else self.ops

    @property
    def model_watts(self) -> float:
        """The card's watts by ``EnergyModel(H100_SXM)`` for this row's
        work at its measured time per call."""
        return pmt.EnergyModel().step_watts(self.flops, self.nbytes, 0.0,
                                            self.seconds / self.calls)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def _workloads(device: torch.device, sizes: dict, seed: int):
    """(name, make) pairs in row order; ``make()`` builds a row's inputs
    and returns (call, flops per call, bytes per call, FP32 operations
    per call or None where they are the flops).  Inputs are made one row
    at a time, so at most one row's arrays live on the card."""
    rng = np.random.default_rng(seed)

    def tensor(shape):
        return torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to(device)

    def uniform(shape, bound):
        return torch.from_numpy(rng.uniform(
            -bound, bound, shape).astype(np.float32)).to(device)

    def make_fma32():
        shape, iters = sizes["fma32"]
        x = tensor(shape)
        return (lambda: fma32(x, iters=iters), 2.0 * x.numel() * iters,
                8.0 * x.numel(), None)

    def make_stream():
        a, b = tensor(sizes["stream"]), tensor(sizes["stream"])
        return (lambda: stream_triad(a, b, scalar=2.0), 2.0 * a.numel(),
                12.0 * a.numel(), None)

    def make_gridder(adjoint):
        # the JAX bench's ranges: lm in [-0.5, 0.5], uv in [-2, 2]
        p, s, v = sizes["gridder"]
        lm, uv = uniform((p, 2), 0.5), uniform((s, v, 2), 2.0)
        if adjoint:
            sub = tensor((s, p, 2))
            call = lambda: degridder(lm, uv, sub)       # noqa: E731
        else:
            vis = tensor((s, v, 2))
            call = lambda: gridder(lm, uv, vis)         # noqa: E731
        # The JAX bench's 8 FLOP per term, so GFLOP/s/W compares with the
        # paper's; each array's bytes counted once (the JAX bench's
        # ``4.0 * (S*V*4 + S*P*2) * 4`` counts the 4-byte width twice).
        return (call, 8.0 * s * v * p, 4.0 * (2 * p + 4 * s * v + 2 * s * p),
                float(GRIDDER_OPS_PER_TERM) * s * v * p)

    def make_gemm():
        m, k, n = sizes["gemm"]
        a, b = tensor((m, k)), tensor((k, n))
        return (lambda: gemm(a, b), 2.0 * m * k * n,
                4.0 * (m * k + k * n + m * n), None)

    def make_jacobi2d():
        x = tensor(sizes["jacobi2d"])
        h, w = x.shape
        return (lambda: jacobi2d(x), 5.0 * max(h - 2, 0) * max(w - 2, 0),
                8.0 * x.numel(), None)

    return [("FMA32", make_fma32), ("STREAM", make_stream),
            ("GRIDDER", lambda: make_gridder(False)),
            ("DEGRIDDER", lambda: make_gridder(True)),
            ("GEMM", make_gemm), ("JACOBI2D", make_jacobi2d)]


def _measure(session, name: str, device: torch.device,
             body: Callable[[], int], meter, flops: float,
             nbytes: float, ops: Optional[float] = None) -> Row:
    """Run ``body`` (which returns its count of calls) inside one region,
    fenced, and make its row; ``meter`` (start/stop), if given, reads the
    same window."""
    with session.region(name) as region:
        if meter is not None:
            meter.start()
        calls = body()
        _sync(device)
        meter_j = meter.stop() if meter is not None else None
    ms = region.measurements
    host = ms.by_sensor("cpuutil")
    row = Row(name=name, calls=calls, seconds=host.seconds,
              host_watts=host.watts, flops=flops, nbytes=nbytes,
              meter_joules=meter_j, ops=ops)
    if any(m.sensor == "nvml" for m in ms):
        card = ms.by_sensor("nvml")
        row.card_watts, row.card_joules = card.watts, card.joules
        row.card_method = next(s.method for s in session.sensors
                               if s.name == "nvml")
    return row


def run(device=None, smoke: bool = False, seed: int = 0,
        meter=None) -> List[Row]:
    """Measure every row, in the JAX bench's order.  ``meter``, an
    object with ``start()`` and ``stop() -> joules``, is read inside each
    region around the same work, for a caller that checks the session's
    card joules against it."""
    device = resolve_device(device)
    sizes = SMOKE if smoke else FULL
    backends = ["cpuutil", "nvml"] if device.type == "cuda" else ["cpuutil"]
    rows = []
    with pmt.Session(backends) as session:
        _sync(device)
        min_s = sizes["min_seconds"]

        def sleep():
            time.sleep(min_s)
            return 1

        rows.append(_measure(session, "SLEEP", device, sleep, meter, 0.0,
                             0.0))
        for name, make in _workloads(device, sizes, seed):
            call, flops, nbytes, ops = make()
            call()                                  # warm up (and build)
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(3):
                call()
            _sync(device)
            per_call = (time.perf_counter() - t0) / 3

            def body(call=call, per_call=per_call):
                # Launch batches sized from the time per call so far,
                # back to back, until min_s of wall clock have passed.
                calls, t0 = 0, time.perf_counter()
                while (left := min_s - (time.perf_counter() - t0)) > 0:
                    batch = max(1, math.ceil(left / per_call))
                    for _ in range(batch):
                        call()
                    _sync(device)
                    calls += batch
                    per_call = (time.perf_counter() - t0) / calls
                return calls

            rows.append(_measure(session, name, device, body, meter, flops,
                                 nbytes, ops))
            del call, body                  # free this row's inputs
    return rows


def format_rows(rows: List[Row]) -> List[str]:
    """The table, in ``ROW_NAMES`` order."""
    by_name = {r.name: r for r in rows}
    out = [f"{'kernel':10s} {'s/call':>10s} {'host W':>8s} {'card W':>8s} "
           f"{'card J/call':>12s} {'achieved':>16s} {'of bound':>9s} "
           f"{'GFLOP/s/W':>10s} {'model W':>8s}"]
    for name in ROW_NAMES:
        r = by_name[name]
        per_call = r.seconds / r.calls
        card_w = "n/a" if r.card_watts is None else f"{r.card_watts:.1f}"
        card_j = "n/a" if r.card_joules is None \
            else f"{r.card_joules / r.calls:.4f}"
        # modeled card watts only beside measured ones: a CPU run's time
        # per call says nothing of the card's
        model_w = "n/a" if r.card_watts is None else f"{r.model_watts:.1f}"
        rate = share = eff = "-"
        if name != "SLEEP" and r.card_watts is not None:
            # rates against the card's bound, so only from a card run
            rate = (f"{r.flops / per_call / 1e12:.2f} TFLOP/s"
                    if r.bound_by == "operations"
                    else f"{r.nbytes / per_call / 1e12:.3f} TB/s")
            share = f"{100 * r.bound_s / per_call:.1f}%"
            report = pmt.EfficiencyReport(joules=r.card_joules,
                                          seconds=r.seconds,
                                          flops=r.flops * r.calls)
            eff = f"{report.gflops_per_watt:.2f}"
        out.append(f"{name:10s} {per_call:10.6f} {r.host_watts:8.1f} "
                   f"{card_w:>8s} {card_j:>12s} {rate:>16s} {share:>9s} "
                   f"{eff:>10s} {model_w:>8s}")
    return out


def main(argv=None) -> List[Row]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="small shapes and 0.05 s rows, for a quick run")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    where = torch.cuda.get_device_name(0) if device.type == "cuda" \
        else "cpu (plain versions; no card numbers)"
    rows = run(device, smoke=args.smoke, seed=args.seed)
    card = f" and nvml (card, measured: {rows[0].card_method})" \
        if device.type == "cuda" else ""
    print(f"# Fig. 2 on {where}: PMT regions stacking cpuutil (host, "
          f"hybrid){card}; model W: EnergyModel(H100_SXM), modeled")
    for line in format_rows(rows):
        print(line)
    return rows


if __name__ == "__main__":
    main()
