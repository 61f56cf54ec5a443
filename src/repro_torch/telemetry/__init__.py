"""Live telemetry plane: the measurement -> observation half of the
energy control loop.  A copy of the JAX package's ``telemetry`` over
this package's ``core``: the same recorder, endpoints and JSON.

The serve engine *measures* (per-request, per-phase J/token through
``pmt.Session`` spans); this package makes those measurements
observable while the engine is still running, with zero dependencies
beyond the stdlib:

  * :class:`PowerRecorder` — append-only, bounded in-memory store fed
    by the session's ``MemoryExporter`` (resolved ``RegionRecord``\\ s),
    a ``PowerMonitor`` subscription (``StepEnergy`` records), and a
    non-perturbing poll of each backend's ring sampler (watts
    timelines).  The smoothing window the ``PowerGovernor`` reads lives
    here too.
  * :class:`TelemetryServer` — a stdlib ``http.server`` HTTP endpoint
    over a recorder: ``/timeline`` (power series), ``/requests``
    (per-request prefill/decode joules), ``/stats`` (engine counters),
    and ``/stream`` (live SSE feed of new records).
"""
from repro_torch.telemetry.recorder import (HealthEvent, PowerRecorder,
                                            PreemptEvent, WattsSample)
from repro_torch.telemetry.server import TelemetryServer
from repro_torch.telemetry.sse import SSESubscriber, format_sse

__all__ = ["PowerRecorder", "WattsSample", "HealthEvent", "PreemptEvent",
           "TelemetryServer", "SSESubscriber", "format_sse"]
