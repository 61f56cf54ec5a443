"""PMT — Power Measurement Toolkit, the PyTorch port's copy.

The paper's primary contribution (Corda, Veenboer, Tolley, 2022): a
high-level library with a standard interface for measuring the energy use
of devices in critical application sections.

The unified entry point is :class:`pmt.Session`: one refcounted
:class:`SensorPool` of shared sensors, one lazily-started background
:class:`RingSampler` per backend, non-blocking nested regions that
resolve against the ring buffer, and pluggable exporters::

    import repro_torch.core as pmt

    with pmt.Session(["cpuutil", "nvml"]) as sess:
        sess.add_exporter(pmt.JsonlExporter("energy.jsonl"))
        with sess.region("prefill"):
            ...
        with sess.region("decode", tokens=128) as r:
            ...
        print(r.measurements.total_joules(), "J")

Region entry/exit never touch a sensor on the caller's thread — exit is
an O(1) span enqueue, and a background resolver batch-resolves spans
against the sampler's preallocated NumPy ring (one vectorized
``np.searchsorted`` pass per backend, exporter fan-out off-path) — so
concurrent serve requests, the train loop, and the decorators below can
all measure through one sampler per backend without waiting on each
other.  ``measurements`` is future-style: it blocks (resolving
synchronously) only when the number is actually asked for.

``pmt.region("roi", backends=["x"])`` opens a region on the implicit
default session for quick scripts.  Classic surfaces (paper Listings
1/2) remain as shims drawing shared sensors from the default pool:

    ======================================  =================================
    old call                                new (Session) call
    ======================================  =================================
    ``sensor = pmt.create("x")``            ``sess = pmt.Session(["x"])``
    ``a = sensor.read(); ...; b = read()``  ``with sess.region("roi") as r:``
    ``sensor.joules(a, b)``                 ``r.measurement.joules``
    ``@pmt.measure("x")``                   ``with sess.region("roi"):``
    ``with pmt.Region("x") as r:``          ``with sess.region("roi") as r:``
    ``sensor.start_dump_thread(f)``         ``sess.add_exporter(CsvExporter(f))``
    ``pmt.PowerMonitor(["x"])``             ``pmt.PowerMonitor(["x"], session=s)``
    ======================================  =================================

Backends: rapl, sysfs, cpuutil, nvml (the card's energy counter or
power, measured), h100 (analytical cost-model sensor of the card,
modeled), dummy.  Every reading carries its sensor's measured, hybrid or
modeled label.
"""
from repro_torch.core.decorators import (Measurement, Measurements, Region, dump,
                                   measure)
from repro_torch.core.dumpfile import (DumpHeader, DumpRecord, average_watts, read_dump,
                             total_joules)
from repro_torch.core.energy_model import H100_SXM, EnergyModel, HardwareSpec
from repro_torch.core.export import (CsvExporter, Exporter, JsonlExporter,
                               MemoryExporter, RegionRecord, read_jsonl)
from repro_torch.core.metrics import (EfficiencyReport, ed2p, edp, gflops_per_watt,
                                joules_per_token, tokens_per_joule)
from repro_torch.core.monitor import (PowerMonitor, StepEnergy, StragglerVerdict,
                                detect_stragglers)
from repro_torch.core.registry import (available_backend_names, backend_names,
                                 create, get_backend, register_backend)
from repro_torch.core.faults import FAULT_KINDS, Fault, FaultInjectingSensor
from repro_torch.core.resolver import SpanResolver, batch_joules_at
from repro_torch.core.sampler import (DumpThread, LegacyRingSampler, RingSampler,
                                SamplerCoverageGap, SamplerReadError,
                                SamplerWindowEvicted, make_ring_sampler)
from repro_torch.core.sensor import Sample, Sensor, SensorError
from repro_torch.core.supervisor import DEGRADED, FAILED, OK, SensorSupervisor
from repro_torch.core.session import (RegionHandle, SensorLease, SensorPool,
                                Session, default_pool, default_session,
                                region, set_default_session)
from repro_torch.core.state import State, joules, rail_joules, seconds, watts

__all__ = [
    # state & sensor
    "State", "Sample", "Sensor", "SensorError",
    "joules", "watts", "seconds", "rail_joules",
    # registry
    "create", "get_backend", "register_backend",
    "backend_names", "available_backend_names",
    # session facade
    "Session", "SensorPool", "SensorLease", "RegionHandle", "region",
    "default_session", "set_default_session", "default_pool",
    # exporters
    "Exporter", "RegionRecord", "CsvExporter", "JsonlExporter",
    "MemoryExporter", "read_jsonl",
    # classic modes (shims over the default session)
    "measure", "dump", "Region", "Measurement", "Measurements",
    "DumpThread", "RingSampler", "LegacyRingSampler", "make_ring_sampler",
    "SamplerWindowEvicted", "SamplerReadError", "SamplerCoverageGap",
    "SpanResolver", "batch_joules_at",
    # fault tolerance
    "SensorSupervisor", "OK", "DEGRADED", "FAILED",
    "Fault", "FaultInjectingSensor", "FAULT_KINDS",
    "DumpHeader", "DumpRecord", "read_dump", "total_joules", "average_watts",
    # energy model & metrics
    "EnergyModel", "HardwareSpec", "H100_SXM",
    "EfficiencyReport", "edp", "ed2p", "gflops_per_watt",
    "joules_per_token", "tokens_per_joule",
    # framework integration
    "PowerMonitor", "StepEnergy", "detect_stragglers", "StragglerVerdict",
]
