"""The port's copy of the PMT library against the JAX package's.

One script of regions on a virtual clock — nested, flat
(``nested=False``) and interleaved regions, a step and per-request spans
through ``PowerMonitor``, three exporters — runs through ``repro.core``
and through ``repro_torch.core`` with the same ``DummySensor`` waveforms.
The background samplers are given a period far longer than the test, so
every sample is one the script forces (the session's first sample at
attach, the closing samples of ``flush`` and of a blocking read): the
two runs see the same samples at the same virtual times, and every
record must agree to the last bit.
"""
import pytest

pytest.importorskip("torch")

import repro.core as jax_pmt  # noqa: E402
import repro_torch.core as torch_pmt  # noqa: E402


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _record_key(r):
    return (r.path, r.label, r.depth, r.sensor, r.kind, r.start_s, r.end_s,
            r.seconds, r.joules, r.watts, r.flops, r.tokens,
            r.window_evicted, r.degraded)


def _script(pmt, tmp_path):
    clk = FakeClock()
    ramp = pmt.create("dummy", watts_fn=lambda t: 40.0 + 5.0 * t, clock=clk)
    flat = pmt.create("dummy", watts=100.0, clock=clk)
    mem = pmt.MemoryExporter()
    jsonl = str(tmp_path / "regions.jsonl")
    csv = str(tmp_path / "regions.csv")
    with pmt.Session([ramp, flat], pool=pmt.SensorPool(), period_s=1e6,
                     exporters=[mem, pmt.JsonlExporter(jsonl),
                                pmt.CsvExporter(csv)]) as sess:
        # nested regions
        with sess.region("outer", tokens=8):
            clk.advance(0.5)
            with sess.region("inner", flops=1e9):
                clk.advance(1.0)
            clk.advance(0.25)
        # flat regions, interleaved: the first closes while the second
        # is open
        a = sess.region("serve/req0", nested=False, tokens=3)
        a.__enter__()
        clk.advance(0.3)
        b = sess.region("serve/req1", nested=False, tokens=5)
        b.__enter__()
        clk.advance(0.4)
        a.__exit__(None, None, None)
        clk.advance(0.2)
        b.__exit__(None, None, None)
        sess.flush()
        # a blocking read in the middle forces a closing sample
        with sess.region("blocking") as blk:
            clk.advance(0.7)
        blocking = [(m.sensor, m.joules, m.seconds, m.watts)
                    for m in blk.measurements]
        # PowerMonitor on the same session: a step and two requests with
        # prefill/decode phases that tile them
        mon = pmt.PowerMonitor(session=sess)
        with mon.measure_step(0, tokens=16):
            clk.advance(0.6)
        for rid, (pf, dec) in enumerate(((0.2, 0.9), (0.35, 0.15))):
            req = mon.measure_request(rid, tokens=4)
            req.__enter__()
            with mon.measure_request(rid, tokens=2, phase="prefill"):
                clk.advance(pf)
            with mon.measure_request(rid, tokens=4, phase="decode"):
                clk.advance(dec)
            req.__exit__(None, None, None)
        sess.flush()
        per_request = mon.per_request_energy()
        steps = [(r.step, r.sensor, r.joules, r.seconds, r.scope, r.phase)
                 for r in mon.records()]
        mon.close()
    records = [_record_key(r) for r in mem.records]
    jsonl_records = [_record_key(r) for r in pmt.read_jsonl(jsonl)]
    with open(csv) as f:
        csv_text = f.read()
    return dict(records=records, jsonl=jsonl_records, csv=csv_text,
                blocking=blocking, per_request=per_request, steps=steps)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return (_script(jax_pmt, tmp_path_factory.mktemp("jax")),
            _script(torch_pmt, tmp_path_factory.mktemp("torch")))


@pytest.mark.parametrize("part", ["records", "jsonl", "csv", "blocking",
                                  "per_request", "steps"])
def test_same_script_gives_the_same_records(runs, part):
    ref, port = runs
    assert port[part] == ref[part]


def test_script_covers_every_kind_of_region(runs):
    _, port = runs
    paths = {r[0] for r in port["records"]}
    assert {"outer", "outer/inner", "serve/req0", "serve/req1",
            "blocking"} <= paths
    assert {r[2] for r in port["records"]} == {0, 1}     # depths
    # the ramp makes joules depend on the sample times, not only on
    # seconds: a wrong sample would show
    ramp = [r for r in port["records"] if r[3] == "dummy" and r[9] != 100.0]
    assert ramp and all(r[8] > 0 for r in ramp)
    # two requests, each with a prefill and decode split
    assert sorted(port["per_request"]) == [0, 1]
    for d in port["per_request"].values():
        assert d["prefill_joules"] > 0 and d["decode_joules"] > 0
        assert d["prefill_joules"] + d["decode_joules"] == pytest.approx(
            d["joules"], rel=1e-9)


def test_port_backends_and_facade():
    assert torch_pmt.backend_names() == ["cpuutil", "dummy", "nvml"]
    assert torch_pmt.get_backend("nvml").kind == "measured"
    assert torch_pmt.get_backend("nvml").native_period_s == 0.010
    skipped = {"Fault", "FaultInjectingSensor", "FAULT_KINDS",
               "EnergyModel", "HardwareSpec", "TPU_V5E"}
    assert set(torch_pmt.__all__) == set(jax_pmt.__all__) - skipped
