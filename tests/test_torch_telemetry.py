"""The port's telemetry plane against the JAX package's.

``PowerRecorder``, the SSE plumbing and ``TelemetryServer`` of
``repro_torch.telemetry`` are fed exactly what the JAX package's are
(the same watts, records and health transitions, each package's own
``RegionRecord``): every read, and every endpoint's status and JSON
body over ``urllib`` against an ephemeral port on 127.0.0.1, must be the
JAX one's.  The counterparts of tests/test_telemetry.py follow, the
fault-tolerance ones of tests/test_faults.py (``TestHealthEvents``,
``TestServerHardening``: malformed queries are JSON 400s), the engine
end to end (a port engine's per-request joules over ``/requests``, both
layouts), the recorder ingesting the preemption plane's events
(tests/test_serve_preempt.py, held to the JAX engine's events), the
exporter plumbing underneath (``MemoryExporter`` under concurrent
subscribe, ``read_jsonl`` on a truncated file), and the launcher with
every control-plane flag.
"""
import dataclasses
import json
import threading
import time
import types
import urllib.error
import urllib.request
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.core.export import RegionRecord as JaxRegionRecord  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve import engine as jax_engine  # noqa: E402
from repro import telemetry as jax_telemetry  # noqa: E402
import repro_torch.core as pmt  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch import telemetry  # noqa: E402
from repro_torch.core.backends.dummy import DummySensor  # noqa: E402
from repro_torch.core.export import (  # noqa: E402
    MemoryExporter, RegionRecord, read_jsonl)
from repro_torch.core.supervisor import DEGRADED, FAILED, OK  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

JAX = types.SimpleNamespace(tel=jax_telemetry, RegionRecord=JaxRegionRecord)
PORT = types.SimpleNamespace(tel=telemetry, RegionRecord=RegionRecord)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny serve steps: torch's intra-op threads only contend with JAX's
    and the other workers of a parallel run.  Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rec_for(ns, path, joules=1.0, tokens=None, start=0.0, end=1.0):
    return ns.RegionRecord(path=path, label=path.rsplit("/", 1)[-1],
                           depth=0, sensor="dummy", kind="modeled",
                           start_s=start, end_s=end, seconds=end - start,
                           joules=joules,
                           watts=joules / max(end - start, 1e-9),
                           tokens=tokens)


def get(url):
    """(status, JSON body) of a GET, errors included."""
    try:
        with urllib.request.urlopen(url, timeout=5.0) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


class FakeSampler:
    """tests/test_faults.py's ``_FakeSampler``."""

    def __init__(self):
        self.state = OK

    def health(self):
        return {"state": self.state, "read_errors": 2, "gaps": 1}

    def last_ts(self):
        return 1.5

    def timeline(self):
        z = np.zeros(0)
        return z, z, z


# -- the recorder: the same reads as JAX's -----------------------------------

def r_windowing(ns):
    rec = ns.tel.PowerRecorder()
    for i in range(10):
        rec.add_watts("dummy", float(i), 100.0 if i >= 5 else 10.0)
    obs = [rec.mean_watts(4.0), rec.mean_watts(100.0),
           rec.mean_watts(1.0, backend="nope"), rec.mean_watts(2.0, now=4.0)]
    assert obs[:3] == [pytest.approx(100.0), pytest.approx(55.0), None]
    return obs, rec.watts_series(), rec.watts_series(since=6.5)


def r_sums_backends(ns):
    rec = ns.tel.PowerRecorder()
    rec.add_watts("a", 1.0, 30.0)
    rec.add_watts("b", 1.0, 12.0)
    obs = [rec.mean_watts(5.0), rec.mean_watts(5.0, backend="a")]
    assert obs == [pytest.approx(42.0), pytest.approx(30.0)]
    return obs


def r_nonfinite_skipped(ns):
    rec = ns.tel.PowerRecorder()
    rec.add_watts("dummy", 0.0, float("nan"))
    rec.add_watts("dummy", 1.0, float("inf"))
    assert rec.mean_watts(10.0) is None
    return rec.stats()


def r_bounded_rings(ns):
    rec = ns.tel.PowerRecorder(record_capacity=4)
    for i in range(10):
        rec.on_record(rec_for(ns, f"r{i}"))
    st = rec.stats()
    assert len(rec.records()) == 4
    assert st["records"] == 10 and st["records_retained"] == 4
    return [r.as_json() for r in rec.records()], st


def r_fanout_and_drop(ns):
    rec = ns.tel.PowerRecorder()
    got = []
    rec.subscribe(got.append)

    def bad(r):
        raise RuntimeError("boom")

    rec.subscribe(bad)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        rec.on_record(rec_for(ns, "a"))
        rec.on_record(rec_for(ns, "b"))
    assert [r.path for r in got] == ["a", "b"]
    assert any("subscriber dropped" in str(x.message) for x in w)
    assert rec.stats()["subscribers"] == 1
    return [r.path for r in got], rec.stats()


def r_request_energy(ns):
    rec = ns.tel.PowerRecorder()
    rec.on_record(rec_for(ns, "serve/req3", joules=10.0, tokens=5))
    rec.on_record(rec_for(ns, "serve/req3/prefill", joules=6.0))
    rec.on_record(rec_for(ns, "serve/req3/decode", joules=4.0))
    rec.on_record(rec_for(ns, "serve/batch0", joules=99.0))
    rec.on_step_energy(types.SimpleNamespace(scope="request", step=4,
                                             phase=None, joules=2.0,
                                             seconds=0.5, tokens=4))
    rec.on_step_energy(types.SimpleNamespace(scope="request", step=4,
                                             phase="decode", joules=1.5,
                                             seconds=0.4, tokens=3))
    rec.on_step_energy(types.SimpleNamespace(scope="step", step=9))
    energy = rec.request_energy()
    d = energy[3]
    assert set(energy) == {3, 4}
    assert d["prefill_joules"] + d["decode_joules"] == \
        pytest.approx(d["joules"])
    assert (d["tokens"], d["j_per_token"], len(d["records"])) == \
        (5, pytest.approx(2.0), 3)
    return energy, rec.stats()


def r_stats_providers(ns):
    rec = ns.tel.PowerRecorder()
    rec.add_stats_provider(lambda: {"extra": 7})
    rec.add_stats_provider(lambda: 1 / 0)
    st = rec.stats()
    assert st["extra"] == 7
    assert any("ZeroDivisionError" in e for e in st["stats_provider_errors"])
    return st


def r_health_transitions(ns):
    """tests/test_faults.py's: a transition a health event, the healthy
    baseline unannounced; a raising subscriber never blocks the fan-out."""
    rec = ns.tel.PowerRecorder()
    fake = FakeSampler()
    got = []

    def bad(ev):
        raise RuntimeError("boom")

    rec.subscribe_health(bad)
    rec.subscribe_health(got.append)
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        for state in (OK, FAILED, OK, DEGRADED, DEGRADED, OK):
            fake.state = state
            rec._poll_health([("dummy", fake)])
    assert [(e.state, e.prev_state) for e in got] == \
        [(FAILED, OK), (OK, FAILED), (DEGRADED, OK), (OK, DEGRADED)]
    assert got[0].timestamp_s == pytest.approx(1.5)
    assert json.loads(got[0].as_json())["state"] == FAILED
    h = rec.health()
    assert (h["state"], h["health_events"]) == (OK, 4)
    return [e.as_json() for e in got], h, rec.stats(), \
        [e._asdict() for e in rec.health_events()]


def r_preempt_events(ns):
    rec = ns.tel.PowerRecorder()
    got = []
    rec.subscribe_preempt(got.append)
    rec.on_preempt_event({"kind": "preempt", "rid": 2, "timestamp_s": 3.0,
                          "dest": "swap", "pages": 4})
    rec.on_preempt_event({"kind": "drain", "rid": None, "timestamp_s": 4.0,
                          "unfinished": 1})
    rec.on_preempt_event({})
    return [e.as_json() for e in got], \
        [e.as_json() for e in rec.preempt_events()], rec.stats()


RECORDER = [r_windowing, r_sums_backends, r_nonfinite_skipped,
            r_bounded_rings, r_fanout_and_drop, r_request_energy,
            r_stats_providers, r_health_transitions, r_preempt_events]


@pytest.mark.parametrize("scenario", RECORDER,
                         ids=[s.__name__[2:] for s in RECORDER])
def test_recorder_equals_jax(scenario):
    assert scenario(PORT) == scenario(JAX)


def test_attach_polls_session_watts():
    sensor = DummySensor(watts=42.0)
    with pmt.Session([sensor], pool=pmt.SensorPool(),
                     period_s=0.002) as sess:
        with telemetry.PowerRecorder(poll_period_s=0.01).attach(sess) as rec:
            with sess.region("work"):
                time.sleep(0.05)
            sess.flush()
            rec.poll_once()
            series = rec.watts_series("dummy")["dummy"]
            assert series, "no watts polled off the ring sampler"
            assert all(w == pytest.approx(42.0) for _t, w in series)
            assert rec.mean_watts(1.0) == pytest.approx(42.0)
            assert any(r.path == "work" for r in rec.records())
            assert rec.health()["backends"]["dummy"]["state"] == OK


# -- SSE plumbing -------------------------------------------------------------

def test_sse_framing_and_queue_equal_jax():
    cases = [("a\nb", "record", "7"), ("", None, None), ("x", "health", None)]
    for args in cases:
        assert telemetry.format_sse(*args) == \
            jax_telemetry.format_sse(*args)
    assert telemetry.format_sse("a\nb", event="record", event_id="7") == \
        b"id: 7\nevent: record\ndata: a\ndata: b\n\n"
    seen = []
    for tel in (telemetry, jax_telemetry):
        sub = tel.SSESubscriber(maxlen=3)
        for i in range(6):
            sub.put(i)
        seen.append((sub.dropped, [sub.get(0.01) for _ in range(4)],
                     len(sub)))
    assert seen[0] == seen[1] == (3, [3, 4, 5, None], 0)


# -- the server: every endpoint's status and JSON equal JAX's -----------------

def fed(ns):
    rec = ns.tel.PowerRecorder()
    rec.add_watts("dummy", 1.0, 50.0)
    rec.add_watts("dummy", 2.0, 70.0)
    rec.add_watts("other", 1.5, 9.0)
    rec.on_record(rec_for(ns, "serve/req0", joules=9.0, tokens=3))
    rec.on_record(rec_for(ns, "serve/req0/prefill", joules=5.0))
    rec.on_record(rec_for(ns, "serve/req0/decode", joules=4.0))
    rec.on_record(rec_for(ns, "serve/req1", joules=2.0, tokens=1))
    rec.on_record(rec_for(ns, "serve/batch0", joules=12.0))
    rec.on_preempt_event({"kind": "preempt", "rid": 1, "timestamp_s": 2.0})
    rec.add_stats_provider(lambda: {"requests_admitted": 2})
    return rec


# (query, status): the endpoints, and tests/test_faults.py's malformed
# queries, each a JSON 400
QUERIES = [("/", 200), ("/nope", 404), ("/timeline", 200),
           ("/timeline?window=5", 200), ("/timeline?since=1.5", 200),
           ("/timeline?backend=other", 200), ("/timeline?backend=nope", 200),
           ("/requests", 200), ("/requests?tenant=t-0.a", 200),
           ("/stats", 200), ("/health", 200),
           ("/timeline?window=abc", 400), ("/timeline?window=-1", 400),
           ("/timeline?window=0", 400), ("/timeline?window=inf", 400),
           ("/timeline?since=nan", 400), ("/timeline?window=bogus", 400),
           ("/requests?tenant=../etc", 400),
           ("/requests?tenant=" + "x" * 65, 400),
           ("/requests?tenant=a%20b", 400)]


@pytest.fixture(scope="module")
def servers():
    pair = []
    for ns in (PORT, JAX):
        rec = fed(ns)
        pair.append((rec, ns.tel.TelemetryServer(
            rec, sse_keepalive_s=0.05).start()))
    yield pair
    for rec, srv in pair:
        srv.close()
        rec.close()


@pytest.mark.parametrize("query,status", QUERIES,
                         ids=[q for q, _ in QUERIES])
def test_endpoint_equals_jax(servers, query, status):
    (_, port), (_, ref) = servers
    assert port.host == "127.0.0.1" and port.port > 0
    got = get(port.url + query)
    assert got == get(ref.url + query)
    assert got[0] == status
    if status != 200:
        assert "error" in got[1]


def test_requests_invariant_and_roundtrip(servers):
    (rec, srv), _ = servers
    _, d = get(srv.url + "/requests")
    assert d["count"] == 2
    req = d["requests"]["0"]
    assert req["prefill_joules"] + req["decode_joules"] \
        == pytest.approx(req["joules"])
    originals = {r.path: r for r in rec.records()}
    for line in req["records"]:
        back = RegionRecord.from_json(line)
        assert back == originals[back.path] and back.as_json() == line
    _, tl = get(srv.url + "/timeline?window=5")
    assert tl["series"]["dummy"] == [[1.0, 50.0], [2.0, 70.0]]
    assert tl["window_mean_watts"] == pytest.approx(69.0)


def read_event(resp, kind, deadline_s=5.0):
    """The data of the next ``event: <kind>`` on an SSE response."""
    deadline = time.monotonic() + deadline_s
    event = None
    while time.monotonic() < deadline:
        line = resp.readline()
        if line.startswith(b"event: "):
            event = line[len(b"event: "):-1].decode()
        elif event == kind and line.startswith(b"data: "):
            return line[len(b"data: "):-1].decode()
    return None


def test_sse_stream_delivers_records_health_and_preempt_events():
    rec = telemetry.PowerRecorder()
    with telemetry.TelemetryServer(rec, sse_keepalive_s=0.05) as srv:
        resp = urllib.request.urlopen(srv.url + "/stream", timeout=5.0)
        assert resp.headers["Content-Type"] == "text/event-stream"
        assert [resp.readline() for _ in range(3)] == \
            [b"event: hello\n", b'data: {"records": 0}\n', b"\n"]
        fresh = rec_for(PORT, "serve/req1", joules=2.5, tokens=1)
        rec.on_record(fresh)
        assert read_event(resp, "record") == fresh.as_json()
        fake = FakeSampler()
        fake.state = DEGRADED
        rec._poll_health([("dummy", fake)])
        data = json.loads(read_event(resp, "health"))
        assert data["state"] == DEGRADED and data["backend"] == "dummy"
        rec.on_preempt_event({"kind": "preempt", "rid": 7,
                              "timestamp_s": 1.0, "dest": "tree"})
        data = json.loads(read_event(resp, "preempt"))
        assert data == {"kind": "preempt", "rid": 7, "timestamp_s": 1.0,
                        "dest": "tree"}
        resp.close()
        srv.close()                  # idempotent, inside the context too
    # the handler lets its client go within a keep-alive period of close
    deadline = time.monotonic() + 5.0
    while rec.stats()["subscribers"] and time.monotonic() < deadline:
        time.sleep(0.01)
    assert rec.stats()["subscribers"] == 0
    rec.close()


# -- end to end: engine -> exporter -> recorder -> HTTP -----------------------

@pytest.fixture(scope="module")
def smollm():
    kw = dict(dtype="float32", prefill_chunk=16)
    cfg_j = dataclasses.replace(
        jax_configs.get_config("smollm-135m", reduced=True), **kw)
    cfg_t = dataclasses.replace(
        port_configs.get_config("smollm-135m", reduced=True), **kw)
    params_j = jax.jit(lambda k: JM.init_params(k, cfg_j)[0])(
        jax.random.PRNGKey(0))
    params_t = bridge.params_from_numpy(jax.device_get(params_j), cfg_t,
                                        device="cpu")
    return dict(cfg_j=cfg_j, cfg=cfg_t, params_j=params_j, params=params_t)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_serve_engine_requests_over_http(smollm, layout):
    """Per-request prefill + decode joules equal the request's total
    through ``/requests``, the records come back bit for bit, the engine's
    counters ride ``/stats`` (``attach_engine``), and the timeline is
    served."""
    sensor = DummySensor(watts=100.0)
    with pmt.Session([sensor], pool=pmt.SensorPool(),
                     period_s=0.002) as sess:
        mem = sess.add_exporter(MemoryExporter())
        with telemetry.PowerRecorder(poll_period_s=0.01).attach(
                sess, exporter=mem) as rec:
            eng = ServeEngine(smollm["cfg"], smollm["params"], batch_size=2,
                              max_len=48, session=sess, prefill_chunk=8,
                              kv_layout=layout, kv_page_size=8,
                              cache_dtype=torch.float32, device="cpu")
            rec.attach_engine(eng)
            done = eng.generate([Request(prompt=[1, 2, 3], max_new_tokens=4,
                                         tenant="a"),
                                 Request(prompt=[4, 5, 6, 7, 8, 9],
                                         max_new_tokens=3)])
            sess.flush()
            rec.poll_once()
            with telemetry.TelemetryServer(rec) as srv:
                _, d = get(srv.url + "/requests")
                _, da = get(srv.url + "/requests?tenant=a")
                _, st = get(srv.url + "/stats")
                _, tl = get(srv.url + "/timeline?window=60")
    assert d["count"] == len(done) and list(da["requests"]) == ["0"]
    exported = {r.as_json() for r in mem.records}
    for rid, req in d["requests"].items():
        assert req["prefill_joules"] > 0 and req["decode_joules"] > 0, rid
        assert req["prefill_joules"] + req["decode_joules"] \
            == pytest.approx(req["joules"], rel=0.02)
        for line in req["records"]:
            assert line in exported, "HTTP record not bit-identical"
            assert RegionRecord.from_json(line).as_json() == line
    assert st["requests_admitted"] == len(done)
    assert st["kv_layout"] == layout and "preemption" in st
    assert "stall_p95_s" in st and "compile_counts" in st
    assert tl["series"]["dummy"], "no watts timeline over HTTP"
    assert tl["window_mean_watts"] == pytest.approx(100.0)


# tests/test_serve_preempt.py's pressured mix on a pool of 9 pages of 8
PRESS = [(13, 16), (21, 4), (40, 4)]


def test_recorder_ingests_preempt_events(smollm):
    """``attach_engine`` wires the engine's event sink: the preemption
    plane's events land in the recorder's ring, counted in its stats,
    and equal the JAX engine's (the timestamps aside)."""
    s = smollm
    got = []
    for ns, make, req in (
            (JAX, lambda: jax_engine.ServeEngine(
                s["cfg_j"], s["params_j"], batch_size=2, max_len=64,
                kv_layout="paged", kv_page_size=8, kv_pool_pages=9,
                preempt=True, cache_dtype=jnp.float32), jax_engine.Request),
            (PORT, lambda: ServeEngine(
                s["cfg"], s["params"], batch_size=2, max_len=64,
                kv_layout="paged", kv_page_size=8, kv_pool_pages=9,
                preempt=True, cache_dtype=torch.float32, device="cpu"),
             Request)):
        eng = make()
        rec = ns.tel.PowerRecorder()
        rec.attach_engine(eng)
        rng = np.random.default_rng(11)
        try:
            done = eng.generate([req(prompt=rng.integers(
                2, s["cfg"].vocab_size - 1, size=(p,)).tolist(),
                max_new_tokens=n) for p, n in PRESS])
            evs = rec.preempt_events()
            kinds = {e.kind for e in evs}
            assert {"preempt", "preempt_resume"} <= kinds
            assert rec.stats()["preempt_events"] == len(evs) >= 2
            assert all(isinstance(e.as_json(), str) for e in evs)
            got.append(([(e.kind, e.rid, e.fields) for e in evs],
                        [r.out for r in done]))
        finally:
            rec.close()
    assert got[1] == got[0]


# -- the exporter plumbing underneath -----------------------------------------

def test_memory_exporter_concurrent_emit_and_subscribe():
    exp = MemoryExporter()
    seen, errors = [], []
    stop = threading.Event()

    def churn():
        try:
            while not stop.is_set():
                unsub = exp.subscribe(lambda r: None)
                unsub()
        except Exception as e:          # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=churn) for _ in range(3)]
    for t in threads:
        t.start()
    exp.subscribe(seen.append)
    n = 400
    emitters = [threading.Thread(
        target=lambda lo: [exp.emit(rec_for(PORT, f"r{lo}/{i}"))
                           for i in range(n)], args=(k,)) for k in range(2)]
    for t in emitters:
        t.start()
    for t in emitters:
        t.join()
    stop.set()
    for t in threads:
        t.join()
    assert not errors
    assert len(exp.records) == len(seen) == 2 * n


def test_memory_exporter_drops_raising_subscriber_and_unsubscribes():
    exp = MemoryExporter()
    calls, hits = [], []

    def bad(r):
        calls.append(r)
        raise ValueError("subscriber bug")

    exp.subscribe(bad)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        exp.emit(rec_for(PORT, "a"))
        exp.emit(rec_for(PORT, "b"))
    assert len(calls) == 1
    assert any("subscriber dropped" in str(x.message) for x in w)
    u1 = exp.subscribe(hits.append)
    u2 = exp.subscribe(hits.append)     # the same function twice
    u1()
    exp.emit(rec_for(PORT, "x"))
    assert len(hits) == 1
    u2()
    exp.emit(rec_for(PORT, "y"))
    assert len(hits) == 1


def test_read_jsonl_skips_bad_lines(tmp_path):
    good = rec_for(PORT, "a", joules=3.0)
    p = tmp_path / "export.jsonl"
    p.write_text('{"not": "a record"}\n' + good.as_json() + "\n"
                 + good.as_json()[: len(good.as_json()) // 2])
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert read_jsonl(p) == [good]
    assert len(w) == 2
    with pytest.raises(Exception):
        read_jsonl(p, strict=True)


# -- the launcher -------------------------------------------------------------

@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_serve_launcher_control_plane_flags(capsys, layout):
    """``launch/serve.py`` with every control-plane flag on the reduced
    config: the telemetry server on an ephemeral port of 127.0.0.1, the
    governor's clause on the stall line, tenants' joules, the supervised
    sensors' health."""
    from repro_torch.launch import serve as serve_launch
    args = ["--reduced", "--device", "cpu", "--requests", "3", "--batch",
            "2", "--max-new", "3", "--max-len", "32",
            "--power-cap-watts", "1000", "--tenant-quota", "1e-9",
            "--signal-ttl-s", "5", "--governor-fail-mode", "open",
            "--telemetry-port", "0", "--supervise"]
    if layout == "paged":
        args += ["--kv-layout", "paged", "--kv-page-size", "8",
                 "--pool-reserve-frac", "0.25", "--preempt"]
    serve_launch.main(args)
    out = capsys.readouterr().out
    assert "telemetry: http://127.0.0.1:" in out
    assert "; governor: " in out and " throttle decisions " in out
    assert "vs cap 1000.0 W, tenant J {'tenant0': " in out
    assert "measurement plane: ok (0 health transitions)" in out
    assert out.count(" -> 3 tokens (length)") == 3
