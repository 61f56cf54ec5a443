"""The port's ``PowerGovernor`` against the JAX package's.

Unit level: each scenario of tests/test_governor.py and of
tests/test_faults.py's ``TestGovernorFailSafe`` runs on both packages'
``PowerGovernor`` and ``PowerRecorder``, given the same watts trace on
an injected step clock (``add_watts``), and must give the same returns,
the same decisions (t, action, watts, cap, detail) and the same
``stats()``, exactly (the arithmetic is the same Python on the same
floats); the reference test's own asserts hold on each side.  A
Hypothesis property (``database=None``) drives both with random call
sequences.

Engine level: reduced smollm-135m in fp32, the same weights through
``repro_torch.bridge``, batch 3, max_len 48, chunks of 8, both layouts.
An observer governor (``cap_watts=None``) leaves the port's greedy
tokens equal to the ungoverned port's and the JAX engine's, byte for
byte.  Under a cap both engines run on a step clock, never a wall
clock: each device step (a decode step or a prefill chunk) advances it
by ``DT`` and adds one sample of a load-coupled power, ``IDLE_W + SLOT_W
* live_slots`` (tests/test_governor.py's sensor), to the recorder.  The
port's engine must then give the JAX engine's tokens and decisions,
complete every request, count in ``stats()["governor"]`` what the
governor counts, and land each decision in its session as a
``serve/governor/<action><n>`` span.  Also: the unholdable cap (forced
admits, pauses), a blacked-out sensor under ``fail_mode="closed"``,
the paged pool veto with a shed request, tenant quotas, and the int8
pool's ``pool_wait`` episodes (tests/test_quant_serve.py).
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import pytest
from hypothesis import given, settings, strategies as hst

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.core.export import RegionRecord as JaxRegionRecord  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve import engine as jax_engine  # noqa: E402
from repro.serve.governor import PowerGovernor as JaxGovernor  # noqa: E402
from repro.telemetry import PowerRecorder as JaxRecorder  # noqa: E402
import repro_torch.core as pmt  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.core.backends.dummy import DummySensor  # noqa: E402
from repro_torch.core.export import MemoryExporter, RegionRecord  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.governor import PowerGovernor  # noqa: E402
from repro_torch.telemetry import PowerRecorder  # noqa: E402

IDLE_W, SLOT_W = 50.0, 15.0
DT = 0.01                   # step-clock seconds a device step

JAX = types.SimpleNamespace(Governor=JaxGovernor, Recorder=JaxRecorder,
                            Request=jax_engine.Request,
                            RegionRecord=JaxRegionRecord)
PORT = types.SimpleNamespace(Governor=PowerGovernor, Recorder=PowerRecorder,
                             Request=Request, RegionRecord=RegionRecord)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny serve steps: torch's intra-op threads only contend with JAX's
    and the other workers of a parallel run.  Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Clock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def feed(rec, clock, watts, seconds=1.0, dt=0.01):
    """Advance the clock while appending a flat watts trace."""
    end = clock.t + seconds
    while clock.t < end:
        clock.advance(dt)
        rec.add_watts("dummy", clock.t, watts)


def governed(ns, cap=100.0, **kw):
    clock = Clock()
    rec = ns.Recorder()
    gov = ns.Governor(rec, cap_watts=cap, window_s=0.5, clock=clock, **kw)
    return gov, rec, clock


def decisions(gov):
    return [(d.t, d.action, d.watts, d.cap, d.detail) for d in gov.decisions]


def rec_for(ns, path, joules):
    return ns.RegionRecord(path=path, label=path.rsplit("/", 1)[-1],
                           depth=0, sensor="dummy", kind="modeled",
                           start_s=0.0, end_s=1.0, seconds=1.0,
                           joules=joules, watts=joules)


def request(ns, rid=None, tenant=None):
    r = ns.Request(prompt=[1], max_new_tokens=1, tenant=tenant)
    r.id = rid
    return r


def raises(fn) -> bool:
    try:
        fn()
    except ValueError:
        return True
    return False


# -- unit scenarios: each returns what it observed --------------------------

def s_gate_blocks_and_resumes(ns):
    gov, rec, clock = governed(ns, cap=100.0)
    feed(rec, clock, 95.0)
    obs = [gov.admission_allowed() for _ in range(6)]   # 95 >= 90
    assert not any(obs)
    assert [d.action for d in gov.decisions] == ["admit_block"]
    feed(rec, clock, 40.0)
    obs.append(gov.admission_allowed())
    assert obs[-1]
    assert [d.action for d in gov.decisions] == \
        ["admit_block", "admit_resume"]
    return obs, decisions(gov), gov.stats()


def s_no_cap_wide_open(ns):
    gov, rec, clock = governed(ns, cap=None)
    feed(rec, clock, 10_000.0)
    obs = [gov.admission_allowed(), gov.prefill_chunk_budget(True),
           gov.maybe_pause_decode(), gov.throttle_count]
    assert obs == [True, 1, 0.0, 0]
    return obs, decisions(gov), gov.stats()


def s_hold_without_signal(ns):
    gov, _rec, clock = governed(ns, cap=100.0)
    obs = [gov.admission_allowed()]
    gov.note_admitted(request(ns))
    obs.append(gov.admission_allowed())
    assert obs == [True, False]
    assert [d.action for d in gov.decisions] == ["admit_hold"]
    clock.advance(gov.admit_hold_s + 0.01)
    obs.append(gov.admission_allowed())
    assert obs[-1]
    return obs, decisions(gov), gov.stats()


def s_predictive_step(ns):
    gov, rec, clock = governed(ns, cap=100.0)
    feed(rec, clock, 50.0)
    obs = [gov.admission_allowed()]
    gov.note_admitted(request(ns, rid=0))      # pre-admission w = 50
    feed(rec, clock, 80.0)                     # slot cost 30 W, settles
    obs.append(gov.admission_allowed())
    obs.append(gov._step_w)
    assert gov._step_w == pytest.approx(30.0, abs=3.0)
    feed(rec, clock, 75.0)                     # 75 + ~30 > 100: blocked
    obs.append(gov.admission_allowed())
    assert not obs[-1]
    feed(rec, clock, 60.0)
    obs.append(gov.admission_allowed())
    assert obs[-1]
    return obs, decisions(gov), gov.stats()


def s_validation_gate(ns):
    rec = ns.Recorder()
    obs = [raises(lambda: ns.Governor(rec, cap_watts=-5.0)),
           raises(lambda: ns.Governor(rec, cap_watts=10.0, admit_frac=1.5)),
           raises(lambda: ns.Governor(rec, cap_watts=10.0,
                                      max_chunks_per_step=0)),
           raises(lambda: ns.Governor(rec, cap_watts=10.0, admit_frac=1.0))]
    assert obs == [True, True, True, False]
    return obs


def s_chunk_tiers(ns):
    gov, rec, clock = governed(ns, cap=100.0)
    obs = []
    for w in (95.0, 60.0, 30.0):
        feed(rec, clock, w)
        obs.append(gov.prefill_chunk_budget(decode_live=True))
    assert obs == [0, 1, gov.max_chunks_per_step]
    actions = [d.action for d in gov.decisions]
    assert actions.count("chunk_pause") == 1
    assert actions.count("chunk_resume") == 1
    return obs, decisions(gov), gov.stats()


def s_decode_pause(ns):
    gov, rec, clock = governed(ns, cap=100.0, pause_s=0.001)
    feed(rec, clock, 105.0)                    # over cap, under 110
    obs = [gov.maybe_pause_decode()]
    feed(rec, clock, 120.0)                    # hard over
    obs.append(gov.maybe_pause_decode())
    assert obs == [0.0, pytest.approx(0.001)]
    assert gov.pause_total_s == pytest.approx(0.001)
    assert gov.decisions[-1].action == "decode_pause"
    return obs, decisions(gov), gov.stats()


def s_quota_from_records(ns):
    gov, rec, clock = governed(ns, cap=None, tenant_quota_j=10.0)
    gov.note_admitted(request(ns, rid=5, tenant="a"))
    obs = [gov.tenant_allowed("a")]
    rec.on_record(rec_for(ns, "serve/req5", 12.0))
    rec.on_record(rec_for(ns, "serve/req5/prefill", 7.0))   # a phase
    rec.on_record(rec_for(ns, "serve/batch0", 99.0))        # the aggregate
    obs += [gov.tenant_joules(), gov.tenant_allowed("a"),
            gov.tenant_allowed("b"), gov.tenant_allowed(None)]
    assert obs == [True, {"a": pytest.approx(12.0)}, False, True, True]
    assert [d.action for d in gov.decisions] == ["tenant_defer"]
    return obs, decisions(gov), gov.stats()


def s_quota_dict(ns):
    gov, rec, clock = governed(ns, cap=None, tenant_quota_j={"a": 1.0})
    gov.note_admitted(request(ns, rid=0, tenant="a"))
    gov.note_admitted(request(ns, rid=1, tenant="b"))
    rec.on_record(rec_for(ns, "serve/req0", 5.0))
    rec.on_record(rec_for(ns, "serve/req1", 5.0))
    obs = [gov.tenant_allowed("a"), gov.tenant_allowed("b")]
    assert obs == [False, True]
    return obs, decisions(gov), gov.stats()


def s_pool_veto(ns):
    gov, rec, clock = governed(ns, cap=None, pool_reserve_frac=0.25)
    obs = [gov.admission_allowed(pool_free_frac=0.10)]
    assert [d.action for d in gov.decisions] == ["pool_block"]
    obs += [gov.admission_allowed(pool_free_frac=0.50),
            gov.admission_allowed(pool_free_frac=0.50)]
    assert obs == [False, True, True]
    assert [d.action for d in gov.decisions] == ["pool_block", "pool_resume"]
    assert gov.stats()["throttle_decisions"] == 2
    return obs, decisions(gov), gov.stats()


def s_pool_veto_off(ns):
    gov, rec, clock = governed(ns, cap=None)
    obs = [gov.admission_allowed(pool_free_frac=0.0)]
    assert obs == [True] and gov.stats()["pool_reserve_frac"] == 0.0
    return obs, decisions(gov), gov.stats()


def s_validation_pool(ns):
    obs = [raises(lambda: ns.Governor(ns.Recorder(), pool_reserve_frac=f))
           for f in (1.0, -0.1, 0.0, 0.99)]
    assert obs == [True, True, False, False]
    return obs


def s_slot_model_fit(ns):
    """Exact watts = 50 + 15 * slots: the fitted slope replaces the EWMA
    step in the predictive gate."""
    gov, rec, clock = governed(ns, cap=100.0)
    eng = types.SimpleNamespace(live_slots=0)
    gov._engine = eng
    obs = []
    for slots in (0, 1, 2, 3, 1, 2):
        eng.live_slots = slots
        feed(rec, clock, IDLE_W + SLOT_W * slots)
        obs.append(gov.admission_allowed())
    obs.append(gov._fitted_step())
    sm = gov.stats()["slot_watts_model"]
    assert sm["slope_w_per_slot"] == pytest.approx(SLOT_W, abs=1e-6)
    assert sm["intercept_w"] == pytest.approx(IDLE_W, abs=1e-6)
    assert sm["samples"] == 6 and gov._step_w is None
    feed(rec, clock, 87.0)                     # 87 + 15 > 100
    obs.append(gov.admission_allowed())
    feed(rec, clock, 70.0)
    obs.append(gov.admission_allowed())
    assert obs[-2:] == [False, True]
    return obs, decisions(gov), gov.stats()


def s_slot_model_spread(ns):
    gov, rec, clock = governed(ns, cap=100.0)
    gov._engine = types.SimpleNamespace(live_slots=2)
    obs = []
    for _ in range(6):
        feed(rec, clock, 80.0)
        obs.append(gov.admission_allowed())
    obs.append(gov._fitted_step())
    assert obs[-1] is None and gov.stats()["slot_watts_model"] is None
    return obs, decisions(gov), gov.stats()


def s_fail_closed(ns):
    gov, rec, clock = governed(ns, cap=100.0, signal_ttl_s=1.0,
                               fail_mode="closed")
    feed(rec, clock, 40.0)
    obs = [gov.signal_stale(), gov.admission_allowed()]
    clock.advance(5.0)                          # the sampler went dark
    obs += [gov.signal_stale(), gov.admission_allowed(),
            gov.prefill_chunk_budget(decode_live=True),
            gov.maybe_pause_decode()]
    feed(rec, clock, 40.0)                      # the signal recovers
    obs += [gov.signal_stale(), gov.admission_allowed()]
    assert obs == [False, True, True, False, 0, 0.0, False, True]
    actions = [d.action for d in gov.decisions]
    assert actions.count("signal_stale") == 1
    assert actions.count("signal_fresh") == 1
    st = gov.stats()
    assert (st["signal_ttl_s"], st["fail_mode"], st["signal_stale"]) == \
        (1.0, "closed", False)
    return obs, decisions(gov), st


def s_fail_open(ns):
    gov, rec, clock = governed(ns, cap=100.0, signal_ttl_s=1.0,
                               fail_mode="open")
    feed(rec, clock, 95.0)                      # over the admit threshold
    obs = [gov.admission_allowed()]
    clock.advance(5.0)
    obs += [gov.signal_stale(), gov.admission_allowed(),
            gov.prefill_chunk_budget(decode_live=True),
            gov.maybe_pause_decode()]
    assert obs == [False, True, True, 1, 0.0]
    return obs, decisions(gov), gov.stats()


def s_cold_start(ns):
    clock = Clock()
    gov = ns.Governor(ns.Recorder(), cap_watts=100.0, window_s=0.5,
                      clock=clock, signal_ttl_s=0.5)
    clock.advance(100.0)
    obs = [gov.signal_stale(), gov.admission_allowed()]
    assert obs == [False, True]
    return obs, decisions(gov), gov.stats()


def s_validation_failsafe(ns):
    rec = ns.Recorder()
    obs = [raises(lambda: ns.Governor(rec, cap_watts=10.0,
                                      signal_ttl_s=0.0)),
           raises(lambda: ns.Governor(rec, cap_watts=10.0,
                                      fail_mode="explode"))]
    assert obs == [True, True]
    return obs


def s_last_watts_ts(ns):
    rec = ns.Recorder()
    rec.add_watts("a", 5.0, 10.0)
    rec.add_watts("b", 2.0, 10.0)
    obs = [rec.last_watts_ts(), rec.last_watts_ts(backend="a"),
           rec.last_watts_ts(backend="nope")]
    assert obs == [2.0, 5.0, None]
    return obs


def s_plane_notes(ns):
    """The preemption plane's and the pool's notes: one decision each,
    episodes and shed requests once, the details' text."""
    gov, rec, clock = governed(ns, cap=None)
    feed(rec, clock, 70.0)
    gov.request_shed()
    gov.request_shed()                          # one pending at a time
    obs = [gov.consume_shed_request(), gov.consume_shed_request()]
    gov.note_preempt(3, 5, "swap")
    gov.note_preempt_resume(3, 40, 2)
    gov.note_quarantine(4)
    gov.note_pool_wait(2, 7)
    gov.note_pool_wait(1, 7)                    # same episode
    gov.note_pool_ready()
    gov.note_pool_ready()
    gov.note_forced_chunk()
    gov.note_forced_admit()
    assert obs == [True, False]
    assert [d.action for d in gov.decisions] == [
        "shed_request", "preempt", "preempt_resume", "quarantine",
        "pool_wait", "pool_ready", "chunk_force", "admit_force"]
    return obs, decisions(gov), gov.stats(), repr(gov)


class _Ctx:
    """A session region stand-in that records its label and flag."""

    def __init__(self, labels, label, nested):
        labels.append((label, nested))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def s_spans(ns):
    """``begin`` binds the engine's session (or its monitor's): every
    decision opens one flat ``serve/governor/<action><n>`` region, the
    decode pause's sleep inside its own; ``close`` unsubscribes."""
    labels = []
    sess = types.SimpleNamespace(
        region=lambda label, nested=True: _Ctx(labels, label, nested))
    gov, rec, clock = governed(ns, cap=100.0, pause_s=1e-4,
                               tenant_quota_j=1.0)
    gov.begin(types.SimpleNamespace(session=None, live_slots=1,
                                    monitor=types.SimpleNamespace(
                                        session=sess)))
    feed(rec, clock, 95.0)
    gov.admission_allowed()
    feed(rec, clock, 130.0)
    gov.maybe_pause_decode()
    gov.note_admitted(request(ns, rid=1, tenant="t"))
    rec.on_record(rec_for(ns, "serve/req1", 2.0))
    gov.tenant_allowed("t")
    gov.close()
    rec.on_record(rec_for(ns, "serve/req1", 2.0))   # no longer counted
    assert labels == [("serve/governor/admit_block1", False),
                      ("serve/governor/decode_pause2", False),
                      ("serve/governor/tenant_defer3", False)]
    return labels, decisions(gov), gov.stats()


SCENARIOS = [s_gate_blocks_and_resumes, s_no_cap_wide_open,
             s_hold_without_signal, s_predictive_step, s_validation_gate,
             s_chunk_tiers, s_decode_pause, s_quota_from_records,
             s_quota_dict, s_pool_veto, s_pool_veto_off, s_validation_pool,
             s_slot_model_fit, s_slot_model_spread, s_fail_closed,
             s_fail_open, s_cold_start, s_validation_failsafe,
             s_last_watts_ts, s_plane_notes, s_spans]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__[2:] for s in SCENARIOS])
def test_governor_equals_jax(scenario):
    """Returns, decisions (t, action, watts, cap, detail) and stats()
    equal to the JAX governor's, exactly."""
    assert scenario(PORT) == scenario(JAX)


OPS = hst.one_of(
    hst.tuples(hst.just("feed"), hst.sampled_from([0.0, 30.0, 60.0, 80.0,
                                                   88.0, 95.0, 105.0,
                                                   130.0]),
               hst.sampled_from([0.02, 0.1, 0.5])),
    hst.tuples(hst.just("advance"), hst.sampled_from([0.05, 0.3, 3.0])),
    hst.tuples(hst.just("admit"), hst.sampled_from([None, 0.1, 0.6])),
    hst.tuples(hst.just("admitted"), hst.sampled_from([None, "a", "b"])),
    hst.tuples(hst.just("budget"), hst.booleans()),
    hst.tuples(hst.just("pause")),
    hst.tuples(hst.just("record"), hst.integers(0, 5),
               hst.sampled_from([0.5, 3.0])),
    hst.tuples(hst.just("tenant"), hst.sampled_from([None, "a", "b"])),
    hst.tuples(hst.just("slots"), hst.integers(0, 4)),
    hst.tuples(hst.just("shed")),
    hst.tuples(hst.just("consume")))


def drive(ns, cfg, ops):
    clock = Clock()
    rec = ns.Recorder()
    gov = ns.Governor(rec, window_s=0.25, clock=clock, pause_s=1e-6,
                      **cfg)
    eng = types.SimpleNamespace(live_slots=0, session=None, monitor=None)
    gov.begin(eng)
    rid = 0
    out = []
    for op in ops:
        kind = op[0]
        if kind == "feed":
            feed(rec, clock, op[1] + 3.0 * eng.live_slots, op[2])
        elif kind == "advance":
            clock.advance(op[1])
        elif kind == "admit":
            out.append(gov.admission_allowed(pool_free_frac=op[1]))
        elif kind == "admitted":
            gov.note_admitted(request(ns, rid=rid, tenant=op[1]))
            rid += 1
        elif kind == "budget":
            out.append(gov.prefill_chunk_budget(op[1]))
        elif kind == "pause":
            out.append(gov.maybe_pause_decode())
        elif kind == "record":
            rec.on_record(rec_for(ns, f"serve/req{op[1]}", op[2]))
        elif kind == "tenant":
            out.append(gov.tenant_allowed(op[1]))
        elif kind == "slots":
            eng.live_slots = op[1]
        elif kind == "shed":
            gov.request_shed()
        else:
            out.append(gov.consume_shed_request())
    return out, decisions(gov), gov.stats()


@settings(database=None, max_examples=40, deadline=None)
@given(cap=hst.sampled_from([None, 60.0, 100.0, 150.0]),
       ttl=hst.sampled_from([None, 0.2, 1.0]),
       mode=hst.sampled_from(["closed", "open"]),
       reserve=hst.sampled_from([0.0, 0.25]),
       quota=hst.sampled_from([None, 2.0, {"a": 1.0}]),
       ops=hst.lists(OPS, min_size=1, max_size=40))
def test_governor_random_traces_equal_jax(cap, ttl, mode, reserve, quota,
                                          ops):
    cfg = dict(cap_watts=cap, signal_ttl_s=ttl, fail_mode=mode,
               pool_reserve_frac=reserve, tenant_quota_j=quota)
    assert drive(PORT, cfg, ops) == drive(JAX, cfg, ops)


# -- engine level ------------------------------------------------------------

@pytest.fixture(scope="module")
def smollm():
    kw = dict(dtype="float32", prefill_chunk=8)
    cfg_j = dataclasses.replace(
        jax_configs.get_config("smollm-135m", reduced=True), **kw)
    cfg_t = dataclasses.replace(
        port_configs.get_config("smollm-135m", reduced=True), **kw)
    params_j = jax.jit(lambda k: JM.init_params(k, cfg_j)[0])(
        jax.random.PRNGKey(0))
    params_t = bridge.params_from_numpy(jax.device_get(params_j), cfg_t,
                                        device="cpu")
    return dict(cfg_j=cfg_j, cfg=cfg_t, params_j=params_j, params=params_t,
                vocab=cfg_t.vocab_size)


# JAX engines of one layout, cache and pool share their jitted steps
_JAX_STEPS = {}
_STEP_ATTRS = {"contiguous": ("_decode", "_prefill_chunk_fn"),
               "paged": ("_paged_decode", "_paged_prefill_chunk_fn")}


def jax_eng(s, layout="contiguous", cd="float32", batch=3, **kw):
    cache = {"float32": jnp.float32}.get(cd, cd)
    eng = jax_engine.ServeEngine(s["cfg_j"], s["params_j"], batch_size=batch,
                                 max_len=48, prefill_chunk=8,
                                 kv_layout=layout, cache_dtype=cache, **kw)
    key = (layout, cd, kw.get("kv_page_size"), kw.get("kv_pool_pages"))
    attrs = _STEP_ATTRS[layout]
    fns = _JAX_STEPS.setdefault(key, tuple(getattr(eng, a) for a in attrs))
    for a, fn in zip(attrs, fns):
        setattr(eng, a, fn)
    return eng


def port_eng(s, layout="contiguous", cd="float32", batch=3, **kw):
    cache = {"float32": torch.float32}.get(cd, cd)
    return ServeEngine(s["cfg"], s["params"], batch_size=batch, max_len=48,
                       prefill_chunk=8, kv_layout=layout, cache_dtype=cache,
                       device="cpu", **kw)


def paged_kw(layout):
    return dict(kv_page_size=8) if layout == "paged" else {}


def reqs(cls, specs, tenants=None):
    return [cls(prompt=list(p), max_new_tokens=n,
                tenant=None if tenants is None else tenants[i])
            for i, (p, n) in enumerate(specs)]


def outs(rs):
    return [r.out for r in rs]


# tests/test_governor.py's workloads
CAPPED = [([1 + i] * 9, 16) for i in range(5)]
UNHOLDABLE = [([2] * 5, 3) for _ in range(3)]
MIXED = [([3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5], 6), ([2, 7, 1, 8], 9),
         ([1] * 17, 4), ([5, 4, 3, 2, 1] * 3, 7)]


class StepClock:
    """The clock of a governed run: each device step advances it by
    ``DT`` and adds one sample of the load-coupled power (the ``load``
    backend) while the sensor lives (``dark_after`` steps, or always)."""

    def __init__(self, rec, dark_after=None):
        self.t, self.rec, self.n = 0.0, rec, 0
        self.dark_after = dark_after
        self.eng = None
        self.hooks = {}

    def __call__(self):
        return self.t

    def tick(self):
        self.t += DT
        self.n += 1
        if self.dark_after is None or self.n <= self.dark_after:
            self.rec.add_watts("load", self.t,
                               IDLE_W + SLOT_W * self.eng.live_slots)
        hook = self.hooks.get(self.n)
        if hook is not None:
            hook()

    def wrap(self, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            self.tick()
            return out
        return call

    def attach(self, eng):
        """Route the engine's device steps (either package's) through
        ``tick``."""
        self.eng = eng
        if hasattr(eng, "_fns"):
            for attr in ("_fns", "_paged_fns"):
                fns = getattr(eng, attr, None)
                if fns is not None:
                    setattr(eng, attr, fns._replace(
                        decode=self.wrap(fns.decode),
                        prefill_chunk=self.wrap(fns.prefill_chunk)))
        else:
            attrs = _STEP_ATTRS[eng.kv_layout]
            for a in attrs:
                setattr(eng, a, self.wrap(getattr(eng, a)))


def governed_pair(s, specs, layout, gov_kw, eng_kw=None, dark_after=None,
                  hooks=None, session=None):
    """The same workload through the JAX and the port engine, each under
    its own package's governor on a step clock.  Returns (JAX engine,
    its governor, done), then the port's."""
    runs = []
    for ns, make in ((JAX, jax_eng), (PORT, port_eng)):
        rec = ns.Recorder()
        clock = StepClock(rec, dark_after)
        gov = ns.Governor(rec, window_s=0.05, pause_s=0.001, clock=clock,
                          **gov_kw)
        eng = make(s, layout, governor=gov, **paged_kw(layout),
                   **(eng_kw or {}))
        clock.attach(eng)
        for n, fn in (hooks or {}).items():
            clock.hooks[n] = (lambda f=fn, g=gov: f(g))
        if ns is PORT:
            eng.session = session
        done = eng.generate(reqs(ns.Request, specs))
        runs.append((eng, gov, done, rec))
    return runs


def check_governed(runs, specs):
    (ej, gj, dj, _), (et, gt, dt, _) = runs
    assert outs(dt) == outs(dj)
    assert [len(r.out) for r in dt] == [n for _, n in specs], \
        "a request starved under the governor"
    assert all(r.finish_reason == "length" for r in dt)
    assert decisions(gt) == decisions(gj)
    assert gt.stats() == gj.stats()
    st = et.stats()
    assert st["governor"]["throttle_decisions"] == gt.throttle_count
    assert st["governor"] == ej.stats()["governor"]
    assert (et.live_slots, et.queue_depth, et.pending_prefill_chunks) \
        == (0, 0, 0)


def window_max(series, window_s, ramp_s):
    t_start = min(series[0][0] + ramp_s,
                  series[0][0] + 0.5 * (series[-1][0] - series[0][0]))
    worst = 0.0
    for i, (t_i, _w) in enumerate(series):
        if t_i < t_start:
            continue
        win = [w for t, w in series[max(0, i - 512):i + 1]
               if t >= t_i - window_s]
        worst = max(worst, sum(win) / len(win))
    return worst


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_observer_governor_keeps_tokens(smollm, layout):
    """cap_watts=None: every lever open; the port's tokens equal the
    ungoverned port's and the JAX engine's, and no decision is made."""
    s = smollm
    want = outs(jax_eng(s, layout, **paged_kw(layout)).generate(
        reqs(jax_engine.Request, MIXED)))
    plain = outs(port_eng(s, layout, **paged_kw(layout)).generate(
        reqs(Request, MIXED)))
    gov = PowerGovernor(PowerRecorder())
    eng = port_eng(s, layout, governor=gov, **paged_kw(layout))
    got = outs(eng.generate(reqs(Request, MIXED)))
    assert got == plain == want
    assert gov.throttle_count == 0
    assert eng.stats()["governor"]["cap_watts"] is None


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_cap_held_on_step_clock(smollm, layout):
    """A cap between the 2- and 3-slot power levels (tests/test_governor.
    py's gate): JAX's tokens and decisions, every request in full, the
    smoothed window under cap * 1.05 after the ramp, and each decision a
    ``serve/governor/`` span of the port's session."""
    s = smollm
    cap = IDLE_W + 2.5 * SLOT_W                  # 87.5 W
    with pmt.Session([DummySensor(watts=1.0)], pool=pmt.SensorPool(),
                     period_s=0.002) as sess:
        mem = sess.add_exporter(MemoryExporter())
        runs = governed_pair(s, CAPPED, layout, dict(cap_watts=cap),
                             session=sess)
        sess.flush()
    check_governed(runs, CAPPED)
    eng, gov, _, rec = runs[1]
    assert gov.throttle_count >= 1, "the cap bound but the governor idled"
    actions = gov.stats()["throttle_actions"]
    assert "admit_block" in actions or "admit_hold" in actions
    peak = window_max(rec.watts_series("load")["load"], 0.05, 0.1)
    assert peak <= cap * 1.05, f"window {peak:.2f} W over cap {cap} W"
    spans = sorted(r.path for r in mem.records
                   if r.path.startswith("serve/governor/"))
    want = sorted(f"serve/governor/{d.action}{n}"
                  for n, d in enumerate(gov.decisions, 1))
    assert spans == want


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_unholdable_cap_liveness_wins(smollm, layout):
    """A cap under idle draw: the engine forces admissions (admit_force)
    and decode pauses, and every request completes."""
    runs = governed_pair(smollm, UNHOLDABLE, layout,
                         dict(cap_watts=IDLE_W * 0.5))
    check_governed(runs, UNHOLDABLE)
    gov = runs[1][1]
    assert "admit_force" in {d.action for d in gov.decisions}
    assert gov.pause_total_s > 0


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_stale_signal_fail_closed_stays_live(smollm, layout):
    """The sensor dies after 6 steps: with fail_mode "closed" the stale
    signal stops admitting and pauses chunks, the forced admits and
    chunks keep the engine live, and decode is never paused blind."""
    runs = governed_pair(smollm, CAPPED[:4], layout,
                         dict(cap_watts=200.0, signal_ttl_s=0.05,
                              fail_mode="closed"), dark_after=6)
    check_governed(runs, CAPPED[:4])
    actions = runs[1][1].stats()["throttle_actions"]
    assert actions.get("signal_stale") == 1
    assert actions.get("admit_force", 0) >= 1
    assert "decode_pause" not in actions


def test_paged_pool_veto_and_shed(smollm):
    """Paged, ``preempt=True`` on a pool of 9 pages with a reserve of
    0.25 and a shed request at the 12th step: pool blocks, a preemption
    from the shed and its resume, each a decision, as in JAX."""
    runs = governed_pair(
        smollm, MIXED, "paged",
        dict(cap_watts=None, pool_reserve_frac=0.25),
        eng_kw=dict(kv_pool_pages=9, preempt=True),
        hooks={12: lambda gov: gov.request_shed()})
    check_governed(runs, MIXED)
    (ej, *_), (et, gov, *_) = runs
    actions = gov.stats()["throttle_actions"]
    assert {"pool_block", "shed_request", "preempt",
            "preempt_resume"} <= set(actions)
    assert et.preempt_log == ej.preempt_log
    assert et.stats()["preemption"]["preemptions"] >= 1


def test_tenant_quota_soft_priority_never_starves(smollm):
    """Tiny per-tenant quotas deprioritize but never drop: every request
    completes, and the quotas see the session's resolved per-request
    joules."""
    eng = port_eng(smollm)
    eng.generate(reqs(Request, [([1] * 9, 2)]))
    sensor = DummySensor(watts_fn=lambda t: IDLE_W + SLOT_W * eng.live_slots)
    with pmt.Session([sensor], pool=pmt.SensorPool(),
                     period_s=0.001) as sess:
        mem = sess.add_exporter(MemoryExporter())
        with PowerRecorder(poll_period_s=0.005).attach(
                sess, exporter=mem) as rec:
            gov = PowerGovernor(rec, tenant_quota_j=1e-6)
            eng.session, eng.governor = sess, gov
            done = eng.generate(reqs(Request, [([3] * 5, 3)] * 4,
                                     tenants=["t0", "t1"] * 2))
            sess.flush()
            gov.close()
    assert all(len(r.out) == 3 for r in done)
    assert set(eng.request_tenants.values()) == {"t0", "t1"}
    joules = gov.tenant_joules()
    assert set(joules) == {"t0", "t1"} and all(v > 0 for v in joules.values())
    assert not gov.tenant_allowed("t0")


PROMPTS = [[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8], [1, 1, 2, 3, 5]]


def test_pool_wait_logged_not_silent(smollm):
    """tests/test_quant_serve.py's: an int8 pool of 7 pages with no
    prefix cache defers admissions; each wait opens a ``pool_wait``
    decision that a ``pool_ready`` closes, as in JAX (details included),
    with JAX's tokens."""
    s = smollm
    runs = []
    for ns, make in ((JAX, jax_eng), (PORT, port_eng)):
        gov = ns.Governor(recorder=None)
        eng = make(s, "paged", "int8", batch=2, kv_page_size=8,
                   kv_pool_pages=7, prefix_cache=False, governor=gov)
        done = eng.generate([ns.Request(prompt=p, max_new_tokens=20)
                             for p in PROMPTS])
        runs.append((eng, gov, done))
    (ej, gj, dj), (et, gt, dt) = runs
    assert outs(dt) == outs(dj)
    assert all(len(r.out) == 20 for r in dt)
    assert et.pool_wait_events >= 1
    assert et.stats()["kv_cache"]["pool_wait_events"] == ej.pool_wait_events
    actions = [d.action for d in gt.decisions]
    assert "pool_wait" in actions and "pool_ready" in actions
    assert "pages" in next(d for d in gt.decisions
                           if d.action == "pool_wait").detail
    assert actions.count("pool_wait") == actions.count("pool_ready")
    assert [(d.action, d.detail) for d in gt.decisions] == \
        [(d.action, d.detail) for d in gj.decisions]


def test_engine_stats_and_gauges_reset(smollm):
    gov = PowerGovernor(PowerRecorder())
    eng = port_eng(smollm, governor=gov)
    done = eng.generate(reqs(Request, [([4] * 5, 2)] * 2))
    st = eng.stats()
    assert st["mode"] == "continuous"
    assert st["requests_admitted"] >= len(done)
    assert "stall_p95_s" in st and "compile_counts" in st
    assert st["governor"] == gov.stats()
    assert st["governor"]["cap_watts"] is None
    assert (eng.live_slots, eng.queue_depth, eng.pending_prefill_chunks) \
        == (0, 0, 0)
    # waves take no governor: it is not consulted, nor bound
    wave = port_eng(smollm, mode="wave", governor=PowerGovernor(None,
                                                                cap_watts=1.0))
    assert [len(r.out) for r in wave.generate(
        reqs(Request, [([4] * 5, 2)]))] == [2]
    assert wave.governor.throttle_count == 0
    assert wave.governor._engine is None
