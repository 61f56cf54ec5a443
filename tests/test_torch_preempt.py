"""The port's preemption plane against the JAX package's.

Reduced smollm-135m and deepseek-v3 (``moe=None, mtp=False``: three
dense MLA layers) in fp32, the same weights through
``repro_torch.bridge``.  Under pool pressure the port's paged engine with
``preempt=True`` preempts, parks (radix tree or a host
``PageSwapStore``) and resumes requests, and must give the JAX
``ServeEngine``'s greedy tokens byte for byte, the unpressured run's
tokens, and JAX's preemption counters and ``preempt_log``: smollm at
page 8 (off the chunk grid of 16) and page 16 over fp32, bf16, int8 and
fp8_e4m3 pools, deepseek-v3 at page 16, each with and without a swap
store.  The counterparts of tests/test_serve_preempt.py follow:
accounting, priority, retry exhaustion, timeout outranking retry (on a
clock the test drives), quarantine (poisoned through the port's serve
steps) with and without retry, the watchdog and its events, drain and
resume, exception cleanup and validation.  The recorder's twin
(``PowerRecorder.attach_engine`` ingesting the plane's events) is in
tests/test_torch_telemetry.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings, strategies as hst

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve import engine as jax_engine  # noqa: E402
from repro.serve.swap import PageSwapStore as JaxSwapStore  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve import engine as engine_mod  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.swap import PageSwapStore  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

SMOLLM, DEEPSEEK = "smollm-135m", "deepseek-v3-671b"
# tests/test_serve_preempt.py's pressured mix: a long decoder (the victim),
# a neighbour, and a page-hungry latecomer the pool cannot cover
PRESS = [(13, 16), (21, 4), (40, 4)]
# at page 8 its victim parks 3 pages: the resume lands at 24, off the
# chunk grid of 16
OFF_GRID = [(27, 16), (9, 4), (40, 4)]
# a resolved prefill record both engines learn their J per token from
PRICE = type("Rec", (), dict(path="serve/req9/prefill", tokens=16,
                             joules=2.4))()
COUNTERS = ("preemptions", "resumes", "retries_exhausted", "wasted_tokens",
            "recovered_tokens", "quarantined")


def press_pool(ps):
    """tests/test_serve_preempt.py's ``_press_pool``."""
    return 9 if ps == 8 else 4


def mk(vocab, specs, cls=Request, seed=11):
    rng = np.random.default_rng(seed)
    return [cls(prompt=rng.integers(2, vocab - 1, size=(p,)).tolist(),
                max_new_tokens=n) for p, n in specs]


def mk_plain(vocab, cls=Request, n_req=5, seed=7, max_new=6):
    """tests/test_serve_preempt.py's ``mk``."""
    rng = np.random.default_rng(seed)
    plens = [13, 21, 9, 30, 17]
    return [cls(prompt=rng.integers(2, vocab - 1, size=(p,)).tolist(),
                max_new_tokens=max_new)
            for p, _ in zip(plens * 10, range(n_req))]


def outs(rs):
    return [r.out for r in rs]


def plane(eng):
    """What the port must hold equal to JAX: the counters and the log's
    event, via and dest."""
    pre = eng.stats()["preemption"]
    log = [(e["event"], e["rid"], e.get("via"), e.get("dest"))
           for e in eng.preempt_log]
    return {k: pre[k] for k in COUNTERS}, log


def _setup(arch):
    kw = dict(dtype="float32", prefill_chunk=16)
    if arch == DEEPSEEK:
        kw.update(moe=None, mtp=False)
    cfg_j = dataclasses.replace(jax_configs.get_config(arch, reduced=True),
                                **kw)
    cfg_t = dataclasses.replace(port_configs.get_config(arch, reduced=True),
                                **kw)
    params_j = jax.jit(lambda k: JM.init_params(k, cfg_j)[0])(
        jax.random.PRNGKey(0))
    params_t = bridge.params_from_numpy(jax.device_get(params_j), cfg_t,
                                        device="cpu")
    return dict(cfg_j=cfg_j, cfg=cfg_t, params_j=params_j, params=params_t,
                vocab=cfg_t.vocab_size)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The serve steps here are tiny: torch's intra-op threads only
    contend, with JAX's and with the other workers of a parallel run
    (where they made this file ~15x slower).  Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setups():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = _setup(arch)
        return cache[arch]
    return get


@pytest.fixture(scope="module")
def smollm(setups):
    return setups(SMOLLM)


def jax_dtype(cd):
    return {"float32": jnp.float32, "bfloat16": jnp.bfloat16}.get(cd, cd)


def port(s, cd="float32", **kw):
    kw.setdefault("kv_layout", "paged")
    kw.setdefault("kv_page_size", 8)
    cd = {"float32": torch.float32, "bfloat16": torch.bfloat16}.get(cd, cd)
    return ServeEngine(s["cfg"], s["params"], batch_size=2, max_len=64,
                       cache_dtype=cd, device="cpu", **kw)


# JAX engines of one config and pool share their jitted paged steps, so
# that each config compiles once for the module
_JAX_STEPS = {}


def jax_paged(s, cd="float32", **kw):
    eng = jax_engine.ServeEngine(s["cfg_j"], s["params_j"], batch_size=2,
                                 max_len=64, kv_layout="paged",
                                 cache_dtype=jax_dtype(cd), **kw)
    key = (s["cfg_j"].name, cd, kw.get("kv_page_size"),
           kw.get("kv_pool_pages"))
    eng._paged_decode, eng._paged_prefill_chunk_fn = _JAX_STEPS.setdefault(
        key, (eng._paged_decode, eng._paged_prefill_chunk_fn))
    return eng


# -- the tentpole gate: pressured == JAX == unpressured -------------------------

CASES = [(SMOLLM, ps, swap, cd, PRESS)
         for ps in (8, 16) for swap in (False, True)
         for cd in ("bfloat16", "int8", "fp8_e4m3")
         + (("float32",) if ps == 8 else ())] \
    + [(SMOLLM, 8, True, "float32", OFF_GRID),
       (DEEPSEEK, 16, False, "float32", PRESS),
       (DEEPSEEK, 16, True, "float32", PRESS),
       (DEEPSEEK, 16, True, "int8", PRESS)]


@pytest.mark.parametrize(
    "arch,ps,swap,cd,specs", CASES,
    ids=[f"{a.split('-')[0]}-p{ps}-{'swap' if sw else 'tree'}-{cd}"
         f"{'-offgrid' if sp is OFF_GRID else ''}"
         for a, ps, sw, cd, sp in CASES])
def test_pressured_run_equals_jax_and_unpressured(setups, arch, ps, swap, cd,
                                                   specs):
    """Pool exhaustion preempts the long decoder; every request still
    completes with JAX's tokens and the unpressured run's, with JAX's
    counters and log, over every cache leaf family (k/v, their int8 /
    fp8 scales, MLA's one ``kv`` leaf and its ``kv_scale``).  With a
    swap store the victim's pages leave the pool and come back through
    the gather and scatter, and the store ends empty.  The accounting
    reconciles: the stats' totals are the log's sums, and with the same
    learned J per prefill token the joules are JAX's."""
    s = setups(arch)
    pool = press_pool(ps)
    ej = jax_paged(s, cd, kv_page_size=ps, kv_pool_pages=pool, preempt=True,
                   swap_store=JaxSwapStore() if swap else None)
    ej.on_record(PRICE)
    want = outs(ej.generate(mk(s["vocab"], specs, jax_engine.Request)))
    store = PageSwapStore() if swap else None
    eng = port(s, cd, kv_page_size=ps, kv_pool_pages=pool, preempt=True,
               swap_store=store)
    eng.on_record(PRICE)
    got = outs(eng.generate(mk(s["vocab"], specs)))
    assert got == want
    if swap or cd != "fp8_e4m3":
        assert outs(port(s, cd, kv_page_size=ps).generate(
            mk(s["vocab"], specs))) == got
    # else a recompute requantizes the generated tokens' rows from the
    # chunk's k and v, whose fp32 sums run in another order than the
    # decode steps': e4m3 codes flip, and the JAX engine's pressured run
    # leaves its unpressured tokens there too
    assert plane(eng) == plane(ej)
    pre = eng.stats()["preemption"]
    assert pre["enabled"] and pre["preemptions"] >= 1
    assert pre["resumes"] == pre["preemptions"]
    kc = eng.stats()["kv_cache"]
    assert kc["pages_used"] + kc["pages_free"] == kc["pages_total"]
    assert kc == pytest.approx(ej.stats()["kv_cache"], rel=1e-12)
    via = [e["via"] for e in eng.preempt_log if e["event"] == "resume"]
    if swap:
        assert pre["swap"] == ej.stats()["preemption"]["swap"]
        assert store.swapped_out_pages >= 1 and store.swapped_in_pages >= 1
        assert len(store) == 0 and store.bytes_used == 0
        assert "swap" in via
        assert eng.swap_copies["bytes_out"] == eng.swap_copies["bytes_in"] \
            == store.swapped_in_pages * eng._page_bytes
    else:
        assert "swap" not in pre
    log = eng.preempt_log
    resumes = [e for e in log if e["event"] == "resume"]
    assert pre["preemptions"] == len(log) - len(resumes)
    for key, of in (("wasted_tokens", "rerun_tokens"),
                    ("recovered_tokens", "recovered_tokens"),
                    ("wasted_joules", "wasted_joules"),
                    ("recovered_joules", "recovered_joules")):
        assert pre[key] == pytest.approx(sum(e[of] for e in resumes))
    assert pre["wasted_joules"] + pre["recovered_joules"] > 0
    jlog = ej.preempt_log
    assert [e.keys() for e in log] == [e.keys() for e in jlog]
    assert [{k: v for k, v in e.items() if isinstance(v, float)}
            for e in log] == pytest.approx(
        [{k: v for k, v in e.items() if isinstance(v, float)}
         for e in jlog], rel=1e-12)
    if specs is OFF_GRID:
        edges = [e["recovered_tokens"] for e in eng.preempt_log
                 if e["event"] == "resume"]
        assert any(t % s["cfg"].prefill_chunk for t in edges)


def test_page_axes_name_every_pool_leaf(setups):
    """The swap path's page axis, from the leaf specs, is where each pool
    leaf (k, v, scales; MLA's kv and kv_scale) holds its pages."""
    for arch, cd in ((SMOLLM, "int8"), (DEEPSEEK, "fp8_e4m3"),
                     (DEEPSEEK, "float32")):
        eng = port(setups(arch), cd, kv_page_size=16)
        leaves = tree_leaves(eng._paged_caches)
        axes = TM.paged_page_axes(eng.cfg)
        assert len(axes) == len(leaves)
        pages = eng._pool.total_pages + 1
        assert all(t.shape[ax] == pages for t, ax in zip(leaves, axes))
        assert eng._page_bytes * pages == sum(t.nbytes for t in leaves)


# -- accounting, priority, retries, deadlines ---------------------------------------

def test_priority_orders_victims(smollm):
    """A high-priority latecomer never preempts higher-priority live work:
    the lowest-priority request is the only victim."""
    s = smollm
    rs = mk(s["vocab"], PRESS)
    for r, p in zip(rs, (-1, 5, 5)):
        r.priority = p
    eng = port(s, kv_pool_pages=9, preempt=True)
    done = eng.generate(rs)
    assert all(r.finish_reason == "length" for r in done)
    assert {e["rid"] for e in eng.preempt_log
            if e["event"] == "preempt"} == {0}
    # a latecomer below every live priority preempts nobody: it waits
    rs = mk(s["vocab"], PRESS)
    for r, p in zip(rs, (3, 3, 1)):
        r.priority = p
    eng = port(s, kv_pool_pages=9, preempt=True)
    done = eng.generate(rs)
    assert all(r.finish_reason == "length" for r in done)
    assert eng.preemptions == 0 and eng.pool_wait_events > 0


def test_retry_exhaustion_retires_like_jax(smollm):
    """preempt_max_retries=0: the first preemption retires the victim
    ``"preempted-retry-exhausted"`` with its partial output, as in JAX."""
    s = smollm
    ej = jax_paged(s, kv_page_size=8, kv_pool_pages=9, preempt=True,
                   preempt_max_retries=0)
    want = ej.generate(mk(s["vocab"], PRESS, jax_engine.Request))
    eng = port(s, kv_pool_pages=9, preempt=True, preempt_max_retries=0)
    done = eng.generate(mk(s["vocab"], PRESS))
    reasons = [r.finish_reason for r in done]
    assert reasons == [r.finish_reason for r in want]
    assert outs(done) == outs(want)
    assert reasons.count("preempted-retry-exhausted") == 1
    exhausted = done[reasons.index("preempted-retry-exhausted")]
    assert 0 < len(exhausted.out) < exhausted.max_new_tokens
    assert plane(eng) == plane(ej)
    assert eng.retries_exhausted == 1


def test_timeout_outranks_retry_while_preempted(smollm, monkeypatch):
    """A preempted request whose deadline lapses while it backs off
    retires ``"timeout"`` (not preempted-*), and its swap checkpoint is
    dropped.  The engine's clock moves only when it sleeps a backoff
    off, so no wall-clock time decides the outcome."""
    s = smollm
    clock = {"t": 0.0, "sleeps": 0}

    def sleep(dt):
        clock["sleeps"] += 1
        clock["t"] += dt

    monkeypatch.setattr(engine_mod, "_clock", lambda: clock["t"])
    monkeypatch.setattr(engine_mod, "_sleep", sleep)
    store = PageSwapStore()
    eng = port(s, kv_pool_pages=9, preempt=True, retry_backoff_s=60.0,
               swap_store=store)
    rs = mk(s["vocab"], PRESS)
    rs[0].deadline_s = 2.0              # the victim-to-be
    done = eng.generate(rs)
    assert eng.preemptions >= 1
    assert done[0].finish_reason == "timeout"
    assert len(done[0].out) > 0         # partial output kept
    assert all(r.finish_reason == "length" for r in done[1:])
    assert len(store) == 0 and store.bytes_used == 0
    assert eng.stats()["requests_timed_out"] == 1
    # it slept the backoff off in slices of at most 50 ms, up to 2 s
    assert clock["sleeps"] >= 40 and 2.0 < clock["t"] < 2.1


# -- quarantine ----------------------------------------------------------------------

def poison(eng, which, row=0):
    """NaN one row of the logits of the first decode step (or prefill
    chunk) through the port's serve steps; the pages themselves are
    clean, so a retried request must reproduce the clean tokens."""
    fns = eng._paged_fns
    fn = getattr(fns, which)
    fired = {"n": 0}

    def call(*a):
        logits = fn(*a)
        if not fired["n"]:
            fired["n"] += 1
            logits[row] = float("nan")
        return logits

    eng._paged_fns = fns._replace(**{which: call})


@pytest.mark.parametrize("which", ["decode", "prefill_chunk"])
def test_quarantine_retires_with_error(smollm, which):
    """A non-finite step retires the poisoned request ``"error"``; its
    pages are dropped and never adopted by the prefix tree, and every
    other request matches the clean run."""
    s = smollm
    clean = outs(port(s).generate(mk_plain(s["vocab"])))
    eng = port(s)
    events = []
    eng.event_sink = events.append
    poison(eng, which)
    done = eng.generate(mk_plain(s["vocab"]))
    assert done[0].finish_reason == "error"
    assert len(done[0].out) < done[0].max_new_tokens
    assert eng.quarantined == 1 and eng.nonfinite_logit_rows == 1
    assert outs(done[1:]) == clean[1:]
    assert [e["phase"] for e in events if e["kind"] == "quarantine"] == [
        "decode" if which == "decode" else "prefill"]
    kc = eng.stats()["kv_cache"]
    assert kc["pages_used"] + kc["pages_free"] == kc["pages_total"]
    # the tree holds the four clean requests' pages, none of the poisoned
    n, pages = eng._radix.match(list(done[0].prompt))
    eng._pool.release(pages)
    assert n == 0
    assert all(eng._radix.match(list(r.prompt))[0] > 0 for r in done[1:])


def test_quarantine_retry_recovers(smollm):
    """retry_errors=True: the quarantined request restarts from scratch
    and, the fault being transient, completes with the clean tokens."""
    s = smollm
    clean = outs(port(s).generate(mk_plain(s["vocab"])))
    eng = port(s, retry_errors=True)
    poison(eng, "decode")
    got = outs(eng.generate(mk_plain(s["vocab"])))
    assert got == clean
    assert eng.quarantined == 1
    assert eng.stats()["preemption"]["resumes"] == 1


# -- watchdog, drain, events --------------------------------------------------------

def test_watchdog_flags_hung_steps(smollm):
    """An impossible per-step budget flags every fenced dispatch as hung:
    detection only (the run completes), counted and emitted; a sink
    that raises does not stop serving."""
    s = smollm
    events = []
    eng = port(s, watchdog_step_timeout_s=1e-9)
    eng.event_sink = events.append
    done = eng.generate(mk_plain(s["vocab"], n_req=2))
    assert all(r.finish_reason == "length" for r in done)
    assert eng.hung_steps > 0
    assert eng.stats()["preemption"]["hung_steps"] == eng.hung_steps
    assert {e["phase"] for e in events} == {"prefill", "decode"}
    assert all(e["kind"] == "hung_step" and "timestamp_s" in e
               for e in events)

    def broken(ev):
        raise RuntimeError("sink down")

    eng.event_sink = broken
    done = eng.generate(mk_plain(s["vocab"], n_req=2))
    assert all(r.finish_reason == "length" for r in done)


def test_drain_checkpoints_and_resumes_like_jax(smollm):
    """drain() mid-run checkpoints every request in flight with
    ``finish_reason`` None; submitting the same objects again resumes
    them (through the tree, one at 24: off the chunk grid) to the
    unpressured tokens, with JAX's resume log."""
    s = smollm

    def drive(eng, attr, fns_attr, cls, replace):
        eng.generate(mk_plain(s["vocab"], cls, n_req=1, seed=1))
        orig = getattr(eng, fns_attr)
        calls = {"n": 0}

        def drain_after_two(*a, **k):
            calls["n"] += 1
            if calls["n"] == 2:
                eng.drain()
            return getattr(orig, attr)(*a, **k) if attr else orig(*a, **k)

        setattr(eng, fns_attr, replace(orig, drain_after_two))
        submitted = mk(s["vocab"], OFF_GRID, cls)
        events = []
        eng.event_sink = events.append
        eng.generate(submitted)
        unfinished = [r for r in submitted if r.finish_reason is None]
        assert unfinished, "drain landed after every request finished"
        assert eng.drains == 1
        assert {e["kind"] for e in events} == {"drain_checkpoint", "drain"}
        setattr(eng, fns_attr, orig)
        eng.generate(unfinished)
        assert all(r.finish_reason == "length" for r in submitted)
        return outs(submitted), [(e["event"], e["rid"], e.get("via"),
                                  e["recovered_tokens"])
                                 for e in eng.preempt_log]

    ej = jax_paged(s, kv_page_size=8)
    want = drive(ej, None, "_paged_prefill_chunk_fn", jax_engine.Request,
                 lambda orig, f: f)
    eng = port(s)
    got = drive(eng, "prefill_chunk", "_paged_fns", Request,
                lambda orig, f: orig._replace(prefill_chunk=f))
    assert got == want
    assert got[0] == outs(port(s).generate(mk(s["vocab"], OFF_GRID)))
    assert any(via == "tree" and rec % 16 for _, _, via, rec in got[1])


# -- exceptions ------------------------------------------------------------------------

class CountingSession:
    """Counts the regions the engine opens and closes."""

    def __init__(self):
        self.open = self.closed = 0

    def region(self, label, tokens=None, nested=True):
        session = self

        class Span:
            def __enter__(self):
                session.open += 1

            def __exit__(self, *exc):
                session.closed += 1

        return Span()


def test_exception_after_a_preemption_releases_everything(smollm):
    """A chunk that raises after a preemption leaks no page, leaves no
    span open and no swap entry of a retired request; the parked victim
    (unfinished) resumes on the next call to the clean tokens."""
    s = smollm
    sess = CountingSession()
    store = PageSwapStore()
    eng = port(s, kv_pool_pages=9, preempt=True, swap_store=store,
               session=sess)
    fns = eng._paged_fns

    def failing(*a, **k):
        if eng.preemptions:
            raise RuntimeError("injected")
        return fns.prefill_chunk(*a, **k)

    eng._paged_fns = fns._replace(prefill_chunk=failing)
    rs = mk(s["vocab"], PRESS)
    with pytest.raises(RuntimeError, match="injected"):
        eng.generate(rs)
    assert sess.open == sess.closed > 1
    st = eng.stats()
    assert st["live_slots"] == 0
    assert st["kv_cache"]["pages_used"] == st["kv_cache"]["prefix_nodes"]
    parked = {r._swap_handle for r in rs if r._swap_handle is not None}
    assert len(store) == len(parked) == 1
    assert all(r.finish_reason is None for r in rs
               if r._swap_handle is not None)
    eng._paged_fns = fns
    eng.generate(rs)
    assert outs(rs) == outs(port(s).generate(mk(s["vocab"], PRESS)))
    assert len(store) == 0 and eng._pool.used_pages == \
        eng.stats()["kv_cache"]["prefix_nodes"]


# -- the swap store and validation ------------------------------------------------------

@settings(max_examples=40, deadline=None, database=None)
@given(hst.lists(hst.tuples(hst.sampled_from(["put", "get", "drop"]),
                            hst.integers(0, 6)), max_size=30),
       hst.integers(0, 400))
def test_swap_store_budget(ops, capacity):
    """Any sequence of puts, gets and drops keeps ``bytes_used`` the sum
    of the held entries' ``nbytes`` and within the budget; the pages
    counters move as the JAX store's do on the same sequence."""
    store, ref = PageSwapStore(capacity), JaxSwapStore(capacity)
    handles, jhandles = [], []
    for op, n in ops:
        if op == "put":
            leaves = [torch.zeros((n, 4), dtype=torch.bfloat16),
                      torch.zeros((n,), dtype=torch.float32)]
            h = store.put(leaves, n)
            jh = ref.put([np.zeros((n, 4), np.float16),
                          np.zeros((n,), np.float32)], n)
            assert (h is None) == (jh is None)
            if h is not None:
                handles.append(h)
                jhandles.append(jh)
        elif handles:
            i = n % len(handles)
            h, jh = handles.pop(i), jhandles.pop(i)
            if op == "get":
                assert sum(t.nbytes for t in store.get(h)) == \
                    sum(a.nbytes for a in ref.get(jh))
            else:
                store.drop(h)
                ref.drop(jh)
        assert store.stats() == ref.stats()
        assert 0 <= store.bytes_used <= capacity
    store.drop(12345)                   # unknown handles are ignored


def test_preempt_validation(smollm):
    s = smollm
    kw = dict(batch_size=2, max_len=64, device="cpu")
    cfg, params = s["cfg"], s["params"]
    with pytest.raises(ValueError, match="preempt"):
        ServeEngine(cfg, params, preempt=True, **kw)
    with pytest.raises(ValueError, match="swap_store"):
        ServeEngine(cfg, params, swap_store=PageSwapStore(), **kw)
    with pytest.raises(ValueError, match="watchdog"):
        ServeEngine(cfg, params, watchdog_step_timeout_s=1.0, **kw)
    with pytest.raises(ValueError, match="watchdog"):
        ServeEngine(cfg, params, kv_layout="paged",
                    watchdog_step_timeout_s=0.0, **kw)
    from repro_torch.serve.governor import PowerGovernor
    gov = PowerGovernor(recorder=None)
    st = ServeEngine(cfg, params, kv_layout="paged", preempt=True,
                     governor=gov, **kw).stats()
    assert st["governor"] == gov.stats() and st["preemption"]["enabled"]
    with pytest.raises(ValueError, match="capacity_bytes"):
        PageSwapStore(-1)
    pre = ServeEngine(cfg, params, **kw).stats()["preemption"]
    assert pre == {"enabled": False, "preemptions": 0, "resumes": 0,
                   "retries_exhausted": 0, "wasted_tokens": 0,
                   "wasted_joules": 0.0, "recovered_tokens": 0,
                   "recovered_joules": 0.0, "quarantined": 0,
                   "hung_steps": 0, "drains": 0}
