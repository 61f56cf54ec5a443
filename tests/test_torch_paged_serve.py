"""The port's paged serve path against the JAX package's.

Reduced smollm-135m in fp32 (activations and pools, so bf16 rounding
cannot flip an argmax), the same weights through ``repro_torch.bridge``.
The paged serve steps must match JAX ``make_paged_serve_fns`` (logits
within 1e-5, pools equal outside the scratch page 0 within 1e-5: fp32
sums in other orders), and the paged engine must generate exactly the
JAX paged engine's tokens and the port's contiguous engine's, with the
same ``stats()["kv_cache"]`` and the same prefix-hit pricing.  The
counterparts of tests/test_serve_paged.py for smollm follow: pool
exhaustion, prefix reuse, isolation, eviction, gauges, validation,
batched admissions.  One JAX engine run is shared by the module.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve import engine as jax_engine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.kernels.cache_update import kernel as cu_kernel  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as da_kernel  # noqa: E402
from repro_torch.kernels.prefill_attention import kernel as pa_kernel  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.swap import PageSwapStore  # noqa: E402

ATOL = 1e-5


class Rec:
    """A resolved record as ``on_record`` reads it."""

    def __init__(self, path, tokens, joules):
        self.path, self.tokens, self.joules = path, tokens, joules


# prefill records fed to both engines between the cold and warm runs
RECORDS = [Rec("serve/req0/prefill", 13, 2.6), Rec("serve/req1", 6, 9.0),
           Rec("serve/req1/prefill", 21, 3.15), Rec("serve/req2/decode", 6,
                                                    1.0),
           Rec("serve/req3/prefill", 0, 1.0), Rec("serve/req4/prefill", 17,
                                                  0.0)]


def mk(vocab, cls=Request, n_req=5, seed=7, max_new=6):
    """tests/test_serve_paged.py's mix."""
    rng = np.random.default_rng(seed)
    plens = [13, 21, 9, 30, 17]
    return [cls(prompt=rng.integers(2, vocab - 1, size=(p,)).tolist(),
                max_new_tokens=max_new)
            for p, _ in zip(plens * 10, range(n_req))]


def outs(rs):
    return [r.out for r in rs]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The serve steps here are tiny: torch's intra-op threads only
    contend, with JAX's and with the other workers of a parallel run.
    Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    cfg_j = dataclasses.replace(
        jax_configs.get_config("smollm-135m", reduced=True),
        dtype="float32", prefill_chunk=16)
    cfg_t = dataclasses.replace(
        port_configs.get_config("smollm-135m", reduced=True),
        dtype="float32", prefill_chunk=16)
    params_j, _ = JM.init_params(jax.random.PRNGKey(0), cfg_j)
    params_t = bridge.params_from_numpy(jax.device_get(params_j), cfg_t,
                                        device="cpu")
    eng = jax_engine.ServeEngine(cfg_j, params_j, batch_size=2, max_len=64,
                                 kv_layout="paged", kv_page_size=8,
                                 cache_dtype=jnp.float32)
    vocab = cfg_t.vocab_size
    cold = outs(eng.generate(mk(vocab, jax_engine.Request)))
    cold_kv = eng.stats()["kv_cache"]
    for rec in RECORDS:
        eng.on_record(rec)
    warm = outs(eng.generate(mk(vocab, jax_engine.Request)))
    return dict(cfg_j=cfg_j, params_j=params_j, cfg=cfg_t, params=params_t,
                vocab=vocab, jax_cold=cold, jax_warm=warm,
                jax_cold_kv=cold_kv, jax_warm_kv=eng.stats()["kv_cache"],
                jax_jpt=eng._prefill_jpt)


def paged(setup, **kw):
    kw.setdefault("kv_page_size", 8)
    return ServeEngine(setup["cfg"], setup["params"], batch_size=2,
                       max_len=64, kv_layout="paged",
                       cache_dtype=torch.float32, device="cpu", **kw)


def contiguous(setup):
    return ServeEngine(setup["cfg"], setup["params"], batch_size=2,
                       max_len=64, cache_dtype=torch.float32, device="cpu")


# -- serve steps --------------------------------------------------------------

def test_paged_serve_fns_match_jax(setup):
    """A shuffled page table, one (B, T) chunk dispatch with rows at their
    own offsets and a passenger (last_idx -1), then a decode step."""
    cfg_j, cfg_t = setup["cfg_j"], setup["cfg"]
    p, ps, b, nb, t = 20, 8, 3, 4, 16
    rng = np.random.default_rng(0)
    table = rng.permutation(np.arange(1, p))[:b * nb].reshape(b, nb) \
        .astype(np.int32)
    toks = rng.integers(2, setup["vocab"], (b, t))
    offs = np.array([0, 8, 3], np.int32)
    last = np.array([15, 9, -1], np.int32)
    cur = np.array([16, 18, 5], np.int32)
    jf = JM.make_paged_serve_fns(cfg_j)
    cj = JM.init_paged_caches(cfg_j, p, ps, dtype=jnp.float32)
    lj, cj = jf.prefill_chunk(setup["params_j"], cj, jnp.asarray(toks),
                              jnp.asarray(offs), jnp.asarray(last),
                              jnp.asarray(table))
    dj, cj = jf.decode(setup["params_j"], cj, jnp.asarray(toks[:, :1]),
                       jnp.asarray(cur), jnp.asarray(table))
    tf = TM.make_paged_serve_fns(cfg_t)
    pt = TM.serving_params(cfg_t, setup["params"], "cpu")
    ct = TM.init_paged_caches(cfg_t, p, ps, torch.float32, "cpu")
    lt = tf.prefill_chunk(pt, ct, torch.as_tensor(toks),
                          torch.as_tensor(offs), torch.as_tensor(last),
                          torch.as_tensor(table))
    np.testing.assert_allclose(np.asarray(lj)[:2], lt.numpy()[:2],
                               atol=ATOL, rtol=0)
    dt = tf.decode(pt, ct, torch.as_tensor(toks[:, :1]),
                   torch.as_tensor(cur), torch.as_tensor(table))
    np.testing.assert_allclose(np.asarray(dj), dt.numpy(), atol=ATOL,
                               rtol=0)
    for leaf in ("k", "v"):
        np.testing.assert_allclose(
            np.asarray(cj["units"]["r0"][leaf])[:, 1:],
            ct["units"]["r0"][leaf].numpy()[:, 1:], atol=ATOL, rtol=0)


# -- engine: tokens and stats ---------------------------------------------------

def test_paged_tokens_equal_jax_paged_and_port_contiguous(setup):
    """Five requests through two slots: slot refills and batched chunk
    admissions; the CPU engine runs the plain versions only."""
    for mod in (cu_kernel, da_kernel, pa_kernel):
        mod.launches = mod.paged_launches = 0
    eng = paged(setup)
    got = outs(eng.generate(mk(setup["vocab"])))
    assert got == setup["jax_cold"]
    assert outs(contiguous(setup).generate(mk(setup["vocab"]))) == got
    assert eng.stats()["kv_cache"] == setup["jax_cold_kv"]
    assert all(getattr(mod, n) == 0 for mod in (cu_kernel, da_kernel,
                                                  pa_kernel)
               for n in ("launches", "paged_launches"))


def test_prefix_warm_equals_cold_and_prices_hits_like_jax(setup):
    """Re-serving the prompts maps cached pages off the radix tree (at
    page 8 and chunk 16 the resume is off the chunk grid), gives the
    cold tokens, and prices the hits from the same records as JAX."""
    eng = paged(setup)
    pools = eng._paged_caches["units"]["r0"]["k"]
    cold = outs(eng.generate(mk(setup["vocab"])))
    kc = eng.stats()["kv_cache"]
    assert kc["prefix_hit_tokens"] == 0 and kc["pages_used"] > 0
    for rec in RECORDS:
        eng.on_record(rec)
    assert eng._prefill_jpt == pytest.approx(setup["jax_jpt"], rel=1e-12)
    warm = outs(eng.generate(mk(setup["vocab"])))
    assert warm == cold == setup["jax_warm"]
    kc = eng.stats()["kv_cache"]
    assert kc["prefix_hit_tokens"] > 0 and kc["prefix_hits"] > 0
    assert kc["saved_prefill_joules"] > 0.0
    assert kc == pytest.approx(setup["jax_warm_kv"], rel=1e-12)
    # the pools persist across generate() calls
    assert eng._paged_caches["units"]["r0"]["k"] is pools


def test_on_record_ignores_what_jax_ignores(setup):
    eng = paged(setup)
    for rec in RECORDS[1:2] + RECORDS[3:]:
        eng.on_record(rec)
    assert eng._prefill_jpt is None


def test_pool_exhaustion_waits(setup):
    """A pool of 9 pages: tests/test_serve_paged.py's mix still gets the
    JAX engine's tokens; with 20 new tokens a request needs 4-7 pages, so
    two rarely fit at once and admissions wait on page frees, and every
    request still gets the contiguous engine's tokens."""
    eng = paged(setup, kv_pool_pages=9)
    assert outs(eng.generate(mk(setup["vocab"]))) == setup["jax_cold"]
    assert eng.stats()["kv_cache"]["pages_total"] == 9
    longer = mk(setup["vocab"], max_new=20)
    ref = outs(contiguous(setup).generate(
        [dataclasses.replace(r) for r in longer]))
    assert outs(eng.generate(longer)) == ref
    assert eng.stats()["kv_cache"]["pool_wait_events"] > 0


def test_prefix_cache_off_is_isolated(setup):
    eng = paged(setup, prefix_cache=False)
    a = outs(eng.generate(mk(setup["vocab"])))
    b = outs(eng.generate(mk(setup["vocab"])))
    assert a == b == setup["jax_cold"]
    kc = eng.stats()["kv_cache"]
    assert kc["prefix_cache"] is False
    assert kc["prefix_hit_tokens"] == 0
    assert kc["pages_used"] == 0
    assert "prefix_hits" not in kc


def test_radix_eviction_under_pool_pressure(setup):
    rng = np.random.default_rng(3)
    rs = [Request(prompt=rng.integers(2, setup["vocab"] - 1,
                                      size=(24,)).tolist(),
                  max_new_tokens=4) for _ in range(6)]
    ref = outs(contiguous(setup).generate(
        [dataclasses.replace(r) for r in rs]))
    eng = paged(setup, kv_pool_pages=8)
    assert outs(eng.generate([dataclasses.replace(r) for r in rs])) == ref
    assert eng.stats()["kv_cache"]["prefix_evictions"] > 0


def test_cache_gauges_consistent(setup):
    eng = paged(setup)
    st = eng.stats()
    assert st["kv_layout"] == "paged"
    kc = st["kv_cache"]
    assert kc["page_size"] == 8
    assert kc["pages_used"] == 0
    assert kc["pages_free"] == kc["pages_total"] == 2 * (64 // 8)
    eng.generate(mk(setup["vocab"], n_req=3))
    kc = eng.stats()["kv_cache"]
    assert kc["pages_used"] + kc["pages_free"] == kc["pages_total"]
    assert kc["pages_used"] == kc["prefix_nodes"]
    assert kc["saved_prefill_joules"] == 0.0
    # every pool leaf, scratch page included, over the usable positions
    assert kc["bytes_per_token"] == pytest.approx(
        2 * setup["cfg"].num_layers * 17 * 8 * setup["cfg"].num_kv_heads
        * setup["cfg"].head_dim * 4 / (16 * 8))


def test_contiguous_engine_reports_no_pool(setup):
    kc = contiguous(setup).stats()["kv_cache"]
    assert kc["cache_dtype"] == "float32" and kc["bytes_per_token"] > 0
    for key in ("pages_total", "prefix_hits", "pool_wait_events"):
        assert key not in kc


def test_paged_validation(setup):
    cfg, params = setup["cfg"], setup["params"]
    kw = dict(batch_size=2, max_len=64, device="cpu")
    with pytest.raises(ValueError, match="kv_layout"):
        ServeEngine(cfg, params, kv_layout="mystery", **kw)
    with pytest.raises(ValueError, match="pool"):
        ServeEngine(cfg, params, kv_layout="paged", kv_page_size=8,
                    kv_pool_pages=7, **kw)
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(cfg, params, kv_layout="paged", mode="wave", **kw)
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(cfg, params, kv_layout="paged", prefill_chunk=0, **kw)
    with pytest.raises(ValueError, match="kv_page_size"):
        ServeEngine(cfg, params, kv_layout="paged", kv_page_size=0, **kw)
    from repro_torch.serve.governor import PowerGovernor
    gov = PowerGovernor(recorder=None, pool_reserve_frac=0.25)
    st = ServeEngine(cfg, params, kv_layout="paged", governor=gov,
                     **kw).stats()
    assert st["governor"] == gov.stats()
    assert st["governor"]["pool_reserve_frac"] == 0.25
    # the preemption plane builds on the paged layout
    eng = ServeEngine(cfg, params, kv_layout="paged", preempt=True,
                      swap_store=PageSwapStore(), **kw)
    assert eng.stats()["preemption"]["enabled"]
    assert eng.stats()["preemption"]["swap"]["entries"] == 0


def test_paged_admission_batching(setup):
    """Both slots admitting at once share each chunk dispatch: fewer
    prefill dispatches than per-request chunks."""
    rng = np.random.default_rng(5)
    rs = [Request(prompt=rng.integers(2, setup["vocab"] - 1,
                                      size=(32,)).tolist(),
                  max_new_tokens=2) for _ in range(4)]
    eng = paged(setup)
    calls = {"n": 0}
    fns = eng._paged_fns

    def counting(*a, **k):
        calls["n"] += 1
        return fns.prefill_chunk(*a, **k)

    eng._paged_fns = fns._replace(prefill_chunk=counting)
    eng.generate(rs)
    solo_chunks = sum(-(-len(r.prompt) // 16) for r in rs)
    assert calls["n"] < solo_chunks
    assert all(len(r.out) == 2 for r in rs)


def test_deadline_releases_pages(setup):
    reqs = mk(setup["vocab"], n_req=2, max_new=40)
    reqs[0].deadline_s = 1e-9
    eng = paged(setup, prefix_cache=False)
    done = eng.generate(reqs)
    assert done[0].finish_reason == "timeout"
    assert done[1].finish_reason == "length" and len(done[1].out) == 40
    assert eng.stats()["kv_cache"]["pages_used"] == 0


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


def test_exception_mid_run_releases_pages_and_spans(setup):
    """A step that raises mid-run leaks neither page references nor open
    spans, and the engine serves the next call as if nothing happened."""
    sess = CountingSession()
    eng = paged(setup, prefix_cache=False, session=sess)
    fns = eng._paged_fns
    calls = {"n": 0}

    def failing(*a, **k):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("injected")
        return fns.prefill_chunk(*a, **k)

    eng._paged_fns = fns._replace(prefill_chunk=failing)
    with pytest.raises(RuntimeError, match="injected"):
        eng.generate(mk(setup["vocab"]))
    assert sess.open == sess.closed > 1
    st = eng.stats()
    assert st["kv_cache"]["pages_used"] == 0 and st["live_slots"] == 0
    eng._paged_fns = fns
    assert outs(eng.generate(mk(setup["vocab"]))) == setup["jax_cold"]


class StepClock:
    """A clock for the dummy sensor that the test drives: it moves 10 ms
    per serve step the engine runs, and not at all between steps, so the
    spans measure device work only and the host's scheduling cannot
    shift joules out of the phases."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def wrap(self, fns):
        def tick(fn):
            def step(*args, **kwargs):
                out = fn(*args, **kwargs)
                self.t += 0.01
                return out
            return step
        return type(fns)(*(tick(fn) for fn in fns))


def test_port_session_phase_joules_sum_to_request_paged(setup):
    """Per-request energy through the port's PMT library on the paged
    engine: every request's ``/prefill`` + ``/decode`` records sum to its
    ``serve/req<N>`` record (5%, as for the contiguous engine), cold and
    warm (the warm prefill spans count only the tokens actually run)."""
    import repro_torch.core as port_pmt
    clk = StepClock()
    with port_pmt.Session([port_pmt.create("dummy", clock=clk)],
                          pool=port_pmt.SensorPool(), period_s=1e6) as sess:
        mem = sess.add_exporter(port_pmt.MemoryExporter())
        eng = paged(setup, session=sess)
        eng._paged_fns = clk.wrap(eng._paged_fns)
        for _ in range(2):
            reqs = mk(setup["vocab"])
            eng.generate(reqs)
        sess.flush()
        per_req = [r for r in mem.records if r.path.startswith("serve/req")
                   and "/" not in r.path.replace("serve/", "")]
        assert len(per_req) == 2 * len(reqs)
        for r in per_req:
            split = sum(p.joules for p in mem.records
                        if p.path.startswith(r.path + "/"))
            assert split == pytest.approx(r.joules, rel=0.05, abs=1e-3)
        prefill = {r.path: r.tokens for r in mem.records
                   if r.path.endswith("/prefill")}
        assert prefill[f"serve/req{reqs[0].id}/prefill"] \
            < len(reqs[0].prompt)                    # a warm prefix hit
        assert sess.stats()["pending"] == 0


def test_serve_launcher_paged_reports_pool_and_energy(capsys):
    from repro_torch.launch import serve as serve_launch
    serve_launch.main(["--reduced", "--device", "cpu", "--kv-layout",
                       "paged", "--kv-page-size", "8", "--requests", "3",
                       "--batch", "2", "--max-new", "3", "--max-len", "32"])
    out = capsys.readouterr().out
    assert "energy (cpuutil): " in out and " J/token" in out
    assert "kv pool: " in out and "8 tokens/page" in out
    assert "prefix cache: " in out


def test_serve_launcher_preemption_flags(capsys):
    """The launcher's preemption flags reach the engine, and it prints
    the ``preemption`` block: 12 pages hold two of the three requests
    (6 pages each), so the third, arriving while the shortest prompt
    decodes and the longest still prefills in chunks of 8, preempts it
    into the swap store."""
    from repro_torch.launch import serve as serve_launch
    serve_launch.main(["--reduced", "--device", "cpu", "--kv-layout",
                       "paged", "--kv-page-size", "8", "--kv-pool-blocks",
                       "12", "--prefill-chunk", "8", "--requests", "3",
                       "--batch", "3", "--max-new", "20", "--max-len", "64",
                       "--preempt", "--preempt-max-retries", "4",
                       "--retry-backoff-s", "0", "--swap-bytes",
                       str(1 << 20), "--retry-errors",
                       "--watchdog-step-timeout-s", "1e-9"])
    out = capsys.readouterr().out
    line = [x for x in out.splitlines() if x.startswith("preemption: ")]
    assert len(line) == 1
    assert line[0].startswith("preemption: 1 preempted, 1 resumed ")
    assert " 0 retries exhausted, 0 quarantined, " in line[0]
    assert "0 hung steps" not in line[0] and " hung steps" in line[0]
    assert "; swap: 3 pages out / 3 in, 0 B held, 0 rejected" in line[0]
    assert out.count(" -> 20 tokens (length)") == 3
