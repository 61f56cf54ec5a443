"""The port's continuous-batching engine against the JAX engine.

Reduced smollm-135m, fp32 activations and fp32 caches on both sides (so
that bf16 rounding of the caches cannot flip an argmax), the same
weights through ``repro_torch.bridge``: the port's greedy tokens must
equal the JAX engine's on the ``MIXED`` mix of
tests/test_serve_continuous.py, whatever the slot count or queue order
(slot refill leaks no KV).  One JAX engine run is shared by the module.
"""
import contextlib
import dataclasses
import time

import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

import repro.core as pmt  # noqa: E402
from repro import configs as jax_configs  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve import engine as jax_engine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.kernels.cache_update import kernel as cu_kernel  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as da_kernel  # noqa: E402
from repro_torch.kernels.prefill_attention import kernel as pa_kernel  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

MIXED = [([1, 2, 3], 8), ([4, 5], 3), ([6], 1),
         ([7, 8, 9, 10, 11, 12, 13, 14, 15], 5), ([2], 12),
         ([3, 1, 4, 1, 5], 2), ([9, 9], 7)]


def mk(reqs, cls=Request):
    return [cls(prompt=list(p), max_new_tokens=n) for p, n in reqs]


@pytest.fixture(scope="module")
def setup():
    cfg_j = dataclasses.replace(
        jax_configs.get_config("smollm-135m", reduced=True), dtype="float32")
    cfg_t = dataclasses.replace(
        port_configs.get_config("smollm-135m", reduced=True), dtype="float32")
    params_j, _ = JM.init_params(jax.random.PRNGKey(0), cfg_j)
    tree = jax.device_get(params_j)
    params_t = bridge.params_from_numpy(tree, cfg_t, device="cpu")
    eng = jax_engine.ServeEngine(cfg_j, params_j, batch_size=3, max_len=64,
                                 cache_dtype=jnp.float32)
    done = eng.generate(mk(MIXED, jax_engine.Request))
    return dict(cfg=cfg_t, params=params_t, jax_out=[r.out for r in done],
                jax_stats=eng.stats())


def port_engine(setup, batch, **kw):
    kw.setdefault("cache_dtype", torch.float32)
    return ServeEngine(setup["cfg"], setup["params"], batch_size=batch,
                       max_len=64, device="cpu", **kw)


def test_greedy_tokens_equal_jax_engine(setup):
    """Three slots for seven requests: every slot refills at least once."""
    for mod in (cu_kernel, da_kernel, pa_kernel):
        mod.launches = 0
    done = port_engine(setup, 3).generate(mk(MIXED))
    assert [r.out for r in done] == setup["jax_out"]
    assert [len(r.out) for r in done] == [n for _, n in MIXED]
    assert all(r.finish_reason == "length" for r in done)
    # the CPU engine ran the plain versions only
    assert (cu_kernel.launches, da_kernel.launches, pa_kernel.launches) \
        == (0, 0, 0)


def test_slot_count_and_queue_order_do_not_change_tokens(setup):
    eng = port_engine(setup, 2, prefill_chunk=4)
    fwd = {tuple(r.prompt): r.out for r in eng.generate(mk(MIXED))}
    rev = {tuple(r.prompt): r.out
           for r in eng.generate(mk(list(reversed(MIXED))))}
    assert fwd == rev
    assert [fwd[tuple(p)] for p, _ in MIXED] == setup["jax_out"]


def test_stats_keys_equal_jax_engine(setup):
    eng = port_engine(setup, 3)
    eng.generate(mk(MIXED[:2]))
    ours, theirs = eng.stats(), setup["jax_stats"]
    assert sorted(ours) == sorted(theirs)
    for key in ("kv_cache", "preemption", "compile_counts"):
        assert sorted(ours[key]) == sorted(theirs[key])
    assert ours["kv_cache"] == theirs["kv_cache"]
    assert ours["requests_admitted"] == 2
    assert ours["compile_counts"] == {"prefill": 0, "decode": 0,
                                      "prefill_chunk": 0}


class FakeSession:
    """Records every region the engine opens: label, tokens, nesting and
    its open/close times."""

    def __init__(self):
        self.spans = []

    @contextlib.contextmanager
    def region(self, label, tokens=None, nested=True):
        rec = {"label": label, "tokens": tokens, "nested": nested,
               "t0": time.perf_counter()}
        yield
        rec["t1"] = time.perf_counter()
        self.spans.append(rec)


def test_per_request_spans_tile_the_request(setup):
    reqs = mk(MIXED[:5])
    total = sum(r.max_new_tokens for r in reqs)
    sess = FakeSession()
    port_engine(setup, 2, session=sess).generate(reqs)
    by = {s["label"]: s for s in sess.spans}
    assert [s["tokens"] for s in sess.spans
            if s["label"].startswith("serve/batch")] == [total]
    per_req = [s for lab, s in by.items()
               if lab.startswith("serve/req") and lab.count("/") == 1]
    assert len(per_req) == len(reqs)
    assert sum(s["tokens"] for s in per_req) == total
    for r in reqs:
        req = by[f"serve/req{r.id}"]
        pre = by[f"serve/req{r.id}/prefill"]
        dec = by[f"serve/req{r.id}/decode"]
        assert not (req["nested"] or pre["nested"] or dec["nested"])
        assert (pre["tokens"], dec["tokens"]) == (len(r.prompt),
                                                  r.max_new_tokens)
        assert req["t0"] <= pre["t0"] <= pre["t1"] <= dec["t0"] \
            <= dec["t1"] <= req["t1"]


class StepClock:
    """A clock for the dummy sensor that the test drives: it moves 10 ms
    per serve step the engine runs, and not at all between steps, so the
    spans measure device work only and the host's scheduling (an xdist
    worker descheduled between one span's close and the next one's
    open) cannot shift joules out of the phases."""

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


def test_real_session_phase_joules_sum_to_request(setup):
    """The same accounting through a PMT ``Session`` on the dummy
    backend, as tests/test_serve_continuous.py holds the JAX engine."""
    reqs = mk(MIXED[:4])
    clk = StepClock()
    with pmt.Session([pmt.create("dummy", clock=clk)],
                     pool=pmt.SensorPool(), period_s=1e6) as sess:
        mem = sess.add_exporter(pmt.MemoryExporter())
        eng = port_engine(setup, 2, session=sess)
        eng._fns = clk.wrap(eng._fns)
        eng.generate(reqs)
        sess.flush()
        per_req = [r for r in mem.records if r.path.startswith("serve/req")
                   and "/" not in r.path.replace("serve/", "")]
        assert len(per_req) == len(reqs)
        for r in per_req:
            split = sum(p.joules for p in mem.records
                        if p.path.startswith(r.path + "/"))
            assert split == pytest.approx(r.joules, rel=0.05, abs=1e-3)
        assert sess.stats()["pending"] == 0


def test_port_session_phase_joules_sum_to_request(setup):
    """The same accounting through the port's own PMT library
    (``repro_torch.core``), which the port's launchers use."""
    import repro_torch.core as port_pmt
    reqs = mk(MIXED[:4])
    clk = StepClock()
    with port_pmt.Session([port_pmt.create("dummy", clock=clk)],
                          pool=port_pmt.SensorPool(), period_s=1e6) as sess:
        mem = sess.add_exporter(port_pmt.MemoryExporter())
        eng = port_engine(setup, 2, session=sess)
        eng._fns = clk.wrap(eng._fns)
        eng.generate(reqs)
        sess.flush()
        per_req = [r for r in mem.records if r.path.startswith("serve/req")
                   and "/" not in r.path.replace("serve/", "")]
        assert len(per_req) == len(reqs)
        for r in per_req:
            split = sum(p.joules for p in mem.records
                        if p.path.startswith(r.path + "/"))
            assert split == pytest.approx(r.joules, rel=0.05, abs=1e-3)
        assert sess.stats()["pending"] == 0


def test_deadline_retires_with_timeout(setup):
    reqs = mk([([1, 2, 3], 40)])
    reqs[0].deadline_s = 1e-9
    done = port_engine(setup, 1).generate(reqs)
    assert done[0].finish_reason == "timeout"


def test_request_validation_and_later_slices_raise(setup):
    eng = port_engine(setup, 1)
    with pytest.raises(ValueError, match="cache slots"):
        eng.generate(mk([([1] * 60, 10)]))
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.generate(mk([([1], 0)]))
    # the baselines serve: waves, sampling, blocking admission
    for kw in (dict(mode="wave"), dict(greedy=False, temperature=1.5),
               dict(prefill_chunk=0)):
        done = port_engine(setup, 1, **kw).generate(mk([([1, 2], 3)]))
        assert [len(r.out) for r in done] == [3]
    for kw in (dict(governor=object()), dict(preempt=True),
               dict(swap_store=object())):
        with pytest.raises(NotImplementedError):
            port_engine(setup, 1, **kw)
    with pytest.raises(ValueError, match="int4"):
        port_engine(setup, 1, cache_dtype="int4")


def test_engine_needs_a_card_unless_cpu_is_asked(setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(setup["cfg"], setup["params"], batch_size=1, max_len=8)


def test_serve_launcher_reports_energy_through_pmt(capsys):
    """``launch/serve.py`` measures through a ``repro_torch.core`` session
    (``["cpuutil"]`` on the CPU) and prints the JAX launcher's report:
    aggregate J/token and the costliest request's prefill/decode split."""
    from repro_torch.launch import serve as serve_launch
    serve_launch.main(["--reduced", "--device", "cpu", "--requests", "3",
                       "--batch", "2", "--max-new", "3", "--max-len", "32"])
    out = capsys.readouterr().out
    assert "energy (cpuutil): " in out and " J/token" in out
    assert "per-request spans: 3 (token sum 9); costliest serve/req" in out
    assert " J prefill / " in out and " J decode)" in out
