"""The port's serve baselines against the JAX package's: whole-prompt
prefill, blocking bucketed admission (``prefill_chunk=0``), waves
(``mode="wave"``), sampled decoding and the dense decode attention.

Reduced smollm-135m in fp32 with fp32 caches on both sides (bf16 and
int8 caches where a test says so), the JAX tree carried over by
``repro_torch.bridge``.  Tolerances:

  * prefill logits and cache leaves within 1e-5 absolute: fp32 through
    the same layers, sums in other orders (as tests/test_torch_model.py
    holds the other serve steps); quantized caches' codes and scales
    bit for bit, since both sides quantize the same k and v rows, which
    ``prefill_kv_cache`` gets as arrays equal to the last bit here;
  * the engines' greedy tokens equal the JAX engines' on ``MIXED``
    (tests/test_torch_engine.py); the JAX engine's decode on the CPU is
    its dense attend, which the port's flash and dense decode both match;
  * sampling cannot follow JAX's PRNG streams, so it is held to
    determinism per seed, as tests/test_serve_chunked.py holds the JAX
    engine's.

One JAX engine run per mode is shared by the module.
"""
import contextlib
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve import engine as jax_engine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.models import attention as PA  # noqa: E402
from repro_torch.models import model as PM  # noqa: E402
from repro_torch.serve import engine as port_engine_mod  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

MIXED = [([1, 2, 3], 8), ([4, 5], 3), ([6], 1),
         ([7, 8, 9, 10, 11, 12, 13, 14, 15], 5), ([2], 12),
         ([3, 1, 4, 1, 5], 2), ([9, 9], 7)]
ATOL = 1e-5
MAX_LEN = 64


def mk(reqs, cls=Request):
    return [cls(prompt=list(p), max_new_tokens=n) for p, n in reqs]


def _cfg(module, **kw):
    return dataclasses.replace(module.get_config("smollm-135m", reduced=True),
                               dtype="float32", **kw)


def _jax_tokens(cfg_j, params_j, **kw):
    kw.setdefault("cache_dtype", jnp.float32)
    eng = jax_engine.ServeEngine(cfg_j, params_j, batch_size=3,
                                 max_len=MAX_LEN, **kw)
    done = eng.generate(mk(MIXED, jax_engine.Request))
    return [r.out for r in done], eng


@pytest.fixture(scope="module")
def setup():
    cfg_j = _cfg(jax_configs)
    params_j, _ = JM.init_params(jax.random.PRNGKey(0), cfg_j)
    tree = jax.device_get(params_j)
    cfg_t = _cfg(port_configs)
    blocking, eng0 = _jax_tokens(cfg_j, params_j, prefill_chunk=0)
    wave, _ = _jax_tokens(cfg_j, params_j, mode="wave")
    return dict(cfg_j=cfg_j, params_j=params_j, tree=tree, cfg=cfg_t,
                params=bridge.params_from_numpy(tree, cfg_t, device="cpu"),
                blocking=blocking, blocking_stalls=len(eng0.stall_events),
                wave=wave)


def port_engine(setup, batch=3, **kw):
    kw.setdefault("cache_dtype", torch.float32)
    return ServeEngine(setup["cfg"], setup["params"], batch_size=batch,
                       max_len=MAX_LEN, device="cpu", **kw)


def _close(a, b, atol=ATOL) -> None:
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               b.float().numpy(), rtol=0, atol=atol)


# -- whole-prompt prefill -------------------------------------------------------

@pytest.mark.parametrize("impl,s", [("dense", 8), ("dense", 16),
                                    ("pallas", 16)])
def test_prefill_matches_jax(setup, impl, s):
    """Last logits and every cache leaf of ``ServeFns.prefill`` against
    JAX ``make_serve_fns(cfg).prefill`` at two buckets under the dense
    attend, and under "pallas": the port's flash op (its plain version on
    the CPU) against the JAX kernel in interpret mode."""
    cfg_j = dataclasses.replace(setup["cfg_j"], attn_impl=impl)
    cfg_t = dataclasses.replace(setup["cfg"], attn_impl=impl)
    params_j = setup["params_j"]
    toks = np.random.default_rng(s).integers(0, cfg_t.vocab_size, (2, s))
    jl, jc = jax.jit(JM.make_serve_fns(cfg_j, cache_dtype=jnp.float32)
                     .prefill, static_argnums=2)(
        params_j, {"tokens": jnp.asarray(toks, jnp.int32)}, 24)
    tl, tc = PM.make_serve_fns(cfg_t, cache_dtype=torch.float32).prefill(
        setup["params"], {"tokens": torch.as_tensor(toks)}, 24)
    assert tl.shape == (2, cfg_t.vocab_size)
    _close(jl, tl)
    jleaves, tleaves = jax.tree.leaves(jc), tree_leaves(tc)
    assert len(jleaves) == len(tleaves) == 2
    for j, t in zip(jleaves, tleaves):
        assert j.shape == tuple(t.shape) and t.dtype == torch.float32
        _close(j, t)
        assert not t[:, :, s:].any()            # the slots past the prompt


def _kv(b, s, kvh, hd, seed):
    rng = np.random.default_rng(seed)
    return [(3 * rng.standard_normal((b, s, kvh, hd))).astype(np.float32)
            for _ in range(2)]


def _as_np(x: torch.Tensor) -> np.ndarray:
    if x.element_size() == 1:                   # codes through their bytes
        return x.view(torch.uint8).numpy()
    return x.float().numpy()


def _jax_np(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.uint8) if x.dtype.itemsize == 1 else \
        x.astype(np.float32)


@pytest.mark.parametrize("store,rows", [
    ("float32", "float32"), ("bfloat16", "float32"), ("bfloat16", "bfloat16"),
    ("int8", "float32"), ("int8", "bfloat16"), ("fp8_e4m3", "float32"),
    ("fp8_e4m3", "bfloat16")])
@pytest.mark.parametrize("window,s", [(None, 13), (8, 20), (8, 6)])
def test_prefill_kv_cache_matches_jax(setup, store, rows, window, s):
    """A layer's cache from a prefill's k and v, bit for bit: the slice
    copy at slot 0 (a cast to bf16 rounds to nearest even on both
    sides), the quantizing write, and the ring branch (window 8 under a
    20-token prompt: the last 8 positions, position p at slot p % 8);
    window 8 over 6 tokens is no ring."""
    mode = store if store in ("int8", "fp8_e4m3") else None
    cfg_j = dataclasses.replace(setup["cfg_j"], kv_quant=mode)
    cfg_t = dataclasses.replace(setup["cfg"], kv_quant=mode)
    k, v = _kv(2, s, cfg_t.num_kv_heads, cfg_t.head_dim, seed=s)
    dtypes = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}
    # a quantized cache's ``dtype`` names only the unquantized layout
    jdt, tdt = dtypes["bfloat16" if mode else store]
    rj, rt = dtypes[rows]
    kj, vj = (jnp.asarray(x).astype(rj) for x in (k, v))
    kt, vt = (torch.as_tensor(x).to(rt) for x in (k, v))
    want = JA.prefill_kv_cache(cfg_j, kj, vj, 24, window=window, dtype=jdt)
    got = PA.prefill_kv_cache(cfg_t, kt, vt, 24, window=window, dtype=tdt)
    assert sorted(want) == sorted(got)
    for name in want:
        w, g = _jax_np(want[name]), _as_np(got[name])
        assert w.shape == g.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_prefill_kv_cache_refuses_an_overlong_prompt(setup):
    cfg = setup["cfg"]
    k, v = (torch.zeros(1, 30, cfg.num_kv_heads, cfg.head_dim)
            for _ in range(2))
    with pytest.raises(ValueError, match="exceeds"):
        PA.prefill_kv_cache(cfg, k, v, 24)


# -- blocking admission and waves ---------------------------------------------------

def test_blocking_tokens_equal_jax_engine(setup):
    eng = port_engine(setup, prefill_chunk=0)
    done = eng.generate(mk(MIXED))
    assert [r.out for r in done] == setup["blocking"]
    assert all(r.finish_reason == "length" for r in done)
    assert len(eng.stall_events) == setup["blocking_stalls"] > 0
    assert eng.stats()["mode"] == "continuous"


def test_wave_tokens_equal_jax_engine(setup):
    eng = port_engine(setup, mode="wave")
    done = eng.generate(mk(MIXED))
    assert [r.out for r in done] == setup["wave"]
    assert [len(r.out) for r in done] == [n for _, n in MIXED]
    assert eng.stats()["mode"] == "wave"
    assert eng.stats()["requests_admitted"] == 0    # as the JAX waves


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


def test_wave_region_counts_generated_tokens(setup):
    """One wave of 2 requests (2 and 6 new tokens): its region counts 8
    generated tokens, not batch x steps = 12 (tests/test_serve_continuous.py)."""
    sess = FakeSession()
    eng = port_engine(setup, batch=2, mode="wave", session=sess)
    eng.generate(mk([([1, 2], 2), ([3], 6)]))
    assert [(s["label"], s["tokens"]) for s in sess.spans] \
        == [("serve/wave0", 8)]
    eng.generate(mk([([1, 2], 2), ([3], 6), ([4], 1)]))     # two waves
    assert [(s["label"], s["tokens"]) for s in sess.spans[1:]] \
        == [("serve/wave1", 8), ("serve/wave2", 1)]


def test_blocking_spans_tile_each_request(setup):
    reqs = mk(MIXED[:5])
    sess = FakeSession()
    port_engine(setup, batch=2, prefill_chunk=0, session=sess).generate(reqs)
    by = {s["label"]: s for s in sess.spans}
    assert [s["tokens"] for s in sess.spans
            if s["label"].startswith("serve/batch")] \
        == [sum(r.max_new_tokens for r in reqs)]
    for r in reqs:
        req, pre, dec = (by[f"serve/req{r.id}{x}"]
                         for x in ("", "/prefill", "/decode"))
        assert (pre["tokens"], dec["tokens"]) == (len(r.prompt),
                                                  r.max_new_tokens)
        assert req["t0"] <= pre["t0"] <= pre["t1"] <= dec["t0"] \
            <= dec["t1"] <= req["t1"]


def test_blocking_records_stall_events(setup):
    """As tests/test_serve_chunked.py: one whole-prompt stall per
    admission that finds the batch decoding."""
    reqs = [(list(range(1, 7)), 10), ([3, 2], 2), (list(range(1, 17)), 6)]
    eng = port_engine(setup, batch=2, prefill_chunk=0)
    eng.generate(mk(reqs))
    assert 1 <= len(eng.stall_events) <= 2
    assert all(s >= 0 for s in eng.stall_events)
    assert eng.stats()["pending_prefill_chunks"] == 0


def _messages(fn_port, fn_jax):
    with pytest.raises(ValueError) as got:
        fn_port()
    with pytest.raises(ValueError) as want:
        fn_jax()
    return str(got.value), str(want.value)


def test_capacity_checks_and_messages_are_jax(setup):
    """Blocking: bucket + max_new_tokens <= max_len + 1 (9 tokens bucket
    to 16, 16 + 2 > 17); a wave: the shared bucket + its most steps; a
    wave refuses deadlines.  Each message is the JAX engine's."""
    cfg_j, params_j = setup["cfg_j"], setup["params_j"]

    def both(kw, reqs, max_len=16):
        port = ServeEngine(setup["cfg"], setup["params"], batch_size=2,
                           max_len=max_len, device="cpu", **kw)
        jx = jax_engine.ServeEngine(cfg_j, params_j, batch_size=2,
                                    max_len=max_len, **kw)
        return _messages(lambda: port.generate(mk(reqs)),
                         lambda: jx.generate(mk(reqs, jax_engine.Request)))

    got, want = both(dict(prefill_chunk=0), [([1] * 9, 2)])
    assert got == want and "cache slots" in got
    # each fits alone (8 + 9, 16 + 1), the wave does not (16 + 9)
    got, want = both(dict(mode="wave"), [([1] * 9, 1), ([1], 9)])
    assert got == want and "wave needs 25 cache slots" in got
    reqs = mk([([1], 2)])
    reqs[0].deadline_s = 5.0
    jreqs = mk([([1], 2)], jax_engine.Request)
    jreqs[0].deadline_s = 5.0
    got, want = _messages(
        lambda: port_engine(setup, mode="wave").generate(reqs),
        lambda: jax_engine.ServeEngine(cfg_j, params_j, batch_size=1,
                                       max_len=16, mode="wave")
        .generate(jreqs))
    assert got == want and "continuous mode" in got
    with pytest.raises(ValueError, match="serve mode"):
        port_engine(setup, mode="burst")
    for kw in (dict(mode="wave"), dict(prefill_chunk=0)):
        with pytest.raises(ValueError, match="paged KV requires"):
            port_engine(setup, kv_layout="paged", kv_page_size=8, **kw)


@pytest.mark.parametrize("plen", [1, 2, 7, 8, 9, 16, 17, 100, 1000, 1024])
@pytest.mark.parametrize("min_bucket", [1, 8, 16])
def test_prompt_bucket_equals_jax(plen, min_bucket):
    got = port_engine_mod.prompt_bucket(plen, min_bucket)
    assert got == jax_engine.prompt_bucket(plen, min_bucket)
    assert got >= max(plen, min_bucket) and got & (got - 1) == 0


def test_prompt_bucket_checks():
    with pytest.raises(ValueError, match="power of two"):
        port_engine_mod.prompt_bucket(5, 6)
    with pytest.raises(ValueError, match="power of two"):
        port_engine_mod.prompt_bucket(5, 0)
    with pytest.raises(ValueError, match="empty prompt"):
        port_engine_mod.prompt_bucket(0)


# -- dense decode --------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_dense(setup):
    """The JAX chunked engine (its decode on the CPU is the dense attend)
    with bf16 and int8 caches."""
    return {name: _jax_tokens(setup["cfg_j"], setup["params_j"],
                              prefill_chunk=4, cache_dtype=name)[0]
            for name in ("bfloat16", "int8")}


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "int8"])
def test_dense_decode_tokens_equal_jax_and_flash(setup, jax_dense,
                                                 cache_dtype):
    runs = {impl: [r.out for r in port_engine(
        setup, prefill_chunk=4, cache_dtype=cache_dtype,
        decode_attn_impl=impl).generate(mk(MIXED))]
        for impl in ("dense", "flash")}
    assert runs["dense"] == runs["flash"] == jax_dense[cache_dtype]


@pytest.mark.parametrize("mode", [None, "int8"])
def test_dense_decode_step_matches_flash(setup, mode):
    """One decode step at per-row positions (one row past its cache, the
    garbage row of a retired slot), dense against flash: logits within
    1e-5, and the first layer's caches equal (the write is the scatter for
    both; later layers' k and v follow the attention outputs, which
    differ in the last bits)."""
    cfg = dataclasses.replace(setup["cfg"], kv_quant=mode)
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (3, 12)))
    out = {}
    for impl in ("dense", "flash"):
        c = dataclasses.replace(cfg, decode_attn_impl=impl)
        fns = PM.make_serve_fns(c, cache_dtype=torch.float32)
        _, caches = fns.prefill(setup["params"], {"tokens": toks}, 16)
        logits = fns.decode(setup["params"], caches, toks[:, :1],
                            torch.tensor([12, 12, 40], dtype=torch.int32))
        out[impl] = (logits, caches)
    torch.testing.assert_close(out["dense"][0], out["flash"][0], rtol=0,
                               atol=ATOL)
    for a, b in zip(tree_leaves(out["dense"][1]),
                    tree_leaves(out["flash"][1])):
        np.testing.assert_array_equal(_as_np(a[0]), _as_np(b[0]))


def test_decode_attn_impl_resolution(setup):
    from repro_torch.models import blocks as PB
    for impl, want in (("auto", "flash"), ("flash", "flash"),
                       ("dense", "dense")):
        cfg = dataclasses.replace(setup["cfg"], decode_attn_impl=impl)
        assert PB.decode_attn_impl(cfg) == want
    with pytest.raises(ValueError, match="decode_attn_impl"):
        PB.decode_attn_impl(dataclasses.replace(setup["cfg"],
                                                decode_attn_impl="paged"))
    eng = port_engine(setup, decode_attn_impl="dense")
    assert eng.cfg.decode_attn_impl == "dense"


# -- sampling ------------------------------------------------------------------------

SAMPLED = [(list(range(1, 7)), 12), ([3, 2], 10)]


@pytest.mark.parametrize("kw", [
    dict(prefill_chunk=4), dict(prefill_chunk=0), dict(mode="wave"),
    dict(prefill_chunk=4, kv_layout="paged", kv_page_size=8)],
    ids=["chunked", "blocking", "wave", "paged"])
def test_sampling_deterministic_per_seed(setup, kw):
    """As tests/test_serve_chunked.py: a seed repeats its tokens exactly,
    another seed gives others, and sampling is not the argmax stream."""
    def run(**extra):
        eng = port_engine(setup, batch=2, **kw, **extra)
        return [r.out for r in eng.generate(mk(SAMPLED))]

    greedy = run()
    s0a = run(greedy=False, temperature=1.5, seed=0)
    s0b = run(greedy=False, temperature=1.5, seed=0)
    s1 = run(greedy=False, temperature=1.5, seed=1)
    assert s0a == s0b
    assert s0a != s1
    assert s0a != greedy
    assert all(len(o) == n for o, (_, n) in zip(s0a, SAMPLED))
    assert all(0 <= t < setup["cfg"].vocab_size for o in s0a for t in o)


def test_sampling_needs_a_temperature_and_greedy_draws_nothing(setup):
    with pytest.raises(ValueError, match="temperature"):
        port_engine(setup, greedy=False, temperature=0.0)
    eng = port_engine(setup)
    assert eng._gen is None
    logits = torch.randn(4, 9)
    assert torch.equal(eng._pick(logits), logits.argmax(dim=-1))
    # a sharp distribution samples its mode; the generator moves on
    hot = port_engine(setup, greedy=False, temperature=1e-3, seed=5)
    state = hot._gen.get_state()
    assert torch.equal(hot._pick(logits), logits.argmax(dim=-1))
    assert not torch.equal(hot._gen.get_state(), state)


# -- the launcher ----------------------------------------------------------------------

@pytest.mark.parametrize("flags,mode", [
    (["--mode", "wave"], "wave"),
    (["--prefill-chunk", "0", "--request-deadline-s", "60"], "continuous"),
    (["--temperature", "1.5"], "continuous"),
    (["--decode-attn-impl", "dense", "--prefill-chunk", "0"], "continuous")],
    ids=["wave", "blocking", "sampled", "dense"])
def test_serve_launcher_modes(capsys, flags, mode):
    from repro_torch.launch import serve as serve_launch
    serve_launch.main(["--reduced", "--device", "cpu", "--requests", "3",
                       "--batch", "2", "--max-new", "3", "--max-len", "32",
                       *flags])
    out = capsys.readouterr().out
    assert f"[{mode}]" in out
    assert "stall p95 " in out
    assert "energy (cpuutil): " in out and " J/token" in out
    if mode == "continuous":
        assert "per-request spans: 3 (token sum 9)" in out
    if "--request-deadline-s" in flags:
        assert "0 timed out" in out
