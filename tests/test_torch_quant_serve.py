"""The port's quantized KV caches (int8, fp8_e4m3) through the serve
stack, against the JAX package's, on the same weights.

Reduced smollm-135m in fp32, the JAX tree carried over by
``repro_torch.bridge``.  Tolerances:

  * serve-step logits within 1e-5 absolute, as the unquantized steps
    (tests/test_torch_model.py): fp32 through the same layers, sums in
    other orders (measured ~6e-7 here);
  * scales within 1e-6 relative: each is the row's absmax times 1/qmax,
    so it moves with the k/v row's own ~1e-7 relative difference;
  * codes equal, apart from codes one step apart where a value sits on a
    rounding boundary and the two sides' k/v differ in the last bit;
    each test counts those and allows at most 0.5% of the codes (the
    seeds here give 0);
  * the engine's greedy tokens equal the JAX engine's, contiguous equal
    to paged, and ``stats()["kv_cache"]`` equal to the JAX engine's.

The logit-drift gate of tests/test_quant_serve.py holds for the port's
quantized decode against its fp32 cache: under 0.10 (int8) and 0.20
(fp8_e4m3) of the larger of max |logit| and 1.
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
from repro_torch.models import model as PM  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

MODES = ("int8", "fp8_e4m3")
ATOL = 1e-5
SCALE_RTOL = 1e-6
MAX_FLIP_SHARE = 0.005
DRIFT_GATE = {"int8": 0.10, "fp8_e4m3": 0.20}
PROMPTS = [[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8], [1, 1, 2, 3, 5]]
COUNTERS = ("launches", "paged_launches", "quant_launches",
            "quant_paged_launches")


def _cfg(module, mode=None):
    return dataclasses.replace(module.get_config("smollm-135m", reduced=True),
                               dtype="float32", kv_quant=mode)


def jax_run(cfg, params, cache_dtype, layout, **kw):
    kw = dict(kv_page_size=8, **kw) if layout == "paged" else kw
    eng = jax_engine.ServeEngine(cfg, params, batch_size=2, max_len=48,
                                 prefill_chunk=8, kv_layout=layout,
                                 cache_dtype=cache_dtype, **kw)
    done = eng.generate([jax_engine.Request(prompt=p, max_new_tokens=6)
                         for p in PROMPTS])
    return [r.out for r in done], eng.stats()["kv_cache"]


@pytest.fixture(scope="module")
def setup():
    cfg_j = _cfg(jax_configs)
    params_j, _ = JM.init_params(jax.random.PRNGKey(0), cfg_j)
    tree = jax.device_get(params_j)
    cfg_t = _cfg(port_configs)
    jax_runs = {(m, lay): jax_run(cfg_j, params_j, m, lay)
                for m in MODES for lay in ("contiguous", "paged")}
    return dict(cfg_j=cfg_j, tree=tree, cfg=cfg_t,
                params=bridge.params_from_numpy(tree, cfg_t, device="cpu"),
                jax=jax_runs)


def port_engine(setup, cache_dtype, layout, **kw):
    if layout == "paged":
        kw = dict(kv_layout="paged", kv_page_size=8, **kw)
    return ServeEngine(setup["cfg"], setup["params"], batch_size=2,
                       max_len=48, prefill_chunk=8, cache_dtype=cache_dtype,
                       device="cpu", **kw)


def ordinals(x) -> np.ndarray:
    """Codes as integers in value order: int8 as is; fp8_e4m3 as its
    sign-magnitude byte, so that neighbouring values differ by 1."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.uint8).numpy() if x.element_size() == 1 \
            and x.dtype != torch.int8 else x.numpy()
    a = np.asarray(x)
    if a.dtype.name == "float8_e4m3fn":
        a = a.view(np.uint8)
    if a.dtype == np.uint8:
        mag = (a & 0x7F).astype(np.int32)
        return np.where(a & 0x80, -mag, mag)
    return a.astype(np.int32)


def assert_leaves(jc, pc, skip_page0=False):
    """Codes equal or one step apart (at most MAX_FLIP_SHARE of them),
    scales within SCALE_RTOL.  Returns the count of one-step codes."""
    flips = 0
    for name in ("k", "v"):
        a, b = ordinals(jc[name]), ordinals(pc[name])
        s, t = np.asarray(jc[f"{name}_scale"]), pc[f"{name}_scale"].numpy()
        if skip_page0:
            a, b, s, t = a[:, 1:], b[:, 1:], s[:, 1:], t[:, 1:]
        d = np.abs(a - b)
        assert d.max() <= 1, f"{name}: codes {d.max()} steps apart"
        flips += int((d == 1).sum())
        assert flips <= MAX_FLIP_SHARE * a.size
        np.testing.assert_allclose(s, t, rtol=SCALE_RTOL, atol=0)
    return flips


# -- serve steps -------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_quant_serve_steps_match_jax(setup, mode):
    """Two chunks (the second right-padded) then three decode steps with
    per-row positions: logits, codes and scales agree with JAX at every
    step (0 codes one step apart at this seed)."""
    cfg_j = dataclasses.replace(setup["cfg_j"], kv_quant=mode)
    cfg_t = dataclasses.replace(setup["cfg"], kv_quant=mode)
    b, chunk, plen, max_len = 2, 8, 13, 32
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg_t.vocab_size, (b, 16)).astype(np.int32)
    toks[:, plen:] = 0
    jfns = JM.make_serve_fns(cfg_j, cache_dtype=jnp.float32)
    jc = JM.init_caches(cfg_j, b, max_len, dtype=jnp.float32)
    pfns = PM.make_serve_fns(cfg_t)
    pc = PM.init_caches(cfg_t, b, max_len, torch.float32, device="cpu")
    assert pc["units"]["r0"]["k"].dtype == \
        {"int8": torch.int8, "fp8_e4m3": torch.float8_e4m3fn}[mode]
    assert pc["units"]["r0"]["k_scale"].shape == (2, b, max_len, 1)
    tree, params = setup["tree"], setup["params"]
    flips = 0
    for off in range(0, 16, chunk):
        last = min(plen - 1 - off, chunk - 1)
        jl, jc = jax.jit(jfns.prefill_chunk)(
            tree, jc, jnp.asarray(toks[:, off:off + chunk]),
            jnp.asarray(off, jnp.int32), jnp.asarray(last, jnp.int32))
        pl = pfns.prefill_chunk(params, pc, torch.from_numpy(
            toks[:, off:off + chunk]).long(), off, last)
        np.testing.assert_allclose(np.asarray(jl), pl.numpy(), atol=ATOL,
                                   rtol=0)
        flips = max(flips, assert_leaves(jc["units"]["r0"],
                                         pc["units"]["r0"]))
    cur = np.array([plen, plen - 3], np.int32)
    nxt = rng.integers(0, cfg_t.vocab_size, (b, 1)).astype(np.int32)
    for _ in range(3):
        jl, jc = jax.jit(jfns.decode)(tree, jc, jnp.asarray(nxt),
                                      jnp.asarray(cur))
        pl = pfns.decode(params, pc, torch.from_numpy(nxt).long(),
                         torch.from_numpy(cur))
        np.testing.assert_allclose(np.asarray(jl), pl.numpy(), atol=ATOL,
                                   rtol=0)
        flips = max(flips, assert_leaves(jc["units"]["r0"],
                                         pc["units"]["r0"]))
        nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
        cur = cur + 1
    assert flips == 0


@pytest.mark.parametrize("mode", MODES)
def test_quant_paged_serve_steps_match_jax(setup, mode):
    """A shuffled page table, one (B, T) chunk dispatch with rows at their
    own offsets and a passenger (last_idx -1), then a decode step: logits
    and the code and scale pools (outside the scratch page 0) agree."""
    cfg_j = dataclasses.replace(setup["cfg_j"], kv_quant=mode)
    cfg_t = dataclasses.replace(setup["cfg"], kv_quant=mode)
    p, ps, b, nb, t = 20, 8, 3, 4, 16
    rng = np.random.default_rng(0)
    table = rng.permutation(np.arange(1, p))[:b * nb].reshape(b, nb) \
        .astype(np.int32)
    toks = rng.integers(2, cfg_t.vocab_size, (b, t))
    offs = np.array([0, 8, 3], np.int32)
    last = np.array([15, 9, -1], np.int32)
    cur = np.array([16, 18, 5], np.int32)
    jf = JM.make_paged_serve_fns(cfg_j)
    cj = JM.init_paged_caches(cfg_j, p, ps, dtype=jnp.float32)
    lj, cj = jf.prefill_chunk(setup["tree"], cj, jnp.asarray(toks),
                              jnp.asarray(offs), jnp.asarray(last),
                              jnp.asarray(table))
    tf = PM.make_paged_serve_fns(cfg_t)
    ct = PM.init_paged_caches(cfg_t, p, ps, torch.float32, "cpu")
    assert ct["units"]["r0"]["v_scale"].shape == (2, p, ps, 1)
    lt = tf.prefill_chunk(setup["params"], ct, torch.as_tensor(toks),
                          torch.as_tensor(offs), torch.as_tensor(last),
                          torch.as_tensor(table))
    np.testing.assert_allclose(np.asarray(lj)[:2], lt.numpy()[:2],
                               atol=ATOL, rtol=0)
    assert assert_leaves(cj["units"]["r0"], ct["units"]["r0"],
                         skip_page0=True) == 0
    dj, cj = jf.decode(setup["tree"], cj, jnp.asarray(toks[:, :1]),
                       jnp.asarray(cur), jnp.asarray(table))
    dt = tf.decode(setup["params"], ct, torch.as_tensor(toks[:, :1]),
                   torch.as_tensor(cur), torch.as_tensor(table))
    np.testing.assert_allclose(np.asarray(dj), dt.numpy(), atol=ATOL,
                               rtol=0)
    assert assert_leaves(cj["units"]["r0"], ct["units"]["r0"],
                         skip_page0=True) == 0


@pytest.mark.parametrize("mode", MODES)
def test_quant_logit_drift_gate(setup, mode):
    """tests/test_quant_serve.py's gate for smollm, the caches built with
    ``prefill_chunk`` (the port has no whole-prompt prefill yet): the
    quantized decode's logits against the fp32 cache's, two steps."""
    b, t, chunk = 2, 32, 8
    toks = np.random.default_rng(1).integers(
        0, setup["cfg"].vocab_size, (b, t))

    def serve_logits(cfg):
        fns = PM.make_serve_fns(cfg)
        caches = PM.init_caches(cfg, b, t + 4, torch.float32, device="cpu")
        padded = np.zeros((b, t), np.int64)
        padded[:, :t - 1] = toks[:, :t - 1]
        for off in range(0, t, chunk):
            fns.prefill_chunk(setup["params"], caches, torch.as_tensor(
                padded[:, off:off + chunk]), off, min(t - 2 - off, chunk - 1))
        l1 = fns.decode(setup["params"], caches,
                        torch.as_tensor(toks[:, t - 1:]), t - 1)
        nxt = torch.argmax(l1, -1, keepdim=True)
        l2 = fns.decode(setup["params"], caches, nxt, t)
        return l1.numpy(), l2.numpy()

    ref1, ref2 = serve_logits(setup["cfg"])
    q1, q2 = serve_logits(dataclasses.replace(setup["cfg"], kv_quant=mode))
    assert np.isfinite(q1).all() and np.isfinite(q2).all()
    bound = DRIFT_GATE[mode] * max(float(np.max(np.abs(ref1))), 1.0)
    assert float(np.max(np.abs(q1 - ref1))) < bound
    assert float(np.max(np.abs(q2 - ref2))) < bound
    assert float(np.max(np.abs(q1 - ref1))) > 0.0       # it did quantize


# -- engine -------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_engine_quant_tokens_and_stats_equal_jax(setup, mode):
    """``ServeEngine(cache_dtype=mode)`` gives the JAX engine's greedy
    tokens and ``stats()["kv_cache"]`` in both layouts, contiguous equal
    to paged; on the CPU no kernel counter moves."""
    for mod in (cu_kernel, da_kernel, pa_kernel):
        for name in COUNTERS:
            setattr(mod, name, 0)
    outs = {}
    for layout in ("contiguous", "paged"):
        eng = port_engine(setup, mode, layout)
        outs[layout] = [r.out for r in eng.generate(
            [Request(prompt=p, max_new_tokens=6) for p in PROMPTS])]
        want_out, want_kv = setup["jax"][mode, layout]
        assert outs[layout] == want_out
        assert eng.stats()["kv_cache"] == pytest.approx(want_kv, rel=1e-12)
        assert eng.stats()["kv_cache"]["cache_dtype"] == mode
    assert outs["contiguous"] == outs["paged"]
    assert all(getattr(mod, name) == 0 for mod in (cu_kernel, da_kernel,
                                                     pa_kernel)
               for name in COUNTERS)


def test_engine_cache_dtype_modes(setup):
    """A mode string sets ``cfg.kv_quant`` and builds code leaves; the
    footprint gauge counts every leaf (codes and scales) in both layouts,
    well under the bf16 cache; an unknown mode raises."""
    bf16 = port_engine(setup, "bfloat16", "contiguous")
    assert bf16.cfg.kv_quant is None
    for mode, dt in (("int8", torch.int8),
                     ("fp8_e4m3", torch.float8_e4m3fn)):
        cont = port_engine(setup, mode, "contiguous")
        paged = port_engine(setup, mode, "paged")
        assert cont.cfg.kv_quant == paged.cfg.kv_quant == mode
        pools = paged._paged_caches["units"]["r0"]
        assert pools["k"].dtype == pools["v"].dtype == dt
        assert pools["k_scale"].dtype == torch.float32
        layers, kvh, hd = (setup["cfg"].num_layers,
                           setup["cfg"].num_kv_heads, setup["cfg"].head_dim)
        per_pos = layers * 2 * kvh * (hd + 4)
        assert cont.cache_bytes_per_token() == per_pos
        assert cont.cache_bytes_per_token() < \
            0.6 * bf16.cache_bytes_per_token()
    with pytest.raises(ValueError, match="int4"):
        port_engine(setup, "int4", "contiguous")


def test_saved_joules_priced_at_own_ewma(setup):
    """A quantized engine's prefix-cache savings are priced at the J per
    prefill token it learned from its own prefill records, not a bf16
    engine's (tests/test_quant_serve.py's counterpart)."""

    class Rec:
        def __init__(self, path, tokens, joules):
            self.path, self.tokens, self.joules = path, tokens, joules

    saved = {}
    for cache_dtype, jpt in {"bfloat16": 2.0, "int8": 0.5}.items():
        eng = ServeEngine(setup["cfg"], setup["params"], batch_size=2,
                          max_len=48, prefill_chunk=8, kv_layout="paged",
                          kv_page_size=4, cache_dtype=cache_dtype,
                          device="cpu")
        eng.on_record(Rec("serve/req0/prefill", 4, 4 * jpt))
        assert eng._prefill_jpt == pytest.approx(jpt)
        prompt = list(range(1, 13))
        eng.generate([Request(prompt=prompt, max_new_tokens=4)])
        eng.generate([Request(prompt=prompt, max_new_tokens=4)])
        st = eng.stats()["kv_cache"]
        assert st["prefix_hit_tokens"] > 0
        assert st["saved_prefill_joules"] == pytest.approx(
            st["prefix_hit_tokens"] * jpt)
        saved[cache_dtype] = st["saved_prefill_joules"]
    assert saved["int8"] < saved["bfloat16"]


def test_serve_launcher_prints_kv_cache_line(capsys):
    from repro_torch.launch import serve as serve_launch
    serve_launch.main(["--reduced", "--device", "cpu", "--cache-dtype",
                       "int8", "--kv-layout", "paged", "--kv-page-size",
                       "8", "--requests", "2", "--batch", "2", "--max-new",
                       "3", "--max-len", "32"])
    out = capsys.readouterr().out
    line = next(x for x in out.splitlines() if x.startswith("kv cache:"))
    assert line.startswith("kv cache: int8, ") and line.endswith(" B/token")
    assert "kv pool:" in out
