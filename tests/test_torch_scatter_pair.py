"""The copying KV scatters that write a layer's k and v in one launch,
and the decode layers that call them, against the JAX package on the
same numpy inputs.

  * The pair ops' plain versions (``cache_update_pair``,
    ``paged_cache_update_pair``) equal two calls of the JAX
    ``cache_update`` / ``paged_cache_update``, through their refs and
    through the Pallas kernels in interpret mode, bit for bit (paged:
    outside the scratch page 0), float32 and bfloat16, slots past the end
    included (the refs clamp them to C - 1; the Pallas scatter takes slots
    in [0, C) only); paged with T 1 and T > 1, masked rows and dead rows
    past their table.  ``valids=None`` equals every row valid, for the
    plain and the quantizing paged pair.
  * One decode layer (``decode_self_attention``, which passes ``cur_len``
    as the slots, no clamp) and one paged decode layer
    (``paged_decode_self_attention``, ``valids`` None) leave the cache
    bit-equal to the JAX layer's.  The projections are made exact in both
    (integer inputs, weights in sixteenths, rotary embedding at the
    identity), so the k/v rows both write are the same floats.
  * The serve steps call the pair op once a layer: a contiguous decode
    step, a paged decode step and a paged chunk, which counting wrappers
    show, every layer with the step's own slot tensor (no per-layer clamp)
    and, at a paged decode step, no valids tensor; the contiguous bf16
    chunk calls no scatter.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.kernels.cache_update import ops as jax_cu  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.kernels import quant  # noqa: E402
from repro_torch.kernels.cache_update import ops as cu_ops  # noqa: E402
from repro_torch.models import attention, layers  # noqa: E402
from repro_torch.models import model as PM  # noqa: E402

B, C, H, D = 4, 40, 2, 16
P, PS, NB = 24, 8, 4
IMPLS = ("lax", "pallas_interpret")


def to_torch(a) -> torch.Tensor:
    """A JAX or numpy array as a torch tensor with the same bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy().view(np.uint8)
    return np.asarray(x).view(np.uint8)


def assert_bits(a, b):
    np.testing.assert_array_equal(bits(a), bits(b))


def arrays(shape, seed, dtype):
    """Normal draws as a JAX array and a torch tensor with the same bits."""
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    j = jnp.asarray(x, dtype)
    return j, to_torch(j)


def _table(seed, dead=()):
    """(B, NB) int32 table of distinct shuffled pages 1..P-1; rows in
    ``dead`` map every block to the scratch page 0."""
    ids = (np.random.default_rng(seed).permutation(P - 1)[:B * NB]
           .reshape(B, NB) + 1).astype(np.int32)
    ids[list(dead)] = 0
    return ids


# -- the pair ops' plain versions ---------------------------------------------

@pytest.mark.parametrize("rest", [(H, D), (H * D + 3,)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", IMPLS)
def test_pair_equals_two_jax_scatters(impl, dtype, rest):
    """Slots at 0, mid-cache, C - 1 and, through the JAX ref, past the end
    (both clamp to C - 1)."""
    last = C + 7 if impl == "lax" else C - 1
    slots = np.array([0, 17, C - 1, last], np.int32)
    jk, tk = arrays((B, C, *rest), 1, dtype)
    jv, tv = arrays((B, C, *rest), 2, dtype)
    jkn, tkn = arrays((B, 1, *rest), 3, dtype)
    jvn, tvn = arrays((B, 1, *rest), 4, dtype)
    want_k = jax_cu.cache_update(jk, jkn, jnp.asarray(slots), impl=impl)
    want_v = jax_cu.cache_update(jv, jvn, jnp.asarray(slots), impl=impl)
    got_k, got_v = cu_ops.cache_update_pair(tk, tkn, tv, tvn,
                                            torch.from_numpy(slots))
    assert got_k is tk and got_v is tv                    # in place
    assert_bits(want_k, got_k)
    assert_bits(want_v, got_v)


@pytest.mark.parametrize("t", [1, 6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", IMPLS)
def test_paged_pair_equals_two_jax_scatters(impl, dtype, t):
    """Outside the scratch page 0: a masked row (valids 0), a row ending
    mid-chunk, a row clamped to the table's last slot and a dead row
    whose table is masked to page 0 and whose start is past its table."""
    jk, tk = arrays((P, PS, H, D), 5, dtype)
    jv, tv = arrays((P, PS, H, D), 6, dtype)
    jkn, tkn = arrays((B, t, H, D), 7, dtype)
    jvn, tvn = arrays((B, t, H, D), 8, dtype)
    where = (_table(9, dead=(3,)),
             np.array([0, 5, NB * PS - 2, NB * PS + 9], np.int32),
             np.array([t, 0, max(t - 2, 1), t], np.int32))
    jw = [jnp.asarray(x) for x in where]
    want_k = jax_cu.paged_cache_update(jk, jkn, *jw, impl=impl)
    want_v = jax_cu.paged_cache_update(jv, jvn, *jw, impl=impl)
    got_k, got_v = cu_ops.paged_cache_update_pair(
        tk, tkn, tv, tvn, *map(torch.from_numpy, where))
    assert got_k is tk and got_v is tv
    assert_bits(np.asarray(want_k)[1:], got_k[1:])
    assert_bits(np.asarray(want_v)[1:], got_v[1:])


def _valids_case(t):
    """A paged write of T rows a batch row, every row valid: the table
    (row 2 dead, masked to page 0), starts (row 3 past its table), valids
    of T for every row, and float32 pools with bf16 rows, as JAX arrays
    and torch tensors with the same bits."""
    where = (_table(10, dead=(2,)),
             np.array([0, 9, 3, NB * PS + 1], np.int32),
             np.full(B, t, np.int32))
    return where, [arrays(shape, seed, dt) for shape, seed, dt in (
        ((P, PS, H, D), 11, "float32"), ((P, PS, H, D), 12, "float32"),
        ((B, t, H, D), 13, "bfloat16"), ((B, t, H, D), 14, "bfloat16"))]


@pytest.mark.parametrize("t", [1, 4])
def test_paged_pair_valids_none_is_every_row_valid(t):
    """``valids=None`` writes what valids of T for every row writes, and
    what two calls of the JAX ref with those valids write (outside page
    0)."""
    where, ((jk, tk), (jv, tv), (jkn, tkn), (jvn, tvn)) = _valids_case(t)
    table, starts, full = map(torch.from_numpy, where)
    got = cu_ops.paged_cache_update_pair(tk.clone(), tkn, tv.clone(), tvn,
                                         table, starts)
    want = cu_ops.paged_cache_update_pair(tk.clone(), tkn, tv.clone(), tvn,
                                          table, starts, full)
    jw = [jnp.asarray(x) for x in where]
    jax_want = (jax_cu.paged_cache_update(jk, jkn, *jw),
                jax_cu.paged_cache_update(jv, jvn, *jw))
    for g, w, j in zip(got, want, jax_want):
        assert_bits(w[1:], g[1:])
        assert_bits(np.asarray(j)[1:], g[1:])


@pytest.mark.parametrize("t", [1, 4])
@pytest.mark.parametrize("mode", ["int8", "fp8_e4m3"])
def test_quant_paged_pair_valids_none_is_every_row_valid(mode, t):
    """The quantizing paged pair likewise: ``valids=None`` gives the codes
    and scales of valids of T for every row (outside page 0)."""
    where, ((_, tk), (_, tv), (_, tkn), (_, tvn)) = _valids_case(t)
    table, starts, full = map(torch.from_numpy, where)
    leaves = [quant.quantize(x, mode) for x in (tk, tv)]

    def call(valids):
        (kc, ks), (vc, vs) = [(c.clone(), s.clone()) for c, s in leaves]
        return cu_ops.quant_paged_cache_update_pair(
            kc, ks, tkn, vc, vs, tvn, table, starts, valids, mode)

    for (gc, gs), (wc, ws) in zip(call(None), call(full)):
        assert torch.equal(gc.view(torch.uint8)[1:], wc.view(torch.uint8)[1:])
        assert torch.equal(gs[1:], ws[1:])


# -- one decode layer against the JAX layer's ---------------------------------

def _exact_layer(dtype):
    """The JAX and the port's reduced smollm-135m attention configs with
    caches of ``dtype``, weights in sixteenths of [-1, 1], and a decode
    input x in {-2, ..., 2}: every projection is exact in float32, the
    JAX layer without rotary embedding and the port's at the position-0
    tables (cos 1, sin 0)."""
    cj = dataclasses.replace(
        jax_configs.get_config("smollm-135m", reduced=True), dtype="float32",
        pos_embed="none")
    ct = dataclasses.replace(
        port_configs.get_config("smollm-135m", reduced=True),
        dtype="float32")
    d, h, kvh, hd = ct.d_model, ct.num_heads, ct.num_kv_heads, ct.head_dim
    rng = np.random.default_rng(15)
    w = {name: (rng.integers(-16, 17, shape) / 16).astype(np.float32)
         for name, shape in (("wq", (d, h, hd)), ("wk", (d, kvh, hd)),
                             ("wv", (d, kvh, hd)), ("wo", (h, hd, d)))}
    x = rng.integers(-2, 3, (B, 1, d)).astype(np.float32)
    tables = layers.rope_tables(torch.zeros(B, 1, dtype=torch.int32), hd,
                                ct.rope_theta)
    return cj, ct, w, x, tables


def _jax_torch_cache(lead, kvh, hd, dtype, seed):
    jk, tk = arrays((*lead, kvh, hd), seed, dtype)
    jv, tv = arrays((*lead, kvh, hd), seed + 1, dtype)
    return {"k": jk, "v": jv}, {"k": tk, "v": tv}


@pytest.mark.parametrize("window", [None, C])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_layer_cache_equals_jax(dtype, window):
    """Positions 0, mid-cache, C - 1 and past the end: the JAX layer's
    slots are ``jnp.minimum(cur, C - 1)`` (``cur % C`` in a ring); the
    port's layer passes ``cur_len`` and the scatter clamps."""
    cj, ct, w, x, tables = _exact_layer(dtype)
    kvh, hd = ct.num_kv_heads, ct.head_dim
    jcache, tcache = _jax_torch_cache((B, C), kvh, hd, dtype, 16)
    cur = np.array([0, 13, C - 1, C + 6], np.int32)
    _, jnew = jax_attn.decode_self_attention(
        cj, {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x),
        jcache, jnp.asarray(cur), window=window)
    out = attention.decode_self_attention(
        ct, {k: torch.from_numpy(v) for k, v in w.items()},
        torch.from_numpy(x), tcache, torch.from_numpy(cur), tables,
        window=window)
    assert out.shape == (B, 1, ct.d_model)
    for name in ("k", "v"):
        assert_bits(jnew[name], tcache[name])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_layer_cache_equals_jax(dtype):
    """The JAX layer writes with a vector of ones as valids, the port's
    with None; outside page 0 the pools are bit-equal (row 3 is dead: its
    table is masked to page 0 and its position is past its table)."""
    cj, ct, w, x, tables = _exact_layer(dtype)
    kvh, hd = ct.num_kv_heads, ct.head_dim
    jcache, tcache = _jax_torch_cache((P, PS), kvh, hd, dtype, 18)
    table = _table(20, dead=(3,))
    cur = np.array([0, 9, NB * PS - 1, NB * PS + 4], np.int32)
    _, jnew = jax_attn.paged_decode_self_attention(
        cj, {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x),
        jcache, jnp.asarray(cur), jnp.asarray(table))
    attention.paged_decode_self_attention(
        ct, {k: torch.from_numpy(v) for k, v in w.items()},
        torch.from_numpy(x), tcache, torch.from_numpy(cur),
        torch.from_numpy(table), tables)
    for name in ("k", "v"):
        assert_bits(np.asarray(jnew[name])[1:], tcache[name][1:])


# -- the serve steps call the pair op once a layer -----------------------------

class Counting:
    """Stands in for an op: records each call's arguments, then calls
    it."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *args, **kwargs):
        self.calls.append(args)
        return self.fn(*args, **kwargs)


def _serve_cfg():
    return dataclasses.replace(
        port_configs.get_config("smollm-135m", reduced=True),
        dtype="float32")


def _tokens(cfg, seed, shape):
    return torch.as_tensor(
        np.random.default_rng(seed).integers(0, cfg.vocab_size, shape))


def test_contiguous_decode_calls_pair_once_a_layer(monkeypatch):
    """A bf16 contiguous chunk calls no scatter (two slice copies a
    layer); a decode step calls the pair op once a layer, each layer with
    the step's own position tensor as the slots."""
    cfg = _serve_cfg()
    params = PM.init_params(cfg, seed=0, device="cpu")
    pair = Counting(cu_ops.cache_update_pair)
    monkeypatch.setattr(attention, "cache_update_pair", pair)
    writes = Counting(attention.chunk_kv_write)
    monkeypatch.setattr(attention, "chunk_kv_write", writes)
    fns = PM.make_serve_fns(cfg)
    caches = PM.init_caches(cfg, 2, 32, torch.bfloat16, device="cpu")
    toks = _tokens(cfg, 21, (2, 8))
    fns.prefill_chunk(params, caches, toks, 0, 7)
    assert pair.calls == [] and len(writes.calls) == 2 * cfg.num_layers
    fns.decode(params, caches, toks[:, :1], torch.tensor([8, 31]))
    assert len(pair.calls) == cfg.num_layers
    slots = {id(args[4]) for args in pair.calls}
    assert len(slots) == 1
    assert pair.calls[0][4].tolist() == [8, 31]


def test_paged_steps_call_pair_once_a_layer(monkeypatch):
    """A paged chunk dispatch (a passenger row among them) and a paged
    decode step each call the paged pair op once a layer: the chunk with
    its valid lengths, the decode step with valids None."""
    cfg = _serve_cfg()
    params = PM.init_params(cfg, seed=0, device="cpu")
    pair = Counting(cu_ops.paged_cache_update_pair)
    monkeypatch.setattr(attention, "paged_cache_update_pair", pair)
    fns = PM.make_paged_serve_fns(cfg)
    pools = PM.init_paged_caches(cfg, P, PS, torch.bfloat16, "cpu")
    table = torch.as_tensor(_table(22)[:2])
    toks = _tokens(cfg, 23, (2, 8))
    fns.prefill_chunk(params, pools, toks, torch.tensor([0, 0]),
                      torch.tensor([7, -1]), table)
    assert len(pair.calls) == cfg.num_layers
    assert all(args[6].tolist() == [8, 0] for args in pair.calls)
    fns.decode(params, pools, toks[:, :1], torch.tensor([8, 0]), table)
    assert len(pair.calls) == 2 * cfg.num_layers
    decode = pair.calls[cfg.num_layers:]
    assert all(args[6] is None for args in decode)
    assert len({id(args[5]) for args in decode}) == 1
