"""The quantizing scatters that write a layer's k and v in one launch,
and the contiguous prefill chunk written through them, against the JAX
package on the same numpy inputs.

  * The pair ops' plain versions (``quant_cache_update_pair``,
    ``quant_paged_cache_update_pair``) equal two calls of the JAX
    ``quant_cache_update_ref`` / ``quant_paged_cache_update_ref``, bit for
    bit in codes and scales (paged: outside the scratch page 0), int8 and
    fp8_e4m3, float32 and bfloat16 rows, T 1 and T > 1, starts past the
    end included (both clamp the start to [0, C - T]).
  * ``quant_cache_update`` with T rows equals the JAX chunk path,
    ``quant.quantize`` then ``chunk_kv_write`` with one int offset, bit
    for bit.
  * One attention layer's ``prefill_chunk_self_attention`` leaves the
    quantized cache bit-equal to the JAX layer's.  The projections are
    made exact in both (integer inputs, weights in sixteenths, rotary
    embedding at the identity), so the k/v rows both quantize are the
    same floats.
  * The serve steps call the quantizing op once a layer: a contiguous
    chunk, a decode step, a paged chunk and a paged decode step, which
    counting wrappers show; the contiguous chunk's cache equals the
    plain ops' route it replaced (``quant.quantize`` then
    ``chunk_kv_write``) bit for bit.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.kernels import quant as jq  # noqa: E402
from repro.kernels.cache_update import ref as jax_cu  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.kernels import quant  # noqa: E402
from repro_torch.kernels.cache_update import ops as cu_ops  # noqa: E402
from repro_torch.models import attention, layers  # noqa: E402
from repro_torch.models import model as PM  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

MODES = ("int8", "fp8_e4m3")
B, C, H, D = 3, 40, 2, 16
P, PS, NB = 24, 8, 4


def to_torch(a) -> torch.Tensor:
    """A JAX or numpy array as a torch tensor with the same bits."""
    a = np.asarray(a)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.view(torch.uint8) if x.element_size() == 1 else x
        return x.numpy().view(np.uint8)
    return np.asarray(x).view(np.uint8)


def assert_bits(a, b):
    np.testing.assert_array_equal(bits(a), bits(b))


def leaf(mode, shape, seed):
    """A quantized leaf (codes, scales) as JAX and torch pairs with the
    same bits."""
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    jc, js = jq.quantize(jnp.asarray(x), mode)
    return (jc, js), (to_torch(jc), to_torch(js))


def rows(shape, seed, dtype):
    """Source rows as a JAX array and a torch tensor with the same bits:
    a zero vector and +-1e4 extremes among them."""
    x = 3 * np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[-1, 0, -1, :2] = (1e4, -1e4)
    j = jnp.asarray(x, dtype)
    return j, to_torch(j)


# -- the pair ops' plain versions ---------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [1, 5])
@pytest.mark.parametrize("mode", MODES)
def test_pair_equals_two_jax_refs(mode, t, dtype):
    """Starts at 0, at C - T - 1 and past C - T: JAX's
    ``dynamic_update_slice`` clamps the last to C - T, as the op does.
    (A negative start, which no caller makes, differs: JAX counts it from
    the end, the op and the kernel clamp it to 0.)"""
    slots = np.array([0, C - t - 1, C + 7 if t == 1 else C - 2], np.int32)
    (jk, jks), (tk, tks) = leaf(mode, (B, C, H, D), 1)
    (jv, jvs), (tv, tvs) = leaf(mode, (B, C, H, D), 2)
    jkn, tkn = rows((B, t, H, D), 3, dtype)
    jvn, tvn = rows((B, t, H, D), 4, dtype)
    want_k = jax_cu.quant_cache_update_ref(jk, jks, jkn, jnp.asarray(slots),
                                           mode)
    want_v = jax_cu.quant_cache_update_ref(jv, jvs, jvn, jnp.asarray(slots),
                                           mode)
    got_k, got_v = cu_ops.quant_cache_update_pair(
        tk, tks, tkn, tv, tvs, tvn, torch.from_numpy(slots), mode)
    assert got_k[0] is tk and got_v[1] is tvs            # in place
    for want, got in ((want_k, got_k), (want_v, got_v)):
        assert_bits(want[0], got[0])
        assert_bits(want[1], got[1])


@pytest.mark.parametrize("t", [1, 6])
@pytest.mark.parametrize("mode", MODES)
def test_paged_pair_equals_two_jax_refs(mode, t):
    """Outside the scratch page 0, with a masked row, a row clamped to
    the table's last slot and a row ending mid-chunk."""
    (jk, jks), (tk, tks) = leaf(mode, (P, PS, H, D), 5)
    (jv, jvs), (tv, tvs) = leaf(mode, (P, PS, H, D), 6)
    jkn, tkn = rows((B, t, H, D), 7, "bfloat16")
    jvn, tvn = rows((B, t, H, D), 8, "bfloat16")
    table = (np.random.default_rng(9).permutation(P - 1)[:B * NB]
             .reshape(B, NB) + 1).astype(np.int32)
    starts = np.array([0, 5, NB * PS - 2], np.int32)
    valids = np.array([t, 0, max(t - 2, 1)], np.int32)
    where = (table, starts, valids)
    want_k = jax_cu.quant_paged_cache_update_ref(
        jk, jks, jkn, *map(jnp.asarray, where), mode)
    want_v = jax_cu.quant_paged_cache_update_ref(
        jv, jvs, jvn, *map(jnp.asarray, where), mode)
    got_k, got_v = cu_ops.quant_paged_cache_update_pair(
        tk, tks, tkn, tv, tvs, tvn, *map(torch.from_numpy, where), mode)
    for want, got in ((want_k, got_k), (want_v, got_v)):
        assert_bits(np.asarray(want[0])[1:], got[0][1:])
        assert_bits(np.asarray(want[1])[1:], got[1][1:])


@pytest.mark.parametrize("offset", [0, 9, C - 8, C - 5])
@pytest.mark.parametrize("mode", MODES)
def test_t_rows_equal_jax_quantize_then_chunk_kv_write(mode, offset):
    """A chunk of T = 8 rows from one int offset (the last two clamp to
    C - T): ``quant_cache_update`` writes what the JAX layer's
    ``quant.quantize`` and ``chunk_kv_write`` write, pad rows included
    (``valid_len`` 5 does not mask the int-offset slice copy)."""
    t = 8
    (jc, js), (tc, ts) = leaf(mode, (B, C, H, D), 10)
    jn, tn = rows((B, t, H, D), 11, "float32")
    codes, scales = jq.quantize(jn, mode)
    want_c = jax_attn.chunk_kv_write(jc, codes, offset, 5)
    want_s = jax_attn.chunk_kv_write(js, scales, offset, 5)
    cu_ops.quant_cache_update(tc, ts, tn, torch.full((B,), offset,
                                                     dtype=torch.int32), mode)
    assert_bits(want_c, tc)
    assert_bits(want_s, ts)


# -- one attention layer's prefill chunk against the JAX layer's --------------

def _cfgs(mode):
    cj = dataclasses.replace(
        jax_configs.get_config("smollm-135m", reduced=True), dtype="float32",
        kv_quant=mode, pos_embed="none")
    ct = dataclasses.replace(
        port_configs.get_config("smollm-135m", reduced=True),
        dtype="float32", kv_quant=mode)
    return cj, ct


@pytest.mark.parametrize("offset,valid_len", [(0, 8), (8, 8), (16, 5),
                                              (28, 8)])
@pytest.mark.parametrize("mode", MODES)
def test_prefill_chunk_layer_cache_equals_jax(mode, offset, valid_len):
    """x in {-2, ..., 2} and weights in sixteenths of [-1, 1]: every
    projection is exact in float32 whatever the order of its sums; the
    JAX layer runs without rotary embedding and the port's with the
    position-0 tables (cos 1, sin 0), so both quantize the same k/v.
    Offset 28 with T 8 and C 32 clamps to 24 in both."""
    cj, ct = _cfgs(mode)
    d, h, kvh, hd = ct.d_model, ct.num_heads, ct.num_kv_heads, ct.head_dim
    t, c = 8, 32
    rng = np.random.default_rng(12)
    w = {name: (rng.integers(-16, 17, shape) / 16).astype(np.float32)
         for name, shape in (("wq", (d, h, hd)), ("wk", (d, kvh, hd)),
                             ("wv", (d, kvh, hd)), ("wo", (h, hd, d)))}
    x = rng.integers(-2, 3, (1, t, d)).astype(np.float32)
    (jk, jks), (tk, tks) = leaf(mode, (1, c, kvh, hd), 13)
    (jv, jvs), (tv, tvs) = leaf(mode, (1, c, kvh, hd), 14)
    _, jcache = jax_attn.prefill_chunk_self_attention(
        cj, {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x),
        {"k": jk, "v": jv, "k_scale": jks, "v_scale": jvs}, offset,
        valid_len)
    tcache = {"k": tk, "v": tv, "k_scale": tks, "v_scale": tvs}
    tables = layers.rope_tables(torch.zeros(1, t, dtype=torch.int32), hd,
                                ct.rope_theta)
    attention.prefill_chunk_self_attention(
        ct, {k: torch.from_numpy(v) for k, v in w.items()},
        torch.from_numpy(x), tcache, offset,
        torch.full((1,), offset, dtype=torch.int32), valid_len, tables)
    for name in ("k", "v", "k_scale", "v_scale"):
        assert_bits(jcache[name], tcache[name])


# -- the serve steps call the quantizing op once a layer ----------------------

class Counting:
    """Stands in for an op: counts its calls, then calls it."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args):
        self.calls += 1
        return self.fn(*args)


def _serve_cfg(mode):
    return dataclasses.replace(
        port_configs.get_config("smollm-135m", reduced=True),
        dtype="float32", kv_quant=mode)


@pytest.mark.parametrize("mode", MODES)
def test_contiguous_chunk_calls_pair_once_a_layer(monkeypatch, mode):
    """A contiguous chunk and a decode step each call the pair op once a
    layer, the chunk no ``chunk_kv_write``; the chunk's cache equals the
    route it replaced (``quant.quantize``, then ``chunk_kv_write`` of
    codes and scales) bit for bit."""
    cfg = _serve_cfg(mode)
    params = PM.init_params(cfg, seed=0, device="cpu")
    toks = torch.as_tensor(
        np.random.default_rng(15).integers(0, cfg.vocab_size, (1, 8)))
    fns = PM.make_serve_fns(cfg)
    write = attention.chunk_kv_write

    def chunk_caches(quantizing):
        monkeypatch.setattr(attention, "quant_cache_update_pair", quantizing)
        monkeypatch.setattr(attention, "chunk_kv_write", Counting(write))
        caches = PM.init_caches(cfg, 1, 32, torch.float32, device="cpu")
        fns.prefill_chunk(params, caches, toks, 8, 5)
        return caches, attention.chunk_kv_write.calls

    def old_route(k, ks, kn, v, vs, vn, offs, mode):
        for codes, scales, new in ((k, ks, kn), (v, vs, vn)):
            qc, qs = quant.quantize(new, mode)
            write(codes, qc, int(offs[0]), 5)
            write(scales, qs, int(offs[0]), 5)

    pair = Counting(cu_ops.quant_cache_update_pair)
    got, slice_writes = chunk_caches(pair)
    assert pair.calls == cfg.num_layers and slice_writes == 0
    want, _ = chunk_caches(old_route)
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert_bits(w, g)
    monkeypatch.setattr(attention, "quant_cache_update_pair", pair)
    fns.decode(params, got, toks[:, :1], 13)
    assert pair.calls == 2 * cfg.num_layers


@pytest.mark.parametrize("mode", MODES)
def test_paged_steps_call_pair_once_a_layer(monkeypatch, mode):
    """A paged chunk dispatch (a passenger row among them) and a paged
    decode step each call the paged pair op once a layer."""
    cfg = _serve_cfg(mode)
    params = PM.init_params(cfg, seed=0, device="cpu")
    pair = Counting(cu_ops.quant_paged_cache_update_pair)
    monkeypatch.setattr(attention, "quant_paged_cache_update_pair", pair)
    fns = PM.make_paged_serve_fns(cfg)
    pools = PM.init_paged_caches(cfg, P, PS, torch.float32, "cpu")
    table = torch.as_tensor((np.random.default_rng(16).permutation(P - 1)
                             [:2 * NB].reshape(2, NB) + 1).astype(np.int32))
    toks = torch.as_tensor(
        np.random.default_rng(17).integers(0, cfg.vocab_size, (2, 8)))
    fns.prefill_chunk(params, pools, toks, torch.tensor([0, 0]),
                      torch.tensor([7, -1]), table)
    assert pair.calls == cfg.num_layers
    fns.decode(params, pools, toks[:, :1], torch.tensor([8, 0]), table)
    assert pair.calls == 2 * cfg.num_layers
