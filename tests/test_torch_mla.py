"""MLA (deepseek-v3) in the port against the JAX package, on the CPU.

* The plain versions of the ``v_width`` branch of the four attention
  kernels (rows 3v, 7v decode, 2v, 8v chunked prefill) with V aliasing K,
  against the JAX ops (their ``lax`` paths) given an explicitly sliced V,
  fp32, and int8 / fp8_e4m3 codes with one scale tensor, at the reduced
  widths (G 4, hdq 24, hdv 16), and bf16 once at deepseek-v3's full
  widths (G 8 of its 128 heads, hdq 576, hdv 512, C 64).  Tolerances:
  fp32 1e-5 (both fold fp32 scores, 576-wide dot products at full width,
  in other orders: 3e-6 apart there; the JAX reference's own ``lax``
  branch is 6e-8 off its sliced V at its widths), bf16 outputs
  2^-7 + 1e-5 (one bf16 rounding of outputs below 1).
* The one-leaf scatters (rows 1, 4, 5, 6) at MLA's F 576, bit for bit.
* Each ``models/mla.py`` function at fp32 on bridged weights of the
  reduced config (``moe=None, mtp=False``; the JAX side under ``jit``):
  outputs within 2e-5, caches within 2e-5 (fp32) and codes and scales
  equal (int8).
* The bridge's round trip with the ``mtp`` subtree, and the refusals:
  MoE layers, the flash kernel on MLA's prefill, the MTP loss.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.kernels.cache_update import ops as jcu  # noqa: E402
from repro.kernels.decode_attention import ops as jda  # noqa: E402
from repro.kernels.prefill_attention import ops as jpa  # noqa: E402
from repro.models import mla as jmla  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.sharding.specs import split_params  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.kernels import quant  # noqa: E402
from repro_torch.kernels.cache_update import ops as cu_ops  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.kernels.prefill_attention import ops as pa_ops  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import mla  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402

ARCH = "deepseek-v3-671b"
DENSE = dict(moe=None, mtp=False)
ATOL = {np.float32: 1e-5, "bfloat16": 2.0 ** -7 + 1e-5}
MODES = ("int8", "fp8_e4m3")
SHAPES = {"reduced": (4, 24, 16, 40), "full": (8, 576, 512, 64)}
# (shape, q dtype, cache: a dtype or a quantized mode)
CASES = [("reduced", torch.float32, torch.float32),
         ("reduced", torch.float32, "int8"),
         ("reduced", torch.bfloat16, "fp8_e4m3"),
         ("full", torch.bfloat16, torch.bfloat16)]


def _np(t):
    return bridge.to_numpy(t)


def _t(a, dt=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dt)


def _j(t: torch.Tensor):
    """A port tensor as a JAX array of its dtype (bf16 through float32,
    codes through their bytes)."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    if t.dtype == torch.int8:
        return jnp.asarray(t.numpy())
    if t.dtype == torch.float8_e4m3fn:
        return jnp.asarray(t.view(torch.uint8).numpy()).view(
            jnp.float8_e4m3fn)
    return jnp.asarray(t.numpy())


def _cache(rng, shape, kind):
    """(cache, scales) in the port: fp32 / bf16 values, or a mode's codes
    with their row scales (scales None for values)."""
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    if kind in MODES:
        return quant.quantize(x, kind)
    return x.to(kind), None


def _jx(fn, **kw):
    """``fn`` under ``jax.jit`` with ``kw`` fixed (the JAX side of the
    kernel tests: one compile a shape instead of one a primitive)."""
    return jax.jit(lambda *a, **k: fn(*a, **kw, **k))


def _close(port, ref, dt):
    tol = ATOL["bfloat16"] if dt == torch.bfloat16 else ATOL[np.float32]
    np.testing.assert_allclose(_np(port), np.asarray(ref, np.float32),
                               atol=tol, rtol=0)


@pytest.mark.parametrize("case", CASES, ids=str)
@pytest.mark.parametrize("paged", [False, True])
def test_decode_v_width_plain_matches_jax(case, paged):
    shape, qdt, cache = case
    g, hd, hdv, c = SHAPES[shape]
    rng = np.random.default_rng(0)
    b = 3
    q = _t(rng.standard_normal((b, 1, g, hd)), qdt)
    lens = torch.tensor([0, c // 2, c - 1], dtype=torch.int32)
    scale = 1.0 / math.sqrt(24)
    ps = 8
    if paged:
        nb = c // ps
        kv, sc = _cache(rng, (1 + b * nb, ps, 1, hd), cache)
        table = torch.from_numpy(1 + rng.permutation(b * nb).reshape(b, nb)
                                 .astype(np.int32))
        got = da_ops.decode_attention_paged(q, kv, kv, table, lens,
                                            scale=scale, v_width=hdv,
                                            k_scale=sc)
        want = _jx(jda.decode_attention_paged, scale=scale, impl="lax")(
            _j(q), _j(kv), _j(kv)[..., :hdv], _j(table), _j(lens),
            k_scale=None if sc is None else _j(sc),
            v_scale=None if sc is None else _j(sc))
    else:
        kv, sc = _cache(rng, (b, c, 1, hd), cache)
        got = da_ops.decode_attention(q, kv, kv, lens, scale=scale,
                                      v_width=hdv, k_scale=sc)
        want = _jx(jda.decode_attention, scale=scale, impl="lax")(
            _j(q), _j(kv), _j(kv)[..., :hdv], _j(lens),
            k_scale=None if sc is None else _j(sc),
            v_scale=None if sc is None else _j(sc))
    assert got.shape == (b, 1, g, hdv) and got.dtype == qdt
    _close(got, want, qdt)


@pytest.mark.parametrize("case", CASES, ids=str)
@pytest.mark.parametrize("paged", [False, True])
def test_prefill_v_width_plain_matches_jax(case, paged):
    shape, qdt, cache = case
    g, hd, hdv, c = SHAPES[shape]
    rng = np.random.default_rng(1)
    b, t = 2, 5
    q = _t(rng.standard_normal((b, t, g, hd)), qdt)
    kx = _t(rng.standard_normal((b, t, 1, hd)), qdt)
    offs = torch.tensor([0, c - 8], dtype=torch.int32)
    scale = 1.0 / math.sqrt(24)
    jkx = _j(kx)
    if paged:
        ps = 8
        nb = c // ps
        kv, sc = _cache(rng, (1 + b * nb, ps, 1, hd), cache)
        table = torch.from_numpy(1 + rng.permutation(b * nb).reshape(b, nb)
                                 .astype(np.int32))
        got = pa_ops.prefill_attention_paged(q, kx, kx, kv, kv, table, offs,
                                             scale=scale, v_width=hdv,
                                             k_scale=sc)
        want = _jx(jpa.prefill_attention_paged, scale=scale, impl="lax")(
            _j(q), jkx, jkx[..., :hdv], _j(kv), _j(kv)[..., :hdv],
            _j(table), _j(offs), k_scale=None if sc is None else _j(sc),
            v_scale=None if sc is None else _j(sc))
    else:
        kv, sc = _cache(rng, (b, c, 1, hd), cache)
        got = pa_ops.prefill_attention(q, kx, kx, kv, kv, offs, scale=scale,
                                       v_width=hdv, k_scale=sc)
        want = _jx(jpa.prefill_attention, scale=scale, impl="lax")(
            _j(q), jkx, jkx[..., :hdv], _j(kv), _j(kv)[..., :hdv],
            _j(offs), k_scale=None if sc is None else _j(sc),
            v_scale=None if sc is None else _j(sc))
    assert got.shape == (b, t, g, hdv) and got.dtype == qdt
    _close(got, want, qdt)


def test_v_width_equals_an_explicit_slice():
    """The alias reads what a sliced V holds: the same plain version
    given k and v_width, or k[..., :v_width] as v, agrees bit for bit."""
    rng = np.random.default_rng(2)
    q = _t(rng.standard_normal((2, 1, 4, 24)))
    kv = _t(rng.standard_normal((2, 40, 1, 24)))
    lens = torch.tensor([5, 39], dtype=torch.int32)
    a = da_ops.decode_attention(q, kv, kv, lens, v_width=16)
    b = da_ops.decode_attention(q, kv, kv[..., :16].contiguous(), lens)
    assert torch.equal(a, b)


# -- the one-leaf scatters at F 576 ------------------------------------------

@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=str)
def test_copying_scatters_at_latent_width(dt):
    rng = np.random.default_rng(3)
    b, c, f, p, ps = 4, 32, 576, 12, 16
    cache = _t(rng.standard_normal((b, c, f)), dt)
    new = _t(rng.standard_normal((b, 1, f)), dt)
    slots = torch.tensor([0, 7, 31, 40], dtype=torch.int32)
    got = cu_ops.cache_update(cache.clone(), new, slots)
    want = jcu.cache_update(_j(cache), _j(new), _j(slots), impl="lax")
    assert np.array_equal(_np(got), np.asarray(want, np.float32))
    pool = _t(rng.standard_normal((p, ps, f)), dt)
    table = torch.from_numpy(1 + rng.permutation(p - 1)[:8].reshape(b, 2)
                             .astype(np.int32))
    new_t = _t(rng.standard_normal((b, 3, f)), dt)
    starts = torch.tensor([0, 14, 29, 3], dtype=torch.int32)
    valids = torch.tensor([3, 2, 0, 1], dtype=torch.int32)
    got = cu_ops.paged_cache_update(pool.clone(), new_t, table, starts,
                                    valids)
    want = jcu.paged_cache_update(_j(pool), _j(new_t), _j(table),
                                  _j(starts), _j(valids), impl="lax")
    assert np.array_equal(_np(got)[1:], np.asarray(want, np.float32)[1:])


@pytest.mark.parametrize("mode", MODES)
def test_quantizing_scatters_at_latent_width(mode):
    rng = np.random.default_rng(4)
    b, c, f, p, ps = 4, 32, 576, 12, 16
    codes, scales = quant.quantize(_t(rng.standard_normal((b, c, f))), mode)
    new = _t(rng.standard_normal((b, 1, f)), torch.bfloat16)
    slots = torch.tensor([0, 7, 31, 40], dtype=torch.int32)
    got_c, got_s = cu_ops.quant_cache_update(codes.clone(), scales.clone(),
                                             new, slots, mode)
    want_c, want_s = jcu.quant_cache_update(_j(codes), _j(scales), _j(new),
                                            _j(slots), mode, impl="lax")
    assert np.array_equal(got_c.view(torch.uint8).numpy(),
                          np.asarray(want_c).view(np.uint8))
    assert np.array_equal(got_s.numpy(), np.asarray(want_s))
    pc, psc = quant.quantize(_t(rng.standard_normal((p, ps, f))), mode)
    table = torch.from_numpy(1 + rng.permutation(p - 1)[:8].reshape(b, 2)
                             .astype(np.int32))
    new_t = _t(rng.standard_normal((b, 3, f)), torch.bfloat16)
    starts = torch.tensor([0, 14, 29, 3], dtype=torch.int32)
    valids = torch.tensor([3, 2, 0, 1], dtype=torch.int32)
    got_c, got_s = cu_ops.quant_paged_cache_update(
        pc.clone(), psc.clone(), new_t, table, starts, valids, mode)
    want_c, want_s = jcu.quant_paged_cache_update(
        _j(pc), _j(psc), _j(new_t), _j(table), _j(starts), _j(valids), mode,
        impl="lax")
    assert np.array_equal(got_c[1:].view(torch.uint8).numpy(),
                          np.asarray(want_c)[1:].view(np.uint8))
    assert np.array_equal(got_s[1:].numpy(), np.asarray(want_s)[1:])


# -- models/mla.py against the JAX layer --------------------------------------

@pytest.fixture(scope="module")
def layer():
    """One MLA layer's weights (the reduced dense config's) in both
    packages, and both configs, fp32."""
    cfg_j = dataclasses.replace(jax_configs.get_config(ARCH, reduced=True),
                                dtype="float32", **DENSE)
    cfg_t = dataclasses.replace(port_configs.get_config(ARCH, reduced=True),
                                dtype="float32", **DENSE)
    pj = jax.jit(lambda k: split_params(jmla.init_mla(k, cfg_j))[0])(
        jax.random.PRNGKey(0))
    pt = {k: torch.from_numpy(np.array(v)) for k, v in pj.items()}
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, pj=pj, pt=pt)


def _jit(fn, **kw):
    """``fn`` under ``jax.jit``, its config (first argument) static."""
    return jax.jit(lambda cfg, *a: fn(cfg, *a, **kw), static_argnums=0)


def _tables(cfg, positions):
    return layers.rope_tables(torch.as_tensor(positions),
                              layers.rope_dim(cfg), cfg.rope_theta)


def _x(rng, b, s, d):
    return rng.standard_normal((b, s, d)).astype(np.float32)


def _allclose(port, ref, atol=2e-5):
    np.testing.assert_allclose(_np(port), np.asarray(ref, np.float32),
                               atol=atol, rtol=1e-5)


def test_projections_match_jax(layer):
    cfg_j, cfg_t = layer["cfg_j"], layer["cfg_t"]
    x = _x(np.random.default_rng(5), 2, 7, cfg_t.d_model)
    pos = np.tile(np.arange(3, 10, dtype=np.int32), (2, 1))
    tab = _tables(cfg_t, pos)
    for port, ref in zip(
            mla._project_q(cfg_t, layer["pt"], torch.from_numpy(x), tab),
            jmla._project_q(cfg_j, layer["pj"], jnp.asarray(x),
                            jnp.asarray(pos))):
        _allclose(port, ref)
    for port, ref in zip(
            mla._project_kv_latent(cfg_t, layer["pt"], torch.from_numpy(x),
                                   tab),
            jmla._project_kv_latent(cfg_j, layer["pj"], jnp.asarray(x),
                                    jnp.asarray(pos))):
        _allclose(port, ref)


@pytest.mark.parametrize("impl", ["dense", "chunked"])
def test_self_attention_matches_jax(layer, impl):
    cfg_j, cfg_t = layer["cfg_j"], layer["cfg_t"]
    x = _x(np.random.default_rng(6), 2, 16, cfg_t.d_model)
    pos = np.tile(np.arange(16, dtype=np.int32), (2, 1))
    out, (lat, kr) = mla.mla_self_attention(
        cfg_t, layer["pt"], torch.from_numpy(x), torch.from_numpy(pos),
        _tables(cfg_t, pos), impl=impl, chunk=8)
    ref, (jlat, jkr) = _jit(jmla.mla_self_attention, impl=impl, chunk=8)(
        cfg_j, layer["pj"], jnp.asarray(x), jnp.asarray(pos))
    _allclose(out, ref)
    _allclose(lat, jlat)
    _allclose(kr, jkr)
    for mode in (None, "int8"):
        cj = dataclasses.replace(cfg_j, kv_quant=mode)
        ct = dataclasses.replace(cfg_t, kv_quant=mode)
        cache = mla.prefill_mla_cache(ct, lat, kr, 24, dtype=torch.float32)
        want = jmla.prefill_mla_cache(cj, jlat, jkr, 24, dtype=jnp.float32)
        if mode is None:
            _allclose(cache["kv"], want["kv"])
        else:
            assert np.array_equal(cache["kv"].numpy(),
                                  np.asarray(want["kv"]))
            _allclose(cache["kv_scale"], want["kv_scale"], atol=1e-7)


def _caches(cfg_t, cfg_j, rng, b, c, mode):
    """A filled (B, C, r + rope) latent cache in both packages (codes and
    scales with ``mode``)."""
    w = cfg_t.mla.kv_lora_rank + cfg_t.mla.qk_rope_head_dim
    vals = torch.from_numpy(rng.standard_normal((b, c, w)).astype(
        np.float32))
    if mode is None:
        return {"kv": vals}, {"kv": jnp.asarray(vals.numpy())}
    codes, sc = quant.quantize(vals, mode)
    return ({"kv": codes, "kv_scale": sc},
            {"kv": _j(codes), "kv_scale": jnp.asarray(sc.numpy())})


def _same_cache(port, ref):
    for name in port:
        a, r = port[name], ref[name]
        if a.element_size() == 1:
            assert np.array_equal(a.view(torch.uint8).numpy(),
                                  np.asarray(r).view(np.uint8)), name
        else:
            _allclose(a, r)


@pytest.mark.parametrize("mode", [None, "int8"])
@pytest.mark.parametrize("offset", [0, 5, "rows"])
def test_prefill_chunk_matches_jax(layer, mode, offset):
    cfg_j = dataclasses.replace(layer["cfg_j"], kv_quant=mode)
    cfg_t = dataclasses.replace(layer["cfg_t"], kv_quant=mode)
    rng = np.random.default_rng(7)
    b, t, c = 2, 6, 24
    off = np.array([2, 9], np.int32) if offset == "rows" else offset
    x = _x(rng, b, t, cfg_t.d_model)
    pos = np.asarray(off).reshape(-1, 1) + np.arange(t, dtype=np.int32)
    cache_t, cache_j = _caches(cfg_t, cfg_j, rng, b, c, mode)
    offs = torch.as_tensor(np.broadcast_to(off, (b,)).copy(),
                           dtype=torch.int32)
    out = mla.mla_prefill_chunk(cfg_t, layer["pt"], torch.from_numpy(x),
                                cache_t, off if offset != "rows" else offs,
                                offs, 4, _tables(cfg_t,
                                                 np.broadcast_to(pos, (b, t))))
    ref, new_j = _jit(jmla.mla_prefill_chunk)(
        cfg_j, layer["pj"], jnp.asarray(x), cache_j, jnp.asarray(off), 4)
    _allclose(out, ref)
    _same_cache(cache_t, new_j)


@pytest.mark.parametrize("mode", [None, "int8"])
@pytest.mark.parametrize("impl", ["flash", "dense"])
def test_decode_matches_jax(layer, mode, impl):
    cfg_j = dataclasses.replace(layer["cfg_j"], kv_quant=mode)
    cfg_t = dataclasses.replace(layer["cfg_t"], kv_quant=mode)
    rng = np.random.default_rng(8)
    b, c = 3, 24
    x = _x(rng, b, 1, cfg_t.d_model)
    cur = np.array([0, 11, 23], np.int32)
    cache_t, cache_j = _caches(cfg_t, cfg_j, rng, b, c, mode)
    out = mla.mla_decode_attention(cfg_t, layer["pt"], torch.from_numpy(x),
                                   cache_t, torch.from_numpy(cur),
                                   _tables(cfg_t, cur[:, None]), impl=impl)
    ref, new_j = _jit(jmla.mla_decode_attention, impl=impl)(
        cfg_j, layer["pj"], jnp.asarray(x), cache_j, jnp.asarray(cur))
    _allclose(out, ref)
    _same_cache(cache_t, new_j)


@pytest.mark.parametrize("mode", [None, "int8"])
def test_paged_layer_matches_jax(layer, mode):
    """A paged chunk, then a paged decode step, on one pool."""
    cfg_j = dataclasses.replace(layer["cfg_j"], kv_quant=mode)
    cfg_t = dataclasses.replace(layer["cfg_t"], kv_quant=mode)
    rng = np.random.default_rng(9)
    b, t, p, ps = 2, 5, 9, 4
    pool_t = mla.init_paged_mla_pool(cfg_t, p, ps, torch.float32, "cpu")
    pool_j = jmla.init_paged_mla_pool(cfg_j, p, ps, jnp.float32)
    table = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    offs = np.array([0, 3], np.int32)
    valid = np.array([5, 4], np.int32)
    x = _x(rng, b, t, cfg_t.d_model)
    pos = offs[:, None] + np.arange(t, dtype=np.int32)
    out = mla.mla_paged_prefill_chunk(
        cfg_t, layer["pt"], torch.from_numpy(x), pool_t,
        torch.from_numpy(offs), torch.from_numpy(valid),
        torch.from_numpy(table), _tables(cfg_t, pos))
    ref, pool_j = _jit(jmla.mla_paged_prefill_chunk)(
        cfg_j, layer["pj"], jnp.asarray(x), pool_j, jnp.asarray(offs),
        jnp.asarray(valid), jnp.asarray(table))
    _allclose(out, ref)
    cur = offs + valid
    x1 = _x(rng, b, 1, cfg_t.d_model)
    out = mla.mla_paged_decode_attention(
        cfg_t, layer["pt"], torch.from_numpy(x1), pool_t,
        torch.from_numpy(cur), torch.from_numpy(table),
        _tables(cfg_t, cur[:, None]))
    ref, pool_j = _jit(jmla.mla_paged_decode_attention)(
        cfg_j, layer["pj"], jnp.asarray(x1), pool_j, jnp.asarray(cur),
        jnp.asarray(table))
    _allclose(out, ref)
    _same_cache({k: v[1:] for k, v in pool_t.items()},
                {k: v[1:] for k, v in pool_j.items()})


# -- the bridge, the refusals ------------------------------------------------

def test_bridge_round_trip_with_mtp():
    """The JAX tree of the reduced dense config with MTP, leaf for leaf:
    into the port and back, and the port's own init has its layout."""
    cfg_j = dataclasses.replace(jax_configs.get_config(ARCH, reduced=True),
                                moe=None)
    cfg_t = dataclasses.replace(port_configs.get_config(ARCH, reduced=True),
                                moe=None)
    tree = jax.device_get(jax.jit(lambda k: JM.init_params(k, cfg_j)[0])(
        jax.random.PRNGKey(1)))
    params = bridge.params_from_numpy(tree, cfg_t, device="cpu")
    back = bridge.params_to_numpy(params, cfg_t)
    flat_j = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_j) == len(flat_b)
    for path, leaf in flat_j:
        np.testing.assert_array_equal(np.asarray(leaf, np.float32),
                                      flat_b[path])
    assert "mtp" in params and set(params["mtp"]) == {"block", "norm",
                                                      "proj"}
    own = model_mod.init_params(cfg_t, seed=0, device="cpu")
    shapes = jax.tree.map(lambda t: tuple(t.shape), own)
    assert shapes == jax.tree.map(lambda t: tuple(t.shape), params)


def test_refusals():
    full = port_configs.get_config(ARCH)
    with pytest.raises(NotImplementedError, match="MoE slice"):
        model_mod.init_params(full, device="cpu")
    red = port_configs.get_config(ARCH, reduced=True)
    with pytest.raises(NotImplementedError, match="MoE slice"):
        model_mod.make_serve_fns(red)
    dense = dataclasses.replace(red, moe=None)
    model_mod.make_serve_fns(dense)            # MTP does not stop serving
    with pytest.raises(NotImplementedError, match="MTP loss"):
        model_mod.loss_fn(dense)
    cfg = dataclasses.replace(dense, mtp=False, attn_impl="pallas",
                              dtype="float32")
    params = model_mod.init_params(cfg, device="cpu")
    fns = model_mod.make_serve_fns(cfg, cache_dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="one head width"):
        fns.prefill(params, {"tokens": torch.zeros((1, 8), dtype=torch.long)},
                    16)
