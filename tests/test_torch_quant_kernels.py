"""The port's quantized-cache kernels' plain versions against the JAX
package's, on the same numpy inputs.

  * ``quant.quantize``/``dequantize`` equal JAX bit for bit in codes
    and scales, in both modes, on zero rows and out-of-range values too
    (the fp8 clip keeps NaN out).
  * The quantizing scatters' plain versions equal the JAX oracles
    (``cache_update/ref.py``) and the Pallas kernels in interpret mode
    bit for bit; masked paged rows leave every real page untouched.
  * The plain quantized decode and prefill attention (contiguous, ring,
    paged, window, softcap) match the JAX blockwise twins within 1e-5:
    both dequantize each block to the same float32 values and fold it
    in fp32, differing only in einsum summation order.

On the CPU every op takes its plain version; the CUDA wrappers refuse
tensors that are not on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import quant as jq  # noqa: E402
from repro.kernels.cache_update import ref as jax_cu  # noqa: E402
from repro.kernels.cache_update.cache_update import (  # noqa: E402
    quant_cache_update_pallas, quant_paged_cache_update_pallas)
from repro.kernels.decode_attention import ref as jax_da  # noqa: E402
from repro.kernels.prefill_attention import ref as jax_pa  # noqa: E402
from repro_torch.kernels import build, quant  # noqa: E402
from repro_torch.kernels.cache_update import kernel as cu_kernel  # noqa: E402
from repro_torch.kernels.cache_update import ops as cu_ops  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.kernels.decode_attention import ref as da_ref  # noqa: E402
from repro_torch.kernels.prefill_attention import ops as pa_ops  # noqa: E402
from repro_torch.kernels.prefill_attention import ref as pa_ref  # noqa: E402

MODES = quant.QUANT_MODES
ATOL = 1e-5
B, C, T, KVH, G, HD = 3, 64, 8, 2, 4, 16
PS, NB, P = 8, 8, 32


def rng(i):
    return np.random.default_rng(i)


def to_torch(a) -> torch.Tensor:
    """A JAX or numpy array as a torch tensor with the same bits (fp8
    through its byte view)."""
    a = np.asarray(a)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(np.array(a, copy=True))


def bits(x) -> np.ndarray:
    """The bytes of a JAX array or torch tensor, for exact comparison."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.uint8) if x.element_size() == 1 else x
        return x.numpy().view(np.uint8)
    return np.asarray(x).view(np.uint8)


def assert_bits(a, b):
    np.testing.assert_array_equal(bits(a), bits(b))


def codes_and_scales(mode, shape, seed):
    """A quantized cache (codes, scales) of ``shape`` as JAX and torch
    pairs with the same bits."""
    x = jnp.asarray(rng(seed).normal(size=shape), jnp.float32)
    jc, js = jq.quantize(x, mode)
    return (jc, js), (to_torch(jc), to_torch(js))


# -- quantize / dequantize ----------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MODES)
def test_quantize_equals_jax_bit_for_bit(mode, dtype):
    x = rng(0).normal(size=(B, C, KVH, HD)).astype(np.float32) * 5
    x[0, 0, 0] = 0.0                                  # a zero row
    x[1, 2, 1, :3] = [1e4, -1e4, 3e38]                # out of range
    x[2, 5, 0] = 1e-30                                # tiny row
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jc, js = jq.quantize(jx, mode)
    tc, ts = quant.quantize(tx, mode)
    assert tc.dtype == quant.quant_dtype(mode) and ts.dtype == torch.float32
    assert_bits(jc, tc)
    assert_bits(js, ts)
    deq = quant.dequantize(tc, ts)
    assert torch.isfinite(deq).all()
    np.testing.assert_array_equal(np.asarray(jq.dequantize(jc, js)),
                                  deq.numpy())
    assert (deq[0, 0, 0] == 0).all()


def test_quant_mode_validation():
    with pytest.raises(ValueError):
        quant.quantize(torch.zeros(2, 4), "int4")
    with pytest.raises(ValueError):
        quant.quant_dtype("bf16")
    assert build.dtype_code(torch.int8, codes=True) == 2
    assert build.dtype_code(torch.float8_e4m3fn, codes=True) == 3
    with pytest.raises(TypeError):
        build.dtype_code(torch.int8)            # not a float type
    with pytest.raises(TypeError):
        build.dtype_code(torch.bfloat16, codes=True)


# -- quantizing scatters -----------------------------------------------------

@pytest.mark.parametrize("heads", [(KVH, HD), (1, 24), None])
@pytest.mark.parametrize("mode", MODES)
def test_quant_cache_update_equals_jax(mode, heads):
    """(B, C, H, D) caches, one head, and an MLA-style (B, C, D) cache
    with (B, C) scales; slots at both ends and past the end (clamped)."""
    shape = (B, C, *heads) if heads else (B, C, 24)
    (jc, _), (tc, _) = codes_and_scales(mode, shape, 1)
    js = jnp.asarray(rng(3).random(shape[:-1]), jnp.float32)
    ts = to_torch(js)
    new = rng(2).normal(size=(B, 1, *shape[2:])).astype(np.float32) * 3
    new[1, 0] = 0.0                                  # a zero row
    slots = np.array([0, 17, C - 1], np.int32)
    want_c, want_s = jax_cu.quant_cache_update_ref(
        jc, js, jnp.asarray(new), jnp.asarray(slots), mode)
    got_c, got_s = cu_ops.quant_cache_update(
        tc, ts, torch.from_numpy(new), torch.from_numpy(slots), mode)
    assert got_c is tc and got_s is ts               # in place
    assert_bits(want_c, got_c)
    assert_bits(want_s, got_s)


@pytest.mark.parametrize("mode", MODES)
def test_quant_cache_update_equals_pallas_interpret(mode):
    (jc, _), (tc, _) = codes_and_scales(mode, (B, C, KVH, HD), 4)
    js = jnp.zeros((B, C, KVH), jnp.float32)
    new = rng(5).normal(size=(B, 1, KVH, HD)).astype(np.float32) * 2
    slots = np.array([3, 0, 40], np.int32)
    want_c, want_s = quant_cache_update_pallas(
        jc, js, jnp.asarray(new), jnp.asarray(slots), mode, interpret=True)
    got_c, got_s = cu_ops.quant_cache_update(
        tc, torch.zeros(B, C, KVH), torch.from_numpy(new),
        torch.from_numpy(slots), mode)
    assert_bits(want_c, got_c)
    assert_bits(want_s, got_s)


def _paged_case(mode, seed):
    (jp, _), (tp, _) = codes_and_scales(mode, (P, PS, KVH, HD), seed)
    js = jnp.asarray(rng(seed + 1).random((P, PS, KVH)), jnp.float32)
    new = rng(seed + 2).normal(size=(B, T, KVH, HD)).astype(np.float32) * 2
    pt = (rng(seed + 3).permutation(P - 1)[:B * NB].reshape(B, NB) + 1
          ).astype(np.int32)
    starts = np.array([0, 5, NB * PS - 3], np.int32)   # last row clamps
    valids = np.array([T, 4, 0], np.int32)             # row 2 masked
    return jp, js, tp, to_torch(js), new, pt, starts, valids


@pytest.mark.parametrize("mode", MODES)
def test_quant_paged_cache_update_equals_jax(mode):
    """Equal to the JAX oracle outside the scratch page 0; masked rows
    (and the rows no valid row targets) leave real pages untouched."""
    jp, js, tp, ts, new, pt, starts, valids = _paged_case(mode, 6)
    before_c, before_s = bits(tp).copy(), bits(ts).copy()
    want_p, want_s = jax_cu.quant_paged_cache_update_ref(
        jp, js, jnp.asarray(new), jnp.asarray(pt), jnp.asarray(starts),
        jnp.asarray(valids), mode)
    got_p, got_s = cu_ops.quant_paged_cache_update(
        tp, ts, torch.from_numpy(new), torch.from_numpy(pt),
        torch.from_numpy(starts), torch.from_numpy(valids), mode)
    assert got_p is tp and got_s is ts
    assert_bits(np.asarray(want_p)[1:], got_p[1:])
    assert_bits(np.asarray(want_s)[1:], got_s[1:])
    pos = np.minimum(starts[:, None] + np.arange(T), NB * PS - 1)
    ok = np.arange(T)[None] < valids[:, None]
    hit = (pt[np.arange(B)[:, None], pos // PS] * PS + pos % PS)[ok]
    kept = np.ones(P * PS, bool)
    kept[hit] = False
    kept[:PS] = False
    row_c = bits(got_p).reshape(P * PS, -1)
    row_s = bits(got_s).reshape(P * PS, -1)
    np.testing.assert_array_equal(row_c[kept],
                                  before_c.reshape(P * PS, -1)[kept])
    np.testing.assert_array_equal(row_s[kept],
                                  before_s.reshape(P * PS, -1)[kept])


@pytest.mark.parametrize("mode", MODES)
def test_quant_paged_cache_update_equals_pallas_interpret(mode):
    jp, js, tp, ts, new, pt, starts, valids = _paged_case(mode, 11)
    want_p, want_s = quant_paged_cache_update_pallas(
        jp, js, jnp.asarray(new), jnp.asarray(pt), jnp.asarray(starts),
        jnp.asarray(valids), mode, interpret=True)
    got_p, got_s = cu_ops.quant_paged_cache_update(
        tp, ts, torch.from_numpy(new), torch.from_numpy(pt),
        torch.from_numpy(starts), torch.from_numpy(valids), mode)
    assert_bits(np.asarray(want_p)[1:], got_p[1:])
    assert_bits(np.asarray(want_s)[1:], got_s[1:])


def test_quant_cuda_wrappers_refuse_cpu_tensors():
    codes = torch.zeros(1, 4, 1, 8, dtype=torch.int8)
    sc, new = torch.zeros(1, 4, 1), torch.zeros(1, 1, 1, 8)
    one = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="on the card"):
        cu_kernel.quant_cache_update_cuda(codes, sc, new, one, "int8")
    with pytest.raises(ValueError, match="on the card"):
        cu_kernel.quant_paged_cache_update_cuda(
            codes, sc, new, torch.zeros(1, 1, dtype=torch.int32), one, one,
            "int8")
    assert cu_kernel.quant_launches == cu_kernel.quant_paged_launches == 0


# -- quantized attention ----------------------------------------------------

@pytest.mark.parametrize("ring,softcap", [(False, None), (True, None),
                                          (False, 20.0)])
@pytest.mark.parametrize("mode", MODES)
def test_quant_decode_plain_matches_jax(mode, ring, softcap):
    r = rng(20)
    q = r.normal(size=(B, KVH, G, HD)).astype(np.float32)
    (jk, jks), (tk, tks) = codes_and_scales(mode, (B, C, KVH, HD), 21)
    (jv, jvs), (tv, tvs) = codes_and_scales(mode, (B, C, KVH, HD), 22)
    lens = np.array([0, 33, 100 if ring else C - 1], np.int32)
    kw = dict(ring=ring, softcap=softcap, scale=0.25)
    want = jax_da.decode_attention_ref(
        jnp.asarray(q), jk, jv, jnp.asarray(lens), block_k=16, k_scale=jks,
        v_scale=jvs, **kw)
    got = da_ref.decode_attention_ref(
        torch.from_numpy(q), tk, tv, torch.from_numpy(lens), block_k=16,
        k_scale=tks, v_scale=tvs, **kw)
    np.testing.assert_allclose(np.asarray(want), got.numpy(), atol=ATOL,
                               rtol=0)
    # the op packs (B, 1, H, hd) and takes the same plain version
    op = da_ops.decode_attention(
        torch.from_numpy(q).reshape(B, 1, KVH * G, HD), tk, tv,
        torch.from_numpy(lens), block_k=16, k_scale=tks, v_scale=tvs, **kw)
    np.testing.assert_array_equal(op.reshape(got.shape).numpy(),
                                  got.numpy())


@pytest.mark.parametrize("window,softcap", [(None, None), (13, None),
                                            (None, 20.0)])
@pytest.mark.parametrize("mode", MODES)
def test_quant_paged_decode_plain_matches_jax(mode, window, softcap):
    r = rng(30)
    q = r.normal(size=(B, KVH, G, HD)).astype(np.float32)
    (jk, jks), (tk, tks) = codes_and_scales(mode, (P, PS, KVH, HD), 31)
    (jv, jvs), (tv, tvs) = codes_and_scales(mode, (P, PS, KVH, HD), 32)
    pt = (r.permutation(P - 1)[:B * NB].reshape(B, NB) + 1).astype(np.int32)
    lens = np.array([0, 20, NB * PS - 1], np.int32)
    kw = dict(window=window, softcap=softcap, scale=0.25)
    want = jax_da.decode_attention_paged_ref(
        jnp.asarray(q), jk, jv, jnp.asarray(pt), jnp.asarray(lens),
        k_scale=jks, v_scale=jvs, **kw)
    got = da_ops.decode_attention_paged(
        torch.from_numpy(q).reshape(B, 1, KVH * G, HD), tk, tv,
        torch.from_numpy(pt), torch.from_numpy(lens), k_scale=tks,
        v_scale=tvs, **kw)
    np.testing.assert_allclose(np.asarray(want),
                               got.reshape(B, KVH, G, HD).numpy(),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("ring,window,softcap", [
    (False, None, None), (True, 24, None), (False, None, 20.0)])
@pytest.mark.parametrize("mode", MODES)
def test_quant_prefill_plain_matches_jax(mode, ring, window, softcap):
    """Only the cache prefix holds codes; the chunk's k/v stay fp32."""
    r = rng(40)
    q = r.normal(size=(B, KVH, T, G, HD)).astype(np.float32)
    kx = r.normal(size=(B, T, KVH, HD)).astype(np.float32)
    vx = r.normal(size=(B, T, KVH, HD)).astype(np.float32)
    (jk, jks), (tk, tks) = codes_and_scales(mode, (B, C, KVH, HD), 41)
    (jv, jvs), (tv, tvs) = codes_and_scales(mode, (B, C, KVH, HD), 42)
    offs = np.array([0, 17, 90 if ring else C - 5], np.int32)
    kw = dict(ring=ring, window=window, softcap=softcap, scale=0.25)
    want = jax_pa.prefill_attention_ref(
        jnp.asarray(q), jnp.asarray(kx), jnp.asarray(vx), jk, jv,
        jnp.asarray(offs), block_k=16, k_scale=jks, v_scale=jvs, **kw)
    got = pa_ref.prefill_attention_ref(
        torch.from_numpy(q), torch.from_numpy(kx), torch.from_numpy(vx), tk,
        tv, torch.from_numpy(offs), block_k=16, k_scale=tks, v_scale=tvs,
        **kw)
    np.testing.assert_allclose(np.asarray(want), got.numpy(), atol=ATOL,
                               rtol=0)
    op = pa_ops.prefill_attention(
        torch.from_numpy(q).permute(0, 2, 1, 3, 4).reshape(B, T, KVH * G,
                                                           HD),
        torch.from_numpy(kx), torch.from_numpy(vx), tk, tv,
        torch.from_numpy(offs), block_k=16, k_scale=tks, v_scale=tvs, **kw)
    np.testing.assert_array_equal(
        op.reshape(B, T, KVH, G, HD).permute(0, 2, 1, 3, 4).numpy(),
        got.numpy())


@pytest.mark.parametrize("window,softcap", [(None, None), (11, 20.0)])
@pytest.mark.parametrize("mode", MODES)
def test_quant_paged_prefill_plain_matches_jax(mode, window, softcap):
    r = rng(50)
    q = r.normal(size=(B, KVH, T, G, HD)).astype(np.float32)
    kx = r.normal(size=(B, T, KVH, HD)).astype(np.float32)
    vx = r.normal(size=(B, T, KVH, HD)).astype(np.float32)
    (jk, jks), (tk, tks) = codes_and_scales(mode, (P, PS, KVH, HD), 51)
    (jv, jvs), (tv, tvs) = codes_and_scales(mode, (P, PS, KVH, HD), 52)
    pt = (r.permutation(P - 1)[:B * NB].reshape(B, NB) + 1).astype(np.int32)
    offs = np.array([0, 9, 40], np.int32)
    kw = dict(window=window, softcap=softcap, scale=0.25)
    want = jax_pa.prefill_attention_paged_ref(
        jnp.asarray(q), jnp.asarray(kx), jnp.asarray(vx), jk, jv,
        jnp.asarray(pt), jnp.asarray(offs), k_scale=jks, v_scale=jvs, **kw)
    got = pa_ops.prefill_attention_paged(
        torch.from_numpy(q).permute(0, 2, 1, 3, 4).reshape(B, T, KVH * G,
                                                           HD),
        torch.from_numpy(kx), torch.from_numpy(vx), tk, tv,
        torch.from_numpy(pt), torch.from_numpy(offs), k_scale=tks,
        v_scale=tvs, **kw)
    np.testing.assert_allclose(
        np.asarray(want),
        got.reshape(B, T, KVH, G, HD).permute(0, 2, 1, 3, 4).numpy(),
        atol=ATOL, rtol=0)


def test_v_scale_defaults_to_k_scale():
    (_, _), (tk, tks) = codes_and_scales("int8", (B, C, KVH, HD), 60)
    q = torch.from_numpy(rng(61).normal(size=(B, 1, KVH * G, HD))
                         .astype(np.float32))
    lens = torch.tensor([3, 30, 63], dtype=torch.int32)
    a = da_ops.decode_attention(q, tk, tk, lens, k_scale=tks)
    b = da_ops.decode_attention(q, tk, tk, lens, k_scale=tks, v_scale=tks)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="v_scale without k_scale"):
        da_ops.decode_attention(q, tk, tk, lens, v_scale=tks)
