"""The tensor-core chunked-prefill kernel's arithmetic, on the CPU.

The kernel (``csrc/prefill_attention.cu`` ``tc::prefill_tc_kernel``)
runs only on the card, where ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold it to its plain version.  Here its arithmetic is
emulated in plain torch, split by split and tile by tile: bf16 q . k
summed in fp32 and scaled after, softcap, masks (a masked key weighs 0:
-inf, against a running max that starts at the finite NEG_INF), the
online softmax in log2 units, each p split into bf16 p_hi + p_lo and both multiplied
with v into the fp32 accumulator, and the splits' (m, l, acc) partials
folded in split order with weights 2^(m_s - M) / L.  Over a cache of
int8 or fp8_e4m3 codes a cache tile is its codes widened to bf16 (exact:
every code is a bf16, also through the kernel's own widening, tested
for all 256 int8 codes and every finite e4m3 value), column c's score is
multiplied by its k scale within the score's multiplier, and each p by
its v scale before the hi + lo split, while l sums the unscaled p.  The
emulation must agree with the port's plain version and with the JAX
package's ``prefill_attention_ref`` on the same numpy inputs (the same
codes and scales) within TOL[bf16] (2^-6 + 1e-5: one bf16 rounding step
of outputs below 4, the tolerance chip_smoke.py holds the kernel to),
contiguous and paged, at one split and at the design's; one split and
many must agree to fp32 rounding; and the split count must be what the
design says at batch 1 and batch 8.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import quant as jquant  # noqa: E402
from repro.kernels.prefill_attention import ref as jax_pa  # noqa: E402
from repro_torch.kernels import split_kv  # noqa: E402
from repro_torch.kernels.prefill_attention import kernel as pa_kernel  # noqa: E402
from repro_torch.kernels.prefill_attention import ref as pa_ref  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain versions here run many small torch ops: torch's intra-op
    threads only contend, with JAX's and with the other workers of a
    parallel run.  Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL_BF16 = 2.0 ** -6 + 1e-5
KT = 32                      # keys per tile, as in the kernel
NEG = -2.0 ** 30
LOG2E = 1.4426950408889634


def _tc_emulation(q, kx, vx, kc, vc, offs, *, ring=False, window=None,
                  softcap=None, scale=1.0, nsplit=1, k_scale=None,
                  v_scale=None):
    """q (B, KVH, T, G, hd), kx/vx (B, T, KVH, hd), all bf16, kc/vc
    (B, C, KVH, hd) bf16 or, with k_scale/v_scale (B, C, KVH) float32,
    int8 / float8_e4m3fn codes; offs a list -> the fp32 output
    (B, KVH, T, G, hdv) before its rounding to bf16, in the kernel's order
    of operations."""
    b_, kvh, t, g, hd = q.shape
    c, hdv = kc.shape[1], vc.shape[-1]
    out = torch.zeros((b_, kvh, t * g, hdv))
    rows_t = torch.arange(t * g)[:, None] // g           # (R, 1)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    mul, cap_in = f32(scale * LOG2E), f32(scale / (softcap or 1.0))
    widen = lambda x: x.to(torch.bfloat16).float()       # noqa: E731
    for b in range(b_):
        off = int(offs[b])
        limit = min(off, c)
        start = max(off - (window - 1), 0) if (not ring and window) else 0
        for h in range(kvh):
            q2 = q[b, h].reshape(t * g, hd).float()
            parts = []
            for s in range(nsplit):
                lo, hi = split_kv.split_range(start, limit, nsplit, s)
                tiles = [(True, x) for x in range(lo, hi, KT)]
                if s == nsplit - 1:
                    tiles += [(False, x) for x in range(0, t, KT)]
                if not tiles:
                    continue
                m = torch.full((t * g,), NEG)
                l = torch.zeros(t * g)
                acc = torch.zeros((t * g, hdv))
                for cache, base in tiles:
                    end = min(base + KT, hi if cache else t)
                    cols = torch.arange(base, end)[None, :]
                    src_k, src_v = (kc, vc) if cache else (kx, vx)
                    kt = widen(src_k[b, base:end, h])
                    vt = widen(src_v[b, base:end, h])
                    x = q2 @ kt.T
                    codes = cache and k_scale is not None
                    if codes:   # the k scale joins the multiplier
                        ks = k_scale[b, base:end, h]
                        x = x * ((cap_in if softcap else mul) * ks)
                        if softcap is not None:
                            x = torch.tanh(x) * (softcap * LOG2E)
                    elif softcap is not None:
                        x = torch.tanh(x * (scale / softcap)) * (softcap * LOG2E)
                    else:
                        x = x * (scale * LOG2E)
                    if not cache:
                        diff = rows_t - cols
                        ok = diff >= 0
                        if window is not None:
                            ok &= diff < window
                    else:
                        q_pos = off + rows_t
                        if ring:
                            pos = (off - 1) - torch.remainder(off - 1 - cols, c)
                            ok = (pos >= 0) & (q_pos - pos < window)
                        else:
                            ok = (cols < off) & torch.ones_like(q_pos,
                                                                dtype=torch.bool)
                            if window is not None:
                                ok &= q_pos - cols < window
                    x2 = torch.where(ok, x, -torch.inf)    # weighs 0
                    m_new = torch.maximum(m, x2.amax(-1))
                    alpha = torch.exp2(m - m_new)
                    p = torch.exp2(x2 - m_new[:, None])
                    l = alpha * l + p.sum(-1)
                    if codes:   # p . (code * vs) = (p * vs) . code
                        p = p * v_scale[b, base:end, h]
                    p_hi = p.to(torch.bfloat16).float()
                    p_lo = (p - p_hi).to(torch.bfloat16).float()
                    acc = alpha[:, None] * acc + (p_hi @ vt + p_lo @ vt)
                    m = m_new
                parts.append((m, l, acc))
            if nsplit == 1:
                m, l, acc = parts[0]
                res = acc / l.clamp_min(1e-30)[:, None]
            else:
                big_m = torch.stack([p[0] for p in parts]).amax(0)
                w = [torch.exp2(p[0] - big_m) for p in parts]
                big_l = sum(wi * p[1] for wi, p in zip(w, parts))
                inv = 1.0 / big_l.clamp_min(1e-30)
                res = torch.zeros((t * g, hdv))
                for wi, p in zip(w, parts):
                    res = res + (wi * inv)[:, None] * p[2]
            out[b, h] = res
    return out.reshape(b_, kvh, t, g, hdv)


def _nsplit(b, kvh, t, g, c):
    nwarps = pa_kernel.tc_warps(t * g)
    groups = b * kvh * math.ceil(t * g / (16 * nwarps))
    return pa_kernel.split_count(groups, c)


def _bf16(rng, *shape):
    a = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(a).to(
        torch.bfloat16)


def _err(a, b):
    return float((a.float() - b.float()).abs().max())


CASES = {
    # name: (b, t, c, kvh, g, hd, offs, ring, window, softcap)
    "serve path B1 T32 C1024 off512": (1, 32, 1024, 3, 3, 64, [512], False,
                                       None, None),
    "B8 uneven offs, off >= C": (8, 32, 256, 3, 3, 64,
                                 [0, 1, 80, 81, 255, 256, 700, 33], False,
                                 None, None),
    "off 0": (1, 32, 1024, 3, 3, 64, [0], False, None, None),
    "odd B2 T17 C333 KVH2 G5 hd40": (2, 17, 333, 2, 5, 40, [0, 200], False,
                                     None, None),
    "ring C64 window64 wrapped": (4, 16, 64, 2, 3, 32, [0, 63, 64, 200],
                                  True, 64, None),
    "softcap 30": (2, 32, 512, 3, 3, 64, [300, 17], False, None, 30.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tc_emulation_matches_port_plain_and_jax(case):
    b, t, c, kvh, g, hd, offs, ring, window, softcap = CASES[case]
    rng = np.random.default_rng(11)
    jq, q = _bf16(rng, b, kvh, t, g, hd)
    jkx, kx = _bf16(rng, b, t, kvh, hd)
    jvx, vx = _bf16(rng, b, t, kvh, hd)
    jkc, kc = _bf16(rng, b, c, kvh, hd)
    jvc, vc = _bf16(rng, b, c, kvh, hd)
    kw = dict(ring=ring, window=window, softcap=softcap,
              scale=1.0 / math.sqrt(hd))
    nsplit = _nsplit(b, kvh, t, g, c)
    got = _tc_emulation(q, kx, vx, kc, vc, offs, nsplit=nsplit,
                        **kw).to(torch.bfloat16)
    offs_t = torch.tensor(offs, dtype=torch.int32)
    plain = pa_ref.prefill_attention_ref(q, kx, vx, kc, vc, offs_t, **kw)
    jax_out = torch.from_numpy(np.array(jax_pa.prefill_attention_ref(
        jq, jkx, jvx, jkc, jvc, jnp.asarray(np.array(offs, np.int32)),
        **kw).astype(jnp.float32)))
    assert _err(got, plain) <= TOL_BF16
    assert _err(got, jax_out) <= TOL_BF16


PAGED_CASES = {
    # name: (p, ps, b, t, nb, kvh, g, hd, offs, window, softcap)
    "serve path: 2 prefilling rows, 6 passengers": (
        130, 16, 8, 32, 16, 3, 3, 64, [128, 0, 0, 0, 240, 0, 0, 0], None,
        None),
    "window 50 ps24 B3 T17 KVH2 G5 hd40": (
        40, 24, 3, 17, 5, 2, 5, 40, [0, 24, 97], 50, None),
    "window 20 softcap 10 ps8 T16": (
        70, 8, 4, 16, 16, 3, 3, 64, [0, 8, 9, 100], 20, 10.0),
}


@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_tc_emulation_matches_paged_plain_and_jax(case):
    """The paged kernel reads the same values through the page table, so
    its arithmetic is the contiguous one's on the gathered cache (of
    capacity NB * page_size, unwrapped)."""
    p, ps, b, t, nb, kvh, g, hd, offs, window, softcap = PAGED_CASES[case]
    rng = np.random.default_rng(12)
    jq, q = _bf16(rng, b, kvh, t, g, hd)
    jkx, kx = _bf16(rng, b, t, kvh, hd)
    jvx, vx = _bf16(rng, b, t, kvh, hd)
    jkp, kp = _bf16(rng, p, ps, kvh, hd)
    jvp, vp = _bf16(rng, p, ps, kvh, hd)
    table = rng.permutation(np.arange(1, p))[:b * nb].reshape(b, nb)
    table = table.astype(np.int32)
    kw = dict(window=window, softcap=softcap, scale=1.0 / math.sqrt(hd))
    c = nb * ps
    tt = torch.from_numpy(table).long()
    kc = kp[tt].reshape(b, c, kvh, hd)
    vc = vp[tt].reshape(b, c, kvh, hd)
    got = _tc_emulation(q, kx, vx, kc, vc, offs,
                        nsplit=_nsplit(b, kvh, t, g, c),
                        **kw).to(torch.bfloat16)
    offs_t = torch.tensor(offs, dtype=torch.int32)
    plain = pa_ref.prefill_attention_paged_ref(
        q, kx, vx, kp, vp, torch.from_numpy(table), offs_t, **kw)
    jax_out = torch.from_numpy(np.array(jax_pa.prefill_attention_paged_ref(
        jq, jkx, jvx, jkp, jvp, jnp.asarray(table),
        jnp.asarray(np.array(offs, np.int32)), **kw).astype(jnp.float32)))
    assert _err(got, plain) <= TOL_BF16
    assert _err(got, jax_out) <= TOL_BF16


MODES = ("int8", "fp8_e4m3")


def _to_torch(a) -> torch.Tensor:
    """A JAX array as a torch tensor with the same bits (fp8 through its
    byte view)."""
    a = np.asarray(a)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(np.array(a, copy=True))


def _codes(rng, mode, *shape):
    """(JAX codes, torch codes, JAX scales, torch scales) of ``mode``,
    quantized by the JAX package from one numpy array."""
    x = jnp.asarray(rng.standard_normal(shape).astype(np.float32))
    jc, js = jquant.quantize(x, mode)
    return jc, _to_torch(jc), js, _to_torch(js)


@pytest.mark.parametrize("splits", ["one", "design"])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("mode", MODES)
def test_tc_emulation_over_codes_matches_port_plain_and_jax(mode, case,
                                                            splits):
    """CASES with the cache in codes: bf16 q and chunk, the prefix int8 or
    fp8_e4m3 with its row scales, at one split and at the design's."""
    b, t, c, kvh, g, hd, offs, ring, window, softcap = CASES[case]
    rng = np.random.default_rng(21)
    jq, q = _bf16(rng, b, kvh, t, g, hd)
    jkx, kx = _bf16(rng, b, t, kvh, hd)
    jvx, vx = _bf16(rng, b, t, kvh, hd)
    jkc, kc, jks, ks = _codes(rng, mode, b, c, kvh, hd)
    jvc, vc, jvs, vs = _codes(rng, mode, b, c, kvh, hd)
    kw = dict(ring=ring, window=window, softcap=softcap,
              scale=1.0 / math.sqrt(hd))
    nsplit = 1 if splits == "one" else _nsplit(b, kvh, t, g, c)
    got = _tc_emulation(q, kx, vx, kc, vc, offs, nsplit=nsplit, k_scale=ks,
                        v_scale=vs, **kw).to(torch.bfloat16)
    offs_t = torch.tensor(offs, dtype=torch.int32)
    plain = pa_ref.prefill_attention_ref(q, kx, vx, kc, vc, offs_t,
                                         k_scale=ks, v_scale=vs, **kw)
    jax_out = torch.from_numpy(np.array(jax_pa.prefill_attention_ref(
        jq, jkx, jvx, jkc, jvc, jnp.asarray(np.array(offs, np.int32)),
        k_scale=jks, v_scale=jvs, **kw).astype(jnp.float32)))
    assert _err(got, plain) <= TOL_BF16
    assert _err(got, jax_out) <= TOL_BF16


@pytest.mark.parametrize("splits", ["one", "design"])
@pytest.mark.parametrize("case", sorted(PAGED_CASES))
@pytest.mark.parametrize("mode", MODES)
def test_tc_emulation_over_paged_codes_matches_plain_and_jax(mode, case,
                                                             splits):
    """PAGED_CASES with the pools in codes and the scale pools paged with
    them: the kernel reads codes and scales through the same physical
    rows, so its arithmetic is the contiguous one's on the gathered
    codes and scales."""
    p, ps, b, t, nb, kvh, g, hd, offs, window, softcap = PAGED_CASES[case]
    rng = np.random.default_rng(22)
    jq, q = _bf16(rng, b, kvh, t, g, hd)
    jkx, kx = _bf16(rng, b, t, kvh, hd)
    jvx, vx = _bf16(rng, b, t, kvh, hd)
    jkp, kp, jksp, ksp = _codes(rng, mode, p, ps, kvh, hd)
    jvp, vp, jvsp, vsp = _codes(rng, mode, p, ps, kvh, hd)
    table = rng.permutation(np.arange(1, p))[:b * nb].reshape(b, nb)
    table = table.astype(np.int32)
    kw = dict(window=window, softcap=softcap, scale=1.0 / math.sqrt(hd))
    c = nb * ps
    tt = torch.from_numpy(table).long()
    gather = lambda x, *tail: x[tt].reshape(b, c, kvh, *tail)  # noqa: E731
    nsplit = 1 if splits == "one" else _nsplit(b, kvh, t, g, c)
    got = _tc_emulation(q, kx, vx, gather(kp, hd), gather(vp, hd), offs,
                        nsplit=nsplit, k_scale=gather(ksp),
                        v_scale=gather(vsp), **kw).to(torch.bfloat16)
    offs_t = torch.tensor(offs, dtype=torch.int32)
    plain = pa_ref.prefill_attention_paged_ref(
        q, kx, vx, kp, vp, torch.from_numpy(table), offs_t, k_scale=ksp,
        v_scale=vsp, **kw)
    jax_out = torch.from_numpy(np.array(jax_pa.prefill_attention_paged_ref(
        jq, jkx, jvx, jkp, jvp, jnp.asarray(table),
        jnp.asarray(np.array(offs, np.int32)), k_scale=jksp, v_scale=jvsp,
        **kw).astype(jnp.float32)))
    assert _err(got, plain) <= TOL_BF16
    assert _err(got, jax_out) <= TOL_BF16


def test_int8_codes_widen_to_bf16_exactly():
    """All 256 int8 codes: bf16 holds each (8 significant bits), and the
    kernel's widening (the code's byte ^ 0x80 under the exponent byte
    0x4b: the float 2^23 + code + 128, less 2^23 + 128) gives it."""
    codes = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8)
    assert torch.equal(codes.to(torch.bfloat16).float(), codes.float())
    byte = (codes.view(torch.uint8).to(torch.int32) ^ 0x80) | 0x4B000000
    widened = byte.view(torch.float32) - 8388736.0
    assert torch.equal(widened, codes.float())
    assert torch.equal(widened.to(torch.bfloat16).float(), codes.float())


def test_fp8_codes_widen_to_bf16_exactly():
    """Every finite float8_e4m3fn value (254 of the 256 bytes; 4
    significant bits, exponents 2^-9 .. 2^8): bf16 holds each, and so
    does half, through which the kernel widens two codes at a time."""
    codes = torch.arange(256, dtype=torch.int32).to(torch.uint8).view(
        torch.float8_e4m3fn)
    f = codes.float()
    finite = torch.isfinite(f)
    assert int(finite.sum()) == 254
    assert torch.equal(codes.to(torch.bfloat16).float()[finite], f[finite])
    via_half = codes.to(torch.float16).float()
    assert torch.equal(via_half[finite], f[finite])
    assert torch.equal(via_half.to(torch.bfloat16).float()[finite],
                       f[finite])


@pytest.mark.parametrize("nsplit", [2, 5, 8])
def test_one_split_and_many_agree_to_fp32_rounding(nsplit):
    """Splitting moves each partial's running max, so p = 2^(x - m) and
    its p_hi + p_lo (2^-16 of p) round at other points, and the fold
    divides once more: the fp32 outputs (before their bf16 rounding)
    agree to a few fp32 ulps of outputs below 4, far inside one bf16
    step."""
    b, t, c, kvh, g, hd = 2, 32, 1024, 3, 3, 64
    rng = np.random.default_rng(13)
    tensors = [_bf16(rng, *s)[1] for s in (
        (b, kvh, t, g, hd), (b, t, kvh, hd), (b, t, kvh, hd),
        (b, c, kvh, hd), (b, c, kvh, hd))]
    offs = [700, 1024]
    kw = dict(scale=0.125, softcap=30.0)
    one = _tc_emulation(*tensors, offs, nsplit=1, **kw)
    many = _tc_emulation(*tensors, offs, nsplit=nsplit, **kw)
    assert float(one.abs().max()) < 4.0
    assert _err(one, many) <= 16 * 2.0 ** -23 * 4.0


def test_split_count_at_batch_1_and_8():
    """Serve path (T 32, G 3, KVH 3: 96 packed rows, 6 warps, one row
    tile): at batch 1 its 3 groups of rows and at batch 8 its 24 split 8
    ways (the cap: the fold grows with the splits), at batch 64 its 192
    groups 2 ways (two blocks an SM, no more); a short cache splits
    less; groups that fill the card twice do not split."""
    assert pa_kernel.tc_warps(32 * 3) == 6
    assert _nsplit(1, 3, 32, 3, 1024) == 8
    assert _nsplit(8, 3, 32, 3, 1024) == 8
    assert _nsplit(64, 3, 32, 3, 1024) == 2
    assert _nsplit(1, 3, 32, 3, 128) == 2
    assert _nsplit(1, 3, 32, 3, 16) == 1
    assert pa_kernel.split_count(264, 4096) == 1
    assert pa_kernel.split_count(1, 10 ** 6) == pa_kernel.TC_MAX_SPLITS


@pytest.mark.parametrize("start,limit,nsplit", [
    (0, 512, 8), (0, 80, 8), (0, 81, 8), (0, 0, 6), (5, 3, 4),
    (449, 1024, 6), (0, 1, 1), (0, 1000, 7)])
def test_split_range_covers_the_range_once(start, limit, nsplit):
    """The shares tile [start, limit) in order with no gap or overlap,
    each a multiple of 16 keys but the last non-empty one; a prefix that
    ends on a share boundary (80 = 5 x 16) leaves the later splits
    empty; an empty range gives nothing to any split."""
    spans = [split_kv.split_range(start, limit, nsplit, s)
             for s in range(nsplit)]
    keys = [k for lo, hi in spans for k in range(lo, hi)]
    assert keys == list(range(start, max(start, limit)))
    full = [hi - lo for lo, hi in spans if hi > lo]
    assert all(n % 16 == 0 for n in full[:-1])
    if (start, limit) == (0, 80):
        assert [hi - lo for lo, hi in spans] == [16] * 5 + [0] * 3


def test_tc_kernel_takes_bf16_heads_up_to_128():
    """bf16 q over a bf16 cache or codes (int8, fp8_e4m3), heads up to 128
    wide; fp32 q, over any cache, and a bf16 q over an fp32 cache take the
    CUDA-core kernel."""
    bf, f32 = torch.bfloat16, torch.float32
    i8, f8 = torch.int8, torch.float8_e4m3fn
    assert pa_kernel.uses_tensor_cores(bf, bf, 64, 64)
    assert pa_kernel.uses_tensor_cores(bf, bf, 40, 40)
    assert pa_kernel.uses_tensor_cores(bf, bf, 128, 96)
    assert not pa_kernel.uses_tensor_cores(bf, bf, 256, 256)
    assert not pa_kernel.uses_tensor_cores(f32, f32, 64, 64)
    assert not pa_kernel.uses_tensor_cores(bf, f32, 64, 64)
    assert pa_kernel.uses_tensor_cores(bf, i8, 64, 64)
    assert pa_kernel.uses_tensor_cores(bf, f8, 36, 36)
    assert pa_kernel.uses_tensor_cores(bf, i8, 128, 128)
    assert not pa_kernel.uses_tensor_cores(bf, i8, 256, 256)
    assert not pa_kernel.uses_tensor_cores(f32, i8, 64, 64)
    assert not pa_kernel.uses_tensor_cores(f32, f8, 64, 64)
