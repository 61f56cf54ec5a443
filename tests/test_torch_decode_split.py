"""The split-KV flash-decode kernel's arithmetic, on the CPU.

The kernel (``csrc/decode_attention.cu``) runs only on the card, where
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold it to its plain
version.  Here its arithmetic is emulated in plain torch: each row's
attendable range [first, last] cut into the splits' shares; in a split,
each key group's own online softmax (log2 units, a tile of keys at a
time, masked keys past the share's end weighing 0: -inf against a
running max that starts at the finite NEG_INF); the groups of a warp
merged by the kernel's shuffle tree, the warps in order, the splits'
partials folded in split order with weights 2^(m_s - M) / L; codes
dequantized as float(code) * scale before the dot product.  The
emulation must agree with the port's plain versions and with the JAX
package's refs on the same numpy inputs within TOL (2e-5 in float32,
2^-6 + 2e-5 in bf16: one bf16 rounding step of outputs below 4, the
tolerance chip_smoke.py holds the kernel to), contiguous and paged,
over bf16, int8 and fp8_e4m3 caches; a row with no attendable key gives
exactly 0; one split and many agree to fp32 rounding; the split count
is what the design says at batch 1 and 8; and every slot in
[first, last] is one the plain versions attend, the ground for the
kernel's testing no slot inside its range.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from strategies import given, settings, st  # noqa: E402

from repro.kernels import quant as jquant  # noqa: E402
from repro.kernels.decode_attention import ref as jax_da  # noqa: E402
from repro_torch.kernels import split_kv  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as da_kernel  # noqa: E402
from repro_torch.kernels.decode_attention import ref as da_ref  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain versions here run many small torch ops: torch's intra-op
    threads only contend, with JAX's and with the other workers of a
    parallel run.  Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -6 + 2e-5}
NEG = -2.0 ** 30
LOG2E = 1.4426950408889634
WARPS = da_kernel.WARPS


def _layout(hd, hdv, itemsize):
    """Key groups a warp, and keys a group takes a tile, as the source's
    ``Shape<D>`` and ``KPG``."""
    d = da_kernel.width(hd, hdv)
    lanes = min(32, d // 8)
    chunks = d // (8 * lanes)
    return 32 // lanes, max(1, 4 // (chunks * (2 if itemsize == 4 else 1)))


def _merge(a, b):
    """Partial a merged with partial b, a's terms first."""
    (ma, la, xa), (mb, lb, xb) = a, b
    mx = torch.maximum(ma, mb)
    wa, wb = torch.exp2(ma - mx), torch.exp2(mb - mx)
    return mx, wa * la + wb * lb, wa[..., None] * xa + wb[..., None] * xb


def _split_partial(qs, kf, vf, lo, hi, gpw, kpg, softcap):
    """One split's (m, l, acc) over keys [lo, hi) for the query rows qs
    (G, hd): per key group (WARPS x gpw of them, kpg keys a tile), then
    the warp's shuffle tree, then the warps in order."""
    ng, g, hdv = WARPS * gpw, qs.shape[0], vf.shape[-1]
    m = torch.full((ng, g), NEG)
    l = torch.zeros((ng, g))
    acc = torch.zeros((ng, g, hdv))
    for base in range(lo, hi, ng * kpg):
        pos = base + torch.arange(ng)[:, None] * kpg + torch.arange(kpg)
        on = pos < hi
        idx = pos.clamp(max=hi - 1)
        s = torch.einsum("gd,nkd->nkg", qs, kf[idx])
        if softcap is not None:
            s = torch.tanh(s * (1.0 / softcap)) * softcap
        s = torch.where(on[..., None], s * LOG2E, -torch.inf)
        mx = torch.maximum(m, s.amax(1))
        alpha = torch.exp2(m - mx)
        p = torch.exp2(s - mx[:, None, :])
        l = alpha * l + p.sum(1)
        acc = alpha[..., None] * acc + torch.einsum("nkg,nkd->ngd", p,
                                                    vf[idx])
        m = mx
    m, l, acc = (x.reshape(WARPS, gpw, *x.shape[1:]) for x in (m, l, acc))
    off = 1
    while off < gpw:  # lane x takes x ^ off's partial, its own first
        part = torch.arange(gpw) ^ off
        m, l, acc = _merge((m, l, acc), (m[:, part], l[:, part],
                                         acc[:, part]))
        off *= 2
    m, l, acc = m[:, 0], l[:, 0], acc[:, 0]
    mx = m.amax(0)
    w = torch.exp2(m - mx)
    big_l, big_a = torch.zeros(g), torch.zeros((g, hdv))
    for i in range(WARPS):
        big_l = big_l + w[i] * l[i]
        big_a = big_a + w[i][:, None] * acc[i]
    return mx, big_l, big_a


def _emulate(q, k, v, lens, *, first_of, nsplit, softcap=None, scale=1.0,
             k_scale=None, v_scale=None):
    """q (B, KVH, G, hd); k, v (B, C, KVH, hd/hdv), the logical cache
    (a paged one gathered through its table); k_scale/v_scale (B, C,
    KVH) of code caches; ``first_of(lens[b])`` the row's first
    attendable slot -> the fp32 output (B, KVH, G, hdv), before its
    rounding to q's dtype."""
    b_, kvh, g, hd = q.shape
    c, hdv = k.shape[1], v.shape[-1]
    gpw, kpg = _layout(hd, hdv, k.element_size())
    out = torch.zeros((b_, kvh, g, hdv))
    for b in range(b_):
        cur = int(lens[b])
        first, last = first_of(cur), min(cur, c - 1)
        for h in range(kvh):
            qs = q[b, h].float() * scale
            kf, vf = k[b, :, h].float(), v[b, :, h].float()
            if k_scale is not None:
                kf = kf * k_scale[b, :, h, None]
                vf = vf * v_scale[b, :, h, None]
            parts = []
            for s in range(nsplit):
                lo, hi = split_kv.split_range(first, last + 1, nsplit, s)
                if hi > lo:
                    parts.append(_split_partial(qs, kf, vf, lo, hi, gpw,
                                                kpg, softcap))
            if not parts:
                continue                  # no attendable key: exactly 0
            if nsplit == 1:
                m, l, acc = parts[0]
                out[b, h] = acc / l.clamp_min(1e-30)[:, None]
                continue
            mx = torch.stack([p[0] for p in parts]).amax(0)
            w = [torch.exp2(p[0] - mx) for p in parts]
            inv = 1.0 / sum(wi * p[1] for wi, p in zip(w, parts)).clamp_min(
                1e-30)
            res = torch.zeros((g, hdv))
            for wi, p in zip(w, parts):
                res = res + (wi * inv)[:, None] * p[2]
            out[b, h] = res
    return out


def _nsplit(b, kvh, g, hd, c):
    groups = b * kvh * math.ceil(g / da_kernel.heads_per_block(hd, hd))
    return da_kernel.split_count(groups, c)


def _to_torch(a) -> torch.Tensor:
    """A JAX array as a torch tensor with the same bits (fp8 through its
    byte view)."""
    a = np.asarray(a)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(np.array(a, copy=True))


def _cache(rng, shape, mode):
    """(JAX cache, torch cache, JAX scales, torch scales): bf16 values,
    or ``mode``'s codes and row scales quantized from them."""
    x = jnp.asarray(rng.standard_normal(shape).astype(np.float32))
    if mode is None:
        jx = x.astype(jnp.bfloat16)
        return jx, _to_torch(jx.astype(jnp.float32)).to(torch.bfloat16), \
            None, None
    jc, js = jquant.quantize(x, mode)
    return jc, _to_torch(jc), js, _to_torch(js)


def _err(a, b):
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


CASES = {
    # name: (b, c, kvh, g, hd, lens, ring, softcap)
    "main B8 C1024 KVH3 G3 hd64": (8, 1024, 3, 3, 64,
                                   [0, 1, 511, 1023, 37, 300, 700, 1000],
                                   False, None),
    "ring C256 wrapped": (8, 256, 3, 3, 64,
                          [0, 1, 100, 255, 256, 300, 1000, 5000], True,
                          None),
    "softcap 30": (8, 1024, 3, 3, 64, [0, 1, 511, 1023, 37, 300, 700, 1000],
                   False, 30.0),
    "odd B3 C1000 KVH2 G4 hd48": (3, 1000, 2, 4, 48, [0, 999, 517], False,
                                  None),
    # one row alone takes 8 splits; ranges ending on the 8 splits' shares
    "split B1 one row at 1023": (1, 1024, 3, 3, 64, [1023], False, None),
    "split share boundaries": (8, 1024, 3, 3, 64,
                               [15, 16, 79, 127, 128, 255, 256, 1023],
                               False, None),
}


@pytest.mark.parametrize("mode,case", [(None, c) for c in sorted(CASES)]
                         + [("int8", "main B8 C1024 KVH3 G3 hd64"),
                            ("fp8_e4m3", "main B8 C1024 KVH3 G3 hd64")])
def test_split_emulation_matches_port_plain_and_jax(mode, case):
    b, c, kvh, g, hd, lens, ring, softcap = CASES[case]
    rng = np.random.default_rng(21)
    jq = jnp.asarray(rng.standard_normal((b, kvh, g, hd)).astype(
        np.float32)).astype(jnp.bfloat16)
    q = _to_torch(jq.astype(jnp.float32)).to(torch.bfloat16)
    jk, k, jks, ks = _cache(rng, (b, c, kvh, hd), mode)
    jv, v, jvs, vs = _cache(rng, (b, c, kvh, hd), mode)
    kw = dict(ring=ring, softcap=softcap, scale=1.0 / math.sqrt(hd))
    lens_t = torch.tensor(lens, dtype=torch.int32)
    got = _emulate(q, k, v, lens, first_of=lambda n: 0,
                   nsplit=_nsplit(b, kvh, g, hd, c), softcap=softcap,
                   scale=kw["scale"], k_scale=ks,
                   v_scale=vs).to(torch.bfloat16)
    plain = da_ref.decode_attention_ref(q, k, v, lens_t, k_scale=ks,
                                        v_scale=vs, **kw)
    jax_out = _to_torch(jax_da.decode_attention_ref(
        jq, jk, jv, jnp.asarray(np.array(lens, np.int32)), k_scale=jks,
        v_scale=jvs, **kw).astype(jnp.float32))
    assert _err(got, plain) <= TOL[torch.bfloat16]
    assert _err(got, jax_out) <= TOL[torch.bfloat16]


PAGED_CASES = {
    # name: (p, ps, b, nb, kvh, g, hd, lens, window, softcap); a row whose
    # window starts past its table's end attends no key
    "main P513 ps16 B8 NB64": (513, 16, 8, 64, 3, 3, 64,
                               [0, 1, 15, 16, 511, 1023, 700, 1500], None,
                               None),
    "window 100 ps24 KVH2 G4 hd48": (60, 24, 8, 6, 2, 4, 48,
                                     [0, 5, 23, 24, 25, 143, 200, 400], 100,
                                     None),
}


@pytest.mark.parametrize("mode,case", [
    (None, "main P513 ps16 B8 NB64"), (None, "window 100 ps24 KVH2 G4 hd48"),
    ("int8", "window 100 ps24 KVH2 G4 hd48"),
    ("fp8_e4m3", "window 100 ps24 KVH2 G4 hd48")])
def test_split_emulation_matches_paged_plain_and_jax(mode, case):
    """The paged kernel reads the same values through the page table, so
    its arithmetic is the contiguous one's on the gathered cache (of
    capacity NB * page_size, never wrapped); a dead row is exactly 0,
    where the plain versions give the mean of the values."""
    p, ps, b, nb, kvh, g, hd, lens, window, softcap = PAGED_CASES[case]
    rng = np.random.default_rng(22)
    jq = jnp.asarray(rng.standard_normal((b, kvh, g, hd)).astype(
        np.float32)).astype(jnp.bfloat16)
    q = _to_torch(jq.astype(jnp.float32)).to(torch.bfloat16)
    jk, kp, jks, ksp = _cache(rng, (p, ps, kvh, hd), mode)
    jv, vp, jvs, vsp = _cache(rng, (p, ps, kvh, hd), mode)
    table = rng.permutation(np.arange(1, p))[:b * nb].reshape(b, nb)
    table = table.astype(np.int32)
    c = nb * ps
    tt = torch.from_numpy(table).long()
    gather = lambda x: None if x is None else x[tt].reshape(b, c,
                                                           *x.shape[2:])
    first_of = (lambda n: max(n - window + 1, 0)) if window else \
        (lambda n: 0)
    kw = dict(window=window, softcap=softcap, scale=1.0 / math.sqrt(hd))
    got = _emulate(q, gather(kp), gather(vp), lens, first_of=first_of,
                   nsplit=_nsplit(b, kvh, g, hd, c), softcap=softcap,
                   scale=kw["scale"], k_scale=gather(ksp),
                   v_scale=gather(vsp)).to(torch.bfloat16)
    lens_t = torch.tensor(lens, dtype=torch.int32)
    plain = da_ref.decode_attention_paged_ref(
        q, kp, vp, torch.from_numpy(table), lens_t, k_scale=ksp,
        v_scale=vsp, **kw)
    jax_out = _to_torch(jax_da.decode_attention_paged_ref(
        jq, jk, jv, jnp.asarray(table), jnp.asarray(np.array(lens,
                                                             np.int32)),
        k_scale=jks, v_scale=jvs, **kw).astype(jnp.float32))
    dead = [i for i, n in enumerate(lens) if first_of(n) > min(n, c - 1)]
    live = [i for i in range(b) if i not in dead]
    assert dead == ([7] if window else [])
    assert _err(got[live], plain[live]) <= TOL[torch.bfloat16]
    assert _err(got[live], jax_out[live]) <= TOL[torch.bfloat16]
    assert torch.equal(got[dead], torch.zeros_like(got[dead]))


@pytest.mark.parametrize("nsplit", [2, 5, 8, 16])
def test_one_split_and_many_agree_to_fp32_rounding(nsplit):
    """Splitting moves each partial's running max and adds one fold, so
    the fp32 outputs (before their rounding to q's dtype) agree to a few
    fp32 ulps of outputs below 4, far inside TOL; float32 inputs, where
    a key group takes 2 keys a tile."""
    b, c, kvh, g, hd = 2, 1024, 3, 3, 64
    rng = np.random.default_rng(23)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((b, kvh, g, hd), (b, c, kvh, hd), (b, c, kvh, hd)))
    kw = dict(first_of=lambda n: 0, softcap=30.0, scale=0.125)
    one = _emulate(q, k, v, [700, 1023], nsplit=1, **kw)
    many = _emulate(q, k, v, [700, 1023], nsplit=nsplit, **kw)
    assert float(one.abs().max()) < 4.0
    assert _err(one, many) <= 16 * 2.0 ** -23 * 4.0
    plain = da_ref.decode_attention_ref(
        q, k, v, torch.tensor([700, 1023], dtype=torch.int32),
        softcap=30.0, scale=0.125)
    assert _err(many, plain) <= TOL[torch.float32]


def test_split_count_at_the_serve_shapes():
    """smollm-135m's decode (3 kv heads, 3 query heads each: one head
    group a kv head) over a 1024-slot cache: batch 1's 3 blocks and
    batch 8's 24 split MAX_SPLITS ways (the fold grows with the splits),
    batch 64's 192 twice (two blocks an SM); a short cache splits less;
    blocks that fill the card twice do not split.  A block takes 4
    query heads, 2 past D 256."""
    assert _nsplit(1, 3, 3, 64, 1024) == da_kernel.MAX_SPLITS == 8
    assert _nsplit(8, 3, 3, 64, 1024) == 8
    assert _nsplit(64, 3, 3, 64, 1024) == 2
    assert _nsplit(1, 3, 3, 64, 128) == 2
    assert _nsplit(1, 3, 3, 64, 16) == 1
    assert da_kernel.split_count(264, 4096) == 1
    assert [da_kernel.width(h, h) for h in (40, 64, 65, 256, 300, 512)] \
        == [64, 64, 128, 256, 512, 512]
    assert da_kernel.width(576, 512) == 0
    assert [da_kernel.heads_per_block(h, h) for h in (64, 256, 512)] \
        == [4, 4, 2]
    assert da_kernel.MAX_SPLITS <= da_kernel.KERNEL_SPLITS == 16


@pytest.mark.parametrize("first,last,nsplit", [
    (0, 1023, 8), (0, 0, 8), (0, 79, 8), (0, 127, 8), (0, 128, 8),
    (1, 0, 8), (301, 400, 8), (925, 1023, 16), (0, 999, 7)])
def test_split_range_covers_each_range_once(first, last, nsplit):
    """The shares tile [first, last] in order with no gap or overlap,
    each a multiple of 16 keys but the last non-empty one; an empty
    range (a dead row) gives nothing to any split."""
    spans = [split_kv.split_range(first, last + 1, nsplit, s)
             for s in range(nsplit)]
    keys = [k for lo, hi in spans for k in range(lo, hi)]
    assert keys == list(range(first, max(first, last + 1)))
    full = [hi - lo for lo, hi in spans if hi > lo]
    assert all(n % 16 == 0 for n in full[:-1])


def _attended(out):
    """The slots a plain version attended: with q = 0 every attended key
    weighs the same, and value rows one-hot on their slot make the
    output that weight on exactly those slots."""
    return set(torch.nonzero(out.flatten() > 0).flatten().tolist())


@settings(max_examples=40, deadline=None, database=None)
@given(c=st.integers(1, 96), cur=st.integers(0, 400), ring=st.booleans(),
       window=st.integers(0, 120), ps=st.sampled_from([1, 4, 8, 16]))
def test_every_slot_in_first_last_is_attended(c, cur, ring, window, ps):
    """Every slot in [first, last] passes the plain versions' masks, and
    no other slot does: a ring below its size holds positions 0..lens, a
    wrapped ring all C; without a ring slot == position, so
    col <= lens and lens - col < window hold by construction.  The
    kernel reads exactly [first, last] and tests no slot in it."""
    lens = torch.tensor([cur], dtype=torch.int32)
    q = torch.zeros(1, 1, 1, 4)
    onehot = lambda n: torch.eye(n).reshape(1, n, 1, n)
    got = da_ref.decode_attention_ref(q, torch.zeros(1, c, 1, 4), onehot(c),
                                      lens, ring=ring, block_k=8)
    assert _attended(got) == set(range(0, min(cur, c - 1) + 1))
    nb = -(-c // ps)
    cap = nb * ps
    win = window or None
    first = max(cur - window + 1, 0) if win else 0
    last = min(cur, cap - 1)
    if first > last:                 # no attendable key: the kernel gives 0
        return
    table = torch.arange(nb, dtype=torch.int32).reshape(1, nb)
    pool = lambda x: x.reshape(nb, ps, *x.shape[2:])
    got = da_ref.decode_attention_paged_ref(
        q, pool(torch.zeros(1, cap, 1, 4)), pool(onehot(cap)), table, lens,
        window=win)
    assert _attended(got) == set(range(first, last + 1))
