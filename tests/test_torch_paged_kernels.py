"""The port's paged kernel modules against the JAX package's oracles.

Each paged plain version of the port must compute what the JAX paged
``ref.py`` computes on the same numpy inputs: the scatter exactly
outside the scratch page 0 (whose content is undefined by contract),
the attention folds at the tolerances of tests/test_torch_kernels.py
(fp32 1e-5: fp32 blockwise folds over the same one-page blocks that
differ only in einsum summation order; bf16 one rounding step, 2^-6,
more).  Page tables are shuffled and non-contiguous, page sizes do not
divide the kernels' 64-key tile, and offsets sit at, just past and just
before a page boundary, and at 0 (no cache page read).

The ops' layouts are held against the JAX ops with ``impl="lax"``; on
the CPU the ops count no launch, and the CUDA wrappers refuse tensors
that are not on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.cache_update import ops as jax_cu_ops  # noqa: E402
from repro.kernels.cache_update import ref as jax_cu  # noqa: E402
from repro.kernels.decode_attention import ops as jax_da_ops  # noqa: E402
from repro.kernels.decode_attention import ref as jax_da  # noqa: E402
from repro.kernels.prefill_attention import ops as jax_pa_ops  # noqa: E402
from repro.kernels.prefill_attention import ref as jax_pa  # noqa: E402
from repro_torch.kernels.cache_update import kernel as cu_kernel  # noqa: E402
from repro_torch.kernels.cache_update import ops as cu_ops  # noqa: E402
from repro_torch.kernels.cache_update import ref as cu_ref  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as da_kernel  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.kernels.decode_attention import ref as da_ref  # noqa: E402
from repro_torch.kernels.prefill_attention import kernel as pa_kernel  # noqa: E402
from repro_torch.kernels.prefill_attention import ops as pa_ops  # noqa: E402
from repro_torch.kernels.prefill_attention import ref as pa_ref  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6 + 1e-5}
H, HD = 6, 16


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, jnp.float32).astype(dtype)
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        getattr(torch, dtype))
    return j, t


def _close(j, t, dtype):
    a = np.asarray(jnp.asarray(j, jnp.float32))
    b = t.float().numpy()
    assert a.shape == b.shape
    err = float(np.max(np.abs(a - b))) if a.size else 0.0
    assert err <= TOL[dtype], f"max |err| {err} > {TOL[dtype]}"


def _table(rng, b, nb, num_pages, masked=()):
    """(b, nb) int32 of distinct shuffled pages 1..num_pages-1; rows in
    ``masked`` map every block to the scratch page 0."""
    ids = rng.permutation(np.arange(1, num_pages))[:b * nb].reshape(b, nb)
    ids[list(masked)] = 0
    return ids.astype(np.int32)


def _f32(t):
    return np.asarray(jnp.asarray(t, jnp.float32)) \
        if not isinstance(t, torch.Tensor) else t.float().numpy()


# -- paged cache_update ---------------------------------------------------------

SCATTER_CASES = {
    # name: (num_pages, ps, b, nb, t, starts, valids, masked rows)
    "decode": (20, 8, 4, 4, 1, [0, 7, 8, 31], [1, 1, 1, 1], ()),
    "decode-dead-rows-past-table": (20, 8, 4, 4, 1, [40, 9, 100, 3],
                                    [1, 1, 1, 0], (0,)),
    "chunk-passengers": (30, 8, 3, 4, 16, [0, 9, 15], [16, 0, 11], ()),
    "ps24-chunk": (12, 24, 2, 3, 7, [23, 50], [7, 5], ()),
    "ps5-odd": (25, 5, 3, 6, 4, [0, 4, 26], [4, 2, 4], ()),
}


@pytest.mark.parametrize("case,dtype", [
    (c, "float32") for c in sorted(SCATTER_CASES)]
    + [("chunk-passengers", "bfloat16")])
def test_paged_cache_update_ref_matches_jax_outside_page_0(case, dtype):
    p, ps, b, nb, t, starts, valids, masked = SCATTER_CASES[case]
    rng = np.random.default_rng(0)
    pool = rng.standard_normal((p, ps, 2, 3))
    new = rng.standard_normal((b, t, 2, 3))
    table = _table(rng, b, nb, p, masked)
    st, va = np.array(starts, np.int32), np.array(valids, np.int32)
    jp, tp = _pair(pool, dtype)
    jn, tn = _pair(new, dtype)
    want = jax_cu.paged_cache_update_ref(jp, jn, jnp.asarray(table),
                                         jnp.asarray(st), jnp.asarray(va))
    got = cu_ref.paged_cache_update_ref(tp, tn, torch.from_numpy(table),
                                        torch.from_numpy(st),
                                        torch.from_numpy(va))
    assert got is tp                                  # updated in place
    np.testing.assert_array_equal(_f32(want)[1:], _f32(got)[1:])


def test_masked_rows_leave_every_real_page_bit_identical():
    """Rows at ``t >= valids[b]`` (passengers, a final chunk's padding)
    touch no real page, whatever their page-table row maps."""
    rng = np.random.default_rng(1)
    p, ps, b, nb, t = 24, 8, 3, 5, 16
    pool = torch.from_numpy(rng.standard_normal((p, ps, 2, 4)).astype(
        np.float32))
    before = pool.clone()
    table = torch.from_numpy(_table(rng, b, nb, p))
    starts = torch.tensor([0, 5, 30], dtype=torch.int32)
    valids = torch.tensor([0, 3, 0], dtype=torch.int32)
    new = torch.from_numpy(rng.standard_normal((b, t, 2, 4)).astype(
        np.float32))
    cu_ops.paged_cache_update(pool, new, table, starts, valids)
    written = {int(table[1, (5 + i) // ps]) * ps + (5 + i) % ps
               for i in range(3)}
    flat, flat0 = pool.view(p * ps, -1), before.view(p * ps, -1)
    for row in range(ps, p * ps):
        if row in written:
            continue
        assert torch.equal(flat[row], flat0[row]), f"row {row} changed"
    for i in range(3):
        r = int(table[1, (5 + i) // ps]) * ps + (5 + i) % ps
        assert torch.equal(flat[r], new[1, i].reshape(-1))


def test_paged_cache_update_op_matches_jax_lax_layout():
    rng = np.random.default_rng(2)
    pool = rng.standard_normal((16, 8, 3, 4))
    new = rng.standard_normal((2, 8, 3, 4))
    table = _table(rng, 2, 3, 16)
    st, va = np.array([3, 16], np.int32), np.array([8, 6], np.int32)
    want = jax_cu_ops.paged_cache_update(
        jnp.asarray(pool, jnp.float32), jnp.asarray(new, jnp.float32),
        jnp.asarray(table), jnp.asarray(st), jnp.asarray(va), impl="lax")
    got = cu_ops.paged_cache_update(
        torch.from_numpy(pool.astype(np.float32)),
        torch.from_numpy(new.astype(np.float32)), torch.from_numpy(table),
        torch.from_numpy(st), torch.from_numpy(va))
    np.testing.assert_array_equal(_f32(want)[1:], _f32(got)[1:])


# -- paged decode attention ------------------------------------------------------

DECODE_CASES = {
    # name: (kvh, num_pages, ps, nb, lens, window, softcap, masked rows)
    "gqa3-ps8": (2, 20, 8, 4, [0, 7, 8, 31], None, None, ()),
    "mqa-ps24": (1, 14, 24, 3, [0, 23, 24, 71], None, None, ()),
    "mha-ps5": (6, 30, 5, 6, [4, 5, 6, 29], None, None, ()),
    "window-ps8": (2, 20, 8, 4, [0, 9, 20, 31], 6, None, ()),
    "softcap-ps8": (2, 20, 8, 4, [0, 7, 8, 31], None, 5.0, ()),
    "window-softcap-ps24": (3, 14, 24, 3, [30, 50, 71, 5], 17, 4.0, ()),
    "dead-rows-past-table": (2, 20, 8, 4, [40, 3, 100, 18], None, None,
                             (0,)),
}


@pytest.mark.parametrize("case,dtype", [
    (c, "float32") for c in sorted(DECODE_CASES)]
    + [("gqa3-ps8", "bfloat16"), ("window-softcap-ps24", "bfloat16")])
def test_decode_attention_paged_ref_matches_jax(case, dtype):
    kvh, p, ps, nb, lens, window, cap, masked = DECODE_CASES[case]
    rng = np.random.default_rng(3)
    b, g = len(lens), H // kvh
    jq, tq = _pair(rng.standard_normal((b, kvh, g, HD)), dtype)
    jk, tk = _pair(rng.standard_normal((p, ps, kvh, HD)), dtype)
    jv, tv = _pair(rng.standard_normal((p, ps, kvh, HD)), dtype)
    table = _table(rng, b, nb, p, masked)
    lens_np = np.array(lens, np.int32)
    kw = dict(window=window, softcap=cap, scale=HD ** -0.5)
    want = jax_da.decode_attention_paged_ref(
        jq, jk, jv, jnp.asarray(table), jnp.asarray(lens_np), **kw)
    got = da_ref.decode_attention_paged_ref(
        tq, tk, tv, torch.from_numpy(table), torch.from_numpy(lens_np), **kw)
    _close(want, got, dtype)


def test_decode_attention_paged_op_matches_jax_lax_layout():
    rng = np.random.default_rng(4)
    b, kvh, p, ps, nb = 3, 2, 20, 8, 4
    q = rng.standard_normal((b, 1, H, HD))
    k = rng.standard_normal((p, ps, kvh, HD))
    v = rng.standard_normal((p, ps, kvh, HD))
    table = _table(rng, b, nb, p)
    lens = np.array([0, 12, 31], np.int32)
    kw = dict(window=10, softcap=5.0, scale=HD ** -0.5)
    want = jax_da_ops.decode_attention_paged(
        *(jnp.asarray(x, jnp.float32) for x in (q, k, v)),
        jnp.asarray(table), jnp.asarray(lens), impl="lax", **kw)
    got = da_ops.decode_attention_paged(
        *(torch.from_numpy(x.astype(np.float32)) for x in (q, k, v)),
        torch.from_numpy(table), torch.from_numpy(lens), **kw)
    _close(want, got, "float32")


# -- paged prefill attention ------------------------------------------------------

PREFILL_CASES = {
    # name: (kvh, num_pages, ps, nb, t, offs, window, softcap)
    "gqa3-ps8": (2, 24, 8, 5, 16, [0, 8, 9, 7], None, None),
    "mqa-ps24": (1, 14, 24, 3, 8, [0, 24, 25, 23], None, None),
    "mha-ps5-t6": (6, 30, 5, 6, 6, [0, 5, 6, 24], None, None),
    "window-ps8": (2, 24, 8, 5, 16, [0, 8, 17, 24], 6, None),
    "softcap-ps8": (2, 24, 8, 5, 16, [0, 8, 9, 7], None, 5.0),
    "window-softcap-ps24": (3, 14, 24, 3, 8, [30, 47, 48, 5], 17, 4.0),
}


@pytest.mark.parametrize("case,dtype", [
    (c, "float32") for c in sorted(PREFILL_CASES)]
    + [("gqa3-ps8", "bfloat16"), ("window-softcap-ps24", "bfloat16")])
def test_prefill_attention_paged_ref_matches_jax(case, dtype):
    kvh, p, ps, nb, t, offs, window, cap = PREFILL_CASES[case]
    rng = np.random.default_rng(5)
    b, g = len(offs), H // kvh
    jq, tq = _pair(rng.standard_normal((b, kvh, t, g, HD)), dtype)
    jkx, tkx = _pair(rng.standard_normal((b, t, kvh, HD)), dtype)
    jvx, tvx = _pair(rng.standard_normal((b, t, kvh, HD)), dtype)
    jk, tk = _pair(rng.standard_normal((p, ps, kvh, HD)), dtype)
    jv, tv = _pair(rng.standard_normal((p, ps, kvh, HD)), dtype)
    table = _table(rng, b, nb, p)
    offs_np = np.array(offs, np.int32)
    kw = dict(window=window, softcap=cap, scale=HD ** -0.5)
    want = jax_pa.prefill_attention_paged_ref(
        jq, jkx, jvx, jk, jv, jnp.asarray(table), jnp.asarray(offs_np), **kw)
    got = pa_ref.prefill_attention_paged_ref(
        tq, tkx, tvx, tk, tv, torch.from_numpy(table),
        torch.from_numpy(offs_np), **kw)
    _close(want, got, dtype)


def test_prefill_attention_paged_op_matches_jax_lax_layout():
    rng = np.random.default_rng(6)
    b, t, kvh, p, ps, nb = 3, 8, 2, 24, 8, 5
    q = rng.standard_normal((b, t, H, HD))
    kx = rng.standard_normal((b, t, kvh, HD))
    vx = rng.standard_normal((b, t, kvh, HD))
    k = rng.standard_normal((p, ps, kvh, HD))
    v = rng.standard_normal((p, ps, kvh, HD))
    table = _table(rng, b, nb, p)
    offs = np.array([0, 9, 30], np.int32)
    kw = dict(window=12, softcap=5.0, scale=HD ** -0.5)
    want = jax_pa_ops.prefill_attention_paged(
        *(jnp.asarray(x, jnp.float32) for x in (q, kx, vx, k, v)),
        jnp.asarray(table), jnp.asarray(offs), impl="lax", **kw)
    got = pa_ops.prefill_attention_paged(
        *(torch.from_numpy(x.astype(np.float32)) for x in (q, kx, vx, k, v)),
        torch.from_numpy(table), torch.from_numpy(offs), **kw)
    _close(want, got, "float32")


# -- dispatch: CPU tensors take the plain path, CUDA wrappers refuse CPU ----

def test_paged_ops_on_cpu_count_no_launch():
    for mod in (cu_kernel, da_kernel, pa_kernel):
        mod.paged_launches = 0
    rng = np.random.default_rng(7)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    table = torch.from_numpy(_table(rng, 2, 3, 12))
    pool = f(12, 8, 2, 4)
    cu_ops.paged_cache_update(pool, f(2, 4, 2, 4), table,
                              torch.tensor([0, 9]), torch.tensor([4, 2]))
    da_ops.decode_attention_paged(f(2, 1, 6, 4), pool, pool, table,
                                  torch.tensor([3, 10]))
    pa_ops.prefill_attention_paged(f(2, 4, 6, 4), f(2, 4, 2, 4),
                                   f(2, 4, 2, 4), pool, pool, table, 5)
    assert (cu_kernel.paged_launches, da_kernel.paged_launches,
            pa_kernel.paged_launches) == (0, 0, 0)


def test_paged_cuda_wrappers_refuse_cpu_tensors():
    i32 = lambda *s: torch.zeros(s, dtype=torch.int32)
    with pytest.raises(ValueError, match="on the card"):
        cu_kernel.paged_cache_update_cuda(
            torch.zeros(4, 8, 6), torch.zeros(2, 1, 6), i32(2, 3), i32(2),
            i32(2))
    with pytest.raises(ValueError, match="on the card"):
        da_kernel.decode_attention_paged_cuda(
            torch.zeros(2, 1, 3, 8), torch.zeros(4, 8, 1, 8),
            torch.zeros(4, 8, 1, 8), i32(2, 3), i32(2))
    with pytest.raises(ValueError, match="on the card"):
        pa_kernel.prefill_attention_paged_cuda(
            torch.zeros(2, 1, 4, 3, 8), torch.zeros(2, 4, 1, 8),
            torch.zeros(2, 4, 1, 8), torch.zeros(4, 8, 1, 8),
            torch.zeros(4, 8, 1, 8), i32(2, 3), i32(2))


def test_paged_later_slice_options_raise():
    """No option raises any more: MLA's ``v_width`` gives the values'
    width, and quantized pools with their scale pools give a result."""
    q, pool, table = torch.zeros(1, 1, 2, 4), torch.zeros(3, 4, 1, 4), \
        torch.ones(1, 2, dtype=torch.int32)
    out = da_ops.decode_attention_paged(q, pool, pool, table, 0, v_width=2)
    assert out.shape == (1, 1, 2, 2) and torch.isfinite(out).all()
    codes, scales = torch.ones(3, 4, 1, 4, dtype=torch.int8), \
        torch.ones(3, 4, 1)
    out = da_ops.decode_attention_paged(q, codes, codes, table, 0,
                                        k_scale=scales)
    assert out.shape == (1, 1, 2, 4) and torch.isfinite(out).all()
    qc, kx = torch.zeros(1, 2, 2, 4), torch.zeros(1, 2, 1, 4)
    out = pa_ops.prefill_attention_paged(qc, kx, kx, pool, pool, table, 0,
                                         v_width=2)
    assert out.shape == (1, 2, 2, 2) and torch.isfinite(out).all()
    out = pa_ops.prefill_attention_paged(qc, kx, kx, codes, codes, table, 0,
                                         k_scale=scales, v_scale=scales)
    assert out.shape == (1, 2, 2, 4) and torch.isfinite(out).all()
