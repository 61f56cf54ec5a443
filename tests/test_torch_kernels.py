"""The port's kernel modules against the JAX package's oracles.

Each plain version of the port (``repro_torch.kernels.<family>.ref``)
must compute what the JAX ``ref.py`` computes on the same numpy inputs:
the scatter exactly, the attention folds to fp32 ulp scale.  Tolerances:
fp32 at 1e-5 absolute — both are fp32 blockwise folds over the same
blocks, differing only in einsum summation order, on outputs of order 1
(the JAX kernels themselves miss their own refs by 1-2 ulp, so nothing
here is bitwise); bf16 at 2^-6 plus that — one bf16 rounding step of
outputs below 4 in magnitude, where the two round the same fp32 value.

On the CPU every op takes its plain version and never counts a kernel
launch; the CUDA wrappers refuse tensors that are not on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.cache_update import ref as jax_cu  # noqa: E402
from repro.kernels.decode_attention import ref as jax_da  # noqa: E402
from repro.kernels.prefill_attention import ref as jax_pa  # noqa: E402
from repro_torch.kernels import on_card  # noqa: E402
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


# -- cache_update ------------------------------------------------------------

@pytest.mark.parametrize("dtype,shape", [
    ("float32", (4, 16, 3, 8)), ("bfloat16", (4, 16, 3, 8)),
    ("float32", (3, 7, 5))])
def test_cache_update_ref_matches_jax_exactly(dtype, shape):
    rng = np.random.default_rng(0)
    b, c = shape[:2]
    cache = rng.standard_normal(shape)
    new = rng.standard_normal((b, 1) + shape[2:])
    slots = np.array([0, c - 1, c // 2, 1][:b], np.int32)
    jc, tc = _pair(cache, dtype)
    jn, tn = _pair(new, dtype)
    want = jax_cu.cache_update_ref(jc, jn, jnp.asarray(slots))
    got = cu_ops.cache_update(tc, tn, torch.from_numpy(slots))
    assert got is tc                               # updated in place
    np.testing.assert_array_equal(np.asarray(want.astype(jnp.float32)),
                                  got.float().numpy())


# -- decode_attention -------------------------------------------------------------

DECODE_CASES = {
    # name: (kvh, c, lens, ring, softcap)
    "mha": (6, 32, [0, 1, 15, 31], False, None),
    "gqa3": (2, 32, [0, 1, 15, 31], False, None),
    "mqa": (1, 32, [0, 1, 15, 31], False, None),
    "ring-wrapped": (2, 16, [0, 5, 15, 40], True, None),
    "softcap": (2, 32, [0, 1, 15, 31], False, 5.0),
    "ring-softcap-mqa": (1, 16, [3, 16, 17, 100], True, 5.0),
    "odd-c": (3, 24, [0, 7, 23, 12], False, None),
}


@pytest.mark.parametrize("case,dtype", [
    (c, "float32") for c in sorted(DECODE_CASES)]
    + [("gqa3", "bfloat16"), ("ring-wrapped", "bfloat16")])
def test_decode_ref_matches_jax(case, dtype):
    kvh, c, lens, ring, cap = DECODE_CASES[case]
    rng = np.random.default_rng(1)
    b, g = len(lens), H // kvh
    jq, tq = _pair(rng.standard_normal((b, kvh, g, HD)), dtype)
    jk, tk = _pair(rng.standard_normal((b, c, kvh, HD)), dtype)
    jv, tv = _pair(rng.standard_normal((b, c, kvh, HD)), dtype)
    lens_np = np.array(lens, np.int32)
    kw = dict(ring=ring, softcap=cap, scale=HD ** -0.5, block_k=8)
    want = jax_da.decode_attention_ref(jq, jk, jv, jnp.asarray(lens_np), **kw)
    got = da_ref.decode_attention_ref(tq, tk, tv, torch.from_numpy(lens_np),
                                      **kw)
    _close(want, got, dtype)


# -- prefill_attention -------------------------------------------------------------

PREFILL_CASES = {
    # name: (kvh, t, c, offs, ring, window, softcap)
    "mha": (6, 8, 32, [0, 1, 12, 31], False, None, None),
    "gqa3": (2, 8, 32, [0, 1, 12, 31], False, None, None),
    "mqa": (1, 8, 32, [0, 1, 12, 31], False, None, None),
    "ring-window-wrapped": (2, 8, 16, [0, 5, 16, 40], True, 16, None),
    "ring-narrow-window": (1, 8, 16, [3, 16, 17, 100], True, 6, None),
    "softcap": (2, 8, 32, [0, 1, 12, 31], False, None, 5.0),
    "odd-c-and-t": (3, 6, 24, [0, 7, 23, 12], False, None, None),
}


@pytest.mark.parametrize("case,dtype", [
    (c, "float32") for c in sorted(PREFILL_CASES)]
    + [("gqa3", "bfloat16"), ("ring-window-wrapped", "bfloat16")])
def test_prefill_ref_matches_jax(case, dtype):
    kvh, t, c, offs, ring, window, cap = PREFILL_CASES[case]
    rng = np.random.default_rng(2)
    b, g = len(offs), H // kvh
    jq, tq = _pair(rng.standard_normal((b, kvh, t, g, HD)), dtype)
    jkx, tkx = _pair(rng.standard_normal((b, t, kvh, HD)), dtype)
    jvx, tvx = _pair(rng.standard_normal((b, t, kvh, HD)), dtype)
    jkc, tkc = _pair(rng.standard_normal((b, c, kvh, HD)), dtype)
    jvc, tvc = _pair(rng.standard_normal((b, c, kvh, HD)), dtype)
    offs_np = np.array(offs, np.int32)
    kw = dict(ring=ring, window=window, softcap=cap, scale=HD ** -0.5,
              block_k=8)
    want = jax_pa.prefill_attention_ref(jq, jkx, jvx, jkc, jvc,
                                        jnp.asarray(offs_np), **kw)
    got = pa_ref.prefill_attention_ref(tq, tkx, tvx, tkc, tvc,
                                       torch.from_numpy(offs_np), **kw)
    _close(want, got, dtype)


# -- dispatch: CPU tensors take the plain path, CUDA wrappers refuse CPU ----

def test_ops_on_cpu_take_plain_path_and_count_no_launch():
    """Each op on CPU tensors gives its plain version's numbers, and no
    kernel launch is counted."""
    for mod in (cu_kernel, da_kernel, pa_kernel):
        mod.launches = 0
    rng = np.random.default_rng(3)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    cache, new = f(2, 8, 2, 4), f(2, 1, 2, 4)
    slots = torch.tensor([3, 7], dtype=torch.int32)
    want = cu_ref.cache_update_ref(cache.clone(), new, slots)
    assert torch.equal(cu_ops.cache_update(cache, new, slots), want)
    q, k, v = f(2, 1, 6, 4), f(2, 8, 2, 4), f(2, 8, 2, 4)
    lens = torch.tensor([2, 7], dtype=torch.int32)
    out = da_ops.decode_attention(q, k, v, lens, scale=0.5)
    ref = da_ref.decode_attention_ref(q.reshape(2, 2, 3, 4), k, v, lens,
                                      scale=0.5)
    assert torch.equal(out, ref.reshape(2, 1, 6, 4))
    qc, kx, vx = f(2, 4, 6, 4), f(2, 4, 2, 4), f(2, 4, 2, 4)
    out = pa_ops.prefill_attention(qc, kx, vx, k, v, 3, scale=0.5)
    qg = qc.reshape(2, 4, 2, 3, 4).permute(0, 2, 1, 3, 4)
    ref = pa_ref.prefill_attention_ref(qg, kx, vx, k, v,
                                       torch.tensor([3, 3]), scale=0.5)
    assert torch.equal(out, ref.permute(0, 2, 1, 3, 4).reshape(2, 4, 6, 4))
    assert (cu_kernel.launches, da_kernel.launches, pa_kernel.launches) \
        == (0, 0, 0)


def test_cuda_wrappers_refuse_cpu_tensors():
    """A kernel wrapper launches on the card or raises: it never computes
    on the CPU itself."""
    x = torch.zeros(2, 4, 8)
    with pytest.raises(ValueError, match="on the card"):
        cu_kernel.cache_update_cuda(x, torch.zeros(2, 1, 8),
                                    torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="on the card"):
        da_kernel.decode_attention_cuda(
            torch.zeros(2, 1, 1, 8), torch.zeros(2, 4, 1, 8),
            torch.zeros(2, 4, 1, 8), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="on the card"):
        pa_kernel.prefill_attention_cuda(
            torch.zeros(2, 1, 3, 1, 8), torch.zeros(2, 3, 1, 8),
            torch.zeros(2, 3, 1, 8), torch.zeros(2, 4, 1, 8),
            torch.zeros(2, 4, 1, 8), torch.zeros(2, dtype=torch.int32))


def test_mixed_devices_raise():
    with pytest.raises(ValueError, match="all lie on the card"):
        on_card(torch.zeros(1), torch.zeros(1, device="meta"))


def test_later_slice_options_raise():
    q, k = torch.zeros(1, 1, 2, 4), torch.zeros(1, 4, 1, 4)
    with pytest.raises(NotImplementedError, match="MLA"):
        da_ops.decode_attention(q, k, k, 0, v_width=2)
    with pytest.raises(NotImplementedError, match="quantized"):
        da_ops.decode_attention(q, k, k, 0, k_scale=torch.zeros(1, 4, 1))
    qc, kx = torch.zeros(1, 2, 2, 4), torch.zeros(1, 2, 1, 4)
    with pytest.raises(NotImplementedError, match="MLA"):
        pa_ops.prefill_attention(qc, kx, kx, k, k, 0, v_width=2)
    with pytest.raises(NotImplementedError, match="quantized"):
        pa_ops.prefill_attention(qc, kx, kx, k, k, 0,
                                 v_scale=torch.zeros(1, 4, 1))
