"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: these skip where there is no card.  On the machine with
the card run them with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
Tolerances as in chip_smoke.py: 2e-5 in fp32 (summation order), one
bf16 rounding step of outputs below 4 (2^-6) in bf16; the scatter is
exact.  The Fig. 2 kernels: STREAM and JACOBI2D exact, FMA32 within
1e-6 relative, GEMM within 1e-5 of max |out|, GRIDDER and DEGRIDDER
within rtol 1e-4 and atol 2e-3 (the JAX tests' own), their pair adjoint
within 1e-3 relative.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.cache_update import ops as cu_ops  # noqa: E402
from repro_torch.kernels.cache_update import ref as cu_ref  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.kernels.decode_attention import ref as da_ref  # noqa: E402
from repro_torch.kernels.prefill_attention import ops as pa_ops  # noqa: E402
from repro_torch.kernels.prefill_attention import ref as pa_ref  # noqa: E402
from repro_torch.kernels.fma32 import kernel as fma_kernel  # noqa: E402
from repro_torch.kernels.fma32 import ops as fma_ops  # noqa: E402
from repro_torch.kernels.fma32 import ref as fma_ref  # noqa: E402
from repro_torch.kernels.gemm import ops as gemm_ops  # noqa: E402
from repro_torch.kernels.gemm import ref as gemm_ref  # noqa: E402
from repro_torch.kernels.gridder import kernel as grid_kernel  # noqa: E402
from repro_torch.kernels.gridder import ops as grid_ops  # noqa: E402
from repro_torch.kernels.gridder import ref as grid_ref  # noqa: E402
from repro_torch.kernels.jacobi2d import ops as jac_ops  # noqa: E402
from repro_torch.kernels.jacobi2d import ref as jac_ref  # noqa: E402
from repro_torch.kernels.stream import ops as st_ops  # noqa: E402
from repro_torch.kernels.stream import ref as st_ref  # noqa: E402

TOL = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -6 + 2e-5}
pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _randn(card, dt, *shape, seed=0):
    g = torch.Generator(device=card).manual_seed(seed)
    return torch.randn(shape, generator=g, device=card).to(dt)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_cache_update_kernel_is_exact(card, dt):
    cache = _randn(card, dt, 4, 33, 3, 64)
    new = _randn(card, dt, 4, 1, 3, 64, seed=1)
    slots = torch.tensor([0, 32, 7, 40], dtype=torch.int32, device=card)
    want = cu_ref.cache_update_ref(cache.clone(), new, slots)
    got = cu_ops.cache_update(cache.clone(), new, slots)
    assert torch.equal(got, want)


@pytest.mark.parametrize("ring,softcap", [(False, None), (True, None),
                                          (False, 30.0)])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_decode_kernel_matches_plain(card, dt, ring, softcap):
    b, c, kvh, g, hd = 5, 200, 3, 3, 64
    q = _randn(card, dt, b, 1, kvh * g, hd)
    k = _randn(card, dt, b, c, kvh, hd, seed=1)
    v = _randn(card, dt, b, c, kvh, hd, seed=2)
    lens = torch.tensor([0, 1, 100, 199, 450], dtype=torch.int32,
                        device=card)
    kw = dict(ring=ring, softcap=softcap, scale=0.125)
    got = da_ops.decode_attention(q, k, v, lens, **kw)
    want = da_ref.decode_attention_ref(q.reshape(b, kvh, g, hd), k, v, lens,
                                       **kw).reshape(b, 1, kvh * g, hd)
    assert float((got.float() - want.float()).abs().max()) <= TOL[dt]


@pytest.mark.parametrize("ring,window,softcap", [
    (False, None, None), (True, 64, None), (False, None, 30.0)])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_prefill_kernel_matches_plain(card, dt, ring, window, softcap):
    b, t, c, kvh, g, hd = 4, 32, 128, 3, 3, 64
    q = _randn(card, dt, b, t, kvh * g, hd)
    kx = _randn(card, dt, b, t, kvh, hd, seed=1)
    vx = _randn(card, dt, b, t, kvh, hd, seed=2)
    kc = _randn(card, dt, b, c, kvh, hd, seed=3)
    vc = _randn(card, dt, b, c, kvh, hd, seed=4)
    offs = torch.tensor([0, 1, 64, 300], dtype=torch.int32, device=card)
    kw = dict(ring=ring, window=window, softcap=softcap, scale=0.125)
    got = pa_ops.prefill_attention(q, kx, vx, kc, vc, offs, **kw)
    qg = q.reshape(b, t, kvh, g, hd).permute(0, 2, 1, 3, 4)
    want = pa_ref.prefill_attention_ref(qg, kx, vx, kc, vc, offs, **kw)
    want = want.permute(0, 2, 1, 3, 4).reshape(b, t, kvh * g, hd)
    assert float((got.float() - want.float()).abs().max()) <= TOL[dt]


# -- the Fig. 2 kernels ------------------------------------------------------

@pytest.mark.parametrize("iters", [1, 64, 1024])
def test_fma32_kernel_matches_plain(card, iters):
    """Both fuse each step (one rounding), so they agree to ~1e-6."""
    x = _randn(card, torch.float32, 333, 257)
    before = fma_kernel.launches
    got = fma_ops.fma32(x, iters=iters)
    assert fma_kernel.launches == before + 1
    want = fma_ref.fma32_ref(x, iters)
    assert float(((got - want).abs() / (1 + want.abs())).max()) <= 1e-6


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(256, 512), (333, 257)])
def test_stream_kernel_is_exact(card, dt, shape):
    """Both round s*b, then the sum, to the arrays' type: equal bits."""
    a = _randn(card, dt, *shape)
    b = _randn(card, dt, *shape, seed=1)
    got = st_ops.stream_triad(a, b, scalar=2.5)
    assert torch.equal(got, st_ref.stream_triad_ref(a, b, 2.5))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mkn", [(256, 512, 384), (257, 131, 129),
                                 (1, 7, 300)])
def test_gemm_kernel_matches_plain(card, dt, mkn):
    """float32 sums of exact products in another order: 1e-5 of max
    |out|.  TF32 off, so the plain version is float32 too."""
    torch.backends.cuda.matmul.allow_tf32 = False
    m, k, n = mkn
    a = _randn(card, dt, m, k)
    b = _randn(card, dt, k, n, seed=1)
    got = gemm_ops.gemm(a, b)
    want = gemm_ref.gemm_ref(a, b)
    assert got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


@pytest.mark.parametrize("shape", [(256, 512), (333, 257), (2, 9)])
def test_jacobi2d_kernel_is_exact(card, shape):
    x = _randn(card, torch.float32, *shape)
    keep = x.clone()
    got = jac_ops.jacobi2d(x)
    assert torch.equal(got, jac_ref.jacobi2d_ref(x))
    assert torch.equal(x, keep)


@pytest.mark.parametrize("psv", [(256, 4, 512), (1000, 3, 1999), (97, 5, 33),
                                 (1, 1, 1)])
def test_gridder_kernels_match_plain_and_are_adjoint(card, psv):
    """Accurate sincosf against torch's sin and cos, sums in other
    orders: the JAX tests' rtol 1e-4, atol 2e-3."""
    p, s, v = psv
    lm = _randn(card, torch.float32, p, 2).clamp(-0.5, 0.5)
    uv = 2.0 * _randn(card, torch.float32, s, v, 2, seed=1).clamp(-1, 1)
    vis = _randn(card, torch.float32, s, v, 2, seed=2)
    sub = _randn(card, torch.float32, s, p, 2, seed=3)
    before = (grid_kernel.gridder_launches, grid_kernel.degridder_launches)
    g = grid_ops.gridder(lm, uv, vis)
    gt = grid_ops.degridder(lm, uv, sub)
    assert (grid_kernel.gridder_launches,
            grid_kernel.degridder_launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(g, grid_ref.gridder_ref(lm, uv, vis),
                               rtol=1e-4, atol=2e-3)
    torch.testing.assert_close(gt, grid_ref.degridder_ref(lm, uv, sub),
                               rtol=1e-4, atol=2e-3)
    lhs = float((g.double() * sub.double()).sum())
    rhs = float((vis.double() * gt.double()).sum())
    assert abs(lhs - rhs) / max(abs(lhs), 1e-3) < 1e-3
