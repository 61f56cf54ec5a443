"""The port's GRIDDER and DEGRIDDER against the JAX package's.

The plain versions (``repro_torch.kernels.gridder.ref``), reached through
the ops on the CPU, must compute what the JAX ``gridder_ref`` /
``degridder_ref`` and the JAX Pallas kernels (in interpret mode) compute
on the same numpy inputs, at the shapes of ``tests/test_kernels.py`` and
its tolerance, rtol 1e-4 and atol 2e-3: the phase is rounded to float32
in both, but sin, cos and the complex sums round in other places and
orders, and the sums reach ~80 in magnitude.  Odd P, V and S, which the
TPU kernels do not take, are held against the JAX ``ref.py`` alone.

On the CPU the ops take the plain versions and count no launch; the CUDA
wrappers refuse tensors that are not on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.gridder import degridder as jax_degridder  # noqa: E402
from repro.kernels.gridder import degridder_ref as jax_degridder_ref  # noqa: E402
from repro.kernels.gridder import gridder as jax_gridder  # noqa: E402
from repro.kernels.gridder import gridder_ref as jax_gridder_ref  # noqa: E402
from repro_torch.kernels.gridder import kernel as grid_kernel  # noqa: E402
from repro_torch.kernels.gridder import ops as grid_ops  # noqa: E402
from repro_torch.kernels.gridder import ref as grid_ref  # noqa: E402

RTOL, ATOL = 1e-4, 2e-3


def _inputs(seed, p, s, v, uv_bound=2.0):
    """lm in [-0.5, 0.5], uv in [-uv_bound, uv_bound], vis and subgrids
    standard normal, as the JAX tests and bench draw them."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (rng.uniform(-0.5, 0.5, (p, 2)).astype(f32),
            rng.uniform(-uv_bound, uv_bound, (s, v, 2)).astype(f32),
            rng.standard_normal((s, v, 2)).astype(f32),
            rng.standard_normal((s, p, 2)).astype(f32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("p,s,v,bv", [(128, 2, 128, 128), (256, 3, 256, 128),
                                      (128, 1, 512, 256)])
def test_gridder_plain_matches_jax(p, s, v, bv):
    lm, uv, vis, _ = _inputs(0, p, s, v)
    got = grid_ops.gridder(*_t(lm, uv, vis))
    assert got.dtype == torch.float32 and got.shape == (s, p, 2)
    _close(got, jax_gridder_ref(lm, uv, vis))
    _close(got, jax_gridder(lm, uv, vis, block_v=bv, interpret=True))


@pytest.mark.parametrize("p,s,v", [(128, 2, 128), (256, 2, 256)])
def test_degridder_plain_matches_jax(p, s, v):
    lm, uv, _, sub = _inputs(1, p, s, v)
    got = grid_ops.degridder(*_t(lm, uv, sub))
    assert got.dtype == torch.float32 and got.shape == (s, v, 2)
    _close(got, jax_degridder_ref(lm, uv, sub))
    _close(got, jax_degridder(lm, uv, sub, interpret=True))


@pytest.mark.parametrize("p,s,v", [(97, 3, 53), (33, 5, 129), (1, 1, 1),
                                   (1000, 1, 37)])
def test_odd_shapes_match_the_jax_reference(p, s, v):
    lm, uv, vis, sub = _inputs(2, p, s, v)
    _close(grid_ops.gridder(*_t(lm, uv, vis)), jax_gridder_ref(lm, uv, vis))
    _close(grid_ops.degridder(*_t(lm, uv, sub)),
           jax_degridder_ref(lm, uv, sub))


@pytest.mark.parametrize("p,s,v", [(128, 2, 128), (97, 3, 53)])
def test_gridder_degridder_adjoint(p, s, v):
    """<G(vis), sub> == <vis, G^T(sub)>, as ``tests/test_kernels.py``
    holds the JAX pair, within 1e-3 relative."""
    lm, uv, vis, sub = _inputs(3, p, s, v, uv_bound=1.0)
    g = grid_ops.gridder(*_t(lm, uv, vis))
    gt = grid_ops.degridder(*_t(lm, uv, sub))
    lhs = float((g.double() * torch.from_numpy(sub).double()).sum())
    rhs = float((torch.from_numpy(vis).double() * gt.double()).sum())
    assert abs(lhs - rhs) / max(abs(lhs), 1e-3) < 1e-3


def test_blockwise_plain_versions_agree_with_one_block(monkeypatch):
    """The plain versions cut S into blocks of at most ``BLOCK_TERMS``
    terms; the cut changes values only as far as the batched complex
    product's summation order follows its batch size (~1 ulp of the
    sums)."""
    lm, uv, vis, sub = _t(*_inputs(4, 64, 7, 96))
    whole = (grid_ref.gridder_ref(lm, uv, vis),
             grid_ref.degridder_ref(lm, uv, sub))
    monkeypatch.setattr(grid_ref, "BLOCK_TERMS", 2 * 64 * 96)
    assert len(grid_ref._blocks(7, 64, 96)) == 4
    torch.testing.assert_close(grid_ref.gridder_ref(lm, uv, vis), whole[0],
                               rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(grid_ref.degridder_ref(lm, uv, sub), whole[1],
                               rtol=1e-6, atol=1e-5)


def test_cpu_ops_count_no_launches_and_wrappers_refuse_cpu_tensors():
    lm, uv, vis, sub = _t(*_inputs(5, 8, 2, 4))
    before = (grid_kernel.gridder_launches, grid_kernel.degridder_launches)
    grid_ops.gridder(lm, uv, vis)
    grid_ops.degridder(lm, uv, sub)
    assert (grid_kernel.gridder_launches,
            grid_kernel.degridder_launches) == before
    for call in (lambda: grid_kernel.gridder_cuda(lm, uv, vis),
                 lambda: grid_kernel.degridder_cuda(lm, uv, sub)):
        with pytest.raises(ValueError, match="on the card"):
            call()
