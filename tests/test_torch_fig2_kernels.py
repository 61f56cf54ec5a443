"""The port's Fig. 2 kernel modules against the JAX package's.

Each plain version (``repro_torch.kernels.<family>.ref``), reached
through its op on the CPU, must compute what the JAX ``ref.py`` and the
JAX Pallas kernel (in interpret mode) compute on the same numpy inputs,
at the shapes of ``tests/test_kernels.py``.  Tolerances:

- FMA32 at rtol 1e-6 (the JAX tests' own), including iters 1024: both
  round once per step (XLA contracts ``y*a + b`` into a fused
  multiply-add; ``torch.addcmul`` is fused too), so they agree to the
  bit, where a version that rounds twice per step misses the tolerance;
- STREAM exactly against the JAX ``ref.py`` in float32 and bfloat16:
  both round ``s*b`` and then the sum to the arrays' type, op by op.
  Against the Pallas kernel in float32 at rtol 1e-5, atol 1e-6 (the JAX
  tests' own): XLA contracts the kernel's jitted body into one fused
  multiply-add, so it misses its own reference by up to 1 ulp of the
  sum;
- GEMM at 1e-5 of max |out| in float32 (float32 sums in other orders)
  and 1e-2 in bfloat16 (the JAX tests' own);
- JACOBI2D exactly: the same sum in the same order.

On the CPU every op takes its plain version and counts no launch; the
CUDA wrappers refuse tensors that are not on the card.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.fma32 import fma32 as jax_fma32  # noqa: E402
from repro.kernels.fma32 import fma32_ref as jax_fma32_ref  # noqa: E402
from repro.kernels.gemm import gemm as jax_gemm  # noqa: E402
from repro.kernels.gemm import gemm_ref as jax_gemm_ref  # noqa: E402
from repro.kernels.jacobi2d import jacobi2d as jax_jacobi2d  # noqa: E402
from repro.kernels.jacobi2d import jacobi2d_ref as jax_jacobi2d_ref  # noqa: E402
from repro.kernels.stream import stream_triad as jax_stream  # noqa: E402
from repro.kernels.stream import stream_triad_ref as jax_stream_ref  # noqa: E402
from repro_torch.kernels.fma32 import kernel as fma_kernel  # noqa: E402
from repro_torch.kernels.fma32 import ops as fma_ops  # noqa: E402
from repro_torch.kernels.gemm import kernel as gemm_kernel  # noqa: E402
from repro_torch.kernels.gemm import ops as gemm_ops  # noqa: E402
from repro_torch.kernels.jacobi2d import kernel as jac_kernel  # noqa: E402
from repro_torch.kernels.jacobi2d import ops as jac_ops  # noqa: E402
from repro_torch.kernels.stream import kernel as st_kernel  # noqa: E402
from repro_torch.kernels.stream import ops as st_ops  # noqa: E402


def _normal(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    return (jnp.asarray(a).astype(dtype),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.float().numpy()


# -- FMA32 ---------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(128, 128), (512, 256), (1024, 384)])
@pytest.mark.parametrize("iters", [1, 16, 64])
def test_fma32_plain_matches_jax(shape, iters):
    x = _normal(0, shape)
    got = fma_ops.fma32(torch.from_numpy(x), iters=iters)
    np.testing.assert_allclose(_np(got), _np(jax_fma32_ref(
        jnp.asarray(x), iters=iters)), rtol=1e-6)
    np.testing.assert_allclose(_np(got), _np(jax_fma32(
        jnp.asarray(x), iters=iters, interpret=True)), rtol=1e-6)


def test_fma32_plain_matches_jax_at_1024_steps_where_two_roundings_fail():
    x = _normal(1, (512, 256))
    want = _np(jax_fma32_ref(jnp.asarray(x), iters=1024))
    got = fma_ops.fma32(torch.from_numpy(x), iters=1024)
    np.testing.assert_allclose(_np(got), want, rtol=1e-6)
    np.testing.assert_allclose(_np(got), _np(jax_fma32(
        jnp.asarray(x), iters=1024, interpret=True)), rtol=1e-6)
    # the test can tell: a multiply then an add misses the tolerance
    y = torch.from_numpy(x)
    for _ in range(1024):
        y = y * 1.0000001 + 1e-7
    assert not np.allclose(_np(y), want, rtol=1e-6, atol=0.0)


# -- STREAM --------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(256, 128), (2048, 512)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stream_triad_plain_matches_jax(shape, dtype):
    ja, ta = _pair(_normal(2, shape), dtype)
    jb, tb = _pair(_normal(3, shape), dtype)
    got = st_ops.stream_triad(ta, tb, scalar=2.5)
    assert got.dtype == getattr(torch, dtype)
    want = jax_stream_ref(ja, jb, scalar=2.5)
    assert str(want.dtype) == dtype
    np.testing.assert_array_equal(_np(got), _np(want))
    kern = jax_stream(ja, jb, scalar=2.5, interpret=True)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_np(got), _np(kern))
    else:
        np.testing.assert_allclose(_np(got), _np(kern), rtol=1e-5,
                                   atol=1e-6)


# -- GEMM ----------------------------------------------------------------------

@pytest.mark.parametrize("mnk", [(256, 256, 256), (512, 256, 384),
                                 (128, 512, 640)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemm_plain_matches_jax(mnk, dtype):
    m, n, k = mnk
    ja, ta = _pair(_normal(4, (m, k), 1 / math.sqrt(k)), dtype)
    jb, tb = _pair(_normal(5, (k, n)), dtype)
    got = gemm_ops.gemm(ta, tb)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    for want in (jax_gemm_ref(ja, jb),
                 jax_gemm(ja, jb, block_m=128, block_n=128, block_k=128,
                          interpret=True)):
        w = _np(want)
        err = float(np.max(np.abs(_np(got) - w)))
        tol = 1e-2 if dtype == "bfloat16" else 1e-5 * float(np.abs(w).max())
        assert err <= tol, f"max |err| {err} > {tol}"


# -- JACOBI2D ------------------------------------------------------------------

@pytest.mark.parametrize("shape,bh", [((256, 128), 64), ((512, 256), 128),
                                      ((128, 384), 128)])
def test_jacobi2d_plain_matches_jax_exactly(shape, bh):
    x = _normal(6, shape)
    got = _np(jac_ops.jacobi2d(torch.from_numpy(x)))
    np.testing.assert_array_equal(got, _np(jax_jacobi2d_ref(jnp.asarray(x))))
    np.testing.assert_array_equal(got, _np(jax_jacobi2d(
        jnp.asarray(x), block_h=bh, interpret=True)))
    # boundary rows and columns keep x
    for edge in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1]):
        np.testing.assert_array_equal(got[edge], x[edge])


@pytest.mark.parametrize("shape", [(97, 45), (2, 9), (3, 3)])
def test_jacobi2d_plain_matches_jax_ref_at_odd_shapes(shape):
    x = _normal(7, shape)
    t = torch.from_numpy(x)
    got = jac_ops.jacobi2d(t)
    np.testing.assert_array_equal(_np(got), _np(jax_jacobi2d_ref(
        jnp.asarray(x))))
    np.testing.assert_array_equal(t.numpy(), x)       # input untouched


# -- dispatch ------------------------------------------------------------------

def test_cpu_ops_count_no_launches_and_wrappers_refuse_cpu_tensors():
    x = torch.zeros((8, 8))
    counts = [m.launches for m in (fma_kernel, st_kernel, gemm_kernel,
                                   jac_kernel)]
    fma_ops.fma32(x, iters=2)
    st_ops.stream_triad(x, x)
    gemm_ops.gemm(x, x)
    jac_ops.jacobi2d(x)
    assert [m.launches for m in (fma_kernel, st_kernel, gemm_kernel,
                                 jac_kernel)] == counts
    for call in (lambda: fma_kernel.fma32_cuda(x, 2),
                 lambda: st_kernel.stream_triad_cuda(x, x, 2.0),
                 lambda: gemm_kernel.gemm_cuda(x, x),
                 lambda: jac_kernel.jacobi2d_cuda(x)):
        with pytest.raises(ValueError, match="on the card"):
            call()
