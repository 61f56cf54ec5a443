"""The CUDA gridder's and degridder's phasor (``csrc/gridder.cu``),
emulated on the CPU.

Both kernels scale each pixel's (l, m) by float32(2 pi) (the gridder
once a thread, the degridder as it stages the pixel), so a term's phase
in radians is ``fmaf(2 pi l, u, (2 pi m) * v)`` in both, and both run
``__sincosf(phase)``, which nvcc builds as a round-toward-zero multiply
by float32(1 / 2 pi) and MUFU.SIN / MUFU.COS (absolute error at most
2^-21.41 on [-pi, pi]: CUDA C++ Programming Guide, intrinsic functions).
Here that float32 arithmetic is written out in numpy, the SFU modelled
as the exact sine and cosine of its argument in turns plus an error of
that bound, and held to:

- the phase: within one float32 ulp at 4 pi (2^-20) of the reference's
  ``float32(2 pi) * (l u + m v)`` over the Fig. 2 ranges;
- each phasor within 2.5e-6 of the reference's over those ranges, the
  SFU's error included: the kernel's per-term error that ``chip_smoke.py``
  and the ``cuda`` tests rely on;
- the gridder at phases up to 4 pi (lm at the corners +-0.5, uv at and
  just inside +-2), V 2048, its sums taken in the kernel's order in
  float32, against the JAX ``gridder_ref`` within the JAX tests' rtol
  1e-4, atol 2e-3, with the SFU's error at 0, at random signs, and at
  the signs that push every term of the real sums the same way;
- the same at phases up to 32 pi (uv at and just inside +-16), outside
  [-pi, pi], where the phase is not reduced before the SFU: the widest
  range the kernel is held to;
- the phase at 32 pi (uv in [-16, 16]) within one float32 ulp there
  (2^-17) of the reference's;
- the degridder likewise: its conjugate sums over P (the Fig. 2 P of
  1024) in the kernel's order against the JAX ``degridder_ref`` at 4 pi
  and 32 pi, with the SFU's error at 0, at random signs, and aligned
  with every term.

The card's own MUFU is not modelled beyond its stated bound (taken on
the fraction of a turn it is given, at any phase); the ``cuda`` tests
and ``chip_smoke.py`` hold the kernel itself to the same tolerance at
the same phases.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.gridder import degridder_ref as jax_degridder_ref  # noqa: E402,E501
from repro.kernels.gridder import gridder_ref as jax_gridder_ref  # noqa: E402

F32, F64 = np.float32, np.float64
TWO_PI = F32(2.0 * math.pi)              # float32(2 pi), the kernel's TWO_PI
INV_TWO_PI = F32(0.15915493667125701904)  # __sincosf's scale to turns
SFU_ERR = 2.0 ** -21.41                  # MUFU.SIN / MUFU.COS on [-pi, pi]


def _round_to_zero(z: np.ndarray) -> np.ndarray:
    """float64 -> float32, rounded toward zero (FMUL.RZ)."""
    f = z.astype(F32)
    over = np.abs(f.astype(F64)) > np.abs(z)
    f[over] = np.nextafter(f[over], F32(0))
    return f


def kernel_phase(l, m, u, v) -> np.ndarray:
    """The kernel's float32 phase in radians: one FMUL, one FFMA on lm
    scaled by TWO_PI."""
    ls, ms = TWO_PI * l.astype(F32), TWO_PI * m.astype(F32)
    return (ls.astype(F64) * u + (ms * v).astype(F64)).astype(F32)


def reference_phase(l, m, u, v) -> np.ndarray:
    """The reference's float32 phase, TWO_PI * (l u + m v)."""
    return TWO_PI * (l.astype(F64) * u + (m * v).astype(F64)).astype(F32)


def sfu_phasor(phase: np.ndarray):
    """(sin, cos) of __sincosf's SFU argument for float32 ``phase``, exact
    (the SFU's own error is added by the caller)."""
    y = _round_to_zero(phase.astype(F64) * F64(INV_TWO_PI)).astype(F64)
    return np.sin(2 * np.pi * y), np.cos(2 * np.pi * y)


def _fig2_terms(n=1_000_000):
    """(l, m, u, v) over the Fig. 2 ranges, the corner terms first."""
    rng = np.random.default_rng(0)
    l, m = (rng.uniform(-0.5, 0.5, n).astype(F32) for _ in range(2))
    u, v = (rng.uniform(-2.0, 2.0, n).astype(F32) for _ in range(2))
    corners = [(sl * 0.5, sm * 0.5, sl * 2.0, sm * 2.0)
               for sl in (-1, 1) for sm in (-1, 1)]
    for i, row in enumerate(corners):
        l[i], m[i], u[i], v[i] = row
    return l, m, u, v


def test_phase_within_an_ulp_of_the_reference():
    l, m, u, v = _fig2_terms()
    got, want = kernel_phase(l, m, u, v), reference_phase(l, m, u, v)
    assert float(np.abs(want).max()) == pytest.approx(4 * math.pi)
    assert np.abs(got.astype(F64) - want).max() <= 2.0 ** -20


def test_phase_at_32_pi_within_an_ulp_of_the_reference():
    """uv in [-16, 16], the widest range the pair is held to: phases up
    to 32 pi, where a float32 ulp is 2^-17."""
    rng = np.random.default_rng(1)
    l, m = (rng.uniform(-0.5, 0.5, 1_000_000).astype(F32) for _ in range(2))
    u, v = (rng.uniform(-16.0, 16.0, 1_000_000).astype(F32)
            for _ in range(2))
    l[0], m[0], u[0], v[0] = 0.5, -0.5, 16.0, -16.0
    got, want = kernel_phase(l, m, u, v), reference_phase(l, m, u, v)
    assert float(np.abs(want).max()) == pytest.approx(32 * math.pi)
    assert np.abs(got.astype(F64) - want).max() <= 2.0 ** -17


def test_phasor_within_2_5e6_of_the_reference():
    l, m, u, v = _fig2_terms()
    sn, cs = sfu_phasor(kernel_phase(l, m, u, v))
    want = reference_phase(l, m, u, v).astype(F64)
    err = max(np.abs(sn - np.sin(want)).max(),
              np.abs(cs - np.cos(want)).max())
    assert err + SFU_ERR <= 2.5e-6, err


def _extremes(rng, p, s, v, reach=2.0):
    """lm with the corners, edges and near-corners first, uv a quarter at
    +-reach, a quarter just inside, a quarter at +-reach in u: the inputs
    of chip_smoke.py's ``gridder_extremes``, drawn with numpy."""
    lm = rng.uniform(-0.5, 0.5, (p, 2)).astype(F32)
    edge = [[x, y] for x in (-0.5, 0.5) for y in (-0.5, 0.5)] \
        + [[0.5, 0.0], [-0.5, 0.0], [0.0, 0.5], [0.0, -0.5]] \
        + [[x * 0.4999, y * 0.49993] for x in (-1, 1) for y in (-1, 1)]
    lm[: len(edge)] = edge
    uv = rng.uniform(-reach, reach, (s, v, 2)).astype(F32)
    q = v // 4
    uv[:, :q] = reach * np.sign(uv[:, :q])
    uv[:, q: 2 * q] = np.sign(uv[:, q: 2 * q]) * (
        reach - 1e-3 * rng.uniform(0.0, 1.0, (s, q, 2))).astype(F32)
    uv[:, 2 * q: 3 * q, 0] = reach * np.sign(uv[:, 2 * q: 3 * q, 0])
    return lm, uv


def emulated_gridder(lm, uv, vis, sfu_error: str, rng):
    """The kernel's gridder in float32: the phase by one FMUL and one
    FFMA, the SFU phasor, and each pixel's sums over V in order, 4 FMAs a
    term."""
    s, v, _ = uv.shape
    re = np.zeros((s, lm.shape[0]), F32)
    im = np.zeros_like(re)
    l, m = lm[None, :, 0], lm[None, :, 1]
    for j in range(v):
        u, w = uv[:, j, 0][:, None], uv[:, j, 1][:, None]
        xr, xi = vis[:, j, 0][:, None], vis[:, j, 1][:, None]
        sn, cs = sfu_phasor(kernel_phase(l, m, u, w))
        if sfu_error == "aligned":    # every term of re moved one way
            cs = cs + SFU_ERR * np.sign(xr)
            sn = sn - SFU_ERR * np.sign(xi)
        elif sfu_error == "random":
            cs = cs + SFU_ERR * rng.choice([-1.0, 1.0], cs.shape)
            sn = sn + SFU_ERR * rng.choice([-1.0, 1.0], sn.shape)
        cs, sn = cs.astype(F32), sn.astype(F32)
        fma = lambda a, b, c: (a.astype(F64) * b + c).astype(F32)  # noqa
        re = fma(xr, cs, re)
        re = fma(-xi, sn, re)
        im = fma(xr, sn, im)
        im = fma(xi, cs, im)
    return np.stack([re, im], axis=-1)


def _emulated_against_jax(sfu_error, reach):
    rng = np.random.default_rng(21)
    p, s, v = 40, 2, 2048
    lm, uv = _extremes(rng, p, s, v, reach)
    assert np.abs((lm[None, :, None, :] * uv[:, None, :, :]).sum(-1)).max() \
        == reach
    vis = rng.standard_normal((s, v, 2)).astype(F32)
    got = emulated_gridder(lm, uv, vis, sfu_error, rng)
    np.testing.assert_allclose(got, np.asarray(jax_gridder_ref(lm, uv, vis)),
                               rtol=1e-4, atol=2e-3)


@pytest.mark.parametrize("sfu_error", ["none", "random", "aligned"])
def test_emulated_gridder_at_4_pi_matches_jax(sfu_error):
    _emulated_against_jax(sfu_error, 2.0)


@pytest.mark.parametrize("sfu_error", ["none", "random", "aligned"])
def test_emulated_gridder_at_32_pi_matches_jax(sfu_error):
    _emulated_against_jax(sfu_error, 16.0)


def emulated_degridder(lm, uv, sub, sfu_error: str, rng):
    """The kernel's degridder in float32: the phase by one FMUL and one
    FFMA on lm scaled by TWO_PI (the gridder's), the SFU phasor, and each
    visibility's conjugate sums over P in order, 4 FMAs a term."""
    s, v, _ = uv.shape
    re = np.zeros((s, v), F32)
    im = np.zeros_like(re)
    u, w = uv[:, :, 0], uv[:, :, 1]
    fma = lambda a, b, c: (a.astype(F64) * b + c).astype(F32)  # noqa: E731
    for j in range(lm.shape[0]):
        l, m = lm[j, 0], lm[j, 1]
        gr, gi = sub[:, j, 0][:, None], sub[:, j, 1][:, None]
        sn, cs = sfu_phasor(kernel_phase(np.full_like(u, l),
                                         np.full_like(w, m), u, w))
        if sfu_error == "aligned":    # every term of re moved one way
            cs = cs + SFU_ERR * np.sign(gr)
            sn = sn + SFU_ERR * np.sign(gi)
        elif sfu_error == "random":
            cs = cs + SFU_ERR * rng.choice([-1.0, 1.0], cs.shape)
            sn = sn + SFU_ERR * rng.choice([-1.0, 1.0], sn.shape)
        cs, sn = cs.astype(F32), sn.astype(F32)
        re = fma(gr, cs, re)
        re = fma(gi, sn, re)
        im = fma(gi, cs, im)
        im = fma(-gr, sn, im)
    return np.stack([re, im], axis=-1)


def _emulated_degridder_against_jax(sfu_error, reach):
    rng = np.random.default_rng(22)
    p, s, v = 1024, 2, 48
    lm, uv = _extremes(rng, p, s, v, reach)
    assert np.abs((lm[None, :, None, :] * uv[:, None, :, :]).sum(-1)).max() \
        == reach
    sub = rng.standard_normal((s, p, 2)).astype(F32)
    got = emulated_degridder(lm, uv, sub, sfu_error, rng)
    np.testing.assert_allclose(
        got, np.asarray(jax_degridder_ref(lm, uv, sub)), rtol=1e-4,
        atol=2e-3)


@pytest.mark.parametrize("sfu_error", ["none", "random", "aligned"])
def test_emulated_degridder_at_4_pi_matches_jax(sfu_error):
    _emulated_degridder_against_jax(sfu_error, 2.0)


@pytest.mark.parametrize("sfu_error", ["none", "random", "aligned"])
def test_emulated_degridder_at_32_pi_matches_jax(sfu_error):
    _emulated_degridder_against_jax(sfu_error, 16.0)
