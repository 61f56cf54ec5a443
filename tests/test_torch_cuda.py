"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: these skip where there is no card.  On the machine with
the card run them with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
Tolerances as in chip_smoke.py: 2e-5 in fp32 (summation order), one
bf16 rounding step of outputs below 4 (2^-6) in bf16; the scatter is
exact.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.cache_update import ops as cu_ops  # noqa: E402
from repro_torch.kernels.cache_update import ref as cu_ref  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.kernels.decode_attention import ref as da_ref  # noqa: E402
from repro_torch.kernels.prefill_attention import ops as pa_ops  # noqa: E402
from repro_torch.kernels.prefill_attention import ref as pa_ref  # noqa: E402

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
