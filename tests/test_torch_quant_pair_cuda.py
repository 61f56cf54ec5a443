"""The quantizing scatters' kernels (``csrc/cache_update.cu``) against
their plain versions on the card, bit for bit in codes and scales.

Marked ``cuda``: these skip where there is no card.  On the machine with
the card run them with
``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_quant_pair_cuda.py``.
One and two leaves (a layer's k and v in one launch), float32 and
bfloat16 rows, T 1 and 32, D 64 and 40 (the 16-byte path: 8 or 16
lanes a vector, idle lanes at D 40) and 36 in bfloat16 (72 bytes a
vector: the general path, a warp a vector), and views one element into
their storage (the general path), contiguous and paged; the paged
kernel is compared outside the scratch page 0, and real pages no valid
row targets must keep their bytes.  Each pair call adds one to the
kernel's launch count.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import quant  # noqa: E402
from repro_torch.kernels.cache_update import kernel as cu_kernel  # noqa: E402
from repro_torch.kernels.cache_update import ops as cu_ops  # noqa: E402
from repro_torch.kernels.cache_update import ref as cu_ref  # noqa: E402

pytestmark = pytest.mark.cuda
MODES = ("int8", "fp8_e4m3")
B, C, H = 4, 80, 3
P, PS, NB = 40, 16, 6


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _bytes(t):
    return t.view(torch.uint8) if t.element_size() == 1 else t


def _randn(card, dt, *shape, seed=0, offset=0):
    """Rows of ``shape`` in ``dt``, a zero vector and +-1e4 extremes among
    them; with ``offset``, a contiguous view that many elements into its
    storage."""
    g = torch.Generator(device=card).manual_seed(seed)
    n = torch.Size(shape).numel()
    flat = (3 * torch.randn(n + offset, generator=g, device=card)).to(dt)
    x = flat[offset:].view(shape)
    x[0, 0, 0] = 0.0
    x[-1, 0, -1, :2] = torch.tensor([1e4, -1e4], dtype=dt)
    return x


def _leaf(card, mode, *shape, seed, offset=0):
    """A quantized leaf (codes, scales); with ``offset``, the codes a view
    that many bytes into their storage."""
    codes, scales = quant.quantize(
        torch.randn(shape, generator=torch.Generator(device=card).manual_seed(
            seed), device=card), mode)
    if offset:
        buf = torch.empty(codes.numel() + offset, dtype=codes.dtype,
                          device=card)
        buf[offset:].copy_(codes.reshape(-1))
        codes = buf[offset:].view(codes.shape)
    return codes, scales


def _clone(codes):
    """A copy of a code leaf with its storage offset kept (alignment)."""
    off = codes.storage_offset()
    buf = torch.empty(codes.numel() + off, dtype=codes.dtype,
                      device=codes.device)
    out = buf[off:].view(codes.shape)
    out.copy_(codes)
    return out


def _args(leaves):
    return [t for codes, scales, new in leaves
            for t in (_clone(codes), scales.clone(), new)]


def _contiguous_case(card, mode, dt, t, d, leaves, offset=0):
    ls = [(*_leaf(card, mode, B, C, H, d, seed=1 + i, offset=offset),
           _randn(card, dt, B, t, H, d, seed=3 + i, offset=offset))
          for i in range(leaves)]
    slots = torch.tensor([0, 17, C - t, C + 5], dtype=torch.int32,
                         device=card)
    return ls, slots


def _check_contiguous(ls, slots, mode):
    if len(ls) == 2:
        n0 = cu_kernel.quant_launches
        got = cu_ops.quant_cache_update_pair(*_args(ls), slots, mode)
        assert cu_kernel.quant_launches == n0 + 1
        want = cu_ref.quant_cache_update_pair_ref(*_args(ls), slots, mode)
    else:
        got = [cu_ops.quant_cache_update(*_args(ls), slots, mode)]
        want = [cu_ref.quant_cache_update_ref(*_args(ls), slots, mode)]
    torch.cuda.synchronize()
    for (gc, gs), (wc, ws) in zip(got, want):
        assert torch.equal(_bytes(gc), _bytes(wc))
        assert torch.equal(gs, ws)
        assert torch.isfinite(quant.dequantize(gc, gs)).all()


@pytest.mark.parametrize("d", [64, 40])
@pytest.mark.parametrize("t", [1, 32])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("leaves", [1, 2])
@pytest.mark.parametrize("mode", MODES)
def test_quant_scatter_kernel_is_bit_exact(card, mode, leaves, dt, t, d):
    _check_contiguous(*_contiguous_case(card, mode, dt, t, d, leaves), mode)


@pytest.mark.parametrize("leaves", [1, 2])
@pytest.mark.parametrize("mode", MODES)
def test_quant_scatter_kernel_general_path(card, mode, leaves):
    """D 36 in bfloat16 (72 bytes a vector), and views one element into
    their storage at D 64: a warp a vector."""
    _check_contiguous(*_contiguous_case(card, mode, torch.bfloat16, 32, 36,
                                        leaves), mode)
    _check_contiguous(*_contiguous_case(card, mode, torch.bfloat16, 1, 64,
                                        leaves, offset=1), mode)


def _paged_case(card, mode, dt, t, d, leaves, offset=0):
    ls = [(*_leaf(card, mode, P, PS, H, d, seed=5 + i, offset=offset),
           _randn(card, dt, B, t, H, d, seed=7 + i, offset=offset))
          for i in range(leaves)]
    g = torch.Generator().manual_seed(9)
    table = (torch.randperm(P - 1, generator=g)[:B * NB] + 1).reshape(
        B, NB).to(device=card, dtype=torch.int32)
    table[3] = 0                          # a dead row on the scratch page
    starts = torch.tensor([0, PS - 1, 5, 10 * PS * NB], dtype=torch.int32,
                          device=card)
    valids = torch.tensor([t, max(t - 3, 1), 0, 1], dtype=torch.int32,
                          device=card)
    return ls, (table, starts, valids)


def _check_paged(ls, where, mode):
    if len(ls) == 2:
        n0 = cu_kernel.quant_paged_launches
        got = cu_ops.quant_paged_cache_update_pair(*_args(ls), *where, mode)
        assert cu_kernel.quant_paged_launches == n0 + 1
        want = cu_ref.quant_paged_cache_update_pair_ref(*_args(ls), *where,
                                                        mode)
    else:
        got = [cu_ops.quant_paged_cache_update(*_args(ls), *where, mode)]
        want = [cu_ref.quant_paged_cache_update_ref(*_args(ls), *where,
                                                    mode)]
    torch.cuda.synchronize()
    for (gc, gs), (wc, ws), (codes, scales, _) in zip(got, want, ls):
        assert torch.equal(_bytes(gc)[1:], _bytes(wc)[1:])
        assert torch.equal(gs[1:], ws[1:])
        for page in where[0][2].tolist():     # row 2 is masked
            assert torch.equal(_bytes(gc[page]), _bytes(codes[page]))
            assert torch.equal(gs[page], scales[page])


@pytest.mark.parametrize("d", [64, 40])
@pytest.mark.parametrize("t", [1, 32])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("leaves", [1, 2])
@pytest.mark.parametrize("mode", MODES)
def test_quant_paged_scatter_kernel_is_bit_exact(card, mode, leaves, dt, t,
                                                 d):
    _check_paged(*_paged_case(card, mode, dt, t, d, leaves), mode)


@pytest.mark.parametrize("leaves", [1, 2])
@pytest.mark.parametrize("mode", MODES)
def test_quant_paged_scatter_kernel_general_path(card, mode, leaves):
    _check_paged(*_paged_case(card, mode, torch.bfloat16, 32, 36, leaves),
                 mode)
    _check_paged(*_paged_case(card, mode, torch.float32, 1, 64, leaves,
                              offset=1), mode)


def test_pair_wrappers_refuse_mismatched_leaves(card):
    """The two leaves of one launch share shapes and dtypes."""
    (kc, ks, kn), (vc, vs, vn) = _contiguous_case(card, "int8",
                                                  torch.bfloat16, 1, 64, 2)[0]
    slots = torch.zeros(B, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="differ"):
        cu_kernel.quant_cache_update_pair_cuda(kc, ks, kn, vc, vs,
                                               vn.float(), slots, "int8")
    with pytest.raises(ValueError, match="T <="):
        cu_kernel.quant_cache_update_cuda(
            kc, ks, torch.zeros(B, C + 1, H, 64, dtype=torch.bfloat16,
                                device=card), slots, "int8")
