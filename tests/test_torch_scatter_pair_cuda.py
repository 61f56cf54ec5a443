"""The copying scatters' kernels (``csrc/cache_update.cu``) against their
plain versions on the card, bit for bit.

Marked ``cuda``: these skip where there is no card.  On the machine with
the card run them with
``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_scatter_pair_cuda.py``.
One and two leaves (a layer's k and v in one launch), float32 and
bfloat16, F 192 (the serve path's 3 kv heads of 64: the 16-byte path)
and F 51 (rows that are no multiple of 16 bytes: the element path), and
views one element into their storage (the element path), contiguous and
paged (T 1 and 32, masked rows, a dead row past its table, ``valids``
None, also for the quantizing paged pair); the paged kernel is compared outside the scratch page 0, and real
pages no valid row targets must keep their bytes.  Each launch adds one
to the kernel's launch count.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import quant  # noqa: E402
from repro_torch.kernels.cache_update import kernel as cu_kernel  # noqa: E402
from repro_torch.kernels.cache_update import ops as cu_ops  # noqa: E402
from repro_torch.kernels.cache_update import ref as cu_ref  # noqa: E402

pytestmark = pytest.mark.cuda
B, C = 8, 96
P, PS, NB = 40, 16, 4
DTYPES = (torch.float32, torch.bfloat16)
# starts that keep every live row's 32 positions inside its table of NB
# pages of PS (with every row valid, a clamp would land several rows on
# the last slot, in no defined order); row 7 is dead, on page 0
ALL_VALID_STARTS = [0, PS - 1, 5, 2 * PS - 2, 20, 1, 3, 10 * PS * NB]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _randn(card, dt, *shape, seed=0, offset=0):
    """Normal draws of ``shape`` in ``dt``; with ``offset``, a contiguous
    view that many elements into its storage."""
    g = torch.Generator(device=card).manual_seed(seed)
    n = torch.Size(shape).numel()
    return torch.randn(n + offset, generator=g, device=card).to(dt)[
        offset:].view(shape)


def _clone(t):
    """A copy of ``t`` with its storage offset kept (alignment)."""
    off = t.storage_offset()
    buf = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)
    out = buf[off:].view(t.shape)
    out.copy_(t)
    return out


def _args(leaves):
    return [x for cache, new in leaves for x in (_clone(cache), new)]


def _contiguous(card, dt, f, leaves, offset=0):
    ls = [(_randn(card, dt, B, C, f, seed=1 + i, offset=offset),
           _randn(card, dt, B, 1, f, seed=3 + i, offset=offset))
          for i in range(leaves)]
    slots = torch.tensor([0, 17, C - 1, C + 5, 40, 41, 2, 95],
                         dtype=torch.int32, device=card)
    return ls, slots


def _check_contiguous(ls, slots):
    n0 = cu_kernel.launches
    if len(ls) == 2:
        got = cu_kernel.cache_update_pair_cuda(*_args(ls), slots)
        want = cu_ref.cache_update_pair_ref(*_args(ls), slots)
    else:
        got = [cu_kernel.cache_update_cuda(*_args(ls), slots)]
        want = [cu_ref.cache_update_ref(*_args(ls), slots)]
    torch.cuda.synchronize()
    assert cu_kernel.launches == n0 + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("f", [192, 51])
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("leaves", [1, 2])
def test_scatter_kernel_is_bit_exact(card, leaves, dt, f):
    _check_contiguous(*_contiguous(card, dt, f, leaves))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("leaves", [1, 2])
def test_scatter_kernel_misaligned_views(card, leaves, dt):
    """F 192 with every tensor one element into its storage: the element
    path."""
    _check_contiguous(*_contiguous(card, dt, 192, leaves, offset=1))


def test_scatter_pair_op_on_serve_caches(card):
    """The op on (B, C, KVH, hd) caches, as the decode layer calls it."""
    k, v = (_randn(card, torch.bfloat16, B, 1024, 3, 64, seed=s)
            for s in (5, 6))
    kn, vn = (_randn(card, torch.bfloat16, B, 1, 3, 64, seed=s)
              for s in (7, 8))
    cur = torch.tensor([0, 1, 511, 1023, 1030, 7, 64, 900],
                       dtype=torch.int32, device=card)
    want = cu_ref.cache_update_pair_ref(k.clone(), kn, v.clone(), vn, cur)
    got = cu_ops.cache_update_pair(k, kn, v, vn, cur)
    torch.cuda.synchronize()
    assert got[0] is k and got[1] is v
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _paged(card, dt, f, t, leaves, offset=0):
    ls = [(_randn(card, dt, P, PS, f, seed=9 + i, offset=offset),
           _randn(card, dt, B, t, f, seed=11 + i, offset=offset))
          for i in range(leaves)]
    g = torch.Generator().manual_seed(13)
    table = torch.randperm(P - 1, generator=g)[:B * NB] + 1
    table = table.reshape(B, NB).to(device=card, dtype=torch.int32)
    table[7] = 0                          # a dead row on the scratch page
    starts = torch.tensor([0, PS - 1, 5, NB * PS - 1, 20, 33, 3,
                           10 * PS * NB], dtype=torch.int32, device=card)
    valids = torch.tensor([t, max(t - 3, 1), 0, 1, t, 0, max(t // 2, 1),
                           1], dtype=torch.int32, device=card)
    return ls, (table, starts, valids)


def _kept(where, t, p):
    """(p * PS,) bools: rows of real pages that no valid row targets."""
    table, starts, valids = where
    dev = table.device
    pos = torch.clamp(starts.long()[:, None] + torch.arange(t, device=dev),
                      0, NB * PS - 1)
    ok = torch.arange(t, device=dev)[None] < valids.long()[:, None]
    hit = (torch.gather(table.long(), 1, pos // PS) * PS + pos % PS)[ok]
    kept = torch.ones(p * PS, dtype=torch.bool, device=dev)
    kept[hit] = False
    kept[:PS] = False                     # page 0: undefined
    return kept


def _check_paged(ls, where):
    n0 = cu_kernel.paged_launches
    if len(ls) == 2:
        got = cu_kernel.paged_cache_update_pair_cuda(*_args(ls), *where)
        want = cu_ref.paged_cache_update_pair_ref(*_args(ls), *where)
    else:
        got = [cu_kernel.paged_cache_update_cuda(*_args(ls), *where)]
        want = [cu_ref.paged_cache_update_ref(*_args(ls), *where)]
    torch.cuda.synchronize()
    assert cu_kernel.paged_launches == n0 + 1
    t = ls[0][1].shape[1]
    valids = where[2] if where[2] is not None else torch.full_like(
        where[1], t)
    kept = _kept((*where[:2], valids), t, P)
    for g, w, (pool, _) in zip(got, want, ls):
        assert torch.equal(g[1:], w[1:])
        f = pool.shape[2]
        assert torch.equal(g.view(P * PS, f)[kept],
                           pool.view(P * PS, f)[kept])


@pytest.mark.parametrize("f", [192, 51])
@pytest.mark.parametrize("t", [1, 32])
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("leaves", [1, 2])
def test_paged_scatter_kernel_is_bit_exact(card, leaves, dt, t, f):
    _check_paged(*_paged(card, dt, f, t, leaves))


@pytest.mark.parametrize("t", [1, 32])
@pytest.mark.parametrize("dt", DTYPES)
def test_paged_scatter_pair_valids_none(card, dt, t):
    """valids None (a null pointer to the kernel): every one of the T rows
    is written, as valids of T for every row write."""
    ls, (table, _, _) = _paged(card, dt, 192, t, 2)
    starts = torch.tensor(ALL_VALID_STARTS, dtype=torch.int32, device=card)
    _check_paged(ls, (table, starts, None))
    got = cu_kernel.paged_cache_update_pair_cuda(*_args(ls), table, starts)
    full = torch.full_like(starts, t)
    want = cu_kernel.paged_cache_update_pair_cuda(*_args(ls), table, starts,
                                                  full)
    torch.cuda.synchronize()
    assert all(torch.equal(g[1:], w[1:]) for g, w in zip(got, want))


@pytest.mark.parametrize("t", [1, 32])
@pytest.mark.parametrize("mode", ["int8", "fp8_e4m3"])
def test_quant_paged_pair_valids_none(card, mode, t):
    """The quantizing paged pair takes valids None too: its codes and
    scales equal its plain version's with valids of T for every row,
    outside page 0."""
    ls, (table, _, _) = _paged(card, torch.bfloat16, 192, t, 2)
    starts = torch.tensor(ALL_VALID_STARTS, dtype=torch.int32, device=card)
    leaves = [(*quant.quantize(pool.view(P, PS, 3, 64).float(), mode),
               new.view(B, t, 3, 64)) for pool, new in ls]
    args = lambda: [x.clone() for leaf in leaves for x in leaf]  # noqa: E731
    n0 = cu_kernel.quant_paged_launches
    got = cu_kernel.quant_paged_cache_update_pair_cuda(
        *args(), table, starts, None, mode)
    want = cu_ref.quant_paged_cache_update_pair_ref(
        *args(), table, starts, torch.full_like(starts, t), mode)
    torch.cuda.synchronize()
    assert cu_kernel.quant_paged_launches == n0 + 1
    for (gc, gs), (wc, ws) in zip(got, want):
        assert torch.equal(gc.view(torch.uint8)[1:], wc.view(torch.uint8)[1:])
        assert torch.equal(gs[1:], ws[1:])


@pytest.mark.parametrize("t", [1, 32])
@pytest.mark.parametrize("leaves", [1, 2])
def test_paged_scatter_kernel_misaligned_views(card, leaves, t):
    _check_paged(*_paged(card, torch.bfloat16, 192, t, leaves, offset=1))


def test_pair_wrappers_refuse_mismatched_leaves(card):
    """The two leaves of one launch share shapes and dtype; a one-leaf
    paged launch needs valids."""
    (k, kn), (v, vn) = _contiguous(card, torch.bfloat16, 192, 2)[0]
    slots = torch.zeros(B, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="differ"):
        cu_kernel.cache_update_pair_cuda(k, kn, v.float(), vn.float(), slots)
    with pytest.raises(ValueError, match="differ"):
        cu_kernel.cache_update_pair_cuda(k, kn, v[:, :10].contiguous(), vn,
                                         slots)
    with pytest.raises(ValueError, match="new is"):
        cu_kernel.cache_update_pair_cuda(k, kn, v, vn.float(), slots)
    ls, (table, starts, valids) = _paged(card, torch.bfloat16, 192, 1, 2)
    (kp, kpn), (vp, vpn) = ls
    with pytest.raises(ValueError, match="differ"):
        cu_kernel.paged_cache_update_pair_cuda(kp, kpn, vp, vpn[:4], table,
                                               starts, valids)
    with pytest.raises(ValueError, match="needs valids"):
        cu_kernel.paged_cache_update_cuda(kp, kpn, table, starts, None)
