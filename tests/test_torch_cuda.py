"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: these skip where there is no card.  On the machine with
the card run them with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
Tolerances as in chip_smoke.py: 2e-5 in fp32 (summation order), one
bf16 rounding step of outputs below 4 (2^-6) in bf16; the scatter is
exact, the paged scatter exact outside the scratch page 0, and so are
the quantizing scatters (codes and scales bit for bit); the quantized
attention kernels hold the bf16 tolerance against their plain versions,
which dequantize to the same float32 values (the tensor-core prefill
kernel, bf16 q over codes, multiplies the row scales onto its fp32
scores and probabilities instead: the same values up to fp32 rounding
order).  Flash attention: TOL in
fp32, and in bf16 2^-5 + 2e-5 (its plain oracle rounds the
probabilities to bf16, the kernel keeps them to fp32 precision).  The
Fig. 2 kernels: STREAM and JACOBI2D exact (also one element off their
alignment), FMA32 within 1e-6 relative, GEMM within 1e-5 of max |out|,
GRIDDER and DEGRIDDER within rtol 1e-4 and atol 2e-3 (the JAX tests'
own; also with phases at 4 pi and 32 pi, and one float off their
alignment), their pair adjoint within 1e-3 relative.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import quant, split_kv  # noqa: E402
from repro_torch.kernels.cache_update import kernel as cu_kernel  # noqa: E402
from repro_torch.kernels.cache_update import ops as cu_ops  # noqa: E402
from repro_torch.kernels.cache_update import ref as cu_ref  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as da_kernel  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.kernels.decode_attention import ref as da_ref  # noqa: E402
from repro_torch.kernels.prefill_attention import kernel as pa_kernel  # noqa: E402
from repro_torch.kernels.prefill_attention import ops as pa_ops  # noqa: E402
from repro_torch.kernels.prefill_attention import ref as pa_ref  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.fma32 import kernel as fma_kernel  # noqa: E402
from repro_torch.kernels.fma32 import ops as fma_ops  # noqa: E402
from repro_torch.kernels.fma32 import ref as fma_ref  # noqa: E402
from repro_torch.kernels.gemm import ops as gemm_ops  # noqa: E402
from repro_torch.kernels.gemm import ref as gemm_ref  # noqa: E402
from repro_torch.kernels.gridder import kernel as grid_kernel  # noqa: E402
from repro_torch.kernels.gridder import ops as grid_ops  # noqa: E402
from repro_torch.kernels.gridder import ref as grid_ref  # noqa: E402
from repro_torch.kernels.jacobi2d import kernel as jac_kernel  # noqa: E402
from repro_torch.kernels.jacobi2d import ops as jac_ops  # noqa: E402
from repro_torch.kernels.jacobi2d import ref as jac_ref  # noqa: E402
from repro_torch.kernels.stream import kernel as st_kernel  # noqa: E402
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


# -- the paged kernels --------------------------------------------------------

def _table(card, b, nb, num_pages, seed=0):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randperm(num_pages - 1, generator=g)[:b * nb] + 1
    return ids.reshape(b, nb).to(device=card, dtype=torch.int32)


@pytest.mark.parametrize("ps,t", [(16, 1), (16, 32), (24, 7), (8, 16)])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_paged_cache_update_kernel_is_exact_outside_page_0(card, dt, ps, t):
    p, b, nb = 40, 4, 8
    pool = _randn(card, dt, p, ps, 3, 64)
    new = _randn(card, dt, b, t, 3, 64, seed=1)
    table = _table(card, b, nb, p)
    table[3] = 0                              # a dead row on the scratch page
    starts = torch.tensor([0, ps - 1, 5, 10 * ps * nb], dtype=torch.int32,
                          device=card)
    valids = torch.tensor([t, max(t - 3, 0), 0, 1], dtype=torch.int32,
                          device=card)
    want = cu_ref.paged_cache_update_ref(pool.clone(), new, table, starts,
                                         valids)
    got = cu_ops.paged_cache_update(pool.clone(), new, table, starts, valids)
    assert torch.equal(got[1:], want[1:])
    # row 2 is masked: its pages keep their bits
    for page in table[2].tolist():
        assert torch.equal(got[page], pool[page])


@pytest.mark.parametrize("ps,window,softcap", [
    (16, None, None), (24, 40, None), (8, None, 30.0), (8, 20, 10.0)])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_paged_decode_kernel_matches_plain(card, dt, ps, window, softcap):
    b, kvh, g, hd, p, nb = 5, 3, 3, 64, 60, 10
    q = _randn(card, dt, b, 1, kvh * g, hd)
    k = _randn(card, dt, p, ps, kvh, hd, seed=1)
    v = _randn(card, dt, p, ps, kvh, hd, seed=2)
    table = _table(card, b, nb, p)
    c = nb * ps
    lens = torch.tensor([0, 1, ps, c - 1, c + 3], dtype=torch.int32,
                        device=card)
    kw = dict(window=window, softcap=softcap, scale=0.125)
    got = da_ops.decode_attention_paged(q, k, v, table, lens, **kw)
    want = da_ref.decode_attention_paged_ref(
        q.reshape(b, kvh, g, hd), k, v, table, lens,
        **kw).reshape(b, 1, kvh * g, hd)
    assert float((got.float() - want.float()).abs().max()) <= TOL[dt]


@pytest.mark.parametrize("ps,window,softcap", [
    (16, None, None), (24, 40, None), (8, None, 30.0), (8, 20, 10.0)])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_paged_prefill_kernel_matches_plain(card, dt, ps, window, softcap):
    b, t, kvh, g, hd, p, nb = 4, 32, 3, 3, 64, 60, 10
    q = _randn(card, dt, b, t, kvh * g, hd)
    kx = _randn(card, dt, b, t, kvh, hd, seed=1)
    vx = _randn(card, dt, b, t, kvh, hd, seed=2)
    k = _randn(card, dt, p, ps, kvh, hd, seed=3)
    v = _randn(card, dt, p, ps, kvh, hd, seed=4)
    table = _table(card, b, nb, p)
    offs = torch.tensor([0, ps, ps + 1, nb * ps - t], dtype=torch.int32,
                        device=card)
    kw = dict(window=window, softcap=softcap, scale=0.125)
    got = pa_ops.prefill_attention_paged(q, kx, vx, k, v, table, offs, **kw)
    qg = q.reshape(b, t, kvh, g, hd).permute(0, 2, 1, 3, 4)
    want = pa_ref.prefill_attention_paged_ref(qg, kx, vx, k, v, table, offs,
                                              **kw)
    want = want.permute(0, 2, 1, 3, 4).reshape(b, t, kvh * g, hd)
    assert float((got.float() - want.float()).abs().max()) <= TOL[dt]


# -- the bf16 tensor-core prefill kernel: split-KV edges --------------------
# (b, t, c, kvh, g, hd, offs): a prefix ending on a split boundary (80 =
# 5 shares of 16 keys of 8 splits at B1 C1024), no cache phase, offsets
# at and past C, B8 with uneven offsets (8 splits), hd 36 (rows not whole
# 16-byte units: element loads), hd 128 and hd 16.

TC_CASES = {
    "split boundary": (1, 32, 1024, 3, 3, 64, [80]),
    "no cache phase": (1, 32, 1024, 3, 3, 64, [0]),
    "off >= C": (2, 32, 256, 3, 3, 64, [256, 700]),
    "uneven B8": (8, 32, 1024, 3, 3, 64, [0, 3, 1023, 1024, 5000, 16, 640,
                                          81]),
    "hd36": (2, 9, 100, 1, 4, 36, [50, 100]),
    "hd128": (2, 20, 300, 2, 4, 128, [299, 31]),
    "hd16 T70": (2, 70, 200, 1, 2, 16, [150, 0]),
}


@pytest.mark.parametrize("case", sorted(TC_CASES))
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_prefill_kernel_split_kv_edges_match_plain(card, dt, case):
    b, t, c, kvh, g, hd, offs = TC_CASES[case]
    qg = _randn(card, dt, b, kvh, t, g, hd)
    kx = _randn(card, dt, b, t, kvh, hd, seed=1)
    vx = _randn(card, dt, b, t, kvh, hd, seed=2)
    kc = _randn(card, dt, b, c, kvh, hd, seed=3)
    vc = _randn(card, dt, b, c, kvh, hd, seed=4)
    offs = torch.tensor(offs, dtype=torch.int32, device=card)
    kw = dict(scale=hd ** -0.5)
    got = pa_kernel.prefill_attention_cuda(qg, kx, vx, kc, vc, offs, **kw)
    want = pa_ref.prefill_attention_ref(qg, kx, vx, kc, vc, offs, **kw)
    assert float((got.float() - want.float()).abs().max()) <= TOL[dt]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_paged_prefill_kernel_uneven_offsets_and_dead_rows(card, dt):
    """B8 over 8 splits of 1024 positions, offsets off every share
    boundary, at 0, at and past the table's end; rows 1 and 3 dead (their
    table all on the scratch page 0)."""
    b, t, kvh, g, hd, p, ps, nb = 8, 32, 3, 3, 64, 513, 16, 64
    qg = _randn(card, dt, b, kvh, t, g, hd)
    kx = _randn(card, dt, b, t, kvh, hd, seed=1)
    vx = _randn(card, dt, b, t, kvh, hd, seed=2)
    k = _randn(card, dt, p, ps, kvh, hd, seed=3)
    v = _randn(card, dt, p, ps, kvh, hd, seed=4)
    table = _table(card, b, nb, p)
    table[1] = table[3] = 0
    offs = torch.tensor([17, 0, 1000, 1024, 1100, 31, 480, 255],
                        dtype=torch.int32, device=card)
    got = pa_kernel.prefill_attention_paged_cuda(qg, kx, vx, k, v, table,
                                                 offs, scale=0.125)
    want = pa_ref.prefill_attention_paged_ref(qg, kx, vx, k, v, table, offs,
                                              scale=0.125)
    assert float((got.float() - want.float()).abs().max()) <= TOL[dt]


def _ticket_sum(card):
    """The split-KV tickets of the current stream, summed: 0 between
    launches."""
    key = (card.index if card.index is not None
           else torch.cuda.current_device(),
           torch.cuda.current_stream().cuda_stream)
    return int(split_kv._tickets[key].abs().sum())


@pytest.mark.parametrize("mode", [None, "int8"])
def test_prefill_tc_kernel_is_deterministic_and_leaves_tickets_at_0(card,
                                                                    mode):
    """The last split to arrive folds the partials in split order, so two
    launches give the same bits; each leaves its tickets at 0 (bf16 cache
    and int8 codes)."""
    b, t, c, kvh, g, hd = 1, 32, 1024, 3, 3, 64
    dt = torch.bfloat16
    kc = _randn(card, dt, b, c, kvh, hd, seed=3)
    vc = _randn(card, dt, b, c, kvh, hd, seed=4)
    kw = dict(scale=0.125)
    if mode:
        (kc, kw["k_scale"]), (vc, kw["v_scale"]) = (
            quant.quantize(x, mode) for x in (kc, vc))
    args = (_randn(card, dt, b, kvh, t, g, hd),
            _randn(card, dt, b, t, kvh, hd, seed=1),
            _randn(card, dt, b, t, kvh, hd, seed=2), kc, vc,
            torch.tensor([700], dtype=torch.int32, device=card))
    first = pa_kernel.prefill_attention_cuda(*args, **kw)
    again = pa_kernel.prefill_attention_cuda(*args, **kw)
    assert torch.equal(first, again)
    assert _ticket_sum(card) == 0


def _decode_serve_inputs(card, dt=torch.bfloat16):
    """Row 3's serve-path case: B8 C1024 KVH3 G3 hd64."""
    b, c, kvh, g, hd = 8, 1024, 3, 3, 64
    lens = torch.tensor([0, 1, 511, 1023, 37, 300, 700, 1000],
                        dtype=torch.int32, device=card)
    return (_randn(card, dt, b, kvh, g, hd), _randn(card, dt, b, c, kvh, hd,
                                                   seed=1),
            _randn(card, dt, b, c, kvh, hd, seed=2), lens)


@pytest.mark.parametrize("mode", [None, "int8"])
def test_decode_kernel_is_deterministic_and_leaves_tickets_at_0(card, mode):
    """The last split to arrive folds the partials in split order, so
    repeated launches give the same bits, contiguous and paged; each
    leaves its tickets at 0."""
    q, k, v, lens = _decode_serve_inputs(card)
    kw = dict(scale=0.125)
    if mode:
        (k, kw["k_scale"]), (v, kw["v_scale"]) = (
            quant.quantize(x, mode) for x in (k, v))
    first = da_kernel.decode_attention_cuda(q, k, v, lens, **kw)
    for _ in range(3):
        assert torch.equal(da_kernel.decode_attention_cuda(q, k, v, lens,
                                                           **kw), first)
    assert _ticket_sum(card) == 0
    table = torch.arange(64, dtype=torch.int32, device=card).repeat(8, 1)
    table += 64 * torch.arange(8, dtype=torch.int32, device=card)[:, None]
    pool = lambda x: x.reshape(8 * 64, 16, *x.shape[2:])
    pk = dict(kw)
    if mode:
        pk = dict(scale=0.125, k_scale=pool(kw["k_scale"]),
                  v_scale=pool(kw["v_scale"]))
    paged = da_kernel.decode_attention_paged_cuda(q, pool(k), pool(v), table,
                                                  lens, **pk)
    assert torch.equal(da_kernel.decode_attention_paged_cuda(
        q, pool(k), pool(v), table, lens, **pk), paged)
    # the pages are the contiguous cache's rows: the same function
    assert float((paged.float() - first.float()).abs().max()) \
        <= TOL[torch.bfloat16]
    assert _ticket_sum(card) == 0


def test_decode_kernel_cuda_graph_replay_equals_eager(card):
    """The split workspace and the tickets are capturable: a CUDA graph
    of the call, replayed on new lens and q, gives the eager call's
    bits, and leaves the tickets at 0."""
    q, k, v, lens = _decode_serve_inputs(card)
    call = lambda: da_kernel.decode_attention_cuda(q, k, v, lens,
                                                   scale=0.125)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    lens.copy_(torch.tensor([1023, 5, 64, 0, 900, 128, 79, 512],
                            dtype=torch.int32))
    q.copy_(_randn(card, torch.bfloat16, *q.shape, seed=9))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, call())
    assert _ticket_sum(card) == 0


@pytest.mark.parametrize("mode", [None, "fp8_e4m3"])
def test_paged_decode_kernel_all_dead_batch_gives_0(card, mode):
    """Every row's window starts past its table's end: no split has a key
    and the output is exactly 0 (the plain version gives the mean)."""
    b, kvh, g, hd, p, ps, nb = 8, 3, 3, 64, 200, 16, 8
    q = _randn(card, torch.bfloat16, b, kvh, g, hd)
    k = _randn(card, torch.bfloat16, p, ps, kvh, hd, seed=1)
    v = _randn(card, torch.bfloat16, p, ps, kvh, hd, seed=2)
    kw = dict(window=16, scale=0.125)
    if mode:
        (k, kw["k_scale"]), (v, kw["v_scale"]) = (
            quant.quantize(x, mode) for x in (k, v))
    lens = torch.tensor([nb * ps + 15 + i * 40 for i in range(b)],
                        dtype=torch.int32, device=card)
    table = _table(card, b, nb, p)
    out = da_kernel.decode_attention_paged_cuda(q, k, v, table, lens, **kw)
    assert torch.equal(out, torch.zeros_like(out))
    assert _ticket_sum(card) == 0


@pytest.mark.parametrize("hd,offset", [(36, 0), (20, 0), (64, 1)])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_decode_kernel_element_path_matches_plain(card, dt, hd, offset):
    """Rows that are not whole 8-element chunks (hd 36, 20) or start off
    their loads' alignment (a cache one element into its storage) are
    read element by element into the same registers."""
    b, c, kvh, g = 3, 300, 2, 5
    q = _randn(card, dt, b, kvh, g, hd)
    store = _randn(card, dt, 2, b * c * kvh * hd + offset, seed=1)
    k = store[0, offset:].view(b, c, kvh, hd)
    v = store[1, offset:].view(b, c, kvh, hd)
    lens = torch.tensor([0, 150, 299], dtype=torch.int32, device=card)
    got = da_kernel.decode_attention_cuda(q, k, v, lens, scale=0.2)
    want = da_ref.decode_attention_ref(q, k, v, lens, scale=0.2)
    assert float((got.float() - want.float()).abs().max()) <= TOL[dt]


def test_decode_smem_bytes_is_the_kernels(card):
    """The wrapper's ``smem_bytes`` equals the shared memory the decode
    kernel launches with (``pmt_decode_smem_bytes``)."""
    from repro_torch.kernels import build
    _chip_smoke().check_decode_smem(build.library(), da_kernel)


def test_redesigned_kernels_sass_and_spills(card):
    """chip_smoke.py's gate: the tensor-core prefill kernels (bf16 q over
    bf16, int8 or fp8 caches) hold HMMA, the GEMM and flash-decode kernels
    FFMA and neither HMMA nor HGMMA, the gridder and the degridder MUFU
    and FFMA, JACOBI2D 16-byte LDG and STG, and ptxas spills nothing in
    any of them."""
    from repro_torch.kernels import build
    build.library()
    _chip_smoke().check_redesigns(build)


# -- quantized caches (int8 / fp8_e4m3 codes with float32 row scales) --------

MODES = ("int8", "fp8_e4m3")


def _bytes(t):
    return t.view(torch.uint8) if t.element_size() == 1 else t


def _codes(card, mode, *shape, seed=0):
    """A quantized cache of ``shape``: (codes, scales)."""
    return quant.quantize(_randn(card, torch.float32, *shape, seed=seed), mode)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", MODES)
def test_quant_cache_update_kernel_is_bit_exact(card, mode, dt):
    """Codes and scales equal the plain version's bit for bit, on a zero
    row and on +-1e4 extremes too, with no NaN."""
    cache, scales = _codes(card, mode, 4, 33, 3, 64)
    new = _randn(card, dt, 4, 1, 3, 64, seed=1)
    new[1, 0, 2] = 0.0
    new[2, 0, 0, :2] = torch.tensor([1e4, -1e4], dtype=dt)
    slots = torch.tensor([0, 32, 7, 40], dtype=torch.int32, device=card)
    n0 = cu_kernel.quant_launches
    want = cu_ref.quant_cache_update_ref(cache.clone(), scales.clone(), new,
                                         slots, mode)
    got = cu_ops.quant_cache_update(cache.clone(), scales.clone(), new,
                                    slots, mode)
    assert cu_kernel.quant_launches == n0 + 1
    assert torch.equal(_bytes(got[0]), _bytes(want[0]))
    assert torch.equal(got[1], want[1])
    assert torch.isfinite(quant.dequantize(*got)).all()


@pytest.mark.parametrize("ps,t", [(16, 1), (16, 32), (24, 7), (8, 16)])
@pytest.mark.parametrize("mode", MODES)
def test_quant_paged_cache_update_kernel_is_bit_exact(card, mode, ps, t):
    p, b, nb = 40, 4, 8
    pool, scales = _codes(card, mode, p, ps, 3, 64)
    new = _randn(card, torch.bfloat16, b, t, 3, 64, seed=1)
    table = _table(card, b, nb, p)
    table[3] = 0                              # a dead row on the scratch page
    starts = torch.tensor([0, ps - 1, 5, 10 * ps * nb], dtype=torch.int32,
                          device=card)
    valids = torch.tensor([t, max(t - 3, 0), 0, 1], dtype=torch.int32,
                          device=card)
    args = (new, table, starts, valids, mode)
    want = cu_ref.quant_paged_cache_update_ref(pool.clone(), scales.clone(),
                                               *args)
    got = cu_ops.quant_paged_cache_update(pool.clone(), scales.clone(), *args)
    assert torch.equal(_bytes(got[0])[1:], _bytes(want[0])[1:])
    assert torch.equal(got[1][1:], want[1][1:])
    for page in table[2].tolist():            # row 2 is masked
        assert torch.equal(_bytes(got[0][page]), _bytes(pool[page]))
        assert torch.equal(got[1][page], scales[page])


@pytest.mark.parametrize("layout", ["contiguous", "ring", "paged",
                                    "paged window softcap"])
@pytest.mark.parametrize("mode", MODES)
def test_quant_decode_kernel_matches_plain(card, mode, layout):
    b, kvh, g, hd, dt = 5, 3, 3, 64, torch.bfloat16
    q = _randn(card, dt, b, 1, kvh * g, hd)
    if layout.startswith("paged"):
        ps, p, nb = (8, 60, 10) if "window" in layout else (16, 60, 10)
        k, ks = _codes(card, mode, p, ps, kvh, hd, seed=1)
        v, vs = _codes(card, mode, p, ps, kvh, hd, seed=2)
        table, c = _table(card, b, nb, p), nb * ps
        lens = torch.tensor([0, 1, ps, c - 1, c + 3], dtype=torch.int32,
                            device=card)
        kw = dict(scale=0.125, k_scale=ks, v_scale=vs)
        if "window" in layout:
            kw.update(window=20, softcap=10.0)
        n0 = da_kernel.quant_paged_launches
        got = da_ops.decode_attention_paged(q, k, v, table, lens, **kw)
        assert da_kernel.quant_paged_launches == n0 + 1
        want = da_ref.decode_attention_paged_ref(
            q.reshape(b, kvh, g, hd), k, v, table, lens, **kw)
    else:
        c = 200
        k, ks = _codes(card, mode, b, c, kvh, hd, seed=1)
        v, vs = _codes(card, mode, b, c, kvh, hd, seed=2)
        lens = torch.tensor([0, 1, 100, 199, 450], dtype=torch.int32,
                            device=card)
        kw = dict(ring=layout == "ring", scale=0.125, k_scale=ks, v_scale=vs)
        n0 = da_kernel.quant_launches
        got = da_ops.decode_attention(q, k, v, lens, **kw)
        assert da_kernel.quant_launches == n0 + 1
        want = da_ref.decode_attention_ref(q.reshape(b, kvh, g, hd), k, v,
                                           lens, **kw)
    want = want.reshape(b, 1, kvh * g, hd)
    assert float((got.float() - want.float()).abs().max()) <= TOL[dt]


@pytest.mark.parametrize("layout", ["contiguous", "ring", "paged",
                                    "paged window softcap"])
@pytest.mark.parametrize("mode", MODES)
def test_quant_prefill_kernel_matches_plain(card, mode, layout):
    b, t, kvh, g, hd, dt = 4, 32, 3, 3, 64, torch.bfloat16
    q = _randn(card, dt, b, t, kvh * g, hd)
    kx = _randn(card, dt, b, t, kvh, hd, seed=1)
    vx = _randn(card, dt, b, t, kvh, hd, seed=2)
    qg = q.reshape(b, t, kvh, g, hd).permute(0, 2, 1, 3, 4)
    if layout.startswith("paged"):
        ps, p, nb = (8, 60, 10) if "window" in layout else (24, 60, 10)
        k, ks = _codes(card, mode, p, ps, kvh, hd, seed=3)
        v, vs = _codes(card, mode, p, ps, kvh, hd, seed=4)
        table = _table(card, b, nb, p)
        offs = torch.tensor([0, ps, ps + 1, nb * ps - t], dtype=torch.int32,
                            device=card)
        kw = dict(scale=0.125, k_scale=ks, v_scale=vs)
        if "window" in layout:
            kw.update(window=20, softcap=10.0)
        n0 = pa_kernel.quant_paged_launches
        got = pa_ops.prefill_attention_paged(q, kx, vx, k, v, table, offs,
                                             **kw)
        assert pa_kernel.quant_paged_launches == n0 + 1
        want = pa_ref.prefill_attention_paged_ref(qg, kx, vx, k, v, table,
                                                  offs, **kw)
    else:
        c = 96
        k, ks = _codes(card, mode, b, c, kvh, hd, seed=3)
        v, vs = _codes(card, mode, b, c, kvh, hd, seed=4)
        offs = torch.tensor([0, 1, 70, 300], dtype=torch.int32, device=card)
        ring = layout == "ring"
        kw = dict(ring=ring, window=64 if ring else None, scale=0.125,
                  k_scale=ks, v_scale=vs)
        n0 = pa_kernel.quant_launches
        got = pa_ops.prefill_attention(q, kx, vx, k, v, offs, **kw)
        assert pa_kernel.quant_launches == n0 + 1
        want = pa_ref.prefill_attention_ref(qg, kx, vx, k, v, offs, **kw)
    want = want.permute(0, 2, 1, 3, 4).reshape(b, t, kvh * g, hd)
    assert float((got.float() - want.float()).abs().max()) <= TOL[dt]


@pytest.mark.parametrize("case", sorted(TC_CASES))
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", MODES)
def test_quant_prefill_kernel_split_kv_edges_match_plain(card, mode, dt,
                                                         case):
    """TC_CASES over a cache of codes: bf16 q takes the tensor-core kernel
    (codes widened to bf16, row scales on the fp32 fragments; hd 36, no
    multiple of 16, copies its codes element by element), fp32 q the
    CUDA-core one."""
    b, t, c, kvh, g, hd, offs = TC_CASES[case]
    qg = _randn(card, dt, b, kvh, t, g, hd)
    kx = _randn(card, dt, b, t, kvh, hd, seed=1)
    vx = _randn(card, dt, b, t, kvh, hd, seed=2)
    kc, ks = _codes(card, mode, b, c, kvh, hd, seed=3)
    vc, vs = _codes(card, mode, b, c, kvh, hd, seed=4)
    offs = torch.tensor(offs, dtype=torch.int32, device=card)
    kw = dict(scale=hd ** -0.5, k_scale=ks, v_scale=vs)
    got = pa_kernel.prefill_attention_cuda(qg, kx, vx, kc, vc, offs, **kw)
    want = pa_ref.prefill_attention_ref(qg, kx, vx, kc, vc, offs, **kw)
    assert float((got.float() - want.float()).abs().max()) <= TOL[dt]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", MODES)
def test_quant_paged_prefill_kernel_uneven_offsets_and_dead_rows(card, mode,
                                                                 dt):
    """The paged split-KV case above (uneven offsets, rows 1 and 3 dead)
    over pools of codes, the scale pools paged with them."""
    b, t, kvh, g, hd, p, ps, nb = 8, 32, 3, 3, 64, 513, 16, 64
    qg = _randn(card, dt, b, kvh, t, g, hd)
    kx = _randn(card, dt, b, t, kvh, hd, seed=1)
    vx = _randn(card, dt, b, t, kvh, hd, seed=2)
    k, ks = _codes(card, mode, p, ps, kvh, hd, seed=3)
    v, vs = _codes(card, mode, p, ps, kvh, hd, seed=4)
    table = _table(card, b, nb, p)
    table[1] = table[3] = 0
    offs = torch.tensor([17, 0, 1000, 1024, 1100, 31, 480, 255],
                        dtype=torch.int32, device=card)
    kw = dict(scale=0.125, k_scale=ks, v_scale=vs)
    got = pa_kernel.prefill_attention_paged_cuda(qg, kx, vx, k, v, table,
                                                 offs, **kw)
    want = pa_ref.prefill_attention_paged_ref(qg, kx, vx, k, v, table, offs,
                                              **kw)
    assert float((got.float() - want.float()).abs().max()) <= TOL[dt]


# -- flash attention (the train path) -----------------------------------------

FLASH_BF16_TOL = 2.0 ** -5 + 2e-5
# bf16 kernel against the fp32 oracle on the same bf16 values: one
# rounding of the fp32 result to bf16 (2^-8 relative) beyond fp32 sums
# in other orders
FLASH_BF16_REL, FLASH_BF16_ATOL = 2.0 ** -8, 2 * TOL[torch.float32]


def _flash_inputs(card, dt, b, sq, skv, h, kvh, hd, amp=1.0):
    """q, k, v; q and k times ``amp`` before the cast to ``dt``."""
    f32 = torch.float32
    return ((amp * _randn(card, f32, b * h, sq, hd)).to(dt),
            (amp * _randn(card, f32, b * kvh, skv, hd, seed=1)).to(dt),
            _randn(card, dt, b * kvh, skv, hd, seed=2))


def _chip_smoke():
    """chip_smoke.py at the repo's root: its SASS reader and shared-memory
    check serve these tests too."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# (b, sq, skv, h, kvh, hd, window, softcap, amp); the last: q and k
# scaled by 3.5, so scores reach |s| ~50, the running max jumps from tile
# to tile and alpha rescales the accumulator hard
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [(2, 256, 256, 9, 3, 64, None, None, 1.0),
                                  (1, 77, 77, 4, 2, 32, 20, 30.0, 1.0),
                                  (2, 100, 300, 4, 4, 128, None, None, 1.0),
                                  (1, 300, 100, 3, 1, 16, 250, None, 1.0),
                                  (2, 512, 512, 4, 2, 128, None, None, 1.0),
                                  (2, 1024, 1024, 9, 3, 64, None, None, 3.5)])
def test_flash_attention_kernel_matches_plain(card, dt, case):
    b, sq, skv, h, kvh, hd, window, softcap, amp = case
    q, k, v = _flash_inputs(card, dt, b, sq, skv, h, kvh, hd, amp)
    kw = dict(causal=True, window=window, softcap=softcap,
              scale=hd ** -0.5)
    if amp != 1.0:
        assert float((q[0].float() @ k[0].float().T).abs().max()) \
            * kw["scale"] > 40
    got = fa_kernel.flash_attention_cuda(q, k, v, **kw)
    want = fa_ref.flash_attention_ref(q, k, v, **kw)
    tol = TOL[dt] if dt == torch.float32 else FLASH_BF16_TOL
    assert got.dtype == dt
    assert float((got.float() - want.float()).abs().max()) <= tol
    if dt == torch.bfloat16:
        exact = fa_ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                           **kw)
        assert bool(((got.float() - exact).abs() <= FLASH_BF16_REL
                     * exact.abs() + FLASH_BF16_ATOL).all())


def test_flash_attention_sass_runs_bf16_on_tensor_cores(card):
    """The built library's bf16 flash kernels hold HGMMA (wgmma) and
    UTMALDG (TMA loads); the fp32 ones no HGMMA (chip_smoke.py's check,
    from ``cuobjdump -sass``)."""
    from repro_torch.kernels import build
    build.library()
    _chip_smoke().check_flash_sass(build.library_path())


def test_flash_attention_smem_bytes_is_the_kernels(card):
    """The wrapper's ``smem_bytes`` equals the shared memory each bf16
    kernel launches with (``pmt_flash_smem_bytes``, from ``tc::Tiles``)."""
    from repro_torch.kernels import build
    _chip_smoke().check_flash_smem(build.library(), fa_kernel)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_rows_with_no_key_are_zero(card, dt):
    """Sq 300 on Skv 100 with window 20: rows 119 and on can attend no
    key.  They come out as zeros (the oracle averages every key there),
    also where their tile of query rows shares key tiles with rows that
    have keys (rows 119-127); every other row matches the oracle."""
    b, sq, skv, h, kvh, hd, window = 2, 300, 100, 4, 2, 64, 20
    q, k, v = _flash_inputs(card, dt, b, sq, skv, h, kvh, hd)
    kw = dict(causal=True, window=window, scale=hd ** -0.5)
    got = fa_kernel.flash_attention_cuda(q, k, v, **kw)
    want = fa_ref.flash_attention_ref(q, k, v, **kw)
    first = skv + window - 1
    tol = TOL[dt] if dt == torch.float32 else FLASH_BF16_TOL
    assert float((got[:, :first].float() - want[:, :first].float())
                 .abs().max()) <= tol
    assert bool((got[:, first:] == 0).all())


def test_flash_attention_op_launches_once_per_forward(card):
    """The op launches the kernel in its forward (again when a checkpoint
    recomputes it) and never in its backward, which is the oracle's VJP:
    its gradients equal the oracle's."""
    from torch.utils.checkpoint import checkpoint
    b, s, h, kvh, hd = 2, 128, 4, 2, 64
    mk = lambda *shape, seed: _randn(card, torch.float32, *shape,
                                     seed=seed).requires_grad_()
    q, k, v = mk(b, s, h, hd, seed=0), mk(b, s, kvh, hd, seed=1), \
        mk(b, s, kvh, hd, seed=2)
    g = _randn(card, torch.float32, b, s, h, hd, seed=3)
    n0 = fa_kernel.launches
    out = fa_ops.flash_attention(q, k, v, scale=0.125)
    assert fa_kernel.launches == n0 + 1
    got = torch.autograd.grad(out, (q, k, v), g)
    assert fa_kernel.launches == n0 + 1
    flat = lambda t: t.transpose(1, 2).reshape(-1, s, hd)
    ref = fa_ref.flash_attention_ref(flat(q), flat(k), flat(v), scale=0.125)
    want = torch.autograd.grad(ref, (q, k, v), flat(g))
    for a, w in zip(got, want):
        assert float((a - w).abs().max()) <= TOL[torch.float32]
    out = checkpoint(lambda *t: fa_ops.flash_attention(*t, scale=0.125),
                     q, k, v, use_reentrant=False)
    out.sum().backward()
    assert fa_kernel.launches == n0 + 3


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
@pytest.mark.parametrize("n,shift", [(2 ** 20 + 13, False),
                                     (4 * 4 * 256 * 132 * 8 + 37, False),
                                     (333 * 257, True), (2 ** 20 + 13, True)])
def test_stream_kernel_ragged_and_misaligned_is_exact(card, dt, n, shift):
    """Lengths that are no multiple of the vector or of the 128 x 2-vector
    tile (the masked tail, the element-wise end), and inputs one element
    into their storage (off the 16-byte alignment: the element-wise
    path)."""
    a = _randn(card, dt, n)
    b = _randn(card, dt, n, seed=1)
    if shift:
        misaligned = _chip_smoke().misaligned
        a, b = misaligned(a), misaligned(b)
        assert a.data_ptr() % 16 and b.data_ptr() % 16
    before = st_kernel.launches
    got = st_ops.stream_triad(a, b, scalar=2.5)
    assert st_kernel.launches == before + 1
    assert torch.equal(got, st_ref.stream_triad_ref(a, b, 2.5))


def test_stream_kernel_cuda_graph_replay_equals_eager(card):
    """The triad captured in a CUDA graph and replayed on new inputs gives
    the eager call's bits (one block per tile: the grid depends on the
    length alone)."""
    a = _randn(card, torch.float32, 1001, 777)
    b = _randn(card, torch.float32, 1001, 777, seed=1)
    call = lambda: st_kernel.stream_triad_cuda(a, b, 2.5)  # noqa: E731
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    a.copy_(_randn(card, torch.float32, 1001, 777, seed=2))
    b.copy_(_randn(card, torch.float32, 1001, 777, seed=3))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, call())
    assert torch.equal(out, st_ref.stream_triad_ref(a, b, 2.5))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mkn", [(256, 512, 384), (257, 131, 129),
                                 (1, 7, 300), (333, 1, 257),
                                 (1000, 1000, 1028)])
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


def _jacobi_heights():
    r = jac_kernel.ROWS
    return sorted({1, 2, 3, 5, r - 1, r, r + 1, 2 * r + 1})


@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("w", [1, 2, 3, 5, 15, 16, 17, 33, 127, 128, 129,
                               513])
def test_jacobi2d_kernel_edges_are_exact(card, w, shift):
    """Heights at the edges of the kernel's strips of ROWS rows (1, 2, 3,
    5, ROWS - 1, ROWS, ROWS + 1, 2 ROWS + 1), widths at the edges of its
    float4 lanes and 128-column warps (W % 4 != 0 takes the element
    path), x at its alignment or one element into its storage (off the
    16-byte alignment: the element path): exact, x unchanged."""
    for h in _jacobi_heights():
        x = _randn(card, torch.float32, h, w, seed=h)
        if shift:
            x = _chip_smoke().misaligned(x)
            assert x.data_ptr() % 16
        keep = x.clone()
        before = jac_kernel.launches
        got = jac_ops.jacobi2d(x)
        assert jac_kernel.launches == before + 1
        assert torch.equal(got, jac_ref.jacobi2d_ref(x)), (h, w, shift)
        assert torch.equal(x, keep)


@pytest.mark.parametrize("psv", [(256, 4, 512), (1000, 3, 1999), (97, 5, 33),
                                 (1, 1, 1)])
def test_gridder_kernels_match_plain_and_are_adjoint(card, psv):
    """The pair's SFU phasor against torch's sin and cos, sums in other
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


def _gridder_pair_at_reach(card, psv, reach):
    p, s, v = psv
    lm, uv = _chip_smoke().gridder_extremes(card, p, s, v, reach)
    turns = (lm[None, :, None, :] * uv[:, None, :, :]).sum(-1)
    assert float(turns.abs().max()) == reach
    vis = _randn(card, torch.float32, s, v, 2, seed=2)
    sub = _randn(card, torch.float32, s, p, 2, seed=3)
    g = grid_ops.gridder(lm, uv, vis)
    gt = grid_ops.degridder(lm, uv, sub)
    torch.testing.assert_close(g, grid_ref.gridder_ref(lm, uv, vis),
                               rtol=1e-4, atol=2e-3)
    torch.testing.assert_close(gt, grid_ref.degridder_ref(lm, uv, sub),
                               rtol=1e-4, atol=2e-3)
    lhs = float((g.double() * sub.double()).sum())
    rhs = float((vis.double() * gt.double()).sum())
    assert abs(lhs - rhs) / max(abs(lhs), 1e-3) < 1e-3


@pytest.mark.parametrize("psv", [(1000, 3, 1999), (97, 5, 33), (1, 1, 1)])
def test_gridder_kernels_misaligned_inputs(card, psv):
    """Every input one float into its storage (off the 8-byte alignment
    of a float2 load; contiguous, so the wrappers take it): no fault, and
    the pair within the JAX tests' rtol 1e-4, atol 2e-3 of its plain
    version."""
    p, s, v = psv
    misaligned = _chip_smoke().misaligned
    lm = misaligned(_randn(card, torch.float32, p, 2).clamp(-0.5, 0.5))
    uv = misaligned(2.0 * _randn(card, torch.float32, s, v, 2,
                                 seed=1).clamp(-1, 1))
    vis = misaligned(_randn(card, torch.float32, s, v, 2, seed=2))
    sub = misaligned(_randn(card, torch.float32, s, p, 2, seed=3))
    assert all(t.data_ptr() % 8 for t in (lm, uv, vis, sub))
    g = grid_ops.gridder(lm, uv, vis)
    gt = grid_ops.degridder(lm, uv, sub)
    torch.cuda.synchronize()
    torch.testing.assert_close(g, grid_ref.gridder_ref(lm, uv, vis),
                               rtol=1e-4, atol=2e-3)
    torch.testing.assert_close(gt, grid_ref.degridder_ref(lm, uv, sub),
                               rtol=1e-4, atol=2e-3)


@pytest.mark.parametrize("psv", [(1100, 3, 2048), (37, 2, 2048)])
def test_gridder_kernels_at_phase_extremes(card, psv):
    """Phases at 4 pi, the Fig. 2 range: lm at the corners +-0.5 (and on
    the edges, just inside the corners), uv at +-2 and just inside +-2
    (non-integer turns near +-4 pi), V 2048.  The pair's phasor is an
    unreduced __sincosf (the gridder's on lm scaled by 2 pi, the
    degridder's on uv scaled by 2 pi); both stay within the JAX tests'
    rtol 1e-4, atol 2e-3 of their plain versions, and adjoint within
    1e-3."""
    _gridder_pair_at_reach(card, psv, 2.0)


@pytest.mark.parametrize("psv", [(1100, 3, 2048), (37, 2, 2048)])
def test_gridder_kernels_at_wide_phases(card, psv):
    """As above with uv at +-16 (phases up to 32 pi, 16 turns), outside
    the interval on which CUDA states __sincosf's error: the widest range
    the pair is held to, at the same tolerance."""
    _gridder_pair_at_reach(card, psv, 16.0)
