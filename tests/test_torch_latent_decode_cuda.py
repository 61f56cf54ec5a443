"""The latent-attention kernel's decode step (rows 3v and 7v:
``csrc/latent_attention.cu`` ``latent_kernel``, wgmma over 64 packed
heads fed by TMA, the splits folded across a cluster) on the card
against its plain versions (``decode_attention/ref.py``), through the
decode wrappers, over bf16, int8 and fp8_e4m3 caches, contiguous and
paged: lens -1 (no attendable key: exactly 0), 0, 1, 15, 16, 17, 31, 32,
33, C - 1 and past C; G 3, 4 and 128 at hd 36, 72 and 576; pages of 4, 8
and 16 with the table's entries past a row's keys on page 0; the
producer's element-copy path (rows of 72 bytes, q off its 16-byte
alignment, pages of 4); two launches in a row.  Also the decode plan
held to the library's.

Marked ``cuda``: these skip where there is no card.  On the machine with
the card run them with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_latent_decode_cuda.py``.
Tolerance: bf16's, 2^-6 + 2e-5 (``chip_smoke.py`` ``TOL``: both compute
in fp32 from the same values, the kernel's sums in another order, its p
through bf16 hi + lo).
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import latent_attention, quant  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as da_kernel  # noqa: E402
from repro_torch.kernels.decode_attention import ref as da_ref  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = 2.0 ** -6 + 2e-5
CACHES = [torch.bfloat16, "int8", "fp8_e4m3"]
# lens of a row: none, the tile and split edges, the last slot and past it
LENS = [-1, 0, 1, 15, 16, 17, 31, 32, 33, 1023, 1024, 2000]
# name -> (G, hd, hdv, capacity, page size)
CASES = {
    "G128 hd576": (128, 576, 512, 1024, 16),
    "G128 hd576 ps8": (128, 576, 512, 1024, 8),
    "G3 hd72": (3, 72, 64, 1024, 16),
    "G4 hd72 ps8": (4, 72, 64, 1024, 8),
    # rows of 72 bytes (36 bf16): the producer's element copies
    "G3 hd36 copies": (3, 36, 32, 1024, 16),
    # pages of 4 (boxes under 8 rows): element copies for the pools
    "G4 hd72 ps4": (4, 72, 64, 1024, 4),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _randn(card, *shape, seed=0):
    g = torch.Generator(device=card).manual_seed(seed)
    return torch.randn(shape, generator=g, device=card)


def _cache(x: torch.Tensor, cache):
    """(cache, k_scale): x as bf16, or as codes of a mode with their row
    scales."""
    if isinstance(cache, str):
        return quant.quantize(x, cache)
    return x.to(cache), None


def _inputs(card, case, cache, paged, lens=LENS, misaligned=False):
    """(wrapper, plain version, positional args, keyword args) of a case;
    with ``misaligned`` q sits 2 bytes past a 16-byte boundary."""
    g, hd, hdv, c, ps = CASES[case]
    b = len(lens)
    q = _randn(card, b, 1, g, hd, seed=1).to(torch.bfloat16)
    if misaligned:
        flat = torch.empty(q.numel() + 1, dtype=q.dtype, device=card)
        q = flat[1:].view(q.shape).copy_(q)
    pos = torch.tensor(lens, dtype=torch.int32, device=card)
    kw = dict(scale=1.0 / math.sqrt(192), v_width=hdv)
    if paged:
        nb = c // ps
        pool, kw["k_scale"] = _cache(_randn(card, 1 + b * nb, ps, 1, hd,
                                            seed=2), cache)
        table = (1 + torch.randperm(b * nb, device=card)).view(b, nb) \
            .to(torch.int32)
        for r, n in enumerate(lens):  # pages past a row's keys: page 0
            table[r, max(n + 1, 0) // ps + 1:] = 0
        return (da_kernel.decode_attention_paged_cuda,
                da_ref.decode_attention_paged_ref,
                (q, pool, pool, table, pos), kw)
    kv, kw["k_scale"] = _cache(_randn(card, b, c, 1, hd, seed=2), cache)
    return (da_kernel.decode_attention_cuda, da_ref.decode_attention_ref,
            (q, kv, kv, pos), kw)


def _counter(paged, cache) -> str:
    return "v_" + ("" if cache == torch.bfloat16 else "quant_") \
        + ("paged_" if paged else "") + "launches"


def _check(run, ref, args, kw, counter, lens, launches=1):
    before = getattr(da_kernel, counter)
    outs = [run(*args, **kw) for _ in range(launches)]
    want = ref(*args, **kw)
    torch.cuda.synchronize()
    assert getattr(da_kernel, counter) == before + launches
    # a row with no attendable key (lens -1) gives exactly 0; the plain
    # version's finite -inf weighs every masked key alike there
    keys = torch.tensor([n >= 0 for n in lens], device=want.device)
    for got in outs:
        assert got.shape == want.shape
        err = (got[keys].float() - want[keys].float()).abs().amax().item() \
            if keys.any() else 0.0
        assert err <= TOL, err
        assert not got[~keys].float().abs().sum().item()


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("cache", CACHES, ids=str)
@pytest.mark.parametrize("paged", [False, True])
def test_decode_kernel_matches_plain(card, case, cache, paged):
    run, ref, args, kw = _inputs(card, case, cache, paged)
    _check(run, ref, args, kw, _counter(paged, cache), LENS)


@pytest.mark.parametrize("cache", CACHES, ids=str)
@pytest.mark.parametrize("paged", [False, True])
def test_decode_kernel_misaligned_q_copies(card, cache, paged):
    run, ref, args, kw = _inputs(card, "G3 hd72", cache, paged,
                                 misaligned=True)
    q, kc = args[0], args[1]
    assert not latent_attention.loads_by_tma(
        q, None, kc, kc.shape[1] if paged else None)
    _check(run, ref, args, kw, _counter(paged, cache), LENS)


@pytest.mark.parametrize("cache", CACHES, ids=str)
@pytest.mark.parametrize("paged", [False, True])
def test_decode_kernel_twice_in_a_row(card, cache, paged):
    # B8 G128 over C 1024: 16 row blocks, each a cluster of 8 splits
    lens = [0, 1, 511, 1023, 37, 300, 700, -1]
    run, ref, args, kw = _inputs(card, "G128 hd576", cache, paged, lens)
    groups = latent_attention.decode_groups(8, 1, 128)
    assert (groups, latent_attention.decode_split_count(groups, 1024)) \
        == (16, 8)
    _check(run, ref, args, kw, _counter(paged, cache), lens, launches=2)


@pytest.mark.parametrize("lens", [[-1] * 8, [2000] * 8, [-1, 3]],
                         ids=["none", "full", "one row"])
def test_decode_kernel_all_or_nothing(card, lens):
    # every row without a key (every split dead), every row at capacity
    run, ref, args, kw = _inputs(card, "G128 hd576", "int8", False, lens)
    _check(run, ref, args, kw, _counter(False, "int8"), lens)


def test_decode_plan_matches_the_library(card):
    from repro_torch.kernels import build
    lib = build.library()
    la = latent_attention
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for b, g, c in ((8, 128, 1024), (1, 128, 1024), (3, 3, 100),
                    (3, 4, 96), (32, 128, 1024), (64, 128, 1024),
                    (8, 128, 64), (8, 4, 1)):
        groups = la.decode_groups(b, 1, g)
        assert lib.pmt_latent_splits(b, 1, 1, g, c, sms, 1) == \
            la.decode_split_count(groups, c, sms), (b, g, c)
    for hd, hdv in ((24, 16), (36, 32), (72, 64), (128, 128), (576, 512)):
        for code in (1, 2, 3):
            assert lib.pmt_latent_smem_bytes(hd, hdv, code) == \
                la.smem_bytes(hd, code >= 2)
    for hd in (24, 36, 72, 576):
        for cache in (torch.bfloat16, torch.int8):
            for shift in (0, 1):
                flat = torch.empty(64 * hd + 1, dtype=torch.bfloat16,
                                   device=card)
                q = flat[shift:shift + 64 * hd].view(1, 1, 64, hd)
                kc = torch.empty(1, 16, 1, hd, dtype=cache, device=card)
                for ps in (None, 4, 8, 16, 24):
                    got = lib.pmt_latent_tma(
                        q.data_ptr(), None, kc.data_ptr(), hd, ps or 16,
                        int(ps is not None),
                        build.dtype_code(cache, codes=cache != torch.bfloat16))
                    assert bool(got) == la.loads_by_tma(q, None, kc, ps), \
                        (hd, cache, shift, ps)
