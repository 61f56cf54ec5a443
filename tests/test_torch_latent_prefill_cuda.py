"""The latent-attention kernel's prefill chunk (rows 2v and 8v:
``csrc/latent_attention.cu`` ``latent_kernel``, wgmma over 64 packed
rows fed by TMA) on the card against its plain versions
(``prefill_attention/ref.py``), through the prefill wrappers, over bf16,
int8 and fp8_e4m3 caches, contiguous and paged: one query token, 9 and
80 (longer than a 32-key tile); offsets 0, 1, 15, 16, 17 and off the
tile; G 3, 4 and 128; pages of 8 and 16 with the table's unused entries
on page 0; the producer's element-copy path (rows of 72 bytes, a base
off its 16-byte alignment, pages of 4); two launches in a row (the
splits folded across a cluster each time).  Also the launcher's plan
held to the library's: shared memory, splits and the TMA rule.

Marked ``cuda``: these skip where there is no card.  On the machine with
the card run them with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_latent_prefill_cuda.py``.
Tolerance: bf16's, 2^-6 + 2e-5 (``chip_smoke.py`` ``TOL``: both compute
in fp32 from the same values, the kernel's sums in another order, its p
through bf16 hi + lo).
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import latent_attention, quant  # noqa: E402
from repro_torch.kernels.prefill_attention import kernel as pa_kernel  # noqa: E402
from repro_torch.kernels.prefill_attention import ref as pa_ref  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = 2.0 ** -6 + 2e-5
CACHES = [torch.bfloat16, "int8", "fp8_e4m3"]
# name -> (G, hd, hdv, T, offsets (one a row), page size)
CASES = {
    "G128 T1": (128, 576, 512, 1, [0, 1, 15, 16, 17, 700], 16),
    "G128 T9": (128, 576, 512, 9, [0, 17, 45, 1000], 16),
    "G128 T80": (128, 576, 512, 80, [0, 33, 100], 8),
    "G3 T9": (3, 72, 64, 9, [0, 1, 15, 16, 17, 45], 8),
    "G4 T80": (4, 24, 16, 80, [0, 16, 45], 16),
    # rows of 72 bytes (36 bf16): the producer's element copies
    "G3 hd36 copies": (3, 36, 32, 9, [5, 17, 40], 16),
    # pages of 4 (boxes under 8 rows): element copies for the pools
    "G4 ps4": (4, 72, 64, 9, [0, 13, 30], 4),
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


def _inputs(card, case, cache, paged, misaligned=False):
    """(wrapper, plain version, positional args, keyword args) of a case;
    with ``misaligned`` q sits 2 bytes past a 16-byte boundary."""
    g, hd, hdv, t, offs, ps = CASES[case]
    b = len(offs)
    c = (max(offs) + ps - 1) // ps * ps + ps
    q = _randn(card, b, 1, t, g, hd, seed=1).to(torch.bfloat16)
    if misaligned:
        flat = torch.empty(q.numel() + 1, dtype=q.dtype, device=card)
        q = flat[1:].view(q.shape).copy_(q)
    kx = _randn(card, b, t, 1, hd, seed=3).to(torch.bfloat16)
    off = torch.tensor(offs, dtype=torch.int32, device=card)
    kw = dict(scale=1.0 / math.sqrt(192), v_width=hdv)
    if paged:
        nb = c // ps
        pool, kw["k_scale"] = _cache(_randn(card, 1 + b * nb, ps, 1, hd,
                                            seed=2), cache)
        table = (1 + torch.randperm(b * nb, device=card)).view(b, nb) \
            .to(torch.int32)
        for r, o in enumerate(offs):  # pages past a row's prefix: page 0
            table[r, (o + ps - 1) // ps:] = 0
        return (pa_kernel.prefill_attention_paged_cuda,
                pa_ref.prefill_attention_paged_ref,
                (q, kx, kx, pool, pool, table, off), kw)
    kv, kw["k_scale"] = _cache(_randn(card, b, c, 1, hd, seed=2), cache)
    return (pa_kernel.prefill_attention_cuda, pa_ref.prefill_attention_ref,
            (q, kx, kx, kv, kv, off), kw)


def _check(run, ref, args, kw, counter, launches=1):
    before = getattr(pa_kernel, counter)
    outs = [run(*args, **kw) for _ in range(launches)]
    want = ref(*args, **kw)
    torch.cuda.synchronize()
    assert getattr(pa_kernel, counter) == before + launches
    for got in outs:
        assert got.shape == want.shape
        err = (got.float() - want.float()).abs().max().item()
        assert err <= TOL, err


def _counter(paged, cache) -> str:
    return "v_" + ("" if cache == torch.bfloat16 else "quant_") \
        + ("paged_" if paged else "") + "launches"


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("cache", CACHES, ids=str)
@pytest.mark.parametrize("paged", [False, True])
def test_prefill_kernel_matches_plain(card, case, cache, paged):
    run, ref, args, kw = _inputs(card, case, cache, paged)
    _check(run, ref, args, kw, _counter(paged, cache))


@pytest.mark.parametrize("cache", CACHES, ids=str)
@pytest.mark.parametrize("paged", [False, True])
def test_prefill_kernel_misaligned_q_copies(card, cache, paged):
    run, ref, args, kw = _inputs(card, "G3 T9", cache, paged,
                                 misaligned=True)
    q, kx, kc = args[0], args[1], args[3]
    assert not latent_attention.loads_by_tma(
        q, kx, kc, kc.shape[1] if paged else None)
    _check(run, ref, args, kw, _counter(paged, cache))


@pytest.mark.parametrize("cache", CACHES, ids=str)
@pytest.mark.parametrize("paged", [False, True])
def test_prefill_kernel_twice_in_a_row(card, cache, paged):
    # G128 T1 over six rows: 12 row blocks over 6 splits, each group's
    # splits one cluster that folds them, launched twice
    run, ref, args, kw = _inputs(card, "G128 T1", cache, paged)
    assert latent_attention.prefill_split_count(
        latent_attention.prefill_groups(6, 1, 1, 128), 720) == 6
    _check(run, ref, args, kw, _counter(paged, cache), launches=2)


def test_prefill_plan_matches_the_library(card):
    from repro_torch.kernels import build
    lib = build.library()
    for hd, hdv in ((24, 16), (36, 32), (72, 64), (128, 128), (576, 512)):
        for code in (1, 2, 3):
            assert lib.pmt_latent_smem_bytes(hd, hdv, code) == \
                latent_attention.smem_bytes(hd, code >= 2)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for b, t, g, c in ((1, 32, 128, 1024), (8, 32, 128, 1024),
                       (6, 1, 128, 720), (2, 9, 3, 100), (3, 80, 4, 64)):
        groups = latent_attention.prefill_groups(b, 1, t, g)
        assert lib.pmt_latent_splits(b, 1, t, g, c, sms, 0) == \
            latent_attention.prefill_split_count(groups, c, sms)
    for hd in (24, 36, 72, 576):
        for cache in (torch.bfloat16, torch.int8):
            for shift in (0, 1):
                flat = torch.empty(64 * hd + 1, dtype=torch.bfloat16,
                                   device=card)
                q = flat[shift:shift + 64 * hd].view(1, 1, 1, 64, hd)
                kx = torch.empty(1, 1, 1, hd, dtype=torch.bfloat16,
                                 device=card)
                kc = torch.empty(1, 16, 1, hd, dtype=cache, device=card)
                for ps in (None, 4, 8, 16, 24):
                    want = latent_attention.loads_by_tma(q, kx, kc, ps)
                    got = lib.pmt_latent_tma(
                        q.data_ptr(), kx.data_ptr(), kc.data_ptr(), hd,
                        ps or 16, int(ps is not None),
                        build.dtype_code(cache, codes=cache != torch.bfloat16))
                    assert bool(got) == want, (hd, cache, shift, ps)
