"""MLA's kernels on the card against their plain versions: the
``v_width`` branch of the four attention kernels (rows 2v, 3v, 7v, 8v:
the tensor-core ``csrc/latent_attention.cu`` for bf16 q, the CUDA-core
kernels for fp32 q), their quantized branches, and the one-leaf scatters
(rows 1, 4, 5, 6) at MLA's 576-wide latent rows, bit for bit.

Marked ``cuda``: these skip where there is no card.  On the machine with
the card run them with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_mla_cuda.py``.
Tolerances: the plain version's, fp32 2e-5 and bf16 2^-6 + 2e-5
(``chip_smoke.py`` ``TOL``: both compute in fp32 from the same values,
the kernel's sums in another order, its p through bf16 hi + lo).
"""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import latent_attention, quant  # noqa: E402
from repro_torch.kernels.cache_update import kernel as cu_kernel  # noqa: E402
from repro_torch.kernels.cache_update import ops as cu_ops  # noqa: E402
from repro_torch.kernels.cache_update import ref as cu_ref  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as da_kernel  # noqa: E402
from repro_torch.kernels.decode_attention import ref as da_ref  # noqa: E402
from repro_torch.kernels.prefill_attention import kernel as pa_kernel  # noqa: E402
from repro_torch.kernels.prefill_attention import ref as pa_ref  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -6 + 2e-5}
# (G, hd, hdv): deepseek-v3 at full width, reduced, and an odd width
SHAPES = {"full": (128, 576, 512), "reduced": (4, 24, 16),
          "odd": (3, 72, 64)}
# (q dtype, cache: a dtype or a quantized mode)
ROUTES = [(torch.bfloat16, torch.bfloat16), (torch.bfloat16, "int8"),
          (torch.bfloat16, "fp8_e4m3"), (torch.float32, torch.float32),
          (torch.float32, "int8")]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(card, *shape, seed=0):
    g = torch.Generator(device=card).manual_seed(seed)
    return torch.randn(shape, generator=g, device=card)


def _cache(x: torch.Tensor, qdt, cache):
    """(cache, k_scale): x as the cache dtype, or as codes of a mode with
    their row scales."""
    if isinstance(cache, str):
        return quant.quantize(x, cache)
    return x.to(cache), None


def _fits(qdt, hd) -> bool:
    """fp32 q takes the CUDA-core kernels, whose heads stop at 512."""
    return qdt == torch.bfloat16 or hd <= 512


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("route", ROUTES, ids=str)
@pytest.mark.parametrize("paged", [False, True])
def test_decode_v_width(card, shape, route, paged):
    g, hd, hdv = SHAPES[shape]
    qdt, cache = route
    if not _fits(qdt, hd):
        pytest.skip("fp32 heads past 512 take no kernel")
    b, c = 8, 1024 if shape == "full" else 96
    lens = torch.tensor([0, 1, c // 2, c - 1, 37, c - 9, 3, -1][:b],
                        dtype=torch.int32, device=card)
    q = _randn(card, b, 1, g, hd, seed=1).to(qdt)
    scale = 1.0 / math.sqrt(192)
    if paged:
        ps, nb = 16, c // 16
        pool, ks = _cache(_randn(card, 1 + b * nb, ps, 1, hd, seed=2), qdt,
                          cache)
        table = (1 + torch.randperm(b * nb, device=card)).view(b, nb) \
            .to(torch.int32)
        args = (q, pool, pool, table, lens)
        run, ref = da_kernel.decode_attention_paged_cuda, \
            da_ref.decode_attention_paged_ref
        counter = "v_quant_paged_launches" if ks is not None \
            else "v_paged_launches"
    else:
        kv, ks = _cache(_randn(card, b, c, 1, hd, seed=2), qdt, cache)
        args = (q, kv, kv, lens)
        run, ref = da_kernel.decode_attention_cuda, \
            da_ref.decode_attention_ref
        counter = "v_quant_launches" if ks is not None else "v_launches"
    kw = dict(scale=scale, v_width=hdv, k_scale=ks)
    before = getattr(da_kernel, counter)
    got = run(*args, **kw)
    want = ref(*args, **kw)
    torch.cuda.synchronize()
    assert getattr(da_kernel, counter) == before + 1
    assert got.shape == (b, 1, g, hdv)
    # lens -1: no attendable key, exactly 0 (the plain version averages)
    assert torch.equal(got[-1], torch.zeros_like(got[-1]))
    err = (got[:-1].float() - want[:-1].float()).abs().max().item()
    assert err <= TOL[qdt], err


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("route", ROUTES, ids=str)
@pytest.mark.parametrize("paged", [False, True])
def test_prefill_v_width(card, shape, route, paged):
    g, hd, hdv = SHAPES[shape]
    qdt, cache = route
    if not _fits(qdt, hd):
        pytest.skip("fp32 heads past 512 take no kernel")
    b, t = (1, 32) if shape == "full" else (3, 9)
    c = 1024 if shape == "full" else 96
    offs = torch.tensor([512, 0, c][:b], dtype=torch.int32, device=card)
    q = _randn(card, b, 1, t, g, hd, seed=1).to(qdt)
    kx = _randn(card, b, t, 1, hd, seed=3).to(qdt)
    scale = 1.0 / math.sqrt(192)
    if paged:
        ps, nb = 16, c // 16
        pool, ks = _cache(_randn(card, 1 + b * nb, ps, 1, hd, seed=2), qdt,
                          cache)
        table = (1 + torch.randperm(b * nb, device=card)).view(b, nb) \
            .to(torch.int32)
        args = (q, kx, kx, pool, pool, table, offs)
        run, ref = pa_kernel.prefill_attention_paged_cuda, \
            pa_ref.prefill_attention_paged_ref
    else:
        kv, ks = _cache(_randn(card, b, c, 1, hd, seed=2), qdt, cache)
        args = (q, kx, kx, kv, kv, offs)
        run, ref = pa_kernel.prefill_attention_cuda, \
            pa_ref.prefill_attention_ref
    kw = dict(scale=scale, v_width=hdv, k_scale=ks)
    if pa_kernel.smem_bytes(hd, hdv) > da_kernel.SMEM_LIMIT \
            and not latent_attention.takes(q, args[-3], args[-2], hdv, ks,
                                           None):
        pytest.skip("fp32 at these widths exceeds a block's shared memory")
    got = run(*args, **kw)
    want = ref(*args, **kw)
    torch.cuda.synchronize()
    assert got.shape == (b, 1, t, g, hdv)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[qdt], err


def test_latent_smem_matches_the_library(card):
    from repro_torch.kernels import build
    lib = build.library()
    for hd, hdv in ((24, 16), (72, 64), (576, 512)):
        for code in (1, 2):
            assert lib.pmt_latent_smem_bytes(hd, hdv, code) == \
                latent_attention.smem_bytes(hd, code == 2)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32], ids=str)
def test_scatters_at_latent_width(card, dt):
    """Rows 1 and 4 at F 576, one leaf, bit for bit."""
    b, c, f, ps, p = 8, 64, 576, 16, 40
    cache = _randn(card, b, c, f, seed=4).to(dt)
    new = _randn(card, b, 1, f, seed=5).to(dt)
    slots = torch.tensor([0, 5, 63, 64, 7, 1, 30, 2], dtype=torch.int32,
                         device=card)
    got = cu_ops.cache_update(cache.clone(), new, slots)
    want = cu_ref.cache_update_ref(cache.clone(), new, slots)
    assert torch.equal(got, want)
    pool = _randn(card, p, ps, f, seed=6).to(dt)
    table = (1 + torch.randperm(p - 1, device=card)[:b * 4]).view(b, 4) \
        .to(torch.int32)
    starts = torch.tensor([0, 3, 17, 63, 8, 9, 40, 1], dtype=torch.int32,
                          device=card)
    valids = torch.tensor([1, 1, 0, 1, 1, 1, 1, 1], dtype=torch.int32,
                          device=card)
    got = cu_ops.paged_cache_update(pool.clone(), new, table, starts, valids)
    want = cu_ref.paged_cache_update_ref(pool.clone(), new, table, starts,
                                         valids)
    assert torch.equal(got[1:], want[1:])


@pytest.mark.parametrize("mode", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("t", [1, 32])
def test_quant_scatters_at_latent_width(card, mode, t):
    """Rows 5 and 6 at F 576, one leaf, codes and scales bit for bit."""
    b, c, f, ps, p = 4, 96, 576, 16, 40
    codes, scales = quant.quantize(_randn(card, b, c, f, seed=7), mode)
    new = _randn(card, b, t, f, seed=8).to(torch.bfloat16)
    slots = torch.tensor([0, 5, 90, 40], dtype=torch.int32, device=card)
    got = cu_ops.quant_cache_update(codes.clone(), scales.clone(), new,
                                    slots, mode)
    want = cu_ref.quant_cache_update_ref(codes.clone(), scales.clone(), new,
                                         slots, mode)
    assert torch.equal(got[0].view(torch.uint8), want[0].view(torch.uint8))
    assert torch.equal(got[1], want[1])
    pcodes, pscales = quant.quantize(_randn(card, p, ps, f, seed=9), mode)
    table = (1 + torch.randperm(p - 1, device=card)[:b * 6]).view(b, 6) \
        .to(torch.int32)
    starts = torch.tensor([0, 3, 17, 60], dtype=torch.int32, device=card)
    valids = torch.tensor([t, t - 1, 0, t], dtype=torch.int32, device=card)
    got = cu_ops.quant_paged_cache_update(pcodes.clone(), pscales.clone(),
                                          new, table, starts, valids, mode)
    want = cu_ref.quant_paged_cache_update_ref(
        pcodes.clone(), pscales.clone(), new, table, starts, valids, mode)
    assert torch.equal(got[0][1:].view(torch.uint8),
                       want[0][1:].view(torch.uint8))
    assert torch.equal(got[1][1:], want[1][1:])
    assert cu_kernel.quant_paged_launches > 0


PROMPTS = [([1, 2, 3], 8), ([4, 5], 3), ([6], 1),
           ([7, 8, 9, 10, 11, 12, 13, 14, 15], 5), ([2], 12),
           ([3, 1, 4, 1, 5], 2), ([9, 9], 7)]


@pytest.mark.parametrize("kw", [
    dict(), dict(kv_layout="paged", kv_page_size=16),
    dict(prefill_chunk=0), dict(cache_dtype="int8")], ids=str)
def test_reduced_engine_card_equals_cpu(card, kw):
    """Reduced deepseek (moe None, mtp off) fp32: the card's greedy tokens
    equal the CPU's (the CUDA-core kernels with v's row width)."""
    cfg = dataclasses.replace(
        configs.get_config("deepseek-v3-671b", reduced=True), moe=None,
        mtp=False, dtype="float32")
    params = model_mod.init_params(cfg, seed=0, device="cpu")
    kw = dict(dict(cache_dtype=torch.float32), **kw)
    outs = []
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(cfg, params, batch_size=3, max_len=64, device=dev,
                          **kw)
        outs.append([r.out for r in eng.generate(
            [Request(prompt=list(p), max_new_tokens=n) for p, n in PROMPTS])])
    assert outs[0] == outs[1]
