"""The serve baselines' kernels at the shapes the whole-prompt prefill
gives them, and the reduced baselines' engines, on the card.

Marked ``cuda``: these skip where there is no card.  On the machine with
the card run them with
``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_serve_modes_cuda.py``.

  * Row 9, the flash-attention forward, at the serve prefill's shapes
    (batch 1 at S 8, 64, 512, 1024 and batch 8 at S 1024; smollm-135m's
    9 heads on 3 kv heads of 64, bf16, causal; S 8 is one partial query
    tile a head) against its plain version within phase 3f's bf16
    tolerance (one bf16 rounding of the output plus the oracle's bf16
    probabilities, 2^-5 + 2e-5), and element by element against the fp32
    oracle on the same bf16 values within 2^-8 |o| + 4e-5; fp32 at S 8
    and 77 within 2e-5.
  * Row 5, the quantizing scatter, writing a whole prompt's T = 1024
    rows at offset 0 (batch 1 and 8, k and v in one launch, int8 and
    fp8_e4m3) bit for bit against its plain version, and
    ``prefill_kv_cache`` on the card against the CPU.
  * Reduced smollm-135m in fp32: the blocking, wave and dense-decode
    engines' greedy tokens on the card equal the CPU's, and a sampled
    run repeats its tokens under its seed.
"""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import quant  # noqa: E402
from repro_torch.kernels.cache_update import kernel as cu_kernel  # noqa: E402
from repro_torch.kernels.cache_update import ref as cu_ref  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.models import attention as PA  # noqa: E402
from repro_torch.models import model as PM  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

pytestmark = pytest.mark.cuda
BF16_TOL = 2.0 ** -5 + 2e-5
BF16_REL, BF16_ATOL = 2.0 ** -8, 4e-5
F32_TOL = 2e-5
MODES = ("int8", "fp8_e4m3")
MIXED = [([1, 2, 3], 8), ([4, 5], 3), ([6], 1),
         ([7, 8, 9, 10, 11, 12, 13, 14, 15], 5), ([2], 12)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _qkv(card, dt, b, s, h=9, kvh=3, hd=64, seed=7):
    g = torch.Generator(device=card).manual_seed(seed)
    mk = lambda n: torch.randn((n, s, hd), generator=g, device=card).to(dt)
    return mk(b * h), mk(b * kvh), mk(b * kvh)


@pytest.mark.parametrize("b,s", [(1, 8), (1, 64), (1, 512), (1, 1024),
                                 (8, 1024)])
def test_flash_kernel_at_serve_prefill_shapes(card, b, s):
    q, k, v = _qkv(card, torch.bfloat16, b, s)
    kw = dict(causal=True, window=None, softcap=None, scale=0.125)
    before = fa_kernel.launches
    got = fa_kernel.flash_attention_cuda(q, k, v, **kw)
    assert fa_kernel.launches == before + 1
    want = fa_ref.flash_attention_ref(q, k, v, **kw)
    exact = fa_ref.flash_attention_ref(q.float(), k.float(), v.float(), **kw)
    assert got.shape == q.shape and bool(torch.isfinite(got).all())
    assert float((got.float() - want.float()).abs().max()) <= BF16_TOL
    assert float(((got.float() - exact).abs()
                  / (BF16_REL * exact.abs() + BF16_ATOL)).max()) <= 1.0


@pytest.mark.parametrize("s", [8, 77])
def test_flash_kernel_fp32_short_prompts(card, s):
    q, k, v = _qkv(card, torch.float32, 1, s)
    kw = dict(causal=True, window=None, softcap=None, scale=0.125)
    got = fa_kernel.flash_attention_cuda(q, k, v, **kw)
    want = fa_ref.flash_attention_ref(q, k, v, **kw)
    assert float((got - want).abs().max()) <= F32_TOL


def _bytes(t):
    return t.view(torch.uint8) if t.element_size() == 1 else t


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("b", [1, 8])
def test_quant_scatter_writes_a_whole_prompt(card, mode, b):
    """T = 1024 bf16 rows a batch row at offset 0 into 2048 slots."""
    t, c, h, d = 1024, 2048, 3, 64
    g = torch.Generator(device=card).manual_seed(b)
    leaves = []
    for _ in range(2):
        codes, scales = quant.quantize(torch.randn(
            (b, c, h, d), generator=g, device=card), mode)
        new = (3 * torch.randn((b, t, h, d), generator=g,
                               device=card)).to(torch.bfloat16)
        leaves.append((codes, scales, new))
    slots = torch.zeros((b,), dtype=torch.int32, device=card)
    args = lambda: [x for codes, scales, new in leaves
                    for x in (codes.clone(), scales.clone(), new)]
    before = cu_kernel.quant_launches
    got = cu_kernel.quant_cache_update_pair_cuda(*args(), slots, mode)
    assert cu_kernel.quant_launches == before + 1
    want = cu_ref.quant_cache_update_pair_ref(*args(), slots, mode)
    for (gc, gs), (wc, ws) in zip(got, want):
        assert torch.equal(_bytes(gc), _bytes(wc))
        assert torch.equal(gs, ws)


@pytest.mark.parametrize("mode", [None, *MODES])
def test_prefill_kv_cache_card_equals_cpu(card, mode):
    cfg = dataclasses.replace(configs.get_config("smollm-135m"),
                              kv_quant=mode)
    g = torch.Generator().manual_seed(3)
    k, v = ((3 * torch.randn((2, 300, 3, 64), generator=g))
            .to(torch.bfloat16) for _ in range(2))
    cpu = PA.prefill_kv_cache(cfg, k, v, 512)
    dev = PA.prefill_kv_cache(cfg, k.to(card), v.to(card), 512)
    assert sorted(cpu) == sorted(dev)
    for name in cpu:
        assert torch.equal(_bytes(dev[name].cpu()), _bytes(cpu[name]))


def _reduced():
    cfg = dataclasses.replace(configs.get_config("smollm-135m", reduced=True),
                              dtype="float32")
    return cfg, PM.init_params(cfg, seed=0, device="cpu")


@pytest.mark.parametrize("kw", [
    dict(prefill_chunk=0), dict(mode="wave"),
    dict(prefill_chunk=4, decode_attn_impl="dense"),
    dict(prefill_chunk=0, cache_dtype="int8")],
    ids=["blocking", "wave", "dense", "blocking-int8"])
def test_reduced_engine_card_equals_cpu(card, kw):
    cfg, params = _reduced()
    kw = dict(kw)
    kw.setdefault("cache_dtype", torch.float32)
    runs = {}
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(cfg, params, batch_size=2, max_len=64, device=dev,
                          **kw)
        runs[dev] = [r.out for r in eng.generate(
            [Request(prompt=p, max_new_tokens=n) for p, n in MIXED])]
    assert runs["cuda"] == runs["cpu"]


def test_reduced_sampling_repeats_under_its_seed(card):
    cfg, params = _reduced()

    def run(seed):
        eng = ServeEngine(cfg, params, batch_size=2, max_len=64,
                          prefill_chunk=4, cache_dtype=torch.float32,
                          greedy=False, temperature=1.5, seed=seed,
                          device="cuda")
        return [r.out for r in eng.generate(
            [Request(prompt=p, max_new_tokens=n) for p, n in MIXED])]

    assert run(0) == run(0)
    assert run(0) != run(1)


def test_flash_launches_once_a_layer_a_prefill(card):
    """The whole-prompt prefill under attn_impl "pallas" launches row 9
    once a layer, and its last logits agree with the dense attend's
    within bf16 noise (2^-4 of max |logit|)."""
    cfg = dataclasses.replace(configs.get_config("smollm-135m", reduced=True),
                              attn_impl="pallas")
    params = PM.serving_params(cfg, PM.init_params(cfg, 0, device="cuda"),
                               "cuda")
    toks = torch.randint(0, cfg.vocab_size, (2, 64), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(0))
    before = fa_kernel.launches
    lp, _ = PM.make_serve_fns(cfg).prefill(params, {"tokens": toks}, 128)
    assert fa_kernel.launches - before == cfg.num_layers
    ld, _ = PM.make_serve_fns(dataclasses.replace(cfg, attn_impl="dense")) \
        .prefill(params, {"tokens": toks}, 128)
    top = max(float(ld.abs().max()), 1.0)
    assert float((lp - ld).abs().max()) <= top * 2.0 ** -4
    assert math.isfinite(float(lp.abs().max()))
