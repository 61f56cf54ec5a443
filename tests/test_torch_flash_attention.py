"""The port's flash attention (its plain path, on the CPU) against the
JAX package's: the Pallas kernel in interpret mode and the jnp oracle,
on the same numpy inputs.

Mirrors the flash cases of tests/test_kernels.py (GQA (4, 4), (8, 2),
(9, 3) at S 256 and 512; window and softcap; bf16; the gradient against
the oracle's) and adds ragged S and Sq != Skv, which the Pallas kernel
does not take (its grid is Sq // block_q), so those hold against the
oracle only.  fp32 tolerance 1e-5 absolute (the JAX tests' own is 2e-4
and 3e-4): both sides compute in fp32, differing in summation order.
bf16 against the JAX oracle within one bf16 step of outputs below 4
(2^-6): both round p to bf16 before p @ v; against the Pallas kernel,
which keeps p in fp32, within the JAX tests' 0.05.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.kernels.flash_attention import flash_attention_ref as jax_ref  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.models import attention as port_attn  # noqa: E402

ATOL = 1e-5
BF16_ORACLE_TOL = 2.0 ** -6 + 2e-5
BF16_PALLAS_TOL = 0.05


def _inputs(seed, b, sq, skv, h, kvh, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, hd)).astype(np.float32),
            rng.standard_normal((b, skv, kvh, hd)).astype(np.float32),
            rng.standard_normal((b, skv, kvh, hd)).astype(np.float32))


def _jax_oracle_4d(q, k, v, **kw):
    """The JAX oracle on the (B, S, H, hd) layout, as ops flattens."""
    b, sq, h, hd = q.shape
    _, skv, kvh, _ = k.shape
    qf = jnp.asarray(q).transpose(0, 2, 1, 3).reshape(b * h, sq, hd)
    kf = jnp.asarray(k).transpose(0, 2, 1, 3).reshape(b * kvh, skv, hd)
    vf = jnp.asarray(v).transpose(0, 2, 1, 3).reshape(b * kvh, skv, hd)
    out = jax_ref(qf, kf, vf, **kw)
    return out.reshape(b, h, sq, hd).transpose(0, 2, 1, 3)


def _port(q, k, v, dtype=torch.float32, **kw):
    t = [torch.from_numpy(x).to(dtype) for x in (q, k, v)]
    return fa_ops.flash_attention(*t, **kw)


def _np(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("h,kvh", [(4, 4), (8, 2), (9, 3)])
@pytest.mark.parametrize("s", [256, 512])
def test_flash_gqa_causal_matches_jax(h, kvh, s):
    q, k, v = _inputs(19, 2, s, s, h, kvh, 64)
    kw = dict(causal=True, scale=1.0 / math.sqrt(64))
    got = _port(q, k, v, **kw).numpy()
    pallas = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       block_q=128, block_k=128, interpret=True, **kw)
    np.testing.assert_allclose(got, _np(pallas), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, _np(_jax_oracle_4d(q, k, v, **kw)),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("window,softcap", [(128, None), (None, 30.0),
                                            (64, 50.0)])
def test_flash_window_softcap_matches_jax(window, softcap):
    q, k, v = _inputs(22, 1, 512, 512, 4, 2, 64)
    kw = dict(causal=True, window=window, softcap=softcap,
              scale=1.0 / math.sqrt(64))
    got = _port(q, k, v, **kw).numpy()
    pallas = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       block_q=128, block_k=128, interpret=True, **kw)
    np.testing.assert_allclose(got, _np(pallas), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, _np(_jax_oracle_4d(q, k, v, **kw)),
                               atol=ATOL, rtol=0)


def test_flash_bf16_matches_jax():
    q, k, v = _inputs(25, 1, 256, 256, 4, 4, 64)
    qb, kb, vb = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    kw = dict(causal=True, scale=1.0 / math.sqrt(64))
    got = fa_ops.flash_attention(
        *(torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
          for x in (qb, kb, vb)), **kw)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    np.testing.assert_allclose(got, _np(_jax_oracle_4d(qb, kb, vb, **kw)),
                               atol=BF16_ORACLE_TOL, rtol=0)
    pallas = jax_flash(qb, kb, vb, interpret=True, **kw)
    np.testing.assert_allclose(got, _np(pallas), atol=BF16_PALLAS_TOL,
                               rtol=0)


@pytest.mark.parametrize("sq,skv,window", [(77, 77, None), (1000, 1000, 50),
                                           (100, 300, None),
                                           (300, 100, None)])
def test_flash_ragged_and_unequal_lengths_match_the_oracle(sq, skv, window):
    q, k, v = _inputs(31, 2, sq, skv, 6, 2, 32)
    kw = dict(causal=True, window=window, softcap=20.0, scale=0.2)
    got = _port(q, k, v, **kw).numpy()
    np.testing.assert_allclose(got, _np(_jax_oracle_4d(q, k, v, **kw)),
                               atol=ATOL, rtol=0)


def test_flash_grad_matches_jax_oracle():
    q, k, v = _inputs(28, 1, 256, 256, 4, 2, 32)
    g = np.random.default_rng(29).standard_normal(q.shape).astype(np.float32)
    kw = dict(causal=True, window=100, softcap=30.0,
              scale=1.0 / math.sqrt(32))
    _, vjp = jax.vjp(lambda a, b, c: _jax_oracle_4d(a, b, c, **kw),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(fa_ops.flash_attention(*ts, **kw), ts,
                              torch.from_numpy(g))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), _np(b), atol=ATOL, rtol=0)


def test_flash_counts_no_launch_on_the_cpu():
    q, k, v = _inputs(3, 1, 64, 64, 2, 1, 16)
    before = fa_kernel.launches
    _port(q, k, v, causal=True)
    assert fa_kernel.launches == before


def test_flash_plain_version_is_the_oracle_on_3d_inputs():
    q, k, v = _inputs(4, 1, 50, 60, 6, 3, 16)
    flat = lambda x: torch.from_numpy(x).permute(0, 2, 1, 3).reshape(
        -1, x.shape[1], x.shape[3]).contiguous()
    got = fa_ref.flash_attention_ref(flat(q), flat(k), flat(v), causal=True,
                                     scale=0.3).numpy()
    qf, kf, vf = (jnp.asarray(flat(x).numpy()) for x in (q, k, v))
    np.testing.assert_allclose(got, _np(jax_ref(qf, kf, vf, causal=True,
                                                scale=0.3)),
                               atol=ATOL, rtol=0)


def test_attention_pallas_refuses_what_the_kernel_cannot_honour():
    cfg = port_configs.get_config("smollm-135m", reduced=True)
    q, k, v = (torch.from_numpy(x) for x in _inputs(5, 1, 8, 8, 3, 1, 16))
    pos = torch.arange(8)[None]
    with pytest.raises(ValueError, match="cannot honor kv_valid"):
        port_attn.attention(cfg, q, k, v, q_pos=pos, kv_pos=pos,
                            kv_valid=torch.ones((1, 8), dtype=torch.bool),
                            impl="pallas")
    with pytest.raises(ValueError, match="causal self-attention only"):
        port_attn.attention(cfg, q, k, v, q_pos=pos, kv_pos=pos,
                            causal=False, impl="pallas")
    with pytest.raises(ValueError, match="unknown attention impl"):
        port_attn.attention(cfg, q, k, v, q_pos=pos, kv_pos=pos,
                            impl="flash", chunk=4)


def test_flash_cuda_wrapper_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(x) for x in _inputs(6, 1, 8, 8, 2, 1, 16))
    with pytest.raises(ValueError, match="on the card"):
        fa_kernel.flash_attention_cuda(q[0], k[0], v[0])


# -- the bf16 kernel's design (wgmma and TMA), its arithmetic on the CPU ------
# The CUDA kernel runs only on the card (tests/test_torch_cuda.py holds it
# there).  Here its arithmetic is emulated in plain torch, tile by tile:
# bf16 q . k summed in fp32 and scaled after, the online softmax in log2
# units, each p split into bf16 p_hi + p_lo, both multiplied with V
# into the fp32 accumulator.  It must meet the gate chip_smoke.py holds
# the kernel to, against the fp32 JAX oracle on the same bf16 values:
# |o - exact| <= 2^-8 |exact| + 2 TOL[fp32] at every element.
TOL_FP32 = 2e-5
GATE_REL, GATE_ATOL = 2.0 ** -8, 2 * TOL_FP32


def _tc_emulation(q, k, v, *, causal, window, softcap, scale, split=True):
    """q (BH, Sq, hd), k/v (BKVH, Skv, hd), all bf16 -> bf16, in the
    bf16 kernel's order of operations.  ``split=False`` rounds each p
    once to bf16 instead."""
    bh, sq, hd = q.shape
    g = bh // k.shape[0]
    kf = torch.repeat_interleave(k, g, dim=0).float()
    vf = torch.repeat_interleave(v, g, dim=0).float()
    log2e = 1.4426950408889634
    m = torch.full((bh, sq), -2.0 ** 30)
    l = torch.zeros((bh, sq))
    acc = torch.zeros((bh, sq, hd))
    rows = torch.arange(sq)[:, None]
    bk = fa_kernel.BLOCK_K
    for lo in range(0, k.shape[1], bk):
        s = torch.einsum("hqd,hkd->hqk", q.float(), kf[:, lo:lo + bk])
        if softcap is not None:
            x = torch.tanh(s * scale / softcap) * softcap * log2e
        else:
            x = s * (scale * log2e)
        cols = torch.arange(lo, lo + x.shape[-1])[None, :]
        ok = torch.ones_like(x[0], dtype=torch.bool)
        if causal:
            ok &= rows >= cols
        if window is not None:
            ok &= rows - cols < window
        x = torch.where(ok[None], x, -torch.inf)
        m_new = torch.maximum(m, x.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new[..., None])
        l = alpha * l + p.sum(-1)
        p_hi = p.to(torch.bfloat16).float()
        pv = p_hi @ vf[:, lo:lo + bk]
        if split:
            pv = pv + (p - p_hi).to(torch.bfloat16).float() @ vf[:, lo:lo + bk]
        acc = alpha[..., None] * acc + pv
        m = m_new
    return (acc / l.clamp_min(1e-30)[..., None]).to(torch.bfloat16)


def _gate_excess(got, exact):
    """max over elements of |got - exact| / (2^-8 |exact| + 2 TOL[fp32]):
    at most 1 passes."""
    return float(((got.float() - exact).abs()
                  / (GATE_REL * exact.abs() + GATE_ATOL)).max())


def _bf16_flat(seed, b, sq, skv, h, kvh, hd, amp=1.0):
    rng = np.random.default_rng(seed)
    mk = lambda n, s: torch.from_numpy(
        rng.standard_normal((n, s, hd)).astype(np.float32)).to(torch.bfloat16)
    q, k, v = mk(b * h, sq), mk(b * kvh, skv), mk(b * kvh, skv)
    return q * amp, k * amp, v


@pytest.mark.parametrize("case", [
    # (b, sq, skv, h, kvh, hd, window, softcap, amp)
    (1, 256, 256, 6, 2, 64, None, None, 1.0),      # GQA 3
    (1, 192, 192, 4, 4, 64, 48, 30.0, 1.0),        # window + softcap
    (2, 77, 77, 3, 1, 32, 20, None, 1.0),          # ragged, window
    (1, 100, 300, 4, 2, 16, None, None, 1.0),      # Sq < Skv
    (1, 200, 130, 2, 1, 128, None, None, 1.0),     # Sq > Skv, hd 128
    (1, 160, 160, 3, 1, 64, None, None, 3.5),      # |s| to ~50
], ids=["gqa", "window-softcap", "ragged-hd32", "sq<skv-hd16",
        "sq>skv-hd128", "large-scores"])
def test_tc_design_meets_the_elementwise_gate(case):
    b, sq, skv, h, kvh, hd, window, softcap, amp = case
    q, k, v = _bf16_flat(40, b, sq, skv, h, kvh, hd, amp)
    kw = dict(causal=True, window=window, softcap=softcap,
              scale=1.0 / math.sqrt(hd))
    got = _tc_emulation(q, k, v, **kw)
    exact = np.array(jax_ref(*(jnp.asarray(t.float().numpy()) for t in (q, k, v)),
                        **kw))
    assert _gate_excess(got, torch.from_numpy(exact)) <= 1.0


def test_tc_design_needs_p_split_in_two():
    """p rounded once to bf16 (up to 2^-9 of each term) breaks the gate
    by far where |o| is small, as rows averaging hundreds of keys are;
    the p_hi + p_lo split (~2^-17) keeps it."""
    q, k, v = _bf16_flat(41, 1, 512, 512, 2, 1, 64)
    kw = dict(causal=True, window=None, softcap=None, scale=0.125)
    exact = torch.from_numpy(np.array(jax_ref(
        *(jnp.asarray(t.float().numpy()) for t in (q, k, v)), **kw)))
    assert _gate_excess(_tc_emulation(q, k, v, **kw), exact) <= 1.0
    assert _gate_excess(_tc_emulation(q, k, v, split=False, **kw),
                        exact) > 1.0


def test_flash_bf16_tiling_fits_shared_memory():
    for hd in fa_kernel.HEAD_DIMS:
        need = fa_kernel.smem_bytes(hd, fa_kernel.BLOCK_K, fa_kernel.STAGES)
        assert need <= fa_kernel.SMEM_LIMIT, hd


def test_flash_cuda_wrapper_refuses_head_widths_it_has_no_kernel_for():
    for hd in (8, 48, 96, 256):
        q = torch.zeros((2, 4, hd), dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="not supported"):
            fa_kernel.flash_attention_cuda(q, q[:1], q[:1])
