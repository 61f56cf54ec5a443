"""Serving deepseek-v3's MLA layers: the port's engine against the JAX
engine on the CPU.

Reduced deepseek-v3 with ``moe=None, mtp=False`` (its three layers all
dense MLA layers), fp32 activations, the same weights through
``repro_torch.bridge``.  The port's greedy tokens equal the JAX
``ServeEngine``'s byte for byte: contiguous chunked prefill, paged (page
16, as the reference's MLA tests) with radix prefix reuse, blocking
whole-prompt admission, int8 and fp8_e4m3 caches (the dense decode
attend and int8 pools are held layer by layer in
``tests/test_torch_mla.py``).  The fp8 logits are held to the JAX fp8 logits
directly (within 1e-4: both dequantize the same codes; the reference's
own drift gate against fp32 fails for MLA fp8, ROADMAP.md Queue 3), and
the KV bytes per token to the JAX engine's.  Also: the whole-prompt
prefill and its caches, and the launcher.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve import engine as jax_engine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

ARCH = "deepseek-v3-671b"
MIXED = [([1, 2, 3], 8), ([4, 5], 3), ([6], 1),
         ([7, 8, 9, 10, 11, 12, 13, 14, 15], 5), ([2], 12),
         ([3, 1, 4, 1, 5], 2), ([9, 9], 7)]
# requests sharing a 20-token system prompt: more than a page of 16, so
# later admissions map the first page from the radix tree
SYSTEM = list(range(30, 50))
SHARED = [(SYSTEM + [1, 2], 4), (SYSTEM + [3], 6), (SYSTEM + [4, 5, 6], 3),
          (SYSTEM + [7], 5)]
LAYOUTS = {
    "chunked": dict(),
    "paged": dict(kv_layout="paged", kv_page_size=16),
    "blocking": dict(prefill_chunk=0),
    "int8": dict(cache_dtype="int8"),
    "fp8_e4m3": dict(cache_dtype="fp8_e4m3"),
}
FP8_LOGIT_TOL = 1e-4


def mk(reqs, cls=Request):
    return [cls(prompt=list(p), max_new_tokens=n) for p, n in reqs]


@pytest.fixture(scope="module")
def setup():
    kw = dict(moe=None, mtp=False, dtype="float32")
    cfg_j = dataclasses.replace(jax_configs.get_config(ARCH, reduced=True),
                                **kw)
    cfg_t = dataclasses.replace(port_configs.get_config(ARCH, reduced=True),
                                **kw)
    params_j = jax.jit(lambda k: JM.init_params(k, cfg_j)[0])(
        jax.random.PRNGKey(0))
    params_t = bridge.params_from_numpy(jax.device_get(params_j), cfg_t,
                                        device="cpu")
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, params_j=params_j,
                params_t=params_t)


def _fp32(kw, jax_side: bool):
    kw = dict(kw)
    kw.setdefault("cache_dtype", jnp.float32 if jax_side else torch.float32)
    return kw


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_greedy_tokens_equal_jax_engine(setup, layout):
    kw = LAYOUTS[layout]
    reqs = MIXED + SHARED if "paged" in layout else MIXED
    jeng = jax_engine.ServeEngine(setup["cfg_j"], setup["params_j"],
                                  batch_size=3, max_len=64,
                                  **_fp32(kw, True))
    want = [r.out for r in jeng.generate(mk(reqs, jax_engine.Request))]
    eng = ServeEngine(setup["cfg_t"], setup["params_t"], batch_size=3,
                      max_len=64, device="cpu", **_fp32(kw, False))
    got = [r.out for r in eng.generate(mk(reqs))]
    assert got == want
    ours, theirs = eng.stats()["kv_cache"], jeng.stats()["kv_cache"]
    assert ours["bytes_per_token"] == theirs["bytes_per_token"]
    if "paged" in layout:
        assert ours["prefix_hits"] == theirs["prefix_hits"] > 0


def test_fp8_logits_match_jax(setup):
    """A chunk then three decode steps through an fp8_e4m3 cache: logits
    within FP8_LOGIT_TOL of the JAX fp8 logits, and the codes equal."""
    cfg_j = dataclasses.replace(setup["cfg_j"], kv_quant="fp8_e4m3")
    cfg_t = dataclasses.replace(setup["cfg_t"], kv_quant="fp8_e4m3")
    jf, tf = JM.make_serve_fns(cfg_j), model_mod.make_serve_fns(cfg_t)
    jc = JM.init_caches(cfg_j, 1, 32)
    tc = model_mod.init_caches(cfg_t, 1, 32, device="cpu")
    toks = np.array([[5, 6, 7, 8, 9, 10, 11, 12]], np.int32)
    lj, jc = jf.prefill_chunk(setup["params_j"], jc, jnp.asarray(toks), 0, 7)
    lt = tf.prefill_chunk(setup["params_t"], tc,
                          torch.from_numpy(toks).long(), 0, 7)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj),
                               atol=FP8_LOGIT_TOL)
    for cur in (8, 9, 10):
        tok = np.array([[cur % 7 + 1]], np.int32)
        lj, jc = jf.decode(setup["params_j"], jc, jnp.asarray(tok),
                           jnp.asarray([cur], jnp.int32))
        lt = tf.decode(setup["params_t"], tc, torch.from_numpy(tok).long(),
                       torch.tensor([cur], dtype=torch.int32))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj),
                                   atol=FP8_LOGIT_TOL)
    codes_t = tc["units"]["r0"]["kv"].view(torch.uint8).numpy()
    codes_j = np.asarray(jc["units"]["r0"]["kv"]).view(np.uint8)
    assert np.array_equal(codes_t, codes_j)


def test_whole_prompt_prefill_matches_jax(setup):
    """``ServeFns.prefill``: the last logits and every layer's latent
    cache (fp32 and int8)."""
    toks = np.array([[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8, 1, 8]],
                    np.int32)
    for mode in (None, "int8"):
        cfg_j = dataclasses.replace(setup["cfg_j"], kv_quant=mode)
        cfg_t = dataclasses.replace(setup["cfg_t"], kv_quant=mode)
        prefill = JM.make_serve_fns(cfg_j, cache_dtype=jnp.float32).prefill
        lj, cj = jax.jit(prefill, static_argnums=2)(
            setup["params_j"], {"tokens": jnp.asarray(toks)}, 16)
        lt, ct = model_mod.make_serve_fns(
            cfg_t, cache_dtype=torch.float32).prefill(
            setup["params_t"], {"tokens": torch.from_numpy(toks).long()}, 16)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=2e-5)
        for name, leaf in ct["units"]["r0"].items():
            want = np.asarray(cj["units"]["r0"][name])
            if leaf.dtype == torch.int8:
                assert np.array_equal(leaf.numpy(), want)
            else:
                np.testing.assert_allclose(leaf.numpy(), want, atol=2e-5)


def test_launcher_serves_dense_deepseek(capsys, monkeypatch):
    from repro_torch.launch import serve as serve_launch
    serve_launch.main(["--arch", ARCH, "--reduced", "--no-moe", "--device",
                       "cpu", "--requests", "3", "--batch", "2",
                       "--max-new", "3", "--max-len", "32", "--kv-layout",
                       "paged", "--kv-page-size", "16", "--cache-dtype",
                       "int8"])
    out = capsys.readouterr().out
    assert "deepseek-v3-671b (reduced)" in out and "kv pool:" in out
    assert "kv cache: int8" in out

    def no_weights(*a, **k):
        raise AssertionError("weights were built")
    monkeypatch.setattr(model_mod, "init_params", no_weights)
    with pytest.raises(NotImplementedError, match="MoE slice"):
        serve_launch.main(["--arch", ARCH, "--device", "cpu"])
