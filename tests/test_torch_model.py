"""The port's serve steps against the JAX package's, on the same weights.

Reduced smollm-135m in fp32 with fp32 caches: the JAX parameter tree is
carried over by ``repro_torch.bridge``; prompts come from a numpy seed.
Tolerance 1e-5 absolute on logits and cache rows: both sides are fp32
through the same layers, differing in matmul and softmax summation order
and in the attention path (the JAX side runs its masked dense decode and
lax prefill on the CPU, the port its blockwise plain versions); on
logits of magnitude below 0.5 the two differ by about 4e-7.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.models import model as PM  # noqa: E402

ATOL = 1e-5
ARCH = "smollm-135m"
# the reduced dense config, and a variant that drives the ring-cache,
# window and softcap paths of the same layers
VARIANTS = {"dense": {},
            "ring-softcap": dict(sliding_window=8, attn_softcap=20.0,
                                 final_softcap=30.0)}


def _configs(variant):
    kw = dict(dtype="float32", **VARIANTS[variant])
    return (dataclasses.replace(jax_configs.get_config(ARCH, reduced=True),
                                **kw),
            dataclasses.replace(port_configs.get_config(ARCH, reduced=True),
                                **kw))


@pytest.fixture(scope="module")
def jax_tree():
    cfg_j, _ = _configs("dense")
    params, _ = JM.init_params(jax.random.PRNGKey(0), cfg_j)
    return jax.device_get(params)


def _np(x):
    return np.asarray(x, np.float32)


def _port_np(t):
    return t.detach().float().numpy()


def _assert_caches(jc, pc, upto=None, atol=ATOL):
    for name in ("k", "v"):
        a = _np(jc["units"]["r0"][name])
        b = _port_np(pc["units"]["r0"][name])
        assert a.shape == b.shape
        if upto is not None:
            a, b = a[:, :, :upto], b[:, :, :upto]
        np.testing.assert_allclose(a, b, atol=atol, rtol=0)


def test_bridge_round_trips_the_tree(jax_tree):
    cfg_j, cfg_t = _configs("dense")
    params = bridge.params_from_numpy(jax_tree, cfg_t, device="cpu")
    assert params["units"]["r0"]["mixer"]["wq"].shape == \
        (cfg_t.num_layers, cfg_t.d_model, cfg_t.num_heads, cfg_t.head_dim)
    back = bridge.params_to_numpy(params, cfg_t)
    flat_a = jax.tree_util.tree_leaves_with_path(jax_tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), b)
    # the port's own init builds the same tree, names and shapes
    own = PM.init_params(cfg_t, seed=0, device="cpu")
    shapes = lambda tree: jax.tree_util.tree_map(lambda x: tuple(x.shape),
                                                 tree)
    assert shapes(bridge.params_to_numpy(own, cfg_t)) == shapes(back)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prefill_chunk_and_decode_match_jax(jax_tree, variant):
    """Two chunks (the second right-padded) then three decode steps with
    a per-row position vector: logits and caches agree with JAX at each
    step."""
    cfg_j, cfg_t = _configs(variant)
    b, chunk, plen, max_len = 2, 8, 13, 32
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg_t.vocab_size, (b, 16)).astype(np.int32)
    toks[:, plen:] = 0
    jfns = JM.make_serve_fns(cfg_j, cache_dtype=jnp.float32)
    jc = JM.init_caches(cfg_j, b, max_len, dtype=jnp.float32)
    params_t = bridge.params_from_numpy(jax_tree, cfg_t, device="cpu")
    pfns = PM.make_serve_fns(cfg_t)
    pc = PM.init_caches(cfg_t, b, max_len, torch.float32, device="cpu")
    jchunk = jax.jit(jfns.prefill_chunk)
    for off in range(0, 16, chunk):
        last = min(plen - 1 - off, chunk - 1)
        jl, jc = jchunk(jax_tree, jc, jnp.asarray(toks[:, off:off + chunk]),
                        jnp.asarray(off, jnp.int32),
                        jnp.asarray(last, jnp.int32))
        pl = pfns.prefill_chunk(params_t, pc,
                                torch.from_numpy(toks[:, off:off + chunk]
                                                 ).long(), off, last)
        np.testing.assert_allclose(_np(jl), _port_np(pl), atol=ATOL, rtol=0)
        _assert_caches(jc, pc)
    jdec = jax.jit(jfns.decode)
    cur = np.array([plen, plen - 3], np.int32)
    nxt = rng.integers(0, cfg_t.vocab_size, (b, 1)).astype(np.int32)
    for _ in range(3):
        jl, jc = jdec(jax_tree, jc, jnp.asarray(nxt), jnp.asarray(cur))
        pl = pfns.decode(params_t, pc, torch.from_numpy(nxt).long(),
                         torch.from_numpy(cur))
        np.testing.assert_allclose(_np(jl), _port_np(pl), atol=ATOL, rtol=0)
        _assert_caches(jc, pc)
        nxt = np.argmax(_np(jl), -1).astype(np.int32)[:, None]
        cur = cur + 1


def _port_chunked(cfg_t, params_t, toks, chunk, max_len):
    pfns = PM.make_serve_fns(cfg_t)
    pc = PM.init_caches(cfg_t, 1, max_len, torch.float32, device="cpu")
    plen = toks.shape[1]
    padded = math.ceil(plen / chunk) * chunk
    buf = np.zeros((1, padded), np.int64)
    buf[0, :plen] = toks[0]
    logits = None
    for off in range(0, padded, chunk):
        logits = pfns.prefill_chunk(params_t, pc,
                                    torch.from_numpy(buf[:, off:off + chunk]),
                                    off, min(plen - 1 - off, chunk - 1))
    return logits, pc


def test_chunked_prefill_matches_jax_whole_prompt(jax_tree):
    """The port's chunked prefill against the JAX whole-prompt prefill:
    same first token, logits and valid cache rows within ATOL."""
    cfg_j, cfg_t = _configs("dense")
    plen, max_len = 13, 32
    toks = np.random.default_rng(1).integers(
        0, cfg_t.vocab_size, (1, plen)).astype(np.int32)
    jfns = JM.make_serve_fns(cfg_j, cache_dtype=jnp.float32)
    jl, jc = jax.jit(lambda p, b: jfns.prefill(p, b, max_len))(
        jax_tree, {"tokens": jnp.asarray(toks)})
    params_t = bridge.params_from_numpy(jax_tree, cfg_t, device="cpu")
    pl, pc = _port_chunked(cfg_t, params_t, toks, 4, max_len)
    assert int(np.argmax(_np(jl))) == int(np.argmax(_port_np(pl)))
    np.testing.assert_allclose(_np(jl), _port_np(pl), atol=ATOL, rtol=0)
    _assert_caches(jc, pc, upto=plen)


def test_chunked_prefill_invariant_to_chunk_size(jax_tree):
    _, cfg_t = _configs("dense")
    params_t = bridge.params_from_numpy(jax_tree, cfg_t, device="cpu")
    toks = np.random.default_rng(2).integers(
        0, cfg_t.vocab_size, (1, 11)).astype(np.int32)
    runs = [_port_chunked(cfg_t, params_t, toks, ck, 32) for ck in (3, 5, 16)]
    assert len({int(torch.argmax(l)) for l, _ in runs}) == 1
    for logits, caches in runs[1:]:
        np.testing.assert_allclose(_port_np(runs[0][0]), _port_np(logits),
                                   atol=1e-5, rtol=0)
        for name in ("k", "v"):
            np.testing.assert_allclose(
                _port_np(runs[0][1]["units"]["r0"][name][:, :, :11]),
                _port_np(caches["units"]["r0"][name][:, :, :11]),
                atol=1e-5, rtol=0)


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    _, cfg_t = _configs("dense")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PM.init_params(cfg_t, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PM.init_caches(cfg_t, 1, 8)
    assert PM.init_caches(cfg_t, 1, 8, device="cpu")["units"]["r0"][
        "k"].device.type == "cpu"


def test_cache_helpers_need_a_card_unless_cpu_is_asked(monkeypatch):
    """``init_kv_cache`` and ``init_block_cache`` resolve their device as
    ``init_caches`` does: ``device=None`` means the card, and without one
    they raise ``resolve_device``'s error rather than go on on the CPU."""
    from repro_torch.device import resolve_device
    from repro_torch.models import attention as PA
    from repro_torch.models import blocks as PB
    _, cfg_t = _configs("dense")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError) as want:
        resolve_device(None)
    for call in (lambda: PA.init_kv_cache(cfg_t, 1, 8),
                 lambda: PB.init_block_cache(cfg_t, 0, 1, 8)):
        with pytest.raises(RuntimeError) as got:
            call()
        assert str(got.value) == str(want.value)
    assert PA.init_kv_cache(cfg_t, 1, 8, device="cpu")["k"].device.type \
        == "cpu"
    assert PB.init_block_cache(cfg_t, 0, 1, 8, device="cpu")["v"].device \
        .type == "cpu"


def test_unported_archs_and_features_raise():
    with pytest.raises(NotImplementedError, match="other-archs slice"):
        port_configs.get_config("gemma2-27b")
    _, cfg_t = _configs("dense")
    # quantized caches are ported: the serve steps build with kv_quant
    fns = PM.make_serve_fns(dataclasses.replace(cfg_t, kv_quant="int8"))
    assert callable(fns.decode) and callable(fns.prefill_chunk)
    # dense decode attention is ported: the serve steps build with it
    fns = PM.make_serve_fns(dataclasses.replace(cfg_t,
                                                decode_attn_impl="dense"))
    assert callable(fns.prefill) and callable(fns.decode)
