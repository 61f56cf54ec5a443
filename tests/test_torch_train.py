"""The port's train path against the JAX package's, on the same weights.

Reduced smollm-135m in fp32: the JAX parameter tree (and train state)
is carried over by ``repro_torch.bridge``; batches come from the same
seeded ``SyntheticLMDataset`` in both packages.  The JAX side is run
once per module in fixtures.

Tolerances, all fp32 (sums in other orders, ~1e-7 relative per op):
hidden states 1e-5 absolute (values of order 1); losses and grad norms
1e-5 relative; gradients 1e-6 absolute plus 1e-4 relative (entries run
from ~1e-9 to ~0.1, and the small ones carry the large ones' absolute
error); optimizer updates on identical inputs 1e-6 relative.  AdamW's
first step is about ``lr * sign(g)``, which turns last-bit gradient
differences near zero into whole-``lr`` parameter differences, so
parameters are compared only through the moments and the trajectory,
never after several steps at 1e-6.
"""
import dataclasses
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as port_pmt  # noqa: E402
from repro import configs as jax_configs  # noqa: E402
from repro.checkpoint import manager as jax_ckpt  # noqa: E402
from repro.data.pipeline import DataConfig as JaxDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticLMDataset as JaxDataset  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import optimizers as JO  # noqa: E402
from repro.train import steps as JS  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.checkpoint import manager as port_ckpt  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.models import model as PM  # noqa: E402
from repro_torch.optim import optimizers as PO  # noqa: E402
from repro_torch.train import steps as PS  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "smollm-135m"
LOSS_RTOL = 1e-5
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)
OCFG = dict(lr=3e-3, warmup_steps=5, decay_steps=200, weight_decay=0.0)


def _configs(**kw):
    kw = dict(dtype="float32", **kw)
    return (dataclasses.replace(jax_configs.get_config(ARCH, reduced=True),
                                **kw),
            dataclasses.replace(port_configs.get_config(ARCH, reduced=True),
                                **kw))


def _np(x):
    return np.asarray(x, np.float32)


def _leaves_with_paths(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _assert_trees(a, b, **tol):
    fa, fb = _leaves_with_paths(a), _leaves_with_paths(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, x), (_, y) in zip(fa, fb):
        np.testing.assert_allclose(_np(x), _np(y), err_msg=str(p), **tol)


def _batch(seq, seed=1, b=2):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 256, (b, seq)).astype(np.int32)
    tgt = rng.integers(0, 256, (b, seq)).astype(np.int32)
    tgt[:, -3:] = -1                       # padded targets are masked
    return {"tokens": toks, "targets": tgt}


def _torch_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _grads_tree(params):
    return PO.tree_map(lambda t: t.grad, params)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The reduced model's ops are tiny: one intra-op thread runs them
    faster than a pool contending with the other test workers' pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_params():
    cfg_j, _ = _configs()
    params, _ = JM.init_params(jax.random.PRNGKey(0), cfg_j)
    return jax.device_get(params)


# -- forward, loss and grads ---------------------------------------------------------

# (attn_impl, seq, remat): dense at seq 32; chunked at 128 > attn_chunk
# 64; the kernel's op (plain version on the CPU) under full and
# dots-saving recompute
CASES = [("dense", 32, "full"), ("chunked", 128, "full"),
         ("pallas", 128, "full"), ("pallas", 128, "dots")]


@pytest.fixture(scope="module")
def jax_forward_loss_grads(jax_params):
    out = {}
    for impl, seq, _ in CASES:
        if (impl, seq) in out:
            continue
        cfg_j, _ = _configs(attn_impl=impl)
        batch = {k: jnp.asarray(v) for k, v in _batch(seq).items()}
        hidden, _ = jax.jit(JM.build_forward(cfg_j))(jax_params, batch)
        (_, metrics), grads = jax.jit(jax.value_and_grad(
            JM.loss_fn(cfg_j), has_aux=True))(jax_params, batch)
        out[impl, seq] = jax.device_get((hidden, metrics, grads))
    return out


@pytest.mark.parametrize("impl,seq,remat", CASES)
def test_forward_loss_and_grads_match_jax(jax_params, jax_forward_loss_grads,
                                          impl, seq, remat):
    _, cfg = _configs(attn_impl=impl, remat=remat)
    hidden_j, metrics_j, grads_j = jax_forward_loss_grads[impl, seq]
    params = PO.tree_map(lambda t: t.requires_grad_(True),
                         bridge.params_from_numpy(jax_params, cfg, "cpu"))
    batch = _torch_batch(_batch(seq))
    hidden, aux = PM.build_forward(cfg)(params, batch)
    np.testing.assert_allclose(hidden.detach().numpy(), _np(hidden_j),
                               atol=1e-5, rtol=0)
    assert float(aux) == 0.0
    loss, metrics = PM.loss_fn(cfg)(params, batch)
    assert set(metrics) == set(metrics_j)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k].detach()),
                                   float(metrics_j[k]),
                                   rtol=LOSS_RTOL, atol=1e-7)
    loss.backward()
    _assert_trees(bridge.params_to_numpy(_grads_tree(params), cfg),
                  grads_j, **GRAD_TOL)


@pytest.mark.parametrize("impl,seq", [("dense", 32), ("chunked", 128),
                                      ("pallas", 128)])
def test_self_attention_matches_jax(jax_params, impl, seq):
    from repro.models import attention as jax_attn
    from repro_torch.models import attention as port_attn
    cfg_j, cfg = _configs(attn_softcap=30.0, sliding_window=40)
    p = jax.tree.map(lambda a: a[0], jax_params["units"]["r0"]["mixer"])
    x = np.random.default_rng(7).standard_normal(
        (2, seq, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(seq, dtype=np.int32), (2, seq))
    kw = dict(window=40, impl=impl, chunk=cfg.attn_chunk)
    want = jax_attn.self_attention(cfg_j, p, jnp.asarray(x),
                                   jnp.asarray(pos), **kw)
    got = port_attn.self_attention(
        cfg, jax.tree.map(lambda a: torch.tensor(np.asarray(a)), p),
        torch.tensor(x), torch.tensor(pos), **kw)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=0)


def test_kernel_op_runs_twice_per_layer_per_step_under_remat(monkeypatch):
    """The launch count chip_smoke.py expects of the train path (2 per
    layer per step: the forward and the checkpoint's recompute), here
    with a counting stand-in for the card check of the op's forward."""
    calls = []

    def counting(*ts):
        calls.append(1)
        return False            # the CPU path: the plain version

    monkeypatch.setattr(fa_ops, "on_card", counting)
    batch = _torch_batch(_batch(64, b=2))
    for remat, per_layer in (("full", 2), ("none", 1)):
        _, cfg = _configs(attn_impl="pallas", remat=remat)
        ocfg = PO.OptimizerConfig(**OCFG)
        state = PS.init_train_state(cfg, ocfg, seed=0, device="cpu")
        step = PS.make_train_step(cfg, ocfg)
        calls.clear()
        step(state, batch)
        assert len(calls) == per_layer * cfg.num_layers, remat


# -- optimizer parts on identical inputs -------------------------------------------------

def _opt_inputs():
    rng = np.random.default_rng(11)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    params = {"units": {"w": mk(2, 130, 140), "b": mk(2, 9)},
              "embed": mk(20, 6), "norm": mk(6)}
    grads = [jax.tree.map(lambda p: mk(*p.shape) * 0.1, params)
             for _ in range(2)]
    return params, grads


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)), tree)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_updates_match_jax_on_identical_inputs(name):
    cfg = PO.OptimizerConfig(name=name, lr=1e-2, warmup_steps=2,
                             decay_steps=10, weight_decay=0.1)
    jcfg = JO.OptimizerConfig(**dataclasses.asdict(cfg))
    params, grads = _opt_inputs()
    j_init, j_update = JO.make_optimizer(jcfg)
    p_init, p_update = PO.make_optimizer(cfg)
    jp, js = params, j_init(params)
    pp = _torch_tree(params)
    ps = p_init(pp)
    _assert_trees(ps.inner, jax.device_get(js.inner), rtol=0, atol=0)
    for g in grads:
        jp, js = j_update(g, js, jp)
        pp, ps = p_update(_torch_tree(g), ps, pp)
        assert int(ps.step) == int(js.step)
        _assert_trees(pp, jax.device_get(jp), rtol=1e-6, atol=1e-7)
        _assert_trees(ps.inner, jax.device_get(js.inner), rtol=1e-6,
                      atol=1e-12)
    if name == "adafactor":     # the factored rule took the big matrix
        assert set(ps.inner["units"]["w"]) == {"vr", "vc"}
        assert set(ps.inner["units"]["b"]) == {"v"}


def test_schedule_and_clip_match_jax():
    cfg = PO.OptimizerConfig(lr=3e-3, warmup_steps=7, decay_steps=50)
    jcfg = JO.OptimizerConfig(**dataclasses.asdict(cfg))
    for s in (0, 1, 3, 7, 8, 20, 49, 50, 80):
        np.testing.assert_allclose(
            float(PO.wsd_schedule(cfg, torch.tensor(s, dtype=torch.int32))),
            float(JO.wsd_schedule(jcfg, jnp.asarray(s, jnp.int32))),
            rtol=1e-6)
    _, (g, _) = _opt_inputs()
    for max_norm in (0.5, 1e3):
        jg, jn = JO.clip_by_global_norm(g, max_norm)
        pg, pn = PO.clip_by_global_norm(_torch_tree(g), max_norm)
        np.testing.assert_allclose(float(pn), float(jn), rtol=1e-6)
        _assert_trees(pg, jax.device_get(jg), rtol=1e-6, atol=0)


# -- train steps ---------------------------------------------------------------------

DATA = dict(vocab_size=256, seq_len=32, global_batch=8, seed=3)


def test_synthetic_batches_are_identical():
    jd, pd = JaxDataset(JaxDataConfig(**DATA)), SyntheticLMDataset(
        DataConfig(**DATA, pad_fraction=0.0))
    for s in (0, 1, 17):
        a, b = jd.batch(s), pd.batch(s)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    padded = SyntheticLMDataset(DataConfig(**dict(DATA, seed=4),
                                           pad_fraction=0.25)).batch(2)
    np.testing.assert_array_equal(padded["targets"], JaxDataset(
        JaxDataConfig(**dict(DATA, seed=4), pad_fraction=0.25)).batch(
            2)["targets"])


@pytest.fixture(scope="module")
def jax_trajectories():
    """3 steps of the JAX train step from PRNGKey(0), and 1 step with 2
    microbatches: the initial state and each step's metrics and moments."""
    cfg_j, _ = _configs()
    ocfg = JO.OptimizerConfig(**OCFG)
    state, _ = JS.init_train_state(jax.random.PRNGKey(0), cfg_j, ocfg)
    init = jax.device_get(state)
    ds = JaxDataset(JaxDataConfig(**DATA))
    out = {"init": init}
    for mb in (1, 2):
        step = jax.jit(JS.make_train_step(cfg_j, ocfg, microbatches=mb))
        st, rows = state, []
        for s in range(1, 4 if mb == 1 else 2):
            st, m = step(st, {k: jnp.asarray(v)
                              for k, v in ds.batch(s).items()})
            rows.append(jax.device_get((m, st.opt.inner["m"])))
        out[mb] = rows
    return out


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_match_jax(jax_trajectories, microbatches):
    _, cfg = _configs()
    ocfg = PO.OptimizerConfig(**OCFG)
    state = bridge.train_state_from_numpy(jax_trajectories["init"], cfg,
                                          "cpu")
    step = PS.make_train_step(cfg, ocfg, microbatches=microbatches)
    ds = SyntheticLMDataset(DataConfig(**DATA))
    for s, (mj, mom_j) in enumerate(jax_trajectories[microbatches], 1):
        state, m = step(state, _torch_batch(ds.batch(s)))
        for k in ("loss", "nll", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(mj[k]),
                                       rtol=LOSS_RTOL, err_msg=f"{k} {s}")
        if s == 1:    # first moments = 0.1 x the clipped step-1 grads
            _assert_trees(state.opt.inner["m"], mom_j, atol=1e-7, rtol=1e-4)


# -- port twins of tests/test_train_integration.py ---------------------------------------

def _setup(seed=0):
    cfg = port_configs.get_config(ARCH, reduced=True)
    ocfg = PO.OptimizerConfig(**OCFG)
    state = PS.init_train_state(cfg, ocfg, seed=seed, device="cpu")
    return cfg, ocfg, state, DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=32, global_batch=8, seed=3)


def test_port_loss_decreases_and_energy_accounted(tmp_path):
    cfg, ocfg, state, dcfg = _setup()
    ds = SyntheticLMDataset(dcfg)
    step = PS.make_train_step(cfg, ocfg)
    mon = port_pmt.PowerMonitor(["cpuutil", "dummy"],
                                log_path=str(tmp_path / "energy.csv"))
    measured = PS.make_measured_train_step(step, mon, tokens_per_step=8 * 32)
    losses = []
    for s in range(30):
        state, metrics, _ = measured(state, _torch_batch(ds.batch(s)), s)
        losses.append(float(metrics["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, losses
    assert mon.cumulative_joules > 0
    assert {r.sensor for r in mon.records()} == {"cpuutil", "dummy"}
    csv = open(tmp_path / "energy.csv").read().splitlines()
    assert len(csv) == 1 + 2 * 30   # header + 2 sensors x 30 steps
    mon.close()


def test_port_checkpoint_restart_reproduces_uninterrupted_run(tmp_path):
    cfg, ocfg, state, dcfg = _setup()
    ds = SyntheticLMDataset(dcfg)
    step = PS.make_train_step(cfg, ocfg)
    mgr = port_ckpt.CheckpointManager(str(tmp_path), every=5, keep=3,
                                      async_save=True)
    mon = port_pmt.PowerMonitor(["dummy"])
    s1 = state
    for s in range(1, 11):
        with mon.measure_step(s):
            s1, _ = step(s1, _torch_batch(ds.batch(s)))
        mgr.maybe_save(s, PS.checkpoint_tree(cfg, s1),
                       port_ckpt.CheckpointMeta(
                           step=s, data_step=s,
                           cumulative_joules=mon.cumulative_joules))
        if s == 5:
            at5 = [t.detach().clone() for t in
                   PO.tree_leaves(PS.checkpoint_tree(cfg, s1))]
    mgr.finalize()
    assert port_ckpt.latest_step(str(tmp_path)) == 10
    # the async save of step 5 holds step 5's state, though the steps
    # after it updated parameters and moments in place while it wrote
    tree5, meta5 = port_ckpt.restore(str(tmp_path),
                                     PS.checkpoint_tree(cfg, state), step=5)
    assert meta5.step == 5
    for a, b in zip(PO.tree_leaves(tree5), at5):
        np.testing.assert_array_equal(a.numpy(), b.numpy())

    _, _, fresh, _ = _setup(seed=1)        # other weights, same structure
    tree, meta = port_ckpt.restore(str(tmp_path),
                                   PS.checkpoint_tree(cfg, fresh))
    assert meta.step == 10 and meta.cumulative_joules > 0
    mon2 = port_pmt.PowerMonitor(["dummy"],
                                 initial_joules=meta.cumulative_joules)
    assert mon2.cumulative_joules == meta.cumulative_joules
    s2 = PS.from_checkpoint_tree(cfg, tree)
    for s in range(meta.data_step + 1, 16):
        s2, _ = step(s2, _torch_batch(ds.batch(s)))

    _, _, ref, _ = _setup()
    for s in range(1, 16):
        ref, _ = step(ref, _torch_batch(ds.batch(s)))
    for a, b in zip(PO.tree_leaves(s2.params), PO.tree_leaves(ref.params)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)
    assert int(s2.opt.step) == int(ref.opt.step) == 15
    mon.close()
    mon2.close()


def test_port_async_save_writes_the_state_it_was_given(tmp_path,
                                                      monkeypatch):
    """An async save holds the leaves as they were when it was called,
    though the optimizers update them in place before the writer thread
    reaches them (held here until the update is done)."""
    cfg, _, state, _ = _setup()
    tree = PS.checkpoint_tree(cfg, state)
    before = [t.detach().clone() for t in PO.tree_leaves(tree)]
    gate, makedirs = threading.Event(), os.makedirs

    def held(*a, **k):
        assert gate.wait(timeout=60)
        return makedirs(*a, **k)

    monkeypatch.setattr(port_ckpt.os, "makedirs", held)
    writer = port_ckpt.save(str(tmp_path), 1, tree,
                            port_ckpt.CheckpointMeta(step=1), blocking=False)
    with torch.no_grad():
        for t in PO.tree_leaves(tree):
            t.add_(1)
    gate.set()
    writer.join()
    got, _ = port_ckpt.restore(str(tmp_path), tree)
    for a, b in zip(PO.tree_leaves(got), before):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_port_checkpoint_has_the_jax_layout(tmp_path, jax_trajectories):
    """A checkpoint the port writes of a bridged JAX state is read back by
    the JAX package's own ``restore`` as that state, leaf for leaf; a
    corrupt newest checkpoint falls back to the one before."""
    _, cfg = _configs()
    jax_state = jax_trajectories["init"]
    state = bridge.train_state_from_numpy(jax_state, cfg, "cpu")
    meta = port_ckpt.CheckpointMeta(step=3, cumulative_joules=1.5,
                                    data_step=3)
    port_ckpt.save(str(tmp_path), 3, PS.checkpoint_tree(cfg, state), meta)
    got, jmeta = jax_ckpt.restore(str(tmp_path), jax_state)
    assert jmeta.cumulative_joules == 1.5
    _assert_trees(got, jax_state, rtol=0, atol=0)
    # a later checkpoint whose first leaf is corrupt is skipped
    port_ckpt.save(str(tmp_path), 4, PS.checkpoint_tree(cfg, state),
                   dataclasses.replace(meta, step=4))
    np.save(str(tmp_path / "step_00000004" / "leaf_00000.npy"),
            np.zeros((cfg.vocab_size, cfg.d_model), np.float32))
    tree, back = port_ckpt.restore(str(tmp_path),
                                   PS.checkpoint_tree(cfg, state))
    assert back.step == 3
    manifest = json.loads((tmp_path / "step_00000003" /
                           "manifest.json").read_text())
    assert manifest["num_leaves"] == len(jax.tree.leaves(jax_state))
    _assert_trees(bridge.params_to_numpy(
        PS.from_checkpoint_tree(cfg, tree).params, cfg),
        jax_state.params, rtol=0, atol=0)


def test_train_cli_runs_and_resumes(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    base = [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
            "--device", "cpu", "--batch", "4", "--seq", "32",
            "--log-every", "3", "--ckpt-dir", str(tmp_path / "ck"),
            "--ckpt-every", "3", "--energy-log", str(tmp_path / "e.csv")]
    out = subprocess.run(base + ["--steps", "6"], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("step     3 loss=") and "J/step=" in lines[0]
    assert lines[-1].startswith("done: 6 steps") \
        and "(cpuutil measured)" in lines[-1]
    out = subprocess.run(base + ["--steps", "9"], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("resumed step=6 joules=")
    assert "done: 3 steps" in out.stdout
    assert port_ckpt.latest_step(str(tmp_path / "ck")) == 9
