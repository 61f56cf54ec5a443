"""Training launcher: the port's train step on the synthetic data
pipeline, with per-step energy through PMT and restartable checkpoints.

Wires the subsystems together: config registry -> train step (with
``--attn-impl pallas`` through the flash-attention kernel) -> synthetic
data -> PMT ``PowerMonitor`` (per-step energy, CSV log, cumulative
accounting) -> atomic async checkpoints carrying the joules -> exact
resume (params, optimizer, data cursor, joules).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      [--reduced] [--steps 100] [--batch 8] [--seq 64] [--lr 3e-3] \\
      [--microbatches 1] [--attn-impl auto] [--ckpt-dir DIR] \\
      [--ckpt-every 50] [--energy-log CSV] [--energy-jsonl PATH] \\
      [--seed 0] [--log-every 10] [--device cuda]

Runs on the card unless ``--device cpu`` is given; energy comes from
``Session(["cpuutil", "nvml"])`` on the card and ``["cpuutil"]`` on the
CPU.  The JAX launcher's ``--mesh`` comes with the mesh slice.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

import repro_torch.core as pmt
from repro_torch import configs
from repro_torch.checkpoint.manager import (CheckpointManager,
                                            CheckpointMeta, latest_step,
                                            restore)
from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset
from repro_torch.device import resolve_device
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.train.steps import (checkpoint_tree, from_checkpoint_tree,
                                     init_train_state,
                                     make_measured_train_step,
                                     make_train_step)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m",
                    choices=list(configs.ARCH_NAMES))
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--attn-impl", default=None,
                    choices=["auto", "dense", "chunked", "pallas"],
                    help="full-sequence attention (default: the config's; "
                         "pallas = the flash-attention kernel)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--energy-log", default="")
    ap.add_argument("--energy-jsonl", default="",
                    help="structured per-region JSONL export path")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = configs.get_config(args.arch, reduced=args.reduced)
    if args.attn_impl:
        cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl)
    ocfg = OptimizerConfig(name=cfg.optimizer, lr=args.lr,
                           warmup_steps=min(20, args.steps // 5 + 1),
                           decay_steps=args.steps)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch, seed=args.seed)
    ds = SyntheticLMDataset(dcfg)

    # One shared measurement session for the whole run: the monitor and
    # any ad-hoc regions resolve off the same background sampler per
    # backend.
    backends = ["cpuutil", "nvml"] if device.type == "cuda" \
        else ["cpuutil"]
    session = pmt.Session(backends)
    if args.energy_jsonl:
        session.add_exporter(pmt.JsonlExporter(args.energy_jsonl))
    monitor = pmt.PowerMonitor(log_path=args.energy_log or None,
                               session=session)
    mgr = (CheckpointManager(args.ckpt_dir, every=args.ckpt_every)
           if args.ckpt_dir else None)

    state = init_train_state(cfg, ocfg, seed=args.seed, device=device)
    start_step = 0
    if mgr and latest_step(args.ckpt_dir) is not None:
        tree, meta = restore(args.ckpt_dir, checkpoint_tree(cfg, state))
        state = from_checkpoint_tree(cfg, tree)
        start_step = meta.data_step
        monitor.close()
        monitor = pmt.PowerMonitor(
            log_path=args.energy_log or None,
            initial_joules=meta.cumulative_joules, session=session)
        print(f"resumed step={meta.step} "
              f"joules={meta.cumulative_joules:.1f}")

    step_fn = make_train_step(cfg, ocfg, microbatches=args.microbatches)
    tokens_per_step = args.batch * args.seq
    measured_step = make_measured_train_step(
        step_fn, monitor, tokens_per_step=tokens_per_step)
    t_start = time.time()
    for s in range(start_step + 1, args.steps + 1):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in ds.batch(s).items()}
        state, metrics, box = measured_step(state, batch, s)
        if mgr:
            sd = monitor.state_dict()
            mgr.maybe_save(s, checkpoint_tree(cfg, state), CheckpointMeta(
                step=s, data_step=s,
                cumulative_joules=sd["cumulative_joules"],
                joules_per_step_ema=sd["joules_per_step_ema"]))
        if s % args.log_every == 0 or s == args.steps:
            r = box.records[0]
            print(f"step {s:5d} loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"J/step={r.joules:.3f} "
                  f"tok/s={tokens_per_step / max(r.seconds, 1e-9):.0f}",
                  flush=True)
    if mgr:
        mgr.finalize()
    dt = time.time() - t_start
    measured = " + ".join(f"{b} measured" for b in backends)
    print(f"done: {args.steps - start_step} steps in {dt:.1f}s, "
          f"total energy {monitor.cumulative_joules:.1f} J ({measured})")
    monitor.close()
    session.close()
    return state


if __name__ == "__main__":
    main()
