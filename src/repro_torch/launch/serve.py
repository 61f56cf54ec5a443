"""Serving launcher: the port's continuous-batching engine on random
weights.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
      [--reduced] [--requests 8] [--batch 4] [--max-new 16] \
      [--max-len 128] [--prefill-chunk 32] [--seed 0] [--device cuda]

Runs on the card unless ``--device cpu`` is given.  Prompts are random
token ids with lengths spread over [1, max_len / 2], made from
``--seed``.  Energy is measured through one PMT session,
``Session(["cpuutil", "nvml"])`` (``["cpuutil"]`` with ``--device
cpu``): the engine opens an aggregate region per ``generate()`` and a
flat ``serve/req<N>`` span per request with ``/prefill`` and ``/decode``
phase spans.  Prints the generated tokens per second, the aggregate
joules per token, the costliest request's joules per token with its
prefill/decode split, and each request's token count.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

import repro_torch.core as pmt
from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.models import model as model_mod
from repro_torch.serve.engine import Request, ServeEngine, stall_p95


def request_energy(records) -> dict:
    """Joules of each request span and its phases, from the session's
    records: ``{"serve/req<N>": {"joules", "tokens", "prefill",
    "decode"}}``, every backend summed."""
    by_req = {}
    for r in records:
        if not r.path.startswith("serve/req"):
            continue
        path, _, phase = r.path.partition("serve/")[2].partition("/")
        d = by_req.setdefault(f"serve/{path}",
                              {"joules": 0.0, "tokens": 0,
                               "prefill": 0.0, "decode": 0.0})
        if phase:
            d[phase] += r.joules
        else:
            d["joules"] += r.joules
            d["tokens"] = r.tokens
    return by_req


def energy_report(records, n_tokens: int, backends) -> list:
    """The JAX launcher's energy lines: aggregate J/token over the
    ``generate()`` regions, and the costliest request's J/token with its
    prefill/decode split.  Request spans overlap in time, so they are
    views of the aggregate, not additions to it."""
    agg = sum(r.joules for r in records
              if not r.path.startswith("serve/req"))
    lines = [f"energy ({'+'.join(backends)}): {agg:.2f} J aggregate, "
             f"{agg / max(n_tokens, 1):.4f} J/token"]
    by_req = request_energy(records)
    if by_req:
        worst = max(by_req.items(),
                    key=lambda kv: kv[1]["joules"] / max(kv[1]["tokens"], 1))
        lines.append(
            f"per-request spans: {len(by_req)} (token sum "
            f"{sum(d['tokens'] for d in by_req.values())}); costliest "
            f"{worst[0]}: "
            f"{worst[1]['joules'] / max(worst[1]['tokens'], 1):.4f} J/token "
            f"({worst[1]['prefill']:.2f} J prefill / "
            f"{worst[1]['decode']:.2f} J decode)")
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m",
                    choices=list(configs.ARCH_NAMES))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="tokens per chunked-prefill admission slice; "
                         "default resolves PMT_PREFILL_CHUNK then "
                         "cfg.prefill_chunk")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = configs.get_config(args.arch, reduced=args.reduced)
    params = model_mod.init_params(cfg, seed=args.seed, device=device)
    rng = np.random.default_rng(args.seed)
    max_prompt = max(1, min(args.max_len // 2,
                            args.max_len + 1 - args.max_new))
    requests = [Request(prompt=rng.integers(
        0, cfg.vocab_size, int(rng.integers(1, max_prompt + 1))).tolist(),
        max_new_tokens=args.max_new) for _ in range(args.requests)]
    backends = ["cpuutil", "nvml"] if device.type == "cuda" \
        else ["cpuutil"]
    with pmt.Session(backends) as session:
        energy = session.add_exporter(pmt.MemoryExporter())
        engine = ServeEngine(cfg, params, batch_size=args.batch,
                             max_len=args.max_len,
                             prefill_chunk=args.prefill_chunk,
                             device=device, session=session)
        t0 = time.perf_counter()
        done = engine.generate(requests)
        if device.type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        session.flush()          # settle any spans still in flight
    n = sum(len(r.out) for r in done)
    where = torch.cuda.get_device_name(0) if device.type == "cuda" \
        else "cpu"
    print(f"{cfg.name}{' (reduced)' if args.reduced else ''} on {where}: "
          f"{len(done)} requests, {n} tokens in {dt:.3f}s "
          f"= {n / dt:.1f} tokens/s (wall clock, first call included)")
    print(f"stall p95 {stall_p95(engine.stall_events) * 1e3:.2f} ms over "
          f"{len(engine.stall_events)} chunks")
    for line in energy_report(energy.records, n, backends):
        print(line)
    for r in done:
        print(f"  req{r.id}: prompt {len(r.prompt)} -> {len(r.out)} tokens "
              f"({r.finish_reason})")


if __name__ == "__main__":
    main()
