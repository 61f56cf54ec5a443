"""Serving launcher: the port's continuous-batching engine on random
weights.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
      [--reduced] [--requests 8] [--batch 4] [--max-new 16] \
      [--max-len 128] [--prefill-chunk 32] [--seed 0] [--device cuda]

Runs on the card unless ``--device cpu`` is given.  Prompts are random
token ids with lengths spread over [1, max_len / 2], made from
``--seed``.  Prints the generated tokens per second and each request's
token count.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.models import model as model_mod
from repro_torch.serve.engine import Request, ServeEngine, stall_p95


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
    engine = ServeEngine(cfg, params, batch_size=args.batch,
                         max_len=args.max_len,
                         prefill_chunk=args.prefill_chunk, device=device)
    t0 = time.perf_counter()
    done = engine.generate(requests)
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = sum(len(r.out) for r in done)
    where = torch.cuda.get_device_name(0) if device.type == "cuda" \
        else "cpu"
    print(f"{cfg.name}{' (reduced)' if args.reduced else ''} on {where}: "
          f"{len(done)} requests, {n} tokens in {dt:.3f}s "
          f"= {n / dt:.1f} tokens/s (wall clock, first call included)")
    print(f"stall p95 {stall_p95(engine.stall_events) * 1e3:.2f} ms over "
          f"{len(engine.stall_events)} chunks")
    for r in done:
        print(f"  req{r.id}: prompt {len(r.prompt)} -> {len(r.out)} tokens "
              f"({r.finish_reason})")


if __name__ == "__main__":
    main()
