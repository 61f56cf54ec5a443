"""Serving launcher: the port's continuous-batching engine on random
weights.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
      [--reduced] [--requests 8] [--batch 4] [--max-new 16] \
      [--max-len 128] [--prefill-chunk 32] [--seed 0] [--device cuda] \
      [--mode {continuous,wave}] [--decode-attn-impl {auto,dense,flash}] \
      [--temperature 0] [--request-deadline-s S] \
      [--cache-dtype {bfloat16,float32,int8,fp8_e4m3}] \
      [--kv-layout paged [--kv-page-size 16] [--kv-pool-blocks N] \
       [--no-prefix-cache]]

Runs on the card unless ``--device cpu`` is given.  Prompts are random
token ids with lengths spread over [1, max_len / 2], made from
``--seed``.  ``--prefill-chunk 0`` admits each request by one blocking
whole-prompt prefill at its power-of-two bucket, ``--mode wave`` serves
batch-sized waves, ``--temperature T`` (> 0) samples at T from
``--seed`` (0: greedy), ``--decode-attn-impl dense`` attends the whole
cache at decode, and ``--request-deadline-s`` retires requests past it
(continuous mode only).  Energy is measured through one PMT session,
``Session(["cpuutil", "nvml"])`` (``["cpuutil"]`` with ``--device
cpu``): the engine opens an aggregate region per ``generate()`` and a
flat ``serve/req<N>`` span per request with ``/prefill`` and ``/decode``
phase spans.  Prints the generated tokens per second, the aggregate
joules per token, the costliest request's joules per token with its
prefill/decode split (continuous mode: waves open no request spans),
the decode stalls behind prefills (count and p95), the KV cache's
storage and footprint (the ``kv cache: <dtype>, <N> B/token`` line;
``--cache-dtype int8`` or ``fp8_e4m3`` stores codes plus float32 row
scales) and each request's token count.  With ``--kv-layout paged`` it also prints the page pool's
use and the prefix cache's hits (the ``kv pool:`` line).
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


def kv_pool_line(kc: dict) -> str:
    """The JAX launcher's ``kv pool:`` line from ``stats()["kv_cache"]``
    of a paged engine."""
    line = (f"kv pool: {kc['pages_used']}/{kc['pages_total']} pages held "
            f"({kc['pages_free']} free, {kc['page_size']} tokens/page, "
            f"{kc['pool_wait_events']} pool waits)")
    if kc["prefix_cache"]:
        line += (f"; prefix cache: {kc['prefix_hits']}/"
                 f"{kc['prefix_lookups']} hits, "
                 f"{kc['prefix_hit_tokens']} prompt tokens reused, "
                 f"{kc['prefix_evictions']} evictions, "
                 f"~{kc['saved_prefill_joules']:.2f} J prefill saved")
    return line


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m",
                    choices=list(configs.ARCH_NAMES))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--mode", default="continuous",
                    choices=["continuous", "wave"],
                    help="continuous = slot refill; wave = synchronized "
                         "batch-sized waves (the baseline)")
    ap.add_argument("--decode-attn-impl", default="auto",
                    choices=["auto", "dense", "flash"],
                    help="decode attention: flash (auto) = the length-aware "
                         "flash-decode kernel; dense = a masked attend "
                         "over the whole cache (contiguous layout)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="tokens per chunked-prefill admission slice; 0 = "
                         "blocking bucketed whole-prompt prefill; default "
                         "resolves PMT_PREFILL_CHUNK then "
                         "cfg.prefill_chunk")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature; 0 (default) = greedy "
                         "argmax")
    ap.add_argument("--request-deadline-s", type=float, default=None,
                    help="per-request deadline from submission: requests "
                         "still waiting or generating past it finish with "
                         "reason 'timeout', keeping their tokens; "
                         "continuous mode only")
    ap.add_argument("--kv-layout", default="contiguous",
                    choices=["contiguous", "paged"],
                    help="KV cache layout: paged = page pools + per-slot "
                         "page tables + radix prefix reuse; contiguous = "
                         "the per-slot caches")
    ap.add_argument("--cache-dtype", default="bfloat16",
                    choices=["bfloat16", "float32", "int8", "fp8_e4m3"],
                    help="KV cache storage: bfloat16/float32 store raw "
                         "values; int8/fp8_e4m3 store quantized codes + "
                         "per-row float32 scales, dequantized inside the "
                         "attention kernels")
    ap.add_argument("--kv-page-size", type=int, default=None,
                    help="tokens per KV page (paged layout); default "
                         "cfg.kv_page_size")
    ap.add_argument("--kv-pool-blocks", type=int, default=None,
                    help="usable pages in the shared pool (paged layout); "
                         "default batch * ceil(max_len / page_size). "
                         "Smaller pools trade admission waits for cache "
                         "memory; prefix-tree pages are evicted LRU "
                         "under pressure")
    ap.add_argument("--prefix-cache", dest="prefix_cache",
                    action="store_true", default=True,
                    help="radix-tree prefix reuse across requests (paged "
                         "layout; default on)")
    ap.add_argument("--no-prefix-cache", dest="prefix_cache",
                    action="store_false")
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
    deadline = args.request_deadline_s if args.mode == "continuous" \
        else None
    requests = [Request(prompt=rng.integers(
        0, cfg.vocab_size, int(rng.integers(1, max_prompt + 1))).tolist(),
        max_new_tokens=args.max_new, deadline_s=deadline)
        for _ in range(args.requests)]
    backends = ["cpuutil", "nvml"] if device.type == "cuda" \
        else ["cpuutil"]
    with pmt.Session(backends) as session:
        energy = session.add_exporter(pmt.MemoryExporter())
        engine = ServeEngine(cfg, params, batch_size=args.batch,
                             max_len=args.max_len, mode=args.mode,
                             decode_attn_impl=args.decode_attn_impl,
                             prefill_chunk=args.prefill_chunk,
                             kv_layout=args.kv_layout,
                             kv_page_size=args.kv_page_size,
                             kv_pool_pages=args.kv_pool_blocks,
                             prefix_cache=args.prefix_cache,
                             cache_dtype=args.cache_dtype,
                             greedy=args.temperature <= 0.0,
                             temperature=args.temperature or 1.0,
                             seed=args.seed, device=device, session=session)
        t0 = time.perf_counter()
        done = engine.generate(requests)
        if device.type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        session.flush()          # settle any spans still in flight
    n = sum(len(r.out) for r in done)
    where = torch.cuda.get_device_name(0) if device.type == "cuda" \
        else "cpu"
    print(f"{cfg.name}{' (reduced)' if args.reduced else ''} on {where} "
          f"[{args.mode}]: {len(done)} requests, {n} tokens in {dt:.3f}s "
          f"= {n / dt:.1f} tokens/s (wall clock, first call included)")
    st = engine.stats()
    what = "whole-prompt prefills" if not engine.prefill_chunk \
        or args.mode == "wave" else "chunks"
    line = (f"stall p95 {stall_p95(engine.stall_events) * 1e3:.2f} ms over "
            f"{len(engine.stall_events)} {what}")
    if args.request_deadline_s is not None:
        line += f", {st['requests_timed_out']} timed out"
    print(line)
    for line in energy_report(energy.records, n, backends):
        print(line)
    kc = st["kv_cache"]
    print(f"kv cache: {kc['cache_dtype']}, "
          f"{kc['bytes_per_token']:.1f} B/token")
    if args.kv_layout == "paged":
        print(kv_pool_line(kc))
    for i, r in enumerate(done):
        print(f"  req{i}: prompt {len(r.prompt)} -> {len(r.out)} tokens "
              f"({r.finish_reason})")


if __name__ == "__main__":
    main()
