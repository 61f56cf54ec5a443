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
       [--no-prefix-cache] [--preempt] [--preempt-max-retries 8] \
       [--retry-backoff-s 0] [--swap-bytes B] [--retry-errors] \
       [--watchdog-step-timeout-s S]] [--num-layers N] [--no-moe] \
      [--power-cap-watts W] [--tenant-quota J] [--signal-ttl-s S] \
      [--governor-fail-mode {closed,open}] [--pool-reserve-frac F] \
      [--telemetry-port P] [--supervise]

  # hold the run under 300 W and watch it live:
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --power-cap-watts 300 --telemetry-port 8321
  curl -N http://127.0.0.1:8321/stream        # live SSE record feed
  curl http://127.0.0.1:8321/timeline         # power series

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
scales) and each request's token count.  With ``--kv-layout paged`` it
also prints the page pool's use and the prefix cache's hits (the ``kv
pool:`` line), and, with ``--preempt`` or where a step was quarantined or
flagged hung, the preemption plane's counters (the ``preemption:``
line; ``--swap-bytes`` adds the swap store's).

The energy control plane, as in the JAX launcher: a ``PowerRecorder``
attached to the session (records and watts timelines) and the engine
(its stats and preemption-plane events); with ``--power-cap-watts`` or
``--tenant-quota`` (continuous mode) a ``PowerGovernor`` reading the
recorder's window, whose decisions close the stall line; with
``--telemetry-port`` a ``TelemetryServer`` on 127.0.0.1 (0: an
ephemeral port, printed).  ``--supervise`` wraps each backend in a
``SensorSupervisor`` with a 0 W dummy behind it.

``--num-layers`` and ``--no-moe`` override the config: ``--arch
deepseek-v3-671b --num-layers 3 --no-moe`` is the published model's
three leading dense MLA layers at full width (its MoE layers come with a
later slice: with them the launcher raises before any weights are
built; its MTP head's weights are built and not read).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

import repro_torch.core as pmt
from repro_torch import configs
from repro_torch.core.backends.dummy import DummySensor
from repro_torch.core.supervisor import SensorSupervisor
from repro_torch.device import resolve_device
from repro_torch.models import model as model_mod
from repro_torch.serve.engine import Request, ServeEngine, stall_p95
from repro_torch.serve.governor import PowerGovernor
from repro_torch.serve.swap import PageSwapStore
from repro_torch.telemetry import PowerRecorder, TelemetryServer


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


def preemption_line(pre: dict) -> str:
    """The JAX launcher's ``preemption:`` line from
    ``stats()["preemption"]``."""
    line = (f"preemption: {pre['preemptions']} preempted, "
            f"{pre['resumes']} resumed "
            f"({pre['recovered_tokens']} tokens recovered "
            f"~{pre['recovered_joules']:.2f} J, "
            f"{pre['wasted_tokens']} re-run "
            f"~{pre['wasted_joules']:.2f} J wasted), "
            f"{pre['retries_exhausted']} retries exhausted, "
            f"{pre['quarantined']} quarantined, "
            f"{pre['hung_steps']} hung steps")
    if "swap" in pre:
        sw = pre["swap"]
        line += (f"; swap: {sw['swapped_out_pages']} pages out / "
                 f"{sw['swapped_in_pages']} in, "
                 f"{sw['bytes_used']} B held, "
                 f"{sw['rejected_puts']} rejected")
    return line


def governor_report(st: dict, window_watts) -> str:
    """The JAX launcher's governor clause from ``stats()["governor"]``
    and the recorder's window watts."""
    watts = window_watts if window_watts is None \
        else round(window_watts, 1)
    line = (f"governor: {st['throttle_decisions']} throttle decisions "
            f"{st['throttle_actions']}, {st['pause_total_s'] * 1e3:.1f} ms "
            f"paused, window {watts} W vs cap {st['cap_watts']} W")
    if st["tenant_joules"]:
        line += f", tenant J {st['tenant_joules']}"
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
    ap.add_argument("--preempt", action="store_true",
                    help="preemption and resume (paged layout): on pool "
                         "exhaustion the lowest-priority live request is "
                         "preempted page-aligned, its written pages parked "
                         "in the radix tree (or host swap, see "
                         "--swap-bytes), and it resumes through chunked "
                         "prefill once pressure clears")
    ap.add_argument("--preempt-max-retries", type=int, default=8,
                    help="preemptions a request survives before retiring "
                         "with reason 'preempted-retry-exhausted'")
    ap.add_argument("--retry-backoff-s", type=float, default=0.0,
                    help="base of the exponential re-admission backoff "
                         "for preempted or quarantined requests (0 = "
                         "immediate retry)")
    ap.add_argument("--swap-bytes", type=int, default=None,
                    help="host-memory swap budget for preempted pages "
                         "(bytes); unset = radix-tree checkpoints only")
    ap.add_argument("--retry-errors", action="store_true",
                    help="restart NaN/Inf-quarantined requests from "
                         "scratch (bounded by --preempt-max-retries) "
                         "instead of retiring them with reason 'error'")
    ap.add_argument("--watchdog-step-timeout-s", type=float, default=None,
                    help="engine watchdog (paged layout): a fenced device "
                         "step slower than this counts a hung step and "
                         "emits an event")
    ap.add_argument("--pool-reserve-frac", type=float, default=0.0,
                    help="governor admission veto when the page pool's "
                         "free fraction drops below this reserve; acts "
                         "only with --kv-layout paged and a governor "
                         "(--power-cap-watts or --tenant-quota): the "
                         "contiguous layout reports no pool (0 disables)")
    ap.add_argument("--power-cap-watts", type=float, default=None,
                    help="hold measured window power under this budget "
                         "via the PowerGovernor (admission gating, "
                         "prefill-chunk pacing, decode duty-cycling); "
                         "continuous mode only")
    ap.add_argument("--tenant-quota", type=float, default=None,
                    help="per-tenant joules quota: requests round-robin "
                         "over two synthetic tenants, and an over-quota "
                         "tenant yields admission priority to in-quota "
                         "ones (soft: never starved)")
    ap.add_argument("--signal-ttl-s", type=float, default=None,
                    help="governor power-signal freshness budget: when "
                         "the newest watts sample is older than this the "
                         "signal is stale and the governor degrades per "
                         "--governor-fail-mode")
    ap.add_argument("--governor-fail-mode", default="closed",
                    choices=["closed", "open"],
                    help="stale-signal policy: closed = stop admitting and "
                         "zero the prefill budget until the signal "
                         "recovers (protects the power budget); open = "
                         "run unthrottled (protects availability)")
    ap.add_argument("--supervise", action="store_true",
                    help="wrap each backend in a SensorSupervisor with a "
                         "0 W dummy fallback: reads get deadline, retry "
                         "and circuit-breaker protection and fail over "
                         "instead of killing the sampler thread")
    ap.add_argument("--telemetry-port", type=int, default=None,
                    help="serve live telemetry on this HTTP port of "
                         "127.0.0.1 (/timeline /requests /stats /health "
                         "/stream SSE); 0 = ephemeral (printed)")
    ap.add_argument("--num-layers", type=int, default=None,
                    help="override the config's layer count")
    ap.add_argument("--no-moe", action="store_true",
                    help="drop the config's MoE (every layer dense)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    overrides = {}
    if args.num_layers is not None:
        overrides["num_layers"] = args.num_layers
    if args.no_moe:
        overrides["moe"] = None
    cfg = configs.get_config(args.arch, reduced=args.reduced, **overrides)
    model_mod.unit_layout(cfg)  # what the port does not serve raises here
    params = model_mod.init_params(cfg, seed=args.seed, device=device)
    rng = np.random.default_rng(args.seed)
    max_prompt = max(1, min(args.max_len // 2,
                            args.max_len + 1 - args.max_new))
    deadline = args.request_deadline_s if args.mode == "continuous" \
        else None
    tenants = args.tenant_quota is not None
    requests = [Request(prompt=rng.integers(
        0, cfg.vocab_size, int(rng.integers(1, max_prompt + 1))).tolist(),
        max_new_tokens=args.max_new, deadline_s=deadline,
        tenant=f"tenant{i % 2}" if tenants else None)
        for i in range(args.requests)]
    backends = ["cpuutil", "nvml"] if device.type == "cuda" \
        else ["cpuutil"]
    sensors = backends
    if args.supervise:
        # a fail-safe chain a backend: the real sensor first, a 0 W dummy
        # last, so that a dead backend degrades the measurements instead
        # of the run
        sensors = [SensorSupervisor([pmt.create(name),
                                     DummySensor(watts=0.0)],
                                    deadline_s=0.25)
                   for name in backends]
    swap_store = None
    if args.swap_bytes is not None:
        swap_store = PageSwapStore(capacity_bytes=args.swap_bytes)
    governor = server = health = None
    with pmt.Session(sensors) as session:
        energy = session.add_exporter(pmt.MemoryExporter())
        # the control plane: the recorder gathers records and watts
        # timelines, the governor (capped or with quotas) reads its window,
        # the HTTP server (if asked for) serves both live
        recorder = PowerRecorder().attach(session, exporter=energy)
        try:
            if (args.power_cap_watts is not None or tenants) \
                    and args.mode == "continuous":
                governor = PowerGovernor(
                    recorder, cap_watts=args.power_cap_watts,
                    tenant_quota_j=args.tenant_quota,
                    signal_ttl_s=args.signal_ttl_s,
                    fail_mode=args.governor_fail_mode,
                    pool_reserve_frac=args.pool_reserve_frac)
            if args.telemetry_port is not None:
                server = TelemetryServer(recorder,
                                         port=args.telemetry_port).start()
                print(f"telemetry: {server.url} "
                      f"(/timeline /requests /stats /health /stream)")
            engine = ServeEngine(
                cfg, params, batch_size=args.batch, max_len=args.max_len,
                mode=args.mode, decode_attn_impl=args.decode_attn_impl,
                prefill_chunk=args.prefill_chunk, governor=governor,
                kv_layout=args.kv_layout, kv_page_size=args.kv_page_size,
                kv_pool_pages=args.kv_pool_blocks,
                prefix_cache=args.prefix_cache,
                cache_dtype=args.cache_dtype, preempt=args.preempt,
                preempt_max_retries=args.preempt_max_retries,
                retry_backoff_s=args.retry_backoff_s,
                retry_errors=args.retry_errors, swap_store=swap_store,
                watchdog_step_timeout_s=args.watchdog_step_timeout_s,
                greedy=args.temperature <= 0.0,
                temperature=args.temperature or 1.0,
                seed=args.seed, device=device, session=session)
            recorder.attach_engine(engine)
            t0 = time.perf_counter()
            done = engine.generate(requests)
            if device.type == "cuda":
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            session.flush()          # settle any spans still in flight
            recorder.poll_once()     # the last watts into the timeline
            if args.supervise:
                health = recorder.health()
        finally:
            if server is not None:
                server.close()
            if governor is not None:
                governor.close()
            recorder.close()
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
    if governor is not None:
        line += "; " + governor_report(
            st["governor"], recorder.mean_watts(governor.window_s))
    print(line)
    for line in energy_report(energy.records, n, backends):
        print(line)
    kc = st["kv_cache"]
    print(f"kv cache: {kc['cache_dtype']}, "
          f"{kc['bytes_per_token']:.1f} B/token")
    if args.kv_layout == "paged":
        print(kv_pool_line(kc))
        pre = st["preemption"]
        if pre["enabled"] or pre["quarantined"] or pre["hung_steps"]:
            print(preemption_line(pre))
    if health is not None:
        print(f"measurement plane: {health['state']} "
              f"({health['health_events']} health transitions)")
    for i, r in enumerate(done):
        print(f"  req{i}: prompt {len(r.prompt)} -> {len(r.out)} tokens "
              f"({r.finish_reason})")


if __name__ == "__main__":
    main()
