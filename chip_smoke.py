"""Drive the PyTorch/CUDA port on one card and check it end to end.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero:
  1. require a CUDA card; print ``nvidia-smi --query-gpu=name,power.limit``.
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc``.
  3. hold each kernel against its plain PyTorch version on the card, at
     the serve path's shapes and at odd sizes, in fp32 and bf16, with the
     tolerances stated below; time kernel, plain version, one library
     call doing the same work, and the least time the card could take.
  4. small reference: reduced smollm-135m in fp32 on the card (kernels)
     against the same model on the CPU (plain versions).
  5. serve full-width smollm-135m (random weights from a seed, bf16) for
     16 requests through the continuous-batching engine with chunked
     prefill, twice (the second run gives the spread); check every
     request's tokens, finite logits, and that every kernel's launch
     count grew; print tokens/s, stall p95 and the card's joules per
     generated token (NVML); then a short run under the profiler.
  6. print the ``{"kernels": [...]}`` line, then the final
     ``{"ok": true, "device": {...}}`` line.

Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,           # dense tensor-core bf16
              torch.float32: 67e12}             # fp32 outside tensor cores
# Tolerances of kernel against plain version on the same inputs.  Both
# compute in fp32 from the same values; they differ in summation order
# (~1e-6 on outputs of order 1, hence 2e-5 in fp32) and, in bf16, by at
# most one bf16 rounding step of outputs below 4 in magnitude (2^-6).
TOL = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -6 + 2e-5}
KERNEL_INFO = {
    "cache_update": ("src/repro_torch/kernels/csrc/cache_update.cu",
                     "src/repro/kernels/cache_update/cache_update.py:105"),
    "prefill_attention": (
        "src/repro_torch/kernels/csrc/prefill_attention.cu",
        "src/repro/kernels/prefill_attention/prefill_attention.py:323"),
    "decode_attention": (
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention/decode_attention.py:272"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, from CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_time(fn):
    """``time_ms`` of a library yardstick, or None (with the reason
    printed) where this PyTorch build lacks the call."""
    try:
        return time_ms(fn)
    except (TypeError, RuntimeError) as exc:
        log(f"  library call unavailable: {exc}")
        return None


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


# -- phase 3: kernels against their plain versions ---------------------------

def check_cache_update(kernel, ref, dev):
    results = {}
    for name, (b, c, f) in {"main B8 C1024 F192": (8, 1024, 192),
                            "odd B5 C77 F51": (5, 77, 51)}.items():
        for dt in (torch.float32, torch.bfloat16):
            g = torch.Generator(device=dev).manual_seed(1)
            cache = torch.randn((b, c, f), generator=g, device=dev).to(dt)
            new = torch.randn((b, 1, f), generator=g, device=dev).to(dt)
            slots = torch.randint(0, c, (b,), generator=g, device=dev,
                                  dtype=torch.int32)
            slots[0], slots[-1] = 0, c - 1
            want = ref.cache_update_ref(cache.clone(), new, slots)
            got = kernel.cache_update_cuda(cache.clone(), new, slots)
            torch.cuda.synchronize()
            err = max_err(got, want)
            log(f"  cache_update {name} {str(dt)[6:]}: max |err| {err} "
                f"(must be 0: a copy)")
            if err != 0.0:
                raise AssertionError("cache_update disagrees with its plain "
                                     "version")
            if name.startswith("main") and dt == torch.bfloat16:
                el = cache.element_size()
                idx = (torch.arange(b, device=dev) * c + slots.long())
                flat, rows = cache.view(b * c, f), new.view(b, f)
                t = {
                    "ms": time_ms(lambda: kernel.cache_update_cuda(
                        cache, new, slots), iters=200),
                    "plain_ms": time_ms(lambda: ref.cache_update_ref(
                        cache, new, slots), iters=200),
                    "library_ms": time_ms(lambda: flat.index_copy_(
                        0, idx, rows), iters=200),
                }
                t["bound_ms"], t["bound_by"] = bound(
                    2 * b * f * el + 4 * b, 0.0, dt)
                results = dict(t, max_abs_err=err)
    return results


def _decode_inputs(dev, dt, b, c, kvh, g, hd, seed=2):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, kvh, g, hd), generator=gen, device=dev).to(dt)
    k = torch.randn((b, c, kvh, hd), generator=gen, device=dev).to(dt)
    v = torch.randn((b, c, kvh, hd), generator=gen, device=dev).to(dt)
    return q, k, v


def check_decode(kernel, ref, dev):
    cases = {
        "main B8 C1024 KVH3 G3 hd64": dict(
            b=8, c=1024, kvh=3, g=3, hd=64,
            lens=[0, 1, 511, 1023, 37, 300, 700, 1000], ring=False,
            softcap=None),
        "ring C256 wrapped": dict(
            b=8, c=256, kvh=3, g=3, hd=64,
            lens=[0, 1, 100, 255, 256, 300, 1000, 5000], ring=True,
            softcap=None),
        "softcap 30": dict(
            b=8, c=1024, kvh=3, g=3, hd=64,
            lens=[0, 1, 511, 1023, 37, 300, 700, 1000], ring=False,
            softcap=30.0),
        "odd B3 C1000 KVH2 G4 hd48": dict(
            b=3, c=1000, kvh=2, g=4, hd=48, lens=[0, 999, 517],
            ring=False, softcap=None),
    }
    results = {}
    for name, cs in cases.items():
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = _decode_inputs(dev, dt, cs["b"], cs["c"], cs["kvh"],
                                     cs["g"], cs["hd"])
            lens = torch.tensor(cs["lens"], dtype=torch.int32, device=dev)
            scale = 1.0 / math.sqrt(cs["hd"])
            kw = dict(ring=cs["ring"], softcap=cs["softcap"], scale=scale)
            got = kernel.decode_attention_cuda(q, k, v, lens, **kw)
            want = ref.decode_attention_ref(q, k, v, lens, **kw)
            torch.cuda.synchronize()
            err = max_err(got, want)
            log(f"  decode_attention {name} {str(dt)[6:]}: max |err| "
                f"{err:.3g} (tol {TOL[dt]:.3g})")
            if not err <= TOL[dt]:
                raise AssertionError("decode_attention disagrees with its "
                                     "plain version")
            if name.startswith("main") and dt == torch.bfloat16:
                b, c, kvh, g, hd = (cs[x] for x in ("b", "c", "kvh", "g",
                                                     "hd"))
                el = k.element_size()
                keys = sum(min(n, c - 1) + 1 for n in cs["lens"])
                nbytes = keys * kvh * 2 * hd * el + 2 * q.numel() * el \
                    + 4 * b
                flops = keys * kvh * g * 4 * hd
                qh = q.view(b, kvh * g, 1, hd)
                kh, vh = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
                mask = (torch.arange(c, device=dev)[None, :]
                        <= lens[:, None]).view(b, 1, 1, c)
                t = {
                    "ms": time_ms(lambda: kernel.decode_attention_cuda(
                        q, k, v, lens, **kw)),
                    "plain_ms": time_ms(lambda: ref.decode_attention_ref(
                        q, k, v, lens, **kw), iters=5),
                    "library_ms": library_time(
                        lambda: F.scaled_dot_product_attention(
                            qh, kh, vh, attn_mask=mask, scale=scale,
                            enable_gqa=True)),
                }
                t["bound_ms"], t["bound_by"] = bound(nbytes, flops, dt)
                results = dict(t, max_abs_err=err)
    return results


def _prefill_inputs(dev, dt, b, t, c, kvh, g, hd, seed=3):
    gen = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=gen, device=dev).to(dt)
    return (mk(b, kvh, t, g, hd), mk(b, t, kvh, hd), mk(b, t, kvh, hd),
            mk(b, c, kvh, hd), mk(b, c, kvh, hd))


def check_prefill(kernel, ref, dev):
    cases = {
        "main B8 T32 C1024 KVH3 G3 hd64": dict(
            b=8, t=32, c=1024, kvh=3, g=3, hd=64,
            offs=[0, 1, 512, 1023, 32, 300, 700, 960], ring=False,
            window=None, softcap=None),
        "serve path B1 T32 C1024 off512": dict(
            b=1, t=32, c=1024, kvh=3, g=3, hd=64, offs=[512], ring=False,
            window=None, softcap=None),
        "ring C256 window256 wrapped": dict(
            b=8, t=32, c=256, kvh=3, g=3, hd=64,
            offs=[0, 5, 255, 256, 300, 1000, 64, 129], ring=True,
            window=256, softcap=None),
        "softcap 30": dict(
            b=8, t=32, c=1024, kvh=3, g=3, hd=64,
            offs=[0, 1, 512, 1023, 32, 300, 700, 960], ring=False,
            window=None, softcap=30.0),
        "odd B2 T17 C333 KVH2 G5 hd40": dict(
            b=2, t=17, c=333, kvh=2, g=5, hd=40, offs=[0, 200], ring=False,
            window=None, softcap=None),
    }
    results = {}
    for name, cs in cases.items():
        for dt in (torch.float32, torch.bfloat16):
            b, t, c, kvh, g, hd = (cs[x] for x in ("b", "t", "c", "kvh", "g",
                                                   "hd"))
            q, kx, vx, kc, vc = _prefill_inputs(dev, dt, b, t, c, kvh, g, hd)
            offs = torch.tensor(cs["offs"], dtype=torch.int32, device=dev)
            scale = 1.0 / math.sqrt(hd)
            kw = dict(ring=cs["ring"], window=cs["window"],
                      softcap=cs["softcap"], scale=scale)
            got = kernel.prefill_attention_cuda(q, kx, vx, kc, vc, offs, **kw)
            want = ref.prefill_attention_ref(q, kx, vx, kc, vc, offs, **kw)
            torch.cuda.synchronize()
            err = max_err(got, want)
            log(f"  prefill_attention {name} {str(dt)[6:]}: max |err| "
                f"{err:.3g} (tol {TOL[dt]:.3g})")
            if not err <= TOL[dt]:
                raise AssertionError("prefill_attention disagrees with its "
                                     "plain version")
            if name.startswith("serve path") and dt == torch.bfloat16:
                off = cs["offs"][0]
                el = kc.element_size()
                nbytes = (min(off, c) + t) * kvh * 2 * hd * el \
                    + 2 * q.numel() * el + 4 * b
                pairs = t * min(off, c) + t * (t + 1) // 2
                flops = pairs * kvh * g * 4 * hd
                h = kvh * g
                qh = q.permute(0, 1, 3, 2, 4).reshape(b, h, t, hd)
                kall = torch.cat([kc[:, :off], kx], 1).permute(0, 2, 1, 3)
                vall = torch.cat([vc[:, :off], vx], 1).permute(0, 2, 1, 3)
                mask = torch.ones((t, off + t), dtype=torch.bool, device=dev)
                mask[:, off:] = torch.tril(mask[:, off:])
                tm = {
                    "ms": time_ms(lambda: kernel.prefill_attention_cuda(
                        q, kx, vx, kc, vc, offs, **kw)),
                    "plain_ms": time_ms(lambda: ref.prefill_attention_ref(
                        q, kx, vx, kc, vc, offs, **kw), iters=5),
                    "library_ms": library_time(
                        lambda: F.scaled_dot_product_attention(
                            qh, kall, vall, attn_mask=mask, scale=scale,
                            enable_gqa=True)),
                }
                tm["bound_ms"], tm["bound_by"] = bound(nbytes, flops, dt)
                results = dict(tm, max_abs_err=err)
    return results


# -- phase 4: small reference ---------------------------------------------------

def check_small_reference(configs, model_mod, ServeEngine, Request):
    """Reduced smollm-135m, fp32: serve steps on the card (kernels)
    against the same steps on the CPU (plain versions), and the engine's
    greedy tokens on both."""
    cfg = dataclasses.replace(configs.get_config("smollm-135m", reduced=True),
                              dtype="float32")
    params = model_mod.init_params(cfg, seed=0, device="cpu")
    fns = model_mod.make_serve_fns(cfg)
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 24)))
    out = {}
    for dev in ("cpu", "cuda"):
        p = model_mod.serving_params(cfg, params, dev)
        caches = model_mod.init_caches(cfg, 2, 64, torch.float32, dev)
        lp = [fns.prefill_chunk(p, caches, toks[:, o:o + 8].to(dev), o, 7)
              for o in (0, 8, 16)]
        cur = torch.tensor([24, 24], dtype=torch.int32, device=dev)
        ld = fns.decode(p, caches, toks[:, -1:].to(dev), cur)
        out[dev] = [x.cpu() for x in lp + [ld]]
    err = max(max_err(a, b) for a, b in zip(out["cpu"], out["cuda"]))
    log(f"  reduced fp32 prefill_chunk + decode logits, card vs CPU: "
        f"max |err| {err:.3g} (tol 1e-4: fp32 sums in other orders)")
    if not err <= 1e-4:
        raise AssertionError("serve steps on the card disagree with the CPU")
    mix = [([1, 2, 3], 8), ([4, 5], 3), ([6], 1),
           ([7, 8, 9, 10, 11, 12, 13, 14, 15], 5), ([2], 12)]
    runs = {}
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(cfg, params, batch_size=2, max_len=64,
                          prefill_chunk=4, cache_dtype=torch.float32,
                          device=dev)
        runs[dev] = [r.out for r in eng.generate(
            [Request(prompt=p, max_new_tokens=n) for p, n in mix])]
    log(f"  reduced fp32 engine greedy tokens, card vs CPU: "
        f"{'equal' if runs['cpu'] == runs['cuda'] else 'DIFFERENT'}")
    if runs["cpu"] != runs["cuda"]:
        raise AssertionError(f"engine tokens differ: {runs}")


# -- phase 5: serve at full width --------------------------------------------------

def serve_full(configs, model_mod, ServeEngine, Request, kernels, nvml):
    """Serve the 16 requests twice on one engine: the first run is the
    main path's (its launch counts go into the ``kernels`` line), the
    second measures the spread of tokens/s and J/token on this card."""
    cfg = configs.get_config("smollm-135m")
    params = model_mod.init_params(cfg, seed=0, device="cuda")
    eng = ServeEngine(cfg, params, batch_size=8, max_len=1024,
                      prefill_chunk=32, cache_dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    warm = [Request(prompt=rng.integers(0, cfg.vocab_size, 40).tolist(),
                    max_new_tokens=4) for _ in range(2)]
    eng.generate(warm)
    torch.cuda.synchronize()
    lengths = rng.permutation(np.linspace(64, 700, 16).astype(int))
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lengths]
    log(f"  prompts {int(lengths.min())}-{int(lengths.max())} tokens, "
        f"64 new tokens each")
    reader = nvml.NvmlReader(0)
    try:
        log(f"  NVML: {reader.name()}, enforced power limit "
            f"{reader.power_limit_watts():.0f} W, now "
            f"{reader.power_watts():.0f} W")
        runs = [served_run(eng, Request, prompts, kernels,
                           nvml.EnergyMeter(reader), i) for i in (1, 2)]
    finally:
        reader.close()
    trace_serve(eng, cfg, Request, rng)
    return runs[0]


def served_run(eng, Request, prompts, kernels, meter, index):
    """One timed, metered serve run with every launch count set to 0
    just before it; checks its output and returns the counts read just
    after it."""
    reqs = [Request(prompt=p, max_new_tokens=64) for p in prompts]
    for mod in kernels.values():
        mod.launches = 0
    meter.start()
    t0 = time.perf_counter()
    done = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    joules = meter.stop()
    launches = {name: mod.launches for name, mod in kernels.items()}
    bad = [(r.id, len(r.out), r.finish_reason) for r in done
           if len(r.out) != 64 or r.finish_reason != "length"]
    if bad:
        raise AssertionError(f"requests without 64 tokens: {bad}")
    nonfinite = eng.nonfinite_logit_rows
    if nonfinite:
        raise AssertionError(f"{nonfinite} logit rows held NaN or Inf")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"serve path")
    gen = sum(len(r.out) for r in done)
    st = eng.stats()
    log(f"  run {index}: {len(done)} requests, {gen} generated tokens in "
        f"{wall:.3f} s: {gen / wall:.1f} tokens/s; stall p95 "
        f"{st['stall_p95_s'] * 1e3:.2f} ms over {st['stall_events']} "
        f"chunks; energy {joules:.1f} J ({meter.method}): "
        f"{joules / gen:.4f} J per generated token")
    log(f"  run {index}: kernel launches {launches}")
    return launches


def trace_serve(eng, cfg, Request, rng):
    """Where the time goes: a short serve run (8 requests, 256-token
    prompts, 32 new tokens) under ``torch.profiler``; prints the device
    busy share of the wall clock and the kernels by device time.  The
    profiler slows the host, so the busy share is a lower bound.  A
    measurement only: it prints why when the profiler sees no device."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, 256).tolist(),
                    max_new_tokens=32) for _ in range(8)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.generate(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Device rows only (kernels, copies): a host op's row repeats the
    # device time of the kernels it launched, so summing every row
    # would count that time twice.
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not e.is_user_annotation]
    busy_us = sum(t for _, t, _ in rows)
    if busy_us <= 0:
        log("  trace: the profiler recorded no device time")
        return
    log(f"  trace: wall {wall * 1e3:.1f} ms, device busy "
        f"{busy_us / 1e3:.1f} ms ({100 * busy_us / 1e6 / wall:.1f}% of "
        f"wall, under the profiler)")
    for key, t, n in sorted(rows, key=lambda r: -r[1])[:10]:
        log(f"    {t / 1e3:9.2f} ms  {n:6d} calls  {key[:90]}")
    for key, t, n in rows:
        if any(name in key for name in ("scatter_rows_kernel",
                                        "decode_attention_kernel",
                                        "prefill_attention_kernel")):
            log(f"  trace: {t / max(n, 1):.2f} us of device time per "
                f"launch, {n} launches: {key[:70]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs on "
              "the card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.core.backends import nvml
    from repro_torch.kernels import build
    from repro_torch.kernels.cache_update import kernel as cu_kernel
    from repro_torch.kernels.cache_update import ref as cu_ref
    from repro_torch.kernels.decode_attention import kernel as da_kernel
    from repro_torch.kernels.decode_attention import ref as da_ref
    from repro_torch.kernels.prefill_attention import kernel as pa_kernel
    from repro_torch.kernels.prefill_attention import ref as pa_ref
    from repro_torch.models import model as model_mod
    from repro_torch.serve.engine import Request, ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")

    t0 = time.perf_counter()
    build.library()
    log(f"[2] kernels built and loaded in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {build.build_seconds if build.build_seconds is not None else 'cached'})")

    dev = torch.device("cuda")
    log("[3] kernels against their plain versions")
    timings = {
        "cache_update": check_cache_update(cu_kernel, cu_ref, dev),
        "prefill_attention": check_prefill(pa_kernel, pa_ref, dev),
        "decode_attention": check_decode(da_kernel, da_ref, dev),
    }
    for name, t in timings.items():
        lib = "n/a" if t["library_ms"] is None else f"{t['library_ms']:.4f}"
        log(f"  {name}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} "
            f"ms, library {lib} ms, bound {t['bound_ms']:.5f} ms "
            f"({t['bound_by']})")

    log("[4] small reference: reduced smollm-135m fp32, card vs CPU")
    check_small_reference(configs, model_mod, ServeEngine, Request)

    log("[5] serve full-width smollm-135m, 16 requests, 8 slots, "
        "max_len 1024, chunk 32, bf16")
    kernels = {"cache_update": cu_kernel, "prefill_attention": pa_kernel,
               "decode_attention": da_kernel}
    launches = serve_full(configs, model_mod, ServeEngine, Request, kernels,
                          nvml)

    rows = []
    for name, t in timings.items():
        source, replaces = KERNEL_INFO[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"]})
    log("[6] results")
    log(card)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
