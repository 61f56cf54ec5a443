"""Drive the PyTorch/CUDA port on one card and check it end to end.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero:
  1. require a CUDA card; print ``nvidia-smi --query-gpu=name,power.limit``.
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc``.
  3. hold each kernel against its plain PyTorch version on the card, at
     the serve path's shapes and at odd sizes, in fp32 and bf16, with the
     tolerances stated below; time kernel, plain version, one library
     call doing the same work, and the least time the card could take;
     the four scatters (contiguous, paged, and their quantizing twins)
     also with the host out of the loop: 100 calls in one CUDA graph,
     the kernel and, where there is one, its ``index_copy_`` yardstick;
     the two copying scatters one leaf and a layer's k and v in one
     launch, exactly, at the serve shapes, F 51 and views one element off
     their alignment (the paged one also with ``valids`` None), the pair
     timed beside two one-leaf launches, two ``index_copy_`` calls, an
     empty kernel (``csrc/empty.cu``: the floor of a launch, at one block
     of 32 threads and at the pair's grid) and the two leaves' byte
     bound, the ``kernels`` line's rows 1 and 4 marked ``leaves: 2``;
     likewise flash-decode (rows 3 and 7, SDPA beside row 3), also at
     its split-KV edges (one long row alone, every row at 0, a wrapped
     ring, ranges ending on split shares, a paged batch of dead rows:
     exactly 0), its shared memory held to the wrapper's ``smem_bytes``,
     and its split count swept 1..16 at B1 and B8 (rows 3, 7).
     3b. the same for the six Fig. 2 kernels (FMA32, STREAM, GRIDDER,
     DEGRIDDER, GEMM, JACOBI2D) at the Fig. 2 path's shapes and at odd
     ones (STREAM and JACOBI2D also at ragged sizes and one element off
     their alignment, exactly, JACOBI2D beside ``x.clone()``; the gridder
     pair also one float off its alignment and with phases at 4 pi and
     32 pi), with the gridder pair's adjoint identity on the card and its
     bound from the FP32 operations and SFU instructions counted in the
     built loop (``cuobjdump -sass``); the kernels redesigned for Hopper
     (bf16 prefill on ``mma.sync``, the f32 GEMM and flash-decode on the
     CUDA cores, the STREAM triad, the gridder's and the degridder's
     phasor on the SFU, JACOBI2D's and the copying scatters' 16-byte
     loads and stores, the quantizing scatters' lane groups, MLA's
     prefill chunk on wgmma fed by TMA) gated on their SASS and on 0
     bytes of ptxas spill.
     The three paged kernels (paged cache_update, decode and prefill
     attention) the same way, at the paged serve path's shapes and at
     odd ones (page sizes 8 and 24, shuffled pages, a window, softcap,
     masked rows, dead rows past their table); the scatter exact outside
     the scratch page 0, real pages untouched where rows are masked.
     3q. quantized KV caches, int8 and fp8_e4m3: the two quantizing
     scatters (contiguous, paged) bit for bit equal to their plain
     versions in codes and scales, one leaf and a layer's k and v in one
     launch, over bf16 and fp32 rows with zero rows and +-1e4 extremes,
     at the serve shapes (decode B8 T1, the contiguous chunk B1 T32
     C1024, paged decode, a paged chunk with masked rows), odd ones and
     views off their alignment, no NaN, real pages untouched where rows
     are masked; the pair call timed at the serve shapes on rows
     without a zero vector, checked bit for bit too (CUDA events and a
     CUDA graph, beside two one-leaf launches) with the two leaves' byte
     bound, the ``kernels`` line's rows 5 and 6 marked ``leaves: 2``;
     the contiguous one also writing a whole prompt's T 1024 rows at
     offset 0 into 2048 slots (batch 1 and 8: phase 5w's prefill), timed
     likewise (``serve_prefill`` in row 5);
     the four attention kernels over codes and row
     scales against their plain versions with the same tolerances and
     cases as above; each timed with its byte bound at code width (the
     decode kernel's also in a CUDA graph).
     3v. MLA's aliased latent cache (the ``v_width`` branch, rows 2v,
     3v, 7v, 8v): each attention kernel over one kv head whose rows are
     the keys and, their first hdv lanes, the values, over bf16, int8 and
     fp8_e4m3, at deepseek-v3's widths (G 128, hdq 576, hdv 512: decode
     B8 C1024, the chunk B1 T32 over a 512 prefix, their paged twins on a
     513 x 16 x 576 pool; ``csrc/latent_attention.cu``) and odd ones (G 3
     and 4 at hdq 24 / hdv 16 and 72 / 64, fp32 on the CUDA-core
     kernels), within TOL; a decode row with lens -1 exactly 0; each main
     case timed beside its byte and operation bounds and, contiguous
     bf16, SDPA over the expanded and sliced tensors; rows 1, 4, 5, 6 at
     F 576 through the one-leaf ops, bit for bit; the latent launcher's
     shared memory, splits and TMA rule against the library's (all four
     rows run ``latent_kernel``: wgmma fed by TMA, the splits folded
     across a cluster, its SASS gated in phase 3b).
     3f. the flash-attention kernel (the train path's) against
     ``flash_attention_ref`` at the train shapes (B 8, S 2048, 9 heads on
     3 kv heads, hd 64, bf16, causal) and at odd ones (fp32, GQA groups
     1, 3, 4, window, softcap, ragged S, Sq != Skv, hd 16/32/128, hd 128
     with no window; in bf16 also scores reaching |s| ~50), in bf16 also
     elementwise against the fp32 oracle within one bf16 rounding, and
     the op's gradients against the oracle's; the bf16 kernels' SASS
     (``cuobjdump -sass``) must hold HGMMA and UTMALDG (tensor cores fed
     by TMA), the fp32 ones no HGMMA; the bf16 kernels' shared memory
     (``pmt_flash_smem_bytes``) must equal the wrapper's ``smem_bytes``;
     timed beside the plain version,
     ``scaled_dot_product_attention`` and its operation bound, with its
     TFLOP/s, share of the bound and factor against SDPA; the same gates
     and times at the serve path's whole-prompt prefill shapes (batch 1
     at S 8, 64, 512, 1024, batch 8 at S 1024; ``serve_prefill`` in row
     9).
  4. small reference: reduced smollm-135m in fp32 on the card (kernels)
     against the same model on the CPU (plain versions), contiguous and
     paged; the paged engine's greedy tokens on the card equal the
     contiguous engine's and the CPU's.  Then the same with int8 and
     fp8_e4m3 caches (logits within QUANT_CARD_EQUAL_CODES_TOL when
     every code agrees, else QUANT_CARD_TOL; codes at most one step
     apart, greedy tokens equal), and the drift gate of
     tests/test_quant_serve.py on the card.
     4m. reduced deepseek-v3 (``moe=None, mtp=False``), fp32: the
     engine's greedy tokens on the card equal the CPU's, contiguous
     chunked, paged (page 16), blocking and int8; the v_width rows
     launched.
     4w. the serve baselines, reduced fp32: blocking admission (fp32 and
     int8 caches), waves and the dense decode give the card's greedy
     tokens equal to the CPU's; the int8 blocking run's quantizing
     scatter once a layer a whole-prompt prefill and a decode step; a
     sampled run repeats its tokens under its seed and another seed
     differs.
  5. serve full-width smollm-135m (random weights from a seed, bf16) for
     16 requests through the continuous-batching engine with chunked
     prefill, twice (the second run gives the spread); check every
     request's tokens, finite logits, that every kernel's launch count
     grew, and that the scatter launched once a layer per decode step (k
     and v in one launch; the chunks' writes are copies), counted by
     wrapping the engine's serve steps (``count_steps``); print tokens/s,
     stall p95 and the card's joules per
     generated token (NVML), measured through a PMT session whose every
     request must have a resolved ``serve/req<N>`` record with
     ``/prefill`` + ``/decode`` within 1% of its total; then a short run
     under the profiler, and the launches one prefill chunk and one
     decode step issue.
     5b. the same model through the paged engine (page 16, the default
     pool of 512 usable pages), 16 requests sharing a 256-token system
     prompt, served cold then warm with the same checks (the paged
     scatter once a layer per decode step and per prefill chunk), plus:
     the paged kernels launched and the contiguous ones not, pool gauges
     that add up, the pages held after a run equal to the prefix tree's,
     prefix hits in both runs and priced saved prefill joules in the
     warm one; then a short run under the profiler.
     5p. the preemption plane on the paged path: (a) tests/
     test_serve_preempt.py's pressured mix through reduced fp32
     smollm-135m (pages of 8 and 16) and deepseek-v3 (``moe=None,
     mtp=False``, pages of 16) with ``preempt=True``, with a swap store
     and without, and smollm's swap path over int8 and fp8_e4m3 pools:
     greedy tokens, every ``preemption`` counter but the joules and the
     preempt log on the card equal to the CPU engine's, and over fp32
     pools tokens equal to the unpressured run's; (b) phase 5's 16
     requests (priorities 0 and 1 in turn) through full-width
     smollm-135m, paged (page 16, bf16) on a pool of 96 pages, once
     with a 1 GiB swap store and once with a swap budget of 0: phase 5's
     checks, preemptions >= 1 and as many resumes, no request retired
     ``"preempted-retry-exhausted"``, pool gauges that add up, an empty
     store, the paged kernels launched and the contiguous ones not;
     prints preemptions and resumes by destination and route, the swap
     copies' bytes, time and GB/s each way, the wasted and recovered
     tokens and joules and tokens/s beside the card's name and power
     limit (tokens against phase 5's logged, not gated); (c) one live
     row's decode logits turned NaN once: that request retires
     ``"error"``, its pages never reach the radix tree, the others give
     the clean tokens; a run with a watchdog of 1e-9 s a step completes
     and flags hung steps.
     5g. the power governor and the telemetry plane: (a) phase 5's run 2
     under an observer governor (no cap) over a ``PowerRecorder``
     attached to its session and engine: tokens equal to run 1's, the
     run's card watts and, at each decode step, the age of the newest
     nvml sample; (b) 8 of phase 5's requests on its engine under a cap
     halfway between the card's idle watts (after a 1 s sleep) and (a)'s:
     phase 5's checks, at least one decision, as many as
     ``stats()["governor"]`` counts, each a ``serve/governor/`` span; the
     window peak after the ramp and tokens/s logged beside the cap and
     phase 5; (c) 4 requests of 16 tokens under half the idle draw: every
     request served, forced admits, decode pauses; then 4 requests of 16
     tokens fail-closed at each of ``SIGNAL_TTLS`` (stale episodes and
     forced admits logged); (d) 8 of phase 5's requests paged on 5p's
     96 pages with ``preempt=True``, a 1 GiB swap store, no prefix
     cache, ``pool_reserve_frac`` 0.25 and one ``request_shed()``, under
     a fresh session with a ``TelemetryServer`` on 127.0.0.1 and an SSE
     client: phase 5's checks, the paged kernels only, a pool block or
     wait and a preemption after the shed, ``/stats`` with ``governor``,
     ``kv_cache`` and ``preemption``, ``/requests`` joules within 1% of
     the session's ``serve/req<N>`` records, ``record`` and ``preempt``
     events on ``/stream``.
     5c. phase 5's 16 requests, through ``PHASE_5C_LAYERS`` (10) of the
     model's 30 layers, once per quantized cache mode and layout
     (int8, fp8_e4m3; contiguous, paged at page 16 with the default
     512-page pool), each with phase 5's checks, plus: only that
     layout's three quantized kernels launched (the bf16 ones and the
     other layout's stayed at 0), the layout's quantizing scatter
     launched once a layer per decode step and per prefill chunk (k and
     v in one launch), ``stats()["kv_cache"]`` names the mode, and bytes
     per token under 0.6x phase 5's bf16 figure at that depth; the int8
     contiguous trace's busy time, launches, launches a prefill chunk and
     a decode step beside phase 5's bf16 ones.
     5m. phase 5's 16 requests through deepseek-v3's three dense MLA
     layers at full width (random bf16 weights from seed 0, 8 slots,
     max_len 1024, chunk 32) under ``Session(["cpuutil", "nvml"])``:
     contiguous and paged (page 16; served again warm, which must map
     prompt pages from the radix tree) over bf16, paged and contiguous
     over int8; phase 5's checks per run, each run's v_width rows and
     one-leaf scatter launched 3 times (once a layer) a decode step, a
     chunk or both, every other counter 0; the first decode step's logits
     through the kernel against the dense attend (MLA_LOGIT_TOL); one
     decode step's device time.
     5w. the serve baselines at full width: phase 5's 16 requests through
     smollm-135m (bf16 weights, attn_impl "pallas", 8 slots, max_len
     2048) under ``Session(["cpuutil", "nvml"])``, with blocking
     admission and in waves of 8 over a bf16 cache, then blocking over an
     int8 cache: phase 5's checks (a wave's ``serve/wave<N>`` regions in
     place of request spans), the flash kernel once a layer a
     whole-prompt prefill, flash decode once a layer a decode step, the
     scatter once a layer a step (the quantizing one also once a layer a
     prefill, T = the bucket at offset 0), no other serve kernel;
     tokens/s, J/token and stall p95 beside
     phase 5's chunked run; the first prefill's last logits through the
     kernel against the dense attend (BASELINE_LOGIT_TOL); one decode
     step's device time with the dense attend beside flash.
     5t. train full-width smollm-135m (bf16 on fp32 masters, AdamW,
     remat full, attn_impl pallas, batch 8 x 2048 from the synthetic
     pipeline): a warm-up step, then 20 steps through
     ``make_measured_train_step`` under a PowerMonitor on cpuutil +
     nvml; checks finite, falling losses, exactly 2 flash launches per
     layer per step (forward and recompute), per-step session joules
     within 10% of an independent meter, and the kernel's loss and grad
     norm against chunked attention at the initial and the trained
     weights; prints
     tokens/s, J/step, J/token and peak memory; traces one step; then
     the reduced fp32 model's train step on the card against the CPU,
     and a checkpoint restart on the card against the uninterrupted run
     under ``torch.use_deterministic_algorithms(True)`` (an op with no
     deterministic version raises).
  6. the paper's Fig. 2 (``repro_torch.launch.fig2``) at full size:
     SLEEP, FMA32, STREAM, GRIDDER, DEGRIDDER, GEMM, JACOBI2D, each one
     region of a PMT session stacking cpuutil and nvml, with the modeled
     card watts beside the measured; before it, a probe of which NVML
     quantity follows the card and a probe of the host sensors (``rapl``,
     ``sysfs``: present, readable, and host watts idle and under load
     where readable); checks that every Fig. 2 kernel's launch count
     grew, that every busy row's card watts exceed SLEEP's, and that each
     row's session joules are within 10% of an independent
     ``EnergyMeter`` reading of the same window.
  7. print the ``{"kernels": [...]}`` line (19 rows: the 15 kernels and
     rows 2v, 3v, 7v, 8v with their launches in phase 5m, the paged rows
     with their launches in phase 5p's swap run and rows 1-4, 7, 8 with
     phase 5g's (b) and (d) beside; the attention
     kernels with their quantized launches and times beside, the
     quantizing scatters with fp8_e4m3's times beside int8's, the four
     scatters' times a pair call's; row 9 with its launches on phase 5w's
     prefills and its times at their shapes, row 5 with phase 5w's int8
     blocking launches and its times at the prefill's write), then the
     final ``{"ok": true, "device": {...}}`` line.

Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,           # dense tensor-core bf16
              torch.float32: 67e12}             # fp32 outside tensor cores
# SFU (MUFU) instructions a second: 16 a clock an SM (CUDA C++
# Programming Guide, compute capability 9.0) x 132 SMs x 1.98 GHz, the
# clock the data sheet's 67 TFLOP/s implies
SFU_OPS_PER_S = 16 * 132 * 1.98e9
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
    "paged_cache_update": ("src/repro_torch/kernels/csrc/cache_update.cu",
                           "src/repro/kernels/cache_update/cache_update.py:48"),
    "quant_cache_update": (
        "src/repro_torch/kernels/csrc/cache_update.cu",
        "src/repro/kernels/cache_update/cache_update.py:157"),
    "quant_paged_cache_update": (
        "src/repro_torch/kernels/csrc/cache_update.cu",
        "src/repro/kernels/cache_update/cache_update.py:209"),
    "decode_attention_paged": (
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention/decode_attention.py:187"),
    "prefill_attention_paged": (
        "src/repro_torch/kernels/csrc/prefill_attention.cu",
        "src/repro/kernels/prefill_attention/prefill_attention.py:231"),
    "fma32": ("src/repro_torch/kernels/csrc/fma32.cu",
              "src/repro/kernels/fma32/fma32.py:28"),
    "stream_triad": ("src/repro_torch/kernels/csrc/stream.cu",
                     "src/repro/kernels/stream/stream.py:19"),
    "gemm": ("src/repro_torch/kernels/csrc/gemm.cu",
             "src/repro/kernels/gemm/gemm.py:33"),
    "jacobi2d": ("src/repro_torch/kernels/csrc/jacobi2d.cu",
                 "src/repro/kernels/jacobi2d/jacobi2d.py:45"),
    "gridder": ("src/repro_torch/kernels/csrc/gridder.cu",
                "src/repro/kernels/gridder/gridder.py:56"),
    "degridder": ("src/repro_torch/kernels/csrc/gridder.cu",
                  "src/repro/kernels/gridder/gridder.py:93"),
    "flash_attention": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:95"),
    # the v_width branch (MLA's aliased latent cache): bf16 q on the
    # tensor-core latent kernel, fp32 q on the CUDA-core kernels above
    "decode_attention v": (
        "src/repro_torch/kernels/csrc/latent_attention.cu",
        "src/repro/kernels/decode_attention/decode_attention.py:272"),
    "decode_attention_paged v": (
        "src/repro_torch/kernels/csrc/latent_attention.cu",
        "src/repro/kernels/decode_attention/decode_attention.py:187"),
    "prefill_attention v": (
        "src/repro_torch/kernels/csrc/latent_attention.cu",
        "src/repro/kernels/prefill_attention/prefill_attention.py:323"),
    "prefill_attention_paged v": (
        "src/repro_torch/kernels/csrc/latent_attention.cu",
        "src/repro/kernels/prefill_attention/prefill_attention.py:231"),
}
# Launch counters: kernel name -> attribute of its wrapper module.  The
# attention kernels count their launches over quantized caches apart,
# under the name with a " quant" suffix.
COUNTER = {"gridder": "gridder_launches", "degridder": "degridder_launches",
           "paged_cache_update": "paged_launches",
           "decode_attention_paged": "paged_launches",
           "prefill_attention_paged": "paged_launches",
           "quant_cache_update": "quant_launches",
           "quant_paged_cache_update": "quant_paged_launches",
           "decode_attention quant": "quant_launches",
           "prefill_attention quant": "quant_launches",
           "decode_attention_paged quant": "quant_paged_launches",
           "prefill_attention_paged quant": "quant_paged_launches",
           "decode_attention v": "v_launches",
           "prefill_attention v": "v_launches",
           "decode_attention_paged v": "v_paged_launches",
           "prefill_attention_paged v": "v_paged_launches",
           "decode_attention v quant": "v_quant_launches",
           "prefill_attention v quant": "v_quant_launches",
           "decode_attention_paged v quant": "v_quant_paged_launches",
           "prefill_attention_paged v quant": "v_quant_paged_launches"}
# Quantized KV-cache modes; the drift gate of tests/test_quant_serve.py:
# max |logit - fp32 cache's logit| under this share of max(max |logit|, 1).
MODES = ("int8", "fp8_e4m3")
DRIFT_GATE = {"int8": 0.10, "fp8_e4m3": 0.20}


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


def graph_ms(fn, calls: int = 100, replays: int = 5) -> float:
    """Device time of one call with the host out of the loop: ``calls``
    calls captured in one CUDA graph, replayed ``replays`` times between
    CUDA events after a warm-up replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):           # capture wants a warm call
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


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


def device_times(kernel_call, library_call, library_ms) -> dict:
    """``graph_ms`` of a kernel call and, where the library call ran
    (``library_ms`` not None), of that call too."""
    return {"graph_ms": graph_ms(kernel_call),
            "library_graph_ms": None if library_ms is None
            else graph_ms(library_call)}


def tm_graph(t: dict, library: str = "index_copy_") -> str:
    """The CUDA-graph device times of a timing dict, for the log."""
    lib = t.get("library_graph_ms")
    return (f"kernel {t['graph_ms']:.5f} ms" + ("" if lib is None else
                                               f", {library} {lib:.5f}"))


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def u8(t: torch.Tensor) -> torch.Tensor:
    """A one-byte code tensor as its bytes (``torch.equal`` has no
    float8 kernel), any other tensor as it is."""
    return t.view(torch.uint8) if t.element_size() == 1 else t


def quantized(mode, *caches):
    """Each cache as (codes, float32 row scales) of ``mode``."""
    from repro_torch.kernels import quant
    return [quant.quantize(c, mode) for c in caches]


def zero_counts(kernels) -> None:
    for name, mod in kernels.items():
        setattr(mod, COUNTER.get(name, "launches"), 0)


def read_counts(kernels) -> dict:
    return {name: getattr(mod, COUNTER.get(name, "launches"))
            for name, mod in kernels.items()}


# -- phase 3: kernels against their plain versions ---------------------------
# The copying scatters (rows 1 and 4): one leaf and a layer's k and v in
# one launch, exactly (a copy), at the serve shapes and odd ones (F 51:
# rows no multiple of 16 bytes, the element path; views one element into
# their storage, likewise); the pair timed at the serve shapes beside two
# one-leaf launches, two ``index_copy_`` calls (the library yardstick for
# two leaves) and an empty kernel (the floor of a launch), in a CUDA
# graph.

def copy_grid(rows: int, units: int, leaves: int) -> tuple:
    """The grid and block size of one copying-scatter launch of ``rows``
    rows of ``units`` units a leaf, as ``copy_launch`` in
    csrc/cache_update.cu sizes it: a block a row, of ``kCopyThreads``
    (read from the source) threads at most."""
    src = (ROOT / "src/repro_torch/kernels/csrc/cache_update.cu").read_text()
    most = int(re.search(r"constexpr int kCopyThreads = (\d+);",
                         src).group(1))
    return (rows, leaves), min(most, (units + 31) // 32 * 32)


def empty_graph_ms(lib, grid, threads: int) -> float:
    """``graph_ms`` of an empty kernel (``csrc/empty.cu``) launched on
    ``grid`` blocks of ``threads``: the floor of a launch."""
    def call():
        err = lib.pmt_empty(*grid, threads,
                            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"pmt_empty failed: error {err}")
    return graph_ms(call)


def _copy_leaves(dev, dt, lead, rows, f, n, seed, skew=False) -> list:
    """``n`` (cache, new) leaves: caches of ``lead`` + (f,) and rows of
    ``rows`` + (f,) in ``dt``; with ``skew``, views one element into their
    storage."""
    out = []
    for i in range(n):
        g = torch.Generator(device=dev).manual_seed(seed + i)
        cache = torch.randn((*lead, f), generator=g, device=dev).to(dt)
        new = torch.randn((*rows, f), generator=g, device=dev).to(dt)
        out.append((misaligned(cache), misaligned(new)) if skew
                   else (cache, new))
    return out


def _copy_args(leaves) -> list:
    """The leaves' tensors, caches copied (a skewed view stays skewed),
    rows as they are: the arguments of one call."""
    copy = lambda t: misaligned(t) if t.storage_offset() else t.clone()
    return [x for cache, new in leaves for x in (copy(cache), new)]


def _copy_calls(kernel, ref, n: int, paged: bool):
    """(kernel call, plain call) over ``n`` leaves: one leaf, or two in
    one launch.  Each takes the leaves' arguments and the routing and
    returns the outputs by leaf."""
    name = "paged_cache_update" if paged else "cache_update"
    pair = "_pair" if n == 2 else ""
    kfn = getattr(kernel, f"{name}{pair}_cuda")
    rfn = getattr(ref, f"{name}{pair}_ref")
    wrap = (lambda out: list(out)) if pair else (lambda out: [out])
    return (lambda args, *where: wrap(kfn(*args, *where)),
            lambda args, *where: wrap(rfn(*args, *where)))


def _copy_timing(kernel, ref, lib, leaves, where, paged, flat_idx,
                 nbytes) -> dict:
    """The pair call over ``leaves`` at a serve shape: by CUDA events
    (host in the loop) and in a CUDA graph, beside the plain version, two
    one-leaf launches (the serve path's call before), two
    ``index_copy_`` calls of the same rows into the flattened caches at
    ``flat_idx`` and an empty kernel at one block of 32 threads and at
    the pair's grid; the bound of ``nbytes``."""
    call, plain = _copy_calls(kernel, ref, 2, paged)
    one, _ = _copy_calls(kernel, ref, 1, paged)
    args = _copy_args(leaves)
    one_where = where if where[-1] is not None else (
        *where[:-1], torch.ones_like(where[0][:, 0]))
    flats = [(c.view(-1, c.shape[-1]), n.reshape(-1, n.shape[-1])[
        flat_idx[1]]) for c, n in zip(args[::2], args[1::2])]
    library = lambda: [flat.index_copy_(0, flat_idx[0], rows)
                       for flat, rows in flats]
    b, t, f = args[1].shape
    grid, threads = copy_grid(b * t, f * args[1].element_size() // 16, 2)
    tm = {"ms": time_ms(lambda: call(args, *where), iters=200),
          "plain_ms": time_ms(lambda: plain(args, *where), iters=200),
          "library_ms": time_ms(library, iters=200),
          "graph_ms": graph_ms(lambda: call(args, *where)),
          "library_graph_ms": graph_ms(library),
          "two_launches_graph_ms": graph_ms(
              lambda: (one(args[:2], *one_where), one(args[2:], *one_where))),
          "empty_graph_ms": empty_graph_ms(lib, (1, 1), 32),
          "empty_grid_graph_ms": empty_graph_ms(lib, grid, threads),
          "grid": [*grid, threads]}
    tm["bound_ms"], tm["bound_by"] = bound(nbytes, 0.0, torch.bfloat16)
    return tm


def _log_copy_timing(name, case, tm) -> None:
    log(f"  {name} {case}, k and v in one launch: kernel {tm['ms']:.5f} ms "
        f"(host in the loop), plain {tm['plain_ms']:.5f}, two index_copy_ "
        f"{tm['library_ms']:.5f}; in a CUDA graph: the pair "
        f"{tm['graph_ms']:.7f}, two one-leaf launches "
        f"{tm['two_launches_graph_ms']:.7f}, two index_copy_ "
        f"{tm['library_graph_ms']:.7f}, an empty kernel "
        f"{tm['empty_graph_ms']:.7f} (1 x 32) and "
        f"{tm['empty_grid_graph_ms']:.7f} (the pair's grid "
        f"{tm['grid'][:2]} x {tm['grid'][2]}); bound "
        f"{tm['bound_ms']:.7f} (bytes)")


def check_cache_update(kernel, ref, lib, dev):
    """Row 1: one leaf and two in one launch equal their plain versions
    exactly; the pair timed at the decode serve shape (bf16)."""
    results = {}
    cases = {"main B8 C1024 F192": (8, 1024, 192, False),
             "odd B5 C77 F51": (5, 77, 51, False),
             "misaligned B8 C1024 F192": (8, 1024, 192, True)}
    for name, (b, c, f, skew) in cases.items():
        g = torch.Generator(device=dev).manual_seed(1)
        slots = torch.randint(0, c, (b,), generator=g, device=dev,
                              dtype=torch.int32)
        # the first and last slots, and one past the end (clamped)
        slots[0], slots[1], slots[-1] = 0, c + 5, c - 1
        for dt in (torch.float32, torch.bfloat16):
            for n in (1, 2):
                leaves = _copy_leaves(dev, dt, (b, c), (b, 1), f, n, 1, skew)
                call, plain = _copy_calls(kernel, ref, n, paged=False)
                got = call(_copy_args(leaves), slots)
                want = plain(_copy_args(leaves), slots)
                torch.cuda.synchronize()
                err = max(max_err(gc, wc) for gc, wc in zip(got, want))
                exact = all(torch.equal(gc, wc) for gc, wc in zip(got, want))
                how = "k and v in one launch" if n == 2 else "one leaf"
                log(f"  cache_update {name} {str(dt)[6:]}, {how}: "
                    f"{'equal' if exact else 'DIFFERENT'} bit for bit, max "
                    f"|err| {err} (must be 0: a copy)")
                if not exact:
                    raise AssertionError("cache_update disagrees with its "
                                         "plain version")
        if not name.startswith("main"):
            continue
        dt = torch.bfloat16
        el = torch.tensor([], dtype=dt).element_size()
        idx = torch.arange(b, device=dev) * c + slots.long().clamp(0, c - 1)
        tm = _copy_timing(
            kernel, ref, lib, _copy_leaves(dev, dt, (b, c), (b, 1), f, 2, 3),
            (slots,), False, (idx, slice(None)),
            # both leaves' rows read and written, the slots read
            2 * 2 * b * f * el + 4 * b)
        _log_copy_timing("cache_update", name, tm)
        results = dict(tm, max_abs_err=0.0)
    return results



def _decode_inputs(dev, dt, b, c, kvh, g, hd, seed=2):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, kvh, g, hd), generator=gen, device=dev).to(dt)
    k = torch.randn((b, c, kvh, hd), generator=gen, device=dev).to(dt)
    v = torch.randn((b, c, kvh, hd), generator=gen, device=dev).to(dt)
    return q, k, v


def decode_sdpa(q, k, v, lens, scale: float):
    """Row 3's yardstick: SDPA over the whole cache with a (B, 1, 1, C)
    mask of the attendable slots, GQA."""
    b, kvh, g, hd = q.shape
    c = k.shape[1]
    qh = q.view(b, kvh * g, 1, hd)
    kh, vh = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    mask = (torch.arange(c, device=q.device)[None, :]
            <= lens[:, None]).view(b, 1, 1, c)
    return lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask, scale=scale, enable_gqa=True)


# Row 3's case on the serve path: 8 decode rows of smollm-135m (3 kv
# heads of 64, 3 query heads each) over a 1024-slot cache.
DECODE_SERVE = dict(b=8, c=1024, kvh=3, g=3, hd=64,
                    lens=[0, 1, 511, 1023, 37, 300, 700, 1000])


def check_decode(kernel, ref, dev, mode=None):
    """Tolerance TOL of q's dtype.  With ``mode`` the cache holds that
    mode's codes and row scales (quantized from the same values), which
    kernel and plain version dequantize to the same float32 values.  The
    split-KV edges: one long row alone, every row at 0, a ring wrapped
    past a 1024-slot cache, and ranges that end on the shares of 8
    splits (16 keys each at 128 keys: 79 leaves three splits empty, 128
    one key in the fifth)."""
    cases = {
        "main B8 C1024 KVH3 G3 hd64": dict(DECODE_SERVE, ring=False,
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
        "split B1 C1024 one row at 1023": dict(
            b=1, c=1024, kvh=3, g=3, hd=64, lens=[1023], ring=False,
            softcap=None),
        "split B8 C1024 every row at 0": dict(
            b=8, c=1024, kvh=3, g=3, hd=64, lens=[0] * 8, ring=False,
            softcap=None),
        "split ring C1024 wrapped": dict(
            b=8, c=1024, kvh=3, g=3, hd=64,
            lens=[1022, 1023, 1024, 1025, 1500, 2047, 3000, 5000],
            ring=True, softcap=None),
        "split share boundaries": dict(
            b=8, c=1024, kvh=3, g=3, hd=64,
            lens=[15, 16, 79, 127, 128, 255, 256, 1023], ring=False,
            softcap=None),
    }
    results = {}
    for name, cs in cases.items():
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = _decode_inputs(dev, dt, cs["b"], cs["c"], cs["kvh"],
                                     cs["g"], cs["hd"])
            lens = torch.tensor(cs["lens"], dtype=torch.int32, device=dev)
            scale = 1.0 / math.sqrt(cs["hd"])
            kw = dict(ring=cs["ring"], softcap=cs["softcap"], scale=scale)
            if mode:
                (k, kw["k_scale"]), (v, kw["v_scale"]) = quantized(mode, k, v)
            got = kernel.decode_attention_cuda(q, k, v, lens, **kw)
            want = ref.decode_attention_ref(q, k, v, lens, **kw)
            torch.cuda.synchronize()
            err = max_err(got, want)
            log(f"  decode_attention {mode or ''} {name} {str(dt)[6:]}: max "
                f"|err| {err:.3g} (tol {TOL[dt]:.3g})")
            if not err <= TOL[dt]:
                raise AssertionError("decode_attention disagrees with its "
                                     "plain version")
            if name.startswith("main") and dt == torch.bfloat16:
                b, c, kvh, g, hd = (cs[x] for x in ("b", "c", "kvh", "g",
                                                     "hd"))
                el = k.element_size()
                keys = sum(min(n, c - 1) + 1 for n in cs["lens"])
                # a quantized row also reads its 4-byte scale
                nbytes = keys * kvh * 2 * (hd * el + (4 if mode else 0)) \
                    + 2 * q.numel() * q.element_size() + 4 * b
                flops = keys * kvh * g * 4 * hd
                sdpa = decode_sdpa(q, k, v, lens, scale)
                t = {
                    "ms": time_ms(lambda: kernel.decode_attention_cuda(
                        q, k, v, lens, **kw)),
                    "plain_ms": time_ms(lambda: ref.decode_attention_ref(
                        q, k, v, lens, **kw), iters=5),
                    "library_ms": None if mode else library_time(sdpa),
                }
                t["bound_ms"], t["bound_by"] = bound(nbytes, flops, dt)
                t.update(device_times(lambda: kernel.decode_attention_cuda(
                    q, k, v, lens, **kw), sdpa, t["library_ms"]))
                log(f"  decode_attention {mode or ''} {name}: device time a "
                    f"call (CUDA graph) {tm_graph(t, 'SDPA')}")
                results = dict(t, max_abs_err=err)
    return results


# Row 2's case on the serve path: one row's 32-token chunk over a 512-token
# prefix of smollm-135m (3 kv heads of 64, 3 query heads each).
PREFILL_SERVE = dict(b=1, t=32, c=1024, kvh=3, g=3, hd=64, offs=[512],
                     ring=False, window=None, softcap=None)


def prefill_sdpa(q, kx, vx, kc, vc, off: int, scale: float):
    """One ``scaled_dot_product_attention`` call computing chunked
    prefill for rows that all sit at ``off``: the chunk's queries over the
    first ``off`` cache positions and the chunk's own keys, causal."""
    b, kvh, t, g, hd = q.shape
    qh = q.permute(0, 1, 3, 2, 4).reshape(b, kvh * g, t, hd)
    kall = torch.cat([kc[:, :off].to(q.dtype), kx], 1).permute(0, 2, 1, 3)
    vall = torch.cat([vc[:, :off].to(q.dtype), vx], 1).permute(0, 2, 1, 3)
    mask = torch.ones((t, off + t), dtype=torch.bool, device=q.device)
    mask[:, off:] = torch.tril(mask[:, off:])
    return lambda: F.scaled_dot_product_attention(
        qh, kall, vall, attn_mask=mask, scale=scale, enable_gqa=True)


def _prefill_inputs(dev, dt, b, t, c, kvh, g, hd, seed=3):
    gen = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=gen, device=dev).to(dt)
    return (mk(b, kvh, t, g, hd), mk(b, t, kvh, hd), mk(b, t, kvh, hd),
            mk(b, c, kvh, hd), mk(b, c, kvh, hd))


def check_prefill(kernel, ref, dev, mode=None):
    """Tolerance TOL of q's dtype; with ``mode`` the cache prefix holds
    codes and row scales, the chunk's own k/v stay in q's dtype."""
    cases = {
        "main B8 T32 C1024 KVH3 G3 hd64": dict(
            b=8, t=32, c=1024, kvh=3, g=3, hd=64,
            offs=[0, 1, 512, 1023, 32, 300, 700, 960], ring=False,
            window=None, softcap=None),
        "serve path B1 T32 C1024 off512": PREFILL_SERVE,
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
        # bf16 runs split-KV (prefill_attention/kernel.py split_count: 8
        # splits at B1 and B8, C1024); 80 = 5 shares of 16 keys ends on a
        # share boundary with 3 empty splits after it
        "split boundary B1 T32 C1024 off80": dict(
            b=1, t=32, c=1024, kvh=3, g=3, hd=64, offs=[80], ring=False,
            window=None, softcap=None),
        "no cache phase B1 T32 C1024 off0": dict(
            b=1, t=32, c=1024, kvh=3, g=3, hd=64, offs=[0], ring=False,
            window=None, softcap=None),
        "off >= C B2 T32 C256": dict(
            b=2, t=32, c=256, kvh=3, g=3, hd=64, offs=[256, 700],
            ring=False, window=None, softcap=None),
        "uneven B8 T32 C1024": dict(
            b=8, t=32, c=1024, kvh=3, g=3, hd=64,
            offs=[0, 3, 1023, 1024, 5000, 16, 640, 81], ring=False,
            window=None, softcap=None),
        # rows of 36 bf16 are not whole 16-byte units: element loads
        "odd B2 T9 C100 KVH1 G4 hd36": dict(
            b=2, t=9, c=100, kvh=1, g=4, hd=36, offs=[50, 100], ring=False,
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
            if mode:
                (kc, kw["k_scale"]), (vc, kw["v_scale"]) = quantized(
                    mode, kc, vc)
            got = kernel.prefill_attention_cuda(q, kx, vx, kc, vc, offs, **kw)
            want = ref.prefill_attention_ref(q, kx, vx, kc, vc, offs, **kw)
            torch.cuda.synchronize()
            err = max_err(got, want)
            log(f"  prefill_attention {mode or ''} {name} {str(dt)[6:]}: max "
                f"|err| {err:.3g} (tol {TOL[dt]:.3g})")
            if not err <= TOL[dt]:
                raise AssertionError("prefill_attention disagrees with its "
                                     "plain version")
            if name.startswith("serve path") and dt == torch.bfloat16:
                off = cs["offs"][0]
                el, qel = kc.element_size(), q.element_size()
                nbytes = min(off, c) * kvh * 2 * (hd * el
                                                  + (4 if mode else 0)) \
                    + t * kvh * 2 * hd * qel + 2 * q.numel() * qel + 4 * b
                pairs = t * min(off, c) + t * (t + 1) // 2
                flops = pairs * kvh * g * 4 * hd
                sdpa = prefill_sdpa(q, kx, vx, kc, vc, off, scale)
                tm = {
                    "ms": time_ms(lambda: kernel.prefill_attention_cuda(
                        q, kx, vx, kc, vc, offs, **kw)),
                    "plain_ms": time_ms(lambda: ref.prefill_attention_ref(
                        q, kx, vx, kc, vc, offs, **kw), iters=5),
                    "library_ms": None if mode else library_time(sdpa),
                }
                tm["bound_ms"], tm["bound_by"] = bound(nbytes, flops, dt)
                tm.update(device_times(
                    lambda: kernel.prefill_attention_cuda(
                        q, kx, vx, kc, vc, offs, **kw), sdpa,
                    tm["library_ms"]))
                log(f"  prefill_attention {mode or ''} {name}: device time "
                    f"a call (CUDA graph) {tm_graph(tm, 'SDPA')}")
                results = dict(tm, max_abs_err=err)
    return results


# -- phase 3, quantized: the quantizing scatters ---------------------------
# Shapes: the serve path's (decode: 8 slots of 1024, smollm-135m's 3 kv
# heads of 64; the contiguous prefill chunk: batch 1, 32 rows into 1024
# slots; paged: 512 usable pages of 16 plus scratch, decode T 1 and a
# 32-token chunk with masked rows) and odd ones (heads of 40: the lane
# groups with idle lanes, 5 units of 16 bytes in groups of 8 in bf16, 10
# in groups of 16 in float32; heads of 36: 72 bytes a bf16 vector, the
# general path, and 9 units in groups of 16 in float32; page sizes 8 and
# 24, positions past the table; a chunk whose start clamps to C - T;
# views one element into their storage, the general path).  One leaf, and
# a layer's k and v in one launch (the serve path's call).  Bit for bit:
# codes through their bytes, scales with torch.equal.  The checked rows
# hold a zero vector and +-1e4 extremes; the timed rows are plain normal
# draws, as the serve path's projections give.

def _quant_leaves(dev, quant, mode, dt, lead, rows, h, d, n, skew,
                  planted=True):
    """``n`` leaves (codes of ``lead`` + (h, d), float32 scales, rows of
    ``rows`` + (h, d) in ``dt``, with ``planted`` a zero vector and +-1e4
    extremes among them); with ``skew``, codes and rows views one element
    into their storage."""
    out = []
    for i in range(n):
        g = torch.Generator(device=dev).manual_seed(21 + i)
        codes, scales = quant.quantize(torch.randn(
            (*lead, h, d), generator=g, device=dev), mode)
        new = (3 * torch.randn((*rows, h, d), generator=g,
                               device=dev)).to(dt)
        if planted:
            new[0, 0, h - 1] = 0.0                      # a zero vector
            new[-1, 0, 0, :2] = torch.tensor([1e4, -1e4], device=dev)
        if skew:
            codes, new = misaligned(codes), misaligned(new)
        out.append((codes, scales, new))
    return out


def _copies(leaves) -> list:
    """The leaves' tensors, codes and scales copied (a skewed view stays
    skewed), rows as they are: the arguments of one call."""
    copy = lambda t: misaligned(t) if t.storage_offset() else t.clone()
    return [x for codes, scales, new in leaves
            for x in (copy(codes), scales.clone(), new)]


def _quant_calls(kernel, ref, leaves, where, mode, paged):
    """(kernel call, plain call) over ``leaves``: one leaf, or two in one
    launch.  Each returns a list of (codes, scales) by leaf."""
    name = "quant_paged_cache_update" if paged else "quant_cache_update"
    pair = "_pair" if len(leaves) == 2 else ""
    kfn = getattr(kernel, f"{name}{pair}_cuda")
    rfn = getattr(ref, f"{name}{pair}_ref")
    wrap = (lambda out: list(out)) if pair else (lambda out: [out])
    return (lambda args: wrap(kfn(*args, *where, mode)),
            lambda args: wrap(rfn(*args, *where, mode)))


def _quant_timing(kernel, ref, leaves, where, mode, paged, nbytes) -> dict:
    """One call over ``leaves`` (the pair at the serve shapes), checked
    bit for bit first (outside the scratch page 0 when paged): its time
    by CUDA events (host in the loop) and in a CUDA graph, the plain
    version's, and the bound of ``nbytes``; beside it the graph time of
    the two one-leaf launches the serve path made before (k, then v)."""
    call, plain = _quant_calls(kernel, ref, leaves, where, mode, paged)
    got, want = call(_copies(leaves)), plain(_copies(leaves))
    lo = 1 if paged else 0
    if not all(torch.equal(u8(gc)[lo:], u8(wc)[lo:])
               and torch.equal(gs[lo:], ws[lo:])
               for (gc, gs), (wc, ws) in zip(got, want)):
        raise AssertionError("the timed quantizing scatter disagrees with "
                             "its plain version")
    args = _copies(leaves)
    one, _ = _quant_calls(kernel, ref, leaves[:1], where, mode, paged)
    t = {"ms": time_ms(lambda: call(args), iters=200),
         "plain_ms": time_ms(lambda: plain(args), iters=200),
         "library_ms": None,
         "graph_ms": graph_ms(lambda: call(args)),
         "two_launches_graph_ms": graph_ms(
             lambda: (one(args[:3]), one(args[3:])))}
    t["bound_ms"], t["bound_by"] = bound(nbytes, 0.0, torch.bfloat16)
    return t


QUANT_CONTIGUOUS = {
    "decode B8 T1 C1024 KVH3 hd64": dict(b=8, t=1, c=1024, h=3, d=64),
    "chunk B1 T32 C1024 KVH3 hd64 off512": dict(b=1, t=32, c=1024, h=3,
                                                d=64, slots=[512]),
    "chunk B1 T32 C1024 off1000 (start 992)": dict(b=1, t=32, c=1024, h=3,
                                                   d=64, slots=[1000]),
    "odd B5 T1 C77 H5 D40": dict(b=5, t=1, c=77, h=5, d=40),
    "odd B5 T3 C77 H5 D40": dict(b=5, t=3, c=77, h=5, d=40,
                                 slots=[0, 74, 75, 200, 30]),
    "odd B3 T7 C50 H2 D36": dict(b=3, t=7, c=50, h=2, d=36,
                                 slots=[0, 43, 49]),
    "misaligned decode B8 T1 C1024 KVH3 hd64": dict(b=8, t=1, c=1024, h=3,
                                                    d=64, skew=True),
    # the whole-prompt prefill's write (phase 5w's cache of 2048 slots):
    # a bucket of 1024 rows a batch row at offset 0, blocking (B1) and a
    # wave (B8)
    "prefill B1 T1024 C2048 off0": dict(b=1, t=1024, c=2048, h=3, d=64,
                                        slots=[0]),
    "prefill B8 T1024 C2048 off0": dict(b=8, t=1024, c=2048, h=3, d=64,
                                        slots=[0] * 8),
}


def check_quant_cache_update(kernel, ref, quant, dev):
    """Row 5: one leaf and two (k and v in one launch) bit for bit; the
    pair timed at the decode and chunk serve shapes and at the whole-prompt
    prefill's (bf16 rows; ``serve_prefill`` in the result)."""
    results = {}
    for mode in MODES:
        for name, cs in QUANT_CONTIGUOUS.items():
            b, t, c, h, d = (cs[x] for x in ("b", "t", "c", "h", "d"))
            for dt in (torch.float32, torch.bfloat16):
                for n in (1, 2):
                    leaves = _quant_leaves(dev, quant, mode, dt, (b, c),
                                           (b, t), h, d, n,
                                           cs.get("skew", False))
                    if "slots" in cs:
                        slots = torch.tensor(cs["slots"], dtype=torch.int32,
                                             device=dev)
                    else:
                        g = torch.Generator(device=dev).manual_seed(20)
                        slots = torch.randint(0, c, (b,), generator=g,
                                              device=dev, dtype=torch.int32)
                        slots[0], slots[-1] = 0, c - 1
                    call, plain = _quant_calls(kernel, ref, leaves, (slots,),
                                               mode, paged=False)
                    got, want = call(_copies(leaves)), plain(_copies(leaves))
                    torch.cuda.synchronize()
                    exact = all(torch.equal(u8(gc), u8(wc))
                                and torch.equal(gs, ws)
                                for (gc, gs), (wc, ws) in zip(got, want))
                    finite = all(bool(torch.isfinite(
                        quant.dequantize(*x)).all()) for x in got)
                    how = "k and v in one launch" if n == 2 else "one leaf"
                    log(f"  quant_cache_update {mode} {name} {str(dt)[6:]} "
                        f"rows, {how}: codes and scales "
                        f"{'equal' if exact else 'DIFFERENT'} bit for bit, "
                        f"{'no' if finite else 'SOME'} NaN/Inf dequantized")
                    if not (exact and finite):
                        raise AssertionError("quant_cache_update disagrees "
                                             "with its plain version")
                    if not ((name.startswith(("decode", "prefill"))
                             or "off512" in name)
                            and dt == torch.bfloat16 and n == 2):
                        continue
                    # read both leaves' rows, write their codes and
                    # scales, read the slots
                    vec, el = b * t * h, leaves[0][2].element_size()
                    timed = _quant_leaves(dev, quant, mode, dt, (b, c),
                                          (b, t), h, d, n, False,
                                          planted=False)
                    tm = _quant_timing(kernel, ref, timed, (slots,), mode,
                                       False, 2 * vec * (d * el + d + 4)
                                       + 4 * b)
                    log(f"  quant_cache_update {mode} {name}, k and v in "
                        f"one launch: kernel {tm['ms']:.5f} ms (host in the "
                        f"loop), {tm['graph_ms']:.5f} in a CUDA graph "
                        f"(two one-leaf launches "
                        f"{tm['two_launches_graph_ms']:.5f}), plain "
                        f"{tm['plain_ms']:.5f}, bound {tm['bound_ms']:.7f} "
                        f"(bytes)")
                    if name.startswith("decode"):
                        results[mode] = dict(tm, max_abs_err=0.0,
                                             serve_prefill={})
                    elif name.startswith("prefill"):
                        results[mode]["serve_prefill"][name.split()[1]] = {
                            k: tm[k] for k in ("ms", "graph_ms", "plain_ms",
                                               "bound_ms", "bound_by")}
                    else:
                        results[mode].update(
                            {f"chunk_{k}": tm[k] for k in (
                                "ms", "graph_ms", "plain_ms", "bound_ms")})
    log("  quant_cache_update: library none (no single PyTorch call "
        "quantizes rows and scatters codes and scales)")
    return results


QUANT_PAGED = {
    "decode P513 ps16 B8 NB64 T1": dict(
        p=513, ps=16, h=3, d=64, b=8, nb=64, t=1, masked=(7,),
        starts=[0, 1, 15, 16, 511, 1023, 700, 1500],
        valids=[1, 1, 1, 1, 1, 1, 0, 1]),
    "prefill P513 ps16 B8 NB64 T32": dict(
        p=513, ps=16, h=3, d=64, b=8, nb=64, t=32, masked=(),
        starts=[0, 16, 512, 992, 5, 100, 0, 17],
        valids=[32, 32, 17, 32, 0, 1, 0, 31]),
    "odd P40 ps24 H2 D40 B3 NB5 T7": dict(
        p=40, ps=24, h=2, d=40, b=3, nb=5, t=7, masked=(),
        starts=[0, 23, 110], valids=[7, 3, 0]),
    "odd P40 ps8 B4 NB9 T1 past the table": dict(
        p=40, ps=8, h=3, d=64, b=4, nb=9, t=1, masked=(),
        starts=[71, 72, 500, 3], valids=[1, 1, 1, 0]),
    # row 2 ends on the table's last slot (a later start would land
    # several rows there, in no defined order)
    "odd P30 ps8 H2 D36 B3 NB4 T5": dict(
        p=30, ps=8, h=2, d=36, b=3, nb=4, t=5, masked=(),
        starts=[0, 6, 27], valids=[5, 2, 5]),
    "misaligned prefill P513 ps16 B8 NB64 T32": dict(
        p=513, ps=16, h=3, d=64, b=8, nb=64, t=32, masked=(),
        starts=[0, 16, 512, 992, 5, 100, 0, 17],
        valids=[32, 32, 17, 32, 0, 1, 0, 31], skew=True),
}


def check_quant_paged_cache_update(kernel, ref, quant, dev):
    """Row 6: bit for bit outside the scratch page 0, one leaf and two in
    one launch; every row of a real page that no valid row targets keeps
    its code bytes and its scale.  The pair timed at the decode and chunk
    serve shapes (bf16 rows)."""
    results = {}
    for mode in MODES:
        for name, cs in QUANT_PAGED.items():
            p, ps, h, d, b, nb, t = (cs[x] for x in (
                "p", "ps", "h", "d", "b", "nb", "t"))
            table = _page_table(dev, b, nb, p, 23, cs["masked"])
            starts = torch.tensor(cs["starts"], dtype=torch.int32,
                                  device=dev)
            valids = torch.tensor(cs["valids"], dtype=torch.int32,
                                  device=dev)
            where = (table, starts, valids)
            _, ok, kept = _paged_targets(dev, table, starts, valids, t, p,
                                         ps)
            for dt in (torch.float32, torch.bfloat16):
                for n in (1, 2):
                    leaves = _quant_leaves(dev, quant, mode, dt, (p, ps),
                                           (b, t), h, d, n,
                                           cs.get("skew", False))
                    call, plain = _quant_calls(kernel, ref, leaves, where,
                                               mode, paged=True)
                    got, want = call(_copies(leaves)), plain(_copies(leaves))
                    torch.cuda.synchronize()
                    exact = all(torch.equal(u8(gc)[1:], u8(wc)[1:])
                                and torch.equal(gs[1:], ws[1:])
                                for (gc, gs), (wc, ws) in zip(got, want))
                    untouched = all(
                        torch.equal(u8(gc).view(p * ps, -1)[kept],
                                    u8(codes).view(p * ps, -1)[kept])
                        and torch.equal(gs.view(p * ps, -1)[kept],
                                        scales.view(p * ps, -1)[kept])
                        for (gc, gs), (codes, scales, _) in zip(got, leaves))
                    finite = all(bool(torch.isfinite(
                        quant.dequantize(gc, gs)[1:]).all())
                        for gc, gs in got)
                    how = "k and v in one launch" if n == 2 else "one leaf"
                    log(f"  quant_paged_cache_update {mode} {name} "
                        f"{str(dt)[6:]} rows, {how}: outside "
                        f"page 0 {'equal' if exact else 'DIFFERENT'} bit for "
                        f"bit; {int(kept.sum())} rows of real pages no valid "
                        f"row targets "
                        f"{'unchanged' if untouched else 'CHANGED'}; "
                        f"{'no' if finite else 'SOME'} NaN/Inf dequantized")
                    if not (exact and untouched and finite):
                        raise AssertionError("quant_paged_cache_update "
                                             "disagrees with its plain "
                                             "version")
                    if n == 2:
                        # valids None (every row valid): the kernel
                        # against the plain version with valids of T
                        every = (table, starts, torch.full_like(valids, t))
                        call, _ = _quant_calls(kernel, ref, leaves,
                                               (table, starts, None), mode,
                                               paged=True)
                        _, plain = _quant_calls(kernel, ref, leaves, every,
                                                mode, paged=True)
                        got, want = call(_copies(leaves)), plain(
                            _copies(leaves))
                        torch.cuda.synchronize()
                        exact = all(torch.equal(u8(gc)[1:], u8(wc)[1:])
                                    and torch.equal(gs[1:], ws[1:])
                                    for (gc, gs), (wc, ws) in zip(got, want))
                        log(f"  quant_paged_cache_update {mode} {name} "
                            f"{str(dt)[6:]} rows, k and v in one launch, "
                            f"valids None: outside page 0 "
                            f"{'equal' if exact else 'DIFFERENT'} bit for "
                            f"bit to every row valid")
                        if not exact:
                            raise AssertionError(
                                "quant_paged_cache_update with valids None "
                                "disagrees with its plain version")
                    if not (name.startswith(("decode", "prefill"))
                            and dt == torch.bfloat16 and n == 2):
                        continue
                    # both leaves' valid rows read and written, one table
                    # entry a valid row, starts and valids
                    vec = int(ok.sum()) * h
                    el = leaves[0][2].element_size()
                    timed = _quant_leaves(dev, quant, mode, dt, (p, ps),
                                          (b, t), h, d, n, False,
                                          planted=False)
                    tm = _quant_timing(kernel, ref, timed, where, mode,
                                       True, 2 * vec * (d * el + d + 4)
                                       + 4 * int(ok.sum()) + 8 * b)
                    log(f"  quant_paged_cache_update {mode} {name}, k and v "
                        f"in one launch: kernel {tm['ms']:.5f} ms (host in "
                        f"the loop), {tm['graph_ms']:.5f} in a CUDA graph "
                        f"(two one-leaf launches "
                        f"{tm['two_launches_graph_ms']:.5f}), plain "
                        f"{tm['plain_ms']:.5f}, bound {tm['bound_ms']:.7f} "
                        f"(bytes)")
                    if name.startswith("decode"):
                        results[mode] = dict(tm, max_abs_err=0.0)
                    else:
                        results[mode].update(
                            {f"chunk_{k}": tm[k] for k in (
                                "ms", "graph_ms", "plain_ms", "bound_ms")})
    return results


# -- phase 3, paged: the paged kernels against their plain versions ---------
# Shapes: the paged serve path's (phase 5b: 512 usable pages of 16
# tokens plus the scratch page, 8 slots of 64 pages, smollm-135m's 3 kv
# heads of 64), and odd ones: page sizes 8 and 24, shuffled
# non-contiguous page ids, a window, softcap, masked rows, dead rows
# whose position runs past the end of their table.

def _page_table(dev, b, nb, num_pages, seed, masked=()):
    """(b, nb) int32 table of distinct shuffled pages 1..num_pages-1;
    rows in ``masked`` map every block to the scratch page 0."""
    ids = np.random.default_rng(seed).permutation(
        np.arange(1, num_pages))[:b * nb].reshape(b, nb)
    ids[list(masked)] = 0
    return torch.tensor(ids, dtype=torch.int32, device=dev)


def _paged_targets(dev, table, starts, valids, t, p, ps):
    """The physical rows the valid rows target, the (B, T) mask of valid
    rows, and the (p * ps,) mask of rows of real pages that none
    targets."""
    nb = table.shape[1]
    pos = torch.clamp(starts.long()[:, None] + torch.arange(t, device=dev),
                      0, nb * ps - 1)
    ok = torch.arange(t, device=dev)[None] < valids.long()[:, None]
    hit = (torch.gather(table.long(), 1, pos // ps) * ps + pos % ps)[ok]
    kept = torch.ones(p * ps, dtype=torch.bool, device=dev)
    kept[hit] = False
    kept[:ps] = False                       # page 0: undefined
    return hit, ok, kept


def check_paged_cache_update(kernel, ref, lib, dev):
    """Row 4: exact outside page 0 (a copy), one leaf and two in one
    launch, with valids and, for the pair, with None (every row valid);
    every row of a real page that no valid row targets keeps its bits.
    The pair timed at the decode serve shape (valids None, the serve
    path's call) and at a chunk (bf16)."""
    cases = {
        # decode: T = 1; row 6 masked (valids 0), row 7 a dead row whose
        # table is masked to page 0 and whose position is past the table
        "decode P513 ps16 F192 B8 NB64 T1": dict(
            p=513, ps=16, f=192, b=8, nb=64, t=1, masked=(7,),
            starts=[0, 1, 15, 16, 511, 1023, 700, 1500],
            valids=[1, 1, 1, 1, 1, 1, 0, 1]),
        # a prefill chunk: T = 32, passengers with valids 0
        "prefill P513 ps16 F192 B8 NB64 T32": dict(
            p=513, ps=16, f=192, b=8, nb=64, t=32, masked=(),
            starts=[0, 16, 512, 992, 5, 100, 0, 17],
            valids=[32, 32, 17, 32, 0, 1, 0, 31]),
        "odd P40 ps24 F51 B3 NB5 T7": dict(
            p=40, ps=24, f=51, b=3, nb=5, t=7, masked=(),
            starts=[0, 23, 110], valids=[7, 3, 0]),
        "odd P40 ps8 F51 B4 NB9 T1 past the table": dict(
            p=40, ps=8, f=51, b=4, nb=9, t=1, masked=(),
            starts=[71, 72, 500, 3], valids=[1, 1, 1, 0]),
        "misaligned prefill P513 ps16 F192 B8 NB64 T32": dict(
            p=513, ps=16, f=192, b=8, nb=64, t=32, masked=(),
            starts=[0, 16, 512, 992, 5, 100, 0, 17],
            valids=[32, 32, 17, 32, 0, 1, 0, 31], skew=True),
    }
    results = {}
    for name, cs in cases.items():
        p, ps, f, b, nb, t = (cs[x] for x in ("p", "ps", "f", "b", "nb",
                                              "t"))
        table = _page_table(dev, b, nb, p, 13, cs["masked"])
        starts = torch.tensor(cs["starts"], dtype=torch.int32, device=dev)
        given = torch.tensor(cs["valids"], dtype=torch.int32, device=dev)
        for valids in (given, None):
            every = torch.full_like(given, t) if valids is None else valids
            hit, ok, kept = _paged_targets(dev, table, starts, every, t, p,
                                           ps)
            for dt in (torch.float32, torch.bfloat16):
                for n in (1, 2) if valids is not None else (2,):
                    leaves = _copy_leaves(dev, dt, (p, ps), (b, t), f, n, 12,
                                          cs.get("skew", False))
                    call, plain = _copy_calls(kernel, ref, n, paged=True)
                    where = (table, starts, valids)
                    got = call(_copy_args(leaves), *where)
                    want = plain(_copy_args(leaves), *where)
                    torch.cuda.synchronize()
                    err = max(max_err(gc[1:], wc[1:])
                              for gc, wc in zip(got, want))
                    exact = all(torch.equal(gc[1:], wc[1:])
                                for gc, wc in zip(got, want))
                    untouched = all(
                        torch.equal(gc.view(p * ps, f)[kept],
                                    pool.view(p * ps, f)[kept])
                        for gc, (pool, _) in zip(got, leaves))
                    how = "k and v in one launch" if n == 2 else "one leaf"
                    log(f"  paged_cache_update {name} {str(dt)[6:]}, {how}"
                        f"{', valids None' if valids is None else ''}: "
                        f"outside page 0 {'equal' if exact else 'DIFFERENT'} "
                        f"bit for bit, max |err| {err} (must be 0: a copy); "
                        f"{int(kept.sum())} rows of real pages no valid row "
                        f"targets {'unchanged' if untouched else 'CHANGED'}")
                    if not (exact and untouched):
                        raise AssertionError("paged_cache_update disagrees "
                                             "with its plain version")
            # the serve path's calls: decode with valids None, a chunk
            # with its valid lengths
            serve = valids is None if name.startswith("decode") \
                else valids is not None and name.startswith("prefill")
            if not serve:
                continue
            dt = torch.bfloat16
            el = torch.tensor([], dtype=dt).element_size()
            nrows = int(ok.sum())
            tm = _copy_timing(
                kernel, ref, lib,
                _copy_leaves(dev, dt, (p, ps), (b, t), f, 2, 14),
                (table, starts, valids), True, (hit, ok.reshape(-1)),
                # both leaves' valid rows read and written, a table entry
                # a valid row, starts (and valids where given)
                2 * 2 * nrows * f * el + 4 * nrows
                + (4 if valids is None else 8) * b)
            _log_copy_timing("paged_cache_update",
                             name + (", valids None" if valids is None
                                     else ""), tm)
            if name.startswith("decode"):
                results = dict(tm, max_abs_err=0.0)
            else:
                results.update({f"chunk_{k}": tm[k] for k in (
                    "ms", "graph_ms", "plain_ms", "bound_ms",
                    "library_graph_ms", "two_launches_graph_ms")})
    return results


# Row 7's case on the paged serve path: 8 rows of 64 pages of 16 tokens
# in a 513-page pool; row 7 dead, its table masked to page 0, its
# position past it.
PAGED_DECODE_SERVE = dict(p=513, ps=16, b=8, nb=64, kvh=3, g=3, hd=64,
                          masked=(7,), lens=[0, 1, 15, 16, 511, 1023, 700,
                                             1500])


def _paged_decode_inputs(dev, dt, cs):
    """q, the two pools, the page table and lens of a paged decode case."""
    p, ps, b, nb, kvh, g, hd = (cs[x] for x in ("p", "ps", "b", "nb", "kvh",
                                                "g", "hd"))
    gen = torch.Generator(device=dev).manual_seed(14)
    mk = lambda *sh: torch.randn(sh, generator=gen, device=dev).to(dt)
    q, kp, vp = mk(b, kvh, g, hd), mk(p, ps, kvh, hd), mk(p, ps, kvh, hd)
    table = _page_table(dev, b, nb, p, 15, cs["masked"])
    lens = torch.tensor(cs["lens"], dtype=torch.int32, device=dev)
    return q, kp, vp, table, lens


def check_paged_decode(kernel, ref, dev, mode=None):
    """Tolerance TOL.  A row with no attendable key (a windowed dead row
    past its table) must give 0, the TPU kernel's value; the plain
    version, which folds every page, gives the mean of the values
    there.  The split-KV edge: a batch whose rows are all dead gives
    exactly 0 everywhere.  With ``mode`` the pools hold codes and the
    scale pools page with them."""
    cases = {
        "main P513 ps16 B8 NB64 KVH3 G3 hd64": dict(
            PAGED_DECODE_SERVE, window=None, softcap=None),
        "softcap 30 ps8": dict(
            p=513, ps=8, b=8, nb=64, kvh=3, g=3, hd=64, masked=(),
            lens=[0, 7, 8, 9, 100, 300, 511, 900], window=None,
            softcap=30.0),
        "window 100 ps24 KVH2 G4 hd48": dict(
            p=60, ps=24, b=8, nb=6, kvh=2, g=4, hd=48, masked=(),
            lens=[0, 5, 23, 24, 25, 143, 200, 400], window=100,
            softcap=None),
        "window 33 softcap 20 ps8 B3 NB7 hd40": dict(
            p=25, ps=8, b=3, nb=7, kvh=2, g=5, hd=40, masked=(2,),
            lens=[40, 55, 60], window=33, softcap=20.0),
        "split every row dead window 16": dict(
            p=513, ps=16, b=8, nb=64, kvh=3, g=3, hd=64, masked=(0, 5),
            lens=[1040, 1100, 1500, 2000, 3000, 1039, 5000, 4096],
            window=16, softcap=None),
    }
    results = {}
    for name, cs in cases.items():
        for dt in (torch.float32, torch.bfloat16):
            p, ps, b, nb, kvh, g, hd = (cs[x] for x in ("p", "ps", "b", "nb",
                                                        "kvh", "g", "hd"))
            q, kp, vp, table, lens = _paged_decode_inputs(dev, dt, cs)
            scale = 1.0 / math.sqrt(hd)
            kw = dict(window=cs["window"], softcap=cs["softcap"],
                      scale=scale)
            if mode:
                (kp, kw["k_scale"]), (vp, kw["v_scale"]) = quantized(
                    mode, kp, vp)
            got = kernel.decode_attention_paged_cuda(q, kp, vp, table, lens,
                                                     **kw)
            want = ref.decode_attention_paged_ref(q, kp, vp, table, lens,
                                                  **kw)
            torch.cuda.synchronize()
            c = nb * ps
            first = [max(n - cs["window"] + 1, 0) if cs["window"] else 0
                     for n in cs["lens"]]
            none = [i for i, (n, f) in enumerate(zip(cs["lens"], first))
                    if f > min(n, c - 1)]
            some = [i for i in range(b) if i not in none]
            err = max_err(got[some], want[some]) if some else 0.0
            zero = max_err(got[none], torch.zeros_like(got[none])) \
                if none else 0.0
            log(f"  decode_attention_paged {mode or ''} {name} "
                f"{str(dt)[6:]}: max |err| {err:.3g} (tol {TOL[dt]:.3g})"
                + (f"; rows {none} attend no key: max |out| {zero} (must "
                   f"be 0)" if none else ""))
            if not err <= TOL[dt] or zero != 0.0:
                raise AssertionError("decode_attention_paged disagrees with "
                                     "its plain version")
            if name.startswith("main") and dt == torch.bfloat16:
                el = kp.element_size()
                keys = sum(min(n, c - 1) + 1 - f
                           for n, f in zip(cs["lens"], first))
                # bytes once: each physical pool row and each table entry
                # the attendable ranges reach, counted once (a masked row
                # reads page 0's rows over and over)
                tab = table.cpu().numpy()
                rows, entries = set(), set()
                for i, (n, f) in enumerate(zip(cs["lens"], first)):
                    pos = np.arange(f, min(n, c - 1) + 1)
                    entries.update((i, j) for j in np.unique(pos // ps))
                    rows.update((tab[i, pos // ps] * ps + pos % ps).tolist())
                nbytes = len(rows) * kvh * 2 * (hd * el + (4 if mode else 0)) \
                    + 2 * q.numel() * q.element_size() \
                    + 4 * (b + len(entries))
                flops = keys * kvh * g * 4 * hd
                tm = {
                    "ms": time_ms(lambda: kernel.decode_attention_paged_cuda(
                        q, kp, vp, table, lens, **kw)),
                    "plain_ms": time_ms(
                        lambda: ref.decode_attention_paged_ref(
                            q, kp, vp, table, lens, **kw), iters=5),
                    "library_ms": None,
                }
                tm["bound_ms"], tm["bound_by"] = bound(nbytes, flops, dt)
                tm.update(device_times(
                    lambda: kernel.decode_attention_paged_cuda(
                        q, kp, vp, table, lens, **kw), None, None))
                log(f"  decode_attention_paged {mode or ''} {name}: device "
                    f"time a call (CUDA graph) {tm_graph(tm)}; library "
                    f"none (no single PyTorch call reads a paged cache)")
                results = dict(tm, max_abs_err=err)
    return results


def check_decode_smem(lib, kernel) -> None:
    """The shared memory the decode kernel launches with (the library's
    ``pmt_decode_smem_bytes``) is the wrapper's ``smem_bytes``, at every
    head width the kernel takes."""
    widths = [(64, 64), (48, 48), (40, 40), (64, 32), (128, 128),
              (96, 200), (256, 256), (512, 512), (320, 512)]
    got = {w: lib.pmt_decode_smem_bytes(*w) for w in widths}
    want = {w: kernel.smem_bytes(*w) for w in widths}
    log(f"  decode_attention shared memory by (hd, hdv): the kernel {got}, "
        f"the wrapper's smem_bytes {want}")
    if got != want:
        raise AssertionError("decode smem_bytes disagrees with the kernel")


def sweep_decode_splits(kernel, ref, dev) -> None:
    """Print the device time a call (CUDA graph) of rows 3 and 7 at each
    split count 1..KERNEL_SPLITS, bf16: row 3's main case at B1 (one row
    at 1023) and B8, row 7's at B8; each count also held to the plain
    version at TOL.  MAX_SPLITS, the wrapper's cap, comes from it."""
    dt = torch.bfloat16
    one = dict(DECODE_SERVE, b=1, lens=[1023])
    scale = 1.0 / math.sqrt(DECODE_SERVE["hd"])
    calls = {}
    for name, cs in (("row 3 B1", one), ("row 3 B8", DECODE_SERVE)):
        q, k, v = _decode_inputs(dev, dt, *(cs[x] for x in (
            "b", "c", "kvh", "g", "hd")))
        lens = torch.tensor(cs["lens"], dtype=torch.int32, device=dev)
        calls[name] = (
            lambda q=q, k=k, v=v, lens=lens: kernel.decode_attention_cuda(
                q, k, v, lens, scale=scale),
            ref.decode_attention_ref(q, k, v, lens, scale=scale), None)
    q, kp, vp, table, lens = _paged_decode_inputs(dev, dt,
                                                  PAGED_DECODE_SERVE)
    calls["row 7 B8"] = (
        lambda: kernel.decode_attention_paged_cuda(q, kp, vp, table, lens,
                                                   scale=scale),
        ref.decode_attention_paged_ref(q, kp, vp, table, lens, scale=scale),
        list(PAGED_DECODE_SERVE["masked"]))
    picked = kernel.split_count
    times = {}
    try:
        for name, (call, want, dead) in calls.items():
            times[name] = {}
            for n in range(1, kernel.KERNEL_SPLITS + 1):
                kernel.split_count = lambda *_, n=n: n
                got = call()
                live = [i for i in range(got.shape[0])
                        if i not in (dead or [])]
                err = max_err(got[live], want[live])
                if not err <= TOL[dt]:
                    raise AssertionError(f"decode at {n} splits disagrees "
                                         f"with its plain version: {err}")
                times[name][n] = graph_ms(call)
    finally:
        kernel.split_count = picked
    for name, by_n in times.items():
        log(f"  decode splits {name}: " + ", ".join(
            f"{n}: {ms:.5f}" for n, ms in by_n.items()) + " ms (CUDA graph)")


# Row 8's case on the serve path: 8 slots of which 2 prefill a 32-token
# chunk (over 256 and 480 cached positions) and 6 ride along with offset
# 0, over pools of 16-token pages (smollm-135m's 3 kv heads of 64).
PAGED_PREFILL_SERVE = dict(p=513, ps=16, b=8, t=32, nb=64, kvh=3, g=3, hd=64,
                           offs=[256, 0, 0, 0, 480, 0, 0, 0], window=None,
                           softcap=None)


def _paged_prefill_inputs(dev, dt, cs):
    """(q, kx, vx, k_pool, v_pool, page_table, offs) of a paged prefill
    case ``cs``."""
    p, ps, b, t, nb, kvh, g, hd = (cs[x] for x in (
        "p", "ps", "b", "t", "nb", "kvh", "g", "hd"))
    gen = torch.Generator(device=dev).manual_seed(16)
    mk = lambda *sh: torch.randn(sh, generator=gen, device=dev).to(dt)
    q, kx, vx = mk(b, kvh, t, g, hd), mk(b, t, kvh, hd), mk(b, t, kvh, hd)
    kp, vp = mk(p, ps, kvh, hd), mk(p, ps, kvh, hd)
    table = _page_table(dev, b, nb, p, 17, cs.get("masked", ()))
    offs = torch.tensor(cs["offs"], dtype=torch.int32, device=dev)
    return q, kx, vx, kp, vp, table, offs


def check_paged_prefill(kernel, ref, dev, mode=None):
    """Tolerance TOL.  Offsets at, just before and just past a page
    boundary, and 0 (no cache page read).  With ``mode`` the pools hold
    codes and the scale pools page with them."""
    cases = {
        "main P513 ps16 B8 T32 NB64 KVH3 G3 hd64": dict(
            p=513, ps=16, b=8, t=32, nb=64, kvh=3, g=3, hd=64,
            offs=[0, 1, 15, 16, 17, 512, 992, 300], window=None,
            softcap=None),
        "serve path: 2 prefilling rows, 6 passengers": PAGED_PREFILL_SERVE,
        "softcap 30 ps8 T16": dict(
            p=513, ps=8, b=8, t=16, nb=64, kvh=3, g=3, hd=64,
            offs=[0, 7, 8, 9, 100, 256, 497, 300], window=None,
            softcap=30.0),
        "window 50 ps24 B3 T17 KVH2 G5 hd40": dict(
            p=40, ps=24, b=3, t=17, nb=5, kvh=2, g=5, hd=40,
            offs=[0, 24, 97], window=50, softcap=None),
        "window 20 softcap 10 ps8 T16": dict(
            p=70, ps=8, b=4, t=16, nb=16, kvh=3, g=3, hd=64,
            offs=[0, 8, 9, 100], window=20, softcap=10.0),
        # split-KV at B8 (8 splits of the 1024 positions): offsets off
        # every share boundary, at 0, at and past the table's end; rows 1
        # and 3 dead (their table all scratch page 0)
        "uneven B8 T32, dead rows": dict(
            p=513, ps=16, b=8, t=32, nb=64, kvh=3, g=3, hd=64,
            offs=[17, 0, 1000, 1024, 1100, 31, 480, 255], window=None,
            softcap=None, masked=(1, 3)),
    }
    results = {}
    for name, cs in cases.items():
        for dt in (torch.float32, torch.bfloat16):
            ps, b, t, nb, kvh, g, hd = (cs[x] for x in (
                "ps", "b", "t", "nb", "kvh", "g", "hd"))
            q, kx, vx, kp, vp, table, offs = _paged_prefill_inputs(dev, dt,
                                                                   cs)
            scale = 1.0 / math.sqrt(hd)
            kw = dict(window=cs["window"], softcap=cs["softcap"],
                      scale=scale)
            if mode:
                (kp, kw["k_scale"]), (vp, kw["v_scale"]) = quantized(
                    mode, kp, vp)
            args = (q, kx, vx, kp, vp, table, offs)
            got = kernel.prefill_attention_paged_cuda(*args, **kw)
            want = ref.prefill_attention_paged_ref(*args, **kw)
            torch.cuda.synchronize()
            err = max_err(got, want)
            log(f"  prefill_attention_paged {mode or ''} {name} "
                f"{str(dt)[6:]}: max |err| {err:.3g} (tol {TOL[dt]:.3g})")
            if not err <= TOL[dt]:
                raise AssertionError("prefill_attention_paged disagrees "
                                     "with its plain version")
            if name.startswith("serve path") and dt == torch.bfloat16:
                el, qel = kp.element_size(), q.element_size()
                prefix = sum(min(o, nb * ps) for o in cs["offs"])
                nbytes = prefix * kvh * 2 * (hd * el + (4 if mode else 0)) \
                    + b * t * kvh * 2 * hd * qel + 2 * q.numel() * qel \
                    + 4 * (b + prefix // ps)
                pairs = t * prefix + b * t * (t + 1) // 2
                flops = pairs * kvh * g * 4 * hd
                tm = {
                    "ms": time_ms(lambda: kernel.prefill_attention_paged_cuda(
                        *args, **kw)),
                    "plain_ms": time_ms(
                        lambda: ref.prefill_attention_paged_ref(*args, **kw),
                        iters=5),
                    "library_ms": None,
                }
                tm["bound_ms"], tm["bound_by"] = bound(nbytes, flops, dt)
                tm["graph_ms"] = graph_ms(
                    lambda: kernel.prefill_attention_paged_cuda(*args, **kw))
                log(f"  prefill_attention_paged {mode or ''} {name}: device "
                    f"time a call (CUDA graph) {tm_graph(tm)}")
                log("  prefill_attention_paged: library none (no single "
                    "PyTorch call reads a paged cache)")
                results = dict(tm, max_abs_err=err)
    return results


# -- phase 3v: MLA's aliased latent cache -------------------------------------
# The v_width branch of rows 2, 3, 7 and 8 (rows 2v, 3v, 7v, 8v).
# deepseek-v3's latent cache at full width is one kv head whose 576-wide
# rows are the keys and, their first 512 lanes, the values, shared by 128
# query heads.  bf16 q takes csrc/latent_attention.cu (tensor cores), fp32
# q the CUDA-core kernels with v's row width passed apart.  The main cases
# are the slice's: decode B8 over C1024, the chunk B1 T32 over a
# 512-position prefix of C1024, and their paged twins on a 513 x 16 x 576
# pool; the odd ones G 3 and 4 at hdq 24 / hdv 16 and hdq 72 / hdv 64.
LATENT = dict(g=128, hd=576, hdv=512)
LATENT_CASES = {
    "decode": dict(b=8, c=1024, pos=[0, 1, 511, 1023, 37, 300, 700, 1000]),
    "prefill": dict(b=1, t=32, c=1024, pos=[512]),
    "decode_paged": dict(p=513, ps=16, b=8, nb=64,
                         pos=[0, 1, 15, 16, 511, 1023, 700, 1000]),
    "prefill_paged": dict(p=513, ps=16, b=8, t=32, nb=64,
                          pos=[0, 1, 15, 16, 17, 512, 992, 300]),
}
LATENT_ODD_CASES = {
    "decode": dict(b=3, c=100, pos=[0, 57, 99]),
    "prefill": dict(b=2, t=9, c=100, pos=[50, 100]),
    "decode_paged": dict(p=40, ps=16, b=3, nb=6, pos=[0, 17, 95]),
    "prefill_paged": dict(p=40, ps=16, b=3, t=9, nb=6, pos=[0, 16, 80]),
}
LATENT_ODD = ((3, 24, 16), (4, 72, 64))          # (G, hdq, hdv)
# the rows' names in the kernels line, by call
LATENT_ROWS = {"decode": "decode_attention v",
               "prefill": "prefill_attention v",
               "decode_paged": "decode_attention_paged v",
               "prefill_paged": "prefill_attention_paged v"}


def _latent_inputs(dev, dt, kind: str, cs: dict, g: int, hd: int):
    """q, the chunk's keys (None at decode), the cache or pool (one kv
    head), the page table (None unpaged) and the positions of a case."""
    gen = torch.Generator(device=dev).manual_seed(21)
    mk = lambda *sh: torch.randn(sh, generator=gen, device=dev).to(dt)
    b = cs["b"]
    decode = kind.startswith("decode")
    q = mk(b, 1, g, hd) if decode else mk(b, 1, cs["t"], g, hd)
    kx = None if decode else mk(b, cs["t"], 1, hd)
    if kind.endswith("paged"):
        cache = mk(cs["p"], cs["ps"], 1, hd)
        table = _page_table(dev, b, cs["nb"], cs["p"], 22)
    else:
        cache, table = mk(b, cs["c"], 1, hd), None
    pos = torch.tensor(cs["pos"], dtype=torch.int32, device=dev)
    return q, kx, cache, table, pos


def _latent_args(kind, q, kx, cache, table, pos) -> tuple:
    """The positional arguments of ``kind``'s kernel wrapper and plain
    version, the cache passed as k and v."""
    return {"decode": (q, cache, cache, pos),
            "decode_paged": (q, cache, cache, table, pos),
            "prefill": (q, kx, kx, cache, cache, pos),
            "prefill_paged": (q, kx, kx, cache, cache, table, pos)}[kind]


def _latent_work(kind, cs, g, hd, hdv, el, mode) -> tuple:
    """(bytes, operations) of a case: each attendable latent row (and its
    scale) read once, q and the chunk's keys read and the output written
    once; 2 (hd + hdv) operations a query head and key."""
    decode = kind.startswith("decode")
    c = cs["nb"] * cs["ps"] if "nb" in cs else cs["c"]
    t = 1 if decode else cs["t"]
    rows = [min(n, c - 1) + 1 if decode else min(n, c) for n in cs["pos"]]
    pairs = sum(t * r + (0 if decode else t * (t + 1) // 2) for r in rows)
    nbytes = sum(rows) * (hd * el + (4 if mode else 0)) \
        + cs["b"] * t * g * 2 * (hd + hdv) + 4 * cs["b"] \
        + (0 if decode else cs["b"] * t * hd * 2)
    if "nb" in cs:
        nbytes += 4 * sum(-(-r // cs["ps"]) for r in rows)
    return nbytes, pairs * g * 2 * (hd + hdv)


def check_latent(fns: dict, dev) -> dict:
    """Rows 2v, 3v, 7v and 8v, each over bf16, int8 and fp8_e4m3 caches,
    against their plain versions on the same inputs (tolerance TOL of q's
    dtype).  ``fns[kind]`` = (kernel wrapper, plain version).  At decode a
    row with no attendable key (lens -1) gives exactly 0.  Each main case
    is timed beside its bounds (bytes and operations) and, over a bf16
    contiguous cache, SDPA over the expanded and sliced tensors.  Returns
    {row name: {mode or "bf16": timings}}."""
    results = {}
    for kind, (kernel, ref) in fns.items():
        row = LATENT_ROWS[kind]
        results[row] = {}
        for mode in (None,) + MODES:
            shapes = [(LATENT_CASES[kind], (LATENT["g"], LATENT["hd"],
                                             LATENT["hdv"]),
                       (torch.bfloat16,))]
            shapes += [(LATENT_ODD_CASES[kind], odd,
                        (torch.float32, torch.bfloat16))
                       for odd in LATENT_ODD]
            for cs, (g, hd, hdv), dts in shapes:
                for dt in dts:
                    q, kx, cache, table, pos = _latent_inputs(dev, dt, kind,
                                                              cs, g, hd)
                    kw = dict(scale=1.0 / math.sqrt(192), v_width=hdv)
                    if mode:
                        (cache, kw["k_scale"]), = quantized(mode, cache)
                    args = _latent_args(kind, q, kx, cache, table, pos)
                    got = kernel(*args, **kw)
                    want = ref(*args, **kw)
                    torch.cuda.synchronize()
                    err = max_err(got, want)
                    label = (f"  {row} {mode or ''} G{g} hd{hd}/{hdv} "
                             f"{str(dt)[6:]}")
                    zero = 0.0
                    if kind.startswith("decode"):
                        dead = _latent_args(kind, q, kx, cache, table,
                                            torch.full_like(pos, -1))
                        out = kernel(*dead, **kw)
                        torch.cuda.synchronize()
                        zero = float(out.float().abs().max())
                    log(f"{label}: max |err| {err:.3g} (tol {TOL[dt]:.3g})"
                        + (f"; lens -1 (no attendable key): max |out| "
                           f"{zero} (must be 0)"
                           if kind.startswith("decode") else ""))
                    if not err <= TOL[dt] or zero != 0.0:
                        raise AssertionError(f"{row} disagrees with its "
                                             f"plain version")
                    if g != LATENT["g"]:
                        continue
                    nbytes, flops = _latent_work(
                        kind, cs, g, hd, hdv, cache.element_size(), mode)
                    call = lambda: kernel(*args, **kw)
                    sdpa = None
                    if not mode and kind == "decode":
                        sdpa = decode_sdpa(q, cache, cache[..., :hdv], pos,
                                           kw["scale"])
                    elif not mode and kind == "prefill":
                        sdpa = prefill_sdpa(q, kx, kx[..., :hdv], cache,
                                            cache[..., :hdv], cs["pos"][0],
                                            kw["scale"])
                    tm = {"ms": time_ms(call),
                          "plain_ms": time_ms(lambda: ref(*args, **kw),
                                              iters=3),
                          "library_ms": None if sdpa is None
                          else library_time(sdpa), "max_abs_err": err,
                          "bound_bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                          "bound_ops_ms": flops / PEAK_FLOPS[dt] * 1e3}
                    tm["bound_ms"], tm["bound_by"] = bound(nbytes, flops, dt)
                    tm.update(device_times(call, sdpa, tm["library_ms"]))
                    log(f"{label}: {tm['ms']:.5f} ms a call by events, "
                        f"{tm_graph(tm, 'SDPA')} in a CUDA graph; plain "
                        f"{tm['plain_ms']:.4f} ms; bound "
                        f"{tm['bound_ms']:.5f} ms ({tm['bound_by']}; bytes "
                        f"{tm['bound_bytes_ms']:.5f}, operations "
                        f"{tm['bound_ops_ms']:.5f})")
                    results[row][mode or "bf16"] = tm
    return results


def check_latent_plan(lib, la) -> None:
    """The latent launcher's plan against the library's: each width
    tier's and cache dtype's shared memory; the splits of decode launches
    (rows 3v, 7v: 16 groups x 8 splits, one wave) and prefill launches
    (rows 2v, 8v) and of small G; and the rule that picks TMA or the
    producer's element copies (16-byte-aligned bases, rows of whole
    16-byte units, page boxes of 8 rows or more; no chunk at decode)."""
    for hd, hdv in ((24, 16), (36, 32), (72, 64), (576, 512)):
        for code in (1, 2, 3):
            got = lib.pmt_latent_smem_bytes(hd, hdv, code)
            if got != la.smem_bytes(hd, code >= 2):
                raise AssertionError(f"latent smem at hd {hd} differs: {got}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b, t, g, c in ((8, 1, 128, 1024), (1, 1, 128, 1024), (3, 1, 3, 100),
                       (3, 1, 4, 96), (32, 1, 128, 1024), (1, 32, 128, 1024),
                       (8, 32, 128, 1024), (2, 9, 3, 100)):
        for decode in ((True, False) if t == 1 else (False,)):
            groups = la.decode_groups(b, 1, g) if decode \
                else la.prefill_groups(b, 1, t, g)
            want = (la.decode_split_count if decode
                    else la.prefill_split_count)(groups, c, sms)
            got = lib.pmt_latent_splits(b, 1, t, g, c, sms, int(decode))
            if got != want:
                raise AssertionError(f"latent splits at B{b} T{t} G{g} C{c} "
                                     f"decode {decode}: {got} != {want}")
    if la.decode_groups(8, 1, 128) * la.decode_split_count(16, 1024, sms) \
            > sms:
        raise AssertionError("the decode's blocks take more than one wave")
    dev = torch.device("cuda")
    for hd in (36, 72, 576):
        for dt in (torch.bfloat16, torch.int8):
            for shift in (0, 1):
                flat = torch.empty(64 * hd + 1, dtype=torch.bfloat16,
                                   device=dev)
                q = flat[shift:shift + 64 * hd].view(1, 1, 1, 64, hd)
                kc = torch.empty(1, 16, 1, hd, dtype=dt, device=dev)
                for ps in (None, 4, 16):
                    for kx in (kc, None):
                        got = lib.pmt_latent_tma(
                            q.data_ptr(), None if kx is None
                            else kx.data_ptr(), kc.data_ptr(), hd, ps or 16,
                            int(ps is not None),
                            1 if dt == torch.bfloat16 else 2)
                        if bool(got) != la.loads_by_tma(q, kx, kc, ps):
                            raise AssertionError(
                                f"the TMA rule differs at hd {hd} {dt} "
                                f"+{shift} ps {ps} kx {kx is not None}")
    log("  latent plan (shared memory, splits, TMA rule) = the library's")


def check_latent_scatters(cu_ops, cu_ref, quant, dev) -> None:
    """Rows 1, 4, 5 and 6 on MLA's one leaf, 576 wide, through the
    one-leaf ops, bit for bit against their plain versions: the copying
    scatters in bf16 and fp32 (a decode step's rows; the paged one also a
    32-row chunk with masked rows), the quantizing ones in int8 and
    fp8_e4m3 (T 1 and 32, contiguous and paged; codes and scales).  The
    paged ones compare outside the scratch page 0."""
    gen = torch.Generator(device=dev).manual_seed(23)
    mk = lambda *sh: torch.randn(sh, generator=gen, device=dev)
    b, c, f, p, ps, nb = 8, 1024, 576, 513, 16, 64
    slots = torch.tensor([0, 5, 1023, 1024, 7, 1, 300, 2], dtype=torch.int32,
                         device=dev)
    table = _page_table(dev, b, nb, p, 24)
    # every row's T <= 32 positions inside its table: no two rows of a
    # batch row clamp onto one slot (whose last write would be the order
    # of the kernel's blocks)
    starts = torch.tensor([0, 3, 17, 992, 8, 9, 40, 1], dtype=torch.int32,
                          device=dev)
    checks = []
    for dt in (torch.bfloat16, torch.float32):
        cache, pool = mk(b, c, f).to(dt), mk(p, ps, f).to(dt)
        new = mk(b, 1, f).to(dt)
        checks.append((f"cache_update F576 {str(dt)[6:]}",
                       cu_ops.cache_update(cache.clone(), new, slots),
                       cu_ref.cache_update_ref(cache.clone(), new, slots)))
        for t in (1, 32):
            rows = mk(b, t, f).to(dt)
            valids = torch.tensor([t, t - 1, 0, t, 1, t, t, t],
                                  dtype=torch.int32, device=dev)
            checks.append((f"paged_cache_update F576 T{t} {str(dt)[6:]}",
                           cu_ops.paged_cache_update(pool.clone(), rows,
                                                     table, starts,
                                                     valids)[1:],
                           cu_ref.paged_cache_update_ref(
                               pool.clone(), rows, table, starts,
                               valids)[1:]))
    for mode in MODES:
        codes, scales = quant.quantize(mk(b, c, f), mode)
        pcodes, pscales = quant.quantize(mk(p, ps, f), mode)
        for t in (1, 32):
            rows = mk(b, t, f).to(torch.bfloat16)
            got = cu_ops.quant_cache_update(codes.clone(), scales.clone(),
                                            rows, slots, mode)
            want = cu_ref.quant_cache_update_ref(codes.clone(),
                                                 scales.clone(), rows,
                                                 slots, mode)
            checks += [(f"quant_cache_update F576 T{t} {mode} codes",
                        u8(got[0]), u8(want[0])),
                       (f"quant_cache_update F576 T{t} {mode} scales",
                        got[1], want[1])]
            valids = torch.tensor([t, t - 1, 0, t, 1, t, t, t],
                                  dtype=torch.int32, device=dev)
            got = cu_ops.quant_paged_cache_update(
                pcodes.clone(), pscales.clone(), rows, table, starts, valids,
                mode)
            want = cu_ref.quant_paged_cache_update_ref(
                pcodes.clone(), pscales.clone(), rows, table, starts, valids,
                mode)
            checks += [(f"quant_paged_cache_update F576 T{t} {mode} codes",
                        u8(got[0][1:]), u8(want[0][1:])),
                       (f"quant_paged_cache_update F576 T{t} {mode} scales",
                        got[1][1:], want[1][1:])]
    torch.cuda.synchronize()
    bad = [name for name, a, w in checks if not torch.equal(a, w)]
    log(f"  the one-leaf scatters at MLA's F 576: {len(checks) - len(bad)} "
        f"of {len(checks)} bit for bit")
    if bad:
        raise AssertionError(f"scatters at F 576 differ: {bad}")


# -- phase 3b: the Fig. 2 kernels against their plain versions ----------------
# Shapes: the Fig. 2 path's (launch/fig2.py FULL), beyond the 50 MB L2,
# and odd ones that leave ragged tiles.

def _randn(dev, *shape, seed=5, dtype=torch.float32):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


def check_fma32(kernel, ref, dev):
    """Tolerance |err| <= 1e-6 * (1 + |want|): both round once per step
    (fused), so they should agree to the bit; a version rounding twice
    per step misses 1e-6 after 1024 steps."""
    results = {}
    for name, shape, iters in (("main 8192x8192", (8192, 8192), 1024),
                               ("odd 1027x771", (1027, 771), 1),
                               ("odd 1027x771", (1027, 771), 64),
                               ("odd 1027x771", (1027, 771), 1024)):
        x = _randn(dev, *shape)
        got = kernel.fma32_cuda(x, iters)
        want = ref.fma32_ref(x, iters)
        torch.cuda.synchronize()
        err = max_err(got, want)
        rel = float(((got - want).abs() / (1 + want.abs())).max())
        log(f"  fma32 {name} iters {iters}: max |err| {err:.3g}, "
            f"max |err| / (1 + |want|) {rel:.3g} (tol 1e-6)")
        if not rel <= 1e-6:
            raise AssertionError("fma32 disagrees with its plain version")
        if name.startswith("main"):
            n = x.numel()
            results = {
                "ms": time_ms(lambda: kernel.fma32_cuda(x, iters)),
                "plain_ms": time_ms(lambda: ref.fma32_ref(x, iters),
                                    iters=2, warmup=1),
                "library_ms": None, "max_abs_err": err}
            results["bound_ms"], results["bound_by"] = bound(
                8.0 * n, 2.0 * n * iters, torch.float32)
    return results


def misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` that starts one element into its
    storage: off the 16-byte alignment of the vector loads."""
    store = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = store[1:].view(t.shape)
    view.copy_(t)
    return view


def check_stream(kernel, ref, dev):
    """Exact: kernel and plain version round the same two operations.
    Cases: the Fig. 2 shape; odd shapes, whose length is no multiple of
    the vector or of the unrolled trip (the masked tail and the
    element-wise end); inputs one element off their alignment (the
    element-wise path)."""
    results = {}
    for name, shape, shift in (("main 16384x16384", (16384, 16384), False),
                               ("odd 1001x777", (1001, 777), False),
                               ("ragged 1x1048589", (1, 2 ** 20 + 13), False),
                               ("misaligned 1001x777", (1001, 777), True)):
        for dt in (torch.float32, torch.bfloat16):
            a = _randn(dev, *shape, seed=6, dtype=dt)
            b = _randn(dev, *shape, seed=7, dtype=dt)
            if shift:
                a, b = misaligned(a), misaligned(b)
            got = kernel.stream_triad_cuda(a, b, 2.5)
            want = ref.stream_triad_ref(a, b, 2.5)
            torch.cuda.synchronize()
            err = max_err(got, want)
            log(f"  stream_triad {name} {str(dt)[6:]} s=2.5: max |err| "
                f"{err} (must be 0)")
            if err != 0.0:
                raise AssertionError("stream_triad disagrees with its "
                                     "plain version")
            if name.startswith("main") and dt == torch.float32:
                n = a.numel()
                results = {
                    "ms": time_ms(lambda: kernel.stream_triad_cuda(
                        a, b, 2.0)),
                    "plain_ms": time_ms(lambda: ref.stream_triad_ref(
                        a, b, 2.0)),
                    "library_ms": time_ms(lambda: torch.add(
                        a, b, alpha=2.0)),
                    "max_abs_err": err}
                results["bound_ms"], results["bound_by"] = bound(
                    12.0 * n, 2.0 * n, torch.float32)
    return results


def check_gemm(kernel, ref, dev):
    """Tolerance 1e-5 of max |want|: both sum exact float32 products in
    float32, in other orders (~1e-7 relative per sum at K = 8192)."""
    results = {}
    for name, (m, k, n) in (("main 8192^3", (8192, 8192, 8192)),
                            ("odd 4097x1023x771", (4097, 1023, 771)),
                            ("K=1 333x1x257", (333, 1, 257)),
                            # K % 16 = 8, M and N off the 128 tile,
                            # rows whole 16-byte units in float32
                            ("ragged 1000x1000x1028", (1000, 1000, 1028))):
        for dt in (torch.float32, torch.bfloat16):
            a = _randn(dev, m, k, seed=8, dtype=dt)
            b = _randn(dev, k, n, seed=9, dtype=dt)
            got = kernel.gemm_cuda(a, b)
            want = ref.gemm_ref(a, b)
            torch.cuda.synchronize()
            err = max_err(got, want)
            scale = float(want.abs().max())
            log(f"  gemm {name} {str(dt)[6:]}: max |err| {err:.3g} "
                f"(tol {1e-5 * scale:.3g} = 1e-5 of max |want|)")
            if not err <= 1e-5 * scale:
                raise AssertionError("gemm disagrees with its plain version")
            if name.startswith("main"):
                el = a.element_size()
                ms = time_ms(lambda: kernel.gemm_cuda(a, b), iters=5,
                             warmup=1)
                t_bound = bound(el * (m * k + k * n) + 4.0 * m * n,
                                2.0 * m * k * n, dt)
                log(f"  gemm {name} {str(dt)[6:]}: kernel {ms:.3f} ms, "
                    f"bound {t_bound[0]:.3f} ms ({t_bound[1]}), "
                    f"{t_bound[0] / ms:.1%} of it")
                if dt == torch.float32:
                    results = {
                        "ms": ms,
                        "plain_ms": time_ms(lambda: ref.gemm_ref(a, b),
                                            iters=5, warmup=1),
                        "library_ms": time_ms(lambda: torch.matmul(a, b),
                                              iters=5, warmup=1),
                        "max_abs_err": err}
                    results["bound_ms"], results["bound_by"] = t_bound
                    lib = results["library_ms"]
                    log(f"  gemm {name} float32: torch.matmul (TF32 off) "
                        f"{lib:.3f} ms, {t_bound[0] / lib:.1%} of the "
                        f"bound; the kernel {ms / lib:.3f}x its time")
    return results


def check_jacobi2d(kernel, ref, dev):
    """Exact: the same sum in the same order, boundary cells copied; x
    unchanged.  Cases: the Fig. 2 shape; odd ones (W % 4 != 0: the
    element path); edges of the kernel's strips of ROWS rows and of its
    warps' 128 columns; x one element into its storage (off the 16-byte
    alignment: the element path at W % 4 == 0).  Times ``x.clone()``
    beside the kernel (``copy_ms``): it moves the same 8 bytes a cell but
    does not compute this function, so it is a ceiling, not the library
    column."""
    results = {}
    rows = kernel.ROWS
    for name, shape, shift in (
            ("main 16384x16384", (16384, 16384), False),
            ("odd 1001x777", (1001, 777), False),
            ("thin 2x9", (2, 9), False),
            ("one 1x1", (1, 1), False),
            (f"strips {rows + 1}x129", (rows + 1, 129), False),
            (f"strips {2 * rows + 1}x513", (2 * rows + 1, 513), False),
            (f"strips {rows - 1}x128", (rows - 1, 128), False),
            (f"strips {rows}x516", (rows, 516), False),
            ("misaligned 1001x780", (1001, 780), True),
            ("misaligned 1001x777", (1001, 777), True)):
        x = _randn(dev, *shape, seed=10)
        if shift:
            x = misaligned(x)
        keep = x.clone()
        got = kernel.jacobi2d_cuda(x)
        want = ref.jacobi2d_ref(x)
        torch.cuda.synchronize()
        err = max_err(got, want)
        log(f"  jacobi2d {name}: max |err| {err} (must be 0)")
        if err != 0.0 or not torch.equal(x, keep):
            raise AssertionError("jacobi2d disagrees with its plain version "
                                 "or wrote x")
        if name.startswith("main"):
            n = x.numel()
            # kernel, clone, clone, kernel: each the mean of its two
            t = [time_ms(f) for f in (lambda: kernel.jacobi2d_cuda(x),
                                      x.clone, x.clone,
                                      lambda: kernel.jacobi2d_cuda(x))]
            results = {
                "ms": (t[0] + t[3]) / 2, "copy_ms": (t[1] + t[2]) / 2,
                "plain_ms": time_ms(lambda: ref.jacobi2d_ref(x)),
                "library_ms": None, "max_abs_err": err}
            results["bound_ms"], results["bound_by"] = bound(
                8.0 * n, 5.0 * n, torch.float32)
            log(f"  jacobi2d {name}: kernel {results['ms']:.5f} ms, "
                f"x.clone() {results['copy_ms']:.5f} ms (the kernel "
                f"{results['ms'] / results['copy_ms']:.4f}x), bound "
                f"{results['bound_ms']:.5f} ms")
    return results


_SASS = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                   r"\s*([^;]*);")


@functools.lru_cache(maxsize=None)
def sass_functions(library: Path) -> tuple:
    """(name, instructions) of every function in the built library, as
    ``cuobjdump -sass`` shows it; one disassembly a library per process
    (the checks of phases 3b and 3f read it a dozen times)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    return tuple(tuple(f.split("\n", 1))
                 for f in re.split(r"\n\s*Function : ", sass)[1:])


def sass_ops_per_term(library: Path, kernel: str, marker: str) -> tuple:
    """FP32 FLOP and SFU (MUFU) instructions per (subgrid, pixel,
    visibility) term in ``kernel``'s loop over staged elements, as
    ``cuobjdump -sass`` shows the built library: FFMA counts 2, FMUL and
    FADD 1.  The loop is the widest backward branch whose span holds no
    barrier; it must hold no forward branch (each trip runs every
    instruction of its body, checked).  The terms in it are counted by
    ``marker``, an opcode each term runs once (MUFU.SIN in the gridder and
    the degridder).  Returns (FLOP per term, MUFU per term, counts of the
    opcodes in the loop, terms in it)."""
    funcs = [text for name, text in sass_functions(library)
             if re.match(rf"\S*{kernel}", name)]
    if len(funcs) != 1:
        raise AssertionError(f"{len(funcs)} SASS functions match {kernel!r}")
    ins = [(int(a, 16), op, args.strip()) for a, op, args in
           _SASS.findall(funcs[0])]
    at = {a: i for i, (a, _, _) in enumerate(ins)}

    def target(args):
        m = re.match(r"`?\(?(0x[0-9a-f]+)", args)
        return int(m.group(1), 16) if m else None

    loops = [(target(x), a) for a, op, x in ins
             if op == "BRA" and target(x) is not None and target(x) < a]
    loops = [(lo, hi) for lo, hi in loops
             if not any(op.startswith("BAR") for a, op, _ in ins
                        if lo <= a <= hi)]
    lo, hi = max(loops, key=lambda span: span[1] - span[0])
    counts, terms = {}, 0
    for a, op, args in ins[at[lo]:at[hi] + 1]:
        to = target(args) if op == "BRA" else None
        if to is not None and to > a:
            raise AssertionError(f"{kernel}: a forward branch at {a:#x} "
                                 f"inside its loop")
        key = op.split(".")[0]
        counts[key] = counts.get(key, 0) + 1
        terms += op == marker or op.startswith(marker + ".")
    if terms < 1:
        raise AssertionError(f"{kernel}: no {marker} in its loop")
    flop = 2 * counts.get("FFMA", 0) + counts.get("FMUL", 0) \
        + counts.get("FADD", 0)
    return flop / terms, counts.get("MUFU", 0) / terms, counts, terms


def gridder_extremes(dev, p: int, s: int, v: int,
                     reach: float = 2.0) -> tuple:
    """(lm, uv) whose phases reach 2 pi reach (4 pi at the default, the
    Fig. 2 range): lm at the four corners +-0.5, on the edges and just
    inside the corners, the rest uniform in [-0.5, 0.5]; uv a quarter at
    +-reach (|phase| = 2 pi reach exactly at a corner), a quarter just
    inside +-reach (non-integer turns near it), a quarter at +-reach in
    one coordinate, the rest uniform in [-reach, reach]."""
    g = torch.Generator(device=dev).manual_seed(12)
    lm = torch.rand((p, 2), generator=g, device=dev) - 0.5
    edge = [[x, y] for x in (-0.5, 0.5) for y in (-0.5, 0.5)] \
        + [[0.5, 0.0], [-0.5, 0.0], [0.0, 0.5], [0.0, -0.5]] \
        + [[x * 0.4999, y * 0.49993] for x in (-1, 1) for y in (-1, 1)]
    lm[: len(edge)] = torch.tensor(edge, device=dev)
    uv = 2.0 * reach * torch.rand((s, v, 2), generator=g, device=dev) - reach
    sign = torch.sign(uv[:, : v // 4])
    uv[:, : v // 4] = reach * sign
    near = torch.rand((s, v // 4, 2), generator=g, device=dev)
    uv[:, v // 4: v // 2] = torch.sign(uv[:, v // 4: v // 2]) * (
        reach - 1e-3 * near)
    uv[:, v // 2: 3 * v // 4, 0] = reach * torch.sign(
        uv[:, v // 2: 3 * v // 4, 0])
    return lm, uv


def check_gridder(kernel, ref, dev, library: Path):
    """Tolerance rtol 1e-4, atol 2e-3 (the JAX tests' own): the phasors
    (both kernels' an unreduced __sincosf on the SFU) and torch's sin/cos
    round differently, and the complex sums (up to ~200 in magnitude at
    V = 2048) run in other orders.  The pair must be adjoint on the card
    within 1e-3 relative.  Cases: the Fig. 2 size, an odd one, the odd
    one with every input one float into its storage (``misaligned``: off
    the 8-byte alignment of a float2 load), phases at 4 pi (uv at +-2,
    the Fig. 2 range: ``gridder_extremes``) and at 32 pi (uv at +-16, the
    widest the pair is held to), at V 2048.  Bound: bytes of each array
    once, the FP32 operations per term counted in the built loop over 67
    TFLOP/s, and its SFU instructions per term over SFU_OPS_PER_S: the
    largest of the three."""
    results = {}
    for name, (p, s, v) in (("main P1024 S1024 V2048", (1024, 1024, 2048)),
                            ("odd P1000 S3 V1999", (1000, 3, 1999)),
                            ("misaligned P1000 S3 V1999", (1000, 3, 1999)),
                            ("extremes P1100 S3 V2048", (1100, 3, 2048)),
                            ("wide P1100 S3 V2048 uv16", (1100, 3, 2048))):
        g = torch.Generator(device=dev).manual_seed(11)
        lm = torch.rand((p, 2), generator=g, device=dev) - 0.5
        uv = 4.0 * torch.rand((s, v, 2), generator=g, device=dev) - 2.0
        vis = torch.randn((s, v, 2), generator=g, device=dev)
        sub = torch.randn((s, p, 2), generator=g, device=dev)
        if name.startswith(("extremes", "wide")):
            reach = 16.0 if name.startswith("wide") else 2.0
            lm, uv = gridder_extremes(dev, p, s, v, reach)
            turns = (lm[None, :, None, :] * uv[:, None, :, :]).sum(-1)
            top = 2 * math.pi * float(turns.abs().max())
            log(f"  {name}: max |phase| {top:.6g} (2 pi x {reach:g} = "
                f"{2 * math.pi * reach:.6g})")
        if name.startswith("misaligned"):
            lm, uv, vis, sub = map(misaligned, (lm, uv, vis, sub))
            if not all(t.data_ptr() % 8 for t in (lm, uv, vis, sub)):
                raise AssertionError("the misaligned inputs are aligned")
        got = {"gridder": kernel.gridder_cuda(lm, uv, vis),
               "degridder": kernel.degridder_cuda(lm, uv, sub)}
        want = {"gridder": ref.gridder_ref(lm, uv, vis),
                "degridder": ref.degridder_ref(lm, uv, sub)}
        torch.cuda.synchronize()
        errs = {}
        for k in got:
            err = max_err(got[k], want[k])
            excess = float(((got[k] - want[k]).abs()
                            - 1e-4 * want[k].abs()).max())
            log(f"  {k} {name}: max |err| {err:.3g}, max |want| "
                f"{float(want[k].abs().max()):.1f}; |err| - 1e-4 |want| at "
                f"most {excess:.3g} (tol 2e-3)")
            if not excess <= 2e-3:
                raise AssertionError(f"{k} disagrees with its plain version")
            errs[k] = err
        lhs = float((got["gridder"].double() * sub.double()).sum())
        rhs = float((vis.double() * got["degridder"].double()).sum())
        rel = abs(lhs - rhs) / max(abs(lhs), 1e-3)
        log(f"  adjoint {name}: <G vis, sub> {lhs:.6g}, <vis, G^T sub> "
            f"{rhs:.6g}, {rel:.3g} apart (tol 1e-3 relative)")
        if not rel < 1e-3:
            raise AssertionError("the card's gridder pair is not adjoint")
        if name.startswith("main"):
            nbytes = 4.0 * (2 * p + 4 * s * v + 2 * s * p)
            terms = float(s) * v * p
            for k, fn, plain, symbol, marker in (
                    ("gridder", lambda: kernel.gridder_cuda(lm, uv, vis),
                     lambda: ref.gridder_ref(lm, uv, vis),
                     "14gridder_kernel", "MUFU.SIN"),
                    ("degridder", lambda: kernel.degridder_cuda(lm, uv, sub),
                     lambda: ref.degridder_ref(lm, uv, sub),
                     "16degridder_kernel", "MUFU.SIN")):
                per_term, sfu, counts, n = sass_ops_per_term(
                    library, symbol, marker)
                log(f"  {k}: {per_term:g} FP32 FLOP and {sfu:g} MUFU per "
                    f"term in its built loop ({n:g} terms a trip, counted "
                    f"by {marker}; per term: "
                    f"{counts.get('FFMA', 0) / n:g} FFMA, "
                    f"{counts.get('FMUL', 0) / n:g} FMUL, "
                    f"{counts.get('FADD', 0) / n:g} FADD; "
                    f"{sum(counts.values()) / n:g} instructions)")
                t = {"ms": time_ms(fn), "plain_ms": time_ms(
                    plain, iters=2, warmup=1), "library_ms": None,
                    "max_abs_err": errs[k], "ops_per_term": per_term,
                    "sfu_per_term": sfu,
                    "bound_fp32_ms": per_term * terms / PEAK_FLOPS[
                        torch.float32] * 1e3,
                    "bound_sfu_ms": sfu * terms / SFU_OPS_PER_S * 1e3,
                    "bound_bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3}
                t["bound_ms"] = max(t["bound_fp32_ms"], t["bound_sfu_ms"],
                                    t["bound_bytes_ms"])
                t["bound_by"] = "bytes" if t["bound_ms"] == t[
                    "bound_bytes_ms"] else "operations"
                log(f"  {k}: bound {t['bound_ms']:.5f} ms, the largest of "
                    f"FP32 {t['bound_fp32_ms']:.5f}, SFU "
                    f"{t['bound_sfu_ms']:.5f}, bytes "
                    f"{t['bound_bytes_ms']:.5f}")
                results[k] = t
    return results


# -- phase 3f: flash attention against its plain version ---------------------
# Shapes: the train path's (B 8, S 2048, 9 query heads on 3 kv heads,
# hd 64, bf16, causal) and odd ones: fp32; GQA groups 1, 3 and 4; a
# window; softcap; both; ragged S 1000 and 77; Sq != Skv both ways; hd
# 16, 32 and 128, 128 also with no window.  fp32 within TOL.  bf16 within
# FLASH_BF16_TOL: beyond the output's one bf16 rounding step (TOL), the
# plain oracle rounds its probabilities to bf16 before p @ v (up to 2^-9
# relative each) and the kernel keeps them to fp32 precision (bf16 p_hi
# + p_lo), which moves outputs of |v| ~ 4 by up to ~2^-7 more.  An H100 measured 2^-6 in every bf16 case.  That bound is
# loose for the later rows, whose |o| averages over ~1000 keys to ~0.05,
# so each bf16 output is also held, element by element, to the fp32
# oracle on the same bf16 values: the kernel differs from it by one
# rounding of its fp32 result to bf16 (at most 2^-8 of |o|) and by fp32
# sums in other orders (FLASH_BF16_ATOL).
FLASH_BF16_TOL = 2.0 ** -5 + 2e-5
FLASH_BF16_REL, FLASH_BF16_ATOL = 2.0 ** -8, 2 * TOL[torch.float32]
# (b, sq, skv, h, kvh, hd, window, softcap); each case in fp32 and bf16
FLASH_CASES = {
    "main B8 S2048 H9 KVH3 hd64": (8, 2048, 2048, 9, 3, 64, None, None),
    "G1 B2 S256 H4 KVH4": (2, 256, 256, 4, 4, 64, None, None),
    "G4 B1 S512 H8 KVH2": (1, 512, 512, 8, 2, 64, None, None),
    "window 128": (1, 512, 512, 4, 2, 64, 128, None),
    "softcap 30": (1, 512, 512, 4, 2, 64, None, 30.0),
    "window 64 + softcap 50": (1, 512, 512, 4, 2, 64, 64, 50.0),
    "ragged S1000": (2, 1000, 1000, 9, 3, 64, None, None),
    "ragged S77 window 20": (3, 77, 77, 9, 3, 64, 20, None),
    "Sq100 Skv300": (2, 100, 300, 4, 2, 64, None, None),
    "Sq300 Skv100": (2, 300, 100, 4, 2, 64, None, None),
    "hd16 S130": (2, 130, 130, 3, 1, 16, None, None),
    "hd32 S256": (2, 256, 256, 4, 2, 32, None, None),
    "hd128 S300": (2, 300, 300, 4, 2, 128, 100, 30.0),
    "hd128 S512 no window": (2, 512, 512, 4, 2, 128, None, None),
}
# bf16 only: q and k scaled by 3.5, so that |s| reaches ~50 (the online
# softmax's running max jumps and alpha rescales the accumulator hard)
FLASH_LARGE_SCORES = ("large scores B2 S1024 H9 KVH3 hd64",
                      (2, 1024, 1024, 9, 3, 64, None, None), 3.5)


# The serve path's whole-prompt prefill (phase 5w, attn_impl "pallas"):
# batch 1 (blocking admission) at power-of-two buckets, and a wave of 8
# at the largest, 9 query heads on 3 kv heads of 64, bf16, causal.  S 8
# is one partial tile of queries and of keys a head.  Each is held to
# the plain version with the bf16 gates above and timed beside SDPA and
# its operation bound.
FLASH_SERVE_CASES = {f"serve prefill B{b} S{s}": (b, s, s, 9, 3, 64, None,
                                                  None)
                     for b, s in ((1, 8), (1, 64), (1, 512), (1, 1024),
                                  (8, 1024))}


def _flash_inputs(dev, dt, b, sq, skv, h, kvh, hd, seed=7, amp=1.0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=gen, device=dev)
    q, k, v = mk(b * h, sq, hd), mk(b * kvh, skv, hd), mk(b * kvh, skv, hd)
    return (amp * q).to(dt), (amp * k).to(dt), v.to(dt)


def sass_opcodes(library: Path, kernel: str) -> list:
    """The opcodes (without modifiers) of every function of the built
    library whose name holds ``kernel``, as ``cuobjdump -sass`` shows
    them: one set per function."""
    return [{op.split(".")[0] for _, op, _ in _SASS.findall(text)}
            for name, text in sass_functions(library) if kernel in name]


def log_ptxas_usage(nvcc_log: str, kernel: str) -> None:
    """Registers and spills of each kernel whose name holds ``kernel``,
    and any ptxas line on its wgmmas (e.g. serialised ones), from the
    ``-Xptxas -v`` lines nvcc printed while it built."""
    for line in nvcc_log.splitlines():
        if "wgmma" in line and kernel in line:
            log(f"  ptxas: {line.strip()}")
    for name, regs, frame, stores, loads in ptxas_usage(nvcc_log, kernel):
        width = re.search(r"ILi(\d+)E", name)
        short = re.search(kernel + r"[a-z0-9]+_kernel", name)
        log(f"  ptxas {short.group(0) if short else name} hd "
            f"{width.group(1) if width else '?'}: Used {regs} registers, "
            f"{frame} bytes stack frame, {stores} bytes spill stores, "
            f"{loads} bytes spill loads")


def check_flash_sass(library: Path) -> None:
    """The bf16 flash kernels (one per head width) run on the tensor cores
    fed by TMA: their SASS holds HGMMA and UTMALDG; the fp32 ones keep the
    CUDA cores: no HGMMA."""
    tc = sass_opcodes(library, "flash_attention_tc_kernel")
    fp32 = sass_opcodes(library, "flash_attention_fp32_kernel")
    log(f"  flash_attention SASS: {len(tc)} bf16 kernels, "
        f"{sum('HGMMA' in f for f in tc)} with HGMMA, "
        f"{sum('UTMALDG' in f for f in tc)} with UTMALDG; {len(fp32)} fp32 "
        f"kernels, {sum('HGMMA' in f for f in fp32)} with HGMMA")
    if not (len(tc) == len(fp32) == 4
            and all({"HGMMA", "UTMALDG"} <= f for f in tc)
            and not any("HGMMA" in f for f in fp32)):
        raise AssertionError("the flash kernels' SASS is not what their "
                             "design says")


def ptxas_usage(nvcc_log: str, kernel: str) -> list:
    """(entry, registers, stack-frame bytes, spill-store bytes,
    spill-load bytes) of every kernel whose name holds ``kernel``, from
    nvcc's ``-Xptxas -v`` lines."""
    rows, name, spill = [], None, (None, None, None)
    for line in nvcc_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1) if kernel in m.group(1) else None
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if name and m:
            spill = tuple(int(x) for x in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if name and m:
            rows.append((name, int(m.group(1)), *spill))
            name = None
    return rows


def nvcc_log(build, source: str) -> str:
    """nvcc's ``-Xptxas -v`` output for one source of csrc/: the building
    process's, or, where this process loaded a library built before, a
    fresh compile of that source alone."""
    if source in build.build_log:
        return build.build_log[source]
    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run(
            [build._nvcc(), *build.NVCC_FLAGS, "-c", str(build.CSRC / source),
             "-o", str(Path(tmp) / "x.o")], capture_output=True, text=True,
            timeout=900, check=True)
    return out.stdout + out.stderr


# The kernels redesigned for Hopper in place of a first port: name in the
# built library, source, how many instantiations, SASS that must be there
# and SASS that must not.
REDESIGNS = (
    # chunked prefill on mma.sync, bf16 q: D 32, 64, 128 x contiguous,
    # paged x a cache of bf16, int8 or fp8_e4m3
    ("prefill_tc_kernel", "prefill_attention.cu", 18, {"HMMA"}, set()),
    # float32 GEMM on the CUDA cores: float32 and bf16 x 16-byte, ragged
    ("gemm_kernel", "gemm.cu", 4, {"FFMA"}, {"HMMA", "HGMMA"}),
    # flash-decode on the CUDA cores, split-KV: float32, bf16, int8, fp8
    # caches x contiguous, paged x D 64, 128, 256, 512
    ("decode_attention_kernel", "decode_attention.cu", 32, {"FFMA"},
     {"HMMA", "HGMMA"}),
    # the STREAM triad, unrolled 16-byte loads: float32, bf16
    ("stream_triad_kernel", "stream.cu", 2, {"LDG", "STG"}, set()),
    # the gridder and the degridder, their phasor on the SFU (MUFU.SIN,
    # MUFU.COS)
    ("14gridder_kernel", "gridder.cu", 1, {"MUFU", "FFMA"}, set()),
    ("16degridder_kernel", "gridder.cu", 1, {"MUFU", "FFMA"}, set()),
    # JACOBI2D's strip walk: 16-byte loads and stores (the 16-byte path)
    # and the element path
    ("jacobi2d_kernel", "jacobi2d.cu", 2, {"LDG", "STG"}, set()),
    # the quantizing scatters, contiguous and paged: float32, bf16 rows x
    # int8, fp8_e4m3 codes x the 16-byte path (lane groups) and the
    # general path (a warp a vector)
    ("quant_scatter_kernel", "cache_update.cu", 8, {"LDG", "STG", "SHFL"},
     set()),
    ("quant_paged_scatter_kernel", "cache_update.cu", 8,
     {"LDG", "STG", "SHFL"}, set()),
    # the copying scatters, contiguous and paged x the 16-byte path and
    # the element path, flat packed
    ("copy_scatter_kernel", "cache_update.cu", 4, {"LDG", "STG"}, set()),
    # MLA's latent attention, decode and the prefill chunk (rows 3v, 7v,
    # 2v, 8v): wgmma fed by TMA, no mma.sync; widths 128, 576 x
    # contiguous, paged x bf16, int8, fp8_e4m3 caches
    ("latent_kernel", "latent_attention.cu", 12, {"HGMMA", "UTMALDG"},
     {"HMMA"}),
)


# Kernels whose spills (a few bytes, ptxas's 168 registers a thread at
# nine warps) must lie outside the tile loop, the span from the first
# HGMMA to the last, rather than be none.
SPILLS_OUTSIDE_LOOP = ("latent_kernel",)


def spills_in_loop(text: str) -> bool:
    """Whether a function's SASS holds a local load or store (LDL, STL)
    between its first and last HGMMA."""
    ops = [op for _, op, _ in _SASS.findall(text)]
    hgmma = [i for i, op in enumerate(ops) if op.startswith("HGMMA")]
    return bool(hgmma) and any(op.startswith(("LDL", "STL"))
                               for op in ops[hgmma[0]:hgmma[-1] + 1])


def check_redesigns(build) -> None:
    """The tensor-core prefill kernels (bf16 q over bf16 or codes) run on
    the tensor cores (their SASS holds HMMA), MLA's latent kernels (decode
    and the prefill chunk) on wgmma fed by TMA (HGMMA and UTMALDG, no
    HMMA), the GEMM and flash-decode
    kernels on the CUDA cores in float32 (FFMA, no HMMA or HGMMA), the
    gridder's and the degridder's phasor on the SFU (MUFU), JACOBI2D's
    16-byte path loads and stores 16 bytes an instruction (LDG and STG
    with a .128 width), the quantizing scatters' lane-group path loads 16
    bytes an instruction (LDG.128), the copying scatters' 16-byte path
    loads and stores 16 bytes an instruction (LDG.128, STG.128), and
    none of them, nor the STREAM triad, spills a byte (ptxas), but MLA's
    latent kernels, which spill nothing in their tile loops."""
    funcs = sass_functions(build.library_path())
    wide = [{op.split(".")[0] for _, op, _ in _SASS.findall(text)
             if ".128" in op}
            for name, text in funcs if "jacobi2d_kernelILi4E" in name]
    log(f"  jacobi2d_kernel<4> SASS: opcodes with a .128 width "
        f"{[sorted(f) for f in wide]}")
    if not (len(wide) == 1 and {"LDG", "STG"} <= wide[0]):
        raise AssertionError("jacobi2d's 16-byte path does not load and "
                             "store 16 bytes an instruction")
    # kVec = true: the template's last argument, "Lb1E" in the name
    groups = [any(op.startswith("LDG") and ".128" in op
                  for _, op, _ in _SASS.findall(text))
              for name, text in funcs
              if "scatter_kernel" in name and "quant" in name
              and "Lb1E" in name]
    log(f"  quantizing scatters' lane-group path: {len(groups)} kernels, "
        f"{sum(groups)} with a 16-byte LDG")
    if not (len(groups) == 8 and all(groups)):
        raise AssertionError("the quantizing scatters' lane-group path does "
                             "not load 16 bytes an instruction")
    copies = [{op.split(".")[0] for _, op, _ in _SASS.findall(text)
               if ".128" in op}
              for name, text in funcs
              if "copy_scatter_kernel" in name and "Lb1E" in name]
    log(f"  copying scatters' 16-byte path: opcodes with a .128 width "
        f"{[sorted(f) for f in copies]}")
    if not (len(copies) == 2 and all({"LDG", "STG"} <= f for f in copies)):
        raise AssertionError("the copying scatters' 16-byte path does not "
                             "load and store 16 bytes an instruction")
    for kernel, source, count, must, must_not in REDESIGNS:
        funcs = sass_opcodes(build.library_path(), kernel)
        usage = ptxas_usage(nvcc_log(build, source), kernel)
        for name, regs, frame, stores, loads in usage:
            args = re.search(kernel + r"I(.*?)EEv", name)  # template args
            log(f"  ptxas {kernel}<{args.group(1) if args else '?'}>: {regs} "
                f"registers, {frame} B stack frame, {stores} B spill "
                f"stores, {loads} B spill loads")
        log(f"  {kernel} SASS: {len(funcs)} functions, "
            f"{sum(must <= f for f in funcs)} with {sorted(must)}, "
            f"{sum(bool(must_not & f) for f in funcs)} with any of "
            f"{sorted(must_not)}")
        if not (len(funcs) == len(usage) == count
                and all(must <= f and not must_not & f for f in funcs)):
            raise AssertionError(f"{kernel}'s SASS is not what its design "
                                 f"says")
        if kernel in SPILLS_OUTSIDE_LOOP:
            loops = [spills_in_loop(text) for name, text in
                     sass_functions(build.library_path()) if kernel in name]
            log(f"  {kernel}: {sum(loops)} of {len(loops)} functions with "
                f"LDL/STL between their first and last HGMMA")
            if any(loops):
                raise AssertionError(f"{kernel} spills in its tile loop")
        elif any(stores or loads for _, _, _, stores, loads in usage):
            raise AssertionError(f"{kernel} spills registers")


def check_flash_smem(lib, kernel) -> None:
    """The shared memory each bf16 flash kernel launches with (the
    library's ``pmt_flash_smem_bytes``) is what the wrapper's
    ``smem_bytes`` checks against SMEM_LIMIT before a launch."""
    got = {hd: lib.pmt_flash_smem_bytes(hd) for hd in kernel.HEAD_DIMS}
    want = {hd: kernel.smem_bytes(hd, kernel.BLOCK_K, kernel.STAGES)
            for hd in kernel.HEAD_DIMS}
    log(f"  flash_attention bf16 shared memory by hd: the kernels {got}, "
        f"the wrapper's smem_bytes {want} (limit {kernel.SMEM_LIMIT})")
    if got != want:
        raise AssertionError("smem_bytes disagrees with the kernel's tiling")


def _backward_ms(ref, q, k, v, kw) -> float:
    """Device time of the op's backward on these inputs: the oracle's
    forward recomputed and its VJP taken (what every layer of a train
    step runs)."""
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    g = torch.ones_like(q)

    def backward():
        torch.autograd.grad(ref.flash_attention_ref(q, k, v, **kw),
                            (q, k, v), g)

    return time_ms(backward, iters=5, warmup=1)


def _flash_timing(kernel, ref, q, k, v, kw, b, sq, h, hd) -> dict:
    """Times of the kernel, its plain version and SDPA on one causal case
    (CUDA events), with the operation bound of its causal pairs."""
    pairs = sq * (sq + 1) // 2
    flops = 4 * b * h * hd * pairs
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    qh, kh, vh = (t.view(b, -1, t.shape[1], hd) for t in (q, k, v))
    tm = {
        "ms": time_ms(lambda: kernel.flash_attention_cuda(q, k, v, **kw),
                      iters=10),
        "plain_ms": time_ms(lambda: ref.flash_attention_ref(q, k, v, **kw),
                            iters=5),
        "library_ms": library_time(
            lambda: F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True, enable_gqa=True,
                scale=kw["scale"])),
        "flops": flops,
    }
    tm["bound_ms"], tm["bound_by"] = bound(nbytes, flops, q.dtype)
    return tm


def _flash_line(name, tm) -> str:
    sdpa = tm["library_ms"]
    return (f"  flash_attention {name} bf16: kernel {tm['ms']:.4f} ms, "
            f"{tm['flops'] / tm['ms'] / 1e9:.1f} TFLOP/s on "
            f"{tm['flops'] / 1e9:.3f} GFLOP, {tm['bound_ms'] / tm['ms']:.1%} "
            f"of its bound {tm['bound_ms']:.5f} ms ({tm['bound_by']}), plain "
            f"{tm['plain_ms']:.4f} ms; SDPA " + (
                "unavailable" if sdpa is None else
                f"{sdpa:.4f} ms, the kernel {tm['ms'] / sdpa:.2f}x its time"))


def check_flash(kernel, ref, ops, dev, library: Path):
    """Phase 3f: the flash-attention kernel against ``flash_attention_ref``
    on every case of FLASH_CASES and, in bf16, FLASH_LARGE_SCORES and
    FLASH_SERVE_CASES; the bf16 kernels' SASS; the op's gradients against
    the oracle's; times at the train path's shapes and at the serve
    prefill's (``serve_prefill`` in the result)."""
    check_flash_sass(library)
    results = {}
    serve = {}
    large, large_case, amp = FLASH_LARGE_SCORES
    cases = [(name, case, dt, 1.0) for name, case in FLASH_CASES.items()
             for dt in (torch.float32, torch.bfloat16)]
    cases.append((large, large_case, torch.bfloat16, amp))
    cases += [(name, case, torch.bfloat16, 1.0)
              for name, case in FLASH_SERVE_CASES.items()]
    for name, (b, sq, skv, h, kvh, hd, window, softcap), dt, amp in cases:
        q, k, v = _flash_inputs(dev, dt, b, sq, skv, h, kvh, hd, amp=amp)
        kw = dict(causal=True, window=window, softcap=softcap,
                  scale=1.0 / math.sqrt(hd))
        got = kernel.flash_attention_cuda(q, k, v, **kw)
        want = ref.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        err = max_err(got, want)
        tol = TOL[dt] if dt == torch.float32 else FLASH_BF16_TOL
        extra, rel = "", 0.0
        if dt == torch.bfloat16:
            # the same oracle in fp32 from the same bf16 values
            exact = ref.flash_attention_ref(q.float(), k.float(),
                                            v.float(), **kw)
            # |err| over its bound, at the worst element (<= 1 passes)
            rel = float(((got.float() - exact).abs() / (
                FLASH_BF16_REL * exact.abs() + FLASH_BF16_ATOL)).max())
            extra = (f"; against the fp32 oracle {max_err(got, exact):.3g}"
                     f", {rel:.3f} of its bound 2^-8 |o| + "
                     f"{FLASH_BF16_ATOL:.0e}; the bf16 oracle against "
                     f"it {max_err(want, exact):.3g}")
            del exact
        if amp != 1.0:
            s0 = (q[0].float() @ k[0].float().T) * kw["scale"]
            extra += f"; max |s| {float(s0.abs().max()):.1f} (head 0)"
        log(f"  flash_attention {name} {str(dt)[6:]}: max |err| "
            f"{err:.3g} (tol {tol:.3g}){extra}")
        if not (err <= tol and rel <= 1.0):
            raise AssertionError("flash_attention disagrees with its "
                                 "plain version")
        if name.startswith("main") and dt == torch.bfloat16:
            tm = _flash_timing(kernel, ref, q, k, v, kw, b, sq, h, hd)
            tm["backward_plain_ms"] = _backward_ms(ref, q, k, v, kw)
            log(_flash_line(name, tm))
            results = dict(tm, max_abs_err=err)
        elif name in FLASH_SERVE_CASES:
            tm = _flash_timing(kernel, ref, q, k, v, kw, b, sq, h, hd)
            log(_flash_line(name, tm))
            serve[name.replace("serve prefill ", "")] = {
                key: tm[key] for key in ("ms", "plain_ms", "library_ms",
                                         "bound_ms", "bound_by")} | {
                "max_abs_err": err}
    # gradients: the op's backward is the oracle's VJP, so they agree to
    # the last bit up to the order of the card's sums (TOL)
    for dt in (torch.float32, torch.bfloat16):
        b, s, h, kvh, hd = 2, 256, 4, 2, 64
        q, k, v = _flash_inputs(dev, dt, b, s, s, h, kvh, hd, seed=8)
        q4 = q.view(b, h, s, hd).transpose(1, 2).detach().requires_grad_()
        k4 = k.view(b, kvh, s, hd).transpose(1, 2).detach().requires_grad_()
        v4 = v.view(b, kvh, s, hd).transpose(1, 2).detach().requires_grad_()
        kw = dict(causal=True, window=96, softcap=30.0, scale=0.125)
        g = torch.randn((b, s, h, hd), device=dev).to(dt)
        got = torch.autograd.grad(ops.flash_attention(q4, k4, v4, **kw),
                                  (q4, k4, v4), g)
        flat = lambda t: t.transpose(1, 2).reshape(-1, s, hd)
        want = torch.autograd.grad(
            ref.flash_attention_ref(flat(q4), flat(k4), flat(v4), **kw),
            (q4, k4, v4), flat(g))
        err = max(max_err(a, w) for a, w in zip(got, want))
        log(f"  flash_attention grads (q, k, v) of the op against the "
            f"oracle's, {str(dt)[6:]}: max |err| {err:.3g} (tol "
            f"{TOL[dt]:.3g})")
        if not err <= TOL[dt]:
            raise AssertionError("flash_attention's gradients disagree with "
                                 "the oracle's")
    results.pop("flops")
    return dict(results, serve_prefill=serve)


# -- phase 4: small reference -------------------------------------------------

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
    # the paged steps: a shuffled page table, per-row offsets, a
    # passenger row (last_idx -1), then a decode step
    pfns = model_mod.make_paged_serve_fns(cfg)
    table = torch.tensor([[5, 2, 9, 7], [3, 8, 1, 6]], dtype=torch.int32)
    offs, last = torch.tensor([0, 5]), torch.tensor([7, -1])
    out = {}
    for dev in ("cpu", "cuda"):
        p = model_mod.serving_params(cfg, params, dev)
        pools = model_mod.init_paged_caches(cfg, 10, 8, torch.float32, dev)
        lp = pfns.prefill_chunk(p, pools, toks[:, :8].to(dev), offs.to(dev),
                                last.to(dev), table.to(dev))
        ld = pfns.decode(p, pools, toks[:, -1:].to(dev),
                         torch.tensor([8, 9], device=dev), table.to(dev))
        out[dev] = [lp[:1].cpu(), ld.cpu()] + [
            t[:, 1:].cpu() for t in (pools["units"]["r0"]["k"],
                                     pools["units"]["r0"]["v"])]
    err = max(max_err(a, b) for a, b in zip(out["cpu"], out["cuda"]))
    log(f"  reduced fp32 paged prefill_chunk + decode logits and pools "
        f"(outside page 0), card vs CPU: max |err| {err:.3g} (tol 1e-4)")
    if not err <= 1e-4:
        raise AssertionError("paged serve steps on the card disagree with "
                             "the CPU")
    mix = [([1, 2, 3], 8), ([4, 5], 3), ([6], 1),
           ([7, 8, 9, 10, 11, 12, 13, 14, 15], 5), ([2], 12)]
    runs = {}
    for dev, layout in (("cpu", "contiguous"), ("cuda", "contiguous"),
                        ("cpu", "paged"), ("cuda", "paged")):
        kw = dict(kv_layout="paged", kv_page_size=8) \
            if layout == "paged" else {}
        eng = ServeEngine(cfg, params, batch_size=2, max_len=64,
                          prefill_chunk=4, cache_dtype=torch.float32,
                          device=dev, **kw)
        runs[dev, layout] = [r.out for r in eng.generate(
            [Request(prompt=p, max_new_tokens=n) for p, n in mix])]
    same = {k: v == runs["cuda", "paged"] for k, v in runs.items()}
    log(f"  reduced fp32 engine greedy tokens, paged engine on the card "
        f"equal to: {same}")
    if not all(same.values()):
        raise AssertionError(f"engine tokens differ: {runs}")


def ordinals(codes: torch.Tensor) -> torch.Tensor:
    """Codes as integers in value order: int8 as they are, fp8_e4m3 as
    its sign-magnitude byte, so neighbouring values differ by 1."""
    if codes.dtype == torch.int8:
        return codes.int()
    u = codes.view(torch.uint8).int()
    return torch.where(u >= 128, -(u & 0x7F), u & 0x7F)


def code_flips(a: dict, b: dict, skip_page0: bool = False) -> int:
    """Codes of two caches one step apart (raises on any further apart),
    and scales within 1e-5 relative."""
    flips = 0
    for name in ("k", "v"):
        x, y = ordinals(a[name].cpu()), ordinals(b[name].cpu())
        s, t = a[f"{name}_scale"].cpu(), b[f"{name}_scale"].cpu()
        if skip_page0:
            x, y, s, t = x[:, 1:], y[:, 1:], s[:, 1:], t[:, 1:]
        d = (x - y).abs()
        if int(d.max()) > 1 or not torch.allclose(s, t, rtol=1e-5, atol=0):
            raise AssertionError(f"{name}: codes {int(d.max())} steps apart "
                                 f"or scales apart, card vs CPU")
        flips += int((d == 1).sum())
    return flips


# Card against CPU on a quantized cache: with equal codes the logits
# differ as the fp32 steps do, so they are held to the fp32 steps' 1e-4
# (measured 5.07e-07); a code can also land one step apart where the two
# sides' k/v straddle a rounding boundary in their last bits, which moves
# these logits by up to ~1e-3 (fp8) each, so with such codes the gate
# allows 1e-2.
QUANT_CARD_TOL = 1e-2
QUANT_CARD_EQUAL_CODES_TOL = 1e-4


def check_small_quantized(configs, model_mod, ServeEngine, Request):
    """Reduced smollm-135m, fp32, int8 and fp8_e4m3 caches: the serve
    steps on the card (kernels) against the CPU (plain versions),
    contiguous and paged; the drift gate of tests/test_quant_serve.py on
    the card; the engine's greedy tokens equal on card and CPU in both
    layouts."""
    base = dataclasses.replace(configs.get_config("smollm-135m",
                                                  reduced=True),
                               dtype="float32")
    params = model_mod.init_params(base, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    t = 32
    toks = torch.as_tensor(rng.integers(0, base.vocab_size, (2, t)))
    padded = torch.zeros_like(toks)
    padded[:, :t - 1] = toks[:, :t - 1]
    table = torch.tensor([[5, 2, 9, 7], [3, 8, 1, 6]], dtype=torch.int32)
    offs, last = torch.tensor([0, 5]), torch.tensor([7, -1])

    def contiguous_steps(cfg, dev):
        """Prefill t - 1 tokens in chunks of 8, then two decode steps."""
        fns = model_mod.make_serve_fns(cfg)
        p = model_mod.serving_params(cfg, params, dev)
        caches = model_mod.init_caches(cfg, 2, t + 4, torch.float32, dev)
        for off in range(0, t, 8):
            fns.prefill_chunk(p, caches, padded[:, off:off + 8].to(dev), off,
                              min(t - 2 - off, 7))
        l1 = fns.decode(p, caches, toks[:, t - 1:].to(dev), t - 1)
        l2 = fns.decode(p, caches, toks[:, :1].to(dev), t)
        return [l1.cpu(), l2.cpu()], caches["units"]["r0"]

    def paged_steps(cfg, dev):
        pfns = model_mod.make_paged_serve_fns(cfg)
        p = model_mod.serving_params(cfg, params, dev)
        pools = model_mod.init_paged_caches(cfg, 10, 8, torch.float32, dev)
        lp = pfns.prefill_chunk(p, pools, toks[:, :8].to(dev), offs.to(dev),
                                last.to(dev), table.to(dev))
        ld = pfns.decode(p, pools, toks[:, -1:].to(dev),
                         torch.tensor([8, 9], device=dev), table.to(dev))
        return [lp[:1].cpu(), ld.cpu()], pools["units"]["r0"]

    ref = contiguous_steps(base, "cuda")[0]
    mix = [([1, 2, 3], 8), ([4, 5], 3), ([6], 1),
           ([7, 8, 9, 10, 11, 12, 13, 14, 15], 5), ([2], 12)]
    for mode in MODES:
        cfg = dataclasses.replace(base, kv_quant=mode)
        for layout, steps in (("contiguous", contiguous_steps),
                              ("paged", paged_steps)):
            (lc, cc), (lg, cg) = steps(cfg, "cpu"), steps(cfg, "cuda")
            err = max(max_err(a, b) for a, b in zip(lc, lg))
            flips = code_flips(cc, cg, skip_page0=layout == "paged")
            tol = QUANT_CARD_TOL if flips else QUANT_CARD_EQUAL_CODES_TOL
            log(f"  reduced fp32 {mode} {layout} serve steps, card vs CPU: "
                f"logits max |err| {err:.3g} (tol {tol}), "
                f"{flips} codes one step apart, scales within 1e-5")
            if not err <= tol:
                raise AssertionError(f"{mode} {layout} serve steps on the "
                                     f"card disagree with the CPU")
            if layout == "contiguous":
                drift = max(max_err(a, b) for a, b in zip(lg, ref))
                gate = DRIFT_GATE[mode] * max(float(ref[0].abs().max()), 1.0)
                finite = all(bool(torch.isfinite(x).all()) for x in lg)
                log(f"  reduced fp32 {mode} decode on the card against the "
                    f"fp32 cache: max |dlogit| {drift:.4g} (gate {gate:.4g}: "
                    f"{DRIFT_GATE[mode]} of max(max |logit|, 1))")
                if not (finite and drift < gate):
                    raise AssertionError(f"{mode} drift gate failed")
        runs = {}
        for dev, layout in (("cpu", "contiguous"), ("cuda", "contiguous"),
                            ("cpu", "paged"), ("cuda", "paged")):
            kw = dict(kv_layout="paged", kv_page_size=8) \
                if layout == "paged" else {}
            eng = ServeEngine(base, params, batch_size=2, max_len=64,
                              prefill_chunk=4, cache_dtype=mode, device=dev,
                              **kw)
            runs[dev, layout] = [r.out for r in eng.generate(
                [Request(prompt=p, max_new_tokens=n) for p, n in mix])]
        same = {k: v == runs["cuda", "paged"] for k, v in runs.items()}
        log(f"  reduced fp32 {mode} engine greedy tokens, paged engine on "
            f"the card equal to: {same}")
        if not all(same.values()):
            raise AssertionError(f"{mode} engine tokens differ: {runs}")


def check_small_baselines(configs, model_mod, ServeEngine, Request,
                          cu_kernel) -> None:
    """Reduced smollm-135m, fp32: the serve baselines' engines on the card
    against the CPU.  Blocking admission (fp32 and int8 caches), waves and
    the dense decode give the same greedy tokens on both; a sampled run
    repeats its tokens under its seed on the card and another seed gives
    others.  The int8 blocking run on the card launches the quantizing
    scatter once a layer a whole-prompt prefill and a decode step."""
    cfg = dataclasses.replace(configs.get_config("smollm-135m", reduced=True),
                              dtype="float32")
    params = model_mod.init_params(cfg, seed=0, device="cpu")
    mix = [([1, 2, 3], 8), ([4, 5], 3), ([6], 1),
           ([7, 8, 9, 10, 11, 12, 13, 14, 15], 5), ([2], 12)]
    reqs = lambda: [Request(prompt=p, max_new_tokens=n) for p, n in mix]
    for label, kw in (
            ("blocking", dict(prefill_chunk=0)),
            ("blocking int8", dict(prefill_chunk=0, cache_dtype="int8")),
            ("wave", dict(mode="wave")),
            ("dense decode", dict(prefill_chunk=4,
                                  decode_attn_impl="dense"))):
        kw.setdefault("cache_dtype", torch.float32)
        runs = {}
        for dev in ("cpu", "cuda"):
            eng = ServeEngine(cfg, params, batch_size=2, max_len=64,
                              device=dev, **kw)
            if dev == "cuda":
                steps = count_steps(eng)
                cu_kernel.quant_launches = 0
            runs[dev] = [r.out for r in eng.generate(reqs())]
        same = runs["cuda"] == runs["cpu"]
        log(f"  reduced fp32 {label} engine greedy tokens, card equal to "
            f"CPU: {same}")
        if not same:
            raise AssertionError(f"{label} engine tokens differ: {runs}")
        if label == "blocking int8":
            # one quantizing write a layer a whole-prompt prefill and a
            # decode step
            want = cfg.num_layers * (steps["prefill"] + steps["decode"])
            log(f"  reduced int8 blocking on the card: quant_cache_update "
                f"launched {cu_kernel.quant_launches} times for "
                f"{steps['prefill']} whole-prompt prefills and "
                f"{steps['decode']} decode steps of {cfg.num_layers} layers "
                f"(must be {want})")
            if cu_kernel.quant_launches != want:
                raise AssertionError("the quantizing scatter is not launched "
                                     "once a layer a prefill and a step")

    def sampled(seed):
        eng = ServeEngine(cfg, params, batch_size=2, max_len=64,
                          prefill_chunk=4, cache_dtype=torch.float32,
                          greedy=False, temperature=1.5, seed=seed,
                          device="cuda")
        return [r.out for r in eng.generate(reqs())]

    a, b, c = sampled(0), sampled(0), sampled(1)
    log(f"  reduced fp32 sampling on the card (temperature 1.5): seed 0 "
        f"twice equal {a == b}, seed 1 differs {a != c}")
    if not (a == b and a != c):
        raise AssertionError("sampling is not deterministic per seed")


# -- phase 5: serve at full width ---------------------------------------------

def serve_full(configs, model_mod, ServeEngine, Request, kernels, nvml,
               pmt, serve_launch, telemetry, PowerGovernor):
    """Serve the 16 requests twice on one engine measured through one
    PMT session (cpuutil + nvml): the first run is the main path's (its
    launch counts go into the ``kernels`` line), the second measures the
    spread of tokens/s and J/token on this card, under an observer
    governor (no cap) over a ``PowerRecorder`` attached to the session
    and the engine (phase 5g (a)): its tokens must equal the first run's,
    and it measures the run's card watts and how old the newest watts
    sample is at each decode step.  Returns, besides phase 5's figures,
    the engine, its session and the recorder for phase 5g."""
    cfg = configs.get_config("smollm-135m")
    params = model_mod.init_params(cfg, seed=0, device="cuda")
    session = pmt.Session(["cpuutil", "nvml"])
    energy = session.add_exporter(pmt.MemoryExporter())
    eng = ServeEngine(cfg, params, batch_size=8, max_len=1024,
                      prefill_chunk=32, cache_dtype=torch.bfloat16,
                      session=session)
    rng = np.random.default_rng(0)
    warm, prompts = serve_workload(cfg, Request, rng)
    eng.generate(warm)
    torch.cuda.synchronize()
    lengths = [len(p) for p in prompts]
    log(f"  prompts {min(lengths)}-{max(lengths)} tokens, 64 new tokens "
        f"each")
    reader = nvml.NvmlReader(0)
    steps = count_steps(eng)
    runs = []
    recorder = telemetry.PowerRecorder().attach(session, exporter=energy)
    recorder.attach_engine(eng)
    observed = {}
    try:
        log(f"  NVML: {reader.name()}, enforced power limit "
            f"{reader.power_limit_watts():.0f} W, now "
            f"{reader.power_watts():.0f} W")
        for i in (1, 2):
            steps.update(decode=0, chunk=0)
            if i == 2:
                observed = observe_run(eng, recorder, PowerGovernor)
            runs.append(served_run(eng, Request, prompts, kernels,
                                   nvml.EnergyMeter(reader), i, session,
                                   energy, serve_launch))
            # the bf16 contiguous chunk is two slice copies a layer
            check_once_a_layer(cfg, runs[-1][0], steps, "cache_update",
                               f"run {i}", chunks=False)
        observed.update(observed.pop("finish")())
    finally:
        reader.close()
    if runs[1][1] != runs[0][1]:
        raise AssertionError("phase 5g (a): the observer-governed run's "
                             "tokens differ from run 1's")
    log(f"  5g (a): run 2 under an observer governor (no cap, backend "
        f"nvml): tokens equal to run 1's; {observed['decisions']} "
        f"decisions; card {observed['watts']:.2f} W over the run "
        f"({observed['samples']} samples, window peak "
        f"{observed['window_peak']:.2f} W); the newest watts sample's age "
        f"at a decode step: median {observed['age_p50'] * 1e3:.1f} ms, "
        f"p99 {observed['age_p99'] * 1e3:.1f} ms, max "
        f"{observed['age_max'] * 1e3:.1f} ms over {observed['ages']} steps "
        f"(a signal_ttl_s under the max would have declared the signal "
        f"stale in this run)")
    traced = trace_serve(eng, cfg, Request, rng)
    live = dict(eng=eng, session=session, energy=energy, recorder=recorder,
                observed=observed)
    return runs[0][0], prompts, runs[0][1], \
        eng.stats()["kv_cache"]["bytes_per_token"], traced, runs[0][2], live


def nvml_window(recorder, n0: int, window_s: float,
                ramp_s: float = 0.0) -> tuple:
    """The card's watts the recorder gathered since its ``n0``-th nvml
    sample: (mean, samples, the largest mean over a trailing
    ``window_s`` window, windows ending ``ramp_s`` after the first
    sample on)."""
    recorder.poll_once()
    series = recorder.watts_series("nvml").get("nvml", [])[n0:]
    if not series:
        return float("nan"), 0, float("nan")
    peak = float("-inf")
    lo = 0
    for i, (t, _) in enumerate(series):
        while series[lo][0] < t - window_s:
            lo += 1
        if t >= series[0][0] + ramp_s:
            win = [w for _, w in series[lo:i + 1]]
            peak = max(peak, sum(win) / len(win))
    mean = sum(w for _, w in series) / len(series)
    return mean, len(series), peak


def observe_run(eng, recorder, PowerGovernor) -> dict:
    """Phase 5g (a): put an observer governor (no cap, the nvml backend)
    on the engine and time, at each decode step, the age of the newest
    nvml sample on the recorder (what a ``signal_ttl_s`` is held
    against).  Returns ``{"finish": f}``; ``f()`` takes the observer and
    the wrapper off and returns the figures of the run."""
    recorder.poll_once()
    n0 = len(recorder.watts_series("nvml").get("nvml", []))
    gov = PowerGovernor(recorder, backend="nvml")
    eng.governor = gov
    fns = eng._fns
    ages = []

    def decode(*args):
        last = recorder.last_watts_ts(backend="nvml")
        if last is not None:
            ages.append(time.monotonic() - last)
        return fns.decode(*args)

    eng._fns = fns._replace(decode=decode)

    def finish() -> dict:
        eng._fns, eng.governor = fns, None
        gov.close()
        mean, n, peak = nvml_window(recorder, n0, gov.window_s)
        xs = sorted(ages) or [float("nan")]
        pick = lambda q: xs[min(len(xs) - 1, int(q * (len(xs) - 1)))]
        if gov.throttle_count:
            raise AssertionError(f"phase 5g (a): the observer decided "
                                 f"{list(gov.decisions)}")
        return {"decisions": gov.throttle_count, "watts": mean,
                "samples": n, "window_peak": peak, "ages": len(ages),
                "age_p50": pick(0.5), "age_p99": pick(0.99),
                "age_max": xs[-1]}

    return {"finish": finish}


def serve_workload(cfg, Request, rng) -> tuple:
    """Phase 5's requests, drawn from ``rng``: two short warm-up requests,
    and the 16 prompts (64-700 tokens, shuffled) that a timed run serves
    with 64 new tokens each."""
    warm = [Request(prompt=rng.integers(0, cfg.vocab_size, 40).tolist(),
                    max_new_tokens=4) for _ in range(2)]
    lengths = rng.permutation(np.linspace(64, 700, 16).astype(int))
    return warm, [rng.integers(0, cfg.vocab_size, n).tolist()
                  for n in lengths]


def served_run(eng, Request, prompts, kernels, meter, index, session,
               energy, serve_launch, priorities=None):
    """One timed, metered serve run with every launch count set to 0
    just before it; checks its output and its PMT records (a wave engine
    opens no request spans: its ``serve/wave<N>`` regions are checked
    instead), and returns the counts read just after it, each request's
    tokens and the run's figures (tokens/s, J/token, stall p95 ms).  A
    preempted request's spans, one set a stay in a slot, are summed."""
    reqs = [Request(prompt=p, max_new_tokens=64, priority=pr)
            for p, pr in zip(prompts, priorities or [0] * len(prompts))]
    session.flush()
    n_before = len(energy.records)
    zero_counts(kernels)
    meter.start()
    t0 = time.perf_counter()
    done = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    joules = meter.stop()
    launches = read_counts(kernels)
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
    session.flush()
    records = energy.records[n_before:]
    by_req = serve_launch.request_energy(records)
    waves = {rec.path: rec.tokens for rec in records
             if rec.path.startswith("serve/wave")}
    if eng.mode == "wave":
        # one region a wave of a batch, counting its generated tokens
        want = math.ceil(len(done) / eng.batch)
        if by_req or len(waves) != want or sum(waves.values()) != gen:
            raise AssertionError(f"wave regions {waves} are not {want} "
                                 f"counting {gen} tokens")
        done = []
    for r in done:
        d = by_req.get(f"serve/req{r.id}")
        if d is None or d["joules"] <= 0:
            raise AssertionError(f"request {r.id} has no resolved "
                                 f"serve/req{r.id} record")
        split = d["prefill"] + d["decode"]
        if not abs(split - d["joules"]) <= 0.01 * d["joules"]:
            raise AssertionError(
                f"request {r.id}: prefill + decode {split:.4f} J against "
                f"its span's {d['joules']:.4f} J (more than 1% apart)")
    agg = sum(rec.joules for rec in records
              if rec.path.startswith(("serve/batch", "serve/wave"))
              and rec.sensor == "nvml")
    st = eng.stats()
    stalls = "whole-prompt prefills" if eng.mode == "wave" \
        or not eng.prefill_chunk else "chunks"
    log(f"  run {index}: {len(reqs)} requests, {gen} generated tokens in "
        f"{wall:.3f} s: {gen / wall:.1f} tokens/s; stall p95 "
        f"{st['stall_p95_s'] * 1e3:.2f} ms over {st['stall_events']} "
        f"{stalls}; energy {joules:.1f} J ({meter.method}): "
        f"{joules / gen:.4f} J per generated token; through the PMT "
        f"session (nvml) {agg:.1f} J, {agg / gen:.4f} J/token")
    if eng.mode == "wave":
        log(f"  run {index}: {len(waves)} serve/wave<N> regions, counting "
            f"{gen} generated tokens")
    else:
        log(f"  run {index}: every request's serve/req<N> span resolved, "
            f"prefill + decode within 1% of its total")
    for line in serve_launch.energy_report(records, gen,
                                           ["cpuutil", "nvml"]):
        log(f"  run {index}: {line}")
    log(f"  run {index}: kernel launches {launches}")
    figures = {"tokens_per_s": gen / wall, "joules_per_token": joules / gen,
               "stall_p95_ms": st["stall_p95_s"] * 1e3,
               "stall_events": st["stall_events"], "wall_s": wall}
    return launches, [r.out for r in reqs], figures


def serve_paged(configs, model_mod, ServeEngine, Request, kernels, nvml,
                pmt, serve_launch, serve_kernels):
    """Phase 5b: the paged engine at full width, 16 requests sharing a
    256-token system prompt, served twice on one engine (cold, then
    warm) through one PMT session (cpuutil + nvml).  Between the runs
    the engine learns the card's joules per prefill token from the
    resolved ``serve/req<N>/prefill`` records (``on_record``), so the
    warm run prices its prefix hits.  Checks every request's tokens and
    record, that the three paged kernels ran and the three contiguous
    ones did not, the pool gauges, and the prefix hits.  Returns the
    cold run's launch counts."""
    cfg = configs.get_config("smollm-135m")
    params = model_mod.init_params(cfg, seed=0, device="cuda")
    session = pmt.Session(["cpuutil", "nvml"])
    energy = session.add_exporter(pmt.MemoryExporter())
    eng = ServeEngine(cfg, params, batch_size=8, max_len=1024,
                      prefill_chunk=32, cache_dtype=torch.bfloat16,
                      kv_layout="paged", kv_page_size=16, session=session)
    kc = eng.stats()["kv_cache"]
    # bytes_per_token counts every pool leaf over the usable positions
    pool_bytes = kc["bytes_per_token"] * kc["pages_total"] * kc["page_size"]
    log(f"  pool: {kc['pages_total']} usable pages of {kc['page_size']} "
        f"tokens + the scratch page, {pool_bytes / 1e6:.1f} MB over "
        f"{cfg.num_layers} layers")
    rng = np.random.default_rng(1)
    system = rng.integers(0, cfg.vocab_size, 256).tolist()
    lengths = rng.permutation(np.linspace(64, 444, 16).astype(int))
    prompts = [system + rng.integers(0, cfg.vocab_size, n).tolist()
               for n in lengths]
    log(f"  prompts: a 256-token system prompt + {int(lengths.min())}-"
        f"{int(lengths.max())} unique tokens, 64 new tokens each")
    warm = [Request(prompt=rng.integers(0, cfg.vocab_size, 40).tolist(),
                    max_new_tokens=4) for _ in range(2)]
    eng.generate(warm)
    torch.cuda.synchronize()
    reader = nvml.NvmlReader(0)
    steps = count_steps(eng)
    outs, launches = [], None
    try:
        for index, name in ((1, "cold"), (2, "warm")):
            hit0 = eng.prefix_hit_tokens
            saved0 = eng.saved_prefill_joules
            zero_counts(serve_kernels)
            steps.update(decode=0, chunk=0)
            counts, out, _ = served_run(eng, Request, prompts, kernels,
                                        nvml.EnergyMeter(reader), index,
                                        session, energy, serve_launch)
            check_once_a_layer(cfg, counts, steps, "paged_cache_update",
                               f"run {index}", chunks=True)
            contiguous = read_counts(serve_kernels)
            log(f"  run {index}: contiguous kernel launches {contiguous} "
                f"(must be 0: the path is paged)")
            if any(contiguous.values()):
                raise AssertionError("the paged path launched a contiguous "
                                     "kernel")
            kc = eng.stats()["kv_cache"]
            hits = eng.prefix_hit_tokens - hit0
            saved = eng.saved_prefill_joules - saved0
            log(f"  run {index} ({name}): "
                f"{serve_launch.kv_pool_line(kc)}; this run: {hits} prompt "
                f"tokens off the tree, ~{saved:.3f} J prefill saved")
            if kc["pages_used"] + kc["pages_free"] != kc["pages_total"]:
                raise AssertionError(f"pool gauges do not add up: {kc}")
            if kc["pages_used"] != kc["prefix_nodes"]:
                raise AssertionError(
                    f"{kc['pages_used']} pages held after the run, but the "
                    f"prefix tree holds {kc['prefix_nodes']}")
            if hits <= 0:
                raise AssertionError(f"run {index}: no prefix hits")
            if name == "warm" and not saved > 0:
                raise AssertionError("the warm run priced no saved prefill "
                                     "joules")
            outs.append(out)
            if launches is None:
                launches = counts
            # the card's J per prefill token, from this run's records
            session.flush()
            for rec in energy.records:
                if rec.sensor == "nvml":
                    eng.on_record(rec)
    finally:
        reader.close()
    agree = sum(a == b for a, b in zip(*outs))
    log(f"  warm vs cold tokens: {agree} of {len(outs[0])} requests equal "
        f"(not gated in bf16: an off-grid resume reorders sums)")
    trace_serve(eng, cfg, Request, rng)
    session.close()
    return launches


def count_steps(eng) -> dict:
    """Wrap the engine's serve steps (both layouts') so that each call
    adds one to its count: {"decode": steps, "chunk": prefill chunks,
    "prefill": whole-prompt prefills}."""
    steps = {"decode": 0, "chunk": 0, "prefill": 0}

    def counted(fn, key):
        def call(*args):
            steps[key] += 1
            return fn(*args)
        return call

    for attr in ("_fns", "_paged_fns"):
        fns = getattr(eng, attr, None)
        if fns is not None:
            fns = fns._replace(
                decode=counted(fns.decode, "decode"),
                prefill_chunk=counted(fns.prefill_chunk, "chunk"))
            if hasattr(fns, "prefill"):
                fns = fns._replace(prefill=counted(fns.prefill, "prefill"))
            setattr(eng, attr, fns)
    return steps


def check_once_a_layer(cfg, counts, steps, scatter, label,
                       chunks: bool) -> None:
    """The scatter launched once a layer per decode step and, where
    ``chunks``, per prefill chunk: k and v in one launch.  Prints its
    launches a decode step beside the two a layer that one launch a leaf
    made."""
    n_steps = steps["decode"] + (steps["chunk"] if chunks else 0)
    want = cfg.num_layers * n_steps
    where = "decode step and prefill chunk" if chunks else \
        "decode step (the chunks' writes are copies)"
    log(f"  {label}: {scatter} launched {counts[scatter]} times for "
        f"{steps['decode']} decode steps and {steps['chunk']} prefill "
        f"chunks of {cfg.num_layers} layers (must be {want}: once a layer a "
        f"{where}, k and v in one launch); {counts[scatter] / n_steps:g} a "
        f"step, where one launch a leaf made {2 * cfg.num_layers}")
    if counts[scatter] != want:
        raise AssertionError(f"{label}: {scatter} is not launched once a "
                             f"layer a step")


# -- phase 5p: the preemption plane -------------------------------------------
# (a) tests/test_serve_preempt.py's pressured mix (a long decoder, a
# neighbour, a page-hungry latecomer) on reduced fp32 models, with that
# test's pools (9 pages of 8, 4 of 16).
PREEMPT_MIX = [(13, 16), (21, 4), (40, 4)]
# (arch, page size, cache dtype, with a swap store)
PREEMPT_SMALL = tuple(
    (arch, ps, "float32", swap)
    for arch, ps in (("smollm-135m", 8), ("smollm-135m", 16),
                     ("deepseek-v3-671b", 16))
    for swap in (True, False)) + (("smollm-135m", 8, "int8", True),
                                  ("smollm-135m", 8, "fp8_e4m3", True))
# (b) full-width smollm-135m's pool, deliberately short: 96 usable pages of
# 16 tokens, at 30 layers x k and v x 3 kv heads x 64 x 2 bytes = 23,040
# bytes a token, 35.4 MB; phase 5's 16 requests would hold ~220 pages in
# 8 slots, so fresh admissions preempt.
PREEMPT_POOL_PAGES = 96


def check_small_preempt(configs, model_mod, ServeEngine, Request,
                        PageSwapStore):
    """Phase 5p (a): the pressured mix through reduced smollm-135m (pages
    of 8 and 16) and reduced deepseek-v3 (``moe=None, mtp=False``, pages
    of 16), fp32, ``preempt=True`` with a swap store and without, and
    smollm's swap path over int8 and fp8_e4m3 pools: the greedy tokens,
    every ``preemption`` counter but the joules and the preempt log on
    the card equal the CPU engine's; over fp32 pools the tokens also
    equal the unpressured engine's on the card (over codes a resume
    requantizes rows, so that is logged)."""
    models = {}
    for arch, ps, cache, swap in PREEMPT_SMALL:
        if arch not in models:
            over = dict(moe=None, mtp=False) \
                if arch.startswith("deepseek") else {}
            cfg = dataclasses.replace(
                configs.get_config(arch, reduced=True), dtype="float32",
                prefill_chunk=16, **over)
            models[arch] = cfg, model_mod.init_params(cfg, seed=0,
                                                      device="cpu")
        cfg, params = models[arch]

        def mix():
            rng = np.random.default_rng(11)
            return [Request(prompt=rng.integers(
                2, cfg.vocab_size - 1, size=(p,)).tolist(), max_new_tokens=n)
                for p, n in PREEMPT_MIX]

        cache_dtype = torch.float32 if cache == "float32" else cache
        free = ServeEngine(cfg, params, batch_size=2, max_len=64,
                           kv_layout="paged", kv_page_size=ps,
                           cache_dtype=cache_dtype, device="cuda")
        unpressured = [r.out for r in free.generate(mix())]
        got = []
        for dev in ("cpu", "cuda"):
            eng = ServeEngine(
                cfg, params, batch_size=2, max_len=64, kv_layout="paged",
                kv_page_size=ps, kv_pool_pages=9 if ps == 8 else 4,
                preempt=True, swap_store=PageSwapStore() if swap else None,
                cache_dtype=cache_dtype, device=dev)
            done = eng.generate(mix())
            pre = eng.stats()["preemption"]
            got.append(([r.out for r in done],
                        {k: v for k, v in pre.items()
                         if not k.endswith("joules")},
                        [(e["event"], e["rid"], e.get("via"), e.get("dest"))
                         for e in eng.preempt_log]))
        cpu, card_run = got
        tokens, counters, plog = card_run
        log(f"  reduced {arch} fp32, {cache} pool, page {ps}, "
            f"{'swap store' if swap else 'no swap store'}: "
            f"{counters['preemptions']} preempted, {counters['resumes']} "
            f"resumed, log {plog}; card equal to the CPU: {card_run == cpu}, "
            f"tokens equal to the unpressured run's: {tokens == unpressured}")
        if card_run != cpu:
            raise AssertionError(f"phase 5p {arch} {cache} page {ps}: card "
                                 f"{card_run} against the CPU's {cpu}")
        if cache == "float32" and tokens != unpressured:
            raise AssertionError(f"phase 5p {arch} page {ps}: pressured "
                                 f"tokens differ from the unpressured")
        if counters["preemptions"] < 1 or (swap and "swap" not in [
                via for _, _, via, _ in plog]):
            raise AssertionError(f"phase 5p {arch} page {ps}: the mix did "
                                 f"not preempt as it should: {plog}")


def serve_preempt(configs, model_mod, ServeEngine, Request, kernels,
                  serve_kernels, nvml, pmt, serve_launch, PageSwapStore,
                  prompts, bf16_tokens, card) -> tuple:
    """Phase 5p (b): phase 5's 16 requests (priorities 0 and 1 in turn)
    through full-width smollm-135m, paged (page 16, 8 slots, max_len
    1024, chunk 32, bf16) on a pool of ``PREEMPT_POOL_PAGES`` with
    ``preempt=True``, under one PMT session (cpuutil + nvml): once with a
    1 GiB swap store, once with a swap budget of 0 (tree and recompute
    resumes), each on a fresh engine that has learned the card's J per
    prefill token from a warm-up.  Each run: phase 5's checks, at least
    one preemption and as many resumes, no request retired
    ``"preempted-retry-exhausted"``, pool gauges that add up, an empty
    swap store, the paged kernels launched and the contiguous ones not.
    Returns the swap run's launch counts and the weights, for (c)."""
    cfg = configs.get_config("smollm-135m")
    params = model_mod.init_params(cfg, seed=0, device="cuda")
    per_token = 2 * cfg.num_layers * cfg.num_kv_heads * cfg.head_dim * 2
    log(f"  pool: {PREEMPT_POOL_PAGES} usable pages of 16 tokens, "
        f"{per_token} B a token, {PREEMPT_POOL_PAGES * 16 * per_token / 1e6:.1f}"
        f" MB; priorities 0 and 1 in turn [{card}]")
    session = pmt.Session(["cpuutil", "nvml"])
    energy = session.add_exporter(pmt.MemoryExporter())
    reader = nvml.NvmlReader(0)
    priorities = [i % 2 for i in range(len(prompts))]
    launches = None
    try:
        for index, (name, budget) in enumerate(
                (("swap store of 1 GiB", 1 << 30), ("swap budget 0", 0)), 1):
            store = PageSwapStore(budget)
            eng = ServeEngine(cfg, params, batch_size=8, max_len=1024,
                              prefill_chunk=32, cache_dtype=torch.bfloat16,
                              kv_layout="paged", kv_page_size=16,
                              kv_pool_pages=PREEMPT_POOL_PAGES, preempt=True,
                              swap_store=store, session=session)
            # the warm-up's prefill spans (4 x 512 tokens) are long enough
            # for the card's joules to resolve: the resumes' price
            rng = np.random.default_rng(2)
            eng.generate([Request(prompt=rng.integers(
                0, cfg.vocab_size, 512).tolist(), max_new_tokens=4)
                for _ in range(4)])
            torch.cuda.synchronize()
            session.flush()
            for rec in energy.records:
                if rec.sensor == "nvml":
                    eng.on_record(rec)
            zero_counts(serve_kernels)
            counts, out, figs = served_run(
                eng, Request, prompts, kernels, nvml.EnergyMeter(reader),
                index, session, energy, serve_launch, priorities=priorities)
            contiguous = read_counts(serve_kernels)
            if any(contiguous.values()):
                raise AssertionError(f"phase 5p: the paged path launched a "
                                     f"contiguous kernel: {contiguous}")
            pre = eng.stats()["preemption"]
            kc = eng.stats()["kv_cache"]
            vias, dests = {}, {}
            for e in eng.preempt_log:
                key, by = ("via", vias) if e["event"] == "resume" \
                    else ("dest", dests)
                by[e[key]] = by.get(e[key], 0) + 1
            io = eng.swap_copies
            rate = lambda b, s: f"{b / s / 1e9:.3f} GB/s" if s else "none"
            log(f"  run {index} ({name}): {pre['preemptions']} preemptions "
                f"by dest {dests}, {pre['resumes']} resumes by via {vias}; "
                f"wasted {pre['wasted_tokens']} tokens "
                f"{pre['wasted_joules']:.3f} J, recovered "
                f"{pre['recovered_tokens']} tokens "
                f"{pre['recovered_joules']:.3f} J; "
                f"{figs['tokens_per_s']:.1f} tokens/s [{card}]")
            log(f"  run {index} ({name}): swap out {io['pages_out']} pages "
                f"{io['bytes_out']} B in {io['seconds_out'] * 1e3:.3f} ms "
                f"({rate(io['bytes_out'], io['seconds_out'])}), in "
                f"{io['pages_in']} pages {io['bytes_in']} B in "
                f"{io['seconds_in'] * 1e3:.3f} ms "
                f"({rate(io['bytes_in'], io['seconds_in'])}); store "
                f"{store.stats()} [{card}]")
            log(f"  run {index} ({name}): {serve_launch.kv_pool_line(kc)}")
            agree = sum(a == b for a, b in zip(out, bf16_tokens))
            log(f"  run {index}: {agree} of {len(out)} requests' tokens equal "
                f"to phase 5's unpressured run (not gated in bf16: a resume "
                f"off the chunk grid reorders sums)")
            if pre["preemptions"] < 1 or pre["resumes"] != pre["preemptions"]:
                raise AssertionError(f"phase 5p run {index}: "
                                     f"{pre['preemptions']} preemptions, "
                                     f"{pre['resumes']} resumes")
            if kc["pages_used"] + kc["pages_free"] != kc["pages_total"]:
                raise AssertionError(f"pool gauges do not add up: {kc}")
            if len(store) or store.bytes_used:
                raise AssertionError(f"swap store not empty: "
                                     f"{store.stats()}")
            if launches is None:
                launches = counts
    finally:
        reader.close()
        session.close()
    return launches, params


def check_quarantine_card(configs, ServeEngine, Request, params, prompts,
                          card) -> None:
    """Phase 5p (c): four of phase 5's prompts (16 new tokens each)
    through full-width smollm-135m, paged, once clean and once with the
    paged decode step wrapped to turn one live row's logits NaN once:
    that request retires ``"error"``, its pages never reach the radix
    tree, the others give the clean tokens.  Then a run with
    ``watchdog_step_timeout_s=1e-9`` completes and flags hung steps."""
    cfg = configs.get_config("smollm-135m")

    def engine(**kw):
        return ServeEngine(cfg, params, batch_size=4, max_len=1024,
                           prefill_chunk=32, cache_dtype=torch.bfloat16,
                           kv_layout="paged", kv_page_size=16, **kw)

    def reqs():
        return [Request(prompt=p, max_new_tokens=16) for p in prompts[:4]]

    clean = [r.out for r in engine().generate(reqs())]
    eng = engine()
    fns = eng._paged_fns
    hit = {}

    def poisoned(params_, caches, tokens, cur, table):
        logits = fns.decode(params_, caches, tokens, cur, table)
        if not hit:
            hit["row"] = int((table != 0).any(dim=1).nonzero()[0, 0])
            logits[hit["row"]] = float("nan")
        return logits

    eng._paged_fns = fns._replace(decode=poisoned)
    done = eng.generate(reqs())
    bad = [i for i, r in enumerate(done) if r.finish_reason == "error"]
    others = [i for i in range(len(done)) if i not in bad]
    n_tree = 0
    for i in bad:
        n_tree, pages = eng._radix.match(list(done[i].prompt))
        eng._pool.release(pages)
    log(f"  quarantine: row {hit.get('row')} poisoned once; requests "
        f"{bad} retired error, {eng.quarantined} quarantined, "
        f"{eng.nonfinite_logit_rows} non-finite rows, its prompt's tokens "
        f"on the tree {n_tree}; the others equal to the clean run: "
        f"{[done[i].out == clean[i] for i in others]} [{card}]")
    if len(bad) != 1 or eng.quarantined != 1 or n_tree \
            or any(done[i].out != clean[i] for i in others) \
            or any(done[i].finish_reason != "length" for i in others):
        raise AssertionError("phase 5p: the quarantine misbehaved")
    events = []
    eng = engine(watchdog_step_timeout_s=1e-9)
    eng.event_sink = events.append
    done = eng.generate(reqs())
    kinds = {e["kind"] for e in events}
    log(f"  watchdog at 1e-9 s a step: {eng.hung_steps} hung steps, events "
        f"{sorted(kinds)}, finish reasons "
        f"{sorted({r.finish_reason for r in done})}")
    if not eng.hung_steps or kinds != {"hung_step"} \
            or any(r.finish_reason != "length" for r in done):
        raise AssertionError("phase 5p: the watchdog misbehaved")


# -- phase 5g: the power governor and the telemetry plane ---------------------

def governor_figures(gov) -> str:
    st = gov.stats()
    model = st["slot_watts_model"]
    fit = "none" if model is None else (
        f"{model['slope_w_per_slot']:.3f} W a slot over "
        f"{model['intercept_w']:.2f} W ({model['samples']} samples)")
    step = "none" if gov._step_w is None else f"{gov._step_w:.3f} W"
    return (f"{st['throttle_decisions']} decisions {st['throttle_actions']}, "
            f"{st['pause_total_s'] * 1e3:.1f} ms paused; learned step "
            f"{step}, slot model {fit}")


def check_governed(st, gov, energy, n_before, label) -> None:
    """The governor's count is the engine's ``stats()["governor"]``
    (``st``, read at the end of the run), it decided at least once, and
    its decisions are session spans."""
    spans = [r.path for r in energy.records[n_before:]
             if r.path.startswith("serve/governor/")]
    log(f"  {label}: {len(spans)} serve/governor/<action><n> spans in the "
        f"session")
    if gov.throttle_count < 1 \
            or st["throttle_decisions"] != gov.throttle_count or not spans:
        raise AssertionError(f"{label}: {gov.throttle_count} decisions, "
                             f"stats {st['throttle_decisions']}, "
                             f"{len(spans)} spans")


def serve_governed(live, Request, kernels, nvml, serve_launch, prompts,
                   PowerGovernor, chunked, card) -> dict:
    """Phase 5g (b) and (c) on phase 5's contiguous engine, session and
    recorder.  (b): a cap from the card's idle watts (after a 1 s sleep)
    and phase 5g (a)'s run watts, halfway between them, on the nvml
    backend: 8 of phase 5's requests, phase 5's checks; the governor
    decides at least once, as many times as ``stats()["governor"]``
    says, and each decision is a ``serve/governor/`` span; the window
    peak after a 1 s ramp is logged against the cap, and tokens/s
    beside phase 5's.  (c): a cap of half the idle draw, 4 requests of
    16 tokens: each completes, forced admits are recorded and decode
    pauses.  Returns (b)'s launches of rows 1-3."""
    eng, session, energy, recorder = (live[k] for k in (
        "eng", "session", "energy", "recorder"))
    time.sleep(1.0)
    recorder.poll_once()
    idle = recorder.mean_watts(1.0, backend="nvml")
    busy = live["observed"]["watts"]
    cap = idle + 0.5 * (busy - idle)
    log(f"  5g (b): card idle {idle:.2f} W (the last second), 5g (a)'s run "
        f"{busy:.2f} W: cap {cap:.2f} W [{card}]")
    gov = PowerGovernor(recorder, cap_watts=cap, backend="nvml")
    eng.governor = gov
    recorder.poll_once()
    n0 = len(recorder.watts_series("nvml").get("nvml", []))
    session.flush()
    n_before = len(energy.records)
    reader = nvml.NvmlReader(0)
    try:
        launches, _, figs = served_run(eng, Request, prompts[:8], kernels,
                                       nvml.EnergyMeter(reader), "5g (b)",
                                       session, energy, serve_launch)
        st = eng.stats()["governor"]
    finally:
        reader.close()
        eng.governor = None
        gov.close()
    session.flush()
    mean, n, peak = nvml_window(recorder, n0, gov.window_s, ramp_s=1.0)
    log(f"  5g (b): {governor_figures(gov)}")
    log(f"  5g (b): card {mean:.2f} W over the run ({n} samples), window "
        f"({gov.window_s} s) peak after a 1 s ramp {peak:.2f} W against the "
        f"cap {cap:.2f} W ({peak / cap:.3f}x; logged, not gated); "
        f"{figs['tokens_per_s']:.1f} tokens/s, {figs['joules_per_token']:.4f}"
        f" J/token against phase 5 run 1's {chunked['tokens_per_s']:.1f} and "
        f"{chunked['joules_per_token']:.4f} (16 requests) [{card}]")
    check_governed(st, gov, energy, n_before, "phase 5g (b)")
    # (c) a cap no load can hold: liveness wins
    gov = PowerGovernor(recorder, cap_watts=0.5 * idle, backend="nvml")
    eng.governor = gov
    n_before = len(energy.records)
    t0 = time.perf_counter()
    try:
        done = eng.generate([Request(prompt=p, max_new_tokens=16)
                             for p in prompts[:4]])
        torch.cuda.synchronize()
        st = eng.stats()["governor"]
    finally:
        eng.governor = None
        gov.close()
    wall = time.perf_counter() - t0
    session.flush()
    log(f"  5g (c): cap {0.5 * idle:.2f} W (half the idle draw), 4 requests "
        f"of 16 tokens in {wall:.3f} s: {governor_figures(gov)}")
    actions = gov.stats()["throttle_actions"]
    if any(len(r.out) != 16 or r.finish_reason != "length" for r in done) \
            or "admit_force" not in actions or not gov.pause_total_s > 0:
        raise AssertionError(f"phase 5g (c): liveness under an unholdable "
                             f"cap: {[len(r.out) for r in done]}, {actions}")
    check_governed(st, gov, energy, n_before, "phase 5g (c)")
    probe_signal_ttl(eng, recorder, Request, prompts, PowerGovernor,
                     10.0 * max(busy, idle), card)
    return launches


# the signal TTLs phase 5g probes, in seconds: under and over the newest
# nvml sample's largest age at a decode step (73-177 ms on an H100 80GB
# HBM3 at 700 W, phase 5g (a))
SIGNAL_TTLS = (0.05, 0.1, 0.2)


def probe_signal_ttl(eng, recorder, Request, prompts, PowerGovernor, cap,
                     card) -> None:
    """Phase 5g's TTL probe: 4 of phase 5's requests of 16 tokens under a
    cap no load reaches (``cap``) with ``fail_mode="closed"``, once per
    ``SIGNAL_TTLS``: how often the nvml signal goes stale between the
    recorder's polls, and what the closed mode's forced admits cost.
    Logged, not gated, but for every request completing."""
    for ttl in SIGNAL_TTLS:
        gov = PowerGovernor(recorder, cap_watts=cap, backend="nvml",
                            signal_ttl_s=ttl, fail_mode="closed")
        eng.governor = gov
        t0 = time.perf_counter()
        try:
            done = eng.generate([Request(prompt=p, max_new_tokens=16)
                                 for p in prompts[:4]])
            torch.cuda.synchronize()
        finally:
            eng.governor = None
            gov.close()
        wall = time.perf_counter() - t0
        acts = gov.stats()["throttle_actions"]
        log(f"  5g ttl {ttl} s (fail closed, cap {cap:.0f} W out of reach): "
            f"{acts.get('signal_stale', 0)} stale episodes, "
            f"{acts.get('admit_force', 0)} forced admits, "
            f"{acts.get('chunk_force', 0)} forced chunks; "
            f"{sum(len(r.out) for r in done) / wall:.1f} tokens/s [{card}]")
        if any(len(r.out) != 16 for r in done):
            raise AssertionError(f"phase 5g: a request starved at a signal "
                                 f"TTL of {ttl} s")


def sse_events(url: str, events: list) -> None:
    """Read an SSE stream until the server closes it, appending each
    event's name."""
    import urllib.request
    with urllib.request.urlopen(url + "/stream", timeout=30.0) as resp:
        for line in resp:
            if line.startswith(b"event: "):
                events.append(line[len(b"event: "):].strip().decode())


def http_json(url: str) -> dict:
    import urllib.request
    with urllib.request.urlopen(url, timeout=30.0) as resp:
        return json.loads(resp.read().decode())


def serve_governed_paged(configs, model_mod, ServeEngine, Request, kernels,
                         serve_kernels, nvml, pmt, serve_launch, telemetry,
                         PowerGovernor, PageSwapStore, prompts, card) -> dict:
    """Phase 5g (d): 8 of phase 5's requests through full-width
    smollm-135m, paged (page 16, bf16) on phase 5p's pool of
    ``PREEMPT_POOL_PAGES`` with ``preempt=True`` and a 1 GiB swap store,
    no prefix cache (the governor's veto reads the free pages, and a
    prefix tree holding the retired prompts' pages would keep them under
    the reserve: every admission but the engine's forced ones vetoed),
    under an uncapped
    governor with ``pool_reserve_frac`` 0.25 and one ``request_shed()``
    at the 40th decode step, a recorder and a ``TelemetryServer`` on
    127.0.0.1 (an ephemeral port) over a fresh session (cpuutil + nvml),
    an SSE client reading ``/stream`` throughout.  Phase 5's checks, the
    paged kernels only; a pool block or wait and a preemption after the
    shed among the decisions; ``/stats`` holds ``governor``, ``kv_cache``
    and ``preemption``; each request's joules on ``/requests`` within 1%
    of the session's ``serve/req<N>`` records; ``/stream`` delivered a
    ``record`` and a ``preempt`` event.  Returns the run's launches of
    rows 4, 7 and 8."""
    import threading
    cfg = configs.get_config("smollm-135m")
    params = model_mod.init_params(cfg, seed=0, device="cuda")
    session = pmt.Session(["cpuutil", "nvml"])
    energy = session.add_exporter(pmt.MemoryExporter())
    recorder = telemetry.PowerRecorder().attach(session, exporter=energy)
    gov = PowerGovernor(recorder, pool_reserve_frac=0.25, backend="nvml")
    eng = ServeEngine(cfg, params, batch_size=8, max_len=1024,
                      prefill_chunk=32, cache_dtype=torch.bfloat16,
                      kv_layout="paged", kv_page_size=16,
                      kv_pool_pages=PREEMPT_POOL_PAGES, preempt=True,
                      swap_store=PageSwapStore(1 << 30), prefix_cache=False,
                      governor=gov, session=session)
    recorder.attach_engine(eng)
    rng = np.random.default_rng(3)
    eng.generate([Request(prompt=rng.integers(0, cfg.vocab_size,
                                              40).tolist(),
                          max_new_tokens=4) for _ in range(2)])
    torch.cuda.synchronize()
    fns = eng._paged_fns
    steps = [0]

    def decode(*args):
        steps[0] += 1
        if steps[0] == 40:
            gov.request_shed()
        return fns.decode(*args)

    eng._paged_fns = fns._replace(decode=decode)
    server = telemetry.TelemetryServer(recorder, host="127.0.0.1",
                                       port=0).start()
    events: list = []
    client = threading.Thread(target=sse_events, args=(server.url, events),
                              daemon=True)
    reader = nvml.NvmlReader(0)
    try:
        client.start()
        zero_counts(serve_kernels)
        n_dec = len(gov.decisions)
        launches, _, figs = served_run(eng, Request, prompts[:8], kernels,
                                       nvml.EnergyMeter(reader), "5g (d)",
                                       session, energy, serve_launch)
        contiguous = read_counts(serve_kernels)
        session.flush()
        recorder.poll_once()
        stats = http_json(server.url + "/stats")
        http_reqs = http_json(server.url + "/requests")["requests"]
        time.sleep(0.5)              # the last records onto the stream
    finally:
        reader.close()
        server.close()
        client.join(timeout=10.0)
        gov.close()
        recorder.close()
        session.close()
    if any(contiguous.values()):
        raise AssertionError(f"phase 5g (d): the paged path launched a "
                             f"contiguous kernel: {contiguous}")
    actions = [d.action for d in list(gov.decisions)[n_dec:]]
    pre = eng.stats()["preemption"]
    log(f"  5g (d): {governor_figures(gov)}; this run's decisions in order "
        f"{actions}; {pre['preemptions']} preemptions, {pre['resumes']} "
        f"resumes; {figs['tokens_per_s']:.1f} tokens/s [{card}]")
    shed = actions.index("shed_request") if "shed_request" in actions \
        else None
    if not ({"pool_block", "pool_wait"} & set(actions)) or shed is None \
            or "preempt" not in actions[shed:]:
        raise AssertionError(f"phase 5g (d): decisions {actions} lack a pool "
                             f"block or wait, or a preemption after the "
                             f"shed")
    missing = {"governor", "kv_cache", "preemption"} - set(stats)
    by_req = serve_launch.request_energy(energy.records)
    worst = float("inf")
    if len(http_reqs) == eng._request_count:
        worst = max(abs(d["joules"] - by_req[f"serve/req{rid}"]["joules"])
                    / by_req[f"serve/req{rid}"]["joules"]
                    for rid, d in http_reqs.items())
    kinds = {k: events.count(k) for k in set(events)}
    log(f"  5g (d): telemetry at {server.url}: /stats keys governor, "
        f"kv_cache, preemption {'present' if not missing else missing}; "
        f"/requests joules against the session's serve/req<N> records: "
        f"largest gap {worst:.2e} of {len(http_reqs)} requests; /stream "
        f"events {kinds}")
    if missing or worst > 0.01 or not kinds.get("record") \
            or not kinds.get("preempt"):
        raise AssertionError("phase 5g (d): the telemetry plane missed a "
                             "gate")
    return launches


# Phase 5c's depth: 10 of smollm-135m's 30 layers (its widths whole), so
# that its four serve runs, host-bound, take a third of their time.
PHASE_5C_LAYERS = 10


def serve_quantized(configs, model_mod, ServeEngine, Request, kernels,
                    others, nvml, pmt, serve_launch, prompts, bf16_tokens,
                    bf16_bytes, bf16_trace):
    """Phase 5c: phase 5's 16 requests through smollm-135m at full width
    and PHASE_5C_LAYERS of its layers once per quantized cache mode and
    layout (contiguous; paged, page 16,
    the default pool of 512 usable pages), each on its own engine, all
    through one PMT session (cpuutil + nvml).  ``kernels[layout]`` are
    the three quantized kernels that layout must launch; every counter
    in ``others[layout]`` (the bf16 kernels, the other layout's quantized
    ones) must stay 0.  The layout's quantizing scatter must launch once a
    layer per decode step and per prefill chunk (k and v in one launch;
    contiguous chunks included).  Checks the mode in ``stats()``, the
    footprint under 0.6x phase 5's bf16 bytes per token (scaled to this
    depth), and everything
    ``served_run`` checks; traces the int8 engines as phases 5 and 5b
    trace theirs, the contiguous one beside phase 5's ``bf16_trace``
    (busy ms, launches issued, launches a chunk).  Returns each kernel's
    launches summed over both modes."""
    cfg = configs.get_config("smollm-135m", num_layers=PHASE_5C_LAYERS)
    # phase 5's bf16 bytes a token, at this depth
    bf16_bytes *= cfg.num_layers / configs.get_config(
        "smollm-135m").num_layers
    params = model_mod.init_params(cfg, seed=0, device="cuda")
    session = pmt.Session(["cpuutil", "nvml"])
    energy = session.add_exporter(pmt.MemoryExporter())
    reader = nvml.NvmlReader(0)
    rng = np.random.default_rng(2)
    totals = {}
    try:
        log(f"  NVML: {reader.name()}, enforced power limit "
            f"{reader.power_limit_watts():.0f} W")
        for layout in ("contiguous", "paged"):
            for index, mode in enumerate(MODES, 1):
                kw = dict(kv_layout="paged", kv_page_size=16) \
                    if layout == "paged" else {}
                eng = ServeEngine(cfg, params, batch_size=8, max_len=1024,
                                  prefill_chunk=32, cache_dtype=mode,
                                  session=session, **kw)
                kc = eng.stats()["kv_cache"]
                ratio = kc["bytes_per_token"] / bf16_bytes
                log(f"  {mode} {layout}: stats cache_dtype "
                    f"{kc['cache_dtype']!r}, {kc['bytes_per_token']:.1f} "
                    f"B/token, {ratio:.3f}x phase 5's bf16 "
                    f"{bf16_bytes:.1f} (must be under 0.6x)")
                if kc["cache_dtype"] != mode or not ratio < 0.6:
                    raise AssertionError(f"{mode} {layout}: kv_cache stats "
                                         f"{kc}")
                eng.generate([Request(prompt=rng.integers(
                    0, cfg.vocab_size, 40).tolist(), max_new_tokens=4)
                    for _ in range(2)])
                torch.cuda.synchronize()
                zero_counts(others[layout])
                steps = count_steps(eng)
                counts, out, _ = served_run(
                    eng, Request, prompts, kernels[layout],
                    nvml.EnergyMeter(reader), f"{mode} {layout}", session,
                    energy, serve_launch)
                stray = {k: n for k, n in read_counts(others[layout]).items()
                         if n}
                if stray:
                    raise AssertionError(f"{mode} {layout} launched other "
                                         f"kernels: {stray}")
                scatter = "quant_paged_cache_update" if layout == "paged" \
                    else "quant_cache_update"
                check_once_a_layer(cfg, counts, steps, scatter,
                                   f"{mode} {layout}", chunks=True)
                log(f"  {mode} {layout}: the bf16 kernels and the other "
                    f"layout's stayed at 0")
                for name, n in counts.items():
                    totals[name] = totals.get(name, 0) + n
                if mode == "int8":
                    # phase 5's and 5b's traced run on this engine: the
                    # same shapes, so its wall clock, device busy time and
                    # launches compare with theirs
                    traced = trace_serve(eng, cfg, Request, rng)
                    if layout == "contiguous" and None not in traced \
                            and None not in bf16_trace:
                        log(f"  int8 contiguous ({cfg.num_layers} layers) "
                            "against phase 5's bf16 (30): busy "
                            f"{traced[0]:.1f} ms against {bf16_trace[0]:.1f}"
                            f", {traced[1]} kernel launches issued against "
                            f"{bf16_trace[1]}, {traced[2]} a prefill chunk "
                            f"against {bf16_trace[2]}, {traced[3]} a decode "
                            f"step against {bf16_trace[3]}")
                del eng
    finally:
        reader.close()
    session.close()
    return totals


# -- phase 4m: MLA's small reference ------------------------------------------

def check_small_mla(configs, model_mod, ServeEngine, Request, v_kernels):
    """Reduced deepseek-v3 (``moe=None, mtp=False``: three dense MLA
    layers), fp32: the engine's greedy tokens on the card (the CUDA-core
    kernels with v's row width, fp32 q) equal the CPU's, contiguous
    chunked, paged (page 16), blocking and int8; the v_width rows must
    have launched on the card."""
    cfg = dataclasses.replace(
        configs.get_config("deepseek-v3-671b", reduced=True), moe=None,
        mtp=False, dtype="float32")
    params = model_mod.init_params(cfg, seed=0, device="cpu")
    mix = [([1, 2, 3], 8), ([4, 5], 3), ([6], 1),
           ([7, 8, 9, 10, 11, 12, 13, 14, 15], 5), ([2], 12)]
    runs = {"chunked": dict(cache_dtype=torch.float32),
            "paged": dict(cache_dtype=torch.float32, kv_layout="paged",
                          kv_page_size=16),
            "blocking": dict(cache_dtype=torch.float32, prefill_chunk=0),
            "int8": dict(cache_dtype="int8")}
    zero_counts(v_kernels)
    for name, kw in runs.items():
        kw = dict(dict(prefill_chunk=4), **kw)
        out = {}
        for dev in ("cpu", "cuda"):
            eng = ServeEngine(cfg, params, batch_size=2, max_len=64,
                              device=dev, **kw)
            out[dev] = [r.out for r in eng.generate(
                [Request(prompt=p, max_new_tokens=n) for p, n in mix])]
        log(f"  reduced deepseek-v3 fp32 {name}: greedy tokens on the card "
            f"equal to the CPU's: {out['cuda'] == out['cpu']}")
        if out["cuda"] != out["cpu"]:
            raise AssertionError(f"MLA {name}: card tokens {out['cuda']} "
                                 f"against the CPU's {out['cpu']}")
    counts = read_counts(v_kernels)
    log(f"  the v_width rows' launches in these runs: {counts}")
    if not all(counts.values()):
        raise AssertionError(f"a v_width row did not launch: {counts}")


# -- phase 5m: MLA serving at full width --------------------------------------
# deepseek-v3-671b's first three layers, which the published model keeps
# dense (ff 18432), at every published width: d_model 7168, 128 heads,
# q_lora 1536, kv_lora 512, rope 64 (a 576-wide latent cache row).
MLA_SERVE = dict(num_layers=3, moe=None, mtp=False)
# The first decode step's logits through the kernel against the dense
# attend, both bf16: the dense attend rounds p to bf16 before p @ v where
# the kernel keeps p_hi + p_lo, ~2^-8 relative on each layer's attention
# output; three layers carry it into the logits.  Gate as phase 5w's:
# 2^-5 of the larger of max |logit| and 1.
MLA_LOGIT_TOL = 2.0 ** -5


def serve_mla(configs, model_mod, ServeEngine, Request, runs_kernels,
              all_kernels, nvml, pmt, serve_launch, prompts) -> tuple:
    """Phase 5's 16 requests (64-700 prompt tokens, 64 new tokens each)
    through deepseek-v3's three dense MLA layers at full width (random
    weights from seed 0, bf16), 8 slots, max_len 1024, chunk 32, through
    one PMT session (cpuutil + nvml): contiguous over a bf16 cache, paged
    (page 16) over bf16, cold then warm (the warm run must map prompt
    pages from the radix tree), paged over int8, contiguous over int8.  ``runs_kernels[run]`` are the kernels a run must launch,
    each 3 times a decode step, a prefill chunk or both (once a layer):
    the v_width attention rows and the run's one-leaf scatter (a bf16
    contiguous chunk's write is a slice copy); every other counter in
    ``all_kernels`` stays 0.  Then the first decode step's logits, flash
    against dense (MLA_LOGIT_TOL), and one decode step's device time.
    Returns each run's launch counts and figures."""
    t_phase = time.perf_counter()
    from repro_torch.tree import tree_leaves
    cfg = configs.get_config("deepseek-v3-671b", **MLA_SERVE)
    params = model_mod.init_params(cfg, seed=0, device="cuda")
    n = sum(t.numel() for t in tree_leaves(params))
    log(f"  {cfg.num_layers} layers, {n / 1e9:.3f} B parameters")
    session = pmt.Session(["cpuutil", "nvml"])
    energy = session.add_exporter(pmt.MemoryExporter())
    reader = nvml.NvmlReader(0)
    rng = np.random.default_rng(3)
    runs = {"contiguous bf16": dict(cache_dtype=torch.bfloat16),
            "paged bf16": dict(cache_dtype=torch.bfloat16,
                               kv_layout="paged", kv_page_size=16),
            "paged int8": dict(cache_dtype="int8", kv_layout="paged",
                               kv_page_size=16),
            "contiguous int8": dict(cache_dtype="int8")}
    launches, figures = {}, {}
    try:
        for label, kw in runs.items():
            eng = ServeEngine(cfg, params, batch_size=8, max_len=1024,
                              prefill_chunk=32, session=session, **kw)
            eng.generate([Request(prompt=rng.integers(
                0, cfg.vocab_size, 40).tolist(), max_new_tokens=4)
                for _ in range(2)])
            torch.cuda.synchronize()
            kernels = runs_kernels[label]
            others = {k: m for k, m in all_kernels.items()
                      if k not in kernels}
            zero_counts(others)
            steps = count_steps(eng)
            counts, _, fig = served_run(
                eng, Request, prompts, kernels, nvml.EnergyMeter(reader),
                label, session, energy, serve_launch)
            stray = {k: c for k, c in read_counts(others).items() if c}
            if stray:
                raise AssertionError(f"{label} launched other kernels: "
                                     f"{stray}")
            per = {"decode": steps["decode"], "chunk": steps["chunk"],
                   "both": steps["decode"] + steps["chunk"]}
            for name, c in counts.items():
                when = "chunk" if name.startswith("prefill") else \
                    "decode" if name.startswith("decode") or (
                        name == "cache_update") else "both"
                want = cfg.num_layers * per[when]
                log(f"  {label}: {name} launched {c} times, {want} = "
                    f"{cfg.num_layers} a {when} ({steps['decode']} decode "
                    f"steps, {steps['chunk']} chunks)")
                if c != want:
                    raise AssertionError(f"{label}: {name} launched {c} "
                                         f"times, not once a layer a step")
            if label == "paged bf16":
                # warm: the same prompts again map their full pages from
                # the radix tree
                hits = eng.stats()["kv_cache"]["prefix_hit_tokens"]
                _, out, figures["paged bf16 warm"] = served_run(
                    eng, Request, prompts, kernels, nvml.EnergyMeter(reader),
                    f"{label} warm", session, energy, serve_launch)
                reused = eng.stats()["kv_cache"]["prefix_hit_tokens"] - hits
                log(f"  {label} warm: {reused} prompt tokens reused from the "
                    f"radix tree (must be > 0)")
                if reused <= 0:
                    raise AssertionError("the warm paged run reused no "
                                         "prefix page")
            launches[label], figures[label] = counts, fig
            del eng
        gate = mla_first_step(cfg, model_mod, params)
    finally:
        reader.close()
        session.close()
    figures["first_step"] = gate
    figures["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 5m took {figures['phase_s']:.1f} s")
    return launches, figures


def mla_first_step(cfg, model_mod, params) -> dict:
    """The first decode step after random 256-token prompts (8 rows, their
    chunks of 32 through row 2v): the logits through the kernel (row 3v)
    against the dense attend from the same cache (MLA_LOGIT_TOL), and
    each step's device time by the profiler."""
    sp = model_mod.serving_params(cfg, params, "cuda")
    toks = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (8, 256)), device="cuda")
    fns = {impl: model_mod.make_serve_fns(dataclasses.replace(
        cfg, decode_attn_impl=impl)) for impl in ("flash", "dense")}
    caches = model_mod.init_caches(cfg, 8, 1024, torch.bfloat16, "cuda")
    for o in range(0, 256, 32):
        fns["flash"].prefill_chunk(sp, caches, toks[:, o:o + 32], o, 31)
    tok1 = toks[:, -1:]
    cur = torch.full((8,), 256, dtype=torch.int32, device="cuda")
    out = {}
    for impl, f in fns.items():
        c = {"units": {k: {n: t.clone() for n, t in v.items()}
                       for k, v in caches["units"].items()}}
        out[impl] = f.decode(sp, c, tok1, cur).float()
        step = lambda: f.decode(sp, c, tok1, cur)
        out[f"{impl}_device_ms"] = step_device_ms(step)
        out[f"{impl}_ms"] = time_ms(step, iters=10)
    top = max(float(out["dense"].abs().max()), 1.0)
    err = max_err(out["flash"], out["dense"])
    same = bool((out["flash"].argmax(-1) == out["dense"].argmax(-1)).all())
    log(f"  first decode step (8 rows at 256): logits through the kernel "
        f"against the dense attend: max |err| {err:.4g} (gate "
        f"{MLA_LOGIT_TOL * top:.4g}: 2^-5 of max(max |logit|, 1) = "
        f"{top:.4g}); argmax equal {same}")
    log(f"  one decode step: flash {out['flash_device_ms']:.4f} ms of device "
        f"time ({out['flash_ms']:.4f} ms by events, host in the loop), dense "
        f"{out['dense_device_ms']:.4f} ms ({out['dense_ms']:.4f})")
    if not err <= MLA_LOGIT_TOL * top:
        raise AssertionError("MLA's flash decode logits disagree with the "
                             "dense attend's")
    return {"max_abs_err": err, "gate": MLA_LOGIT_TOL * top,
            "argmax_equal": same,
            **{k: v for k, v in out.items() if k.endswith("ms")}}


# -- phase 5w: the serve baselines at full width ------------------------------
# The first whole-prompt prefill's last logits through the flash kernel
# against the same prefill through the dense attend, both in bf16: the
# dense attend rounds its probabilities to bf16 before p @ v where the
# kernel keeps them to fp32 (p_hi + p_lo), ~2^-8 relative on each layer's
# attention output, which 30 layers carry into the logits.  Gate: 2^-5 of
# the larger of max |logit| and 1 (0.0644 at seed 0's max |logit| of
# 2.062, where an H100 measured 0.0254).
BASELINE_LOGIT_TOL = 2.0 ** -5
BASELINE_MAX_LEN = 2048      # a bucket of 1024 plus 64 new tokens


def step_device_ms(step) -> float:
    """Device time of one call of ``step`` by ``torch.profiler`` (the
    kernels' and copies' time summed, after one untraced call), or NaN
    where the profiler sees no device."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and not e.is_user_annotation)
    return us / 1e3 if us > 0 else float("nan")


def serve_baselines(configs, model_mod, ServeEngine, Request, cu_kernel,
                    da_kernel, fa_kernel, pa_kernel, nvml, pmt,
                    serve_launch, prompts, chunked):
    """Phase 5w: phase 5's 16 requests through full-width smollm-135m
    (bf16 weights, random from seed 0, attn_impl "pallas", 8 slots,
    max_len 2048) under one PMT session (cpuutil + nvml): with blocking
    admission and in waves of 8 over a bf16 cache, then with blocking
    admission over an int8 cache.  Checks what ``served_run`` checks,
    every whole-prompt prefill launching the flash kernel once a layer,
    flash decode once a layer a decode step, the cache's scatter once a
    layer a decode step (and, quantizing, a whole-prompt prefill: row 5
    writing the bucket at offset 0), no other serve kernel; prints
    tokens/s, J/token and stall p95 beside phase 5's chunked run
    (``chunked``).  Then the first prefill's last logits under "pallas"
    against "dense", and one decode step's device time with the dense
    attend beside flash at this cache size.  Returns the flash kernel's
    launches by run, the int8 blocking run's quantizing-scatter launches
    with its prefills and decode steps, and the figures."""
    t_phase = time.perf_counter()
    cfg = configs.get_config("smollm-135m", attn_impl="pallas")
    params = model_mod.init_params(cfg, seed=0, device="cuda")
    session = pmt.Session(["cpuutil", "nvml"])
    energy = session.add_exporter(pmt.MemoryExporter())
    reader = nvml.NvmlReader(0)
    rng = np.random.default_rng(5)
    bf16_kernels = {"cache_update": cu_kernel, "decode_attention": da_kernel,
                    "flash_attention": fa_kernel}
    int8_kernels = {"quant_cache_update": cu_kernel,
                    "decode_attention quant": da_kernel,
                    "flash_attention": fa_kernel}
    serve = dict(bf16_kernels, **int8_kernels,
                 prefill_attention=pa_kernel,
                 **{"prefill_attention quant": pa_kernel})
    flash, figures, blocking_int8 = {}, {}, None
    try:
        for label, kw, kernels in (
                ("blocking", dict(prefill_chunk=0), bf16_kernels),
                ("wave", dict(mode="wave"), bf16_kernels),
                ("blocking int8", dict(prefill_chunk=0, cache_dtype="int8"),
                 int8_kernels)):
            kw.setdefault("cache_dtype", torch.bfloat16)
            absent = {k: m for k, m in serve.items() if k not in kernels}
            scatter, decode = list(kernels)[:2]
            eng = ServeEngine(cfg, params, batch_size=8,
                              max_len=BASELINE_MAX_LEN, session=session,
                              **kw)
            eng.generate([Request(prompt=rng.integers(
                0, cfg.vocab_size, 40).tolist(), max_new_tokens=4)
                for _ in range(2)])
            torch.cuda.synchronize()
            steps = count_steps(eng)
            zero_counts(absent)
            counts, _, fig = served_run(eng, Request, prompts, kernels,
                                        nvml.EnergyMeter(reader), label,
                                        session, energy, serve_launch)
            stray = {k: n for k, n in read_counts(absent).items() if n}
            if stray:
                raise AssertionError(f"{label} launched {stray}")
            want = cfg.num_layers * steps["prefill"]
            log(f"  {label}: flash_attention launched "
                f"{counts['flash_attention']} times for {steps['prefill']} "
                f"whole-prompt prefills of {cfg.num_layers} layers (must be "
                f"{want}); no other serve kernel launched")
            if counts["flash_attention"] != want:
                raise AssertionError("the flash kernel is not launched once "
                                     "a layer a prefill")
            want = cfg.num_layers * steps["decode"]
            log(f"  {label}: {decode} launched {counts[decode]} times for "
                f"{steps['decode']} decode steps of {cfg.num_layers} layers "
                f"(must be {want})")
            if counts[decode] != want:
                raise AssertionError(f"{label}: flash decode is not launched "
                                     f"once a layer a decode step")
            if scatter == "quant_cache_update":
                # one quantizing write a layer a whole-prompt prefill (the
                # bucket's rows at offset 0) and a decode step
                want = cfg.num_layers * (steps["prefill"] + steps["decode"])
                blocking_int8 = dict(prefill=steps["prefill"],
                                     decode=steps["decode"],
                                     launches=counts[scatter])
                log(f"  {label}: {scatter} launched {counts[scatter]} times "
                    f"for {steps['prefill']} whole-prompt prefills and "
                    f"{steps['decode']} decode steps of {cfg.num_layers} "
                    f"layers (must be {want})")
                if counts[scatter] != want:
                    raise AssertionError(f"{label}: the quantizing scatter is "
                                         f"not launched once a layer a "
                                         f"prefill and a step")
            else:
                check_once_a_layer(cfg, counts, steps, scatter, label,
                                   chunks=False)
            log(f"  {label} against phase 5's chunked run 1: "
                f"{fig['tokens_per_s']:.2f} tokens/s against "
                f"{chunked['tokens_per_s']:.2f}, "
                f"{fig['joules_per_token']:.4f} J/token against "
                f"{chunked['joules_per_token']:.4f}, stall p95 "
                f"{fig['stall_p95_ms']:.2f} ms over {fig['stall_events']} "
                f"whole-prompt prefills against {chunked['stall_p95_ms']:.2f}"
                f" ms over {chunked['stall_events']} chunks")
            flash[label] = counts["flash_attention"]
            figures[label] = dict(fig, prefills=steps["prefill"],
                                  decode_steps=steps["decode"])
            serve_params = eng.params
            del eng
    finally:
        reader.close()
        session.close()
    # the first request's blocking prefill, through the kernel and dense
    from repro_torch.serve.engine import prompt_bucket
    plen = len(prompts[0])
    bucket = prompt_bucket(plen)
    toks = torch.zeros((1, bucket), dtype=torch.long, device="cuda")
    toks[0, bucket - plen:] = torch.as_tensor(prompts[0])
    logits = {}
    for impl in ("pallas", "dense"):
        fns = model_mod.make_serve_fns(dataclasses.replace(cfg,
                                                           attn_impl=impl))
        logits[impl] = fns.prefill(serve_params, {"tokens": toks},
                                   BASELINE_MAX_LEN)[0].float()
    top = max(float(logits["dense"].abs().max()), 1.0)
    err = max_err(logits["pallas"], logits["dense"])
    log(f"  first prefill (S {bucket}, {plen} tokens), last logits through "
        f"the flash kernel against the dense attend: max |err| {err:.4g} "
        f"(gate {BASELINE_LOGIT_TOL * top:.4g}: 2^-5 of max(max |logit|, "
        f"1) = {top:.4g}); argmax equal "
        f"{bool((logits['pallas'].argmax(-1) == logits['dense'].argmax(-1)).all())}")
    if not err <= BASELINE_LOGIT_TOL * top:
        raise AssertionError("the flash prefill's logits disagree with the "
                             "dense attend's")
    # one decode step at this cache size, each impl
    caches = model_mod.init_caches(cfg, 8, BASELINE_MAX_LEN, torch.bfloat16,
                                   "cuda")
    tok1 = toks[:, -8:].reshape(8, 1)
    cur = torch.full((8,), bucket + 32, dtype=torch.int32, device="cuda")
    for impl in ("flash", "dense"):
        fns = model_mod.make_serve_fns(dataclasses.replace(
            cfg, decode_attn_impl=impl))
        step = lambda: fns.decode(serve_params, caches, tok1, cur)
        figures[f"decode_{impl}_device_ms"] = step_device_ms(step)
        figures[f"decode_{impl}_ms"] = time_ms(step, iters=10)
    log(f"  one decode step, B8 at position {bucket + 32} of a "
        f"{BASELINE_MAX_LEN}-slot cache: flash "
        f"{figures['decode_flash_device_ms']:.4f} ms of device time "
        f"({figures['decode_flash_ms']:.4f} ms by events, host in the "
        f"loop), dense {figures['decode_dense_device_ms']:.4f} ms "
        f"({figures['decode_dense_ms']:.4f})")
    figures["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 5w took {figures['phase_s']:.1f} s")
    return flash, blocking_int8, figures


def trace_serve(eng, cfg, Request, rng) -> tuple:
    """Where the time goes: a short serve run (8 requests, 256-token
    prompts, 32 new tokens) under ``torch.profiler``; prints the device
    busy share of the wall clock and the kernels by device time.  The
    profiler records the card's activity only (kernels, copies, the
    runtime calls that launch them), not every host op, which keeps its
    post-processing short; it still slows the host, so the busy share is
    a lower bound.  Then, on a contiguous engine, the kernel launches one
    prefill chunk issues (batch 1, 32 tokens at offset 32 of a fresh chunk
    cache, after one untraced chunk), and on either layout the launches one
    decode step issues (``decode_step_launches``).  A measurement only: it
    prints why when the profiler sees no device.  Returns the device busy
    ms, the launches issued, the launches a chunk and the launches a
    decode step (None where not measured)."""
    from torch.profiler import ProfilerActivity, profile
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, 256).tolist(),
                    max_new_tokens=32) for _ in range(8)]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.generate(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, _ = trace_summary(prof, wall, (
        "copy_scatter_kernel", "quant_scatter_kernel",
        "quant_paged_scatter_kernel",
        "decode_attention_kernel", "prefill_attention_kernel",
        "prefill_tc_kernel"))
    per_chunk = None
    if eng.kv_layout == "contiguous":
        from repro_torch.models import model as model_mod
        caches = model_mod.init_caches(eng.cfg, 1, eng.max_len,
                                       dtype=eng.cache_dtype,
                                       device=eng.device)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 32)),
                               device=eng.device)
        eng._fns.prefill_chunk(eng.params, caches, toks[:1], 0, 31)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as chunk_prof:
            eng._fns.prefill_chunk(eng.params, caches, toks[1:], 32, 31)
            torch.cuda.synchronize()
        from torch.autograd import DeviceType
        per_chunk = launches_issued(chunk_prof)
        ran = sum(e.count for e in chunk_prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation)
        log(f"  trace: one prefill chunk (B1, 32 tokens, {cfg.num_layers} "
            f"layers) issues {per_chunk} kernel launches; {ran} device "
            f"kernels and copies run")
    per_decode = decode_step_launches(eng, rng)
    log(f"  trace: one decode step (B{eng.batch}, {cfg.num_layers} layers, "
        f"{eng.kv_layout}) issues {per_decode} kernel launches")
    return busy, launches_issued(prof) if busy is not None else None, \
        per_chunk, per_decode


def decode_step_launches(eng, rng) -> int:
    """Kernel launches one decode step of the engine's batch issues, by
    ``torch.profiler``: a fresh cache (or fresh pools of 4 pages a slot)
    at positions 3, 10, ..., after one untraced step there."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import model as model_mod
    b, dev = eng.batch, eng.device
    toks = torch.as_tensor(rng.integers(0, eng.cfg.vocab_size, (b, 1)),
                           device=dev)
    cur = torch.arange(b, dtype=torch.int32, device=dev) * 7 + 3
    if eng.kv_layout == "paged":
        nb, ps = 4, eng.kv_page_size
        caches = model_mod.init_paged_caches(eng.cfg, 1 + b * nb, ps,
                                             eng.cache_dtype, dev)
        table = torch.arange(1, 1 + b * nb, dtype=torch.int32,
                             device=dev).reshape(b, nb)
        step = lambda: eng._paged_fns.decode(eng.params, caches, toks, cur,
                                             table)
    else:
        caches = model_mod.init_caches(eng.cfg, b, eng.max_len,
                                       dtype=eng.cache_dtype, device=dev)
        step = lambda: eng._fns.decode(eng.params, caches, toks, cur)
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    return launches_issued(prof)


def launches_issued(prof) -> int:
    """Kernel launches the host issued under ``prof`` (its
    cudaLaunchKernel and cuLaunchKernelEx calls)."""
    return sum(e.count for e in prof.key_averages()
               if e.key in ("cudaLaunchKernel", "cuLaunchKernelEx"))


def trace_summary(prof, wall: float, kernel_names) -> tuple:
    """Print the device busy share of ``wall``, the launches issued, the
    ten costliest device rows, and the time per launch of each row whose
    name holds one of ``kernel_names``.  Returns the device busy ms and
    the device ms of those rows (None, None where the profiler saw no
    device)."""
    from torch.autograd import DeviceType
    # Device rows only (kernels, copies): a host op's row repeats the
    # device time of the kernels it launched, so summing every row
    # would count that time twice.
    averages = prof.key_averages()
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in averages
            if e.device_type == DeviceType.CUDA
            and not e.is_user_annotation]
    busy_us = sum(t for _, t, _ in rows)
    if busy_us <= 0:
        log("  trace: the profiler recorded no device time")
        return None, None
    # kernel launches the host issued, and the device rows' executions
    # (kernels, copies, sets)
    issued = launches_issued(prof)
    executed = sum(n for _, _, n in rows)
    log(f"  trace: wall {wall * 1e3:.1f} ms, device busy "
        f"{busy_us / 1e3:.1f} ms ({100 * busy_us / 1e6 / wall:.1f}% of "
        f"wall, under the profiler); {issued} kernel launches issued, "
        f"{executed} device kernels and copies run")
    for key, t, n in sorted(rows, key=lambda r: -r[1])[:10]:
        log(f"    {t / 1e3:9.2f} ms  {n:6d} calls  {key[:90]}")
    named_us = 0.0
    for key, t, n in rows:
        if any(name in key for name in kernel_names):
            named_us += t
            log(f"  trace: {t / max(n, 1):.2f} us of device time per "
                f"launch, {n} launches, {100 * t / busy_us:.1f}% of device "
                f"time: {key[:70]}")
    return busy_us / 1e3, named_us / 1e3


# -- phase 5t: train at full width --------------------------------------------
TRAIN_STEPS = 20
TRAIN_BATCH, TRAIN_SEQ = 8, 2048          # SmolLM's training context
# One bf16 step at the same weights and batch through the kernel and
# through the chunked XLA-style path, at the initial weights and after
# 20 steps: chunked rounds its scores and probabilities to bf16 where
# the kernel keeps fp32, so loss and grad norm differ by what those
# roundings move.  After 20 steps (the loss has flattened at ~6.08
# after its fast fall) the card measured 2.2e-6 (loss) and 1.25e-5
# (grad norm) relative; the gate leaves ~50x for other weights and
# data.
TRAIN_IMPL_TOL = {"loss": 1e-4, "grad_norm": 1e-3}      # relative
# Reduced fp32 train step, card against CPU: fp32 sums in other orders
# (TF32 off) — the CPU tests' tolerances against the JAX package: loss
# and grad norm 1e-5 relative, first moments (0.1 x clipped grads) 1e-7
# absolute plus 1e-4 relative.
TRAIN_CARD_TOL = {"loss": 1e-5, "m_atol": 1e-7, "m_rtol": 1e-4}


def _state_to(train, optim, state, dev):
    """A copy of a train state on ``dev`` (parameters require grad)."""
    copy = lambda t: t.detach().to(dev, copy=True)
    return train.TrainState(
        params=optim.tree_map(lambda t: copy(t).requires_grad_(),
                              state.params),
        opt=optim.OptState(step=copy(state.opt.step),
                           inner=optim.tree_map(copy, state.opt.inner)))


def _loss_and_gnorm(model_mod, optim, cfg, params, batch) -> tuple:
    loss, _ = model_mod.loss_fn(cfg)(params, batch)
    grads = torch.autograd.grad(loss, optim.tree_leaves(params))
    return (float(loss.detach()),
            float(optim.global_norm(dict(enumerate(grads)))))


def _check_impls(model_mod, optim, cfg, params, batch, which) -> None:
    """The kernel inside the whole model: loss and grad norm of one step
    through it and through chunked attention, same weights and batch."""
    got = {impl: _loss_and_gnorm(model_mod, optim, dataclasses.replace(
        cfg, attn_impl=impl), params, batch)
        for impl in ("pallas", "chunked")}
    dl = abs(got["pallas"][0] - got["chunked"][0]) / got["chunked"][0]
    dg = abs(got["pallas"][1] - got["chunked"][1]) / got["chunked"][1]
    log(f"  step at {which} weights, pallas against chunked: loss "
        f"{got['pallas'][0]:.5f} / {got['chunked'][0]:.5f} ({dl:.2e} "
        f"relative, tol {TRAIN_IMPL_TOL['loss']}), grad norm "
        f"{got['pallas'][1]:.5f} / {got['chunked'][1]:.5f} ({dg:.2e}, tol "
        f"{TRAIN_IMPL_TOL['grad_norm']})")
    if not (dl <= TRAIN_IMPL_TOL["loss"]
            and dg <= TRAIN_IMPL_TOL["grad_norm"]):
        raise AssertionError("the kernel's model disagrees with chunked "
                             "attention")


def train_cell(configs, train, optim, data, dev) -> tuple:
    """Phase 5t's cell: full-width smollm-135m (``attn_impl="pallas"``,
    ``remat="full"``), AdamW decaying over TRAIN_STEPS, batches 0 to
    TRAIN_STEPS of ``SyntheticLMDataset`` seed 0 (8 x 2048) on ``dev``,
    and the train state from seed 0.  Returns (cfg, ocfg, batches,
    state).  ``in_turn.py`` runs the same cell on two checkouts."""
    cfg = configs.get_config("smollm-135m", attn_impl="pallas",
                             remat="full")
    ocfg = optim.OptimizerConfig(lr=3e-3, warmup_steps=5,
                                 decay_steps=TRAIN_STEPS)
    ds = data.SyntheticLMDataset(data.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        global_batch=TRAIN_BATCH, seed=0))
    batches = [{k: torch.as_tensor(v, device=dev)
                for k, v in ds.batch(i).items()}
               for i in range(TRAIN_STEPS + 1)]
    state = train.init_train_state(cfg, ocfg, seed=0, device=dev)
    return cfg, ocfg, batches, state


def measured_steps(train, pmt, nvml, fa_kernel, step_fn, state,
                   batches) -> tuple:
    """Phase 5t's measured run: steps 1 to TRAIN_STEPS through
    ``make_measured_train_step`` under a ``PowerMonitor`` on
    ``Session(["cpuutil", "nvml"])``, the wall clock and an NVML
    ``EnergyMeter`` around them, the flash launches counted from 0.
    Returns the state and a dict: losses, flash launches per step,
    nvml joules per step through the session, wall s, meter joules and
    method, the launch counts."""
    kernels = {"flash_attention": fa_kernel}
    tokens = TRAIN_BATCH * TRAIN_SEQ
    session = pmt.Session(["cpuutil", "nvml"])
    monitor = pmt.PowerMonitor(session=session)
    measured = train.make_measured_train_step(step_fn, monitor,
                                              tokens_per_step=tokens)
    reader = nvml.NvmlReader(0)
    try:
        meter = nvml.EnergyMeter(reader)
        losses, per_step, boxes = [], [], []
        zero_counts(kernels)
        meter.start()
        t0 = time.perf_counter()
        for i in range(1, TRAIN_STEPS + 1):
            before = fa_kernel.launches
            state, metrics, box = measured(state, batches[i], i)
            per_step.append(fa_kernel.launches - before)
            losses.append(float(metrics["loss"]))
            boxes.append(box)
        wall = time.perf_counter() - t0
        joules = meter.stop()
        launches = read_counts(kernels)
    finally:
        reader.close()
    step_j = [sum(r.joules for r in b.records if r.sensor == "nvml")
              for b in boxes]
    monitor.close()
    session.close()
    return state, {"losses": losses, "per_step": per_step,
                   "step_j": step_j, "wall": wall, "joules": joules,
                   "method": meter.method, "launches": launches}


def train_full(configs, model_mod, train, optim, data, ckpt, fa_kernel,
               nvml, pmt):
    """Phase 5t: ``train_cell``, bf16 compute on fp32 masters: one
    warm-up step, then ``measured_steps``.  Kernel against chunked
    attention at the initial weights, and again at the trained ones;
    then one step traced; the reduced fp32 model's step on the card
    against the CPU; a checkpoint restart on the card against the
    uninterrupted run.  Returns the launch counts of the measured
    steps."""
    dev = torch.device("cuda")
    cfg, ocfg, batches, state = train_cell(configs, train, optim, data, dev)
    _check_impls(model_mod, optim, cfg, state.params, batches[0],
                 "the initial")
    step_fn = train.make_train_step(cfg, ocfg)
    t0 = time.perf_counter()
    state, _ = step_fn(state, batches[0])
    torch.cuda.synchronize()
    log(f"  warm-up step in {time.perf_counter() - t0:.2f} s")

    tokens = TRAIN_BATCH * TRAIN_SEQ
    torch.cuda.reset_peak_memory_stats()
    state, run = measured_steps(train, pmt, nvml, fa_kernel, step_fn, state,
                                batches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses, per_step, step_j = run["losses"], run["per_step"], run["step_j"]
    wall, joules = run["wall"], run["joules"]
    log(f"  losses {' '.join(f'{x:.4f}' for x in losses)}")
    log(f"  {TRAIN_STEPS} steps of {tokens} tokens in {wall:.3f} s: "
        f"{TRAIN_STEPS * tokens / wall:.0f} tokens/s, "
        f"{wall / TRAIN_STEPS * 1e3:.1f} ms/step; card {joules:.1f} J "
        f"({run['method']}): {joules / TRAIN_STEPS:.2f} J/step, "
        f"{joules / (TRAIN_STEPS * tokens) * 1e3:.4f} mJ/token, "
        f"{joules / wall:.1f} W; peak memory {peak:.2f} GiB")
    log(f"  flash launches per step {per_step} (expected "
        f"{2 * cfg.num_layers}: forward + recompute of {cfg.num_layers} "
        f"layers)")
    gap = abs(sum(step_j) - joules) / joules
    log(f"  per-step nvml joules through the session {sum(step_j):.1f} J "
        f"against the meter's {joules:.1f} J ({100 * gap:.2f}% apart, tol "
        f"10%); J/step {min(step_j):.2f}-{max(step_j):.2f}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite losses: {losses}")
    if not np.mean(losses[-5:]) < np.mean(losses[:5]):
        raise AssertionError(f"loss did not fall: {losses}")
    if any(n != 2 * cfg.num_layers for n in per_step):
        raise AssertionError(f"flash launches per step {per_step}")
    if not gap <= 0.10:
        raise AssertionError("per-step joules disagree with the meter")

    _check_impls(model_mod, optim, cfg, state.params, batches[-1],
                 "the trained")
    trace_train(step_fn, state, batches[-1])
    del state, batches
    check_train_reference(configs, train, optim, data, ckpt)
    return run["launches"]


def trace_train(step_fn, state, batch) -> tuple:
    """Where a train step's time goes: one step under ``torch.profiler``.
    Returns the step's wall ms, the device busy ms and the flash
    kernels' device ms."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return (wall * 1e3, *trace_summary(prof, wall, ("flash_attention_",)))


def check_train_reference(configs, train, optim, data, ckpt) -> None:
    """Reduced smollm-135m in fp32 with the kernel (3 heads of 64): one
    train step on the card against the same step on the CPU from the
    same state; then 3 steps, a checkpoint, 3 more, against a fresh state
    restored from that checkpoint and stepped 3 times — under
    ``torch.use_deterministic_algorithms(True)``, since the embedding
    gather's backward accumulates with atomics by default.  Without
    ``warn_only``: an op with no deterministic version raises (cuBLAS is
    made deterministic by ``CUBLAS_WORKSPACE_CONFIG``, set in ``main``
    before the first matmul), so the gate can be tight."""
    cfg = configs.get_config("smollm-135m", reduced=True, dtype="float32",
                             attn_impl="pallas")
    ocfg = optim.OptimizerConfig(lr=3e-3, warmup_steps=2, decay_steps=10)
    ds = data.SyntheticLMDataset(data.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=64, global_batch=4, seed=0))
    batch = lambda i, dev: {k: torch.as_tensor(v, device=dev)
                            for k, v in ds.batch(i).items()}
    step_fn = train.make_train_step(cfg, ocfg)
    init = train.init_train_state(cfg, ocfg, seed=0, device="cpu")
    out = {}
    for dev in ("cpu", "cuda"):
        st, m = step_fn(_state_to(train, optim, init, dev), batch(1, dev))
        out[dev] = (float(m["loss"]), float(m["grad_norm"]),
                    [t.cpu() for t in optim.tree_leaves(st.opt.inner["m"])])
    (lc, gc, mc), (lg, gg, mg) = out["cpu"], out["cuda"]
    dm = max(float(((a - b).abs() - TRAIN_CARD_TOL["m_rtol"] * b.abs())
                   .max()) for a, b in zip(mg, mc))
    log(f"  reduced fp32 train step (flash kernel), card vs CPU: "
        f"loss {lg:.7f} / {lc:.7f}, grad norm {gg:.7f} / {gc:.7f}, first "
        f"moments max |err| - rtol |m| {dm:.3g} (tol "
        f"{TRAIN_CARD_TOL['m_atol']})")
    if not (abs(lg - lc) <= TRAIN_CARD_TOL["loss"] * abs(lc)
            and abs(gg - gc) <= TRAIN_CARD_TOL["loss"] * abs(gc)
            and dm <= TRAIN_CARD_TOL["m_atol"]):
        raise AssertionError("the train step on the card disagrees with "
                             "the CPU")

    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            run = _state_to(train, optim, init, "cuda")
            for i in range(1, 7):
                run, _ = step_fn(run, batch(i, "cuda"))
                if i == 3:
                    ckpt.save(tmp, 3, train.checkpoint_tree(cfg, run),
                              ckpt.CheckpointMeta(step=3, data_step=3))
            other = train.init_train_state(cfg, ocfg, seed=1, device="cuda")
            tree, meta = ckpt.restore(tmp, train.checkpoint_tree(cfg, other))
            resumed = train.from_checkpoint_tree(cfg, tree)
            for i in range(meta.data_step + 1, 7):
                resumed, _ = step_fn(resumed, batch(i, "cuda"))
    finally:
        torch.use_deterministic_algorithms(False)
    pairs = [(a.detach(), b.detach()) for a, b in zip(
        optim.tree_leaves(resumed.params), optim.tree_leaves(run.params))]
    err = max(max_err(a, b) for a, b in pairs)
    same = all(torch.equal(a, b) for a, b in pairs)
    log(f"  reduced fp32 checkpoint restart at step 3 of 6 on the card "
        f"(deterministic algorithms): parameters max |err| {err:.3g} "
        f"against the uninterrupted run (tol rtol 1e-5, atol 1e-6); "
        f"bit for bit: {same}")
    if not all(torch.allclose(a, b, rtol=1e-5, atol=1e-6) for a, b in pairs):
        raise AssertionError("the restarted run departs from the "
                             "uninterrupted one")


# -- phase 6: the paper's Fig. 2 on the card ----------------------------------

def probe_nvml(reader, fma32_cuda):
    """Which NVML quantity follows the card: samples the total-energy
    counter and the power reading every ~2 ms for 2 s, with FMA32 load
    from 0.5 s to ~1.5 s; prints each one's update interval and the time
    each takes to rise halfway from idle to loaded.  A measurement
    only."""
    x = torch.randn(8192, 8192, device="cuda")
    fma32_cuda(x, 1024)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fma32_cuda(x, 1024)
    torch.cuda.synchronize()
    per_call = time.perf_counter() - t0
    samples, load_at = [], None
    start = time.perf_counter()
    while (now := time.perf_counter() - start) < 2.0:
        if load_at is None and now >= 0.5:
            for _ in range(max(1, int(1.0 / per_call))):
                fma32_cuda(x, 1024)
            load_at = time.perf_counter() - start
        samples.append((time.perf_counter() - start, reader.energy_joules(),
                        reader.power_watts()))
        time.sleep(0.002)
    torch.cuda.synchronize()
    t = np.array([s[0] for s in samples])
    w = np.array([s[2] for s in samples])

    def step_ms(v):
        changed = t[1:][np.diff(v) != 0]
        return float(np.median(np.diff(changed)) * 1e3) \
            if changed.size > 1 else float("nan")

    def half_rise_ms(tt, v):
        idle = np.median(v[tt < load_at])
        loaded = np.median(v[(tt > load_at + 0.5) & (tt < load_at + 0.9)])
        above = tt[(tt >= load_at) & (v >= (idle + loaded) / 2)]
        rise = (above[0] - load_at) * 1e3 if above.size else float("nan")
        return float(rise), float(idle), float(loaded)

    pw = half_rise_ms(t, w)
    log(f"  NVML power reading: updates every {step_ms(w):.1f} ms "
        f"(median), idle {pw[1]:.1f} W, loaded {pw[2]:.1f} W, half-rise "
        f"{pw[0]:.0f} ms after the load starts")
    if samples[0][1] is None:
        log("  NVML total-energy counter: unsupported on this card")
        return
    e = np.array([s[1] for s in samples])
    # the counter's power between consecutive updates of the counter
    idx = np.flatnonzero(np.diff(e) != 0) + 1
    cw = half_rise_ms(t[idx][1:], np.diff(e[idx]) / np.diff(t[idx]))
    log(f"  NVML total-energy counter: updates every {step_ms(e):.1f} ms "
        f"(median); its power between updates: idle {cw[1]:.1f} W, "
        f"loaded {cw[2]:.1f} W, half-rise {cw[0]:.0f} ms after the load "
        f"starts")


def _host_tree(name, rapl, sysfs) -> tuple:
    """(files the back end would read, the readable ones) on this
    machine."""
    if name == "rapl":
        files = [d["path"] for d in rapl.RaplSensor._discover(
            rapl.DEFAULT_ROOT)]
    else:
        files = sysfs._discover(sysfs.DEFAULT_HWMON_GLOBS)
    readable = []
    for f in files:
        try:
            with open(f) as fh:
                float(fh.read().strip())
            readable.append(f)
        except (OSError, ValueError) as exc:
            log(f"  {name}: {f} not readable ({type(exc).__name__}: {exc})")
    return files, readable


def probe_host_sensors(pmt, fma32_cuda):
    """Which host sensors this machine offers: for ``rapl`` (powercap)
    and ``sysfs`` (hwmon) whether the files are there, whether they can
    be read, and where they can, the host's watts through the back end
    over 2 s idle and 2 s of FMA32 on the card.  A machine without the
    files fails nothing; a back end that has readable files but raises,
    or whose joules do not increase, fails the run."""
    from repro_torch.core.backends import rapl, sysfs
    x = torch.randn(8192, 8192, device="cuda")
    fma32_cuda(x, 1024)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fma32_cuda(x, 1024)
    torch.cuda.synchronize()
    per_call = time.perf_counter() - t0
    for name in ("rapl", "sysfs"):
        files, readable = _host_tree(name, rapl, sysfs)
        where = rapl.DEFAULT_ROOT if name == "rapl" else "/sys/class/hwmon"
        if not files:
            log(f"  {name}: no files under {where}: not present here")
            continue
        log(f"  {name}: {len(files)} file(s) under {where}, "
            f"{len(readable)} readable")
        if not readable or (name == "rapl" and len(readable) < len(files)):
            log(f"  {name}: present but not readable here: host watts not "
                f"measured")
            continue
        sensor = pmt.create(name, root=rapl.DEFAULT_ROOT) \
            if name == "rapl" else pmt.create(name, files=readable)
        a = sensor.read()
        time.sleep(2.0)
        b = sensor.read()
        end = time.perf_counter() + 2.0
        while time.perf_counter() < end:
            for _ in range(max(1, int(0.25 / per_call))):
                fma32_cuda(x, 1024)
            torch.cuda.synchronize()
        c = sensor.read()
        log(f"  {name} ({sensor.kind}): host {pmt.watts(a, b):.1f} W idle "
            f"over {pmt.seconds(a, b):.2f} s, {pmt.watts(b, c):.1f} W under "
            f"FMA32 on the card over {pmt.seconds(b, c):.2f} s")
        if not (b.joules > a.joules and c.joules > b.joules):
            raise AssertionError(f"{name}: joules did not increase "
                                 f"({a.joules}, {b.joules}, {c.joules})")


def fig2_phase(fig2, nvml, kernels):
    """Run ``launch/fig2.py`` at full size with every Fig. 2 launch count
    set to 0 just before it; an independent ``EnergyMeter`` reads each
    row's window.  Fails when a kernel was not launched, a busy row's
    card watts are not above SLEEP's, or a row's session joules and the
    meter's differ by more than 10%.  Returns the launch counts."""
    zero_counts(kernels)
    reader = nvml.NvmlReader(0)
    try:
        rows = fig2.run("cuda", meter=nvml.EnergyMeter(reader))
    finally:
        reader.close()
    launches = read_counts(kernels)
    log(f"  card joules from the nvml sensor's {rows[0].card_method}")
    for line in fig2.format_rows(rows):
        log(f"  {line}")
    log(f"  kernel launches {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"Fig. 2 path")
    sleep = rows[0]
    for r in rows:
        gap = abs(r.card_joules - r.meter_joules) / r.meter_joules
        log(f"  {r.name}: {r.calls} calls in {r.seconds:.3f} s; card "
            f"{r.card_joules:.2f} J through the session, {r.meter_joules:.2f} "
            f"J by the meter ({100 * gap:.2f}% apart, tol 10%)")
        if not gap <= 0.10:
            raise AssertionError(f"{r.name}: session and meter joules "
                                 f"differ by more than 10%")
        if r is not sleep and not r.card_watts > sleep.card_watts:
            raise AssertionError(f"{r.name}: card {r.card_watts:.1f} W is "
                                 f"not above SLEEP's {sleep.card_watts:.1f} W")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs on "
              "the card", file=sys.stderr)
        return 1
    # cuBLAS's deterministic setting, for phase 5t's restart check; its
    # workspace is 8 x 4 MiB, PyTorch's default on Hopper
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.core.backends import nvml
    from repro_torch.kernels import build, latent_attention, quant
    from repro_torch.kernels.cache_update import kernel as cu_kernel
    from repro_torch.kernels.cache_update import ops as cu_ops
    from repro_torch.kernels.cache_update import ref as cu_ref
    from repro_torch.kernels.decode_attention import kernel as da_kernel
    from repro_torch.kernels.decode_attention import ref as da_ref
    from repro_torch.kernels.prefill_attention import kernel as pa_kernel
    from repro_torch.kernels.prefill_attention import ref as pa_ref
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.fma32 import kernel as fma_kernel
    from repro_torch.kernels.fma32 import ref as fma_ref
    from repro_torch.kernels.gemm import kernel as gemm_kernel
    from repro_torch.kernels.gemm import ref as gemm_ref
    from repro_torch.kernels.gridder import kernel as grid_kernel
    from repro_torch.kernels.gridder import ref as grid_ref
    from repro_torch.kernels.jacobi2d import kernel as jac_kernel
    from repro_torch.kernels.jacobi2d import ref as jac_ref
    from repro_torch.kernels.stream import kernel as st_kernel
    from repro_torch.kernels.stream import ref as st_ref
    import repro_torch.core as pmt
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.data import pipeline as data
    from repro_torch.launch import fig2
    from repro_torch.launch import serve as serve_launch
    from repro_torch.models import model as model_mod
    from repro_torch.optim import optimizers as optim
    from repro_torch import telemetry
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.governor import PowerGovernor
    from repro_torch.serve.swap import PageSwapStore
    from repro_torch.train import steps as train

    t_start = time.perf_counter()
    elapsed = lambda: f"({time.perf_counter() - t_start:.0f} s in)"
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
        "cache_update": check_cache_update(cu_kernel, cu_ref,
                                           build.library(), dev),
        "prefill_attention": check_prefill(pa_kernel, pa_ref, dev),
        "decode_attention": check_decode(da_kernel, da_ref, dev),
        "paged_cache_update": check_paged_cache_update(
            cu_kernel, cu_ref, build.library(), dev),
        "prefill_attention_paged": check_paged_prefill(pa_kernel, pa_ref,
                                                       dev),
        "decode_attention_paged": check_paged_decode(da_kernel, da_ref,
                                                     dev),
    }
    check_decode_smem(build.library(), da_kernel)
    sweep_decode_splits(da_kernel, da_ref, dev)
    log(f"[3q] quantized caches (int8, fp8_e4m3): the quantizing scatters "
        f"bit for bit, the attention kernels over codes {elapsed()}")
    quant_timings = {
        "quant_cache_update": check_quant_cache_update(cu_kernel, cu_ref,
                                                       quant, dev),
        "quant_paged_cache_update": check_quant_paged_cache_update(
            cu_kernel, cu_ref, quant, dev),
    }
    for name, check, kernel, ref in (
            ("prefill_attention", check_prefill, pa_kernel, pa_ref),
            ("decode_attention", check_decode, da_kernel, da_ref),
            ("prefill_attention_paged", check_paged_prefill, pa_kernel,
             pa_ref),
            ("decode_attention_paged", check_paged_decode, da_kernel,
             da_ref)):
        quant_timings[name] = {m: check(kernel, ref, dev, mode=m)
                               for m in MODES}
    for name, by_mode in quant_timings.items():
        for mode, t in by_mode.items():
            graph = f" ({t['graph_ms']:.5f} in a CUDA graph)" \
                if "graph_ms" in t else ""
            log(f"  {name} {mode}: kernel {t['ms']:.4f} ms{graph}, plain "
                f"{t['plain_ms']:.4f} ms, library none, bound "
                f"{t['bound_ms']:.6f} ms ({t['bound_by']})")

    log(f"[3v] MLA's aliased latent cache: rows 2v, 3v, 7v, 8v (v_width) "
        f"over bf16, int8 and fp8_e4m3 caches, and the one-leaf scatters "
        f"at F 576 {elapsed()}")
    latent_timings = check_latent({
        "decode": (da_kernel.decode_attention_cuda,
                   da_ref.decode_attention_ref),
        "prefill": (pa_kernel.prefill_attention_cuda,
                    pa_ref.prefill_attention_ref),
        "decode_paged": (da_kernel.decode_attention_paged_cuda,
                         da_ref.decode_attention_paged_ref),
        "prefill_paged": (pa_kernel.prefill_attention_paged_cuda,
                          pa_ref.prefill_attention_paged_ref)}, dev)
    check_latent_scatters(cu_ops, cu_ref, quant, dev)
    check_latent_plan(build.library(), latent_attention)

    log(f"[3b] Fig. 2 kernels against their plain versions {elapsed()}")
    timings.update({
        "fma32": check_fma32(fma_kernel, fma_ref, dev),
        "stream_triad": check_stream(st_kernel, st_ref, dev),
        "gemm": check_gemm(gemm_kernel, gemm_ref, dev),
        "jacobi2d": check_jacobi2d(jac_kernel, jac_ref, dev),
    })
    timings.update(check_gridder(grid_kernel, grid_ref, dev,
                                 build.library_path()))
    log(f"  the kernels redesigned for Hopper: SASS and ptxas {elapsed()}")
    check_redesigns(build)
    log(f"[3f] flash attention against its plain version {elapsed()}")
    if build.build_log:
        log_ptxas_usage(build.build_log["flash_attention.cu"],
                        "flash_attention_")
    check_flash_smem(build.library(), fa_kernel)
    timings["flash_attention"] = check_flash(fa_kernel, fa_ref, fa_ops, dev,
                                             build.library_path())
    for name, t in timings.items():
        lib = "none" if t["library_ms"] is None else f"{t['library_ms']:.4f}"
        log(f"  {name}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} "
            f"ms, library {lib} ms, bound {t['bound_ms']:.5f} ms "
            f"({t['bound_by']})")
    log(f"  flash_attention backward (the oracle's VJP, plain on the card): "
        f"{timings['flash_attention']['backward_plain_ms']:.4f} ms a call "
        f"at the train shape")

    log(f"[4] small reference: reduced smollm-135m fp32, card vs CPU "
        f"{elapsed()}")
    check_small_reference(configs, model_mod, ServeEngine, Request)
    check_small_quantized(configs, model_mod, ServeEngine, Request)
    log(f"[4m] small reference, MLA: reduced deepseek-v3 (moe None, mtp "
        f"off) fp32, card vs CPU {elapsed()}")
    check_small_mla(configs, model_mod, ServeEngine, Request, {
        "decode_attention v": da_kernel, "prefill_attention v": pa_kernel,
        "decode_attention_paged v": da_kernel,
        "prefill_attention_paged v": pa_kernel,
        "decode_attention v quant": da_kernel,
        "prefill_attention v quant": pa_kernel})
    log(f"[4w] small reference, the serve baselines: blocking, waves, "
        f"dense decode, sampling {elapsed()}")
    check_small_baselines(configs, model_mod, ServeEngine, Request,
                          cu_kernel)

    log(f"[5] serve full-width smollm-135m, 16 requests, 8 slots, "
        f"max_len 1024, chunk 32, bf16 {elapsed()}")
    kernels = {"cache_update": cu_kernel, "prefill_attention": pa_kernel,
               "decode_attention": da_kernel}
    launches, prompts, bf16_tokens, bf16_bytes, bf16_trace, chunked, \
        live = serve_full(configs, model_mod, ServeEngine, Request, kernels,
                          nvml, pmt, serve_launch, telemetry, PowerGovernor)

    log(f"[5b] serve full-width smollm-135m paged: 16 requests sharing a "
        f"256-token system prompt, 8 slots, max_len 1024, chunk 32, page 16, "
        f"bf16, cold then warm {elapsed()}")
    paged_kernels = {"paged_cache_update": cu_kernel,
                     "prefill_attention_paged": pa_kernel,
                     "decode_attention_paged": da_kernel}
    launches.update(serve_paged(configs, model_mod, ServeEngine, Request,
                                paged_kernels, nvml, pmt, serve_launch,
                                kernels))

    log(f"[5p] the preemption plane on the paged path: (a) reduced fp32 "
        f"smollm-135m (pages of 8 and 16) and deepseek-v3 (pages of 16) "
        f"under pool pressure, card vs CPU; (b) full-width smollm-135m, "
        f"phase 5's 16 requests on {PREEMPT_POOL_PAGES} pages of 16, with a "
        f"swap store and without; (c) quarantine and the watchdog "
        f"{elapsed()}")
    check_small_preempt(configs, model_mod, ServeEngine, Request,
                        PageSwapStore)
    preempt_launches, full_params = serve_preempt(
        configs, model_mod, ServeEngine, Request, paged_kernels, kernels,
        nvml, pmt, serve_launch, PageSwapStore, prompts, bf16_tokens, card)
    check_quarantine_card(configs, ServeEngine, Request, full_params,
                          prompts, card)
    del full_params

    log(f"[5g] the power governor and the telemetry plane at full width: "
        f"(a) was phase 5's run 2; (b) a binding cap and (c) an unholdable "
        f"one on phase 5's contiguous engine; (d) paged on "
        f"{PREEMPT_POOL_PAGES} pages with preemption, a pool reserve, a "
        f"shed request and the HTTP/SSE server {elapsed()}")
    t_phase = time.perf_counter()
    try:
        governor_launches = serve_governed(
            live, Request, kernels, nvml, serve_launch, prompts,
            PowerGovernor, chunked, card)
    finally:
        live["recorder"].close()
        live["session"].close()
        del live
    governor_launches.update(serve_governed_paged(
        configs, model_mod, ServeEngine, Request, paged_kernels, kernels,
        nvml, pmt, serve_launch, telemetry, PowerGovernor, PageSwapStore,
        prompts, card))
    log(f"  5g launches: (b) rows 1-3 and (d) rows 4, 7, 8: "
        f"{governor_launches}")
    log(f"  phase 5g took {time.perf_counter() - t_phase:.1f} s")

    log(f"[5c] serve smollm-135m at full width, {PHASE_5C_LAYERS} of its "
        f"layers, with quantized KV caches: phase 5's 16 requests, int8 and "
        f"fp8_e4m3, contiguous and paged (page 16), 8 slots, max_len 1024, "
        f"chunk 32, bf16 weights {elapsed()}")
    quant_kernels = {
        "contiguous": {"quant_cache_update": cu_kernel,
                       "prefill_attention quant": pa_kernel,
                       "decode_attention quant": da_kernel},
        "paged": {"quant_paged_cache_update": cu_kernel,
                  "prefill_attention_paged quant": pa_kernel,
                  "decode_attention_paged quant": da_kernel}}
    all_kernels = dict(kernels, **paged_kernels,
                       **quant_kernels["contiguous"], **quant_kernels["paged"])
    others = {layout: {k: m for k, m in all_kernels.items() if k not in ks}
              for layout, ks in quant_kernels.items()}
    quant_launches = serve_quantized(
        configs, model_mod, ServeEngine, Request, quant_kernels, others,
        nvml, pmt, serve_launch, prompts, bf16_tokens, bf16_bytes,
        bf16_trace)

    log(f"[5m] serve deepseek-v3's three dense MLA layers at full width: "
        f"phase 5's 16 requests, 8 slots, max_len 1024, chunk 32, bf16 "
        f"weights; contiguous and paged (page 16) over bf16, paged and "
        f"contiguous over int8 {elapsed()}")
    mla_runs = {
        "contiguous bf16": {"decode_attention v": da_kernel,
                            "prefill_attention v": pa_kernel,
                            "cache_update": cu_kernel},
        "paged bf16": {"decode_attention_paged v": da_kernel,
                       "prefill_attention_paged v": pa_kernel,
                       "paged_cache_update": cu_kernel},
        "paged int8": {"decode_attention_paged v quant": da_kernel,
                       "prefill_attention_paged v quant": pa_kernel,
                       "quant_paged_cache_update": cu_kernel},
        "contiguous int8": {"decode_attention v quant": da_kernel,
                            "prefill_attention v quant": pa_kernel,
                            "quant_cache_update": cu_kernel}}
    mla_all = dict(all_kernels, **{k: m for run in mla_runs.values()
                                   for k, m in run.items()})
    mla_launches, mla_figures = serve_mla(
        configs, model_mod, ServeEngine, Request, mla_runs, mla_all, nvml,
        pmt, serve_launch, prompts)

    log(f"[5w] serve full-width smollm-135m's baselines: phase 5's 16 "
        f"requests, blocking (prefill_chunk 0) then waves of 8 over a bf16 "
        f"cache, then blocking over an int8 cache, 8 slots, max_len "
        f"{BASELINE_MAX_LEN}, attn_impl pallas, bf16 weights {elapsed()}")
    flash_serve, blocking_int8, baselines = serve_baselines(
        configs, model_mod, ServeEngine, Request, cu_kernel, da_kernel,
        fa_kernel, pa_kernel, nvml, pmt, serve_launch, prompts, chunked)

    log(f"[5t] train full-width smollm-135m: batch {TRAIN_BATCH} x "
        f"{TRAIN_SEQ}, bf16 on fp32 masters, AdamW, remat full, "
        f"attn_impl pallas, {TRAIN_STEPS} measured steps {elapsed()}")
    launches.update(train_full(configs, model_mod, train, optim, data, ckpt,
                               fa_kernel, nvml, pmt))

    log(f"[6] the paper's Fig. 2 through launch/fig2.py, full size "
        f"{elapsed()}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clk = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    if clk.returncode == 0:
        mhz = float(clk.stdout.split()[0])
        log(f"  fp32 rate of this card outside the tensor cores: {sms} SMs "
            f"x 128 lanes x 2 FLOP x {mhz:.0f} MHz = "
            f"{sms * 128 * 2 * mhz * 1e6 / 1e12:.1f} TFLOP/s (the bounds "
            f"use the data sheet's 67)")
    reader = nvml.NvmlReader(0)
    try:
        probe_nvml(reader, fma_kernel.fma32_cuda)
    finally:
        reader.close()
    probe_host_sensors(pmt, fma_kernel.fma32_cuda)
    for name in ("gridder", "degridder"):
        counted = (timings[name]["ops_per_term"],
                   timings[name]["sfu_per_term"])
        if counted != fig2.PHASOR_OPS[name.upper()]:
            log(f"  note: {name}'s built loop does {counted[0]:g} FP32 FLOP "
                f"and {counted[1]:g} MUFU per term; launch/fig2.py bounds "
                f"its row with {fig2.PHASOR_OPS[name.upper()]}")
    fig2_kernels = {"fma32": fma_kernel, "stream_triad": st_kernel,
                    "gridder": grid_kernel, "degridder": grid_kernel,
                    "gemm": gemm_kernel, "jacobi2d": jac_kernel}
    launches.update(fig2_phase(fig2, nvml, fig2_kernels))

    # The two quantizing scatters are rows of their own, their numbers
    # int8's with fp8_e4m3's beside them; the four attention kernels carry
    # their quantized launches (phase 5c, both modes) and times beside
    # their bf16 ones.
    # The copying scatters' numbers are a pair call's too, k and v in one
    # launch (two_launches_graph_ms: a leaf a call).
    for name in ("cache_update", "paged_cache_update"):
        timings[name]["leaves"] = 2
    for name in ("quant_cache_update", "quant_paged_cache_update"):
        by_mode = quant_timings.pop(name)
        # a call writes a layer's k and v: ms, graph_ms, bound_ms and
        # launches are a pair call's (two_launches_graph_ms: a leaf a call)
        timings[name] = dict(by_mode["int8"], leaves=2,
                             fp8_e4m3=by_mode["fp8_e4m3"])
        launches[name] = quant_launches[name]
    # the serve baselines' path: row 9 on phase 5w's whole-prompt
    # prefills (by run), row 5 on phase 5w's int8 blocking run (its
    # prefills' and decode steps' writes), both beside their times
    # at the serve prefill's shapes (``serve_prefill``)
    timings["flash_attention"]["serve_launches"] = flash_serve
    timings["quant_cache_update"]["blocking_launches"] = blocking_int8
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err")
    rows = []
    for name, t in timings.items():
        source, replaces = KERNEL_INFO[name]
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches[name],
               **{k: t[k] for k in keys}}
        extras = ("leaves", "graph_ms", "library_graph_ms",
                  "backward_plain_ms", "copy_ms", "two_launches_graph_ms",
                  "chunk_ms", "chunk_graph_ms", "chunk_plain_ms",
                  "chunk_bound_ms", "chunk_library_graph_ms",
                  "chunk_two_launches_graph_ms", "empty_graph_ms",
                  "empty_grid_graph_ms", "grid",
                  "ops_per_term", "sfu_per_term", "bound_fp32_ms",
                  "bound_sfu_ms", "bound_bytes_ms", "serve_prefill",
                  "serve_launches", "blocking_launches")
        row.update({k: t[k] for k in extras if k in t})
        if "fp8_e4m3" in t:
            row["fp8_e4m3"] = {k: t["fp8_e4m3"][k] for k in keys + extras
                               if k in t["fp8_e4m3"]}
        if name in quant_timings:
            row["quant_launches"] = quant_launches[f"{name} quant"]
            row["quant"] = {m: {k: quant_timings[name][m][k]
                                for k in keys + extras
                                if k in quant_timings[name][m]}
                            for m in MODES}
        rows.append(row)
    # the one-leaf scatters' launches on phase 5m's MLA runs
    for row in rows:
        run = {"cache_update": "contiguous bf16",
               "paged_cache_update": "paged bf16",
               "quant_cache_update": "contiguous int8",
               "quant_paged_cache_update": "paged int8"}.get(row["name"])
        if run:
            row["mla_launches"] = mla_launches[run][row["name"]]
        # the paged rows' launches on phase 5p's swap run
        if row["name"] in preempt_launches:
            row["preempt_launches"] = preempt_launches[row["name"]]
        # rows 1-4, 7, 8: their launches on phase 5g's (b) and (d)
        if row["name"] in governor_launches:
            row["governor_launches"] = governor_launches[row["name"]]
    # rows 2v, 3v, 7v, 8v: launches on phase 5m's bf16 runs (quant_launches:
    # its int8 runs), times at the slice's shapes, bf16 with int8's and
    # fp8_e4m3's beside
    extra = ("graph_ms", "library_graph_ms", "bound_bytes_ms",
             "bound_ops_ms")
    for name, by_mode in latent_timings.items():
        source, replaces = KERNEL_INFO[name]
        layout = "paged" if "paged" in name else "contiguous"
        bf = by_mode["bf16"]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": mla_launches[f"{layout} bf16"][name],
            **{k: bf[k] for k in keys + extra if k in bf},
            "quant_launches": mla_launches[f"{layout} int8"][f"{name} quant"],
            "quant": {m: {k: by_mode[m][k] for k in keys + extra
                          if k in by_mode[m]} for m in MODES}})
    log(f"[7] results {elapsed()}")
    log(json.dumps({"serve_baselines": baselines, "chunked": chunked,
                    "mla": mla_figures}))
    log(card)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
