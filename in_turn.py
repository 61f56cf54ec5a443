"""Time two checkouts of this repo in turns on one card.

    python3 in_turn.py OTHER_CHECKOUT [--latent-only]

Speeds measured on two machines cannot be compared (cards run under
other power limits and hosts), so this runs, on one card, OTHER, this
checkout, this checkout, OTHER, ROUNDS times over: 2 x ROUNDS pairs
of OTHER and this checkout, each side first in half of them.  Each run
is a fresh process that imports that checkout's ``repro_torch`` and
builds its kernels, then measures with this checkout's
``chip_smoke.py`` (its functions take the modules they drive):

  * phase 3b's GEMM at 8192^3 in float32 and ``torch.matmul`` (TF32
    off) on the same inputs, ``time_ms`` over 10 calls after 2;
  * phase 3b's STREAM triad at 16384^2 in float32 (s = 2) and
    ``torch.add(a, b, alpha=2)`` on the same inputs, ``time_ms`` in the
    order kernel, add, add, kernel (and their ratio);
  * phase 3b's GRIDDER and DEGRIDDER at P 1024, S 1024, V 2048 with
    phase 6's ranges (lm in [-0.5, 0.5], uv in [-2, 2]), ``time_ms``;
  * phase 3b's JACOBI2D at 16384^2 in float32 and ``x.clone()`` (the
    same 8 bytes a cell moved, not the same function: a ceiling),
    ``time_ms`` in the order kernel, clone, clone, kernel;
  * phase 3's row 2 on the serve path (``PREFILL_SERVE``: B 1, a
    32-token chunk over a 512-token prefix, 3 kv heads of 64, 3 query
    heads each, bf16): the chunked-prefill kernel by ``time_ms`` (host
    in the loop) and by ``graph_ms`` (100 calls in one CUDA graph: device
    time), and its SDPA yardstick by ``graph_ms``; row 2q, the same over
    the prefix in int8 codes, and rows 8 and 8q, the paged kernel on
    ``PAGED_PREFILL_SERVE`` (8 slots, 2 prefilling a 32-token chunk over
    256 and 480 cached positions, pages of 16) over bf16 and int8 pools,
    by ``graph_ms``;
  * phase 3's rows 3 and 7 on the serve path (``DECODE_SERVE``: 8 decode
    rows over a 1024-slot cache, 3 kv heads of 64, 3 query heads each,
    bf16; ``PAGED_DECODE_SERVE``: the same over 64 pages of 16 a row,
    one row dead): the flash-decode kernel, contiguous and paged, in bf16
    and over int8 codes (rows 3q, 7q), by ``graph_ms``, and row 3's SDPA
    yardstick by ``graph_ms``;
  * rows 5 and 6, a layer's quantized write (k and v, int8 codes of
    bf16 rows, 3 kv heads of 64) at the serve shapes, by ``graph_ms``:
    decode (8 rows into 1024 slots; paged, ``QUANT_PAGED``'s decode case)
    and a prefill chunk (batch 1, 32 rows at slot 512; paged, its chunk
    case).  A checkout whose ``cache_update`` kernel module has the pair
    wrappers makes one pair call; one without makes the calls its serve
    path made: the two one-leaf launches, and for the contiguous chunk
    ``quant.quantize`` and four ``chunk_kv_write`` slice copies;
  * rows 1 and 4, a layer's bf16 write (k and v, 3 kv heads of 64) at
    the serve shapes, by ``graph_ms``: decode (8 rows into 1024 slots;
    paged, ``QUANT_PAGED``'s decode case, every row valid) and a paged
    prefill chunk (its chunk case).  A checkout whose ``cache_update``
    kernel module has ``cache_update_pair_cuda`` makes one pair call
    (paged decode with ``valids`` None); one without makes the two
    one-leaf launches its serve path made (paged decode with a vector of
    ones);
  * the kernel launches one bf16 decode step issues (phase 5's
    ``decode_step_launches``), contiguous and paged (page 16);
  * phase 5's serve cell (full-width smollm-135m, 8 slots, max_len 1024,
    chunk 32, bf16; ``serve_workload``'s 16 requests, 64 new tokens
    each) served once after its warm-up: wall seconds and tokens/s; then
    phase 5c's int8 contiguous cell (the same with ``cache_dtype="int8"``,
    no session) likewise;
  * phase 3f's main case: the flash-attention kernel at the train
    shape (B 8, S 2048, 9 query heads on 3 kv heads, hd 64, bf16,
    causal), ``time_ms`` over 10 calls after 3;
  * phase 5t's cell (``train_cell``): one warm-up step, then its
    TRAIN_STEPS measured steps (``measured_steps``: wall clock and the
    card's NVML joules);
  * one more step traced (``trace_train``): device busy time and the
    flash kernel's share of it;
  * phase 3v's main cases (``LATENT_CASES`` at deepseek-v3's widths: G
    128, hdq 576, hdv 512) through the checkout's wrappers, over a bf16
    cache and int8 codes, by ``graph_ms``: rows 2v (the chunk, B1 T32
    over 512), 8v (the paged chunk, B8 T32, prefixes 0-992), 3v and 7v
    (decode, contiguous and paged).

With ``--latent-only`` a run measures phase 3v's cases alone.

Prints one JSON line per run, then by checkout the median and quartiles
of each number, and how many pairs this checkout won on each time.  Imports nothing of JAX; needs one card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ROUNDS = 5          # 10 pairs, as a claim of a gain needs

CHILD = r"""
import json, math, sys, time
other, root = sys.argv[1], sys.argv[2]
sys.path[:0] = [other + "/src", root]
import numpy as np
import torch
import chip_smoke as smoke
import repro_torch.core as pmt
from repro_torch import configs
from repro_torch.core.backends import nvml
from repro_torch.data import pipeline as data
from repro_torch.kernels import build, quant
from repro_torch.kernels.cache_update import kernel as cu_kernel
from repro_torch.kernels.decode_attention import kernel as da_kernel
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.gemm import kernel as gemm_kernel
from repro_torch.kernels.gridder import kernel as grid_kernel
from repro_torch.kernels.jacobi2d import kernel as jac_kernel
from repro_torch.kernels.prefill_attention import kernel as pa_kernel
from repro_torch.kernels.stream import kernel as st_kernel
from repro_torch.models import attention
from repro_torch.models import model as model_mod
from repro_torch.optim import optimizers as optim
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train import steps as train

dev = torch.device("cuda")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
build.library()
"""
CHILD_BODY = r"""
a = smoke._randn(dev, 8192, 8192, seed=8)
b = smoke._randn(dev, 8192, 8192, seed=9)
gemm_ms = smoke.time_ms(lambda: gemm_kernel.gemm_cuda(a, b), iters=10,
                        warmup=2)
matmul_ms = smoke.time_ms(lambda: torch.matmul(a, b), iters=10, warmup=2)
del a, b

a = smoke._randn(dev, 16384, 16384, seed=6)
b = smoke._randn(dev, 16384, 16384, seed=7)
# kernel, add, add, kernel: each the mean of its two
triad = lambda: st_kernel.stream_triad_cuda(a, b, 2.0)
add = lambda: torch.add(a, b, alpha=2.0)
t = [smoke.time_ms(f) for f in (triad, add, add, triad)]
stream_ms, add_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
del a, b

g = torch.Generator(device=dev).manual_seed(11)
lm = torch.rand((1024, 2), generator=g, device=dev) - 0.5
uv = 4.0 * torch.rand((1024, 2048, 2), generator=g, device=dev) - 2.0
vis = torch.randn((1024, 2048, 2), generator=g, device=dev)
sub = torch.randn((1024, 1024, 2), generator=g, device=dev)
gridder_ms = smoke.time_ms(lambda: grid_kernel.gridder_cuda(lm, uv, vis))
degridder_ms = smoke.time_ms(lambda: grid_kernel.degridder_cuda(lm, uv, sub))
del lm, uv, vis, sub

x = smoke._randn(dev, 16384, 16384, seed=10)
jacobi = lambda: jac_kernel.jacobi2d_cuda(x)
t = [smoke.time_ms(f) for f in (jacobi, x.clone, x.clone, jacobi)]
jacobi2d_ms, copy_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
del x

cs = smoke.PREFILL_SERVE
args = smoke._prefill_inputs(dev, torch.bfloat16, *(cs[x] for x in (
    "b", "t", "c", "kvh", "g", "hd")))
offs = torch.tensor(cs["offs"], dtype=torch.int32, device=dev)
scale = 1.0 / math.sqrt(cs["hd"])
prefill = lambda: pa_kernel.prefill_attention_cuda(*args, offs, scale=scale)
prefill_ms = smoke.time_ms(prefill)
prefill_graph_ms = smoke.graph_ms(prefill)
sdpa_graph_ms = smoke.graph_ms(smoke.prefill_sdpa(*args, cs["offs"][0],
                                                  scale))
(kq, ks), (vq, vs) = smoke.quantized("int8", args[3], args[4])
quant_prefill_graph_ms = smoke.graph_ms(
    lambda: pa_kernel.prefill_attention_cuda(
        *args[:3], kq, vq, offs, scale=scale, k_scale=ks, v_scale=vs))
q, kx, vx, kp, vp, table, offs = smoke._paged_prefill_inputs(
    dev, torch.bfloat16, smoke.PAGED_PREFILL_SERVE)
paged_prefill_graph_ms = smoke.graph_ms(
    lambda: pa_kernel.prefill_attention_paged_cuda(q, kx, vx, kp, vp, table,
                                                   offs, scale=scale))
(kq, ks), (vq, vs) = smoke.quantized("int8", kp, vp)
quant_paged_prefill_graph_ms = smoke.graph_ms(
    lambda: pa_kernel.prefill_attention_paged_cuda(
        q, kx, vx, kq, vq, table, offs, scale=scale, k_scale=ks, v_scale=vs))
del args, q, kx, vx, kp, vp, kq, vq

cs = smoke.DECODE_SERVE
q, k, v = smoke._decode_inputs(dev, torch.bfloat16, *(cs[x] for x in (
    "b", "c", "kvh", "g", "hd")))
lens = torch.tensor(cs["lens"], dtype=torch.int32, device=dev)
scale = 1.0 / math.sqrt(cs["hd"])
decode_graph_ms = smoke.graph_ms(lambda: da_kernel.decode_attention_cuda(
    q, k, v, lens, scale=scale))
decode_sdpa_graph_ms = smoke.graph_ms(smoke.decode_sdpa(q, k, v, lens,
                                                        scale))
(kq, ks), (vq, vs) = smoke.quantized("int8", k, v)
quant_decode_graph_ms = smoke.graph_ms(lambda: da_kernel.decode_attention_cuda(
    q, kq, vq, lens, scale=scale, k_scale=ks, v_scale=vs))
q, k, v, table, lens = smoke._paged_decode_inputs(dev, torch.bfloat16,
                                                  smoke.PAGED_DECODE_SERVE)
paged_decode_graph_ms = smoke.graph_ms(
    lambda: da_kernel.decode_attention_paged_cuda(q, k, v, table, lens,
                                                  scale=scale))
(kq, ks), (vq, vs) = smoke.quantized("int8", k, v)
quant_paged_decode_graph_ms = smoke.graph_ms(
    lambda: da_kernel.decode_attention_paged_cuda(
        q, kq, vq, table, lens, scale=scale, k_scale=ks, v_scale=vs))
del q, k, v, kq, vq

g = torch.Generator(device=dev).manual_seed(21)
leaf = lambda *lead: quant.quantize(torch.randn(
    (*lead, 3, 64), generator=g, device=dev), "int8")
rows = lambda b, t: torch.randn((b, t, 3, 64), generator=g,
                                device=dev).to(torch.bfloat16)
pair = hasattr(cu_kernel, "quant_cache_update_pair_cuda")
(k, ks), (v, vs) = leaf(8, 1024), leaf(8, 1024)
kn, vn = rows(8, 1), rows(8, 1)
slots = torch.randint(0, 1024, (8,), generator=g, device=dev,
                      dtype=torch.int32)
if pair:
    write = lambda: cu_kernel.quant_cache_update_pair_cuda(
        k, ks, kn, v, vs, vn, slots, "int8")
else:
    write = lambda: [cu_kernel.quant_cache_update_cuda(
        c, s, n, slots, "int8") for c, s, n in ((k, ks, kn), (v, vs, vn))]
quant_write_graph_ms = smoke.graph_ms(write)
(k, ks), (v, vs) = leaf(1, 1024), leaf(1, 1024)
kn, vn = rows(1, 32), rows(1, 32)
offs = torch.tensor([512], dtype=torch.int32, device=dev)


def chunk_write():
    if pair:
        return cu_kernel.quant_cache_update_pair_cuda(k, ks, kn, v, vs, vn,
                                                      offs, "int8")
    for c, s, n in ((k, ks, kn), (v, vs, vn)):
        codes, scales = quant.quantize(n, "int8")
        attention.chunk_kv_write(c, codes, 512, 32)
        attention.chunk_kv_write(s, scales, 512, 32)


quant_chunk_write_graph_ms = smoke.graph_ms(chunk_write)
paged_ms = {}
for case in ("decode P513 ps16 B8 NB64 T1", "prefill P513 ps16 B8 NB64 T32"):
    cs = smoke.QUANT_PAGED[case]
    (k, ks), (v, vs) = leaf(cs["p"], cs["ps"]), leaf(cs["p"], cs["ps"])
    kn, vn = rows(cs["b"], cs["t"]), rows(cs["b"], cs["t"])
    where = (smoke._page_table(dev, cs["b"], cs["nb"], cs["p"], 23,
                               cs["masked"]),
             torch.tensor(cs["starts"], dtype=torch.int32, device=dev),
             torch.tensor(cs["valids"], dtype=torch.int32, device=dev))
    if pair:
        write = lambda: cu_kernel.quant_paged_cache_update_pair_cuda(
            k, ks, kn, v, vs, vn, *where, "int8")
    else:
        write = lambda: [cu_kernel.quant_paged_cache_update_cuda(
            c, s, n, *where, "int8") for c, s, n in ((k, ks, kn),
                                                     (v, vs, vn))]
    paged_ms[case[:6]] = smoke.graph_ms(write)
del k, v, ks, vs, kn, vn

# rows 1 and 4: a layer's bf16 write, k and v (3 kv heads of 64)
bf16 = lambda *shape: torch.randn(shape, generator=g, device=dev).to(
    torch.bfloat16)
pair = hasattr(cu_kernel, "cache_update_pair_cuda")
k, v, kn, vn = bf16(8, 1024, 192), bf16(8, 1024, 192), bf16(8, 1, 192), \
    bf16(8, 1, 192)
if pair:
    write = lambda: cu_kernel.cache_update_pair_cuda(k, kn, v, vn, slots)
else:
    write = lambda: (cu_kernel.cache_update_cuda(k, kn, slots),
                     cu_kernel.cache_update_cuda(v, vn, slots))
bf16_write_graph_ms = smoke.graph_ms(write)
for case in ("decode P513 ps16 B8 NB64 T1", "prefill P513 ps16 B8 NB64 T32"):
    cs = smoke.QUANT_PAGED[case]
    k, v = bf16(cs["p"], cs["ps"], 192), bf16(cs["p"], cs["ps"], 192)
    kn, vn = bf16(cs["b"], cs["t"], 192), bf16(cs["b"], cs["t"], 192)
    table = smoke._page_table(dev, cs["b"], cs["nb"], cs["p"], 23,
                              cs["masked"])
    starts = torch.tensor(cs["starts"], dtype=torch.int32, device=dev)
    valids = torch.tensor(cs["valids"], dtype=torch.int32, device=dev)
    # the serve path's calls: a decode step's rows are all valid (the
    # pair takes None; the one-leaf calls a vector of ones built a layer)
    if pair:
        write = lambda: cu_kernel.paged_cache_update_pair_cuda(
            k, kn, v, vn, table, starts, valids if cs["t"] > 1 else None)
    else:
        write = lambda: [cu_kernel.paged_cache_update_cuda(
            c, n, table, starts, valids if cs["t"] > 1
            else torch.ones_like(starts)) for c, n in ((k, kn), (v, vn))]
    paged_ms["bf16 " + case[:6]] = smoke.graph_ms(write)
del k, v, kn, vn

scfg = configs.get_config("smollm-135m")
sparams = model_mod.init_params(scfg, seed=0, device="cuda")
warm, prompts = smoke.serve_workload(scfg, Request, np.random.default_rng(0))
served = {}
for cache_dtype in (torch.bfloat16, "int8"):
    eng = ServeEngine(scfg, sparams, batch_size=8, max_len=1024,
                      prefill_chunk=32, cache_dtype=cache_dtype)
    eng.generate(warm)
    torch.cuda.synchronize()
    if cache_dtype == torch.bfloat16:
        decode_launches = smoke.decode_step_launches(
            eng, np.random.default_rng(3))
        paged = ServeEngine(scfg, sparams, batch_size=8, max_len=1024,
                            prefill_chunk=32, cache_dtype=cache_dtype,
                            kv_layout="paged", kv_page_size=16)
        paged_decode_launches = smoke.decode_step_launches(
            paged, np.random.default_rng(3))
        del paged
    t0 = time.perf_counter()
    done = eng.generate([Request(prompt=p, max_new_tokens=64)
                         for p in prompts])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    served[str(cache_dtype)] = (wall, sum(len(r.out) for r in done) / wall)
    del eng, done
del sparams
serve_s, serve_tokens_per_s = served["torch.bfloat16"]
int8_serve_s, int8_serve_tokens_per_s = served["int8"]

b, sq, skv, h, kvh, hd, _, _ = smoke.FLASH_CASES["main B8 S2048 H9 KVH3 hd64"]
q, k, v = smoke._flash_inputs(dev, torch.bfloat16, b, sq, skv, h, kvh, hd)
kernel_ms = smoke.time_ms(lambda: fa_kernel.flash_attention_cuda(
    q, k, v, causal=True, scale=1.0 / math.sqrt(hd)), iters=10)
del q, k, v

cfg, ocfg, batches, state = smoke.train_cell(configs, train, optim, data,
                                             dev)
step_fn = train.make_train_step(cfg, ocfg)
state, _ = step_fn(state, batches[0])
torch.cuda.synchronize()
state, run = smoke.measured_steps(train, pmt, nvml, fa_kernel, step_fn,
                                  state, batches)
assert all(math.isfinite(x) for x in run["losses"]), run["losses"]
traced, busy, flash = smoke.trace_train(step_fn, state, batches[-1])
n, wall = smoke.TRAIN_STEPS, run["wall"]
res = {
    "gemm_ms": gemm_ms, "matmul_ms": matmul_ms,
    "stream_ms": stream_ms, "add_ms": add_ms,
    "stream_over_add": stream_ms / add_ms, "gridder_ms": gridder_ms,
    "degridder_ms": degridder_ms, "jacobi2d_ms": jacobi2d_ms,
    "copy_ms": copy_ms,
    "prefill_ms": prefill_ms, "prefill_graph_ms": prefill_graph_ms,
    "sdpa_graph_ms": sdpa_graph_ms,
    "quant_prefill_graph_ms": quant_prefill_graph_ms,
    "paged_prefill_graph_ms": paged_prefill_graph_ms,
    "quant_paged_prefill_graph_ms": quant_paged_prefill_graph_ms,
    "decode_graph_ms": decode_graph_ms,
    "decode_sdpa_graph_ms": decode_sdpa_graph_ms,
    "paged_decode_graph_ms": paged_decode_graph_ms,
    "quant_decode_graph_ms": quant_decode_graph_ms,
    "quant_paged_decode_graph_ms": quant_paged_decode_graph_ms,
    "quant_write_graph_ms": quant_write_graph_ms,
    "quant_chunk_write_graph_ms": quant_chunk_write_graph_ms,
    "quant_paged_write_graph_ms": paged_ms["decode"],
    "quant_paged_chunk_write_graph_ms": paged_ms["prefil"],
    "bf16_write_graph_ms": bf16_write_graph_ms,
    "bf16_paged_write_graph_ms": paged_ms["bf16 decode"],
    "bf16_paged_chunk_write_graph_ms": paged_ms["bf16 prefil"],
    "decode_launches": decode_launches,
    "paged_decode_launches": paged_decode_launches,
    "serve_s": serve_s, "serve_tokens_per_s": serve_tokens_per_s,
    "int8_serve_s": int8_serve_s,
    "int8_serve_tokens_per_s": int8_serve_tokens_per_s,
    "kernel_ms": kernel_ms,
    "step_ms": wall / n * 1e3,
    "tokens_per_s": n * smoke.TRAIN_BATCH * smoke.TRAIN_SEQ / wall,
    "j_per_step": run["joules"] / n, "watts": run["joules"] / wall,
    "flash_per_step": run["per_step"][0], "traced_wall_ms": traced,
    "busy_ms": busy, "flash_ms": flash, "flash_share": flash / busy,
    "last_loss": run["losses"][-1]}
"""
# phase 3v's main cases (deepseek-v3's widths: G 128, hdq 576, hdv 512)
# over a bf16 cache and int8 codes, through the checkout's wrappers
CHILD_LATENT = r"""
for row, kind, fn in (
        ("2v", "prefill", pa_kernel.prefill_attention_cuda),
        ("8v", "prefill_paged", pa_kernel.prefill_attention_paged_cuda),
        ("3v", "decode", da_kernel.decode_attention_cuda),
        ("7v", "decode_paged", da_kernel.decode_attention_paged_cuda)):
    q, kx, cache, table, pos = smoke._latent_inputs(
        dev, torch.bfloat16, kind, smoke.LATENT_CASES[kind],
        smoke.LATENT["g"], smoke.LATENT["hd"])
    for mode in ("bf16", "int8"):
        kw = dict(scale=1.0 / math.sqrt(192), v_width=smoke.LATENT["hdv"])
        c = cache
        if mode != "bf16":
            c, kw["k_scale"] = quant.quantize(cache, mode)
        args = smoke._latent_args(kind, q, kx, c, table, pos)
        res[f"latent_{row}_{mode}_graph_ms"] = smoke.graph_ms(
            lambda: fn(*args, **kw))
    del q, kx, cache, table, pos, c
print(json.dumps({"checkout": other, **res}))
"""
LATENT_KEYS = tuple(f"latent_{row}_{mode}_graph_ms" for row in
                    ("2v", "8v", "3v", "7v") for mode in ("bf16", "int8"))
KEYS = ("gemm_ms", "matmul_ms", "stream_ms", "add_ms", "stream_over_add",
        "gridder_ms", "degridder_ms", "jacobi2d_ms", "copy_ms",
        "prefill_ms", "prefill_graph_ms", "sdpa_graph_ms",
        "quant_prefill_graph_ms", "paged_prefill_graph_ms",
        "quant_paged_prefill_graph_ms", "decode_graph_ms",
        "decode_sdpa_graph_ms", "paged_decode_graph_ms",
        "quant_decode_graph_ms", "quant_paged_decode_graph_ms",
        "quant_write_graph_ms", "quant_chunk_write_graph_ms",
        "quant_paged_write_graph_ms", "quant_paged_chunk_write_graph_ms",
        "bf16_write_graph_ms", "bf16_paged_write_graph_ms",
        "bf16_paged_chunk_write_graph_ms", "decode_launches",
        "paged_decode_launches", "serve_s", "serve_tokens_per_s",
        "int8_serve_s",
        "int8_serve_tokens_per_s", "kernel_ms", "step_ms", "tokens_per_s",
        "j_per_step", "watts", "busy_ms", "flash_share") + LATENT_KEYS
WON = ("gemm_ms", "stream_ms", "gridder_ms", "degridder_ms", "jacobi2d_ms",
       "prefill_ms", "prefill_graph_ms", "quant_prefill_graph_ms",
       "paged_prefill_graph_ms", "quant_paged_prefill_graph_ms",
       "decode_graph_ms",
       "paged_decode_graph_ms", "quant_decode_graph_ms",
       "quant_paged_decode_graph_ms", "quant_write_graph_ms",
       "quant_chunk_write_graph_ms", "quant_paged_write_graph_ms",
       "quant_paged_chunk_write_graph_ms", "bf16_write_graph_ms",
       "bf16_paged_write_graph_ms", "bf16_paged_chunk_write_graph_ms",
       "serve_s", "int8_serve_s",
       "kernel_ms", "step_ms") + LATENT_KEYS


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path, help="the other checkout's root")
    ap.add_argument("--latent-only", action="store_true",
                    help="time phase 3v's main cases alone")
    args = ap.parse_args()
    other = args.other.resolve()
    child = CHILD + ("res = {}\n" if args.latent_only else CHILD_BODY) \
        + CHILD_LATENT
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    order = [other, ROOT, ROOT, other]
    runs = []
    for _ in range(ROUNDS):
        for checkout in order:
            out = subprocess.run(
                [sys.executable, "-c", child, str(checkout), str(ROOT)],
                capture_output=True, text=True, timeout=900)
            if out.returncode:
                print(out.stdout[-4000:] + out.stderr[-4000:],
                      file=sys.stderr)
                return 1
            runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
            print(json.dumps(runs[-1]), flush=True)
    keys = [key for key in KEYS if key in runs[0]]
    for checkout in order[:2]:
        mine = [r for r in runs if r["checkout"] == str(checkout)]
        print(json.dumps({"checkout": str(checkout), "runs": len(mine), **{
            key: {"median": statistics.median(r[key] for r in mine),
                  "quartiles": statistics.quantiles(
                      [r[key] for r in mine], n=4)[::2]}
            for key in keys}}), flush=True)
    # runs 4i, 4i+1 and 4i+2, 4i+3 are the pairs: (other, this), (this, other)
    pairs = [(runs[i], runs[i + 1]) if runs[i]["checkout"] == str(other)
             else (runs[i + 1], runs[i]) for i in range(0, len(runs), 2)]
    print(json.dumps({"pairs": len(pairs), "this_faster": {
        key: sum(mine[key] < theirs[key] for theirs, mine in pairs)
        for key in WON if key in runs[0]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
