"""Time design variants of the DEGRIDDER, JACOBI2D, tensor-core
chunked-prefill, latent-attention and KV-scatter kernels on one card.

    python3 kernel_variants.py [NAME_PREFIX ...]

Each variant is a shipped source of ``src/repro_torch/kernels/csrc``
(``gridder.cu``, ``jacobi2d.cu``, ``prefill_attention.cu``,
``cache_update.cu``, ``latent_attention.cu``) with some of
its ``constexpr int`` constants set to other values, or with a passage
replaced by another design of the same function, so the sources carry no
knobs.  Every variant is built alone (``build.NVCC_FLAGS``, one ``nvcc``
each, all started together) into the git-ignored ``build/variants/``,
loaded with ``ctypes``, checked against the plain version once (the
degridder within rtol 1e-4, atol 2e-3; JACOBI2D exactly; prefill within
``chip_smoke.TOL[bf16]``) and timed with ``chip_smoke``'s ``time_ms`` at
the Fig. 2 sizes (the degridder at P 1024, S 1024, V 2048 with lm in
[-0.5, 0.5] and uv in [-2, 2]; JACOBI2D at 16384^2 f32, beside
``x.clone()``, which moves the same bytes), or its ``graph_ms`` (100
calls in a CUDA graph) for prefill at row 2's serve-path case
(``PREFILL_SERVE``), once with a bf16 cache (row 2) and once with the
prefix in int8 codes (row 2q); the quantizing scatters (rows 5, 6) by
``graph_ms`` of one call writing a layer's k and v (bf16 rows to int8
codes, checked bit for bit) at the serve shapes: decode (8 rows into
1024 slots), the contiguous chunk (batch 1, 32 rows at slot 512) and the paged decode
(``chip_smoke.QUANT_PAGED``'s decode case); the copying scatters (rows
1, 4) by ``graph_ms`` and by ``time_ms`` over 200 calls (host in the
loop) of one call writing a layer's bf16 k and v (3 kv heads of 64,
checked bit for bit) at decode (8 rows into 1024 slots), the paged
decode (every row valid: ``valids`` None) and the paged chunk (B 8, T
32, masked rows), beside an empty kernel (``csrc/empty.cu``) on one
block of 32 threads and on the pair's grids; the latent-attention
kernel (``latent_kernel``; rows 3v, 7v, 2v, 8v): the shipped source
(the splits folded across a cluster), with ``clock64()`` stamps by
stage and the global timer at the ends of each block's ``PHASES``
(``LATENT_STAMPS``; printed as cycles a tile summed over every block of
one launch, and microseconds a phase), and with the fold of the design
before it (``LATENT_TICKET_FOLD``: partials in device memory, the last
block of a group folding them alone) and with the cluster's fold out of
line (``LATENT_FOLD_OUT_OF_LINE``), by ``graph_ms`` at
``chip_smoke.LATENT_CASES``' decode, paged decode, chunk and paged
chunk over a bf16
cache and int8 codes, checked within ``chip_smoke.TOL[bf16]``.  ROUNDS
rounds, each call once a round, the
order rotated round by round.  With name prefixes, only the variants
whose names start with one of them.  Prints the card's name and power
limit, each variant's registers and spills (ptxas), then one JSON line a
call: median and quartiles of its ms.  Imports nothing of JAX; needs one
card.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import json
import math
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ROUNDS = 10
# The tensor-core prefill kernel with the key operand of S = q . k^T built
# from a cache tile's codes in registers (two codes of one key row, two
# bytes, per bf16 pair of the B fragment) in place of ldmatrix over the
# tile widened in shared memory; the block's pass then widens v alone.
K_FROM_CODES = (
    ("""          uint32_t kb[4];
          ldmatrix_x4(kb, kd + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * P + kk * 16 +
                              ((lane >> 3) & 1) * 8);""",
     """          uint32_t kb[4];
          if (kCodes && i < n_cache) {
            const uint8_t* kr = kcs + ((i % kStages) * kKT + np * 16 + (lane >> 2)) * CP +
                                kk * 16 + tq * 2;
            kb[0] = widen2<TC>(*reinterpret_cast<const uint16_t*>(kr));
            kb[1] = widen2<TC>(*reinterpret_cast<const uint16_t*>(kr + 8));
            kb[2] = widen2<TC>(*reinterpret_cast<const uint16_t*>(kr + 8 * CP));
            kb[3] = widen2<TC>(*reinterpret_cast<const uint16_t*>(kr + 8 * CP + 8));
          } else {
            ldmatrix_x4(kb, kd + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * P + kk * 16 +
                                ((lane >> 3) & 1) * 8);
          }"""),
    ("for (int u = tid; u < 2 * kKT * kUnits; u += nthreads)",
     "for (int u = kKT * kUnits + tid; u < 2 * kKT * kUnits; u += nthreads)"),
)
# The same with a code tile widened one iteration ahead: at iteration i
# the block waits for tiles i and i + 1, then widens tile i + 1 while it
# computes tile i, so no cache tile but the first costs a barrier more
# (one tile, not two, is in flight during a tile's compute).
WIDEN_AHEAD = ((
    """      if (i + 1 < ntiles)  // tile i + 1 may still be in flight
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      // tile i is in for every thread, and every warp is done with tile
      // i - 1, whose slot tile i + 2 now takes
      __syncthreads();
      if (i + 2 < ntiles) load_tile(i + 2, (i + 2) % kStages);
      if constexpr (kCodes) {
        if (i < n_cache) {  // a cache tile's codes: widen them, then read
          widen_tile(i % kStages);
          __syncthreads();
        }
      }""",
    """      if (kCodes || i + 1 >= ntiles)
        cp_async_wait<0>();
      else
        cp_async_wait<1>();
      __syncthreads();
      if (i + 2 < ntiles) load_tile(i + 2, (i + 2) % kStages);
      if constexpr (kCodes) {
        if (i == 0 && n_cache > 0) {
          widen_tile(0);
          __syncthreads();
        }
        if (i + 1 < n_cache) widen_tile((i + 1) % kStages);
      }"""),)
# The quantizing scatters with the general path (a warp a vector, each
# lane reading its values twice) for every launch: the design before the
# lane groups, in the pair launch.
WARP_A_VECTOR = (("  const bool vec = vec16_ok<TIN>(a);",
                  "  const bool vec = false;"),)
QUANT_ENTRIES = ("pmt_quant_cache_update", "pmt_quant_paged_cache_update")
# The copying scatters' block-a-row body and grid, as shipped, which the
# passages below replace; the layouts that give a block several rows
# also count the rows a leaf.
COPY_BODY = """  const int r = blockIdx.x, b = r / a.T;  // source row b * T + t
  const int u = threadIdx.x;
  const Unit* from = reinterpret_cast<const Unit*>(leaf.src) + (long long)r * a.units;
  const Unit x = u < a.units ? from[u] : Unit{};
  const long long dst = rows(b, r - b * a.T, a.T);
  if (dst < 0) return;
  Unit* to = reinterpret_cast<Unit*>(leaf.dst) + dst * a.units;
  if (u < a.units) to[u] = x;
  for (int i = u + blockDim.x; i < a.units; i += blockDim.x) to[i] = from[i];"""
COPY_GRID = """  const int threads = (int)std::min<long long>(kCopyThreads, (units + 31) / 32 * 32);
  const dim3 grid((unsigned)nrows, leaves);"""
ROWS_FIELD = (("  int T;\n", "  int T;\n  int rows;\n"),
              ("  a.units = (int)units;\n",
               "  a.units = (int)units;\n  a.rows = (int)nrows;\n"))
# A warp a row, kCopyThreads / 32 rows a block (the row is the warp's, but
# the compiler cannot know that a warp's threadIdx.x / 32 is one value).
WARP_A_ROW = ROWS_FIELD + (
    (COPY_BODY,
     """  const int r = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (r >= a.rows) return;
  const int lane = threadIdx.x % 32, b = r / a.T;
  const Unit* from = reinterpret_cast<const Unit*>(leaf.src) + (long long)r * a.units;
  const Unit x = lane < a.units ? from[lane] : Unit{};
  const long long dst = rows(b, r - b * a.T, a.T);
  if (dst < 0) return;
  Unit* to = reinterpret_cast<Unit*>(leaf.dst) + dst * a.units;
  if (lane < a.units) to[lane] = x;
  for (int i = lane + 32; i < a.units; i += 32) to[i] = from[i];"""),
    (COPY_GRID,
     """  const int per = (int)std::min<long long>(kCopyThreads / 32, nrows);
  const int threads = 32 * per;
  const dim3 grid((unsigned)((nrows + per - 1) / per), leaves);"""),
)
# Flat packing: the launch's work is rows x units and thread j copies
# unit j % units of row j / units (no idle lane; every thread divides by
# the units a row, and by T, before its lookup can issue).
FLAT = ROWS_FIELD + (
    (COPY_BODY,
     """  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= a.rows * a.units) return;
  const Unit x = reinterpret_cast<const Unit*>(leaf.src)[j];
  const int r = j / a.units;  // source row b * T + t
  const int b = r / a.T;
  const long long dst = rows(b, r - b * a.T, a.T);
  if (dst >= 0) reinterpret_cast<Unit*>(leaf.dst)[dst * a.units + (j - r * a.units)] = x;"""),
    (COPY_GRID,
     """  const long long items = nrows * units;
  const int threads = (int)std::min<long long>(kCopyThreads, (items + 31) / 32 * 32);
  const dim3 grid((unsigned)((items + threads - 1) / threads), leaves);"""),
)
# Two-dimensional blocks: x the unit of a row, y the row (kCopyThreads /
# units rows a block), so no thread divides by the units a row and no
# lane of a row idles but the block's last.
ROWS_OF_UNITS = ROWS_FIELD + (
    (COPY_BODY,
     """  const int r = blockIdx.x * blockDim.y + threadIdx.y, u = threadIdx.x;
  if (r >= a.rows) return;
  const Unit x = reinterpret_cast<const Unit*>(leaf.src)[(long long)r * a.units + u];
  const int b = r / a.T;
  const long long dst = rows(b, r - b * a.T, a.T);
  if (dst >= 0) reinterpret_cast<Unit*>(leaf.dst)[dst * a.units + u] = x;"""),
    (COPY_GRID,
     """  const int per = std::max(1, kCopyThreads / (int)units);
  const dim3 threads((unsigned)units, per);
  const dim3 grid((unsigned)((nrows + per - 1) / per), leaves);"""),
)
# The copying scatters launched with Hopper's programmatic dependent
# launch: a launch may start while the one before it on the stream runs
# its last blocks, and waits (griddepcontrol.wait) for that grid's
# completion and its memory before the first source load.
PDL = (
    ("  const CopyLeaf leaf = blockIdx.y ? a.v : a.k;",
     """  asm volatile("griddepcontrol.launch_dependents;");
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const CopyLeaf leaf = blockIdx.y ? a.v : a.k;"""),
    ("  kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(a, rows);",
     """  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, kernel, a, rows);"""),
)
COPY_ENTRIES = ("pmt_cache_update", "pmt_paged_cache_update")
# name -> (source, entry point(s), {constant: value}[, ((old, new), ...)]);
# {} and no passages is the shipped design
# The latent-attention kernel with the split fold of the design before
# it: each split stores its fp32 partial, row maxima and sums to device
# memory and takes a ticket, and the group's last block to take one folds
# every split's partial alone (8 chunks of 16 bytes a thread in flight),
# in place of the cluster's fold through distributed shared memory.  The
# partials and tickets are the variant's own device arrays (enough for
# 128 group-splits of 64 x 512, rows 3v, 7v and 2v), and no cluster is
# launched.
FOLD_SLOTS = 128
LATENT_TICKET_FOLD = (
    ("""// Rows of a TMA box of the paged pools""",
     f"""__device__ float pmt_fold_ws[{FOLD_SLOTS} * 64 * (512 + 2)];
__device__ int pmt_fold_tickets[{FOLD_SLOTS}];

// Rows of a TMA box of the paged pools"""),
    ("""  __shared__ float fold_ml[2][kRows];  // a split's row maxima and sums, for the fold""",
     """  __shared__ int is_last;"""),
    ("""  const int limit = limit_of(b);""",
     """  const int limit = limit_of(b);
  const int group = bh * gridDim.y + blockIdx.y;
  float* ws = pmt_fold_ws;
  int* tickets = pmt_fold_tickets;"""),
    ("""          if (wg == 0 && (lane & 3) == 0) {
            fold_ml[0][r] = m_run[j];
            fold_ml[1][r] = l_tot[j];
          }
        }
      }""", """          if (wg == 0 && (lane & 3) == 0 && r < rows) {
            ml[2 * r] = m_run[j];
            ml[2 * r + 1] = l_tot[j];
          }
        }
        named_sync(4, 128 * kConsumers);
        if (hdv % 4 == 0) {
          const int units = hdv / 4;
          for (int u = tid; u < rows * units; u += 128 * kConsumers) {
            const int r = u / units, c = u - r * units;
            *reinterpret_cast<float4*>(acc + (size_t)r * hdv + c * 4) =
                *reinterpret_cast<const float4*>(stage + r * DV + (c ^ (r & 7)) * 4);
          }
        } else {
          for (int e = tid; e < rows * hdv; e += 128 * kConsumers) {
            const int r = e / hdv, c = e - r * hdv;
            acc[(size_t)r * hdv + c] = stage[r * DV + ((c >> 2) ^ (r & 7)) * 4 + (c & 3)];
          }
        }
      }"""),
    ("""        float* stage = reinterpret_cast<float*>(sm);  // [kRows][DV], chunks of 4
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = r0 + 8 * j;
#pragma unroll
          for (int i = 0; i < NW / 8; ++i) {
            const int col = wg * NW + 8 * i + c0;""",
     """        float* acc = ws + ((size_t)group * nsplit + split) * kRows * hdv;
        float* ml = ws + (size_t)gridDim.y * gridDim.z * nsplit * kRows * hdv +
                    ((size_t)group * nsplit + split) * kRows * 2;
        float* stage = reinterpret_cast<float*>(sm);  // [kRows][DV], chunks of 4
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = r0 + 8 * j;
#pragma unroll
          for (int i = 0; i < NW / 8; ++i) {
            const int col = wg * NW + 8 * i + c0;"""),
    # the fold, from the kernel's fold to its end (FOLD_START .. FOLD_END)
    ("""  cluster[0].val.clusterDim.x = a.nsplit;""",
     """  cluster[0].val.clusterDim.x = 1;"""),
)
TICKET_FOLD_BODY = """  if (nsplit == 1) return;
  const size_t groups = (size_t)gridDim.y * gridDim.z;
  auto acc_of = [&](int s) { return ws + ((size_t)group * nsplit + s) * kRows * hdv; };
  auto ml_of = [&](int s) {
    return ws + groups * nsplit * kRows * hdv + ((size_t)group * nsplit + s) * kRows * 2;
  };
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(tickets + group, 1) == nsplit - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  unsigned live = 0;
  for (int s = 0; s < nsplit; ++s) {
    int l0, h0;
    share(s, l0, h0);
    if (h0 > l0 || (!decode && s == nsplit - 1)) live |= 1u << s;
  }
  float* wts = reinterpret_cast<float*>(sm);
  for (int r = tid; r < rows; r += blockDim.x) {
    float mv[kMaxSplits], lv[kMaxSplits];
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      const bool on = (live >> s) & 1u;
      mv[s] = on ? __ldcg(ml_of(s) + 2 * r) : PMT_NEG_INF;
      lv[s] = on ? __ldcg(ml_of(s) + 2 * r + 1) : 0.f;
    }
    float M = PMT_NEG_INF, Lsum = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) M = fmaxf(M, mv[s]);
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      mv[s] = (live >> s) & 1u ? ex2(mv[s] - M) : 0.f;
      Lsum += mv[s] * lv[s];
    }
    const float inv = 1.f / fmaxf(Lsum, 1e-30f);
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      if (s < nsplit) wts[s * kRows + r] = mv[s] * inv;
  }
  __syncthreads();
  constexpr int kBatch = 8;
  const int width = hdv % 4 == 0 ? 4 : 1;
  const int groups_row = hdv / width, total = rows * groups_row;
  const size_t out0 = (size_t)bh * rows_total + row0;
  for (int i0 = tid; i0 < total; i0 += kBatch * blockDim.x) {
    float4 sum[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) sum[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < nsplit; ++s) {
      if (!((live >> s) & 1u)) continue;
      float4 v[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int i = i0 + k * blockDim.x;
        if (i >= total) continue;
        const int r = i / groups_row, d = (i - r * groups_row) * width;
        const float* src = acc_of(s) + (size_t)r * hdv + d;
        v[k] = width == 4 ? __ldcg(reinterpret_cast<const float4*>(src))
                          : make_float4(__ldcg(src), 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int i = i0 + k * blockDim.x;
        if (i >= total) continue;
        const float w = wts[s * kRows + i / groups_row];
        sum[k].x = fmaf(w, v[k].x, sum[k].x);
        sum[k].y = fmaf(w, v[k].y, sum[k].y);
        sum[k].z = fmaf(w, v[k].z, sum[k].z);
        sum[k].w = fmaf(w, v[k].w, sum[k].w);
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = i0 + k * blockDim.x;
      if (i >= total) continue;
      const int r = i / groups_row, d = (i - r * groups_row) * width;
      bf16* dst = out + (out0 + r) * hdv + d;
      dst[0] = __float2bfloat16(sum[k].x);
      if (width == 4) {
        dst[1] = __float2bfloat16(sum[k].y);
        dst[2] = __float2bfloat16(sum[k].z);
        dst[3] = __float2bfloat16(sum[k].w);
      }
    }
  }
  if (tid == 0) tickets[group] = 0;
}
"""
FOLD_START = "  if (nsplit == 1) return;\n\n  // The fold, spread over the group's cluster"
FOLD_END = "  cluster_sync();  // no block leaves while another may still read its shared memory\n}\n"
LATENT_TICKET_FOLD += (((FOLD_START, FOLD_END), TICKET_FOLD_BODY),)
# The kernel with clock64() stamps, consumer thread 0 (warpgroup 0) by
# stage: 0 the wait for a full tile, 1 widening codes or zeroing rows
# (and its named barrier), 2 issuing S, 3 issuing the last tile's p . v
# and waiting for S, 4 the scores' scale, masks and row maxima, 5 the
# named barrier that shares the maxima, 6 p, its split and its stores, 7
# the named barrier that shares p, 8 waiting for the last tile's p . v
# and its release; 12 the wait for q; and producer thread 0: 10 its waits
# for an empty stage, 11 issuing loads (q's included) and widening codes.
# Slot 15 the block's tiles.  And the global timer (ns) on thread 0 at the
# ends of a block's PHASES: 13 its start, 16 q in, 17 the tiles done, 18
# the output stored or the partial kept, 19 the cluster met (every split's
# partial kept), 20 its share of the fold stored, 14 its end (21: 1, 2
# where it folds).  pmt_latent_stamps copies them out and zeroes them.
STAMP_BLOCKS, STAMP_SLOTS = 4096, 24
STAMP_BLK = "blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z)"
PHASES = (("q", 13, 16), ("tiles", 16, 17), ("output or partial", 17, 18),
          ("cluster wait", 18, 19), ("fold", 19, 20), ("leave", 20, 14))
GSTAMP = f"""  auto gstamp = [&](int k) {{
    if (threadIdx.x == 0 && {STAMP_BLK} < {STAMP_BLOCKS}) {{
      unsigned long long now;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      pmt_stamps[({STAMP_BLK}) * {STAMP_SLOTS} + k] = now;
    }}
  }};
"""
LATENT_STAMPS = (
    ("""// Rows of a TMA box of the paged pools""",
     f"""__device__ unsigned long long pmt_stamps[{STAMP_BLOCKS * STAMP_SLOTS}];

// Rows of a TMA box of the paged pools"""),
    ("""extern "C" int pmt_latent_smem_bytes(""",
     """extern "C" int pmt_latent_stamps(void* dst, int n) {
  cudaError_t err = cudaMemcpyFromSymbol(dst, pmt_stamps, n * sizeof(unsigned long long));
  void* dev = nullptr;
  if (err == cudaSuccess) err = cudaGetSymbolAddress(&dev, pmt_stamps);
  if (err == cudaSuccess) err = cudaMemset(dev, 0, sizeof(pmt_stamps));
  return static_cast<int>(err);
}

extern "C" int pmt_latent_smem_bytes("""),
    ("""    if (ntiles > 0) mbar_wait(q_full, 0);
    for (int t = 0; t < ntiles; ++t) {""", """    unsigned long long stamp_acc[13] = {};
    long long stamp_t = clock64();
    auto stamp = [&](int k) {
      const long long now = clock64();
      stamp_acc[k] += now - stamp_t;
      stamp_t = now;
    };
    if (ntiles > 0) mbar_wait(q_full, 0);
    stamp(12);
    if (ntiles > 0) gstamp(16);
    for (int t = 0; t < ntiles; ++t) {"""),
    ("""  const int split = blockIdx.x, h = blockIdx.z % KVH, b = b_of_z, bh = b * KVH + h;""",
     GSTAMP + """  gstamp(13);
  const int split = blockIdx.x, h = blockIdx.z % KVH, b = b_of_z, bh = b * KVH + h;"""),
    ("""      mbar_wait(full(t), phase(t));
      const int base""", """      mbar_wait(full(t), phase(t));
      stamp(0);
      const int base"""),
    ("""        named_sync(1, 128 * kConsumers);
      }
""", """        named_sync(1, 128 * kConsumers);
      }
      stamp(1);
"""),
    ("""      wgmma_commit();
      if (t > 0) {""", """      wgmma_commit();
      stamp(2);
      if (t > 0) {"""),
    ("""        wgmma_wait<0>();
      }
      fence_regs(s);
""", """        wgmma_wait<0>();
      }
      fence_regs(s);
      stamp(3);
"""),
    ("""      named_sync(2, 128 * kConsumers);
      uint8_t* pb""", """      stamp(4);
      named_sync(2, 128 * kConsumers);
      stamp(5);
      uint8_t* pb"""),
    ("""      fence_proxy_async();
      named_sync(3, 128 * kConsumers);
""", """      fence_proxy_async();
      stamp(6);
      named_sync(3, 128 * kConsumers);
      stamp(7);
"""),
    ("""      if (t > 0 && lane == 0) mbar_arrive(empty(t - 1));  // this warp is done with it
""", """      if (t > 0 && lane == 0) mbar_arrive(empty(t - 1));  // this warp is done with it
      stamp(8);
"""),
    ("""    if (ntiles > 0) {  // the last tile's p . v
""", f"""    if (tid == 0 && {STAMP_BLK} < {STAMP_BLOCKS}) {{
      const int blk = {STAMP_BLK};
      for (int k = 0; k < 9; ++k) pmt_stamps[blk * {STAMP_SLOTS} + k] = stamp_acc[k];
      pmt_stamps[blk * {STAMP_SLOTS} + 12] = stamp_acc[12];
      pmt_stamps[blk * {STAMP_SLOTS} + 15] = ntiles;
    }}
    if (ntiles > 0) {{  // the last tile's p . v
"""),
    ("""    if (ntiles > 0 || nsplit == 1) {
      float l_tot[2];""", """    if (ntiles > 0) gstamp(17);
    if (ntiles > 0 || nsplit == 1) {
      float l_tot[2];"""),
    ("""      for (int t = 0; t < ntiles; ++t) {
        mbar_wait(empty(t), phase(t) ^ 1);
""", """      unsigned long long pst[2] = {};
      long long pt = clock64();
      auto pstamp = [&](int k) {
        const long long now = clock64();
        pst[k] += now - pt;
        pt = now;
      };
      for (int t = 0; t < ntiles; ++t) {
        pstamp(1);
        mbar_wait(empty(t), phase(t) ^ 1);
        pstamp(0);
"""),
    ("""          mbar_arrive(bar);
        }
      }
    }
  } else {""", f"""          mbar_arrive(bar);
        }}
      }}
      pstamp(1);
      if (ptid == 0 && {STAMP_BLK} < {STAMP_BLOCKS}) {{
        pmt_stamps[({STAMP_BLK}) * {STAMP_SLOTS} + 10] = pst[0];
        pmt_stamps[({STAMP_BLK}) * {STAMP_SLOTS} + 11] = pst[1];
      }}
    }}
  }} else {{"""),
    ("""  if (nsplit == 1) return;

  // The fold, spread over the group's cluster""", """  gstamp(18);
  if (nsplit == 1) {
    gstamp(14);
    return;
  }

  // The fold, spread over the group's cluster"""),
    ("""  cluster_sync();
  unsigned live = 0;""", f"""  cluster_sync();
  gstamp(19);
  if (tid == 0 && {STAMP_BLK} < {STAMP_BLOCKS}) pmt_stamps[({STAMP_BLK}) * {STAMP_SLOTS} + 21] = 2;
  unsigned live = 0;"""),
    ("""  cluster_sync();  // no block leaves while another may still read its shared memory
}""", """  gstamp(20);
  cluster_sync();  // no block leaves while another may still read its shared memory
  gstamp(14);
}"""),
)
# The cluster's fold out of line, a call in place of inlined code (the
# kernel's registers allotted without the fold's).
LATENT_FOLD_OUT_OF_LINE = (("__device__ __forceinline__ void fold_splits(",
                            "__device__ __noinline__ void fold_splits("),)
LATENT_ENTRY = "pmt_latent_attention"

VARIANTS = {
    "degridder": ("gridder.cu", "pmt_degridder", {}),
    "degridder 64 threads": ("gridder.cu", "pmt_degridder",
                             {"DTHREADS": 64}),
    "degridder 128 threads": ("gridder.cu", "pmt_degridder",
                              {"DTHREADS": 128}),
    "degridder 512 threads": ("gridder.cu", "pmt_degridder",
                              {"DTHREADS": 512}),
    "degridder VPT 4": ("gridder.cu", "pmt_degridder", {"VPT": 4}),
    "degridder 128 threads VPT 4": ("gridder.cu", "pmt_degridder",
                                    {"DTHREADS": 128, "VPT": 4}),
    "jacobi2d": ("jacobi2d.cu", "pmt_jacobi2d", {}),
    "jacobi2d ROWS 2": ("jacobi2d.cu", "pmt_jacobi2d", {"ROWS": 2}),
    "jacobi2d ROWS 8": ("jacobi2d.cu", "pmt_jacobi2d", {"ROWS": 8}),
    "jacobi2d ROWS 16": ("jacobi2d.cu", "pmt_jacobi2d", {"ROWS": 16}),
    "jacobi2d ROWS 32": ("jacobi2d.cu", "pmt_jacobi2d", {"ROWS": 32}),
    "jacobi2d 64 threads": ("jacobi2d.cu", "pmt_jacobi2d",
                            {"THREADS": 64}),
    "jacobi2d 256 threads": ("jacobi2d.cu", "pmt_jacobi2d",
                             {"THREADS": 256}),
    "prefill": ("prefill_attention.cu", "pmt_prefill_attention_tc", {}),
    "prefill k from codes": ("prefill_attention.cu",
                             "pmt_prefill_attention_tc", {}, K_FROM_CODES),
    "prefill widen ahead": ("prefill_attention.cu",
                            "pmt_prefill_attention_tc", {}, WIDEN_AHEAD),
    "prefill kStages 4": ("prefill_attention.cu", "pmt_prefill_attention_tc",
                          {"kStages": 4}),
    "prefill kKT 64": ("prefill_attention.cu", "pmt_prefill_attention_tc",
                       {"kKT": 64}),
    "quant scatter": ("cache_update.cu", QUANT_ENTRIES, {}),
    "quant scatter warp a vector": ("cache_update.cu", QUANT_ENTRIES, {},
                                    WARP_A_VECTOR),
    "quant scatter 64 threads": ("cache_update.cu", QUANT_ENTRIES,
                                 {"kQuantThreads": 64}),
    "quant scatter 256 threads": ("cache_update.cu", QUANT_ENTRIES,
                                  {"kQuantThreads": 256}),
    "quant scatter 512 threads": ("cache_update.cu", QUANT_ENTRIES,
                                  {"kQuantThreads": 512}),
    "quant scatter 1024 threads": ("cache_update.cu", QUANT_ENTRIES,
                                   {"kQuantThreads": 1024}),
    "scatter": ("cache_update.cu", COPY_ENTRIES, {}),
    "scatter a warp a row": ("cache_update.cu", COPY_ENTRIES, {},
                             WARP_A_ROW),
    "scatter a warp a row 256 threads": ("cache_update.cu", COPY_ENTRIES,
                                         {"kCopyThreads": 256}, WARP_A_ROW),
    "scatter flat": ("cache_update.cu", COPY_ENTRIES, {}, FLAT),
    "scatter flat 64 threads": ("cache_update.cu", COPY_ENTRIES,
                                {"kCopyThreads": 64}, FLAT),
    "scatter flat 256 threads": ("cache_update.cu", COPY_ENTRIES,
                                 {"kCopyThreads": 256}, FLAT),
    "scatter flat 512 threads": ("cache_update.cu", COPY_ENTRIES,
                                 {"kCopyThreads": 512}, FLAT),
    "scatter rows of units": ("cache_update.cu", COPY_ENTRIES, {},
                              ROWS_OF_UNITS),
    "scatter PDL": ("cache_update.cu", COPY_ENTRIES, {}, PDL),
    "latent": ("latent_attention.cu", LATENT_ENTRY, {}),
    "latent stamped": ("latent_attention.cu", LATENT_ENTRY, {},
                       LATENT_STAMPS),
    "latent ticket fold": ("latent_attention.cu", LATENT_ENTRY, {},
                           LATENT_TICKET_FOLD),
    "latent fold out of line": ("latent_attention.cu", LATENT_ENTRY, {},
                                LATENT_FOLD_OUT_OF_LINE),
}


def variant_source(text: str, values: dict, passages=()) -> str:
    for name, value in values.items():
        text, n = re.subn(rf"(constexpr int {name} = )\d+;",
                          rf"\g<1>{value};", text)
        if n != 1:
            raise AssertionError(f"no single constant {name} to set")
    for old, new in passages:
        if isinstance(old, tuple):  # the region from old[0] to old[1]
            start, end = old
            if text.count(start) != 1 or end not in text.split(start)[1]:
                raise AssertionError(f"no region {start[:40]!r} to replace")
            head, tail = text.split(start)
            text = head + new + tail.split(end, 1)[1]
            continue
        if text.count(old) != 1:
            raise AssertionError(f"no single passage {old[:40]!r} to replace")
        text = text.replace(old, new)
    return text


def build_all(build, names, ptxas_usage) -> dict:
    """{variant: ctypes library} of ``names``, each built from its own
    source; prints each variant's registers and spills (of the prefill
    variants, each tensor-core instantiation's, by ``ptxas_usage``)."""
    procs = {}
    for i, name in enumerate(names):
        source, entry, values, *passages = VARIANTS[name]
        out = ROOT / "build" / "variants" / str(i)
        out.mkdir(parents=True, exist_ok=True)
        src = out / source
        src.write_text(variant_source((build.CSRC / source).read_text(),
                                      values, *passages))
        procs[name] = (out / "lib.so", subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
             "-shared", str(src), "-o", str(out / "lib.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        log, _ = proc.communicate(timeout=900)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        if name.startswith("prefill"):
            ptxas = [f"{re.search(r'kernelI(.*?)EEv', n).group(1)} {regs} "
                     f"registers {stores}/{loads} B spilled"
                     for n, regs, _, stores, loads in ptxas_usage(
                         log, "prefill_tc_kernel")]
        else:
            ptxas = [line.strip() for line in log.splitlines()
                     if "registers" in line or "spill" in line]
        print(f"{name}: ptxas " + " | ".join(ptxas), flush=True)
        lib = ctypes.CDLL(str(path))
        entries = VARIANTS[name][1]
        for entry in (entries,) if isinstance(entries, str) else entries:
            getattr(lib, entry).argtypes = build.SIGNATURES[entry]
        libs[name] = lib
    return libs


def prefill_calls(smoke, pa_kernel, pa_ref, dev, stream, libs) -> tuple:
    """{call name: call} of each prefill variant over row 2's serve-path
    case, with a bf16 cache and with the prefix in int8 codes, and
    {call name: (got, want)} to check once after a first call."""
    import torch
    cs = smoke.PREFILL_SERVE
    b, t, c, kvh, g, hd = (cs[x] for x in ("b", "t", "c", "kvh", "g", "hd"))
    q, kx, vx, kc, vc = smoke._prefill_inputs(dev, torch.bfloat16, b, t, c,
                                              kvh, g, hd)
    offs = torch.tensor(cs["offs"], dtype=torch.int32, device=dev)
    scale = 1.0 / math.sqrt(hd)
    (kq, ks), (vq, vs) = smoke.quantized("int8", kc, vc)
    # as kernel.py _tc_launch
    nwarps = pa_kernel.tc_warps(t * g)
    groups = b * kvh * math.ceil(t * g / (16 * nwarps))
    nsplit = pa_kernel.split_count(groups, c)
    tickets = torch.zeros(groups, dtype=torch.int32, device=dev)
    ws = torch.empty(groups * nsplit * 16 * nwarps * (hd + 2),
                     dtype=torch.float32, device=dev)
    calls, checks = {}, {}
    for name, lib in libs.items():
        if not name.startswith("prefill"):
            continue
        for cache, (k, v, kp, vp, code) in {
                "bf16": (kc, vc, None, None, 1),
                "int8": (kq, vq, ks.data_ptr(), vs.data_ptr(), 2)}.items():
            out = torch.empty((b, kvh, t, g, hd), dtype=q.dtype, device=dev)
            call = (lambda lib=lib, k=k, v=v, kp=kp, vp=vp, code=code,
                    out=out: lib.pmt_prefill_attention_tc(
                        q.data_ptr(), kx.data_ptr(), vx.data_ptr(),
                        k.data_ptr(), v.data_ptr(), kp, vp, offs.data_ptr(),
                        out.data_ptr(), ws.data_ptr(), tickets.data_ptr(),
                        b, t, c, kvh, g, hd, hd, scale, 0, 0, 0.0, code,
                        nsplit, nwarps, stream()))
            calls[f"{name}, {cache}"] = call
            kw = dict(scale=scale)
            if code == 2:
                kw.update(k_scale=ks, v_scale=vs)
            checks[f"{name}, {cache}"] = (out, pa_ref.prefill_attention_ref(
                q, kx, vx, k, v, offs, **kw))
    return calls, checks


# Rows 3v, 7v, 2v and 8v's cases (chip_smoke.LATENT_CASES), over a bf16
# cache and over int8 codes.
LATENT_TIMED = ("decode", "decode_paged", "prefill", "prefill_paged")
LATENT_CACHES = ("bf16", "int8")
STAGES = (
    "full wait", "widen or zero", "S issue", "PV issue and S wait",
    "scores and maxima", "maxima barrier", "p and its stores", "p barrier",
    "PV wait and release", "-", "producer empty waits", "producer issue",
    "q wait")


def latent_calls(smoke, refs, quant, dev, stream, libs) -> tuple:
    """{call name: call} of each latent-attention variant at rows 3v, 7v,
    2v and 8v's cases (bf16 q over a bf16 cache or int8 codes), and {call
    name: (got, want)} to check once after a first call."""
    import torch
    calls, checks = {}, {}
    if not any(name.startswith("latent") for name in libs):
        return calls, checks
    g, hd, hdv = (smoke.LATENT[k] for k in ("g", "hd", "hdv"))
    scale = 1.0 / math.sqrt(192)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for kind in LATENT_TIMED:
        cs = smoke.LATENT_CASES[kind]
        q, kx, cache0, table, pos = smoke._latent_inputs(
            dev, torch.bfloat16, kind, cs, g, hd)
        decode = kind.startswith("decode")
        t = 1 if decode else cs["t"]
        b = cs["b"]
        c = cs["nb"] * cs["ps"] if table is not None else cs["c"]
        qq = q.view(b, 1, t, g, hd)
        for mode in LATENT_CACHES:
            cache, ks = (cache0, None) if mode == "bf16" \
                else quant.quantize(cache0, mode)
            want = refs[kind](*smoke._latent_args(kind, q, kx, cache, table,
                                                  pos),
                              scale=scale, v_width=hdv, k_scale=ks)
            for name, lib in libs.items():
                if not name.startswith("latent"):
                    continue
                out = torch.empty((b, 1, t, g, hdv), dtype=torch.bfloat16,
                                  device=dev)
                call = functools.partial(
                    lib.pmt_latent_attention, qq.data_ptr(),
                    None if kx is None else kx.data_ptr(), cache.data_ptr(),
                    None if ks is None else ks.data_ptr(), pos.data_ptr(),
                    None if table is None else table.data_ptr(),
                    out.data_ptr(), b, t, c,
                    1 if table is None else table.shape[1],
                    c if table is None else cache.shape[1], cache.shape[0],
                    1, g, hd, hdv, scale, int(decode),
                    int(table is not None), 1 if ks is None else 2, sms)
                key = f"{name}, {kind} {mode}"
                # the tensors behind the pointers live as long as the call
                calls[key] = lambda call=call, keep=(out, qq, kx, cache, ks,
                                                     table, pos): \
                    call(stream())
                checks[key] = (out, want.view(b, 1, t, g, hdv))
    return calls, checks


def latent_stamps(lib, call) -> dict:
    """One launch of the stamped variant: {stage: clock cycles a tile}
    summed over the blocks that had tiles, the blocks and tiles, each
    phase's mean and longest span over the blocks (us, the global timer),
    and the launch's timeline."""
    import torch
    n = STAMP_BLOCKS * STAMP_SLOTS
    buf = (ctypes.c_ulonglong * n)()
    lib.pmt_latent_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    if lib.pmt_latent_stamps(buf, n):  # zeroes what earlier launches left
        raise RuntimeError("pmt_latent_stamps failed")
    if call():
        raise RuntimeError("the stamped launch failed")
    torch.cuda.synchronize()
    if lib.pmt_latent_stamps(buf, n):
        raise RuntimeError("pmt_latent_stamps failed")
    started = [buf[i * STAMP_SLOTS:(i + 1) * STAMP_SLOTS]
               for i in range(STAMP_BLOCKS) if buf[i * STAMP_SLOTS + 13]]
    worked = [blk for blk in started if blk[15]]
    tiles = sum(blk[15] for blk in worked)
    out = {"blocks": len(started), "with_tiles": len(worked), "tiles": tiles,
           "cycles_a_tile": {stage: sum(blk[k] for blk in worked) / tiles
                             for k, stage in enumerate(STAGES)},
           "phases_us": {}}
    for name, a, b in PHASES:
        spans = [(blk[b] - blk[a]) / 1e3 for blk in started
                 if blk[a] and blk[b]]
        out["phases_us"][name] = {
            "blocks": len(spans), "mean": statistics.mean(spans),
            "max": max(spans)} if spans else None
    t0 = min(blk[13] for blk in started)
    starts = sorted(blk[13] - t0 for blk in started)
    out["timeline_us"] = {
        "span": (max(blk[14] for blk in started) - t0) / 1e3,
        "block_mean": statistics.mean(blk[14] - blk[13]
                                      for blk in started) / 1e3,
        "block_max": max(blk[14] - blk[13] for blk in started) / 1e3,
        "start_quartiles": [starts[len(starts) * k // 4] / 1e3
                            for k in range(4)] + [starts[-1] / 1e3]}
    return out


def quant_calls(smoke, cu_ref, quant, dev, stream, libs) -> tuple:
    """{call name: call} of each quantizing-scatter variant writing a
    layer's k and v (bf16 rows, int8 codes, in one launch) at the decode,
    contiguous-chunk and paged-decode serve shapes, and {call name:
    (got, want)} to check once after a first call: lists of code and
    scale tensors, bit for bit."""
    import torch
    g = torch.Generator(device=dev).manual_seed(21)

    def leaves(lead, b, t):
        out = []
        for _ in range(2):
            codes, scales = quant.quantize(torch.randn(
                (*lead, 3, 64), generator=g, device=dev), "int8")
            out.append((codes, scales, torch.randn(
                (b, t, 3, 64), generator=g, device=dev).to(torch.bfloat16)))
        return out

    cs = smoke.QUANT_PAGED["decode P513 ps16 B8 NB64 T1"]
    where = (smoke._page_table(dev, cs["b"], cs["nb"], cs["p"], 23,
                               cs["masked"]),
             torch.tensor(cs["starts"], dtype=torch.int32, device=dev),
             torch.tensor(cs["valids"], dtype=torch.int32, device=dev))
    slots = torch.randint(0, 1024, (8,), generator=g, device=dev,
                          dtype=torch.int32)
    shapes = {
        "decode": (leaves((8, 1024), 8, 1), (slots,)),
        "chunk": (leaves((1, 1024), 1, 32),
                  (torch.tensor([512], dtype=torch.int32, device=dev),)),
        "paged decode": (leaves((cs["p"], cs["ps"]), cs["b"], 1), where)}
    calls, checks = {}, {}
    for name, lib in libs.items():
        if not name.startswith("quant"):
            continue
        for shape, (ls, w) in shapes.items():
            paged = shape.startswith("paged")
            ref = cu_ref.quant_paged_cache_update_pair_ref if paged \
                else cu_ref.quant_cache_update_pair_ref
            args = [x.clone() for leaf in ls for x in leaf]
            want = [x for pair in ref(*[x.clone() for x in args], *w,
                                       "int8") for x in pair]
            b, t = ls[0][2].shape[:2]
            # the call holds ``args`` and ``w``: the kernel reads and
            # writes through their pointers
            if paged:
                call = (lambda lib=lib, args=args, w=w, b=b, t=t:
                        lib.pmt_quant_paged_cache_update(
                            *(x.data_ptr() for x in args), 2,
                            *(x.data_ptr() for x in w), b, t, cs["nb"],
                            cs["ps"], 3, 64, 1, 2, stream()))
            else:
                call = (lambda lib=lib, args=args, w=w, b=b, t=t:
                        lib.pmt_quant_cache_update(
                            *(x.data_ptr() for x in args), 2,
                            w[0].data_ptr(), b, t, 1024, 3, 64, 1, 2,
                            stream()))
            calls[f"{name}, {shape}"] = call
            got = [args[0], args[1], args[3], args[4]]
            if paged:               # the scratch page 0 is undefined
                got, want = [x[1:] for x in got], [x[1:] for x in want]
            checks[f"{name}, {shape}"] = (got, want)
    return calls, checks


def copy_calls(smoke, cu_ref, dev, stream, libs) -> tuple:
    """{call name: call} of each copying-scatter variant writing a layer's
    k and v (bf16, 3 kv heads of 64: F 192) in one launch at the serve
    shapes: decode (8 rows into 1024 slots), the paged decode (valids
    None, the serve path's call) and the paged chunk (``chip_smoke``'s
    cases: B 8, T 32, masked rows), and {call name: (got, want)} to check
    once after a first call, bit for bit (paged: outside page 0)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(31)
    f, nb, ps = 192, 64, 16

    def leaves(lead, b, t):
        return [x for _ in range(2) for x in (
            torch.randn((*lead, f), generator=g, device=dev).to(
                torch.bfloat16),
            torch.randn((b, t, f), generator=g, device=dev).to(
                torch.bfloat16))]

    table = smoke._page_table(dev, 8, nb, 513, 13, (7,))
    starts = torch.tensor([0, 1, 15, 16, 511, 1023, 700, 1500],
                          dtype=torch.int32, device=dev)
    chunk_table = smoke._page_table(dev, 8, nb, 513, 13)
    chunk_starts = torch.tensor([0, 16, 512, 992, 5, 100, 0, 17],
                                dtype=torch.int32, device=dev)
    chunk_valids = torch.tensor([32, 32, 17, 32, 0, 1, 0, 31],
                                dtype=torch.int32, device=dev)
    slots = torch.randint(0, 1024, (8,), generator=g, device=dev,
                          dtype=torch.int32)
    # shape -> (leaves' tensors, routing, T, paged)
    shapes = {
        "decode": (leaves((8, 1024), 8, 1), (slots,), 1, False),
        "paged decode": (leaves((513, ps), 8, 1), (table, starts, None), 1,
                         True),
        "paged chunk": (leaves((513, ps), 8, 32),
                        (chunk_table, chunk_starts, chunk_valids), 32,
                        True)}
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    calls, checks = {}, {}
    if any(name.startswith("scatter") for name in libs):
        # the floor of a launch: an empty kernel on one block of 32
        # threads, and on the shipped pair's grids at decode (8 rows x 2
        # leaves) and at the paged chunk (256 x 2), blocks of 32
        from repro_torch.kernels import build
        for grid, threads in (((1, 1), 32), ((8, 2), 32), ((256, 2), 32)):
            calls[f"empty kernel {grid} x {threads}"] = (
                lambda grid=grid, threads=threads: build.library().pmt_empty(
                    *grid, threads, stream()))
    for name, lib in libs.items():
        if not name.startswith("scatter"):
            continue
        for shape, (ls, w, t, paged) in shapes.items():
            args = [x.clone() for x in ls]
            ref = cu_ref.paged_cache_update_pair_ref if paged \
                else cu_ref.cache_update_pair_ref
            want = list(ref(*[x.clone() for x in args], *w))
            # the call holds ``args`` and ``w``: the kernel reads and
            # writes through their pointers
            if paged:
                call = (lambda lib=lib, args=args, w=w, t=t:
                        lib.pmt_paged_cache_update(
                            *(x.data_ptr() for x in args), 2,
                            *(ptr(x) for x in w), 8, t, nb, ps, 2 * f,
                            stream()))
            else:
                call = (lambda lib=lib, args=args, w=w:
                        lib.pmt_cache_update(
                            *(x.data_ptr() for x in args), 2,
                            w[0].data_ptr(), 8, 1024, 2 * f, stream()))
            calls[f"{name}, {shape}"] = call
            got = [args[0], args[2]]
            if paged:               # the scratch page 0 is undefined
                got, want = [x[1:] for x in got], [x[1:] for x in want]
            checks[f"{name}, {shape}"] = (got, want)
    return calls, checks


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("prefixes", nargs="*",
                    help="time only the variants whose names start so")
    prefixes = tuple(ap.parse_args().prefixes)
    names = [n for n in VARIANTS if not prefixes or n.startswith(prefixes)]
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke as smoke
    from repro_torch.kernels import build, quant
    from repro_torch.kernels.cache_update import ref as cu_ref
    from repro_torch.kernels.gridder import ref as grid_ref
    from repro_torch.kernels.jacobi2d import ref as jac_ref
    from repro_torch.kernels.prefill_attention import kernel as pa_kernel
    from repro_torch.kernels.prefill_attention import ref as pa_ref

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    libs = build_all(build, names, smoke.ptxas_usage)
    dev = torch.device("cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    calls, timers = {}, {}
    if any(n.startswith("degridder") for n in libs):
        g = torch.Generator(device=dev).manual_seed(11)
        p, s, v = 1024, 1024, 2048
        lm = torch.rand((p, 2), generator=g, device=dev) - 0.5
        uv = 4.0 * torch.rand((s, v, 2), generator=g, device=dev) - 2.0
        sub = torch.randn((s, p, 2), generator=g, device=dev)
        vis = torch.empty((s, v, 2), device=dev)
        want_vis = grid_ref.degridder_ref(lm, uv, sub)
    if any(n.startswith("jacobi2d") for n in libs):
        x = smoke._randn(dev, 16384, 16384, seed=10)
        y = torch.empty_like(x)
        want_y = jac_ref.jacobi2d_ref(x)
        calls["x.clone()"] = lambda: x.clone()
    for name, lib in libs.items():
        if name.startswith("degridder"):
            calls[name] = lambda lib=lib: lib.pmt_degridder(
                lm.data_ptr(), uv.data_ptr(), sub.data_ptr(),
                vis.data_ptr(), s, p, v, stream())
        elif name.startswith("jacobi2d"):
            calls[name] = lambda lib=lib: lib.pmt_jacobi2d(
                x.data_ptr(), y.data_ptr(), 16384, 16384, stream())
    for name in list(calls):
        if name == "x.clone()":
            continue
        if calls[name]():
            raise RuntimeError(f"{name}: the launch failed")
        torch.cuda.synchronize()
        if name.startswith("degridder"):
            excess = float(((vis - want_vis).abs()
                            - 1e-4 * want_vis.abs()).max())
            if not excess <= 2e-3:
                raise AssertionError(f"{name} disagrees: {excess}")
        elif not torch.equal(y, want_y):
            raise AssertionError(f"{name} disagrees with the plain version")
    timers.update({name: smoke.time_ms for name in calls})
    pcalls, checks = prefill_calls(smoke, pa_kernel, pa_ref, dev, stream,
                                   libs)
    for name, (got, want) in checks.items():
        if pcalls[name]():
            raise RuntimeError(f"{name}: the launch failed")
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        print(f"{name}: max |err| {err:.3g}", flush=True)
        if not err <= smoke.TOL[torch.bfloat16]:
            raise AssertionError(f"{name} disagrees with the plain version")
    calls.update(pcalls)
    timers.update({name: smoke.graph_ms for name in pcalls})
    from repro_torch.kernels.decode_attention import ref as da_ref
    lcalls, checks = latent_calls(smoke, {
        "decode": da_ref.decode_attention_ref,
        "decode_paged": da_ref.decode_attention_paged_ref,
        "prefill": pa_ref.prefill_attention_ref,
        "prefill_paged": pa_ref.prefill_attention_paged_ref}, quant, dev,
        stream, libs)
    for name, (got, want) in checks.items():
        if lcalls[name]():
            raise RuntimeError(f"{name}: the launch failed")
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        print(f"{name}: max |err| {err:.3g}", flush=True)
        if not err <= smoke.TOL[torch.bfloat16]:
            raise AssertionError(f"{name} disagrees with the plain version")
        if name.startswith("latent stamped,"):
            print(json.dumps({"stamps": name, **latent_stamps(
                libs["latent stamped"], lcalls[name])}), flush=True)
    if checks:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,"
                              "clocks.max.sm", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        print(f"SM clock, max SM clock: {smi.stdout.strip()}", flush=True)
    calls.update(lcalls)
    timers.update({name: smoke.graph_ms for name in lcalls})
    qcalls, checks = quant_calls(smoke, cu_ref, quant, dev, stream, libs)
    for name, (got, want) in checks.items():
        if qcalls[name]():
            raise RuntimeError(f"{name}: the launch failed")
        torch.cuda.synchronize()
        differ = [int((smoke.u8(a) != smoke.u8(b)).sum())
                  for a, b in zip(got, want)]
        if any(differ):
            raise AssertionError(f"{name} disagrees with the plain version: "
                                 f"k codes, k scales, v codes, v scales "
                                 f"differ in {differ} elements")
        print(f"{name}: codes and scales equal bit for bit", flush=True)
    calls.update(qcalls)
    timers.update({name: smoke.graph_ms for name in qcalls})
    ccalls, checks = copy_calls(smoke, cu_ref, dev, stream, libs)
    for name, (got, want) in checks.items():
        if ccalls[name]():
            raise RuntimeError(f"{name}: the launch failed")
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{name} disagrees with the plain version")
        print(f"{name}: k and v equal bit for bit", flush=True)
    # in a CUDA graph and by CUDA events (host in the loop) both
    for name, call in ccalls.items():
        calls[f"{name}, graph"] = calls[f"{name}, event loop"] = call
        timers[f"{name}, graph"] = smoke.graph_ms
        timers[f"{name}, event loop"] = functools.partial(smoke.time_ms,
                                                          iters=200)
    times = {name: [] for name in calls}
    order = list(calls)
    for r in range(ROUNDS):
        for name in order[r % len(order):] + order[:r % len(order)]:
            times[name].append(timers[name](calls[name]))
    for name, ts in times.items():
        print(json.dumps({"variant": name, "median_ms": statistics.median(
            ts), "quartiles_ms": statistics.quantiles(ts, n=4)[::2]}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
