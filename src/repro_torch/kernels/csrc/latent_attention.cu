// Attention over an aliased latent cache (MLA): the key row is
// [latent | rope], `hd` wide, and the value is its first `hdv` lanes,
// one kv head shared by G query heads (G 128, hd 576, hdv 512 for
// deepseek-v3 at full width).  One kernel, latent_kernel, for the decode
// step (one query token a row, the new token already in the cache) and
// for the prefill chunk (T query tokens over the cache prefix and their
// own causal keys), over a contiguous (B, C, KVH, hd) cache or (P, ps,
// KVH, hd) page pools read through a (B, NB) page table, in bf16 or over
// int8 / fp8_e4m3 codes with one float32 scale a row.
//
// Replaces the v_width branch of the TPU kernels decode_attention_pallas
// and decode_attention_paged_pallas
// (src/repro/kernels/decode_attention/decode_attention.py) and of
// prefill_attention_pallas and prefill_attention_paged_pallas
// (src/repro/kernels/prefill_attention/prefill_attention.py), quantized
// branches included: their V BlockSpec read the first v_width lanes of
// the array that was also K, so the latent row came in twice.  Same
// function as the port's CUDA-core kernels (decode_attention.cu,
// prefill_attention.cu) with v the first hdv lanes of k: scores in fp32,
// one online softmax, the output in bf16.  Those kernels take the other
// inputs of the branch (fp32 q, a window, a ring, a softcap).
//
// What bounds it on the H100: operations, or at the paged chunk the
// bytes of q and the output.  Every query head of a row shares the one
// latent row, so a decode step at B8 C1024 reads 9.4 MB of cache (2.8 us
// at 3.35 TB/s) for 2.28 GFLOP of products (2.3 us on the bf16 tensor
// cores, 34 us on the fp32 CUDA cores).  What it spends is latency: a
// 64-row tile's chain of products and softmax, a few tiles a block.
//
// The design (PERF.md §6 has the stamps behind it; the mma.sync loop it
// replaced spent ~6000 cycles a 32-key tile issuing copies, ldmatrix and
// mma.sync):
//  * Tensor cores over packed heads: the T * G query rows of a (row, kv
//    head) are wgmma's M, 64 a block (at G 128 one query token and 64 of
//    its heads, so one causal mask for the block; per row at small G).
//    The aliased tile is staged once: a tile of 32 key rows, hd wide,
//    feeds the score's product and, through its first hdv columns, the
//    value's.  hd and hdv are padded with zeros to the kernel's widths DK
//    and DV (128/128 or 576/512); value columns past hdv are neither
//    computed nor stored.
//  * A producer warpgroup: its first warp loads q once and the key tiles
//    into a ring of three full / empty mbarrier pairs with TMA: 4-D tensor
//    maps of the chunk's keys and of the cache (boxes of 32 rows) or of
//    the pools (one box set a page segment of gcd(ps, 16) rows, the page
//    from the table), 64 bf16 columns a box, 128-byte swizzled, zeros past
//    the tensor's edges.  Codes come in unswizzled, as codes.  Where a row
//    is no whole number of 16-byte units, a base is off its 16-byte
//    alignment or a page box would be under 8 rows, the loading warp
//    copies element by element into the same layout (loads_by_tma; the
//    choice depends on shapes and pointers only).
//  * Codes: a code tile lands as codes and the producer warpgroup's four
//    warps widen it exactly into the bf16 tile (every int8 code and finite
//    e4m3 value is a bf16), zeroing its rows past its keys, from one code
//    tile into which the next tile's codes land while the consumers work.
//    The row scale multiplies the fp32 score and p (before p's bf16 hi +
//    lo split), never a bf16 operand: q . (code_c s_c) = (q . code_c) s_c
//    and sum_c p_c (code_c s_c) = sum_c (p_c s_c) code_c.  One scale a row
//    serves as k and v scale, as the alias's one scale tensor does.  The
//    chunk's own keys are bf16, scale 1.
//  * Two consumer warpgroups.  Warpgroup w forms S for the tile's keys
//    [16 w, 16 w + 16) over the whole depth (wgmma m64n16k16, q and k
//    K-major in shared memory); the two meet at a named barrier to take
//    one row maximum, store p_hi and p_lo for their keys into a swizzled
//    64 x 64 bf16 tile (two buffers) and meet again; then each forms O +=
//    p . v for its half of the value columns over all the tile's keys
//    (wgmma m64n256k16 at hdv 512, 64 x 256 fp32 in 128 registers, p from
//    shared memory, v the tile's rows MN-major through the transpose bit).
//    Tile t's S goes to the tensor cores ahead of tile t - 1's p . v, so
//    the softmax runs beside that p . v.  No block barrier and no mma.sync
//    stand in the tile loop.  p through the tensor cores as bf16 p_hi +
//    p_lo (~16 bits); l sums the fp32 p.
//  * Registers decide the rest.  Three warpgroups make ptxas allot 168 a
//    thread, and O takes 128: S split by depth or into two chains, or
//    setmaxnreg, spilled or lost (PERF.md §6), and codes cost the
//    consumers no registers because the producers widen them.
//  * Split-KV, folded across a cluster.  The grid is (splits, row blocks,
//    B * KVH), and the splits of a (row, kv head, row block) are one
//    thread-block cluster.  Each split takes a share of the cache range
//    (rounded to 16 keys), the chunk's last split also the chunk's keys.
//    A decode row attends [0, min(lens, C - 1)] (lens -1: no key, and an
//    output of exactly 0), so at decode a split may have no key; it then
//    only takes part in the fold.  Each split keeps its fp32 partial, row
//    maxima and sums in its own shared memory; after a cluster barrier,
//    block s folds the s-th share of the group's rows (fold_splits),
//    reading the live splits' partials through distributed shared memory
//    in split order, and a second cluster barrier keeps every block's
//    shared memory alive until the others have read it.  No partial goes
//    to device memory and no block folds the whole group: the last block
//    to take a ticket did, reading 1 MB from L2 at decode, and took ~2.8x
//    the whole decode step this way (PERF.md §6).
//  * The output is staged in q and the ring and stored in whole 16-byte
//    chunks.
//  * Blocks of the batch rows with the longest key ranges start first.
#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"
#include "tile.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace pmt::sm90;
using namespace pmt::tile;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBK = 32;        // keys of a tile
constexpr int kRows = 64;      // packed query rows of a block: wgmma's M
constexpr int kConsumers = 2;  // warpgroups, each half the value columns
constexpr int kThreads = 128 * kConsumers + 128;  // and a producer warpgroup
constexpr int kMaxSplits = 8;  // a portable cluster's blocks
static_assert(kBK == 32, "a producer lane loads one key row's scale");

// Row blocks of a launch over T query tokens of G heads, and its splits
// for `groups` = B * KVH * row blocks over a cache of capacity C on `sms`
// SMs: one block an SM (its shared memory), so as many splits as fill the
// SMs once over, no more than one per 128 keys of the capacity (64 at
// decode, whose splits take no chunk), at most kMaxSplits
// (kernels/latent_attention.py prefill_groups, prefill_split_count,
// decode_split_count).
__host__ inline int row_blocks(int T, int G) { return (T * G + kRows - 1) / kRows; }

__host__ inline int split_count(int groups, int C, int sms, int decode) {
  const int keys = decode ? 64 : 128;
  return std::max(1, std::min(std::min(sms / groups, (C + keys - 1) / keys), kMaxSplits));
}

// Shared memory of a block, each tile on a 1024-byte boundary (the
// 128-byte swizzle's period): q (64 rows) | the key ring (kStages tiles of
// kBK rows) | p, two buffers (64 rows of p_hi's 32 keys, then p_lo's: 128
// bytes) | one code tile and each stage's row scales (codes only) | the
// warpgroups' row maxima (at the end, row sums) | the barriers (q, full
// and empty a stage, codes landed).  A bf16 tile is DK / 64 boxes of 64
// columns (128 bytes a row, swizzled as TMA writes them and wgmma reads
// them); a code tile DK / kCodeBox boxes of kCodeBox bytes a row,
// unswizzled.  After the last tile, q and the ring stage the output for
// coalesced stores, or hold the split's fp32 partial for the cluster's
// fold, and p's buffers the fold's weights.
template <int DK, bool kCodes>
struct Layout {
  static constexpr int kStages = 3;
  static constexpr int kQBytes = kRows * DK * 2;
  static constexpr int kTileBytes = kBK * DK * 2;
  static constexpr int kPBytes = 2 * kRows * 128;  // two buffers
  static constexpr int kCodeBox = DK == 576 ? 192 : DK;
  static constexpr int kCodeBytes = kCodes ? kBK * DK : 0;
  static constexpr int kScaleBytes = kCodes ? kBK * 4 : 0;
  static constexpr int kXBytes = kConsumers * kRows * 4;
  static constexpr int kSmem = 1024 + kQBytes + kStages * kTileBytes + kPBytes +
                               kCodeBytes + kStages * kScaleBytes + kXBytes +
                               8 * (2 + 2 * kStages);
  static_assert(kRows * DK * 4 <= kQBytes + kStages * kTileBytes,
                "q and the ring hold a split's 64 x DV fp32 partial (DV <= DK)");
  static_assert(kMaxSplits * kRows * 4 <= kPBytes, "p's buffers hold the fold's weights");
};

// Rows of a TMA box of the paged pools: a tile's keys start on 16-key
// boundaries (split_range), so boxes of gcd(ps, 16) rows never cross a
// page.  The contiguous cache takes whole tiles.
__host__ __device__ inline int pool_box_rows(int ps) {
  int r = 16;
  while (ps % r) r >>= 1;
  return r;
}

// Whether a launch loads q, the chunk's keys and the cache tiles by TMA:
// every row a whole number of 16-byte units at 16-byte-aligned bases,
// and page boxes of at least 8 rows (whole 1024-byte swizzle atoms).
// Otherwise the producer warp copies them element by element.
__host__ inline bool loads_by_tma(const void* q, const void* kx, const void* kc, int hd,
                                  int code_bytes, int paged, int ps) {
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(kx) |
                          reinterpret_cast<uintptr_t>(kc);
  return (bases & 15) == 0 && (2 * hd) % 16 == 0 && (code_bytes * hd) % 16 == 0 &&
         (!paged || pool_box_rows(ps) >= 8);
}

// A float of shared memory at a 32-bit shared address.
__device__ __forceinline__ float lds_f32(uint32_t addr) {
  float x;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(x) : "r"(addr) : "memory");
  return x;
}

// Byte offset of bf16 element (r, d) in a tile of `rows` rows of boxes of
// 64 columns, 128-byte swizzled: 16-byte chunk c of row r at c ^ (r % 8).
__device__ __forceinline__ uint32_t swz(int rows, int r, int d) {
  return (d >> 6) * rows * 128 + r * 128 + ((((d & 63) >> 3) ^ (r & 7)) << 4) + (d & 7) * 2;
}

// The fold of a group's splits, spread over its cluster (block s is split
// s): block `split` folds its share of the group's `rows` rows, reading
// the live splits' row maxima and sums (shared address ml_s: [2][kRows])
// and fp32 partials (stage_s: [kRows][DV], 16-byte chunks swizzled by
// row) through distributed shared memory in split order: weights
// 2^(m_s - M) / L a row (into wts: [kMaxSplits][kRows]), then the
// weighted sum, every live split's 16 bytes of a thread's chunk in
// flight at once, into out (the group's rows x hdv).  No live split (a
// decode row with no key) gives 0.
template <int DV>
__device__ __forceinline__ void fold_splits(bf16* __restrict__ out, uint32_t stage_s, float* wts,
                                         uint32_t ml_s, int rows, int split, int nsplit,
                                         unsigned live, int hdv) {
  const int tid = threadIdx.x;
  const int per = (rows + nsplit - 1) / nsplit;
  const int rb = min(rows, split * per), re = min(rows, rb + per);  // this block's rows
  for (int r = rb + tid; r < re; r += kThreads) {
    float mv[kMaxSplits], lv[kMaxSplits];
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      const bool on = (live >> s) & 1u;
      mv[s] = on ? ld_dsmem_f32(mapa(ml_s + 4 * r, s)) : PMT_NEG_INF;
      lv[s] = on ? ld_dsmem_f32(mapa(ml_s + 4 * (kRows + r), s)) : 0.f;
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
    for (int s = 0; s < kMaxSplits; ++s) wts[s * kRows + r - rb] = mv[s] * inv;
  }
  __syncthreads();
  if (hdv % 4 == 0) {
    const int units = hdv / 4;
    for (int u = tid; u < (re - rb) * units; u += kThreads) {
      const int i = u / units, r = rb + i, c = u - i * units;
      const uint32_t at = stage_s + 16 * (r * (DV / 4) + (c ^ (r & 7)));
      float4 v[kMaxSplits];
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s)
        if ((live >> s) & 1u) v[s] = ld_dsmem_f4(mapa(at, s));
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s) {
        if (!((live >> s) & 1u)) continue;
        const float w = wts[s * kRows + i];
        sum.x = fmaf(w, v[s].x, sum.x);
        sum.y = fmaf(w, v[s].y, sum.y);
        sum.z = fmaf(w, v[s].z, sum.z);
        sum.w = fmaf(w, v[s].w, sum.w);
      }
      *reinterpret_cast<uint2*>(out + (size_t)r * hdv + c * 4) =
          make_uint2(pack_bf16(sum.x, sum.y), pack_bf16(sum.z, sum.w));
    }
  } else {
    for (int e = tid; e < (re - rb) * hdv; e += kThreads) {
      const int i = e / hdv, r = rb + i, c = e - i * hdv;
      const uint32_t at = stage_s + 4 * (r * DV + ((c >> 2) ^ (r & 7)) * 4 + (c & 3));
      float sum = 0.f;
      for (int s = 0; s < nsplit; ++s)
        if ((live >> s) & 1u) sum = fmaf(wts[s * kRows + i], ld_dsmem_f32(mapa(at, s)), sum);
      out[(size_t)r * hdv + c] = __float2bfloat16(sum);
    }
  }
}

// q, out: (B, KVH, T, G, hd / hdv) bf16; kx: the chunk's keys (B, T, KVH,
// hd) bf16 (none at decode); kc: the cache (B, C, KVH, hd), or with kPaged
// the pools (P, ps, KVH, hd) read through page_table (B, NB), C = NB * ps;
// TC bf16, or int8_t / __nv_fp8_e4m3 codes with row scales ksc (rows x KVH
// float32).  decode (T = 1): pos = lens, the cache range [0, min(lens, C -
// 1)] and no chunk; else pos = offs, the range [0, min(offs, C)) and the
// chunk's keys t' <= t.  mul = scale x log2(e) takes a score to log2
// units.  tq, tx, tk: their tensor maps (with tma; else unused).  Launched
// in clusters of nsplit blocks along x.
template <int DK, int DV, bool kPaged, typename TC>
__global__ void __launch_bounds__(kThreads, 1)
latent_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tx,
              const __grid_constant__ CUtensorMap tk, const bf16* __restrict__ q,
              const bf16* __restrict__ kx, const TC* __restrict__ kc,
              const float* __restrict__ ksc, const int* __restrict__ pos,
              const int* __restrict__ page_table, bf16* __restrict__ out, int T, int C, int NB,
              int ps, int KVH, int G, int hd, int hdv, float mul, int decode, int nsplit,
              int tma) {
  constexpr bool kCodes = pmt::is_code<TC>::value;
  using L = Layout<DK, kCodes>;
  constexpr int S = L::kStages;
  constexpr int NW = DV / kConsumers;  // value columns of a warpgroup
  constexpr int CB = L::kCodeBox;
  extern __shared__ __align__(16) uint8_t smem_pf[];
  __shared__ float fold_ml[2][kRows];  // a split's row maxima and sums, for the fold
  const uint32_t raw = smem_u32(smem_pf);
  const uint32_t q_s = (raw + 1023) & ~1023u;  // the same in every block of the cluster
  uint8_t* sm = smem_pf + (q_s - raw);         // q_s as a pointer
  const uint32_t tiles_s = q_s + L::kQBytes;
  const uint32_t p_s = tiles_s + S * L::kTileBytes;
  uint8_t* codes = sm + (p_s - q_s) + L::kPBytes;                // [kBK * DK]
  float* scl = reinterpret_cast<float*>(codes + L::kCodeBytes);  // [stage][kBK]
  // [warpgroup][row]: row maxima, at the end row sums
  float* xch = reinterpret_cast<float*>(reinterpret_cast<uint8_t*>(scl) + S * L::kScaleBytes);
  const uint32_t bars = smem_u32(xch + kConsumers * kRows);
  const uint32_t q_full = bars;
  auto full = [&](int t) { return bars + 8 * (1 + t % S); };
  auto empty = [&](int t) { return bars + 8 * (1 + S + t % S); };
  const uint32_t code_full = bars + 8 * (1 + 2 * S);  // codes only
  auto phase = [](int t) { return static_cast<uint32_t>((t / S) & 1); };
  auto tile_of = [&](int t) { return tiles_s + (t % S) * L::kTileBytes; };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // keys of batch row r's cache range
  auto limit_of = [&](int r) { return decode ? max(min(pos[r], C - 1) + 1, 0) : min(pos[r], C); };
  // The batch rows in order of their cache ranges, longest first (ties
  // by index): blocks z take the (z / KVH)-th, so the longest rows'
  // blocks start first and the short ones fill in behind them.
  __shared__ int b_of_z;
  __shared__ int tile_info[S][2];  // a stage's tile: first key; keys | cache << 8
  const int B = gridDim.z / KVH;
  for (int r = tid; r < B; r += blockDim.x) {
    const int lr = limit_of(r);
    int rank = 0;
    for (int r2 = 0; r2 < B; ++r2) {
      const int l2 = limit_of(r2);
      rank += l2 > lr || (l2 == lr && r2 < r);
    }
    if (rank == (int)blockIdx.z / KVH) b_of_z = r;
  }
  if (tid == 0) {
    mbar_init(q_full, 32);  // every lane of the loading warp arrives
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 128);  // every producer thread
      mbar_init(empty(s), 4 * kConsumers);  // lane 0 of every consumer warp
    }
    mbar_init(code_full, 32);
    mbar_init_fence();
  }
  __syncthreads();

  const int split = blockIdx.x, h = blockIdx.z % KVH, b = b_of_z, bh = b * KVH + h;
  const int rows_total = T * G;
  const int row0 = blockIdx.y * kRows;
  const int rows = min(kRows, rows_total - row0);
  const int limit = limit_of(b);
  auto share = [&](int s, int& lo, int& hi) { split_range(0, limit, nsplit, s, lo, hi); };
  int lo, hi;
  share(split, lo, hi);
  const int n_cache = (hi - lo + kBK - 1) / kBK;
  const int t_max = min(T - 1, (row0 + rows - 1) / G);  // chunk keys past it are masked
  const bool with_chunk = !decode && split == nsplit - 1;  // it takes the chunk's keys too
  const int ntiles = n_cache + (with_chunk ? t_max / kBK + 1 : 0);
  // Tile t: cache keys lo + t * kBK .. (t < n_cache), then the chunk's.
  auto tile_base = [&](int t) { return t < n_cache ? lo + t * kBK : (t - n_cache) * kBK; };
  auto tile_keys = [&](int t) {
    return t < n_cache ? min(kBK, hi - tile_base(t)) : min(kBK, T - tile_base(t));
  };

  const bf16 zero = __float2bfloat16(0.f);
  const size_t kstride = (size_t)KVH * hd;
  if (warp >= 4 * kConsumers) {
    // Producer: its first warp loads q once, then the tiles as the ring
    // frees up, lane 0 first telling a barrier the bytes its TMA loads
    // bring; all four warps widen code tiles.  Each producer thread
    // arrives once on a tile's barrier.
    const bool loader = warp == 4 * kConsumers;
    const int ptid = tid - 128 * kConsumers;
    if (ntiles > 0) {
      // cache row of tile key r (r < the tile's keys)
      auto cache_row = [&](int base, int r) -> size_t {
        const int p = base + r;
        if constexpr (kPaged)
          return (size_t)page_table[(size_t)b * NB + p / ps] * ps + (p % ps);
        else
          return (size_t)b * C + p;
      };
      // element copies: `rows_n` rows of `src(r)` into a swizzled bf16 tile
      // of `box_rows` rows, zeros past hd and past rows_n
      auto copy_bf16 = [&](uint32_t dst, int box_rows, int rows_n, auto src) {
        for (int i = lane; i < box_rows * DK; i += 32) {
          const int r = i / DK, d = i - r * DK;
          const bf16 v = r < rows_n && d < hd ? src(r)[d] : zero;
          *reinterpret_cast<bf16*>(sm + (dst - q_s) + swz(box_rows, r, d)) = v;
        }
        fence_proxy_async();
      };
      // TMA loads of `bytes` on barrier `bar`, lane 0 first telling it
      // so: the lanes issue the boxes together, box i on lane i % 32.
      auto tma_boxes = [&](uint32_t bar, uint32_t bytes, int nbox, auto issue) {
        if (lane == 0) mbar_arrive_expect_tx(bar, bytes);
        __syncwarp();
        for (int i = lane; i < nbox; i += 32) issue(i);
        if (lane != 0) mbar_arrive(bar);
      };
      if (loader && tma) {
        tma_boxes(q_full, L::kQBytes, DK / 64, [&](int j) {
          tma_load_3d(q_s + j * kRows * 128, &tq, 64 * j, row0, bh, q_full);
        });
      } else if (loader) {
        const bf16* qb = q + ((size_t)bh * rows_total + row0) * hd;
        copy_bf16(q_s, kRows, rows, [&](int r) { return qb + (size_t)r * hd; });
        mbar_arrive(q_full);
      }
      // the cache tile of keys [base, base + n) in boxes of `box_bytes` a
      // row, `nb` a row, on barrier `bar`: one set of boxes (contiguous),
      // or one a page segment of R rows (paged)
      auto cache_boxes = [&](int base, int n, uint32_t at, int box_bytes, int nb, int box_cols,
                             uint32_t bar) {
        if constexpr (kPaged) {
          const int R = pool_box_rows(ps), nseg = (n + R - 1) / R;
          tma_boxes(bar, nseg * R * nb * box_bytes, nseg * nb, [&](int i) {
            const int sg = i / nb, j = i - sg * nb, p = base + sg * R;
            const int page = page_table[(size_t)b * NB + p / ps];
            tma_load_4d(at + j * kBK * box_bytes + sg * R * box_bytes, &tk, box_cols * j, h,
                        p % ps, page, bar);
          });
        } else {
          tma_boxes(bar, kBK * nb * box_bytes, nb, [&](int j) {
            tma_load_4d(at + j * kBK * box_bytes, &tk, box_cols * j, h, base, b, bar);
          });
        }
      };
      // cache tile t's codes into the code tile
      auto load_codes = [&](int t) {
        cache_boxes(tile_base(t), tile_keys(t), smem_u32(codes), CB, DK / CB, CB, code_full);
      };
      if (kCodes && loader && tma && n_cache > 0) load_codes(0);
      for (int t = 0; t < ntiles; ++t) {
        mbar_wait(empty(t), phase(t) ^ 1);
        const uint32_t bar = full(t), dst = tile_of(t);
        const int base = tile_base(t), n = tile_keys(t);
        const bool cache = t < n_cache;
        if (ptid == 0) {  // for the consumers, who keep no range of their own
          tile_info[t % S][0] = base;
          tile_info[t % S][1] = n | cache << 8;
        }
        if (cache && kCodes) {
          // This tile's row scales, then its codes (landed in the code
          // tile, the producer's own) widened exactly into the bf16 tile,
          // rows past its keys zeroed (p is 0 there, and 0 x NaN would not
          // be); then the next cache tile's codes, which land while the
          // consumers work.
          const int st = t % S;
          if (loader) scl[st * kBK + lane] = lane < n ? ksc[cache_row(base, lane) * KVH + h] : 0.f;
          if (tma) mbar_wait(code_full, t & 1);
          const uint8_t* cd = codes;
          const uint8_t* kt = reinterpret_cast<const uint8_t*>(kc) + (size_t)h * hd;
          uint8_t* tp = sm + (dst - q_s);
          constexpr int kUnits = DK / 8;
          for (int u = ptid; u < kBK * kUnits; u += 128) {
            const int r = u / kUnits, d = (u - r * kUnits) * 8;
            uint2 c = make_uint2(0u, 0u);
            if (r < n) {
              if (tma) {
                c = *reinterpret_cast<const uint2*>(cd + (d / CB) * kBK * CB + r * CB + d % CB);
              } else {
                const uint8_t* row = kt + cache_row(base, r) * kstride;
                for (int k = 0; k < 8 && d + k < hd; ++k) {
                  const uint32_t byte = row[d + k];
                  if (k < 4) c.x |= byte << (8 * k);
                  else c.y |= byte << (8 * (k - 4));
                }
              }
            }
            *reinterpret_cast<uint4*>(tp + swz(kBK, r, d)) = widen8<TC>(c);
          }
          fence_proxy_async();  // (the code tile's reads too, before the next load)
          named_sync(5, 128);   // the producer warpgroup is done with the code tile
          if (loader && tma && t + 1 < n_cache) load_codes(t + 1);
          mbar_arrive(bar);
          continue;
        }
        if (!loader) {
          mbar_arrive(bar);
          continue;
        }
        if constexpr (kCodes) scl[(t % S) * kBK + lane] = 1.f;  // chunk keys: unscaled
        if (tma && cache) {
          cache_boxes(base, n, dst, 128, DK / 64, 64, bar);
        } else if (tma) {
          tma_boxes(bar, L::kTileBytes, DK / 64, [&](int j) {
            tma_load_4d(dst + j * kBK * 128, &tx, 64 * j, h, base, b, bar);
          });
        } else {
          const bf16* kt = (cache ? reinterpret_cast<const bf16*>(kc) : kx) + (size_t)h * hd;
          copy_bf16(dst, kBK, n, [&](int r) {
            return kt + (cache ? cache_row(base, r) : (size_t)b * T + base + r) * kstride;
          });
          mbar_arrive(bar);
        }
      }
    }
  } else {
    // Consumers: warpgroup wg forms the scores of the tile's keys [16 wg,
    // 16 wg + 16) over the whole depth; the two meet at named barriers to
    // take one row maximum and to share p; each then accumulates p . v
    // over all the tile's keys into its own NW value columns.  Tile t's S
    // goes to the tensor cores ahead of tile t - 1's p . v, and tile t's
    // softmax runs while that p . v does (p in two buffers).
    const int wg = warp >> 2;
    const int r0 = 16 * (warp & 3) + (lane >> 2);  // this thread's rows r0, r0 + 8
    const int c0 = 2 * (lane & 3);                // and columns c0, c0 + 1 of each 8
    float o[NW / 2];
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) o[i] = 0.f;
    float m_run[2] = {PMT_NEG_INF, PMT_NEG_INF}, l_run[2] = {0.f, 0.f};
    // O += p_hi . v + p_lo . v for tile t (p in buffer t % 2) over this
    // warpgroup's value columns, v the tile's own rows (their first NW x 2
    // columns), MN-major: a step is 16 keys, the next 64 columns one box
    // on.  Descriptors are a base plus the step's offset (16-byte units in
    // the address field), the base made afresh each tile (opaque to the
    // compiler, which would otherwise hold every step's in registers).
    auto issue_pv = [&](int t) {
      uint32_t pa = p_s + (t & 1) * L::kPBytes / 2, va = tile_of(t) + (wg * NW / 64) * kBK * 128;
      asm volatile("" : "+r"(pa), "+r"(va));
      const uint64_t pd = smem_desc(pa, 16, 1024, 1),
                     vd = smem_desc(va, kBK * 128, 1024, 1);
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)  // p_hi, then p_lo
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_ss_tb<NW>(o, pd + ((h2 * 64 + kk * 32) >> 4), vd + ((kk * 16 * 128) >> 4));
    };
    if (ntiles > 0) mbar_wait(q_full, 0);
    for (int t = 0; t < ntiles; ++t) {
      const int st = t % S;
      const uint32_t tile = tile_of(t);
      uint8_t* tp = sm + (tile - q_s);
      mbar_wait(full(t), phase(t));
      const int base = tile_info[st][0], n = tile_info[st][1] & 255;
      const bool cache = tile_info[st][1] >> 8;
      if (!kCodes && cache && n < kBK) {
        // rows past the tile's keys zeroed (p is 0 there, and 0 x NaN
        // would not be; over codes the producer zeroes them)
        constexpr int kUnits = DK / 8;
#pragma unroll 1
        for (int u = n * kUnits + tid; u < kBK * kUnits; u += 128 * kConsumers) {
          const int r = u / kUnits, d = (u - r * kUnits) * 8;
          *reinterpret_cast<uint4*>(tp + swz(kBK, r, d)) = make_uint4(0u, 0u, 0u, 0u);
        }
        fence_proxy_async();
        named_sync(1, 128 * kConsumers);
      }

      // S = q . k^T over this warpgroup's 16 keys, 16 columns (32 bytes)
      // a step, inside one swizzled box and then the next; then the last
      // tile's p . v behind it.
      uint32_t qa = q_s, ka = tile + wg * 16 * 128;
      asm volatile("" : "+r"(qa), "+r"(ka));
      const uint64_t qd = smem_desc(qa, 16, 1024, 1), kd = smem_desc(ka, 16, 1024, 1);
      float s[8];
      fence_regs(s);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk) {
        const int part = kk >> 2, off = (kk & 3) * 32;
        wgmma_ss<16>(s, qd + ((part * kRows * 128 + off) >> 4),
                     kd + ((part * kBK * 128 + off) >> 4), kk > 0);
      }
      wgmma_commit();
      if (t > 0) {
        issue_pv(t - 1);
        wgmma_commit();
        wgmma_wait<1>();  // S is in; p . v may still run
      } else {
        wgmma_wait<0>();
      }
      fence_regs(s);

      // scale, masks, online softmax (log2 units), on the fragments: a
      // cache tile's keys below n all attend; chunk key t' from rows t >= t'.
      // this tile's row scales (codes), by 32-bit shared address off q's
      const uint32_t tscl =
          q_s + static_cast<uint32_t>(reinterpret_cast<uint8_t*>(scl) - sm) + st * kBK * 4;
      int end[2];
#pragma unroll
      for (int j = 0; j < 2; ++j)  // (the rows' tokens made afresh: registers are short)
        end[j] = cache ? n : min((row0 + r0 + 8 * j) / G + 1 - base, n);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = 16 * wg + 8 * i + c0 + c;
            float x = s[4 * i + 2 * j + c] * mul;
            if constexpr (kCodes) x *= lds_f32(tscl + 4 * col);
            x = col < end[j] ? x : -INFINITY;  // weighs 0
            s[4 * i + 2 * j + c] = x;
            mx[j] = fmaxf(mx[j], x);
          }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
        mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
        if ((lane & 3) == 0) xch[wg * kRows + r0 + 8 * j] = mx[j];
      }
      named_sync(2, 128 * kConsumers);
      uint8_t* pb = sm + (p_s - q_s) + (t & 1) * L::kPBytes / 2;  // p's buffer
      float alpha[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int row = r0 + 8 * j;
        const float m_new = fmaxf(m_run[j], fmaxf(xch[row], xch[kRows + row]));
        alpha[j] = ex2(m_run[j] - m_new);  // NEG_INF at least: finite
        m_run[j] = m_new;
        float lsum = 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& p = s[4 * i + 2 * j + c];
            p = ex2(p - m_new);
            lsum += p;
            if constexpr (kCodes) p *= lds_f32(tscl + 4 * (16 * wg + 8 * i + c0 + c));  // l keeps p
          }
        l_run[j] = alpha[j] * l_run[j] + lsum;
        // p_hi at columns [0, 32) of the row, p_lo at [32, 64)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          uint32_t ph, pl;
          split_bf16(s[4 * i + 2 * j], s[4 * i + 2 * j + 1], ph, pl);
          const int col = 16 * wg + 8 * i + c0;
          *reinterpret_cast<uint32_t*>(pb + swz(kRows, row, col)) = ph;
          *reinterpret_cast<uint32_t*>(pb + swz(kRows, row, col + 32)) = pl;
        }
      }
      fence_proxy_async();
      named_sync(3, 128 * kConsumers);
      wgmma_wait<0>();  // the last tile's p . v
      fence_regs(o);
      if (t > 0 && lane == 0) mbar_arrive(empty(t - 1));  // this warp is done with it
#pragma unroll
      for (int i = 0; i < NW / 8; ++i)  // O to this tile's maxima, for its p . v
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          o[4 * i + 2 * j] *= alpha[j];
          o[4 * i + 2 * j + 1] *= alpha[j];
        }
    }
    if (ntiles > 0) {  // the last tile's p . v
      fence_regs(o);
      wgmma_fence();
      issue_pv(ntiles - 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(empty(ntiles - 1));
    }

    // l: the quad's shares, then the two warpgroups' (over maxima already
    // read); then the output (one split; a row with no key gives 0),
    // staged in q and the ring (every consumer past its last product) in
    // 16-byte chunks swizzled by row and stored row by row in whole
    // chunks, or this split's partial, kept there for the cluster's fold.
    if (ntiles > 0 || nsplit == 1) {
      float l_tot[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        l_run[j] += __shfl_xor_sync(0xffffffffu, l_run[j], 1);
        l_run[j] += __shfl_xor_sync(0xffffffffu, l_run[j], 2);
        if ((lane & 3) == 0) xch[wg * kRows + r0 + 8 * j] = l_run[j];
      }
      named_sync(2, 128 * kConsumers);
#pragma unroll
      for (int j = 0; j < 2; ++j) l_tot[j] = xch[r0 + 8 * j] + xch[kRows + r0 + 8 * j];
      if (nsplit == 1) {
        const size_t out0 = (size_t)bh * rows_total + row0;
        bf16* stage = reinterpret_cast<bf16*>(sm);  // [kRows][DV], chunks of 8
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = r0 + 8 * j;
          const float l = fmaxf(l_tot[j], 1e-30f);
#pragma unroll
          for (int i = 0; i < NW / 8; ++i) {
            const int chunk = (wg * NW) / 8 + i;
            *reinterpret_cast<__nv_bfloat162*>(stage + r * DV + (chunk ^ (r & 7)) * 8 + c0) =
                __floats2bfloat162_rn(o[4 * i + 2 * j] / l, o[4 * i + 2 * j + 1] / l);
          }
        }
        named_sync(4, 128 * kConsumers);
        if (hdv % 8 == 0) {
          const int units = hdv / 8;
          for (int u = tid; u < rows * units; u += 128 * kConsumers) {
            const int r = u / units, c = u - r * units;
            *reinterpret_cast<uint4*>(out + (out0 + r) * hdv + c * 8) =
                *reinterpret_cast<const uint4*>(stage + r * DV + (c ^ (r & 7)) * 8);
          }
        } else {
          for (int e = tid; e < rows * hdv; e += 128 * kConsumers) {
            const int r = e / hdv, c = e - r * hdv;
            out[(out0 + r) * hdv + c] = stage[r * DV + ((c >> 3) ^ (r & 7)) * 8 + (c & 7)];
          }
        }
      } else {
        // Split-KV: this split's partial (unnormalised), its maxima and sums.
        float* stage = reinterpret_cast<float*>(sm);  // [kRows][DV], chunks of 4
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = r0 + 8 * j;
#pragma unroll
          for (int i = 0; i < NW / 8; ++i) {
            const int col = wg * NW + 8 * i + c0;
            *reinterpret_cast<float2*>(stage + r * DV + ((col >> 2) ^ (r & 7)) * 4 + (col & 3)) =
                make_float2(o[4 * i + 2 * j], o[4 * i + 2 * j + 1]);
          }
          if (wg == 0 && (lane & 3) == 0) {
            fold_ml[0][r] = m_run[j];
            fold_ml[1][r] = l_tot[j];
          }
        }
      }
    }
  }
  if (nsplit == 1) return;

  // The fold, spread over the group's cluster: once every split has kept
  // its partial (or has none: a split with no key), block s folds its
  // share of the rows; then no block leaves while another may still read
  // its shared memory.
  cluster_sync();
  unsigned live = 0;  // the splits that kept a partial
  for (int s = 0; s < nsplit; ++s) {
    int l0, h0;
    share(s, l0, h0);
    if (h0 > l0 || (!decode && s == nsplit - 1)) live |= 1u << s;
  }
  fold_splits<DV>(out + ((size_t)bh * rows_total + row0) * hdv, q_s,
                  reinterpret_cast<float*>(sm + (p_s - q_s)), smem_u32(&fold_ml[0][0]), rows,
                  split, nsplit, live, hdv);
  cluster_sync();  // no block leaves while another may still read its shared memory
}

// The map of a tensor whose rows are `hd` elements of `es` bytes, dims
// {hd, d1, d2[, d3]} outermost last, read in boxes {box_cols, 1 or
// box_rows, ...}: bf16 tiles 128-byte swizzled, codes as they lie.
inline bool tensor_map(EncodeTiled encode, CUtensorMap* map, const void* base, int rank,
                       const cuuint64_t* dims, const cuuint32_t* box, int es, bool codes) {
  cuuint64_t strides[3];
  cuuint64_t stride = dims[0] * es;
  for (int i = 0; i + 1 < rank; ++i) {
    strides[i] = stride;
    stride *= dims[i + 1];
  }
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, codes ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                rank, const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                codes ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Args {
  const void *q, *kx, *kc, *ksc, *pos, *page_table;
  void* out;
  int B, T, C, NB, ps, P, KVH, G, hd, hdv;
  float scale;
  int decode, nsplit;
};

template <int DK, int DV, bool kPaged, typename TC>
int launch(const Args& a, cudaStream_t stream) {
  constexpr bool kCodes = pmt::is_code<TC>::value;
  using L = Layout<DK, kCodes>;
  const int tma = loads_by_tma(a.q, a.kx, a.kc, a.hd, sizeof(TC), kPaged, a.ps);
  CUtensorMap tq{}, tx{}, tk{};
  if (tma) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
    const cuuint64_t hd = a.hd;
    const cuuint64_t q_dims[3] = {hd, (cuuint64_t)a.T * a.G, (cuuint64_t)a.B * a.KVH};
    const cuuint32_t q_box[3] = {64, kRows, 1};
    const cuuint64_t x_dims[4] = {hd, (cuuint64_t)a.KVH, (cuuint64_t)a.T, (cuuint64_t)a.B};
    const cuuint32_t x_box[4] = {64, 1, kBK, 1};
    // the cache (B, C, KVH, hd) or the pools (P, ps, KVH, hd)
    const cuuint64_t k_dims[4] = {hd, (cuuint64_t)a.KVH, (cuuint64_t)(kPaged ? a.ps : a.C),
                                  (cuuint64_t)(kPaged ? a.P : a.B)};
    const cuuint32_t k_box[4] = {kCodes ? (cuuint32_t)L::kCodeBox : 64u, 1,
                                 (cuuint32_t)(kPaged ? pool_box_rows(a.ps) : kBK), 1};
    if (!tensor_map(encode, &tq, a.q, 3, q_dims, q_box, 2, false) ||
        (!a.decode && !tensor_map(encode, &tx, a.kx, 4, x_dims, x_box, 2, false)) ||
        !tensor_map(encode, &tk, a.kc, 4, k_dims, k_box, sizeof(TC), kCodes))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = latent_kernel<DK, DV, kPaged, TC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the splits of a group are one cluster along x
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = a.nsplit;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.nsplit, row_blocks(a.T, a.G), a.B * a.KVH);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = L::kSmem;
  cfg.stream = stream;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, tq, tx, tk, static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.kx),
      static_cast<const TC*>(a.kc), static_cast<const float*>(a.ksc),
      static_cast<const int*>(a.pos), static_cast<const int*>(a.page_table),
      static_cast<bf16*>(a.out), a.T, a.C, a.NB, a.ps, a.KVH, a.G, a.hd, a.hdv,
      a.scale * kLog2e, a.decode, a.nsplit, tma);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The kernel's widths: (128, 128) for heads up to 128, else (576, 512);
// 0 where none holds them.
__host__ inline int dk_of(int hd, int hdv) {
  if (hdv > hd || hd < 1 || hdv < 1) return 0;
  if (hd <= 128) return 128;
  if (hd <= 576 && hdv <= 512) return 576;
  return 0;
}

template <bool kPaged, typename TC>
int by_width(const Args& a, cudaStream_t s) {
  switch (dk_of(a.hd, a.hdv)) {
    case 128: return launch<128, 128, kPaged, TC>(a, s);
    case 576: return launch<576, 512, kPaged, TC>(a, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool kPaged>
int by_cache_type(const Args& a, int cache_dtype, cudaStream_t s) {
  switch (cache_dtype) {
    case 1: return by_width<kPaged, bf16>(a, s);
    case 2: return by_width<kPaged, int8_t>(a, s);
    case 3: return by_width<kPaged, __nv_fp8_e4m3>(a, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Rows 3v, 7v (decode) and 2v, 8v (the prefill chunk).  q, out: (B, KVH,
// T, G, hd / hdv) bf16; kx: (B, T, KVH, hd) bf16, the chunk's keys (none,
// may be null, with decode, where T is 1); kc: the cache (B, C, KVH, hd),
// or with paged the pools (P, ps, KVH, hd) and page_table (B, NB) int32
// (C = NB * ps), of cache_dtype 1 = bfloat16, 2 = int8, 3 = fp8_e4m3;
// k_scale: their (rows, KVH) float32 row scales for the codes; pos: (B,)
// int32 lens (decode) or chunk offsets.  Every tensor contiguous.  The
// values are the first hdv lanes of the key rows: hdv <= hd, hd <= 576,
// hdv <= 512.  sms: the card's SMs, for the splits (pmt_latent_splits).
// Returns the launch's error, else cudaGetLastError().
extern "C" int pmt_latent_attention(const void* q, const void* kx, const void* kc,
                                    const void* k_scale, const void* pos,
                                    const void* page_table, void* out, int B, int T, int C,
                                    int NB, int ps, int P, int KVH, int G, int hd, int hdv,
                                    float scale, int decode, int paged, int cache_dtype, int sms,
                                    void* stream) {
  if (B == 0 || T == 0 || KVH == 0 || G == 0) return 0;
  if (C < 1 || sms < 1 || (decode ? T != 1 : kx == nullptr) ||
      (paged && (page_table == nullptr || P < 1 || ps < 1)) ||
      (cache_dtype >= 2 && k_scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nsplit = split_count(B * KVH * row_blocks(T, G), C, sms, decode);
  const Args a{q,  kx, kc, k_scale, pos, page_table, out, B,   T,     C,      NB,
               ps, P,  KVH, G,      hd,  hdv,        scale, decode, nsplit};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return paged ? by_cache_type<true>(a, cache_dtype, s) : by_cache_type<false>(a, cache_dtype, s);
}

// The splits (the cluster's blocks) of a launch over B rows of KVH kv
// heads, T query tokens of G heads each, a cache of capacity C, on sms
// SMs: what kernels/latent_attention.py prefill_split_count (decode_split_count)
// gives for prefill_groups (decode_groups).
extern "C" int pmt_latent_splits(int B, int KVH, int T, int G, int C, int sms, int decode) {
  return split_count(B * KVH * row_blocks(T, G), C, sms, decode);
}

// The kernel's dynamic shared memory (0 where it takes no such widths):
// what kernels/latent_attention.py smem_bytes must give.
extern "C" int pmt_latent_smem_bytes(int hd, int hdv, int cache_dtype) {
  const int dk = dk_of(hd, hdv);
  if (!dk) return 0;
  const bool codes = cache_dtype >= 2;
  if (dk == 128) return codes ? Layout<128, true>::kSmem : Layout<128, false>::kSmem;
  return codes ? Layout<576, true>::kSmem : Layout<576, false>::kSmem;
}

// 1 where a launch over these tensors loads by TMA (kx null at decode), 0
// where its producer warp copies (loads_by_tma): what
// kernels/latent_attention.py loads_by_tma must give.
extern "C" int pmt_latent_tma(const void* q, const void* kx, const void* kc, int hd, int ps,
                              int paged, int cache_dtype) {
  return loads_by_tma(q, kx, kc, hd, cache_dtype >= 2 ? 1 : 2, paged, ps);
}
