// Attention over an aliased latent cache (MLA): the key row is
// [latent | rope], `hd` wide, and the value is its first `hdv` lanes,
// one kv head shared by G query heads (G 128, hd 576, hdv 512 for
// deepseek-v3 at full width).  Two kernels: latent_attention_kernel for
// decode (one query token a row, the new token already in the cache) and
// latent_prefill_kernel for the prefill chunk (T query tokens over the
// cache prefix and their own causal keys), each over a contiguous (B, C,
// KVH, hd) cache or (P, ps, KVH, hd) page pools read through a (B, NB)
// page table, in bf16 or over int8 / fp8_e4m3 codes with one float32
// scale a row.
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
// cores, 34 us on the fp32 CUDA cores).
//
// Both kernels share:
//  * Tensor cores over packed heads: the T * G query rows of a (row, kv
//    head) are the M dimension of the products, as the tensor-core
//    prefill kernel packs T * G rows (prefill_attention.cu).
//  * The aliased tile staged once: a tile of 32 key rows, hd wide, feeds
//    the score's product and, through its first hdv columns, the value's.
//  * Codes as in the tensor-core prefill kernel: a code tile lands as
//    codes, is widened exactly to bf16 (every int8 code and finite e4m3
//    value is a bf16), and the row scale multiplies the fp32 score and p
//    (before p's bf16 hi + lo split), never a bf16 operand: q . (code_c
//    s_c) = (q . code_c) s_c and sum_c p_c (code_c s_c) = sum_c (p_c s_c)
//    code_c.  One scale a row serves as k and v scale, as the alias's one
//    scale tensor does.  The chunk's own keys are bf16, scale 1.
//  * Split-KV as in the other attention kernels: the grid is (splits, row
//    blocks, B * KVH); each split takes a share of the cache range
//    (rounded to 16 keys), the prefill's last split also the chunk's keys;
//    the last block of a (row, kv head, row block) to take its ticket
//    folds the partials in split order and resets the ticket.
//  * p through the tensor cores as bf16 p_hi + p_lo (~16 bits, as in the
//    other tensor-core kernels); l sums the fp32 p.  hd and hdv are padded
//    with zeros in shared memory to the kernel's widths DK and DV; value
//    columns past hdv are neither computed nor stored.
//
// Decode (latent_attention_kernel, mma.sync; widths 64/64, 128/128 or
// 576/512).  Its prefill branch is the chunk's first design, kept as the
// baseline kernel_variants.py times; the library launches it for decode
// only.
//  * mma.sync m16n8k16 (bf16 in, fp32 accumulate), 16 rows a row tile; a
//    block takes one or two row tiles.  The tile lands by 16-byte
//    cp.async in a ring of three; the value fragments are read with
//    ldmatrix .trans over its first hdv columns.
//  * hdv split over warps.  A 16 x 512 fp32 accumulator is 256 registers
//    a thread on one warp, so four warps share a row tile, each holding
//    a quarter of the value columns (64 registers at hdv 512).  The four
//    also split the score's depth: each forms the partial q . k^T over a
//    quarter of hd's 16-wide steps, the partials meet in shared memory,
//    and every warp adds them in the same order, so all four hold the
//    same scores, maxima, sums and p, and none computes the whole score.
//
// The prefill chunk (latent_prefill_kernel, wgmma fed by TMA; widths
// 128/128 or 576/512).  The decode design spent ~6000 cycles a key tile
// (clock64() stamps on thread 0, kernel_variants.py): issuing the
// mma.sync and ldmatrix of p . v (26%) and of S (15%), issuing the
// 16-byte copies (22%; 41% through the page table), the exchange of the
// warps' partial scores (12%) and the softmax (11%), for 32 rows a tile.
//  * 64 packed rows a block, wgmma's M (at G 128 one query token and 64 of
//    its heads, so one causal mask for the block; per row at small G).
//  * A producer warpgroup: its first warp loads q once and the key tiles
//    into a ring of three full / empty mbarrier pairs with TMA:
//    4-D tensor maps of the chunk's keys and of the cache (boxes of 32
//    rows) or of the pools (one box set a page segment of gcd(ps, 16)
//    rows, the page from the table), 64 bf16 columns a box, 128-byte
//    swizzled, zeros past the tensor's edges.  Codes come in unswizzled,
//    as codes.  Where a row is no whole number of 16-byte units, a base is
//    off its 16-byte alignment or a page box would be under 8 rows, the
//    loading warp copies element by element into the same layout
//    (loads_by_tma; the choice depends on shapes and pointers only).
//  * Two consumer warpgroups.  Warpgroup w forms S for the tile's keys
//    [16 w, 16 w + 16) over the whole depth (wgmma m64n16k16, q and k
//    K-major in shared memory); the two meet at a named barrier to take
//    one row maximum, store p_hi and p_lo for their keys into a swizzled
//    64 x 64 bf16 tile (two buffers) and meet again; then each forms O +=
//    p . v for its half of the value columns over all the tile's keys
//    (wgmma m64n256k16 at hdv 512, 64 x 256 fp32 in 128 registers, p from
//    shared memory, v the tile's rows MN-major through the transpose bit).
//    Tile t's S goes to the tensor cores ahead of tile t - 1's p . v, so
//    the softmax runs beside that p . v.  No block barrier stands in the
//    tile loop.
//  * Registers decide the rest.  Three warpgroups make ptxas allot 168 a
//    thread (so would two and one producer warp), and O takes 128.
//    Splitting S by depth (m64n32k16, the partials added across
//    warpgroups) or into two chains, or setmaxnreg (ptxas still allots
//    168), spilled or lost (PERF.md §6).  So the producer warpgroup's four warps widen a code
//    tile into the bf16 tile (and zero its rows past its keys; the
//    consumers zero a bf16 tile's), from one code tile into which the next
//    tile's codes land while the consumers work: codes cost the consumers
//    no registers, and their ring keeps three stages.
//  * The output (or a split's fp32 partial) is staged in q and the ring
//    and stored in whole 16-byte chunks; the last split's fold keeps 8
//    chunks a thread in flight.
//  * Blocks of the batch rows with the longest cache ranges start first.
#include "common.cuh"
#include "hopper.cuh"
#include "tile.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace pmt::sm90;
using namespace pmt::tile;

constexpr int kKT = 32;          // keys per tile
constexpr int kStages = 3;       // tiles in the ring
static_assert(kStages == 3, "the loop loads tile i + 2 while it computes tile i");
constexpr int kSlices = 4;       // warps of a row tile
constexpr int kMaxRowTiles = 2;  // row tiles of a block, 16 query rows each
constexpr int kMaxSplits = 8;
constexpr int kXch = 16 * kKT;   // floats of one warp's partial scores
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of a block: q (16 x row tiles rows) | the key ring
// (kStages x kKT rows), bf16 rows of DK + 8 (16 bytes of padding put the
// 8 rows of an ldmatrix on distinct banks) | the warps' partial scores;
// for codes, then the code ring (kStages x kKT rows of DK + 16 bytes) and
// its row scales (kStages x kKT floats).
template <typename TC>
__host__ __device__ inline size_t smem_bytes(int DK, int row_tiles) {
  size_t bytes = sizeof(bf16) * (size_t)(DK + 8) * (16 * row_tiles + kStages * kKT) +
                 sizeof(float) * (size_t)kXch * kSlices * row_tiles;
  if (pmt::is_code<TC>::value) bytes += (size_t)kStages * kKT * (DK + 16 + sizeof(float));
  return bytes;
}

// q, out: (B, KVH, T, G, hd / hdv) bf16; kx: the chunk's keys (B, T, KVH,
// hd) bf16 (prefill only); kc: the cache (B, C, KVH, hd), or with kPaged
// the pools (P, ps, KVH, hd) read through page_table (B, NB), C = NB * ps;
// TC bf16, or int8_t / __nv_fp8_e4m3 codes with row scales ksc (rows x
// KVH float32).  decode: pos = lens, the cache range [0, min(lens, C - 1)]
// and no chunk (T = 1); else pos = offs, the range [0, min(offs, C)) and
// the chunk's keys t' <= t.  ws: the splits' partials (unused with one
// split); tickets: one zeroed int per (row, kv head, row block).
template <int DK, int DV, bool kPaged, typename TC>
__global__ void __launch_bounds__(kSlices * kMaxRowTiles * 32, 1)
latent_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kx,
                        const TC* __restrict__ kc, const float* __restrict__ ksc,
                        const int* __restrict__ pos, const int* __restrict__ page_table,
                        bf16* __restrict__ out, float* __restrict__ ws,
                        int* __restrict__ tickets, int T, int C, int NB, int ps, int KVH, int G,
                        int hd, int hdv, float scale, int decode, int nsplit) {
  constexpr bool kCodes = pmt::is_code<TC>::value;
  constexpr int P = DK + 8;
  constexpr int CP = DK + 16;              // bytes of a code ring row
  constexpr int KSTEPS = DK / 16;          // of the score's depth
  constexpr int NKQ = (KSTEPS + kSlices - 1) / kSlices;  // a warp's
  constexpr int CW = DV / kSlices;         // value columns a warp
  constexpr int NV = CW / 8;               // its n8 tiles
  static_assert(CW % 16 == 0, "a warp's value columns are whole ldmatrix tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int is_last;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int RB = nthreads / (2 * kSlices);  // 16 query rows a row tile
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + RB * P;
  float* xs = reinterpret_cast<float*>(ks + kStages * kKT * P);
  uint8_t* kcs = reinterpret_cast<uint8_t*>(xs + (size_t)kXch * (nthreads / 32));
  float* scl = reinterpret_cast<float*>(kcs + kStages * kKT * CP);  // [stage][kKT]

  const int split = blockIdx.x, bh = blockIdx.z;
  const int b = bh / KVH, h = bh - b * KVH;
  const int rows_total = T * G;
  const int row0 = blockIdx.y * RB;
  const int rows = min(RB, rows_total - row0);
  const int group = bh * gridDim.y + blockIdx.y;
  const int p0 = pos[b];
  const int limit = decode ? min(p0, C - 1) + 1 : min(p0, C);
  auto share = [&](int s, int& lo, int& hi) { split_range(0, limit, nsplit, s, lo, hi); };
  const bool chunk_split = !decode && split == nsplit - 1;
  int lo, hi;
  share(split, lo, hi);
  const int n_cache = (hi - lo + kKT - 1) / kKT;
  const int t_max = min(T - 1, (row0 + rows - 1) / G);  // chunk keys past it are masked
  const int ntiles = n_cache + (chunk_split ? t_max / kKT + 1 : 0);

  const int warp = tid >> 5, lane = tid & 31;
  const int rt = warp / kSlices, sl = warp % kSlices;  // row tile, slice
  const int r_lo = rt * 16 + (lane >> 2);  // this thread's rows r_lo and r_lo + 8
  const int tq = lane & 3;                  // and columns 2 tq, 2 tq + 1 of each n8 tile
  const int tr[2] = {(row0 + r_lo) / G, (row0 + r_lo + 8) / G};

  float o[NV][4];
#pragma unroll
  for (int n = 0; n < NV; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_run[2] = {PMT_NEG_INF, PMT_NEG_INF}, l_run[2] = {0.f, 0.f};

  if (ntiles > 0) {
    const bf16 zero = __float2bfloat16(0.f);
    const size_t kstride = (size_t)KVH * hd;
    uintptr_t bf16_ptrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(kx);
    if constexpr (!kCodes) bf16_ptrs |= reinterpret_cast<uintptr_t>(kc);
    const bool vec = (hd & 7) == 0 && (bf16_ptrs & 15) == 0;
    const bool cvec = (hd & 15) == 0 && (reinterpret_cast<uintptr_t>(kc) & 15) == 0;
    // zero padding: columns [hd, DK) of the q and key rows (and code rows)
    for (int r = tid; r < RB + kStages * kKT; r += nthreads)
      for (int d = hd; d < DK; ++d) qs[(size_t)r * P + d] = zero;
    if constexpr (kCodes)
      for (int r = tid; r < kStages * kKT; r += nthreads)
        for (int d = hd; d < DK; ++d) kcs[(size_t)r * CP + d] = 0;

    const bf16* qb = q + ((size_t)bh * rows_total + row0) * hd;
    if (vec) {
      const int ck = hd / 8;
      for (int i = tid; i < RB * ck; i += nthreads) {
        const int r = i / ck, c = i - r * ck;
        const bool in = r < rows;
        cp_async16(qs + r * P + c * 8, in ? qb + (size_t)r * hd + c * 8 : qb, in ? 16 : 0);
      }
    } else {
      for (int i = tid; i < RB * hd; i += nthreads) {
        const int r = i / hd, d = i - r * hd;
        qs[r * P + d] = r < rows ? qb[(size_t)r * hd + d] : zero;
      }
    }

    // Tile i: cache keys lo + i * kKT .. (i < n_cache), then the chunk's.
    auto tile_base = [&](int i) { return i < n_cache ? lo + i * kKT : (i - n_cache) * kKT; };
    auto tile_keys = [&](int i) {
      return i < n_cache ? min(kKT, hi - tile_base(i)) : min(kKT, T - tile_base(i));
    };
    auto load_tile = [&](int i, int buf) {
      const bool cache = i < n_cache;
      const int base = tile_base(i), n = tile_keys(i);
      auto row_of = [&](int r) -> size_t {  // key row r's row in its tensor
        const int p = base + r;
        if (!cache) return (size_t)b * T + p;
        if constexpr (kPaged)
          return (size_t)page_table[(size_t)b * NB + p / ps] * ps + (p % ps);
        else
          return (size_t)b * C + p;
      };
      // rows [0, n) in 16-byte chunks (ck a row), rows [n, kKT) zero-filled
      auto copy_rows = [&](auto* dst, const auto* src0, int pitch, int ck) {
        using E = std::remove_pointer_t<decltype(dst)>;
        constexpr int el = 16 / sizeof(E);
        for (int i2 = tid; i2 < kKT * ck; i2 += nthreads) {
          const int r = i2 / ck, c = i2 - r * ck;
          const auto* src = r < n ? src0 + row_of(r) * kstride + c * el : src0;
          cp_async16(dst + r * pitch + c * el, src, r < n ? 16 : 0);
        }
      };
      // the same element by element (rows that are not whole 16-byte units)
      auto copy_elems = [&](auto* dst, const auto* src0, int pitch, auto zero_el) {
        for (int i2 = tid; i2 < kKT * hd; i2 += nthreads) {
          const int r = i2 / hd, d = i2 - r * hd;
          dst[r * pitch + d] = r < n ? src0[row_of(r) * kstride + d] : zero_el;
        }
      };
      float* sd = scl + buf * kKT;
      if constexpr (kCodes) {
        if (cache) {  // codes into the code ring, their row scales beside them
          const uint8_t* kt = reinterpret_cast<const uint8_t*>(kc) + (size_t)h * hd;
          uint8_t* kd = kcs + buf * kKT * CP;
          if (cvec) copy_rows(kd, kt, CP, hd / 16);
          else copy_elems(kd, kt, CP, uint8_t{0});
          for (int r = tid; r < kKT; r += nthreads)
            cp_async4(sd + r, r < n ? ksc + row_of(r) * KVH + h : ksc, r < n ? 4 : 0);
          cp_async_commit();
          return;
        }
        for (int r = tid; r < kKT; r += nthreads) sd[r] = 1.f;  // chunk keys: unscaled
      }
      const bf16* kt = (cache ? reinterpret_cast<const bf16*>(kc) : kx) + (size_t)h * hd;
      bf16* kd = ks + buf * kKT * P;
      if (vec) copy_rows(kd, kt, P, hd / 8);
      else copy_elems(kd, kt, P, zero);
      cp_async_commit();
    };

    // A landed code tile widened exactly into the bf16 ring's slot buf.
    auto widen_tile = [&](int buf) {
      constexpr int kUnits = DK / 8;  // of a row
      for (int u = tid; u < kKT * kUnits; u += nthreads) {
        const int r = buf * kKT + u / kUnits, c = u % kUnits;
        *reinterpret_cast<uint4*>(ks + r * P + c * 8) =
            widen8<TC>(*reinterpret_cast<const uint2*>(kcs + r * CP + c * 8));
      }
    };

    const float mul = scale * kLog2e;  // score -> log2 units
    uint32_t qf[NKQ][4];
    float* xmine = xs + (size_t)warp * kXch;
    const float* xtile = xs + (size_t)rt * kSlices * kXch;
    load_tile(0, 0);  // q rides in tile 0's group
    if (ntiles > 1) load_tile(1, 1);
    for (int i = 0; i < ntiles; ++i) {
      if (i + 1 < ntiles)  // tile i + 1 may still be in flight
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      // tile i is in for every thread; every warp is done with tile i - 1
      // (its slot, which tile i + 2 takes, and the partial scores)
      __syncthreads();
      if (i + 2 < ntiles) load_tile(i + 2, (i + 2) % kStages);
      if constexpr (kCodes) {
        if (i < n_cache) {
          widen_tile(i % kStages);
          __syncthreads();
        }
      }
      if (i == 0) {
#pragma unroll
        for (int j = 0; j < NKQ; ++j) {
          const int kk = sl * NKQ + j;
          if (kk < KSTEPS)
            ldmatrix_x4(qf[j], qs + (rt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P +
                                   kk * 16 + (lane >> 4) * 8);
        }
      }
      const bf16* kd = ks + (i % kStages) * kKT * P;

      // This warp's partial S = q . k^T over its quarter of the depth.
      float sc[kKT / 8][4];
#pragma unroll
      for (int j = 0; j < kKT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
      for (int j = 0; j < NKQ; ++j) {
        const int kk = sl * NKQ + j;
        if (kk >= KSTEPS || kk * 16 >= hd) break;
#pragma unroll
        for (int np = 0; np < kKT / 16; ++np) {
          uint32_t kb[4];
          ldmatrix_x4(kb, kd + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * P + kk * 16 +
                              ((lane >> 3) & 1) * 8);
          mma_bf16_16816(sc[2 * np], qf[j], kb[0], kb[1]);
          mma_bf16_16816(sc[2 * np + 1], qf[j], kb[2], kb[3]);
        }
      }
      // The row tile's four partials meet: each warp adds them in slice
      // order, so all four hold the same scores.
#pragma unroll
      for (int j = 0; j < kKT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) xmine[(j * 4 + e) * 32 + lane] = sc[j][e];
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kKT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float s = 0.f;
#pragma unroll
          for (int w = 0; w < kSlices; ++w) s += xtile[w * kXch + (j * 4 + e) * 32 + lane];
          sc[j][e] = s;
        }

      // scale, masks, online softmax (log2 units), on the fragments.  A
      // cache tile's keys are all attendable (the range is cut to them);
      // a chunk key t' is attendable from rows t >= t'.
      const bool cache = i < n_cache;
      const int base = tile_base(i), n = tile_keys(i);
      int end[2];  // tile columns c < end attend
#pragma unroll
      for (int u = 0; u < 2; ++u) end[u] = cache ? n : min(tr[u] + 1 - base, n);
      const float* tscl = scl + (i % kStages) * kKT;  // this tile's row scales
#pragma unroll
      for (int j = 0; j < kKT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + tq * 2 + (e & 1);
          float x = sc[j][e] * mul;
          if constexpr (kCodes) x *= tscl[c];
          sc[j][e] = c < end[e >> 1] ? x : -INFINITY;  // weighs 0
        }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < kKT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
      float alpha[2], lsum[2] = {0.f, 0.f};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 1));
        mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 2));
        const float m_new = fmaxf(m_run[u], mx[u]);  // NEG_INF at least: finite
        alpha[u] = ex2(m_run[u] - m_new);
        m_run[u] = m_new;
      }
#pragma unroll
      for (int j = 0; j < kKT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[j][e] = ex2(sc[j][e] - m_run[e >> 1]);
          lsum[e >> 1] += sc[j][e];
        }
#pragma unroll
      for (int u = 0; u < 2; ++u) l_run[u] = alpha[u] * l_run[u] + lsum[u];
#pragma unroll
      for (int n8 = 0; n8 < NV; ++n8) {
        o[n8][0] *= alpha[0];
        o[n8][1] *= alpha[0];
        o[n8][2] *= alpha[1];
        o[n8][3] *= alpha[1];
      }
      if constexpr (kCodes) {  // p . (code * s) = (p * s) . code; l keeps p
#pragma unroll
        for (int j = 0; j < kKT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] *= tscl[j * 8 + tq * 2 + (e & 1)];
      }

      // O += p . v over this warp's value columns, v the tile's own rows
      // (their first hdv lanes), p as bf16 p_hi + p_lo.
#pragma unroll
      for (int kk = 0; kk < kKT / 16; ++kk) {
        uint32_t ph[4], pl[4];
        split_bf16(sc[2 * kk][0], sc[2 * kk][1], ph[0], pl[0]);
        split_bf16(sc[2 * kk][2], sc[2 * kk][3], ph[1], pl[1]);
        split_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ph[2], pl[2]);
        split_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int np = 0; np < NV / 2; ++np) {
          const int col = sl * CW + np * 16;
          if (col >= hdv) break;
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, kd + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P + col +
                                    (lane >> 4) * 8);
          mma_bf16_16816(o[2 * np], ph, vb[0], vb[1]);
          mma_bf16_16816(o[2 * np], pl, vb[0], vb[1]);
          mma_bf16_16816(o[2 * np + 1], ph, vb[2], vb[3]);
          mma_bf16_16816(o[2 * np + 1], pl, vb[2], vb[3]);
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) {  // a row's l is spread over its quad
    l_run[u] += __shfl_xor_sync(0xffffffffu, l_run[u], 1);
    l_run[u] += __shfl_xor_sync(0xffffffffu, l_run[u], 2);
  }

  const size_t out0 = (size_t)bh * rows_total + row0;
  if (nsplit == 1) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = r_lo + 8 * u;
      if (r >= rows) continue;
      const float l = fmaxf(l_run[u], 1e-30f);
      bf16* orow = out + (out0 + r) * hdv;
#pragma unroll
      for (int n8 = 0; n8 < NV; ++n8)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = sl * CW + n8 * 8 + tq * 2 + e;
          if (c < hdv) orow[c] = __float2bfloat16(o[n8][2 * u + e] / l);
        }
    }
    return;
  }

  // Split-KV: this split's partial, then the ticket.
  const size_t groups = (size_t)gridDim.y * gridDim.z;
  auto acc_of = [&](int s) { return ws + ((size_t)group * nsplit + s) * RB * hdv; };
  auto ml_of = [&](int s) {
    return ws + groups * nsplit * RB * hdv + ((size_t)group * nsplit + s) * RB * 2;
  };
  if (ntiles > 0) {
    float* acc = acc_of(split);
    float* ml = ml_of(split);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = r_lo + 8 * u;
      if (r >= rows) continue;
#pragma unroll
      for (int n8 = 0; n8 < NV; ++n8)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = sl * CW + n8 * 8 + tq * 2 + e;
          if (c < hdv) acc[(size_t)r * hdv + c] = o[n8][2 * u + e];
        }
      if (sl == 0 && tq == 0) {
        ml[2 * r] = m_run[u];
        ml[2 * r + 1] = l_run[u];
      }
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(tickets + group, 1) == nsplit - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // The last block folds the partials in split order: weights
  // 2^(m_s - M) / L a row, then the weighted sum of the accumulators,
  // every split's loads of a row in flight at once.
  unsigned live = 0;  // the splits that wrote a partial
  for (int s = 0; s < nsplit; ++s) {
    int l0, h0;
    share(s, l0, h0);
    if (h0 > l0 || (!decode && s == nsplit - 1)) live |= 1u << s;
  }
  float* wt = reinterpret_cast<float*>(smem_raw);  // [nsplit][RB], over q's slot
  for (int r = tid; r < rows; r += nthreads) {
    float mv[kMaxSplits], lv[kMaxSplits];
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      const bool on = (live >> s) & 1u;
      mv[s] = on ? __ldcg(ml_of(s) + 2 * r) : PMT_NEG_INF;
      lv[s] = on ? __ldcg(ml_of(s) + 2 * r + 1) : 0.f;
    }
    float M = PMT_NEG_INF, L = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) M = fmaxf(M, mv[s]);
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      mv[s] = (live >> s) & 1u ? ex2(mv[s] - M) : 0.f;
      L += mv[s] * lv[s];
    }
    const float inv = 1.f / fmaxf(L, 1e-30f);
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      if (s < nsplit) wt[s * RB + r] = mv[s] * inv;
  }
  __syncthreads();
  const int width = hdv % 4 == 0 ? 4 : 1;  // columns a thread sums at once
  const int groups_row = hdv / width;
  for (int i = tid; i < rows * groups_row; i += nthreads) {
    const int r = i / groups_row, d = (i - r * groups_row) * width;
    float4 v[kMaxSplits];
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      if (!((live >> s) & 1u)) continue;
      const float* src = acc_of(s) + (size_t)r * hdv + d;
      v[s] = width == 4 ? __ldcg(reinterpret_cast<const float4*>(src))
                        : make_float4(__ldcg(src), 0.f, 0.f, 0.f);
    }
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      if (!((live >> s) & 1u)) continue;
      const float w = wt[s * RB + r];
      sum.x = fmaf(w, v[s].x, sum.x);
      sum.y = fmaf(w, v[s].y, sum.y);
      sum.z = fmaf(w, v[s].z, sum.z);
      sum.w = fmaf(w, v[s].w, sum.w);
    }
    bf16* dst = out + (out0 + r) * hdv + d;
    dst[0] = __float2bfloat16(sum.x);
    if (width == 4) {
      dst[1] = __float2bfloat16(sum.y);
      dst[2] = __float2bfloat16(sum.z);
      dst[3] = __float2bfloat16(sum.w);
    }
  }
  if (tid == 0) tickets[group] = 0;  // ready for the next launch
}

// -- the prefill chunk (rows 2v, 8v): wgmma over 64 packed rows, fed by TMA ------

namespace prefill {

constexpr int kBK = 32;        // keys of a tile
constexpr int kRows = 64;      // packed query rows of a block: wgmma's M
constexpr int kConsumers = 2;  // warpgroups, each half the value columns
constexpr int kThreads = 128 * kConsumers + 128;  // and a producer warpgroup
constexpr int kMaxSplits = 8;
static_assert(kBK == 32, "a producer lane loads one key row's scale");

// Shared memory of a block, each tile on a 1024-byte boundary (the
// 128-byte swizzle's period): q (64 rows) | the key ring (kStages tiles of
// kBK rows) | p, two buffers (64 rows of p_hi's 32 keys, then p_lo's: 128
// bytes) | one code tile and each stage's row scales (codes only) | the
// warpgroups' row maxima (at the end, row sums) | the barriers (q, full
// and empty a stage, codes landed).  A bf16 tile is DK / 64 boxes of 64 columns (128
// bytes a row, swizzled as TMA writes them and wgmma reads them); a code
// tile DK / kCodeBox boxes of kCodeBox bytes a row, unswizzled.  After
// the last tile, q and the ring stage the output (or the split's fp32
// partial) for coalesced stores.
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
  static_assert(kRows * DK * 4 <= kQBytes + kStages * kTileBytes + kPBytes,
                "q, the ring and p hold a split's 64 x DV fp32 partial (DV <= DK)");
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

// q, out: (B, KVH, T, G, hd / hdv) bf16; kx: the chunk's keys (B, T, KVH,
// hd) bf16; kc: the cache (B, C, KVH, hd), or with kPaged the pools (P,
// ps, KVH, hd) read through page_table (B, NB), C = NB * ps; TC bf16, or
// int8_t / __nv_fp8_e4m3 codes with row scales ksc (rows x KVH float32).
// A row attends the cache range [0, min(offs, C)) and the chunk's keys t'
// <= t; mul = scale x log2(e) takes a score to log2 units.  tq, tx, tk:
// their tensor maps (with tma; else unused); ws: the
// splits' partials (unused with one split); tickets: one zeroed int per
// (row, kv head, row block).
template <int DK, int DV, bool kPaged, typename TC>
__global__ void __launch_bounds__(kThreads, 1)
latent_prefill_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tx,
                      const __grid_constant__ CUtensorMap tk, const bf16* __restrict__ q,
                      const bf16* __restrict__ kx, const TC* __restrict__ kc,
                      const float* __restrict__ ksc, const int* __restrict__ offs,
                      const int* __restrict__ page_table, bf16* __restrict__ out,
                      float* __restrict__ ws, int* __restrict__ tickets, int T, int C, int NB,
                      int ps, int KVH, int G, int hd, int hdv, float mul, int nsplit,
                      int tma) {
  constexpr bool kCodes = pmt::is_code<TC>::value;
  using L = Layout<DK, kCodes>;
  constexpr int S = L::kStages;
  constexpr int NW = DV / kConsumers;  // value columns of a warpgroup
  constexpr int CB = L::kCodeBox;
  extern __shared__ __align__(16) uint8_t smem_pf[];
  __shared__ int is_last;
  const uint32_t raw = smem_u32(smem_pf);
  const uint32_t q_s = (raw + 1023) & ~1023u;
  uint8_t* sm = smem_pf + (q_s - raw);  // q_s as a pointer
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
  // The batch rows in order of their cache ranges, longest first (ties
  // by index): blocks z take the (z / KVH)-th, so the longest rows'
  // blocks start first and the short ones fill in behind them.
  __shared__ int b_of_z;
  __shared__ int tile_info[S][2];  // a stage's tile: first key; keys | cache << 8
  const int B = gridDim.z / KVH;
  for (int r = tid; r < B; r += blockDim.x) {
    const int lr = min(offs[r], C);
    int rank = 0;
    for (int r2 = 0; r2 < B; ++r2) {
      const int l2 = min(offs[r2], C);
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
  const int group = bh * gridDim.y + blockIdx.y;
  const int limit = min(offs[b], C);
  auto share = [&](int s, int& lo, int& hi) { split_range(0, limit, nsplit, s, lo, hi); };
  int lo, hi;
  share(split, lo, hi);
  const int n_cache = (hi - lo + kBK - 1) / kBK;
  const int t_max = min(T - 1, (row0 + rows - 1) / G);  // chunk keys past it are masked
  const int ntiles = n_cache + (split == nsplit - 1 ? t_max / kBK + 1 : 0);
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
    // read); then the output (one split) or this split's partial, staged
    // in q and the ring (every consumer past its last product) in 16-byte
    // chunks swizzled by row, and stored row by row in whole chunks.
    if (ntiles > 0) {
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
      const size_t out0 = (size_t)bh * rows_total + row0;
      if (nsplit == 1) {
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
        float* acc = ws + ((size_t)group * nsplit + split) * kRows * hdv;
        float* ml = ws + (size_t)gridDim.y * gridDim.z * nsplit * kRows * hdv +
                    ((size_t)group * nsplit + split) * kRows * 2;
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
          if (wg == 0 && (lane & 3) == 0 && r < rows) {
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
      }
    }
  }
  if (nsplit == 1) return;

  // The ticket; the last block of the group folds the partials in split
  // order: weights 2^(m_s - M) / L a row, then the weighted sum, kBatch
  // chunks a thread in flight at a time.
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
  unsigned live = 0;  // the splits that wrote a partial
  for (int s = 0; s < nsplit; ++s) {
    int l0, h0;
    share(s, l0, h0);
    if (h0 > l0 || s == nsplit - 1) live |= 1u << s;
  }
  float* wts = reinterpret_cast<float*>(sm);  // [nsplit][kRows], over q's slot
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
  const int width = hdv % 4 == 0 ? 4 : 1;  // columns a thread sums at once
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
  if (tid == 0) tickets[group] = 0;  // ready for the next launch
}

}  // namespace prefill

struct Args {
  const void *q, *kx, *kc, *ksc, *pos, *page_table;
  void *out, *ws, *tickets;
  int B, T, C, NB, ps, KVH, G, hd, hdv;
  float scale;
  int decode, nsplit, row_tiles;
};

// The kernel's widths (DK, DV) for hd and hdv, 0 where none holds them.
__host__ inline int tier_of(int hd, int hdv) {
  if (hdv > hd || hd < 1 || hdv < 1) return 0;
  if (hd <= 64) return 1;
  if (hd <= 128) return 2;
  if (hd <= 576 && hdv <= 512) return 3;
  return 0;
}

__host__ inline int dk_of(int tier) { return tier == 1 ? 64 : tier == 2 ? 128 : 576; }

template <int DK, int DV, bool kPaged, typename TC>
int launch(const Args& a, cudaStream_t stream) {
  const size_t bytes = smem_bytes<TC>(DK, a.row_tiles);
  auto kernel = latent_attention_kernel<DK, DV, kPaged, TC>;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int rb = 16 * a.row_tiles;
  const dim3 grid(a.nsplit, (a.T * a.G + rb - 1) / rb, a.B * a.KVH);
  kernel<<<grid, 32 * kSlices * a.row_tiles, bytes, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.kx),
      static_cast<const TC*>(a.kc), static_cast<const float*>(a.ksc),
      static_cast<const int*>(a.pos), static_cast<const int*>(a.page_table),
      static_cast<bf16*>(a.out), static_cast<float*>(a.ws), static_cast<int*>(a.tickets), a.T,
      a.C, a.NB, a.ps, a.KVH, a.G, a.hd, a.hdv, a.scale, a.decode, a.nsplit);
  return static_cast<int>(cudaGetLastError());
}

template <bool kPaged, typename TC>
int by_width(const Args& a, cudaStream_t s) {
  switch (tier_of(a.hd, a.hdv)) {
    case 1: return launch<64, 64, kPaged, TC>(a, s);
    case 2: return launch<128, 128, kPaged, TC>(a, s);
    case 3: return launch<576, 512, kPaged, TC>(a, s);
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

struct PrefillArgs {
  const void *q, *kx, *kc, *ksc, *offs, *page_table;
  void *out, *ws, *tickets;
  int B, T, C, NB, ps, P, KVH, G, hd, hdv;
  float scale;
  int nsplit;
};

template <int DK, int DV, bool kPaged, typename TC>
int launch_prefill(const PrefillArgs& a, cudaStream_t stream) {
  using namespace prefill;
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
        !tensor_map(encode, &tx, a.kx, 4, x_dims, x_box, 2, false) ||
        !tensor_map(encode, &tk, a.kc, 4, k_dims, k_box, sizeof(TC), kCodes))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = latent_prefill_kernel<DK, DV, kPaged, TC>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.nsplit, (a.T * a.G + kRows - 1) / kRows, a.B * a.KVH);
  kernel<<<grid, kThreads, L::kSmem, stream>>>(
      tq, tx, tk, static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.kx),
      static_cast<const TC*>(a.kc), static_cast<const float*>(a.ksc),
      static_cast<const int*>(a.offs), static_cast<const int*>(a.page_table),
      static_cast<bf16*>(a.out), static_cast<float*>(a.ws), static_cast<int*>(a.tickets), a.T,
      a.C, a.NB, a.ps, a.KVH, a.G, a.hd, a.hdv, a.scale * kLog2e, a.nsplit, tma);
  return static_cast<int>(cudaGetLastError());
}

// The prefill kernel's widths: (128, 128) for heads up to 128, else
// (576, 512); 0 where none holds them.
__host__ inline int prefill_dk(int hd, int hdv) {
  if (hdv > hd || hd < 1 || hdv < 1) return 0;
  if (hd <= 128) return 128;
  if (hd <= 576 && hdv <= 512) return 576;
  return 0;
}

template <bool kPaged, typename TC>
int prefill_by_width(const PrefillArgs& a, cudaStream_t s) {
  switch (prefill_dk(a.hd, a.hdv)) {
    case 128: return launch_prefill<128, 128, kPaged, TC>(a, s);
    case 576: return launch_prefill<576, 512, kPaged, TC>(a, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool kPaged>
int prefill_by_cache_type(const PrefillArgs& a, int cache_dtype, cudaStream_t s) {
  switch (cache_dtype) {
    case 1: return prefill_by_width<kPaged, bf16>(a, s);
    case 2: return prefill_by_width<kPaged, int8_t>(a, s);
    case 3: return prefill_by_width<kPaged, __nv_fp8_e4m3>(a, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Decode (decode must be 1: the prefill chunk takes pmt_latent_prefill;
// the decode kernel's prefill branch is a baseline kernel_variants.py
// launches with this check lifted).  q, out: (B, KVH, 1, G, hd / hdv)
// bf16; kx: ignored, may be null; kc: the cache (B, C,
// KVH, hd), or with paged the pools (P, ps, KVH, hd) and page_table (B,
// NB) int32 (C = NB * ps), of cache_dtype 1 = bfloat16, 2 = int8, 3 =
// fp8_e4m3; k_scale: their (rows, KVH) float32 row scales for the codes;
// pos: (B,) int32 lens.  The
// values are the first hdv lanes of the key rows: hdv <= hd, hd <= 576,
// hdv <= 512.  ws: the splits' partials, groups * nsplit * 16 * row_tiles
// * (hdv + 2) float32 for groups = B * KVH * row blocks (unused, may be
// null, with one split); tickets: >= groups int32 that are 0 (and are 0
// again when the kernel ends); nsplit in 1..8; row_tiles 1 or 2.  Returns
// cudaGetLastError().
extern "C" int pmt_latent_attention(const void* q, const void* kx, const void* kc,
                                    const void* k_scale, const void* pos,
                                    const void* page_table, void* out, void* ws, void* tickets,
                                    int B, int T, int C, int NB, int ps, int KVH, int G, int hd,
                                    int hdv, float scale, int decode, int paged,
                                    int cache_dtype, int nsplit, int row_tiles, void* stream) {
  if (B == 0 || T == 0 || KVH == 0 || G == 0) return 0;
  if (nsplit < 1 || nsplit > kMaxSplits || row_tiles < 1 || row_tiles > kMaxRowTiles ||
      tickets == nullptr || (nsplit > 1 && ws == nullptr) || !decode || T != 1 ||
      (paged && page_table == nullptr) ||
      (cache_dtype >= 2 && k_scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,  kx, kc,  k_scale, pos, page_table, out, ws,    tickets, B,
               T,  C,  NB,  ps,      KVH, G,          hd,  hdv,   scale,   decode,
               nsplit, row_tiles};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return paged ? by_cache_type<true>(a, cache_dtype, s) : by_cache_type<false>(a, cache_dtype, s);
}

// The dynamic shared memory a block launches with (0 where the kernel
// takes no such widths): what kernels/latent_attention.py smem_bytes
// must give.
extern "C" int pmt_latent_smem_bytes(int hd, int hdv, int cache_dtype, int row_tiles) {
  const int tier = tier_of(hd, hdv);
  if (!tier) return 0;
  const int DK = dk_of(tier);
  return static_cast<int>(cache_dtype >= 2 ? smem_bytes<int8_t>(DK, row_tiles)
                                           : smem_bytes<bf16>(DK, row_tiles));
}

// The prefill chunk (rows 2v, 8v): q, out: (B, KVH, T, G, hd / hdv) bf16;
// kx: (B, T, KVH, hd) bf16, the chunk's keys; kc: the cache (B, C, KVH,
// hd), or with paged the pools (P, ps, KVH, hd) and page_table (B, NB)
// int32 (C = NB * ps), of cache_dtype 1 = bfloat16, 2 = int8, 3 =
// fp8_e4m3; k_scale: their (rows, KVH) float32 row scales for the codes;
// offs: (B,) int32 chunk offsets.  Every tensor contiguous.  The values
// are the first hdv lanes of the key rows: hdv <= hd, hd <= 576, hdv <=
// 512.  ws: the splits' partials, groups * nsplit * 64 * (hdv + 2)
// float32 for groups = B * KVH * ceil(T * G / 64) (unused, may be null,
// with one split); tickets: >= groups int32 that are 0 (and are 0 again
// when the kernel ends); nsplit in 1..8.  Returns cudaGetLastError().
extern "C" int pmt_latent_prefill(const void* q, const void* kx, const void* kc,
                                  const void* k_scale, const void* offs,
                                  const void* page_table, void* out, void* ws, void* tickets,
                                  int B, int T, int C, int NB, int ps, int P, int KVH, int G,
                                  int hd, int hdv, float scale, int paged, int cache_dtype,
                                  int nsplit, void* stream) {
  if (B == 0 || T == 0 || KVH == 0 || G == 0) return 0;
  if (nsplit < 1 || nsplit > prefill::kMaxSplits || tickets == nullptr ||
      (nsplit > 1 && ws == nullptr) || kx == nullptr ||
      (paged && (page_table == nullptr || P < 1 || ps < 1)) ||
      (cache_dtype >= 2 && k_scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const PrefillArgs a{q,   kx, kc, k_scale, offs, page_table, out, ws,  tickets, B,      T,
                      C,   NB, ps, P,       KVH,  G,          hd,  hdv, scale,   nsplit};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return paged ? prefill_by_cache_type<true>(a, cache_dtype, s)
               : prefill_by_cache_type<false>(a, cache_dtype, s);
}

// The prefill kernel's dynamic shared memory (0 where it takes no such
// widths): what kernels/latent_attention.py prefill_smem_bytes must give.
extern "C" int pmt_latent_prefill_smem_bytes(int hd, int hdv, int cache_dtype) {
  const int dk = prefill_dk(hd, hdv);
  if (!dk) return 0;
  const bool codes = cache_dtype >= 2;
  if (dk == 128)
    return codes ? prefill::Layout<128, true>::kSmem : prefill::Layout<128, false>::kSmem;
  return codes ? prefill::Layout<576, true>::kSmem : prefill::Layout<576, false>::kSmem;
}

// 1 where a prefill launch over these tensors loads by TMA, 0 where its
// producer warp copies (prefill::loads_by_tma): what
// kernels/latent_attention.py loads_by_tma must give.
extern "C" int pmt_latent_prefill_tma(const void* q, const void* kx, const void* kc, int hd,
                                      int ps, int paged, int cache_dtype) {
  return prefill::loads_by_tma(q, kx, kc, hd, cache_dtype >= 2 ? 1 : 2, paged, ps);
}
