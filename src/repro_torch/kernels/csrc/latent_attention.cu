// Attention over an aliased latent cache (MLA): the key row is
// [latent | rope], `hd` wide, and the value is its first `hdv` lanes,
// one kv head shared by G query heads (G 128, hd 576, hdv 512 for
// deepseek-v3 at full width).  One kernel serves decode (one query token
// a row, the new token already in the cache) and the prefill chunk (T
// query tokens over the cache prefix and their own causal keys), over a
// contiguous (B, C, KVH, hd) cache or (P, ps, KVH, hd) page pools read
// through a (B, NB) page table, in bf16 or over int8 / fp8_e4m3 codes
// with one float32 scale a row.
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
// What bounds it on the H100: operations.  Every query head of a row
// shares the one latent row, so a decode step at B8 C1024 reads 9.4 MB of
// cache (2.8 us at 3.35 TB/s) for 2.28 GFLOP of products (2.3 us on the
// bf16 tensor cores, 34 us on the fp32 CUDA cores).  The design:
//
//  * Tensor cores over packed heads.  The T * G query rows of a (row, kv
//    head) are the M dimension of mma.sync m16n8k16 (bf16 in, fp32
//    accumulate), 16 rows a row tile, as the tensor-core prefill kernel
//    packs T * G rows (prefill_attention.cu); a decode step is the same
//    with T = 1.  A block takes one or two row tiles and stages each key
//    tile once for all of them.
//  * The aliased tile staged once.  A tile of 32 key rows, hd wide, lands
//    by 16-byte cp.async in a ring of three; the value fragments are read
//    from the same rows (ldmatrix .trans over its first hdv columns).
//  * hdv split over warps.  A 16 x 512 fp32 accumulator is 256 registers
//    a thread on one warp, so four warps share a row tile, each holding
//    a quarter of the value columns (64 registers at hdv 512).  The four
//    also split the score's depth: each forms the partial q . k^T over a
//    quarter of hd's 16-wide steps, the partials meet in shared memory,
//    and every warp adds them in the same order, so all four hold the
//    same scores, maxima, sums and p, and none computes the whole score.
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
//
// p goes through the tensor cores as bf16 p_hi + p_lo (~16 bits, as in
// the other tensor-core kernels); l sums the fp32 p.  hd and hdv are
// padded with zeros in shared memory to the kernel's widths DK and DV
// (64/64, 128/128 or 576/512); value columns past hdv are neither
// computed nor stored.
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

}  // namespace

// q, out: (B, KVH, T, G, hd / hdv) bf16; kx: (B, T, KVH, hd) bf16, the
// chunk's keys (ignored, may be null, with decode); kc: the cache (B, C,
// KVH, hd), or with paged the pools (P, ps, KVH, hd) and page_table (B,
// NB) int32 (C = NB * ps), of cache_dtype 1 = bfloat16, 2 = int8, 3 =
// fp8_e4m3; k_scale: their (rows, KVH) float32 row scales for the codes;
// pos: (B,) int32, lens with decode (T = 1), else the chunk offsets.  The
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
      tickets == nullptr || (nsplit > 1 && ws == nullptr) || (decode && T != 1) ||
      (!decode && kx == nullptr) || (paged && page_table == nullptr) ||
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
