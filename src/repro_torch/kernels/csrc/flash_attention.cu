// Flash attention, forward: q (BH, Sq, hd) against k, v (BKVH, Skv, hd),
// blockwise online softmax with causal and sliding-window masks and tanh
// soft-capping; the train path's full-sequence attention.
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention/flash_attention.py).  Same
// function: scores q.k * scale in fp32; softcap, then the masks
// `row >= col` (causal) and `row - col < window`, a masked key weighing
// 0; running max m, sum l and accumulator acc in fp32, p kept to fp32
// precision (the Pallas kernel does not round it to bf16; the plain
// oracle does); output acc / max(l, 1e-30) in q's dtype.  GQA reads kv
// head bh / (BH / BKVH) in place, with no repeat in memory.  The TPU
// kernel walked a sequential kv grid axis with the state in VMEM and
// needed Sq and Skv to be multiples of its blocks; here a block loops
// over key tiles, keeps m and l in registers and masks ragged tiles, so
// any Sq and Skv work.  Like the Pallas kernel, both paths below skip
// the key tiles that lie wholly above the diagonal or wholly outside the
// window (they are never loaded; a bf16 warpgroup also skips the loaded
// tiles none of its rows can attend), and the heaviest (last) query
// tiles are scheduled first.
//
// What bounds it on the H100: at the train path's shapes (B 8, S 2048,
// 9 query heads on 3 kv heads, hd 64, causal) one call does 4 * B * H *
// hd * S(S+1)/2 ~ 38.7 GFLOP on 50 MB, ~770 flops per byte, so
// operations bound it: 0.039 ms at the bf16 tensor cores' 989 TFLOP/s.
//
// bf16 (the train path): the tensor cores, fed by TMA.  A block covers
// one (bh, 64 W query rows) with W consumer warpgroups (3 at hd <= 64,
// 2 at hd 128) and one producer warp.  The producer loads the block's q
// rows once and K and V tiles of 64 keys into a ring of four stages in
// shared memory with TMA, each stage guarded by a full/empty mbarrier
// pair.  The tensor maps are 3-D (BKVH, Skv, hd), so a tile past Skv
// reads zeros, never the next head's rows (0 x NaN would be NaN), and a
// box holds at most 128 bytes of a row, swizzled to match the wgmma
// descriptors: hd 64 and 128 at 128 bytes (hd 128 as two 64-column
// boxes), hd 32 at 64, hd 16 at 32.  A consumer warpgroup runs S = q.k^T
// as wgmma m64n64k16 (both operands K-major in shared memory, fp32
// accumulators in registers) and scales S in fp32 after the product (a
// bf16 operand could not carry q * scale unless scale is a power of
// two).  Softcap, masks and the online softmax run on the accumulator
// fragments in the log2 domain (ex2; each thread holds two rows,
// reduced over the four threads of a quad).  O += P.V runs as wgmma with
// P from registers and V from shared memory (MN-major, the transpose
// bit).  P is not rounded once to bf16: each fp32 p is split into bf16
// p_hi + p_lo, and both go through the tensor cores into the same
// accumulator (~2^-17 relative), so the output differs from the fp32
// oracle by about its own bf16 rounding.  A TF32 product would keep only
// 10 bits of p (2^-11) and need V widened to fp32 in shared memory; the
// split costs one more bf16 product at twice TF32's rate.  l sums the
// fp32 p.  The tiles are pipelined inside a warpgroup: tile t's S is
// issued together with tile t-1's P.V, and tile t's softmax runs while
// that P.V is on the tensor cores.  Registers decide the tiling: ptxas
// gives each thread 65,536 / (threads rounded up to warpgroups), 128 at
// three consumers and 168 at two, and setmaxnreg does not raise what it
// allocates, so it is not used.  With 128-key tiles S, p_hi/p_lo and O
// (64 + 64 + 32 registers at hd 64) spilled and ptxas serialised every
// wgmma; with 64-key tiles it does not, and the few bytes still spilled
// (PERF.md) cost less than a third warpgroup gains.
//
// fp32 keeps the CUDA-core loop: on fp32 operands the tensor cores run
// only TF32, which would break the fp32 tolerance (2e-5) that the
// card-against-CPU checks of the train path hold.  Each thread of 256
// owns 4 query rows and, in turn, 4 key columns of a 64 x 64 score tile
// and hd/16 output columns, reading q and k rows from shared memory as
// float4 (8 loads per 64 FMAs).
#include <cuda.h>  // CUtensorMap and its enums; the encoder is reached at run time

#include "common.cuh"
#include "hopper.cuh"

namespace {

// -- fp32: CUDA cores -------------------------------------------------------------

namespace fp32 {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16: ty owns rows ty + 16 i, tx columns
constexpr int kPad = 4;        // row padding in floats: 16-byte aligned rows

template <int HD>
struct Layout {
  static constexpr int kQP = HD + kPad;   // pitch of q and k rows
  static constexpr int kPP = kBK + kPad;  // pitch of probability rows
  // q (kBQ x kQP) | k (kBK x kQP) | v (kBK x HD) | p (kBQ x kPP)
  static constexpr size_t kFloats =
      (size_t)kBQ * kQP + (size_t)kBK * kQP + (size_t)kBK * HD + (size_t)kBQ * kPP;
};

__device__ __forceinline__ float half_warp_max(float x) {
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// N floats at `src` (aligned to their vector width) into `dst`.
template <int N>
__device__ __forceinline__ void load_floats(float (&dst)[N], const float* src) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int u = 0; u < N; u += 4) {
      const float4 x = *reinterpret_cast<const float4*>(src + u);
      dst[u] = x.x; dst[u + 1] = x.y; dst[u + 2] = x.z; dst[u + 3] = x.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int u = 0; u < N; u += 2) {
      const float2 x = *reinterpret_cast<const float2*>(src + u);
      dst[u] = x.x; dst[u + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int u = 0; u < N; ++u) dst[u] = src[u];
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, float* __restrict__ out, int group,
                            int Sq, int Skv, float scale, int causal, int window,
                            float softcap) {
  using L = Layout<HD>;
  constexpr int DV = HD / 16;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kBQ * L::kQP;
  float* vs = ks + kBK * L::kQP;
  float* ps = vs + kBK * HD;

  const int bh = blockIdx.y;
  const int q_lo = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest tiles first
  const int nq = min(kBQ, Sq - q_lo);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* qb = q + ((size_t)bh * Sq + q_lo) * HD;
  const float* kb = k + (size_t)(bh / group) * Skv * HD;
  const float* vb = v + (size_t)(bh / group) * Skv * HD;

  // The keys some row of this block can attend: none past the last row
  // (causal), none at or before first row - window (window).
  int k_begin = 0, k_end = Skv;
  if (causal) k_end = min(Skv, q_lo + nq);
  if (window > 0) k_begin = max(0, q_lo - (window - 1));

  pmt::load_rows<float>(qs, [=](int r) { return qb + (size_t)r * HD; }, nq, HD,
                        pmt::rows_vec_ok(qb, HD, HD), L::kQP);
  __syncthreads();
  for (int i = threadIdx.x; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i - r * HD;
    float* x = qs + r * L::kQP + d;
    *x = r < nq ? *x * scale : 0.f;
  }

  float m[4], l[4], o[4][DV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = PMT_NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int u = 0; u < DV; ++u) o[i][u] = 0.f;
  }
  const bool kvec = pmt::rows_vec_ok(kb, HD, HD);
  const bool vvec = pmt::rows_vec_ok(vb, HD, HD);

  for (int lo = k_begin; lo < k_end; lo += kBK) {
    const int n = min(kBK, k_end - lo);
    __syncthreads();  // the previous tile's readers are done with ks, vs, ps
    pmt::load_rows<float>(ks, [=](int r) { return kb + (size_t)(lo + r) * HD; }, n, HD,
                          kvec, L::kQP);
    pmt::load_rows<float>(vs, [=](int r) { return vb + (size_t)(lo + r) * HD; }, n, HD,
                          vvec, HD);
    for (int i = n * HD + threadIdx.x; i < kBK * HD; i += kThreads) vs[i] = 0.f;
    __syncthreads();

    // Scores of rows ty + 16 i against keys tx + 16 j.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * L::kQP + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * L::kQP + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          s[i][j] = fmaf(qv[i].w, kv[j].w, a);
        }
    }

    // Online softmax of each row; the 16 threads of a row share a half-warp.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q_lo + ty + 16 * i;
      // Masked keys take p = 0 outright, not exp(NEG_INF - m): a row
      // with no key in the tiles so far keeps m = NEG_INF, and would
      // otherwise weigh every masked key 1 (so a row with no key at all
      // comes out as zeros).
      float mx = PMT_NEG_INF;
      unsigned ok_bits = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, col = lo + c;
        float x = s[i][j];
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        const bool ok =
            c < n && (!causal || row >= col) && (window <= 0 || row - col < window);
        s[i][j] = x;
        if (ok) {
          ok_bits |= 1u << j;
          mx = fmaxf(mx, x);
        }
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = (ok_bits >> j) & 1u ? expf(s[i][j] - m_new) : 0.f;
        s[i][j] = p;
        sum += p;
      }
      sum = half_warp_sum(sum);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int u = 0; u < DV; ++u) o[i][u] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[(ty + 16 * i) * L::kPP + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

    // acc += p @ v over the tile's keys (p is 0 and v is 0 past n).
    const int n4 = (n + 3) & ~3;
    for (int c = 0; c < n4; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * L::kPP + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float vv[DV];
        load_floats<DV>(vv, vs + (c + cc) * HD + tx * DV);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = cc == 0 ? pv[i].x : cc == 1 ? pv[i].y : cc == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int u = 0; u < DV; ++u) o[i][u] = fmaf(p, vv[u], o[i][u]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= nq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* orow = out + ((size_t)bh * Sq + q_lo + r) * HD + tx * DV;
#pragma unroll
    for (int u = 0; u < DV; ++u) orow[u] = o[i][u] / denom;
  }
}

}  // namespace fp32

// -- bf16: tensor cores (wgmma) fed by TMA -----------------------------------------

namespace tc {

using namespace pmt::sm90;

constexpr int kBK = 64;     // keys per K/V tile
constexpr int kStages = 4;  // K/V ring depth
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Tiles {
  // Consumer warpgroups of 64 query rows each, and one producer warp.
  static constexpr int kConsumers = HD <= 64 ? 3 : 2;
  static constexpr int kBQ = 64 * kConsumers;         // query rows per block
  static constexpr int kThreads = 128 * kConsumers + 32;
  static constexpr int kBoxCols = HD < 64 ? HD : 64;  // columns of one TMA box
  static constexpr int kRowBytes = 2 * kBoxCols;      // 32, 64 or 128: the swizzle
  static constexpr int kParts = HD / kBoxCols;        // boxes per row: 2 at hd 128
  static constexpr uint32_t kSwizzle = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  static constexpr int kQBytes = 64 * HD * 2;         // one warpgroup's q rows
  static constexpr int kKVBytes = kBK * HD * 2;       // one K or V tile
  // 1 KB of alignment slack | q (kConsumers) | (K, V) x kStages | barriers
  static constexpr int kSmem =
      1024 + kConsumers * kQBytes + 2 * kStages * kKVBytes + 8 * (1 + 2 * kStages);
};

__device__ __forceinline__ float ex2(float x) {  // 2^x; 0 for -inf and below 2^-126
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Where one consumer warpgroup stands: its rows, the thread's two rows
// r0 and r0 + 8 of the accumulator fragments, and in each 8-column block
// of them the columns c0 and c0 + 1.
struct Rows {
  int wg_lo, wg_hi, r0, c0;
};

// Issue S = q . k^T for one tile: K-major operands, 16 columns (32
// bytes) a step, inside one swizzled box and then the next.
template <int HD>
__device__ __forceinline__ void issue_qk(float (&s)[kBK / 2], uint32_t q_wg, uint32_t ks) {
  using T = Tiles<HD>;
  constexpr int RB = T::kRowBytes;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int part = kk / (RB / 32), off = (kk % (RB / 32)) * 32;
    wgmma_ss<kBK>(s, smem_desc(q_wg + part * 64 * RB + off, 16, 8 * RB, T::kSwizzle),
                 smem_desc(ks + part * kBK * RB + off, 16, 8 * RB, T::kSwizzle), kk > 0);
  }
}

// Issue O += p_hi . V + p_lo . V for one tile.  V is MN-major: a step is
// 16 keys (two 8-row swizzle atoms); the second 64 columns of hd 128 lie
// one box on.
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2],
                                         uint32_t (&p_hi)[kBK / 16][4],
                                         uint32_t (&p_lo)[kBK / 16][4], uint32_t vs) {
  using T = Tiles<HD>;
  constexpr int RB = T::kRowBytes;
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    wgmma_rs<HD>(o, p_hi[kk], smem_desc(vs + kk * 16 * RB, kBK * RB, 8 * RB, T::kSwizzle));
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    wgmma_rs<HD>(o, p_lo[kk], smem_desc(vs + kk * 16 * RB, kBK * RB, 8 * RB, T::kSwizzle));
}

// Online softmax of one tile's scores, in place: s becomes p = 2^(x -
// m), x the scaled (and soft-capped) score in log2 units, the scale
// folded into the exponent's FMA where there is no softcap; m2 and l
// (this thread's share of the row sums) move on; alpha gets the factor
// that rescales the accumulator.  With WHOLE every (row, key) pair is
// allowed and the masks are skipped.
template <bool WHOLE>
__device__ __forceinline__ void softmax_tile(float (&s)[kBK / 2], float (&m2)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             const Rows& rw, int lo, int last, float scale,
                                             int causal, int window, float softcap) {
  float mul = scale * kLog2e;  // x = s * mul
  if (softcap > 0.f) {
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) s[i] = tanhf(s[i] * scale / softcap) * softcap * kLog2e;
    mul = 1.f;
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = rw.r0 + 8 * j;
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < kBK / 8; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& x = s[4 * i + 2 * j + c];
        if (!WHOLE) {
          // A masked key weighs 0 outright: 2^(-inf - m) is 0 whatever m
          // is, also NEG_INF for a row with no key yet.
          const int col = lo + 8 * i + rw.c0 + c;
          const bool ok = col <= last && (!causal || row >= col) &&
                          (window <= 0 || row - col < window);
          x = ok ? x : -INFINITY;
        }
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m2[j], mx * mul);
    alpha[j] = ex2(m2[j] - m_new);
    m2[j] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kBK / 8; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float p = ex2(fmaf(s[4 * i + 2 * j + c], mul, -m_new));
        s[4 * i + 2 * j + c] = p;
        sum += p;
      }
    l[j] = alpha[j] * l[j] + sum;
  }
}

// p = p_hi + p_lo, both bf16, as the A fragments of 16-key steps:
// register 2 h + j of step kk holds row r0 + 8 j, keys 8 (2 kk + h) + c0
// and the one after, the score fragments' own places, so no data moves.
__device__ __forceinline__ void split_p(const float (&s)[kBK / 2],
                                        uint32_t (&p_hi)[kBK / 16][4],
                                        uint32_t (&p_lo)[kBK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float a = s[4 * (2 * kk + h) + 2 * j], b = s[4 * (2 * kk + h) + 2 * j + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(a, b);
        const float2 hf = __bfloat1622float2(hi);
        const __nv_bfloat162 rest = __floats2bfloat162_rn(a - hf.x, b - hf.y);
        p_hi[kk][2 * h + j] = *reinterpret_cast<const uint32_t*>(&hi);
        p_lo[kk][2 * h + j] = *reinterpret_cast<const uint32_t*>(&rest);
      }
}

template <int HD>
__global__ void __launch_bounds__(Tiles<HD>::kThreads, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          __nv_bfloat16* __restrict__ out, int group, int Sq, int Skv,
                          float scale, int causal, int window, float softcap) {
  using T = Tiles<HD>;
  constexpr int RB = T::kRowBytes, kConsumers = T::kConsumers, kBQ = T::kBQ;
  extern __shared__ uint8_t smem_raw[];
  // Swizzled tiles start on 1024-byte boundaries (the 128-byte swizzle's
  // period): each is a whole number of KB after this base.
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_s = (raw + 1023) & ~1023u;
  const uint32_t kv_s = q_s + kConsumers * T::kQBytes;  // stage s: K at 2s, V at 2s + 1
  const uint32_t bars = kv_s + 2 * kStages * T::kKVBytes;
  const uint32_t q_full = bars;
  auto full = [&](int t) { return bars + 8 * (1 + t % kStages); };
  auto empty = [&](int t) { return bars + 8 * (1 + kStages + t % kStages); };
  auto k_tile = [&](int t) { return kv_s + 2 * (t % kStages) * T::kKVBytes; };
  auto phase = [](int t) { return static_cast<uint32_t>((t / kStages) & 1); };

  const int bh = blockIdx.y;
  const int q_lo = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest tiles first
  const int q_last = min(q_lo + kBQ, Sq) - 1;
  int k_begin = 0, k_end = Skv;
  if (causal) k_end = min(Skv, q_last + 1);
  if (window > 0) k_begin = max(0, q_lo - (window - 1));
  const int ntiles = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * kConsumers);  // lane 0 of every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= 4 * kConsumers) {
    // Producer: one thread loads q once, then K and V tiles as the ring
    // frees up.
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full, kConsumers * T::kQBytes);
      for (int w = 0; w < kConsumers; ++w)
        for (int p = 0; p < T::kParts; ++p)
          tma_load_3d(q_s + w * T::kQBytes + p * 64 * RB, &tq, p * T::kBoxCols,
                      q_lo + 64 * w, bh, q_full);
      const int kvh = bh / group;
      for (int t = 0; t < ntiles; ++t) {
        mbar_wait(empty(t), phase(t) ^ 1);
        mbar_arrive_expect_tx(full(t), 2 * T::kKVBytes);
        const uint32_t ks = k_tile(t), vs = ks + T::kKVBytes;
        const int lo = k_begin + t * kBK;
        for (int p = 0; p < T::kParts; ++p) {
          tma_load_3d(ks + p * kBK * RB, &tk, p * T::kBoxCols, lo, kvh, full(t));
          tma_load_3d(vs + p * kBK * RB, &tv, p * T::kBoxCols, lo, kvh, full(t));
        }
      }
    }
    return;
  }
  const int wg = warp >> 2;
  Rows rw;
  rw.wg_lo = q_lo + 64 * wg;
  rw.wg_hi = min(rw.wg_lo + 63, q_last);
  rw.r0 = rw.wg_lo + 16 * (warp & 3) + (lane >> 2);
  rw.c0 = 2 * (lane & 3);
  const uint32_t q_wg = q_s + wg * T::kQBytes;
  auto lo_of = [&](int t) { return k_begin + t * kBK; };
  auto last_of = [&](int t) { return min(lo_of(t) + kBK, k_end) - 1; };  // last real key
  // Tiles no row of this warpgroup can attend (also every tile for the
  // rows past Sq of a ragged last block) lie before t_first or after
  // t_last; the warpgroup only releases them.
  auto skip = [&](int t) {
    return rw.wg_lo > q_last || (causal && lo_of(t) > rw.wg_hi) ||
           (window > 0 && rw.wg_lo - last_of(t) >= window);
  };
  int t_first = 0, t_last = ntiles - 1;
  while (t_first < ntiles && skip(t_first)) ++t_first;
  while (t_last >= t_first && skip(t_last)) --t_last;
  auto release = [&](int t) {
    if (lane == 0) mbar_arrive(empty(t));  // this warp is done with the stage
  };

  float o[HD / 2], s[kBK / 2];
  uint32_t p_hi[kBK / 16][4], p_lo[kBK / 16][4];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) s[i] = 0.f;
  float m2[2] = {PMT_NEG_INF, PMT_NEG_INF};  // running max, log2 units
  float l[2] = {0.f, 0.f};                    // this thread's share of the sums
  float alpha[2];
  auto softmax = [&](int t) {
    const int lo = lo_of(t), last = last_of(t);
    // Where every (row, key) pair of the tile is allowed, skip the masks.
    if (last == lo + kBK - 1 && (!causal || lo + kBK - 1 <= rw.wg_lo) &&
        (window <= 0 || rw.wg_hi - lo < window))
      softmax_tile<true>(s, m2, l, alpha, rw, lo, last, scale, causal, window, softcap);
    else
      softmax_tile<false>(s, m2, l, alpha, rw, lo, last, scale, causal, window, softcap);
  };

  mbar_wait(q_full, 0);
  for (int t = 0; t < t_first; ++t) {
    mbar_wait(full(t), phase(t));
    release(t);
  }
  if (t_first <= t_last) {
    // The first tile alone: S, then its softmax (O is still 0).
    mbar_wait(full(t_first), phase(t_first));
    fence_regs(s);
    wgmma_fence();
    issue_qk<HD>(s, q_wg, k_tile(t_first));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    softmax(t_first);
    split_p(s, p_hi, p_lo);
    // Then each next tile's S runs on the tensor cores ahead of the
    // previous tile's P.V, and its softmax while that P.V runs.
    for (int t = t_first + 1; t <= t_last; ++t) {
      mbar_wait(full(t), phase(t));
      fence_regs(s);
      fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        fence_regs(p_hi[kk]);
        fence_regs(p_lo[kk]);
      }
      wgmma_fence();
      issue_qk<HD>(s, q_wg, k_tile(t));
      wgmma_commit();
      issue_pv<HD>(o, p_hi, p_lo, k_tile(t - 1) + T::kKVBytes);
      wgmma_commit();
      wgmma_wait<1>();  // S is in; P.V may still run
      fence_regs(s);
      softmax(t);
      wgmma_wait<0>();
      fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        fence_regs(p_hi[kk]);
        fence_regs(p_lo[kk]);
      }
      release(t - 1);
#pragma unroll
      for (int i = 0; i < HD / 8; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          o[4 * i + 2 * j] *= alpha[j];
          o[4 * i + 2 * j + 1] *= alpha[j];
        }
      split_p(s, p_hi, p_lo);
    }
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      fence_regs(p_hi[kk]);
      fence_regs(p_lo[kk]);
    }
    wgmma_fence();
    issue_pv<HD>(o, p_hi, p_lo, k_tile(t_last) + T::kKVBytes);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    release(t_last);
  }
  for (int t = max(t_last + 1, t_first); t < ntiles; ++t) {
    mbar_wait(full(t), phase(t));
    release(t);
  }

  // out = acc / max(l, 1e-30) for the rows below Sq.
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float sum = l[j];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float denom = fmaxf(sum, 1e-30f);
    const int row = rw.r0 + 8 * j;
    if (row > q_last) continue;
    __nv_bfloat16* orow = out + ((size_t)bh * Sq + row) * HD + rw.c0;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i) =
          __floats2bfloat162_rn(o[4 * i + 2 * j] / denom, o[4 * i + 2 * j + 1] / denom);
  }
}

// The 3-D map (heads, rows, HD) of a contiguous bf16 tensor, read in
// boxes of `box_rows` rows and T::kBoxCols columns, swizzled as the wgmma
// descriptors expect.
template <int HD>
bool tensor_map(EncodeTiled encode, CUtensorMap* map, const void* base, int rows, int heads,
                int box_rows) {
  using T = Tiles<HD>;
  const cuuint64_t dims[3] = {(cuuint64_t)HD, (cuuint64_t)rows, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)HD * 2, (cuuint64_t)rows * HD * 2};
  const cuuint32_t box[3] = {(cuuint32_t)T::kBoxCols, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = T::kRowBytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : T::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                          : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tc

struct Args {
  const void *q, *k, *v;
  void* out;
  int BH, BKVH, Sq, Skv;
  float scale;
  int causal, window;
  float softcap;
};

template <int HD>
int launch_fp32(const Args& a, cudaStream_t stream) {
  const size_t bytes = fp32::Layout<HD>::kFloats * sizeof(float);
  auto kernel = fp32::flash_attention_fp32_kernel<HD>;
  if (bytes > 48 * 1024) {  // above the default, opt in first
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((a.Sq + fp32::kBQ - 1) / fp32::kBQ, a.BH);
  kernel<<<grid, fp32::kThreads, bytes, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.out), a.BH / a.BKVH, a.Sq, a.Skv,
      a.scale, a.causal, a.window, a.softcap);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_bf16(const Args& a, cudaStream_t stream) {
  using T = tc::Tiles<HD>;
  if (a.Skv == 0)  // no key: every row is 0, and a map needs rows
    return static_cast<int>(
        cudaMemsetAsync(a.out, 0, (size_t)a.BH * a.Sq * HD * 2, stream));
  const tc::EncodeTiled encode = tc::encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap tq, tk, tv;
  if (!tc::tensor_map<HD>(encode, &tq, a.q, a.Sq, a.BH, 64) ||
      !tc::tensor_map<HD>(encode, &tk, a.k, a.Skv, a.BKVH, tc::kBK) ||
      !tc::tensor_map<HD>(encode, &tv, a.v, a.Skv, a.BKVH, tc::kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = tc::flash_attention_tc_kernel<HD>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Sq + T::kBQ - 1) / T::kBQ, a.BH);
  kernel<<<grid, T::kThreads, T::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(a.out), a.BH / a.BKVH, a.Sq, a.Skv, a.scale,
      a.causal, a.window, a.softcap);
  return static_cast<int>(cudaGetLastError());
}

template <int (*F16)(const Args&, cudaStream_t), int (*F32)(const Args&, cudaStream_t),
          int (*F64)(const Args&, cudaStream_t), int (*F128)(const Args&, cudaStream_t)>
int by_width(const Args& a, int hd, cudaStream_t s) {
  switch (hd) {
    case 16: return F16(a, s);
    case 32: return F32(a, s);
    case 64: return F64(a, s);
    case 128: return F128(a, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, out: (BH, Sq, hd); k, v: (BKVH, Skv, hd); BH a multiple of BKVH;
// hd 16, 32, 64 or 128; dtype 0 = float32 (CUDA cores), 1 = bfloat16
// (tensor cores; every pointer 16-byte aligned).  window <= 0 and
// softcap <= 0 mean none.  Returns cudaGetLastError().
extern "C" int pmt_flash_attention(const void* q, const void* k, const void* v, void* out,
                                   int BH, int BKVH, int Sq, int Skv, int hd, float scale,
                                   int causal, int window, float softcap, int dtype,
                                   void* stream) {
  if (BH == 0 || Sq == 0) return 0;
  if (BKVH <= 0 || BH % BKVH) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, out, BH, BKVH, Sq, Skv, scale, causal, window, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return by_width<launch_fp32<16>, launch_fp32<32>, launch_fp32<64>, launch_fp32<128>>(
        a, hd, s);
  if (dtype == 1)
    return by_width<launch_bf16<16>, launch_bf16<32>, launch_bf16<64>, launch_bf16<128>>(
        a, hd, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of one bf16 (tensor-core) block at head width hd,
// as launch_bf16 asks for it; -1 for a width the kernel is not built for.
extern "C" int pmt_flash_smem_bytes(int hd) {
  switch (hd) {
    case 16: return tc::Tiles<16>::kSmem;
    case 32: return tc::Tiles<32>::kSmem;
    case 64: return tc::Tiles<64>::kSmem;
    case 128: return tc::Tiles<128>::kSmem;
  }
  return -1;
}
