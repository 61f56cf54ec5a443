// Flash attention, forward: q (BH, Sq, hd) against k, v (BKVH, Skv, hd),
// blockwise online softmax with causal and sliding-window masks and tanh
// soft-capping; the train path's full-sequence attention.
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention/flash_attention.py).  Same
// function: q scaled and multiplied with k in fp32; softcap, then the
// masks `row >= col` (causal) and `row - col < window`, a masked key
// weighing 0; running max m, sum l and accumulator acc in fp32, p kept in
// fp32 (the Pallas kernel does not round it to bf16; the plain oracle
// does); output acc / max(l, 1e-30) in q's dtype.  GQA reads kv head
// bh / (BH / BKVH) in place, with no repeat in memory.  The TPU kernel
// walked a sequential kv grid axis with the state in VMEM and needed
// Sq and Skv to be multiples of its blocks (it leaves rows unwritten
// otherwise); here one block per (bh, tile of 64 query rows) loops over
// 64-key tiles, keeps m and l in registers and masks ragged tiles, so
// any Sq and Skv work.
//
// What bounds it on the H100: at the train path's shapes (B 8, S 2048,
// 9 query heads on 3 kv heads, hd 64, causal) one call does 4 * B * H *
// hd * S(S+1)/2 ~ 38.7 GFLOP on 50 MB, ~770 flops per byte, so
// operations bound it: 0.039 ms at the bf16 tensor cores' 989 TFLOP/s.
// This first design does its products on the CUDA cores in fp32 (a
// ceiling of ~67 TFLOP/s, ~0.58 ms): each thread of 256 owns 4 query
// rows and, in turn, 4 key columns of the 64 x 64 score tile and hd/16
// output columns, reading q and k rows from shared memory as float4
// (8 loads per 64 FMAs), so shared memory keeps pace with the FMAs.
// Like the Pallas kernel it skips the key tiles that lie wholly above
// the diagonal or wholly outside the window: they are never loaded, and
// the heaviest (last) query tiles are scheduled first.  Tensor-core
// (wgmma) tiles fed by TMA, and a backward kernel, are the levers for
// later.
#include "common.cuh"

namespace {

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

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int group, int Sq,
                       int Skv, float scale, int causal, int window, float softcap) {
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
  const T* qb = q + ((size_t)bh * Sq + q_lo) * HD;
  const T* kb = k + (size_t)(bh / group) * Skv * HD;
  const T* vb = v + (size_t)(bh / group) * Skv * HD;

  // The keys some row of this block can attend: none past the last row
  // (causal), none at or before first row - window (window).
  int k_begin = 0, k_end = Skv;
  if (causal) k_end = min(Skv, q_lo + nq);
  if (window > 0) k_begin = max(0, q_lo - (window - 1));

  pmt::load_rows<T>(qs, [=](int r) { return qb + (size_t)r * HD; }, nq, HD,
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
    pmt::load_rows<T>(ks, [=](int r) { return kb + (size_t)(lo + r) * HD; }, n, HD, kvec,
                      L::kQP);
    pmt::load_rows<T>(vs, [=](int r) { return vb + (size_t)(lo + r) * HD; }, n, HD, vvec,
                      HD);
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
    T* orow = out + ((size_t)bh * Sq + q_lo + r) * HD + tx * DV;
#pragma unroll
    for (int u = 0; u < DV; ++u) orow[u] = pmt::from_f<T>(o[i][u] / denom);
  }
}

struct Args {
  const void *q, *k, *v;
  void* out;
  int BH, BKVH, Sq, Skv;
  float scale;
  int causal, window;
  float softcap;
};

template <typename T, int HD>
int launch(const Args& a, cudaStream_t stream) {
  const size_t bytes = Layout<HD>::kFloats * sizeof(float);
  auto kernel = flash_attention_kernel<T, HD>;
  if (bytes > 48 * 1024) {  // above the default, opt in first
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.BH);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.out), a.BH / a.BKVH, a.Sq, a.Skv, a.scale, a.causal, a.window,
      a.softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_width(const Args& a, int hd, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(a, s);
    case 32: return launch<T, 32>(a, s);
    case 64: return launch<T, 64>(a, s);
    case 128: return launch<T, 128>(a, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, out: (BH, Sq, hd); k, v: (BKVH, Skv, hd); BH a multiple of BKVH;
// hd 16, 32, 64 or 128; dtype 0 = float32, 1 = bfloat16.  window <= 0
// and softcap <= 0 mean none.  Returns cudaGetLastError().
extern "C" int pmt_flash_attention(const void* q, const void* k, const void* v, void* out,
                                   int BH, int BKVH, int Sq, int Skv, int hd, float scale,
                                   int causal, int window, float softcap, int dtype,
                                   void* stream) {
  if (BH == 0 || Sq == 0) return 0;
  if (BKVH <= 0 || BH % BKVH) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, out, BH, BKVH, Sq, Skv, scale, causal, window, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return by_width<float>(a, hd, s);
  if (dtype == 1) return by_width<__nv_bfloat16>(a, hd, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
