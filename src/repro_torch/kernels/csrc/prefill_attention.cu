// Chunked-prefill attention: T chunk queries at positions offs[b] + t
// attend the cache prefix (positions < offs[b]) and their own causal
// keys in one online softmax.
//
// Replaces the TPU kernel prefill_attention_pallas
// (src/repro/kernels/prefill_attention/prefill_attention.py).  Same
// function: q packed (B, KVH, T, G, hd) so that the G query heads of a
// kv head share each key; phase 1 folds the cache k/v (B, C, KVH, hd)
// slots below min(offs[b], C) (a ring cache of size C maps slot s to
// position (offs-1) - ((offs-1-s) mod C) and masks positions outside
// the window), phase 2 the chunk's own k/v (B, T, KVH, hd) with
// `t >= col` (and `t - col < window`); softcap optional; fp32 softmax;
// output in q's dtype.  The TPU kernel walked one sequential grid axis
// over both phases with the running state in VMEM; here one block per
// (row, kv head, tile of 16 packed query rows) loops over the key
// tiles of both phases and keeps the state in shared memory.
//
// What bounds it on the H100: at the serve path's shapes (a 32-token
// chunk, 3 query heads per kv head, prefixes up to ~1k) each key tile
// is used by 96 query rows, ~0.1k flops per byte, still below the
// ~295 flops per byte the bf16 tensor cores need, so bytes bound it in
// principle; but this first kernel computes its dot products on the
// CUDA cores in fp32, which caps it near 67 TFLOP/s, and at batch 1 it
// has only KVH * ceil(T * G / 16) blocks (18 for smollm-135m), so in
// practice it is latency-bound.  The design keeps the TPU kernel's
// property that cache tiles past a row's prefix are never read, and
// skips chunk tiles that lie wholly above the block's last query.
// Tensor-core (wgmma/mma) tiles and splitting the prefix over more
// blocks are the levers for later.
#include "common.cuh"

namespace {

constexpr int kRows = 16;     // packed (t, g) query rows per block
constexpr int kTile = 64;     // keys per tile
constexpr int kThreads = 128;

// Shared memory, in floats: q (kRows x hd) | k tile (kTile x hd+1) |
// v tile (kTile x hdv) | scores (kRows x kTile) | acc (kRows x hdv) |
// m, l, alpha (kRows each).
__host__ __device__ inline size_t smem_floats(int hd, int hdv) {
  return (size_t)kRows * hd + (size_t)kTile * (hd + 1) + (size_t)kTile * hdv +
         (size_t)kRows * kTile + (size_t)kRows * hdv + 3 * (size_t)kRows;
}

template <typename TQ, typename TC>
__global__ void __launch_bounds__(kThreads)
prefill_attention_kernel(const TQ* __restrict__ q, const TQ* __restrict__ kx,
                         const TQ* __restrict__ vx, const TC* __restrict__ kc,
                         const TC* __restrict__ vc, const int* __restrict__ offs,
                         TQ* __restrict__ out, int T, int C, int KVH, int G, int hd,
                         int hdv, float scale, int ring, int window, float softcap) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  const int row0 = blockIdx.z * kRows;
  const int rows_total = T * G;
  const int rows = min(kRows, rows_total - row0);
  float* qs = smem;
  float* ks = qs + kRows * hd;
  float* vs = ks + kTile * (hd + 1);
  float* ps = vs + kTile * hdv;
  float* acc = ps + kRows * kTile;
  float* m = acc + kRows * hdv;
  float* l = m + kRows;
  float* alpha = l + kRows;

  const int off = offs[b];
  const size_t head = (size_t)b * KVH + h;
  const TQ* qb = q + (head * rows_total + row0) * hd;
  for (int i = threadIdx.x; i < kRows * hd; i += kThreads)
    qs[i] = i < rows * hd ? pmt::to_f(qb[i]) * scale : 0.f;
  for (int i = threadIdx.x; i < kRows * hdv; i += kThreads) acc[i] = 0.f;
  for (int i = threadIdx.x; i < kRows; i += kThreads) {
    m[i] = PMT_NEG_INF;
    l[i] = 0.f;
  }

  // Scores of this block's rows against one loaded key tile, masked.
  // phase 1: cache slots lo + c; phase 2: chunk keys lo + c.
  auto scores = [&](int lo, int n, bool cache_phase) {
    for (int i = threadIdx.x; i < kRows * kTile; i += kThreads) {
      const int r = i / kTile, c = i - r * kTile;
      float s = PMT_NEG_INF;
      if (r < rows && c < n) {
        const float* qr = qs + r * hd;
        const float* kr = ks + c * (hd + 1);
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
        if (softcap > 0.f) dot = tanhf(dot / softcap) * softcap;
        const int t = (row0 + r) / G;
        const int col = lo + c;
        bool valid;
        if (cache_phase) {
          const int q_pos = off + t;
          if (ring) {
            const int lastp = off - 1;
            const int pos = lastp - (((lastp - col) % C) + C) % C;
            valid = pos >= 0 && q_pos - pos < window;
          } else {
            valid = col < off && (window <= 0 || q_pos - col < window);
          }
        } else {
          const int diff = t - col;
          valid = diff >= 0 && (window <= 0 || diff < window);
        }
        s = valid ? dot : PMT_NEG_INF;
      }
      ps[i] = s;
    }
  };

  auto fold = [&](int n) {
    __syncthreads();
    pmt::softmax_fold(ps, m, l, alpha, kRows, kTile, n);
    __syncthreads();
    pmt::pv_fold(ps, vs, acc, alpha, kRows, kTile, n, hdv);
  };

  // Phase 1: cache tiles below min(off, C); tiles past it are never read.
  const int limit = min(off, C);
  const TC* kcb = kc + (size_t)b * C * KVH * hd + (size_t)h * hd;
  const TC* vcb = vc + (size_t)b * C * KVH * hdv + (size_t)h * hdv;
  for (int lo = 0; lo < limit; lo += kTile) {
    const int n = min(kTile, C - lo);
    __syncthreads();
    pmt::load_tile(ks, kcb + (size_t)lo * KVH * hd, n, hd, (size_t)KVH * hd, hd + 1);
    pmt::load_tile(vs, vcb + (size_t)lo * KVH * hdv, n, hdv, (size_t)KVH * hdv, hdv);
    __syncthreads();
    scores(lo, n, true);
    fold(n);
  }

  // Phase 2: the chunk's own keys, up to this block's last query (keys
  // past it are masked for every row of the block).
  const int t_max = (row0 + rows - 1) / G;
  const TQ* kxb = kx + (size_t)b * T * KVH * hd + (size_t)h * hd;
  const TQ* vxb = vx + (size_t)b * T * KVH * hdv + (size_t)h * hdv;
  for (int lo = 0; lo <= t_max; lo += kTile) {
    const int n = min(kTile, T - lo);
    __syncthreads();
    pmt::load_tile(ks, kxb + (size_t)lo * KVH * hd, n, hd, (size_t)KVH * hd, hd + 1);
    pmt::load_tile(vs, vxb + (size_t)lo * KVH * hdv, n, hdv, (size_t)KVH * hdv, hdv);
    __syncthreads();
    scores(lo, n, false);
    fold(n);
  }

  __syncthreads();
  TQ* ob = out + (head * rows_total + row0) * hdv;
  for (int i = threadIdx.x; i < rows * hdv; i += kThreads)
    ob[i] = pmt::from_f<TQ>(acc[i] / fmaxf(l[i / hdv], 1e-30f));
}

template <typename TQ, typename TC>
int launch(const void* q, const void* kx, const void* vx, const void* kc, const void* vc,
           const void* offs, void* out, int B, int T, int C, int KVH, int G, int hd, int hdv,
           float scale, int ring, int window, float softcap, cudaStream_t stream) {
  const size_t bytes = smem_floats(hd, hdv) * sizeof(float);
  auto kernel = prefill_attention_kernel<TQ, TC>;
  if (bytes > 48 * 1024) {  // above the default, opt in first
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(B, KVH, (T * G + kRows - 1) / kRows);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TQ*>(kx), static_cast<const TQ*>(vx),
      static_cast<const TC*>(kc), static_cast<const TC*>(vc), static_cast<const int*>(offs),
      static_cast<TQ*>(out), T, C, KVH, G, hd, hdv, scale, ring, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out: (B, KVH, T, G, hd/hdv) and chunk kx, vx: (B, T, KVH, hd/hdv)
// of q_dtype; cache kc, vc: (B, C, KVH, hd/hdv) of cache_dtype; offs:
// (B,) int32.  dtype codes: 0 = float32, 1 = bfloat16.  window <= 0 and
// softcap <= 0 mean none.  Returns cudaGetLastError().
extern "C" int pmt_prefill_attention(const void* q, const void* kx, const void* vx,
                                     const void* kc, const void* vc, const void* offs,
                                     void* out, int B, int T, int C, int KVH, int G, int hd,
                                     int hdv, float scale, int ring, int window,
                                     float softcap, int q_dtype, int cache_dtype,
                                     void* stream) {
  if (B == 0 || T == 0 || KVH == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && cache_dtype == 0)
    return launch<float, float>(q, kx, vx, kc, vc, offs, out, B, T, C, KVH, G, hd, hdv, scale,
                                ring, window, softcap, s);
  if (q_dtype == 0 && cache_dtype == 1)
    return launch<float, __nv_bfloat16>(q, kx, vx, kc, vc, offs, out, B, T, C, KVH, G, hd, hdv,
                                        scale, ring, window, softcap, s);
  if (q_dtype == 1 && cache_dtype == 0)
    return launch<__nv_bfloat16, float>(q, kx, vx, kc, vc, offs, out, B, T, C, KVH, G, hd, hdv,
                                        scale, ring, window, softcap, s);
  if (q_dtype == 1 && cache_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, kx, vx, kc, vc, offs, out, B, T, C, KVH, G,
                                                hd, hdv, scale, ring, window, softcap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
