// Chunked-prefill attention: T chunk queries at positions offs[b] + t
// attend the cache prefix (positions < offs[b]) and their own causal
// keys in one online softmax.  Two layouts of the cache share one
// kernel, templated on how a logical key position becomes an address: a
// contiguous (B, C, KVH, hd) cache, and physical page pools
// (P, ps, KVH, hd) addressed through a (B, NB) page table.
//
// Replaces the TPU kernels prefill_attention_pallas and
// prefill_attention_paged_pallas
// (src/repro/kernels/prefill_attention/prefill_attention.py).  Same
// function: q packed (B, KVH, T, G, hd) so that the G query heads of a
// kv head share each key; phase 1 folds the cache's positions below
// min(offs[b], C) (a ring cache of size C maps slot s to position
// (offs-1) - ((offs-1-s) mod C) and masks positions outside the window;
// an unwrapped cache, contiguous or paged, masks q_pos - col >= window
// when a window is given), phase 2 the chunk's own k/v (B, T, KVH, hd)
// with `t >= col` (and `t - col < window`); softcap optional; fp32
// softmax; output in q's dtype.  The TPU kernels walked one sequential
// grid axis over both phases (one page per cache step in the paged one)
// with the running state in VMEM; here one block per (row, kv head, tile
// of 16 packed query rows) loops over the 64-key tiles of both phases
// and keeps the state in shared memory.  A paged tile gathers its keys
// from as many pages as they span: the block first turns each position
// into its physical row (page_table[b, pos / ps] * ps + pos % ps) in
// shared memory, then loads the rows.
//
// Quantized caches (int8 or fp8_e4m3 codes with one float32 scale per
// (position, kv head) row beside them) replace the quantized branch of
// both TPU kernels.  Only the cache prefix holds codes: the chunk's own
// k/v arrive at q's precision.  Phase 1's tile loader reads the codes at
// their own width and the tile's row scales through the same row
// mapping (for a paged tile, the same physical rows), and stages
// float(code) * scale in shared memory; nothing dequantized goes to
// device memory.
//
// What bounds it on the H100: at the serve path's shapes (a 32-token
// chunk, 3 query heads per kv head, prefixes up to ~1k) each key tile
// is used by 96 query rows, ~0.1k flops per byte, still below the
// ~295 flops per byte the bf16 tensor cores need, so bytes bound it in
// principle; but this first kernel computes its dot products on the
// CUDA cores in fp32, which caps it near 67 TFLOP/s, and it has only
// B * KVH * ceil(T * G / 16) blocks (18 per batch row for smollm-135m),
// so in practice it is latency-bound.  The design keeps the TPU kernels'
// property that cache positions outside a row's attendable range
// (at or past offs[b]; with a window on an unwrapped cache, below
// offs[b] - window + 1) are never read, and skips chunk tiles that lie
// wholly above the block's last query.  Tensor-core (wgmma/mma) tiles
// and splitting the prefix over more blocks are the levers for later.
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

// kPaged: kc, vc are pools (P, ps, KVH, hd) and page_table is (B, NB),
// C = NB * ps; otherwise kc, vc are (B, C, KVH, hd) and page_table unused.
// A code type TC (int8_t, __nv_fp8_e4m3) reads ksc, vsc: the cache's row
// scales (rows x KVH, rows counted as kc's); other types ignore them.
template <typename TQ, typename TC, bool kPaged>
__global__ void __launch_bounds__(kThreads)
prefill_attention_kernel(const TQ* __restrict__ q, const TQ* __restrict__ kx,
                         const TQ* __restrict__ vx, const TC* __restrict__ kc,
                         const TC* __restrict__ vc, const float* __restrict__ ksc,
                         const float* __restrict__ vsc, const int* __restrict__ offs,
                         const int* __restrict__ page_table, TQ* __restrict__ out, int T,
                         int C, int NB, int ps, int KVH, int G, int hd, int hdv,
                         float scale, int ring, int window, float softcap) {
  extern __shared__ float smem[];
  __shared__ int rows_[kTile];  // physical rows of a paged tile's keys
  __shared__ float kscl[kTile], vscl[kTile];  // a quantized tile's row scales
  constexpr bool kQuant = pmt::is_code<TC>::value;
  const int b = blockIdx.x, h = blockIdx.y;
  const int row0 = blockIdx.z * kRows;
  const int rows_total = T * G;
  const int rows = min(kRows, rows_total - row0);
  float* qs = smem;
  float* ks = qs + kRows * hd;
  float* vs = ks + kTile * (hd + 1);
  float* ps_ = vs + kTile * hdv;
  float* acc = ps_ + kRows * kTile;
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
  // phase 1: cache positions lo + c; phase 2: chunk keys lo + c.
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
      ps_[i] = s;
    }
  };

  auto fold = [&](int n) {
    __syncthreads();
    pmt::softmax_fold(ps_, m, l, alpha, kRows, kTile, n);
    __syncthreads();
    pmt::pv_fold(ps_, vs, acc, alpha, kRows, kTile, n, hdv);
  };

  // Phase 1: cache positions in [start, min(off, C)); none outside is
  // read.  Without a ring, positions below off - window + 1 are masked
  // for every query of the chunk (queries sit at off + t, t >= 0).
  const int limit = min(off, C);
  const int start = (!ring && window > 0) ? max(off - (window - 1), 0) : 0;
  const size_t kstride = (size_t)KVH * hd, vstride = (size_t)KVH * hdv;
  const TC* kch = kc + (size_t)h * hd;
  const TC* vch = vc + (size_t)h * hdv;
  const int* pt = kPaged ? page_table + (size_t)b * NB : nullptr;
  const bool kvec = pmt::rows_vec_ok(kch, hd, kstride);
  const bool vvec = pmt::rows_vec_ok(vch, hdv, vstride);
  for (int lo = start; lo < limit; lo += kTile) {
    const int n = min(kTile, limit - lo);
    __syncthreads();  // previous tile's readers are done with ks/vs/ps/rows
    if constexpr (kPaged || kQuant) {
      for (int r = threadIdx.x; r < n; r += kThreads) {
        const int pos = lo + r;  // < limit <= C, so pos / ps < NB
        if constexpr (kPaged) rows_[r] = pt[pos / ps] * ps + pos % ps;
        if constexpr (kQuant) {  // the codes' own rows, paged or not
          const size_t row = kPaged ? (size_t)rows_[r] : (size_t)b * C + pos;
          kscl[r] = ksc[row * KVH + h];
          vscl[r] = vsc[row * KVH + h];
        }
      }
      __syncthreads();
    }
    auto phys = [&](int r) -> size_t {
      if constexpr (kPaged) return (size_t)rows_[r];
      else return (size_t)b * C + lo + r;
    };
    pmt::load_rows<TC>(ks, [&](int r) { return kch + phys(r) * kstride; }, n, hd, kvec,
                       hd + 1, kscl);
    pmt::load_rows<TC>(vs, [&](int r) { return vch + phys(r) * vstride; }, n, hdv, vvec,
                       hdv, vscl);
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

struct Args {
  const void *q, *kx, *vx, *kc, *vc, *ksc, *vsc, *offs, *page_table;
  void* out;
  int B, T, C, NB, ps, KVH, G, hd, hdv;
  float scale;
  int ring, window;
  float softcap;
};

template <typename TQ, typename TC, bool kPaged>
int launch(const Args& a, cudaStream_t stream) {
  const size_t bytes = smem_floats(a.hd, a.hdv) * sizeof(float);
  auto kernel = prefill_attention_kernel<TQ, TC, kPaged>;
  if (bytes > 48 * 1024) {  // above the default, opt in first
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(a.B, a.KVH, (a.T * a.G + kRows - 1) / kRows);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TQ*>(a.kx), static_cast<const TQ*>(a.vx),
      static_cast<const TC*>(a.kc), static_cast<const TC*>(a.vc),
      static_cast<const float*>(a.ksc), static_cast<const float*>(a.vsc),
      static_cast<const int*>(a.offs), static_cast<const int*>(a.page_table),
      static_cast<TQ*>(a.out), a.T, a.C, a.NB, a.ps, a.KVH, a.G, a.hd, a.hdv, a.scale,
      a.ring, a.window, a.softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, bool kPaged>
int by_cache_type(const Args& a, int cache_dtype, cudaStream_t s) {
  if (cache_dtype >= 2 && (a.ksc == nullptr || a.vsc == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);  // codes need their scales
  switch (cache_dtype) {
    case 0: return launch<TQ, float, kPaged>(a, s);
    case 1: return launch<TQ, __nv_bfloat16, kPaged>(a, s);
    case 2: return launch<TQ, int8_t, kPaged>(a, s);
    case 3: return launch<TQ, __nv_fp8_e4m3, kPaged>(a, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool kPaged>
int dispatch(const Args& a, int q_dtype, int cache_dtype, void* stream) {
  if (a.B == 0 || a.T == 0 || a.KVH == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0) return by_cache_type<float, kPaged>(a, cache_dtype, s);
  if (q_dtype == 1) return by_cache_type<__nv_bfloat16, kPaged>(a, cache_dtype, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, out: (B, KVH, T, G, hd/hdv) and chunk kx, vx: (B, T, KVH, hd/hdv)
// of q_dtype; cache kc, vc: (B, C, KVH, hd/hdv) of cache_dtype; k_scale,
// v_scale: (B, C, KVH) float32 for the code types, else ignored (may be
// null); offs: (B,) int32.  dtype codes: 0 = float32, 1 = bfloat16, 2 =
// int8, 3 = fp8_e4m3 (q: 0 or 1).  window <= 0 and softcap <= 0 mean
// none.  Returns cudaGetLastError().
extern "C" int pmt_prefill_attention(const void* q, const void* kx, const void* vx,
                                     const void* kc, const void* vc, const void* k_scale,
                                     const void* v_scale, const void* offs,
                                     void* out, int B, int T, int C, int KVH, int G, int hd,
                                     int hdv, float scale, int ring, int window,
                                     float softcap, int q_dtype, int cache_dtype,
                                     void* stream) {
  const Args a{q,   kx,  vx, kc,  vc, k_scale, v_scale, offs, nullptr, out, B,      T,
               C,   1,   C,  KVH, G,  hd,      hdv,     scale, ring,  window, softcap};
  return dispatch<false>(a, q_dtype, cache_dtype, stream);
}

// q, out, kx, vx, offs as above; k_pool, v_pool: (P, ps, KVH, hd/hdv) of
// cache_dtype; k_scale, v_scale: (P, ps, KVH) float32 pools for the code
// types; page_table: (B, NB) int32, every entry a page of the pools.
// window <= 0 and softcap <= 0 mean none.  Returns cudaGetLastError().
extern "C" int pmt_prefill_attention_paged(const void* q, const void* kx, const void* vx,
                                           const void* k_pool, const void* v_pool,
                                           const void* k_scale, const void* v_scale,
                                           const void* page_table, const void* offs,
                                           void* out, int B, int T, int NB, int ps, int KVH,
                                           int G, int hd, int hdv, float scale, int window,
                                           float softcap, int q_dtype, int cache_dtype,
                                           void* stream) {
  const Args a{q,  kx,  vx,     k_pool, v_pool, k_scale, v_scale, offs,   page_table,
               out, B,   T,      NB * ps, NB,    ps,      KVH,     G,      hd,
               hdv, scale, 0,    window,  softcap};
  return dispatch<true>(a, q_dtype, cache_dtype, stream);
}
