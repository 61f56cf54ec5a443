// Length-aware flash-decode: one new query token per row against its
// KV cache, all G query heads of one kv head together.  Two layouts of
// the cache share one kernel, templated on how a logical key position
// becomes an address: a contiguous (B, C, KVH, hd) cache, and physical
// page pools (P, ps, KVH, hd) addressed through a (B, NB) page table.
//
// Replaces the TPU kernels decode_attention_pallas and
// decode_attention_paged_pallas
// (src/repro/kernels/decode_attention/decode_attention.py).  Same
// function: q (B, KVH, G, hd) against the cache with the new token
// already at its slot, valid positions `col <= lens[b]` (a ring cache of
// size C: `(lens[b] - col) mod C <= lens[b]`; a paged cache, which is
// never wrapped, optionally `lens[b] - col < window`), optional logit
// softcap, one online softmax in fp32, output in q's dtype.  The TPU
// kernels walked a sequential grid axis over key blocks (one page per
// block in the paged one) with the running max, sum and accumulator in
// VMEM scratch; here one block per (row, kv head) walks 64-key tiles in
// a loop and keeps them in shared memory.  A paged tile gathers its 64
// keys from as many pages as they span: the block first turns each
// position into its physical row (page_table[b, pos / ps] * ps +
// pos % ps) in shared memory, then loads the rows.
//
// What bounds it on the H100: bytes.  Each key and value is read once
// and used for G (3 for smollm-135m) query heads, about 2 * G flops per
// byte in bf16, far below the ~295 the tensor cores need; the least
// time is the valid cache prefix over 3.35 TB/s.  The design keeps the
// TPU kernels' length-aware property: a row's loop runs from its first
// attendable position (0, or lens[b] - window + 1) to its last,
// min(lens[b], C - 1), so keys outside are never read (a wrapped ring
// reads all C).  It is simple, not fast: B * KVH blocks (24 at B=8)
// leave most of the 132 SMs idle, and the tile loop does not overlap its
// loads with its arithmetic.  Splitting the key range (the pages) over
// several blocks with a combine pass (split-KV) and double-buffered
// asynchronous tile loads are the levers for later.
//
// Quantized caches (int8 or fp8_e4m3 codes, one float32 scale per
// (position, kv head) row, in (B, C, KVH) or, paged, (P, ps, KVH) beside
// the codes) replace the quantized branch of both TPU kernels, which
// dequantized each block in VMEM.  The element type of the cache is a
// template parameter too: the tile loader reads codes at their own width
// (hd 64 is 64 bytes a row, four 16-byte loads), reads the tile's row
// scales through the same row mapping as the codes (a paged tile's
// scales come from the same physical rows), and stages
// float(code) * scale in the shared-memory tile the fp32 online softmax
// reads.  Nothing dequantized is written to device memory.  At one byte
// a value plus four bytes a row, the bytes that bound the kernel shrink
// to ~0.53x of bf16's at hd 64.
//
// A row with no attendable key (only a paged row with a window whose
// position lies past the end of its table by more than the window: a
// dead row of a decode burst) returns 0, as the TPU kernel does; the
// plain blockwise version, which folds every block, returns the mean of
// its values there.
#include "common.cuh"

namespace {

constexpr int kTile = 64;      // keys per tile
constexpr int kThreads = 128;

// Shared memory, in floats: q (G x hd) | k tile (kTile x hd+1) |
// v tile (kTile x hdv) | scores (G x kTile) | acc (G x hdv) | m, l, alpha.
__host__ __device__ inline size_t smem_floats(int G, int hd, int hdv) {
  return (size_t)G * hd + (size_t)kTile * (hd + 1) + (size_t)kTile * hdv +
         (size_t)G * kTile + (size_t)G * hdv + 3 * (size_t)G;
}

// kPaged: k, v are pools (P, ps, KVH, hd) and page_table is (B, NB),
// C = NB * ps; otherwise k, v are (B, C, KVH, hd) and page_table unused.
// A code type TKV (int8_t, __nv_fp8_e4m3) reads ksc, vsc: the row scales
// (rows x KVH, rows counted as k's); other types ignore them.
template <typename TQ, typename TKV, bool kPaged>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                        const TKV* __restrict__ v, const float* __restrict__ ksc,
                        const float* __restrict__ vsc, const int* __restrict__ lens,
                        const int* __restrict__ page_table, TQ* __restrict__ out,
                        int C, int NB, int ps, int KVH, int G, int hd, int hdv,
                        float scale, int ring, int window, float softcap) {
  extern __shared__ float smem[];
  __shared__ int rows[kTile];       // physical rows of a paged tile's keys
  __shared__ float kscl[kTile], vscl[kTile];  // a quantized tile's row scales
  constexpr bool kQuant = pmt::is_code<TKV>::value;
  const int b = blockIdx.x, h = blockIdx.y;
  float* qs = smem;
  float* ks = qs + G * hd;
  float* vs = ks + kTile * (hd + 1);
  float* ps_ = vs + kTile * hdv;
  float* acc = ps_ + G * kTile;
  float* m = acc + G * hdv;
  float* l = m + G;
  float* alpha = l + G;

  const int cur = lens[b];
  // Slots that can hold a valid key: [first, last].  Past `last` every
  // slot is masked (a ring below its size holds positions <= lens[b]).
  const int last = min(cur, C - 1);
  const int first = (!ring && window > 0) ? max(cur - (window - 1), 0) : 0;
  const int end = last + 1;
  const size_t head = (size_t)b * KVH + h;
  for (int i = threadIdx.x; i < G * hd; i += kThreads)
    qs[i] = pmt::to_f(q[head * G * hd + i]) * scale;
  for (int i = threadIdx.x; i < G * hdv; i += kThreads) acc[i] = 0.f;
  for (int i = threadIdx.x; i < G; i += kThreads) {
    m[i] = PMT_NEG_INF;
    l[i] = 0.f;
  }

  // Row r of the tile at `lo` is physical row phys(r) of k and v, counted
  // in (KVH * hd)-element rows from the head's first element.
  const size_t kstride = (size_t)KVH * hd, vstride = (size_t)KVH * hdv;
  const TKV* kh = k + (size_t)h * hd;
  const TKV* vh = v + (size_t)h * hdv;
  const int* pt = kPaged ? page_table + (size_t)b * NB : nullptr;
  const bool kvec = pmt::rows_vec_ok(kh, hd, kstride);
  const bool vvec = pmt::rows_vec_ok(vh, hdv, vstride);
  for (int lo = first; lo < end; lo += kTile) {
    const int n = min(kTile, end - lo);
    __syncthreads();  // previous tile's readers are done with ks/vs/ps/rows
    auto phys = [&](int r) -> size_t {
      if constexpr (kPaged) return (size_t)rows[r];
      else return (size_t)b * C + lo + r;
    };
    if constexpr (kPaged || kQuant) {
      for (int r = threadIdx.x; r < n; r += kThreads) {
        const int pos = lo + r;  // < end <= C, so pos / ps < NB
        if constexpr (kPaged) rows[r] = pt[pos / ps] * ps + pos % ps;
        if constexpr (kQuant) {  // the codes' own rows, paged or not
          const size_t row = kPaged ? (size_t)rows[r] : (size_t)b * C + pos;
          kscl[r] = ksc[row * KVH + h];
          vscl[r] = vsc[row * KVH + h];
        }
      }
      __syncthreads();
    }
    pmt::load_rows<TKV>(ks, [&](int r) { return kh + phys(r) * kstride; }, n, hd, kvec,
                        hd + 1, kscl);
    pmt::load_rows<TKV>(vs, [&](int r) { return vh + phys(r) * vstride; }, n, hdv, vvec,
                        hdv, vscl);
    __syncthreads();
    for (int i = threadIdx.x; i < G * kTile; i += kThreads) {
      const int g = i / kTile, c = i - g * kTile;
      float s = PMT_NEG_INF;
      if (c < n) {
        const float* qr = qs + g * hd;
        const float* kr = ks + c * (hd + 1);
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
        if (softcap > 0.f) dot = tanhf(dot / softcap) * softcap;
        const int col = lo + c;
        const bool valid = ring ? (((cur - col) % C + C) % C) <= cur
                                : col <= cur && (window <= 0 || cur - col < window);
        s = valid ? dot : PMT_NEG_INF;
      }
      ps_[i] = s;
    }
    __syncthreads();
    pmt::softmax_fold(ps_, m, l, alpha, G, kTile, n);
    __syncthreads();
    pmt::pv_fold(ps_, vs, acc, alpha, G, kTile, n, hdv);
  }
  __syncthreads();
  TQ* ob = out + head * G * hdv;
  for (int i = threadIdx.x; i < G * hdv; i += kThreads)
    ob[i] = pmt::from_f<TQ>(acc[i] / fmaxf(l[i / hdv], 1e-30f));
}

struct Args {
  const void *q, *k, *v, *ksc, *vsc, *lens, *page_table;
  void* out;
  int B, C, NB, ps, KVH, G, hd, hdv;
  float scale;
  int ring, window;
  float softcap;
};

template <typename TQ, typename TKV, bool kPaged>
int launch(const Args& a, cudaStream_t stream) {
  const size_t bytes = smem_floats(a.G, a.hd, a.hdv) * sizeof(float);
  auto kernel = decode_attention_kernel<TQ, TKV, kPaged>;
  if (bytes > 48 * 1024) {  // above the default, opt in first
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(a.B, a.KVH), kThreads, bytes, stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k),
      static_cast<const TKV*>(a.v), static_cast<const float*>(a.ksc),
      static_cast<const float*>(a.vsc), static_cast<const int*>(a.lens),
      static_cast<const int*>(a.page_table), static_cast<TQ*>(a.out), a.C, a.NB, a.ps,
      a.KVH, a.G, a.hd, a.hdv, a.scale, a.ring, a.window, a.softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, bool kPaged>
int by_cache_type(const Args& a, int kv_dtype, cudaStream_t s) {
  if (kv_dtype >= 2 && (a.ksc == nullptr || a.vsc == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);  // codes need their scales
  switch (kv_dtype) {
    case 0: return launch<TQ, float, kPaged>(a, s);
    case 1: return launch<TQ, __nv_bfloat16, kPaged>(a, s);
    case 2: return launch<TQ, int8_t, kPaged>(a, s);
    case 3: return launch<TQ, __nv_fp8_e4m3, kPaged>(a, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool kPaged>
int dispatch(const Args& a, int q_dtype, int kv_dtype, void* stream) {
  if (a.B == 0 || a.KVH == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0) return by_cache_type<float, kPaged>(a, kv_dtype, s);
  if (q_dtype == 1) return by_cache_type<__nv_bfloat16, kPaged>(a, kv_dtype, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, out: (B, KVH, G, hd/hdv) of q_dtype; k, v: (B, C, KVH, hd/hdv) of
// kv_dtype; k_scale, v_scale: (B, C, KVH) float32 for the code types,
// else ignored (may be null); lens: (B,) int32.  dtype codes: 0 =
// float32, 1 = bfloat16, 2 = int8, 3 = fp8_e4m3 (q: 0 or 1).  softcap
// <= 0 means no softcap.  Returns cudaGetLastError().
extern "C" int pmt_decode_attention(const void* q, const void* k, const void* v,
                                    const void* k_scale, const void* v_scale,
                                    const void* lens, void* out, int B, int C, int KVH,
                                    int G, int hd, int hdv, float scale, int ring,
                                    float softcap, int q_dtype, int kv_dtype,
                                    void* stream) {
  const Args a{q, k, v, k_scale, v_scale, lens, nullptr, out, B, C, 1, C, KVH, G, hd, hdv,
               scale, ring, 0, softcap};
  return dispatch<false>(a, q_dtype, kv_dtype, stream);
}

// q, out as above; k_pool, v_pool: (P, ps, KVH, hd/hdv) of kv_dtype;
// k_scale, v_scale: (P, ps, KVH) float32 pools for the code types;
// page_table: (B, NB) int32, every entry a page of the pools; lens: (B,)
// int32.  window <= 0 and softcap <= 0 mean none.  Returns
// cudaGetLastError().
extern "C" int pmt_decode_attention_paged(const void* q, const void* k_pool,
                                          const void* v_pool, const void* k_scale,
                                          const void* v_scale, const void* page_table,
                                          const void* lens, void* out, int B, int NB, int ps,
                                          int KVH, int G, int hd, int hdv, float scale,
                                          int window, float softcap, int q_dtype,
                                          int kv_dtype, void* stream) {
  const Args a{q,  k_pool, v_pool, k_scale, v_scale, lens, page_table, out, B, NB * ps, NB,
               ps, KVH,    G,      hd,      hdv,     scale, 0,          window, softcap};
  return dispatch<true>(a, q_dtype, kv_dtype, stream);
}
