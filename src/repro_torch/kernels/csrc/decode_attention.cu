// Length-aware flash-decode: one new query token per row against its
// KV cache, all G query heads of one kv head together.
//
// Replaces the TPU kernel decode_attention_pallas
// (src/repro/kernels/decode_attention/decode_attention.py).  Same
// function: q (B, KVH, G, hd) against k/v (B, C, KVH, hd) with the new
// token already at its slot, valid slots `col <= lens[b]` (a ring cache
// of size C: `(lens[b] - col) mod C <= lens[b]`), optional logit
// softcap, one online softmax in fp32, output in q's dtype.  The TPU
// kernel walked a sequential grid axis over key blocks with the running
// max, sum and accumulator in VMEM scratch; here one block per (row,
// kv head) walks the key tiles in a loop and keeps them in shared
// memory.
//
// What bounds it on the H100: bytes.  Each key and value is read once
// and used for G (3 for smollm-135m) query heads, about 2 * G flops per
// byte in bf16, far below the ~295 the tensor cores need; the least
// time is the valid cache prefix over 3.35 TB/s.  The design keeps the
// TPU kernel's length-aware property: a row's loop stops at its last
// valid slot, min(lens[b], C - 1), so slots past a row's fill are never
// read (a wrapped ring reads all C).  It is simple, not fast: B * KVH
// blocks (24 at B=8) leave most of the 132 SMs idle, and the tile loop
// does not overlap its loads with its arithmetic.  Splitting the key
// range over several blocks with a combine pass (split-KV) and
// double-buffered asynchronous tile loads are the levers for later.
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

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                        const TKV* __restrict__ v, const int* __restrict__ lens,
                        TQ* __restrict__ out, int C, int KVH, int G, int hd,
                        int hdv, float scale, int ring, float softcap) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  float* qs = smem;
  float* ks = qs + G * hd;
  float* vs = ks + kTile * (hd + 1);
  float* ps = vs + kTile * hdv;
  float* acc = ps + G * kTile;
  float* m = acc + G * hdv;
  float* l = m + G;
  float* alpha = l + G;

  const int cur = lens[b];
  const int last = min(cur, C - 1);  // last slot that can hold a valid key
  const size_t head = (size_t)b * KVH + h;
  for (int i = threadIdx.x; i < G * hd; i += kThreads)
    qs[i] = pmt::to_f(q[head * G * hd + i]) * scale;
  for (int i = threadIdx.x; i < G * hdv; i += kThreads) acc[i] = 0.f;
  for (int i = threadIdx.x; i < G; i += kThreads) {
    m[i] = PMT_NEG_INF;
    l[i] = 0.f;
  }

  const TKV* kb = k + (size_t)b * C * KVH * hd + (size_t)h * hd;
  const TKV* vb = v + (size_t)b * C * KVH * hdv + (size_t)h * hdv;
  for (int lo = 0; lo <= last; lo += kTile) {
    const int n = min(kTile, C - lo);
    __syncthreads();  // previous tile's readers are done with ks/vs/ps
    pmt::load_tile(ks, kb + (size_t)lo * KVH * hd, n, hd, (size_t)KVH * hd, hd + 1);
    pmt::load_tile(vs, vb + (size_t)lo * KVH * hdv, n, hdv, (size_t)KVH * hdv, hdv);
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
        const bool valid = ring ? (((cur - col) % C + C) % C) <= cur : col <= cur;
        s = valid ? dot : PMT_NEG_INF;
      }
      ps[i] = s;
    }
    __syncthreads();
    pmt::softmax_fold(ps, m, l, alpha, G, kTile, n);
    __syncthreads();
    pmt::pv_fold(ps, vs, acc, alpha, G, kTile, n, hdv);
  }
  __syncthreads();
  TQ* ob = out + head * G * hdv;
  for (int i = threadIdx.x; i < G * hdv; i += kThreads)
    ob[i] = pmt::from_f<TQ>(acc[i] / fmaxf(l[i / hdv], 1e-30f));
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, const void* lens, void* out,
           int B, int C, int KVH, int G, int hd, int hdv, float scale, int ring,
           float softcap, cudaStream_t stream) {
  const size_t bytes = smem_floats(G, hd, hdv) * sizeof(float);
  auto kernel = decode_attention_kernel<TQ, TKV>;
  if (bytes > 48 * 1024) {  // above the default, opt in first
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(B, KVH), kThreads, bytes, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      static_cast<const int*>(lens), static_cast<TQ*>(out), C, KVH, G, hd, hdv, scale, ring,
      softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out: (B, KVH, G, hd/hdv) of q_dtype; k, v: (B, C, KVH, hd/hdv) of
// kv_dtype; lens: (B,) int32.  dtype codes: 0 = float32, 1 = bfloat16.
// softcap <= 0 means no softcap.  Returns cudaGetLastError().
extern "C" int pmt_decode_attention(const void* q, const void* k, const void* v,
                                    const void* lens, void* out, int B, int C, int KVH,
                                    int G, int hd, int hdv, float scale, int ring,
                                    float softcap, int q_dtype, int kv_dtype,
                                    void* stream) {
  if (B == 0 || KVH == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0)
    return launch<float, float>(q, k, v, lens, out, B, C, KVH, G, hd, hdv, scale, ring, softcap, s);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch<float, __nv_bfloat16>(q, k, v, lens, out, B, C, KVH, G, hd, hdv, scale, ring,
                                        softcap, s);
  if (q_dtype == 1 && kv_dtype == 0)
    return launch<__nv_bfloat16, float>(q, k, v, lens, out, B, C, KVH, G, hd, hdv, scale, ring,
                                        softcap, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, lens, out, B, C, KVH, G, hd, hdv,
                                                scale, ring, softcap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
