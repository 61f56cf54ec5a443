// Per-row KV-cache scatter: cache[b, slots[b], :] = src[b, :] in place.
//
// Replaces the TPU kernel cache_update_pallas
// (src/repro/kernels/cache_update/cache_update.py), which aliased the
// cache to its output and wrote one (1, 1, F) block per batch row.
//
// What bounds it on the H100: nothing the card computes.  A decode step
// moves B * F elements per call (8 rows of 192 bf16 for smollm-135m,
// about 3 KB), which the memory system moves in well under a
// microsecond; the launch itself costs more, and the serve path makes
// two calls (k and v) per layer per decode step.  The design keeps the
// launch as light as it can be: one block per row, each thread moving
// 16 bytes at a time when the row size and both pointers allow it, the
// slot read by the block itself from device memory (no host sync), and
// the cache never copied.  Fusing the k and v scatters, or the scatter
// into the projection that produces the row, is the lever for later.
#include "common.cuh"

namespace {

__global__ void scatter_rows_kernel(char* __restrict__ cache,
                                    const char* __restrict__ src,
                                    const int* __restrict__ slots, int C,
                                    long long row_bytes, int vec16) {
  const int b = blockIdx.x;
  int s = slots[b];
  // Clamp like the reference's dynamic_update_slice: an out-of-range
  // slot writes the nearest row instead of memory outside the cache.
  s = s < 0 ? 0 : (s >= C ? C - 1 : s);
  char* dst = cache + ((long long)b * C + s) * row_bytes;
  const char* from = src + (long long)b * row_bytes;
  if (vec16) {
    const int4* f4 = reinterpret_cast<const int4*>(from);
    int4* d4 = reinterpret_cast<int4*>(dst);
    for (long long i = threadIdx.x; i < row_bytes / 16; i += blockDim.x) d4[i] = f4[i];
  } else {
    for (long long i = threadIdx.x; i < row_bytes; i += blockDim.x) dst[i] = from[i];
  }
}

}  // namespace

// cache: (B, C, F) elements of row_bytes / F bytes; src: (B, F); slots: (B,)
// int32, all on the device.  Returns cudaGetLastError() after the launch.
extern "C" int pmt_cache_update(void* cache, const void* src, const void* slots,
                                int B, int C, long long row_bytes, void* stream) {
  if (B == 0 || row_bytes == 0) return 0;
  const int vec16 = row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(cache) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(src) % 16 == 0;
  const long long units = vec16 ? row_bytes / 16 : row_bytes;
  const int threads = units >= 256 ? 256 : (units <= 32 ? 32 : (int)((units + 31) / 32) * 32);
  scatter_rows_kernel<<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<char*>(cache), static_cast<const char*>(src),
      static_cast<const int*>(slots), C, row_bytes, vec16);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Paged scatter: row t of src[b] lands at logical position
// pos = min(starts[b] + t, NB * ps - 1) of row b's paged cache, i.e. at
// physical row page_table[b, pos / ps] * ps + pos % ps of the pool, for
// t < valids[b].
//
// Replaces the TPU kernel paged_cache_update_pallas
// (src/repro/kernels/cache_update/cache_update.py), whose out index map
// read the page table from scalar prefetch and routed masked rows to the
// scratch page 0.  Here a masked row is not written at all: the scratch
// page's content is undefined by contract, and no masked write can reach
// a real page.  The clamp of pos to the table's last slot is the TPU
// kernel's: rows that keep decoding past the end of their table (dead
// rows in a device-side decode burst) write the last slot instead of
// reading the page table out of bounds (a negative position, which the
// engine never makes, clamps to 0).  Page ids are the caller's to keep
// inside the pool.
//
// What bounds it on the H100: as for the contiguous scatter, nothing the
// card computes; a decode step writes B rows of KVH * hd elements per
// pool and the launch costs more than the bytes.  One block per (t, b)
// row, 16-byte moves where the row size and pointers allow.  One launch
// for k and v together is the lever for later.
namespace {

__global__ void paged_scatter_kernel(char* __restrict__ pool, const char* __restrict__ src,
                                     const int* __restrict__ page_table,
                                     const int* __restrict__ starts,
                                     const int* __restrict__ valids, int T, int NB, int ps,
                                     long long row_bytes, int vec16) {
  const int t = blockIdx.x, b = blockIdx.y;
  if (t >= valids[b]) return;  // masked: never touches a page
  const int cap = NB * ps - 1;
  int pos = starts[b] + t;
  pos = pos < 0 ? 0 : (pos > cap ? cap : pos);
  const long long row = (long long)page_table[(long long)b * NB + pos / ps] * ps + pos % ps;
  char* dst = pool + row * row_bytes;
  const char* from = src + ((long long)b * T + t) * row_bytes;
  if (vec16) {
    const int4* f4 = reinterpret_cast<const int4*>(from);
    int4* d4 = reinterpret_cast<int4*>(dst);
    for (long long i = threadIdx.x; i < row_bytes / 16; i += blockDim.x) d4[i] = f4[i];
  } else {
    for (long long i = threadIdx.x; i < row_bytes; i += blockDim.x) dst[i] = from[i];
  }
}

}  // namespace

// pool: (P, ps, F) elements of row_bytes / F bytes; src: (B, T, F);
// page_table: (B, NB) int32; starts, valids: (B,) int32; all on the
// device.  Returns cudaGetLastError() after the launch.
extern "C" int pmt_paged_cache_update(void* pool, const void* src, const void* page_table,
                                      const void* starts, const void* valids, int B, int T,
                                      int NB, int ps, long long row_bytes, void* stream) {
  if (B == 0 || T == 0 || row_bytes == 0) return 0;
  const int vec16 = row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(pool) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(src) % 16 == 0;
  const long long units = vec16 ? row_bytes / 16 : row_bytes;
  const int threads = units >= 256 ? 256 : (units <= 32 ? 32 : (int)((units + 31) / 32) * 32);
  paged_scatter_kernel<<<dim3(T, B), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<char*>(pool), static_cast<const char*>(src),
      static_cast<const int*>(page_table), static_cast<const int*>(starts),
      static_cast<const int*>(valids), T, NB, ps, row_bytes, vec16);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Quantizing scatters: each (row, kv head) vector of hd values is
// quantized to codes plus one float32 absmax scale, and both land where
// the scatters above would put the row: at cache[b, slots[b], h] and
// scales[b, slots[b], h] (contiguous), or through the page table into a
// code pool (P, ps, H, D) and a scale pool (P, ps, H) whose pages are
// the code pool's (paged; masked rows t >= valids[b] write nothing).
//
// Replace the TPU kernels quant_cache_update_pallas and
// quant_paged_cache_update_pallas
// (src/repro/kernels/cache_update/cache_update.py), which quantized one
// (H, D) row block per grid step and wrote it through the same index
// maps as the unquantized scatters.
//
// The quantization is the contract of kernels/quant.py, op for op, so
// codes and scales equal the plain versions' bit for bit:
//   amax = max |x| (a warp-shuffle max: exact in any order);
//   s = fmaxf(amax, 1e-8f) * (float)(1.0 / qmax): a multiply by the
//     float32 constant, never a division by qmax;
//   y = x / s, IEEE-rounded (__fdiv_rn; the build has no fast math);
//   int8: rintf (half to even, as torch.round), clip to +-127, cast;
//   fp8_e4m3: clip to +-448, then the round-to-nearest-even conversion
//     (the clip keeps NaN out: e4m3 has no infinity).
//
// What bounds it on the H100: as for the scatters above, nothing the
// card computes; a decode step reads B * H rows of D values and writes
// as many codes and B * H scales, a few KB, and the launch costs more.
// One warp per (row, head) vector (2 values a lane at D = 64), four to
// a block; each lane reads its values twice (amax, then quantize), the
// second time from L1.  Fusing the k and v scatters into one launch is
// the lever for later.
namespace {

template <typename TC> __device__ __forceinline__ float qmax_of();
template <> __device__ __forceinline__ float qmax_of<int8_t>() { return 127.f; }
template <> __device__ __forceinline__ float qmax_of<__nv_fp8_e4m3>() { return 448.f; }

template <typename TC> __device__ __forceinline__ TC encode(float y);
template <> __device__ __forceinline__ int8_t encode<int8_t>(float y) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(y), -127.f), 127.f));
}
template <> __device__ __forceinline__ __nv_fp8_e4m3 encode<__nv_fp8_e4m3>(float y) {
  __nv_fp8_e4m3 c;
  c.__x = __nv_cvt_float_to_fp8(fminf(fmaxf(y, -448.f), 448.f), __NV_SATFINITE, __NV_E4M3);
  return c;
}

// One warp quantizes one vector of D values: all 32 lanes take part.
template <typename TIN, typename TC>
__device__ __forceinline__ void quantize_row(const TIN* __restrict__ x, TC* __restrict__ codes,
                                             float* __restrict__ scale, int D) {
  const int lane = threadIdx.x & 31;
  float amax = 0.f;
  for (int d = lane; d < D; d += 32) amax = fmaxf(amax, fabsf(pmt::to_f(x[d])));
  amax = pmt::warp_max(amax);
  const float inv = static_cast<float>(1.0 / static_cast<double>(qmax_of<TC>()));
  const float s = fmaxf(amax, 1e-8f) * inv;
  for (int d = lane; d < D; d += 32) codes[d] = encode<TC>(__fdiv_rn(pmt::to_f(x[d]), s));
  if (lane == 0) *scale = s;
}

constexpr int kQuantWarps = 4;  // warps (vectors) per block

template <typename TIN, typename TC>
__global__ void __launch_bounds__(32 * kQuantWarps)
quant_scatter_kernel(TC* __restrict__ cache, float* __restrict__ scales,
                     const TIN* __restrict__ src, const int* __restrict__ slots, int B, int C,
                     int H, int D) {
  const int w = blockIdx.x * kQuantWarps + (threadIdx.x >> 5);
  if (w >= B * H) return;  // a whole warp leaves together
  const int b = w / H, h = w - b * H;
  int s = slots[b];
  s = s < 0 ? 0 : (s >= C ? C - 1 : s);  // clamp, as the scatter above
  const size_t row = ((size_t)b * C + s) * H + h;
  quantize_row<TIN, TC>(src + ((size_t)b * H + h) * D, cache + row * D, scales + row, D);
}

template <typename TIN, typename TC>
__global__ void __launch_bounds__(32 * kQuantWarps)
quant_paged_scatter_kernel(TC* __restrict__ pool, float* __restrict__ scales,
                           const TIN* __restrict__ src, const int* __restrict__ page_table,
                           const int* __restrict__ starts, const int* __restrict__ valids,
                           int B, int T, int NB, int ps, int H, int D) {
  const int w = blockIdx.x * kQuantWarps + (threadIdx.x >> 5);
  if (w >= B * T * H) return;
  const int b = w / (T * H), rem = w - b * T * H;
  const int t = rem / H, h = rem - t * H;
  if (t >= valids[b]) return;  // masked: never touches a page
  const int cap = NB * ps - 1;
  int pos = starts[b] + t;
  pos = pos < 0 ? 0 : (pos > cap ? cap : pos);
  const size_t prow = (size_t)page_table[(size_t)b * NB + pos / ps] * ps + pos % ps;
  const size_t row = prow * H + h;
  quantize_row<TIN, TC>(src + (((size_t)b * T + t) * H + h) * D, pool + row * D,
                        scales + row, D);
}

struct QuantArgs {
  void *codes, *scales;
  const void *src, *page_table, *starts, *valids;  // page_table: paged only
  const void* slots;                                // contiguous only
  int B, T, C, NB, ps, H, D;
};

template <typename TIN, typename TC, bool kPaged>
int quant_launch(const QuantArgs& a, cudaStream_t stream) {
  const long long vectors = (long long)a.B * a.T * a.H;
  const int blocks = (int)((vectors + kQuantWarps - 1) / kQuantWarps);
  if constexpr (kPaged) {
    quant_paged_scatter_kernel<TIN, TC><<<blocks, 32 * kQuantWarps, 0, stream>>>(
        static_cast<TC*>(a.codes), static_cast<float*>(a.scales),
        static_cast<const TIN*>(a.src), static_cast<const int*>(a.page_table),
        static_cast<const int*>(a.starts), static_cast<const int*>(a.valids), a.B, a.T, a.NB,
        a.ps, a.H, a.D);
  } else {
    quant_scatter_kernel<TIN, TC><<<blocks, 32 * kQuantWarps, 0, stream>>>(
        static_cast<TC*>(a.codes), static_cast<float*>(a.scales),
        static_cast<const TIN*>(a.src), static_cast<const int*>(a.slots), a.B, a.C, a.H,
        a.D);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kPaged>
int quant_dispatch(const QuantArgs& a, int src_dtype, int code_dtype, void* stream) {
  if (a.B == 0 || a.T == 0 || a.H == 0 || a.D == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (src_dtype == 0 && code_dtype == 2) return quant_launch<float, int8_t, kPaged>(a, s);
  if (src_dtype == 0 && code_dtype == 3) return quant_launch<float, __nv_fp8_e4m3, kPaged>(a, s);
  if (src_dtype == 1 && code_dtype == 2)
    return quant_launch<__nv_bfloat16, int8_t, kPaged>(a, s);
  if (src_dtype == 1 && code_dtype == 3)
    return quant_launch<__nv_bfloat16, __nv_fp8_e4m3, kPaged>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// cache: (B, C, H, D) codes of code_dtype (2 = int8, 3 = fp8_e4m3);
// scales: (B, C, H) float32; src: (B, H, D) of src_dtype (0 = float32,
// 1 = bfloat16); slots: (B,) int32; all on the device.  Returns
// cudaGetLastError() after the launch.
extern "C" int pmt_quant_cache_update(void* cache, void* scales, const void* src,
                                      const void* slots, int B, int C, int H, int D,
                                      int src_dtype, int code_dtype, void* stream) {
  const QuantArgs a{cache, scales, src, nullptr, nullptr, nullptr, slots, B, 1, C, 1, 1, H, D};
  return quant_dispatch<false>(a, src_dtype, code_dtype, stream);
}

// pool: (P, ps, H, D) codes of code_dtype; scales: (P, ps, H) float32;
// src: (B, T, H, D) of src_dtype; page_table: (B, NB) int32; starts,
// valids: (B,) int32; all on the device.  Returns cudaGetLastError().
extern "C" int pmt_quant_paged_cache_update(void* pool, void* scales, const void* src,
                                            const void* page_table, const void* starts,
                                            const void* valids, int B, int T, int NB, int ps,
                                            int H, int D, int src_dtype, int code_dtype,
                                            void* stream) {
  const QuantArgs a{pool,   scales, src, page_table, starts, valids, nullptr,
                    B,      T,      0,   NB,         ps,     H,      D};
  return quant_dispatch<true>(a, src_dtype, code_dtype, stream);
}
