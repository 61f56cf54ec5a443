// The KV-cache scatters: a layer's new k and v rows written in place
// into its caches, contiguous (B, C, ...) or page pools (P, ps, ...)
// through a page table; copied as they are (rows 1 and 4 of PERF.md's
// table) or quantized to codes plus row scales (rows 5 and 6).  One
// launch takes one leaf or two (a layer's k and v), the leaf a grid
// dimension, and the routing of a row to its destination is shared.
#include "common.cuh"

#include <algorithm>

namespace {

// Where row t of batch row b's source lands: a row of the cache or pool
// seen as rows (of elements, or of (H, D) vectors), or -1 for nowhere.
// Both read device memory (no host sync) and run after the thread's
// source load is issued, so the two reads are in flight together.

// Contiguous caches (B, C, ...): row t at slot s + t, s = slots[b]
// clamped to [0, C - T] (dynamic_update_slice's clamp of its start; at
// T = 1 the clamp of the slot to [0, C - 1]: an out-of-range slot writes
// the nearest row, never memory outside the cache).
struct SlotRows {
  const int* slots;
  int C;
  __device__ __forceinline__ long long operator()(int b, int t, int T) const {
    int s = slots[b];
    s = s < 0 ? 0 : (s > C - T ? C - T : s);
    return (long long)b * C + s + t;
  }
};

// Page pools (P, ps, ...): logical position pos = min(starts[b] + t,
// NB * ps - 1) of row b (a negative one, which the engine never makes,
// clamps to 0), i.e. physical row page_table[b, pos / ps] * ps + pos % ps;
// -1 for a masked row, t >= valids[b].  A null `valids` means every one
// of the T rows is valid (a decode step's), so no per-step tensor of
// ones is built for it.  The clamp of pos to the table's last slot is
// the TPU kernels': rows that keep decoding past the end of their table
// (dead rows in a device-side decode burst) write the last slot instead
// of reading the page table out of bounds.  Page ids are the caller's to
// keep inside the pool.
struct PageRows {
  const int *page_table, *starts, *valids;
  int NB, ps;
  __device__ __forceinline__ long long operator()(int b, int t, int) const {
    if (valids && t >= valids[b]) return -1;  // masked: never touches a page
    const int cap = NB * ps - 1;
    int pos = starts[b] + t;
    pos = pos < 0 ? 0 : (pos > cap ? cap : pos);
    return (long long)page_table[(long long)b * NB + pos / ps] * ps + pos % ps;
  }
};

// ---------------------------------------------------------------------------
// Copying scatters (rows 1 and 4): row t of src[b] lands, as it is, where
// SlotRows (T = 1) or PageRows routes it.
//
// Replace the TPU kernels cache_update_pallas and
// paged_cache_update_pallas (src/repro/kernels/cache_update/cache_update.py),
// which aliased the cache to the output and wrote one (1, 1, F) row block
// a grid step, the paged one through an out index map that read the page
// table from scalar prefetch and routed masked rows to the scratch page 0.
// Here a masked row is not written at all: the scratch page's content is
// undefined by contract, and no masked write can reach a real page.
//
// What bounds them on the H100: a launch, not bytes.  A decode step of
// smollm-135m moves 8 rows of 192 bf16 (384 B) a leaf, about 6 KB for k
// and v, which 3.35 TB/s moves in ~0.002 us; an empty kernel takes
// 0.00098-0.00100 ms a launch in a CUDA graph, on one block or on the
// pair's grid (chip_smoke.py phase 3, kernel_variants.py; H100 at 700 W),
// and the pair at decode 0.0011-0.0013.  The design spends as few
// launches, and as little of each, as it can:
//   * one launch a layer for k and v (blockIdx.y picks the leaf), where
//     the serve path made two;
//   * a block a row: thread u moves the row's 16-byte unit u (24 units at
//     F 192 in bf16: one warp, 8 lanes idle), and the row is the block's
//     index, so its slot or page lookup is the same for every thread and
//     waits for no per-thread arithmetic;
//   * each thread issues its 16-byte source load before it reads the
//     slot, or valids and the page table: the source address depends on
//     (leaf, row, unit) alone, so the load flies with the lookup;
//   * plain stores, not evict-first ones: the attention kernel reads
//     these rows right after, from L2;
//   * where the row's bytes are not a multiple of 16 or a pointer is off
//     16-byte alignment, the launch takes the element path (a byte a
//     thread), chosen once for the launch.
// Timed and not kept (kernel_variants.py "scatter": a pair call at decode
// / paged decode / paged chunk in a CUDA graph, H100, against this design's
// 0.00129 / 0.00154 / 0.00192 ms): flat packing, thread j moving unit
// j % units of row j / units so that no lane idles, 0.00149 / 0.00169 /
// 0.00203 (64-512 threads within 3% of that): every thread divides by
// the units a row and by T before its lookup can issue; blocks of rows x
// units 0.00149 / 0.00166 / 0.00199; a warp a row, 4 rows a block,
// 0.00133 / 0.00152 / 0.00188 (8 rows: 0.00181 on the chunk), 3% slower
// on the serve path's most frequent call, contiguous decode, 1-2% faster
// on paged rows; a programmatic dependent launch 0.00080 / 0.00109 /
// 0.00131, which overlaps each launch with the previous scatter's tail: a
// neighbour the serve path never gives it (the scatter follows the k/v
// projection, whose kernels do not trigger it), and host-bound event
// loops cannot resolve it.
constexpr int kCopyThreads = 128;  // a block's threads, at most (wider rows loop)

struct CopyLeaf {
  char* dst;        // the cache or pool, as rows of the row's bytes
  const char* src;  // (B, T) rows, contiguous
};

struct CopyLaunch {
  CopyLeaf k, v;  // v is k again for one leaf
  int T;
  int units;      // units a row: 16 bytes each (kVec), else one byte
};

template <bool kVec, typename Rows>
__global__ void __launch_bounds__(kCopyThreads)
    copy_scatter_kernel(CopyLaunch a, Rows rows) {
  using Unit = typename std::conditional<kVec, int4, char>::type;
  const CopyLeaf leaf = blockIdx.y ? a.v : a.k;
  const int r = blockIdx.x, b = r / a.T;  // source row b * T + t
  const int u = threadIdx.x;
  const Unit* from = reinterpret_cast<const Unit*>(leaf.src) + (long long)r * a.units;
  const Unit x = u < a.units ? from[u] : Unit{};
  const long long dst = rows(b, r - b * a.T, a.T);
  if (dst < 0) return;
  Unit* to = reinterpret_cast<Unit*>(leaf.dst) + dst * a.units;
  if (u < a.units) to[u] = x;
  for (int i = u + blockDim.x; i < a.units; i += blockDim.x) to[i] = from[i];
}

template <typename Rows>
int copy_launch(CopyLaunch a, const Rows& rows, int leaves, int B, long long row_bytes,
                void* stream) {
  if (leaves != 1 && leaves != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (leaves == 1) a.v = a.k;
  if (B == 0 || a.T == 0 || row_bytes == 0) return 0;
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = row_bytes % 16 == 0 && aligned(a.k.dst) && aligned(a.k.src) &&
                   aligned(a.v.dst) && aligned(a.v.src);
  const long long units = vec ? row_bytes / 16 : row_bytes;
  const long long nrows = (long long)B * a.T;
  if (nrows > INT32_MAX || units > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  a.units = (int)units;
  const int threads = (int)std::min<long long>(kCopyThreads, (units + 31) / 32 * 32);
  const dim3 grid((unsigned)nrows, leaves);
  auto kernel = vec ? copy_scatter_kernel<true, Rows> : copy_scatter_kernel<false, Rows>;
  kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(a, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One or two leaves (k, then v; the v pointers unused for one): caches
// (B, C, F) and src (B, F), rows of row_bytes; slots: (B,) int32; all on
// the device.  Returns cudaGetLastError() after the launch.
extern "C" int pmt_cache_update(void* k_cache, const void* k_src, void* v_cache,
                                const void* v_src, int leaves, const void* slots, int B, int C,
                                long long row_bytes, void* stream) {
  CopyLaunch a{};
  a.k = {static_cast<char*>(k_cache), static_cast<const char*>(k_src)};
  a.v = {static_cast<char*>(v_cache), static_cast<const char*>(v_src)};
  a.T = 1;
  const SlotRows rows{static_cast<const int*>(slots), C};
  return copy_launch(a, rows, leaves, B, row_bytes, stream);
}

// One or two leaves as above, paged: pools (P, ps, F), src (B, T, F);
// page_table: (B, NB) int32; starts: (B,) int32; valids: (B,) int32, or
// null for every row valid; all on the device.  Returns
// cudaGetLastError() after the launch.
extern "C" int pmt_paged_cache_update(void* k_pool, const void* k_src, void* v_pool,
                                      const void* v_src, int leaves, const void* page_table,
                                      const void* starts, const void* valids, int B, int T,
                                      int NB, int ps, long long row_bytes, void* stream) {
  CopyLaunch a{};
  a.k = {static_cast<char*>(k_pool), static_cast<const char*>(k_src)};
  a.v = {static_cast<char*>(v_pool), static_cast<const char*>(v_src)};
  a.T = T;
  const PageRows rows{static_cast<const int*>(page_table), static_cast<const int*>(starts),
                      static_cast<const int*>(valids), NB, ps};
  return copy_launch(a, rows, leaves, B, row_bytes, stream);
}

// ---------------------------------------------------------------------------
// Quantizing scatters (rows 5 and 6): each (row, kv head) vector of D
// values is quantized to codes plus one float32 absmax scale, and both
// land where SlotRows or PageRows routes the row.  Contiguous: row t of
// src[b] lands at cache[b, s + t, h] and scales[b, s + t, h], s =
// slots[b] clamped to [0, C - T] (T > 1 is a prefill chunk).  Paged:
// through the page table into a code pool (P, ps, H, D) and a scale pool
// (P, ps, H) whose pages are the code pool's; masked rows t >= valids[b]
// write nothing.  One launch takes one or two leaves
// (codes, scales, source), the leaf a grid dimension, so the serve path
// writes a layer's k and v in one launch.
//
// Replace the TPU kernels quant_cache_update_pallas and
// quant_paged_cache_update_pallas
// (src/repro/kernels/cache_update/cache_update.py), which quantized one
// (H, D) row block per grid step and wrote it through the same index
// maps as the unquantized scatters, one leaf a call.
//
// The quantization is the contract of kernels/quant.py, op for op, so
// codes and scales equal the plain versions' bit for bit:
//   amax = max |x| (a shuffle max: exact in any order);
//   s = fmaxf(amax, 1e-8f) * (float)(1.0 / qmax): a multiply by the
//     float32 constant, never a division by qmax;
//   y = x / s, IEEE-rounded (__fdiv_rn; the build has no fast math);
//   int8: rintf (half to even, as torch.round), clip to +-127, cast;
//   fp8_e4m3: clip to +-448, then the round-to-nearest-even conversion
//     (the clip keeps NaN out: e4m3 has no infinity).
//
// What bounds it on the H100: nothing the card computes.  A decode step
// of smollm-135m reads 2 x 8 x 3 vectors of 64 bf16 and writes as many
// codes and 48 scales, about 4.8 KB; the launch and the chain of
// dependent steps a vector takes cost more than the bytes.  The design:
//   * one launch a layer for k and v (blockIdx.y picks the leaf), where
//     the serve path made two;
//   * a vector is held by a group of G lanes, D * sizeof(src) / 16 of
//     them rounded up to a power of two (8 at D 64 in bf16, 16 in
//     float32), each with one 16-byte load kept in registers; the absmax
//     is a log2(G)-step xor shuffle within the group, the codes come from
//     the same registers and leave in one 8-byte (bf16) or 4-byte
//     (float32) store a lane, the scale from the group's first lane.
//     Several vectors share a warp; a block holds whole rows (rows x H
//     vectors, up to kQuantThreads threads);
//   * where the row's bytes, a pointer or D * sizeof(src) > 512 do not
//     allow that, the launch takes the general path, chosen once for the
//     launch: a warp a vector, each lane reading its values twice (amax,
//     then quantize), the second time from L1.
// At the serve shapes a launch is latency: a warp a vector is 3-5%
// slower than the lane groups; 128 threads a block beat 64, 256, 512 and
// 1024 by 0.5-3% (512 and 1024 lose 18% and 38% on a chunk, fewer
// blocks).  Every value is divided: a test of the vector's amax
// (or of each value) would spare a zero vector the division's slow path,
// but cost every other vector 1-8% of a launch, and k and v rows come
// from projections of normed states, so a zero vector is not the serve
// path's case.  Those designs were timed (kernel_variants.py, a pair
// call in a CUDA graph, H100) and not kept.
namespace {

constexpr int kQuantThreads = 128;  // a block's threads, at most (whole rows)

template <typename TC> __device__ __forceinline__ float qmax_of();
template <> __device__ __forceinline__ float qmax_of<int8_t>() { return 127.f; }
template <> __device__ __forceinline__ float qmax_of<__nv_fp8_e4m3>() { return 448.f; }

template <typename TC> __device__ __forceinline__ float scale_of(float amax) {
  const float inv = static_cast<float>(1.0 / static_cast<double>(qmax_of<TC>()));
  return fmaxf(amax, 1e-8f) * inv;
}

// The code of y, as its byte.
template <typename TC> __device__ __forceinline__ uint32_t encode(float y);
template <> __device__ __forceinline__ uint32_t encode<int8_t>(float y) {
  return static_cast<uint8_t>(static_cast<int8_t>(fminf(fmaxf(rintf(y), -127.f), 127.f)));
}
template <> __device__ __forceinline__ uint32_t encode<__nv_fp8_e4m3>(float y) {
  return __nv_cvt_float_to_fp8(fminf(fmaxf(y, -448.f), 448.f), __NV_SATFINITE, __NV_E4M3);
}

// 16 bytes of source values, widened to float32 (bf16 exactly: its bits
// are a float32's upper half).
__device__ __forceinline__ void load16(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// A group of G lanes (a power of two, aligned in its warp) quantizes one
// vector: lane g < units holds its 16 bytes g.  Every lane of the warp
// calls this, `active` or not: the shuffles take the whole warp.  `live`
// lanes read (a vector that exists), `active` ones write (one whose row
// has a destination): the read does not wait for the destination's
// lookup.
template <typename TIN, typename TC>
__device__ __forceinline__ void quantize_group16(const TIN* x, uint8_t* codes, float* scale,
                                                 int g, int G, int units, bool live,
                                                 bool active) {
  constexpr int N = 16 / sizeof(TIN);
  float v[N] = {};
  float amax = 0.f;
  if (live && g < units) {
    load16(x + g * N, v);
#pragma unroll
    for (int i = 0; i < N; ++i) amax = fmaxf(amax, fabsf(v[i]));
  }
  for (int o = G >> 1; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s = scale_of<TC>(amax);
  if (active && g < units) {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = __fdiv_rn(v[i], s);
    uint32_t w[N / 4];
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      w[i] = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) w[i] |= encode<TC>(v[4 * i + j]) << (8 * j);
    }
    if constexpr (N == 8)
      *reinterpret_cast<uint2*>(codes + g * N) = make_uint2(w[0], w[1]);
    else
      *reinterpret_cast<uint32_t*>(codes + g * N) = w[0];
  }
  if (active && g == 0) *scale = s;
}

// The general path: a warp quantizes one vector, each lane its values
// d = lane, lane + 32, ...; every lane of the warp calls this (`live`
// and `active` as above).
template <typename TIN, typename TC>
__device__ __forceinline__ void quantize_warp(const TIN* x, uint8_t* codes, float* scale, int D,
                                              bool live, bool active) {
  const int lane = threadIdx.x & 31;
  float amax = 0.f;
  if (live)
    for (int d = lane; d < D; d += 32) amax = fmaxf(amax, fabsf(pmt::to_f(x[d])));
  amax = pmt::warp_max(amax);
  const float s = scale_of<TC>(amax);
  if (active) {
    for (int d = lane; d < D; d += 32)
      codes[d] = static_cast<uint8_t>(encode<TC>(__fdiv_rn(pmt::to_f(x[d]), s)));
    if (lane == 0) *scale = s;
  }
}

struct QuantLeaf {
  uint8_t* codes;
  float* scales;
  const void* src;  // (B, T, H, D)
};

struct QuantLaunch {
  QuantLeaf k, v;  // v is k again for one leaf
  int B, T, H, D;
  int G;           // lanes a vector: a power of two; 32 on the general path
  int units;       // 16-byte units a vector (the 16-byte path)
  int vpb;         // vectors a block
};

// Vector v of a leaf's source (row r = b * T + t, head h) lands at row
// `dst` of the cache or pool: the source read depends on v alone, so it
// is in flight while the slot or page lookup runs.  Vector counts fit in
// 32 bits (checked at launch).
template <typename TIN, typename TC, bool kVec, typename Rows>
__device__ __forceinline__ void quant_scatter_body(const QuantLaunch& a, const Rows& rows) {
  const QuantLeaf leaf = blockIdx.y ? a.v : a.k;
  const int local = threadIdx.x / a.G, g = threadIdx.x % a.G;
  const int vec = blockIdx.x * a.vpb + local;
  const bool live = local < a.vpb && vec < a.B * a.T * a.H;
  const int v = live ? vec : 0;
  const int r = v / a.H, h = v - r * a.H;
  const int b = r / a.T;
  const TIN* x = static_cast<const TIN*>(leaf.src) + (long long)v * a.D;
  const long long dst = live ? rows(b, r - b * a.T, a.T) : -1;
  const bool active = dst >= 0;
  const long long at = active ? dst * a.H + h : 0;
  if constexpr (kVec)
    quantize_group16<TIN, TC>(x, leaf.codes + at * a.D, leaf.scales + at, g, a.G, a.units,
                              live, active);
  else
    quantize_warp<TIN, TC>(x, leaf.codes + at * a.D, leaf.scales + at, a.D, live, active);
}

template <typename TIN, typename TC, bool kVec>
__global__ void quant_scatter_kernel(QuantLaunch a, SlotRows rows) {
  quant_scatter_body<TIN, TC, kVec>(a, rows);
}

template <typename TIN, typename TC, bool kVec>
__global__ void quant_paged_scatter_kernel(QuantLaunch a, PageRows rows) {
  quant_scatter_body<TIN, TC, kVec>(a, rows);
}

template <typename TIN>
bool vec16_ok(const QuantLaunch& a) {
  constexpr int N = 16 / sizeof(TIN);
  auto aligned = [](const void* p, int n) { return reinterpret_cast<uintptr_t>(p) % n == 0; };
  return a.D % N == 0 && a.D / N <= 32 && aligned(a.k.src, 16) && aligned(a.v.src, 16) &&
         aligned(a.k.codes, N) && aligned(a.v.codes, N);
}

template <typename TIN, typename TC, typename Rows>
int quant_launch(QuantLaunch a, const Rows& rows, int leaves, cudaStream_t stream) {
  constexpr bool kPaged = std::is_same<Rows, PageRows>::value;
  const bool vec = vec16_ok<TIN>(a);
  a.units = a.D / (16 / (int)sizeof(TIN));
  a.G = 32;
  if (vec)
    for (a.G = 1; a.G < a.units;) a.G <<= 1;  // units <= 32
  const long long vectors = (long long)a.B * a.T * a.H;
  if (vectors > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int per_row = a.H * a.G;
  long long vpb = per_row <= kQuantThreads ? (long long)(kQuantThreads / per_row) * a.H
                                           : std::max(kQuantThreads / a.G, 1);
  vpb = std::min(vpb, vectors);
  a.vpb = (int)vpb;
  const int threads = (int)((vpb * a.G + 31) / 32 * 32);
  const dim3 grid((unsigned)((vectors + vpb - 1) / vpb), leaves);
  if constexpr (kPaged) {
    if (vec)
      quant_paged_scatter_kernel<TIN, TC, true><<<grid, threads, 0, stream>>>(a, rows);
    else
      quant_paged_scatter_kernel<TIN, TC, false><<<grid, threads, 0, stream>>>(a, rows);
  } else {
    if (vec)
      quant_scatter_kernel<TIN, TC, true><<<grid, threads, 0, stream>>>(a, rows);
    else
      quant_scatter_kernel<TIN, TC, false><<<grid, threads, 0, stream>>>(a, rows);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename Rows>
int quant_dispatch(QuantLaunch a, const Rows& rows, int leaves, int src_dtype, int code_dtype,
                   void* stream) {
  if (leaves != 1 && leaves != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (leaves == 1) a.v = a.k;
  if (a.B == 0 || a.T == 0 || a.H == 0 || a.D == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (src_dtype == 0 && code_dtype == 2) return quant_launch<float, int8_t>(a, rows, leaves, s);
  if (src_dtype == 0 && code_dtype == 3)
    return quant_launch<float, __nv_fp8_e4m3>(a, rows, leaves, s);
  if (src_dtype == 1 && code_dtype == 2)
    return quant_launch<__nv_bfloat16, int8_t>(a, rows, leaves, s);
  if (src_dtype == 1 && code_dtype == 3)
    return quant_launch<__nv_bfloat16, __nv_fp8_e4m3>(a, rows, leaves, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

QuantLeaf leaf_of(void* codes, void* scales, const void* src) {
  return {static_cast<uint8_t*>(codes), static_cast<float*>(scales), src};
}

}  // namespace

// One or two leaves (k, then v; the v pointers unused for one): codes
// (B, C, H, D) of code_dtype (2 = int8, 3 = fp8_e4m3), scales (B, C, H)
// float32, src (B, T, H, D) of src_dtype (0 = float32, 1 = bfloat16),
// T <= C; slots: (B,) int32; all on the device.  Returns
// cudaGetLastError() after the launch.
extern "C" int pmt_quant_cache_update(void* k_codes, void* k_scales, const void* k_src,
                                      void* v_codes, void* v_scales, const void* v_src,
                                      int leaves, const void* slots, int B, int T, int C, int H,
                                      int D, int src_dtype, int code_dtype, void* stream) {
  if (T > C) return static_cast<int>(cudaErrorInvalidValue);
  QuantLaunch a{};
  a.k = leaf_of(k_codes, k_scales, k_src);
  a.v = leaf_of(v_codes, v_scales, v_src);
  a.B = B, a.T = T, a.H = H, a.D = D;
  const SlotRows rows{static_cast<const int*>(slots), C};
  return quant_dispatch(a, rows, leaves, src_dtype, code_dtype, stream);
}

// One or two leaves as above, paged: codes (P, ps, H, D), scales
// (P, ps, H), src (B, T, H, D); page_table: (B, NB) int32; starts:
// (B,) int32; valids: (B,) int32, or null for every row valid; all on
// the device.  Returns cudaGetLastError().
extern "C" int pmt_quant_paged_cache_update(void* k_codes, void* k_scales, const void* k_src,
                                            void* v_codes, void* v_scales, const void* v_src,
                                            int leaves, const void* page_table,
                                            const void* starts, const void* valids, int B,
                                            int T, int NB, int ps, int H, int D, int src_dtype,
                                            int code_dtype, void* stream) {
  QuantLaunch a{};
  a.k = leaf_of(k_codes, k_scales, k_src);
  a.v = leaf_of(v_codes, v_scales, v_src);
  a.B = B, a.T = T, a.H = H, a.D = D;
  const PageRows rows{static_cast<const int*>(page_table), static_cast<const int*>(starts),
                      static_cast<const int*>(valids), NB, ps};
  return quant_dispatch(a, rows, leaves, src_dtype, code_dtype, stream);
}
