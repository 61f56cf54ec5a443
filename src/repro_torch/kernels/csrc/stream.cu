// STREAM triad: out = a + s * b, elementwise, float32 or bfloat16.
//
// Replaces the TPU kernel stream_triad_pallas
// (src/repro/kernels/stream/stream.py), which streamed (bm, N) blocks of
// a and b through VMEM.
//
// Rounding: the JAX reference computes `a + s*b` as two operations, each
// rounded to the array's type.  nvcc would contract the expression into
// one fused multiply-add, so the product and the sum are written with
// __fmul_rn / __fadd_rn, which it never contracts.  In bfloat16 the
// product is rounded to bfloat16 before the add, as torch and JAX do op
// by op.
//
// What bounds it on the H100: bytes.  It does 2 FLOP per element and
// moves 3 elements (12 bytes in float32), so at (16384, 16384) the bound
// is 3.2 GB over 3.35 TB/s (0.96 ms).  The design sweeps memory in order:
//  - each block takes one contiguous tile of UNROLL * THREADS (2 x 128)
//    16-byte vectors (a float4 or eight bfloat16 each), thread t the
//    vectors t and t + THREADS: every load of a warp is one 512-byte
//    coalesced run;
//  - one block per tile, so the hardware hands out tiles in address order
//    as blocks retire, and the blocks resident at any moment cover one
//    window of memory that moves forward (a grid-stride loop over one
//    persistent wave spread each warp's loads over windows megabytes
//    apart, and was slower);
//  - a block loads all its vectors of a and of b before any arithmetic,
//    with no bounds check; the vectors past the last whole tile take a
//    masked loop, and a ragged end (n not a multiple of the vector) or a
//    misaligned pointer the element-wise loop;
//  - stores are st.global.cs (evict-first): the output is not read again.
// On an H100 80GB HBM3 at 700 W, in turns over 10 rounds: 1.0405 ms at
// (16384, 16384) float32, 3.10 TB/s (92.4% of 3.35), against 1.0407 for
// torch.add(a, b, alpha=2) and 1.0857 for the first port (a grid-stride
// loop of one vector a trip over at most 16 blocks an SM).  Variants
// timed the same way and not kept: one persistent wave with a
// grid-stride loop of 4 vectors a trip (1.0939; 1.0930 with .cs loads and
// stores), tiles of 128 x 4 or 128 x 8 vectors (1.0478, 1.0603), one
// persistent wave over 128 x 4 tiles (1.0930); no faster: plain stores
// (1.0412), .cs or .nc loads (1.0405, 1.0408), 256 x 2 tiles (1.0404).
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int UNROLL = 2;                                // 16-byte vectors a thread per tile
constexpr long long TILE = (long long)UNROLL * THREADS;  // vectors a block
constexpr long long MAX_BLOCKS = 0x7fffffffLL;           // gridDim.x's limit

template <typename T>
__device__ __forceinline__ T triad(T a, T b, float s);

template <>
__device__ __forceinline__ float triad<float>(float a, float b, float s) {
  return __fadd_rn(a, __fmul_rn(s, b));
}

template <>
__device__ __forceinline__ __nv_bfloat16 triad<__nv_bfloat16>(__nv_bfloat16 a, __nv_bfloat16 b,
                                                               float s) {
  const float prod = __bfloat162float(__float2bfloat16(__fmul_rn(s, __bfloat162float(b))));
  return __float2bfloat16(__fadd_rn(__bfloat162float(a), prod));
}

// The triad of the 16 / sizeof(T) elements in two 16-byte vectors.
template <typename T>
__device__ __forceinline__ int4 triad16(int4 va, int4 vb, float s) {
  constexpr int kVec = 16 / sizeof(T);
  int4 vo;
  const T* ea = reinterpret_cast<const T*>(&va);
  const T* eb = reinterpret_cast<const T*>(&vb);
  T* eo = reinterpret_cast<T*>(&vo);
#pragma unroll
  for (int j = 0; j < kVec; ++j) eo[j] = triad<T>(ea[j], eb[j], s);
  return vo;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    stream_triad_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out,
                        long long n, float s, int vec16) {
  constexpr int kVec = 16 / sizeof(T);
  const long long threads = (long long)gridDim.x * THREADS;
  const long long first = (long long)blockIdx.x * THREADS + threadIdx.x;
  long long done = 0;
  if (vec16) {
    const long long nvec = n / kVec;
    const int4* a4 = reinterpret_cast<const int4*>(a);
    const int4* b4 = reinterpret_cast<const int4*>(b);
    int4* o4 = reinterpret_cast<int4*>(out);
    const long long whole = nvec / TILE;
    for (long long t = blockIdx.x; t < whole; t += gridDim.x) {
      const long long i = t * TILE + threadIdx.x;
      int4 va[UNROLL], vb[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) va[u] = a4[i + u * THREADS];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) vb[u] = b4[i + u * THREADS];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) __stcs(o4 + i + u * THREADS, triad16<T>(va[u], vb[u], s));
    }
    for (long long i = whole * TILE + first; i < nvec; i += threads)
      __stcs(o4 + i, triad16<T>(a4[i], b4[i], s));
    done = nvec * kVec;
  }
  for (long long i = done + first; i < n; i += threads) out[i] = triad<T>(a[i], b[i], s);
}

// One block per tile of TILE vectors (or of TILE elements on the
// element-wise path).
template <typename T>
void launch(const void* a, const void* b, void* out, long long n, float s, cudaStream_t stream) {
  const int vec16 = reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  constexpr long long kVec = 16 / sizeof(T);
  const long long units = vec16 ? (n + kVec - 1) / kVec : n;
  long long blocks = (units + TILE - 1) / TILE;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  stream_triad_kernel<T><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(out), n, s, vec16);
}

}  // namespace

// a, b, out: n elements of `dtype` (0 = float32, 1 = bfloat16) on the
// device.  Returns cudaGetLastError() after the launch.
extern "C" int pmt_stream_triad(const void* a, const void* b, void* out, long long n, float s,
                                int dtype, void* stream) {
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch<float>(a, b, out, n, s, st);
  else
    launch<__nv_bfloat16>(a, b, out, n, s, st);
  return static_cast<int>(cudaGetLastError());
}
