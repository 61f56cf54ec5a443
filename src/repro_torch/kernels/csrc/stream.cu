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
// is 3.2 GB over 3.35 TB/s (~1 ms).  The design moves 16 bytes per load
// and store (a float4, or eight bfloat16) on a grid-stride loop, so each
// warp issues 512-byte coalesced transactions; a ragged tail or a
// misaligned pointer takes the element-wise loop.
#include "common.cuh"

namespace {

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

template <typename T>
__global__ void stream_triad_kernel(const T* __restrict__ a, const T* __restrict__ b,
                                    T* __restrict__ out, long long n, float s, int vec16) {
  constexpr int kVec = 16 / sizeof(T);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec16) {
    const long long nvec = n / kVec;
    const int4* a4 = reinterpret_cast<const int4*>(a);
    const int4* b4 = reinterpret_cast<const int4*>(b);
    int4* o4 = reinterpret_cast<int4*>(out);
    for (long long i = first; i < nvec; i += stride) {
      const int4 va = a4[i], vb = b4[i];
      int4 vo;
      const T* ea = reinterpret_cast<const T*>(&va);
      const T* eb = reinterpret_cast<const T*>(&vb);
      T* eo = reinterpret_cast<T*>(&vo);
#pragma unroll
      for (int j = 0; j < kVec; ++j) eo[j] = triad<T>(ea[j], eb[j], s);
      o4[i] = vo;
    }
    done = nvec * kVec;
  }
  for (long long i = done + first; i < n; i += stride) out[i] = triad<T>(a[i], b[i], s);
}

template <typename T>
void launch(const void* a, const void* b, void* out, long long n, float s, cudaStream_t stream) {
  const int vec16 = reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int threads = 256;
  const long long units = vec16 ? (n + 16 / (long long)sizeof(T) - 1) / (16 / (long long)sizeof(T)) : n;
  long long blocks = (units + threads - 1) / threads;
  if (blocks > (long long)sms * 16) blocks = (long long)sms * 16;
  stream_triad_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
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
