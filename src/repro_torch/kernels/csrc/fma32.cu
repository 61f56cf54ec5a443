// FMA32: y = x, then `iters` dependent y = fmaf(y, 1.0000001f, 1e-7f).
//
// Replaces the TPU kernel fma32_pallas (src/repro/kernels/fma32/fma32.py),
// the paper's FLOP burner: each grid step held one (bm, N) block in VMEM
// and ran the chain on the vector unit.
//
// Rounding: the JAX reference's `y * a + b` is contracted into one fused
// multiply-add by XLA, so the chain rounds once per step.  fmaf does the
// same; a multiply then an add would drift from the reference by up to
// ~2e-4 after 1024 steps.
//
// What bounds it on the H100: operations.  At (8192, 8192) and 1024
// steps it does 2 * 1024 FLOP per element against 8 bytes moved, far
// past the card's fp32 ridge point, so the bound is 137 GFLOP over the
// CUDA cores' fp32 rate (~2 ms).  The design keeps each element's chain
// in a register and lets independent threads hide the FMA latency: one
// element per thread per trip of a grid-stride loop, with enough blocks
// to fill every SM.  `iters` is a runtime argument, so nothing is
// unrolled away.
#include <cuda_runtime.h>

namespace {

__global__ void fma32_kernel(const float* __restrict__ x, float* __restrict__ out,
                             long long n, int iters) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    float y = x[i];
    for (int k = 0; k < iters; ++k) y = fmaf(y, 1.0000001f, 1e-7f);
    out[i] = y;
  }
}

}  // namespace

// x, out: n float32 on the device.  Returns cudaGetLastError() after the
// launch.
extern "C" int pmt_fma32(const void* x, void* out, long long n, int iters, void* stream) {
  if (n == 0) return 0;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > (long long)sms * 32) blocks = (long long)sms * 32;
  fma32_kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n, iters);
  return static_cast<int>(cudaGetLastError());
}
