// GRIDDER and DEGRIDDER: the image-domain-gridding pair of the paper's
// Fig. 2, complex values as (re, im) float32 pairs.
//
//   gridder:   sub[s, p] = sum_v vis[s, v] * exp(+i phase[s, p, v])
//   degridder: vis[s, v] = sum_p sub[s, p] * exp(-i phase[s, p, v])
//   phase[s, p, v] = float32(2 pi) * (l_p * u_sv + m_p * v_sv)
//
// with lm (P, 2) pixel coordinates, uv (S, V, 2), vis (S, V, 2) and
// sub (S, P, 2), all contiguous.
//
// Replaces the TPU kernels gridder_pallas and degridder_pallas
// (src/repro/kernels/gridder/gridder.py).  The TPU has no per-lane loop,
// so they built a (P, bv) phase matrix with one matrix-unit product and
// reduced it with two more into a VMEM accumulator carried along a
// sequential visibility axis; they needed P and V in multiples of 128.
//
// What bounds it on the H100: operations.  Every (subgrid, pixel,
// visibility) term costs a 2-term dot (3 FLOP), the 2 pi scale (1), one
// accurate sincosf (its FP32 instructions; chip_smoke.py counts them in
// the built loop) and a complex multiply-add (4 FMAs, 8 FLOP), against
// 8 bytes per input or output element moved once: at P = 1024, V = 2048,
// S = 1024, 2.1e9 terms against 25 MB.  The design is IDG's CUDA
// original: one thread per output element (a pixel for the gridder, a
// visibility for the degridder) keeps its coordinates and its re/im sums
// in registers; the block stages its subgrid's elements of the other
// axis in shared memory, CHUNK at a time, with 16-byte loads where the
// alignment allows, and every lane of a warp then reads the same shared
// element (a broadcast, no bank conflicts).  S runs on gridDim.x (up to
// 2^31 - 1), tiles of the thread axis on gridDim.y (at most 65535, which
// the wrapper checks); any P, V and S work, ragged tails masked.
//
// Precision: sincosf, the accurate one, and no --use_fast_math: the
// intrinsic __sincosf loses accuracy outside [-pi, pi], and phases here
// reach 4 pi.  Both kernels round the phase the same way, so the pair
// stays adjoint on the card.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // output elements per block
constexpr int CHUNK = 512;    // staged elements per trip: 2 x 4 KB of shared memory
constexpr float TWO_PI = 6.28318530717958647692f;  // float32(2 pi), as the reference rounds it

// Copy n (re, im) pairs to shared memory: two pairs per 16-byte load
// when `VEC` (src 16-byte aligned and n even, as the launch ensures),
// else one pair per 8-byte load.
template <bool VEC>
__device__ __forceinline__ void stage(float2* __restrict__ dst, const float2* __restrict__ src,
                                      int n) {
  if (VEC) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < n / 2; i += THREADS) d4[i] = s4[i];
  } else {
    for (int i = threadIdx.x; i < n; i += THREADS) dst[i] = src[i];
  }
}

__device__ __forceinline__ float phase_of(float2 lm, float2 uv) {
  return TWO_PI * (lm.x * uv.x + lm.y * uv.y);
}

// Grid (S, ceil(P / THREADS)); thread = pixel.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    gridder_kernel(const float2* __restrict__ lm, const float2* __restrict__ uv,
                   const float2* __restrict__ vis, float2* __restrict__ out, int P, int V) {
  __shared__ __align__(16) float2 s_uv[CHUNK];
  __shared__ __align__(16) float2 s_vis[CHUNK];
  const long long s = blockIdx.x;
  const int p = blockIdx.y * THREADS + threadIdx.x;
  const float2 xy = p < P ? lm[p] : make_float2(0.f, 0.f);
  const float2* uv_s = uv + s * V;
  const float2* vis_s = vis + s * V;
  float re = 0.f, im = 0.f;
  for (int c0 = 0; c0 < V; c0 += CHUNK) {
    const int n = min(CHUNK, V - c0);
    __syncthreads();  // every lane is done with the previous chunk
    stage<VEC>(s_uv, uv_s + c0, n);
    stage<VEC>(s_vis, vis_s + c0, n);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float2 w = s_uv[j], x = s_vis[j];
      float sn, cs;
      sincosf(phase_of(xy, w), &sn, &cs);
      // (x.re + i x.im) (cs + i sn)
      re = fmaf(x.x, cs, re);
      re = fmaf(-x.y, sn, re);
      im = fmaf(x.x, sn, im);
      im = fmaf(x.y, cs, im);
    }
  }
  if (p < P) out[s * P + p] = make_float2(re, im);
}

// Grid (S, ceil(V / THREADS)); thread = visibility.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    degridder_kernel(const float2* __restrict__ lm, const float2* __restrict__ uv,
                     const float2* __restrict__ sub, float2* __restrict__ out, int P, int V) {
  __shared__ __align__(16) float2 s_lm[CHUNK];
  __shared__ __align__(16) float2 s_sub[CHUNK];
  const long long s = blockIdx.x;
  const int v = blockIdx.y * THREADS + threadIdx.x;
  const float2 w = v < V ? uv[s * V + v] : make_float2(0.f, 0.f);
  const float2* sub_s = sub + s * P;
  float re = 0.f, im = 0.f;
  for (int c0 = 0; c0 < P; c0 += CHUNK) {
    const int n = min(CHUNK, P - c0);
    __syncthreads();
    stage<VEC>(s_lm, lm + c0, n);
    stage<VEC>(s_sub, sub_s + c0, n);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float2 xy = s_lm[j], g = s_sub[j];
      float sn, cs;
      sincosf(phase_of(xy, w), &sn, &cs);
      // (g.re + i g.im) (cs - i sn)
      re = fmaf(g.x, cs, re);
      re = fmaf(g.y, sn, re);
      im = fmaf(g.y, cs, im);
      im = fmaf(-g.x, sn, im);
    }
  }
  if (v < V) out[s * V + v] = make_float2(re, im);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

using Kernel = void (*)(const float2*, const float2*, const float2*, float2*, int, int);

int launch(Kernel kernel, int S, int threads_axis, const void* a, const void* b, const void* c,
           void* out, int P, int V, void* stream) {
  const dim3 grid(S, (threads_axis + THREADS - 1) / THREADS);
  kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(a), static_cast<const float2*>(b),
      static_cast<const float2*>(c), static_cast<float2*>(out), P, V);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// lm (P, 2), uv and vis (S, V, 2), out (S, P, 2): float32 on the device.
// Returns cudaGetLastError() after the launch.
extern "C" int pmt_gridder(const void* lm, const void* uv, const void* vis, void* out, int S,
                           int P, int V, void* stream) {
  if (S == 0 || P == 0) return 0;
  // a subgrid's chunks start 16-byte aligned, and hold an even count,
  // when V is even
  const bool vec = V % 2 == 0 && aligned16(uv) && aligned16(vis);
  const Kernel k = vec ? static_cast<Kernel>(gridder_kernel<true>) : gridder_kernel<false>;
  return launch(k, S, P, lm, uv, vis, out, P, V, stream);
}

// lm (P, 2), uv (S, V, 2), sub (S, P, 2), out (S, V, 2): float32 on the
// device.  Returns cudaGetLastError() after the launch.
extern "C" int pmt_degridder(const void* lm, const void* uv, const void* sub, void* out, int S,
                             int P, int V, void* stream) {
  if (S == 0 || V == 0) return 0;
  // a subgrid's chunks start 16-byte aligned, and hold an even count,
  // when P is even
  const bool vec = P % 2 == 0 && aligned16(lm) && aligned16(sub);
  const Kernel k = vec ? static_cast<Kernel>(degridder_kernel<true>) : degridder_kernel<false>;
  return launch(k, S, V, lm, uv, sub, out, P, V, stream);
}
