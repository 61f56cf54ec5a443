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
// What bounds them on the H100: instructions, not bytes.  At P = 1024,
// V = 2048, S = 1024 there are 2.1e9 (subgrid, pixel, visibility) terms
// against 25 MB of arrays.  Each term is a 2-term dot, a phasor and a
// complex multiply-add (4 FMAs).  Both kernels follow IDG's CUDA
// original: a thread keeps its output elements' coordinates and re/im
// sums in registers; the block stages its subgrid's elements of the other
// axis in shared memory, CHUNK at a time, and every lane of a warp then
// reads the same shared element (a broadcast, no bank conflicts).  S runs
// on gridDim.x (up to 2^31 - 1), tiles of the thread axis on gridDim.y
// (at most 65535, which the wrapper checks); any P, V and S work, ragged
// tails masked.
//
// The gridder (redesigned for Hopper):
//  - The phasor on the SFU.  Each thread scales its pixels' (l, m) by
//    float32(2 pi) once, so each term's phase in radians is one FMUL and
//    one FFMA, and __sincosf(phase) is one FMUL.RZ to turns and MUFU.SIN
//    + MUFU.COS.  That replaces the accurate sincosf, its Cody-Waite
//    reduction, quadrant F2I, selects and slow-path branch: 12 FP32 FLOP
//    and 2 MUFU a term in place of 36 FLOP.
//  - Its accuracy, and the range it is held to.  The phase is not reduced
//    before the SFU.  CUDA states __sincosf's absolute error (2^-21.41)
//    on [-pi, pi] only; beyond it the FMUL.RZ to turns, and the kernel's
//    float32 phase (2 pi l) u + (2 pi m) v beside the reference's
//    float32(2 pi) (l u + m v), each lose ~|phase| 2^-24.  At the Fig. 2
//    ranges (lm in [-0.5, 0.5], uv in [-2, 2]: |l u + m v| <= 2 turns) a
//    phasor moves by at most ~2.5e-6 from the reference's, which over
//    V = 2048 unit visibilities random-walks to ~1e-4, inside atol 2e-3.
//    chip_smoke.py and the cuda tests hold the kernel to the JAX tests'
//    rtol 1e-4, atol 2e-3 with phases up to 4 pi (2 turns) and up to
//    32 pi (uv in [-16, 16]: 16 turns); tests/test_torch_gridder_sfu.py
//    emulates the arithmetic at both.  Wider phases are not tested.
//  - PIX pixels a thread, GTHREADS apart (coalesced stores), on one staged
//    visibility: the block stages (u, v, re, im) as one float4, so one
//    broadcast LDS.128 serves PIX terms.  128 threads x 8 pixels make a
//    block of 1024 pixels; __launch_bounds__ caps registers at 64, so 8
//    blocks fit an SM and the Fig. 2 grid of 1024 blocks is one wave.
//  - What bounds it: the SFU, 2 MUFU a term at 16 a clock an SM (1.03 ms
//    at the Fig. 2 size), with the dispatch of 9.6 instructions a term
//    close behind, so every FMA-pipe instruction a term costs time.
//    Timed in turns on an H100 80GB HBM3 at 700 W (10 rounds): this
//    design 1.1447 ms.  Variants timed the same way and not kept: the
//    phase in turns with the 2 pi multiply in the loop 1.1933; an exact
//    reduction to [-0.5, 0.5] turns first (three FADDs) 1.2547, by rintf
//    (FRND, on a slower pipe) 1.7158; the visibility loop unrolled 2x
//    1.2037, 4x 1.1621; 4 pixels a thread 1.1657; cos from a polynomial
//    on the FMA pipe for 2 or 8 of the 8 pixels 1.5120, 1.5797; the
//    accurate sincosf 2.9375 at 8 pixels a thread, 3.2301 at 1 (the
//    first port's design).
//  - Staging reads floats one at a time (any 4-byte alignment works);
//    bytes do not bound this kernel.
//
// The degridder (first port): one visibility a thread and the accurate
// sincosf, 36 FP32 FLOP a term (chip_smoke.py counts them in the built
// loop); its redesign can take phasor() with lm scaled by TWO_PI.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // degridder visibilities per block
constexpr int CHUNK = 512;    // staged elements per trip: 8 KB of shared memory
constexpr float TWO_PI = 6.28318530717958647692f;  // float32(2 pi), as the reference rounds it
constexpr int GTHREADS = 128;  // gridder threads per block
constexpr int PIX = 8;         // gridder pixels per thread

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

// exp(i phase) of a term, its phase in radians, on the SFU.
__device__ __forceinline__ void phasor(float phase, float* sn, float* cs) {
  __sincosf(phase, sn, cs);
}

// Grid (S, ceil(P / (GTHREADS * PIX))); a thread's pixels are GTHREADS
// apart.
__global__ void __launch_bounds__(GTHREADS, 1024 / GTHREADS)
    gridder_kernel(const float* __restrict__ lm, const float* __restrict__ uv,
                   const float* __restrict__ vis, float2* __restrict__ out, int P, int V) {
  __shared__ float4 s_w[CHUNK];  // (u, v, vis re, vis im) of each staged visibility
  const long long s = blockIdx.x;
  const int p0 = blockIdx.y * (GTHREADS * PIX) + threadIdx.x;
  float l[PIX], m[PIX], re[PIX], im[PIX];
#pragma unroll
  for (int k = 0; k < PIX; ++k) {
    const int p = p0 + k * GTHREADS;
    l[k] = p < P ? lm[2 * p] * TWO_PI : 0.f;
    m[k] = p < P ? lm[2 * p + 1] * TWO_PI : 0.f;
    re[k] = im[k] = 0.f;
  }
  const float* uv_s = uv + 2 * s * V;
  const float* vis_s = vis + 2 * s * V;
  for (int c0 = 0; c0 < V; c0 += CHUNK) {
    const int n = min(CHUNK, V - c0);
    __syncthreads();  // every lane is done with the previous chunk
    for (int i = threadIdx.x; i < n; i += GTHREADS) {
      const long long e = 2LL * (c0 + i);
      s_w[i] = make_float4(uv_s[e], uv_s[e + 1], vis_s[e], vis_s[e + 1]);
    }
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < n; ++j) {
      const float4 w = s_w[j];
#pragma unroll
      for (int k = 0; k < PIX; ++k) {
        float sn, cs;
        phasor(l[k] * w.x + m[k] * w.y, &sn, &cs);
        // (w.re + i w.im) (cs + i sn)
        re[k] = fmaf(w.z, cs, re[k]);
        re[k] = fmaf(-w.w, sn, re[k]);
        im[k] = fmaf(w.z, sn, im[k]);
        im[k] = fmaf(w.w, cs, im[k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < PIX; ++k) {
    const int p = p0 + k * GTHREADS;
    if (p < P) out[s * P + p] = make_float2(re[k], im[k]);
  }
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
  const dim3 grid(S, (P + GTHREADS * PIX - 1) / (GTHREADS * PIX));
  gridder_kernel<<<grid, GTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lm), static_cast<const float*>(uv), static_cast<const float*>(vis),
      static_cast<float2*>(out), P, V);
  return static_cast<int>(cudaGetLastError());
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
