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
// The degridder (redesigned for Hopper) mirrors the gridder:
//  - VPT visibilities a thread, DTHREADS apart (coalesced loads of uv and
//    stores of out), their (u, v) and re/im sums in registers; 256
//    threads x 8 visibilities make a block of 2048, and __launch_bounds__
//    caps registers at 64 (4 blocks an SM).  The Fig. 2 grid (one block a
//    subgrid) is 1024 blocks, 1.94 waves of 528.
//  - The block stages its subgrid's pixels as one float4 each, (2 pi l,
//    2 pi m, sub re, sub im): lm scaled by float32(2 pi) as the gridder
//    scales it, so a term's phase is the gridder's to the bit.  Staging
//    reads one float at a time (any 4-byte alignment works: a float2
//    load of a view one float into its storage would fault), and one
//    broadcast LDS.128 serves VPT terms.
//  - A term's phase (2 pi l) u + (2 pi m) v is one FMUL and one FFMA, its
//    phasor phasor(), and the conjugate sums 4 FFMA: 12 FP32 FLOP and 2
//    MUFU a term, the gridder's count and bound (the SFU's).  Held to the
//    same range: phases up to 32 pi at rtol 1e-4, atol 2e-3.
//  - What bounds it: the SFU, as the gridder.  Timed by kernel_variants.py
//    on an H100 80GB HBM3 at 700 W (10 rounds, medians): this design
//    1.1121 ms (in turns with the first port, 1.1202 against 2.9232: one
//    visibility a thread, the accurate sincosf, float2 loads).  Variants
//    timed the same way and not kept: 64 and 128 threads 1.1163, 1.1152;
//    512 threads 2.1704 (a block of 4096 visibilities leaves half its
//    threads idle at V = 2048); 4 visibilities a thread 1.1431, 1.1456 at
//    128 threads; (u, v) scaled by 2 pi in place of lm, at 128 threads
//    1.1172 beside 1.1097 for 256 threads in another run (the same count,
//    but a phase up to 2 ulps from the reference's at 4 pi).
#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 512;    // staged elements per trip: 8 KB of shared memory
constexpr float TWO_PI = 6.28318530717958647692f;  // float32(2 pi), as the reference rounds it
constexpr int GTHREADS = 128;  // gridder threads per block
constexpr int PIX = 8;         // gridder pixels per thread
constexpr int DTHREADS = 256;  // degridder threads per block
constexpr int VPT = 8;         // degridder visibilities per thread

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

// Grid (S, ceil(V / (DTHREADS * VPT))); a thread's visibilities are
// DTHREADS apart.
__global__ void __launch_bounds__(DTHREADS, 1024 / DTHREADS)
    degridder_kernel(const float* __restrict__ lm, const float* __restrict__ uv,
                     const float* __restrict__ sub, float2* __restrict__ out, int P, int V) {
  __shared__ float4 s_p[CHUNK];  // (2 pi l, 2 pi m, sub re, sub im) of each staged pixel
  const long long s = blockIdx.x;
  const int v0 = blockIdx.y * (DTHREADS * VPT) + threadIdx.x;
  const float* uv_s = uv + 2 * s * V;
  float u[VPT], w[VPT], re[VPT], im[VPT];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int v = v0 + k * DTHREADS;
    u[k] = v < V ? uv_s[2LL * v] : 0.f;
    w[k] = v < V ? uv_s[2LL * v + 1] : 0.f;
    re[k] = im[k] = 0.f;
  }
  const float* sub_s = sub + 2 * s * P;
  for (int c0 = 0; c0 < P; c0 += CHUNK) {
    const int n = min(CHUNK, P - c0);
    __syncthreads();  // every lane is done with the previous chunk
    for (int i = threadIdx.x; i < n; i += DTHREADS) {
      const long long e = 2LL * (c0 + i);
      s_p[i] = make_float4(lm[e] * TWO_PI, lm[e + 1] * TWO_PI, sub_s[e], sub_s[e + 1]);
    }
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < n; ++j) {
      const float4 g = s_p[j];
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        float sn, cs;
        phasor(__fmaf_rn(g.x, u[k], __fmul_rn(g.y, w[k])), &sn, &cs);
        // (g.re + i g.im) (cs - i sn)
        re[k] = fmaf(g.z, cs, re[k]);
        re[k] = fmaf(g.w, sn, re[k]);
        im[k] = fmaf(g.w, cs, im[k]);
        im[k] = fmaf(-g.z, sn, im[k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int v = v0 + k * DTHREADS;
    if (v < V) out[s * V + v] = make_float2(re[k], im[k]);
  }
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
  const dim3 grid(S, (V + DTHREADS * VPT - 1) / (DTHREADS * VPT));
  degridder_kernel<<<grid, DTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lm), static_cast<const float*>(uv), static_cast<const float*>(sub),
      static_cast<float2*>(out), P, V);
  return static_cast<int>(cudaGetLastError());
}
