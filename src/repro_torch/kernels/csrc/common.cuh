// Helpers shared by the port's CUDA kernels: element conversion, warp
// reductions, and the online-softmax fold of one key tile that the
// decode and chunked-prefill attention kernels both run.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The additive mask of kernels/constants.py: finite, so that a fully
// masked score never turns the running max into NaN.
#define PMT_NEG_INF (-1073741824.0f)

namespace pmt {

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Softmax half of one online-softmax fold, for `rows` query rows against
// a tile of `bk` score columns of which the first `n` are real (the rest
// pad a ragged last tile).  `ps` holds the masked scores (rows x bk) and
// gets the probabilities; m/l are the running max and sum, `alpha` the
// rescale factor of the accumulator.  One warp per row; the caller
// synchronises the block before and after.
__device__ __forceinline__ void softmax_fold(float* ps, float* m, float* l,
                                             float* alpha, int rows, int bk,
                                             int n) {
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int r = threadIdx.x >> 5; r < rows; r += nwarps) {
    float* pr = ps + r * bk;
    float mx = PMT_NEG_INF;
    for (int c = lane; c < n; c += 32) mx = fmaxf(mx, pr[c]);
    mx = warp_max(mx);
    const float m_prev = m[r];
    const float m_new = fmaxf(m_prev, mx);
    float sum = 0.f;
    for (int c = lane; c < bk; c += 32) {
      const float p = c < n ? expf(pr[c] - m_new) : 0.f;
      pr[c] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const float a = expf(m_prev - m_new);
      l[r] = a * l[r] + sum;
      m[r] = m_new;
      alpha[r] = a;
    }
  }
}

// Accumulator half of the fold: acc[r, d] = alpha[r] * acc[r, d]
// + sum_c p[r, c] * v[c, d], over the first `n` columns of the tile.
__device__ __forceinline__ void pv_fold(const float* ps, const float* vs,
                                        float* acc, const float* alpha,
                                        int rows, int bk, int n, int hdv) {
  for (int i = threadIdx.x; i < rows * hdv; i += blockDim.x) {
    const int r = i / hdv, d = i - r * hdv;
    const float* pr = ps + r * bk;
    float a = 0.f;
    for (int c = 0; c < n; ++c) a = fmaf(pr[c], vs[c * hdv + d], a);
    acc[i] = alpha[r] * acc[i] + a;
  }
}

// Copy a tile of `n` key rows (row stride `stride` elements, `width`
// wide) from device memory into fp32 shared memory with row pitch
// `pitch`.  Where rows allow it, each thread moves 16 bytes per load and
// puts up to four loads in flight before it converts and stores any of
// them, so a tile costs about one memory round trip rather than one per
// element; otherwise neighbouring threads read neighbouring elements.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int n,
                                          int width, size_t stride,
                                          int pitch) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int kInFlight = 4;
  if (width % kVec == 0 && stride % kVec == 0 &&
      reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    const int per_row = width / kVec;
    const int total = n * per_row;
    for (int base = threadIdx.x; base < total; base += kInFlight * blockDim.x) {
      int4 buf[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int i = base + u * blockDim.x;
        if (i < total) {
          const int r = i / per_row, c = i - r * per_row;
          buf[u] = *(reinterpret_cast<const int4*>(src + (size_t)r * stride) + c);
        }
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int i = base + u * blockDim.x;
        if (i < total) {
          const int r = i / per_row, c = i - r * per_row;
          const T* e = reinterpret_cast<const T*>(&buf[u]);
          float* d = dst + r * pitch + c * kVec;
#pragma unroll
          for (int j = 0; j < kVec; ++j) d[j] = to_f(e[j]);
        }
      }
    }
    return;
  }
  for (int i = threadIdx.x; i < n * width; i += blockDim.x) {
    const int r = i / width, d = i - r * width;
    dst[r * pitch + d] = to_f(src[(size_t)r * stride + d]);
  }
}

}  // namespace pmt
