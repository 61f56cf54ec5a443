// Helpers shared by the port's CUDA kernels: element conversion, warp
// reductions, the online-softmax fold of one key tile that the
// chunked-prefill attention kernel's CUDA-core path runs, and the tile
// loads that dequantize the code types of quantized caches (int8_t and
// __nv_fp8_e4m3, one float32 scale per row) as they stage a tile.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// The additive mask of kernels/constants.py: finite, so that a fully
// masked score never turns the running max into NaN.
#define PMT_NEG_INF (-1073741824.0f)

namespace pmt {

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// Codes of a quantized cache, widened exactly (every int8 and every
// e4m3 value is a float32; e4m3 goes through half, which also holds it).
template <> __device__ __forceinline__ float to_f<int8_t>(int8_t x) {
  return static_cast<float>(x);
}
template <> __device__ __forceinline__ float to_f<__nv_fp8_e4m3>(__nv_fp8_e4m3 x) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(x.__x, __NV_E4M3)));
}

// Element types that hold quantization codes, each row scaled by a
// float32 scale kept beside it: dequantized = float(code) * scale.
template <typename T> struct is_code : std::false_type {};
template <> struct is_code<int8_t> : std::true_type {};
template <> struct is_code<__nv_fp8_e4m3> : std::true_type {};

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

// Copy a tile of `n` key rows, each `width` elements starting at
// `row(r)`, from device memory into fp32 shared memory with row pitch
// `pitch`.  With `vec_ok` (every row start 16-byte aligned, `width` a
// whole number of 16-byte units) each thread moves 16 bytes per load and
// puts up to four loads in flight before it converts and stores any of
// them, so a tile costs about one memory round trip rather than one per
// element; otherwise neighbouring threads read neighbouring elements.
// `row` maps a tile row to its address: a fixed stride for a contiguous
// cache, a page-table lookup for a paged one.  For a code type `T` each
// element is staged as float(code) * scl[r] (`scl`: the tile's row
// scales, already in shared memory), the op order of the plain
// versions; other types ignore `scl`.
template <typename T, typename RowFn>
__device__ __forceinline__ void load_rows(float* dst, RowFn row, int n,
                                          int width, bool vec_ok,
                                          int pitch,
                                          const float* scl = nullptr) {
  auto widen = [&](T x, int r) -> float {
    if constexpr (is_code<T>::value) return to_f(x) * scl[r];
    else return to_f(x);
  };
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int kInFlight = 4;
  if (vec_ok) {
    const int per_row = width / kVec;
    const int total = n * per_row;
    for (int base = threadIdx.x; base < total; base += kInFlight * blockDim.x) {
      int4 buf[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int i = base + u * blockDim.x;
        if (i < total) {
          const int r = i / per_row, c = i - r * per_row;
          buf[u] = *(reinterpret_cast<const int4*>(row(r)) + c);
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
          for (int j = 0; j < kVec; ++j) d[j] = widen(e[j], r);
        }
      }
    }
    return;
  }
  for (int i = threadIdx.x; i < n * width; i += blockDim.x) {
    const int r = i / width, d = i - r * width;
    dst[r * pitch + d] = widen(row(r)[d], r);
  }
}

// Whether rows `base + k * stride` (k >= 0) of `width` elements can be
// moved in 16-byte units.
template <typename T>
__device__ __forceinline__ bool rows_vec_ok(const T* base, int width,
                                            size_t stride) {
  constexpr int kVec = 16 / sizeof(T);
  return width % kVec == 0 && stride % kVec == 0 &&
         reinterpret_cast<uintptr_t>(base) % 16 == 0;
}

// load_rows over `n` rows at a fixed stride of `stride` elements.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int n,
                                          int width, size_t stride,
                                          int pitch) {
  load_rows<T>(dst, [=](int r) { return src + (size_t)r * stride; }, n,
               width, rows_vec_ok(src, width, stride), pitch);
}

}  // namespace pmt
