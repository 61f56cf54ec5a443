// Device helpers of the tensor-core attention kernels over packed query
// rows (prefill_attention.cu's tc kernel, latent_attention.cu): the split
// of a key range over blocks, bf16 packing and the hi + lo split of fp32
// probabilities, and the exact widening of int8 / fp8_e4m3 codes to bf16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#include <type_traits>

namespace pmt {
namespace tile {

__device__ __forceinline__ float ex2(float x) {  // 2^x; 0 for -inf
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Split s's keys [lo, hi) of the key range [start, limit): shares of
// ceil(n / nsplit) rounded up to 16 keys, so the last splits may be empty.
// (kernels/split_kv.py split_range is the same function.)
__device__ __forceinline__ void split_range(int start, int limit, int nsplit, int s, int& lo,
                                            int& hi) {
  const int n = limit - start;
  if (n <= 0) {
    lo = hi = 0;
    return;
  }
  const int per = ((n + nsplit - 1) / nsplit + 15) / 16 * 16;
  lo = min(start + s * per, limit);
  hi = min(lo + per, limit);
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(a, b);  // a in the low half
  return *reinterpret_cast<const uint32_t*>(&x);
}

// hi = bf16(a, b); lo = bf16 of what hi leaves over.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - __low2float(h), b - __high2float(h));
}

// Two codes (bytes 0 and 1 of x) as a bf16 pair, byte 0 in the low half.
// Exact: every int8 code and every finite e4m3 value is a bf16 (8 and 4
// significant bits).  An int8 code is biased into the low mantissa byte
// of 2^23 by one byte permute and the bias subtracted in fp32 (as in
// decode_attention.cu); e4m3 codes convert two at a time to half, which
// holds them too.
template <typename TC>
__device__ __forceinline__ uint32_t widen2(uint32_t x) {
  float2 f;
  if constexpr (std::is_same<TC, int8_t>::value) {
    // bytes (b ^ 0x80, 0, 0, 0x4b): 2^23 + b + 128
    f.x = __uint_as_float(__byte_perm(x ^ 0x80808080u, 0x4b000000u, 0x7650u)) - 8388736.f;
    f.y = __uint_as_float(__byte_perm(x ^ 0x80808080u, 0x4b000000u, 0x7651u)) - 8388736.f;
  } else {
    f = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(x & 0xffffu), __NV_E4M3)));
  }
  return pack_bf16(f.x, f.y);
}

// Eight codes (code j in byte j % 4 of word j / 4) as four bf16 pairs.
template <typename TC>
__device__ __forceinline__ uint4 widen8(uint2 w) {
  return make_uint4(widen2<TC>(w.x), widen2<TC>(w.x >> 16), widen2<TC>(w.y),
                    widen2<TC>(w.y >> 16));
}

}  // namespace tile
}  // namespace pmt
