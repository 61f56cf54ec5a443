// GEMM: c (M, N) float32 = a (M, K) @ b (K, N), a and b float32 or
// bfloat16, row-major, products summed in float32.
//
// Replaces the TPU kernel gemm_pallas (src/repro/kernels/gemm/gemm.py):
// a (M/bm, N/bn, K/bk) grid whose sequential K axis kept each output
// tile in VMEM as an fp32 accumulator while the matrix unit took
// 128-aligned products.
//
// What bounds it on the H100: operations.  An (8192, 8192, 8192)
// product is 1.1 TFLOP against ~0.8 GB moved; in float32 on the CUDA
// cores that is ~16 ms at the card's fp32 rate.  This first kernel runs
// on the CUDA cores (tensor cores, wgmma and TMA are later work): each
// block owns a 128 x 128 output tile and walks K in steps of 8, staging
// an (128 x 8) slab of a, transposed, and an (8 x 128) slab of b in
// shared memory as float32; each of its 256 threads keeps an 8 x 8 tile
// of sums in registers and does 64 FMAs per 16 shared-memory reads.  A
// thread's 8 columns are two groups of 4, 64 apart, so a warp's reads of
// b are contiguous 16-byte vectors without bank conflicts; the a slab is
// padded so its transposing stores do not conflict either.  The loop
// over K inside the block takes the place of the TPU's sequential grid
// axis.  Tiles at the ragged edges load zeros and store nothing outside
// c, so any M, N, K work.
#include "common.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 8, TM = 8, THREADS = 256;
constexpr int APAD = 4;  // row pitch BM + 4 floats: 16-byte aligned, conflict-free

template <typename T>
__global__ void __launch_bounds__(THREADS)
    gemm_kernel(const T* __restrict__ a, const T* __restrict__ b, float* __restrict__ c, int M,
                int N, int K) {
  __shared__ __align__(16) float as[BK][BM + APAD];
  __shared__ __align__(16) float bs[BK][BN];
  const int tid = threadIdx.x;
  const int tr = tid / 16;  // rows tr * 8 .. +8 of the tile
  const int tc = tid % 16;  // columns tc * 4 .. +4 and 64 + tc * 4 .. +4
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int u = 0; u < BM * BK / THREADS; ++u) {
      const int i = tid + u * THREADS;
      const int m = i / BK, k = i % BK;
      const int gm = row0 + m, gk = k0 + k;
      as[k][m] = (gm < M && gk < K) ? pmt::to_f(a[(size_t)gm * K + gk]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < BK * BN / THREADS; ++u) {
      const int i = tid + u * THREADS;
      const int k = i / BN, n = i % BN;
      const int gk = k0 + k, gn = col0 + n;
      bs[k][n] = (gk < K && gn < N) ? pmt::to_f(b[(size_t)gk * N + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[k][tr * TM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[k][tr * TM + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[k][tc * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[k][64 + tc * 4]);
      const float av[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = row0 + tr * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = col0 + (j < 4 ? tc * 4 + j : 64 + tc * 4 + (j - 4));
      if (gn < N) c[(size_t)gm * N + gn] = acc[i][j];
    }
  }
}

}  // namespace

// a: (M, K), b: (K, N) of `dtype` (0 = float32, 1 = bfloat16), c: (M, N)
// float32, all row-major on the device.  Returns cudaGetLastError() after
// the launch.
extern "C" int pmt_gemm(const void* a, const void* b, void* c, int M, int N, int K, int dtype,
                        void* stream) {
  if (M == 0 || N == 0) return 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    gemm_kernel<float><<<grid, THREADS, 0, st>>>(static_cast<const float*>(a),
                                                 static_cast<const float*>(b),
                                                 static_cast<float*>(c), M, N, K);
  else
    gemm_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
        static_cast<float*>(c), M, N, K);
  return static_cast<int>(cudaGetLastError());
}
