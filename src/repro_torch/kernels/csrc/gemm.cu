// GEMM: c (M, N) float32 = a (M, K) @ b (K, N), a and b float32 or
// bfloat16, row-major, products of the exact input values summed in
// float32.
//
// Replaces the TPU kernel gemm_pallas (src/repro/kernels/gemm/gemm.py):
// a (M/bm, N/bn, K/bk) grid whose sequential K axis kept each output
// tile in VMEM as an fp32 accumulator while the matrix unit took
// 128-aligned products.
//
// What bounds it on the H100: operations.  An (8192, 8192, 8192)
// product is 1.1 TFLOP against ~0.8 GB moved: ~16.4 ms at the card's 67
// TFLOP/s of float32 FMA.  It stays on the CUDA cores in full float32:
// wgmma takes float32 operands only as TF32, which keeps 10 of the 23
// mantissa bits, and a product that rounds its inputs so misses both the
// function (exact products) and the card check's 1e-5 of max |c|; a
// 3xTF32 split (three TF32 products per term) rounds each product
// another way and is not this kernel.  So the design is about feeding
// the FMA units without stalls:
//
//  * each thread keeps a 16 x 8 tile of sums in registers: 128 FMAs per
//    6 16-byte shared reads.  An H100 SM does 128 float32 FMAs a clock
//    but reads 128 bytes of shared memory a clock, and a 16-byte read
//    takes one such wavefront per quarter warp, so an 8 x 8 tile a
//    thread (64 FMAs per 4 reads) keeps shared memory as busy as the FMA
//    units (it reached 65% of the bound, PERF.md); 16 x 8 leaves it 75%
//    busy.  That takes ~220 registers a thread;
//  * a block of 256 threads (8 warps, one block an SM at that register
//    count) owns a 128 x 256 tile of c, so each slab it loads feeds
//    2 x 128 x 256 x 16 FLOP; on the card this beat 256 x 128, 128 x 128
//    at two blocks an SM and 64 x 256 (cuBLAS's float32 tile);
//  * K is walked in slabs of 16 (32 and 8 were slower) through a ring of
//    two shared buffers: while the FMAs run on one slab the next slab's
//    global loads are in flight (b by 16-byte cp.async straight into
//    shared memory; a as 16-byte loads into registers, stored transposed
//    after the FMAs, since its slab is read along M), so a slab costs one
//    barrier and global latency hides behind 2048 FMAs a thread;
//  * each warp covers a 64 x 64 piece of the tile (lanes 4 x 8, a lane's
//    rows four groups of 4 16 apart, its columns two groups of 4 32
//    apart): a quarter warp reads one 16-byte vector of a (a broadcast)
//    or 128 contiguous bytes of b;
//  * blocks run in groups of 8 block rows down a column of b panels, so
//    the a panels of a group and the b panel under way stay in L2;
//  * c is written as float4.
// Under this load the card draws ~650 W of its 700 W, and the kernel
// stays some 8% behind torch.matmul's float32 kernel (PERF.md).
//
// bfloat16 inputs take the same pipeline: a thread's 16-byte loads hold 8
// values each, widened to float32 as they are stored into shared memory.
// 16-byte loads need each row of a and b to start on 16 bytes (K and N
// multiples of 4 floats or 8 bf16, aligned pointers); otherwise the
// loader reads element by element after the FMAs, with the same ring and
// the same FMAs, so any M, N and K work.  Ragged edges read zeros and
// write nothing outside c.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using pmt::sm90::cp_async16;
using pmt::sm90::cp_async_commit;
using pmt::sm90::cp_async_wait;

// A thread's sums: TM x TN, as float4 groups (rows 4 a group, LY * 4
// apart; columns 4 a group, LX * 4 apart).  Lanes LY x LX a warp, warps
// WY x WX a block.
constexpr int TM = 16, TN = 8, LY = 4, LX = 8, WY = 2, WX = 4, BK = 16, GROUP_M = 8;
constexpr int THREADS = 32 * WY * WX;
constexpr int BM = WY * LY * TM, BN = WX * LX * TN;
constexpr int APITCH = BM + 4;  // floats: 16-byte rows

struct Smem {
  float a[2][BK][APITCH];  // a slab transposed: [k][m]
  float b[2][BK][BN];      // b slab as it lies: [k][n]
};

// One slab's loads (load) and the stores that finish them (store), by
// element type and path.  A thread moves chunks t, t + THREADS, ... of
// each slab, a chunk being 16 bytes (4 floats or 8 bf16, along k for a
// and along n for b) on the 16-byte paths and one element otherwise.  On
// the 16-byte paths load puts the slab in flight (into registers, or, for
// float32 b, into shared memory by cp.async) and store, after the FMAs,
// writes the registers to shared memory, so the loads' latency hides
// behind the FMAs.  The element path (ragged shapes) keeps no registers
// in flight: store reads and writes each element.
template <typename T, bool kVec>
struct Loader {
  static constexpr int kW = kVec ? 16 / sizeof(T) : 1;  // elements a chunk
  static constexpr int kA = BM * BK / kW / THREADS;      // chunks a thread
  static constexpr int kB = BK * BN / kW / THREADS;
  static constexpr bool kAsync = kVec && sizeof(T) == 4;  // b by cp.async
  uint4 ra[kVec ? kA : 1], rb[kVec && !kAsync ? kB : 1];

  // chunk j of a: row, k; of b: k, n (slab-relative)
  static __device__ __forceinline__ void a_at(int j, int& m, int& k) {
    const int i = threadIdx.x + j * THREADS;
    m = i / (BK / kW), k = (i % (BK / kW)) * kW;
  }
  static __device__ __forceinline__ void b_at(int j, int& k, int& n) {
    const int i = threadIdx.x + j * THREADS;
    k = i / (BN / kW), n = (i % (BN / kW)) * kW;
  }

  // A 16-byte chunk lies wholly inside or wholly outside the matrix: on
  // those paths K and N are multiples of kW.
  __device__ __forceinline__ void load(const T* a, const T* b, int M, int N, int K, int row0,
                                       int col0, int k0, Smem& s, int buf) {
    if constexpr (kVec) {
#pragma unroll
      for (int j = 0; j < kA; ++j) {
        int m, k;
        a_at(j, m, k);
        m += row0, k += k0;
        ra[j] = (m < M && k < K) ? *reinterpret_cast<const uint4*>(a + (size_t)m * K + k)
                                 : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int j = 0; j < kB; ++j) {
        int k, n;
        b_at(j, k, n);
        const bool in = k0 + k < K && col0 + n < N;
        const T* src = in ? b + (size_t)(k0 + k) * N + col0 + n : b;
        if constexpr (kAsync)
          cp_async16(&s.b[buf][k][n], src, in ? 16 : 0);
        else
          rb[j] = in ? *reinterpret_cast<const uint4*>(src) : make_uint4(0, 0, 0, 0);
      }
      if constexpr (kAsync) cp_async_commit();
    }
  }

  __device__ __forceinline__ void store(const T* a, const T* b, int M, int N, int K, int row0,
                                        int col0, int k0, Smem& s, int buf) const {
#pragma unroll
    for (int j = 0; j < kA; ++j) {
      int m, k;
      a_at(j, m, k);
      if constexpr (kVec) {
        const T* e = reinterpret_cast<const T*>(&ra[j]);
#pragma unroll
        for (int u = 0; u < kW; ++u) s.a[buf][k + u][m] = pmt::to_f(e[u]);
      } else {
        const int gm = row0 + m, gk = k0 + k;
        s.a[buf][k][m] = (gm < M && gk < K) ? pmt::to_f(a[(size_t)gm * K + gk]) : 0.f;
      }
    }
    if constexpr (!kAsync) {
#pragma unroll
      for (int j = 0; j < kB; ++j) {
        int k, n;
        b_at(j, k, n);
        if constexpr (kVec) {
          const T* e = reinterpret_cast<const T*>(&rb[j]);
#pragma unroll
          for (int u = 0; u < kW; ++u) s.b[buf][k][n + u] = pmt::to_f(e[u]);
        } else {
          const int gk = k0 + k, gn = col0 + n;
          s.b[buf][k][n] = (gk < K && gn < N) ? pmt::to_f(b[(size_t)gk * N + gn]) : 0.f;
        }
      }
    }
  }
};

template <typename T, bool kVec>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_kernel(const T* __restrict__ a, const T* __restrict__ b, float* __restrict__ c, int M,
                int N, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int t = threadIdx.x;

  // grouped order: GROUP_M block rows walk the block columns together
  const int nbm = (M + BM - 1) / BM, nbn = (N + BN - 1) / BN;
  const int per_group = GROUP_M * nbn;
  const int first = (int)(blockIdx.x / per_group) * GROUP_M;
  const int rows_in_group = min(nbm - first, GROUP_M);
  const int in_group = (int)(blockIdx.x % per_group);
  const int row0 = (first + in_group % rows_in_group) * BM;
  const int col0 = (in_group / rows_in_group) * BN;

  const int warp = t >> 5, lane = t & 31;
  const int ra = (warp / WX) * LY * TM + (lane / LX) * 4;  // rows ra + LY * 4 i .. +3
  const int cb = (warp % WX) * LX * TN + (lane % LX) * 4;  // columns cb + LX * 4 j .. +3

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  Loader<T, kVec> ld;
  const int nk = (K + BK - 1) / BK;
  if (nk > 0) {
    ld.load(a, b, M, N, K, row0, col0, 0, s, 0);
    ld.store(a, b, M, N, K, row0, col0, 0, s, 0);
    cp_async_wait<0>();
  }
  __syncthreads();
  for (int it = 0; it < nk; ++it) {
    const int cur = it & 1;
    const bool next = it + 1 < nk;
    if (next) ld.load(a, b, M, N, K, row0, col0, (it + 1) * BK, s, cur ^ 1);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM / 4; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(&s.a[cur][k][ra + LY * 4 * i]);
        av[4 * i] = x.x, av[4 * i + 1] = x.y, av[4 * i + 2] = x.z, av[4 * i + 3] = x.w;
      }
#pragma unroll
      for (int j = 0; j < TN / 4; ++j) {
        const float4 x = *reinterpret_cast<const float4*>(&s.b[cur][k][cb + LX * 4 * j]);
        bv[4 * j] = x.x, bv[4 * j + 1] = x.y, bv[4 * j + 2] = x.z, bv[4 * j + 3] = x.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (next) {
      ld.store(a, b, M, N, K, row0, col0, (it + 1) * BK, s, cur ^ 1);
      cp_async_wait<0>();
    }
    __syncthreads();  // the next slab is in; nobody reads this one any more
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = row0 + ra + LY * 4 * (i / 4) + i % 4;
    if (gm >= M) continue;
#pragma unroll
    for (int h = 0; h < TN / 4; ++h) {
      const int gn = col0 + cb + LX * 4 * h;
      float* out = c + (size_t)gm * N + gn;
      if (kVec) {  // N % 4 == 0: the 4 columns are all in or all out
        if (gn < N)
          *reinterpret_cast<float4*>(out) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gn + j < N) out[j] = acc[i][4 * h + j];
      }
    }
  }
}

template <typename T, bool kVec>
int launch_as(const void* a, const void* b, void* c, int M, int N, int K, cudaStream_t st) {
  auto kernel = gemm_kernel<T, kVec>;
  constexpr int bytes = sizeof(Smem);
  if (bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = (unsigned)((M + BM - 1) / BM) * (unsigned)((N + BN - 1) / BN);
  kernel<<<blocks, THREADS, bytes, st>>>(static_cast<const T*>(a), static_cast<const T*>(b),
                                         static_cast<float*>(c), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* a, const void* b, void* c, int M, int N, int K, cudaStream_t st) {
  constexpr int kVecElems = 16 / sizeof(T);
  const bool vec = K % kVecElems == 0 && N % kVecElems == 0 &&
                   reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(c) % 16 == 0;
  return vec ? launch_as<T, true>(a, b, c, M, N, K, st) : launch_as<T, false>(a, b, c, M, N, K, st);
}

}  // namespace

// a: (M, K), b: (K, N) of `dtype` (0 = float32, 1 = bfloat16), c: (M, N)
// float32, all row-major on the device.  Returns cudaGetLastError() after
// the launch.
extern "C" int pmt_gemm(const void* a, const void* b, void* c, int M, int N, int K, int dtype,
                        void* stream) {
  if (M == 0 || N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, b, c, M, N, K, st);
  if (dtype == 1) return launch<__nv_bfloat16>(a, b, c, M, N, K, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
