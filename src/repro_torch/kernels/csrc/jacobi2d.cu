// JACOBI2D: one 5-point Jacobi sweep over a float32 (H, W) grid.
// Interior cells get 0.2 * (c + up + down + left + right); boundary rows
// and columns keep x.  The result goes to a new array: x is never
// written.
//
// Replaces the TPU kernel jacobi2d_pallas
// (src/repro/kernels/jacobi2d/jacobi2d.py), which tiled full-width row
// blocks and bound the same input three times to reach the rows above
// and below its block.
//
// Rounding: the sum is taken in the JAX reference's order,
// ((((c + up) + down) + left) + right), then scaled by 0.2f, which gives
// its bits exactly.
//
// What bounds it on the H100: bytes.  It does 5 FLOP per cell against 8
// bytes (one read, one write), so at (16384, 16384) the bound is 2.15 GB
// over 3.35 TB/s (0.641 ms).  To keep the memory busy a thread must have
// many bytes in flight, so the design streams 16-byte vectors:
//  - each thread owns COLS = 4 adjacent columns (one float4), a warp 128,
//    a block of THREADS = 128 threads 512; it walks down a strip of
//    ROWS = 4 rows and loads all of the strip's ROWS + 2 rows (one above,
//    one below) into registers before any arithmetic: 6 16-byte loads in
//    flight a thread, 96 bytes, every warp load one 512-byte run;
//  - the left and right neighbours of its columns come from its own
//    float4 and, across lanes, by __shfl_up_sync / __shfl_down_sync; at
//    the warp's two edges lane 0 and lane 31 load the one column outside
//    (4 bytes a row, lines the neighbouring warp reads: L1 or L2);
//  - the rows above and below are read again by the neighbouring strips
//    (2 / ROWS more reads), which run at about the same time, so those
//    reads hit L2: the grid runs across the width first (blockIdx.x),
//    strip after strip;
//  - no division or modulo per element: the interior tests are
//    comparisons of the row and the column;
//  - stores are st.global.cs (evict-first): out is not read again.
// W % 4 != 0, or x or out off 16-byte alignment, take the element path:
// the same walk with one column a thread (COLS = 1) and 4-byte accesses,
// exact at any 4-byte alignment.
// Timed by kernel_variants.py on an H100 80GB HBM3 at 700 W (10 rounds,
// medians) at (16384, 16384): this design 0.7157 ms (3.00 TB/s), against
// 0.7090 for x.clone() (the same bytes moved, no stencil); in turns with
// the first port (32 x 8 blocks staging a 34 x 10 halo tile in shared
// memory, one 4-byte load a cell) 0.7149 against 1.4167.  Variants timed
// the same way and not kept: ROWS 8, 16, 32 0.7197, 0.7252, 0.7245
// (more registers, fewer blocks resident; the halo rows they save come
// from L2 anyway); 64 and 256 threads 0.7172, 0.7169; ROWS 2 0.7133, 0.3%
// faster, not taken: it reads every row three times and halves the
// tallest grid the launch takes (65535 strips).
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 128;  // threads a block, along the row
constexpr int ROWS = 4;       // rows a thread walks down

// Element j of a thread's columns (j is known at compile time: the loops
// over it are unrolled, so this stays in registers).
__device__ __forceinline__ float& at(float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}
__device__ __forceinline__ float& at(float& v, int) { return v; }

// Grid (ceil(W / (THREADS * COLS)), ceil(H / ROWS)).  COLS is 4 when W
// is a multiple of 4 and x, out are 16-byte aligned (every row then
// starts aligned and a thread's 4 columns are all in range or all out),
// else 1.
template <int COLS>
__global__ void __launch_bounds__(THREADS)
    jacobi2d_kernel(const float* __restrict__ x, float* __restrict__ out, int H, int W) {
  using T = std::conditional_t<COLS == 4, float4, float>;
  const int lane = threadIdx.x & 31;
  const int c0 = (blockIdx.x * THREADS + threadIdx.x) * COLS;  // first column
  const int y0 = blockIdx.y * ROWS;                            // first row
  const bool in = c0 < W;
  // the column a warp-edge lane loads beside its own: lane 0's left,
  // lane 31's right
  const int ce = lane == 0 ? c0 - 1 : c0 + COLS;
  const bool edge = (lane == 0 || lane == 31) && ce >= 0 && ce < W;
  T r[ROWS + 2];  // rows y0 - 1 .. y0 + ROWS of this thread's columns
  float e[ROWS];  // column ce of rows y0 .. y0 + ROWS - 1
#pragma unroll
  for (int i = 0; i < ROWS + 2; ++i) {
    const int y = y0 - 1 + i;
    if (in && y >= 0 && y < H)
      r[i] = *reinterpret_cast<const T*>(x + (size_t)y * W + c0);
    else
      r[i] = T{};
  }
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int y = y0 + i;
    e[i] = edge && y < H ? x[(size_t)y * W + ce] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int y = y0 + i;
    T& c = r[i + 1];
    // the neighbours across lanes: the last column of lane - 1, the first
    // of lane + 1
    const float from_left = __shfl_up_sync(0xffffffffu, at(c, COLS - 1), 1);
    const float from_right = __shfl_down_sync(0xffffffffu, at(c, 0), 1);
    if (!in || y >= H) continue;
    T o = c;
    if (y > 0 && y < H - 1) {
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int col = c0 + j;
        if (col > 0 && col < W - 1) {
          const float left = j > 0 ? at(c, j - 1) : lane == 0 ? e[i] : from_left;
          const float right = j < COLS - 1 ? at(c, j + 1) : lane == 31 ? e[i] : from_right;
          at(o, j) = 0.2f * ((((at(c, j) + at(r[i], j)) + at(r[i + 2], j)) + left) + right);
        }
      }
    }
    __stcs(reinterpret_cast<T*>(out + (size_t)y * W + c0), o);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int COLS>
void launch(const void* x, void* out, int H, int W, cudaStream_t stream) {
  const dim3 grid((W + THREADS * COLS - 1) / (THREADS * COLS), (H + ROWS - 1) / ROWS);
  jacobi2d_kernel<COLS><<<grid, THREADS, 0, stream>>>(static_cast<const float*>(x),
                                                      static_cast<float*>(out), H, W);
}

}  // namespace

// x, out: (H, W) float32, row-major, on the device, not overlapping.
// Returns cudaGetLastError() after the launch.
extern "C" int pmt_jacobi2d(const void* x, void* out, int H, int W, void* stream) {
  if (H == 0 || W == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (W % 4 == 0 && aligned16(x) && aligned16(out))
    launch<4>(x, out, H, W, st);
  else
    launch<1>(x, out, H, W, st);
  return static_cast<int>(cudaGetLastError());
}
