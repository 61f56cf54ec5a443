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
// over 3.35 TB/s (~0.64 ms).  The design gives each 32 x 8 block of
// threads a shared-memory tile with a one-cell halo (34 x 10), loaded
// with neighbouring threads on neighbouring columns, so every cell is
// read from device memory about 1.3 times (the halo's share mostly hits
// L2) and written once, coalesced.
#include <cuda_runtime.h>

namespace {

constexpr int TX = 32, TY = 8;

__global__ void __launch_bounds__(TX* TY)
    jacobi2d_kernel(const float* __restrict__ x, float* __restrict__ out, int H, int W) {
  __shared__ float tile[TY + 2][TX + 2];
  const int bx = blockIdx.x * TX, by = blockIdx.y * TY;
  const int t = threadIdx.y * TX + threadIdx.x;
  for (int i = t; i < (TY + 2) * (TX + 2); i += TX * TY) {
    const int ty = i / (TX + 2), tx = i % (TX + 2);
    const int yy = by + ty - 1, xx = bx + tx - 1;
    tile[ty][tx] = (yy >= 0 && yy < H && xx >= 0 && xx < W) ? x[(size_t)yy * W + xx] : 0.f;
  }
  __syncthreads();
  const int gx = bx + threadIdx.x, gy = by + threadIdx.y;
  if (gx >= W || gy >= H) return;
  const int sx = threadIdx.x + 1, sy = threadIdx.y + 1;
  const float c = tile[sy][sx];
  float r = c;
  if (gy > 0 && gy < H - 1 && gx > 0 && gx < W - 1) {
    const float up = tile[sy - 1][sx], down = tile[sy + 1][sx];
    const float left = tile[sy][sx - 1], right = tile[sy][sx + 1];
    r = 0.2f * ((((c + up) + down) + left) + right);
  }
  out[(size_t)gy * W + gx] = r;
}

}  // namespace

// x, out: (H, W) float32, row-major, on the device, not overlapping.
// Returns cudaGetLastError() after the launch.
extern "C" int pmt_jacobi2d(const void* x, void* out, int H, int W, void* stream) {
  if (H == 0 || W == 0) return 0;
  const dim3 block(TX, TY);
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY);
  jacobi2d_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), H, W);
  return static_cast<int>(cudaGetLastError());
}
