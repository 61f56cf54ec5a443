// An empty kernel: the floor of a launch on the card, the yardstick that
// the scatters (whose bytes take ~0.002 us) are read against.  Replaces
// no TPU kernel and no serve path runs it; chip_smoke.py phase 3 times it
// in a CUDA graph at one block of 32 threads and at a scatter pair's
// grid.
#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

// Launches empty_kernel on a (gx, gy) grid of `threads`-thread blocks.
// Returns cudaGetLastError() after the launch.
extern "C" int pmt_empty(int gx, int gy, int threads, void* stream) {
  empty_kernel<<<dim3(gx, gy), threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
