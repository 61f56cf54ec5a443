// Per-row KV-cache scatter: cache[b, slots[b], :] = src[b, :] in place.
//
// Replaces the TPU kernel cache_update_pallas
// (src/repro/kernels/cache_update/cache_update.py), which aliased the
// cache to its output and wrote one (1, 1, F) block per batch row.
//
// What bounds it on the H100: nothing the card computes.  A decode step
// moves B * F elements per call (8 rows of 192 bf16 for smollm-135m,
// about 3 KB), which the memory system moves in well under a
// microsecond; the launch itself costs more, and the serve path makes
// two calls (k and v) per layer per decode step.  The design keeps the
// launch as light as it can be: one block per row, each thread moving
// 16 bytes at a time when the row size and both pointers allow it, the
// slot read by the block itself from device memory (no host sync), and
// the cache never copied.  Fusing the k and v scatters, or the scatter
// into the projection that produces the row, is the lever for later.
#include "common.cuh"

namespace {

__global__ void scatter_rows_kernel(char* __restrict__ cache,
                                    const char* __restrict__ src,
                                    const int* __restrict__ slots, int C,
                                    long long row_bytes, int vec16) {
  const int b = blockIdx.x;
  int s = slots[b];
  // Clamp like the reference's dynamic_update_slice: an out-of-range
  // slot writes the nearest row instead of memory outside the cache.
  s = s < 0 ? 0 : (s >= C ? C - 1 : s);
  char* dst = cache + ((long long)b * C + s) * row_bytes;
  const char* from = src + (long long)b * row_bytes;
  if (vec16) {
    const int4* f4 = reinterpret_cast<const int4*>(from);
    int4* d4 = reinterpret_cast<int4*>(dst);
    for (long long i = threadIdx.x; i < row_bytes / 16; i += blockDim.x) d4[i] = f4[i];
  } else {
    for (long long i = threadIdx.x; i < row_bytes; i += blockDim.x) dst[i] = from[i];
  }
}

}  // namespace

// cache: (B, C, F) elements of row_bytes / F bytes; src: (B, F); slots: (B,)
// int32, all on the device.  Returns cudaGetLastError() after the launch.
extern "C" int pmt_cache_update(void* cache, const void* src, const void* slots,
                                int B, int C, long long row_bytes, void* stream) {
  if (B == 0 || row_bytes == 0) return 0;
  const int vec16 = row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(cache) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(src) % 16 == 0;
  const long long units = vec16 ? row_bytes / 16 : row_bytes;
  const int threads = units >= 256 ? 256 : (units <= 32 ? 32 : (int)((units + 31) / 32) * 32);
  scatter_rows_kernel<<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<char*>(cache), static_cast<const char*>(src),
      static_cast<const int*>(slots), C, row_bytes, vec16);
  return static_cast<int>(cudaGetLastError());
}
