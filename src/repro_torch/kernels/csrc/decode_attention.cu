// Length-aware flash-decode: one new query token per row against its
// KV cache, the query heads of one kv head together.  Two layouts of the
// cache share one kernel, templated on how a logical key position
// becomes an address: a contiguous (B, C, KVH, hd) cache, and physical
// page pools (P, ps, KVH, hd) addressed through a (B, NB) page table.
//
// Replaces the TPU kernels decode_attention_pallas and
// decode_attention_paged_pallas
// (src/repro/kernels/decode_attention/decode_attention.py), their
// quantized branches included.  Same function: q (B, KVH, G, hd) against
// the cache with the new token already at its slot, the attendable slots
// [first, last] with last = min(lens[b], C - 1) and first = 0, or
// lens[b] - window + 1 for a windowed paged row; optional logit softcap;
// one online softmax in fp32; output in q's dtype.  Every slot in
// [first, last] is attendable under the plain versions' masks (a ring
// below its size holds positions 0..lens[b]; a wrapped ring, every slot;
// tests/test_torch_decode_split.py pins it), so the kernel masks only
// the keys past the end of its range, and reads no key outside it.  The
// TPU kernels walked a sequential grid axis over key blocks with the
// running max, sum and accumulator in VMEM scratch.
//
// What bounds it on the H100: latency, then bytes; not arithmetic.  Each
// key and value is read once for G query heads (3 for smollm-135m):
// about 2 G flops per byte, where the bf16 tensor cores need ~295.  The
// serve path's case (B8 C1024 KVH3 G3 hd64 bf16, chip_smoke.py phase 3)
// moves 0.83 us of cache at 3.35 TB/s and does ~8 MFLOP (~0.12 us at 67
// TFLOP/s in fp32).  So the kernel stays on the CUDA cores in fp32: an
// mma.m16n8k16 would leave 13 of its 16 rows idle at G 3, and the fp32
// and code caches need fp32 operands to keep their tolerances.  What
// sets its time is the chain of dependent steps, not the bytes: measured
// on an H100 80GB HBM3 at 700 W in a CUDA graph (chip_smoke.py phase 3),
// the case takes ~0.0095 ms against SDPA's ~0.011 (the first port of
// this kernel, one block per (row, kv head) walking 64-key tiles with
// synchronous loads: 0.094), and one split a row, which walks 16 tiles
// in turn, ~0.020: each tile's shuffle tree, exponentials and FMAs on
// few warps an SM wait on one another.  The design:
//
//  * Split-KV.  The grid is (B * KVH * head groups, splits).  Split s
//    takes an equal share of the row's range, rounded up to 16 keys
//    (split_range below; kernels/split_kv.py split_range is the same
//    function).  The host picks the split count from the capacity C and
//    the number of blocks a split has (lens lives on the card:
//    decode_attention/kernel.py split_count).  Each split writes its
//    unnormalised (m, l, acc) to a workspace; the last block of a
//    (row, kv head, head group) to arrive, found by an atomic ticket,
//    folds the partials in split order (bit for bit whatever the order
//    of arrival), writes the output and resets its ticket to 0: one
//    launch, no memset, capturable in a CUDA graph.  Each of the fold's
//    two phases (the weights, then the accumulators) puts every split's
//    loads in flight at once; 8 splits at most (the host's cap): more
//    made the serve case slower.  A split whose share is empty loads
//    nothing and only takes its ticket; a row with no attendable key (a
//    dead paged row of a burst) writes exactly 0, as the TPU kernel does
//    (the plain blockwise version, which folds every block, returns the
//    mean of its values there).
//  * Warp-parallel keys, state in registers.  A lane holds 8 elements of
//    a row (one 16-byte load of bf16, two of float32, one 8-byte load of
//    codes, so every type has the same layout and register budget), and
//    a group of D / 8 lanes (at most 32) holds one key: 4 groups a warp
//    at hd 64.  Each group keeps its own online softmax (m, l) and its
//    slice of the p.v accumulator for the block's query heads in
//    registers, with q, already scaled, beside them; a key's dot product
//    is 8 FMAs a lane and a shuffle tree over the group.  The groups of
//    a warp merge by shuffles and the warps through shared memory once,
//    at the end of the split.  Codes are dequantized in registers,
//    float(code) * scale for each element before its FMA (the op order
//    of kernels/quant.py; the scale is not factored out of the dot):
//    an int8 code widens by a byte permute and one subtraction, fp8
//    codes two at a time through half.  Over codes the case takes 5-9%
//    longer than over bf16 for half the bytes: the loop is bound by its
//    instructions' latency, and dequantizing adds to them.
//  * Loads ahead of use.  A group takes its keys a tile of up to 4 at a
//    time (2 for float32, 1 at D 512) and loads tile i + 1 into registers
//    before it computes tile i.  A paged tile's rows come from the page
//    table by a (page, offset) cursor stepped from key to key and tile to
//    tile, with no division by the page size.  Rows that are not whole
//    8-element units or are misaligned are read element by element into
//    the same registers.
//
// Head widths: D = 64, 128, 256 or 512 (the smallest that holds hd and
// hdv; lanes past a row's width hold zeros).  v's rows may be wider than
// hdv (vld elements, the values their first hdv): MLA's aliased latent
// cache passes k as v, vld = hd; such inputs with bf16 q take the
// tensor-core latent_attention.cu instead, this kernel the others (fp32
// q, a window, a ring, a softcap) up to width 512.  A block takes 4 query heads
// (2 at D 512, where a lane holds two chunks of a row); G is split over
// blocks of that many, so G does not enter the shared memory or the
// registers.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kEl = 8;          // elements of a row in one lane's chunk
constexpr int kMaxSplits = 16;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {  // 2^x; 0 for -inf
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__host__ __device__ inline int width_of(int hd, int hdv) {
  const int w = hd > hdv ? hd : hdv;
  return w <= 64 ? 64 : w <= 128 ? 128 : w <= 256 ? 256 : w <= 512 ? 512 : 0;
}

// Query heads a block of head width D takes: 4, or 2 at D 512, where a
// lane holds two chunks of a row.
__host__ __device__ constexpr int heads_of(int D) { return D == 512 ? 2 : 4; }

// Lanes of a block of head width D.
template <int D> struct Shape {
  static constexpr int kLanes = D / kEl < 32 ? D / kEl : 32;  // on one key
  static constexpr int kChunks = D / (kEl * kLanes);           // of a row, a lane
  static constexpr int kHeads = heads_of(D);                    // query heads a block
  static constexpr int kGroups = 32 / kLanes;                   // key groups a warp
};

// Shared memory, in floats, for `heads` query heads: the warps' partials
// (kWarps x heads x hdv, then their m and l), the warps' weights
// (kWarps x heads), the block's M and L (2 x heads), the fold's weights
// (kMaxSplits x heads).
__host__ __device__ inline size_t smem_floats(int heads, int hdv) {
  return (size_t)heads * ((size_t)kWarps * (hdv + 2) + kWarps + 2 + kMaxSplits);
}

// Split s's keys [lo, hi) of the range [start, limit): shares of
// ceil(n / nsplit) rounded up to 16 keys, so the last splits may be empty.
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

// 8 elements of T as raw bits.
template <typename T> struct Chunk {
  uint32_t w[2 * sizeof(T)];
};

// A whole chunk at p: one 8-byte load of codes, one 16-byte load of bf16,
// two of float32 (p aligned to the load).
template <typename T>
__device__ __forceinline__ void load_chunk(Chunk<T>& c, const T* p) {
  if constexpr (sizeof(T) == 1) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    c.w[0] = x.x;
    c.w[1] = x.y;
  } else {
#pragma unroll
    for (int i = 0; i < (int)sizeof(T) / 2; ++i) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(p) + i);
      c.w[4 * i] = x.x;
      c.w[4 * i + 1] = x.y;
      c.w[4 * i + 2] = x.z;
      c.w[4 * i + 3] = x.w;
    }
  }
}

template <typename T> __device__ __forceinline__ uint32_t bits_of(T x);
template <> __device__ __forceinline__ uint32_t bits_of<float>(float x) {
  return __float_as_uint(x);
}
template <> __device__ __forceinline__ uint32_t bits_of<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat16_as_ushort(x);
}
template <> __device__ __forceinline__ uint32_t bits_of<int8_t>(int8_t x) {
  return static_cast<uint8_t>(x);
}
template <> __device__ __forceinline__ uint32_t bits_of<__nv_fp8_e4m3>(__nv_fp8_e4m3 x) {
  return x.__x;
}

// The first n (<= 8) elements at p one by one, the rest 0.
template <typename T>
__device__ __forceinline__ void load_elems(Chunk<T>& c, const T* p, int n) {
#pragma unroll
  for (int i = 0; i < 2 * (int)sizeof(T); ++i) c.w[i] = 0u;
#pragma unroll
  for (int j = 0; j < kEl; ++j)
    if (j < n) c.w[j * sizeof(T) / 4] |= bits_of(p[j]) << (8 * (j * sizeof(T) % 4));
}

template <typename T>
__device__ __forceinline__ void zero_chunk(Chunk<T>& c) {
#pragma unroll
  for (int i = 0; i < 2 * (int)sizeof(T); ++i) c.w[i] = 0u;
}

// The 8 elements of a chunk, widened exactly to float32.  An int8 code
// is biased into the low mantissa byte of 2^23 (one byte permute) and
// the bias subtracted, which is exact and takes no conversion unit;
// fp8 codes convert two at a time through half.
template <typename T>
__device__ __forceinline__ void widen(const Chunk<T>& c, float (&f)[kEl]) {
#pragma unroll
  for (int j = 0; j < kEl; ++j) {
    const uint32_t w = c.w[j * sizeof(T) / 4];
    if constexpr (sizeof(T) == 4) {
      f[j] = __uint_as_float(w);
    } else if constexpr (sizeof(T) == 2) {
      f[j] = __uint_as_float(j % 2 ? w & 0xffff0000u : w << 16);
    } else if constexpr (std::is_same<T, int8_t>::value) {
      // bytes (b ^ 0x80, 0, 0, 0x4b): 2^23 + b + 128
      const uint32_t x = __byte_perm(w ^ 0x80808080u, 0x4b000000u, 0x7650u | (j % 4));
      f[j] = __uint_as_float(x) - 8388736.f;
    } else if (j % 2 == 0) {
      const __half2 h(__nv_cvt_fp8x2_to_halfraw2(
          static_cast<__nv_fp8x2_storage_t>(w >> (8 * (j % 4))), __NV_E4M3));
      const float2 p = __half22float2(h);
      f[j] = p.x;
      f[j + 1] = p.y;
    }
  }
}

// Whether rows base + r * stride of `width` elements move in whole
// chunks: width a multiple of 8 and every chunk aligned to its loads.
template <typename T>
__device__ __forceinline__ bool chunks_ok(const T* base, int width, size_t stride) {
  constexpr size_t kAlign = 8 * sizeof(T) < 16 ? 8 * sizeof(T) : 16;
  return width % kEl == 0 && (stride * sizeof(T)) % kAlign == 0 &&
         reinterpret_cast<uintptr_t>(base) % kAlign == 0;
}

// One lane's chunks of up to K keys of k and v, and their row scales.
template <typename T, int K, int CH> struct Tile {
  Chunk<T> k[K][CH], v[K][CH];
  float ks[K], vs[K];
};

__device__ __forceinline__ float load_q(const void* q, size_t i, int q_bf16) {
  return q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(q)[i])
                : static_cast<const float*>(q)[i];
}

__device__ __forceinline__ void store_out(void* out, size_t i, float x, int q_bf16) {
  if (q_bf16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(x);  // nearest even, as torch
  else
    static_cast<float*>(out)[i] = x;
}

// kPaged: k, v are pools (P, ps, KVH, hd) and page_table is (B, NB),
// C = NB * ps; otherwise k, v are (B, C, KVH, hd).  A code type TKV
// (int8_t, __nv_fp8_e4m3) reads ksc, vsc: the row scales (rows x KVH,
// rows counted as k's).  q and out are bf16 with q_bf16, else float32.
// ws: the splits' partials (unused with one split); tickets: one zeroed
// int per block of a split.
template <typename TKV, bool kPaged, int D>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const void* __restrict__ q, const TKV* __restrict__ k,
                        const TKV* __restrict__ v, const float* __restrict__ ksc,
                        const float* __restrict__ vsc, const int* __restrict__ lens,
                        const int* __restrict__ page_table, void* __restrict__ out,
                        float* __restrict__ ws, int* __restrict__ tickets, int C, int NB, int ps,
                        int KVH, int G, int hd, int hdv, int vld, float scale, int ring,
                        int window, float softcap, int q_bf16, int nsplit) {
  using S = Shape<D>;
  constexpr int H = S::kHeads, L = S::kLanes, CH = S::kChunks;
  constexpr int NG = kWarps * S::kGroups;  // key groups a block
  constexpr int KPG = 4 / (CH * (sizeof(TKV) == 4 ? 2 : 1)) > 0
                          ? 4 / (CH * (sizeof(TKV) == 4 ? 2 : 1)) : 1;  // keys a group a tile
  constexpr int kSpan = NG * KPG;                                        // keys a tile
  constexpr bool kQuant = pmt::is_code<TKV>::value;
  extern __shared__ float smem[];
  __shared__ int is_last;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int li = lane % L;                       // lane in its key group
  const int gi = warp * S::kGroups + lane / L;   // key group in the block
  const int hgroups = (G + H - 1) / H;
  const int group = blockIdx.x, split = blockIdx.y;
  const int bh = group / hgroups, hg = group - bh * hgroups;
  const int b = bh / KVH, h = bh - b * KVH;
  const int g0 = hg * H, gn = min(H, G - g0);

  const int cur = lens[b];
  const int last = min(cur, C - 1);
  const int first = (!ring && window > 0) ? max(cur - (window - 1), 0) : 0;
  int lo, hi;
  split_range(first, last + 1, nsplit, split, lo, hi);

  // q, scaled, for this lane's elements of the block's heads (0 past hd
  // and for heads past G).
  const size_t qrow = (size_t)bh * G + g0;
  float qf[H][CH][kEl];
#pragma unroll
  for (int g = 0; g < H; ++g)
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int e = 0; e < kEl; ++e) {
        const int d = (c * L + li) * kEl + e;
        qf[g][c][e] = (g < gn && d < hd) ? load_q(q, (qrow + g) * hd + d, q_bf16) * scale : 0.f;
      }

  float m[H], l[H], acc[H][CH][kEl];
#pragma unroll
  for (int g = 0; g < H; ++g) {
    m[g] = PMT_NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int e = 0; e < kEl; ++e) acc[g][c][e] = 0.f;
  }

  const size_t kstride = (size_t)KVH * hd, vstride = (size_t)KVH * vld;
  const TKV* kh = k + (size_t)h * hd;
  const TKV* vh = v + (size_t)h * vld;
  const int* pt = kPaged ? page_table + (size_t)b * NB : nullptr;
  const bool kvec = chunks_ok(kh, hd, kstride), vvec = chunks_ok(vh, hdv, vstride);
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;

  // The (page, offset) cursor of this group's first key of a tile.
  int pi = 0, po = 0, step_pages = 0, step_rows = 0;
  if constexpr (kPaged) {
    const int p0 = lo + gi * KPG;
    pi = p0 / ps;
    po = p0 - pi * ps;
    step_pages = kSpan / ps;
    step_rows = kSpan - step_pages * ps;
  }

  // This group's keys base + gi * KPG + j of a tile, those before hi.
  auto load_tile = [&](Tile<TKV, KPG, CH>& t, int base, int qi, int qo) {
#pragma unroll
    for (int j = 0; j < KPG; ++j) {
      const int pos = base + gi * KPG + j;
      const bool on = pos < hi;
      size_t row = 0;
      if constexpr (kPaged) {
        if (on) row = (size_t)pt[qi] * ps + qo;
        if (++qo == ps) {
          qo = 0;
          ++qi;
        }
      } else {
        row = (size_t)b * C + pos;
      }
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int e0 = (c * L + li) * kEl;
        const TKV* kp = kh + row * kstride + e0;
        const TKV* vp = vh + row * vstride + e0;
        if (on && kvec && e0 < hd) load_chunk(t.k[j][c], kp);
        else if (on && !kvec && e0 < hd) load_elems(t.k[j][c], kp, min(hd - e0, kEl));
        else zero_chunk(t.k[j][c]);
        if (on && vvec && e0 < hdv) load_chunk(t.v[j][c], vp);
        else if (on && !vvec && e0 < hdv) load_elems(t.v[j][c], vp, min(hdv - e0, kEl));
        else zero_chunk(t.v[j][c]);
      }
      if constexpr (kQuant) {
        t.ks[j] = on ? __ldg(ksc + row * KVH + h) : 0.f;
        t.vs[j] = on ? __ldg(vsc + row * KVH + h) : 0.f;
      }
    }
  };

  Tile<TKV, KPG, CH> cur_t, next_t;
  if (lo < hi) load_tile(cur_t, lo, pi, po);
  for (int base = lo; base < hi; base += kSpan) {
    if constexpr (kPaged) {  // the cursor of the next tile
      po += step_rows;
      pi += step_pages;
      if (po >= ps) {
        po -= ps;
        ++pi;
      }
    }
    if (base + kSpan < hi) load_tile(next_t, base + kSpan, pi, po);

    // Scores of the tile's keys, in log2 units.
    float s[KPG][H];
#pragma unroll
    for (int j = 0; j < KPG; ++j) {
      float kf[CH][kEl];
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        widen(cur_t.k[j][c], kf[c]);
        if constexpr (kQuant)
#pragma unroll
          for (int e = 0; e < kEl; ++e) kf[c][e] *= cur_t.ks[j];
      }
#pragma unroll
      for (int g = 0; g < H; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < CH; ++c)
#pragma unroll
          for (int e = 0; e < kEl; ++e) dot = fmaf(qf[g][c][e], kf[c][e], dot);
        s[j][g] = dot;
      }
    }
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1)
#pragma unroll
      for (int j = 0; j < KPG; ++j)
#pragma unroll
        for (int g = 0; g < H; ++g) s[j][g] += __shfl_xor_sync(0xffffffffu, s[j][g], off);
    const bool tail = base + kSpan > hi;
#pragma unroll
    for (int j = 0; j < KPG; ++j)
#pragma unroll
      for (int g = 0; g < H; ++g) {
        float x = s[j][g];
        if (softcap > 0.f) x = tanhf(x * inv_cap) * softcap;
        x *= kLog2e;
        if (tail && base + gi * KPG + j >= hi) x = -INFINITY;  // weighs 0
        s[j][g] = x;
      }

    // The online softmax of each head over the tile's keys.
#pragma unroll
    for (int g = 0; g < H; ++g) {
      float mx = m[g];
#pragma unroll
      for (int j = 0; j < KPG; ++j) mx = fmaxf(mx, s[j][g]);
      const float alpha = ex2(m[g] - mx);
      m[g] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KPG; ++j) {
        s[j][g] = ex2(s[j][g] - mx);
        sum += s[j][g];
      }
      l[g] = alpha * l[g] + sum;
#pragma unroll
      for (int c = 0; c < CH; ++c)
#pragma unroll
        for (int e = 0; e < kEl; ++e) acc[g][c][e] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < KPG; ++j)
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        float vf[kEl];
        widen(cur_t.v[j][c], vf);
#pragma unroll
        for (int e = 0; e < kEl; ++e) {
          if constexpr (kQuant) vf[e] *= cur_t.vs[j];
#pragma unroll
          for (int g = 0; g < H; ++g) acc[g][c][e] = fmaf(s[j][g], vf[e], acc[g][c][e]);
        }
      }
    cur_t = next_t;
  }

  // The warp's key groups merge: a shuffle tree over the groups.
#pragma unroll
  for (int off = L; off < 32; off <<= 1)
#pragma unroll
    for (int g = 0; g < H; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mx = fmaxf(m[g], mo);
      const float a = ex2(m[g] - mx), w = ex2(mo - mx);
      l[g] = a * l[g] + w * lo_;
      m[g] = mx;
#pragma unroll
      for (int c = 0; c < CH; ++c)
#pragma unroll
        for (int e = 0; e < kEl; ++e)
          acc[g][c][e] = a * acc[g][c][e] + w * __shfl_xor_sync(0xffffffffu, acc[g][c][e], off);
    }

  // The block's warps merge through shared memory, in warp order.
  float* wacc = smem;                         // [kWarps][H][hdv]
  float* wml = wacc + kWarps * H * hdv;       // [kWarps][H][2]: m, l
  float* wwt = wml + kWarps * H * 2;          // [kWarps][H]
  float* bml = wwt + kWarps * H;              // [H][2]: M, L
  float* fwt = bml + 2 * H;                   // [kMaxSplits][H]
  if (lane < L) {
#pragma unroll
    for (int g = 0; g < H; ++g)
#pragma unroll
      for (int c = 0; c < CH; ++c)
#pragma unroll
        for (int e = 0; e < kEl; ++e) {
          const int d = (c * L + li) * kEl + e;
          if (d < hdv) wacc[(warp * H + g) * hdv + d] = acc[g][c][e];
        }
    if (lane == 0)
#pragma unroll
      for (int g = 0; g < H; ++g) {
        wml[(warp * H + g) * 2] = m[g];
        wml[(warp * H + g) * 2 + 1] = l[g];
      }
  }
  __syncthreads();
  if (tid < H) {
    float mx = PMT_NEG_INF;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wml[(w * H + tid) * 2]);
    float sum = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float a = ex2(wml[(w * H + tid) * 2] - mx);
      wwt[w * H + tid] = a;
      sum += a * wml[(w * H + tid) * 2 + 1];
    }
    bml[2 * tid] = mx;
    bml[2 * tid + 1] = sum;
  }
  __syncthreads();
  auto merged = [&](int g, int d) {
    float a = 0.f;
    for (int w = 0; w < kWarps; ++w) a = fmaf(wwt[w * H + g], wacc[(w * H + g) * hdv + d], a);
    return a;
  };
  const size_t orow = (size_t)bh * G + g0;  // output rows of hdv
  if (nsplit == 1) {
    for (int i = tid; i < gn * hdv; i += kThreads) {
      const int g = i / hdv, d = i - g * hdv;
      store_out(out, (orow + g) * hdv + d, merged(g, d) / fmaxf(bml[2 * g + 1], 1e-30f), q_bf16);
    }
    return;
  }

  // Split-KV: this split's partial, then the ticket.
  const size_t groups = gridDim.x;
  auto acc_of = [&](int sp) { return ws + ((size_t)group * nsplit + sp) * H * hdv; };
  auto ml_of = [&](int sp) {
    return ws + groups * nsplit * H * hdv + ((size_t)group * nsplit + sp) * H * 2;
  };
  if (lo < hi) {
    float* pa = acc_of(split);
    for (int i = tid; i < gn * hdv; i += kThreads) {
      const int g = i / hdv, d = i - g * hdv;
      pa[i] = merged(g, d);
    }
    if (tid < gn) {
      ml_of(split)[2 * tid] = bml[2 * tid];
      ml_of(split)[2 * tid + 1] = bml[2 * tid + 1];
    }
  }
  // One thread takes the ticket with an acq_rel atomic: its release
  // publishes the block's writes (the barrier orders them before it), its
  // acquire lets the last block read every split's.
  __syncthreads();
  if (tid == 0) {
    int t;
    asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;"
                 : "=r"(t)
                 : "l"(tickets + group)
                 : "memory");
    is_last = t == nsplit - 1;
  }
  __syncthreads();
  if (!is_last) return;

  // The last block folds the partials in split order: weights
  // 2^(m_s - M) / L a head, then the weighted sum of the accumulators,
  // each phase with every split's loads in flight at once.
  unsigned live = 0;  // the splits that wrote a partial
  for (int sp = 0; sp < nsplit; ++sp) {
    int l0, h0;
    split_range(first, last + 1, nsplit, sp, l0, h0);
    if (h0 > l0) live |= 1u << sp;
  }
  if (tid < gn) {
    float mv[kMaxSplits], lv[kMaxSplits];
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp) {
      const bool on = (live >> sp) & 1u;
      mv[sp] = on ? __ldcg(ml_of(sp) + 2 * tid) : PMT_NEG_INF;
      lv[sp] = on ? __ldcg(ml_of(sp) + 2 * tid + 1) : 0.f;
    }
    float mx = PMT_NEG_INF, sum = 0.f;
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp) mx = fmaxf(mx, mv[sp]);
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp) {
      mv[sp] = (live >> sp) & 1u ? ex2(mv[sp] - mx) : 0.f;
      sum += mv[sp] * lv[sp];
    }
    const float inv = 1.f / fmaxf(sum, 1e-30f);
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp) fwt[sp * H + tid] = mv[sp] * inv;
  }
  __syncthreads();
  for (int i = tid; i < gn * hdv; i += kThreads) {
    const int g = i / hdv;
    float x[kMaxSplits];
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp)
      x[sp] = (live >> sp) & 1u ? __ldcg(acc_of(sp) + i) : 0.f;
    float sum = 0.f;
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp)
      if ((live >> sp) & 1u) sum = fmaf(fwt[sp * H + g], x[sp], sum);
    store_out(out, orow * hdv + i, sum, q_bf16);
  }
  if (tid == 0) tickets[group] = 0;  // ready for the next launch
}

struct Args {
  const void *q, *k, *v, *ksc, *vsc, *lens, *page_table;
  void *out, *ws, *tickets;
  int B, C, NB, ps, KVH, G, hd, hdv, vld;
  float scale;
  int ring, window;
  float softcap;
  int q_bf16, nsplit;
};

template <typename TKV, bool kPaged, int D>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int H = Shape<D>::kHeads;
  const size_t bytes = smem_floats(H, a.hdv) * sizeof(float);  // < 48 KB up to hdv 512
  const dim3 grid(a.B * a.KVH * ((a.G + H - 1) / H), a.nsplit);
  decode_attention_kernel<TKV, kPaged, D><<<grid, kThreads, bytes, stream>>>(
      a.q, static_cast<const TKV*>(a.k), static_cast<const TKV*>(a.v),
      static_cast<const float*>(a.ksc), static_cast<const float*>(a.vsc),
      static_cast<const int*>(a.lens), static_cast<const int*>(a.page_table), a.out,
      static_cast<float*>(a.ws), static_cast<int*>(a.tickets), a.C, a.NB, a.ps, a.KVH, a.G,
      a.hd, a.hdv, a.vld, a.scale, a.ring, a.window, a.softcap, a.q_bf16, a.nsplit);
  return static_cast<int>(cudaGetLastError());
}

template <typename TKV, bool kPaged>
int by_width(const Args& a, cudaStream_t s) {
  switch (width_of(a.hd, a.hdv)) {
    case 64: return launch<TKV, kPaged, 64>(a, s);
    case 128: return launch<TKV, kPaged, 128>(a, s);
    case 256: return launch<TKV, kPaged, 256>(a, s);
    case 512: return launch<TKV, kPaged, 512>(a, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool kPaged>
int dispatch(Args a, int q_dtype, int kv_dtype, void* stream) {
  if (a.B == 0 || a.KVH == 0 || a.G == 0) return 0;
  if (q_dtype != 0 && q_dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (a.vld < a.hdv) return static_cast<int>(cudaErrorInvalidValue);
  if (kv_dtype >= 2 && (a.ksc == nullptr || a.vsc == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);  // codes need their scales
  if (a.nsplit < 1 || a.nsplit > kMaxSplits || a.tickets == nullptr ||
      (a.nsplit > 1 && a.ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  a.q_bf16 = q_dtype;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kv_dtype) {
    case 0: return by_width<float, kPaged>(a, s);
    case 1: return by_width<__nv_bfloat16, kPaged>(a, s);
    case 2: return by_width<int8_t, kPaged>(a, s);
    case 3: return by_width<__nv_fp8_e4m3, kPaged>(a, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, out: (B, KVH, G, hd/hdv) of q_dtype; k, v: (B, C, KVH, hd/vld) of
// kv_dtype (the values the first hdv <= vld lanes of v's rows); k_scale, v_scale: (B, C, KVH) float32 for the code types,
// else ignored (may be null); lens: (B,) int32.  dtype codes: 0 =
// float32, 1 = bfloat16, 2 = int8, 3 = fp8_e4m3 (q: 0 or 1).  softcap
// <= 0 means no softcap.  ws: the splits' partials, B * KVH *
// ceil(G / heads) * nsplit * heads * (hdv + 2) float32 (heads: 4, or 2
// when hd or hdv exceeds 256; unused with one split); tickets: at least
// B * KVH * ceil(G / heads) int32 that are 0 (and are 0 again when the
// kernel ends); nsplit in 1..16.  hd and hdv at most 512.  Returns
// cudaGetLastError().
extern "C" int pmt_decode_attention(const void* q, const void* k, const void* v,
                                    const void* k_scale, const void* v_scale,
                                    const void* lens, void* out, void* ws, void* tickets,
                                    int B, int C, int KVH, int G, int hd, int hdv, int vld,
                                    float scale, int ring, float softcap, int q_dtype,
                                    int kv_dtype, int nsplit, void* stream) {
  const Args a{q,  k,   v,  k_scale, v_scale, lens,  nullptr, out,   ws,   tickets, B,
               C,  1,   C,  KVH,     G,       hd,    hdv,     vld,   scale, ring,   0,
               softcap, 0, nsplit};
  return dispatch<false>(a, q_dtype, kv_dtype, stream);
}

// q, out as above; k_pool, v_pool: (P, ps, KVH, hd/vld) of kv_dtype;
// k_scale, v_scale: (P, ps, KVH) float32 pools for the code types;
// page_table: (B, NB) int32, every entry a page of the pools; lens: (B,)
// int32.  window <= 0 and softcap <= 0 mean none.  ws, tickets and
// nsplit as above.  Returns cudaGetLastError().
extern "C" int pmt_decode_attention_paged(const void* q, const void* k_pool,
                                          const void* v_pool, const void* k_scale,
                                          const void* v_scale, const void* page_table,
                                          const void* lens, void* out, void* ws, void* tickets,
                                          int B, int NB, int ps, int KVH, int G, int hd, int hdv,
                                          int vld, float scale, int window, float softcap,
                                          int q_dtype, int kv_dtype, int nsplit, void* stream) {
  const Args a{q,  k_pool, v_pool, k_scale, v_scale, lens,   page_table, out,   ws,
               tickets, B,  NB * ps, NB,   ps,      KVH,    G,          hd,    hdv,
               vld,     scale, 0,   window, softcap, 0,     nsplit};
  return dispatch<true>(a, q_dtype, kv_dtype, stream);
}

// The dynamic shared memory a block launches with for these head widths
// (0 where hd or hdv exceeds 512): what decode_attention/kernel.py
// smem_bytes must give.
extern "C" int pmt_decode_smem_bytes(int hd, int hdv) {
  const int D = width_of(hd, hdv);
  return D ? static_cast<int>(smem_floats(heads_of(D), hdv) * sizeof(float)) : 0;
}
