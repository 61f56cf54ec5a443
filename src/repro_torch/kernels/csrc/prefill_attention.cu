// Chunked-prefill attention: T chunk queries at positions offs[b] + t
// attend the cache prefix (positions < offs[b]) and their own causal
// keys in one online softmax.  Two layouts of the cache share one
// kernel, templated on how a logical key position becomes an address: a
// contiguous (B, C, KVH, hd) cache, and physical page pools
// (P, ps, KVH, hd) addressed through a (B, NB) page table.
//
// Replaces the TPU kernels prefill_attention_pallas and
// prefill_attention_paged_pallas
// (src/repro/kernels/prefill_attention/prefill_attention.py).  Same
// function: q packed (B, KVH, T, G, hd) so that the G query heads of a
// kv head share each key; phase 1 folds the cache's positions below
// min(offs[b], C) (a ring cache of size C maps slot s to position
// (offs-1) - ((offs-1-s) mod C) and masks positions outside the window;
// an unwrapped cache, contiguous or paged, masks q_pos - col >= window
// when a window is given), phase 2 the chunk's own k/v (B, T, KVH, hd)
// with `t >= col` (and `t - col < window`); softcap optional; fp32
// softmax; output in q's dtype.  The TPU kernels walked one sequential
// grid axis over both phases (one page per cache step in the paged one)
// with the running state in VMEM; here one block per (row, kv head, tile
// of 16 packed query rows) loops over the 64-key tiles of both phases
// and keeps the state in shared memory.  A paged tile gathers its keys
// from as many pages as they span: the block first turns each position
// into its physical row (page_table[b, pos / ps] * ps + pos % ps) in
// shared memory, then loads the rows.
//
// Quantized caches (int8 or fp8_e4m3 codes with one float32 scale per
// (position, kv head) row beside them) replace the quantized branch of
// both TPU kernels.  Only the cache prefix holds codes: the chunk's own
// k/v arrive at q's precision.  Both kernels read the codes at their own
// width and the tile's row scales through the same row mapping (for a
// paged tile, the same physical rows); nothing dequantized goes to device
// memory.  The CUDA-core loop (fp32 q) stages float(code) * scale in
// shared memory; the tensor-core kernel (bf16 q) keeps the scales out of
// its products (below).
//
// What bounds it on the H100: at the serve path's shapes (a 32-token
// chunk, 3 query heads per kv head, prefixes up to ~1k) each key tile
// is used by 96 query rows, ~0.1k flops per byte, still below the
// ~295 flops per byte the bf16 tensor cores need, so bytes bound it in
// principle; but this first kernel computes its dot products on the
// CUDA cores in fp32, which caps it near 67 TFLOP/s, and it has only
// B * KVH * ceil(T * G / 16) blocks (18 per batch row for smollm-135m),
// so in practice it is latency-bound.  The design keeps the TPU kernels'
// property that cache positions outside a row's attendable range
// (at or past offs[b]; with a window on an unwrapped cache, below
// offs[b] - window + 1) are never read, and skips chunk tiles that lie
// wholly above the block's last query.
//
// bf16 q (q and chunk bf16, the cache bf16 or codes, hd and hdv up to
// 128; rows 2 and 8 of the serve path, and 2q and 8q over codes):
// prefill_tc_kernel below, on the tensor cores and split over blocks.  At the serve path's shapes the CUDA-core loop above
// took 0.12 ms for work whose bytes take 0.15 us: 18 blocks on 132 SMs,
// each walking 9 key tiles one after another, loading each synchronously
// and forming every dot product from shared memory one element at a time.
// The redesign attacks each of those:
//
//  * Tensor cores.  A block holds 16 packed (t, g) query rows per warp,
//    up to 8 warps (96 rows, 6 warps, for smollm-135m's 32-token chunk
//    and 3 query heads per kv head: no row wasted).  S = q . k^T and
//    O += p . v run as mma.sync m16n8k16 (bf16 in, fp32 accumulate) on
//    fragments read with ldmatrix from bf16 tiles.  mma.sync rather than
//    wgmma: wgmma's 64-row tiles would leave a third of 96 rows idle,
//    and a paged tile gathers 16-key pages, which TMA would fetch as
//    several boxes a tile.  The scale multiplies the fp32 scores (q is
//    never rounded to bf16 after scaling); softcap, masks and the online
//    softmax run on the accumulator fragments in log2 units, the masks
//    as one interval of columns a row (a ring cache's slot-to-position
//    map per element), a masked key weighing 0 (-inf against a running
//    max that starts at the finite NEG_INF); each fp32 p goes through the
//    tensor cores as bf16 p_hi + p_lo (as in flash_attention.cu), so p
//    keeps ~16 bits and l sums the fp32 p.  hd and hdv are zero-padded in
//    shared memory up to the kernel's width D (32, 64 or 128), a multiple
//    of 16.  A warp's work on a tile is a serial chain (the mma, the
//    softmax's shuffles and exponentials, the mma again): per-element
//    branches and integer divisions in it cost more than the mma, so
//    none is left there.
//  * Asynchronous copies.  q and each 32-key tile of k and v move by
//    16-byte cp.async into a ring of three tiles: tiles i + 1 and i + 2
//    are in flight while tile i is computed, and a tile costs one
//    barrier.  A paged tile's row addresses come from the page table as
//    each row's copy starts.  Rows past a tile's end are zero-filled (0 x
//    garbage could be NaN).  Rows that are not whole 16-byte units (hd or
//    hdv not a multiple of 8, or misaligned tensors) are copied element
//    by element into the same ring.
//  * More blocks (split-KV).  The grid is (splits, row tiles, B * KVH).
//    Split s takes an equal share of the row's attendable cache range,
//    rounded up to 16 keys (the range lives on the card, so the host
//    picks the split count from the capacity C and the batch:
//    prefill_attention/kernel.py split_count); the last split also takes
//    the chunk's own keys, so it is never empty and every row's partial
//    there has a real maximum.  Each split writes its unnormalised
//    (m, l, acc) to a workspace; the last block of a (row, kv head, row
//    tile) to arrive, found by an atomic ticket, folds the partials in
//    split order (deterministic whatever the arrival order), writes the
//    output and resets its ticket to 0, so one launch does it all and no
//    memset precedes it.  The fold puts every split's loads of a row in
//    flight at once: one L2 round trip, not one per split (with one per
//    split, 16 splits were slower on the card than one); still, it grows
//    with the splits, so they stop at 8.  Splits whose share is empty
//    load nothing and only take their ticket.  The tickets are one int32 per (row, kv
//    head, row tile), zero between launches: launches that share a
//    ticket array run one after another (one stream).
//
//  * Codes (rows 2q and 8q).  A bf16 operand would round float(code) *
//    scale, so that product is never formed.  Every int8 code and every
//    finite e4m3 value is exact in bf16 (8 and 4 significant bits), and so
//    is its product with a bf16 q in the fp32 accumulator; the row scales
//    come out of both sums: q . (code_c ks_c) = (q . code_c) ks_c, and
//    sum_c p_c (code_c vs_c) = sum_c (p_c vs_c) code_c.  So a cache tile
//    moves as codes (16-byte cp.async, 16 codes a copy: half of bf16's
//    bytes) into a byte ring beside the bf16 one, its 32 k and 32 v row
//    scales (4-byte cp.async, KVH floats apart) in the same commit group;
//    once it has landed, the block widens it exactly into the tile's bf16
//    slot (one more barrier a cache tile), and ldmatrix and the mma chain
//    run as for bf16.  Column c's k scale joins the score's multiplier
//    (mul * ks_c, or cap_in * ks_c under softcap), and each p is
//    multiplied by its v scale before its hi + lo split; l sums the
//    unscaled p, and the chunk's own keys take a scale of 1.  The result
//    differs from the plain versions' codes.float() * scale by fp32
//    rounding order (~1e-7 relative).  Code rows that are not whole
//    16-byte units (hd or hdv not a multiple of 16, or misaligned codes)
//    are copied element by element into the same ring; the scales past a
//    tile's end are zero-filled like the code rows.
//
// The fp32 q instantiations keep the CUDA-core loop: their fp32 values
// would be rounded by a bf16 operand.  So do bf16 heads wider than 128,
// whose fragments would not fit the registers.
//
// The CUDA-core loop also takes v rows wider than hdv (vld elements, the
// values their first hdv): MLA's aliased latent cache passes k as v
// (vld = hd).  Such inputs with bf16 q take the tensor-core
// latent_attention.cu instead; this loop the others (fp32 q, a window,
// a ring, a softcap) where they fit its shared memory.
#include "common.cuh"
#include "hopper.cuh"
#include "tile.cuh"

namespace {

constexpr int kRows = 16;     // packed (t, g) query rows per block
constexpr int kTile = 64;     // keys per tile
constexpr int kThreads = 128;

// Shared memory, in floats: q (kRows x hd) | k tile (kTile x hd+1) |
// v tile (kTile x hdv) | scores (kRows x kTile) | acc (kRows x hdv) |
// m, l, alpha (kRows each).
__host__ __device__ inline size_t smem_floats(int hd, int hdv) {
  return (size_t)kRows * hd + (size_t)kTile * (hd + 1) + (size_t)kTile * hdv +
         (size_t)kRows * kTile + (size_t)kRows * hdv + 3 * (size_t)kRows;
}

// kPaged: kc, vc are pools (P, ps, KVH, hd) and page_table is (B, NB),
// C = NB * ps; otherwise kc, vc are (B, C, KVH, hd) and page_table unused.
// A code type TC (int8_t, __nv_fp8_e4m3) reads ksc, vsc: the cache's row
// scales (rows x KVH, rows counted as kc's); other types ignore them.
template <typename TQ, typename TC, bool kPaged>
__global__ void __launch_bounds__(kThreads)
prefill_attention_kernel(const TQ* __restrict__ q, const TQ* __restrict__ kx,
                         const TQ* __restrict__ vx, const TC* __restrict__ kc,
                         const TC* __restrict__ vc, const float* __restrict__ ksc,
                         const float* __restrict__ vsc, const int* __restrict__ offs,
                         const int* __restrict__ page_table, TQ* __restrict__ out, int T,
                         int C, int NB, int ps, int KVH, int G, int hd, int hdv, int vld,
                         float scale, int ring, int window, float softcap) {
  extern __shared__ float smem[];
  __shared__ int rows_[kTile];  // physical rows of a paged tile's keys
  __shared__ float kscl[kTile], vscl[kTile];  // a quantized tile's row scales
  constexpr bool kQuant = pmt::is_code<TC>::value;
  const int b = blockIdx.x, h = blockIdx.y;
  const int row0 = blockIdx.z * kRows;
  const int rows_total = T * G;
  const int rows = min(kRows, rows_total - row0);
  float* qs = smem;
  float* ks = qs + kRows * hd;
  float* vs = ks + kTile * (hd + 1);
  float* ps_ = vs + kTile * hdv;
  float* acc = ps_ + kRows * kTile;
  float* m = acc + kRows * hdv;
  float* l = m + kRows;
  float* alpha = l + kRows;

  const int off = offs[b];
  const size_t head = (size_t)b * KVH + h;
  const TQ* qb = q + (head * rows_total + row0) * hd;
  for (int i = threadIdx.x; i < kRows * hd; i += kThreads)
    qs[i] = i < rows * hd ? pmt::to_f(qb[i]) * scale : 0.f;
  for (int i = threadIdx.x; i < kRows * hdv; i += kThreads) acc[i] = 0.f;
  for (int i = threadIdx.x; i < kRows; i += kThreads) {
    m[i] = PMT_NEG_INF;
    l[i] = 0.f;
  }

  // Scores of this block's rows against one loaded key tile, masked.
  // phase 1: cache positions lo + c; phase 2: chunk keys lo + c.
  auto scores = [&](int lo, int n, bool cache_phase) {
    for (int i = threadIdx.x; i < kRows * kTile; i += kThreads) {
      const int r = i / kTile, c = i - r * kTile;
      float s = PMT_NEG_INF;
      if (r < rows && c < n) {
        const float* qr = qs + r * hd;
        const float* kr = ks + c * (hd + 1);
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
        if (softcap > 0.f) dot = tanhf(dot / softcap) * softcap;
        const int t = (row0 + r) / G;
        const int col = lo + c;
        bool valid;
        if (cache_phase) {
          const int q_pos = off + t;
          if (ring) {
            const int lastp = off - 1;
            const int pos = lastp - (((lastp - col) % C) + C) % C;
            valid = pos >= 0 && q_pos - pos < window;
          } else {
            valid = col < off && (window <= 0 || q_pos - col < window);
          }
        } else {
          const int diff = t - col;
          valid = diff >= 0 && (window <= 0 || diff < window);
        }
        s = valid ? dot : PMT_NEG_INF;
      }
      ps_[i] = s;
    }
  };

  auto fold = [&](int n) {
    __syncthreads();
    pmt::softmax_fold(ps_, m, l, alpha, kRows, kTile, n);
    __syncthreads();
    pmt::pv_fold(ps_, vs, acc, alpha, kRows, kTile, n, hdv);
  };

  // Phase 1: cache positions in [start, min(off, C)); none outside is
  // read.  Without a ring, positions below off - window + 1 are masked
  // for every query of the chunk (queries sit at off + t, t >= 0).
  const int limit = min(off, C);
  const int start = (!ring && window > 0) ? max(off - (window - 1), 0) : 0;
  const size_t kstride = (size_t)KVH * hd, vstride = (size_t)KVH * vld;
  const TC* kch = kc + (size_t)h * hd;
  const TC* vch = vc + (size_t)h * vld;
  const int* pt = kPaged ? page_table + (size_t)b * NB : nullptr;
  const bool kvec = pmt::rows_vec_ok(kch, hd, kstride);
  const bool vvec = pmt::rows_vec_ok(vch, hdv, vstride);
  for (int lo = start; lo < limit; lo += kTile) {
    const int n = min(kTile, limit - lo);
    __syncthreads();  // previous tile's readers are done with ks/vs/ps/rows
    if constexpr (kPaged || kQuant) {
      for (int r = threadIdx.x; r < n; r += kThreads) {
        const int pos = lo + r;  // < limit <= C, so pos / ps < NB
        if constexpr (kPaged) rows_[r] = pt[pos / ps] * ps + pos % ps;
        if constexpr (kQuant) {  // the codes' own rows, paged or not
          const size_t row = kPaged ? (size_t)rows_[r] : (size_t)b * C + pos;
          kscl[r] = ksc[row * KVH + h];
          vscl[r] = vsc[row * KVH + h];
        }
      }
      __syncthreads();
    }
    auto phys = [&](int r) -> size_t {
      if constexpr (kPaged) return (size_t)rows_[r];
      else return (size_t)b * C + lo + r;
    };
    pmt::load_rows<TC>(ks, [&](int r) { return kch + phys(r) * kstride; }, n, hd, kvec,
                       hd + 1, kscl);
    pmt::load_rows<TC>(vs, [&](int r) { return vch + phys(r) * vstride; }, n, hdv, vvec,
                       hdv, vscl);
    __syncthreads();
    scores(lo, n, true);
    fold(n);
  }

  // Phase 2: the chunk's own keys, up to this block's last query (keys
  // past it are masked for every row of the block).
  const int t_max = (row0 + rows - 1) / G;
  const TQ* kxb = kx + (size_t)b * T * KVH * hd + (size_t)h * hd;
  const TQ* vxb = vx + (size_t)b * T * KVH * vld + (size_t)h * vld;
  for (int lo = 0; lo <= t_max; lo += kTile) {
    const int n = min(kTile, T - lo);
    __syncthreads();
    pmt::load_tile(ks, kxb + (size_t)lo * KVH * hd, n, hd, (size_t)KVH * hd, hd + 1);
    pmt::load_tile(vs, vxb + (size_t)lo * KVH * vld, n, hdv, (size_t)KVH * vld, hdv);
    __syncthreads();
    scores(lo, n, false);
    fold(n);
  }

  __syncthreads();
  TQ* ob = out + (head * rows_total + row0) * hdv;
  for (int i = threadIdx.x; i < rows * hdv; i += kThreads)
    ob[i] = pmt::from_f<TQ>(acc[i] / fmaxf(l[i / hdv], 1e-30f));
}

struct Args {
  const void *q, *kx, *vx, *kc, *vc, *ksc, *vsc, *offs, *page_table;
  void* out;
  int B, T, C, NB, ps, KVH, G, hd, hdv, vld;
  float scale;
  int ring, window;
  float softcap;
};

template <typename TQ, typename TC, bool kPaged>
int launch(const Args& a, cudaStream_t stream) {
  const size_t bytes = smem_floats(a.hd, a.hdv) * sizeof(float);
  auto kernel = prefill_attention_kernel<TQ, TC, kPaged>;
  if (bytes > 48 * 1024) {  // above the default, opt in first
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(a.B, a.KVH, (a.T * a.G + kRows - 1) / kRows);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TQ*>(a.kx), static_cast<const TQ*>(a.vx),
      static_cast<const TC*>(a.kc), static_cast<const TC*>(a.vc),
      static_cast<const float*>(a.ksc), static_cast<const float*>(a.vsc),
      static_cast<const int*>(a.offs), static_cast<const int*>(a.page_table),
      static_cast<TQ*>(a.out), a.T, a.C, a.NB, a.ps, a.KVH, a.G, a.hd, a.hdv, a.vld,
      a.scale, a.ring, a.window, a.softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, bool kPaged>
int by_cache_type(const Args& a, int cache_dtype, cudaStream_t s) {
  if (cache_dtype >= 2 && (a.ksc == nullptr || a.vsc == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);  // codes need their scales
  switch (cache_dtype) {
    case 0: return launch<TQ, float, kPaged>(a, s);
    case 1: return launch<TQ, __nv_bfloat16, kPaged>(a, s);
    case 2: return launch<TQ, int8_t, kPaged>(a, s);
    case 3: return launch<TQ, __nv_fp8_e4m3, kPaged>(a, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool kPaged>
int dispatch(const Args& a, int q_dtype, int cache_dtype, void* stream) {
  if (a.B == 0 || a.T == 0 || a.KVH == 0) return 0;
  if (a.vld < a.hdv) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0) return by_cache_type<float, kPaged>(a, cache_dtype, s);
  if (q_dtype == 1) return by_cache_type<__nv_bfloat16, kPaged>(a, cache_dtype, s);
  return static_cast<int>(cudaErrorInvalidValue);
}


// -- bf16 q: tensor cores, split-KV ------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
using namespace pmt::sm90;
using namespace pmt::tile;

constexpr int kKT = 32;        // keys per tile
constexpr int kStages = 3;     // tiles of k and v in the ring
constexpr int kMaxWarps = 8;   // 16 packed query rows each
constexpr int kMaxSplits = 8;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory: q (16 x warps rows) | k ring (kStages x kKT rows) | v
// ring (kStages x kKT rows), bf16 rows of D + 8 (16 bytes of padding put
// the 8 rows of an ldmatrix on distinct banks); for a code cache TC, then
// the k and v code rings (kStages x kKT rows of D + 16 bytes each) and the
// scale ring (kStages x (kKT k and kKT v) floats).
template <typename TC>
__host__ __device__ inline size_t smem_bytes(int D, int nwarps) {
  size_t bytes = sizeof(bf16) * (size_t)(D + 8) * (16 * nwarps + 2 * kStages * kKT);
  if (pmt::is_code<TC>::value)
    bytes += (size_t)kStages * kKT * (2 * (size_t)(D + 16) + 2 * sizeof(float));
  return bytes;
}

// kPaged: kc, vc are pools (P, ps, KVH, hd) read through page_table
// (B, NB), C = NB * ps; otherwise (B, C, KVH, hd).  TC, the cache's
// element type: bf16, or int8_t / __nv_fp8_e4m3 codes with their row
// scales ksc, vsc (rows x KVH float32, rows counted as kc's; unused for
// bf16).  ws: the splits' partials (unused with one split); tickets: one
// zeroed int per (row, kv head, row tile).
template <int D, bool kPaged, typename TC>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
prefill_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kx,
                  const bf16* __restrict__ vx, const TC* __restrict__ kc,
                  const TC* __restrict__ vc, const float* __restrict__ ksc,
                  const float* __restrict__ vsc, const int* __restrict__ offs,
                  const int* __restrict__ page_table, bf16* __restrict__ out,
                  float* __restrict__ ws, int* __restrict__ tickets, int T, int C, int NB, int ps,
                  int KVH, int G, int hd, int hdv, float scale, int ring, int window,
                  float softcap, int nsplit) {
  constexpr bool kCodes = pmt::is_code<TC>::value;
  constexpr int P = D + 8;
  constexpr int CP = D + 16;  // bytes of a code ring row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int is_last;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int RB = nthreads / 2;  // 16 rows a warp
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + RB * P;
  bf16* vs = ks + kStages * kKT * P;
  uint8_t* kcs = reinterpret_cast<uint8_t*>(vs + kStages * kKT * P);  // codes
  uint8_t* vcs = kcs + kStages * kKT * CP;
  float* scl = reinterpret_cast<float*>(vcs + kStages * kKT * CP);  // [stage][k | v][kKT]

  const int split = blockIdx.x, bh = blockIdx.z;
  const int b = bh / KVH, h = bh - b * KVH;
  const int rows_total = T * G;
  const int row0 = blockIdx.y * RB;
  const int rows = min(RB, rows_total - row0);
  const int group = bh * gridDim.y + blockIdx.y;
  const int off = offs[b];
  // Cache positions [start, limit) may be attended (as in the CUDA-core
  // kernel): none at or past off is read, nor, with a window on an
  // unwrapped cache, any below off - window + 1.
  const int limit = min(off, C);
  const int start = (!ring && window > 0) ? max(off - (window - 1), 0) : 0;
  auto share = [&](int s, int& lo, int& hi) { split_range(start, limit, nsplit, s, lo, hi); };
  const bool last = split == nsplit - 1;
  int lo, hi;
  share(split, lo, hi);
  const int n_cache = (hi - lo + kKT - 1) / kKT;
  const int t_max = min(T - 1, (row0 + rows - 1) / G);  // chunk keys past it are masked
  const int ntiles = n_cache + (last ? t_max / kKT + 1 : 0);

  const int warp = tid >> 5, lane = tid & 31;
  const int r_lo = warp * 16 + (lane >> 2);  // this thread's rows r_lo and r_lo + 8
  const int tq = lane & 3;                   // and key / value columns 2 tq, 2 tq + 1
  const int tr[2] = {(row0 + r_lo) / G, (row0 + r_lo + 8) / G};

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_run[2] = {PMT_NEG_INF, PMT_NEG_INF}, l_run[2] = {0.f, 0.f};

  if (ntiles > 0) {
    const bf16 zero = __float2bfloat16(0.f);
    const size_t kstride = (size_t)KVH * hd, vstride = (size_t)KVH * hdv;
    // 16-byte copies of bf16 rows (q, the chunk, a bf16 cache) and, apart,
    // of code rows (16 codes a copy)
    uintptr_t bf16_ptrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(kx) |
                          reinterpret_cast<uintptr_t>(vx);
    if constexpr (!kCodes)
      bf16_ptrs |= reinterpret_cast<uintptr_t>(kc) | reinterpret_cast<uintptr_t>(vc);
    const bool vec = ((hd | hdv) & 7) == 0 && (bf16_ptrs & 15) == 0;
    const bool cvec =
        ((hd | hdv) & 15) == 0 &&
        ((reinterpret_cast<uintptr_t>(kc) | reinterpret_cast<uintptr_t>(vc)) & 15) == 0;
    // zero padding: columns [hd, D) of q and k rows, [hdv, D) of v rows
    for (int r = tid; r < RB + 2 * kStages * kKT; r += nthreads)
      for (int d = r < RB + kStages * kKT ? hd : hdv; d < D; ++d) qs[(size_t)r * P + d] = zero;
    if constexpr (kCodes)  // and of the code rows, which widen over all of D
      for (int r = tid; r < 2 * kStages * kKT; r += nthreads)
        for (int d = r < kStages * kKT ? hd : hdv; d < D; ++d) kcs[(size_t)r * CP + d] = 0;

    const bf16* qb = q + ((size_t)bh * rows_total + row0) * hd;
    if (vec) {
      const int ck = hd / 8;
      for (int i = tid; i < RB * ck; i += nthreads) {
        const int r = i / ck, c = i - r * ck;
        const bool in = r < rows;
        cp_async16(qs + r * P + c * 8, in ? qb + (size_t)r * hd + c * 8 : qb, in ? 16 : 0);
      }
    } else {
      for (int i = tid; i < RB * hd; i += nthreads) {
        const int r = i / hd, d = i - r * hd;
        qs[r * P + d] = r < rows ? qb[(size_t)r * hd + d] : zero;
      }
    }

    // Tile i: cache keys lo + i * kKT .. (i < n_cache), then the chunk's.
    auto tile_base = [&](int i) { return i < n_cache ? lo + i * kKT : (i - n_cache) * kKT; };
    auto tile_keys = [&](int i) {
      return i < n_cache ? min(kKT, hi - tile_base(i)) : min(kKT, T - tile_base(i));
    };
    // A thread's first 16-byte chunk of a tile's k rows (row rk, chunk
    // kc) and v rows, and its step (nthreads chunks) in rows and chunks:
    // the same for every tile, so a tile's loads divide nothing.
    const int ckk = vec ? hd / 8 : 1, ckv = vec ? hdv / 8 : 1;
    const int rk = tid / ckk, kc0 = tid % ckk, drk = nthreads / ckk, dck = nthreads % ckk;
    const int rv = tid / ckv, vc0 = tid % ckv, drv = nthreads / ckv, dcv = nthreads % ckv;
    // the same for code rows, 16 codes a chunk
    const int cck = cvec ? hd / 16 : 1, ccv = cvec ? hdv / 16 : 1;
    const int crk = tid / cck, kcc0 = tid % cck, cdrk = nthreads / cck, cdck = nthreads % cck;
    const int crv = tid / ccv, vcc0 = tid % ccv, cdrv = nthreads / ccv, cdcv = nthreads % ccv;
    const int ps_shift = (ps & (ps - 1)) == 0 ? __ffs(ps) - 1 : -1;  // pages of 2^k rows
    auto load_tile = [&](int i, int buf) {
      const bool cache = i < n_cache;
      const int base = tile_base(i), n = tile_keys(i);
      auto row_of = [&](int r) -> size_t {  // key row r's row in its tensor
        const int pos = base + r;
        if (!cache) return (size_t)b * T + pos;
        if constexpr (kPaged) {
          const int page = ps_shift >= 0 ? pos >> ps_shift : pos / ps;
          return (size_t)page_table[(size_t)b * NB + page] * ps + (pos - page * ps);
        } else {
          return (size_t)b * C + pos;
        }
      };
      // rows [0, n) of ck 16-byte chunks each, rows [n, kKT) zero-filled
      auto copy_rows = [&](auto* dst, const auto* src0, size_t stride, int pitch, int ck,
                           int r, int c, int dr, int dc) {
        using E = std::remove_pointer_t<decltype(dst)>;
        constexpr int el = 16 / sizeof(E);
        for (int i2 = tid; i2 < kKT * ck; i2 += nthreads) {
          const auto* src = r < n ? src0 + row_of(r) * stride + c * el : src0;
          cp_async16(dst + r * pitch + c * el, src, r < n ? 16 : 0);
          r += dr, c += dc;
          if (c >= ck) c -= ck, ++r;
        }
      };
      // the same element by element (rows that are not whole 16-byte units)
      auto copy_elems = [&](auto* kd, auto* vd, const auto* kt, const auto* vt, int pitch,
                            auto zero_el) {
        for (int i2 = tid; i2 < kKT * (hd + hdv); i2 += nthreads) {
          const bool is_k = i2 < kKT * hd;
          const int w = is_k ? hd : hdv;
          const int j = is_k ? i2 : i2 - kKT * hd;
          const int r = j / w, d = j - r * w;
          (is_k ? kd : vd)[r * pitch + d] =
              r < n ? (is_k ? kt : vt)[row_of(r) * (is_k ? kstride : vstride) + d] : zero_el;
        }
      };
      if constexpr (kCodes) {
        float* sd = scl + buf * 2 * kKT;
        if (cache) {  // codes into the code ring, their row scales beside them
          const uint8_t* kt = reinterpret_cast<const uint8_t*>(kc) + (size_t)h * hd;
          const uint8_t* vt = reinterpret_cast<const uint8_t*>(vc) + (size_t)h * hdv;
          uint8_t* kd = kcs + buf * kKT * CP;
          uint8_t* vd = vcs + buf * kKT * CP;
          if (cvec) {
            copy_rows(kd, kt, kstride, CP, cck, crk, kcc0, cdrk, cdck);
            copy_rows(vd, vt, vstride, CP, ccv, crv, vcc0, cdrv, cdcv);
          } else {
            copy_elems(kd, vd, kt, vt, CP, uint8_t{0});
          }
          for (int r = tid; r < 2 * kKT; r += nthreads) {  // k scales, then v scales
            const int rr = r & (kKT - 1);
            const float* s0 = r < kKT ? ksc : vsc;
            cp_async4(sd + r, rr < n ? s0 + row_of(rr) * KVH + h : s0, rr < n ? 4 : 0);
          }
          cp_async_commit();
          return;
        }
        for (int r = tid; r < 2 * kKT; r += nthreads) sd[r] = 1.f;  // chunk keys: unscaled
      }
      const bf16* kt = (cache ? reinterpret_cast<const bf16*>(kc) : kx) + (size_t)h * hd;
      const bf16* vt = (cache ? reinterpret_cast<const bf16*>(vc) : vx) + (size_t)h * hdv;
      bf16* kd = ks + buf * kKT * P;
      bf16* vd = vs + buf * kKT * P;
      if (vec) {
        copy_rows(kd, kt, kstride, P, ckk, rk, kc0, drk, dck);
        copy_rows(vd, vt, vstride, P, ckv, rv, vc0, drv, dcv);
      } else {
        copy_elems(kd, vd, kt, vt, P, zero);
      }
      cp_async_commit();
    };

    // A ring cache's slots map to positions through off (masks per
    // element); otherwise a row t attends an interval of columns: cache
    // positions [off + t - window + 1, off), chunk keys [t - window + 1,
    // t] (no lower end without a window).
    auto ring_ok = [&](int t, int col) -> bool {
      const int lastp = off - 1;
      const int pos = lastp - (((lastp - col) % C) + C) % C;
      return pos >= 0 && off + t - pos < window;
    };
    auto interval = [&](bool cache, int t, int& first, int& end) {
      end = cache ? off : t + 1;
      first = window > 0 ? end - window + (cache ? t + 1 : 0) : -(1 << 30);
    };

    // A landed code tile (k and v rows of slot buf, all kKT of them, over
    // all of D) widened exactly into the bf16 ring's slot buf, 8 codes a step.
    auto widen_tile = [&](int buf) {
      constexpr int kUnits = D / 8;  // of a row
      for (int u = tid; u < 2 * kKT * kUnits; u += nthreads) {
        const int row = u / kUnits, c = u - row * kUnits;  // row of k, then of v
        const int r = buf * kKT + (row & (kKT - 1));
        const uint8_t* src = (row < kKT ? kcs : vcs) + r * CP + c * 8;
        bf16* dst = (row < kKT ? ks : vs) + r * P + c * 8;
        *reinterpret_cast<uint4*>(dst) = widen8<TC>(*reinterpret_cast<const uint2*>(src));
      }
    };

    const float mul = scale * kLog2e;  // score -> log2 units
    const float cap_in = softcap > 0.f ? scale / softcap : 0.f, cap_out = softcap * kLog2e;
    uint32_t qf[D / 16][4];
    load_tile(0, 0);  // q rides in tile 0's group
    if (ntiles > 1) load_tile(1, 1);
    for (int i = 0; i < ntiles; ++i) {
      if (i + 1 < ntiles)  // tile i + 1 may still be in flight
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      // tile i is in for every thread, and every warp is done with tile
      // i - 1, whose slot tile i + 2 now takes
      __syncthreads();
      if (i + 2 < ntiles) load_tile(i + 2, (i + 2) % kStages);
      if constexpr (kCodes) {
        if (i < n_cache) {  // a cache tile's codes: widen them, then read
          widen_tile(i % kStages);
          __syncthreads();
        }
      }
      if (i == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          ldmatrix_x4(qf[kk], qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P +
                                  kk * 16 + (lane >> 4) * 8);
      }
      const bf16* kd = ks + (i % kStages) * kKT * P;
      const bf16* vd = vs + (i % kStages) * kKT * P;

      // S = q . k^T over this tile's keys (columns 8 j + 2 tq, + 1)
      float sc[kKT / 8][4];
#pragma unroll
      for (int j = 0; j < kKT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        if (kk * 16 >= hd) break;
#pragma unroll
        for (int np = 0; np < kKT / 16; ++np) {
          uint32_t kb[4];
          ldmatrix_x4(kb, kd + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * P + kk * 16 +
                              ((lane >> 3) & 1) * 8);
          mma_bf16_16816(sc[2 * np], qf[kk], kb[0], kb[1]);
          mma_bf16_16816(sc[2 * np + 1], qf[kk], kb[2], kb[3]);
        }
      }

      // scale, softcap, masks, online softmax (log2 units), on the fragments
      const bool cache = i < n_cache, ring_tile = cache && ring;
      const int base = tile_base(i), n = tile_keys(i);
      int first[2], end[2];  // tile columns c with first <= base + c < end
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        interval(cache, tr[u], first[u], end[u]);
        first[u] = max(first[u] - base, 0);
        end[u] = min(end[u] - base, n);
      }
      // x = score * scale (soft-capped) in log2 units; a masked key weighs
      // 0 outright: 2^(-inf - m) is 0, also while m is still NEG_INF.
      // Over codes the score is q . code, and column c's k scale joins
      // the multiplier (1 for the chunk's keys).
      const float* tscl = scl + (i % kStages) * 2 * kKT;  // this tile's k | v scales
      if constexpr (kCodes) {
        const float m0 = softcap > 0.f ? cap_in : mul;
#pragma unroll
        for (int j = 0; j < kKT / 8; ++j) {
          const float2 s = *reinterpret_cast<const float2*>(tscl + j * 8 + tq * 2);
          sc[j][0] *= m0 * s.x;
          sc[j][1] *= m0 * s.y;
          sc[j][2] *= m0 * s.x;
          sc[j][3] *= m0 * s.y;
        }
        if (softcap > 0.f) {
#pragma unroll
          for (int j = 0; j < kKT / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[j][e] = tanhf(sc[j][e]) * cap_out;
        }
      } else if (softcap > 0.f) {
#pragma unroll
        for (int j = 0; j < kKT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] = tanhf(sc[j][e] * cap_in) * cap_out;
      } else {
#pragma unroll
        for (int j = 0; j < kKT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] *= mul;
      }
      if (ring_tile) {
#pragma unroll
        for (int j = 0; j < kKT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = j * 8 + tq * 2 + (e & 1);
            if (!(c < n && ring_ok(tr[e >> 1], base + c))) sc[j][e] = -INFINITY;
          }
      } else {
#pragma unroll
        for (int j = 0; j < kKT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = j * 8 + tq * 2 + (e & 1), u = e >> 1;
            sc[j][e] = c >= first[u] && c < end[u] ? sc[j][e] : -INFINITY;
          }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < kKT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
      float alpha[2], lsum[2] = {0.f, 0.f};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 1));
        mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 2));
        const float m_new = fmaxf(m_run[u], mx[u]);  // NEG_INF at least: finite
        alpha[u] = ex2(m_run[u] - m_new);
        m_run[u] = m_new;
      }
#pragma unroll
      for (int j = 0; j < kKT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[j][e] = ex2(sc[j][e] - m_run[e >> 1]);
          lsum[e >> 1] += sc[j][e];
        }
#pragma unroll
      for (int u = 0; u < 2; ++u) l_run[u] = alpha[u] * l_run[u] + lsum[u];
#pragma unroll
      for (int n8 = 0; n8 < D / 8; ++n8) {
        o[n8][0] *= alpha[0];
        o[n8][1] *= alpha[0];
        o[n8][2] *= alpha[1];
        o[n8][3] *= alpha[1];
      }
      if constexpr (kCodes) {  // p . (code * vs) = (p * vs) . code; l keeps p
#pragma unroll
        for (int j = 0; j < kKT / 8; ++j) {
          const float2 s = *reinterpret_cast<const float2*>(tscl + kKT + j * 8 + tq * 2);
          sc[j][0] *= s.x;
          sc[j][1] *= s.y;
          sc[j][2] *= s.x;
          sc[j][3] *= s.y;
        }
      }

      // O += p . v, p as bf16 p_hi + p_lo: the score fragments of keys
      // 16 kk .. + 15 are the A fragment of that k step
#pragma unroll
      for (int kk = 0; kk < kKT / 16; ++kk) {
        uint32_t ph[4], pl[4];
        split_bf16(sc[2 * kk][0], sc[2 * kk][1], ph[0], pl[0]);
        split_bf16(sc[2 * kk][2], sc[2 * kk][3], ph[1], pl[1]);
        split_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ph[2], pl[2]);
        split_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
          if (np * 16 >= hdv) break;
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, vd + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P +
                                    np * 16 + (lane >> 4) * 8);
          mma_bf16_16816(o[2 * np], ph, vb[0], vb[1]);
          mma_bf16_16816(o[2 * np], pl, vb[0], vb[1]);
          mma_bf16_16816(o[2 * np + 1], ph, vb[2], vb[3]);
          mma_bf16_16816(o[2 * np + 1], pl, vb[2], vb[3]);
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) {  // a row's l is spread over its quad
    l_run[u] += __shfl_xor_sync(0xffffffffu, l_run[u], 1);
    l_run[u] += __shfl_xor_sync(0xffffffffu, l_run[u], 2);
  }

  const size_t out0 = (size_t)bh * rows_total + row0;
  if (nsplit == 1) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = r_lo + 8 * u;
      if (r >= rows) continue;
      const float l = fmaxf(l_run[u], 1e-30f);
      bf16* orow = out + (out0 + r) * hdv;
#pragma unroll
      for (int n8 = 0; n8 < D / 8; ++n8)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n8 * 8 + tq * 2 + e;
          if (c < hdv) orow[c] = __float2bfloat16(o[n8][2 * u + e] / l);
        }
    }
    return;
  }

  // Split-KV: this split's partial, then the ticket.
  const size_t groups = (size_t)gridDim.y * gridDim.z;
  auto acc_of = [&](int s) { return ws + ((size_t)group * nsplit + s) * RB * hdv; };
  auto ml_of = [&](int s) {
    return ws + groups * nsplit * RB * hdv + ((size_t)group * nsplit + s) * RB * 2;
  };
  if (ntiles > 0) {
    float* acc = acc_of(split);
    float* ml = ml_of(split);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = r_lo + 8 * u;
      if (r >= rows) continue;
#pragma unroll
      for (int n8 = 0; n8 < D / 8; ++n8)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n8 * 8 + tq * 2 + e;
          if (c < hdv) acc[(size_t)r * hdv + c] = o[n8][2 * u + e];
        }
      if (tq == 0) {
        ml[2 * r] = m_run[u];
        ml[2 * r + 1] = l_run[u];
      }
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(tickets + group, 1) == nsplit - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // The last block folds the partials in split order: weights
  // 2^(m_s - M) / L a row, then the weighted sum of the accumulators.
  // Each thread puts every split's loads in flight before it sums them:
  // one L2 round trip a row and a 4-column group, not one per split.
  unsigned live = 0;  // the splits that wrote a partial
  for (int s = 0; s < nsplit; ++s) {
    int l0, h0;
    share(s, l0, h0);
    if (s == nsplit - 1 || h0 > l0) live |= 1u << s;
  }
  float* wt = reinterpret_cast<float*>(smem_raw);  // [nsplit][RB], over q's slot
  for (int r = tid; r < rows; r += nthreads) {
    float mv[kMaxSplits], lv[kMaxSplits];
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      const bool on = (live >> s) & 1u;
      mv[s] = on ? __ldcg(ml_of(s) + 2 * r) : PMT_NEG_INF;
      lv[s] = on ? __ldcg(ml_of(s) + 2 * r + 1) : 0.f;
    }
    float M = PMT_NEG_INF, L = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) M = fmaxf(M, mv[s]);
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      mv[s] = (live >> s) & 1u ? ex2(mv[s] - M) : 0.f;
      L += mv[s] * lv[s];
    }
    const float inv = 1.f / fmaxf(L, 1e-30f);
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      if (s < nsplit) wt[s * RB + r] = mv[s] * inv;
  }
  __syncthreads();
  const int width = hdv % 4 == 0 ? 4 : 1;  // columns a thread sums at once
  const int groups_row = hdv / width;
  for (int i = tid; i < rows * groups_row; i += nthreads) {
    const int r = i / groups_row, d = (i - r * groups_row) * width;
    float4 v[kMaxSplits];
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      if (!((live >> s) & 1u)) continue;
      const float* src = acc_of(s) + (size_t)r * hdv + d;
      v[s] = width == 4 ? __ldcg(reinterpret_cast<const float4*>(src))
                        : make_float4(__ldcg(src), 0.f, 0.f, 0.f);
    }
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      if (!((live >> s) & 1u)) continue;
      const float w = wt[s * RB + r];
      sum.x = fmaf(w, v[s].x, sum.x);
      sum.y = fmaf(w, v[s].y, sum.y);
      sum.z = fmaf(w, v[s].z, sum.z);
      sum.w = fmaf(w, v[s].w, sum.w);
    }
    bf16* dst = out + (out0 + r) * hdv + d;
    dst[0] = __float2bfloat16(sum.x);
    if (width == 4) {
      dst[1] = __float2bfloat16(sum.y);
      dst[2] = __float2bfloat16(sum.z);
      dst[3] = __float2bfloat16(sum.w);
    }
  }
  if (tid == 0) tickets[group] = 0;  // ready for the next launch
}

struct TcArgs {
  const void *q, *kx, *vx, *kc, *vc, *ksc, *vsc, *offs, *page_table;
  void *out, *ws, *tickets;
  int B, T, C, NB, ps, KVH, G, hd, hdv;
  float scale;
  int ring, window;
  float softcap;
  int nsplit, nwarps;
};

template <int D, bool kPaged, typename TC>
int launch_tc(const TcArgs& a, cudaStream_t stream) {
  const size_t bytes = smem_bytes<TC>(D, a.nwarps);
  auto kernel = prefill_tc_kernel<D, kPaged, TC>;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int rb = 16 * a.nwarps;
  const dim3 grid(a.nsplit, (a.T * a.G + rb - 1) / rb, a.B * a.KVH);
  kernel<<<grid, 32 * a.nwarps, bytes, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.kx),
      static_cast<const bf16*>(a.vx), static_cast<const TC*>(a.kc),
      static_cast<const TC*>(a.vc), static_cast<const float*>(a.ksc),
      static_cast<const float*>(a.vsc), static_cast<const int*>(a.offs),
      static_cast<const int*>(a.page_table), static_cast<bf16*>(a.out),
      static_cast<float*>(a.ws), static_cast<int*>(a.tickets), a.T, a.C, a.NB, a.ps, a.KVH,
      a.G, a.hd, a.hdv, a.scale, a.ring, a.window, a.softcap, a.nsplit);
  return static_cast<int>(cudaGetLastError());
}

template <bool kPaged, typename TC>
int by_width(const TcArgs& a, cudaStream_t s) {
  const int width = max(a.hd, a.hdv);
  if (width <= 32) return launch_tc<32, kPaged, TC>(a, s);
  if (width <= 64) return launch_tc<64, kPaged, TC>(a, s);
  if (width <= 128) return launch_tc<128, kPaged, TC>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool kPaged>
int dispatch_tc(const TcArgs& a, int cache_dtype, void* stream) {
  if (a.B == 0 || a.T == 0 || a.KVH == 0) return 0;
  if (a.nwarps < 1 || a.nwarps > kMaxWarps || a.nsplit < 1 || a.nsplit > kMaxSplits ||
      a.tickets == nullptr || (a.nsplit > 1 && a.ws == nullptr) ||
      (cache_dtype >= 2 && (a.ksc == nullptr || a.vsc == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);  // codes need their scales
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cache_dtype) {
    case 1: return by_width<kPaged, bf16>(a, s);
    case 2: return by_width<kPaged, int8_t>(a, s);
    case 3: return by_width<kPaged, __nv_fp8_e4m3>(a, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tc

}  // namespace

// q, out: (B, KVH, T, G, hd/hdv) and chunk kx, vx: (B, T, KVH, hd/vld)
// of q_dtype; cache kc, vc: (B, C, KVH, hd/vld) of cache_dtype (the
// values the first hdv <= vld lanes of v's rows: vld = hd where v is k,
// MLA's aliased latent cache); k_scale,
// v_scale: (B, C, KVH) float32 for the code types, else ignored (may be
// null); offs: (B,) int32.  dtype codes: 0 = float32, 1 = bfloat16, 2 =
// int8, 3 = fp8_e4m3 (q: 0 or 1).  window <= 0 and softcap <= 0 mean
// none.  Returns cudaGetLastError().
extern "C" int pmt_prefill_attention(const void* q, const void* kx, const void* vx,
                                     const void* kc, const void* vc, const void* k_scale,
                                     const void* v_scale, const void* offs,
                                     void* out, int B, int T, int C, int KVH, int G, int hd,
                                     int hdv, int vld, float scale, int ring, int window,
                                     float softcap, int q_dtype, int cache_dtype,
                                     void* stream) {
  const Args a{q, kx, vx,  kc, vc, k_scale, v_scale, offs,  nullptr, out,    B,      T,
               C, 1,  C,   KVH, G, hd,      hdv,     vld,   scale,   ring,   window, softcap};
  return dispatch<false>(a, q_dtype, cache_dtype, stream);
}

// q, out, kx, vx, offs as above; k_pool, v_pool: (P, ps, KVH, hd/vld) of
// cache_dtype; k_scale, v_scale: (P, ps, KVH) float32 pools for the code
// types; page_table: (B, NB) int32, every entry a page of the pools.
// window <= 0 and softcap <= 0 mean none.  Returns cudaGetLastError().
extern "C" int pmt_prefill_attention_paged(const void* q, const void* kx, const void* vx,
                                           const void* k_pool, const void* v_pool,
                                           const void* k_scale, const void* v_scale,
                                           const void* page_table, const void* offs,
                                           void* out, int B, int T, int NB, int ps, int KVH,
                                           int G, int hd, int hdv, int vld, float scale,
                                           int window, float softcap, int q_dtype,
                                           int cache_dtype, void* stream) {
  const Args a{q,   kx,    vx, k_pool,  v_pool, k_scale, v_scale, offs, page_table,
               out, B,     T,  NB * ps, NB,     ps,      KVH,     G,    hd,
               hdv, vld,   scale, 0,    window, softcap};
  return dispatch<true>(a, q_dtype, cache_dtype, stream);
}

// The tensor-core kernel (q and chunk bf16, a cache of bf16 or of int8 /
// fp8_e4m3 codes, max(hd, hdv) <= 128) over a contiguous cache;
// arguments as pmt_prefill_attention (k_scale, v_scale null for a bf16
// cache; cache_dtype 1, 2 or 3), plus: ws, the splits' partials, nsplit *
// groups * 16 * nwarps * (hdv + 2) float32 for groups = B * KVH * row
// tiles (unused, may be null, with one split); tickets, >= groups int32
// that are 0 (and are 0 again when the kernel ends); nsplit in 1..8
// splits of the cache range; nwarps in 1..8, 16 packed query rows each.
// Returns cudaGetLastError().
extern "C" int pmt_prefill_attention_tc(const void* q, const void* kx, const void* vx,
                                        const void* kc, const void* vc, const void* k_scale,
                                        const void* v_scale, const void* offs, void* out,
                                        void* ws, void* tickets, int B, int T, int C, int KVH,
                                        int G, int hd, int hdv, float scale, int ring,
                                        int window, float softcap, int cache_dtype,
                                        int nsplit, int nwarps, void* stream) {
  const tc::TcArgs a{q,       kx,      vx,     kc,   vc,     k_scale, v_scale, offs,
                     nullptr, out,     ws,     tickets, B,   T,       C,       1,
                     C,       KVH,     G,      hd,   hdv,    scale,   ring,    window,
                     softcap, nsplit,  nwarps};
  return tc::dispatch_tc<false>(a, cache_dtype, stream);
}

// The same over page pools, arguments as pmt_prefill_attention_paged plus
// ws, tickets, nsplit and nwarps as above.  Returns cudaGetLastError().
extern "C" int pmt_prefill_attention_paged_tc(const void* q, const void* kx, const void* vx,
                                              const void* k_pool, const void* v_pool,
                                              const void* k_scale, const void* v_scale,
                                              const void* page_table, const void* offs,
                                              void* out, void* ws, void* tickets, int B, int T,
                                              int NB, int ps, int KVH, int G, int hd, int hdv,
                                              float scale, int window, float softcap,
                                              int cache_dtype, int nsplit, int nwarps,
                                              void* stream) {
  const tc::TcArgs a{q,      kx,      vx,      k_pool, v_pool,  k_scale, v_scale,
                     offs,   page_table, out,  ws,     tickets, B,       T,
                     NB * ps, NB,     ps,      KVH,    G,       hd,      hdv,
                     scale,  0,       window,  softcap, nsplit, nwarps};
  return tc::dispatch_tc<true>(a, cache_dtype, stream);
}
