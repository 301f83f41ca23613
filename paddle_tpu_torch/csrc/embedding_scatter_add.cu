// Embedding scatter-add for Hopper (sm_90a): the dense gradient of a row
// gather.  out = zeros(V, D); out[ids[n], :] += rows[n, :] for every n.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/embedding.py::
// _scatter_add_kernel (launched by scatter_add_rows).  On the TPU, dynamic
// scatters are slow, so that kernel walks vocab blocks and multiplies the
// transposed one-hot [N, block] mask by the incoming rows on the MXU: every
// block reads every row, and each output row sums its rows in a fixed
// order.
//
// Order of addition, fixed: each output row is the sum of its incoming rows
// in ascending n, starting from +0.0.  That is the order of the plain
// version on the CPU (index_add_ into zeros), so the kernel is bit-equal to
// it and to itself across runs.  No float atomics, no partial sums.
//
// Bound: bytes.  The output table is written once and each valid incoming
// row read once: (V*D + N_valid*D) * sizeof(T) plus the ids (15 us for the
// bf16 word table [32000, 512] at 16384 ids on an H100).  Three things
// stand in the way:
//  (a) finding each row's ids.  Most rows of a word table get no id, and
//      their zeros are most of the bytes: a row must not wait on searches.
//  (b) the long segments.  The ids of one row are added in order, so its
//      sum is one chain of dependent adds a column: the padding id 0 of a
//      training batch holds a quarter of its 16384 ids, a chain of ~4100
//      adds (~10 us at 4 clocks an add) over rows scattered through the
//      gradient, which must be in flight on many SMs to be read in time.
//  (c) launches and grid-wide steps: at these sizes every kernel boundary
//      and every pass over the ids costs microseconds of the card's time
//      and of the host's.
//
// Design: two launches.
//  1. sort_kernel, one cooperative launch: a stable LSD radix sort of the
//     row indices by id (8-bit digits; one pass for V <= 256, two for V <=
//     65536), each pass a histogram phase and a scatter phase over tiles
//     of 512 ids with a grid-wide barrier after each, then the row
//     offsets.  The histogram counts a tile's digits with integer atomics
//     in shared memory (the counts do not depend on the order) into a
//     [tiles, 256] table; a scatter block scans that table itself (one
//     coalesced load a tile for each digit's thread) for its base per
//     digit, and ranks its ids within the tile in order: warp w owns 64
//     consecutive ids, taken 32 at a time; eight ballots find the lanes
//     with the same digit, and per-warp digit counts, scanned across the
//     warps in warp order, place each id after every earlier one with its
//     digit.  Ids outside [0, V) are dropped by the first pass: they add
//     nothing (see below).  Row offsets, for (a): start[r] for every row r
//     in [0, V], the first sorted place whose id is not below r, from head
//     flags -- the thread of sorted place p writes p into start[] for the
//     rows between the previous place's id and its own, so each entry is
//     written once and row r's segment is [start[r], start[r + 1]).  The
//     head of a segment longer than kLong appends its id to a list of long
//     segments (an integer atomic: the list's order varies between runs,
//     and no sum depends on it).
//  2. segment_sums_kernel, two kinds of block:
//     * long blocks, for (b), first in the grid so that they start before
//       the row blocks and overlap them: block b takes work items b, b + P,
//       ... of the list x column slices.  A slice is 32 columns (a lane
//       each) unless the long segments are too few for kLongItems items;
//       then it narrows to 32 bytes, so that the padding segment alone is
//       32 items (bf16) or 64 (float32) on as many SMs.  Seven producer
//       warps stage the item's rows for the slice into a shared-memory ring
//       of kStages stages (16-byte cp.async a lane, an mbarrier a stage,
//       the next stage's row indices loaded early); one consumer warp, a
//       lane a column, adds the staged rows in ascending n.  Each column
//       stays one ordered chain.
//     * row blocks, for (a): each warp takes kRowsPerWarp consecutive rows,
//       reads their kRowsPerWarp + 1 offsets in one coalesced load, and
//       writes each row that is not long: its (at most kLong) rows added in
//       order, 16-byte accesses, 16 columns a lane; a row with no id is
//       written as zeros by the same stores, with no dependent load.
//
// Semantics: an id outside [0, V), -1 included, adds nothing -- what the
// Pallas kernel's one-hot product gives, and what the gather (K2) gives for
// the same id.  The JAX package's composed path (zeros.at[ids].add) wraps
// -1 onto the last row instead.  The port follows the kernel.
//
// Two instances: float32, and bf16 (the amp-bf16 step casts the word table
// and its gradient rows to bf16).  The bf16 instance reads bf16 rows,
// widens them exactly, sums each output row in float32 in the same order
// from +0.0, and rounds once to bf16 (to nearest even) at the store: the
// Pallas kernel's float32 one-hot product written in the table's dtype.
// Only the loads and stores differ; the sort and the offsets are shared.
// Rows whose width in bytes is not a multiple of 16 (or that are not
// 16-byte aligned) take element accesses in place of 16-byte ones.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kSortThreads = 256;               // 8 warps
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kRounds = 2;                      // 32 ids a round, per warp
constexpr int kTile = kSortThreads * kRounds;   // ids a sort tile: 512
constexpr int kDigits = 256;
constexpr int kNoDigit = kDigits;               // an id that takes no place
constexpr int kHistLoads = 32;                  // histogram entries a sort thread loads at once
constexpr int kLong = 32;                       // a longer segment goes to the long blocks
constexpr int kThreads = 256;                   // a block of segment_sums_kernel
constexpr int kRowsPerWarp = 4;                 // rows a warp of a row block
constexpr int kRowsPerBlock = kThreads / 32 * kRowsPerWarp;
constexpr int kMinSliceBytes = 32;              // a long work item's columns, at least
constexpr int kLongItems = 256;                 // long work items wanted, at least
constexpr int kProducers = kThreads - 32;       // threads staging rows in a long block
constexpr int kStages = 4;                      // stages of a long block's ring
constexpr int kMaxItems = 64;                   // work items a long block holds
constexpr int kGroup = 8;                       // staged rows the consumer loads at once
constexpr int kGapLanes = 8;                    // longer runs of offsets: by the warp

// 16 bytes of T (kVec) or one T, widened to float32 (exact for bf16), and
// stored rounded to T (to nearest even for bf16)
template <typename T, bool kVec>
struct Access;
template <>
struct Access<float, true> {
  static constexpr int kE = 4;
  static __device__ __forceinline__ void load(const float* p, float (&x)[kE]) {
    const float4 y = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = y.x, x[1] = y.y, x[2] = y.z, x[3] = y.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&x)[kE]) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  }
};
template <>
struct Access<__nv_bfloat16, true> {
  static constexpr int kE = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&x)[kE]) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&x)[kE]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};
template <typename T>
struct Access<T, false> {
  static constexpr int kE = 1;
  static __device__ __forceinline__ void load(const T* p, float (&x)[1]) { x[0] = widen(*p); }
  static __device__ __forceinline__ void store(T* p, const float (&x)[1]) { narrow(p, x[0]); }
  static __device__ __forceinline__ float widen(float x) { return x; }
  static __device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ void narrow(float* p, float x) { *p = x; }
  static __device__ __forceinline__ void narrow(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// an arrival on the barrier once every earlier cp.async of this thread has
// landed; it counts as one of the barrier's expected arrivals
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
// wait until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// Within sort_kernel a buffer written by one phase is read by the next on
// other SMs: those reads go through L2 (ld.global.cg), never the
// non-coherent cache.

// the tile's digit counts: hist[tile * kDigits + digit]
template <bool kFirst>
__device__ __forceinline__ void radix_hist(const int* keys, const int* count, int64_t n,
                                           int64_t v, int shift, int* hist, int tiles, int tile) {
  __shared__ int cnt[kDigits];
  __syncthreads();                                // the previous tile's counts are written
  cnt[threadIdx.x] = 0;
  const int64_t base = static_cast<int64_t>(tile) * kTile + threadIdx.x;
  int k[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {     // the buffers hold n keys: load them all
    const int64_t pos = base + r * kSortThreads;
    k[r] = pos < n ? __ldcg(keys + pos) : -1;
  }
  const int64_t limit = kFirst ? n : __ldcg(count);
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    if (base + r * kSortThreads >= limit || k[r] < 0 || (kFirst && k[r] >= v)) continue;
    atomicAdd(&cnt[(k[r] >> shift) & (kDigits - 1)], 1);
  }
  __syncthreads();
  hist[tile * kDigits + threadIdx.x] = cnt[threadIdx.x];
}

// stable scatter of the tile's (key, n) pairs to their places after the
// digit's earlier ids; the first pass reads the ids (n = their position),
// drops those outside [0, v) and writes the count of the rest to *count
template <bool kFirst>
__device__ __forceinline__ void radix_scatter(const int* keys, const int* idx, int* count,
                                              int64_t n, int64_t v, int shift, const int* hist,
                                              int tiles, int* keys_out, int* idx_out, int tile) {
  __shared__ int wcnt[kSortWarps][kDigits];     // per warp: digit counts, then offsets
  __shared__ int base_d[kDigits];
  __shared__ int wsum[kSortWarps];
  const int t = threadIdx.x, w = t / 32, lane = t % 32;
  // warp w owns the tile's ids w * 64 .. + 63, 32 a round, in order
  const int64_t pos0 = static_cast<int64_t>(tile) * kTile + w * (32 * kRounds) + lane;
  int key[kRounds], val[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int64_t pos = pos0 + r * 32;
    key[r] = pos < n ? __ldcg(keys + pos) : -1;
    val[r] = pos < n ? (kFirst ? static_cast<int>(pos) : __ldcg(idx + pos)) : 0;
  }
  const int64_t limit = kFirst ? n : __ldcg(count);
  // thread t is digit t: its total over all tiles and over the tiles before
  // this one (kHistLoads loads in flight at once, each coalesced across the
  // digits), then the exclusive scan of the totals over the digits
  int tot = 0, pre = 0;
  for (int tb0 = 0; tb0 < tiles; tb0 += kHistLoads) {
    int c[kHistLoads];
#pragma unroll
    for (int i = 0; i < kHistLoads; ++i)
      c[i] = tb0 + i < tiles ? __ldcg(hist + (tb0 + i) * kDigits + t) : 0;
#pragma unroll
    for (int i = 0; i < kHistLoads; ++i) {
      tot += c[i];
      pre += tb0 + i < tile ? c[i] : 0;
    }
  }
  __syncthreads();                                // the previous tile is placed
#pragma unroll
  for (int ww = 0; ww < kSortWarps; ++ww) wcnt[ww][t] = 0;
  int inc = tot;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += o;
  }
  if (lane == 31) wsum[w] = inc;
  __syncthreads();
  int warp_base = 0;
  for (int ww = 0; ww < w; ++ww) warp_base += wsum[ww];
  base_d[t] = warp_base + inc - tot + pre;
  if (kFirst && tile == 0 && t == kDigits - 1) *count = warp_base + inc;

  const unsigned lt = (1u << lane) - 1u;
  int dig[kRounds], rank[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int k = key[r];
    const bool in = pos0 + r * 32 < limit && k >= 0 && (!kFirst || k < v);
    const int d = in ? (k >> shift) & (kDigits - 1) : kNoDigit;
    // the lanes with this lane's digit: eight ballots, one a bit
    unsigned peers = __ballot_sync(0xffffffffu, in);
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const bool bit = (d >> b) & 1;
      const unsigned on = __ballot_sync(0xffffffffu, bit);
      peers &= bit ? on : ~on;
    }
    rank[r] = in ? wcnt[w][d] + __popc(peers & lt) : 0;
    __syncwarp();
    if (in && (peers & lt) == 0) wcnt[w][d] += __popc(peers);
    __syncwarp();
    dig[r] = d;
  }
  __syncthreads();
  int run = 0;
#pragma unroll
  for (int ww = 0; ww < kSortWarps; ++ww) {
    const int c = wcnt[ww][t];
    wcnt[ww][t] = run;
    run += c;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    if (dig[r] == kNoDigit) continue;
    const int out = base_d[dig[r]] + wcnt[w][dig[r]] + rank[r];
    keys_out[out] = key[r];
    idx_out[out] = val[r];
  }
}

// start[r] for every row r in [0, v]: the first sorted place whose id is
// not below r (start[v] = m, the count of valid ids).  The thread of sorted
// place p in [0, m] writes p for the rows (keys[p - 1], keys[p]] (keys[-1]
// = -1, keys[m] = v): every entry once.  A lane with more than kGapLanes
// rows hands them to its warp.  The head of a segment longer than kLong
// appends its id to ``longs``.
__device__ __forceinline__ void row_offsets(const int* keys, int m, int64_t p, int v, int* start,
                                            int* longs, int* nlong) {
  const int lane = threadIdx.x % 32;
  int lo = 0, hi = 0;                             // the rows [lo, hi) that start at p
  if (p <= m) {
    const int prev = p > 0 ? __ldcg(keys + p - 1) : -1;
    const int cur = p < m ? __ldcg(keys + p) : v;
    lo = prev + 1;
    hi = cur + 1;
    if (prev != cur && p + kLong < m && __ldcg(keys + p + kLong) == cur)
      longs[atomicAdd(nlong, 1)] = cur;
  }
  const int at = static_cast<int>(p);
  if (hi - lo <= kGapLanes)
    for (int r = lo; r < hi; ++r) start[r] = at;
  for (unsigned big = __ballot_sync(0xffffffffu, hi - lo > kGapLanes); big != 0; big &= big - 1) {
    const int src = __ffs(big) - 1;
    const int blo = __shfl_sync(0xffffffffu, lo, src), bhi = __shfl_sync(0xffffffffu, hi, src);
    const int bat = __shfl_sync(0xffffffffu, at, src);
    for (int r = blo + lane; r < bhi; r += 32) start[r] = bat;
  }
}

// the whole sort and the row offsets in one cooperative launch: each radix
// pass is a histogram phase and a scatter phase over the tiles (blocks take
// tiles in turn), each ended by a grid-wide barrier; then the offsets, a
// thread a sorted place.  keys / idx: the two buffers of each; *count: the
// valid ids; n may be 0 (no pass runs)
__global__ void __launch_bounds__(kSortThreads)
sort_kernel(const int* ids, int64_t n, int64_t v, int passes, int* keys0, int* idx0, int* keys1,
            int* idx1, int* hist, int tiles, int* count, int* start, int* longs, int* nlong) {
  cg::grid_group grid = cg::this_grid();
  if (blockIdx.x == 0 && threadIdx.x == 0) *nlong = 0;
  const int* src_keys = ids;
  const int* src_idx = nullptr;
  for (int p = 0; p < passes; ++p) {
    int* dk = p % 2 == 0 ? keys0 : keys1;
    int* di = p % 2 == 0 ? idx0 : idx1;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      if (p == 0)
        radix_hist<true>(src_keys, count, n, v, 0, hist, tiles, tile);
      else
        radix_hist<false>(src_keys, count, n, v, 8 * p, hist, tiles, tile);
    }
    grid.sync();
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      if (p == 0)
        radix_scatter<true>(src_keys, src_idx, count, n, v, 0, hist, tiles, dk, di, tile);
      else
        radix_scatter<false>(src_keys, src_idx, count, n, v, 8 * p, hist, tiles, dk, di, tile);
    }
    grid.sync();
    src_keys = dk;
    src_idx = di;
  }
  const int m = n > 0 ? __ldcg(count) : 0;
  const int64_t threads = static_cast<int64_t>(gridDim.x) * kSortThreads;
  // every lane of a warp takes part in row_offsets' ballot: the bound is
  // rounded up to whole warps' worth of places
  for (int64_t p0 = static_cast<int64_t>(blockIdx.x) * kSortThreads; p0 <= m; p0 += threads)
    row_offsets(src_keys, m, p0 + threadIdx.x, static_cast<int>(v), start, longs, nlong);
}

// a segment [lo, hi) of at most kLong ids, added by the warp into the
// output row dst in order, 16 columns a lane a pass (kBatch rows' loads in
// flight); lo == hi writes zeros.  A row past the segment adds +0.0, which
// changes no sum that starts from +0.0
template <typename T, bool kVec>
__device__ __forceinline__ void add_short(const int* __restrict__ idx, int lo, int hi,
                                          const T* __restrict__ rows, T* __restrict__ dst,
                                          int64_t d) {
  using A = Access<T, kVec>;
  constexpr int kE = A::kE, kQ = 16 / kE, kPass = 32 * kQ * kE, kBatch = 2;
  const int lane = threadIdx.x % 32;
  const int len = hi - lo;
  const int my_idx = lane < len ? __ldg(idx + lo + lane) : 0;
  for (int64_t c0 = 0; c0 < d; c0 += kPass) {
    float acc[kQ][kE];
#pragma unroll
    for (int q = 0; q < kQ; ++q)
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[q][e] = 0.f;
    for (int u0 = 0; u0 < len; u0 += kBatch) {
      float x[kBatch][kQ][kE];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int r = __shfl_sync(0xffffffffu, my_idx, (u0 + u) & 31);
        const T* src = rows + static_cast<int64_t>(r) * d;
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          const int64_t c = c0 + (q * 32 + lane) * kE;
          if (u0 + u < len && c < d) {
            A::load(src + c, x[u][q]);
          } else {
#pragma unroll
            for (int e = 0; e < kE; ++e) x[u][q][e] = 0.f;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
#pragma unroll
        for (int q = 0; q < kQ; ++q)
#pragma unroll
          for (int e = 0; e < kE; ++e) acc[q][e] += x[u][q][e];
    }
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int64_t c = c0 + (q * 32 + lane) * kE;
      if (c < d) A::store(dst + c, acc[q]);
    }
  }
}

// a stage's rows of a column slice, added in order to acc by one lane: the
// whole stage unrolled (kRows a compile-time count), or the segment's last
// stage, cnt rows, with kGroup rows' loads in flight while the previous
// kGroup are added (a row past cnt adds +0.0)
template <typename T, int kRows, int kCols>
__device__ __forceinline__ void add_stage(float& acc, const T* x) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc += Access<T, false>::widen(x[r * kCols]);
}
template <typename T, int kCols>
__device__ __forceinline__ void add_rows(float& acc, const T* x, int cnt) {
  float xa[kGroup], xb[kGroup];
  auto load = [&](float (&v)[kGroup], int r0) {
#pragma unroll
    for (int i = 0; i < kGroup; ++i)
      v[i] = r0 + i < cnt ? Access<T, false>::widen(x[(r0 + i) * kCols]) : 0.f;
  };
  load(xa, 0);
  for (int r0 = 0; r0 < cnt; r0 += 2 * kGroup) {
    load(xb, r0 + kGroup);
#pragma unroll
    for (int i = 0; i < kGroup; ++i) acc += xa[i];
    load(xa, r0 + 2 * kGroup);
#pragma unroll
    for (int i = 0; i < kGroup; ++i) acc += xb[i];
  }
}

// the columns of a long work item: the widest slice, a lane a column (32),
// unless the long segments are too few for kLongItems items; then narrower,
// down to kMinSliceBytes
template <typename T>
__host__ __device__ __forceinline__ int slice_cols(int64_t n_long, int64_t d) {
  int cols = 32;
  while (cols * static_cast<int>(sizeof(T)) > kMinSliceBytes &&
         n_long * ((d + cols - 1) / cols) < kLongItems)
    cols /= 2;
  return cols;
}

// a long block's shared memory: the ring of kStages stages (kCopies
// copies of each producer thread: 16 bytes each, or an element), a full
// and an empty barrier a stage, and the block's work items
template <typename T, bool kVec>
struct LongSmem {
  static constexpr int kPieceBytes = kVec ? 16 : static_cast<int>(sizeof(T));   // a copy
  static constexpr int kCopies = kVec ? 2 : 8;    // copies a producer thread issues a stage
  static constexpr int kStageElems = kCopies * kProducers * kPieceBytes / static_cast<int>(sizeof(T));
  alignas(16) T ring[kStages][kStageElems];
  uint64_t full[kStages], empty[kStages];
  int item_key[kMaxItems], item_lo[kMaxItems], item_hi[kMaxItems];
  int64_t item_col[kMaxItems];
};

// a long block: work items b, b + blocks, ... of (long segment, slice of
// kCols columns); the producer warps stage each item's rows for its slice
// into the ring (kRowsPerStage rows a stage), and the consumer warp adds
// them, a lane a column, in ascending n.  Both walk the same stages: item
// j, rows [base, base + kRowsPerStage) of its segment.  kCols is a
// template argument so that the consumer's loads take constant offsets
template <typename T, bool kVec, int kCols>
__device__ __forceinline__ void long_block(LongSmem<T, kVec>& S, const int* __restrict__ idx,
                                           const int* __restrict__ start,
                                           const int* __restrict__ longs, int n_long,
                                           const T* __restrict__ rows, T* __restrict__ out,
                                           int64_t d, int64_t blocks) {
  using L = LongSmem<T, kVec>;
  constexpr int kCopies = L::kCopies;
  constexpr int kPieces = kCols * static_cast<int>(sizeof(T)) / L::kPieceBytes;   // copies a row
  constexpr int kPieceCols = kCols / kPieces;
  constexpr int kRowsPerStage = L::kStageElems / kCols;
  auto& ring = S.ring;
  auto& full = S.full;
  auto& empty = S.empty;
  int* item_key = S.item_key;
  int* item_lo = S.item_lo;
  int* item_hi = S.item_hi;
  int64_t* item_col = S.item_col;
  const int64_t slices = (d + kCols - 1) / kCols;
  const int64_t items = static_cast<int64_t>(n_long) * slices;
  const int64_t b = blockIdx.x;
  if (b >= items) return;
  const int n_items = static_cast<int>((items - 1 - b) / blocks + 1);   // <= kMaxItems
  const int t = threadIdx.x;
  if (t < n_items) {
    const int64_t item = b + t * blocks;
    const int key = longs[item / slices];
    item_key[t] = key;
    item_lo[t] = start[key];
    item_hi[t] = start[key + 1];
    item_col[t] = item % slices * kCols;
  }
  if (t < kStages) {
    mbar_init(&full[t], kProducers);
    mbar_init(&empty[t], 32);
  }
  __syncthreads();
  if (t < 32) {                                    // the consumer warp
    int stage = 0;
    for (int j = 0; j < n_items; ++j) {
      const int hi = item_hi[j];
      float acc = 0.f;
      for (int base = item_lo[j]; base < hi; base += kRowsPerStage, ++stage) {
        const int s = stage % kStages;
        mbar_wait(&full[s], (stage / kStages) & 1);
        const int cnt = min(kRowsPerStage, hi - base);
        const T* x = &ring[s][t % kCols];
        if (cnt == kRowsPerStage)                  // a whole stage: no row to mask
          add_stage<T, kRowsPerStage, kCols>(acc, x);
        else
          add_rows<T, kCols>(acc, x, cnt);
        mbar_arrive(&empty[s]);
      }
      const int64_t c = item_col[j] + t;
      if (t < kCols && c < d)
        Access<T, false>::narrow(out + static_cast<int64_t>(item_key[j]) * d + c, acc);
    }
    return;
  }
  // the producer warps: each thread takes copies pt + k * kProducers of a
  // stage; the row indices of the next stage are loaded as soon as this
  // stage's copies are issued, before the next slot is waited for
  const int pt = t - 32;
  int nj = 0, nbase = item_lo[0];                  // the next stage to load indices for
  int src_row[kCopies];
  auto load_rows = [&]() {
#pragma unroll
    for (int k = 0; k < kCopies; ++k) {
      const int row = (pt + k * kProducers) / kPieces;
      src_row[k] = nj < n_items && nbase + row < item_hi[nj] ? __ldg(idx + nbase + row) : -1;
    }
    nbase += kRowsPerStage;
    if (nj < n_items && nbase >= item_hi[nj]) {
      ++nj;
      nbase = nj < n_items ? item_lo[nj] : 0;
    }
  };
  load_rows();
  int stage = 0;
  for (int j = 0; j < n_items; ++j) {
    const int64_t col0 = item_col[j];
    for (int base = item_lo[j]; base < item_hi[j]; base += kRowsPerStage, ++stage) {
      const int s = stage % kStages;
      if (stage >= kStages) mbar_wait(&empty[s], (stage / kStages + 1) & 1);
#pragma unroll
      for (int k = 0; k < kCopies; ++k) {
        const int q = pt + k * kProducers;        // the stage's element q * kPieceCols
        const int64_t c = col0 + q % kPieces * kPieceCols;
        if (src_row[k] < 0 || c >= d) continue;
        const T* src = rows + static_cast<int64_t>(src_row[k]) * d + c;
        if constexpr (kVec)
          cp_async16(&ring[s][q * kPieceCols], src);
        else
          ring[s][q] = *src;
      }
      if constexpr (kVec)
        mbar_arrive_cp_async(&full[s]);
      else
        mbar_arrive(&full[s]);
      load_rows();
    }
  }
}

// every output row: blocks [0, long_blocks) are long blocks (launched
// first, so that they overlap the row blocks), the rest row blocks of
// kRowsPerBlock rows; a row whose segment holds more than kLong ids is the
// long blocks'
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
segment_sums_kernel(const int* __restrict__ idx, const int* __restrict__ start,
                    const int* __restrict__ longs, const int* __restrict__ nlong,
                    const T* __restrict__ rows, T* __restrict__ out, int64_t v, int64_t d,
                    int64_t long_blocks) {
  if (blockIdx.x < long_blocks) {
    __shared__ LongSmem<T, kVec> S;
    const int n_long = *nlong;
    const int cols = slice_cols<T>(n_long, d);
    if (cols == 32)
      long_block<T, kVec, 32>(S, idx, start, longs, n_long, rows, out, d, long_blocks);
    else if (cols == 16)
      long_block<T, kVec, 16>(S, idx, start, longs, n_long, rows, out, d, long_blocks);
    else if constexpr (sizeof(T) == 4)
      long_block<T, kVec, 8>(S, idx, start, longs, n_long, rows, out, d, long_blocks);
    return;
  }
  const int lane = threadIdx.x % 32;
  const int64_t r0 =
      ((blockIdx.x - long_blocks) * (kThreads / 32) + threadIdx.x / 32) * kRowsPerWarp;
  if (r0 >= v) return;
  const int at = lane <= kRowsPerWarp && r0 + lane <= v ? __ldg(start + r0 + lane) : 0;
#pragma unroll 1
  for (int i = 0; i < kRowsPerWarp && r0 + i < v; ++i) {
    const int lo = __shfl_sync(0xffffffffu, at, i), hi = __shfl_sync(0xffffffffu, at, i + 1);
    if (hi - lo <= kLong) add_short<T, kVec>(idx, lo, hi, rows, out + (r0 + i) * d, d);
  }
}

int sort_passes(int64_t v) {
  int bits = 0;
  for (int64_t x = v - 1; x > 0; x >>= 1) ++bits;
  return bits <= 8 ? 1 : (bits + 7) / 8;
}

template <typename T>
int scatter_add_rows(const int* ids, const T* rows, T* out, int* scratch, int64_t n, int64_t v,
                     int64_t d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (v <= 0 || d <= 0) return static_cast<int>(cudaSuccess);
  if (n < 0 || n >= (1ll << 31) || v >= (1ll << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  static int sms = 0, sort_blocks = 0;   // SMs; sort_kernel's blocks the card holds at once
  if (sms == 0) {
    int dev = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sort_kernel, kSortThreads, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    sort_blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  int tiles = static_cast<int>((n + kTile - 1) / kTile);
  int* keys0 = scratch;
  int* idx0 = scratch + n;
  int* keys1 = scratch + 2 * n;
  int* idx1 = scratch + 3 * n;
  int* hist = scratch + 4 * n;
  int* count = hist + static_cast<int64_t>(kDigits) * tiles;
  int* nlong = count + 1;
  int* start = count + 2;
  int* longs = start + v + 1;
  int passes = n > 0 ? sort_passes(v) : 0;
  // the sorted indices end in the buffer the last pass wrote
  const int* sorted_idx = passes % 2 == 1 ? idx0 : idx1;
  // a block a tile, or a thread a sorted place for the offsets, at most
  // what the card holds at once (the blocks wait for each other)
  int64_t sort_grid = (n + kSortThreads) / kSortThreads;
  if (sort_grid < tiles) sort_grid = tiles;
  if (sort_grid > sort_blocks) sort_grid = sort_blocks;
  void* args[] = {&ids, &n, &v, &passes, &keys0, &idx0, &keys1, &idx1, &hist, &tiles, &count,
                  &start, &longs, &nlong};
  cudaError_t e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(sort_kernel),
                                              dim3(static_cast<unsigned>(sort_grid)),
                                              dim3(kSortThreads), args, 0, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  // at most n / (kLong + 1) long segments, each cut into at most this
  // many slices; the long blocks take the items in turn, at most kMaxItems
  // each
  const int64_t min_cols = kMinSliceBytes / static_cast<int64_t>(sizeof(T));
  const int64_t max_items = n / (kLong + 1) * ((d + min_cols - 1) / min_cols);
  int64_t long_blocks = (max_items + kMaxItems - 1) / kMaxItems;
  if (long_blocks < 4ll * sms) long_blocks = 4ll * sms < max_items ? 4ll * sms : max_items;
  const int64_t blocks = long_blocks + (v + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  // 16 bytes a lane where rows are 16-byte aligned
  const bool vec = (d * static_cast<int64_t>(sizeof(T))) % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(rows) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const unsigned grid = static_cast<unsigned>(blocks);
  if (vec)
    segment_sums_kernel<T, true><<<grid, kThreads, 0, s>>>(sorted_idx, start, longs, nlong, rows,
                                                           out, v, d, long_blocks);
  else
    segment_sums_kernel<T, false><<<grid, kThreads, 0, s>>>(sorted_idx, start, longs, nlong, rows,
                                                            out, v, d, long_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ids: [n] int32; rows: [n, d] and out: [v, d] float32 (or bf16), every
// element of out written; scratch: 4 * n + 256 * ceil(n / 512) + 2 +
// (v + 1) + n / 33 int32 (two key and two index arrays, the [tiles, 256]
// histogram, the counts of valid ids and of long segments, the row
// offsets, the list of long segments).  n < 2**31,
// v < 2**31 - 1.  Launches 2 kernels on ``stream``; returns the first
// error.
extern "C" int ptt_scatter_add_rows_f32(const int* ids, const float* rows, float* out,
                                        int* scratch, int64_t n, int64_t v, int64_t d,
                                        void* stream) {
  return scatter_add_rows<float>(ids, rows, out, scratch, n, v, d, stream);
}

extern "C" int ptt_scatter_add_rows_bf16(const int* ids, const __nv_bfloat16* rows,
                                         __nv_bfloat16* out, int* scratch, int64_t n, int64_t v,
                                         int64_t d, void* stream) {
  return scatter_add_rows<__nv_bfloat16>(ids, rows, out, scratch, n, v, d, stream);
}
