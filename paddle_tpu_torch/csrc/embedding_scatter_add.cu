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
// it and to itself across runs.  No float atomics.
//
// Design: a stable sort of the row indices by id, then one pass that writes
// every output row.
//  1. LSD radix sort of the valid ids (8-bit digits; one pass for V <= 256,
//     two for V <= 65536), each pass two kernels over tiles of 2048 ids:
//     a histogram of the tile's digits (integer atomics in shared memory:
//     the counts do not depend on the order), and a stable scatter.  The
//     scatter block scans the [256 digits x tiles] histogram itself (digit
//     major, tiles in block order) for its base per digit, and ranks its
//     ids within the tile in order: warp w owns 256 consecutive ids, taken
//     32 at a time; eight ballots find the lanes with the same digit, and
//     per-warp digit counts, scanned across the warps in warp order, place
//     each id after every earlier one with its digit.  Ids outside [0, V)
//     are dropped by the first pass: they add nothing (see below).  Every
//     load of a kernel is issued before the first is used.
//  2. Two segment kernels write every output row (so no memset runs); a
//     row with no ids is written as zeros.  Each segment of the sorted ids
//     is added in segment order, which is ascending n:
//     * the short kernel: one warp a row finds its segment by two 32-way
//       searches (three dependent loads at N = 16384) and adds it if it
//       holds at most 32 ids (the word table: 0.5 ids a row on average),
//       4 floats a lane over D, 4 rows in flight;
//     * the long kernel: a longer segment (the position table: 64 ids a
//       row; the word table's padding id 0: thousands) by one warp per 32
//       columns, one a block so that they spread over the SMs, each lane
//       one column: 48 rows' loads in flight while the previous 48 are
//       added (two batches in registers), so the adds of a column stay in
//       sequence and the loads do not wait.  Warp (j, c) takes the run that covers sorted position
//       32 j if the run starts after 32 (j - 1).
// Launches a call: 2 * passes + 2 (6 into the word table [32000, 512], 4
// into the position table [256, 512]).
//
// Bound: bytes.  The output table is written once and each valid incoming
// row read once: (V*D + N_valid*D) * 4 bytes (2 in bf16) plus the ids.
// The sort moves 16 bytes an id a pass, 0.5 MB at N = 16384: in L2.  A long
// segment adds a chain of dependent adds per column: 4096 ids take ~9 us at
// 4 clocks an add, whatever the width.
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
// Only the segment kernels' loads and stores differ; the sort is shared.
// At the word table the bf16 instance moves half the bytes.  Its long path
// reads two columns a lane as one 32-bit word (a warp per 64 columns), so
// a warp's load of a row is 128 bytes as in float32, with half the loads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSortThreads = 256;               // 8 warps
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kRounds = 8;                      // 32 ids a round, per warp
constexpr int kTile = kSortThreads * kRounds;   // ids a sort block: 2048
constexpr int kDigits = 256;
constexpr int kNoDigit = kDigits;               // an id that takes no place
constexpr int kSegWarps = 8;                    // warps a segment block
constexpr int kLong = 32;                       // a longer segment is spread over D

// element loads widened to float32 (exact for bf16) and stores rounded to
// the element type (to nearest even for bf16)
__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  const unsigned short u = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<uint32_t>(u) << 16);
}
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {   // 8 bytes
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// the tile's digit counts: hist[digit * tiles + tile]
template <bool kFirst>
__global__ void __launch_bounds__(kSortThreads)
radix_hist_kernel(const int* __restrict__ keys, const int* __restrict__ count, int64_t n, int64_t v,
                  int shift, int* __restrict__ hist, int tiles) {
  __shared__ int cnt[kDigits];
  cnt[threadIdx.x] = 0;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x;
  int k[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {     // the buffers hold n keys: load them all
    const int64_t pos = base + r * kSortThreads;
    k[r] = pos < n ? keys[pos] : -1;
  }
  const int64_t limit = kFirst ? n : *count;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    if (base + r * kSortThreads >= limit || k[r] < 0 || (kFirst && k[r] >= v)) continue;
    atomicAdd(&cnt[(k[r] >> shift) & (kDigits - 1)], 1);
  }
  __syncthreads();
  hist[threadIdx.x * tiles + blockIdx.x] = cnt[threadIdx.x];
}

// stable scatter of the tile's (key, n) pairs to their places after the
// digit's earlier ids; the first pass reads the ids (n = their position),
// drops those outside [0, v) and writes the count of the rest to *count
template <bool kFirst>
__global__ void __launch_bounds__(kSortThreads)
radix_scatter_kernel(const int* __restrict__ keys, const int* __restrict__ idx, int* count,
                     int64_t n, int64_t v, int shift, const int* __restrict__ hist, int tiles,
                     int* __restrict__ keys_out, int* __restrict__ idx_out) {
  __shared__ int wcnt[kSortWarps][kDigits];     // per warp: digit counts, then offsets
  __shared__ int base_d[kDigits];
  __shared__ int wsum[kSortWarps];
  const int t = threadIdx.x, w = t / 32, lane = t % 32;
  // warp w owns the tile's ids w * 256 .. + 255, 32 a round, in order
  const int64_t pos0 = static_cast<int64_t>(blockIdx.x) * kTile + w * (32 * kRounds) + lane;
  int key[kRounds], val[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int64_t pos = pos0 + r * 32;
    key[r] = pos < n ? keys[pos] : -1;
    val[r] = pos < n ? (kFirst ? static_cast<int>(pos) : idx[pos]) : 0;
  }
  // thread t is digit t: its total over all tiles and over the tiles before
  // this one, then the exclusive scan of the totals over the digits
  int tot = 0, pre = 0;
#pragma unroll 8
  for (int tb = 0; tb < tiles; ++tb) {
    const int c = hist[t * tiles + tb];
    tot += c;
    pre += tb < static_cast<int>(blockIdx.x) ? c : 0;
  }
  const int64_t limit = kFirst ? n : *count;
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
  if (kFirst && blockIdx.x == 0 && t == kDigits - 1) *count = warp_base + inc;

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

// the first place in sorted[a, b) whose key is not below x; every lane of
// the warp takes part and gets the answer
__device__ __forceinline__ int warp_lower_bound(const int* __restrict__ sorted, int a, int b,
                                                int64_t x) {
  const int lane = threadIdx.x % 32;
  while (b - a > 32) {
    const int step = (b - a + 31) / 32;
    const int p = a + lane * step;
    const unsigned below = __ballot_sync(0xffffffffu, p < b && sorted[p] < x);
    const int c = __popc(below);                // probes below x, a prefix of the lanes
    const int na = c > 0 ? a + (c - 1) * step + 1 : a;
    b = min(b, a + c * step);
    a = na;
  }
  const int p = a + lane;
  return a + __popc(__ballot_sync(0xffffffffu, p < b && sorted[p] < x));
}

// a short segment [lo, hi) (hi - lo <= kLong) of one output row: the warp
// adds its rows in order, 4 elements a lane (kVec) or 1, 4 rows in flight
template <typename T, bool kVec>
__device__ __forceinline__ void add_short(const int* __restrict__ idx, int lo, int hi,
                                          const T* __restrict__ rows, T* __restrict__ dst,
                                          int64_t d) {
  const int lane = threadIdx.x % 32;
  constexpr int kPer = kVec ? 4 : 1;
  constexpr int kPass = 32 * kPer;
  constexpr int kBatch = 4;
  const int my_idx = lo + lane < hi ? __ldg(idx + lo + lane) : 0;
  for (int64_t c0 = 0; c0 < d; c0 += 4 * kPass) {
    float acc[4][kPer];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < kPer; ++e) acc[q][e] = 0.f;
    for (int u0 = 0; u0 < hi - lo; u0 += kBatch) {
      float x[kBatch][4][kPer];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int r = __shfl_sync(0xffffffffu, my_idx, (u0 + u) & 31);
        const bool in = u0 + u < hi - lo;
        const T* src = rows + static_cast<int64_t>(r) * d;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int64_t c = c0 + q * kPass + lane * kPer;
          if constexpr (kVec) {
            const float4 y = in && c < d ? load4(src + c) : make_float4(0.f, 0.f, 0.f, 0.f);
            x[u][q][0] = y.x;
            x[u][q][1] = y.y;
            x[u][q][2] = y.z;
            x[u][q][3] = y.w;
          } else {
            x[u][q][0] = in && c < d ? load1(src + c) : 0.f;
          }
        }
      }
      // a row past the segment adds +0.0, which changes no sum that
      // starts from +0.0
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int e = 0; e < kPer; ++e) acc[q][e] += x[u][q][e];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int64_t c = c0 + q * kPass + lane * kPer;
      if (c >= d) continue;
      if constexpr (kVec) {
        store4(dst + c, make_float4(acc[q][0], acc[q][1], acc[q][2], acc[q][3]));
      } else {
        store1(dst + c, acc[q][0]);
      }
    }
  }
}

constexpr int kLongBatch = 48;                  // rows a long-path batch: two fit in registers

// the row indices at sorted positions base .. base + kLongBatch - 1: this
// lane holds base + lane and base + 32 + lane (-1 past hi or past the batch)
struct BatchIdx {
  int lo, hi;
};
__device__ __forceinline__ BatchIdx batch_idx(const int* __restrict__ idx, int base, int hi) {
  const int lane = threadIdx.x % 32;
  return {base + lane < hi ? __ldg(idx + base + lane) : -1,
          32 + lane < kLongBatch && base + 32 + lane < hi ? __ldg(idx + base + 32 + lane) : -1};
}

// what one lane of the long path reads of a row: one column (a float32, or a
// bf16 widened), or with kPair two bf16 columns as one 32-bit word (a warp
// then reads 128 bytes a row, as in float32, with half the loads)
template <typename T, bool kPair>
struct LaneWord {
  using W = float;
  static constexpr int kCols = 1;
  static __device__ __forceinline__ W load(const T* p) { return load1(p); }
  static __device__ __forceinline__ void add(float (&acc)[2], W w) { acc[0] += w; }
};
template <>
struct LaneWord<__nv_bfloat16, true> {
  using W = uint32_t;
  static constexpr int kCols = 2;
  static __device__ __forceinline__ W load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned int*>(p));
  }
  static __device__ __forceinline__ void add(float (&acc)[2], W w) {
    acc[0] += __uint_as_float(w << 16);
    acc[1] += __uint_as_float(w & 0xffff0000u);
  }
};

// column(s) c of the batch's rows, whose indices the warp's lanes hold: this
// lane's words, 0 (+0.0) for a missing row or past d
template <typename T, bool kPair>
__device__ __forceinline__ void load_batch(typename LaneWord<T, kPair>::W (&x)[kLongBatch],
                                           BatchIdx bi, const T* __restrict__ rows, int64_t d,
                                           int64_t c) {
  // every shuffle first, then every load: no load waits on the next shuffle
  int r[kLongBatch];
#pragma unroll
  for (int u = 0; u < kLongBatch; ++u) r[u] = __shfl_sync(0xffffffffu, u < 32 ? bi.lo : bi.hi, u % 32);
#pragma unroll
  for (int u = 0; u < kLongBatch; ++u)
    x[u] = r[u] >= 0 && c < d
               ? LaneWord<T, kPair>::load(rows + static_cast<int64_t>(r[u]) * d + c)
               : typename LaneWord<T, kPair>::W(0);
}

// the long segments: warp (j, chunk), one a block, takes the segment that
// covers sorted position kLong * j if it starts after kLong * (j - 1) and
// holds more than kLong ids, at columns kCols * (32 * chunk + lane) (+1).
// Each lane adds its column(s) in order; kLongBatch rows' loads are in
// flight while the previous kLongBatch are added, and the indices one batch
// further ahead.  A row past the segment adds +0.0, which changes no sum
// that starts from +0.0
template <typename T, bool kPair>
__global__ void __launch_bounds__(32, 1)
long_segment_kernel(const int* __restrict__ keys, const int* __restrict__ idx,
                    const int* __restrict__ count, const T* __restrict__ rows,
                    T* __restrict__ out, int64_t d, int64_t chunks) {
  using L = LaneWord<T, kPair>;
  const int lane = threadIdx.x;
  const int m = *count;
  const int64_t j = blockIdx.x / chunks;
  const int64_t p = j * kLong;
  if (p >= m) return;
  const int key = keys[p];
  if (p >= kLong && keys[p - kLong] == key) return;   // the run started earlier
  // the run's start, within (p - kLong, p]
  const int a = static_cast<int>(p >= kLong ? p - kLong + 1 : 0);
  const int lo = a + __popc(__ballot_sync(0xffffffffu, a + lane <= p && keys[a + lane] < key));
  const int hi = warp_lower_bound(keys, static_cast<int>(p), m, static_cast<int64_t>(key) + 1);
  if (hi - lo <= kLong) return;                      // the short kernel's
  const int64_t c = ((blockIdx.x % chunks) * 32 + lane) * L::kCols;
  float acc[2] = {0.f, 0.f};
  typename L::W xa[kLongBatch], xb[kLongBatch];
  BatchIdx ia = batch_idx(idx, lo, hi), ib = batch_idx(idx, lo + kLongBatch, hi);
  load_batch<T, kPair>(xa, ia, rows, d, c);
  for (int base = lo; base < hi; base += 2 * kLongBatch) {
    ia = batch_idx(idx, base + 2 * kLongBatch, hi);
    load_batch<T, kPair>(xb, ib, rows, d, c);
#pragma unroll
    for (int u = 0; u < kLongBatch; ++u) L::add(acc, xa[u]);
    ib = batch_idx(idx, base + 3 * kLongBatch, hi);
    load_batch<T, kPair>(xa, ia, rows, d, c);
#pragma unroll
    for (int u = 0; u < kLongBatch; ++u) L::add(acc, xb[u]);
  }
  T* dst = out + static_cast<int64_t>(key) * d + c;
  if (c < d) store1(dst, acc[0]);
  if (L::kCols == 2 && c + 1 < d) store1(dst + 1, acc[1]);
}

// output row w: its segment found by two searches, added by add_short
// unless it holds more than kLong ids (long_segment_kernel's then)
template <typename T, bool kVec>
__global__ void __launch_bounds__(kSegWarps * 32)
short_segment_kernel(const int* __restrict__ keys, const int* __restrict__ idx,
                     const int* __restrict__ count, const T* __restrict__ rows,
                     T* __restrict__ out, int64_t v, int64_t d) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kSegWarps + threadIdx.x / 32;
  if (row >= v) return;
  const int m = count != nullptr ? *count : 0;
  const int lo = warp_lower_bound(keys, 0, m, row);
  const int hi = warp_lower_bound(keys, lo, m, row + 1);
  if (hi - lo <= kLong) add_short<T, kVec>(idx, lo, hi, rows, out + row * d, d);
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
  if (n < 0 || n >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = static_cast<int>((n + kTile - 1) / kTile);
  int* keys[2] = {scratch, scratch + 2 * n};
  int* idx[2] = {scratch + n, scratch + 3 * n};
  int* hist = scratch + 4 * n;
  int* count = hist + static_cast<int64_t>(kDigits) * tiles;
  const int* src_keys = ids;
  const int* src_idx = nullptr;
  if (n > 0) {
    const int passes = sort_passes(v);
    for (int p = 0; p < passes; ++p) {
      int* dk = keys[p % 2];
      int* di = idx[p % 2];
      if (p == 0) {
        radix_hist_kernel<true><<<tiles, kSortThreads, 0, s>>>(src_keys, count, n, v, 0, hist, tiles);
        radix_scatter_kernel<true><<<tiles, kSortThreads, 0, s>>>(src_keys, src_idx, count, n, v, 0,
                                                                  hist, tiles, dk, di);
      } else {
        radix_hist_kernel<false><<<tiles, kSortThreads, 0, s>>>(src_keys, count, n, v, 8 * p,
                                                                hist, tiles);
        radix_scatter_kernel<false><<<tiles, kSortThreads, 0, s>>>(src_keys, src_idx, count, n, v,
                                                                   8 * p, hist, tiles, dk, di);
      }
      src_keys = dk;
      src_idx = di;
    }
  }
  // 4 elements a lane: 16-byte (float32) or 8-byte (bf16) accesses
  const bool vec = d % 4 == 0 && (reinterpret_cast<uintptr_t>(rows) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const dim3 grid(static_cast<unsigned>((v + kSegWarps - 1) / kSegWarps)), block(kSegWarps * 32);
  const int* sorted_count = n > 0 ? count : nullptr;
  if (vec)
    short_segment_kernel<T, true><<<grid, block, 0, s>>>(src_keys, src_idx, sorted_count, rows,
                                                         out, v, d);
  else
    short_segment_kernel<T, false><<<grid, block, 0, s>>>(src_keys, src_idx, sorted_count, rows,
                                                          out, v, d);
  if (n > kLong) {
    // bf16 rows of an even width: two columns a lane, 32-bit loads
    bool pair = false;
    if constexpr (sizeof(T) == 2)
      pair = d % 2 == 0 && (reinterpret_cast<uintptr_t>(rows) & 3) == 0;
    const int64_t chunks = pair ? (d + 63) / 64 : (d + 31) / 32;
    const int64_t blocks = (n + kLong - 1) / kLong * chunks;
    if (blocks >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
    if constexpr (sizeof(T) == 2) {
      if (pair) {
        long_segment_kernel<T, true><<<static_cast<unsigned>(blocks), 32, 0, s>>>(
            src_keys, src_idx, count, rows, out, d, chunks);
        return static_cast<int>(cudaGetLastError());
      }
    }
    long_segment_kernel<T, false><<<static_cast<unsigned>(blocks), 32, 0, s>>>(
        src_keys, src_idx, count, rows, out, d, chunks);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ids: [n] int32; rows: [n, d] and out: [v, d] float32 (or bf16), every
// element of out written; scratch: 4 * n + 256 * ceil(n / 2048) + 1 int32
// (two key and two index arrays, the [256, tiles] histogram, the count of
// valid ids).  n < 2**31.  Launches 2 * passes + 2 kernels on ``stream``;
// returns the first error.
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
