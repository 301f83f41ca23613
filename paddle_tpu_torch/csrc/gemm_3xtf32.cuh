// The tensor-core GEMM mainloops for Hopper (sm_90a) of the fused linear +
// softmax cross-entropy forward (K7, csrc/linear_ce.cu) and backward (K8,
// csrc/linear_ce_bwd.cu): the 3xTF32 kernel template gemm_3xtf32_kernel<kEpi>
// (float32 operands), whose epilogue is what differs between them, and the
// bf16 one, gemm_bf16_kernel<kEpi> (K7's bf16 instance), with the same
// epilogues (the epilogue<kEpi> function below).
//
// C[m, n] = sum_k At[k, m] * Bk[n, k], float32 in, float32 sums, on the
// tensor cores at 495 TFLOP/s TF32 (an H100 SXM) as three TF32 products.
//
// 3xTF32.  One TF32 product keeps 10 mantissa bits of each operand and fails
// the float32 gates.  Each float32 operand v is split into hi = v with its
// low 13 mantissa bits cleared (what the tensor core reads of a float32 word)
// and lo = tf32(v - hi), rounded to nearest; every k-step of 32 runs its
// eight small products (a_lo * b_hi, a_hi * b_lo) and then its four large
// ones (a_hi * b_hi).  The dropped a_lo * b_lo is 2^-22 of the product.
// The tensor core truncates when it adds into its accumulator, an error
// with the sign of the sum that grows with the length of the chain (7e-6
// norm-relative at K = 1028 in one chain, measured); so wgmma sums one
// k-step of 32 from zero and the CUDA cores add the k-steps, rounded to
// nearest.  That holds the error at float32's (2e-7 to 5e-7).
//
// One mainloop serves the three products: C[m, n] = sum_k At[k, m] * Bk[n, k].
//  * Bk is K-major, the only layout wgmma reads 32-bit operands in.  TMA
//    brings 128 rows x 32 k (128-byte rows, 128-byte swizzle) a stage; three
//    splitter warps write lo of every staged element into a tile beside it
//    (elementwise, so blind to the swizzle), and wgmma reads hi from the
//    staged tile itself and lo from the second.  Costs: 16 KB of shared
//    memory a stage and 16 KB read + 16 KB written per k-step; no pass over
//    device memory.
//  * At is M-major and goes through registers, where the split is free: TMA
//    brings 32 k x 128 m as four boxes of 32 x 32 (128-byte swizzle) and each
//    thread loads its wgmma A fragment from them.  Fragment row r of a warp
//    is mapped to tile row (r % 4) + 16 * ((r % 8) / 4) + 4 * (r / 8) (+ 8
//    for odd warps) so that the 32 lanes of each load hit 32 banks; the
//    epilogue stores by the same map.
//  Persistent blocks (one an SM, 384 threads) walk 128 x 128 output tiles.
//  One warpgroup feeds: a producer thread keeps a ring of four stages filled
//  by TMA across tile boundaries, and the splitter warps follow it.  Two
//  consumer warpgroups run wgmma.m64n128k8.tf32 with A from registers on 64
//  rows each; they meet at no barrier in the mainloop, so one's bookkeeping
//  (adding the stage's sum, splitting the next A fragments) runs under the
//  other's products.  setmaxnreg gives the feeding warpgroup 40 registers a
//  thread and the consumers 232 (two accumulators of 64, the fragments).
//
// Epilogues: kStore writes (or adds into) C; kDl writes the backward's
// dlT tile and its row sums (csrc/linear_ce_bwd.cu); kLse reduces each tile
// column's max and sum of exp over each warpgroup's 64 rows, for the
// forward (csrc/linear_ce.cu).
//
// The bf16 mainloop, gemm_bf16_kernel<kEpi> (K7's bf16 instance): C[m, n] =
// sum_k At[k, m] * Bk[n, k] with At bf16 and M-major, Bk bf16 and K-major,
// on wgmma.m64n128k16.f32.bf16.bf16, both operands read from shared memory
// through descriptors (no split, no register path).  For 16-bit types
// wgmma reads an MN-major operand as it is stored (its transpose bit), so
// At is the matrix as the caller holds it: TMA brings 64 k x 64 m boxes of
// At (128-byte rows, 128-byte swizzle), one per consumer warpgroup's 64 rows,
// and 128 rows x 64 k of Bk a stage.  A product of two bf16 values is exact
// in float32; as in the 3xTF32 loop, wgmma sums one stage (64 k) from zero
// and the CUDA cores add the stages, so the tensor core's truncating
// accumulation never runs a chain longer than 64.  Each consumer warpgroup
// keeps two stage sums in turn: stage j + 1's products are issued before
// stage j's are waited for and added, so the tensor core does not idle
// through the adds.  The three accumulators (192 registers a thread) need
// setmaxnreg: a producer warpgroup (one thread issues the copies) keeps 40
// registers a thread and the two consumer warpgroups take 232, as in the
// 3xTF32 loop.  Both operands stream through one ring of six k-steps; the
// tiles are walked n fastest, so the blocks at work at once share At's row
// tile in L2.  (Keeping that row tile in shared memory through a block's
// run of tiles halved the bytes from L2 but gained nothing once the
// epilogue ran: tools/k7_split.py, PERF.md.)  The same epilogues.
#pragma once
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 32;   // block tile; k-step in floats (128 bytes)
constexpr int kStages = 4;
constexpr int kConsumers = 2;                   // warpgroups of 64 rows
constexpr int kConsumerThreads = kConsumers * 128;
constexpr int kThreads = kConsumerThreads + 128;  // and the producer's warpgroup:
constexpr int kSplitThreads = 96;               // one warp for TMA, three that split B
constexpr int kTileBytes = kBM * kBK * 4;       // one A or B stage: 16 KB
static_assert(kBM == kBN, "A and B stages have one size");
constexpr int kStageBytes = 2 * kTileBytes;
constexpr int kBoxBytes = 32 * 128;             // one 32 k x 32 m box of A
// a stage: A, B and B's lo tile; three barriers a stage; 1 KB to align
constexpr int kSmem = kStages * (kStageBytes + kTileBytes) + 3 * kStages * 8 + 1024;
// kLse: each consumer warp's (max, sum) of every tile column, two tiles'
// worth (by tile parity), after the barriers
constexpr int kConsumerWarps = kConsumerThreads / 32;
constexpr int kXchgFloats = kConsumerWarps * 2 * kBN;
constexpr int kOffXchg = kStages * (kStageBytes + kTileBytes) + 128;
constexpr int kSmemLse = kOffXchg + 2 * kXchgFloats * 4 + 1024;
static_assert(3 * kStages * 8 <= 128, "the barriers fit before the exchange area");
constexpr uint32_t kHiMask = 0xffffe000u;       // a float32 word without its low 13 mantissa bits

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// mbar_arrive where pred holds, without a branch: a divergent branch while a
// wgmma is in flight makes the compiler serialize the wgmmas
__device__ __forceinline__ void mbar_arrive_if(uint64_t* bar, bool pred) {
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %1, 0;\n"
               " @p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n"
               ::"r"(smem_u32(bar)), "r"(static_cast<int>(pred)) : "memory");
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

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor of a tile of 128-byte rows in the 128-byte
// swizzle that TMA wrote: 8-row groups 1024 bytes apart (SBO).  A K-major
// tile's rows are its M or N rows and LBO is unused (1); an MN-major tile's
// rows are its k rows, 64 elements of M or N each, and LBO is the distance
// to the next 64 of M or N
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo = 16) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d = (keep_d ? d : 0) + a (m64k8 fragment in registers) * b (n128k8, shared memory), TF32
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64], uint32_t a0, uint32_t a1,
                                                     uint32_t a2, uint32_t a3, uint64_t db,
                                                     int keep_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(keep_d));
}

// keep the compiler from moving accumulator reads, or from reusing the A
// fragment's registers, across the asynchronous wgmma
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_frag(uint32_t (&a)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// the split: hi by clearing 13 bits, lo = (v - hi) rounded to TF32
__device__ __forceinline__ uint32_t tf32_hi(float v) { return __float_as_uint(v) & kHiMask; }
__device__ __forceinline__ uint32_t tf32_lo(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v - __uint_as_float(tf32_hi(v))));
  return r;
}

// what the epilogue does with a tile
struct Epilogue {
  float* out;            // [m, n] output, row stride ldo
  int64_t ldo;
  int accumulate;        // kStore: out += tile
  // kDl only: out is dlT for the chunk at column v0 of the vocabulary
  const float* bias;     // [V] or null
  const int* labels;     // [n]
  const float* lse;      // [n]
  const float* g;        // [n]
  float* part;           // [n tiles, part_ld] row sums of dlT, or null
  int part_ld;
  int v0;
  // kLse only (bias, labels as above): per half row tile (the 64 rows of
  // one consumer warpgroup) and column, the max and the sum of
  // exp(C + bias - max) over those rows, [2 * m tiles, n] each; and C + bias
  // at the label's row, written by the one thread holding it
  float* lse_max;
  float* lse_sum;
  float* label_logit;    // [n]
};

enum { kStore = 0, kDl = 1, kLse = 2 };

// tools/k7_split.py builds K7 bf16 with one of these set, to time one part
// of it: PTT_K7_NO_EPILOGUE (the mainloop alone), PTT_K7_FAST_EXP (kLse's
// column exps as __expf), PTT_K7_NO_SHUFFLE (kLse without its shuffles).
// Their results are wrong by design; no build of the port sets them.
#ifdef PTT_K7_FAST_EXP
#define PTT_LSE_EXP __expf
#else
#define PTT_LSE_EXP expf
#endif
#ifdef PTT_K7_NO_SHUFFLE
#define PTT_LSE_SHFL(v, off) (v)
#else
#define PTT_LSE_SHFL(v, off) __shfl_xor_sync(0xffffffffu, v, off)
#endif

// *p = v where pred holds, as a predicated store: no branch
__device__ __forceinline__ void store_if(float* p, float v, bool pred) {
  asm volatile("{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n @q st.global.f32 [%0], %1;\n}\n"
               ::"l"(p), "f"(v), "r"(static_cast<int>(pred)) : "memory");
}

// the 128 threads of consumer warpgroup wg alone (barrier 0 is __syncthreads')
__device__ __forceinline__ void warpgroup_barrier(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

__device__ __forceinline__ void tile_origin(int tile, int mt, int nt, int n_fast, int& m0,
                                            int& n0) {
  if (n_fast) {
    m0 = (tile / nt) * kBM;
    n0 = (tile % nt) * kBN;
  } else {
    m0 = (tile % mt) * kBM;
    n0 = (tile / mt) * kBN;
  }
}

// what a consumer thread does with its part of an output tile (m0, n0): the
// accumulator fragment of m64n128, acc[4j + 2h + e] at fragment row gq + 8h
// of its warp's 16, which is tile row row_h[h], and column 8j + 2 * tq + e.
// xchg is kLse's exchange area for this tile (consumer warps 0-7 of the
// block, warpgroup wg of this thread)
template <int kEpi>
__device__ __forceinline__ void epilogue(const float (&acc)[64], const int (&row_h)[2], int m0,
                                         int n0, int m, int n, const Epilogue& ep, float* xchg,
                                         int warp, int wg) {
  const int lane = threadIdx.x % 32;
  const int tq = lane & 3;
  if (kEpi == kStore) {
    const bool vec2 = (ep.ldo & 1) == 0 && (reinterpret_cast<uintptr_t>(ep.out) & 7) == 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + row_h[h];
      if (row >= m) continue;
      float* dst = ep.out + static_cast<int64_t>(row) * ep.ldo;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = n0 + 8 * j + 2 * tq;
        float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if (vec2 && col + 1 < n) {
          float2* p = reinterpret_cast<float2*>(dst + col);
          if (ep.accumulate) {
            const float2 old = *p;
            v0 += old.x;
            v1 += old.y;
          }
          *p = make_float2(v0, v1);
        } else {
          if (col < n) dst[col] = ep.accumulate ? dst[col] + v0 : v0;
          if (col + 1 < n) dst[col + 1] = ep.accumulate ? dst[col + 1] + v1 : v1;
        }
      }
    }
  } else if (kEpi == kLse) {
    // tile rows are vocabulary columns v, tile columns batch rows b.  Per
    // column: the max over the warp's 16 rows (8 lanes x 2 halves, by
    // shuffles), the sum of exp(logit - max) over them the same way, then
    // the warpgroup's 4 warps' pairs merged in warp order through shared
    // memory.  Each step runs over all 32 of the thread's columns before the
    // next, so its 32 shuffles or exps are independent of each other, and
    // no step branches (with a branch around each exp and store the
    // epilogue took nearly twice as long).  Each warpgroup keeps
    // its own half of the tile, so the two meet at no barrier here either
    float bias_h[2] = {0.f, 0.f};
    bool in_h[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      in_h[h] = m0 + row_h[h] < m;
      if (ep.bias != nullptr) bias_h[h] = __ldg(ep.bias + min(m0 + row_h[h], m - 1));
    }
    // the logit of column c = 2 j + e (tile column 8 j + 2 tq + e) at half h
    auto logit = [&](int c, int h) {
      return in_h[h] ? acc[4 * (c >> 1) + 2 * h + (c & 1)] + bias_h[h] : -INFINITY;
    };
    // the label's logit, written by the one thread holding it
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int b = n0 + 8 * (c >> 1) + 2 * tq + (c & 1);
      const int lab = __ldg(ep.labels + min(b, n - 1));
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store_if(ep.label_logit + b, logit(c, h), b < n && in_h[h] && lab == m0 + row_h[h]);
    }
    float cmax[32], csum[32];
#pragma unroll
    for (int c = 0; c < 32; ++c) cmax[c] = fmaxf(logit(c, 0), logit(c, 1));
#pragma unroll
    for (int off = 4; off <= 16; off *= 2)
#pragma unroll
      for (int c = 0; c < 32; ++c)
        cmax[c] = fmaxf(cmax[c], PTT_LSE_SHFL(cmax[c], off));
    // a row past m has logit -inf and exp 0: no branch around the exps
    // (a column of the warp with no row has max -inf: subtract 0 there)
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const float ref = cmax[c] == -INFINITY ? 0.f : cmax[c];
      csum[c] = PTT_LSE_EXP(logit(c, 0) - ref) + PTT_LSE_EXP(logit(c, 1) - ref);
    }
#pragma unroll
    for (int off = 4; off <= 16; off *= 2)
#pragma unroll
      for (int c = 0; c < 32; ++c) csum[c] += PTT_LSE_SHFL(csum[c], off);
    // the 8 lanes of a column hold the same pair: all store it (no branch)
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int col = 8 * (c >> 1) + 2 * tq + (c & 1);
      xchg[warp * 2 * kBN + col] = cmax[c];
      xchg[warp * 2 * kBN + kBN + col] = csum[c];
    }
    warpgroup_barrier(wg);
    // one thread a column merges the warpgroup's 4 warps; the next tile's
    // pairs go to the other half of the exchange area
    const int col = threadIdx.x % 128;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 4 * wg; w < 4 * wg + 4; ++w) mx = fmaxf(mx, xchg[w * 2 * kBN + col]);
    float s = 0.f;
#pragma unroll
    for (int w = 4 * wg; w < 4 * wg + 4; ++w) {
      const float sw = xchg[w * 2 * kBN + kBN + col];   // 0: no row of that warp
      s += sw * expf(sw > 0.f ? xchg[w * 2 * kBN + col] - mx : -INFINITY);
    }
    const int64_t idx = static_cast<int64_t>(2 * (m0 / kBM) + wg) * n + n0 + col;
    store_if(ep.lse_max + idx, mx, n0 + col < n);
    store_if(ep.lse_sum + idx, s, n0 + col < n);
  } else {
    // dlT[v, b] = (exp(logit + bias[v] - lse[b]) - (labels[b] == v)) * g[b]:
    // tile rows are the chunk's vocabulary columns, tile columns the rows b
    float bias_h[2] = {0.f, 0.f}, sum_h[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (ep.bias != nullptr && m0 + row_h[h] < m) bias_h[h] = ep.bias[ep.v0 + m0 + row_h[h]];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + 8 * j + 2 * tq;
      float lse_e[2], g_e[2];
      int lab_e[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool in = col + e < n;
        lse_e[e] = in ? __ldg(ep.lse + col + e) : 0.f;
        g_e[e] = in ? __ldg(ep.g + col + e) : 0.f;
        lab_e[e] = in ? __ldg(ep.labels + col + e) - ep.v0 : -1;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + row_h[h];
        if (row >= m) continue;
        float val[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = expf(acc[4 * j + 2 * h + e] + bias_h[h] - lse_e[e]);
          val[e] = col + e < n ? (p - (lab_e[e] == row ? 1.f : 0.f)) * g_e[e] : 0.f;
        }
        float* dst = ep.out + static_cast<int64_t>(row) * ep.ldo + col;
        if (col + 1 < n) {
          *reinterpret_cast<float2*>(dst) = make_float2(val[0], val[1]);
        } else if (col < n) {
          *dst = val[0];
        }
        sum_h[h] += val[0] + val[1];
      }
    }
    if (ep.part != nullptr) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float s = sum_h[h];
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        const int row = m0 + row_h[h];
        if (tq == 0 && row < m)
          ep.part[static_cast<int64_t>(n0 / kBN) * ep.part_ld + row] = s;
      }
    }
  }
}

// C[m, n] = sum_k At[k, m] * Bk[n, k] in 3xTF32; tma_a boxes are 32 k x 32 m
// of At, tma_b boxes 128 n x 32 k of Bk.  n_fast: neighbouring blocks share
// their rows of At (else their rows of Bk).
template <int kEpi>
__global__ void __launch_bounds__(kThreads, 1)
gemm_3xtf32_kernel(const __grid_constant__ CUtensorMap tma_a,
                   const __grid_constant__ CUtensorMap tma_b, int m, int n, int k, int n_fast,
                   const Epilogue ep) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;     // 128-byte swizzle atoms: 1024-aligned
  uint8_t* smem = smem_raw + (base - raw);
  constexpr int kOffB = kStages * kTileBytes, kOffLo = 2 * kStages * kTileBytes;
  // full: TMA has filled the stage; split: B's lo tile is written too;
  // empty: both consumer warpgroups are done with the stage
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kOffLo + kStages * kTileBytes);
  uint64_t* split = full + kStages;
  uint64_t* empty = split + kStages;

  const int warp = threadIdx.x / 32;
  const int nk = (k + kBK - 1) / kBK;
  const int mt = (m + kBM - 1) / kBM, nt = (n + kBN - 1) / kBN;
  const int tiles = mt * nt;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&split[s], kSplitThreads);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // 384 threads start with 168 registers each; the producer's warpgroup
  // keeps 40 and the consumers take 232 (128 * 40 + 256 * 232 = 384 * 168)
  if (warp >= kConsumers * 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == kConsumers * 4) {
      // producer: one thread keeps the ring filled, across tile boundaries
      if (threadIdx.x % 32 == 0) {
        int it = 0;
        for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
          int m0, n0;
          tile_origin(tile, mt, nt, n_fast, m0, n0);
          for (int kt = 0; kt < nk; ++kt, ++it) {
            const int s = it % kStages;
            if (it >= kStages) mbar_wait(&empty[s], ((it / kStages) - 1) & 1);
            mbar_expect_tx(&full[s], kStageBytes);
#pragma unroll
            for (int i = 0; i < kBM / 32; ++i)
              tma_load_2d(base + s * kTileBytes + i * kBoxBytes, &tma_a, m0 + 32 * i, kt * kBK,
                          &full[s]);
            tma_load_2d(base + kOffB + s * kTileBytes, &tma_b, kt * kBK, n0, &full[s]);
          }
        }
      }
    } else {
      // splitters: write lo of every element of each stage's B tile beside
      // it (the stage is not refilled before the consumers, who wait for
      // this, have released it)
      const int t = threadIdx.x - kConsumerThreads - 32;
      int64_t stages = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) stages += nk;
      for (int64_t it = 0; it < stages; ++it) {
        const int s = static_cast<int>(it % kStages);
        mbar_wait(&full[s], static_cast<unsigned>(it / kStages) & 1);
        const float4* src = reinterpret_cast<const float4*>(smem + kOffB + s * kTileBytes);
        float4* dst = reinterpret_cast<float4*>(smem + kOffLo + s * kTileBytes);
#pragma unroll 2
        for (int idx = t; idx < kTileBytes / 16; idx += kSplitThreads) {
          const float4 v = src[idx];
          dst[idx] = make_float4(__uint_as_float(tf32_lo(v.x)), __uint_as_float(tf32_lo(v.y)),
                                 __uint_as_float(tf32_lo(v.z)), __uint_as_float(tf32_lo(v.w)));
        }
        // the writes go to wgmma: order them before the arrival
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(&split[s]);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = warp / 4, w4 = warp % 4, lane = threadIdx.x % 32;
  const int gq = lane >> 2, tq = lane & 3;
  // A fragment word r of k-step ks: fragment row gq + 8 * (r & 1), k = 8 * ks
  // + tq + 4 * (r >> 1).  The row's place in its 32 x 32 box: 16-byte chunk
  // c0 + (r & 1), word gq & 3; the swizzle xors the chunk with k & 7.
  const int box = 2 * wg + (w4 >> 1);
  const int c0 = 2 * (w4 & 1) + 4 * (gq >> 2);
  int a_off[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int k7 = tq + 4 * (r >> 1);
    a_off[r] = box * kBoxBytes + k7 * 128 + (((c0 + (r & 1)) ^ k7) << 4) + (gq & 3) * 4;
  }
  // tile row of accumulator row half h (fragment rows gq and gq + 8)
  int row_h[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) row_h[h] = 32 * box + 8 * (w4 & 1) + 4 * h + 16 * (gq >> 2) + (gq & 3);

  // acc: the tile's float32 sum; part: one stage's sum, kept by wgmma (a
  // chain in the tensor core's truncating accumulator is one stage long)
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) part[i] = 0.f;
  // this thread's A fragments: of the stage in the tensor cores, split (wgmma
  // reads these registers until its group completes), and of the next, whole
  uint32_t hi[16], lo[16];
  float next_a[16];
  int it = 0;

  // stage j has arrived and its lo tile is written: load its A fragments
  auto take_stage = [&](int j) {
    const int s = j % kStages;
    mbar_wait(&full[s], (j / kStages) & 1);
    mbar_wait(&split[s], (j / kStages) & 1);
    const uint8_t* a = smem + s * kTileBytes;
#pragma unroll
    for (int ks = 0; ks < kBK / 8; ++ks) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        next_a[4 * ks + r] = *reinterpret_cast<const float*>(a + a_off[r] + ks * 1024);
    }
  };

  int tile_no = 0;   // this block's tiles so far
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++tile_no) {
    int m0, n0;
    tile_origin(tile, mt, nt, n_fast, m0, n0);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    if (nk > 0) take_stage(it);
#pragma unroll 1
    for (int kt = 0; kt < nk; ++kt, ++it) {
      // one k-step of 32: split the A fragments, start the stage's products,
      // and meanwhile take the next stage
      const int s = it % kStages;
      const uint32_t b_hi = base + kOffB + s * kTileBytes;
      const uint32_t b_lo = base + kOffLo + s * kTileBytes;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        hi[i] = tf32_hi(next_a[i]);
        lo[i] = tf32_lo(next_a[i]);
      }
      fence_acc(part);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      // the small terms first, then the four large ones
#pragma unroll
      for (int ks = 0; ks < kBK / 8; ++ks) {
        const uint64_t dh = smem_desc(b_hi + ks * 32), dl = smem_desc(b_lo + ks * 32);
        wgmma_m64n128k8_tf32(part, lo[4 * ks], lo[4 * ks + 1], lo[4 * ks + 2], lo[4 * ks + 3], dh,
                             ks > 0);
        wgmma_m64n128k8_tf32(part, hi[4 * ks], hi[4 * ks + 1], hi[4 * ks + 2], hi[4 * ks + 3], dl,
                             1);
      }
#pragma unroll
      for (int ks = 0; ks < kBK / 8; ++ks)
        wgmma_m64n128k8_tf32(part, hi[4 * ks], hi[4 * ks + 1], hi[4 * ks + 2], hi[4 * ks + 3],
                             smem_desc(b_hi + ks * 32), 1);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      if (kt + 1 < nk) take_stage(it + 1);
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(part);
      fence_frag(hi);
      fence_frag(lo);
      if (threadIdx.x % 128 == 0) mbar_arrive(&empty[s]);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];
    }

    float* xchg = reinterpret_cast<float*>(smem + kOffXchg) + (tile_no & 1) * kXchgFloats;
    epilogue<kEpi>(acc, row_h, m0, n0, m, n, ep, xchg, warp, wg);
  }
}


// d = (keep_d ? d : 0) + a (m64k16) * b (n128k16), bf16 in, float32 sums;
// both operands in shared memory: a M-major (transposed, k rows of 64 m),
// b K-major (n rows of 64 k)
__device__ __forceinline__ void wgmma_m64n128k16_bf16(float (&d)[64], uint64_t da, uint64_t db,
                                                      int keep_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(keep_d));
}

constexpr int kBKh = 64;                         // k-step of the bf16 loop: 128-byte rows
constexpr int kBoxBytesBf16 = kBKh * 128;        // one 64 k x 64 m box of At
static_assert(kConsumers * kBoxBytesBf16 == kTileBytes, "a warpgroup's box of At each");
static_assert(kBM * kBKh * 2 == kTileBytes, "a bf16 k-step of A or B is 16 KB, as a float32 one");
// a ring of stages, each one k-step of At (a 64 k x 64 m box per consumer
// warpgroup) and of Bk (128 n x 64 k)
constexpr int kStagesBf16 = 6;
constexpr int kOffBarBf16 = kStagesBf16 * kStageBytes;   // then the barriers
constexpr int kOffXchgBf16 = kOffBarBf16 + 128;
static_assert(2 * kStagesBf16 * 8 <= 128, "the barriers fit before the exchange area");
constexpr int kSmemBf16 = kOffXchgBf16 + 1024;
constexpr int kSmemBf16Lse = kOffXchgBf16 + 2 * kXchgFloats * 4 + 1024;

// C[m, n] = sum_k At[k, m] * Bk[n, k] in bf16 with float32 sums; tma_a
// boxes are 64 k x 64 m of At, tma_b boxes 128 n x 64 k of Bk.  Block b
// takes output tiles b, b + gridDim.x, ... in row-major order (n fastest),
// so the blocks at work at once share At's row tile, which L2 then serves.
template <int kEpi>
__global__ void __launch_bounds__(kThreads, 1)
gemm_bf16_kernel(const __grid_constant__ CUtensorMap tma_a,
                 const __grid_constant__ CUtensorMap tma_b, int m, int n, int k,
                 const Epilogue ep) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;     // 128-byte swizzle atoms: 1024-aligned
  uint8_t* smem = smem_raw + (base - raw);
  // full: TMA has filled the stage; empty: both consumer warpgroups are done with it
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kOffBarBf16);
  uint64_t* empty = full + kStagesBf16;

  const int warp = threadIdx.x / 32;
  const int nk = (k + kBKh - 1) / kBKh;
  const int mt = (m + kBM - 1) / kBM, nt = (n + kBN - 1) / kBN;
  const int tiles = mt * nt;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStagesBf16; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // 384 threads start with 168 registers each; the producer's warpgroup
  // keeps 40 and the consumers take 232
  if (warp >= kConsumers * 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    // producer: one thread keeps the ring filled, across tile boundaries
    if (threadIdx.x == kConsumerThreads) {
      int g = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / nt) * kBM, n0 = (tile % nt) * kBN;
        for (int kt = 0; kt < nk; ++kt, ++g) {
          const int s = g % kStagesBf16;
          if (g >= kStagesBf16) mbar_wait(&empty[s], (g / kStagesBf16 - 1) & 1);
          mbar_expect_tx(&full[s], kStageBytes);
          for (int i = 0; i < kConsumers; ++i)
            tma_load_2d(base + s * kStageBytes + i * kBoxBytesBf16, &tma_a, m0 + 64 * i,
                        kt * kBKh, &full[s]);
          tma_load_2d(base + s * kStageBytes + kTileBytes, &tma_b, kt * kBKh, n0, &full[s]);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = warp / 4, w4 = warp % 4, lane = threadIdx.x % 32;
  const int gq = lane >> 2;
  // tile row of accumulator row half h: the warpgroup's 64 rows, 16 a warp
  const int row_h[2] = {64 * wg + 16 * w4 + gq, 64 * wg + 16 * w4 + gq + 8};
  // acc: the tile's float32 sum; part0, part1: one k-step's sum each, kept
  // by wgmma in turn, so that one k-step's products run while the CUDA cores
  // add the other's (the order of the sums is the same as with one)
  float acc[64], part0[64], part1[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) part0[i] = part1[i] = 0.f;
  // start the block's g-th k-step into p, from zero, as one wgmma group
  auto issue = [&](float (&p)[64], int g) {
    const int s = g % kStagesBf16;
    const uint32_t a = base + s * kStageBytes + wg * kBoxBytesBf16;
    const uint32_t b = base + s * kStageBytes + kTileBytes;
    mbar_wait(&full[s], (g / kStagesBf16) & 1);
    fence_acc(p);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < kBKh / 16; ++ks)
      wgmma_m64n128k16_bf16(p, smem_desc(a + ks * 16 * 128, kBoxBytesBf16),
                            smem_desc(b + ks * 32), ks > 0);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  };
  // that group has completed into p: release its stage and add p
  auto retire = [&](float (&p)[64], int g) {
    fence_acc(p);
    mbar_arrive_if(&empty[g % kStagesBf16], threadIdx.x % 128 == 0);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += p[i];
  };

  for (int tile = blockIdx.x, tile_no = 0, g = 0; tile < tiles;
       tile += gridDim.x, ++tile_no, g += nk) {
    const int m0 = (tile / nt) * kBM, n0 = (tile % nt) * kBN;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    // part0 holds k-step kt in flight at the top of each pair (nk >= 1)
    issue(part0, g);
    int kt = 0;
#pragma unroll 1
    for (; kt + 2 < nk; kt += 2) {
      issue(part1, g + kt + 1);
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      retire(part0, g + kt);
      issue(part0, g + kt + 2);
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      retire(part1, g + kt + 1);
    }
    if (kt + 1 < nk) {   // the last two k-steps
      issue(part1, g + kt + 1);
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      retire(part0, g + kt);
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      retire(part1, g + kt + 1);
    } else {             // the last k-step
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      retire(part0, g + kt);
    }
#ifdef PTT_K7_NO_EPILOGUE
    float folded = 0.f;   // kept, so that the products are not dropped
#pragma unroll
    for (int i = 0; i < 64; ++i) folded += acc[i];
    store_if(ep.label_logit + tile_no, folded, folded == 1234.5f);
#else
    float* xchg = reinterpret_cast<float*>(smem + kOffXchgBf16) + (tile_no & 1) * kXchgFloats;
    epilogue<kEpi>(acc, row_h, m0, n0, m, n, ep, xchg, warp, wg);
#endif
  }
}

// cuTensorMapEncodeTiled from libcuda, found at run time so that the
// library needs no link flag of its own
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault) == cudaSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a float32 (or, with bf16, bf16) matrix of `outer` rows of `inner`
// contiguous elements, row stride ld, read in boxes of box_outer rows x 128
// bytes (32 float32 or 64 bf16 elements)
bool make_map(CUtensorMap* map, const void* ptr, int64_t inner, int64_t outer, int64_t ld,
              int box_outer, bool bf16 = false) {
  const EncodeTiledFn fn = encode_fn();
  if (fn == nullptr || inner <= 0 || outer <= 0) return false;
  const int elem = bf16 ? 2 : 4;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / elem),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t elem_strides[2] = {1, 1};
  return fn(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
            const_cast<void*>(ptr), dims, strides, box, elem_strides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// C = At^T Bk^T: at [k, m] with row stride lda, bk [n, k] with row stride
// ldb (both strides multiples of 4 floats, both pointers 16-byte aligned)
template <int kEpi>
cudaError_t launch_gemm(const float* at, int64_t lda, const float* bk, int64_t ldb, int m, int n,
                        int k, int n_fast, const Epilogue& ep, cudaStream_t stream) {
  constexpr int smem = kEpi == kLse ? kSmemLse : kSmem;
  static int resident = 0;   // blocks the card holds at once
  if (resident == 0) {
    cudaError_t e = cudaFuncSetAttribute(gemm_3xtf32_kernel<kEpi>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int dev = 0, sms = 0, per_sm = 0;
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gemm_3xtf32_kernel<kEpi>,
                                                        kThreads, smem);
    if (e != cudaSuccess) return e;
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  if (m <= 0 || n <= 0) return cudaSuccess;
  if (k <= 0 || lda % 4 != 0 || ldb % 4 != 0 || !aligned16(at) || !aligned16(bk))
    return cudaErrorInvalidValue;
  const int64_t tiles = static_cast<int64_t>((m + kBM - 1) / kBM) * ((n + kBN - 1) / kBN);
  if (tiles >= (1ll << 31)) return cudaErrorInvalidValue;
  alignas(64) CUtensorMap ma, mb;
  if (!make_map(&ma, at, m, k, lda, 32) || !make_map(&mb, bk, k, n, ldb, kBN))
    return cudaErrorInvalidValue;
  const int grid = static_cast<int>(tiles < resident ? tiles : resident);
  gemm_3xtf32_kernel<kEpi><<<grid, kThreads, smem, stream>>>(ma, mb, m, n, k, n_fast, ep);
  return cudaGetLastError();
}

// C = At^T Bk^T in bf16 with float32 sums: at [k, m] with row stride lda,
// bk [n, k] with row stride ldb (bf16 elements; both strides multiples of
// 8, both pointers 16-byte aligned)
template <int kEpi>
cudaError_t launch_gemm_bf16(const void* at, int64_t lda, const void* bk, int64_t ldb, int m,
                             int n, int k, const Epilogue& ep, cudaStream_t stream) {
  constexpr int smem = kEpi == kLse ? kSmemBf16Lse : kSmemBf16;
  static int resident = 0;   // blocks the card holds at once
  if (resident == 0) {
    cudaError_t e = cudaFuncSetAttribute(gemm_bf16_kernel<kEpi>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int dev = 0, sms = 0, per_sm = 0;
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gemm_bf16_kernel<kEpi>,
                                                        kThreads, smem);
    if (e != cudaSuccess) return e;
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  if (m <= 0 || n <= 0) return cudaSuccess;
  if (k <= 0 || lda % 8 != 0 || ldb % 8 != 0 || !aligned16(at) || !aligned16(bk))
    return cudaErrorInvalidValue;
  const int64_t tiles = static_cast<int64_t>((m + kBM - 1) / kBM) * ((n + kBN - 1) / kBN);
  if (tiles >= (1ll << 31)) return cudaErrorInvalidValue;
  alignas(64) CUtensorMap ma, mb;
  if (!make_map(&ma, at, m, k, lda, kBKh, true) || !make_map(&mb, bk, k, n, ldb, kBN, true))
    return cudaErrorInvalidValue;
  const int grid = static_cast<int>(tiles < resident ? tiles : resident);
  gemm_bf16_kernel<kEpi><<<grid, kThreads, smem, stream>>>(ma, mb, m, n, k, ep);
  return cudaGetLastError();
}

}  // namespace
