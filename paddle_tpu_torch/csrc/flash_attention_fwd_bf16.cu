// Flash-attention forward for Hopper (sm_90a) on bf16 q, k and v, on the
// bf16 tensor cores (wgmma).  The float32 kernel is csrc/flash_attention_fwd.cu.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/flash_attention.py::
// _attn_fwd_kernel (launched by _flash_fwd_pallas) on bf16 inputs, with the
// same function: scores (q * sm_scale) . k^T in float32, a causal mask and a
// per-(batch*head) key-length mask, an online softmax in float32 over key
// tiles, out = acc / l rounded once to bf16 (to nearest even), lse = m +
// log(l) in float32, stored [B*H, T], and exact zeros for a row with no
// valid key.  As the float32 kernel does: no divisibility gate, key tiles
// past the causal diagonal, the key length or T are never loaded, and a
// padded row (key length 0) does no work.
//
// Bound (chip_smoke.py prints it per shape): at the training path's shape
// (B*H 512, T 256, d 64) the bytes, q, k, v and out in bf16 at 3.35 TB/s;
// the products below take less at 989 TFLOP/s bf16.
//
// Float32's accuracy from bf16 products:
//  * S = q . k^T.  A product of two bf16 values is exact in float32, and
//    wgmma sums one key tile's d products from zero (a chain of at most 128).
//    The scale multiplies S in float32 (exact where sm_scale is a power of
//    two, as 64**-0.5 is); the Pallas kernel scales q in float32 first.
//    Both are float32 roundings of one value.
//  * p . v.  The Pallas kernel multiplies P in float32 by V.  Here P is split
//    in registers into two bf16 terms, P_hi = bf16(P) and P_lo = bf16(P -
//    P_hi), rounded to nearest even (P - P_hi is exact), and each term's
//    product with V is exact in float32.  P_hi is within half a bf16 ulp of
//    P (under 2**-8 |P|), so the rest is below half of P's ulp,
//    and P_lo, its rounding to 8 bits, leaves under 2**-17 |P| (2**-134
//    absolute where P_lo is a bf16 subnormal).  So out is within 2**-17
//    max|v| of its float32 value; one term (P rounded once, the tests'
//    control) is up to 2**-8 off.
//  * No tensor-core chain runs longer than one tile: each key tile's p . v
//    is summed from zero (the P_lo terms first) into a partial, which the
//    CUDA cores add to the output accumulator after rescaling it by the
//    softmax's alpha, the rule that holds float32's error in
//    csrc/gemm_3xtf32.cuh.
//
// Design: one block per (batch*head, 64 query rows), one warpgroup, and
// three blocks an SM (two at d 128), so that one block's loads and output
// run under the others' products.  Its first thread brings the q tile once,
// then the K and V tiles of 64 keys, through TMA into a ring of kStages
// stages with an mbarrier each, and refills a stage as soon as the
// warpgroup's products that read it have completed.  The TMA maps are 3D
// ([B*H, T, d]), so rows past T arrive as zeros; shared-memory rows are d
// bf16 (32, 64 or 128 bytes) in the swizzle of that width, d 128 as two
// halves of 64 columns.  Per key tile the warpgroup runs: S on
// wgmma.m64n64k16 (q and k
// K-major, as stored); the masks and the online softmax in float32 in
// registers (ex2.approx of the log2(e)-scaled scores); the split; p . v on
// wgmma.m64n{d}k16 with A from registers (the accumulator fragment of S,
// packed to bf16 pairs, is the A fragment of the next wgmma, so P never
// touches shared memory) and V [keys, d] read as stored, MN-major, through
// wgmma's transpose bit; the output accumulator's rescale runs while p . v
// is in flight.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;        // the Pallas kernel's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBQ = 64;                  // query rows a block: one warpgroup
constexpr int kBK = 64;                  // keys a tile
constexpr int kThreads = 128;

// Shared memory of a block for head dim D, byte offsets from a 1024-aligned
// base: the q tile, kStages K tiles, kStages V tiles, the barriers.  A row
// is D bf16 in the swizzle of its width; at D 128 a tile is two chunks of
// 64 columns, one after the other.  kBlocks blocks share an SM (3 x 128
// threads x 168 registers; at D 128, whose accumulators take more, 2).
template <int D>
struct Cfg {
  static constexpr int kStages = D >= 128 ? 2 : 3;
  static constexpr int kBlocks = D >= 128 ? 2 : 3;
  static constexpr int kSwz = D >= 64 ? 128 : 2 * D;   // bytes a chunk row = swizzle span
  static constexpr int kCols = kSwz / 2;               // columns a chunk
  static constexpr int kChunks = D / kCols;
  static constexpr int kSteps = kCols / 16;            // k16 steps of S a chunk
  static constexpr uint64_t kLayout = kSwz == 128 ? 1 : kSwz == 64 ? 2 : 3;   // wgmma's code
  static constexpr int kQChunk = kBQ * kSwz;
  static constexpr int kKVChunk = kBK * kSwz;
  static constexpr int kTile = kChunks * kKVChunk;     // a K or a V tile
  static constexpr int kOffK = kChunks * kQChunk;
  static constexpr int kOffV = kOffK + kStages * kTile;
  static constexpr int kOffBar = kOffV + kStages * kTile;
  static constexpr int kSmem = kOffBar + (1 + kStages) * 8 + 1024;
  static_assert(kKVChunk % 1024 == 0, "every chunk starts on a swizzle atom");
};

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

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
        "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor of a chunk in D's swizzle: 8-row groups
// 8 rows apart (SBO).  A K-major operand's rows are its M or N rows (LBO
// unused); an MN-major one's are its k rows, and LBO is the distance to
// the next chunk of its M or N columns
template <int D>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo = 16) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>((8 * Cfg<D>::kSwz) >> 4) << 32) | (Cfg<D>::kLayout << 62);
}

// d = (keep_d ? d : 0) + a * b, m64n64k16 bf16 with float32 sums, a and b
// K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int keep_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(keep_d));
}

// d = (keep_d ? d : 0) + a * b, m64n{2 * size of d}k16 bf16 with float32
// sums: a, the m64k16 fragment of 4 registers (bf16 pairs), b MN-major in
// shared memory (wgmma's transpose bit)
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t* a, uint64_t db,
                                         int keep_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(keep_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t* a, uint64_t db,
                                         int keep_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(keep_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a, uint64_t db,
                                         int keep_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(keep_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a, uint64_t db,
                                         int keep_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(keep_d));
}

// keep the compiler from moving accumulator reads, or from reusing the A
// fragments' registers, across the asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_frag(uint32_t (&a)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// 2**x on the special-function unit (relative error ~2**-22; an underflow
// to a float32 subnormal gives 0, a weight below 2**-126 that adds nothing)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(kThreads, Cfg<D>::kBlocks)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tma_q,
                      const __grid_constant__ CUtensorMap tma_k,
                      const __grid_constant__ CUtensorMap tma_v, const int* __restrict__ kv_lens,
                      __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int tq, int tk,
                      int causal, float sm_scale) {
  using C = Cfg<D>;
  constexpr int kStages = C::kStages;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;     // swizzle atoms: 1024-aligned
  uint64_t* const qfull = reinterpret_cast<uint64_t*>(smem_raw + (base - raw) + C::kOffBar);
  uint64_t* const full = qfull + 1;       // a stage's K and V tiles have arrived

  const int bh = blockIdx.y, q0 = blockIdx.x * kBQ;
  // keys at or past klen are masked for every row (past T or the key
  // length); none at or past kend is loaded (causal: past the block's last row)
  int klen = tk;
  if (kv_lens != nullptr) klen = min(klen, max(kv_lens[bh], 0));
  const int kend = causal ? min(klen, min(q0 + kBQ, tq)) : klen;
  const int ntiles = (kend + kBK - 1) / kBK;

  // tile t's K and V into stage t % kStages
  auto load_kv = [&](int t) {
    const int s = t % kStages;
    mbar_expect_tx(&full[s], 2 * C::kTile);
    for (int c = 0; c < C::kChunks; ++c) {
      const uint32_t off = s * C::kTile + c * C::kKVChunk;
      tma_load_3d(base + C::kOffK + off, &tma_k, c * C::kCols, t * kBK, bh, &full[s]);
      tma_load_3d(base + C::kOffV + off, &tma_v, c * C::kCols, t * kBK, bh, &full[s]);
    }
  };
  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (ntiles > 0) {
      mbar_expect_tx(qfull, C::kChunks * C::kQChunk);
      for (int c = 0; c < C::kChunks; ++c)
        tma_load_3d(base + c * C::kQChunk, &tma_q, c * C::kCols, q0, bh, qfull);
      for (int t = 0; t < min(ntiles, kStages); ++t) load_kv(t);
    }
  }
  __syncthreads();

  // this thread holds accumulator rows `row` and row + 8 (h = 0, 1), and of
  // each 8 columns j the two 2 tq4 and 2 tq4 + 1: element 4 j + 2 h + e
  const int lane = threadIdx.x % 32, tq4 = lane & 3;
  const int row = q0 + 16 * (threadIdx.x / 32) + (lane >> 2);

  float o[D / 2], sc[32], pv[D / 2];
  float m[2] = {kNegInf, kNegInf}, ml[2] = {0.f, 0.f}, lpart[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = pv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  uint32_t ph[16], pl[16];   // P_hi and P_lo: the A fragments of 4 k16 steps

  if (ntiles > 0) mbar_wait(qfull, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % kStages, k0 = t * kBK;
    mbar_wait(&full[s], (t / kStages) & 1);
    const uint32_t kt = base + C::kOffK + s * C::kTile, vt = base + C::kOffV + s * C::kTile;

    // S = q . k^T over d, summed from zero
    fence_acc(sc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const int c = ks / C::kSteps, off = (ks % C::kSteps) * 32;
      wgmma_ss(sc, smem_desc<D>(base + c * C::kQChunk + off),
               smem_desc<D>(kt + c * C::kKVChunk + off), ks > 0);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(sc);

    // the scale, the masks and the online softmax, row by row; each exp is
    // exp2 of the score times log2(e) less the running max's (ml).  A tile
    // below the key length and the warpgroup's causal diagonal needs no mask
    const bool masked = k0 + kBK > klen || (causal && k0 + kBK - 1 > q0);
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qpos = row + 8 * h;
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = k0 + 8 * j + 2 * tq4 + e;
          float& x = sc[4 * j + 2 * h + e];
          x = !masked || (kp < klen && (!causal || kp <= qpos)) ? x * sm_scale : kNegInf;
          mt = fmaxf(mt, x);
        }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m[h], mt);
      // rows masked so far keep p = 0 (not exp(-inf - -inf) = 1)
      const bool live = m_new > kNegInf / 2;
      const float ml_new = m_new * kLog2e;
      alpha[h] = exp2_ftz(m[h] > kNegInf / 2 ? ml[h] - ml_new : 0.f);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * j + 2 * h + e];
          x = exp2_ftz(live ? fmaf(x, kLog2e, -ml_new) : -INFINITY);   // no branch
          psum += x;
        }
      lpart[h] = lpart[h] * alpha[h] + psum;
      m[h] = m_new;
      ml[h] = ml_new;
    }

    // the split: S's fragment, in consecutive pairs, is the A fragments' layout
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const __nv_bfloat162 hi = __floats2bfloat162_rn(sc[2 * i], sc[2 * i + 1]);
      const float2 hf = __bfloat1622float2(hi);
      ph[i] = bf16x2_bits(hi);
      pl[i] = bf16x2_bits(__floats2bfloat162_rn(sc[2 * i] - hf.x, sc[2 * i + 1] - hf.y));
    }

    // the tile's p . v from zero, the small terms first; the output
    // accumulator is rescaled meanwhile
    fence_acc(pv);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_rs(pv, pl + 4 * kk, smem_desc<D>(vt + kk * 16 * C::kSwz, C::kKVChunk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_rs(pv, ph + 4 * kk, smem_desc<D>(vt + kk * 16 * C::kSwz, C::kKVChunk), 1);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(pv);
    fence_frag(ph);
    fence_frag(pl);
    // the products that read stage s have completed: refill it
    if (threadIdx.x == 0 && t + kStages < ntiles) load_kv(t + kStages);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] += pv[i];
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = lpart[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int qpos = row + 8 * h;
    if (qpos >= tq) continue;
    const float l_safe = fmaxf(l, 1e-20f);
    const bool any = m[h] > kNegInf / 2;   // a row with no valid key emits zeros
    __nv_bfloat16* ob = out + (static_cast<int64_t>(bh) * tq + qpos) * D + 2 * tq4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(ob + 8 * j) = __floats2bfloat162_rn(
          any ? o[4 * j + 2 * h] / l_safe : 0.f, any ? o[4 * j + 2 * h + 1] / l_safe : 0.f);
    if (tq4 == 0) lse[static_cast<int64_t>(bh) * tq + qpos] = m[h] + logf(l_safe);
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

// a [bh, t, D] bf16 tensor read in boxes of `rows` rows of one chunk's
// columns (rows past t read as zeros)
template <int D>
bool make_map(CUtensorMap* map, const void* ptr, int t, int bh, int rows) {
  using C = Cfg<D>;
  const EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(t),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {2ull * D, 2ull * D * t};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(C::kCols), static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = C::kSwz == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : C::kSwz == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                     : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* kv_lens, void* out,
                   float* lse, int bh, int tq, int tk, int causal, float sm_scale,
                   cudaStream_t stream) {
  using C = Cfg<D>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  // with no keys nothing is loaded: the maps only need a valid shape
  alignas(64) CUtensorMap mq, mk, mv;
  const int tk_map = tk > 0 ? tk : 1;
  if (!make_map<D>(&mq, q, tq, bh, kBQ) || !make_map<D>(&mk, k, tk_map, bh, kBK) ||
      !make_map<D>(&mv, v, tk_map, bh, kBK))
    return cudaErrorInvalidValue;
  const dim3 grid((tq + kBQ - 1) / kBQ, bh);
  flash_fwd_bf16_kernel<D><<<grid, kThreads, C::kSmem, stream>>>(
      mq, mk, mv, kv_lens, static_cast<__nv_bfloat16*>(out), lse, tq, tk, causal, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// q: [bh, tq, d], k/v: [bh, tk, d] bf16 contiguous, 16-byte aligned;
// kv_lens: [bh] int32 or null; out: [bh, tq, d] bf16; lse: [bh, tq] float32;
// d in 16, 32, 64, 128.  Launches on ``stream`` and returns
// cudaGetLastError().
extern "C" int ptt_flash_attn_fwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                       const __nv_bfloat16* v, const int* kv_lens,
                                       __nv_bfloat16* out, float* lse, int bh, int tq, int tk,
                                       int d, int causal, float sm_scale, void* stream) {
  if (bh <= 0 || tq <= 0) return static_cast<int>(cudaSuccess);
  if (bh > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (d) {
    case 16: e = launch<16>(q, k, v, kv_lens, out, lse, bh, tq, tk, causal, sm_scale, s); break;
    case 32: e = launch<32>(q, k, v, kv_lens, out, lse, bh, tq, tk, causal, sm_scale, s); break;
    case 64: e = launch<64>(q, k, v, kv_lens, out, lse, bh, tq, tk, causal, sm_scale, s); break;
    case 128:
      e = launch<128>(q, k, v, kv_lens, out, lse, bh, tq, tk, causal, sm_scale, s);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}
