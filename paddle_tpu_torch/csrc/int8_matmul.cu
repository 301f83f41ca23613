// The int8 matmul path for Hopper (sm_90a): abs-max quantization of both
// operands, an exact int8 x int8 -> int32 GEMM and the dequant, in four
// launches and one memset.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/int8_matmul.py::_mm_kernel
// (launched by _mm_pallas from int8_matmul) together with the quantizers and
// the dequant that XLA fuses around it there (int8_matmul.py:42 and :115).
// The wrapper is paddle_tpu_torch/ops/cuda/int8_matmul.py.
//
//  * ptt_int8_absmax2 -- max|x| and max|y| in one grid-stride reduction: a
//    warp reduction, a block reduction, then atomicMax on the float's bit
//    pattern into a zeroed pair.  |v| >= 0, so the integer order is the
//    float order, and a NaN (sign cleared by fabsf) stays the largest.
//  * ptt_int8_quantize -- q = rint(min(max(v, -s), s) * (bin_cnt / s)),
//    s = max(absmax, 1e-8) read from device memory, the ratio one IEEE
//    division, rint rounding half to even as torch.round and jnp.round.
//    Rows are written as int8 zero-padded to Kp = a multiple of 16 bytes
//    (zeros leave the integer products exact, and every row then meets
//    TMA's 16-byte stride rule).  The weight [K, N] is written transposed,
//    [N, Kp], through a shared-memory tile: the K-major layout that integer
//    wgmma requires for B.
//  * ptt_int8_gemm -- C[m, n] = sum_k A[m, k] * Bt[n, k], A [M, Kp] and Bt
//    [N, Kp] both K-major.  128 x 128 output tiles, K in 128-byte steps.
//    Persistent blocks (one an SM) walk the tiles, M fastest, so the blocks
//    in flight share weight tiles.  One producer warp keeps a ring of four
//    stages filled by TMA (128-byte swizzle, zero fill past the ragged M, N
//    and K edges) guarded by full and empty mbarriers, across tile
//    boundaries: the next tile loads during this tile's epilogue.  Two
//    consumer warpgroups each run wgmma.mma_async.m64n128k32.s32.s8.s8 on 64
//    rows, with the int32 accumulator in registers.  The epilogue writes
//    either the int32 sum or float32 __fmul_rn(__int2float_rn(acc), scale),
//    scale = (s_x * s_y) * r, r = float32(1 / bin_cnt^2): the dequant of the
//    JAX package in XLA's form (division by a constant folded into a product
//    with its reciprocal), so no int32 tensor and no dequant pass remain.
//    The output is what bounds the head: each warp stages its 16 rows in
//    shared memory and writes every row as 512 contiguous bytes (the
//    fragment's own stores would touch 8 rows with 32 bytes each).
//
// What changed from the TPU design: the Pallas grid walks K blocks in order
// and carries the int32 accumulator in VMEM scratch; here a thread block
// owns an output tile, keeps the accumulator in registers and writes once.
// The TPU kernel's alignment gate (and the XLA fallback behind it) is gone:
// TMA's zero fill and masked stores take any shape.
//
// Bound at the serving path's shapes (M = 2048; (K, N) = (512, 512),
// (512, 2048), (2048, 512), (512, 32000)): bytes, and for the vocabulary
// head the 262 MB float32 output (0.078 ms at 3.35 TB/s), against 0.034 ms
// of int8 operations at 1,979 TOP/s.  The quantizers are bound by bytes:
// each operand is read twice (abs-max, quantize) and written once as int8.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-8f;  // fake_quantize_abs_max's scale floor

__device__ __forceinline__ float clamp_scale(float a) {
  // max(a, 1e-8), NaN kept, as torch.clamp_min and jnp.maximum keep it
  return a != a ? a : fmaxf(a, kEps);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- abs-max pair

constexpr int kRedThreads = 256;

__device__ __forceinline__ unsigned abs_bits(float v) { return __float_as_uint(fabsf(v)); }

__device__ unsigned absmax_range(const float* __restrict__ p, int64_t n, int64_t start,
                                 int64_t stride) {
  unsigned best = 0;
  const int64_t n4 = (reinterpret_cast<uintptr_t>(p) & 15) == 0 ? n / 4 : 0;
  const float4* p4 = reinterpret_cast<const float4*>(p);
  for (int64_t i = start; i < n4; i += stride) {
    const float4 v = __ldg(p4 + i);
    best = max(best, max(max(abs_bits(v.x), abs_bits(v.y)), max(abs_bits(v.z), abs_bits(v.w))));
  }
  for (int64_t i = n4 * 4 + start; i < n; i += stride) best = max(best, abs_bits(__ldg(p + i)));
  return best;
}

// blocks [0, bx) reduce x into out[0], the rest y into out[1]
__global__ void __launch_bounds__(kRedThreads)
absmax2_kernel(const float* __restrict__ x, int64_t nx, const float* __restrict__ y,
               int64_t ny, int bx, unsigned* __restrict__ out) {
  __shared__ unsigned warp_best[kRedThreads / 32];
  const bool is_x = static_cast<int>(blockIdx.x) < bx;
  const int blk = is_x ? blockIdx.x : blockIdx.x - bx;
  const int nblk = is_x ? bx : gridDim.x - bx;
  unsigned best = absmax_range(is_x ? x : y, is_x ? nx : ny,
                               static_cast<int64_t>(blk) * kRedThreads + threadIdx.x,
                               static_cast<int64_t>(nblk) * kRedThreads);
  best = __reduce_max_sync(0xffffffffu, best);
  if (threadIdx.x % 32 == 0) warp_best[threadIdx.x / 32] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kRedThreads / 32; ++w) best = max(best, warp_best[w]);
    atomicMax(out + (is_x ? 0 : 1), best);
  }
}

int reduce_blocks(int64_t n) {
  const int64_t per_block = static_cast<int64_t>(kRedThreads) * 16;  // 4 float4 a thread
  const int64_t b = (n + per_block - 1) / per_block;
  return static_cast<int>(b < 1 ? 1 : (b > 1024 ? 1024 : b));
}

// ---------------------------------------------------------------- quantizers

constexpr int kQThreads = 256;

__device__ __forceinline__ uint32_t quant_byte(float v, float s, float ratio) {
  const float q = rintf(__fmul_rn(fminf(fmaxf(v, -s), s), ratio));
  return static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(__float2int_rn(q))));
}

// src [rows, cols] -> q [rows, kp], one 16-byte chunk of a row a thread
__global__ void __launch_bounds__(kQThreads)
quantize_rows_kernel(const float* __restrict__ src, int rows, int cols, int kp,
                     const float* __restrict__ scale, float bin_cnt, int vec,
                     int8_t* __restrict__ q) {
  const float s = clamp_scale(*scale);
  const float ratio = __fdiv_rn(bin_cnt, s);
  const int chunks = kp / 16;
  const int64_t total = static_cast<int64_t>(rows) * chunks;
  for (int64_t c = static_cast<int64_t>(blockIdx.x) * kQThreads + threadIdx.x; c < total;
       c += static_cast<int64_t>(gridDim.x) * kQThreads) {
    const int64_t r = c / chunks;
    const int col0 = static_cast<int>(c - r * chunks) * 16;
    const float* p = src + r * cols + col0;
    float v[16];
    if (vec && col0 + 16 <= cols) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 f = __ldg(reinterpret_cast<const float4*>(p) + i);
        v[4 * i] = f.x; v[4 * i + 1] = f.y; v[4 * i + 2] = f.z; v[4 * i + 3] = f.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) v[i] = col0 + i < cols ? __ldg(p + i) : 0.f;
    }
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      w[j] = quant_byte(v[4 * j], s, ratio) | quant_byte(v[4 * j + 1], s, ratio) << 8 |
             quant_byte(v[4 * j + 2], s, ratio) << 16 | quant_byte(v[4 * j + 3], s, ratio) << 24;
    }
    *reinterpret_cast<uint4*>(q + r * kp + col0) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

constexpr int kT = 64;           // transpose tile: 64 k x 64 n
constexpr int kTLd = kT + 4;     // shared row stride in bytes: conflict-free byte writes

// src [k, n] -> qt [n, kp]: coalesced float reads along n, int8 through a
// shared tile, 16-byte writes along k
__global__ void __launch_bounds__(kQThreads)
quantize_t_kernel(const float* __restrict__ src, int k, int n, int kp,
                  const float* __restrict__ scale, float bin_cnt, int8_t* __restrict__ qt) {
  __shared__ __align__(16) int8_t tile[kT * kTLd];  // [n local][k local]
  const float s = clamp_scale(*scale);
  const float ratio = __fdiv_rn(bin_cnt, s);
  const int k0 = blockIdx.x * kT, n0 = blockIdx.y * kT;
  const int t = threadIdx.x;
  const int nl = t % kT, gn = n0 + nl;
#pragma unroll
  for (int i = 0; i < kT * kT / kQThreads; ++i) {
    const int kl = t / kT + (kQThreads / kT) * i, gk = k0 + kl;
    const float v = (gk < k && gn < n) ? __ldg(src + static_cast<int64_t>(gk) * n + gn) : 0.f;
    tile[nl * kTLd + kl] = static_cast<int8_t>(quant_byte(v, s, ratio));
  }
  __syncthreads();
  const int row = t / 4, ch = t % 4;
  const int on = n0 + row, ok = k0 + ch * 16;
  if (on < n && ok < kp) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(tile + row * kTLd + ch * 16);
    *reinterpret_cast<uint4*>(qt + static_cast<int64_t>(on) * kp + ok) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// --------------------------------------------------------------------- GEMM

constexpr int kBM = 128, kBN = 128, kBK = 128;  // block tile; K step in bytes
constexpr int kStages = 4;                      // a whole K = 512 tile in flight
constexpr int kConsumers = 2;                   // warpgroups of 64 rows
constexpr int kGemmThreads = kConsumers * 128 + 32;  // and one producer warp
constexpr int kTileBytes = kBM * kBK;           // one A or B stage: 16 KB
static_assert(kBM == kBN, "A and B stages share one TMA box");
constexpr int kStageBytes = 2 * kTileBytes;
// each consumer warp stages its 16 output rows of 128 words; rows padded by
// 8 words so the fragment's 8-byte writes of a half-warp hit 32 banks
constexpr int kOutLd = kBN + 8;
constexpr int kOutBytes = kConsumers * 4 * 16 * kOutLd * 4;
constexpr int kGemmSmem = kStages * kStageBytes + kOutBytes + 2 * kStages * 8 + 1024;  // + alignment

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

// wgmma shared-memory descriptor of a K-major tile of 128-byte rows in the
// 128-byte swizzle that TMA wrote: 8-row groups 1024 bytes apart (SBO)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// keep the compiler from moving accumulator reads across the async wgmma
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <bool kF32>
__global__ void __launch_bounds__(kGemmThreads, 1)
int8_gemm_kernel(const __grid_constant__ CUtensorMap tma_a,
                 const __grid_constant__ CUtensorMap tma_b, void* __restrict__ c, int m, int n,
                 int kp, const float* __restrict__ scales, float r) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;     // 128-byte swizzle atoms: 1024-aligned
  const uint32_t sa = base, sb = base + kStages * kTileBytes;
  uint32_t* out_stage = reinterpret_cast<uint32_t*>(smem_raw + (base - raw) + 2 * kStages * kTileBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(reinterpret_cast<uint8_t*>(out_stage) + kOutBytes);
  uint64_t* empty = full + kStages;

  const int warp = threadIdx.x / 32;
  const int nk = (kp + kBK - 1) / kBK;
  // persistent: the block walks output tiles blockIdx.x, + gridDim.x, ...;
  // M tiles are numbered fastest, so the blocks in flight share weight tiles
  const int mt = (m + kBM - 1) / kBM;
  const int tiles = mt * ((n + kBN - 1) / kBN);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers * 4) {
    // producer: one thread keeps the ring filled, across tile boundaries,
    // so the next tile's loads run during this tile's epilogue
    if (threadIdx.x % 32 == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile % mt) * kBM, n0 = (tile / mt) * kBN;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % kStages;
          if (it >= kStages) mbar_wait(&empty[s], ((it / kStages) - 1) & 1);
          mbar_expect_tx(&full[s], kStageBytes);
          tma_load_2d(sa + s * kTileBytes, &tma_a, kt * kBK, m0, &full[s]);
          tma_load_2d(sb + s * kTileBytes, &tma_b, kt * kBK, n0, &full[s]);
        }
      }
    }
    return;
  }

  const int wg = warp / 4;
  const int lane = threadIdx.x % 32;
  const bool quads = (n % 4) == 0;   // 16-byte stores stay aligned
  float scale = 0.f;
  if (kF32) scale = __fmul_rn(__fmul_rn(clamp_scale(scales[0]), clamp_scale(scales[1])), r);
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile % mt) * kBM, n0 = (tile / mt) * kBN;
    int acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % kStages;
      mbar_wait(&full[s], (it / kStages) & 1);
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk) {
        wgmma_m64n128k32_s8(acc, smem_desc(sa + s * kTileBytes + wg * 64 * kBK + kk * 32),
                            smem_desc(sb + s * kTileBytes + kk * 32));
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(acc);
      if (threadIdx.x % 128 == 0) mbar_arrive(&empty[s]);
    }

    // accumulator fragment of m64nNk32: d[4j + 2h + e] at row 16 * (warp % 4)
    // + lane / 4 + 8h of the warpgroup's 64, column 8j + 2 * (lane % 4) + e.
    // A warp owns 16 whole rows: it stages them in shared memory (float32
    // bits, or int32) and writes each row as 512 contiguous bytes, with
    // streaming stores (the output is not read again by this kernel).
    uint32_t* rows16 = out_stage + (wg * 4 + warp % 4) * 16 * kOutLd;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        uint2 w;
        if (kF32) {
          w = make_uint2(__float_as_uint(__fmul_rn(__int2float_rn(v0), scale)),
                         __float_as_uint(__fmul_rn(__int2float_rn(v1), scale)));
        } else {
          w = make_uint2(static_cast<uint32_t>(v0), static_cast<uint32_t>(v1));
        }
        *reinterpret_cast<uint2*>(rows16 + (lane / 4 + 8 * h) * kOutLd + 8 * j + 2 * (lane % 4)) = w;
      }
    }
    __syncwarp();
    const int row_base = m0 + wg * 64 + (warp % 4) * 16;
    const int col = n0 + 4 * lane;
#pragma unroll 4
    for (int rr = 0; rr < 16; ++rr) {
      const int row = row_base + rr;
      if (row >= m) break;
      const uint4 w = *reinterpret_cast<const uint4*>(rows16 + rr * kOutLd + 4 * lane);
      uint32_t* dst = static_cast<uint32_t*>(c) + static_cast<int64_t>(row) * n + col;
      if (quads && col + 3 < n) {
        __stcs(reinterpret_cast<uint4*>(dst), w);
      } else {
        if (col < n) __stcs(dst, w.x);
        if (col + 1 < n) __stcs(dst + 1, w.y);
        if (col + 2 < n) __stcs(dst + 2, w.z);
        if (col + 3 < n) __stcs(dst + 3, w.w);
      }
    }
    __syncwarp();   // the rows are out before the next tile stages its own
  }
}

// cuTensorMapEncodeTiled from the CUDA driver library, found at run time so that the
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

// a [rows, kp] int8 row-major operand, read in kBK x 128-row boxes
bool make_map(CUtensorMap* map, const int8_t* ptr, int rows, int kp) {
  const EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kp), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(kp)};
  const cuuint32_t box[2] = {kBK, kBM};
  const cuuint32_t elem_strides[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(ptr), dims, strides, box,
            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool kF32>
cudaError_t launch_gemm(const CUtensorMap& ma, const CUtensorMap& mb, void* c, int m, int n,
                        int kp, const float* scales, float r, cudaStream_t stream) {
  static int resident = 0;   // blocks the card holds at once
  if (resident == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        int8_gemm_kernel<kF32>, cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmem);
    int dev = 0, sms = 0, per_sm = 0;
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, int8_gemm_kernel<kF32>,
                                                        kGemmThreads, kGemmSmem);
    if (e != cudaSuccess) return e;
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int64_t tiles = static_cast<int64_t>((m + kBM - 1) / kBM) * ((n + kBN - 1) / kBN);
  const int grid = static_cast<int>(tiles < resident ? tiles : resident);
  int8_gemm_kernel<kF32><<<grid, kGemmThreads, kGemmSmem, stream>>>(ma, mb, c, m, n, kp,
                                                                     scales, r);
  return cudaGetLastError();
}

}  // namespace

// out[0] = max|x|, out[1] = max|y| (float32 bit patterns); x, y float32 on
// the device.  Zeroes out, launches on ``stream``, returns cudaGetLastError().
extern "C" int ptt_int8_absmax2(const float* x, int64_t nx, const float* y, int64_t ny,
                                unsigned* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(out, 0, 2 * sizeof(unsigned), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int bx = nx > 0 ? reduce_blocks(nx) : 0, by = ny > 0 ? reduce_blocks(ny) : 0;
  if (bx + by == 0) return static_cast<int>(cudaSuccess);
  absmax2_kernel<<<bx + by, kRedThreads, 0, s>>>(x, nx, y, ny, bx, out);
  return static_cast<int>(cudaGetLastError());
}

// src [rows, cols] float32 -> q int8 [rows, kp] (transpose = 0) or
// [cols, kp] (transpose = 1), kp a multiple of 16 >= the row length,
// zero-padded; the scale is *scale (raw abs-max) on the device.
extern "C" int ptt_int8_quantize(const float* src, int rows, int cols, int kp,
                                 const float* scale, float bin_cnt, int transpose, int8_t* q,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kp % 16 != 0 || (reinterpret_cast<uintptr_t>(q) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (transpose) {
    const dim3 grid((kp + kT - 1) / kT, (cols + kT - 1) / kT);
    if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
    quantize_t_kernel<<<grid, kQThreads, 0, s>>>(src, rows, cols, kp, scale, bin_cnt, q);
  } else {
    const int vec = cols % 4 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
    const int64_t total = static_cast<int64_t>(rows) * (kp / 16);
    const int64_t blocks = (total + kQThreads - 1) / kQThreads;
    quantize_rows_kernel<<<static_cast<int>(blocks < 4096 ? blocks : 4096), kQThreads, 0, s>>>(
        src, rows, cols, kp, scale, bin_cnt, vec, q);
  }
  return static_cast<int>(cudaGetLastError());
}

// a [m, kp] and bt [n, kp] int8 row-major (kp a multiple of 16, 16-byte
// aligned), c [m, n]: int32 when scales is null, else float32 dequantized
// with scales = [max|x|, max|y|] and r = float32(1 / bin_cnt^2).
extern "C" int ptt_int8_gemm(const int8_t* a, const int8_t* bt, void* c, int m, int n, int kp,
                             const float* scales, float r, void* stream) {
  if (kp <= 0 || kp % 16 != 0 || (reinterpret_cast<uintptr_t>(a) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(bt) & 15) != 0 ||
      static_cast<int64_t>((m + kBM - 1) / kBM) * ((n + kBN - 1) / kBN) >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  alignas(64) CUtensorMap ma, mb;
  if (!make_map(&ma, a, m, kp) || !make_map(&mb, bt, n, kp))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = scales != nullptr
                            ? launch_gemm<true>(ma, mb, c, m, n, kp, scales, r, s)
                            : launch_gemm<false>(ma, mb, c, m, n, kp, nullptr, 0.f, s);
  return static_cast<int>(e);
}
