// int8 GEMM for Hopper (sm_90a): acc[m, n] = sum_k a[m, k] * bt[n, k],
// int8 operands, exact int32 accumulation.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/int8_matmul.py::_mm_kernel
// (launched by _mm_pallas from int8_matmul).  Same function: the abs-max
// quantisation of both operands and the dequant scale stay outside the
// kernel, in the wrapper (ops/cuda/int8_matmul.py), as they stay in XLA
// there.  The wrapper hands the quantised weight over transposed, [N, K],
// which is the layout mma's ".col" B operand wants.
//
// What changed from the TPU design:
//  * Loop order.  The Pallas grid walks K blocks sequentially and carries
//    the int32 accumulator in VMEM scratch.  Here one thread block owns a
//    128 x 128 output tile, loops over K in steps of 64 bytes, and keeps
//    the accumulator in registers; the output is written once.
//  * Products.  mma.sync.aligned.m16n8k32 s8 x s8 -> s32 on the int8
//    tensor cores: 8 warps in a 2 x 4 grid, each warp a 64 x 32 sub-tile
//    (4 x 4 mma tiles, 64 int32 accumulators a thread).  A and B tiles are
//    staged in shared memory (two buffers, the next tile prefetched into
//    registers while the current one is multiplied) with rows of 80 bytes,
//    so the fragment reads of a warp hit 32 different banks.
//  * Shapes.  No alignment gate and no fallback: the kernel masks the
//    ragged M, N and K edges itself.  When K is a multiple of 16 and both
//    operands are 16-byte aligned it loads 16 bytes a thread; otherwise it
//    loads byte by byte (only ragged shapes take that path).
//
// Bound at the serving path's shapes (M = 2048; (K, N) = (512, 512),
// (512, 2048), (2048, 512), (512, 32000)): the int32 output's bytes for
// the small products and operations for the large ones, against 1,979
// TOP/s dense int8 and 3.35 TB/s.  This first version uses mma.sync, not
// wgmma and TMA, and reaches a fraction of the int8 peak: it is right and
// simple first.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 64;  // block tile; K step in bytes
constexpr int kThreads = 256;                  // 8 warps
constexpr int kLd = kBK + 16;                  // shared row stride (bytes)
constexpr int kWM = 64, kWN = 32;              // warp tile
constexpr int kMT = kWM / 16, kNT = kWN / 8;   // mma tiles per warp
constexpr int kChunks = kBM * kBK / 16;        // 16-byte chunks per tile
constexpr int kPerThread = kChunks / kThreads; // = 2
static_assert(kBM == kBN && kChunks % kThreads == 0, "A and B tiles share the load map");

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One 16-byte chunk of a [rows, k] row-major int8 matrix: row ``r``,
// columns [c, c + 16); out-of-range bytes are zero.
template <bool VEC>
__device__ __forceinline__ int4 load_chunk(const int8_t* __restrict__ src, int rows, int k,
                                           int r, int c) {
  int4 v = make_int4(0, 0, 0, 0);
  if (r >= rows || c >= k) return v;
  const int8_t* p = src + static_cast<int64_t>(r) * k + c;
  if (VEC) {
    v = *reinterpret_cast<const int4*>(p);          // k % 16 == 0: whole chunk in range
  } else {
    int8_t* b = reinterpret_cast<int8_t*>(&v);
    const int n = k - c < 16 ? k - c : 16;
    for (int i = 0; i < n; ++i) b[i] = p[i];
  }
  return v;
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
int8_gemm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ bt,
                 int32_t* __restrict__ c, int m, int n, int k) {
  __shared__ __align__(16) int8_t sa[2][kBM * kLd];
  __shared__ __align__(16) int8_t sb[2][kBN * kLd];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;            // mma group and thread in group
  const int wm = (warp / 4) * kWM, wn = (warp % 4) * kWN;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  int acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  int4 ra[kPerThread], rb[kPerThread];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int ch = tid + i * kThreads, row = ch / (kBK / 16), col = (ch % (kBK / 16)) * 16;
      ra[i] = load_chunk<VEC>(a, m, k, m0 + row, k0 + col);
      rb[i] = load_chunk<VEC>(bt, n, k, n0 + row, k0 + col);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int ch = tid + i * kThreads, row = ch / (kBK / 16), col = (ch % (kBK / 16)) * 16;
      *reinterpret_cast<int4*>(&sa[buf][row * kLd + col]) = ra[i];
      *reinterpret_cast<int4*>(&sb[buf][row * kLd + col]) = rb[i];
    }
  };

  const int nk = (k + kBK - 1) / kBK;
  if (nk > 0) {
    load(0);
    store(0);
  }
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) load((kt + 1) * kBK);          // in flight during the products
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t fa[kMT][4], fb[kNT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const int8_t* base = &sa[buf][(wm + i * 16 + g) * kLd + kk + t * 4];
        fa[i][0] = *reinterpret_cast<const uint32_t*>(base);
        fa[i][1] = *reinterpret_cast<const uint32_t*>(base + 8 * kLd);
        fa[i][2] = *reinterpret_cast<const uint32_t*>(base + 16);
        fa[i][3] = *reinterpret_cast<const uint32_t*>(base + 8 * kLd + 16);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int8_t* base = &sb[buf][(wn + j * 8 + g) * kLd + kk + t * 4];
        fb[j][0] = *reinterpret_cast<const uint32_t*>(base);
        fb[j][1] = *reinterpret_cast<const uint32_t*>(base + 16);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_s8(acc[i][j], fa[i], fb[j]);
    }
    if (kt + 1 < nk) store(buf ^ 1);
    __syncthreads();
  }

  // accumulator fragment: c0, c1 at (row g, cols 2t, 2t+1); c2, c3 at row g+8
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int col = n0 + wn + j * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + i * 16 + g + 8 * h;
        if (row >= m) continue;
        int32_t* dst = c + static_cast<int64_t>(row) * n + col;
        if (col < n) dst[0] = acc[i][j][2 * h];
        if (col + 1 < n) dst[1] = acc[i][j][2 * h + 1];
      }
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// a: [m, k] int8, bt: [n, k] int8 (the right operand transposed), c: [m, n]
// int32, all row-major on the device.  Launches on ``stream`` and returns
// cudaGetLastError().
extern "C" int ptt_int8_gemm(const int8_t* a, const int8_t* bt, int32_t* c, int m, int n,
                             int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  if (k % 16 == 0 && aligned16(a) && aligned16(bt)) {
    int8_gemm_kernel<true><<<grid, kThreads, 0, s>>>(a, bt, c, m, n, k);
  } else {
    int8_gemm_kernel<false><<<grid, kThreads, 0, s>>>(a, bt, c, m, n, k);
  }
  return static_cast<int>(cudaGetLastError());
}
