// Fused final projection + softmax cross-entropy for Hopper (sm_90a),
// float32: the forward (lse and label logit of x @ W + b without the
// logits in device memory) and the backward (dx, dW, db).
//
// Replaces the TPU kernels paddle_tpu/ops/pallas/linear_ce.py::_fwd_kernel
// (launched by linear_ce_fwd) and ::_bwd_kernel (launched by linear_ce_bwd).
//
// Bound: operations.  At the training path's shapes (B = 16384 rows,
// D = 512, V = 32000) the forward is one [B, D] x [D, V] product, 0.54
// TFLOP; the backward is three (the logits recomputed, dx and dW), 1.61
// TFLOP.  The bytes (x, W, the outputs) are ~0.2 GB.  This first version
// does the products on the float32 CUDA cores (67 TFLOP/s on an H100 SXM):
// TF32 or bf16 tensor cores come with the AMP work.
//
// All products share one tile routine, gemm_tile: a 128 x 128 output tile
// per 256-thread block, k-steps of 8 staged through double-buffered shared
// memory with the next step's global loads in flight in registers, and an
// 8 x 8 register micro-tile per thread (rows ty*4..+3 and 64+ty*4..+3,
// columns tx*4..+3 and 64+tx*4..+3, so each k reads four conflict-free
// float4s of shared memory for 64 FMAs).
//
// Forward.  The Pallas grid walks vocab tiles in order and carries the
// running (max, sum-exp, label logit) of each row in VMEM scratch.  Here a
// block owns 128 rows and a contiguous range of vocab tiles (8 by default,
// over blockIdx.y, so the grid has thousands of blocks and two fit on an
// SM); each thread keeps its own online (max, sum-exp) for its 8 rows over
// its own columns, in registers, for the whole range -- no cross-thread
// reduction per tile.  At the end the 16 threads that share a row merge by
// warp shuffles, and a second small kernel merges the ranges' partials in
// range order (deterministic).  lse and the label logit are stored as [B], not
// lane-replicated to 128.  A label outside [0, V) gives label logit 0, as
// the Pallas one-hot pick does.
//
// Backward.  The Pallas backward writes V/bv dx partials and reduces them
// outside, because a TPU grid cannot revisit an output block.  Here the
// vocabulary is walked in chunks of VC columns, and for each chunk three
// kernels run, each output element written by one block (deterministic):
//   1. dl[:, chunk] = (exp(x @ W[:, chunk] + b - lse) - onehot) * g, the
//      logits recomputed from the saved lse, written to a [B, VC] scratch;
//   2. dx (+)= dl @ W[:, chunk]^T, accumulated over the chunks in place;
//   3. dW[:, chunk] = x^T @ dl, and db[chunk] = column sums of dl, summed
//      in row order by the blocks of the first row tile.
// The scratch is the price of three products instead of four: two kernels
// that each recompute the logits (one owning rows for dx, one owning vocab
// tiles for dW) would do four.  With VC = 4096 it is 256 MB at B = 16384,
// 1/8 of the [B, V] logits.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;          // output tile rows
constexpr int BN = 128;          // output tile columns
constexpr int BK = 8;            // k-step
constexpr int kThreads = 256;
constexpr int kPad = 4;          // shared-memory row padding, floats
constexpr float kNegInf = -1e30f;

struct __align__(16) Smem {
  float a[2][BK][BM + kPad];
  float b[2][BK][BN + kPad];
};

// Row (0..127) of the tile that accumulator row i (0..7) of this thread
// holds, and likewise the column of accumulator column j.
__device__ __forceinline__ int tile_row(int i) {
  return (i < 4 ? 0 : 64) + (threadIdx.x / 16) * 4 + (i & 3);
}
__device__ __forceinline__ int tile_col(int j) {
  return (j < 4 ? 0 : 64) + (threadIdx.x % 16) * 4 + (j & 3);
}

// One float4 of an operand tile for the k-step at k0.  The tile has 128
// "rows" i (M for A, N for B) and BK k's.  KCONTIG: element (i, k) lies at
// p[i * ld + k] (k contiguous, kmax % 4 == 0); otherwise at p[k * ld + i]
// (i contiguous, imax % 4 == 0).  Out-of-range elements load as 0.
template <bool KCONTIG>
__device__ __forceinline__ float4 load_tile4(const float* __restrict__ p, int64_t ld,
                                             int i0, int imax, int k0, int kmax) {
  const int t = threadIdx.x;
  float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
  if (KCONTIG) {
    const int i = i0 + t / 2, k = k0 + (t % 2) * 4;
    if (i < imax && k < kmax) r = *reinterpret_cast<const float4*>(p + i * ld + k);
  } else {
    const int k = k0 + t / 32, i = i0 + (t % 32) * 4;
    if (k < kmax && i < imax) r = *reinterpret_cast<const float4*>(p + k * ld + i);
  }
  return r;
}

template <bool KCONTIG>
__device__ __forceinline__ void store_tile4(float (*s)[BM + kPad], float4 r) {
  const int t = threadIdx.x;
  if (KCONTIG) {
    const int i = t / 2, k = (t % 2) * 4;
    s[k][i] = r.x;
    s[k + 1][i] = r.y;
    s[k + 2][i] = r.z;
    s[k + 3][i] = r.w;
  } else {
    const int k = t / 32, i = (t % 32) * 4;
    *reinterpret_cast<float4*>(&s[k][i]) = r;
  }
}

// acc = A[m0:m0+128, :K] @ B[:K, n0:n0+128] (zero outside M, N, K).
// A_K / B_K say which operands are k-contiguous (see load_tile4).  With
// COLSUM, threads 0..127 also return in *colsum the sum over k of B's
// column threadIdx.x, in k order.
template <bool A_K, bool B_K, bool COLSUM>
__device__ __forceinline__ void gemm_tile(float (&acc)[8][8], Smem& sm,
                                          const float* __restrict__ A, int64_t lda, int m0, int M,
                                          const float* __restrict__ B, int64_t ldb, int n0, int N,
                                          int K, float* colsum) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int nk = (K + BK - 1) / BK;
  float4 ra = load_tile4<A_K>(A, lda, m0, M, 0, K);
  float4 rb = load_tile4<B_K>(B, ldb, n0, N, 0, K);
  __syncthreads();  // the block's previous use of sm is over
  store_tile4<A_K>(sm.a[0], ra);
  store_tile4<B_K>(sm.b[0], rb);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {
      ra = load_tile4<A_K>(A, lda, m0, M, (kt + 1) * BK, K);
      rb = load_tile4<B_K>(B, ldb, n0, N, (kt + 1) * BK, K);
    }
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sm.a[cur][k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&sm.a[cur][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sm.b[cur][k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&sm.b[cur][k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (COLSUM && threadIdx.x < BN) {
#pragma unroll
      for (int k = 0; k < BK; ++k) *colsum += sm.b[cur][k][threadIdx.x];
    }
    if (kt + 1 < nk) {
      store_tile4<A_K>(sm.a[cur ^ 1], ra);
      store_tile4<B_K>(sm.b[cur ^ 1], rb);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------- forward

__global__ void __launch_bounds__(kThreads, 2)
ce_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ bias, const int* __restrict__ labels,
              float* __restrict__ part_m, float* __restrict__ part_s,
              float* __restrict__ part_lab, int rows, int d, int v, int tiles_per_split) {
  __shared__ Smem sm;
  const int m0 = blockIdx.x * BM;
  const int nt0 = blockIdx.y * tiles_per_split;
  const int nt1 = min(nt0 + tiles_per_split, (v + BN - 1) / BN);
  float m[8], s[8], lab[8];
  int lbl[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + tile_row(i);
    lbl[i] = row < rows ? labels[row] : -1;
    m[i] = kNegInf;
    s[i] = 0.f;
    lab[i] = 0.f;
  }
  for (int nt = nt0; nt < nt1; ++nt) {
    const int n0 = nt * BN;
    float acc[8][8];
    gemm_tile<true, false, false>(acc, sm, x, d, m0, rows, w, v, n0, v, d, nullptr);
    int col[8];
    float bj[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      col[j] = n0 + tile_col(j);
      bj[j] = (bias != nullptr && col[j] < v) ? bias[col[j]] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[i][j] += bj[j];
        if (col[j] < v) {
          mx = fmaxf(mx, acc[i][j]);
          if (col[j] == lbl[i]) lab[i] = acc[i][j];
        }
      }
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (col[j] < v) sum += expf(acc[i][j] - mx);
      s[i] = s[i] * expf(m[i] - mx) + sum;
      m[i] = mx;
    }
  }
  // merge the 16 threads (lanes differing in their low 4 bits) of a row
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int off = 8; off >= 1; off >>= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float so = __shfl_xor_sync(0xffffffffu, s[i], off);
      const float lo = __shfl_xor_sync(0xffffffffu, lab[i], off);
      const float mn = fmaxf(m[i], mo);
      s[i] = s[i] * expf(m[i] - mn) + so * expf(mo - mn);
      m[i] = mn;
      lab[i] += lo;
    }
  }
  if (threadIdx.x % 16 == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = m0 + tile_row(i);
      if (row < rows) {
        const int64_t idx = static_cast<int64_t>(blockIdx.y) * rows + row;
        part_m[idx] = m[i];
        part_s[idx] = s[i];
        part_lab[idx] = lab[i];
      }
    }
  }
}

__global__ void ce_fwd_combine_kernel(const float* __restrict__ part_m,
                                      const float* __restrict__ part_s,
                                      const float* __restrict__ part_lab,
                                      float* __restrict__ lse, float* __restrict__ lab,
                                      int rows, int splits) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  float mx = kNegInf;
  for (int sp = 0; sp < splits; ++sp) mx = fmaxf(mx, part_m[static_cast<int64_t>(sp) * rows + row]);
  float sum = 0.f, l = 0.f;
  for (int sp = 0; sp < splits; ++sp) {
    const int64_t idx = static_cast<int64_t>(sp) * rows + row;
    sum += part_s[idx] * expf(part_m[idx] - mx);
    l += part_lab[idx];
  }
  lse[row] = mx + logf(sum);
  lab[row] = l;
}

// --------------------------------------------------------------- backward

// dl[r, c] = (exp(x[r] . W[:, v0 + c] + b[v0 + c] - lse[r]) - onehot) * g[r]
// for the chunk's columns c < vc; dl has row stride ldl.
__global__ void __launch_bounds__(kThreads)
ce_dl_kernel(const float* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ bias, const int* __restrict__ labels,
             const float* __restrict__ lse, const float* __restrict__ g,
             float* __restrict__ dl, int rows, int d, int v, int v0, int vc, int ldl) {
  __shared__ Smem sm;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  float acc[8][8];
  gemm_tile<true, false, false>(acc, sm, x, d, m0, rows, w + v0, v, n0, vc, d, nullptr);
  float bj[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = n0 + tile_col(j);
    bj[j] = (bias != nullptr && c < vc) ? bias[v0 + c] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + tile_row(i);
    if (row >= rows) continue;
    const float l = lse[row], gr = g[row];
    const int lb = labels[row] - v0;
    float o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + tile_col(j);
      const float p = expf(acc[i][j] + bj[j] - l);
      o[j] = (p - (c == lb ? 1.f : 0.f)) * gr;
    }
    float* dst = dl + static_cast<int64_t>(row) * ldl + n0;
    // vc % 4 == 0: a group of 4 columns is all inside or all outside
    if (n0 + tile_col(0) < vc)
      *reinterpret_cast<float4*>(dst + tile_col(0)) = make_float4(o[0], o[1], o[2], o[3]);
    if (n0 + tile_col(4) < vc)
      *reinterpret_cast<float4*>(dst + tile_col(4)) = make_float4(o[4], o[5], o[6], o[7]);
  }
}

// dx[r, :] (+)= dl[r, :vc] @ W[:, v0:v0+vc]^T
__global__ void __launch_bounds__(kThreads)
ce_dx_kernel(const float* __restrict__ dl, const float* __restrict__ w,
             float* __restrict__ dx, int rows, int d, int v, int v0, int vc, int ldl,
             int accumulate) {
  __shared__ Smem sm;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  float acc[8][8];
  gemm_tile<true, true, false>(acc, sm, dl, ldl, m0, rows, w + v0, v, n0, d, vc, nullptr);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + tile_row(i);
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + tile_col(j);
      if (c < d) {
        float* p = dx + static_cast<int64_t>(row) * d + c;
        *p = accumulate ? *p + acc[i][j] : acc[i][j];
      }
    }
  }
}

// dW[:, v0:v0+vc] = x^T @ dl[:, :vc]; the first row tile's blocks also
// write db[v0:v0+vc] = column sums of dl.
__global__ void __launch_bounds__(kThreads)
ce_dw_kernel(const float* __restrict__ x, const float* __restrict__ dl,
             float* __restrict__ dw, float* __restrict__ db, int rows, int d, int v,
             int v0, int vc, int ldl) {
  __shared__ Smem sm;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  float acc[8][8];
  float colsum = 0.f;
  if (db != nullptr && blockIdx.x == 0) {
    gemm_tile<false, false, true>(acc, sm, x, d, m0, d, dl, ldl, n0, vc, rows, &colsum);
    const int c = n0 + threadIdx.x;
    if (threadIdx.x < BN && c < vc) db[v0 + c] = colsum;
  } else {
    gemm_tile<false, false, false>(acc, sm, x, d, m0, d, dl, ldl, n0, vc, rows, nullptr);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + tile_row(i);
    if (r >= d) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + tile_col(j);
      if (c < vc) dw[static_cast<int64_t>(r) * v + v0 + c] = acc[i][j];
    }
  }
}

unsigned cdiv(int a, int b) { return static_cast<unsigned>((a + b - 1) / b); }

}  // namespace

// x: [rows, d], w: [d, v], bias: [v] or null, labels: [rows] int32 ->
// lse, lab: [rows].  part_*: [splits, rows] scratch, splits >= 1.
// d % 4 == 0, v % 4 == 0, x and w 16-byte aligned.  Launches on ``stream``
// and returns cudaGetLastError().
extern "C" int ptt_linear_ce_fwd_f32(const float* x, const float* w, const float* bias,
                                     const int* labels, float* lse, float* lab,
                                     float* part_m, float* part_s, float* part_lab,
                                     int rows, int d, int v, int splits, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaSuccess);
  if (d % 4 != 0 || v % 4 != 0 || v <= 0 || splits <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ntiles = static_cast<int>(cdiv(v, BN));
  const int per = static_cast<int>(cdiv(ntiles, splits));
  const int used = static_cast<int>(cdiv(ntiles, per));
  ce_fwd_kernel<<<dim3(cdiv(rows, BM), used), kThreads, 0, s>>>(
      x, w, bias, labels, part_m, part_s, part_lab, rows, d, v, per);
  ce_fwd_combine_kernel<<<cdiv(rows, 256), 256, 0, s>>>(part_m, part_s, part_lab, lse, lab,
                                                        rows, used);
  return static_cast<int>(cudaGetLastError());
}

// As the forward, plus lse, g: [rows] -> dx: [rows, d], dw: [d, v],
// db: [v] (null when bias is null).  dl: [rows, chunk] scratch,
// chunk % 4 == 0.
extern "C" int ptt_linear_ce_bwd_f32(const float* x, const float* w, const float* bias,
                                     const int* labels, const float* lse, const float* g,
                                     float* dx, float* dw, float* db, float* dl,
                                     int rows, int d, int v, int chunk, void* stream) {
  if (d % 4 != 0 || v % 4 != 0 || chunk % 4 != 0 || chunk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0) {  // no rows: every gradient is zero
    cudaMemsetAsync(dw, 0, sizeof(float) * static_cast<size_t>(d) * v, s);
    if (db != nullptr) cudaMemsetAsync(db, 0, sizeof(float) * static_cast<size_t>(v), s);
    return static_cast<int>(cudaGetLastError());
  }
  for (int v0 = 0; v0 < v; v0 += chunk) {
    const int vc = v - v0 < chunk ? v - v0 : chunk;
    ce_dl_kernel<<<dim3(cdiv(rows, BM), cdiv(vc, BN)), kThreads, 0, s>>>(
        x, w, bias, labels, lse, g, dl, rows, d, v, v0, vc, chunk);
    ce_dx_kernel<<<dim3(cdiv(rows, BM), cdiv(d, BN)), kThreads, 0, s>>>(
        dl, w, dx, rows, d, v, v0, vc, chunk, v0 > 0);
    ce_dw_kernel<<<dim3(cdiv(d, BM), cdiv(vc, BN)), kThreads, 0, s>>>(
        x, dl, dw, bias != nullptr ? db : nullptr, rows, d, v, v0, vc, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}
