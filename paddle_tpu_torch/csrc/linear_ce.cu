// Fused final projection + softmax cross-entropy for Hopper (sm_90a),
// float32: the forward (lse and label logit of x @ W + b without the
// logits in device memory).  The backward is csrc/linear_ce_bwd.cu.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/linear_ce.py::_fwd_kernel
// (launched by linear_ce_fwd).
//
// Bound: operations.  At the training path's shapes (B = 16384 rows,
// D = 512, V = 32000) the forward is one [B, D] x [D, V] product, 0.54
// TFLOP of float32 work: 8.0 ms on the float32 CUDA cores (67 TFLOP/s) and,
// as three TF32 products (1.61 TFLOP), 3.25 ms on the tensor cores (495
// TFLOP/s).  The bytes (x, W, the outputs) are ~0.1 GB.
//
// The product runs in the backward's 3xTF32 mainloop (csrc/gemm_3xtf32.cuh)
// as C = logits^T: At = W [D, V] (M = V, the vocabulary), Bk = x [B, D]
// (N = B), one launch over the whole vocabulary, neighbouring blocks on
// one vocabulary tile (W is read from device memory once; x, 32 MB, stays
// in L2).  Its kLse epilogue adds the float32 bias after the product, as
// the Pallas kernel does, and reduces each half of a 128-row vocabulary
// tile (the 64 rows of one consumer warpgroup) to a (max, sum of exp) pair
// per batch row: within a warp by shuffles, across the warpgroup's 4 warps
// in warp order through shared memory, behind a named barrier of the
// warpgroup's 128 threads (so the two warpgroups still never wait for each
// other, and one's epilogue runs under the other's products).  The pairs,
// 2 x 500 x B floats at the training shapes (66 MB), are merged by a second
// kernel in a fixed order: 8 contiguous ranges of them, each in vocabulary
// order, then the ranges in order.
// The label logit is written by the one thread whose tile row is the label;
// the merge writes 0 for a label outside [0, V), as the Pallas one-hot pick
// gives.  No float atomics: two calls on the same inputs are bit-equal.
// expf and logf are the accurate ones (one expf a logit).
//
// The Pallas grid walks vocab tiles in order and carries the running (max,
// sum-exp, label logit) of each row in VMEM scratch; a Hopper grid has no
// order, so the running pair becomes per-tile pairs and an ordered merge.
//
// The bf16 instance (the amp-bf16 step's forward): bf16 x and W, the float32
// bias, float32 lse and label logit -- the Pallas kernel's function on bf16
// operands.  The product runs on bf16 wgmma (gemm_bf16_kernel, same header)
// with the same kLse epilogue and merge, W [D, V] read as stored (M-major,
// through wgmma's transpose bit) and x [B, D] K-major.  The tiles are
// walked along the batch first, so the blocks at work at once read the same
// 128 vocabulary rows of W, which L2 serves.
// Bound at the training shapes: operations, 0.54 TFLOP at 989 TFLOP/s bf16,
// 0.54 ms (the bytes, x 16 MB, W 33 MB and the outputs, take 0.015 ms).
// paddle_tpu_torch/tools/k7_split.py times the kernel with its epilogue
// taken out, and with cheapened parts of it.
#include "gemm_3xtf32.cuh"

namespace {

constexpr int kMergeWarps = 8;   // a merge block: 32 rows, 8 ranges of half tiles

// (mx, sum) <- the pair merged with (m, s): sum of exp(x - mx) over both
__device__ __forceinline__ void merge_pair(float& mx, float& sum, float m, float s) {
  if (!(s > 0.f)) return;                        // a half tile past v: nothing
  if (m > mx) {
    sum = sum * expf(mx - m) + s;
    mx = m;
  } else {
    sum += s * expf(m - mx);
  }
}

// lse[b] = log-sum-exp over the half tiles: warp w merges the w-th of 8
// contiguous ranges of them in vocabulary order, then the 8 ranges are
// merged in order (a fixed order, so the result does not depend on the
// run); lab[b] = 0 where the label lies outside [0, v) (else the epilogue
// wrote it)
__global__ void __launch_bounds__(kMergeWarps * 32)
ce_fwd_combine_kernel(const float* __restrict__ part_max, const float* __restrict__ part_sum,
                      const int* __restrict__ labels, float* __restrict__ lse,
                      float* __restrict__ lab, int rows, int tiles, int v) {
  __shared__ float wm[kMergeWarps][32], ws[kMergeWarps][32];
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int row = blockIdx.x * 32 + lane;
  const int per = (tiles + kMergeWarps - 1) / kMergeWarps;
  const int t0 = min(tiles, w * per), t1 = min(tiles, t0 + per);
  float mx = -INFINITY, sum = 0.f;
  if (row < rows) {
#pragma unroll 8
    for (int t = t0; t < t1; ++t) {
      const int64_t i = static_cast<int64_t>(t) * rows + row;
      merge_pair(mx, sum, part_max[i], part_sum[i]);
    }
  }
  wm[w][lane] = mx;
  ws[w][lane] = sum;
  __syncthreads();
  if (w != 0 || row >= rows) return;
  mx = -INFINITY;
  sum = 0.f;
#pragma unroll
  for (int k = 0; k < kMergeWarps; ++k) merge_pair(mx, sum, wm[k][lane], ws[k][lane]);
  lse[row] = mx + logf(sum);
  const int l = labels[row];
  if (l < 0 || l >= v) lab[row] = 0.f;
}

}  // namespace

// x: [rows, d], w: [d, v], bias: [v] or null, labels: [rows] int32 ->
// lse, lab: [rows].  part_max, part_sum: [2 * ceil(v / 128), rows] scratch.
// d, v multiples of 4 and d > 0; x and w 16-byte aligned.  Launches the
// product with its epilogue and the merge on ``stream``; returns the first
// error.
extern "C" int ptt_linear_ce_fwd_f32(const float* x, const float* w, const float* bias,
                                     const int* labels, float* lse, float* lab,
                                     float* part_max, float* part_sum, int rows, int d, int v,
                                     void* stream) {
  if (rows <= 0) return static_cast<int>(cudaSuccess);
  if (d <= 0 || d % 4 != 0 || v <= 0 || v % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Epilogue ep = {};
  ep.bias = bias;
  ep.labels = labels;
  ep.lse_max = part_max;
  ep.lse_sum = part_sum;
  ep.label_logit = lab;
  cudaError_t e = launch_gemm<kLse>(w, v, x, d, v, rows, d, 1, ep, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = 2 * ((v + kBM - 1) / kBM);
  ce_fwd_combine_kernel<<<(rows + 31) / 32, kMergeWarps * 32, 0, s>>>(part_max, part_sum, labels,
                                                                      lse, lab, rows, tiles, v);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 instance: x [rows, d] and w [d, v] (row stride ldw) bf16, bias
// [v] float32 or null, labels [rows] int32 -> lse, lab [rows] float32;
// part_max, part_sum as above.  d and ldw multiples of 8; x and w 16-byte
// aligned.  Launches the product with its epilogue and the merge on
// ``stream``; returns the first error.
extern "C" int ptt_linear_ce_fwd_bf16(const uint16_t* x, const uint16_t* w, const float* bias,
                                      const int* labels, float* lse, float* lab, float* part_max,
                                      float* part_sum, int rows, int d, int v, int ldw,
                                      void* stream) {
  if (rows <= 0) return static_cast<int>(cudaSuccess);
  if (d <= 0 || d % 8 != 0 || v <= 0 || ldw < v || ldw % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Epilogue ep = {};
  ep.bias = bias;
  ep.labels = labels;
  ep.lse_max = part_max;
  ep.lse_sum = part_sum;
  ep.label_logit = lab;
  cudaError_t e = launch_gemm_bf16<kLse>(w, ldw, x, d, v, rows, d, ep, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = 2 * ((v + kBM - 1) / kBM);
  ce_fwd_combine_kernel<<<(rows + 31) / 32, kMergeWarps * 32, 0, s>>>(part_max, part_sum, labels,
                                                                      lse, lab, rows, tiles, v);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 mainloop on its own, for tests and measurements: out [m, n]
// float32 (row stride n) = at [k, m] bf16 (row stride lda) transposed times
// bk [n, k] bf16 transposed; k and lda multiples of 8, both 16-byte aligned.
extern "C" int ptt_gemm_bf16(const uint16_t* at, const uint16_t* bk, float* out, int m, int n,
                             int k, int lda, void* stream) {
  Epilogue ep = {};
  ep.out = out;
  ep.ldo = n;
  return static_cast<int>(
      launch_gemm_bf16<kStore>(at, lda, bk, k, m, n, k, ep, static_cast<cudaStream_t>(stream)));
}
