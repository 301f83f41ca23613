// Backward of the fused final projection + softmax cross-entropy for Hopper
// (sm_90a): dx, dW, db of sum(g * (lse - label logit)), float32 in and out,
// the three products on the tensor cores as 3xTF32 wgmma.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/linear_ce.py::_bwd_kernel
// (launched by linear_ce_bwd).  The forward (K7) is csrc/linear_ce.cu.
//
// Bound: operations.  At the training path's shapes (B = 16384 rows,
// D = 512, V = 32000) the backward is three [B, D] x [D, V]-sized products,
// 1.61 TFLOP of float32 work: 24.0 ms on the float32 CUDA cores (67 TFLOP/s)
// and, as three TF32 products per float32 product (4.83 TFLOP), 9.8 ms on
// the tensor cores (495 TFLOP/s).  The bytes (x, W, the outputs) are 0.2 GB.
//
// The mainloop, its layouts and its 3xTF32 split: csrc/gemm_3xtf32.cuh.
//  With the scratch kept transposed, dlT [VC, B], no operand needs a copy:
//    dlT = W^T x^T   At = W[:, chunk] [D, VC]   Bk = x [B, D]
//    dx  = dl W^T    At = dlT [VC, B]           Bk = W[:, chunk] [D, VC]
//    dW  = x^T dl    At = x [B, D]              Bk = dlT [VC, B]
//
// The vocabulary is walked in chunks of VC columns.  Per chunk: the dl
// kernel (logits recomputed from the saved lse; its epilogue also writes
// each tile's row sums of dlT), the dx kernel (accumulating over the chunks
// in place, each element owned by one block), the dW kernel, and a small
// kernel that adds the row sums in tile order into db.  No float atomics:
// the result does not depend on the run.  The scratch is written once and
// read twice, 1/8 of the [B, V] logits at VC = 4096.
//
// What changed from the TPU design: the Pallas backward writes V/bv dx
// partials and reduces them outside, because a TPU grid cannot revisit an
// output block; here dx accumulates in place over the chunks.
#include "gemm_3xtf32.cuh"

namespace {

// db[c] = sum over the row tiles, in order, of part[tile, c]
__global__ void ce_db_kernel(const float* __restrict__ part, int tiles, int part_ld,
                             float* __restrict__ db, int vc) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= vc) return;
  float s = 0.f;
  for (int t = 0; t < tiles; ++t) s += part[static_cast<int64_t>(t) * part_ld + c];
  db[c] = s;
}

}  // namespace

// c [m, n] (row stride ldc) = at^T bk^T in 3xTF32: at [k, m] row stride lda,
// bk [n, k] row stride ldb.  The mainloop of the backward on its own.
extern "C" int ptt_gemm_3xtf32(const float* at, const float* bk, float* c, int m, int n, int k,
                               int64_t lda, int64_t ldb, int64_t ldc, int n_fast, void* stream) {
  Epilogue ep = {};
  ep.out = c;
  ep.ldo = ldc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(launch_gemm<kStore>(at, lda, bk, ldb, m, n, k, n_fast, ep, s));
}

// x: [rows, d], w: [d, v], bias: [v] or null, labels: [rows] int32, lse, g:
// [rows] -> dx: [rows, d], dw: [d, v], db: [v] (null when bias is null).
// Scratch: dlt [chunk, ldl] (ldl >= rows), part [ceil(rows / 128), chunk]
// (unused when bias is null).  d, v, chunk, ldl multiples of 4; x, w, dlt
// 16-byte aligned.  Launches on ``stream`` and returns the first error.
extern "C" int ptt_linear_ce_bwd_f32(const float* x, const float* w, const float* bias,
                                     const int* labels, const float* lse, const float* g,
                                     float* dx, float* dw, float* db, float* dlt, float* part,
                                     int rows, int d, int v, int chunk, int ldl, void* stream) {
  if (d <= 0 || v <= 0 || d % 4 != 0 || v % 4 != 0 || chunk % 4 != 0 || chunk <= 0 ||
      ldl % 4 != 0 || ldl < rows)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0) {  // no rows: every gradient is zero
    cudaMemsetAsync(dw, 0, sizeof(float) * static_cast<size_t>(d) * v, s);
    if (bias != nullptr) cudaMemsetAsync(db, 0, sizeof(float) * static_cast<size_t>(v), s);
    return static_cast<int>(cudaGetLastError());
  }
  const int row_tiles = (rows + kBN - 1) / kBN;
  for (int v0 = 0; v0 < v; v0 += chunk) {
    const int vc = v - v0 < chunk ? v - v0 : chunk;
    Epilogue dl = {};
    dl.out = dlt;
    dl.ldo = ldl;
    dl.bias = bias;
    dl.labels = labels;
    dl.lse = lse;
    dl.g = g;
    dl.part = bias != nullptr ? part : nullptr;
    dl.part_ld = chunk;
    dl.v0 = v0;
    cudaError_t e = launch_gemm<kDl>(w + v0, v, x, d, vc, rows, d, 0, dl, s);
    if (e != cudaSuccess) return static_cast<int>(e);
    Epilogue to_dx = {};
    to_dx.out = dx;
    to_dx.ldo = d;
    to_dx.accumulate = v0 > 0;
    e = launch_gemm<kStore>(dlt, ldl, w + v0, v, rows, d, vc, 1, to_dx, s);
    if (e != cudaSuccess) return static_cast<int>(e);
    Epilogue to_dw = {};
    to_dw.out = dw + v0;
    to_dw.ldo = v;
    e = launch_gemm<kStore>(x, d, dlt, ldl, d, vc, rows, 0, to_dw, s);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (bias != nullptr)
      ce_db_kernel<<<(vc + 255) / 256, 256, 0, s>>>(part, row_tiles, chunk, db + v0, vc);
  }
  return static_cast<int>(cudaGetLastError());
}
