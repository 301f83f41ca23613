// Batched row-vector product for Hopper (sm_90a):
//   out[b, n] = sum_k x[b, k] * y[b, k, n].
//
// This is the ``matmul`` lowering's route for a batch of row vectors (M = 1
// after the transposes, with batch dims), as a decode step's attention
// reads its cache: [b, 1, cap] x [b, cap, d] and [b, 1, d] x [b, d, cap].
// cuBLAS picks its kernel (and with it the order of the sum over K) by the
// batch count, so a row's result there depends on how many other rows share
// the batch.  Here each output element is one thread's fused multiply-add
// chain over k = 0 .. K-1 from +0.0, whatever B is: a row's bits are the
// same alone and inside any batch.
//
// Bound: bytes.  Each y element is read once and used in one multiply-add;
// a warp's 32 lanes take 32 adjacent n of one (b, k), so y's rows are read
// coalesced when its n stride is 1 (the value cache), and x[b, k] is one
// broadcast load a warp.  The shapes are small (a decode batch), so the
// grid is one thread an output element, walked by a grid-stride loop.
//
// Strides are in elements, so a transposed operand (the key cache read as
// [b, d, cap]) is taken as it lies, without a copy.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
rowvec_mm_kernel(const float* __restrict__ x, const float* __restrict__ y,
                 float* __restrict__ out, int64_t b_count, int64_t k_count,
                 int64_t n_count, int64_t x_sb, int64_t x_sk, int64_t y_sb,
                 int64_t y_sk, int64_t y_sn) {
  const int64_t total = b_count * n_count;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t b = i / n_count;
    const int64_t n = i - b * n_count;
    const float* xr = x + b * x_sb;
    const float* yc = y + b * y_sb + n * y_sn;
    float acc = 0.f;
    for (int64_t k = 0; k < k_count; ++k) {
      acc = __fmaf_rn(__ldg(xr + k * x_sk), __ldg(yc + k * y_sk), acc);
    }
    out[i] = acc;
  }
}

}  // namespace

// x: [b, k] float32 (strides x_sb, x_sk); y: [b, k, n] float32 (strides
// y_sb, y_sk, y_sn); out: [b, n] float32, contiguous.  Launches on
// ``stream`` and returns cudaGetLastError().
extern "C" int ptt_rowvec_mm_f32(const float* x, const float* y, float* out,
                                 int64_t b, int64_t k, int64_t n, int64_t x_sb,
                                 int64_t x_sk, int64_t y_sb, int64_t y_sk,
                                 int64_t y_sn, void* stream) {
  if (b <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  const int64_t total = b * n;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 65535) blocks = 65535;
  rowvec_mm_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      x, y, out, b, k, n, x_sb, x_sk, y_sb, y_sk, y_sn);
  return static_cast<int>(cudaGetLastError());
}
