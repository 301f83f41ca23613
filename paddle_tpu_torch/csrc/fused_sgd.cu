// Fused SGD update for Hopper (sm_90a), float32: p' = p - lr * g.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/fused_optimizer.py::
// _sgd_kernel (launched by fused_sgd through _row_call).  Same function,
// element for element.
//
// What changed from the TPU design: the TPU pads the flattened tensors to
// [rows, 128] (its (8, 128) tiling) and reads lr as a (1, 1) SMEM scalar;
// here the tensors stay flat and every thread reads lr from the device
// scalar (no host round trip across the 186 updates of a step).  The
// output is a fresh buffer, not the parameter.
//
// Bound: bytes.  Two tensors are read and one written, 12 bytes an
// element, for one fused multiply-add.  Each thread moves float4s (16
// bytes a lane, coalesced) when the element count and the pointers allow,
// in a grid-stride loop.
//
// Rounding: one rounding per element, __fmaf_rn(-lr, g, p), which is what
// the JAX package's kernel computes (XLA contracts p - lr * g into a fused
// multiply-add; its CPU interpret mode does).  The explicit intrinsic
// leaves nvcc no choice of contraction, and the plain PyTorch version
// emulates the single rounding exactly, so K5 is bit-equal to both.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <bool VEC4>
__global__ void __launch_bounds__(kThreads)
fused_sgd_kernel(const float* __restrict__ p, const float* __restrict__ g,
                 const float* __restrict__ lr_in, float* __restrict__ po, int64_t n) {
  const float lr = *lr_in;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (VEC4) {
    for (; i < n / 4; i += stride) {
      const float4 pv = reinterpret_cast<const float4*>(p)[i];
      const float4 gv = reinterpret_cast<const float4*>(g)[i];
      float4 o;
      o.x = __fmaf_rn(-lr, gv.x, pv.x);
      o.y = __fmaf_rn(-lr, gv.y, pv.y);
      o.z = __fmaf_rn(-lr, gv.z, pv.z);
      o.w = __fmaf_rn(-lr, gv.w, pv.w);
      reinterpret_cast<float4*>(po)[i] = o;
    }
  } else {
    for (; i < n; i += stride) po[i] = __fmaf_rn(-lr, g[i], p[i]);
  }
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

// p, g -> po: [n] float32; lr: one float32, all on the device.  Launches on
// ``stream`` and returns cudaGetLastError().
extern "C" int ptt_fused_sgd_f32(const float* p, const float* g, const float* lr, float* po,
                                 int64_t n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = n % 4 == 0 && aligned16(p) && aligned16(g) && aligned16(po);
  const int64_t work = vec4 ? n / 4 : n;
  // at most 8 blocks per SM's worth (132 SMs on an H100), at least one
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 132 * 8) blocks = 132 * 8;
  if (blocks < 1) blocks = 1;
  if (vec4) {
    fused_sgd_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(p, g, lr, po, n);
  } else {
    fused_sgd_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(p, g, lr, po, n);
  }
  return static_cast<int>(cudaGetLastError());
}
