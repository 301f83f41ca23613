// Fused Adam update for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/fused_optimizer.py::
// _adam_kernel (launched by fused_adam).  Same function, element for
// element:
//   m1' = beta1 * m1 + (1 - beta1) * g
//   m2' = beta2 * m2 + (1 - beta2) * (g * g)
//   p'  = p - lr_t * m1' / (sqrt(m2') + eps)
//   lr_t = lr * sqrt(1 - beta2_pow * beta2) / (1 - beta1_pow * beta1)
// and beta{1,2}_pow' = beta{1,2}_pow * beta{1,2}.
//
// What changed from the TPU design: the TPU pads the flattened tensors to
// [rows, 128] (its (8, 128) tiling) and gets lr_t as an SMEM scalar computed
// outside; here the tensors stay flat, and every thread computes lr_t from
// the three device scalars (lr, beta1_pow, beta2_pow: no host round trip).
// Block 0's thread 0 writes the two beta powers.  The outputs are fresh
// buffers, not the inputs.
//
// Bound: bytes.  Four tensors are read and three written, 28 bytes an
// element, with 10 flops: far below the card's flops per byte.  Each thread
// moves float4s (16 bytes a lane, coalesced) when the element count and
// the pointers allow, in a grid-stride loop.
//
// Rounding: the products and sums use the _rn intrinsics, so nvcc cannot
// contract them into FMAs; with IEEE sqrt and division (the defaults
// without --use_fast_math) every element is rounded as the plain PyTorch
// version rounds it.  (1 - beta) comes in from the host, rounded from
// double as the plain version's Python scalars are.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Coef {
  float beta1, beta2, omb1, omb2, eps, lr_t;
};

__device__ __forceinline__ void adam1(const Coef& c, float p, float g, float m1, float m2,
                                      float* po, float* m1o, float* m2o) {
  const float m1n = __fadd_rn(__fmul_rn(c.beta1, m1), __fmul_rn(c.omb1, g));
  const float m2n = __fadd_rn(__fmul_rn(c.beta2, m2), __fmul_rn(c.omb2, __fmul_rn(g, g)));
  *m1o = m1n;
  *m2o = m2n;
  *po = __fsub_rn(p, __fdiv_rn(__fmul_rn(c.lr_t, m1n), __fadd_rn(__fsqrt_rn(m2n), c.eps)));
}

template <bool VEC4>
__global__ void __launch_bounds__(kThreads)
fused_adam_kernel(const float* __restrict__ p, const float* __restrict__ g,
                  const float* __restrict__ m1, const float* __restrict__ m2,
                  const float* __restrict__ b1p_in, const float* __restrict__ b2p_in,
                  const float* __restrict__ lr_in, float beta1, float beta2, float omb1,
                  float omb2, float eps, float* __restrict__ po, float* __restrict__ m1o,
                  float* __restrict__ m2o, float* __restrict__ b1p_out,
                  float* __restrict__ b2p_out, int64_t n) {
  const float b1p = *b1p_in, b2p = *b2p_in, lr = *lr_in;
  Coef c{beta1, beta2, omb1, omb2, eps, 0.f};
  c.lr_t = __fdiv_rn(__fmul_rn(lr, __fsqrt_rn(__fsub_rn(1.f, __fmul_rn(b2p, beta2)))),
                     __fsub_rn(1.f, __fmul_rn(b1p, beta1)));
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *b1p_out = __fmul_rn(b1p, beta1);
    *b2p_out = __fmul_rn(b2p, beta2);
  }
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (VEC4) {
    const int64_t n4 = n / 4;
    for (; i < n4; i += stride) {
      const float4 pv = reinterpret_cast<const float4*>(p)[i];
      const float4 gv = reinterpret_cast<const float4*>(g)[i];
      const float4 av = reinterpret_cast<const float4*>(m1)[i];
      const float4 bv = reinterpret_cast<const float4*>(m2)[i];
      float4 pn, an, bn;
      adam1(c, pv.x, gv.x, av.x, bv.x, &pn.x, &an.x, &bn.x);
      adam1(c, pv.y, gv.y, av.y, bv.y, &pn.y, &an.y, &bn.y);
      adam1(c, pv.z, gv.z, av.z, bv.z, &pn.z, &an.z, &bn.z);
      adam1(c, pv.w, gv.w, av.w, bv.w, &pn.w, &an.w, &bn.w);
      reinterpret_cast<float4*>(po)[i] = pn;
      reinterpret_cast<float4*>(m1o)[i] = an;
      reinterpret_cast<float4*>(m2o)[i] = bn;
    }
  } else {
    for (; i < n; i += stride) adam1(c, p[i], g[i], m1[i], m2[i], po + i, m1o + i, m2o + i);
  }
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

// p, g, m1, m2 -> po, m1o, m2o: [n] float32; b1p, b2p, lr -> b1p_out,
// b2p_out: one float32 each, on the device.  Launches on ``stream`` and
// returns cudaGetLastError().
extern "C" int ptt_fused_adam_f32(const float* p, const float* g, const float* m1,
                                  const float* m2, const float* b1p, const float* b2p,
                                  const float* lr, float beta1, float beta2, float omb1,
                                  float omb2, float eps, float* po, float* m1o, float* m2o,
                                  float* b1p_out, float* b2p_out, int64_t n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = n % 4 == 0 && aligned16(p) && aligned16(g) && aligned16(m1) &&
                    aligned16(m2) && aligned16(po) && aligned16(m1o) && aligned16(m2o);
  const int64_t work = vec4 ? n / 4 : n;
  // at most 8 blocks per SM's worth (132 SMs on an H100), at least one
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 132 * 8) blocks = 132 * 8;
  if (blocks < 1) blocks = 1;
  if (vec4) {
    fused_adam_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        p, g, m1, m2, b1p, b2p, lr, beta1, beta2, omb1, omb2, eps, po, m1o, m2o, b1p_out,
        b2p_out, n);
  } else {
    fused_adam_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        p, g, m1, m2, b1p, b2p, lr, beta1, beta2, omb1, omb2, eps, po, m1o, m2o, b1p_out,
        b2p_out, n);
  }
  return static_cast<int>(cudaGetLastError());
}
