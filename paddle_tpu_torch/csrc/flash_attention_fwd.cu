// Flash-attention forward for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/flash_attention.py::
// _attn_fwd_kernel (launched by _flash_fwd_pallas).  Same function: per
// (batch*head) row block, scores q.k^T scaled by sm_scale (applied to q
// before the dot), a causal mask and a per-(batch*head) key-length mask,
// an online softmax over key tiles, out = acc / l, lse = m + log(l), and
// exact zeros for a row with no valid key.
//
// What changed from the TPU design:
//  * Loop order.  The Pallas grid walks KV blocks sequentially and carries
//    (acc, m, l) in VMEM scratch between grid steps.  Here one thread block
//    owns one (batch*head, 64-row query tile) and loops over K/V tiles
//    staged in shared memory; m, l and acc stay in registers for the whole
//    loop, and the output is written once.
//  * Shapes.  No divisibility gate and no block halving: the kernel masks
//    ragged T edges itself, and takes head_dim 16, 32, 64 and 128 (the TPU
//    policy declined head_dim 64, so transformer-base never reached the
//    Pallas kernel there).
//  * Work skipping.  K/V tiles past the row block's causal diagonal, past
//    the key length, or past T are never loaded.  That is exact: a fully
//    masked tile leaves (acc, m, l) unchanged.  A padded batch row (key
//    length 0) does no work at all.
//  * lse is stored as [B*H, T] float32, not lane-replicated to 128.
//
// Bound at the serving path's shapes (B*H = 64, T = 256, d = 64): operations
// on the float32 CUDA cores -- 4*d flops per valid (query, key) pair, about
// 1 GFLOP per call, against 16 MiB of q/k/v/out traffic (chip_smoke.py
// prints both bounds).  This first version does the products
// with scalar FMAs from shared memory; tensor cores (TF32 or bf16 wgmma)
// come with the bf16/AMP work.  Four threads share a query row: each holds
// a quarter of q and of the accumulator in registers, partial dots are
// summed with two warp shuffles, and the four threads read four
// consecutive shared-memory words of a K/V row, which the eight rows of a
// warp read as broadcasts -- no bank conflicts.  The softmax is updated
// once per 16 keys to amortize the accumulator rescale.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;        // the Pallas kernel's NEG_INF
constexpr int kBlockQ = 64;              // query rows per thread block
constexpr int kTpr = 4;                  // threads per query row
constexpr int kThreads = kBlockQ * kTpr;
constexpr int kChunk = 16;               // keys per online-softmax update

template <int D>
struct Tile {
  static constexpr int kBlockK = D <= 64 ? 64 : 32;  // keys per staged tile
  static constexpr int kPer = D / kTpr;              // dims per thread
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ kv_lens,
                 float* __restrict__ out, float* __restrict__ lse, int tq,
                 int tk, int causal, float sm_scale) {
  constexpr int BK = Tile<D>::kBlockK;
  constexpr int PER = Tile<D>::kPer;
  static_assert(BK % kChunk == 0 && D % 4 == 0, "tile shape");
  __shared__ __align__(16) float ks[BK * D];
  __shared__ __align__(16) float vs[BK * D];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int part = threadIdx.x % kTpr;      // this thread's interleaved dims
  const int qpos = q0 + threadIdx.x / kTpr;
  const bool row_ok = qpos < tq;

  const float* qb = q + static_cast<int64_t>(bh) * tq * D;
  const float* kb = k + static_cast<int64_t>(bh) * tk * D;
  const float* vb = v + static_cast<int64_t>(bh) * tk * D;

  float qr[PER], acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    qr[i] = row_ok ? qb[static_cast<int64_t>(qpos) * D + i * kTpr + part] * sm_scale
                   : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  // Keys past kend are masked for every row of this block: past T, past
  // the key length, or (causal) past the block's last query row.
  int kend = tk;
  if (kv_lens != nullptr) kend = min(kend, max(kv_lens[bh], 0));
  if (causal) kend = min(kend, min(q0 + kBlockQ, tq));

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = threadIdx.x; idx < BK * D / 4; idx += kThreads) {
      const int kp = k0 + (idx * 4) / D;
      const int col = (idx * 4) % D;
      float4 kv4 = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv4 = kv4;
      if (kp < tk) {
        kv4 = *reinterpret_cast<const float4*>(kb + static_cast<int64_t>(kp) * D + col);
        vv4 = *reinterpret_cast<const float4*>(vb + static_cast<int64_t>(kp) * D + col);
      }
      reinterpret_cast<float4*>(ks)[idx] = kv4;
      reinterpret_cast<float4*>(vs)[idx] = vv4;
    }
    __syncthreads();

    for (int c0 = 0; c0 < BK && k0 + c0 < kend; c0 += kChunk) {
      float s[kChunk];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const float* kr = ks + (c0 + c) * D + part;
        float a = 0.f;
#pragma unroll
        for (int i = 0; i < PER; ++i) a = fmaf(qr[i], kr[i * kTpr], a);
        a += __shfl_xor_sync(0xffffffffu, a, 1);
        a += __shfl_xor_sync(0xffffffffu, a, 2);
        const int kp = k0 + c0 + c;
        s[c] = (kp < kend && (!causal || qpos >= kp)) ? a : kNegInf;
      }
      float m_new = m;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) m_new = fmaxf(m_new, s[c]);
      // rows masked so far keep p = 0 (not exp(-inf - -inf) = 1)
      const bool live = m_new > kNegInf / 2;
      const float alpha = m > kNegInf / 2 ? expf(m - m_new) : 1.f;
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        s[c] = live ? expf(s[c] - m_new) : 0.f;
        psum += s[c];
      }
      l = l * alpha + psum;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        float a = acc[i] * alpha;
#pragma unroll
        for (int c = 0; c < kChunk; ++c)
          a = fmaf(s[c], vs[(c0 + c) * D + i * kTpr + part], a);
        acc[i] = a;
      }
      m = m_new;
    }
  }

  if (row_ok) {
    const float l_safe = fmaxf(l, 1e-20f);
    const bool any = m > kNegInf / 2;  // a row with no valid key emits zeros
    float* ob = out + (static_cast<int64_t>(bh) * tq + qpos) * D;
#pragma unroll
    for (int i = 0; i < PER; ++i) ob[i * kTpr + part] = any ? acc[i] / l_safe : 0.f;
    if (part == 0) lse[static_cast<int64_t>(bh) * tq + qpos] = m + logf(l_safe);
  }
}

template <int D>
void launch(const float* q, const float* k, const float* v, const int* kv_lens,
            float* out, float* lse, int bh, int tq, int tk, int causal,
            float sm_scale, cudaStream_t stream) {
  const dim3 grid((tq + kBlockQ - 1) / kBlockQ, bh);
  flash_fwd_kernel<D><<<grid, kThreads, 0, stream>>>(q, k, v, kv_lens, out, lse,
                                                     tq, tk, causal, sm_scale);
}

}  // namespace

// q: [bh, tq, d], k/v: [bh, tk, d] float32 contiguous, 16-byte aligned;
// kv_lens: [bh] int32 or null; out: [bh, tq, d]; lse: [bh, tq] float32.
// Launches on ``stream`` and returns cudaGetLastError().
extern "C" int ptt_flash_attn_fwd_f32(const float* q, const float* k,
                                      const float* v, const int* kv_lens,
                                      float* out, float* lse, int bh, int tq,
                                      int tk, int d, int causal,
                                      float sm_scale, void* stream) {
  if (bh <= 0 || tq <= 0) return static_cast<int>(cudaSuccess);
  if (bh > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: launch<16>(q, k, v, kv_lens, out, lse, bh, tq, tk, causal, sm_scale, s); break;
    case 32: launch<32>(q, k, v, kv_lens, out, lse, bh, tq, tk, causal, sm_scale, s); break;
    case 64: launch<64>(q, k, v, kv_lens, out, lse, bh, tq, tk, causal, sm_scale, s); break;
    case 128: launch<128>(q, k, v, kv_lens, out, lse, bh, tq, tk, causal, sm_scale, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
