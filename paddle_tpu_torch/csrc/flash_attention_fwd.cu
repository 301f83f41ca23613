// Flash-attention forward for Hopper (sm_90a), register-tiled, on float32
// q/k/v.  bf16 q/k/v go to the tensor-core kernel of
// csrc/flash_attention_fwd_bf16.cu.
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
//    owns one (batch*head, 64-query tile) and loops over 64-key tiles; m, l
//    and the output accumulator stay in registers, and the output is
//    written once.
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
// Bound: operations on the float32 CUDA cores (4*d flops per valid (query,
// key) pair; chip_smoke.py prints the bound per shape).  The products stay
// in float32 outside the tensor cores: TF32 would fail the float32 gates.
// Design for the FMA rate:
//  * 256 threads as a 16 x 16 grid.  Thread (ty, tx) owns query rows
//    4*ty..4*ty+3 and keys tx, tx+16, tx+32, tx+48 of a tile: a 4 x 4
//    micro-tile of S built from float4 reads of q and k rows, four d at a
//    time -- 8 shared-memory reads per 64 FMAs.  Then the same rows and
//    head_dim/16 output columns: a 4 x (d/16) micro-tile of O built from one
//    float4 of P (stored transposed) and the float4 of a V row per key.
//  * Row max and row sums come from shuffles among the 16 threads of a row
//    (one warp); each exp is computed once, by the thread that owns the
//    score, and the sums are reduced once, after the last tile.
//  * K and V tiles are double-buffered in shared memory with cp.async: the
//    next tile loads while this one is multiplied.  Rows of q and k are
//    padded by 4 floats, so the reads of a quarter-warp hit distinct banks.
//  * head_dim 64 takes 101.6 KB of dynamic shared memory: two blocks an SM.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;        // the Pallas kernel's NEG_INF
constexpr int kBQ = 64;                  // query rows per block
constexpr int kBK = 64;                  // keys per tile
constexpr int kPLd = kBQ + 4;            // padded row of P^T (floats)

constexpr int kRows = 4;                 // query rows a thread
constexpr int kThreads = 16 * (kBQ / kRows);  // 16 x 16

// shared memory of one block, byte offsets: q (scaled), the K and V tiles
// (two buffers each) and P^T
template <int D>
struct Cfg {
  static constexpr int kLd = D + 4;                   // padded q and k rows (floats)
  static constexpr int kVec = D >= 64 ? 4 : D / 16;   // output columns a thread reads at once
  static constexpr int kGroups = D / 16 / kVec;       // of kVec columns, 16 * kVec apart
  static constexpr int kQOff = 0;
  static constexpr int kKOff = kQOff + kBQ * kLd * 4;                  // two buffers
  static constexpr int kVOff = kKOff + 2 * kBK * kLd * 4;    // two, unpadded rows
  static constexpr int kPOff = kVOff + 2 * kBK * D * 4;
  static constexpr int kBytes = kPOff + kBK * kPLd * 4;
  static_assert(kKOff % 16 == 0 && kVOff % 16 == 0 && kPOff % 16 == 0, "16-byte regions");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

template <int D>
__device__ __forceinline__ void load_kv_tile(float* ks, float* vs, const float* __restrict__ kb,
                                             const float* __restrict__ vb, int k0, int tk) {
  constexpr int kChunks = kBK * D / 4;
  for (int idx = threadIdx.x; idx < kChunks; idx += kThreads) {
    const int row = idx / (D / 4), col = (idx % (D / 4)) * 4;
    const int kp = k0 + row;
    const bool valid = kp < tk;
    const int64_t off = valid ? static_cast<int64_t>(kp) * D + col : 0;
    cp_async4(ks + row * Cfg<D>::kLd + col, kb + off, valid);
    cp_async4(vs + row * D + col, vb + off, valid);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// 4 consecutive floats, and the V row's kVec columns
__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

template <int V>
struct VecT;
template <> struct VecT<4> { using T = float4; };
template <> struct VecT<2> { using T = float2; };
template <> struct VecT<1> { using T = float; };

template <int V>
__device__ __forceinline__ typename VecT<V>::T ldv(const float* p) {
  return *reinterpret_cast<const typename VecT<V>::T*>(p);
}

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ float lane_of(const float2& v, int i) { return i == 0 ? v.x : v.y; }
__device__ __forceinline__ float lane_of(const float& v, int) { return v; }

template <int D>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 2 : 1)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ kv_lens,
                 float* __restrict__ out, float* __restrict__ lse, int tq, int tk, int causal,
                 float sm_scale) {
  using C = Cfg<D>;
  using VT = typename VecT<C::kVec>::T;
  constexpr int kOC = D / 16;  // output columns a thread
  extern __shared__ __align__(16) uint8_t smem[];
  float* qs = reinterpret_cast<float*>(smem + C::kQOff);
  float* ps = reinterpret_cast<float*>(smem + C::kPOff);
  float* const kbuf = reinterpret_cast<float*>(smem + C::kKOff);
  float* const vbuf = reinterpret_cast<float*>(smem + C::kVOff);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const float* qb = q + static_cast<int64_t>(bh) * tq * D;
  const float* kb = k + static_cast<int64_t>(bh) * tk * D;
  const float* vb = v + static_cast<int64_t>(bh) * tk * D;

  // Keys past kend are masked for every row of this block: past T, past
  // the key length, or (causal) past the block's last query row.
  int kend = tk;
  if (kv_lens != nullptr) kend = min(kend, max(kv_lens[bh], 0));
  if (causal) kend = min(kend, min(q0 + kBQ, tq));
  const int ntiles = (kend + kBK - 1) / kBK;
  if (ntiles > 0) load_kv_tile<D>(kbuf, vbuf, kb, vb, 0, tk);

  // q, scaled, into shared memory once
  for (int idx = tid; idx < kBQ * D / 4; idx += kThreads) {
    const int row = idx / (D / 4), col = (idx % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + row < tq) {
      x = ldg4(qb + static_cast<int64_t>(q0 + row) * D + col);
      x.x *= sm_scale; x.y *= sm_scale; x.z *= sm_scale; x.w *= sm_scale;
    }
    *reinterpret_cast<float4*>(qs + row * C::kLd + col) = x;
  }

  float o[kRows][kOC], m[kRows], lpart[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    lpart[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kOC; ++c) o[r][c] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    const int buf = t & 1, k0 = t * kBK;
    const float* ks = kbuf + buf * kBK * C::kLd;
    const float* vs = vbuf + buf * kBK * D;
    if (t + 1 < ntiles) {
      load_kv_tile<D>(kbuf + (buf ^ 1) * kBK * C::kLd, vbuf + (buf ^ 1) * kBK * D, kb, vb,
                         k0 + kBK, tk);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();   // this tile (and, on the first, q) is in shared memory

    // S micro-tile: rows kRows*ty + r, keys tx + 16*c
    float s[kRows][4];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 b[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = ld4(ks + (tx + 16 * c) * C::kLd + d);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(qs + (ty * kRows + r) * C::kLd + d);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float x = s[r][c];
          x = fmaf(a.x, b[c].x, x);
          x = fmaf(a.y, b[c].y, x);
          x = fmaf(a.z, b[c].z, x);
          x = fmaf(a.w, b[c].w, x);
          s[r][c] = x;
        }
      }
    }

    // online softmax over this tile, row by row
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = q0 + ty * kRows + r;
      float mt = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kp = k0 + tx + 16 * c;
        if (!(kp < kend && (!causal || qpos >= kp))) s[r][c] = kNegInf;
        mt = fmaxf(mt, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off /= 2) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[r], mt);
      // rows masked so far keep p = 0 (not exp(-inf - -inf) = 1)
      const bool live = m_new > kNegInf / 2;
      const float alpha = m[r] > kNegInf / 2 ? expf(m[r] - m_new) : 1.f;
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = live ? expf(s[r][c] - m_new) : 0.f;
        psum += s[r][c];
      }
      lpart[r] = lpart[r] * alpha + psum;
#pragma unroll
      for (int c = 0; c < kOC; ++c) o[r][c] *= alpha;
      m[r] = m_new;
    }
    // P^T: row = key, 4 consecutive query rows as one float4
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int r4 = 0; r4 < kRows; r4 += 4)
        *reinterpret_cast<float4*>(ps + (tx + 16 * c) * kPLd + ty * kRows + r4) =
            make_float4(s[r4][c], s[r4 + 1][c], s[r4 + 2][c], s[r4 + 3][c]);
    __syncthreads();   // P complete

    // O micro-tile: rows kRows*ty + r, columns g*16*kVec + tx*kVec + i
    const int jn = min(kBK, kend - k0);   // keys past kend have p = 0
#pragma unroll 2
    for (int j = 0; j < jn; ++j) {
      float p[kRows];
#pragma unroll
      for (int r4 = 0; r4 < kRows; r4 += 4) {
        const float4 p4 = *reinterpret_cast<const float4*>(ps + j * kPLd + ty * kRows + r4);
        p[r4] = p4.x; p[r4 + 1] = p4.y; p[r4 + 2] = p4.z; p[r4 + 3] = p4.w;
      }
#pragma unroll
      for (int g = 0; g < C::kGroups; ++g) {
        const VT vv = ldv<C::kVec>(vs + j * D + g * 16 * C::kVec + tx * C::kVec);
#pragma unroll
        for (int i = 0; i < C::kVec; ++i) {
          const float x = lane_of(vv, i);
#pragma unroll
          for (int r = 0; r < kRows; ++r) o[r][g * C::kVec + i] = fmaf(p[r], x, o[r][g * C::kVec + i]);
        }
      }
    }
    __syncthreads();   // every thread is done with this buffer and with P
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float l = lpart[r];
#pragma unroll
    for (int off = 8; off > 0; off /= 2) l += __shfl_xor_sync(0xffffffffu, l, off);
    const int qpos = q0 + ty * kRows + r;
    if (qpos >= tq) continue;
    const float l_safe = fmaxf(l, 1e-20f);
    const bool any = m[r] > kNegInf / 2;  // a row with no valid key emits zeros
    float* ob = out + (static_cast<int64_t>(bh) * tq + qpos) * D;
#pragma unroll
    for (int g = 0; g < C::kGroups; ++g)
#pragma unroll
      for (int i = 0; i < C::kVec; ++i)
        ob[g * 16 * C::kVec + tx * C::kVec + i] = any ? o[r][g * C::kVec + i] / l_safe : 0.f;
    if (tx == 0) lse[static_cast<int64_t>(bh) * tq + qpos] = m[r] + logf(l_safe);
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, const int* kv_lens,
                   float* out, float* lse, int bh, int tq, int tk, int causal, float sm_scale,
                   cudaStream_t stream) {
  using C = Cfg<D>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kBytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((tq + kBQ - 1) / kBQ, bh);
  flash_fwd_kernel<D><<<grid, kThreads, C::kBytes, stream>>>(q, k, v, kv_lens, out, lse, tq, tk,
                                                             causal, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// q: [bh, tq, d], k/v: [bh, tk, d] float32 contiguous, 16-byte aligned;
// kv_lens: [bh] int32 or null; out: [bh, tq, d] float32; lse: [bh, tq]
// float32.  Launches on ``stream`` and returns cudaGetLastError().
extern "C" int ptt_flash_attn_fwd_f32(const float* q, const float* k, const float* v,
                                      const int* kv_lens, float* out, float* lse, int bh,
                                      int tq, int tk, int d, int causal, float sm_scale,
                                      void* stream) {
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
