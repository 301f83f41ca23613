// Multi-tensor fused Adam update for Hopper (sm_90a), float32: one launch
// updates every parameter of a step.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/fused_optimizer.py::
// _adam_kernel (launched by fused_adam).  Same function, element for
// element, for each tensor of the table:
//   m1' = beta1 * m1 + (1 - beta1) * g
//   m2' = beta2 * m2 + (1 - beta2) * (g * g)      (fused: pallas_adam)
//   m2' = beta2 * m2 + ((1 - beta2) * g) * g      (composed: adam)
//   p'  = p - lr_t * m1' / (sqrt(m2') + eps)
//   lr_t = lr * sqrt(1 - beta2_pow * beta2) / (1 - beta1_pow * beta1)
// and beta{1,2}_pow' = beta{1,2}_pow * beta{1,2}.  An entry's flag says
// which of the two expressions of m2' it computes, so each op type keeps
// its own roundings.
//
// What changed from the TPU design: the TPU pads each flattened tensor to
// [rows, 128] (its (8, 128) tiling), gets lr_t as an SMEM scalar computed
// outside, and XLA fuses a step's updates into one program.  Here the
// tensors stay flat, and one launch takes them all: the table (pointers,
// element counts, flags and each tensor's first chunk, a prefix sum the
// host works out) is one __grid_constant__ kernel parameter, so it needs
// no copy to the device.  The tensors are cut into chunks of a fixed size;
// a persistent grid of a few blocks an SM walks the chunks with a
// grid-stride loop, and a block finds a chunk's tensor by a binary search
// over the chunk prefix, which it copies into shared memory once.  Small
// tensors (a transformer has many of 512 floats) share the card with the
// large ones instead of each paying a launch.  Every chunk computes lr_t
// from its tensor's three device scalars; the thread that owns a tensor's
// chunk 0 writes its beta powers.
//
// In place: the host passes p, m1 and m2 as their own outputs (the port
// updates state in place, as the TPU executor's donated buffers are).
// Each element is loaded and stored by one thread, loads before stores,
// and no pointer is __restrict__, so that is race-free.  The beta powers
// are not: every chunk of a tensor reads beta{1,2}_pow, and a later chunk
// would read the new value the chunk-0 thread wrote.  Their outputs are
// fresh one-element buffers, which the caller copies home after the
// launch.
//
// Bound: bytes.  Four tensors are read and three written, 28 bytes an
// element, with 10 flops: far below the card's flops per byte.  No byte is
// read twice, so the float4 loads and stores carry evict-first hints
// (__ldcs / __stcs), and each thread keeps kUnroll float4s of each stream
// in flight.  A tensor whose pointers are not all 16-byte aligned goes
// element by element, as does the tail of a tensor whose count is not a
// multiple of 4 (a chunk starts at a multiple of 4 elements).
//
// Rounding: the products and sums use the _rn intrinsics, so nvcc cannot
// contract them into FMAs; with IEEE sqrt and division (the defaults
// without --use_fast_math) every element is rounded as the plain PyTorch
// versions round it.  (1 - beta) comes in from the host, rounded from
// double as the plain versions' Python scalars are.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
// float4s of each stream in flight a thread: 4 took 2 % off 2 over the
// training step's 186 parameters on an H100 (tools/k56_sweep.py)
constexpr int kUnroll = 4;
// tensors a launch (ADAM_CAPACITY in ops/cuda/fused_optimizer.py): the table
// below is 28,704 bytes, inside the 32,764 bytes a kernel's parameters may take
constexpr int kMaxTensors = 256;
// floats a chunk (a multiple of 4: a chunk starts 16-byte aligned; CHUNK in
// ops/cuda/fused_optimizer.py, whose planner cuts the tensors) and blocks of
// the persistent grid an SM.  Over the training step's 186 parameters on an
// H100, chunks of 4K-16K floats and 2-8 blocks an SM time within 1-2 % of
// each other, larger chunks up to 2 % slower (tools/k56_sweep.py)
constexpr int kChunk = 8192;
constexpr int kBlocksPerSm = 4;
// a smaller table for groups of at most this many: a table of one launches
// 4 us sooner through it on an H100, host and events (tools/k56_sweep.py,
// one_table)
constexpr int kSmallTensors = 8;
constexpr int32_t kFused = 1, kVec4 = 2;

// an entry's pointers: the inputs, then the outputs (PO, M1O, M2O may be P,
// M1, M2: in place; B1PO and B2PO never alias B1P and B2P)
enum { P, G, M1, M2, B1P, B2P, LR, PO, M1O, M2O, B1PO, B2PO, kPtrs };

template <int CAP>
struct Table {
  float* ptr[CAP][kPtrs];
  int64_t n[CAP];
  int32_t flags[CAP];
  int32_t chunk_start[CAP + 1];   // a tensor's first chunk; [n_tensors] = all chunks
  int32_t n_tensors;
  float beta1, beta2, omb1, omb2, eps;
};

struct Coef {
  float beta1, beta2, omb1, omb2, eps, lr_t;
};

template <bool FUSED>
__device__ __forceinline__ void adam1(const Coef& c, float p, float g, float m1, float m2,
                                      float& po, float& m1o, float& m2o) {
  const float m1n = __fadd_rn(__fmul_rn(c.beta1, m1), __fmul_rn(c.omb1, g));
  const float sq = FUSED ? __fmul_rn(c.omb2, __fmul_rn(g, g))
                         : __fmul_rn(__fmul_rn(c.omb2, g), g);
  const float m2n = __fadd_rn(__fmul_rn(c.beta2, m2), sq);
  m1o = m1n;
  m2o = m2n;
  po = __fsub_rn(p, __fdiv_rn(__fmul_rn(c.lr_t, m1n), __fadd_rn(__fsqrt_rn(m2n), c.eps)));
}

// a streaming store: no byte written is read again by this kernel (in
// place, its element was loaded before, by the same thread)
__device__ __forceinline__ void store(float4* p, float4 v) { __stcs(p, v); }

template <bool FUSED>
__device__ __forceinline__ void adam4(const Coef& c, float4 p, float4 g, float4 a, float4 b,
                                      float4* po, float4* ao, float4* bo) {
  float4 pn, an, bn;
  adam1<FUSED>(c, p.x, g.x, a.x, b.x, pn.x, an.x, bn.x);
  adam1<FUSED>(c, p.y, g.y, a.y, b.y, pn.y, an.y, bn.y);
  adam1<FUSED>(c, p.z, g.z, a.z, b.z, pn.z, an.z, bn.z);
  adam1<FUSED>(c, p.w, g.w, a.w, b.w, pn.w, an.w, bn.w);
  store(po, pn);
  store(ao, an);
  store(bo, bn);
}

// elements [begin, end) of one tensor, by the block's threads
template <bool FUSED>
__device__ __forceinline__ void adam_range(const Coef& c, float* const* ptr, int64_t begin,
                                           int64_t end, bool vec4) {
  const float* p = ptr[P] + begin;
  const float* g = ptr[G] + begin;
  const float* m1 = ptr[M1] + begin;
  const float* m2 = ptr[M2] + begin;
  float* po = ptr[PO] + begin;
  float* m1o = ptr[M1O] + begin;
  float* m2o = ptr[M2O] + begin;
  const int len = static_cast<int>(end - begin);   // at most one chunk
  const int n4 = vec4 ? len / 4 : 0;
  const float4* p4 = reinterpret_cast<const float4*>(p);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  const float4* a4 = reinterpret_cast<const float4*>(m1);
  const float4* b4 = reinterpret_cast<const float4*>(m2);
  float4* po4 = reinterpret_cast<float4*>(po);
  float4* ao4 = reinterpret_cast<float4*>(m1o);
  float4* bo4 = reinterpret_cast<float4*>(m2o);
  for (int i = threadIdx.x; i < n4; i += kUnroll * kThreads) {
    float4 pv[kUnroll], gv[kUnroll], av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {      // every load issued before any use
      const int j = i + u * kThreads;
      if (j < n4) {
        pv[u] = __ldcs(p4 + j);
        gv[u] = __ldcs(g4 + j);
        av[u] = __ldcs(a4 + j);
        bv[u] = __ldcs(b4 + j);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = i + u * kThreads;
      if (j < n4) adam4<FUSED>(c, pv[u], gv[u], av[u], bv[u], po4 + j, ao4 + j, bo4 + j);
    }
  }
  for (int i = 4 * n4 + threadIdx.x; i < len; i += kThreads)
    adam1<FUSED>(c, p[i], g[i], m1[i], m2[i], po[i], m1o[i], m2o[i]);
}

template <int CAP>
__global__ void __launch_bounds__(kThreads)
fused_adam_kernel(const __grid_constant__ Table<CAP> tab) {
  __shared__ int32_t starts[CAP + 1];
  for (int i = threadIdx.x; i <= tab.n_tensors; i += kThreads) starts[i] = tab.chunk_start[i];
  __syncthreads();
  const int n_chunks = starts[tab.n_tensors];
  for (int chunk = blockIdx.x; chunk < n_chunks; chunk += gridDim.x) {
    // the last tensor whose first chunk is at or before this one (every
    // tensor has at least one chunk)
    int lo = 0, hi = tab.n_tensors - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (starts[mid] <= chunk) lo = mid; else hi = mid - 1;
    }
    float* const* ptr = tab.ptr[lo];
    const float b1p = *ptr[B1P], b2p = *ptr[B2P], lr = *ptr[LR];
    Coef c{tab.beta1, tab.beta2, tab.omb1, tab.omb2, tab.eps, 0.f};
    c.lr_t = __fdiv_rn(__fmul_rn(lr, __fsqrt_rn(__fsub_rn(1.f, __fmul_rn(b2p, c.beta2)))),
                       __fsub_rn(1.f, __fmul_rn(b1p, c.beta1)));
    const int local = chunk - starts[lo];
    if (local == 0 && threadIdx.x == 0) {
      *ptr[B1PO] = __fmul_rn(b1p, c.beta1);
      *ptr[B2PO] = __fmul_rn(b2p, c.beta2);
    }
    const int64_t begin = static_cast<int64_t>(local) * kChunk;
    const int64_t end = tab.n[lo] < begin + kChunk ? tab.n[lo] : begin + kChunk;
    const bool vec4 = tab.flags[lo] & kVec4;
    if (tab.flags[lo] & kFused) {
      adam_range<true>(c, ptr, begin, end, vec4);
    } else {
      adam_range<false>(c, ptr, begin, end, vec4);
    }
  }
}

template <int CAP>
int launch(const int64_t* ptrs, const int64_t* counts, const int32_t* flags,
           const int32_t* chunk_start, int n_tensors, float beta1, float beta2, float omb1,
           float omb2, float eps, cudaStream_t stream) {
  Table<CAP> tab;
  memcpy(tab.ptr, ptrs, sizeof(int64_t) * kPtrs * n_tensors);
  memcpy(tab.n, counts, sizeof(int64_t) * n_tensors);
  memcpy(tab.flags, flags, sizeof(int32_t) * n_tensors);
  memcpy(tab.chunk_start, chunk_start, sizeof(int32_t) * (n_tensors + 1));
  tab.n_tensors = n_tensors;
  tab.beta1 = beta1;
  tab.beta2 = beta2;
  tab.omb1 = omb1;
  tab.omb2 = omb2;
  tab.eps = eps;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_chunks = chunk_start[n_tensors];
  int blocks = sms * kBlocksPerSm;
  if (blocks > n_chunks) blocks = n_chunks;
  if (blocks < 1) blocks = 1;
  fused_adam_kernel<CAP><<<blocks, kThreads, 0, stream>>>(tab);
  return static_cast<int>(cudaGetLastError());
}

static_assert(sizeof(Table<kMaxTensors>) <= 32764, "the table must fit the kernel parameters");

}  // namespace

// One launch over n_tensors <= kMaxTensors tensors.  ptrs: kPtrs device
// pointers an entry (p, g, m1, m2, beta1_pow, beta2_pow, lr, then p', m1',
// m2' -- p, m1, m2 themselves to update in place, or other buffers -- and
// beta1_pow', beta2_pow', buffers apart from the inputs; float32);
// counts: elements an entry; flags: kFused | kVec4 (every big pointer
// 16-byte aligned); chunk_start: n_tensors + 1 chunk offsets.  The host arrays are copied
// into the kernel's parameter before this returns.  Launches on ``stream``
// and returns cudaGetLastError().
extern "C" int ptt_fused_adam_multi_f32(const int64_t* ptrs, const int64_t* counts,
                                        const int32_t* flags, const int32_t* chunk_start,
                                        int n_tensors, float beta1, float beta2, float omb1,
                                        float omb2, float eps, void* stream) {
  if (n_tensors < 1 || n_tensors > kMaxTensors)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_tensors <= kSmallTensors)
    return launch<kSmallTensors>(ptrs, counts, flags, chunk_start, n_tensors, beta1, beta2, omb1,
                                 omb2, eps, s);
  return launch<kMaxTensors>(ptrs, counts, flags, chunk_start, n_tensors, beta1, beta2, omb1,
                             omb2, eps, s);
}
