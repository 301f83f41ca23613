// Multi-tensor fused SGD update for Hopper (sm_90a), float32: one launch
// computes p' = p - lr * g for every parameter of a step.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/fused_optimizer.py::
// _sgd_kernel (launched by fused_sgd through _row_call).  Same function,
// element for element, for each tensor of the table.
//
// What changed from the TPU design: the TPU pads each flattened tensor to
// [rows, 128] (its (8, 128) tiling) and reads lr as a (1, 1) SMEM scalar,
// and XLA fuses a step's updates into one program.  Here the tensors stay
// flat and one launch takes them all, as csrc/fused_adam.cu does (its notes
// give the design): a __grid_constant__ table of pointers, element counts,
// flags and first chunks; a persistent grid walking fixed-size chunks; a
// binary search over the chunk prefix in shared memory.  Every chunk reads
// its tensor's lr from the device.
//
// In place: the host passes p as its own output (the port updates state in
// place, as the TPU executor's donated buffers are).  That is race-free:
// each element is loaded and stored by one thread, the load first, no
// pointer is __restrict__, and the only value a chunk shares with another,
// lr, is never written here.
//
// Bound: bytes.  Two tensors are read and one written, 12 bytes an
// element, for one fused multiply-add.  Streaming float4 loads and stores
// (__ldcs / __stcs), kUnroll float4s of each stream in flight a thread.
//
// Rounding: one rounding per element, __fmaf_rn(-lr, g, p), which is what
// the JAX package's kernel computes (XLA contracts p - lr * g into a fused
// multiply-add; its CPU interpret mode does).  The explicit intrinsic
// leaves nvcc no choice of contraction, and the plain PyTorch version
// emulates the single rounding exactly, so K5 is bit-equal to both.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;          // float4s of each stream in flight a thread
// tensors a launch (SGD_CAPACITY in ops/cuda/fused_optimizer.py): the table
// below is 24,584 bytes, inside the 32,764 bytes a kernel's parameters may take
constexpr int kMaxTensors = 512;
// floats a chunk and blocks of the persistent grid an SM, as in
// csrc/fused_adam.cu (CHUNK in ops/cuda/fused_optimizer.py)
constexpr int kChunk = 8192;
constexpr int kBlocksPerSm = 4;
// a smaller table for groups of at most this many: a table of one launches
// 3 us sooner through it on an H100 (tools/k56_sweep.py, one_table)
constexpr int kSmallTensors = 8;
constexpr int32_t kVec4 = 2;

enum { P, G, LR, PO, kPtrs };

template <int CAP>
struct Table {
  float* ptr[CAP][kPtrs];
  int64_t n[CAP];
  int32_t flags[CAP];
  int32_t chunk_start[CAP + 1];   // a tensor's first chunk; [n_tensors] = all chunks
  int32_t n_tensors;
};

// a streaming store: no byte written is read again by this kernel
__device__ __forceinline__ void store(float4* p, float4 v) { __stcs(p, v); }

__device__ __forceinline__ float4 sgd4(float lr, float4 p, float4 g) {
  return make_float4(__fmaf_rn(-lr, g.x, p.x), __fmaf_rn(-lr, g.y, p.y),
                     __fmaf_rn(-lr, g.z, p.z), __fmaf_rn(-lr, g.w, p.w));
}

template <int CAP>
__global__ void __launch_bounds__(kThreads)
fused_sgd_kernel(const __grid_constant__ Table<CAP> tab) {
  __shared__ int32_t starts[CAP + 1];
  for (int i = threadIdx.x; i <= tab.n_tensors; i += kThreads) starts[i] = tab.chunk_start[i];
  __syncthreads();
  const int n_chunks = starts[tab.n_tensors];
  for (int chunk = blockIdx.x; chunk < n_chunks; chunk += gridDim.x) {
    int lo = 0, hi = tab.n_tensors - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (starts[mid] <= chunk) lo = mid; else hi = mid - 1;
    }
    float* const* ptr = tab.ptr[lo];
    const float lr = *ptr[LR];
    const int64_t begin = static_cast<int64_t>(chunk - starts[lo]) * kChunk;
    const int64_t end = tab.n[lo] < begin + kChunk ? tab.n[lo] : begin + kChunk;
    const float* p = ptr[P] + begin;
    const float* g = ptr[G] + begin;
    float* po = ptr[PO] + begin;
    const int len = static_cast<int>(end - begin);
    const int n4 = (tab.flags[lo] & kVec4) ? len / 4 : 0;
    const float4* p4 = reinterpret_cast<const float4*>(p);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* po4 = reinterpret_cast<float4*>(po);
    for (int i = threadIdx.x; i < n4; i += kUnroll * kThreads) {
      float4 pv[kUnroll], gv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {    // every load issued before any use
        const int j = i + u * kThreads;
        if (j < n4) {
          pv[u] = __ldcs(p4 + j);
          gv[u] = __ldcs(g4 + j);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = i + u * kThreads;
        if (j < n4) store(po4 + j, sgd4(lr, pv[u], gv[u]));
      }
    }
    for (int i = 4 * n4 + threadIdx.x; i < len; i += kThreads) po[i] = __fmaf_rn(-lr, g[i], p[i]);
  }
}

template <int CAP>
int launch(const int64_t* ptrs, const int64_t* counts, const int32_t* flags,
           const int32_t* chunk_start, int n_tensors, cudaStream_t stream) {
  Table<CAP> tab;
  memcpy(tab.ptr, ptrs, sizeof(int64_t) * kPtrs * n_tensors);
  memcpy(tab.n, counts, sizeof(int64_t) * n_tensors);
  memcpy(tab.flags, flags, sizeof(int32_t) * n_tensors);
  memcpy(tab.chunk_start, chunk_start, sizeof(int32_t) * (n_tensors + 1));
  tab.n_tensors = n_tensors;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_chunks = chunk_start[n_tensors];
  int blocks = sms * kBlocksPerSm;
  if (blocks > n_chunks) blocks = n_chunks;
  if (blocks < 1) blocks = 1;
  fused_sgd_kernel<CAP><<<blocks, kThreads, 0, stream>>>(tab);
  return static_cast<int>(cudaGetLastError());
}

static_assert(sizeof(Table<kMaxTensors>) <= 32764, "the table must fit the kernel parameters");

}  // namespace

// One launch over n_tensors <= kMaxTensors tensors.  ptrs: kPtrs device
// pointers an entry (p, g, lr, then p': p itself to update in place, or
// another buffer; float32); counts: elements an entry; flags: kVec4 (p, g and p' 16-byte aligned);
// chunk_start: n_tensors + 1 chunk offsets.  The host arrays are copied
// into the kernel's parameter before this returns.  Launches on ``stream``
// and returns cudaGetLastError().
extern "C" int ptt_fused_sgd_multi_f32(const int64_t* ptrs, const int64_t* counts,
                                       const int32_t* flags, const int32_t* chunk_start,
                                       int n_tensors, void* stream) {
  if (n_tensors < 1 || n_tensors > kMaxTensors)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_tensors <= kSmallTensors)
    return launch<kSmallTensors>(ptrs, counts, flags, chunk_start, n_tensors, s);
  return launch<kMaxTensors>(ptrs, counts, flags, chunk_start, n_tensors, s);
}
