// Embedding row gather for Hopper (sm_90a): out[n, :] = W[ids[n], :].
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/embedding.py::_gather_kernel
// (launched by gather_rows).  On the TPU, dynamic row gathers are slow, so
// that kernel multiplies a one-hot [block, vocab] matrix by the whole
// VMEM-resident table on the MXU.  On Hopper a gather is a plain row copy;
// the one-hot product would read the whole table for every block of ids.
//
// Bound: bytes.  There is no arithmetic: each id reads one table row and
// writes one output row.  Each thread moves 16 bytes per access (float4),
// and the 32 lanes of a warp cover 512 contiguous bytes of one row, so the
// table read and the output write are both fully coalesced.  One warp per
// row (8 rows per 256-thread block) keeps enough loads in flight to cover
// device-memory latency at the serving path's 2048 ids.
//
// Semantics: an id outside [0, V) gives a zero row -- what the Pallas
// kernel's one-hot product gives (no column matches).  The JAX package's
// composed path (jnp.take) differs there: NaN for id V, wrap-around for -1.
// The port follows the kernel.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;   // threads along a row
constexpr int kRows = 8;     // rows per block

template <typename T>
__device__ __forceinline__ T zero();

template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }

template <>
__device__ __forceinline__ float4 zero<float4>() { return make_float4(0.f, 0.f, 0.f, 0.f); }

// T is float4 when the row width is a multiple of 4 floats and the pointers
// are 16-byte aligned, float otherwise; ``dv`` is the row width in T units.
template <typename T>
__global__ void __launch_bounds__(kLanes * kRows)
gather_rows_kernel(const T* __restrict__ w, const int* __restrict__ ids,
                   T* __restrict__ out, int64_t n, int64_t v, int64_t dv) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRows + threadIdx.y;
  if (row >= n) return;
  const int id = ids[row];
  T* dst = out + row * dv;
  if (id < 0 || id >= v) {
    for (int64_t c = threadIdx.x; c < dv; c += kLanes) dst[c] = zero<T>();
    return;
  }
  const T* src = w + static_cast<int64_t>(id) * dv;
  for (int64_t c = threadIdx.x; c < dv; c += kLanes) dst[c] = __ldg(src + c);
}

}  // namespace

// w: [v, d] float32 row-major; ids: [n] int32; out: [n, d] float32.
// Launches on ``stream`` and returns cudaGetLastError().
extern "C" int ptt_gather_rows_f32(const float* w, const int* ids, float* out,
                                   int64_t n, int64_t v, int64_t d,
                                   void* stream) {
  if (n <= 0 || d <= 0) return static_cast<int>(cudaSuccess);
  const dim3 block(kLanes, kRows);
  const dim3 grid(static_cast<unsigned>((n + kRows - 1) / kRows));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = d % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec4) {
    gather_rows_kernel<float4><<<grid, block, 0, s>>>(
        reinterpret_cast<const float4*>(w), ids, reinterpret_cast<float4*>(out),
        n, v, d / 4);
  } else {
    gather_rows_kernel<float><<<grid, block, 0, s>>>(w, ids, out, n, v, d);
  }
  return static_cast<int>(cudaGetLastError());
}
