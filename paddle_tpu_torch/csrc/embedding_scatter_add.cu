// Embedding scatter-add for Hopper (sm_90a): the dense gradient of a row
// gather.  out = zeros(V, D); out[ids[n], :] += rows[n, :] for every n.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/embedding.py::
// _scatter_add_kernel (launched by scatter_add_rows).  On the TPU, dynamic
// scatters are slow, so that kernel walks vocab blocks and multiplies the
// transposed one-hot [N, block] mask by the incoming rows on the MXU: every
// block reads every row.  On Hopper a scatter-add is a row-wise atomic add.
//
// Bound: bytes.  The output table is written once (a memset) and each
// incoming row is read once and added once: (V*D + 2*N*D) * 4 bytes plus
// the ids.  One warp per incoming row, 32 lanes over consecutive columns,
// so the row read is coalesced and the atomics of a warp land on one
// contiguous 128-byte span of the output row (red.global.add.f32, resolved
// in L2).  Duplicated ids (the position table: every id repeats once per
// batch row) contend on the same addresses and serialize in L2.
//
// Determinism: float atomics add in the order the warps arrive, which
// varies run to run, so duplicated rows differ in the last bits between
// runs.  The plain version (index_add_) on the card does the same.  A
// sort-and-segment-sum design would be deterministic.
//
// Semantics: an id outside [0, V), -1 included, adds nothing -- what the
// Pallas kernel's one-hot product gives, and what the gather (K2) gives for
// the same id.  The JAX package's composed path (zeros.at[ids].add) wraps
// -1 onto the last row instead.  The port follows the kernel.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;  // threads along a row
constexpr int kRows = 8;    // incoming rows per block

__global__ void __launch_bounds__(kLanes * kRows)
scatter_add_rows_kernel(const int* __restrict__ ids, const float* __restrict__ rows,
                        float* __restrict__ out, int64_t n, int64_t v, int64_t d) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRows + threadIdx.y;
  if (row >= n) return;
  const int id = ids[row];
  if (id < 0 || id >= v) return;
  const float* src = rows + row * d;
  float* dst = out + static_cast<int64_t>(id) * d;
  for (int64_t c = threadIdx.x; c < d; c += kLanes) atomicAdd(dst + c, __ldg(src + c));
}

}  // namespace

// ids: [n] int32; rows: [n, d] float32; out: [v, d] float32, zeroed here.
// Launches a memset and the kernel on ``stream``; returns cudaGetLastError().
extern "C" int ptt_scatter_add_rows_f32(const int* ids, const float* rows, float* out,
                                        int64_t n, int64_t v, int64_t d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (v <= 0 || d <= 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = cudaMemsetAsync(out, 0, static_cast<size_t>(v * d) * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 block(kLanes, kRows);
  const dim3 grid(static_cast<unsigned>((n + kRows - 1) / kRows));
  scatter_add_rows_kernel<<<grid, block, 0, s>>>(ids, rows, out, n, v, d);
  return static_cast<int>(cudaGetLastError());
}
