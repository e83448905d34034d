// K2 — in-place sparse row update (scatter-add), hand-written for Hopper.
//
// Replaces cafe_tpu/ops/pallas_apply.py: pallas_scatter_add (kernel body
// _apply_kernel), which the JAX package's ops/sparse.apply_rows selects
// for SGD into tables of >= 2^20 rows with dim % 128 == 0.
//
// Computes, in place: table[ids[k], :] += upd[k, :] for every lane k with
// 0 <= ids[k] < n_rows; other lanes are dropped. Duplicate ids sum across
// the whole batch. The TPU kernel combined in-tile duplicates with an
// equality matmul and relied on its sequential grid for cross-tile ones;
// on Hopper blocks run in parallel in no order, so every element is an
// f32 atomicAdd resolved in L2: duplicates in any blocks sum, in an order
// that changes from run to run (so the result matches a sequential sum to
// f32 rounding, scaled by the size of the largest duplicate group).
//
// Layout: one warp per lane (8 warps a block, grid-stride over lanes),
// the warp's 32 threads across the D columns, so a row's atomics are
// coalesced 128-byte segments at D = 128.
//
// Bound on the H100: memory. Bytes that must move: ids and updates read
// once (B*4 + B*D*4) and each touched row read and written once
// (2*U*D*4 for U distinct in-range ids), at 3.35 TB/s.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int64_t kMaxBlocks = 132 * 32;

__global__ void scatter_add_kernel(float* __restrict__ table,
                                   const int32_t* __restrict__ ids,
                                   const float* __restrict__ upd,
                                   int64_t lanes, int32_t dim,
                                   int64_t n_rows) {
  const int warp = threadIdx.x / 32;
  const int col0 = threadIdx.x % 32;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
       k < lanes; k += stride) {
    const int32_t id = ids[k];
    if (id < 0 || id >= n_rows) continue;  // dropped lane
    float* row = table + static_cast<int64_t>(id) * dim;
    const float* u = upd + k * dim;
    for (int c = col0; c < dim; c += 32) atomicAdd(row + c, u[c]);
  }
}

}  // namespace

extern "C" const char* cafe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// table [n_rows, dim] f32, ids [lanes] int32, upd [lanes, dim] f32, all
// contiguous on the stream's device. Returns cudaGetLastError().
extern "C" int scatter_add_launch(void* table, const void* ids,
                                  const void* upd, int64_t lanes,
                                  int32_t dim, int64_t n_rows,
                                  void* stream) {
  if (lanes > 0 && dim > 0) {
    int64_t blocks = (lanes + kWarps - 1) / kWarps;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    scatter_add_kernel<<<static_cast<int>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(table), static_cast<const int32_t*>(ids),
        static_cast<const float*>(upd), lanes, dim, n_rows);
  }
  return static_cast<int>(cudaGetLastError());
}
