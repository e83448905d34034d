// K3 — SGD sparse apply over sorted row keys, hand-written for Hopper.
//
// Replaces cafe_tpu/ops/pallas_rowsum.py: pallas_rowsum_t (kernel body
// _rowsum_kernel) behind sparse_add_dense, which the JAX package's
// ops/sparse.apply_rows selects for SGD under sparse_apply_impl='dense'.
//
// Computes, in place: table[key, :] += sum of upd[l, :] over the lanes l
// with keys[l] == key, for every key in [0, n_rows); other keys are
// dropped. The caller hands the keys sorted ascending and the updates
// permuted to match (a stable sort, so each run keeps its lanes' batch
// order).
//
// The TPU kernel accumulated a dense [D, N] sum in VMEM with one-hot MXU
// matmuls over 512-lane tiles, because the TPU has no fast scatter. On
// Hopper nothing carries over: one thread per (lane, channel); the
// thread of a run's first lane finds the run's end (a galloping then a
// binary search over the sorted keys), sums the run's updates in lane
// order starting from 0, and adds the sum to its row once. Every row
// has exactly one owner per channel, so there are no atomics and the
// result is deterministic: bit-equal run to run, and to a sequential
// sum-then-add. Long runs (Zipf-hot rows) serialise on one thread per
// channel; their loads are independent, so the loop pipelines them.
//
// Bound on the H100: memory. Bytes that must move: keys and updates read
// once (B*4 + B*D*4) and each touched row read and written once
// (2*U*D*4 for U distinct in-range keys), at 3.35 TB/s.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void rowsum_add_kernel(float* __restrict__ table,
                                  const int32_t* __restrict__ keys,
                                  const float* __restrict__ upd,
                                  int64_t lanes, int32_t dim,
                                  int64_t n_rows) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t >= lanes * dim) return;
  const int64_t k = t / dim;
  const int32_t c = static_cast<int32_t>(t - k * dim);
  const int32_t key = keys[k];
  if (key < 0 || key >= n_rows) return;        // dropped lane
  if (k > 0 && keys[k - 1] == key) return;     // not the run's first lane
  // end of the run: gallop until a probe leaves it, then bisect. Keys
  // are sorted, so keys[j] != key means keys[j] > key for j > k.
  int64_t lo = k + 1, hi = lanes, step = 1;
  while (true) {
    const int64_t p = k + step;
    if (p >= lanes) break;
    if (keys[p] != key) { hi = p; break; }
    lo = p + 1;
    step *= 2;
  }
  while (lo < hi) {
    const int64_t mid = lo + (hi - lo) / 2;
    if (keys[mid] == key) lo = mid + 1; else hi = mid;
  }
  const float* u = upd + k * dim + c;
  float sum = 0.0f;
#pragma unroll 8
  for (int64_t j = 0; j < lo - k; ++j) sum += u[j * dim];
  table[static_cast<int64_t>(key) * dim + c] += sum;
}

}  // namespace

extern "C" const char* cafe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// table [n_rows, dim] f32; keys [lanes] int32 sorted ascending; upd
// [lanes, dim] f32 in the keys' order; all contiguous on the stream's
// device. Returns cudaGetLastError().
extern "C" int rowsum_add_launch(void* table, const void* keys,
                                 const void* upd, int64_t lanes,
                                 int32_t dim, int64_t n_rows,
                                 void* stream) {
  if (lanes > 0 && dim > 0) {
    const int64_t blocks = (lanes * dim + kThreads - 1) / kThreads;
    rowsum_add_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(table), static_cast<const int32_t*>(keys),
        static_cast<const float*>(upd), lanes, dim, n_rows);
  }
  return static_cast<int>(cudaGetLastError());
}
