// K4 — row gather, hand-written for Hopper.
//
// Replaces cafe_tpu/ops/pallas_gather.py: pallas_gather (kernel body
// _gather_kernel), the TPU's deep queue of one-row DMAs that the JAX
// package keeps as the measurement baseline of its gather A/B
// (tools/ab_decisions.py decision 4) and the roofline tool.
//
// Computes: out[i, :] = table[ids[i], :] for i in [0, B), `tile` rows per
// block (B % tile == 0, checked by the wrapper as the TPU kernel asserts).
// A row copy is bit-exact for every dtype, so the kernel moves bytes.
//
// Design: one warp per row; each block's warps stride over its tile of
// rows; the 32 lanes of a warp copy one row in vectors of V (16, 4 or 1
// bytes, chosen by the wrapper from the row bytes, the row stride and
// both base pointers, so a view of a table need not be aligned). Byte
// offsets are 64-bit: a 2^22 x 128 f32 table ends exactly at 2^31 bytes.
// An id outside [0, n_rows) trips a device-side assert, as torch's own
// index kernels do: no clamp, no wrap, no silent zero.
//
// Bound on the H100: memory. Bytes that must move: B ids read, B rows
// read and B rows written, at 3.35 TB/s. Random rows are latency-bound
// transactions; this first version keeps one row per warp in flight and
// no TMA or cp.async pipeline (later work).

#include <cuda_runtime.h>
#include <cassert>
#include <cstdint>

namespace {

constexpr int kMaxWarps = 16;

template <typename V>
__global__ void gather_kernel(const char* __restrict__ table,
                              const int32_t* __restrict__ ids,
                              char* __restrict__ out, int64_t n_rows,
                              int64_t row_stride, int64_t row_bytes,
                              int32_t tile) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  const int64_t words = row_bytes / static_cast<int64_t>(sizeof(V));
  const int64_t first = static_cast<int64_t>(blockIdx.x) * tile;
  for (int r = warp; r < tile; r += n_warps) {
    const int64_t i = first + r;
    const int32_t id = ids[i];
    assert(id >= 0 && id < n_rows);
    const V* src =
        reinterpret_cast<const V*>(table + static_cast<int64_t>(id) *
                                               row_stride);
    V* dst = reinterpret_cast<V*>(out + i * row_bytes);
    for (int64_t w = lane; w < words; w += 32) dst[w] = src[w];
  }
}

template <typename V>
cudaError_t launch(const void* table, const void* ids, void* out,
                   int64_t n_ids, int64_t n_rows, int64_t row_stride,
                   int64_t row_bytes, int32_t tile, cudaStream_t s) {
  const int warps = tile < kMaxWarps ? tile : kMaxWarps;
  const int64_t blocks = n_ids / tile;
  gather_kernel<V><<<static_cast<unsigned>(blocks), warps * 32, 0, s>>>(
      static_cast<const char*>(table), static_cast<const int32_t*>(ids),
      static_cast<char*>(out), n_rows, row_stride, row_bytes, tile);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* cafe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// table: n_rows rows of row_bytes bytes, row_stride bytes apart; ids
// [n_ids] int32; out [n_ids, row_bytes] contiguous; n_ids % tile == 0;
// vec_bytes (16, 4 or 1) divides row_bytes, row_stride and both base
// addresses. Returns cudaGetLastError().
extern "C" int gather_launch(const void* table, const void* ids, void* out,
                             int64_t n_ids, int64_t n_rows,
                             int64_t row_stride, int64_t row_bytes,
                             int32_t tile, int32_t vec_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile <= 0 || n_ids % tile != 0 || row_bytes % vec_bytes != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_ids == 0 || row_bytes == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err;
  if (vec_bytes == 16) {
    err = launch<uint4>(table, ids, out, n_ids, n_rows, row_stride,
                        row_bytes, tile, s);
  } else if (vec_bytes == 4) {
    err = launch<uint32_t>(table, ids, out, n_ids, n_rows, row_stride,
                           row_bytes, tile, s);
  } else if (vec_bytes == 1) {
    err = launch<uint8_t>(table, ids, out, n_ids, n_rows, row_stride,
                          row_bytes, tile, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
