// K1 — the sketch insert's landing reduction, hand-written for Hopper.
//
// Replaces cafe_tpu/ops/pallas_land.py: pallas_land_max_t (kernel body
// _land_kernel), which the JAX package dispatches from
// ops/sorted_update.land_max for impl 'auto' / 'pallas'.
//
// Computes: out[r, c] = max over lanes l with keys[l] == r of enc[l, c],
// -1 where no lane writes (enc >= -1, so -1 is the neutral element).
// Keys outside [0, n_rows) are dropped. The TPU kernel needed a lane
// rotate scan and an MXU one-hot matmul over 16-bit halves because the
// TPU has no fast integer scatter; Hopper has atomicMax on int32 in L2,
// so the design is two plain passes:
//   1. fill out [n_rows, C] with -1;
//   2. one thread per (lane, channel) with a payload >= 0 and an
//      in-range key does atomicMax on its destination.
// Integer max is order-free, so the result is bit-exact and
// deterministic whatever order the atomics land in. No payload encoding
// is needed (the TPU kernel's q = enc + 1), so any int32 >= -1 is valid
// and there is no row or lane cap (the TPU's caps came from VMEM).
//
// Bound on the H100: memory. Each input byte is read once and each
// output byte written once: (B*C + B + n_rows*C) * 4 bytes at 3.35 TB/s;
// the atomics resolve in L2. The sort order of the keys is not exploited
// (segment-end lanes or warp reductions would cut the atomics): later
// work.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;

int blocks_for(int64_t n) {
  int64_t b = (n + kThreads - 1) / kThreads;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return b < 1 ? 1 : static_cast<int>(b);
}

__global__ void fill_kernel(int32_t* __restrict__ out, int64_t n,
                            int32_t value) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    out[i] = value;
  }
}

__global__ void land_max_kernel(const int32_t* __restrict__ enc,
                                const int32_t* __restrict__ keys,
                                int32_t* __restrict__ out, int64_t lanes,
                                int32_t channels, int32_t n_rows) {
  const int64_t total = lanes * channels;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < total; i += stride) {
    const int32_t v = enc[i];
    if (v < 0) continue;  // -1 = no writer: the fill already holds it
    const int64_t lane = i / channels;
    const int32_t key = keys[lane];
    if (key < 0 || key >= n_rows) continue;  // dropped lane
    atomicMax(out + static_cast<int64_t>(key) * channels +
                  (i - lane * channels),
              v);
  }
}

}  // namespace

extern "C" const char* cafe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// enc [lanes, channels] int32, keys [lanes] int32, out [n_rows, channels]
// int32, all contiguous on the stream's device. Returns cudaGetLastError().
extern "C" int land_max_launch(const void* enc, const void* keys, void* out,
                               int64_t lanes, int32_t channels,
                               int32_t n_rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n_out = static_cast<int64_t>(n_rows) * channels;
  if (n_out > 0) {
    fill_kernel<<<blocks_for(n_out), kThreads, 0, s>>>(
        static_cast<int32_t*>(out), n_out, -1);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t total = lanes * channels;
  if (total > 0 && n_out > 0) {
    land_max_kernel<<<blocks_for(total), kThreads, 0, s>>>(
        static_cast<const int32_t*>(enc), static_cast<const int32_t*>(keys),
        static_cast<int32_t*>(out), lanes, channels, n_rows);
  }
  return static_cast<int>(cudaGetLastError());
}
