// K1 — the sketch insert's landing reduction, hand-written for Hopper.
//
// Replaces cafe_tpu/ops/pallas_land.py: pallas_land_max_t (kernel body
// _land_kernel), which the JAX package dispatches from
// ops/sorted_update.land_max for impl 'auto' / 'pallas'.
//
// Computes: out[r, c] = max over lanes l with keys[l] == r of enc[l, c],
// -1 where no lane writes (enc >= -1, so -1 is the neutral element).
// Keys outside [0, n_rows) are dropped. Keys must ascend, as the JAX
// kernel's contract says (the sketch insert lands its bucket-sorted
// lanes); each block checks a share of the neighbouring pairs and trips a
// device-side assert on a descent, as torch's index kernels do, so an
// unsorted input never lands silently wrong.
//
// Design: row-owner tiles, one launch, no global atomics. Block b owns
// output rows [b*R, b*R + R), R chosen from the row count and the SM
// count so that the grid is about four blocks an SM where the rows allow:
//   1. its tile of R x C int32 in shared memory starts at -1;
//   2. the block finds its lanes [lo, hi), the lower bounds of its first
//      row and of the next block's in the sorted keys: one warp each, a
//      32-way search (four rounds at 53,248 lanes, a ballot a round and
//      no block barrier) while the other warps fill the tile;
//   3. all threads walk those lanes, kLanes adjacent lanes a thread a
//      round, loading each lane's key and its channels together. A
//      thread first folds its own lanes of one key; a warp whose lanes
//      all hold one key (the inside of a hot run: the keys ascend) then
//      reduces each channel with one __reduce_max_sync and does one
//      shared atomicMax, and in any other warp each of a thread's runs
//      does its own. So a hot bucket of thousands of lanes costs one
//      shared atomic per 128 lanes and spreads over the whole block, and
//      a warp that holds no lane skips the round;
//   4. the block stores its tile with coalesced 16-byte stores: every
//      output element is written exactly once, and rows no lane reaches
//      get -1 in the same pass.
// Blocks share nothing, so there is no carry and no fix-up, the result
// is the same bit for bit on every launch, and a call can be captured in
// a CUDA graph. (A warp-wide match, or a reduction with per-key masks,
// would serialise over the distinct keys of a warp; a shuffle scan costs
// every warp 5 shuffles a channel.) No payload encoding is needed (the
// TPU kernel's q = enc + 1), and there is no row or lane cap (the TPU's
// caps came from VMEM).
//
// Bound on the H100: memory. Each input byte is read once and each
// output byte written once: (B*C + B + n_rows*C) * 4 bytes at 3.35 TB/s.
// At the headline shape (53,248 lanes into 9,646 rows) that is 0.44 us,
// below a launch, and a block's time is latency: the search, one round
// of lane loads, the store. At the sibling shape (1.5M rows) the output
// store is nearly all of it; the output (30.9 MB) is larger than the
// SMs' shared memory, so the tiles take a second, short wave.

#include <cuda_runtime.h>
#include <cassert>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;
constexpr int kLanes = 4;             // adjacent lanes a thread a round
constexpr int kMaxTileBytes = 48 * 1024;
constexpr int kMaxDevices = 64;

// The lower bound of `target` in keys[0, lanes): the first position with
// key >= target, found by one warp with a 32-way search (32 samples a
// round, a ballot, no block barrier; 4 rounds at 53,248 lanes). The
// first rounds sample the same keys in every block, so the blocks of an
// SM share them in L1. Every lane of the warp returns the answer. The
// block barriers of a block-wide search would wait each round for the
// slowest warp's load.
__device__ int64_t warp_lower_bound(const int32_t* __restrict__ keys,
                                    int64_t lanes, int64_t target) {
  const int lane = threadIdx.x & 31;
  int64_t lo = 0, hi = lanes;   // the answer lies in [lo, hi]
  while (lo < hi) {             // warp-uniform
    const int64_t step = (hi - lo + 31) >> 5;
    const int64_t p = lo + lane * step;
    const bool below = p < hi && keys[p] < target;
    const int c = __popc(__ballot_sync(0xffffffffu, below));
    // samples 0..c-1 lie below the target, sample c (if any) does not
    if (c == 0) return lo;
    const int64_t first = lo + (c - 1) * step + 1;
    if (step == 1) return first;
    const int64_t last = lo + c * step;
    lo = first;
    hi = last < hi ? last : hi;
  }
  return lo;
}

template <int CB>   // channels loaded together (CB >= channels, or a batch)
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
land_max_kernel(const int32_t* __restrict__ enc,
                const int32_t* __restrict__ keys, int32_t* __restrict__ out,
                int64_t lanes, int32_t channels, int32_t n_rows,
                int32_t rows_per_block, int64_t check_per_block) {
  extern __shared__ __align__(16) int32_t tile[];
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  int64_t r1 = r0 + rows_per_block;
  if (r1 > n_rows) r1 = n_rows;
  if (r1 < r0) r1 = r0;
  const int n_tile = static_cast<int>(r1 - r0) * channels;

  // this block's share of the order check, pairs (i, i + 1): the first
  // pair a thread is loaded now and checked at the end
  const int64_t pairs = lanes - 1;
  const int64_t c_begin = check_per_block * blockIdx.x;
  const int64_t c_end = c_begin + check_per_block < pairs
                            ? c_begin + check_per_block : pairs;
  const int64_t ci = c_begin + threadIdx.x;
  int32_t ka = 0, kb = 0;
  if (ci < c_end) {
    ka = keys[ci];
    kb = keys[ci + 1];
  }

  const int n_vec = n_tile / 4;   // the tile and dst are 16-byte aligned
  int4* tile4 = reinterpret_cast<int4*>(tile);
  for (int i = threadIdx.x; i < n_vec; i += kThreads) {
    tile4[i] = make_int4(-1, -1, -1, -1);
  }
  for (int i = n_vec * 4 + threadIdx.x; i < n_tile; i += kThreads) {
    tile[i] = -1;
  }
  // warp 0 finds the block's first lane, warp 1 its end, while the
  // other warps fill the tile
  __shared__ int64_t bounds[2];
  if (threadIdx.x < 64) {
    const int64_t b = warp_lower_bound(keys, lanes, threadIdx.x < 32 ? r0
                                                                      : r1);
    if ((threadIdx.x & 31) == 0) bounds[threadIdx.x >> 5] = b;
  }
  __syncthreads();
  const int64_t lo = bounds[0], hi = bounds[1];

  const int lane_id = threadIdx.x & 31;
  const int64_t warp_first = (threadIdx.x & ~31) * kLanes;
  for (int64_t base = lo; base < hi; base += kThreads * kLanes) {
    if (base + warp_first >= hi) continue;   // warp-uniform: no lane here
    const int64_t l0 = base + threadIdx.x * kLanes;
    int32_t key[kLanes];
    int32_t v[kLanes][CB];
    // the keys and the first channels load together: one round of loads
#pragma unroll
    for (int u = 0; u < kLanes; ++u) {
      key[u] = l0 + u < hi ? keys[l0 + u] : -1;   // -1: no lane (keys >= r0)
#pragma unroll
      for (int j = 0; j < CB; ++j) {
        v[u][j] = l0 + u < hi && j < channels ? enc[(l0 + u) * channels + j]
                                              : -1;
      }
    }
    // every lane of the warp holds one key: the inside of a hot run
    const int32_t k0 = __shfl_sync(0xffffffffu, key[0], 0);
    const bool one_key =
        __all_sync(0xffffffffu, key[0] == k0 && key[kLanes - 1] == k0);
    for (int c0 = 0; c0 < channels; c0 += CB) {
      if (c0 > 0) {
#pragma unroll
        for (int u = 0; u < kLanes; ++u) {
#pragma unroll
          for (int j = 0; j < CB; ++j) {
            v[u][j] = l0 + u < hi && c0 + j < channels
                          ? enc[(l0 + u) * channels + c0 + j] : -1;
          }
        }
      }
      // the thread's own runs: each run's last lane takes the run's max
#pragma unroll
      for (int u = 1; u < kLanes; ++u) {
        if (key[u] == key[u - 1]) {
#pragma unroll
          for (int j = 0; j < CB; ++j) v[u][j] = max(v[u][j], v[u - 1][j]);
        }
      }
      if (one_key) {
#pragma unroll
        for (int j = 0; j < CB; ++j) {
          const int32_t m = __reduce_max_sync(0xffffffffu, v[kLanes - 1][j]);
          if (lane_id == 0 && c0 + j < channels && m >= 0) {
            atomicMax(tile + (k0 - r0) * channels + c0 + j, m);
          }
        }
      } else {
#pragma unroll
        for (int u = 0; u < kLanes; ++u) {
          if (key[u] < 0 || (u + 1 < kLanes && key[u + 1] == key[u])) {
            continue;
          }
          int32_t* row = tile + (key[u] - r0) * channels + c0;
#pragma unroll
          for (int j = 0; j < CB; ++j) {
            if (c0 + j < channels && v[u][j] >= 0) atomicMax(row + j, v[u][j]);
          }
        }
      }
    }
  }
  __syncthreads();

  // dst is 16-byte aligned: R*C % 4 == 0
  int32_t* dst = out + r0 * channels;
  int4* dst4 = reinterpret_cast<int4*>(dst);
  for (int i = threadIdx.x; i < n_vec; i += kThreads) dst4[i] = tile4[i];
  for (int i = n_vec * 4 + threadIdx.x; i < n_tile; i += kThreads) {
    dst[i] = tile[i];
  }

  assert(ci >= c_end || ka <= kb);
  for (int64_t i = ci + kThreads; i < c_end; i += kThreads) {
    assert(keys[i] <= keys[i + 1]);
  }
}

int sm_count() {
  static int cached[kMaxDevices] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 132;
  if (dev < 0 || dev >= kMaxDevices) dev = 0;
  if (cached[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    cached[dev] = n > 0 ? n : 132;
  }
  return cached[dev];
}

template <int CB>
cudaError_t launch(const int32_t* enc, const int32_t* keys, int32_t* out,
                   int64_t lanes, int32_t channels, int32_t n_rows,
                   int32_t rows, unsigned blocks, size_t smem,
                   cudaStream_t s) {
  // pairs (i, i + 1) each block checks: divided here, not on the card
  const int64_t per = lanes > 1 ? (lanes - 1 + blocks - 1) / blocks : 0;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        land_max_kernel<CB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  land_max_kernel<CB><<<blocks, kThreads, smem, s>>>(enc, keys, out, lanes,
                                                     channels, n_rows, rows,
                                                     per);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* cafe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Rows a block owns: about kBlocksPerSm blocks an SM where the rows
// allow, a multiple of 4 (so each block's first element is 16-byte
// aligned), and a tile of at most 48 KB of shared memory (at least 4
// rows). Exposed so the tests can place runs at the tile edges.
extern "C" int32_t land_rows_per_block(int32_t n_rows, int32_t channels) {
  const int64_t blocks = static_cast<int64_t>(kBlocksPerSm) * sm_count();
  int64_t r = (static_cast<int64_t>(n_rows) + blocks - 1) / blocks;
  r = (r + 3) / 4 * 4;
  int64_t cap = kMaxTileBytes / (4 * static_cast<int64_t>(channels > 0
                                                            ? channels : 1));
  cap = cap / 4 * 4;
  if (r > cap) r = cap;
  if (r < 4) r = 4;
  return static_cast<int32_t>(r);
}

// enc [lanes, channels] int32, keys [lanes] int32 ascending, out [n_rows,
// channels] int32 (16-byte aligned), all contiguous on the stream's
// device. One launch, or none when there is nothing to write or check.
// Returns cudaGetLastError().
extern "C" int land_max_launch(const void* enc, const void* keys, void* out,
                               int64_t lanes, int32_t channels,
                               int32_t n_rows, void* stream) {
  if (lanes < 0 || channels < 0 || n_rows < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n_out = static_cast<int64_t>(n_rows) * channels;
  if (n_out == 0 && lanes < 2) return static_cast<int>(cudaGetLastError());
  const int32_t rows = land_rows_per_block(n_rows, channels);
  const int64_t blocks = n_out > 0 ? (static_cast<int64_t>(n_rows) + rows -
                                      1) / rows
                                   : 1;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = n_out > 0 ? static_cast<size_t>(rows) * channels * 4
                                : 0;
  const auto* e = static_cast<const int32_t*>(enc);
  const auto* k = static_cast<const int32_t*>(keys);
  auto* o = static_cast<int32_t*>(out);
  const auto b = static_cast<unsigned>(blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the channels a thread loads together: 4 for up to 4, all 5 of the
  // sketch's packed landing (cells + 1), else batches of 8 (its
  // two-channel landing has 2 * cells)
  cudaError_t err;
  if (channels <= 4) {
    err = launch<4>(e, k, o, lanes, channels, n_rows, rows, b, smem, s);
  } else if (channels == 5) {
    err = launch<5>(e, k, o, lanes, channels, n_rows, rows, b, smem, s);
  } else {
    err = launch<8>(e, k, o, lanes, channels, n_rows, rows, b, smem, s);
  }
  return static_cast<int>(err);
}
