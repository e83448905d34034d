// K3 — SGD sparse apply as a tiled, deterministic segmented row sum,
// hand-written for Hopper.
//
// Replaces cafe_tpu/ops/pallas_rowsum.py: pallas_rowsum_t (kernel body
// _rowsum_kernel) behind sparse_add_dense, which the JAX package's
// ops/sparse.apply_rows selects for SGD under sparse_apply_impl='dense'.
//
// Computes, in place: table[r, :] += sum of upd[l, :] over the lanes l
// with idx[l] == r, for every r in [0, n_rows); lanes with idx outside
// [0, n_rows), negative ones included, are dropped.
//
// The TPU kernel accumulated a dense [D, N] sum in VMEM with one-hot MXU
// matmuls over 512-lane tiles, because the TPU has no fast scatter. None
// of that carries over. One C entry runs four stages on the caller's
// stream:
//
//   1. prep: key = idx where 0 <= idx < n_rows, else n_rows (uint32), and
//      the lane index as the payload (int32);
//   2. a stable radix sort of (key, lane) over the low bit_length(n_rows)
//      bits only (CUB's DeviceRadixSort from the toolkit; the JAX package
//      sorts outside its kernel too, with jnp.argsort);
//   3. the ported kernel: each block takes a tile of kTile consecutive
//      sorted lanes, reads upd[perm[l], :] straight from the unsorted
//      updates (no permuted copy; a row's D floats are contiguous) and
//      reduces each run of equal keys inside the tile in a fixed order: a
//      segmented shuffle tree inside each warp, then the warps' totals in
//      warp order through shared memory. A run wholly inside the tile is
//      added to its row once, by the thread of its last lane. A run that
//      crosses the tile's start writes its partial sum to the tile's head
//      carry; one that starts in the tile and crosses its end, to the
//      tile's tail carry;
//   4. fix-up: for each run that crosses tiles, the block of the tile
//      holding its head adds its tail carry and the head carries of the
//      following tiles, in tile order, to the row once. The block stages
//      those carries through shared memory, so its loads run in parallel
//      and only the adds of each channel are serial.
//
// Every row has one owner, there are no atomics, and every sum is taken
// in an order fixed by the tile, the tree and the tile order, so two
// launches on one input are bit-equal. A block's time no longer depends
// on how long a run is: a run of 50,000 lanes is 200 tiles' worth of
// ordinary work plus one fix-up walk over 200 carries.
//
// Bound on the H100: memory. Bytes that must move: ids and updates read
// once (B*4 + B*D*4) and each touched row read and written once
// (2*U*D*4 for U distinct in-range keys), at 3.35 TB/s.

// CUB's kernels get a namespace of their own, so a trace tells them from
// the radix sorts that PyTorch runs elsewhere in the step.
#define CUB_WRAPPED_NAMESPACE cafe_rowsum
#include <cub/device/device_radix_sort.cuh>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kTile = 256;            // sorted lanes a block of stage 3
constexpr int kWarps = kTile / 32;
constexpr int kPrepThreads = 256;
constexpr int kFixThreads = 128;
constexpr int kStage = 4096;         // floats of carries a fix-up chunk
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__global__ void rowsum_prep_kernel(const T* __restrict__ idx,
                                   uint32_t* __restrict__ keys,
                                   int32_t* __restrict__ lanes_out,
                                   int64_t lanes, int64_t n_rows) {
  const int64_t l = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (l >= lanes) return;
  const T v = idx[l];
  keys[l] = static_cast<uint32_t>((v >= 0 && v < n_rows) ? v : n_rows);
  lanes_out[l] = static_cast<int32_t>(l);
}

template <int V>
struct Vec {
  float x[V];
};

template <int V>
__device__ __forceinline__ Vec<V> load_vec(const float* p) {
  Vec<V> r;
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    r.x[0] = q.x; r.x[1] = q.y; r.x[2] = q.z; r.x[3] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) r.x[i] = p[i];
  }
  return r;
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const Vec<V>& v) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v.x[0], v.x[1], v.x[2],
                                                v.x[3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = v.x[i];
  }
}

// Stage 3. carry is [tiles, 2, dim]: [t][0] the head carry of tile t,
// [t][1] its tail carry. V floats a thread a step (4 where the rows
// allow 16-byte accesses).
template <int V>
__global__ void __launch_bounds__(kTile) rowsum_tile_kernel(
    float* __restrict__ table, const uint32_t* __restrict__ keys,
    const int32_t* __restrict__ perm, const float* __restrict__ upd,
    float* __restrict__ carry, int64_t lanes, int32_t dim,
    uint32_t n_rows) {
  __shared__ int head_of_warp[kWarps];
  __shared__ float total_of_warp[kWarps][V];
  const int tid = threadIdx.x, warp = tid / 32, wl = tid % 32;
  const int64_t t = blockIdx.x;
  const int64_t s = t * kTile;
  const int64_t e = s + kTile < lanes ? s + kTile : lanes;
  const int64_t l = s + tid;
  const bool live = l < e;
  const uint32_t key = live ? keys[l] : 0u;
  // a segment of the scan starts at each run's first lane and at the
  // tile's first lane; lanes past the tile's end are segments of their own
  const bool head = !live || tid == 0 || keys[l - 1] != key;
  const bool last = live && (l == e - 1 || keys[l + 1] != key);
  const uint32_t first_key = keys[s];
  const bool cont_in = live && s > 0 && key == first_key &&
                       keys[s - 1] == first_key;
  const bool cont_out = live && l == e - 1 && e < lanes && keys[e] == key;
  const int64_t row = live ? perm[l] : 0;

  // hs: the tile lane where this lane's segment starts (a max-scan)
  int hs = head ? tid : -1;
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int up = __shfl_up_sync(kFull, hs, d);
    if (wl >= d && up > hs) hs = up;
  }
  if (wl == 31) head_of_warp[warp] = hs;
  __syncthreads();
  for (int w = 0; w < warp; ++w)
    if (head_of_warp[w] > hs) hs = head_of_warp[w];
  const int hs_in_warp = hs - warp * 32;   // < 0: starts in an earlier warp

  const float* src = upd + row * dim;
  for (int c = 0; c < dim; c += V) {
    Vec<V> v;
    if (live) {
      v = load_vec<V>(src + c);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) v.x[i] = 0.0f;
    }
    // segmented inclusive scan in the warp: add lane wl-d's partial sum
    // while that lane lies in this lane's segment
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float up = __shfl_up_sync(kFull, v.x[i], d);
        if (wl >= d && wl - d >= hs_in_warp) v.x[i] = up + v.x[i];
      }
    }
    if (wl == 31) {
#pragma unroll
      for (int i = 0; i < V; ++i) total_of_warp[warp][i] = v.x[i];
    }
    __syncthreads();
    if (last && key < n_rows) {
      if (hs_in_warp < 0) {
        // the segment began in warp hs / 32: that warp's total from hs
        // on, then whole warps, in warp order, then this warp's part
        Vec<V> p;
#pragma unroll
        for (int i = 0; i < V; ++i) p.x[i] = total_of_warp[hs / 32][i];
        for (int w = hs / 32 + 1; w < warp; ++w) {
#pragma unroll
          for (int i = 0; i < V; ++i) p.x[i] = p.x[i] + total_of_warp[w][i];
        }
#pragma unroll
        for (int i = 0; i < V; ++i) v.x[i] = p.x[i] + v.x[i];
      }
      if (cont_in) {
        store_vec<V>(carry + (t * 2) * dim + c, v);
      } else if (cont_out) {
        store_vec<V>(carry + (t * 2 + 1) * dim + c, v);
      } else {
        float* dst = table + static_cast<int64_t>(key) * dim + c;
        Vec<V> cur = load_vec<V>(dst);
#pragma unroll
        for (int i = 0; i < V; ++i) cur.x[i] = cur.x[i] + v.x[i];
        store_vec<V>(dst, cur);
      }
    }
    __syncthreads();   // total_of_warp is rewritten by the next step
  }
}

// Stage 4: one block a tile; only the tile holding the head of a kept
// run that crosses its end does any work.
__global__ void __launch_bounds__(kFixThreads) rowsum_fixup_kernel(
    float* __restrict__ table, const uint32_t* __restrict__ keys,
    const float* __restrict__ carry, int64_t lanes, int32_t dim,
    uint32_t n_rows, int64_t tiles) {
  const int64_t t = blockIdx.x;
  const int64_t s = t * kTile;
  const int64_t e = s + kTile;
  if (e >= lanes) return;                       // no lane after this tile
  const uint32_t key = keys[e - 1];
  if (key >= n_rows || keys[e] != key) return;  // no kept run crosses e
  if (t > 0 && keys[s - 1] == key) return;      // head in an earlier tile
  // the following tiles whose first lane continues the run: a prefix of
  // them, since the keys are sorted; counted blockDim tiles at a time
  int64_t m = 0;
  for (int64_t base = t + 1; base < tiles; base += blockDim.x) {
    const int64_t j = base + threadIdx.x;
    const int n = __syncthreads_count(j < tiles && keys[j * kTile] == key);
    m += n;
    if (n < static_cast<int>(blockDim.x)) break;
  }
  // the head carries of those tiles, staged through shared memory a
  // chunk at a time by the whole block and summed per channel in tile
  // order: blockDim channels at a time
  __shared__ float stage[kStage];
  for (int c0 = 0; c0 < dim; c0 += blockDim.x) {
    const int width = min(static_cast<int>(blockDim.x), dim - c0);
    const int per = kStage / width;   // tiles a chunk
    const bool mine = static_cast<int>(threadIdx.x) < width;
    const int64_t c = c0 + threadIdx.x;
    float sum = mine ? carry[(t * 2 + 1) * dim + c] : 0.0f;
    for (int64_t j0 = t + 1; j0 <= t + m; j0 += per) {
      const int64_t left = t + m + 1 - j0;
      const int k = left < per ? static_cast<int>(left) : per;
      __syncthreads();  // the previous chunk has been summed
#pragma unroll 8
      for (int i = threadIdx.x; i < k * width; i += blockDim.x)
        stage[i] = carry[((j0 + i / width) * 2) * dim + c0 + i % width];
      __syncthreads();
      if (mine) {
#pragma unroll 8
        for (int q = 0; q < k; ++q) sum += stage[q * width + threadIdx.x];
      }
    }
    if (mine) {
      float* dst = table + static_cast<int64_t>(key) * dim + c;
      *dst = *dst + sum;
    }
  }
}

constexpr size_t kAlign = 256;

size_t align_up(size_t x) { return (x + kAlign - 1) / kAlign * kAlign; }

// bits that hold every key in [0, n_rows]
int key_bits(int64_t n_rows) {
  int b = 0;
  while ((int64_t{1} << b) <= n_rows) ++b;
  return b;
}

// The workspace: keys and lanes before and after the sort, the carries
// and CUB's temp storage (from `temp` to the end), each 256-byte aligned.
struct Layout {
  size_t keys_in, keys_out, perm_in, perm_out, carry, temp;
};

Layout layout(int64_t lanes, int32_t dim) {
  const size_t b = static_cast<size_t>(lanes);
  const size_t tiles = (b + kTile - 1) / kTile;
  Layout L;
  L.keys_in = 0;
  L.keys_out = L.keys_in + align_up(b * 4);
  L.perm_in = L.keys_out + align_up(b * 4);
  L.perm_out = L.perm_in + align_up(b * 4);
  L.carry = L.perm_out + align_up(b * 4);
  L.temp = L.carry + align_up(tiles * 2 * static_cast<size_t>(dim) * 4);
  return L;
}

// CUB's sort: a size query when temp is null, else the sort itself
cudaError_t sort_pairs(void* temp, size_t& temp_bytes, const uint32_t* keys_in,
                       uint32_t* keys_out, const int32_t* perm_in,
                       int32_t* perm_out, int64_t lanes, int64_t n_rows,
                       cudaStream_t stream) {
  return cafe_rowsum::cub::DeviceRadixSort::SortPairs(
      temp, temp_bytes, keys_in, keys_out, perm_in, perm_out,
      static_cast<int>(lanes), 0, key_bits(n_rows), stream);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

bool nothing_to_do(int64_t lanes, int32_t dim, int64_t n_rows) {
  return lanes <= 0 || dim <= 0 || n_rows <= 0;
}

bool out_of_range(int64_t lanes, int64_t n_rows) {
  return lanes > INT32_MAX || n_rows >= INT32_MAX;
}

}  // namespace

extern "C" const char* cafe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Bytes of workspace rowsum_add_launch needs for this shape (0 when there
// is nothing to do), written to *out.
extern "C" int rowsum_workspace_bytes(int64_t lanes, int32_t dim,
                                      int64_t n_rows, int64_t* out) {
  *out = 0;
  if (nothing_to_do(lanes, dim, n_rows)) return 0;
  if (out_of_range(lanes, n_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  size_t temp_bytes = 0;
  const cudaError_t err = sort_pairs(nullptr, temp_bytes, nullptr, nullptr,
                                     nullptr, nullptr, lanes, n_rows, 0);
  *out = static_cast<int64_t>(layout(lanes, dim).temp + align_up(temp_bytes));
  return static_cast<int>(err);
}

// table [n_rows, dim] f32, updated in place; idx [lanes] int32 or int64
// (idx_bytes 4 or 8); upd [lanes, dim] f32; ws a 256-byte aligned
// workspace of at least rowsum_workspace_bytes; all contiguous on the
// stream's device. Runs all four stages; returns the first CUDA error.
extern "C" int rowsum_add_launch(void* table, const void* idx, int idx_bytes,
                                 const void* upd, int64_t lanes, int32_t dim,
                                 int64_t n_rows, void* ws, int64_t ws_bytes,
                                 void* stream) {
  if (nothing_to_do(lanes, dim, n_rows))
    return static_cast<int>(cudaGetLastError());
  if (out_of_range(lanes, n_rows) || (idx_bytes != 4 && idx_bytes != 8) ||
      (reinterpret_cast<uintptr_t>(ws) % kAlign) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout L = layout(lanes, dim);
  if (ws_bytes <= static_cast<int64_t>(L.temp))
    return static_cast<int>(cudaErrorInvalidValue);
  char* base = static_cast<char*>(ws);
  uint32_t* keys_in = reinterpret_cast<uint32_t*>(base + L.keys_in);
  uint32_t* keys = reinterpret_cast<uint32_t*>(base + L.keys_out);
  int32_t* perm_in = reinterpret_cast<int32_t*>(base + L.perm_in);
  int32_t* perm = reinterpret_cast<int32_t*>(base + L.perm_out);
  float* carry = reinterpret_cast<float*>(base + L.carry);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);

  const unsigned prep_blocks =
      static_cast<unsigned>((lanes + kPrepThreads - 1) / kPrepThreads);
  if (idx_bytes == 4)
    rowsum_prep_kernel<int32_t><<<prep_blocks, kPrepThreads, 0, st>>>(
        static_cast<const int32_t*>(idx), keys_in, perm_in, lanes, n_rows);
  else
    rowsum_prep_kernel<int64_t><<<prep_blocks, kPrepThreads, 0, st>>>(
        static_cast<const int64_t*>(idx), keys_in, perm_in, lanes, n_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // CUB refuses (cudaErrorInvalidValue) temp storage below its need
  size_t temp_bytes = static_cast<size_t>(ws_bytes) - L.temp;
  err = sort_pairs(base + L.temp, temp_bytes, keys_in, keys, perm_in, perm,
                   lanes, n_rows, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int64_t tiles = (lanes + kTile - 1) / kTile;
  float* tab = static_cast<float*>(table);
  const float* u = static_cast<const float*>(upd);
  const uint32_t n = static_cast<uint32_t>(n_rows);
  if (dim % 4 == 0 && aligned16(tab) && aligned16(u))
    rowsum_tile_kernel<4><<<static_cast<unsigned>(tiles), kTile, 0, st>>>(
        tab, keys, perm, u, carry, lanes, dim, n);
  else
    rowsum_tile_kernel<1><<<static_cast<unsigned>(tiles), kTile, 0, st>>>(
        tab, keys, perm, u, carry, lanes, dim, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tiles > 1)
    rowsum_fixup_kernel<<<static_cast<unsigned>(tiles), kFixThreads, 0,
                          st>>>(tab, keys, carry, lanes, dim, n, tiles);
  return static_cast<int>(cudaGetLastError());
}
