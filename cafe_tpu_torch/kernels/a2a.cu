// K5 — all-to-all over the mesh by peer writes, hand-written for Hopper.
//
// Replaces cafe_tpu/ops/pallas_a2a.py: a2a_shard (kernel body
// _a2a_kernel), which the JAX package's --shard_exchange pallas runs for
// the request and row legs of the sharded exchange.
//
// Computes, on rank `me` of n: out[s] = in_s[me] for every source rank s,
// where in_s is rank s's input [n, chunk] (chunk j destined for rank j);
// out[me] = in[me] is the local copy. Dtype-blind: it moves bytes, 16 at
// a time where both pointers allow.
//
// The TPU kernel issued n-1 remote DMAs behind a barrier semaphore. On
// Hopper a kernel can store straight into another process's device
// memory through a CUDA IPC mapping (over NVLink between cards; in the
// same memory on one card), so the design is:
//
//   * the grid is sized to the card, not to the bytes: each chunk is cut
//     into P parts (contiguous, 16-byte aligned byte ranges), one block a
//     part and one 16-byte vector a thread, so every vector of the call
//     is in flight at once. Blocks shrink from 256 to 64 threads until
//     the P * n blocks make at least one wave over the SMs (read once
//     from the device attributes). No block is launched without bytes to
//     move, and no thread loops unless the chunk needs more than
//     kMaxParts parts; then a thread moves several vectors, kUnroll loads
//     before their stores;
//   * every rank owns a symmetric WORKSPACE (plain cudaMalloc, exported
//     once with cudaIpcGetMemHandle and opened once by each peer): two
//     parities of n receive slots of `stride` bytes, then two parities
//     of n x P int32 arrival flags, one per (source, part), then two
//     int32s that only this rank touches: its COUNTER of completed calls
//     and a ticket;
//   * a call's EPOCH e is the counter plus one, read on the card by
//     every block of both kernels, and its parity is e & 1. The kernels
//     take a peer table with both parities' slot and flag addresses,
//     fixed for the workspace's life, so no argument of a launch changes
//     from call to call but the input and the output: a launch captured
//     in a CUDA graph and replayed runs the epoch of its replay, and
//     eager calls and replays share one sequence and may interleave;
//   * the SEND kernel's block (p, j) copies part p of in[j] into peer
//     j's receive slot for `me` (in[me] straight into the output). After
//     __syncthreads() its thread 0 alone fences at system scope and
//     release-stores the epoch into peer j's flag (me, p). The barrier
//     orders every thread's stores before thread 0's fence, and the
//     fence is cumulative, so one fence a block covers the block's
//     stores; no thread waits for any other block;
//   * the RECV kernel's block (p, s) acquire-spins on its flag (s, p)
//     until it reaches the epoch, then copies part p of slot s into the
//     output (L2 loads: another device wrote those bytes). A receiving
//     block waits for the one part it copies, not for the whole chunk.
//     Every block then takes a ticket (an atomic add); the last of the
//     P * n blocks, which runs after every other block has read the
//     epoch, resets the ticket and stores e into the counter, so the
//     next call (in stream order: the next SEND starts after this RECV
//     ends) reads e + 1.
//
// Epochs grow by one per call and never need resetting. Every rank makes
// the same calls on a workspace in the same order, so its counter agrees
// with every peer's at each call. The two parities alternate by epoch,
// so a peer may run one call ahead of this rank without touching the
// slots this rank still reads. The argument: a peer Q writes this rank's
// parity-e slots again only in call e+2. Q's SEND of e+2 starts after
// Q's RECV of e+1 has finished (stream order on Q), which waited for at
// least one flag that this rank stores in its SEND of e+1. That SEND
// starts after this rank's RECV of e has finished (stream order here),
// and that RECV is the last reader of the parity-e slots. So every read
// of call e's slots ends before any write of call e+2's. The flags of
// the two parities are apart, so a flag of e+1 never satisfies a wait of
// e, and a flag only grows.
//
// n = 1 has no workspace and no flags: the SEND launch is the local copy
// alone (a2a_send_kernel_local: a flat index, no peer table and no part
// arithmetic).
//
// The SEND kernel reads chunk j at in + j * in_stride. The all-to-all
// passes in_stride = chunk_bytes; the ALL-GATHER passes 0, so every peer
// (and the local output) receives the one chunk the input holds, read
// once for each of them: out[s] = rank s's chunk. The RECV kernel and the
// protocol are the same for both, and so is the workspace of a chunk
// size. The device reduce-scatter (kernels/a2a.py psum_scatter) is the
// all-to-all followed by a sum over the received chunks.
//
// Bound on the H100: bytes. Each rank reads its input once and writes its
// output once (plus the receive slots it fills on its peers); at n = 1
// that is 2 * bytes at 3.35 TB/s, and at n > 1 the (n-1)/n of the input
// that leaves the card also crosses NVLink at 450 GB/s each way.

#include <cuda_runtime.h>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;     // most threads a block
constexpr int kMinThreads = 64;   // fewest, for a chunk of few vectors
constexpr int kMaxPeers = 8;
constexpr int kUnroll = 4;        // 16-byte vectors a thread keeps in flight
constexpr int64_t kMaxParts = 8192;
constexpr int kMaxDevices = 64;

// Peer j's receive slot and P flags for this rank, by parity (fixed
// for the workspace's life; entry `me` unused: the local chunk goes
// straight to the output).
struct Peers {
  char* slot[2][kMaxPeers];
  int* flag[2][kMaxPeers];
};

__device__ __forceinline__ void st_release_sys(int* p, int v) {
  asm volatile("st.release.sys.global.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ int ld_acquire_sys(const int* p) {
  int v;
  asm volatile("ld.acquire.sys.global.s32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// The block's copy of part `part` (bytes [part * part_bytes, ...) of a
// `chunk`-byte copy; part_bytes is a multiple of 16). `l2` reads through
// L2 only (bytes another device wrote). A part of at most one vector a
// thread is one predicated copy, with no loop.
template <bool l2>
__device__ __forceinline__ void copy_part(char* __restrict__ dst,
                                          const char* __restrict__ src,
                                          int64_t chunk, int64_t part_bytes,
                                          int part) {
  const int64_t b0 = part_bytes * part;
  if (b0 >= chunk) return;
  const int len = static_cast<int>(b0 + part_bytes < chunk ? part_bytes
                                                           : chunk - b0);
  const char* s = src + b0;
  char* d = dst + b0;
  int done = 0;
  if (((reinterpret_cast<uintptr_t>(s) | reinterpret_cast<uintptr_t>(d)) &
       15) == 0) {
    const int nv = len / 16;
    const int4* s4 = reinterpret_cast<const int4*>(s);
    int4* d4 = reinterpret_cast<int4*>(d);
    if (nv <= static_cast<int>(blockDim.x)) {
      const int i = threadIdx.x;
      if (i < nv) d4[i] = l2 ? __ldcg(s4 + i) : s4[i];
    } else {
      for (int i0 = threadIdx.x; i0 < nv; i0 += kUnroll * blockDim.x) {
        int4 v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = i0 + u * blockDim.x;
          if (i < nv) v[u] = l2 ? __ldcg(s4 + i) : s4[i];
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = i0 + u * blockDim.x;
          if (i < nv) d4[i] = v[u];
        }
      }
    }
    done = nv * 16;
  }
  for (int i = done + threadIdx.x; i < len; i += blockDim.x) {
    d[i] = l2 ? __ldcg(reinterpret_cast<const signed char*>(s) + i) : s[i];
  }
}

// n = 1: the local copy alone, one 16-byte vector a thread over the
// whole chunk (the byte tail to the first threads), with no peer table,
// no flags and no part arithmetic; bytes where the pointers are not
// 16-byte aligned (each thread its 16).
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
a2a_send_kernel_local(const char* __restrict__ in, char* __restrict__ out,
                      int64_t bytes) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (kVec) {
    const int64_t nv = bytes >> 4;
    if (i < nv) {
      reinterpret_cast<int4*>(out)[i] = reinterpret_cast<const int4*>(in)[i];
    }
    if (i < (bytes & 15)) out[nv * 16 + i] = in[nv * 16 + i];
  } else {
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      if (i * 16 + k < bytes) out[i * 16 + k] = in[i * 16 + k];
    }
  }
}

// __grid_constant__: blocks index the peer table by parity and
// blockIdx.y, which would otherwise copy the whole parameter struct to
// each thread's stack. counter[0]: this rank's completed calls.
__global__ void __launch_bounds__(kThreads)
a2a_send_kernel(const char* __restrict__ in, char* __restrict__ out,
                const __grid_constant__ Peers peers,
                const int* __restrict__ counter, int me,
                int64_t chunk_bytes, int64_t part_bytes, int64_t in_stride) {
  const int j = blockIdx.y;
  const int p = blockIdx.x;
  const int epoch = counter[0] + 1;
  const int par = epoch & 1;
  char* dst = j == me ? out + j * chunk_bytes : peers.slot[par][j];
  copy_part<false>(dst, in + j * in_stride, chunk_bytes, part_bytes, p);
  if (j == me) return;   // the local chunk: no flag
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    st_release_sys(peers.flag[par][j] + p, epoch);
  }
}

// slots / flags: this rank's parity-0 receive slots and flags (parity 1
// follows each); counter: [completed calls, ticket], this rank's own.
__global__ void __launch_bounds__(kThreads)
a2a_recv_kernel(const char* __restrict__ slots, char* __restrict__ out,
                const int* __restrict__ flags, int* counter, int me,
                int64_t chunk_bytes, int64_t part_bytes, int64_t stride) {
  const int n = gridDim.y;
  const int s = blockIdx.y;
  const int p = blockIdx.x;
  __shared__ int epoch_s;
  if (threadIdx.x == 0) epoch_s = counter[0] + 1;
  __syncthreads();
  const int epoch = epoch_s;
  const int64_t ps = static_cast<int64_t>(epoch & 1) * n + s;
  if (s != me) {  // the SEND kernel wrote the local chunk
    if (threadIdx.x == 0) {
      const int* f = flags + ps * gridDim.x + p;
      while (ld_acquire_sys(f) < epoch) {
      }
    }
    __syncthreads();
    copy_part<true>(out + s * chunk_bytes, slots + ps * stride, chunk_bytes,
                    part_bytes, p);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned blocks = gridDim.x * gridDim.y;
    if (atomicAdd(reinterpret_cast<unsigned*>(counter + 1), 1u) ==
        blocks - 1) {
      counter[1] = 0;
      counter[0] = epoch;
    }
  }
}

int sm_count() {
  static int cached[kMaxDevices] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 132;
  if (dev < 0 || dev >= kMaxDevices) dev = 0;
  if (cached[dev] == 0) {
    int v = 0;
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    cached[dev] = v > 0 ? v : 132;
  }
  return cached[dev];
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// Bytes of one part when a chunk is cut into `parts` (a multiple of 16),
// and the threads of its block: one a vector, a multiple of 32.
int64_t part_bytes_of(int64_t chunk_bytes, int parts) {
  return ceil_div(ceil_div(chunk_bytes, 16), parts) * 16;
}

int threads_of(int64_t part_bytes) {
  int64_t t = ceil_div(part_bytes / 16, 32) * 32;
  if (t > kThreads) t = kThreads;
  if (t < 32) t = 32;
  return static_cast<int>(t);
}

}  // namespace

static_assert(sizeof(cudaIpcMemHandle_t) == 64, "IPC handle is 64 bytes");

extern "C" const char* cafe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Parts a chunk of `chunk_bytes` is cut into over a mesh of n on the
// current device: one vector a thread in blocks of 256 threads, halved
// down to 64 while the P * n blocks fall short of one wave over the SMs;
// at most kMaxParts (a thread then moves several vectors). Every rank of
// a mesh must use the same P (a2a.py takes the smallest over the ranks).
extern "C" int a2a_parts(int64_t chunk_bytes, int n) {
  if (n < 1) n = 1;
  const int64_t vecs = ceil_div(chunk_bytes, 16);
  const int64_t sms = sm_count();
  int64_t threads = kThreads;
  int64_t parts = ceil_div(vecs, threads);
  while (threads > kMinThreads && parts * n < sms) {
    threads /= 2;
    parts = ceil_div(vecs, threads);
  }
  if (parts > kMaxParts) parts = kMaxParts;
  if (parts < 1) parts = 1;
  return static_cast<int>(parts);
}

// A zeroed workspace of `bytes` on the current device.
extern "C" int a2a_ws_alloc(int64_t bytes, void** out) {
  cudaError_t err = cudaMalloc(out, static_cast<size_t>(bytes));
  if (err == cudaSuccess)
    err = cudaMemset(*out, 0, static_cast<size_t>(bytes));
  return static_cast<int>(err);
}

extern "C" int a2a_ws_free(void* p) { return static_cast<int>(cudaFree(p)); }

// Writes the 64-byte IPC handle of workspace `p` to `handle`.
extern "C" int a2a_ipc_handle(void* p, void* handle) {
  cudaIpcMemHandle_t h;
  cudaError_t err = cudaIpcGetMemHandle(&h, p);
  if (err == cudaSuccess) std::memcpy(handle, &h, sizeof(h));
  return static_cast<int>(err);
}

// Maps a peer's workspace from its 64-byte handle.
extern "C" int a2a_ipc_open(const void* handle, void** out) {
  cudaIpcMemHandle_t h;
  std::memcpy(&h, handle, sizeof(h));
  return static_cast<int>(
      cudaIpcOpenMemHandle(out, h, cudaIpcMemLazyEnablePeerAccess));
}

extern "C" int a2a_ipc_close(void* p) {
  return static_cast<int>(cudaIpcCloseMemHandle(p));
}

// in: chunk j at in + j * in_stride (in_stride = chunk_bytes: the
// all-to-all's [n * chunk_bytes] input; 0: the all-gather's one chunk);
// out [n * chunk_bytes]; slots[par * n + j] and flags[par * n + j]: peer
// j's receive slot and `parts` flags for this rank at parity par (n > 1
// only); counter: this rank's [completed calls, ticket] (n > 1 only).
// parts <= 0 picks a2a_parts(chunk_bytes, n) on this device (n == 1
// only: at n > 1 every rank must pass the same count). Returns
// cudaGetLastError().
extern "C" int a2a_send_launch(const void* in, void* out,
                               void* const* slots, int* const* flags,
                               int n, int me, int64_t chunk_bytes,
                               int64_t in_stride, int parts,
                               const int* counter, void* stream) {
  if (n < 1 || n > kMaxPeers || me < 0 || me >= n || in_stride < 0 ||
      (n > 1 && (parts < 1 || slots == nullptr || flags == nullptr ||
                 counter == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (chunk_bytes <= 0) return static_cast<int>(cudaGetLastError());
  if (parts < 1) parts = a2a_parts(chunk_bytes, n);
  const int64_t part_bytes = part_bytes_of(chunk_bytes, parts);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* src = static_cast<const char*>(in);
  auto* dst = static_cast<char*>(out);
  if (n == 1) {   // part p is block p: its threads' vectors, in order
    // (chunk 0 is the input's first chunk for either in_stride)
    const int threads = threads_of(part_bytes);
    const auto blocks = static_cast<unsigned>(
        ceil_div(ceil_div(chunk_bytes, 16), threads));
    if (((reinterpret_cast<uintptr_t>(src) |
          reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
      a2a_send_kernel_local<true><<<blocks, threads, 0, s>>>(src, dst,
                                                             chunk_bytes);
    } else {
      a2a_send_kernel_local<false><<<blocks, threads, 0, s>>>(src, dst,
                                                              chunk_bytes);
    }
    return static_cast<int>(cudaGetLastError());
  }
  Peers peers;
  for (int par = 0; par < 2; ++par) {
    for (int j = 0; j < kMaxPeers; ++j) {
      peers.slot[par][j] =
          j < n ? static_cast<char*>(slots[par * n + j]) : nullptr;
      peers.flag[par][j] = j < n ? flags[par * n + j] : nullptr;
    }
  }
  a2a_send_kernel<<<dim3(parts, n), threads_of(part_bytes), 0, s>>>(
      src, dst, peers, counter, me, chunk_bytes, part_bytes, in_stride);
  return static_cast<int>(cudaGetLastError());
}

// slots: this rank's receive slots, parity 0's n slots of `stride` bytes
// then parity 1's; flags: its [2][n][parts] flags; counter: its
// [completed calls, ticket]; out [n * chunk_bytes] (the local chunk
// already written by the SEND kernel).
extern "C" int a2a_recv_launch(const void* slots, void* out, const void* flags,
                               int* counter, int n, int me,
                               int64_t chunk_bytes, int64_t stride, int parts,
                               void* stream) {
  if (n < 2 || n > kMaxPeers || me < 0 || me >= n || parts < 1 ||
      counter == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (chunk_bytes <= 0) return static_cast<int>(cudaGetLastError());
  const int64_t part_bytes = part_bytes_of(chunk_bytes, parts);
  a2a_recv_kernel<<<dim3(parts, n), threads_of(part_bytes), 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(slots), static_cast<char*>(out),
      static_cast<const int*>(flags), counter, me, chunk_bytes, part_bytes,
      stride);
  return static_cast<int>(cudaGetLastError());
}
