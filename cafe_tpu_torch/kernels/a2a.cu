// K5 — all-to-all over the mesh by peer writes, hand-written for Hopper.
//
// Replaces cafe_tpu/ops/pallas_a2a.py: a2a_shard (kernel body
// _a2a_kernel), which the JAX package's --shard_exchange pallas runs for
// the request and row legs of the sharded exchange.
//
// Computes, on rank `me` of n: out[s] = in_s[me] for every source rank s,
// where in_s is rank s's input [n, chunk] (chunk j destined for rank j);
// out[me] = in[me] is the local copy. Dtype-blind: it moves bytes, 16 at
// a time where the chunk and the pointers allow.
//
// The TPU kernel issued n-1 remote DMAs behind a barrier semaphore. On
// Hopper a kernel can store straight into another process's device
// memory through a CUDA IPC mapping (over NVLink between cards; in the
// same memory on one card), so the design is:
//
//   * every rank owns a symmetric WORKSPACE (plain cudaMalloc, exported
//     once with cudaIpcGetMemHandle and opened once by each peer): two
//     parities of n receive slots of `stride` bytes, 2*n int32 flags and
//     one block counter;
//   * the SEND kernel copies in[j] into peer j's receive slot for `me`
//     (in[me] straight into the output). Each block fences its stores at
//     system scope; the last block to finish (a ticket counter) then
//     release-stores the call's epoch into each peer's flag for `me`, so
//     no flag can overtake any block's writes;
//   * the RECV kernel's blocks each acquire-spin on the flag of their
//     source rank until it reaches the epoch, then copy that slot into
//     the output (L2 loads: the bytes came from another device).
//
// Epochs grow by one per call and never need resetting. The two parities
// alternate by epoch, so a peer may run one call ahead of this rank
// without touching the slots this rank still reads: to start call e+2 on
// the same parity a peer must have seen this rank's e+1 flag, which this
// rank stores only after its call-e RECV finished (stream order). n = 1
// has no workspace and no flags: the SEND kernel is the local copy.
//
// Bound on the H100: bytes. Each rank reads its input once and writes its
// output once (plus the receive slots it fills on its peers); at n = 1
// that is 2 * bytes at 3.35 TB/s.

#include <cuda_runtime.h>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPeers = 8;
constexpr int64_t kVecsPerBlock = 4 * kThreads;   // 16 KB a block
constexpr int64_t kMaxBlocks = 132 * 8;

struct Peers {
  char* dst[kMaxPeers];  // where chunk j of the input goes
  int* flag[kMaxPeers];  // peer j's flag slot for this rank
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

// This block's share (part `part` of `parts`) of a `bytes` copy.
// `l2` reads through L2 only (bytes another device wrote).
template <bool l2>
__device__ __forceinline__ void copy_share(char* dst, const char* src,
                                           int64_t bytes, bool vec,
                                           int part, int parts) {
  const int64_t step = static_cast<int64_t>(parts) * blockDim.x;
  const int64_t first = static_cast<int64_t>(part) * blockDim.x +
                        threadIdx.x;
  int64_t done = 0;
  if (vec) {
    const int64_t nv = bytes / 16;
    const int4* s = reinterpret_cast<const int4*>(src);
    int4* d = reinterpret_cast<int4*>(dst);
    for (int64_t i = first; i < nv; i += step)
      d[i] = l2 ? __ldcg(s + i) : s[i];
    done = nv * 16;
  }
  for (int64_t i = done + first; i < bytes; i += step)
    dst[i] = l2 ? __ldcg(reinterpret_cast<const signed char*>(src) + i)
                : src[i];
}

// __grid_constant__: blocks index the peer table by blockIdx.y, which
// would otherwise copy the whole parameter struct to each thread's stack
__global__ void a2a_send_kernel(const char* __restrict__ in,
                                const __grid_constant__ Peers peers,
                                int n, int me, int64_t chunk_bytes, bool vec,
                                unsigned int* counter, int epoch) {
  const int j = blockIdx.y;
  copy_share<false>(peers.dst[j], in + j * chunk_bytes, chunk_bytes, vec,
                    blockIdx.x, gridDim.x);
  if (n == 1) return;
  __threadfence_system();  // this thread's stores, before the ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int total = gridDim.x * gridDim.y;
    if (atomicAdd(counter, 1u) == total - 1) {
      atomicExch(counter, 0u);  // ready for the next call on this stream
      __threadfence_system();
      for (int k = 0; k < n; ++k)
        if (k != me) st_release_sys(peers.flag[k], epoch);
    }
  }
}

__global__ void a2a_recv_kernel(const char* __restrict__ slots,
                                char* __restrict__ out,
                                const int* __restrict__ flags, int me,
                                int64_t chunk_bytes, int64_t stride, bool vec,
                                int epoch) {
  const int s = blockIdx.y;
  if (s == me) return;  // the SEND kernel wrote the local chunk
  if (threadIdx.x == 0) {
    while (ld_acquire_sys(flags + s) < epoch) __nanosleep(100);
  }
  __syncthreads();
  copy_share<true>(out + s * chunk_bytes, slots + s * stride, chunk_bytes,
                   vec, blockIdx.x, gridDim.x);
}

dim3 grid_for(int64_t chunk_bytes, int n) {
  int64_t per = (chunk_bytes / 16 + kVecsPerBlock - 1) / kVecsPerBlock;
  int64_t cap = kMaxBlocks / n;
  if (per > cap) per = cap;
  if (per < 1) per = 1;
  return dim3(static_cast<unsigned int>(per), static_cast<unsigned int>(n));
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

static_assert(sizeof(cudaIpcMemHandle_t) == 64, "IPC handle is 64 bytes");

extern "C" const char* cafe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
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

// in [n * chunk_bytes]; dst[j]: where chunk j goes (for j == me, this
// rank's output); flags[j]: peer j's flag slot for this rank (unused at
// n == 1, like `counter`). Returns cudaGetLastError().
extern "C" int a2a_send_launch(const void* in, void* const* dst,
                               int* const* flags, int n, int me,
                               int64_t chunk_bytes, void* counter, int epoch,
                               void* stream) {
  if (n < 1 || n > kMaxPeers || me < 0 || me >= n)
    return static_cast<int>(cudaErrorInvalidValue);
  if (chunk_bytes <= 0) return static_cast<int>(cudaGetLastError());
  Peers peers;
  bool vec = chunk_bytes % 16 == 0 && aligned16(in);
  for (int j = 0; j < kMaxPeers; ++j) {
    peers.dst[j] = j < n ? static_cast<char*>(dst[j]) : nullptr;
    peers.flag[j] = (j < n && flags != nullptr) ? flags[j] : nullptr;
    if (j < n) vec = vec && aligned16(peers.dst[j]);
  }
  a2a_send_kernel<<<grid_for(chunk_bytes, n), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(in), peers, n, me, chunk_bytes, vec,
      static_cast<unsigned int*>(counter), epoch);
  return static_cast<int>(cudaGetLastError());
}

// slots: this rank's receive slots of the call's parity (n slots of
// `stride` bytes); flags: its n flags of that parity; out [n * chunk_bytes]
// (the local chunk already written by the SEND kernel).
extern "C" int a2a_recv_launch(const void* slots, void* out, const void* flags,
                               int n, int me, int64_t chunk_bytes,
                               int64_t stride, int epoch, void* stream) {
  if (n < 2 || n > kMaxPeers || me < 0 || me >= n)
    return static_cast<int>(cudaErrorInvalidValue);
  if (chunk_bytes <= 0) return static_cast<int>(cudaGetLastError());
  const bool vec = chunk_bytes % 16 == 0 && stride % 16 == 0 &&
                   aligned16(slots) && aligned16(out);
  a2a_recv_kernel<<<grid_for(chunk_bytes, n), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(slots), static_cast<char*>(out),
      static_cast<const int*>(flags), me, chunk_bytes, stride, vec, epoch);
  return static_cast<int>(cudaGetLastError());
}
