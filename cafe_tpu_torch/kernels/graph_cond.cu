// CUDA graph conditional IF nodes for the port's `cond` (utils/cond.py).
//
// Replaces no TPU kernel: it is the card's form of the JAX package's
// lax.cond, which XLA compiles into a device-side branch of the jitted
// step. Torch's own route to these nodes
// (CUDAGraph.begin_capture_to_if_node, which
// torch/_higher_order_ops/cudagraph_conditional_nodes.py uses) is absent
// from some torch builds, so the port opens and closes a body itself
// through the CUDA runtime (12.4 or later), in the order torch's
// CUDAGraph::begin_capture_to_if_node takes:
//
//   1. on the stream that captures the step, a one-thread kernel reads
//      the predicate (a bool on the card, inverted for the else body)
//      and sets the node's condition with cudaGraphSetConditional, so
//      every replay reads the predicate that replay computed;
//   2. a conditional IF node follows it in the captured graph, and the
//      stream's capture continues after that node;
//   3. a stream of its own starts capturing into the node's body graph,
//      so everything the caller enqueues on it until cafe_cond_end lands
//      in the body and runs only on the replays whose condition is set.
//
// Bound: latency. The condition kernel moves one byte and the node costs
// a replay about one kernel launch; a body that does not run costs
// nothing else.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

__global__ void set_condition_kernel(cudaGraphConditionalHandle handle,
                                     const bool* pred, int negate) {
  unsigned int value = *pred ? 1u : 0u;
  cudaGraphSetConditional(handle, negate ? value ^ 1u : value);
}

}  // namespace

extern "C" {

// Open an IF body in the graph that `stream` is capturing. Writes the
// stream that captures the body to *body_stream_out. Returns a CUDA
// error code (0 on success).
int cafe_cond_begin(void* stream, const void* pred, int negate,
                    void** body_stream_out) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  unsigned long long id = 0;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, &id, &graph);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive)
    return cudaErrorStreamCaptureImplicit;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_condition_kernel<<<1, 1, 0, s>>>(handle,
                                       static_cast<const bool*>(pred),
                                       negate);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaStreamGetCaptureInfo(s, &status, &id, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
  if (err != cudaSuccess) return err;
  cudaGraph_t body = params.conditional.phGraph_out[0];
  err = cudaStreamUpdateCaptureDependencies(
      s, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return err;
  cudaStream_t body_stream;
  err = cudaStreamCreateWithFlags(&body_stream, cudaStreamNonBlocking);
  if (err != cudaSuccess) return err;
  err = cudaStreamBeginCaptureToGraph(body_stream, body, nullptr, nullptr,
                                      0, cudaStreamCaptureModeGlobal);
  if (err != cudaSuccess) {
    cudaStreamDestroy(body_stream);
    return err;
  }
  *body_stream_out = body_stream;
  return cudaSuccess;
}

// Close the body that `body_stream` captures and release the stream.
int cafe_cond_end(void* body_stream) {
  cudaStream_t s = static_cast<cudaStream_t>(body_stream);
  cudaGraph_t body = nullptr;
  cudaError_t err = cudaStreamEndCapture(s, &body);
  cudaError_t err2 = cudaStreamDestroy(s);
  return err != cudaSuccess ? err : err2;
}

const char* cafe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
