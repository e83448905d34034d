// Span marks and the promotions counter of utils/spans.py.
//
// Replaces no TPU kernel: the JAX package's step is one jitted program,
// which a profile of it splits by XLA's own op names. A replayed CUDA
// graph carries no host range, so the port marks its spans with kernels
// captured into the graph:
//
//   * a begin and an end mark a span, one-thread kernels that do nothing
//     and whose names carry the span's (cafe_span_begin_<span>,
//     cafe_span_end_<span>; extern "C", so a profiler prints them as
//     they are). On one stream they run in the captured order, so a
//     trace books each device op to the innermost span open at its
//     start;
//   * cafe_span_count adds a 0-d int64 on the card to a running total on
//     the card (the promotions a step lands), with no host read.
//
// A GraphedStep captures its step twice, with the marks and without
// them (train/capture.py), and replays the first only while the
// profiler is on, so an untraced replay runs none of these kernels.
// Outside a capture the marks launch only while the profiler is on.
//
// Bound: latency, one launch each; the counter moves 24 bytes.

#include <cuda_runtime.h>

#define CAFE_SPAN(name)                                    \
  extern "C" __global__ void cafe_span_begin_##name() {}   \
  extern "C" __global__ void cafe_span_end_##name() {}

// the spans, in utils/spans.SPANS' order
CAFE_SPAN(step)
CAFE_SPAN(embed_gather)
CAFE_SPAN(towers)
CAFE_SPAN(cafe_insert)
CAFE_SPAN(cafe_migrate)
CAFE_SPAN(cafe_update)

extern "C" __global__ void cafe_span_count(const long long* n,
                                           long long* total) {
  total[0] += n[0];
}

namespace {

// begin and end of each span, mark i = 2 * span + (end ? 1 : 0)
const void* const MARKS[] = {
    (const void*)cafe_span_begin_step,
    (const void*)cafe_span_end_step,
    (const void*)cafe_span_begin_embed_gather,
    (const void*)cafe_span_end_embed_gather,
    (const void*)cafe_span_begin_towers,
    (const void*)cafe_span_end_towers,
    (const void*)cafe_span_begin_cafe_insert,
    (const void*)cafe_span_end_cafe_insert,
    (const void*)cafe_span_begin_cafe_migrate,
    (const void*)cafe_span_end_cafe_migrate,
    (const void*)cafe_span_begin_cafe_update,
    (const void*)cafe_span_end_cafe_update,
};
const char* const NAMES[] = {
    "step", "embed_gather", "towers", "cafe_insert", "cafe_migrate",
    "cafe_update",
};
constexpr int N_MARKS = sizeof(MARKS) / sizeof(MARKS[0]);

}  // namespace

extern "C" {

int cafe_span_count_spans() { return N_MARKS / 2; }

const char* cafe_span_name(int span) {
  return span >= 0 && span < N_MARKS / 2 ? NAMES[span] : nullptr;
}

// Load every kernel of this library (the runtime loads a module's
// kernels at their first use), so that no load happens inside a capture.
int cafe_span_load() {
  cudaFuncAttributes attr;
  for (int mark = 0; mark < N_MARKS; ++mark) {
    cudaError_t err = cudaFuncGetAttributes(&attr, MARKS[mark]);
    if (err != cudaSuccess) return err;
  }
  return cudaFuncGetAttributes(&attr, (const void*)cafe_span_count);
}

// Launch mark `mark` on `stream`. Returns a CUDA error code.
int cafe_span_mark(void* stream, int mark) {
  if (mark < 0 || mark >= N_MARKS) return cudaErrorInvalidValue;
  return cudaLaunchKernel(MARKS[mark], dim3(1), dim3(1), nullptr, 0,
                          static_cast<cudaStream_t>(stream));
}

// total[0] += n[0] on `stream` (both int64 on the card).
int cafe_span_count_launch(void* stream, const void* n, void* total) {
  cafe_span_count<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(n), static_cast<long long*>(total));
  return cudaGetLastError();
}

// Upload an instantiated graph (a cudaGraphExec_t) on `stream`, so that
// its first launch does not.
int cafe_span_upload(void* exec, void* stream) {
  return cudaGraphUpload(static_cast<cudaGraphExec_t>(exec),
                         static_cast<cudaStream_t>(stream));
}

const char* cafe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
