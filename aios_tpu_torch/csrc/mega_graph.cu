// The decode megagraph's early exit: a captured CUDA graph that runs up to K
// decode ticks and stops the moment no slot needs another one.
//
// Replaces no Pallas kernel. The JAX package runs the megagraph as one
// `lax.while_loop` (aios_tpu/engine/engine.py, `_mega_impl`), whose `cond`
// XLA evaluates on the device between ticks. A CUDA graph cannot branch from
// the host, so each tick of the port's megagraph is a conditional IF node
// (CUDA 12.4+) whose body is that tick's decode step, captured straight into
// the node's body graph, and whose handle the one-thread gate kernel below
// sets from the live flags just before it: a tick runs while its index is
// below the dispatch's cap and some slot is live (active, no stop id sampled,
// budget left, below the context cap). A tick that does not run writes
// nothing; once one is skipped every later gate sees the same state and
// skips too, so the ticks that ran are a prefix and their count is k.
//
// What bounds it: nothing measurable. The gate reads 4 bytes a slot of each
// flag and launches once per tick; a dead tick costs that launch and the
// conditional node's own scheduling, not the tick's forward.
//
// The capture helpers take the stream PyTorch captures the whole graph on
// and a second stream that captures a tick's body into the node's graph
// (`cudaStreamBeginCaptureToGraph`); ops/mega_graph.py drives them.

#include <cuda_runtime.h>

namespace {

__global__ void mega_gate_kernel(cudaGraphConditionalHandle handle, int has_handle, int tick,
                                 const int* __restrict__ cap,
                                 const bool* __restrict__ active, const bool* __restrict__ done,
                                 const int* __restrict__ rem, const int* __restrict__ lengths,
                                 int ctx_cap, int slots, int* __restrict__ go_out) {
  int go = 0;
  if (tick < *cap) {
    for (int s = 0; s < slots && !go; ++s)
      go = active[s] && !done[s] && rem[s] > 0 && lengths[s] < ctx_cap;
  }
  go_out[tick] = go;
  if (has_handle) cudaGraphSetConditional(handle, go);
}

}  // namespace

// go_out[tick] = 1 when tick < *cap and some slot s < slots has active[s],
// !done[s], rem[s] > 0 and lengths[s] < ctx_cap, else 0; with has_handle,
// the conditional handle is set to the same value (inside a graph launch
// only). One thread.
extern "C" int aios_mega_gate(unsigned long long handle, int has_handle, int tick,
                              const void* cap, const void* active, const void* done,
                              const void* rem, const void* lengths, int ctx_cap, int slots,
                              void* go_out, void* stream) {
  mega_gate_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<cudaGraphConditionalHandle>(handle), has_handle, tick,
      static_cast<const int*>(cap), static_cast<const bool*>(active),
      static_cast<const bool*>(done), static_cast<const int*>(rem),
      static_cast<const int*>(lengths), ctx_cap, slots, static_cast<int*>(go_out));
  return static_cast<int>(cudaGetLastError());
}

// A conditional handle of the graph `stream` is capturing, default 0 and
// reset to it at every launch of the graph.
extern "C" int aios_cond_handle(void* stream, unsigned long long* handle_out) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  cudaError_t err = cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream), &status,
                                             nullptr, &graph, nullptr, nullptr);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive) return static_cast<int>(cudaErrorIllegalState);
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, cudaGraphCondAssignDefault);
  *handle_out = static_cast<unsigned long long>(handle);
  return static_cast<int>(err);
}

// Append an IF node on `handle` after the work `stream` has captured so far
// (the gate), make it what the stream's next work depends on, and start
// capturing `body` into the node's body graph.
extern "C" int aios_cond_if_begin(void* stream, void* body, unsigned long long handle) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive) return static_cast<int>(cudaErrorIllegalState);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = static_cast<cudaGraphConditionalHandle>(handle);
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(body),
                                                        params.conditional.phGraph_out[0],
                                                        nullptr, nullptr, 0,
                                                        cudaStreamCaptureModeThreadLocal));
}

// End the capture of an IF node's body on `body`.
extern "C" int aios_cond_if_end(void* body) {
  cudaGraph_t graph;
  return static_cast<int>(cudaStreamEndCapture(static_cast<cudaStream_t>(body), &graph));
}

extern "C" const char* aios_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
