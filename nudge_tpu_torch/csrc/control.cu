// Conditional nodes of a CUDA graph under stream capture (CUDA 12.4 or
// newer): the IF node that nudge_tpu_torch/control.py makes of a `cond`
// branch when torch's CUDAGraph cannot capture one itself
// (CUDAGraph.begin_capture_to_if_node). Graph plumbing, no engine math.
//
// nudge_if_begin(pred, parent, body, body_graph): in the graph `parent` is
//   capturing, a one-thread kernel that sets a new conditional handle from
//   the bool at `pred` when the graph runs, then an IF node on that handle
//   after it; `parent` goes on capturing after the node, and `body` (an
//   idle stream) starts capturing into the node's body graph, which is
//   written to *body_graph.
// nudge_if_end(body): ends the body's capture.
// nudge_stamp(rows, row, row_offset, cols, slot, clear, stream): one
//   thread writes the card's %globaltimer (ns) into rows[r, slot], r =
//   *row + row_offset (row 0 when `row` is null), after setting slots
//   [0, clear) of that row to -1: the stage stamps of a traced graph
//   (nudge_tpu_torch/trace.py).
//
// Each returns the cudaError_t of its calls.

#include <cuda_runtime.h>

namespace {

__global__ void set_if_kernel(cudaGraphConditionalHandle handle,
                              const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

// The graph `s` is capturing into and the nodes its next node depends on.
cudaError_t capture_info(cudaStream_t s, cudaGraph_t* graph,
                         const cudaGraphNode_t** deps, size_t* n) {
  cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, graph, deps,
                                             nullptr, n);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, graph, deps,
                                             n);
#endif
  if (err != cudaSuccess) return err;
  return status == cudaStreamCaptureStatusActive
             ? cudaSuccess
             : cudaErrorIllegalState;
}

__global__ void stamp_kernel(long long* rows, const long long* row,
                             int row_offset, int cols, int slot, int clear) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  long long* r = rows + ((row ? *row : 0) + row_offset) * cols;
  for (int k = 0; k < clear; ++k) r[k] = -1;
  r[slot] = static_cast<long long>(now);
}

}  // namespace

extern "C" int nudge_if_begin(const bool* pred, void* parent_stream,
                              void* body_stream, void* body_graph_out) {
  cudaStream_t parent = static_cast<cudaStream_t>(parent_stream);
  cudaStream_t body = static_cast<cudaStream_t>(body_stream);
  cudaGraph_t* body_graph = static_cast<cudaGraph_t*>(body_graph_out);
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n;
  cudaError_t err = capture_info(parent, &graph, &deps, &n);
  if (err != cudaSuccess) return err;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_if_kernel<<<1, 1, 0, parent>>>(handle, pred);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = capture_info(parent, &graph, &deps, &n);
  if (err != cudaSuccess) return err;

  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, n, &params);
#else
  err = cudaGraphAddNode(&node, graph, deps, n, &params);
#endif
  if (err != cudaSuccess) return err;
#if CUDART_VERSION >= 13000
  err = cudaStreamUpdateCaptureDependencies(parent, &node, nullptr, 1,
                                            cudaStreamSetCaptureDependencies);
#else
  err = cudaStreamUpdateCaptureDependencies(parent, &node, 1,
                                            cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return err;
  *body_graph = params.conditional.phGraph_out[0];
  return cudaStreamBeginCaptureToGraph(body, *body_graph, nullptr, nullptr, 0,
                                       cudaStreamCaptureModeRelaxed);
}

extern "C" int nudge_if_end(void* body_stream) {
  cudaGraph_t graph;
  return cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &graph);
}

extern "C" int nudge_stamp(void* rows, const void* row, int row_offset,
                           int cols, int slot, int clear, void* stream) {
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(rows), static_cast<const long long*>(row),
      row_offset, cols, slot, clear);
  return cudaGetLastError();
}
