// Conditional nodes of a captured CUDA graph: the port's `lax.cond`
// (utils/graphs.cond, ops/cuda/cond_cuda.py).
//
// While `stream` captures a graph, vil_cond_begin appends to it a one-thread
// kernel that sets a conditional handle from a device bool and, behind that
// kernel, an IF conditional node whose body runs at a replay only where the
// handle is nonzero; then it starts capturing `body_stream` into that body.
// The work enqueued on `body_stream` until vil_cond_end becomes the body;
// the work enqueued on `stream` after vil_cond_begin depends on the node.
// A replay that skips the body skips every kernel in it.
//
// Needs CUDA >= 12.4 (conditional nodes, cudaStreamBeginCaptureToGraph) and
// a device of compute capability 9.0 for the device-side
// cudaGraphSetConditional.
#include <cuda_runtime.h>

// handle := (*pred != 0) != negate
__global__ void vil_set_conditional_kernel(cudaGraphConditionalHandle handle,
                                           const bool* pred, int negate) {
  const unsigned int v = (*pred ? 1u : 0u) ^ (negate ? 1u : 0u);
  cudaGraphSetConditional(handle, v);
}

extern "C" int vil_cond_runtime_version() { return CUDART_VERSION; }

// On the capturing `stream`: the set kernel (on `pred`, negated with
// `negate`) and an IF node behind it; then `body_stream` captures into the
// node's body (`mode`: a cudaStreamCaptureMode). *body_out receives the
// body graph. Returns a cudaError_t (cudaErrorIllegalState when `stream`
// is not capturing).
extern "C" int vil_cond_begin(void* stream, const void* pred, int negate, void* body_stream,
                              int mode, void** body_out) {
  const cudaStream_t st = (cudaStream_t)stream;
  cudaStreamCaptureStatus status;
  unsigned long long id = 0;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t e = cudaStreamGetCaptureInfo(st, &status, &id, &graph, &deps, &n_deps);
  if (e != cudaSuccess) return (int)e;
  if (status != cudaStreamCaptureStatusActive) return (int)cudaErrorIllegalState;
  cudaGraphConditionalHandle handle;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (e != cudaSuccess) return (int)e;
  vil_set_conditional_kernel<<<1, 1, 0, st>>>(handle, (const bool*)pred, negate);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // the node depends on what the stream's next node would: the set kernel
  e = cudaStreamGetCaptureInfo(st, &status, &id, &graph, &deps, &n_deps);
  if (e != cudaSuccess) return (int)e;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  e = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (e != cudaSuccess) return (int)e;
  e = cudaStreamUpdateCaptureDependencies(st, &node, 1, cudaStreamSetCaptureDependencies);
  if (e != cudaSuccess) return (int)e;
  cudaGraph_t body = params.conditional.phGraph_out[0];
  e = cudaStreamBeginCaptureToGraph((cudaStream_t)body_stream, body, nullptr, nullptr, 0,
                                    (cudaStreamCaptureMode)mode);
  if (e != cudaSuccess) return (int)e;
  *body_out = (void*)body;
  return 0;
}

// Ends the capture of `body_stream` into its body.
extern "C" int vil_cond_end(void* body_stream) {
  cudaGraph_t g = nullptr;
  return (int)cudaStreamEndCapture((cudaStream_t)body_stream, &g);
}
