// Conditional nodes of a CUDA graph under stream capture: the device-side
// branches of the captured frame step (hso_tpu_torch/pipeline/step_graph.py).
//
// The JAX step is one compiled program whose FC/IC choice is a lax.cond and
// whose FC level LM is a lax.while_loop (hso_tpu/pipeline/fused_step.py:115-119,
// hso_tpu/track/coarse_tracker.py:260-290).  The port captures the step into a
// CUDA graph; each branch, and each iteration of the gated loop, becomes an IF
// node whose body runs only when a device bool says so, read by the graph at
// replay, never by the host.  The PyTorch build this port runs on (2.11) has
// no conditional-node API, so the node is made here:
//
//   hso_if_node_begin: on the stream being captured, create a conditional
//   handle in the graph under capture, capture one one-thread kernel that
//   sets the handle from *pred (negated when asked), add an IF node after it,
//   make the node the stream's capture dependency, and start capturing
//   `body` into the node's body graph;
//   hso_if_node_end: end the capture of `body`, first counting its nodes
//   when asked (only for a body that holds no IF node of its own: counting
//   one that does fails on the card);
//   hso_capture_counts: the nodes of any capture under way that holds no IF
//   node (the keyframe body's graph, the windowed BA's).
//
// Not a port of a TPU kernel: the one kernel here reads a bool and sets a
// handle.  Nothing here allocates on the device; every call returns its
// cudaError_t.
#include <cuda_runtime.h>

namespace {

__global__ void set_if_handle(cudaGraphConditionalHandle handle, const bool* pred, int negate) {
    const bool v = *pred;
    cudaGraphSetConditional(handle, (v != (negate != 0)) ? 1u : 0u);
}

cudaError_t capture_info(cudaStream_t stream, cudaGraph_t* graph, const cudaGraphNode_t** deps,
                         size_t* n_deps) {
    cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
    cudaError_t e = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph, deps, nullptr, n_deps);
#else
    cudaError_t e = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph, deps, n_deps);
#endif
    if (e == cudaSuccess && status != cudaStreamCaptureStatusActive)
        return cudaErrorStreamCaptureImplicit;
    return e;
}

}  // namespace

extern "C" int hso_if_node_begin(cudaStream_t stream, const bool* pred, int negate,
                                 cudaStream_t body) {
    cudaGraph_t graph;
    const cudaGraphNode_t* deps = nullptr;
    size_t n_deps = 0;
    cudaError_t e = capture_info(stream, &graph, &deps, &n_deps);
    if (e != cudaSuccess) return e;
    cudaGraphConditionalHandle handle;
    e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
    if (e != cudaSuccess) return e;
    set_if_handle<<<1, 1, 0, stream>>>(handle, pred, negate);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    e = capture_info(stream, &graph, &deps, &n_deps);   // now: the set kernel
    if (e != cudaSuccess) return e;
    cudaGraphNodeParams params = {};
    params.type = cudaGraphNodeTypeConditional;
    params.conditional.handle = handle;
    params.conditional.type = cudaGraphCondTypeIf;
    params.conditional.size = 1;
    cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
    e = cudaGraphAddNode(&node, graph, deps, nullptr, n_deps, &params);
    if (e != cudaSuccess) return e;
    e = cudaStreamUpdateCaptureDependencies(stream, &node, nullptr, 1,
                                            cudaStreamSetCaptureDependencies);
#else
    e = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
    if (e != cudaSuccess) return e;
    e = cudaStreamUpdateCaptureDependencies(stream, &node, 1, cudaStreamSetCaptureDependencies);
#endif
    if (e != cudaSuccess) return e;
    return cudaStreamBeginCaptureToGraph(body, params.conditional.phGraph_out[0], nullptr,
                                         nullptr, 0, cudaStreamCaptureModeRelaxed);
}

// Add the nodes and kernel nodes of the graph being captured on `stream` to
// `nodes` and `kernels` (the record of what a capture holds; only for a graph
// that holds no IF node: counting one that does fails on the card).
extern "C" int hso_capture_counts(cudaStream_t stream, long long* nodes, long long* kernels) {
    cudaGraph_t graph;
    const cudaGraphNode_t* deps = nullptr;
    size_t n = 0;
    cudaError_t e = capture_info(stream, &graph, &deps, &n);
    if (e == cudaSuccess) e = cudaGraphGetNodes(graph, nullptr, &n);
    if (e == cudaSuccess && n > 0) {
        cudaGraphNode_t* all = new cudaGraphNode_t[n];
        e = cudaGraphGetNodes(graph, all, &n);
        for (size_t i = 0; e == cudaSuccess && i < n; ++i) {
            cudaGraphNodeType t;
            e = cudaGraphNodeGetType(all[i], &t);
            *nodes += 1;
            *kernels += t == cudaGraphNodeTypeKernel;
        }
        delete[] all;
    }
    return e;
}

// With `nodes` and `kernels` given, add the body's nodes and kernel nodes to
// them before its capture ends.
extern "C" int hso_if_node_end(cudaStream_t body, long long* nodes, long long* kernels) {
    cudaError_t e = cudaSuccess;
    if (nodes != nullptr && kernels != nullptr)
        e = static_cast<cudaError_t>(hso_capture_counts(body, nodes, kernels));
    cudaGraph_t graph;
    cudaError_t e_end = cudaStreamEndCapture(body, &graph);
    return e != cudaSuccess ? e : e_end;
}
