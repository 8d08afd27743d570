// The conditional IF node of the whole-fit CUDA graph
// (train/graphs.py::GraphFit, ops/conditional.py).
//
// No TPU kernel corresponds to this one.  It replaces the condition of the
// JAX package's lax.while_loop over the epochs (dca_tpu/train/compiled.py,
// `cond`: epoch < epochs and not stop): the host enqueues one replay of the
// epoch's graph for every epoch of the fit, and each replay runs the epoch
// only while the fit's device flag `stop` is false.  A replay after the
// stop then runs this kernel and nothing else, so it changes no tensor.
//
// dca_graph_if_begin, called while `parent` captures a graph, appends to
// it this kernel and, after it, an IF node whose body graph `body` then
// captures (cudaStreamBeginCaptureToGraph, thread-local mode, so that
// other threads may allocate and synchronize meanwhile).  The kernel, one
// thread, reads the one byte of `stop` and sets the node's condition
// (cudaGraphSetConditional) on every launch of the graph.  It moves one
// byte: its time is the launch's, not a bound of bytes or operations.
// dca_graph_if_end ends the body's capture, and counts the body's nodes
// into `counts` unless it is NULL; the parent capture goes on after the
// node.  Needs CUDA 12.4 or later (conditional nodes captured
// from streams).
//
// dca_capture_node_counts reads the graph a stream is capturing into:
// its kernel, memcpy, memset and other nodes so far (cudaGraphGetNodes,
// cudaGraphNodeGetType), the node counts of train/graphs.py's captures;
// an IF node's body is counted when its capture ends.

#include <cuda_runtime.h>

#include <vector>

namespace {

__global__ void dca_set_if_kernel(cudaGraphConditionalHandle handle, const bool* stop) {
    cudaGraphSetConditional(handle, *stop ? 0u : 1u);
}

// the stream's capture: its graph and the nodes the next one depends on
cudaError_t capture_info(cudaStream_t s, cudaGraph_t* graph, const cudaGraphNode_t** deps,
                         size_t* n_deps) {
    cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
    const cudaGraphEdgeData* edges;
    cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, graph, deps, &edges, n_deps);
#else
    cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, graph, deps, n_deps);
#endif
    if (err == cudaSuccess && status != cudaStreamCaptureStatusActive)
        return cudaErrorIllegalState;  // not capturing
    return err;
}

// counts[4]: the kernel, memcpy, memset and other nodes of `graph`
cudaError_t count_nodes(cudaGraph_t graph, long long* counts) {
    size_t n = 0;
    cudaError_t err = cudaGraphGetNodes(graph, nullptr, &n);
    if (err != cudaSuccess) return err;
    std::vector<cudaGraphNode_t> nodes(n);
    if (n > 0) err = cudaGraphGetNodes(graph, nodes.data(), &n);
    if (err != cudaSuccess) return err;
    for (int i = 0; i < 4; ++i) counts[i] = 0;
    for (size_t i = 0; i < n; ++i) {
        cudaGraphNodeType type;
        err = cudaGraphNodeGetType(nodes[i], &type);
        if (err != cudaSuccess) return err;
        counts[type == cudaGraphNodeTypeKernel   ? 0
               : type == cudaGraphNodeTypeMemcpy ? 1
               : type == cudaGraphNodeTypeMemset ? 2
                                                 : 3] += 1;
    }
    return cudaSuccess;
}

}  // namespace

extern "C" {

int dca_capture_node_counts(void* stream, long long* counts) {
    cudaGraph_t graph;
    const cudaGraphNode_t* deps;
    size_t n_deps;
    cudaError_t err = capture_info((cudaStream_t)stream, &graph, &deps, &n_deps);
    if (err != cudaSuccess) return (int)err;
    return (int)count_nodes(graph, counts);
}


int dca_graph_if_begin(void* parent, void* body, const void* stop) {
    cudaStream_t ps = (cudaStream_t)parent;
    cudaGraph_t graph;
    const cudaGraphNode_t* deps;
    size_t n_deps;
    cudaError_t err = capture_info(ps, &graph, &deps, &n_deps);
    if (err != cudaSuccess) return (int)err;
    cudaGraphConditionalHandle handle;
    err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
    if (err != cudaSuccess) return (int)err;
    dca_set_if_kernel<<<1, 1, 0, ps>>>(handle, (const bool*)stop);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = capture_info(ps, &graph, &deps, &n_deps);  // now after the kernel
    if (err != cudaSuccess) return (int)err;

    cudaGraphNodeParams params = {};
    params.type = cudaGraphNodeTypeConditional;
    params.conditional.handle = handle;
    params.conditional.type = cudaGraphCondTypeIf;
    params.conditional.size = 1;
    cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
    err = cudaGraphAddNode(&node, graph, deps, nullptr, n_deps, &params);
    if (err != cudaSuccess) return (int)err;
    err = cudaStreamUpdateCaptureDependencies(ps, &node, nullptr, 1,
                                              cudaStreamSetCaptureDependencies);
#else
    err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
    if (err != cudaSuccess) return (int)err;
    err = cudaStreamUpdateCaptureDependencies(ps, &node, 1, cudaStreamSetCaptureDependencies);
#endif
    if (err != cudaSuccess) return (int)err;
    return (int)cudaStreamBeginCaptureToGraph((cudaStream_t)body, params.conditional.phGraph_out[0],
                                              nullptr, nullptr, 0,
                                              cudaStreamCaptureModeThreadLocal);
}

int dca_graph_if_end(void* body, long long* counts) {
    cudaGraph_t graph;
    cudaError_t err = cudaStreamEndCapture((cudaStream_t)body, &graph);
    if (err != cudaSuccess || counts == nullptr) return (int)err;
    return (int)count_nodes(graph, counts);
}

}  // extern "C"
