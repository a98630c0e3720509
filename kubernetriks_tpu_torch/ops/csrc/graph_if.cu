// A conditional node in the CUDA graph a stream is capturing: the
// counterpart of the reference's lax.cond in a captured window piece.
//
// ktt_graph_if appends to the graph `stream` is capturing a one-thread
// kernel that copies a device flag into a new conditional handle, then an
// IF node on that handle whose body is a copy of `body` (a graph captured
// beforehand), and makes the IF node the stream's capture dependency. A
// replay then runs the body only where the flag is set when the node is
// reached; nothing is read back to the host.

#include <cuda_runtime.h>

__global__ void ktt_set_if_kernel(cudaGraphConditionalHandle handle, const bool* flag) {
    cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

extern "C" int ktt_graph_if(const void* flag, void* body, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaStreamCaptureStatus status;
    cudaGraph_t graph;
    const cudaGraphNode_t* deps;
    size_t n_deps;
    cudaError_t e = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
    if (e != cudaSuccess) return e;
    if (status != cudaStreamCaptureStatusActive) return cudaErrorStreamCaptureInvalidated;
    cudaGraphConditionalHandle handle;
    e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
    if (e != cudaSuccess) return e;
    ktt_set_if_kernel<<<1, 1, 0, s>>>(handle, static_cast<const bool*>(flag));
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    // The set kernel is now the stream's dependency.
    e = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
    if (e != cudaSuccess) return e;
    cudaGraphNodeParams params = {};
    params.type = cudaGraphNodeTypeConditional;
    params.conditional.handle = handle;
    params.conditional.type = cudaGraphCondTypeIf;
    params.conditional.size = 1;
    cudaGraphNode_t node;
    e = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
    if (e != cudaSuccess) return e;
    cudaGraphNode_t child;
    e = cudaGraphAddChildGraphNode(&child, params.conditional.phGraph_out[0], nullptr, 0,
                                   static_cast<cudaGraph_t>(body));
    if (e != cudaSuccess) return e;
    return cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
}
