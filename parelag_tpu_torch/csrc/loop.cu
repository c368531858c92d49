// The loop test of the device-resident PCG, and the graph surgery that
// turns a captured body into a CUDA graph WHILE loop.
//
// Counterpart of the `cond` of parelag_tpu/solvers/cg.py::pcg's
// lax.while_loop (cg.py:36-38): go = any(nom > tol2) & (it < maxiter).
// The JAX package leaves that test to XLA; it is no Pallas kernel and
// this is no port of one.  The PCG of solvers/cg.py::compile_pcg runs
// as one captured graph: the init part, one test launch, then a WHILE
// conditional node whose body is the PCG body followed by this kernel,
// which bumps the iteration counter and sets the node's handle.  The
// host reads nothing until the graph ends.
//
// Bound on Hopper: launch latency.  It reads s <= 64 values of nom and
// tol2 (one block, one thread a column, a block-wide OR) and writes one
// int; its time is the launch's.
//
// The loop (loop_while_begin / loop_while_end): PyTorch 2.11's
// CUDAGraph exposes no conditional node, so the capture adds the WHILE
// node to the graph PyTorch is capturing through the runtime API and
// captures the body on a second stream straight into the node's body
// graph (cudaStreamBeginCaptureToGraph); the caller routes that
// stream's allocations to the graph's private memory pool.

#include <dlfcn.h>

#include <vector>

#include "common.cuh"

constexpr int kLoopThreads = 64;   // the most columns (MAX_RHS)

template <typename T>
__global__ void __launch_bounds__(kLoopThreads)
pcg_loop_test_kernel(const T* __restrict__ nom, const T* __restrict__ tol2,
                     int s, int* it, bool* go, int step, int maxiter,
                     cudaGraphConditionalHandle handle, int set) {
    const int j = threadIdx.x;
    // a NaN compares false, as jnp.any(nom > tol2) does
    const int any = __syncthreads_or(j < s && nom[j] > tol2[j]);
    if (j == 0) {
        const int k = *it + step;
        *it = k;
        const int g = any && k < maxiter;
        if (go) *go = g != 0;
        if (set) cudaGraphSetConditional(handle, g ? 1u : 0u);
    }
}

// dt: DT_F32 or DT_F64 (nom, tol2 of s <= 64 entries); it: one int,
// bumped by step; go (may be null): one bool, the test's value; set: 1
// sets the conditional handle (only inside a graph that owns it)
extern "C" int pcg_loop_test_launch(int dt, const void* nom,
                                    const void* tol2, int s, void* it,
                                    void* go, int step, int maxiter,
                                    unsigned long long handle, int set,
                                    void* stream) {
    if (s < 1 || s > kLoopThreads) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    int* itp = (int*)it;
    bool* gop = (bool*)go;
    if (dt == DT_F32)
        pcg_loop_test_kernel<float><<<1, kLoopThreads, 0, st>>>(
            (const float*)nom, (const float*)tol2, s, itp, gop, step,
            maxiter, handle, set);
    else if (dt == DT_F64)
        pcg_loop_test_kernel<double><<<1, kLoopThreads, 0, st>>>(
            (const double*)nom, (const double*)tol2, s, itp, gop, step,
            maxiter, handle, set);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

// a conditional handle of the graph `stream` is capturing (default
// value 0; the kernel sets it)
extern "C" int loop_handle_create(void* stream, unsigned long long* out) {
    cudaStreamCaptureStatus status;
    cudaGraph_t g = nullptr;
    cudaError_t e = cudaStreamGetCaptureInfo((cudaStream_t)stream, &status,
                                             nullptr, &g, nullptr, nullptr);
    if (e != cudaSuccess) return (int)e;
    if (status != cudaStreamCaptureStatusActive)
        return (int)cudaErrorStreamCaptureInvalidated;
    cudaGraphConditionalHandle h;
    e = cudaGraphConditionalHandleCreate(&h, g, 0, 0);
    *out = (unsigned long long)h;
    return (int)e;
}

// Open the loop: add a WHILE node on `handle` after all that `stream`
// has captured, make it the only node the stream's later work depends
// on, and start capturing `body_stream` into the node's body graph
// (returned in body_out).  loop_while_end closes the body.
extern "C" int loop_while_begin(void* stream, void* body_stream,
                                unsigned long long handle,
                                void** body_out) {
    cudaStream_t st = (cudaStream_t)stream;
    cudaStreamCaptureStatus status;
    cudaGraph_t g = nullptr;
    const cudaGraphNode_t* deps = nullptr;
    size_t nd = 0;
    cudaError_t e = cudaStreamGetCaptureInfo(st, &status, nullptr, &g, &deps,
                                             &nd);
    if (e != cudaSuccess) return (int)e;
    if (status != cudaStreamCaptureStatusActive)
        return (int)cudaErrorStreamCaptureInvalidated;
    cudaGraphNodeParams p = {};
    p.type = cudaGraphNodeTypeConditional;
    p.conditional.handle = (cudaGraphConditionalHandle)handle;
    p.conditional.type = cudaGraphCondTypeWhile;
    p.conditional.size = 1;
    cudaGraphNode_t w;
    if ((e = cudaGraphAddNode(&w, g, deps, nd, &p)) != cudaSuccess)
        return (int)e;
    if ((e = cudaStreamUpdateCaptureDependencies(
             st, &w, 1, cudaStreamSetCaptureDependencies)) != cudaSuccess)
        return (int)e;
    cudaGraph_t body = p.conditional.phGraph_out[0];
    *body_out = (void*)body;
    return (int)cudaStreamBeginCaptureToGraph(
        (cudaStream_t)body_stream, body, nullptr, nullptr, 0,
        cudaStreamCaptureModeGlobal);
}

extern "C" int loop_while_end(void* body_stream) {
    cudaGraph_t g = nullptr;
    return (int)cudaStreamEndCapture((cudaStream_t)body_stream, &g);
}

// the runtime's last error, cleared (after a capture that failed, so
// that the next launcher's cudaGetLastError sees only its own launch)
extern "C" int loop_last_error() { return (int)cudaGetLastError(); }

// Count the nodes of `graph` and of the child graphs it holds:
// out[0] all nodes, out[1] kernel nodes, out[2] kernel nodes of this
// library's kernels (the hand-written ones: their host stubs lie in the
// shared object that holds this function).
static void count(cudaGraph_t g, long long* out, const void* base) {
    size_t n = 0;
    if (cudaGraphGetNodes(g, nullptr, &n) != cudaSuccess || n == 0) return;
    std::vector<cudaGraphNode_t> nodes(n);
    if (cudaGraphGetNodes(g, nodes.data(), &n) != cudaSuccess) return;
    for (cudaGraphNode_t nd : nodes) {
        cudaGraphNodeType t;
        if (cudaGraphNodeGetType(nd, &t) != cudaSuccess) continue;
        ++out[0];
        if (t == cudaGraphNodeTypeKernel) {
            ++out[1];
            cudaKernelNodeParams kp;
            Dl_info info;
            if (cudaGraphKernelNodeGetParams(nd, &kp) == cudaSuccess
                && dladdr(kp.func, &info) && info.dli_fbase == base)
                ++out[2];
        } else if (t == cudaGraphNodeTypeGraph) {
            cudaGraph_t c;
            if (cudaGraphChildGraphNodeGetGraph(nd, &c) == cudaSuccess)
                count(c, out, base);
        }
    }
}

extern "C" int loop_graph_count(void* graph, long long* out) {
    Dl_info self;
    if (!dladdr((const void*)&loop_graph_count, &self))
        return (int)cudaErrorUnknown;
    out[0] = out[1] = out[2] = 0;
    count((cudaGraph_t)graph, out, self.dli_fbase);
    // a kernel node launched through the driver API (cuBLAS) may refuse
    // the runtime's query: clear that error, so the next launcher's
    // cudaGetLastError sees only its own launch
    cudaGetLastError();
    return 0;
}
