// ELL (padded-row) SpMV: y[i] = sum_k val[i, k] * x[idx[i, k]].
//
// Replaces parelag_tpu/ops/pallas_kernels.py::ell_spmv_pallas (which
// never lowered on the TPU: Mosaic has no 1-D gather).  ELL carries the
// Hiptmair smoother's D, D^T and auxiliary operator on the Maxwell lane.
// Layout as the port's EllMatrix: idx (n, k) int32 and val (n, k)
// row-major, padding entries at column 0 with value 0.  Rows are not
// padded to a tile multiple: the grid covers n and the last block masks
// its ragged edge.
//
// Design: one thread per row walks its k entries.  A warp's k loads of
// idx and val cover 32 * k contiguous elements, so each row's run is
// fetched from device memory once and served from L1 for the rest of the
// loop; the x gathers hit L2 (x of the Maxwell lane's operators is at
// most 45,000 entries).  Bound on Hopper: device-memory bytes, idx + val
// read once plus x and y; two flops per entry.  Sums accumulate in the
// value dtype (f32 or f64), as the XLA einsum of ell_matvec does.

#include "common.cuh"

template <typename T>
__global__ void ell_spmv_kernel(const int* __restrict__ idx,
                                const T* __restrict__ val,
                                const T* __restrict__ x, T* __restrict__ y,
                                int n, int k, int m) {
    using A = typename AccOf<T>::type;
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int* ir = idx + i * k;
    const T* vr = val + i * k;
    A acc = A(0);
    for (int j = 0; j < k; ++j) {
        const int c = ir[j];
        if (c >= 0 && c < m) acc += widen(vr[j]) * widen(x[c]);
    }
    narrow(y + i, acc);
}

static const int kEllThreads = 256;

extern "C" int ell_spmv_launch(int dtype, const void* idx, const void* val,
                               const void* x, void* y, int n, int k, int m,
                               void* stream) {
    if (n < 0 || k < 1 || m < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    dim3 grid((unsigned)((n + kEllThreads - 1) / kEllThreads));
    cudaStream_t s = (cudaStream_t)stream;
    switch (dtype) {
        case DT_F32:
            ell_spmv_kernel<float><<<grid, kEllThreads, 0, s>>>(
                (const int*)idx, (const float*)val, (const float*)x,
                (float*)y, n, k, m);
            break;
        case DT_F64:
            ell_spmv_kernel<double><<<grid, kEllThreads, 0, s>>>(
                (const int*)idx, (const double*)val, (const double*)x,
                (double*)y, n, k, m);
            break;
        default:
            return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
