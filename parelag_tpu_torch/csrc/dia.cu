// DIA (diagonal / shift) SpMV and the fused weighted-Jacobi sweep.
//
// Replaces parelag_tpu/ops/pallas_kernels.py::dia_spmv_pallas and
// ::dia_jacobi_sweep_pallas.  The table is row aligned: data[d * ld + i]
// multiplies x[i + offs[d]].  On the TPU the kernels kept a padded x in
// VMEM and took static slices of a 1024-aligned superblock; here each
// thread owns one row, reads its nd coefficients (neighbouring threads on
// neighbouring addresses, so every table read is one coalesced stream)
// and gathers x[i + off] with a bounds check instead of a padded x.
//
// Bound on Hopper: device-memory bytes.  A matvec reads the nd x n table
// once (nd = 27 on the H1 grid) plus x and y; the nd shifted x reads of
// a block mostly hit L1/L2, since on an N^3 cell grid the offsets span
// only +-((N+1)^2 + (N+1) + 1) rows.  Two flops per table entry sit far
// below the card's compute roofline.
//
// The offsets travel by value in a __grid_constant__ struct (nd <= 48,
// the DIA-format limit of solvers/hierarchy.py), so no device copy of
// them is made.  Sums accumulate in f32 for f32 and bf16 tables (the
// Pallas kernel accumulated in the table dtype) and in f64 for f64, and
// are stored in the table dtype.

#include "common.cuh"

#define DIA_MAX_OFFS 48

struct DiaOffs {
    int v[DIA_MAX_OFFS];
};

template <typename T>
__global__ void dia_spmv_kernel(const T* __restrict__ data,
                                const T* __restrict__ x, T* __restrict__ y,
                                const __grid_constant__ DiaOffs offs, int nd,
                                long long ld, int n, int m) {
    using A = typename AccOf<T>::type;
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    A acc = A(0);
    for (int d = 0; d < nd; ++d) {
        long long j = i + offs.v[d];
        if (j >= 0 && j < m) acc += widen(data[d * ld + i]) * widen(x[j]);
    }
    narrow(y + i, acc);
}

// x'[i] = x[i] + dw[i] * (b[i] - sum_d data[d, i] x[i + offs[d]])
// (dw carries omega * dinv); square operator, separate output.
template <typename T>
__global__ void dia_jacobi_kernel(const T* __restrict__ data,
                                  const T* __restrict__ x,
                                  const T* __restrict__ b,
                                  const T* __restrict__ dw,
                                  T* __restrict__ xout,
                                  const __grid_constant__ DiaOffs offs,
                                  int nd, long long ld, int n) {
    using A = typename AccOf<T>::type;
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    A acc = A(0);
    for (int d = 0; d < nd; ++d) {
        long long j = i + offs.v[d];
        if (j >= 0 && j < n) acc += widen(data[d * ld + i]) * widen(x[j]);
    }
    narrow(xout + i, widen(x[i]) + widen(dw[i]) * (widen(b[i]) - acc));
}

static const int kThreads = 256;

static bool pack_offs(DiaOffs* o, const int* offs, int nd) {
    if (nd < 1 || nd > DIA_MAX_OFFS) return false;
    for (int d = 0; d < nd; ++d) o->v[d] = offs[d];
    return true;
}

extern "C" int dia_spmv_launch(int dtype, const void* data, const void* x,
                               void* y, const int* offs, int nd, long long ld,
                               int n, int m, void* stream) {
    DiaOffs o;
    if (!pack_offs(&o, offs, nd) || n < 0 || m < 0)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    dim3 grid((unsigned)((n + kThreads - 1) / kThreads));
    cudaStream_t s = (cudaStream_t)stream;
    switch (dtype) {
        case DT_F32:
            dia_spmv_kernel<float><<<grid, kThreads, 0, s>>>(
                (const float*)data, (const float*)x, (float*)y, o, nd, ld, n,
                m);
            break;
        case DT_BF16:
            dia_spmv_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
                (const __nv_bfloat16*)data, (const __nv_bfloat16*)x,
                (__nv_bfloat16*)y, o, nd, ld, n, m);
            break;
        case DT_F64:
            dia_spmv_kernel<double><<<grid, kThreads, 0, s>>>(
                (const double*)data, (const double*)x, (double*)y, o, nd, ld,
                n, m);
            break;
        default:
            return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

extern "C" int dia_jacobi_sweep_launch(int dtype, const void* data,
                                       const void* x, const void* b,
                                       const void* dw, void* xout,
                                       const int* offs, int nd, long long ld,
                                       int n, void* stream) {
    DiaOffs o;
    if (!pack_offs(&o, offs, nd) || n < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    dim3 grid((unsigned)((n + kThreads - 1) / kThreads));
    cudaStream_t s = (cudaStream_t)stream;
    switch (dtype) {
        case DT_F32:
            dia_jacobi_kernel<float><<<grid, kThreads, 0, s>>>(
                (const float*)data, (const float*)x, (const float*)b,
                (const float*)dw, (float*)xout, o, nd, ld, n);
            break;
        case DT_BF16:
            dia_jacobi_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
                (const __nv_bfloat16*)data, (const __nv_bfloat16*)x,
                (const __nv_bfloat16*)b, (const __nv_bfloat16*)dw,
                (__nv_bfloat16*)xout, o, nd, ld, n);
            break;
        case DT_F64:
            dia_jacobi_kernel<double><<<grid, kThreads, 0, s>>>(
                (const double*)data, (const double*)x, (const double*)b,
                (const double*)dw, (double*)xout, o, nd, ld, n);
            break;
        default:
            return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
