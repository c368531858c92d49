// DIA (diagonal / shift) SpMV and the fused weighted-Jacobi sweep, for
// one right-hand side and for s of them.
//
// Replaces parelag_tpu/ops/pallas_kernels.py::dia_spmv_pallas,
// ::dia_jacobi_sweep_pallas, ::dia_spmv_multirhs_pallas and
// ::dia_jacobi_sweep_multirhs_pallas.  The table is row aligned:
// data[d * ld + i] multiplies x[i + offs[d]].  On the TPU the kernels
// kept a padded x in VMEM and took static slices of a 1024-aligned
// superblock; here each thread owns one row (the s-column kernels below:
// one row and a group of its columns), reads its nd coefficients
// (neighbouring threads on neighbouring addresses, so every table read is
// one coalesced stream) and gathers x[i + off] with a bounds check
// instead of a padded x.
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

// ---------------------------------------------------------------------
// s right-hand sides (the multi-RHS block PCG of the H1 flagship)
//
// X is (m, s) row-major, the layout pcg and the V-cycle hold; the TPU
// kernels took a transposed (s, xlen) copy because Mosaic shifts along
// lanes, which this card does not need.  One thread per (row, group of W
// neighbouring columns), the groups of a row on neighbouring threads: each
// thread reads the coefficient data[d, i] once for its W columns (the
// G = s / W threads of a row read the same address, one broadcast, so the
// table crosses device memory once for all s columns, the point of the
// kernel) and W columns of X[i + off, :] as one 16-byte load, so the X
// loads of a warp are one contiguous run.  W = 16 bytes / element (4 f32,
// 8 bf16, 2 f64) when s is a multiple of it and the tensors are 16-byte
// aligned, else W = 1.  Bound: bytes, table + X + Y (+ B for the sweep):
// at s = 16 on the 27-offset fine grid the table is ~46 % of them in f32.
// s <= 64 (the JAX module's _MAX_RHS), checked by the wrapper.

// W elements of T at p, widened to the accumulator type (W = 1: one
// element; W > 1: one 16-byte load of an aligned run)
template <typename T, int W> struct Cols;
template <typename T> struct Cols<T, 1> {
    using A = typename AccOf<T>::type;
    __device__ static void load(const T* p, A (&v)[1]) { v[0] = widen(*p); }
    __device__ static void store(T* p, const A (&v)[1]) { narrow(p, v[0]); }
};
template <> struct Cols<float, 4> {
    __device__ static void load(const float* p, float (&v)[4]) {
        const float4 q = *reinterpret_cast<const float4*>(p);
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    }
    __device__ static void store(float* p, const float (&v)[4]) {
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    }
};
template <> struct Cols<double, 2> {
    __device__ static void load(const double* p, double (&v)[2]) {
        const double2 q = *reinterpret_cast<const double2*>(p);
        v[0] = q.x; v[1] = q.y;
    }
    __device__ static void store(double* p, const double (&v)[2]) {
        *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
    }
};
template <> struct Cols<__nv_bfloat16, 8> {
    __device__ static void load(const __nv_bfloat16* p, float (&v)[8]) {
        const uint4 q = *reinterpret_cast<const uint4*>(p);
        const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            // the two bf16 halves of a word: low = first element
            v[2 * k] = __uint_as_float(w[k] << 16);
            v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
        }
    }
    __device__ static void store(__nv_bfloat16* p, const float (&v)[8]) {
        unsigned w[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k],
                                                           v[2 * k + 1]);
            w[k] = *reinterpret_cast<const unsigned*>(&h);
        }
        *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    }
};

template <typename T, int W>
__global__ void dia_spmv_mr_kernel(const T* __restrict__ data,
                                   const T* __restrict__ x,
                                   T* __restrict__ y,
                                   const __grid_constant__ DiaOffs offs,
                                   int nd, long long ld, int n, int m, int s) {
    using A = typename AccOf<T>::type;
    const int G = s / W;
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long i = t / G;
    const int q = (int)(t - i * G) * W;
    if (i >= n) return;
    A acc[W], xv[W];
#pragma unroll
    for (int w = 0; w < W; ++w) acc[w] = A(0);
    for (int d = 0; d < nd; ++d) {
        const long long j = i + offs.v[d];
        if (j >= 0 && j < m) {
            const A c = widen(data[d * ld + i]);
            Cols<T, W>::load(x + j * s + q, xv);
#pragma unroll
            for (int w = 0; w < W; ++w) acc[w] += c * xv[w];
        }
    }
    Cols<T, W>::store(y + i * s + q, acc);
}

// X'[i, q] = X[i, q] + dw[i] * (B[i, q] - sum_d data[d, i] X[i + off_d, q])
template <typename T, int W>
__global__ void dia_jacobi_mr_kernel(const T* __restrict__ data,
                                     const T* __restrict__ x,
                                     const T* __restrict__ b,
                                     const T* __restrict__ dw,
                                     T* __restrict__ xout,
                                     const __grid_constant__ DiaOffs offs,
                                     int nd, long long ld, int n, int s) {
    using A = typename AccOf<T>::type;
    const int G = s / W;
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long i = t / G;
    const int q = (int)(t - i * G) * W;
    if (i >= n) return;
    A acc[W], xv[W];
#pragma unroll
    for (int w = 0; w < W; ++w) acc[w] = A(0);
    for (int d = 0; d < nd; ++d) {
        const long long j = i + offs.v[d];
        if (j >= 0 && j < n) {
            const A c = widen(data[d * ld + i]);
            Cols<T, W>::load(x + j * s + q, xv);
#pragma unroll
            for (int w = 0; w < W; ++w) acc[w] += c * xv[w];
        }
    }
    A bv[W];
    Cols<T, W>::load(x + i * s + q, xv);
    Cols<T, W>::load(b + i * s + q, bv);
    const A di = widen(dw[i]);
#pragma unroll
    for (int w = 0; w < W; ++w) acc[w] = xv[w] + di * (bv[w] - acc[w]);
    Cols<T, W>::store(xout + i * s + q, acc);
}

// columns per thread: a 16-byte run when s and every (n, s) tensor allow
template <typename T>
static int cols_per_thread(int s, const void* a, const void* b,
                           const void* c) {
    const int w = 16 / (int)sizeof(T);
    const bool aligned = ((reinterpret_cast<unsigned long long>(a)
                           | reinterpret_cast<unsigned long long>(b)
                           | reinterpret_cast<unsigned long long>(c))
                          & 15ull) == 0;
    return (s % w == 0 && aligned) ? w : 1;
}

static dim3 mr_grid(int n, int s, int w) {
    const long long total = (long long)n * (s / w);
    return dim3((unsigned)((total + kThreads - 1) / kThreads));
}

template <typename T, int W>
static void spmv_mr(const void* data, const void* x, void* y,
                    const DiaOffs& o, int nd, long long ld, int n, int m,
                    int s, cudaStream_t st) {
    dia_spmv_mr_kernel<T, W><<<mr_grid(n, s, W), kThreads, 0, st>>>(
        (const T*)data, (const T*)x, (T*)y, o, nd, ld, n, m, s);
}

template <typename T>
static void spmv_mr_any(const void* data, const void* x, void* y,
                        const DiaOffs& o, int nd, long long ld, int n, int m,
                        int s, cudaStream_t st) {
    if (cols_per_thread<T>(s, x, y, y) > 1)
        spmv_mr<T, 16 / sizeof(T)>(data, x, y, o, nd, ld, n, m, s, st);
    else
        spmv_mr<T, 1>(data, x, y, o, nd, ld, n, m, s, st);
}

extern "C" int dia_spmv_multirhs_launch(int dtype, const void* data,
                                        const void* x, void* y,
                                        const int* offs, int nd,
                                        long long ld, int n, int m, int s,
                                        void* stream) {
    DiaOffs o;
    if (!pack_offs(&o, offs, nd) || n < 0 || m < 0 || s < 1)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    switch (dtype) {
        case DT_F32:
            spmv_mr_any<float>(data, x, y, o, nd, ld, n, m, s, st);
            break;
        case DT_BF16:
            spmv_mr_any<__nv_bfloat16>(data, x, y, o, nd, ld, n, m, s, st);
            break;
        case DT_F64:
            spmv_mr_any<double>(data, x, y, o, nd, ld, n, m, s, st);
            break;
        default:
            return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

template <typename T, int W>
static void jacobi_mr(const void* data, const void* x, const void* b,
                      const void* dw, void* xout, const DiaOffs& o, int nd,
                      long long ld, int n, int s, cudaStream_t st) {
    dia_jacobi_mr_kernel<T, W><<<mr_grid(n, s, W), kThreads, 0, st>>>(
        (const T*)data, (const T*)x, (const T*)b, (const T*)dw, (T*)xout, o,
        nd, ld, n, s);
}

template <typename T>
static void jacobi_mr_any(const void* data, const void* x, const void* b,
                          const void* dw, void* xout, const DiaOffs& o,
                          int nd, long long ld, int n, int s,
                          cudaStream_t st) {
    if (cols_per_thread<T>(s, x, b, xout) > 1)
        jacobi_mr<T, 16 / sizeof(T)>(data, x, b, dw, xout, o, nd, ld, n, s,
                                     st);
    else
        jacobi_mr<T, 1>(data, x, b, dw, xout, o, nd, ld, n, s, st);
}

extern "C" int dia_jacobi_sweep_multirhs_launch(int dtype, const void* data,
                                                const void* x, const void* b,
                                                const void* dw, void* xout,
                                                const int* offs, int nd,
                                                long long ld, int n, int s,
                                                void* stream) {
    DiaOffs o;
    if (!pack_offs(&o, offs, nd) || n < 0 || s < 1)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    switch (dtype) {
        case DT_F32:
            jacobi_mr_any<float>(data, x, b, dw, xout, o, nd, ld, n, s, st);
            break;
        case DT_BF16:
            jacobi_mr_any<__nv_bfloat16>(data, x, b, dw, xout, o, nd, ld, n,
                                         s, st);
            break;
        case DT_F64:
            jacobi_mr_any<double>(data, x, b, dw, xout, o, nd, ld, n, s,
                                  st);
            break;
        default:
            return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
