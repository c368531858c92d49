// Row-group SpMV shared by the BCSR (bcsr.cu) and ELL (ell.cu) kernels:
// y[i] = sum over row i's entries j of vals[j] * x[col_idx[j]], row i's
// entries being [rows(i), rows(i + 1)) of col_idx and vals.  A CSR row
// reads its extent from row_ptr (CsrRows); an ELL row of the (n, k)
// row-major layout is the CSR row with row_ptr[i] = i * k (EllRows), its
// padding entries (column 0, value 0) adding 0 like any other product.
//
// A group of G lanes (G a power of two, 1 to 32) owns R consecutive
// rows, one after the other, and its lanes stride over each row's
// entries: lane l takes entries l, l + G, ..., so the groups of a warp
// read one contiguous run of col_idx and vals.  The first S * G entries of
// all R rows are loaded at once, the rest by a loop.  The x gathers are
// written inline with the products, as bcsr.cu always wrote them: nvcc
// issues every column and value load, then every gather, then the FMAs
// (SASS on sm_90a), and the BCSR kernel keeps its instructions (a first
// product written as an FMA onto zero cost BCSR P0 4 %).  Each row's
// partial sums meet by xor shuffles inside the group, and lane i % G
// stores row i.  No shared memory: each byte is used once.
#pragma once

#include "common.cuh"

static const int kThreads = 256;   // threads a block

inline int log2i(int v) {
    int l = 0;
    while ((1 << l) < v) ++l;
    return l;
}

inline bool pow2_in(int v, int lo, int hi) {
    return v >= lo && v <= hi && (v & (v - 1)) == 0;
}

// element loads through the read-only path, widened to the accumulator
__device__ __forceinline__ float ldg1(const float* p) { return __ldg(p); }
__device__ __forceinline__ double ldg1(const double* p) { return __ldg(p); }
__device__ __forceinline__ float ldg1(const __nv_bfloat16* p) {
    const unsigned short u = __ldg(reinterpret_cast<const unsigned short*>(p));
    return __uint_as_float((unsigned)u << 16);
}

struct CsrRows {
    const int* row_ptr;
    __device__ __forceinline__ int operator()(long long i) const {
        return __ldg(row_ptr + i);
    }
};

struct EllRows {      // the wrapper keeps n * k below 2^31
    int k;
    __device__ __forceinline__ int operator()(long long i) const {
        return (int)i * k;
    }
};

// extents of the R rows from r0 (rows past n are empty)
template <int R, typename Rows>
__device__ __forceinline__ void load_rows(const Rows& rows, long long r0,
                                          int n, int (&rp)[R + 1]) {
#pragma unroll
    for (int i = 0; i <= R; ++i) rp[i] = rows(r0 + i < n ? r0 + i : n);
}

// The group's part of y, for a grid of kThreads-thread blocks covering
// ceil(n / R) groups of 1 << lg lanes.  Every lane reaches the shuffles,
// those past n too.
template <int R, int S, typename A, typename Rows, typename TV,
          typename TX, typename TY>
__device__ __forceinline__ void row_group_spmv(
        const Rows& rows, const int* __restrict__ col_idx,
        const TV* __restrict__ vals, const TX* __restrict__ x,
        TY* __restrict__ y, int n, int m, int lg) {
    const int G = 1 << lg;
    const long long r0 = (((long long)blockIdx.x * kThreads + threadIdx.x)
                          >> lg) * R;
    const int lane = threadIdx.x & (G - 1);
    int rp[R + 1];
    load_rows<R>(rows, r0, n, rp);
    int c[R][S];
    A v[R][S], acc[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
        for (int s = 0; s < S; ++s) {
            const int j = rp[i] + lane + s * G;
            c[i][s] = j < rp[i + 1] ? col_idx[j] : -1;
            v[i][s] = j < rp[i + 1] ? A(widen(vals[j])) : A(0);
        }
#pragma unroll
    for (int i = 0; i < R; ++i) {
        acc[i] = (unsigned)c[i][0] < (unsigned)m
            ? v[i][0] * A(ldg1(x + c[i][0])) : A(0);
#pragma unroll
        for (int s = 1; s < S; ++s)
            if ((unsigned)c[i][s] < (unsigned)m)
                acc[i] += v[i][s] * A(ldg1(x + c[i][s]));
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
        for (int j = rp[i] + lane + S * G; j < rp[i + 1]; j += G) {
            const int cj = col_idx[j];
            if ((unsigned)cj < (unsigned)m)
                acc[i] += A(widen(vals[j])) * A(ldg1(x + cj));
        }
        for (int o = G >> 1; o > 0; o >>= 1)
            acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
        if (r0 + i < n && lane == (i & (G - 1))) narrow(y + r0 + i, acc[i]);
    }
}
