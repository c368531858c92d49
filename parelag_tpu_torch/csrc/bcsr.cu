// Row-compressed SpMV of the BcsrMatrix format, for one right-hand side
// and for s of them.
//
// Replaces parelag_tpu/ops/pallas_kernels.py::bcsr_spmv_pallas and, for
// (m, s) inputs, the XLA einsum of the JAX BcsrMatrix.matvec
// (parelag_tpu/ops/device_sparse.py).  Both computed y = A x over 8 x 128
// dense tiles, the TPU's shape.  On the V-cycle's transfers those tiles
// are 1-3 % full (P0 of the 96^3 flagship: 6.7 nonzeros per 1,024
// slots), and a product does 2 operations for every ~6 bytes it must
// read, far below the point where tensor cores would matter.  So the only
// lever on this card is bytes, and the port's BcsrMatrix keeps just the
// nonzeros in row order: row_ptr (n + 1) int32, col_idx (nnz) int32 and
// values (nnz).  A product reads each nonzero once (value + column), x
// from L2 (every main-path x fits in the 50 MB L2), and writes y once.
//
// Bound on Hopper: device-memory bytes, nnz * (value + 4) + 4 (n + 1)
// for the matrix plus x and y.  Sums accumulate in f32 (f64 for f64
// operands) and are stored in the promoted type of values and x, as
// BcsrMatrix.matvec gives.  A column index outside [0, m) reads 0, as the
// tile kernel's bounds check did.

#include "row_spmv.cuh"

// ---------------------------------------------------------------------
// Element and 16-byte loads through the read-only path, widened to the
// accumulator type, and the matching narrowing stores.

template <typename T, typename A>
__device__ __forceinline__ void ldg_cols(const T* p, A (&v)[1]) {
    v[0] = A(ldg1(p));
}
__device__ __forceinline__ void ldg_cols(const float* p, float (&v)[4]) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void ldg_cols(const double* p, double (&v)[2]) {
    const double2 q = __ldg(reinterpret_cast<const double2*>(p));
    v[0] = q.x; v[1] = q.y;
}
__device__ __forceinline__ void ldg_cols(const __nv_bfloat16* p,
                                         float (&v)[8]) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {       // low half = first element
        v[2 * k] = __uint_as_float(w[k] << 16);
        v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
}

template <typename T, typename A>
__device__ __forceinline__ void st_cols(T* p, const A (&v)[1]) {
    narrow(p, v[0]);
}
__device__ __forceinline__ void st_cols(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st_cols(float* p, const float (&v)[8]) {
    float4* q = reinterpret_cast<float4*>(p);
    q[0] = make_float4(v[0], v[1], v[2], v[3]);
    q[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void st_cols(double* p, const double (&v)[2]) {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}
__device__ __forceinline__ void st_cols(__nv_bfloat16* p,
                                        const float (&v)[8]) {
    unsigned w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
        w[k] = *reinterpret_cast<const unsigned*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// Rows per group, R.  The product is latency-bound before it is
// bytes-bound when a lane's only work is one chain of dependent loads
// (row_ptr, then col_idx and values, then x): with one row per group P0
// moved 1.43 TB/s at full occupancy.  So a group takes R = kRows
// consecutive rows and issues the loads of all of them before it uses
// any, R times the bytes in flight per lane (P0 in bf16, device us per
// launch on an H100 80GB HBM3 at 700 W: 17.5 at R = 1, 12.9 at 2, 11.7
// at 4, 12.4 at 8).  A product whose threads at R = 1 fit in one wave of
// the card (kWave) takes R = 1: its latency is one chain either way, and
// R > 1 would only serialise the long rows.
static const int kRows = 4;
static const long long kWave = 132LL * 2048;   // SMs x resident threads

static int rows_per_group(long long threads_at_one_row) {
    return threads_at_one_row <= kWave ? 1 : kRows;
}

// ---------------------------------------------------------------------
// One right-hand side: vector CSR with sub-warp groups, the row-group
// product of row_spmv.cuh with one entry a lane loaded at once (S = 1).
// G lanes a row (G a power of two from 2 to 32; the wrapper takes the one
// that covers the mean nonzeros per row, at most 16: P0 ~3.3 -> 4, R0 ~26
// -> 16, which took 9.8 us against 13.3 at G = 32); most rows have no
// more than G nonzeros.

template <typename TV, typename TX, typename TY, typename A, int R>
__global__ void __launch_bounds__(kThreads)
bcsr_row_spmv_kernel(const int* __restrict__ row_ptr,
                     const int* __restrict__ col_idx,
                     const TV* __restrict__ vals, const TX* __restrict__ x,
                     TY* __restrict__ y, int n, int m, int lg) {
    row_group_spmv<R, 1, A>(CsrRows{row_ptr}, col_idx, vals, x, y, n, m,
                            lg);
}

template <typename TV, typename TX, typename TY, typename A>
static int launch(const void* rp, const void* ci, const void* v,
                  const void* x, void* y, int n, int m, int g,
                  cudaStream_t s) {
    const int lg = log2i(g);
    const int r = rows_per_group((long long)n << lg);
    const long long threads = ((long long)n + r - 1) / r << lg;
    const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
    if (r == 1)
        bcsr_row_spmv_kernel<TV, TX, TY, A, 1><<<blocks, kThreads, 0, s>>>(
            (const int*)rp, (const int*)ci, (const TV*)v, (const TX*)x,
            (TY*)y, n, m, lg);
    else
        bcsr_row_spmv_kernel<TV, TX, TY, A, kRows>
            <<<blocks, kThreads, 0, s>>>((const int*)rp, (const int*)ci,
                                         (const TV*)v, (const TX*)x, (TY*)y,
                                         n, m, lg);
    return (int)cudaGetLastError();
}

// Supported (values, x) -> y: (bf16, bf16) -> bf16; (bf16 | f32, bf16 |
// f32) otherwise -> f32; (f64, f64) -> f64.  g: lanes per row.
extern "C" int bcsr_spmv_launch(int vdt, int xdt, const void* row_ptr,
                                const void* col_idx, const void* vals,
                                const void* x, void* y, int n, int m, int g,
                                void* stream) {
    if (n < 0 || m < 0 || !pow2_in(g, 2, 32))
        return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    typedef __nv_bfloat16 bf16;
    if (vdt == DT_BF16 && xdt == DT_BF16)
        return launch<bf16, bf16, bf16, float>(row_ptr, col_idx, vals, x, y,
                                               n, m, g, s);
    if (vdt == DT_BF16 && xdt == DT_F32)
        return launch<bf16, float, float, float>(row_ptr, col_idx, vals, x,
                                                 y, n, m, g, s);
    if (vdt == DT_F32 && xdt == DT_BF16)
        return launch<float, bf16, float, float>(row_ptr, col_idx, vals, x,
                                                 y, n, m, g, s);
    if (vdt == DT_F32 && xdt == DT_F32)
        return launch<float, float, float, float>(row_ptr, col_idx, vals, x,
                                                  y, n, m, g, s);
    if (vdt == DT_F64 && xdt == DT_F64)
        return launch<double, double, double, double>(row_ptr, col_idx, vals,
                                                      x, y, n, m, g, s);
    return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------
// s right-hand sides: Y (n, s) = A @ X (m, s), both row-major, s <= 64.
//
// A group of L lanes owns R consecutive rows (as above) and covers a
// row's s columns in chunks of W: W = 16 bytes of X (4 f32, 8 bf16, 2
// f64) when s is a multiple of it and X and Y are 16-byte aligned, else
// W = 1 (then a lane takes up to two chunks, so s <= 64 fits in 32
// lanes).  L is the power of two that covers the chunks, up to 32.  Each
// lane walks all of a row's nonzeros: their columns and values are read
// once per group (its L lanes read the same address: one broadcast), and
// each nonzero costs the lane one 16-byte load of its slice of X[col, :].
// The first nonzero of all R rows is loaded together; the lanes store Y's
// row slice in 16-byte pieces.  Splitting a row's nonzeros over K lane
// groups, as the 1-RHS kernel does, costs a K-way shuffle reduction of
// all W sums of a lane, and lost at every K tried (H100 80GB HBM3, 700 W,
// device us per launch, s = 16 in bf16: P0 ~3.3 nonzeros per row 32.0 /
// 35.8 / 55.2 at K = 1 / 2 / 4, R0 ~26 per row 28.1 / 44.0 / 51.6 at K =
// 1 / 4 / 16).  P0 at s = 16 in bf16: L = 2, sixteen groups per warp.
// Bound: bytes, the nonzeros once plus X's touched rows and Y.

// acc += v * X[xr, the lane's chunks]
template <typename TX, typename A, int W, int NCH>
__device__ __forceinline__ void fma_cols(A (&acc)[NCH][W], A v,
                                         const TX* __restrict__ xr, int l,
                                         int L, int C) {
#pragma unroll
    for (int h = 0; h < NCH; ++h) {
        const int ch = l + h * L;
        if (ch < C) {
            A xv[W];
            ldg_cols(xr + ch * W, xv);
#pragma unroll
            for (int w = 0; w < W; ++w) acc[h][w] += v * xv[w];
        }
    }
}

template <typename TV, typename TX, typename TY, typename A, int W, int R>
__global__ void __launch_bounds__(kThreads)
bcsr_row_spmm_kernel(const int* __restrict__ row_ptr,
                     const int* __restrict__ col_idx,
                     const TV* __restrict__ vals, const TX* __restrict__ x,
                     TY* __restrict__ y, int n, int m, int s, int lgl) {
    constexpr int NCH = W == 1 ? 2 : 1;     // column chunks per lane
    const int L = 1 << lgl;
    const long long r0 = (((long long)blockIdx.x * kThreads + threadIdx.x)
                          >> lgl) * R;
    const int l = threadIdx.x & (L - 1);
    const int C = s / W;                    // chunks of a row
    int rp[R + 1];
    load_rows<R>(CsrRows{row_ptr}, r0, n, rp);
    int c[R];
    A v[R], acc[R][NCH][W];
#pragma unroll
    for (int i = 0; i < R; ++i) {
        c[i] = rp[i] < rp[i + 1] ? col_idx[rp[i]] : -1;
        v[i] = rp[i] < rp[i + 1] ? A(widen(vals[rp[i]])) : A(0);
#pragma unroll
        for (int h = 0; h < NCH; ++h)
#pragma unroll
            for (int w = 0; w < W; ++w) acc[i][h][w] = A(0);
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
        if ((unsigned)c[i] < (unsigned)m)
            fma_cols(acc[i], v[i], x + (long long)c[i] * s, l, L, C);
#pragma unroll
    for (int i = 0; i < R; ++i) {
        for (int j = rp[i] + 1; j < rp[i + 1]; ++j) {
            const int cj = col_idx[j];
            if ((unsigned)cj < (unsigned)m)
                fma_cols(acc[i], A(widen(vals[j])), x + (long long)cj * s, l,
                         L, C);
        }
        if (r0 + i < n) {
#pragma unroll
            for (int h = 0; h < NCH; ++h) {
                const int ch = l + h * L;
                if (ch < C) st_cols(y + (r0 + i) * s + ch * W, acc[i][h]);
            }
        }
    }
}

template <typename TV, typename TX, typename TY, typename A, int W>
static void launch_mr_w(const void* rp, const void* ci, const void* v,
                        const void* x, void* y, int n, int m, int s,
                        cudaStream_t st) {
    const int chunks = s / W;
    const int lgl = log2i(chunks < 32 ? chunks : 32);
    const int r = rows_per_group((long long)n << lgl);
    const long long threads = ((long long)n + r - 1) / r << lgl;
    const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
    if (r == 1)
        bcsr_row_spmm_kernel<TV, TX, TY, A, W, 1>
            <<<blocks, kThreads, 0, st>>>((const int*)rp, (const int*)ci,
                                          (const TV*)v, (const TX*)x, (TY*)y,
                                          n, m, s, lgl);
    else
        bcsr_row_spmm_kernel<TV, TX, TY, A, W, kRows>
            <<<blocks, kThreads, 0, st>>>((const int*)rp, (const int*)ci,
                                          (const TV*)v, (const TX*)x, (TY*)y,
                                          n, m, s, lgl);
}

template <typename TV, typename TX, typename TY, typename A>
static int launch_mr(const void* rp, const void* ci, const void* v,
                     const void* x, void* y, int n, int m, int s,
                     cudaStream_t st) {
    constexpr int W = 16 / sizeof(TX);
    const bool aligned = ((reinterpret_cast<unsigned long long>(x)
                           | reinterpret_cast<unsigned long long>(y))
                          & 15ull) == 0;
    if (s % W == 0 && aligned)
        launch_mr_w<TV, TX, TY, A, W>(rp, ci, v, x, y, n, m, s, st);
    else
        launch_mr_w<TV, TX, TY, A, 1>(rp, ci, v, x, y, n, m, s, st);
    return (int)cudaGetLastError();
}

// The (values, x) -> y pairs of bcsr_spmv_launch; 1 <= s <= 64.
extern "C" int bcsr_spmv_multirhs_launch(int vdt, int xdt,
                                         const void* row_ptr,
                                         const void* col_idx,
                                         const void* vals, const void* x,
                                         void* y, int n, int m, int s,
                                         void* stream) {
    if (n < 0 || m < 0 || s < 1 || s > 64)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    typedef __nv_bfloat16 bf16;
    if (vdt == DT_BF16 && xdt == DT_BF16)
        return launch_mr<bf16, bf16, bf16, float>(row_ptr, col_idx, vals, x,
                                                  y, n, m, s, st);
    if (vdt == DT_BF16 && xdt == DT_F32)
        return launch_mr<bf16, float, float, float>(row_ptr, col_idx, vals,
                                                    x, y, n, m, s, st);
    if (vdt == DT_F32 && xdt == DT_BF16)
        return launch_mr<float, bf16, float, float>(row_ptr, col_idx, vals,
                                                    x, y, n, m, s, st);
    if (vdt == DT_F32 && xdt == DT_F32)
        return launch_mr<float, float, float, float>(row_ptr, col_idx, vals,
                                                     x, y, n, m, s, st);
    if (vdt == DT_F64 && xdt == DT_F64)
        return launch_mr<double, double, double, double>(
            row_ptr, col_idx, vals, x, y, n, m, s, st);
    return (int)cudaErrorInvalidValue;
}
