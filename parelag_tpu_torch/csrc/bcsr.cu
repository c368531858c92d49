// BCSR SpMV over 8 x 128 tiles.
//
// Replaces parelag_tpu/ops/pallas_kernels.py::bcsr_spmv_pallas (on the
// TPU the same product ran as XLA, ops/device_sparse.py
// BcsrMatrix.matvec).  Layout: col_blocks (nbr, kb) int32 and tiles
// (nbr, kb, 8, 128); y[8 rb + r] = sum_k sum_c tiles[rb, k, r, c]
// * x[128 col_blocks[rb, k] + c].  It carries the P/R transfers of the
// V-cycle (bf16 tiles, bf16 or f32 x) and any coarse operator past the
// DIA offset limit.
//
// Design: one 128-thread block per row block, thread c owns column c of
// every tile of the row block.  Each (k, r) tile row is one coalesced
// 128-element read, the x element is read once per tile and reused for
// its 8 rows, and the 8 per-row partial sums reduce across the block
// (warp shuffles, then 4 warps through shared memory).  x is read with a
// bounds check, so no padded copy of x is made.
//
// Bound on Hopper: device-memory bytes.  The tile stream (nbr * kb * 1024
// elements) dominates; the padding slots of short row blocks are zero
// tiles that are still read, as in the TPU layout.  Accumulation is f32
// (f64 for f64 operands); the result is stored in the promoted type of
// tiles and x, as BcsrMatrix.matvec gives.

#include "common.cuh"

static const int kCols = 128;  // threads per block == tile width
static const int kRows = 8;    // tile height
static const int kWarps = kCols / 32;

template <typename A>
__device__ __forceinline__ A warp_sum(A v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

template <typename TT, typename TX, typename TY, typename A>
__global__ void __launch_bounds__(kCols)
bcsr_spmv_kernel(const int* __restrict__ col_blocks,
                 const TT* __restrict__ tiles, const TX* __restrict__ x,
                 TY* __restrict__ y, int kb, int n, int m) {
    const int rb = blockIdx.x;
    const int c = threadIdx.x;
    const int* cb = col_blocks + (long long)rb * kb;
    const TT* t = tiles + (long long)rb * kb * (kRows * kCols);
    A acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = A(0);
    for (int k = 0; k < kb; ++k) {
        const long long col = (long long)cb[k] * kCols + c;
        const A xv = (col >= 0 && col < m) ? A(widen(x[col])) : A(0);
        const TT* tk = t + (long long)k * (kRows * kCols) + c;
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] += A(widen(tk[r * kCols])) * xv;
    }
    __shared__ A part[kRows][kWarps];
    const int warp = c >> 5, lane = c & 31;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        const A v = warp_sum(acc[r]);
        if (lane == 0) part[r][warp] = v;
    }
    __syncthreads();
    if (c < kRows) {
        A s = A(0);
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += part[c][w];
        const long long row = (long long)rb * kRows + c;
        if (row < n) narrow(y + row, s);
    }
}

template <typename TT, typename TX, typename TY, typename A>
static int launch(const void* cb, const void* tiles, const void* x, void* y,
                  int nbr, int kb, int n, int m, cudaStream_t s) {
    bcsr_spmv_kernel<TT, TX, TY, A><<<nbr, kCols, 0, s>>>(
        (const int*)cb, (const TT*)tiles, (const TX*)x, (TY*)y, kb, n, m);
    return (int)cudaGetLastError();
}

// Supported (tiles, x) -> y: (bf16, bf16) -> bf16; (bf16 | f32, bf16 |
// f32) otherwise -> f32; (f64, f64) -> f64.
extern "C" int bcsr_spmv_launch(int tdt, int xdt, const void* col_blocks,
                                const void* tiles, const void* x, void* y,
                                int nbr, int kb, int n, int m,
                                void* stream) {
    if (nbr < 0 || kb < 1 || n < 0 || m < 0 || n > nbr * kRows)
        return (int)cudaErrorInvalidValue;
    if (nbr == 0 || n == 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    typedef __nv_bfloat16 bf16;
    if (tdt == DT_BF16 && xdt == DT_BF16)
        return launch<bf16, bf16, bf16, float>(col_blocks, tiles, x, y, nbr,
                                               kb, n, m, s);
    if (tdt == DT_BF16 && xdt == DT_F32)
        return launch<bf16, float, float, float>(col_blocks, tiles, x, y,
                                                 nbr, kb, n, m, s);
    if (tdt == DT_F32 && xdt == DT_BF16)
        return launch<float, bf16, float, float>(col_blocks, tiles, x, y,
                                                 nbr, kb, n, m, s);
    if (tdt == DT_F32 && xdt == DT_F32)
        return launch<float, float, float, float>(col_blocks, tiles, x, y,
                                                  nbr, kb, n, m, s);
    if (tdt == DT_F64 && xdt == DT_F64)
        return launch<double, double, double, double>(col_blocks, tiles, x,
                                                      y, nbr, kb, n, m, s);
    return (int)cudaErrorInvalidValue;
}
