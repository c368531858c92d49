// BCSR SpMV over 8 x 128 tiles, for one right-hand side and for s of
// them.
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

// ---------------------------------------------------------------------
// s right-hand sides: Y (n, s) = BCSR @ X (m, s), both row-major.
//
// No Pallas kernel: the JAX package computed this as an XLA einsum over
// the gathered (nbr, kb, 128, s) operand (ops/device_sparse.py
// BcsrMatrix.matvec), 3.7 GB per apply of P0 at 96^3 with s = 16.  Here
// one 128-thread block per row block streams each tile once for all s
// columns.  Thread c loads column c of the tile (8 coalesced rows) and a
// warp ballot lists which of the warp's 32 columns hold a nonzero: the
// transfers' tiles are ~1 % full (P0 at 96^3: 6.7 nonzeros in 1,024
// slots), so the work follows the nonzero columns, not the slots.  The
// warp walks its listed columns together: lane l owns output column
// q = 16 ch + l % 16 of rows 4 (l / 16) .. 4 (l / 16) + 3, takes the
// column's 8 tile values from the owning lane by shuffles and reads
// X[128 cb + c, q] (the 16 lanes of a half-warp read one contiguous run,
// and both halves the same addresses).  The four warps' partial sums meet
// in shared memory at the end.  Bound: bytes, the tile stream as for one
// column, plus the X rows the nonzeros touch and the (n, s) output.
// s <= 64: four chunks of 16 columns, four rows each, in registers.

static const int kRhsChunk = 16;              // columns per chunk
static const int kMaxChunks = 4;              // s <= 64
static const int kLaneRows = kRows / 2;       // rows per lane

template <typename TT, typename TX, typename TY, typename A>
__global__ void __launch_bounds__(kCols)
bcsr_spmm_kernel(const int* __restrict__ col_blocks,
                 const TT* __restrict__ tiles, const TX* __restrict__ x,
                 TY* __restrict__ y, int kb, int n, int m, int s) {
    const int rb = blockIdx.x;
    const int c = threadIdx.x;
    const int warp = c >> 5, lane = c & 31;
    const bool upper = lane >= kRhsChunk;     // rows 4..7, else 0..3
    const int q0 = lane % kRhsChunk;
    const int* cb = col_blocks + (long long)rb * kb;
    const TT* tb = tiles + (long long)rb * kb * (kRows * kCols);
    A acc[kMaxChunks][kLaneRows];
#pragma unroll
    for (int ch = 0; ch < kMaxChunks; ++ch)
#pragma unroll
        for (int j = 0; j < kLaneRows; ++j) acc[ch][j] = A(0);
    for (int k = 0; k < kb; ++k) {
        const long long col0 = (long long)cb[k] * kCols;
        const TT* tk = tb + (long long)k * (kRows * kCols) + c;
        A tv[kRows];
        bool any = false;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
            tv[r] = A(widen(tk[r * kCols]));
            any |= (tv[r] != A(0));
        }
        unsigned mask = __ballot_sync(0xffffffffu, any && col0 + c < m);
        while (mask) {                        // uniform over the warp
            const int src = __ffs(mask) - 1;
            mask &= mask - 1;
            A t4[kLaneRows];
#pragma unroll
            for (int j = 0; j < kLaneRows; ++j) {
                const A lo = __shfl_sync(0xffffffffu, tv[j], src);
                const A hi = __shfl_sync(0xffffffffu, tv[j + kLaneRows], src);
                t4[j] = upper ? hi : lo;
            }
            const TX* xr = x + (col0 + (warp << 5) + src) * s;
#pragma unroll
            for (int ch = 0; ch < kMaxChunks; ++ch) {
                const int q = ch * kRhsChunk + q0;
                if (ch * kRhsChunk < s) {     // uniform over the warp
                    const A xv = q < s ? A(widen(xr[q])) : A(0);
#pragma unroll
                    for (int j = 0; j < kLaneRows; ++j)
                        acc[ch][j] += t4[j] * xv;
                }
            }
        }
    }
    __shared__ A part[kCols / 32][kRows][kRhsChunk];
    const int r = c / kRhsChunk, qq = c % kRhsChunk;   // 8 x 16 outputs
    const long long row = (long long)rb * kRows + r;
#pragma unroll
    for (int ch = 0; ch < kMaxChunks; ++ch) {
        if (ch * kRhsChunk < s) {             // uniform over the block
            __syncthreads();                  // last chunk's readers done
#pragma unroll
            for (int j = 0; j < kLaneRows; ++j)
                part[warp][(upper ? kLaneRows : 0) + j][q0] = acc[ch][j];
            __syncthreads();
            const int q = ch * kRhsChunk + qq;
            if (q < s && row < n) {
                A sum = A(0);
#pragma unroll
                for (int w = 0; w < kCols / 32; ++w) sum += part[w][r][qq];
                narrow(y + row * s + q, sum);
            }
        }
    }
}

template <typename TT, typename TX, typename TY, typename A>
static int launch_mr(const void* cb, const void* tiles, const void* x,
                     void* y, int nbr, int kb, int n, int m, int s,
                     cudaStream_t st) {
    bcsr_spmm_kernel<TT, TX, TY, A><<<nbr, kCols, 0, st>>>(
        (const int*)cb, (const TT*)tiles, (const TX*)x, (TY*)y, kb, n, m, s);
    return (int)cudaGetLastError();
}

// The (tiles, x) -> y pairs of bcsr_spmv_launch.
extern "C" int bcsr_spmv_multirhs_launch(int tdt, int xdt,
                                         const void* col_blocks,
                                         const void* tiles, const void* x,
                                         void* y, int nbr, int kb, int n,
                                         int m, int s, void* stream) {
    if (nbr < 0 || kb < 1 || n < 0 || m < 0 || n > nbr * kRows || s < 1
        || s > kMaxChunks * kRhsChunk)
        return (int)cudaErrorInvalidValue;
    if (nbr == 0 || n == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    typedef __nv_bfloat16 bf16;
    if (tdt == DT_BF16 && xdt == DT_BF16)
        return launch_mr<bf16, bf16, bf16, float>(col_blocks, tiles, x, y,
                                                  nbr, kb, n, m, s, st);
    if (tdt == DT_BF16 && xdt == DT_F32)
        return launch_mr<bf16, float, float, float>(col_blocks, tiles, x, y,
                                                    nbr, kb, n, m, s, st);
    if (tdt == DT_F32 && xdt == DT_BF16)
        return launch_mr<float, bf16, float, float>(col_blocks, tiles, x, y,
                                                    nbr, kb, n, m, s, st);
    if (tdt == DT_F32 && xdt == DT_F32)
        return launch_mr<float, float, float, float>(col_blocks, tiles, x,
                                                     y, nbr, kb, n, m, s, st);
    if (tdt == DT_F64 && xdt == DT_F64)
        return launch_mr<double, double, double, double>(
            col_blocks, tiles, x, y, nbr, kb, n, m, s, st);
    return (int)cudaErrorInvalidValue;
}
