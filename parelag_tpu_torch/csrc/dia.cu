// DIA (diagonal / shift) SpMV and the fused weighted-Jacobi sweep, for
// one right-hand side and for s of them.
//
// Replaces parelag_tpu/ops/pallas_kernels.py::dia_spmv_pallas (:215),
// ::dia_jacobi_sweep_pallas (:266), ::dia_spmv_multirhs_pallas (:328)
// and ::dia_jacobi_sweep_multirhs_pallas (:400).  The table is row
// aligned: data[d * ld + i] multiplies x[i + offs[d]], ld >= n.  On the
// TPU the kernels kept a padded x in VMEM and took static slices of a
// 1024-aligned superblock; here the kernels stage the x rows a tile of
// rows touches in shared memory (the windows of a host plan) with
// 16-byte copies, zero outside [0, m), so their inner loops have no
// bounds test.  Sums accumulate in f32 for f32 and bf16 tables (the
// Pallas kernels accumulated in the table dtype) and in f64 for f64, in
// the offset order of the table, and are stored in the table dtype.  An
// entry whose x row falls outside [0, m) is multiplied by 0 (as the
// Pallas kernels' zero padding did), so it must be finite: to_dia
// stores 0 there.

#include "common.cuh"

#define DIA_MAX_OFFS 64

// 16 bytes global -> shared, bypassing L1; src_bytes < 16 zero-fills
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(src_bytes));
}

// ---------------------------------------------------------------------
// One right-hand side (dia_spmv_pallas, dia_jacobi_sweep_pallas)
//
// Bound on Hopper: device-memory bytes.  A matvec reads the nd x n table
// once (nd = 27 on the H1 grids) plus x and y; two flops per table entry
// sit far below the compute roofline.  On the 97^3 flagship grid the
// bf16 table is 49.3 MB of the 53 MB a matvec must move: 15.8 us at
// 3.35 TB/s.  The one-thread-a-row kernel these replace loaded one table
// entry per offset from global memory behind a bounds branch: a few
// 2-byte loads in flight a thread, 55 % of that in bf16.
//
// Design (the host plan, hopper_kernels.dia_row_plan, chooses each part
// from shapes alone and is passed by value):
//  * A block of T = 256 threads owns a tile of R = RT T rows, thread t
//    the rows b + t + r T (r < RT; RT = 2 for f32 and bf16, 1 for f64,
//    halved while the grid would have under 132 tiles).
//  * x windows.  The plan merges the sorted offsets into windows
//    (stage_windows: neighbours join while their gap is below R; the 27
//    offsets of a 27-point grid make one window per z-plane); the block
//    copies window k, the x rows [b + lo_k, b + lo_k + len_k) (lo_k
//    rounded down to a multiple of V = 16 bytes of items), into shared
//    memory with 16-byte cp.async, zero outside [0, m), so x[i +
//    offs[d]] is staged element i - b + xo[d] and the sums have no
//    bounds test.  Each x row crosses from L2 about (R + hi - lo) / R
//    times a window instead of once an offset.  Where the windows do
//    not fit kRowSmemBytes, x is read from device memory, 0 outside
//    [0, m) by a predicated load.
//  * Table, bf16 (and every dtype on a grid under 132 tiles): the block
//    also copies its nd table rows, each tstride = R + V elements from
//    the 16-byte boundary at or below data[d ld + b] (rows of ld = n
//    elements are not 16-byte aligned, and the table is not padded),
//    zero-filled past the table's end: every table byte crosses device
//    memory once, in 16-byte pieces, the whole slab in flight before one
//    wait, and a thread then reads the entry of row i at staged element
//    d tstride + (d ld mod V) + i - b: two scalar shared loads and an
//    FMA a row-offset.  Table, f32 and f64 on larger grids: each thread
//    loads its entries from device memory (coalesced across the warp,
//    4 or 8 bytes a lane) in batches of kRowBatch offsets issued a batch
//    ahead of their products, the first before the staging's wait; x
//    still from the windows.
//  * The sweep also copies the tile's b and dw rows and takes x[i] from
//    the window that holds offset 0 (plan center).
//  * Sums in offset order, in f32 (f64 for f64), as the plain version.
//
// Measured (kernel_profile --dia, --dia-variants, --ablate; PERF.md):
// with the sums left out, the bf16 copies alone run near the card's
// streaming rate; the sums cost two shared-memory wavefronts a
// row-offset, which is what keeps the bf16 pair above its bound.  A
// staged f32 table loses to its direct loads on the 49^3 grid and the
// darcy table (and ties on the 97^3 grid), hence the split by dtype;
// two rows a thread gain on all three.  Threads that owned V rows and
// shifted 16-byte table vectors in registers, with batches of loads
// issued ahead and neighbour chunks by warp shuffle, ran slower than the
// one-thread-a-row kernel on every grid (shifting and unpacking cost
// ~80 instructions an offset and 100-127 registers a thread), and so did
// a persistent grid that double-buffered tiles: both were removed.
//
// Pointers: the table, x, b and dw may start anywhere on their element
// size (a row of a Krylov basis, say).  Each is staged from the 16-byte
// boundary at or below its first element, `lead` elements before it, and
// read at that shift: the plan's windows hold V - 1 rows more than the
// tile needs, b and dw R + V rows; an element before the tensor's start
// is never read (the chunk that holds the start is copied element by
// element, zeros before it).  The dynamic shared memory stays within the
// default 48 KB (kRowSmemBytes; the plan cuts T to fit), so no attribute
// is set.

// the plan, by value (ctypes mirror: hopper_kernels._DiaRow)
struct DiaRow {
    int threads;              // T: threads a block
    int rows;                 // RT: rows a thread, T apart (a tile: RT T)
    int tstride;              // staged table row: RT T + V elements
    int tstaged;              // 1: the table rows are staged
    int staged;               // 1: the x windows are staged
    int center;               // x[i] at staged x element i - b + center
                              // + lead(x) (staged, offset 0 in a
                              // window), else -1
    int nwin;                 // windows
    int xlen;                 // staged x elements of all windows
    int off[DIA_MAX_OFFS];    // the offsets
    int xo[DIA_MAX_OFFS];     // x[b + t + off[d]] at staged x element
                              // t + xo[d] + lead(x) (staged)
    int lo[DIA_MAX_OFFS];     // window k: x rows from b + lo[k] on ...
    int len[DIA_MAX_OFFS];    // ... len[k] of them (multiples of V) ...
    int base[DIA_MAX_OFFS];   // ... from staged x element base[k] on
};

static const int kRowMaxThreads = 256;
static const int kRowSmemBytes = 49152;
// measurement hook (kernel_profile --dia --ablate), as the multi-RHS
// kernels': built with -DDIA_STAGE_ABLATE=1 the kernels skip the sums,
// with =2 the copies into shared memory; their results are then wrong

// offsets a batch: their coefficients are loaded before their products
static const int kRowBatch = 8;

// the elements of T between p and the 16-byte boundary at or below it
template <typename T>
__device__ __forceinline__ int lead(const T* p) {
    return (int)((reinterpret_cast<unsigned long long>(p) & 15ull)
                 / sizeof(T));
}

// The chunk of stage_chunk that holds the tensor's start lo: element by
// element, zeros before lo and from hi on (kept out of line: the
// staging loops meet it at most once a tensor)
template <typename T>
__device__ __noinline__ void stage_head(T* dst, const T* __restrict__ base,
                                        long long g, long long lo,
                                        long long hi) {
    constexpr int V = 16 / (int)sizeof(T);
    for (int e = 0; e < V; ++e) {
        const long long j = g + e;
        if (j >= lo && j < hi) dst[e] = base[j];
        else narrow(dst + e, typename AccOf<T>::type(0));
    }
}

// The V elements [g, g + V) of base (16-byte aligned; g a multiple of V)
// into dst, those outside the tensor's [lo, hi) as zeros: one 16-byte
// copy (zero-filled past hi), or stage_head for the chunk that holds the
// tensor's start, so nothing before it is read
template <typename T>
__device__ __forceinline__ void stage_chunk(T* dst, const T* __restrict__ base,
                                            long long g, long long lo,
                                            long long hi) {
    constexpr int V = 16 / (int)sizeof(T);
    if (g >= lo && g + V <= hi) {
        cp_async16(dst, base + g, 16);
    } else if (g >= lo || g + V <= lo) {
        // past the end, in part or whole, or wholly before the start
        const long long left = g >= lo && g < hi ? hi - g : 0;
        cp_async16(dst, left ? base + g : base, (int)left * (int)sizeof(T));
    } else {
        stage_head<T>(dst, base, g, lo, hi);
    }
}

// Issue the copies of the tile at row b0 (see the note above): its nd
// table rows into ts, chunk (d, k) by thread (d tstride / V + k) mod T,
// (STAGED) its x windows into xs and (SWEEP) its b and dw into bs, each
// from the 16-byte boundary at or below its tensor's own position
template <typename T, bool STAGED, bool TSTAGED, bool SWEEP>
__device__ __forceinline__ void stage_row_tile(T* ts, T* xs, T* bs,
                                               const T* __restrict__ data,
                                               const T* __restrict__ x,
                                               const T* __restrict__ b,
                                               const T* __restrict__ dw,
                                               const DiaRow& p, int nd,
                                               long long ld, long long b0,
                                               int m) {
    constexpr int V = 16 / (int)sizeof(T);
    if constexpr (SWEEP) {
        // the tile's b and dw rows (m = n), R + V each, zero past n
        const int R = blockDim.x * p.rows;
        const int ba = lead(b), wa = lead(dw);
        for (int e = threadIdx.x * V; e < R + V; e += blockDim.x * V) {
            stage_chunk<T>(bs + e, b - ba, b0 + e, ba, ba + m);
            stage_chunk<T>(bs + R + V + e, dw - wa, b0 + e, wa, wa + m);
        }
    }
    if constexpr (TSTAGED) {
        const int ta = lead(data);
        const long long tend = ta + (long long)nd * ld;  // the table's end
        const int cpr = p.tstride / V;
        const int dd = blockDim.x / cpr, dk = blockDim.x % cpr;
        int d = threadIdx.x / cpr, k = threadIdx.x % cpr;
        while (d < nd) {
            const long long g =
                ((ta + (long long)d * ld + b0) & ~(long long)(V - 1))
                + k * V;
            stage_chunk<T>(ts + d * p.tstride + k * V, data - ta, g, ta,
                           tend);
            d += dd;
            k += dk;
            if (k >= cpr) { k -= cpr; ++d; }
        }
    }
    if constexpr (STAGED) {
        const int xa = lead(x);
        for (int w = 0; w < p.nwin; ++w) {
            const long long g0 = b0 + p.lo[w];
            T* dst = xs + p.base[w];
            for (int e = threadIdx.x * V; e < p.len[w]; e += blockDim.x * V)
                stage_chunk<T>(dst + e, x - xa, g0 + e, xa, xa + m);
        }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// x[i_r + off[d]] of the thread's row r: from the staged windows (STAGED;
// xd at staged x element t + xo[d]) or from device memory, 0 outside
// [0, m)
template <typename T, bool STAGED>
__device__ __forceinline__ typename AccOf<T>::type xval(
        const T* xd, const T* __restrict__ x, long long j, int m) {
    using A = typename AccOf<T>::type;
    if constexpr (STAGED) return widen(*xd);
    else return j >= 0 && j < m ? widen(__ldg(x + j)) : A(0);
}

// The entries of offsets [d0, d0 + kRowBatch) below nd for the thread's
// rows i0 + r T, from device memory (coalesced across the warp); a row
// past n reads row n - 1 instead (it is not stored)
template <typename T, int RT>
__device__ __forceinline__ void load_batch(
        typename AccOf<T>::type (&c)[kRowBatch][RT],
        const T* __restrict__ data, int d0, int nd, long long ld,
        long long i0, int n) {
    long long row[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
        const long long i = i0 + (long long)r * blockDim.x;
        row[r] = i < n ? i : n - 1;
    }
#pragma unroll
    for (int u = 0; u < kRowBatch; ++u) {
        if (d0 + u >= nd) break;
        const T* td = data + (long long)(d0 + u) * ld;
#pragma unroll
        for (int r = 0; r < RT; ++r) c[u][r] = widen(__ldg(td + row[r]));
    }
}

template <typename T, int RT>
__device__ __forceinline__ void copy_batch(
        typename AccOf<T>::type (&c)[kRowBatch][RT],
        const typename AccOf<T>::type (&from)[kRowBatch][RT]) {
#pragma unroll
    for (int u = 0; u < kRowBatch; ++u)
#pragma unroll
        for (int r = 0; r < RT; ++r) c[u][r] = from[u][r];
}

// acc[r] += data[d, i_r] x[i_r + off[d]] for all d, in order, for the
// rows i_r = b0 + t + r T of the thread (x[i_r + off[d]] at xs[t + r T +
// xo[d]]: xs already moved by x's lead).  TSTAGED: the entry of row i_r
// at staged element d tstride + ((lead + d ld) mod V) + t + r T, two
// shared loads and an FMA an offset.  Else the entries from device memory, coalesced
// across the warp, in batches of kRowBatch offsets whose loads are
// issued one batch ahead of their products (the first batch, `first`,
// before the staging's wait).
template <typename T, int RT, bool STAGED, bool TSTAGED>
__device__ __forceinline__ void sum_offsets(
        typename AccOf<T>::type (&acc)[RT], const T* ts, const T* xs,
        const T* __restrict__ data, const T* __restrict__ x,
        const DiaRow& p, int nd, long long ld, long long b0, int n, int m,
        const typename AccOf<T>::type (&first)[kRowBatch][RT]) {
    constexpr int V = 16 / (int)sizeof(T);
    using A = typename AccOf<T>::type;
    const int t = threadIdx.x, nt = blockDim.x;
    const long long i0 = b0 + t;
    if constexpr (TSTAGED) {
        const int ldv = (int)(ld & (V - 1));
        int sh = lead(data);                     // (lead + d ld) mod V
        const T* tr = ts + t;
        for (int d = 0; d < nd; ++d) {
            const T* td = tr + sh;
            const T* xd = xs + t + p.xo[d];
#pragma unroll
            for (int r = 0; r < RT; ++r)
                acc[r] += widen(td[r * nt])
                          * xval<T, STAGED>(xd + r * nt, x,
                                            i0 + r * nt + p.off[d], m);
            tr += p.tstride;
            sh = (sh + ldv) & (V - 1);
        }
        return;
    }
    // each batch's loads go out one batch ahead of its products
    A c[kRowBatch][RT], next[kRowBatch][RT];
    copy_batch<T, RT>(c, first);
    for (int d0 = 0; d0 < nd; d0 += kRowBatch) {
        load_batch<T, RT>(next, data, d0 + kRowBatch, nd, ld, i0, n);
#pragma unroll
        for (int u = 0; u < kRowBatch; ++u) {
            const int d = d0 + u;
            if (d >= nd) break;
            const T* xd = xs + t + p.xo[d];
#pragma unroll
            for (int r = 0; r < RT; ++r)
                acc[r] += c[u][r] * xval<T, STAGED>(xd + r * nt, x,
                                                    i0 + r * nt + p.off[d],
                                                    m);
        }
        copy_batch<T, RT>(c, next);
    }
}

// y[i] = sum_d data[d, i] x[i + off[d]] or, SWEEP (m = n), y[i] = x[i] +
// dw[i] (b[i] - that sum), for the RT rows b + t + r T of each thread
// (r < RT; a tile of R = RT T rows)
template <typename T, int RT, bool STAGED, bool TSTAGED, bool SWEEP>
__device__ __forceinline__ void dia_rows(
        T* sm, const T* __restrict__ data, const T* __restrict__ x,
        const T* __restrict__ b, const T* __restrict__ dw,
        T* __restrict__ y, const DiaRow& p, int nd, long long ld, int n,
        int m) {
    constexpr int V = 16 / (int)sizeof(T);
    using A = typename AccOf<T>::type;
    const int t = threadIdx.x, nt = blockDim.x;
    const long long b0 = (long long)blockIdx.x * nt * RT;
    // shared memory: [table rows][x windows][b][dw], each present or not
    T* ts = sm;
    T* xs = TSTAGED ? sm + nd * p.tstride : sm;
    T* bs = STAGED ? xs + p.xlen : xs;
#if DIA_STAGE_ABLATE != 2
    stage_row_tile<T, STAGED, TSTAGED, SWEEP>(ts, xs, bs, data, x, b, dw, p,
                                              nd, ld, b0, m);
#endif
    A xi[RT];
    if constexpr (SWEEP) {
        // x[i] from device memory unless its window is staged
#pragma unroll
        for (int r = 0; r < RT; ++r) {
            const long long i = b0 + t + (long long)r * nt;
            xi[r] = !(STAGED && p.center >= 0) && i < n ? widen(__ldg(x + i))
                                                        : A(0);
        }
    }
    // the table read from device memory: the first batch's loads go out
    // before the wait
    A first[kRowBatch][RT];
    if constexpr (!TSTAGED)
        load_batch<T, RT>(first, data, 0, nd, ld, b0 + t, n);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    if (b0 + t >= n) return;
    A acc[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) acc[r] = A(0);
    // staged x, b and dw sit at their leads past the 16-byte boundary
    const T* xsa = STAGED ? xs + lead(x) : xs;
#if DIA_STAGE_ABLATE != 1
    sum_offsets<T, RT, STAGED, TSTAGED>(acc, ts, xsa, data, x, p, nd, ld, b0,
                                         n, m, first);
#endif
#pragma unroll
    for (int r = 0; r < RT; ++r) {
        const long long i = b0 + t + (long long)r * nt;
        if (i >= n) break;
        if constexpr (SWEEP) {
            const int e = t + r * nt;
            if (STAGED && p.center >= 0) xi[r] = widen(xsa[e + p.center]);
            acc[r] = xi[r] + widen(bs[RT * nt + V + lead(dw) + e])
                             * (widen(bs[lead(b) + e]) - acc[r]);
        }
        narrow(y + i, acc[r]);
    }
}

template <typename T, int RT, bool STAGED, bool TSTAGED>
__global__ void __launch_bounds__(kRowMaxThreads)
dia_spmv_row_kernel(const T* __restrict__ data, const T* __restrict__ x,
                    T* __restrict__ y, const __grid_constant__ DiaRow p,
                    int nd, long long ld, int n, int m) {
    extern __shared__ __align__(16) unsigned char smem[];
    dia_rows<T, RT, STAGED, TSTAGED, false>(reinterpret_cast<T*>(smem), data,
                                            x, nullptr, nullptr, y, p, nd, ld,
                                            n, m);
}

template <typename T, int RT, bool STAGED, bool TSTAGED>
__global__ void __launch_bounds__(kRowMaxThreads)
dia_jacobi_row_kernel(const T* __restrict__ data, const T* __restrict__ x,
                      const T* __restrict__ b, const T* __restrict__ dw,
                      T* __restrict__ xout,
                      const __grid_constant__ DiaRow p, int nd,
                      long long ld, int n) {
    extern __shared__ __align__(16) unsigned char smem[];
    dia_rows<T, RT, STAGED, TSTAGED, true>(reinterpret_cast<T*>(smem), data,
                                           x, b, dw, xout, p, nd, ld, n, n);
}

// a pointer on the element size of T (any tensor's is)
template <typename T>
static bool on_item(const void* a) {
    return reinterpret_cast<unsigned long long>(a) % sizeof(T) == 0;
}

template <typename T, int RT, bool STAGED, bool TSTAGED, bool SWEEP>
static void row_kernel(unsigned grid, const DiaRow& p, size_t smem,
                       cudaStream_t st, const void* data, const void* x,
                       const void* b, const void* dw, void* y, int nd,
                       long long ld, int n, int m) {
    const T *dt = (const T*)data, *xt = (const T*)x;
    if constexpr (SWEEP)
        dia_jacobi_row_kernel<T, RT, STAGED, TSTAGED>
            <<<grid, p.threads, smem, st>>>(dt, xt, (const T*)b,
                                            (const T*)dw, (T*)y, p, nd, ld,
                                            n);
    else
        dia_spmv_row_kernel<T, RT, STAGED, TSTAGED>
            <<<grid, p.threads, smem, st>>>(dt, xt, (T*)y, p, nd, ld, n, m);
}

// the kernel for the plan's RT, x staging and table staging
template <typename T, bool SWEEP>
static void row_pick(unsigned grid, const DiaRow& p, size_t smem,
                     cudaStream_t st, const void* data, const void* x,
                     const void* b, const void* dw, void* y, int nd,
                     long long ld, int n, int m) {
    const int k = (p.rows == 2) * 4 + p.staged * 2 + p.tstaged;
    switch (k) {
#define DIA_ROW_CASE(K, RT, XS, TS)                                          \
        case K:                                                              \
            row_kernel<T, RT, XS, TS, SWEEP>(grid, p, smem, st, data, x, b, \
                                             dw, y, nd, ld, n, m);          \
            break;
        DIA_ROW_CASE(0, 1, false, false)
        DIA_ROW_CASE(1, 1, false, true)
        DIA_ROW_CASE(2, 1, true, false)
        DIA_ROW_CASE(3, 1, true, true)
        DIA_ROW_CASE(4, 2, false, false)
        DIA_ROW_CASE(5, 2, false, true)
        DIA_ROW_CASE(6, 2, true, false)
        DIA_ROW_CASE(7, 2, true, true)
#undef DIA_ROW_CASE
    }
}

// Checks the plan against the shapes and launches; returns 0 or a CUDA
// error (cudaErrorInvalidValue for what the kernels do not take)
template <typename T, bool SWEEP>
static int row_launch(const void* data, const void* x, const void* b,
                      const void* dw, void* y, const DiaRow& p, int nd,
                      long long ld, int n, int m, cudaStream_t st) {
    constexpr int V = 16 / (int)sizeof(T);
    if (nd < 1 || nd > DIA_MAX_OFFS || n < 1 || m < 0 || ld < n
        || p.threads < 32 || p.threads > kRowMaxThreads || p.threads % 32
        || (p.rows != 1 && p.rows != 2) || (p.tstaged != 0 && p.tstaged != 1)
        || (p.staged != 0 && p.staged != 1)
        || p.tstride != p.threads * p.rows + V || !on_item<T>(data)
        || !on_item<T>(x)
        || (SWEEP && (m != n || !on_item<T>(b) || !on_item<T>(dw))))
        return (int)cudaErrorInvalidValue;
    const int tile = p.threads * p.rows;
    long long elems = p.tstaged ? (long long)nd * p.tstride : 0;
    if (SWEEP) elems += 2LL * (tile + V);              // b and dw
    if (p.staged) {
        if (m < 1 || p.nwin < 1 || p.nwin > DIA_MAX_OFFS)
            return (int)cudaErrorInvalidValue;
        int at = 0;
        for (int k = 0; k < p.nwin; ++k) {
            if (p.lo[k] % V || p.len[k] < V || p.len[k] % V
                || p.base[k] != at)
                return (int)cudaErrorInvalidValue;
            at += p.len[k];
        }
        // the last thread's x stays staged at any lead below V
        if (at != p.xlen
            || (p.center >= 0 && p.center + tile + V - 1 > p.xlen))
            return (int)cudaErrorInvalidValue;
        for (int d = 0; d < nd; ++d)
            if (p.xo[d] < 0 || p.xo[d] + tile + V - 1 > p.xlen)
                return (int)cudaErrorInvalidValue;
        elems += p.xlen;
    }
    const size_t smem = elems * sizeof(T);
    if (smem > (size_t)kRowSmemBytes) return (int)cudaErrorInvalidValue;
    const unsigned grid = (unsigned)((n + tile - 1) / tile);
    row_pick<T, SWEEP>(grid, p, smem, st, data, x, b, dw, y, nd, ld, n, m);
    return (int)cudaGetLastError();
}

template <bool SWEEP>
static int row_dispatch(int dtype, const void* data, const void* x,
                        const void* b, const void* dw, void* y,
                        const DiaRow* plan, int nd, long long ld, int n,
                        int m, void* stream) {
    if (n < 0 || m < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    switch (dtype) {
        case DT_F32:
            return row_launch<float, SWEEP>(data, x, b, dw, y, *plan, nd, ld,
                                            n, m, st);
        case DT_BF16:
            return row_launch<__nv_bfloat16, SWEEP>(data, x, b, dw, y, *plan,
                                                    nd, ld, n, m, st);
        case DT_F64:
            return row_launch<double, SWEEP>(data, x, b, dw, y, *plan, nd,
                                             ld, n, m, st);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

extern "C" int dia_spmv_launch(int dtype, const void* data, const void* x,
                               void* y, const DiaRow* plan, int nd,
                               long long ld, int n, int m, void* stream) {
    return row_dispatch<false>(dtype, data, x, nullptr, nullptr, y, plan, nd,
                               ld, n, m, stream);
}

extern "C" int dia_jacobi_sweep_launch(int dtype, const void* data,
                                       const void* x, const void* b,
                                       const void* dw, void* xout,
                                       const DiaRow* plan, int nd,
                                       long long ld, int n, void* stream) {
    return row_dispatch<true>(dtype, data, x, b, dw, xout, plan, nd, ld, n,
                              n, stream);
}

// ---------------------------------------------------------------------
// s right-hand sides (the multi-RHS block PCG of the H1 flagship)
//
// X is (m, s) row-major, the layout pcg and the V-cycle hold; the TPU
// kernels took a transposed (s, xlen) copy because Mosaic shifts along
// lanes, which this card does not need.  Bound: bytes, table + X + Y
// (+ B and dw for the sweep); at s = 16 on the 27-offset fine grid the
// table is ~46 % of them in f32.
//
// X and the table staged in shared memory.  A block stages a tile of R
// rows and a slice of C columns at a time.  The host plan
// (ops/hopper_kernels.py::dia_stage_plan) merges the sorted offsets into
// windows (neighbours join while their gap is below R); window k holds
// the X rows [b + lo_k, b + R + hi_k) of the tile at row b, clipped to
// [0, m) and zero outside, so the inner loop has no bounds check.  On the
// 97^3 grid the 27 offsets make 3 windows (one per z-plane) of R + 196
// rows, P = 97^2 rows apart, where a per-row kernel (each thread loading
// X[i + off] from global memory) fetched each X row up to 27 times and
// ran at a third of its bound.
//
// March.  Where the plan finds the windows equally long and spaced by a
// period P (one per plane of a grid), the tile at b + P needs windows
// 1..K-1 of the tile at b as its windows 0..K-2: the windows sit in a
// ring of K slots and a block that takes the tile one plane up stages
// only the new top window.  The work list orders tiles plane-fastest
// ((slice, tile in the plane, plane)), and the grid is persistent (the
// blocks that fit the card at once, each a contiguous run of the list),
// so a block marches up a column of tiles and each X row crosses from
// L2 to the SM ~(R + 196) / R times instead of 3 (R + 196) / R.  The
// staging bandwidth, not the arithmetic, was what bound a block that
// stages all K windows for each tile.
//
// Each tile stages its nd table rows too, R + 16 bytes each from the
// 16-byte boundary at or below data[d, b] (rows of ld = n elements are
// not 16-byte aligned; the compute skips the shift): read straight from
// global memory, a warp's coefficient load fetched 32 bytes and too
// few table bytes were in flight.  Every chunk is one 16-byte
// cp.async.cg (zero-filled past the ends), all issued before one wait;
// where a slice is all of X's columns a window is one contiguous run of
// X and needs no per-row index.
//
// Then one thread per (kTR rows, W-column group): W = 16 bytes /
// element, the G threads of a row read one broadcast coefficient (the
// table crosses device memory once for each column slice, once in all
// when C = s).  The plan also cuts the offsets into runs of up to kRun
// consecutive offsets whose staged X rows are consecutive (the c = -1,
// 0, 1 of a 27-point stencil line): a run of L offsets reads the
// kTR + L - 1 X rows it spans once each, so one line costs 5 X loads
// for 9 row-offset products, and its L kTR coefficients are loaded
// before the products.  Sums run in the offset order of the table.
// Shapes the 16-byte path does not take (s * sizeof(T) not a multiple
// of 16, or an (n, s) tensor not 16-byte aligned) stage X element by
// element and compute one column per thread.  s <= 64 (the JAX module's
// _MAX_RHS) and nd <= DIA_STAGE_MAX_OFFS = 48 (the DIA format of
// solvers/hierarchy.py, the only caller with s columns), checked by the
// wrapper; the table must be 16-byte aligned, as every allocation is.
//
// Measurement hook (kernel_profile.py --ablate): built with
// -DDIA_STAGE_ABLATE=1 the kernels skip the sums (the fill and the
// stores remain), with =2 they skip the copies of the contiguous path
// into shared memory (the compute runs on what is there).  Their results
// are then wrong; the default build has neither.

#define DIA_STAGE_MAX_OFFS 48
#define DIA_MAX_WIN (DIA_STAGE_MAX_OFFS + 1)

// the plan, by value (ctypes mirror: hopper_kernels._DiaStage)
struct DiaStage {
    int rows;               // R: tile rows
    int cols;               // C: slice columns
    int nwin;               // K: windows
    int sweep;              // sh[nd] and wof[nd] locate X[i] (the sweep)
    int tstride;            // staged table row: R + 16 bytes of elements
    int period;             // P of the march, or 0
    int nrun;               // runs of offsets
    int lo[DIA_MAX_WIN];    // window k starts at X row b + lo[k] ...
    int len[DIA_MAX_WIN];   // ... and holds len[k] = R + hi_k - lo_k rows
    int base[DIA_MAX_WIN];  // first staged row of slot k (stride: the slice)
    int sh[DIA_MAX_WIN];    // staged row of X[i + offs[d]] minus i's tile row
    int wof[DIA_MAX_WIN];   // window of offset d
    int run_d0[DIA_MAX_WIN];   // run j: offsets run_d0[j] ...
    int run_len[DIA_MAX_WIN];  // ... to run_d0[j] + run_len[j] - 1
};

// the most dynamic shared memory a block of these kernels may take (an
// H100 block's 227 KB less room for their static per-offset rows); the
// plan aims at two blocks per SM
static const int kStageMaxBytes = 232448 - 256;
static const int kStageThreads = 384;
// rows per thread (odd: a quarter-warp's 16-byte reads of 32- and 64-byte
// X rows then fall on distinct banks) and the longest run
static const int kTR = 3;
static const int kRun = 3;

// W elements of T: fetch() reads them (W > 1: one 16-byte load of an
// aligned run) as Raw, unpack() widens them to the accumulator type
template <typename T, int W> struct Cols;
template <typename T> struct Cols<T, 1> {
    using A = typename AccOf<T>::type;
    using Raw = T;
    __device__ static Raw fetch(const T* p) { return *p; }
    __device__ static void unpack(Raw q, A (&v)[1]) { v[0] = widen(q); }
    __device__ static void store(T* p, const A (&v)[1]) { narrow(p, v[0]); }
};
template <> struct Cols<float, 4> {
    using Raw = float4;
    __device__ static Raw fetch(const float* p) {
        return *reinterpret_cast<const float4*>(p);
    }
    __device__ static void unpack(Raw q, float (&v)[4]) {
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    }
    __device__ static void store(float* p, const float (&v)[4]) {
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    }
};
template <> struct Cols<double, 2> {
    using Raw = double2;
    __device__ static Raw fetch(const double* p) {
        return *reinterpret_cast<const double2*>(p);
    }
    __device__ static void unpack(Raw q, double (&v)[2]) {
        v[0] = q.x; v[1] = q.y;
    }
    __device__ static void store(double* p, const double (&v)[2]) {
        *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
    }
};
template <> struct Cols<__nv_bfloat16, 8> {
    using Raw = uint4;
    __device__ static Raw fetch(const __nv_bfloat16* p) {
        return *reinterpret_cast<const uint4*>(p);
    }
    __device__ static void unpack(Raw q, float (&v)[8]) {
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

// One tile of the work list: rows [b, b + valid) of the output, columns
// [q0, q0 + cw); rot: window k sits in slot (k + rot) % K; fresh: every
// window is staged, else only the top one (the march)
struct StageTile {
    long long b;
    int valid, q0, cw, rot;
    bool fresh;
};

// Tile w of the list (slice, tile in the plane, plane), plane fastest; a
// plan without a march has one "plane" of all the tiles
__device__ __forceinline__ StageTile stage_tile_at(const DiaStage& p,
                                                   long long w, bool first,
                                                   int prev_rot, int n,
                                                   int s) {
    const int per_plane = p.period > 0 ? (p.period + p.rows - 1) / p.rows
                                       : (n + p.rows - 1) / p.rows;
    const int planes = p.period > 0 ? (n + p.period - 1) / p.period : 1;
    const int plane = (int)(w % planes);
    const long long rest = w / planes;
    const int xt = (int)(rest % per_plane);
    StageTile t;
    t.q0 = (int)(rest / per_plane) * p.cols;
    t.cw = min(p.cols, s - t.q0);
    t.b = (long long)xt * p.rows + (long long)plane * p.period;
    long long valid = p.rows;
    if (p.period > 0) valid = min(valid, (long long)p.period - xt * p.rows);
    valid = min(valid, (long long)n - t.b);
    t.valid = (int)valid;
    t.fresh = first || plane == 0 || p.period == 0;
    t.rot = t.fresh ? 0 : (prev_rot + 1) % p.nwin;
    return t;
}

// Stage tile t: its table rows into ts (row d at d * tstride, from the
// 16-byte boundary at or below data[d * ld + b]), its windows (all, or
// the top one) of X into their slots of xs (row stride cw, zero outside
// [0, m)), and shs[d] = the staged row of X[i + offs[d]] minus i's tile
// row for this rotation; then wait for all of it.
template <typename T, int W>
__device__ __forceinline__ void stage_tile(T* ts, T* xs, int* shs,
                                           const T* __restrict__ data,
                                           const T* __restrict__ x,
                                           const DiaStage& p, int nd,
                                           long long ld, const StageTile& t,
                                           int m, int s) {
    using A = typename AccOf<T>::type;
    const int K = p.nwin;
    for (int d = threadIdx.x; d <= nd; d += blockDim.x) {
        const int k = p.wof[d];
        shs[d] = p.sh[d] - p.base[k] + p.base[(k + t.rot) % K];
    }
    const int V = 16 / (int)sizeof(T);
    const long long tend = nd * ld;          // elements of the table
    {
        // chunk c of table row d, stepping (d, c) by blockDim.x chunks
        const int tchunks = p.tstride / V;
        const int dd = blockDim.x / tchunks, dc = blockDim.x % tchunks;
        int d = threadIdx.x / tchunks, c = threadIdx.x % tchunks;
        while (d < nd) {
            const long long g = (d * ld + t.b) / V * V + c * V;
            const long long left = (tend - g) * (long long)sizeof(T);
            const int bytes = left >= 16 ? 16 : (left > 0 ? (int)left : 0);
#if DIA_STAGE_ABLATE != 2
            cp_async16(ts + d * p.tstride + c * V, bytes ? data + g : data,
                       bytes);
#endif
            d += dd;
            c += dc;
            if (c >= tchunks) { c -= tchunks; ++d; }
        }
    }
    const int per_row = t.cw / W;
    for (int k = t.fresh ? 0 : K - 1; k < K; ++k) {
        const long long g0 = t.b + p.lo[k];
        T* dst = xs + (long long)p.base[(k + t.rot) % K] * t.cw;
        if (W > 1 && t.cw == s) {
            // all columns: the window is one contiguous run of X, and a
            // 16-byte chunk never straddles two rows
            const long long e0 = g0 * s, eend = (long long)m * s;
            const int total = p.len[k] * s / V;
            for (int e = threadIdx.x; e < total; e += blockDim.x) {
                const long long q = e0 + (long long)e * V;
                const bool in = q >= 0 && q < eend;
#if DIA_STAGE_ABLATE != 2
                cp_async16(dst + e * V, in ? x + q : x, in ? 16 : 0);
#endif
            }
            continue;
        }
        const int total = p.len[k] * per_row;
        for (int e = threadIdx.x; e < total; e += blockDim.x) {
            const int row = e / per_row;
            const int c = (e - row * per_row) * W;
            const long long g = g0 + row;
            const bool in = g >= 0 && g < m;
            const T* src = in ? x + g * s + t.q0 + c : x;
            if (W > 1)
                cp_async16(dst + row * t.cw + c, src, in ? 16 : 0);
            else
                narrow(dst + row * t.cw + c, in ? widen(*src) : A(0));
        }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
}

// One run of L offsets: acc[t] += coefficient(d0 + j, row r + t) times X
// row r + t + j of the run (xr: its first staged row, at the column
// group), for j < L.  Each X row is read once and feeds the products it
// takes part in; acc[t] still takes them in offset order (j rises with
// the row).  tr: the staged table row d0 at tile row r; shift: the
// 16-byte shift of row d0, ldv: how much it moves a row.
template <typename T, int W, int L>
__device__ __forceinline__ void run_sum(
        const T* tr, int tstride, int shift, int ldv, const T* xr, int cw,
        typename AccOf<T>::type (&acc)[kTR][W]) {
    using A = typename AccOf<T>::type;
    constexpr int V = 16 / (int)sizeof(T);
    A c[L][kTR];
#pragma unroll
    for (int j = 0; j < L; ++j) {
        const T* cj = tr + j * tstride + ((shift + j * ldv) & (V - 1));
#pragma unroll
        for (int t = 0; t < kTR; ++t) c[j][t] = widen(cj[t]);
    }
#pragma unroll
    for (int u = 0; u < kTR + L - 1; ++u) {
        A xv[W];
        Cols<T, W>::unpack(Cols<T, W>::fetch(xr + u * cw), xv);
#pragma unroll
        for (int j = 0; j < L; ++j) {
            const int t = u - j;
            if (t < 0 || t >= kTR) continue;
#pragma unroll
            for (int w = 0; w < W; ++w) acc[t][w] += c[j][t] * xv[w];
        }
    }
}

// acc[t] = sum over d of the staged coefficient of tile row r + t times
// the W columns of staged X row r + t + shs[d] (xq: the column group's
// first staged element), in offset order, run by run
template <typename T, int W>
__device__ __forceinline__ void staged_rows_sum(
        const T* ts, const T* xq, const int* shs, const DiaStage& p,
        long long ld, long long b, int r, int cw,
        typename AccOf<T>::type (&acc)[kTR][W]) {
    using A = typename AccOf<T>::type;
    constexpr int V = 16 / (int)sizeof(T);
    const int ldv = (int)(ld & (V - 1));
    const int shift0 = (int)(b & (V - 1));   // data[d * ld + b] mod V
#pragma unroll
    for (int t = 0; t < kTR; ++t)
#pragma unroll
        for (int w = 0; w < W; ++w) acc[t][w] = A(0);
#if DIA_STAGE_ABLATE == 1
    return;
#endif
    for (int k = 0; k < p.nrun; ++k) {
        const int d0 = p.run_d0[k];
        const T* tr = ts + d0 * p.tstride + r;
        const T* xr = xq + (r + shs[d0]) * cw;
        const int shift = (shift0 + d0 * ldv) & (V - 1);
        switch (p.run_len[k]) {
            case 3:
                run_sum<T, W, 3>(tr, p.tstride, shift, ldv, xr, cw, acc);
                break;
            case 2:
                run_sum<T, W, 2>(tr, p.tstride, shift, ldv, xr, cw, acc);
                break;
            default:
                run_sum<T, W, 1>(tr, p.tstride, shift, ldv, xr, cw, acc);
        }
    }
}

// The block's run of the work list: [w0, w1)
__device__ __forceinline__ void stage_run(long long work, long long& w0,
                                          long long& w1) {
    w0 = blockIdx.x * work / gridDim.x;
    w1 = (blockIdx.x + 1) * work / gridDim.x;
}

template <typename T, int W>
__global__ void __launch_bounds__(kStageThreads, 2)
dia_spmv_staged_kernel(const T* __restrict__ data, const T* __restrict__ x,
                       T* __restrict__ y, const __grid_constant__ DiaStage p,
                       int nd, long long ld, int n, int m, int s,
                       long long work) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int shs[DIA_MAX_WIN];
    T* ts = reinterpret_cast<T*>(smem);
    T* xs = ts + nd * p.tstride;
    using A = typename AccOf<T>::type;
    long long w0, w1;
    stage_run(work, w0, w1);
    int rot = 0;
    for (long long w = w0; w < w1; ++w) {
        const StageTile t = stage_tile_at(p, w, w == w0, rot, n, s);
        rot = t.rot;
        stage_tile<T, W>(ts, xs, shs, data, x, p, nd, ld, t, m, s);
        const int G = t.cw / W;
        for (int it = threadIdx.x; it < p.rows / kTR * G; it += blockDim.x) {
            const int r = it / G * kTR;
            if (r >= t.valid) break;
            const int q = (it - r / kTR * G) * W;
            A acc[kTR][W];
            staged_rows_sum<T, W>(ts, xs + q, shs, p, ld, t.b, r, t.cw, acc);
#pragma unroll
            for (int u = 0; u < kTR; ++u)
                if (r + u < t.valid)
                    Cols<T, W>::store(y + (t.b + r + u) * s + t.q0 + q,
                                      acc[u]);
        }
        __syncthreads();                     // before the next stage
    }
}

// X'[i, q] = X[i, q] + dw[i] * (B[i, q] - sum_d data[d, i] X[i + off_d, q]);
// X[i] comes from the staged windows (shs[nd]); B and dw are fetched
// before the sum, so their loads overlap it
template <typename T, int W>
__global__ void __launch_bounds__(kStageThreads, 2)
dia_jacobi_staged_kernel(const T* __restrict__ data, const T* __restrict__ x,
                         const T* __restrict__ b, const T* __restrict__ dw,
                         T* __restrict__ xout,
                         const __grid_constant__ DiaStage p, int nd,
                         long long ld, int n, int s, long long work) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int shs[DIA_MAX_WIN];
    T* ts = reinterpret_cast<T*>(smem);
    T* xs = ts + nd * p.tstride;
    using A = typename AccOf<T>::type;
    using C = Cols<T, W>;
    long long w0, w1;
    stage_run(work, w0, w1);
    int rot = 0;
    for (long long w = w0; w < w1; ++w) {
        const StageTile t = stage_tile_at(p, w, w == w0, rot, n, s);
        rot = t.rot;
        stage_tile<T, W>(ts, xs, shs, data, x, p, nd, ld, t, n, s);
        const int G = t.cw / W;
        for (int it = threadIdx.x; it < p.rows / kTR * G; it += blockDim.x) {
            const int r = it / G * kTR;
            if (r >= t.valid) break;
            const int q = (it - r / kTR * G) * W;
            typename C::Raw braw[kTR];
            T draw[kTR];
#pragma unroll
            for (int u = 0; u < kTR; ++u) {
                // rows past the tile read row r (in range) and are not
                // stored
                const long long i = t.b + r + (r + u < t.valid ? u : 0);
                braw[u] = C::fetch(b + i * s + t.q0 + q);
                draw[u] = dw[i];
            }
            A acc[kTR][W];
            staged_rows_sum<T, W>(ts, xs + q, shs, p, ld, t.b, r, t.cw, acc);
#pragma unroll
            for (int u = 0; u < kTR; ++u) {
                if (r + u >= t.valid) continue;
                const long long i = t.b + r + u;
                A xv[W], bv[W];
                C::unpack(C::fetch(xs + q + (r + u + shs[nd]) * t.cw), xv);
                C::unpack(braw[u], bv);
                const A di = widen(draw[u]);
#pragma unroll
                for (int w = 0; w < W; ++w)
                    xv[w] = xv[w] + di * (bv[w] - acc[u][w]);
                C::store(xout + i * s + t.q0 + q, xv);
            }
        }
        __syncthreads();                     // before the next stage
    }
}

// Checks the plan against the shapes and picks W: 16 bytes of columns
// per thread when s, the slice and every (n, s) tensor allow, else 1.
// Returns W, or -1 for a plan or a table the kernels cannot take.
template <typename T>
static int stage_width(const DiaStage& p, int nd, int s, const void* data,
                       const void* a, const void* b, const void* c) {
    const int v = 16 / (int)sizeof(T);
    if (p.rows < 1 || p.cols < 1 || p.cols > s || p.nwin < 1
        || p.nwin > DIA_MAX_WIN || nd < 1 || nd > DIA_STAGE_MAX_OFFS
        || p.rows % v != 0 || p.rows % kTR != 0 || p.tstride != p.rows + v
        || p.period < 0
        || (reinterpret_cast<unsigned long long>(data) & 15ull) != 0)
        return -1;
    long long rows = 0;
    for (int k = 0; k < p.nwin; ++k) {
        if (p.len[k] < p.rows || p.base[k] != rows) return -1;
        if (p.period > 0 && (p.len[k] != p.len[0]
                             || p.lo[k] - p.lo[0] != k * p.period))
            return -1;
        rows += p.len[k];
    }
    for (int d = 0; d < nd + p.sweep; ++d)
        if (p.wof[d] < 0 || p.wof[d] >= p.nwin) return -1;
    if (p.nrun < 1 || p.nrun > nd) return -1;
    for (int k = 0, d = 0; k < p.nrun; d += p.run_len[k++])
        if (p.run_d0[k] != d || p.run_len[k] < 1 || p.run_len[k] > kRun
            || (k == p.nrun - 1 && d + p.run_len[k] != nd))
            return -1;
    if ((rows * p.cols + (long long)nd * p.tstride) * (long long)sizeof(T)
        > kStageMaxBytes)
        return -1;
    const bool aligned = ((reinterpret_cast<unsigned long long>(a)
                           | reinterpret_cast<unsigned long long>(b)
                           | reinterpret_cast<unsigned long long>(c))
                          & 15ull) == 0;
    return (s % v == 0 && p.cols % v == 0 && aligned) ? v : 1;
}

static int stage_bytes(const DiaStage& p, int nd, int elem) {
    return ((p.base[p.nwin - 1] + p.len[p.nwin - 1]) * p.cols
            + nd * p.tstride) * elem;
}

// the work list's length: (column slices) x (tiles a plane) x (planes)
static long long stage_work(const DiaStage& p, int n, int s) {
    const long long slices = (s + p.cols - 1) / p.cols;
    if (p.period == 0) return slices * ((n + p.rows - 1) / p.rows);
    return slices * ((p.period + p.rows - 1) / p.rows)
           * ((n + p.period - 1) / p.period);
}

static int stage_threads(const DiaStage& p, int w) {
    const int items = p.rows / kTR * (p.cols / w);
    return items >= kStageThreads ? kStageThreads : ((items + 31) / 32) * 32;
}

// The blocks of one staged kernel that fit the card at once, for each
// launch shape it has met (the V-cycle alternates between its levels'):
// the occupancy query costs more host time than a small level's kernel
struct StageGrid {
    static const int kSlots = 8;
    int used = 0;
    int dev[kSlots], threads[kSlots], bytes[kSlots];
    long long fit[kSlots];
};

// Size the persistent grid: the blocks that fit the card at once, at
// most one per tile.  A shape met first raises the kernel's dynamic
// shared memory limit above the default 48 KB (to kStageMaxBytes, which
// covers every plan) and asks for its occupancy.  Returns 0 or a CUDA
// error.
template <typename K>
static int stage_grid(K kernel, StageGrid& c, int threads, int bytes,
                      long long work, unsigned* grid) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    int i = 0;
    while (i < c.used && (c.dev[i] != dev || c.threads[i] != threads
                          || c.bytes[i] != bytes))
        ++i;
    if (i == c.used) {
        int sms = 0, per_sm = 0;
        e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            kStageMaxBytes);
        if (e == cudaSuccess)
            e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                       dev);
        if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, kernel, threads, bytes);
        if (e != cudaSuccess) return (int)e;
        if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
        if (c.used < StageGrid::kSlots) ++c.used;
        i = c.used - 1;                      // a full cache reuses its last
        c.dev[i] = dev;
        c.threads[i] = threads;
        c.bytes[i] = bytes;
        c.fit[i] = (long long)per_sm * sms;
    }
    *grid = (unsigned)(work < c.fit[i] ? work : c.fit[i]);
    return 0;
}

template <typename T, int W>
static int spmv_staged(const void* data, const void* x, void* y,
                       const DiaStage& p, int nd, long long ld, int n, int m,
                       int s, cudaStream_t st) {
    const int bytes = stage_bytes(p, nd, sizeof(T));
    const int threads = stage_threads(p, W);
    const long long work = stage_work(p, n, s);
    static StageGrid cache;
    unsigned grid = 0;
    const int e = stage_grid(dia_spmv_staged_kernel<T, W>, cache, threads,
                             bytes, work, &grid);
    if (e != 0) return e;
    dia_spmv_staged_kernel<T, W><<<grid, threads, bytes, st>>>(
        (const T*)data, (const T*)x, (T*)y, p, nd, ld, n, m, s, work);
    return (int)cudaGetLastError();
}

template <typename T>
static int spmv_staged_any(const void* data, const void* x, void* y,
                           const DiaStage& p, int nd, long long ld, int n,
                           int m, int s, cudaStream_t st) {
    const int w = stage_width<T>(p, nd, s, data, x, y, y);
    if (w < 0) return (int)cudaErrorInvalidValue;
    if (w > 1)
        return spmv_staged<T, 16 / sizeof(T)>(data, x, y, p, nd, ld, n, m, s,
                                              st);
    return spmv_staged<T, 1>(data, x, y, p, nd, ld, n, m, s, st);
}

extern "C" int dia_spmv_multirhs_launch(int dtype, const void* data,
                                        const void* x, void* y,
                                        const DiaStage* plan, int nd,
                                        long long ld, int n, int m, int s,
                                        void* stream) {
    if (n < 0 || m < 0 || s < 1) return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    const DiaStage& p = *plan;
    cudaStream_t st = (cudaStream_t)stream;
    switch (dtype) {
        case DT_F32:
            return spmv_staged_any<float>(data, x, y, p, nd, ld, n, m, s, st);
        case DT_BF16:
            return spmv_staged_any<__nv_bfloat16>(data, x, y, p, nd, ld, n,
                                                  m, s, st);
        case DT_F64:
            return spmv_staged_any<double>(data, x, y, p, nd, ld, n, m, s,
                                           st);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

template <typename T, int W>
static int jacobi_staged(const void* data, const void* x, const void* b,
                         const void* dw, void* xout, const DiaStage& p,
                         int nd, long long ld, int n, int s,
                         cudaStream_t st) {
    const int bytes = stage_bytes(p, nd, sizeof(T));
    const int threads = stage_threads(p, W);
    const long long work = stage_work(p, n, s);
    static StageGrid cache;
    unsigned grid = 0;
    const int e = stage_grid(dia_jacobi_staged_kernel<T, W>, cache, threads,
                             bytes, work, &grid);
    if (e != 0) return e;
    dia_jacobi_staged_kernel<T, W><<<grid, threads, bytes, st>>>(
        (const T*)data, (const T*)x, (const T*)b, (const T*)dw, (T*)xout, p,
        nd, ld, n, s, work);
    return (int)cudaGetLastError();
}

template <typename T>
static int jacobi_staged_any(const void* data, const void* x, const void* b,
                             const void* dw, void* xout, const DiaStage& p,
                             int nd, long long ld, int n, int s,
                             cudaStream_t st) {
    const int w = stage_width<T>(p, nd, s, data, x, b, xout);
    if (w < 0 || !p.sweep) return (int)cudaErrorInvalidValue;
    if (w > 1)
        return jacobi_staged<T, 16 / sizeof(T)>(data, x, b, dw, xout, p, nd,
                                                ld, n, s, st);
    return jacobi_staged<T, 1>(data, x, b, dw, xout, p, nd, ld, n, s, st);
}

extern "C" int dia_jacobi_sweep_multirhs_launch(int dtype, const void* data,
                                                const void* x, const void* b,
                                                const void* dw, void* xout,
                                                const DiaStage* plan, int nd,
                                                long long ld, int n, int s,
                                                void* stream) {
    if (n < 0 || s < 1) return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    const DiaStage& p = *plan;
    cudaStream_t st = (cudaStream_t)stream;
    switch (dtype) {
        case DT_F32:
            return jacobi_staged_any<float>(data, x, b, dw, xout, p, nd, ld, n,
                                            s, st);
        case DT_BF16:
            return jacobi_staged_any<__nv_bfloat16>(data, x, b, dw, xout, p,
                                                    nd, ld, n, s, st);
        case DT_F64:
            return jacobi_staged_any<double>(data, x, b, dw, xout, p, nd, ld,
                                             n, s, st);
        default:
            return (int)cudaErrorInvalidValue;
    }
}
