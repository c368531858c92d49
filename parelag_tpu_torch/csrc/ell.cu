// ELL (padded-row) SpMV: y[i] = sum_k val[i, k] * x[idx[i, k]].
//
// Replaces parelag_tpu/ops/pallas_kernels.py::ell_spmv_pallas (which
// never lowered on the TPU: Mosaic has no 1-D gather).  ELL carries the
// Hiptmair smoother's D, D^T and auxiliary operator on the Maxwell lane.
// Layout as the port's EllMatrix: idx (n, k) int32 and val (n, k)
// row-major, padding entries at column 0 with value 0.  (values, x) ->
// y: (f32, f32) -> f32 and (f64, f64) -> f64, summed in that dtype, as
// the XLA einsum of ell_matvec does; (bf16, bf16) -> bf16 and (bf16,
// f32) -> f32, summed in f32 as the port's DIA kernels sum bf16 tables
// (the bf16 cycle of the high-order lane applies a bf16 ELL A0).  A
// column index outside [0, m) reads 0.
//
// Bound on Hopper: device-memory bytes (idx + val once, x, y; two flops
// per entry), but the Maxwell lane's operators are launch-sized: D0
// 45,000 x 15,625 with k = 2, D0^T 15,625 x 45,000 with k <= 6, A_aux
// 15,625 x 15,625 with k = 27, each a few MB that an L2 of 50 MB keeps.
// There one thread per row, walking its k entries as a chain of dependent
// loads, left the time to latency: A_aux launched 62 blocks of 256
// threads on 132 SMs, each lane waiting on 27 load -> gather -> FMA steps
// (3.77 us against a 0.92 us bound).
//
// Design: an ELL row is a CSR row with row_ptr[i] = i * k, so the kernel
// is the row-group product of row_spmv.cuh (the BCSR kernel's) over
// EllRows, one row a group.  The host plan (hopper_kernels.
// ell_launch_plan) gives each row G lanes and each lane S slots: lane l
// loads slots l, l + G, ..., l + (S - 1) G, all of them before it uses
// any (the idx and val loads, then the x gathers, then the FMAs), so a
// lane waits on one load -> gather -> FMA chain for its S entries, and a
// warp's loads of one slot cover 32 / G whole rows of idx and val as one
// contiguous run.  The plan takes the fewest lanes that cover k at S = 4,
// then more while the grid would leave an SM without a block (H100 80GB
// HBM3, 700 W, device us per launch, kernel_profile --ell-slots 1,2,4:
// A_aux 2.21 / 2.19 / 2.00 at G x S = 16 x 2 / 16 x 2 / 8 x 4, the
// flagship's P0 as ELL 36.4 / 24.5 / 23.1 at 8 x 1 / 4 x 2 / 2 x 4).  A
// group takes one row, not BCSR's R = 4 rows beyond a wave of the card:
// with no row_ptr load in the chain, the S slots keep the loads in
// flight, and R = 4 was slower at every (G, S) tried but 8 x 1.

#include "row_spmv.cuh"

template <typename TV, typename TX, typename TY, int S>
__global__ void __launch_bounds__(kThreads)
ell_spmv_kernel(const int* __restrict__ idx, const TV* __restrict__ val,
                const TX* __restrict__ x, TY* __restrict__ y, int n, int k,
                int m, int lg) {
    row_group_spmv<1, S, typename AccOf<TV>::type>(
        EllRows{k}, idx, val, x, y, n, m, lg);
}

template <typename TV, typename TX, typename TY>
static int launch(const void* idx, const void* val, const void* x, void* y,
                  int n, int k, int m, int lanes, int slots,
                  cudaStream_t st) {
    const int lg = log2i(lanes);
    const long long threads = (long long)n << lg;
    const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
    const int* i = (const int*)idx;
    const TV* v = (const TV*)val;
    const TX* xs = (const TX*)x;
    TY* ys = (TY*)y;
    if (slots == 1)
        ell_spmv_kernel<TV, TX, TY, 1><<<blocks, kThreads, 0, st>>>(
            i, v, xs, ys, n, k, m, lg);
    else if (slots == 2)
        ell_spmv_kernel<TV, TX, TY, 2><<<blocks, kThreads, 0, st>>>(
            i, v, xs, ys, n, k, m, lg);
    else
        ell_spmv_kernel<TV, TX, TY, 4><<<blocks, kThreads, 0, st>>>(
            i, v, xs, ys, n, k, m, lg);
    return (int)cudaGetLastError();
}

// (values, x) dtype codes as above; lanes G (a power of two, 1 to 32) and
// slots S (1, 2 or 4) from hopper_kernels.ell_launch_plan; n * k < 2^31
extern "C" int ell_spmv_launch(int vdt, int xdt, const void* idx,
                               const void* val, const void* x, void* y,
                               int n, int k, int m, int lanes, int slots,
                               void* stream) {
    if (n < 0 || k < 1 || m < 0 || (long long)n * k >= (1LL << 31)
        || !pow2_in(lanes, 1, 32) || !pow2_in(slots, 1, 4))
        return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    typedef __nv_bfloat16 bf16;
    if (vdt == DT_F32 && xdt == DT_F32)
        return launch<float, float, float>(idx, val, x, y, n, k, m, lanes,
                                           slots, st);
    if (vdt == DT_F64 && xdt == DT_F64)
        return launch<double, double, double>(idx, val, x, y, n, k, m,
                                              lanes, slots, st);
    if (vdt == DT_BF16 && xdt == DT_BF16)
        return launch<bf16, bf16, bf16>(idx, val, x, y, n, k, m, lanes,
                                        slots, st);
    if (vdt == DT_BF16 && xdt == DT_F32)
        return launch<bf16, float, float>(idx, val, x, y, n, k, m, lanes,
                                          slots, st);
    return (int)cudaErrorInvalidValue;
}
