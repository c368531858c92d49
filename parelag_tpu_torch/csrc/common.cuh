// Shared helpers of the hand-written Hopper kernels: element loads that
// widen to the accumulator type, stores that narrow from it, and the
// dtype codes the ctypes launchers take.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// dtype codes (must match DTYPE_CODES in ops/hopper_kernels.py)
enum DtypeCode { DT_F32 = 0, DT_BF16 = 1, DT_F64 = 2 };

// f32 and bf16 accumulate in f32; f64 in f64
template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<double> { using type = double; };

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
__device__ __forceinline__ double widen(double v) { return v; }

__device__ __forceinline__ void narrow(float* p, float v) { *p = v; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);
}
__device__ __forceinline__ void narrow(double* p, double v) { *p = v; }
