// Shared helpers of the hand-written attention kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Masked-score value and softmax floor of the reference kernels.
#define REPRO_NEG_INF (-1e30f)
#define REPRO_L_FLOOR (1e-30f)

// dtype codes shared with the Python wrappers
enum { REPRO_F32 = 0, REPRO_BF16 = 1 };

// returned for a configuration no kernel was instantiated for
#define REPRO_UNSUPPORTED (-1)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);
}

// Sets the dynamic shared-memory ceiling when a launch needs more than
// the 48 KB a block gets without asking.
template <typename K>
inline cudaError_t reserve_smem(K kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
}
