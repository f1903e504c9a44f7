// Shared helpers of the Hopper kernels: dtype codes (the Python wrappers
// pass the same numbers), float conversions, warp reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

enum { RT_F32 = 0, RT_BF16 = 1 };

// running-max start of the online softmax; finite, so exp(NEG - NEG) is 1
// and never NaN
#define RT_NEG (-1e30f)
#define RT_NEG_INF (-__int_as_float(0x7f800000))

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// round to nearest even, as torch's .to(dtype)
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Opt a kernel into more than 48 KB of dynamic shared memory (H100: up to
// 227 KB a block).  Remembers the largest size already granted.
template <typename K>
static cudaError_t rt_allow_smem(K kernel, size_t bytes, size_t* granted) {
  if (bytes <= 48 * 1024 || bytes <= *granted) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *granted = bytes;
  return err;
}
