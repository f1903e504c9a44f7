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

// The library links its own CUDA runtime; the current device is the
// thread's, shared with PyTorch's runtime.  Every entry point takes the
// device of its tensors and holds one of these while it launches: that
// device is current inside, and the caller's is current again after.
class RtDevice {
 public:
  explicit RtDevice(int device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device) {
      err_ = cudaSetDevice(device);
      restore_ = err_ == cudaSuccess;
    }
  }
  ~RtDevice() {
    if (restore_) cudaSetDevice(prev_);
  }
  RtDevice(const RtDevice&) = delete;
  RtDevice& operator=(const RtDevice&) = delete;
  cudaError_t status() const { return err_; }

 private:
  int prev_ = 0;
  bool restore_ = false;
  cudaError_t err_;
};

constexpr int RT_MAX_DEVICES = 64;

// Opt a kernel into more than 48 KB of dynamic shared memory (H100: up to
// 227 KB a block).  cudaFuncSetAttribute acts on the current device, so
// the largest size granted is remembered per device: granted[device].
template <typename K>
static cudaError_t rt_allow_smem(K kernel, size_t bytes,
                                 size_t (&granted)[RT_MAX_DEVICES]) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= RT_MAX_DEVICES) return cudaErrorInvalidDevice;
  if (bytes <= granted[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) granted[dev] = bytes;
  return err;
}
