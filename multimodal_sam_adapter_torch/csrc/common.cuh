// Shared helpers for the package's CUDA kernels.
//
// Every kernel takes float32 or bfloat16 storage and computes in float32.
// The launchers have a plain C interface (bound from Python with ctypes),
// launch on the caller's stream and return cudaGetLastError() as an int.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace msa {

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

constexpr int kMaxDevices = 64;

// Let `kernel` take `smem` bytes of dynamic shared memory (beyond 48 KB a
// kernel must opt in). The attribute persists per function and device, so
// it is set only when a launch needs more than this device has granted so
// far; `granted` is the calling launcher's record, one entry per device
// (a function-local static of each kernel instantiation).
template <typename Kernel>
inline cudaError_t reserve_smem(Kernel kernel, size_t smem,
                                int (&granted)[kMaxDevices]) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if ((int)smem <= granted[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) granted[dev] = (int)smem;
  return err;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

}  // namespace msa
