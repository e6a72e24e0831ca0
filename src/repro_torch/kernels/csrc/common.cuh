// Helpers shared by the port's CUDA kernels (built for sm_90a, one shared
// library per .cu file, bound to Python with ctypes: plain C entry points
// that take pointers, ints and the stream, and return cudaGetLastError()).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

namespace repro {

constexpr float kNegInf = -1e30f;  // the JAX package's NEG_INF: finite, so
                                   // NEG_INF - NEG_INF is 0, never NaN
constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = exp2(x * log2(e))

// two bf16 values packed in one 32-bit word -> two floats (exact)
__device__ __forceinline__ float2 bf2_to_f2(uint32_t w) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&w);
  return __bfloat1622float2(h);
}

__device__ __forceinline__ uint32_t f2_to_bf2(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Raise a kernel's dynamic shared memory limit above the 48 KB default.
template <class Kernel>
__host__ cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace repro

// The wrapper turns a non-zero return code into a message with this.
REPRO_EXPORT const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
