// RMSNorm: y = x * rsqrt(mean(x^2) + eps) * (1 + w), in fp32, output in bf16.
// x (R, D) bf16, w (D,) fp32.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py:rmsnorm (_kernel), a
// single pass over row tiles of 256 rows.
//
// What bounds it on an H100: bytes. At the serving slice's prefill (1024 rows
// of D = 2048) it reads 4 MB and writes 4 MB, ~2.5 us at 3.35 TB/s; at a
// decode step (8 rows) it moves 65 KB and launch latency bounds it.
//
// What the design does about it: one block of 256 threads per row; each
// thread reads its share of the row as bf16 pairs (coalesced 4-byte loads),
// the sum of squares is reduced in fp32 through warp shuffles and shared
// memory, and the second pass re-reads the row from L1/L2 rather than from
// device memory, so each row crosses the memory bus once each way.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
                   __nv_bfloat16* __restrict__ out, int D, float eps) {
  __shared__ float partial[kThreads / 32];
  const int row = blockIdx.x, tid = threadIdx.x;
  const int pairs = D / 2;
  const uint32_t* xr = reinterpret_cast<const uint32_t*>(x + static_cast<long>(row) * D);
  uint32_t* orow = reinterpret_cast<uint32_t*>(out + static_cast<long>(row) * D);

  float ss = 0.f;
  for (int i = tid; i < pairs; i += kThreads) {
    const float2 f = repro::bf2_to_f2(xr[i]);
    ss = fmaf(f.x, f.x, ss);
    ss = fmaf(f.y, f.y, ss);
  }
  ss = repro::warp_sum(ss);
  if ((tid & 31) == 0) partial[tid >> 5] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) total += partial[i];
  const float inv = rsqrtf(total / static_cast<float>(D) + eps);

  for (int i = tid; i < pairs; i += kThreads) {
    const float2 f = repro::bf2_to_f2(xr[i]);
    const float2 wf = reinterpret_cast<const float2*>(w)[i];
    orow[i] = repro::f2_to_bf2((f.x * inv) * (1.f + wf.x), (f.y * inv) * (1.f + wf.y));
  }
}

}  // namespace

REPRO_EXPORT int rmsnorm_fwd(const void* x, const void* w, void* out, int R, int D, float eps,
                             int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (R == 0) return cudaSuccess;
  rmsnorm_kernel<<<R, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
      static_cast<__nv_bfloat16*>(out), D, eps);
  return cudaGetLastError();
}
