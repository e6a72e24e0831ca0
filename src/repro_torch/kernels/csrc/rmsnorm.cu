// RMSNorm: y = x * rsqrt(mean(x^2) + eps) * (1 + w), in fp32, output in bf16.
// x (R, D) bf16 with D even, w (D,) fp32.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py:rmsnorm (_kernel), a
// single pass over row tiles of 256 rows.
//
// What bounds it on an H100: bytes. At the serving slice's prefill (1024 rows
// of D = 2048) it reads 4 MB and writes 4 MB, ~2.5 us at 3.35 TB/s; at a
// decode step (8 rows) it moves 65 KB and launch latency bounds it.
//
// What the design does about it: one warp per row, and no barrier but the
// warp's own shuffles. The row is read once, in 16-byte loads (lane l takes
// loads l, l + 32, ...: 8 a lane at D = 2048, 10 at 2560, 20 at 5120), and
// held in registers while the sum of squares is reduced. Every load of w is
// in flight beside x's: as float4 into registers (all of w up to D = 2560)
// or by cp.async into the block's shared memory (the rest at 5120: a decode
// step finds w cold, and a second trip to it would wait on the sum). A
// block is one warp: at a decode step's 8 rows the rows spread over 8 SMs,
// and no SM's L1 carries more than one row's x, w and y. A D that is even
// but not a multiple of 8 (rows not 16-byte aligned) takes the same body
// with 4-byte loads of bf16 pairs. A row too wide for the registers (past
// 8,192, or 5,120 in pairs) is read twice, the second time from L2. The
// arithmetic is the TPU kernel's: the fp32 sum of x^2 (in this order: each
// lane over its even loads and over its odd loads, the two added, then a
// butterfly over the lanes; one sum a lane when the row is read twice),
// inv = rsqrt(sum / D + eps), (x inv)(1 + w).
//
// Two more entries serve a row whose width is split over ranks (tensor
// parallelism: mamba2's gated norm over d_inner = 5,120, 2,560 columns a
// rank). rmsnorm_sumsq writes each row's fp32 sum of x^2 over the rank's
// columns; the caller sums those over the ranks; rmsnorm_scaled_fwd then
// writes (x inv)(1 + w) with inv = rsqrt(ss / width + eps) from the summed
// ss and the whole width. Both are one warp a row with 16-byte loads as
// above (4-byte loads of bf16 pairs where D is not a multiple of 8), and
// neither holds the row in registers: the first has nothing to write back,
// the second nothing to reduce. Each reads x once; bytes bound both.
#include "common.cuh"

namespace {

// `Vec` is the load: uint4 (8 bf16) or uint32_t (2 bf16); the w values of
// load i, as float pairs
template <class Vec>
__device__ __forceinline__ void load_w(const float* __restrict__ w, int i,
                                       float2 (&wf)[sizeof(Vec) / 4]) {
  if constexpr (sizeof(Vec) == 16) {
    const float4 a = reinterpret_cast<const float4*>(w)[2 * i];
    const float4 b = reinterpret_cast<const float4*>(w)[2 * i + 1];
    wf[0] = make_float2(a.x, a.y);
    wf[1] = make_float2(a.z, a.w);
    wf[2] = make_float2(b.x, b.y);
    wf[3] = make_float2(b.z, b.w);
  } else {
    wf[0] = reinterpret_cast<const float2*>(w)[i];
  }
}

template <class Vec>
__device__ __forceinline__ float sum_sq(const Vec& v, float ss) {
  const uint32_t* u = reinterpret_cast<const uint32_t*>(&v);
#pragma unroll
  for (int q = 0; q < static_cast<int>(sizeof(Vec) / 4); ++q) {
    const float2 f = repro::bf2_to_f2(u[q]);
    ss = fmaf(f.x, f.x, ss);
    ss = fmaf(f.y, f.y, ss);
  }
  return ss;
}

template <class Vec>
__device__ __forceinline__ Vec scaled(const Vec& v, const float2 (&wf)[sizeof(Vec) / 4],
                                      float inv) {
  const uint32_t* u = reinterpret_cast<const uint32_t*>(&v);
  Vec o;
  uint32_t* ou = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
  for (int q = 0; q < static_cast<int>(sizeof(Vec) / 4); ++q) {
    const float2 f = repro::bf2_to_f2(u[q]);
    ou[q] = repro::f2_to_bf2((f.x * inv) * (1.f + wf[q].x), (f.y * inv) * (1.f + wf[q].y));
  }
  return o;
}

// Of the V loads of a lane, those whose w is held in registers: x's words
// and these w stay within 160 registers (all of w up to D = 2560; half of it
// at 5120). The w of the others is copied into shared memory.
template <class Vec>
__host__ __device__ constexpr int reg_w_loads(int V) {
  constexpr int W = sizeof(Vec) / 4;  // bf16 pairs a load
  const int fit = (160 - W * V) / (2 * W);
  return fit >= V ? V : (fit > 0 ? fit : 0);
}

// w of load i (2 W floats) into shared memory at dst + (i - first) 2 W, by
// cp.async and cached in L1 (the rows of an SM read the same w)
template <class Vec>
__device__ __forceinline__ void copy_w(float* dst, const float* __restrict__ w, int i,
                                       int first) {
  constexpr int F = sizeof(Vec) / 2;  // floats of w a load
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst + (i - first) * F));
  if constexpr (F == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(w + i * F));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(d + 16), "l"(w + i * F + 4));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(w + i * F));
  }
}

// One warp, one row. V loads a lane held in registers (rows of at most 32 V
// loads); the rest of w is copied into shared memory first, then x and the
// w held in registers are loaded, so that every load is in flight before the
// reduction. A lane reads back only the w it copied. V == 0: any row, read
// twice.
template <class Vec, int V>
__global__ void __launch_bounds__(32)
    rmsnorm_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
                   __nv_bfloat16* __restrict__ out, int D, float eps) {
  constexpr int W = sizeof(Vec) / 4;  // bf16 pairs a load
  const int lane = threadIdx.x;
  const long row = blockIdx.x;
  const int nv = D / (2 * W);  // loads in the row
  const Vec* xr = reinterpret_cast<const Vec*>(x + row * D);
  Vec* orow = reinterpret_cast<Vec*>(out + row * D);
  float ss[2] = {0.f, 0.f};  // even and odd loads' sums, added before the butterfly
  if constexpr (V > 0) {
    constexpr int PF = reg_w_loads<Vec>(V);
    extern __shared__ __align__(16) float w_rest[];  // w of the loads from 32 PF on
#pragma unroll
    for (int k = PF; k < V; ++k)
      if (k * 32 + lane < nv) copy_w<Vec>(w_rest, w, k * 32 + lane, 32 * PF);
    asm volatile("cp.async.commit_group;\n" ::);
    Vec v[V];
    float2 wf[PF > 0 ? PF : 1][W];
#pragma unroll
    for (int k = 0; k < V; ++k)
      if (k * 32 + lane < nv) v[k] = xr[k * 32 + lane];
#pragma unroll
    for (int k = 0; k < PF; ++k)
      if (k * 32 + lane < nv) load_w<Vec>(w, k * 32 + lane, wf[k]);
#pragma unroll
    for (int k = 0; k < V; ++k)
      if (k * 32 + lane < nv) ss[k & 1] = sum_sq(v[k], ss[k & 1]);
    const float inv = rsqrtf(repro::warp_sum(ss[0] + ss[1]) / static_cast<float>(D) + eps);
    asm volatile("cp.async.wait_group 0;\n" ::);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int i = k * 32 + lane;
      if (i < nv) {
        if (k < PF) {
          orow[i] = scaled(v[k], wf[k], inv);
        } else {
          float2 wr[W];
          load_w<Vec>(w_rest, i - 32 * PF, wr);
          orow[i] = scaled(v[k], wr, inv);
        }
      }
    }
  } else {
    for (int i = lane; i < nv; i += 32) ss[0] = sum_sq(xr[i], ss[0]);
    const float inv = rsqrtf(repro::warp_sum(ss[0]) / static_cast<float>(D) + eps);
    for (int i = lane; i < nv; i += 32) {
      float2 wf[W];
      load_w<Vec>(w, i, wf);
      orow[i] = scaled(xr[i], wf, inv);
    }
  }
}

template <class Vec, int V>
cudaError_t launch(const void* x, const void* w, void* out, int R, int D, float eps,
                   cudaStream_t stream) {
  constexpr int F = sizeof(Vec) / 2, PF = V > 0 ? reg_w_loads<Vec>(V) : 0;
  const int nv = D / F;
  const size_t smem = V > 0 && nv > 32 * PF ? static_cast<size_t>(nv - 32 * PF) * F * 4 : 0;
  const cudaError_t err = repro::allow_smem(rmsnorm_kernel<Vec, V>, smem);
  if (err != cudaSuccess) return err;
  rmsnorm_kernel<Vec, V><<<R, 32, smem, stream>>>(static_cast<const __nv_bfloat16*>(x),
                                                  static_cast<const float*>(w),
                                                  static_cast<__nv_bfloat16*>(out), D, eps);
  return cudaGetLastError();
}

// the smallest register-held instantiation that takes `per` loads a lane
template <class Vec, int V, int... More>
cudaError_t dispatch(int per, const void* x, const void* w, void* out, int R, int D, float eps,
                     cudaStream_t stream) {
  if (per <= V) return launch<Vec, V>(x, w, out, R, D, eps, stream);
  if constexpr (sizeof...(More) > 0)
    return dispatch<Vec, More...>(per, x, w, out, R, D, eps, stream);
  else
    return launch<Vec, 0>(x, w, out, R, D, eps, stream);
}

// One warp, one row: the fp32 sum of x^2 over the row's D columns, two
// loads a lane in flight, each into its own sum (added before the butterfly).
template <class Vec>
__global__ void __launch_bounds__(32)
    rmsnorm_sumsq_kernel(const __nv_bfloat16* __restrict__ x, float* __restrict__ ss, int D) {
  constexpr int W = sizeof(Vec) / 4;
  const int lane = threadIdx.x;
  const long row = blockIdx.x;
  const int nv = D / (2 * W);
  const Vec* xr = reinterpret_cast<const Vec*>(x + row * D);
  float s0 = 0.f, s1 = 0.f;
  int i = lane;
  for (; i + 32 < nv; i += 64) {
    const Vec a = xr[i], b = xr[i + 32];
    s0 = sum_sq(a, s0);
    s1 = sum_sq(b, s1);
  }
  if (i < nv) s0 = sum_sq(xr[i], s0);
  const float t = repro::warp_sum(s0 + s1);
  if (lane == 0) ss[row] = t;
}

// One warp, one row: (x inv)(1 + w) with inv = rsqrt(ss[row] / width + eps).
template <class Vec>
__global__ void __launch_bounds__(32)
    rmsnorm_scaled_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ ss,
                          const float* __restrict__ w, __nv_bfloat16* __restrict__ out, int D,
                          float width, float eps) {
  constexpr int W = sizeof(Vec) / 4;
  const int lane = threadIdx.x;
  const long row = blockIdx.x;
  const int nv = D / (2 * W);
  const Vec* xr = reinterpret_cast<const Vec*>(x + row * D);
  Vec* orow = reinterpret_cast<Vec*>(out + row * D);
  const float inv = rsqrtf(ss[row] / width + eps);
  for (int i = lane; i < nv; i += 32) {
    float2 wf[W];
    load_w<Vec>(w, i, wf);
    orow[i] = scaled(xr[i], wf, inv);
  }
}

}  // namespace

REPRO_EXPORT int rmsnorm_sumsq(const void* x, void* ss, int R, int D, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (D <= 0 || D % 2 != 0) return cudaErrorInvalidValue;
  if (R == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  if (D % 8 == 0)
    rmsnorm_sumsq_kernel<uint4><<<R, 32, 0, s>>>(xb, static_cast<float*>(ss), D);
  else
    rmsnorm_sumsq_kernel<uint32_t><<<R, 32, 0, s>>>(xb, static_cast<float*>(ss), D);
  return cudaGetLastError();
}

REPRO_EXPORT int rmsnorm_scaled_fwd(const void* x, const void* ss, const void* w, void* out,
                                    int R, int D, int width, float eps, int device,
                                    void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (D <= 0 || D % 2 != 0 || width < D) return cudaErrorInvalidValue;
  if (R == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* sf = static_cast<const float*>(ss);
  const auto* wf = static_cast<const float*>(w);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  if (D % 8 == 0)
    rmsnorm_scaled_kernel<uint4><<<R, 32, 0, s>>>(xb, sf, wf, ob, D, static_cast<float>(width),
                                                  eps);
  else
    rmsnorm_scaled_kernel<uint32_t><<<R, 32, 0, s>>>(xb, sf, wf, ob, D,
                                                     static_cast<float>(width), eps);
  return cudaGetLastError();
}

REPRO_EXPORT int rmsnorm_fwd(const void* x, const void* w, void* out, int R, int D, float eps,
                             int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (D <= 0 || D % 2 != 0) return cudaErrorInvalidValue;
  if (R == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % 8 == 0)
    return dispatch<uint4, 1, 2, 4, 8, 10, 16, 20, 32>((D / 8 + 31) / 32, x, w, out, R, D,
                                                           eps, s);
  return dispatch<uint32_t, 8, 32, 80>((D / 2 + 31) / 32, x, w, out, R, D, eps, s);
}
