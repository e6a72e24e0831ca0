// Fused decode-step sampler: the LM-head product of h (B, d) with the head,
// an online log-sum-exp of the untempered logits, and a hash Gumbel-max draw,
// returning per row the token and its untempered logprob. inv_temp == 0 is
// greedy with the first-max rule; vocab columns >= vocab are never sampled.
//
// Replaces the TPU kernel src/repro/kernels/sampling.py:fused_sample
// (_sample_kernel, _hash_u32, _uniform_01), which walked a (B, vocab tiles)
// grid in order and carried the running max, sum and winner in VMEM scratch.
//
// What bounds it on an H100: bytes. The head is the tied embedding, 256000 x
// 2048 bf16 = 1.05 GB, read once per decode step: ~0.31 ms at 3.35 TB/s. The
// products (2 x 8 x 1.05 G bf16 FLOP) are far below the tensor-core bound.
//
// What the design does about it:
// - The head is read as the embedding lies, (Vp, d) row by row: a tied head's
//   (d, Vp) view is never made contiguous (that would copy 1 GB per step).
// - Pass 1: a block per 256 vocab rows and per 8 batch rows. h sits in shared
//   memory as fp32; each warp streams 4 vocab rows at a time with 16-byte
//   loads and dots them with all 8 h rows, so each head byte is read once.
//   Logits are the fp32 sums of bf16 products, never rounded to bf16. One
//   warp per batch row then scans the tile's 256 logits: max, sum of
//   exponentials, and the Gumbel-max winner, written to scratch.
// - Pass 2: a block per batch row merges the tiles' partials in a fixed
//   tree: the larger score wins, on equal scores the lower index. No
//   atomics, so a run is repeatable bit for bit.
// - The counter hash is splitmix32 in wrapping uint32 arithmetic, bit for bit
//   the TPU kernel's; z * inv_temp + g is rounded as two operations (no fused
//   multiply-add), and logf is the full-precision one (no fast math).
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileV = 256;  // vocab rows per block
constexpr int kRowsB = 8;    // batch rows per block: one scanning warp each
constexpr int kVStep = 4;    // vocab rows a warp dots at once
static_assert(kVStep * kRowsB == 32, "the reduce-scatter leaves one sum per lane");

__device__ __forceinline__ uint32_t hash_u32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float uniform_01(uint32_t seed, uint32_t pos) {
  const uint32_t bits = hash_u32(pos * 0x9E3779B1u + seed) >> 8;
  return __fmul_rn(__fadd_rn(static_cast<float>(bits), 0.5f), 1.0f / 16777216.0f);
}

// first-max order: larger score, then lower index
__device__ __forceinline__ bool better(float y1, int i1, float y2, int i2) {
  return y1 > y2 || (y1 == y2 && i1 < i2);
}

struct State {
  float m, l, y, z;
  int i;
  __device__ void merge(float m2, float l2, float y2, float z2, int i2) {
    const float mn = fmaxf(m, m2);
    l = l * expf(m - mn) + l2 * expf(m2 - mn);
    m = mn;
    if (better(y2, i2, y, i)) {
      y = y2;
      z = z2;
      i = i2;
    }
  }
  __device__ void merge_lane(int offset) {
    merge(__shfl_xor_sync(0xffffffffu, m, offset), __shfl_xor_sync(0xffffffffu, l, offset),
          __shfl_xor_sync(0xffffffffu, y, offset), __shfl_xor_sync(0xffffffffu, z, offset),
          __shfl_xor_sync(0xffffffffu, i, offset));
  }
};

__global__ void __launch_bounds__(kThreads)
    sample_tile_kernel(const __nv_bfloat16* __restrict__ h, const __nv_bfloat16* __restrict__ rows,
                       const int* __restrict__ seeds, const float* __restrict__ inv_temp,
                       float4* __restrict__ part, int* __restrict__ part_idx, int B, int d, int Vp,
                       int vocab) {
  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);  // [kRowsB][d]
  float* zs = hs + kRowsB * d;                  // [kRowsB][kTileV]
  const int tile = blockIdx.x, b0 = blockIdx.y * kRowsB;
  const int nb = min(kRowsB, B - b0);
  const int v0 = tile * kTileV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const int half_d = d / 2;
  for (int i = tid; i < kRowsB * half_d; i += kThreads) {
    const int r = i / half_d, c = i % half_d;
    float2 f = make_float2(0.f, 0.f);
    if (r < nb) f = repro::bf2_to_f2(reinterpret_cast<const uint32_t*>(h + static_cast<long>(b0 + r) * d)[c]);
    reinterpret_cast<float2*>(hs)[i] = f;
  }
  __syncthreads();

  for (int g = warp; g < kTileV / kVStep; g += kWarps) {
    const int vbase = v0 + g * kVStep;
    float acc[kVStep * kRowsB];
#pragma unroll
    for (int i = 0; i < kVStep * kRowsB; ++i) acc[i] = 0.f;
#pragma unroll 2
    for (int c = lane * 8; c < d; c += 32 * 8) {
      float wf[kVStep][8];
#pragma unroll
      for (int r = 0; r < kVStep; ++r) {
        uint4 raw = make_uint4(0, 0, 0, 0);
        if (vbase + r < Vp) raw = *reinterpret_cast<const uint4*>(rows + static_cast<long>(vbase + r) * d + c);
        const float2 a = repro::bf2_to_f2(raw.x), b = repro::bf2_to_f2(raw.y);
        const float2 e = repro::bf2_to_f2(raw.z), f = repro::bf2_to_f2(raw.w);
        wf[r][0] = a.x; wf[r][1] = a.y; wf[r][2] = b.x; wf[r][3] = b.y;
        wf[r][4] = e.x; wf[r][5] = e.y; wf[r][6] = f.x; wf[r][7] = f.y;
      }
#pragma unroll
      for (int bb = 0; bb < kRowsB; ++bb) {
        const float4* hp = reinterpret_cast<const float4*>(hs + bb * d + c);
        const float4 h0 = hp[0], h1 = hp[1];
#pragma unroll
        for (int r = 0; r < kVStep; ++r) {
          float s = acc[r * kRowsB + bb];
          s = fmaf(wf[r][0], h0.x, s); s = fmaf(wf[r][1], h0.y, s);
          s = fmaf(wf[r][2], h0.z, s); s = fmaf(wf[r][3], h0.w, s);
          s = fmaf(wf[r][4], h1.x, s); s = fmaf(wf[r][5], h1.y, s);
          s = fmaf(wf[r][6], h1.z, s); s = fmaf(wf[r][7], h1.w, s);
          acc[r * kRowsB + bb] = s;
        }
      }
    }
    // reduce-scatter across the warp: 31 shuffles leave lane L holding the
    // full sum of acc[L], i.e. vocab row vbase + L / kRowsB, batch row L % kRowsB
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) {
      const bool upper = (lane & o) != 0;
#pragma unroll
      for (int i = 0; i < o; ++i) {
        const float send = upper ? acc[i] : acc[i + o];
        const float keep = upper ? acc[i + o] : acc[i];
        acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
      }
    }
    zs[(lane % kRowsB) * kTileV + g * kVStep + lane / kRowsB] = acc[0];
  }
  __syncthreads();

  if (warp >= nb) return;
  const int b = b0 + warp;
  const float it = inv_temp[b];
  const uint32_t seed = static_cast<uint32_t>(seeds[b]);
  State st{repro::kNegInf, 0.f, repro::kNegInf, repro::kNegInf, INT_MAX};
  float zl[kTileV / 32];
#pragma unroll
  for (int t = 0; t < kTileV / 32; ++t) {
    const int pos = v0 + lane + 32 * t;
    const bool valid = pos < vocab && pos < Vp;
    const float z = valid ? zs[warp * kTileV + lane + 32 * t] : repro::kNegInf;
    zl[t] = z;
    st.m = fmaxf(st.m, z);
    if (valid) {
      const float u = uniform_01(seed, static_cast<uint32_t>(pos));
      const float gumbel = -logf(-logf(u));
      const float y = it == 0.f ? z : __fadd_rn(__fmul_rn(z, it), gumbel);
      if (y > st.y) {  // positions ascend, so strictly better keeps the first max
        st.y = y;
        st.z = z;
        st.i = pos;
      }
    }
  }
#pragma unroll
  for (int t = 0; t < kTileV / 32; ++t) {
    const int pos = v0 + lane + 32 * t;
    if (pos < vocab && pos < Vp) st.l += expf(zl[t] - st.m);
  }
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) st.merge_lane(o);
  if (lane == 0) {
    part[static_cast<long>(tile) * B + b] = make_float4(st.m, st.l, st.y, st.z);
    part_idx[static_cast<long>(tile) * B + b] = st.i;
  }
}

__global__ void __launch_bounds__(kThreads)
    sample_reduce_kernel(const float4* __restrict__ part, const int* __restrict__ part_idx,
                         int ntiles, int B, int* __restrict__ tok, float* __restrict__ lp) {
  __shared__ float4 s4[kWarps];
  __shared__ int si[kWarps];
  const int b = blockIdx.x, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  State st{repro::kNegInf, 0.f, repro::kNegInf, repro::kNegInf, INT_MAX};
  for (int t = tid; t < ntiles; t += kThreads) {
    const float4 p = part[static_cast<long>(t) * B + b];
    st.merge(p.x, p.y, p.z, p.w, part_idx[static_cast<long>(t) * B + b]);
  }
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) st.merge_lane(o);
  if (lane == 0) {
    s4[warp] = make_float4(st.m, st.l, st.y, st.z);
    si[warp] = st.i;
  }
  __syncthreads();
  if (tid != 0) return;
  for (int w = 1; w < kWarps; ++w) st.merge(s4[w].x, s4[w].y, s4[w].z, s4[w].w, si[w]);
  const float lse = st.m + logf(fmaxf(st.l, 1e-20f));
  tok[b] = st.i;
  lp[b] = st.z - lse;
}

}  // namespace

REPRO_EXPORT int fused_sample_num_tiles(int Vp) { return (Vp + kTileV - 1) / kTileV; }

// rows: the head as (Vp, d) rows (the tied embedding as it lies).
// part (ntiles, B) float4 and part_idx (ntiles, B) int32 are the wrapper's
// scratch for the partials of pass 1.
REPRO_EXPORT int fused_sample_fwd(const void* h, const void* rows, const void* seeds,
                                  const void* inv_temp, void* part, void* part_idx, void* tok,
                                  void* lp, int B, int d, int Vp, int vocab, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ntiles = fused_sample_num_tiles(Vp);
  const size_t smem = sizeof(float) * (static_cast<size_t>(kRowsB) * d + kRowsB * kTileV);
  err = repro::allow_smem(sample_tile_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(ntiles, (B + kRowsB - 1) / kRowsB);
  sample_tile_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(h), static_cast<const __nv_bfloat16*>(rows),
      static_cast<const int*>(seeds), static_cast<const float*>(inv_temp),
      static_cast<float4*>(part), static_cast<int*>(part_idx), B, d, Vp, vocab);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sample_reduce_kernel<<<B, kThreads, 0, s>>>(static_cast<const float4*>(part),
                                              static_cast<const int*>(part_idx), ntiles, B,
                                              static_cast<int*>(tok), static_cast<float*>(lp));
  return cudaGetLastError();
}
