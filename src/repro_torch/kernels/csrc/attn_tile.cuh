// One block's online-softmax attention of up to 16 query rows against a range
// of keys of one KV head: the body shared by flash_attention.cu (rows are
// query positions of one head) and decode_attention.cu (rows are the query
// heads of one KV group, one position each).
//
// Layout in shared memory, per block of 128 threads (4 warps x 4 rows):
//   q  16 x D fp32     the rows, read by every lane at the same address
//                      (a broadcast, no bank conflict)
//   k  32 x (D/2 + 1)  bf16 pairs, one pad word per key so that lane j
//                      reading key j walks 32 different banks
//   v  32 x D/2        bf16 pairs, lanes read neighbouring words
// At D = 256 that is 49,280 bytes, above the 48 KB default, so the kernels
// take it as dynamic shared memory after cudaFuncSetAttribute.
//
// Scores: lane j owns key j of the 32-key tile and takes the fp32 dot product
// with each of its warp's 4 rows. The running max, the running sum and the
// rescale follow the TPU kernels: masked scores are NEG_INF, masked
// probabilities 0, and the probabilities are rounded to bf16 (v's type)
// before the value product, which accumulates in fp32. Output: lane l owns
// the words l, l+32, ... of each of its rows.
#pragma once

#include "common.cuh"

namespace repro {
namespace attn {

constexpr int kRows = 16;     // query rows per block
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr int kKeys = 32;     // keys per tile: one per lane

template <int D>
struct Smem {
  float q[kRows][D];
  uint32_t k[kKeys][D / 2 + 1];
  uint32_t v[kKeys][D / 2];
};

// Attends rows [0, nrows) of q (row stride q_stride elements) against keys
// [k_begin, k_end) of k/v (key stride kv_stride elements). mask(row, key) is
// the row's own mask inside that range. Writes o (row stride o_stride) and,
// if lse is not null, lse[row] = m + log(l).
template <int D, class Mask>
__device__ __forceinline__ void attend_rows(
    Smem<D>& sm, const __nv_bfloat16* __restrict__ q, long q_stride, int nrows,
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    long kv_stride, int k_begin, int k_end, float scale, const Mask& mask,
    __nv_bfloat16* __restrict__ o, long o_stride, float* __restrict__ lse) {
  static_assert(D % 64 == 0, "head_dim must be a multiple of 64");
  constexpr int W = D / 2;   // 32-bit words per row
  constexpr int NP = D / 64; // output words per lane per row
  constexpr int C8 = D / 8;  // 16-byte chunks per row
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int i = tid; i < kRows * W; i += kThreads) {
    const int r = i / W, c = i % W;
    float2 f = make_float2(0.f, 0.f);
    if (r < nrows) f = bf2_to_f2(reinterpret_cast<const uint32_t*>(q + r * q_stride)[c]);
    *reinterpret_cast<float2*>(&sm.q[r][2 * c]) = f;
  }

  float acc[kRowsPerWarp][NP][2];
  float m[kRowsPerWarp], l[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int t = 0; t < NP; ++t) acc[r][t][0] = acc[r][t][1] = 0.f;
  }

  for (int k0 = (k_begin / kKeys) * kKeys; k0 < k_end; k0 += kKeys) {
    __syncthreads();  // the previous tile is no longer read
    for (int i = tid; i < kKeys * C8; i += kThreads) {
      const int j = i / C8, c = i % C8, key = k0 + j;
      uint4 kk = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (key < k_end) {
        kk = reinterpret_cast<const uint4*>(k + key * kv_stride)[c];
        vv = reinterpret_cast<const uint4*>(v + key * kv_stride)[c];
      }
      uint32_t* kr = &sm.k[j][4 * c];
      kr[0] = kk.x; kr[1] = kk.y; kr[2] = kk.z; kr[3] = kk.w;
      reinterpret_cast<uint4*>(&sm.v[j][0])[c] = vv;
    }
    __syncthreads();

    const int key = k0 + lane;
    const bool in_range = key >= k_begin && key < k_end;
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
#pragma unroll 4
    for (int c = 0; c < W; ++c) {
      const float2 kf = bf2_to_f2(sm.k[lane][c]);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float2 qf = *reinterpret_cast<const float2*>(&sm.q[warp * kRowsPerWarp + r][2 * c]);
        s[r] = fmaf(qf.x, kf.x, s[r]);
        s[r] = fmaf(qf.y, kf.y, s[r]);
      }
    }

    float p[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const bool ok = in_range && mask(warp * kRowsPerWarp + r, key);
      const float sr = ok ? s[r] * scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float pr = ok ? expf(sr - m_new) : 0.f;
      const float alpha = expf(m[r] - m_new);
      l[r] = alpha * l[r] + warp_sum(pr);
      m[r] = m_new;
#pragma unroll
      for (int t = 0; t < NP; ++t) {
        acc[r][t][0] *= alpha;
        acc[r][t][1] *= alpha;
      }
      p[r] = __bfloat162float(__float2bfloat16(pr));
    }

#pragma unroll 4
    for (int j = 0; j < kKeys; ++j) {
      float pj[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) pj[r] = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
      for (int t = 0; t < NP; ++t) {
        const float2 vf = bf2_to_f2(sm.v[j][lane + 32 * t]);
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          acc[r][t][0] = fmaf(pj[r], vf.x, acc[r][t][0]);
          acc[r][t][1] = fmaf(pj[r], vf.y, acc[r][t][1]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = warp * kRowsPerWarp + r;
    if (row >= nrows) continue;
    const float lc = fmaxf(l[r], 1e-20f);
    uint32_t* orow = reinterpret_cast<uint32_t*>(o + row * o_stride);
#pragma unroll
    for (int t = 0; t < NP; ++t) orow[lane + 32 * t] = f2_to_bf2(acc[r][t][0] / lc, acc[r][t][1] / lc);
    if (lse != nullptr && lane == 0) lse[row] = m[r] + logf(lc);
  }
}

}  // namespace attn
}  // namespace repro
