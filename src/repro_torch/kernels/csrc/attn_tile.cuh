// One block's online-softmax attention of up to 16 query rows against a range
// of keys of one KV head, on the CUDA cores: the body of decode_attention.cu
// and decode_attention_quant.cu (rows are the query heads of one KV group,
// one position each). flash_attention.cu and paged_decode_attention.cu no
// longer use it: they take their products on the tensor cores (flash's own
// body; split_kv.cuh for the paged decode, which reuses the loader policies
// below). How key j's K and V rows reach shared memory is the caller's,
// through a loader policy:
//   Bf16Rows  bf16 rows, found by a functor that maps a key to the element
//             offset of its row, contiguous (Strided) or through a block
//             table of pages (the paged functor of
//             paged_decode_attention.cu, under split_kv.cuh);
//   Int8Rows  int8 rows with one f32 scale per key, dequantized to bf16
//             (value * scale in fp32, rounded to nearest) as they land, so
//             the bf16 cache never exists in device memory
//             (decode_attention_quant.cu).
// Either way the tile in shared memory holds bf16, and the same arithmetic
// follows.
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

// Key `key` at element offset key * stride: a contiguous cache row.
struct Strided {
  long stride;
  __device__ long operator()(int key) const { return key * stride; }
};

// Loader of bf16 K/V rows: key j's D values start at element key_at(j) of k
// and of v. load() gives the 16-byte chunk c (8 values) of each.
template <class KeyAt>
struct Bf16Rows {
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  KeyAt key_at;
  __device__ __forceinline__ void load(int key, int c, uint4& kk, uint4& vv) const {
    const long at = key_at(key);
    kk = reinterpret_cast<const uint4*>(k + at)[c];
    vv = reinterpret_cast<const uint4*>(v + at)[c];
  }
};

// 8 int8 values (8 bytes) times a scale, each rounded to bf16: 16 bytes.
__device__ __forceinline__ uint4 dequant8(uint2 raw, float s) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t word = i < 2 ? raw.x : raw.y;
    const int sh = (i & 1) * 16;
    const float a = static_cast<float>(static_cast<int8_t>((word >> sh) & 0xff));
    const float b = static_cast<float>(static_cast<int8_t>((word >> (sh + 8)) & 0xff));
    w[i] = f2_to_bf2(a * s, b * s);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Loader of int8 K/V rows of a contiguous cache: key j's D values start at
// element j * stride of k and of v, and its scales at j * scale_stride of
// k_scale and v_scale. load() dequantizes chunk c (8 values) to bf16.
struct Int8Rows {
  const int8_t* k;
  const int8_t* v;
  const float* k_scale;
  const float* v_scale;
  long stride;
  long scale_stride;
  __device__ __forceinline__ void load(int key, int c, uint4& kk, uint4& vv) const {
    const long at = key * stride;
    const float ks = __ldg(k_scale + key * scale_stride);
    const float vs = __ldg(v_scale + key * scale_stride);
    kk = dequant8(reinterpret_cast<const uint2*>(k + at)[c], ks);
    vv = dequant8(reinterpret_cast<const uint2*>(v + at)[c], vs);
  }
};

// Attends rows [0, nrows) of q (row stride q_stride elements) against keys
// [k_begin, k_end), whose K/V rows `rows` loads (Bf16Rows or Int8Rows).
// mask(row, key) is the row's own mask inside that range. Writes o (row
// stride o_stride) and, if lse is not null, lse[row] = m + log(l).
template <int D, class Rows, class Mask>
__device__ __forceinline__ void attend_rows(
    Smem<D>& sm, const __nv_bfloat16* __restrict__ q, long q_stride, int nrows,
    const Rows& rows, int k_begin, int k_end, float scale, const Mask& mask,
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
      if (key < k_end) rows.load(key, c, kk, vv);
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
