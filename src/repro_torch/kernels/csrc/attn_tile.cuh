// Loader policies of the split-KV decode body (split_kv.cuh): how key j's K
// and V rows are found and read.
//   Bf16Rows  bf16 rows, found by a functor that maps a key to the element
//             offset of its row: contiguous (Strided, decode_attention.cu)
//             or through a block table of pages (the paged functor of
//             paged_decode_attention.cu);
//   Int8Rows  int8 rows with one f32 scale per key, dequantized to bf16
//             (value * scale in fp32, rounded to nearest) as they are read,
//             so the bf16 cache never exists in device memory
//             (decode_attention_quant.cu).
// Either way the tile in shared memory holds bf16, and the same arithmetic
// follows.
#pragma once

#include "common.cuh"

namespace repro {
namespace attn {

// Key `key` at element offset key * stride: a contiguous cache row.
struct Strided {
  long stride;
  __device__ long operator()(int key) const { return key * stride; }
};

// Loader of bf16 K/V rows: key j's D values start at element key_at(j) of k
// and of v (split_kv.cuh copies them with cp.async).
template <class KeyAt>
struct Bf16Rows {
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  KeyAt key_at;
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

}  // namespace attn
}  // namespace repro
