// Decode attention over an int8 KV cache: one new query token per sequence,
// q (B,H,D) bf16, against k/v (B,S,KVH,D) int8 with one f32 scale per slot and
// KV head, k_scale/v_scale (B,S,KVH), a per-row valid length cache_len (B,)
// int32, the absolute position pos_offset of cache slot 0 and an optional
// sliding window. Key j's values are k[j] * k_scale[j] rounded to bf16, the
// numbers the plain version (ref.decode_attention_quant) gets by dequantizing
// the whole cache first. Returns o (B,H,D) bf16 and lse (B,H) fp32.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:
// decode_attention_quant (_quant_kernel), which walked a (B, KVH, nS) grid in
// order with cache_len scalar-prefetched and dequantized each int8 tile (and
// its scales) in VMEM right before the logits product, so that the bf16 cache
// never existed in HBM.
//
// What bounds it on an H100: bytes, at least. It must read each row's live
// int8 K and V once with their scales, B x kv_len x KVH x (2 D + 8) bytes: at
// the int8-KV lockstep path (B=8, one KV head of D=256, kv_len up to 160) at
// most 0.66 MB, about 0.2 us at 3.35 TB/s. As for decode_attention.cu,
// latency bounds it in practice.
//
// What the design does about it: it is decode_attention.cu with another
// loader policy of split_kv.cuh: splits of split_keys keys (80 blocks at the
// lockstep shape), both products on the tensor cores, the lse merge kernel.
// The Int8Rows loader reads 8 int8 values (8 bytes) per thread and chunk,
// multiplies them by the key's scale in fp32 and rounds them to bf16 as they
// land in shared memory, so the cache crosses the memory bus as int8, half
// the bytes of bf16, and no dequantized copy of it is ever written to device
// memory. The loads are synchronous, one 16-key tile a split: the int8 kernel
// takes 1.07x the bf16 one's time at the lockstep step, so a cp.async-staged
// int8 copy was not needed.
//
// Measured on an NVIDIA H100 80GB HBM3 at a 700 W power limit (chip_smoke.py,
// PERF.md section 6): 12.0 us for both launches at the int8-KV lockstep step
// against 20.9 us for one SDPA call on K/V dequantized beforehand (0.57x); the
// CUDA-core body it replaces took 44.7 us. Its own device time (attn_probe):
// split 3.9 us, merge 3.0 us.
#include "split_kv.cuh"

namespace {

using repro::split::kRows;
using repro::split::kThreads;
using repro::split::NoMask;
using repro::split::Smem;

template <int D>
__global__ void __launch_bounds__(kThreads)
    decode_quant_split_kernel(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k,
                              const int8_t* __restrict__ v, const float* __restrict__ k_scale,
                              const float* __restrict__ v_scale,
                              const int* __restrict__ cache_len, float* __restrict__ o_part,
                              float* __restrict__ lse_part, int B, int S, int H, int KVH,
                              int split_keys, int rtiles, float scale, int window,
                              int pos_offset) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem_raw);
  const int s = blockIdx.x, kvh = blockIdx.y / rtiles, b = blockIdx.z;
  const int group = H / KVH, r0 = (blockIdx.y % rtiles) * kRows;
  const int nrows = min(kRows, group - r0);
  const long head0 = static_cast<long>(b) * H + static_cast<long>(kvh) * group + r0;
  repro::split::load_q<D>(sm, q + head0 * D, nrows);

  const int2 live = repro::split::live_range(cache_len[b], S, window, pos_offset);
  const int k_begin = max(s * split_keys, live.x), k_end = min((s + 1) * split_keys, live.y);
  const long kv_stride = static_cast<long>(KVH) * D;
  const long kv_at = static_cast<long>(b) * S * kv_stride + static_cast<long>(kvh) * D;
  const long sc_at = static_cast<long>(b) * S * KVH + kvh;
  const repro::attn::Int8Rows rows{k + kv_at, v + kv_at, k_scale + sc_at, v_scale + sc_at,
                                   kv_stride, KVH};
  const long part = static_cast<long>(s) * B * H + head0;
  repro::split::attend_split<D>(sm, nrows, rows, k_begin, k_end, scale, NoMask{},
                                o_part + part * D, lse_part + part);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* k_scale, const void* v_scale,
           const void* cache_len, void* o, void* lse, void* o_part, void* lse_part, int B, int S,
           int H, int KVH, int split_keys, float scale, int window, int pos_offset,
           cudaStream_t stream) {
  const size_t smem = sizeof(Smem<D>);
  cudaError_t err = repro::allow_smem(decode_quant_split_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const int rtiles = (H / KVH + kRows - 1) / kRows;
  const int nsplit = (S + split_keys - 1) / split_keys;
  const dim3 grid(nsplit, KVH * rtiles, B);
  decode_quant_split_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(cache_len),
      static_cast<float*>(o_part), static_cast<float*>(lse_part), B, S, H, KVH, split_keys,
      rtiles, scale, window, pos_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return repro::split::combine<D>(static_cast<const float*>(o_part),
                                  static_cast<const float*>(lse_part),
                                  static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
                                  nsplit, B * H, stream);
}

}  // namespace

// o_part (nsplit, B, H, D) and lse_part (nsplit, B, H), fp32, are the
// caller's scratch, nsplit = ceil(S / split_keys).
REPRO_EXPORT int decode_attention_quant_fwd(const void* q, const void* k, const void* v,
                                            const void* k_scale, const void* v_scale,
                                            const void* cache_len, void* o, void* lse,
                                            void* o_part, void* lse_part, int B, int S, int H,
                                            int KVH, int D, int split_keys, float scale,
                                            int window, int pos_offset, int device,
                                            void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (split_keys < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, k_scale, v_scale, cache_len, o, lse, o_part, lse_part, B, S, H,
                        KVH, split_keys, scale, window, pos_offset, s);
    case 128:
      return launch<128>(q, k, v, k_scale, v_scale, cache_len, o, lse, o_part, lse_part, B, S,
                         H, KVH, split_keys, scale, window, pos_offset, s);
    case 256:
      return launch<256>(q, k, v, k_scale, v_scale, cache_len, o, lse, o_part, lse_part, B, S,
                         H, KVH, split_keys, scale, window, pos_offset, s);
    default: return cudaErrorInvalidValue;
  }
}
