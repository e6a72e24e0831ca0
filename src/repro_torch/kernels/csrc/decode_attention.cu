// Decode attention: one new query token per sequence, q (B,H,D), against a
// KV cache k/v (B,S,KVH,D), all bf16, with a per-row valid length
// cache_len (B,) int32, the absolute position pos_offset of cache slot 0 and
// an optional sliding window. Returns o (B,H,D) bf16 and lse (B,H) fp32, so
// the shards of a sequence-sharded cache can be combined exactly.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:
// decode_attention (_kernel, with the ragged fetch-skip _ragged_block_index),
// which walked a (B, KVH, nS) grid in order and took the query heads of one
// KV group together.
//
// What bounds it on an H100: it reads each row's live K and V once, at most
// 8 x 160 x 256 x 2 B x 2 = 1.3 MB at the lockstep serving shape (B=8, one
// KV head, D=256), which the memory moves in well under a microsecond. What
// bounds it in practice is latency: the chain of one block's loads,
// products and stores, and the two launches.
//
// What the design does about it (split_kv.cuh): the S slots are cut into
// splits of split_keys keys (the wrapper's split_rule.split_keys, from the
// shapes alone, never from cache_len), one block of four warps per (split,
// 16 heads of a KV group, row): at the lockstep shape 10 splits of one
// 16-key tile, 80 blocks. The 16 heads are the M of mma.m16n8k16, so both
// products run on the tensor cores and each K/V tile is read once for all
// of them (the TPU kernel's grouping). The ragged fetch-skip becomes the
// block's key range: a block attends only its split's share of the row's
// live keys [first, last) (first set by the window, last by cache_len), and
// a split with none writes lse NEG_INF and reads nothing. K/V rows arrive by
// cp.async. A second kernel merges the splits by their lse in a fixed order,
// with no atomics. A row with no live key comes out as the TPU kernel's: o =
// 0 and lse = NEG_INF + log(1e-20).
//
// Measured on an NVIDIA H100 80GB HBM3 at a 700 W power limit (chip_smoke.py,
// PERF.md section 6): 11.2 us for both launches at the lockstep step against
// 20.9 us for one SDPA call (0.54x); the CUDA-core body it replaces, one block
// per (row, KV head), took 47.8 us. Its own device time (attn_probe): split
// 3.1 us, merge 2.9 us; the rest is the gap between the two launches.
#include "split_kv.cuh"

namespace {

using repro::split::kRows;
using repro::split::kThreads;
using repro::split::NoMask;
using repro::split::Smem;

template <int D>
__global__ void __launch_bounds__(kThreads)
    decode_split_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const int* __restrict__ cache_len,
                        float* __restrict__ o_part, float* __restrict__ lse_part, int B, int S,
                        int H, int KVH, int split_keys, int rtiles, float scale, int window,
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
  using Rows = repro::attn::Bf16Rows<repro::attn::Strided>;
  const Rows rows{k + kv_at, v + kv_at, repro::attn::Strided{kv_stride}};
  const long part = static_cast<long>(s) * B * H + head0;
  repro::split::attend_split<D>(sm, nrows, rows, k_begin, k_end, scale, NoMask{},
                                o_part + part * D, lse_part + part);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* cache_len, void* o, void* lse,
           void* o_part, void* lse_part, int B, int S, int H, int KVH, int split_keys,
           float scale, int window, int pos_offset, cudaStream_t stream) {
  const size_t smem = sizeof(Smem<D>);
  cudaError_t err = repro::allow_smem(decode_split_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const int rtiles = (H / KVH + kRows - 1) / kRows;
  const int nsplit = (S + split_keys - 1) / split_keys;
  const dim3 grid(nsplit, KVH * rtiles, B);
  decode_split_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(cache_len),
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
REPRO_EXPORT int decode_attention_fwd(const void* q, const void* k, const void* v,
                                      const void* cache_len, void* o, void* lse, void* o_part,
                                      void* lse_part, int B, int S, int H, int KVH, int D,
                                      int split_keys, float scale, int window, int pos_offset,
                                      int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (split_keys < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, cache_len, o, lse, o_part, lse_part, B, S, H, KVH, split_keys,
                        scale, window, pos_offset, s);
    case 128:
      return launch<128>(q, k, v, cache_len, o, lse, o_part, lse_part, B, S, H, KVH, split_keys,
                         scale, window, pos_offset, s);
    case 256:
      return launch<256>(q, k, v, cache_len, o, lse, o_part, lse_part, B, S, H, KVH, split_keys,
                         scale, window, pos_offset, s);
    default: return cudaErrorInvalidValue;
  }
}
