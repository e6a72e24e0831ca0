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
// 8 x 160 x 256 x 2 B x 2 = 1.3 MB at the serving slice's shapes (B=8, one KV
// head, D=256), which the memory moves in well under a microsecond; launch
// latency and the few blocks in flight bound it in practice.
//
// What the design does about it: the 16 query heads of the one KV group are
// the 16 rows of one block, so each K/V tile is read once for all of them
// (the TPU kernel's grouping). The ragged fetch-skip becomes per-row loop
// bounds: a block walks only keys [first, last) of its row, first set by the
// window and last by cache_len, so dead tiles are never loaded. One block per
// (row, KV head) is only 8 blocks at B=8 on 132 SMs: correct, and slow by
// design for now; splitting S across blocks with an lse combine is later work.
#include "attn_tile.cuh"

namespace {

using repro::attn::kRows;
using repro::attn::kThreads;
using repro::attn::Smem;

// The key range [first, last) of the row is the whole mask.
struct NoMask {
  __device__ bool operator()(int, int) const { return true; }
};

template <int D>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v, const int* __restrict__ cache_len,
                            __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int S, int H,
                            int KVH, float scale, int window, int pos_offset) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem_raw);
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int group = H / KVH;
  const int r0 = blockIdx.x * kRows;
  const int nrows = min(kRows, group - r0);
  const long head0 = static_cast<long>(b) * H + static_cast<long>(kvh) * group + r0;
  const long kv_stride = static_cast<long>(KVH) * D;
  const long kv_at = static_cast<long>(b) * S * kv_stride + static_cast<long>(kvh) * D;

  // valid: pos_offset + key < len, and (window) pos_offset + key > len - 1 - window
  const int len = cache_len[b];
  const int last = max(0, min(S, len - pos_offset));
  const int first = window > 0 ? min(last, max(0, len - window - pos_offset)) : 0;
  repro::attn::attend_rows<D>(sm, q + head0 * D, D, nrows, k + kv_at, v + kv_at, kv_stride, first,
                              last, scale, NoMask{}, o + head0 * D, D, lse + head0);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* cache_len, void* o, void* lse,
           int B, int S, int H, int KVH, float scale, int window, int pos_offset,
           cudaStream_t stream) {
  const size_t smem = sizeof(Smem<D>);
  cudaError_t err = repro::allow_smem(decode_attention_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const int group = H / KVH;
  const dim3 grid((group + kRows - 1) / kRows, KVH, B);
  decode_attention_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(cache_len),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), S, H, KVH, scale, window,
      pos_offset);
  return cudaGetLastError();
}

}  // namespace

REPRO_EXPORT int decode_attention_fwd(const void* q, const void* k, const void* v,
                                      const void* cache_len, void* o, void* lse, int B, int S,
                                      int H, int KVH, int D, float scale, int window,
                                      int pos_offset, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(q, k, v, cache_len, o, lse, B, S, H, KVH, scale, window, pos_offset, s);
    case 128: return launch<128>(q, k, v, cache_len, o, lse, B, S, H, KVH, scale, window, pos_offset, s);
    case 256: return launch<256>(q, k, v, cache_len, o, lse, B, S, H, KVH, scale, window, pos_offset, s);
    default: return cudaErrorInvalidValue;
  }
}
