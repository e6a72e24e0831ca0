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
// What bounds it on an H100: bytes. It must read each row's live int8 K and V
// once with their scales, B x kv_len x KVH x (2 D + 8) bytes: at the int8-KV
// lockstep path (B=8, one KV head of D=256, kv_len up to 160) at most 0.66 MB,
// about 0.2 us at 3.35 TB/s. As for decode_attention.cu, launch latency and
// the few blocks in flight (B x KVH = 8 on 132 SMs) bound it in practice.
//
// What the design does about it: it is decode_attention.cu with another
// loader. The shared tile body (attn_tile.cuh) takes an Int8Rows loader that
// reads 8 int8 values (8 bytes) per thread and chunk, multiplies them by the
// key's scale in fp32 and rounds them to bf16 as they land in shared memory;
// the scores, the online softmax and the value product are the bf16 kernels'
// own. The cache crosses the memory bus as int8, half the bytes of bf16. The
// grid is one block per (row, KV head) with the 16 query heads of the group
// as the block's rows, so each K/V tile is read and dequantized once for all
// of them, and a block walks only keys [first, last) of its row.
#include "attn_tile.cuh"

namespace {

using repro::attn::kRows;
using repro::attn::kThreads;
using repro::attn::Smem;

struct NoMask {
  __device__ bool operator()(int, int) const { return true; }
};

template <int D>
__global__ void __launch_bounds__(kThreads)
    decode_attention_quant_kernel(const __nv_bfloat16* __restrict__ q,
                                  const int8_t* __restrict__ k, const int8_t* __restrict__ v,
                                  const float* __restrict__ k_scale,
                                  const float* __restrict__ v_scale,
                                  const int* __restrict__ cache_len,
                                  __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int S,
                                  int H, int KVH, float scale, int window, int pos_offset) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem_raw);
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int group = H / KVH;
  const int r0 = blockIdx.x * kRows;
  const int nrows = min(kRows, group - r0);
  const long head0 = static_cast<long>(b) * H + static_cast<long>(kvh) * group + r0;
  const long kv_stride = static_cast<long>(KVH) * D;
  const long kv_at = static_cast<long>(b) * S * kv_stride + static_cast<long>(kvh) * D;
  const long sc_at = static_cast<long>(b) * S * KVH + kvh;
  const repro::attn::Int8Rows rows{k + kv_at, v + kv_at, k_scale + sc_at, v_scale + sc_at,
                                   kv_stride, KVH};

  // valid: pos_offset + key < len, and (window) pos_offset + key > len - 1 - window
  const int len = cache_len[b];
  const int last = max(0, min(S, len - pos_offset));
  const int first = window > 0 ? min(last, max(0, len - window - pos_offset)) : 0;
  repro::attn::attend_rows<D>(sm, q + head0 * D, D, nrows, rows, first, last, scale, NoMask{},
                              o + head0 * D, D, lse + head0);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* k_scale, const void* v_scale,
           const void* cache_len, void* o, void* lse, int B, int S, int H, int KVH, float scale,
           int window, int pos_offset, cudaStream_t stream) {
  const size_t smem = sizeof(Smem<D>);
  cudaError_t err = repro::allow_smem(decode_attention_quant_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const int group = H / KVH;
  const dim3 grid((group + kRows - 1) / kRows, KVH, B);
  decode_attention_quant_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(cache_len),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), S, H, KVH, scale, window,
      pos_offset);
  return cudaGetLastError();
}

}  // namespace

REPRO_EXPORT int decode_attention_quant_fwd(const void* q, const void* k, const void* v,
                                            const void* k_scale, const void* v_scale,
                                            const void* cache_len, void* o, void* lse, int B,
                                            int S, int H, int KVH, int D, float scale, int window,
                                            int pos_offset, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, k_scale, v_scale, cache_len, o, lse, B, S, H, KVH, scale, window,
                        pos_offset, s);
    case 128:
      return launch<128>(q, k, v, k_scale, v_scale, cache_len, o, lse, B, S, H, KVH, scale,
                         window, pos_offset, s);
    case 256:
      return launch<256>(q, k, v, k_scale, v_scale, cache_len, o, lse, B, S, H, KVH, scale,
                         window, pos_offset, s);
    default: return cudaErrorInvalidValue;
  }
}
