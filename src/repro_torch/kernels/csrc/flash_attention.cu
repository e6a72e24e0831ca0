// Prefill attention: online-softmax attention of q (B,Sq,H,D) against k/v
// (B,Sk,KVH,D), all bf16, causal or not, with an optional sliding window, GQA
// (head h reads KV head h / (H/KVH)), a q_offset and a scale. k and v may be
// the first Sk positions of a longer cache: row b starts kv_batch_stride
// elements after row b-1 (Sk*KVH*D when contiguous). Chunked prefill calls it
// so, with Sq = one page of queries at q_offset against the cache prefix.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:flash_attention
// (_kernel), which walked a (B, H, nQ, nK) grid in order and carried the
// running max, sum and accumulator across the K axis in VMEM scratch.
//
// What bounds it on an H100: at the serving slice's prefill (B=8, Sq=Sk=128,
// 16 padded heads of D=256, one KV head) it moves ~17.8 MB and does ~1.07
// GFLOP under the causal mask, so the bound is the memory's (~5 us). This
// first version computes the products with fp32 FMAs on the CUDA cores, not
// the tensor cores, so the arithmetic bounds it in practice.
//
// What the design does about it: blocks run in parallel on 132 SMs, so the
// TPU's grid carry becomes a loop over 32-key tiles inside the block, and the
// loop stops at the block's causal bound (and starts at its window bound), so
// fully masked tiles are never loaded. Each block takes 16 query rows of one
// head; a ragged tail of Sq is masked, not asserted away. K and V tiles are
// read once per block with 16-byte loads. Padded heads (all-zero q) come out
// as the TPU kernel computes them: a uniform softmax over the visible keys.
#include "attn_tile.cuh"

namespace {

using repro::attn::kRows;
using repro::attn::kThreads;
using repro::attn::Smem;

struct FlashMask {
  int qpos0;  // absolute position of the block's row 0
  int causal;
  int window;  // 0 = none
  __device__ bool operator()(int row, int key) const {
    const int qp = qpos0 + row;
    return (!causal || key <= qp) && (window <= 0 || key > qp - window);
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                           int Sq, int Sk, int H, int KVH, long kv_batch_stride, float scale,
                           int causal, int window, int q_offset) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem_raw);
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kRows;
  const int kvh = h / (H / KVH);
  const int nrows = min(kRows, Sq - q0);
  const long row_stride = static_cast<long>(H) * D;
  const long kv_stride = static_cast<long>(KVH) * D;
  const long q_at = (static_cast<long>(b) * Sq + q0) * row_stride + static_cast<long>(h) * D;
  const long kv_at = static_cast<long>(b) * kv_batch_stride + static_cast<long>(kvh) * D;

  const int qlo = q0 + q_offset, qhi = q0 + nrows - 1 + q_offset;
  const int k_end = causal ? min(Sk, qhi + 1) : Sk;
  const int k_begin = window > 0 ? max(0, qlo - window + 1) : 0;
  const FlashMask mask{qlo, causal, window};
  using Rows = repro::attn::Bf16Rows<repro::attn::Strided>;
  repro::attn::attend_rows<D>(sm, q + q_at, row_stride, nrows,
                              Rows{k + kv_at, v + kv_at, repro::attn::Strided{kv_stride}},
                              k_begin, k_end, scale, mask, o + q_at, row_stride, nullptr);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk, int H,
           int KVH, long kv_batch_stride, float scale, int causal, int window, int q_offset,
           cudaStream_t stream) {
  const size_t smem = sizeof(Smem<D>);
  cudaError_t err = repro::allow_smem(flash_attention_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kRows - 1) / kRows, H, B);
  flash_attention_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Sq, Sk, H, KVH,
      kv_batch_stride, scale, causal, window, q_offset);
  return cudaGetLastError();
}

}  // namespace

REPRO_EXPORT int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B,
                                     int Sq, int Sk, int H, int KVH, int D,
                                     long long kv_batch_stride, float scale, int causal,
                                     int window, int q_offset, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, o, B, Sq, Sk, H, KVH, kv_batch_stride, scale, causal, window,
                        q_offset, s);
    case 128:
      return launch<128>(q, k, v, o, B, Sq, Sk, H, KVH, kv_batch_stride, scale, causal, window,
                        q_offset, s);
    case 256:
      return launch<256>(q, k, v, o, B, Sq, Sk, H, KVH, kv_batch_stride, scale, causal, window,
                        q_offset, s);
    default: return cudaErrorInvalidValue;
  }
}
