// Paged decode attention: one new query token per sequence, q (B,H,D) bf16,
// against a pool of KV pages pool_k/pool_v (P,ps,KVH,D) bf16 through a block
// table tables (B,T) int32: position p of row b lives in page
// tables[b, p / ps] at offset p % ps, and the valid keys are p < kv_len[b]
// (clamped to the T*ps positions the table spans). Returns o (B,H,D) bf16 and
// lse (B,H) fp32. Table entries past a row's live span may name any page and
// never change the output: they are never read.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:
// paged_decode_attention (_paged_kernel), which walked a (B, KVH, T) grid in
// order with the block table and kv_len scalar-prefetched, one pool page per
// grid step, and clamped dead steps to the last live page (its fetch-skip).
//
// What bounds it on an H100: it must read each row's live K and V once,
// B x kv_len x KVH x D x 2 B x 2; at the streaming serving slice (8 slots, one
// KV head of D=256, kv_len up to 256) that is at most 2.1 MB, under a
// microsecond of memory time. Launch latency and the few blocks in flight
// (B x KVH = 8 on 132 SMs) bound it in practice, as for decode_attention.cu.
//
// What the design does about it: it is decode_attention.cu with another key
// address. The grid is the same, (ceil(group/16), KVH, B) blocks of 128
// threads, the 16 query heads of one KV group as the 16 rows of one block, so
// each K/V tile is read once for all of them. There is no scalar prefetch: a
// block reads its own table row, one entry per key it loads (from L1 after
// the first). The TPU's one page per grid step is not carried over: the
// shared 32-key tile (attn_tile.cuh) spans two 16-token pages, each key
// found through the table. The fetch-skip becomes the loop bound: a block
// walks only keys [0, kv_len[b]), so dead pages are never loaded. Splitting
// the keys across blocks with an lse combine is later work.
#include "attn_tile.cuh"

namespace {

using repro::attn::kRows;
using repro::attn::kThreads;
using repro::attn::Smem;

// Element offset of key `key` of one row: its page through the table row,
// then its slot in the page. The KV head's offset is in the base pointer.
struct PagedKeyAt {
  const int* table;  // this row's T page ids
  int page_size;
  long page_stride;  // ps * KVH * D
  long key_stride;   // KVH * D
  __device__ long operator()(int key) const {
    const long page = __ldg(table + key / page_size);
    return page * page_stride + static_cast<long>(key % page_size) * key_stride;
  }
};

struct NoMask {
  __device__ bool operator()(int, int) const { return true; }
};

template <int D>
__global__ void __launch_bounds__(kThreads)
    paged_decode_attention_kernel(const __nv_bfloat16* __restrict__ q,
                                  const __nv_bfloat16* __restrict__ pool_k,
                                  const __nv_bfloat16* __restrict__ pool_v,
                                  const int* __restrict__ tables, const int* __restrict__ kv_len,
                                  __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int T,
                                  int page_size, int H, int KVH, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem_raw);
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int group = H / KVH;
  const int r0 = blockIdx.x * kRows;
  const int nrows = min(kRows, group - r0);
  const long head0 = static_cast<long>(b) * H + static_cast<long>(kvh) * group + r0;
  const long key_stride = static_cast<long>(KVH) * D;
  const PagedKeyAt key_at{tables + static_cast<long>(b) * T, page_size,
                          static_cast<long>(page_size) * key_stride, key_stride};
  const int last = max(0, min(kv_len[b], T * page_size));
  const long head_at = static_cast<long>(kvh) * D;
  const repro::attn::Bf16Rows<PagedKeyAt> rows{pool_k + head_at, pool_v + head_at, key_at};
  repro::attn::attend_rows<D>(sm, q + head0 * D, D, nrows, rows, 0, last, scale, NoMask{},
                              o + head0 * D, D, lse + head0);
}

template <int D>
int launch(const void* q, const void* pool_k, const void* pool_v, const void* tables,
           const void* kv_len, void* o, void* lse, int B, int T, int page_size, int H, int KVH,
           float scale, cudaStream_t stream) {
  const size_t smem = sizeof(Smem<D>);
  cudaError_t err = repro::allow_smem(paged_decode_attention_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const int group = H / KVH;
  const dim3 grid((group + kRows - 1) / kRows, KVH, B);
  paged_decode_attention_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(pool_k),
      static_cast<const __nv_bfloat16*>(pool_v), static_cast<const int*>(tables),
      static_cast<const int*>(kv_len), static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      T, page_size, H, KVH, scale);
  return cudaGetLastError();
}

}  // namespace

REPRO_EXPORT int paged_decode_attention_fwd(const void* q, const void* pool_k, const void* pool_v,
                                            const void* tables, const void* kv_len, void* o,
                                            void* lse, int B, int T, int page_size, int H, int KVH,
                                            int D, float scale, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, pool_k, pool_v, tables, kv_len, o, lse, B, T, page_size, H, KVH, scale, s);
    case 128:
      return launch<128>(q, pool_k, pool_v, tables, kv_len, o, lse, B, T, page_size, H, KVH, scale,
                         s);
    case 256:
      return launch<256>(q, pool_k, pool_v, tables, kv_len, o, lse, B, T, page_size, H, KVH, scale,
                         s);
    default: return cudaErrorInvalidValue;
  }
}
