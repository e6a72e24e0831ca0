// Paged decode attention: one new query token per sequence, q (B,H,D) bf16,
// against a pool of KV pages pool_k/pool_v (P,ps,KVH,D) bf16 through a block
// table tables (B,T) int32: position p of row b lives in page
// tables[b, p / ps] at offset p % ps, and the valid keys are p < kv_len[b]
// (clamped to the T*ps positions the table spans). Returns o (B,H,D) bf16 and
// lse (B,H) fp32. Table entries past a row's live span may hold anything:
// neither they nor the pages they name are ever read.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:
// paged_decode_attention (_paged_kernel), which walked a (B, KVH, T) grid in
// order with the block table and kv_len scalar-prefetched, one pool page per
// grid step, and clamped dead steps to the last live page (its fetch-skip).
//
// What bounds it on an H100: it must read each row's live K and V once,
// B x kv_len x KVH x D x 2 B x 2; at the streaming serving slice (8 slots, one
// KV head of D=256, kv_len up to 256) that is at most 2.1 MB, under a
// microsecond of memory time. With one block per (row, KV head) only 8 blocks
// ran on 132 SMs, each walking its keys serially: latency, not bytes, bounded
// it.
//
// What the design does about it (split_kv.cuh): the keys are cut into splits
// of split_pages whole pages, one block of four warps per (split, 16 heads of
// a KV group, row): at the streaming shape 16 splits of one page, 128 blocks. The
// wrapper picks split_pages from the table width T*ps and the batch, never
// from kv_len, so no decode step waits on a read of the lengths. A block
// whose split starts at or past its row's kv_len writes an empty partial
// (lse NEG_INF) and reads nothing. A live block reads its split's live table
// entries once, one per page, into shared memory, then copies its keys with
// cp.async through them. Both products run on the tensor cores (the group's
// 16 heads are the M of mma.m16n8k16). A second kernel merges the splits by
// their lse in a fixed order, as the JAX package's combine_decode_shards
// does: no atomics, the same bits from launch to launch. Each split rounds p
// to bf16 against its own running max where one pass would use the global
// one; the difference stays inside the bf16 tolerance. Measured on an H100
// (PERF.md, section 6): about half of SDPA's time on K/V gathered beforehand,
// split and merge together, at the streaming step.
#include "split_kv.cuh"

namespace {

using repro::split::kRows;
using repro::split::kThreads;
using repro::split::NoMask;
using repro::split::Smem;

// Element offset of key `key` of one split: its page through the split's
// table entries in shared memory (pages[0] holds the page of key `first`),
// then its slot in the page. The KV head's offset is in the base pointer.
struct SplitPageKeyAt {
  const int* pages;
  int first;
  int page_size;
  long page_stride;  // ps * KVH * D
  long key_stride;   // KVH * D
  __device__ long operator()(int key) const {
    const int rel = key - first;
    return pages[rel / page_size] * page_stride + static_cast<long>(rel % page_size) * key_stride;
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads)
    paged_split_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ pool_k,
                       const __nv_bfloat16* __restrict__ pool_v, const int* __restrict__ tables,
                       const int* __restrict__ kv_len, float* __restrict__ o_part,
                       float* __restrict__ lse_part, int B, int T, int page_size, int H, int KVH,
                       int split_pages, int rtiles, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem_raw);
  int* pages = reinterpret_cast<int*>(smem_raw + sizeof(Smem<D>));
  const int s = blockIdx.x, kvh = blockIdx.y / rtiles, b = blockIdx.z;
  const int group = H / KVH, r0 = (blockIdx.y % rtiles) * kRows;
  const int nrows = min(kRows, group - r0);
  const long head0 = static_cast<long>(b) * H + static_cast<long>(kvh) * group + r0;
  repro::split::load_q<D>(sm, q + head0 * D, nrows);

  const int split_keys = split_pages * page_size;
  const int last = max(0, min(kv_len[b], T * page_size));
  const int k_begin = s * split_keys, k_end = min(k_begin + split_keys, last);
  if (k_begin < k_end) {  // the live entries of this split's pages, one read each
    const int* row = tables + static_cast<long>(b) * T + s * split_pages;
    const int live = (k_end - k_begin + page_size - 1) / page_size;
    for (int i = threadIdx.x; i < live; i += kThreads) pages[i] = row[i];
    __syncthreads();
  }
  const long key_stride = static_cast<long>(KVH) * D;
  const SplitPageKeyAt key_at{pages, k_begin, page_size, page_size * key_stride, key_stride};
  const long head_at = static_cast<long>(kvh) * D;
  const repro::attn::Bf16Rows<SplitPageKeyAt> rows{pool_k + head_at, pool_v + head_at, key_at};
  const long part = static_cast<long>(s) * B * H + head0;
  repro::split::attend_split<D>(sm, nrows, rows, k_begin, k_end, scale, NoMask{},
                                o_part + part * D, lse_part + part);
}

template <int D>
int launch(const void* q, const void* pool_k, const void* pool_v, const void* tables,
           const void* kv_len, void* o, void* lse, void* o_part, void* lse_part, int B, int T,
           int page_size, int H, int KVH, int split_pages, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(Smem<D>) + split_pages * sizeof(int);
  cudaError_t err = repro::allow_smem(paged_split_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const int rtiles = (H / KVH + kRows - 1) / kRows;
  const int nsplit = (T + split_pages - 1) / split_pages;
  const dim3 grid(nsplit, KVH * rtiles, B);
  paged_split_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(pool_k),
      static_cast<const __nv_bfloat16*>(pool_v), static_cast<const int*>(tables),
      static_cast<const int*>(kv_len), static_cast<float*>(o_part), static_cast<float*>(lse_part),
      B, T, page_size, H, KVH, split_pages, rtiles, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return repro::split::combine<D>(static_cast<const float*>(o_part),
                                  static_cast<const float*>(lse_part),
                                  static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
                                  nsplit, B * H, stream);
}

}  // namespace

// o_part (nsplit, B, H, D) and lse_part (nsplit, B, H), fp32, are the
// caller's scratch, nsplit = ceil(T / split_pages).
REPRO_EXPORT int paged_decode_attention_fwd(const void* q, const void* pool_k, const void* pool_v,
                                            const void* tables, const void* kv_len, void* o,
                                            void* lse, void* o_part, void* lse_part, int B, int T,
                                            int page_size, int H, int KVH, int D, int split_pages,
                                            float scale, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (split_pages < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, pool_k, pool_v, tables, kv_len, o, lse, o_part, lse_part, B, T,
                        page_size, H, KVH, split_pages, scale, s);
    case 128:
      return launch<128>(q, pool_k, pool_v, tables, kv_len, o, lse, o_part, lse_part, B, T,
                         page_size, H, KVH, split_pages, scale, s);
    case 256:
      return launch<256>(q, pool_k, pool_v, tables, kv_len, o, lse, o_part, lse_part, B, T,
                         page_size, H, KVH, split_pages, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
