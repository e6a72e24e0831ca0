// Prefill attention: online-softmax attention of q (B,Sq,H,D) against k/v
// (B,Sk,KVH,D), all bf16, causal or not, with an optional sliding window, GQA
// (head h reads KV head h / (H/KVH)), a q_offset and a scale. k and v may be
// the first Sk positions of a longer cache: row b starts kv_batch_stride
// elements after row b-1 (Sk*KVH*D when contiguous). Chunked prefill calls it
// so, with Sq = one page of queries at q_offset against the cache prefix.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:flash_attention
// (_kernel), which walked a (B, H, nQ, nK) grid in order, carried the running
// max, sum and accumulator across the K axis in VMEM scratch, and took both
// products as bf16 x bf16 with fp32 accumulation, p rounded to v's type.
//
// What bounds it on an H100: at the serving slice's prefill (B=8, Sq=Sk=128,
// 16 padded heads of D=256, one KV head) it moves ~17.8 MB, almost all of it
// q and o, and does ~1.07 GFLOP under the causal mask, so the memory bounds it
// (~5 us). The products must run on the tensor cores to get near it.
//
// What the design does about it:
// - Both products are mma.sync.m16n8k16 (bf16 in, fp32 accumulate), exactly
//   the TPU kernel's dot_general contract. Fragments come from shared memory
//   through ldmatrix (V through ldmatrix.trans); p goes from the score
//   accumulator to bf16 A fragments in registers. Each of the 4 warps owns 16
//   rows; its fp32 output accumulator (16 x D) stays in registers (128 per
//   thread at D=256), q stays in shared memory and is re-read per key tile,
//   and the key tile is 32 keys at D=256 (64 below), to stay clear of spills.
// - A block takes 64 rows: hb heads of one KV group (hb the largest power of
//   two dividing the group, at most 16) at 64/hb consecutive positions, so
//   every K/V tile read serves all of them and the causal and window bounds
//   are those of the block's positions. At gemma-2b's 16 heads on one KV head
//   a block is 4 positions x 16 heads, which keeps a 16-query chunk at 4
//   blocks per sequence rather than 16 blocks of one head each.
// - K/V tiles come in through cp.async (16 bytes a thread) into two stages:
//   the next tile's copy is in flight while the block computes on this one.
//   The loop stops at the block's causal bound and starts at its window
//   bound, so fully masked tiles are never loaded; keys past Sk are
//   zero-filled and masked.
// - Rows of shared memory are padded by 16 bytes, so ldmatrix's 8 rows hit
//   32 different banks. The output goes through the warp's own q rows in
//   shared memory and out in 16-byte stores.
// - The mask is evaluated only on tiles where some key is hidden from some
//   row of the block, and under the causal mask the position blocks with
//   the most keys are launched first (the SMs' second blocks are light).
// The arithmetic keeps the TPU kernel's order: s = (q.k) * scale, NEG_INF
// where masked, m_new = max(m, max s), p = exp(s - m_new) (0 where masked),
// alpha = exp(m - m_new), l = alpha l + sum p, acc = alpha acc + bf16(p).v,
// o = acc / max(l, 1e-20). exp is taken as exp2(x * log2 e) and the final
// division as one reciprocal of l per row: both round differently from the
// TPU's by a few fp32 ulps, far inside bf16. Padded heads (all-zero q) come
// out as a uniform softmax over the visible keys, as on the TPU.
//
// Measured on an H100 (PERF.md, section 6): 1.3x SDPA at the lockstep prompt,
// 0.5x SDPA at the streaming chunk; copies and products overlap only in
// part, and each warp's mma.sync run latency-bound.
#include <type_traits>

#include "mma.cuh"

namespace {

using namespace repro::mma;
using repro::f2_to_bf2;
using repro::kNegInf;
using repro::kLog2e;

// Probe builds (src/repro_torch/tools/attn_probe.py) set these; the port's
// build sets none. FA_WARPS: warps per block. FA_PROBE_COPIES_ONLY: the tile
// loop keeps its copies and barriers and drops the products and the softmax.
// FA_PROBE_PRODUCTS_ONLY: the K/V tiles are not copied (the products run on
// whatever shared memory holds). Neither probe build computes attention.
#ifndef FA_WARPS
#define FA_WARPS 4
#endif
constexpr int kWarps = FA_WARPS;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // rows of a block: 16 per warp

template <int D>
struct Tile {
  static constexpr int BK = D == 256 ? 32 : 64;  // keys per K/V tile
  static constexpr int LD = D + 8;               // row stride in shared memory
  static constexpr int C8 = D / 8;               // 16-byte chunks per row
};

template <int D>
struct Smem {
  __nv_bfloat16 q[kRows][Tile<D>::LD];
  __nv_bfloat16 k[2][Tile<D>::BK][Tile<D>::LD];
  __nv_bfloat16 v[2][Tile<D>::BK][Tile<D>::LD];
};

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  int Sq, Sk, H, KVH;
  int hb;  // heads per block; row r is position r / hb, head r % hb
  int qp;  // positions per block, kRows / hb
  long kv_batch_stride;
  float scale;
  int causal, window, q_offset;
};

template <int D>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(const Params p) {
  constexpr int BK = Tile<D>::BK, C8 = Tile<D>::C8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // blockIdx.x runs over (row, head group), blockIdx.y over position blocks
  // from the last: under the causal mask the blocks with the most keys start
  // first, and the SMs' second blocks are the light ones
  const int nhg = p.H / p.hb;
  const int b = blockIdx.x / nhg, h0 = (blockIdx.x % nhg) * p.hb;
  const int p0 = (gridDim.y - 1 - blockIdx.y) * p.qp;
  const int kvh = h0 / (p.H / p.KVH);
  const int npos = min(p.qp, p.Sq - p0);
  const long row_stride = static_cast<long>(p.H) * D;
  const long q_at = (static_cast<long>(b) * p.Sq + p0) * row_stride + static_cast<long>(h0) * D;

  // q rows (group 0 of the copies); rows past Sq are zero
  for (int i = tid; i < kRows * C8; i += kThreads) {
    const int r = i / C8, c = i % C8, pos = r / p.hb;
    const bool ok = pos < npos;
    const long at = ok ? q_at + pos * row_stride + (r % p.hb) * D + c * 8 : 0;
    cp_async16(&sm.q[r][c * 8], p.q + at, ok);
  }
  cp_async_commit();

  const int qlo = p0 + p.q_offset, qhi = p0 + npos - 1 + p.q_offset;
  const int k_end = p.causal ? min(p.Sk, qhi + 1) : p.Sk;
  const int k_begin = p.window > 0 ? max(0, qlo - p.window + 1) : 0;
  const int t_first = (k_begin / BK) * BK;
  const int ntiles = k_end > t_first ? (k_end - t_first + BK - 1) / BK : 0;
  const long kv_at = static_cast<long>(b) * p.kv_batch_stride + static_cast<long>(kvh) * D;
  const long key_stride = static_cast<long>(p.KVH) * D;

  auto load_tile = [&](int t, int st) {
    const int key0 = t_first + t * BK;
#ifdef FA_PROBE_PRODUCTS_ONLY
    if (key0 >= 0) return;  // always: the copies below never run
#endif
    for (int i = tid; i < BK * C8; i += kThreads) {
      const int j = i / C8, c = i % C8, key = key0 + j;
      const bool ok = key < k_end;
      const long at = ok ? kv_at + key * key_stride + c * 8 : 0;
      cp_async16(&sm.k[st][j][c * 8], p.k + at, ok);
      cp_async16(&sm.v[st][j][c * 8], p.v + at, ok);
    }
  };

  // this thread's rows of its warp's 16: r0 and r0 + 8
  const int r0 = warp * 16 + (lane >> 2);
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) qpos[i] = p0 + (r0 + 8 * i) / p.hb + p.q_offset;
  auto visible = [&](int i, int key) {
    return key < k_end && (!p.causal || key <= qpos[i]) &&
           (p.window <= 0 || key > qpos[i] - p.window);
  };

  float acc[D / 8][4];
#pragma unroll
  for (int t = 0; t < D / 8; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  if (ntiles > 0) load_tile(0, 0);
  cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    const int st = t & 1;
    if (t + 1 < ntiles) load_tile(t + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // q and tile t have landed (this thread's copies)
    __syncthreads();     // ... and every thread's

#ifndef FA_PROBE_COPIES_ONLY
    // S = q k^T over the tile: BK/8 n-tiles of 8 keys
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      uint32_t a[4];
      ldmatrix_x4(a, &sm.q[warp * 16 + (lane & 15)][kd * 16 + (lane >> 4) * 8]);
#pragma unroll
      for (int n2 = 0; n2 < BK / 16; ++n2) {
        uint32_t bk[4];
        ldmatrix_x4(bk, &sm.k[st][n2 * 16 + (lane >> 4) * 8 + (lane & 7)]
                             [kd * 16 + ((lane >> 3) & 1) * 8]);
        mma_bf16(s[2 * n2], a, bk[0], bk[1]);
        mma_bf16(s[2 * n2 + 1], a, bk[2], bk[3]);
      }
    }

    // online softmax, row by row (c0, c1: row r0; c2, c3: row r0 + 8); the
    // mask is evaluated only on tiles where some key is hidden from some row
    const int tile_lo = t_first + t * BK, tile_hi = tile_lo + BK - 1;
    const bool all_visible = tile_hi < k_end && (!p.causal || tile_hi <= qlo) &&
                             (p.window <= 0 || tile_lo > qhi - p.window);
    const int key0 = tile_lo + (lane & 3) * 2;
    auto softmax = [&](auto masked_t) {
      constexpr bool masked = decltype(masked_t)::value;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = m[i];
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float& x = s[n][2 * i + j];
            x = !masked || visible(i, key0 + n * 8 + j) ? x * p.scale : kNegInf;
            mx = fmaxf(mx, x);
          }
        const float m_new = quad_max(mx);
        const float alpha = exp2f((m[i] - m_new) * kLog2e);
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float& x = s[n][2 * i + j];
            x = !masked || visible(i, key0 + n * 8 + j) ? exp2f((x - m_new) * kLog2e) : 0.f;
            sum += x;
          }
        l[i] = alpha * l[i] + quad_sum(sum);
        m[i] = m_new;
#pragma unroll
        for (int d = 0; d < D / 8; ++d) {
          acc[d][2 * i] *= alpha;
          acc[d][2 * i + 1] *= alpha;
        }
      }
    };
    if (all_visible)
      softmax(std::false_type{});
    else
      softmax(std::true_type{});

    // acc += bf16(p) v over the tile, 16 keys per k-step
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      scores_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int d2 = 0; d2 < D / 16; ++d2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, &sm.v[st][kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8]
                                   [d2 * 16 + (lane >> 4) * 8]);
        mma_bf16(acc[2 * d2], pa, bv[0], bv[1]);
        mma_bf16(acc[2 * d2 + 1], pa, bv[2], bv[3]);
      }
    }
#endif
    __syncthreads();  // stage st is free for tile t + 2
  }
  cp_async_wait<0>();
  __syncthreads();  // q copies done (they may be all there was), q no longer read

  // o = acc * (1 / max(l, 1e-20)), through the warp's own q rows, 16-byte stores
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float inv = 1.f / fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int d = 0; d < D / 8; ++d)
      *reinterpret_cast<uint32_t*>(&sm.q[r0 + 8 * i][d * 8 + (lane & 3) * 2]) =
          f2_to_bf2(acc[d][2 * i] * inv, acc[d][2 * i + 1] * inv);
  }
  __syncwarp();
  for (int i = lane; i < 16 * C8; i += 32) {
    const int r = warp * 16 + i / C8, c = i % C8, pos = r / p.hb;
    if (pos < npos)
      *reinterpret_cast<uint4*>(p.o + q_at + pos * row_stride + (r % p.hb) * D + c * 8) =
          *reinterpret_cast<const uint4*>(&sm.q[r][c * 8]);
  }
}

template <int D>
int launch(Params p, int B, cudaStream_t stream) {
  const size_t smem = sizeof(Smem<D>);
  cudaError_t err = repro::allow_smem(flash_attention_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const int group = p.H / p.KVH;
  p.hb = (group & -group) < 16 ? (group & -group) : 16;
  p.qp = kRows / p.hb;
  const dim3 grid(B * (p.H / p.hb), (p.Sq + p.qp - 1) / p.qp);
  flash_attention_kernel<D><<<grid, kThreads, smem, stream>>>(p);
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
  Params p{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
           static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
           Sq, Sk, H, KVH, 0, 0, static_cast<long>(kv_batch_stride), scale, causal, window,
           q_offset};
  switch (D) {
    case 64: return launch<64>(p, B, s);
    case 128: return launch<128>(p, B, s);
    case 256: return launch<256>(p, B, s);
    default: return cudaErrorInvalidValue;
  }
}
