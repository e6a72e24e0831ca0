// Split-KV flash decode on the tensor cores: the keys of one row are cut
// into splits of a fixed number of keys, one block per (split, 16 query heads
// of one KV group, row), and a second small kernel merges the splits' partial
// outputs by their log-sum-exp. The body is a template over attn_tile.cuh's
// loader policies (how key j's K and V rows reach shared memory):
//   Bf16Rows<KeyAt>  copied with cp.async, 16 bytes a thread, the next tile
//                    in flight while the block computes on this one;
//   any other policy (Int8Rows) through its own load(), which dequantizes
//                    to bf16 as the values land.
// paged_decode_attention.cu instantiates it with a paged KeyAt,
// decode_attention.cu with Bf16Rows<Strided> and decode_attention_quant.cu
// with Int8Rows, each over its row's live key range (live_range below for
// the two contiguous caches).
//
// One block is four warps over the same 16 rows and the same keys. The 16
// rows are the query heads of one KV group at one position, exactly the
// M = 16 of mma.m16n8k16, so both products are tensor-core mmas. Warp w
// takes quarter w of the head dimension: it reduces S = q k^T over its
// quarter (fragments through ldmatrix), the four partial scores are summed
// through shared memory in warp order (so every warp holds the same S), each
// warp runs the same online softmax, and then it takes o += bf16(p) v for its
// quarter of o (V through ldmatrix.trans, p straight from the S registers).
// So each warp's mma chains, loads and output stores are a quarter of one
// warp's, which is what bounds a split of one or two tiles. The arithmetic
// is the TPU kernel's within a split: scale, NEG_INF where masked, running
// max and sum, alpha, p rounded to v's type, l = max(l, 1e-20) at the end. A
// split writes o_part = acc / l (fp32) and lse_part = m + log(l); a split
// with no live key writes lse_part = NEG_INF only, and the merge never reads
// its o_part, selecting its values away. exp is exp2(x * log2 e) and the
// divisions by l and by the merge's sum are one reciprocal per row: both
// round differently from the TPU's by a few fp32 ulps, far inside bf16.
//
// The merge (combine_kernel) is the JAX package's combine_decode_shards
// (src/repro/kernels/ref.py): M = max lse, w = exp(lse - M), o = sum(o w) /
// max(sum w, 1e-20), in split order, one warp per (row, head), no atomics, so
// two launches on the same inputs give the same bits. It also writes the
// row's total lse = M + log(max(sum w, 1e-20)).
#pragma once

#include "attn_tile.cuh"
#include "mma.cuh"

namespace repro {
namespace split {

constexpr int kRows = 16;   // query heads per block: the M of one mma
constexpr int kKeys = 16;   // keys per tile: the K of the value product's mma
constexpr int kWarps = 4;   // each takes a quarter of the head dimension
constexpr int kThreads = 32 * kWarps;

template <int D>
struct Smem {
  static constexpr int LD = D + 8;  // padded rows: ldmatrix hits 32 banks
  __nv_bfloat16 q[kRows][LD];
  __nv_bfloat16 k[2][kKeys][LD];
  __nv_bfloat16 v[2][kKeys][LD];
  float s[kWarps][8][32];  // the warps' partial scores, [warp][value][lane]
};

// 16 bytes (chunk c, 8 values) of key `key`'s K and V rows into shared
// memory; zeros where !ok. Any policy: through its synchronous load().
template <class Rows>
struct TileCopy {
  __device__ __forceinline__ static void copy(const Rows& rows, int key, int c, bool ok,
                                              __nv_bfloat16* kd, __nv_bfloat16* vd) {
    uint4 kk = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
    if (ok) rows.load(key, c, kk, vv);
    *reinterpret_cast<uint4*>(kd) = kk;
    *reinterpret_cast<uint4*>(vd) = vv;
  }
};

// bf16 rows: cp.async straight from device memory.
template <class KeyAt>
struct TileCopy<attn::Bf16Rows<KeyAt>> {
  __device__ __forceinline__ static void copy(const attn::Bf16Rows<KeyAt>& rows, int key, int c,
                                              bool ok, __nv_bfloat16* kd, __nv_bfloat16* vd) {
    const long at = ok ? rows.key_at(key) + 8 * c : 0;
    mma::cp_async16(kd, rows.k + at, ok);
    mma::cp_async16(vd, rows.v + at, ok);
  }
};

// Starts the copy of the block's nrows query rows (row stride D; rows past
// nrows are zero) as one cp.async group. Call before attend_split, as early
// as the kernel can.
template <int D>
__device__ __forceinline__ void load_q(Smem<D>& sm, const __nv_bfloat16* __restrict__ q,
                                       int nrows) {
  constexpr int C8 = D / 8;
  for (int i = threadIdx.x; i < kRows * C8; i += kThreads) {
    const int r = i / C8, c = i % C8;
    const bool ok = r < nrows;
    mma::cp_async16(&sm.q[r][c * 8], q + (ok ? r * D + c * 8 : 0), ok);
  }
  mma::cp_async_commit();
}

// Attends the block's rows (their copy started by load_q) against keys
// [k_begin, k_end), which `rows` loads; mask(row, key) is the rows' own mask
// inside that range. Writes nrows rows of o_part (row stride D, fp32) and
// lse_part; with no key in range, lse_part = NEG_INF and o_part is not
// written.
template <int D, class Rows, class Mask>
__device__ __forceinline__ void attend_split(Smem<D>& sm, int nrows, const Rows& rows,
                                             int k_begin, int k_end, float scale,
                                             const Mask& mask, float* __restrict__ o_part,
                                             float* __restrict__ lse_part) {
  static_assert(D % 64 == 0, "head_dim must be a multiple of 64");
  constexpr int C8 = D / 8;
  constexpr int DW = D / kWarps;  // this warp's quarter of the head dimension
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3, d0 = warp * DW;
  if (k_begin >= k_end) {
    mma::cp_async_wait<0>();
    for (int r = threadIdx.x; r < nrows; r += kThreads) lse_part[r] = kNegInf;
    return;
  }
  const int ntiles = (k_end - k_begin + kKeys - 1) / kKeys;
  auto load_tile = [&](int t, int st) {
    const int key0 = k_begin + t * kKeys;
    for (int i = threadIdx.x; i < kKeys * C8; i += kThreads) {
      const int j = i / C8, c = i % C8, key = key0 + j;
      TileCopy<Rows>::copy(rows, key, c, key < k_end, &sm.k[st][j][c * 8], &sm.v[st][j][c * 8]);
    }
  };

  float acc[DW / 8][4];
#pragma unroll
  for (int d = 0; d < DW / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  load_tile(0, 0);
  mma::cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    const int st = t & 1;
    if (t + 1 < ntiles) load_tile(t + 1, st ^ 1);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();
    __syncthreads();

    // this warp's partial S over its quarter of D, then the sum of the four
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < DW / 16; ++kk) {
      const int kd = d0 / 16 + kk;
      uint32_t a[4], bk[4];
      mma::ldmatrix_x4(a, &sm.q[lane & 15][kd * 16 + (lane >> 4) * 8]);
      mma::ldmatrix_x4(bk, &sm.k[st][(lane >> 4) * 8 + (lane & 7)][kd * 16 + ((lane >> 3) & 1) * 8]);
      mma::mma_bf16(s[0], a, bk[0], bk[1]);
      mma::mma_bf16(s[1], a, bk[2], bk[3]);
    }
#pragma unroll
    for (int v = 0; v < 8; ++v) sm.s[warp][v][lane] = s[v >> 2][v & 3];
    __syncthreads();
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      float x = sm.s[0][v][lane];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) x += sm.s[w][v][lane];
      s[v >> 2][v & 3] = x;
    }

    const int key0 = k_begin + t * kKeys + t4 * 2;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = g + 8 * i;
      float mx = m[i];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int key = key0 + n * 8 + j;
          float& x = s[n][2 * i + j];
          x = key < k_end && mask(row, key) ? x * scale : kNegInf;
          mx = fmaxf(mx, x);
        }
      const float m_new = mma::quad_max(mx);
      const float alpha = exp2f((m[i] - m_new) * kLog2e);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int key = key0 + n * 8 + j;
          float& x = s[n][2 * i + j];
          x = key < k_end && mask(row, key) ? exp2f((x - m_new) * kLog2e) : 0.f;
          sum += x;
        }
      l[i] = alpha * l[i] + mma::quad_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int d = 0; d < DW / 8; ++d) {
        acc[d][2 * i] *= alpha;
        acc[d][2 * i + 1] *= alpha;
      }
    }

    uint32_t pa[4];
    mma::scores_to_a(pa, s[0], s[1]);
#pragma unroll
    for (int d2 = 0; d2 < DW / 16; ++d2) {
      uint32_t bv[4];
      mma::ldmatrix_x4_trans(bv, &sm.v[st][(lane & 7) + ((lane >> 3) & 1) * 8]
                                        [d0 + d2 * 16 + (lane >> 4) * 8]);
      mma::mma_bf16(acc[2 * d2], pa, bv[0], bv[1]);
      mma::mma_bf16(acc[2 * d2 + 1], pa, bv[2], bv[3]);
    }
    __syncthreads();  // stage st and the partial scores are free
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = g + 8 * i;
    if (row >= nrows) continue;
    const float lc = fmaxf(l[i], 1e-20f), inv = 1.f / lc;
    float* orow = o_part + row * D + d0 + t4 * 2;
#pragma unroll
    for (int d = 0; d < DW / 8; ++d)
      *reinterpret_cast<float2*>(orow + d * 8) =
          make_float2(acc[d][2 * i] * inv, acc[d][2 * i + 1] * inv);
    if (warp == 0 && t4 == 0) lse_part[row] = m[i] + logf(lc);
  }
}

// The live keys [x, y) of a contiguous cache row of S slots whose slot 0
// holds position pos_offset: position p is live when p < len and, with a
// window, p > len - 1 - window (window 0: none). The range is the row's whole
// mask: the decode kernels attend their split's share of it with NoMask.
__device__ __forceinline__ int2 live_range(int len, int S, int window, int pos_offset) {
  const int last = max(0, min(S, len - pos_offset));
  const int first = window > 0 ? min(last, max(0, len - window - pos_offset)) : 0;
  return make_int2(first, last);
}

struct NoMask {
  __device__ bool operator()(int, int) const { return true; }
};

// Merges nsplit partials of `rows` (row, head) pairs: o_part (nsplit, rows,
// D) fp32, lse_part (nsplit, rows); writes o (rows, D) bf16 and lse (rows).
// One warp per pair; lane l owns the D/32 values from l * D/32. The loads do
// not wait on each other: lane j reads split j's lse (32 splits at a time),
// the weights go round by shuffles, and the o_part reads of a chunk are all
// in flight together. The sums run in split order.
template <int D>
__global__ void __launch_bounds__(128)
    combine_kernel(const float* __restrict__ o_part, const float* __restrict__ lse_part,
                   __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int nsplit, int rows) {
  constexpr int V = D / 32;
  const int row = blockIdx.x * 4 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  float M = kNegInf;
  for (int s = lane; s < nsplit; s += 32) M = fmaxf(M, lse_part[static_cast<long>(s) * rows + row]);
  M = warp_max(M);
  float num[V], den = 0.f;
#pragma unroll
  for (int j = 0; j < V; ++j) num[j] = 0.f;
  for (int s0 = 0; s0 < nsplit; s0 += 32) {
    const int n = min(32, nsplit - s0);
    const float ls = lane < n ? lse_part[static_cast<long>(s0 + lane) * rows + row] : kNegInf;
    // a split with no live key has weight 0 and an unwritten o_part: its
    // (garbage) values are selected away, never multiplied
    const float wl = ls == kNegInf ? 0.f : exp2f((ls - M) * kLog2e);
    const float* op = o_part + (static_cast<long>(s0) * rows + row) * D + lane * V;
    for (int j0 = 0; j0 < n; j0 += 8) {
      float x[8][V];  // eight splits' values in flight at once
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int v = 0; v < V; v += 2) {
          float2 x2 = make_float2(0.f, 0.f);
          if (j0 + j < n)
            x2 = *reinterpret_cast<const float2*>(op + static_cast<long>(j0 + j) * rows * D + v);
          x[j][v] = x2.x;
          x[j][v + 1] = x2.y;
        }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float w = __shfl_sync(0xffffffffu, wl, (j0 + j) & 31);
        if (j0 + j >= n) break;
        den += w;
#pragma unroll
        for (int v = 0; v < V; ++v) num[v] += w > 0.f ? x[j][v] * w : 0.f;
      }
    }
  }
  const float inv = 1.f / fmaxf(den, 1e-20f);
  uint32_t* orow = reinterpret_cast<uint32_t*>(o + static_cast<long>(row) * D + lane * V);
#pragma unroll
  for (int v = 0; v < V; v += 2) orow[v / 2] = f2_to_bf2(num[v] * inv, num[v + 1] * inv);
  if (lane == 0) lse[row] = M + logf(fmaxf(den, 1e-20f));
}

// Launches combine_kernel over `rows` (row, head) pairs on `stream`.
template <int D>
cudaError_t combine(const float* o_part, const float* lse_part, __nv_bfloat16* o, float* lse,
                    int nsplit, int rows, cudaStream_t stream) {
  combine_kernel<D><<<(rows + 3) / 4, 128, 0, stream>>>(o_part, lse_part, o, lse, nsplit, rows);
  return cudaGetLastError();
}

}  // namespace split
}  // namespace repro
