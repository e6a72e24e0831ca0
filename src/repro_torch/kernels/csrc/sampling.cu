// Fused decode-step sampler: the LM-head product of h (B, d) with the head,
// an online log-sum-exp of the untempered logits, and a hash Gumbel-max draw,
// returning per row the token and its untempered logprob. inv_temp == 0 is
// greedy with the first-max rule; vocab columns >= vocab are never sampled.
//
// Replaces the TPU kernel src/repro/kernels/sampling.py:fused_sample
// (_sample_kernel, _hash_u32, _uniform_01), which walked a (B, vocab tiles)
// grid in order and carried the running max, sum and winner in VMEM scratch.
//
// What bounds it on an H100: bytes. The head is read once per decode step:
// the tied embedding, 256000 x 2048 bf16 = 1.05 GB at gemma-2b (~0.31 ms at
// 3.35 TB/s), or an untied lm_head, 3584 x 152064 = 1.09 GB at qwen2.5-7b. Its products (2 B Vp d) take 0.068 ms on the bf16 tensor cores
// at B = 64, but 1.0 ms on the fp32 CUDA cores: they must be tensor-core
// products. A sampled row also costs two logf and an expf per vocab entry,
// ~55 us of issue per SM at B = 64, which has to hide under the stream.
//
// What the design does about it:
// - Tensor-core products: wgmma m64nNk16, bf16 in, fp32 accumulate, with N
//   the batch rows rounded up to 8, 16, 32 or 64. A warpgroup of 4 consumer
//   warps takes 64 vocab rows as the A operand and h as the B operand, both
//   read by the tensor cores straight from shared memory. The head is
//   never transposed or copied: it is read as it lies, in one of two
//   layouts (COLS, a template flag). The tied embedding lies as (Vp, d)
//   rows, d contiguous: a K-major A tile, one TMA box of 64 k by TV vocab
//   rows. An untied lm_head lies as (d, Vp), vocab contiguous: an MN-major A
//   tile (wgmma's transpose bit on A), TV / 64 TMA boxes of 64 vocab columns
//   by 64 k rows, each the canonical MN-major 128-byte swizzle atom (8 k rows
//   of 128 bytes, 8-row groups 1024 bytes apart). Either way a tile holds TV
//   whole vocab rows and a stage the same bytes, so the grid, the scan and
//   the merge are one code. Products of bf16 pairs are exact in fp32, and
//   every row sums its products in k order, so equal rows give equal logits
//   wherever they lie.
// - The head is read once for every B <= 64: a block carries all the
//   n-tiles of up to 64 batch rows. Above 64 rows the batch is tiled by 64
//   (grid.y), and each slice reads the head again.
// - A producer warp streams a ring of stages through the Tensor Memory
//   Accelerator: 2D TMA copies of 64-wide k-slices of the block's head tile
//   and of h, in the 128-byte swizzle that wgmma reads; rows past the head
//   or the batch and columns past d come in as zeros. An (Vp, d) head is read
//   in 256-byte pieces of its rows at KC = 128, a (d, Vp) head in 256-byte
//   (TV = 128) or 512-byte (TV = 256) pieces of its k rows. mbarriers say when a
//   stage has landed (full) and when every consumer warp is done with it
//   (empty), so the loads run ahead of the products and the scans by the
//   whole ring and no consumer waits on another. A stage is 128 wide (256
//   bytes of every row) at up to 8 batch rows and 64 wide above, with L2
//   promotion of 256 bytes: short pieces of many rows cost the DRAM pages
//   more than their bytes (attn_probe's copies-only build times the stream
//   alone).
// - A persistent grid sized to the card: as many blocks as fit at once
//   (occupancy x SMs), each walking T whole tiles of a fixed, contiguous
//   vocab range. All blocks are resident and carry equal bytes: no wave tail.
//   From 17 batch rows up, 16 consumer warps make a tile of 256 rows, so h's
//   reads from L2 stay a quarter of the head's and the Gumbel arithmetic
//   has 16 warps to hide in.
// - The scan is deferred and spread: at a tile's last k-slice the logits go
//   from the accumulators to shared memory, and the consumers scan them in
//   small pieces during the next tile's k-slices. Warp w of CW owns batch
//   columns w, w + CW, ...; lane l takes rows l, l + 32, ... of a column with
//   an online max, sum of exponentials and first-max winner, then a
//   butterfly over the lanes, and lane 0 folds the tile into the column's
//   running state.
// - Deterministic merge: each block writes one partial per batch row; the
//   last block to finish (an atomic ticket picks it, and no atomic takes
//   part in a sum) merges them all: lane l takes blocks l, l + 32, ... in
//   order, then a fixed butterfly. Two launches give the same bits on one
//   card (the grid, and so the logprob's last bits, follow its SM count).
// - The counter hash is splitmix32 in wrapping uint32 arithmetic, bit for bit
//   the TPU kernel's; z * inv_temp + g is rounded as two operations (no fused
//   multiply-add), and logf/expf are the full-precision ones (no fast math).
//   On equal scores the lower index wins, whatever tile or block holds it.
// - Every instantiation is spill-free (-Xptxas -v, printed by chip_smoke.py).
//   The wrapper requires d % 8 == 0, and Vp % 8 == 0 for a (d, Vp) head
//   (TMA's 16-byte row stride), which every configs/registry.py arch meets.
#include <cuda.h>
#include <cudaTypedefs.h>

#include <climits>

#include "mma.cuh"

namespace {

using repro::kNegInf;
using repro::mma::smem_addr;

// Probe builds (src/repro_torch/tools/attn_probe.py) set these; the port's
// build sets none. SAMPLE_KC=64: 64-wide stages at every batch size.
// SAMPLE_PROBE_NO_L2_PROMOTION: TMA copies without L2 promotion.
// SAMPLE_PROBE_COPIES_ONLY: the consumers wait for each stage and release
// it, with no products and no scans (no sample comes out).
constexpr int kMaxRowsB = 64;  // batch rows a block carries (8 n-tiles)

__device__ __forceinline__ uint32_t hash_u32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float uniform_01(uint32_t seed, uint32_t pos) {
  const uint32_t bits = hash_u32(pos * 0x9E3779B1u + seed) >> 8;
  return __fmul_rn(__fadd_rn(static_cast<float>(bits), 0.5f), 1.0f / 16777216.0f);
}

// first-max order: larger score, then lower index
__device__ __forceinline__ bool better(float y1, int i1, float y2, int i2) {
  return y1 > y2 || (y1 == y2 && i1 < i2);
}

// Online sampler state: max m and sum l of exp(z - m) of the untempered
// logits, the best score y, its logit z and its index i.
struct State {
  float m, l, y, z;
  int i;
  __device__ void merge(float m2, float l2, float y2, float z2, int i2) {
    const float mn = fmaxf(m, m2);
    l = l * expf(m - mn) + l2 * expf(m2 - mn);
    m = mn;
    if (better(y2, i2, y, i)) {
      y = y2;
      z = z2;
      i = i2;
    }
  }
  __device__ void merge(const State& o) { merge(o.m, o.l, o.y, o.z, o.i); }
  __device__ void merge_lane(int offset) {
    merge(__shfl_xor_sync(0xffffffffu, m, offset), __shfl_xor_sync(0xffffffffu, l, offset),
          __shfl_xor_sync(0xffffffffu, y, offset), __shfl_xor_sync(0xffffffffu, z, offset),
          __shfl_xor_sync(0xffffffffu, i, offset));
  }
};

__device__ __forceinline__ State empty_state() {
  return State{kNegInf, 0.f, kNegInf, kNegInf, INT_MAX};
}

// One instantiation: CW consumer warps (a tile of 16 CW vocab rows, 64 a
// warpgroup), NT n-tiles (8 NT batch columns), stages of KC columns, a ring
// of STAGES; one producer warp more.
template <int CW, int NT, int KC, int STAGES>
struct Shape {
#ifdef SAMPLE_KC
  static constexpr int kKC = SAMPLE_KC;
#else
  static constexpr int kKC = KC;
#endif
  static_assert(kKC == 64 || kKC == 128, "a stage is one or two 64-wide TMA boxes");
  static_assert(CW % 4 == 0, "consumers come in warpgroups");
  static constexpr int kStages = STAGES;
  static constexpr int kThreads = 32 * CW;      // consumer threads
  static constexpr int TV = 16 * CW;            // vocab rows of a tile
  static constexpr int NB = 8 * NT;             // batch columns of a block
  static constexpr int kSubs = kKC / 64;        // 64-wide boxes of a stage
  static constexpr int kHeadElems = kSubs * TV * 64;
  static constexpr int kStageElems = kSubs * (TV + NB) * 64;
  static constexpr uint32_t kStageBytes = 2 * kStageElems;
  static constexpr int kZLd = TV + 4;           // a column's stride in the logit buffer
  static constexpr int kRowsPerLane = TV / 32;  // scan rows of a lane in one column
  static constexpr int kScan = NB / CW * kRowsPerLane;  // a lane's scan per tile
  static_assert(NB % CW == 0, "every consumer warp owns as many batch columns");
  // the ring (1024-byte aligned for the swizzle), the logits, the column
  // states, the mbarriers
  static constexpr size_t kSmem = 1024 + sizeof(__nv_bfloat16) * kStages * kStageElems +
                                  sizeof(float) * NB * kZLd + sizeof(State) * NB +
                                  sizeof(uint64_t) * (2 * kStages + 1);
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// The producer's arrive on a stage's full barrier, which then also waits for
// the stage's bytes of TMA copies to land.
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 state;\nmbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\nbra WAIT;\nDONE:\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// A 2D TMA copy of the box at (column x, row y) of map into shared memory,
// counted on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int x, int y,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_addr(bar))
      : "memory");
}

// wgmma operand descriptor of a K-major tile in the 128-byte swizzle: rows
// of 128 bytes, 8-row groups 1024 bytes apart (start, leading and stride
// byte offsets in 16-byte units; layout 1 = 128-byte swizzle).
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// wgmma operand descriptor of an MN-major tile in the 128-byte swizzle, as
// TMA writes a box of 64 MN columns by k rows: each k row 128 bytes (64 MN
// elements), 8-row k groups 1024 bytes apart (the stride byte offset), and
// the next 64 MN elements one 64 x 64 box (8192 bytes) on (the leading byte
// offset; an m64 operand spans one).
__device__ __forceinline__ uint64_t sw128_mn_desc(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(8192 >> 4) << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void gmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void gmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void gmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

#define REPRO_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])

// d (64 x N fp32; a warp's 16 rows, n-tile j of 8 columns at d[4j .. 4j + 3]
// as mma.sync's C fragment) += A (64 x 16 bf16) * B (16 x N bf16), both in
// shared memory, B K-major, A K-major (TA = 0) or MN-major (TA = 1), issued
// by one warpgroup.
template <int TA>
__device__ __forceinline__ void gmma8(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, %7, 0;\n}\n"
      : REPRO_F4(0)
      : "l"(da), "l"(db), "r"(1), "n"(TA));
}

template <int TA>
__device__ __forceinline__ void gmma16(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, 0;\n}\n"
      : REPRO_F4(0), REPRO_F4(4)
      : "l"(da), "l"(db), "r"(1), "n"(TA));
}

template <int TA>
__device__ __forceinline__ void gmma32(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, 0;\n}\n"
      : REPRO_F4(0), REPRO_F4(4), REPRO_F4(8), REPRO_F4(12)
      : "l"(da), "l"(db), "r"(1), "n"(TA));
}

template <int TA>
__device__ __forceinline__ void gmma64(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, 0;\n}\n"
      : REPRO_F4(0), REPRO_F4(4), REPRO_F4(8), REPRO_F4(12), REPRO_F4(16), REPRO_F4(20),
        REPRO_F4(24), REPRO_F4(28)
      : "l"(da), "l"(db), "r"(1), "n"(TA));
}

template <int N, int TA>
__device__ __forceinline__ void gmma_bf16(float* d, uint64_t da, uint64_t db) {
  if constexpr (N == 8) gmma8<TA>(d, da, db);
  else if constexpr (N == 16) gmma16<TA>(d, da, db);
  else if constexpr (N == 32) gmma32<TA>(d, da, db);
  else gmma64<TA>(d, da, db);
}

#undef REPRO_F4

// Barrier of the consumer warps only (the producer never waits on it).
template <int kThreads>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

// COLS: the head lies as (d, Vp), vocab contiguous (tm_head maps it with
// vocab as the inner dimension); else as (Vp, d) rows.
template <int CW, int NT, int KC, int STAGES, int MIN_BLOCKS, bool COLS>
__global__ void __launch_bounds__(32 * CW + 32, MIN_BLOCKS)
    sample_kernel(const __grid_constant__ CUtensorMap tm_head,
                  const __grid_constant__ CUtensorMap tm_h, const int* __restrict__ seeds,
                  const float* __restrict__ inv_temp, float4* __restrict__ part,
                  int* __restrict__ part_idx, unsigned int* __restrict__ ticket,
                  int* __restrict__ tok, float* __restrict__ lp, int B, int d, int Vp, int vocab,
                  int tiles_per_block, float4* __restrict__ state, int* __restrict__ state_idx,
                  int col_offset) {
  using S = Shape<CW, NT, KC, STAGES>;
  constexpr int kStages = S::kStages;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(
      (reinterpret_cast<uintptr_t>(smem4) + 1023) & ~static_cast<uintptr_t>(1023));
  float* zbuf = reinterpret_cast<float*>(ring + kStages * S::kStageElems);  // [NB][kZLd]
  State* cst = reinterpret_cast<State*>(zbuf + S::NB * S::kZLd);            // [NB]
  // full[kStages], then empty[kStages], 8-byte aligned past the states
  uint64_t* full = reinterpret_cast<uint64_t*>(
      (reinterpret_cast<uintptr_t>(cst + S::NB) + 7) & ~static_cast<uintptr_t>(7));
  uint64_t* empty = full + kStages;
  __shared__ float s_it[S::NB];
  __shared__ uint32_t s_seed[S::NB];
  __shared__ bool s_last;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b0 = blockIdx.y * kMaxRowsB;
  const int nb = min(S::NB, B - b0);
  const int r0 = blockIdx.x * tiles_per_block * S::TV;
  const int r1 = min(r0 + tiles_per_block * S::TV, Vp);
  const int lim = min(r1, vocab);  // rows below lim are sampled
  const int ntile = (r1 - r0 + S::TV - 1) / S::TV;
  const int ksteps = (d + S::kKC - 1) / S::kKC;
  const int total = ntile * ksteps;

  if (tid < S::NB) {
    s_it[tid] = tid < nb ? inv_temp[b0 + tid] : 0.f;
    s_seed[tid] = tid < nb ? static_cast<uint32_t>(seeds[b0 + tid]) : 0u;
    cst[tid] = empty_state();
  }
  if (tid < kStages) {
    mbar_init(full + tid, 1);    // the producer's arrive, then the stage's bytes
    mbar_init(empty + tid, CW);  // one arrive per consumer warp
  }
  __syncthreads();

  if (warp == CW) {
    // ---- the producer: stage s is k-slice s % ksteps of tile s / ksteps ----
    if (lane == 0) {
      for (int s = 0; s < total; ++s) {
        const int slot = s % kStages;
        if (s >= kStages) mbar_wait(empty + slot, (s / kStages - 1) & 1);
        const int tile = s / ksteps, k0 = (s - tile * ksteps) * S::kKC;
        __nv_bfloat16* st = ring + slot * S::kStageElems;
        mbar_arrive_expect(full + slot, S::kStageBytes);
#pragma unroll
        for (int sub = 0; sub < S::kSubs; ++sub) {
          if constexpr (COLS) {
            // TV / 64 boxes of 64 vocab columns by 64 k rows, 8192 bytes apart
#pragma unroll
            for (int j = 0; j < S::TV / 64; ++j)
              tma_load(st + sub * S::TV * 64 + j * 64 * 64, &tm_head,
                       r0 + tile * S::TV + 64 * j, k0 + sub * 64, full + slot);
          } else {
            tma_load(st + sub * S::TV * 64, &tm_head, k0 + sub * 64, r0 + tile * S::TV,
                     full + slot);
          }
          tma_load(st + S::kHeadElems + sub * S::NB * 64, &tm_h, k0 + sub * 64, b0,
                   full + slot);
        }
      }
    }
  } else {
    // ---- the consumers ----
    // The deferred scan of the tile whose logits are in zbuf (ztile): this
    // lane's positions [sp, upto) of kScan, column by column.
    int ztile = -1, sp = S::kScan;
    State ls = empty_state();
    auto scan_to = [&](int upto) {
      const int zrow0 = r0 + ztile * S::TV;
      for (; sp < upto; ++sp) {
        const int q = sp / S::kRowsPerLane, rr = sp - q * S::kRowsPerLane;
        const int col = warp + CW * q;  // warp-uniform
        if (col >= nb) continue;
        const int row = lane + 32 * rr, pos = zrow0 + row;
        if (pos < lim) {
          const float z = zbuf[col * S::kZLd + row];
          if (z > ls.m) {
            ls.l = ls.l * expf(ls.m - z) + 1.f;
            ls.m = z;
          } else {
            ls.l += expf(z - ls.m);
          }
          float y = z;
          const float it = s_it[col];
          if (it != 0.f) {
            const float u = uniform_01(s_seed[col], static_cast<uint32_t>(pos + col_offset));
            const float gumbel = -logf(-logf(u));
            y = __fadd_rn(__fmul_rn(z, it), gumbel);
          }
          if (better(y, pos + col_offset, ls.y, ls.i)) {
            ls.y = y;
            ls.z = z;
            ls.i = pos + col_offset;
          }
        }
        if (rr == S::kRowsPerLane - 1) {  // the column's tile is done
#pragma unroll
          for (int o = 16; o >= 1; o >>= 1) ls.merge_lane(o);
          if (lane == 0) cst[col].merge(ls);
          ls = empty_state();
        }
      }
    };

    float acc[4 * NT];  // the warp's 16 rows of the tile, all 8 NT columns
#pragma unroll
    for (int i = 0; i < 4 * NT; ++i) acc[i] = 0.f;

    for (int s = 0; s < total; ++s) {
      const int slot = s % kStages;
      mbar_wait(full + slot, (s / kStages) & 1);
      const int tile = s / ksteps, k = s - tile * ksteps;
#ifdef SAMPLE_PROBE_COPIES_ONLY
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + slot);
#else
      // warpgroup warp / 4 takes rows [64 (warp / 4), + 64) of the tile (64
      // rows of 64 k, or one box of 64 columns by 64 k rows: 8192 bytes
      // either way), 16 k a step: 32 bytes along a (Vp, d) row, 16 k rows
      // (2048 bytes) of a (d, Vp) box
      const __nv_bfloat16* stg = ring + slot * S::kStageElems;
      gmma_fence();
#pragma unroll
      for (int sub = 0; sub < S::kSubs; ++sub)
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const __nv_bfloat16* a = stg + sub * S::TV * 64 + (warp >> 2) * 64 * 64;
          gmma_bf16<S::NB, COLS ? 1 : 0>(
              acc, COLS ? sw128_mn_desc(a + ks * 16 * 64) : sw128_desc(a + ks * 16),
              sw128_desc(stg + S::kHeadElems + sub * S::NB * 64 + ks * 16));
        }
      gmma_commit();
      gmma_wait_all();
      __syncwarp();  // the warp's products of the slot are done: release it
      if (lane == 0) mbar_arrive(empty + slot);
      // the previous tile's scan, spread over this tile's k-slices but its last
      if (ztile >= 0 && k < ksteps - 1) scan_to(S::kScan * (k + 1) / (ksteps - 1));
      if (k != ksteps - 1) continue;
      // ---- the tile's logits to zbuf, once every warp's scan of the
      // previous tile is done ----
      consumers_sync<S::kThreads>();
      {
        const int g = lane >> 2, t = lane & 3;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int row = warp * 16 + g + (q >> 1) * 8;
            zbuf[(j * 8 + 2 * t + (q & 1)) * S::kZLd + row] = acc[4 * j + q];
            acc[4 * j + q] = 0.f;
          }
      }
      ztile = tile;
      sp = 0;
      consumers_sync<S::kThreads>();       // zbuf complete
      if (ksteps == 1) scan_to(S::kScan);  // no later k-slice to spread it over
#endif
    }
    scan_to(S::kScan);  // the last tile's
  }
  __syncthreads();

  // ---- one partial per (block, batch row); the last block merges them ----
  if (tid < nb) {
    const long at = static_cast<long>(blockIdx.x) * B + b0 + tid;
    const State c = cst[tid];
    part[at] = make_float4(c.m, c.l, c.y, c.z);
    part_idx[at] = c.i;
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) {
    const unsigned int nblk = gridDim.x * gridDim.y;
    s_last = atomicInc(ticket, nblk - 1) == nblk - 1;  // wraps to 0 for the next launch
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int b = warp; b < B && warp < CW; b += CW) {
    State m = empty_state();
    for (int blk = lane; blk < static_cast<int>(gridDim.x); blk += 32) {
      const long at = static_cast<long>(blk) * B + b;
      const float4 p = __ldcg(part + at);
      m.merge(p.x, p.y, p.z, p.w, __ldcg(part_idx + at));
    }
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) m.merge_lane(o);
    if (lane == 0) {
      if (state != nullptr) {  // a vocab shard's merged state, for the ranks' merge
        state[b] = make_float4(m.m, m.l, m.y, m.z);
        state_idx[b] = m.i;
      } else {
        tok[b] = m.i;
        lp[b] = m.z - (m.m + logf(fmaxf(m.l, 1e-20f)));
      }
    }
  }
}

using Kernel = void (*)(const CUtensorMap, const CUtensorMap, const int*, const float*, float4*,
                        int*, unsigned int*, int*, float*, int, int, int, int, int, float4*, int*,
                        int);

struct Variant {
  Kernel kernel;
  int threads, tv, nb;
  size_t smem;
};

template <int CW, int NT, int KC, int STAGES, int MIN_BLOCKS>
Variant variant(bool cols) {
  using S = Shape<CW, NT, KC, STAGES>;
  return {cols ? sample_kernel<CW, NT, KC, STAGES, MIN_BLOCKS, true>
               : sample_kernel<CW, NT, KC, STAGES, MIN_BLOCKS, false>,
          S::kThreads + 32, S::TV, S::NB, S::kSmem};
}

// The instantiation for a batch and a head layout: NT n-tiles of 8 rows
// cover min(B, 64). Shared memory: 142 KB at NT = 1 (one block an SM), 82 KB
// at NT = 2 (two), 178 KB at NT = 4 and 187 KB at NT = 8 (one).
Variant pick(int B, bool cols) {
  const int rows = B < kMaxRowsB ? B : kMaxRowsB;
  if (rows <= 8) return variant<8, 1, 128, 4, 1>(cols);
  if (rows <= 16) return variant<8, 2, 64, 4, 2>(cols);
  if (rows <= 32) return variant<16, 4, 64, 4, 1>(cols);
  return variant<16, 8, 64, 3, 1>(cols);
}

// Tiles per block: the fewest that let every block be resident at once.
int tiles_for(const Variant& v, int Vp, int device, cudaError_t* err) {
  *err = repro::allow_smem(v.kernel, v.smem);
  if (*err != cudaSuccess) return 0;
  int per_sm = 0, sms = 0;
  *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, v.kernel, v.threads, v.smem);
  if (*err != cudaSuccess) return 0;
  *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (*err != cudaSuccess) return 0;
  if (per_sm < 1) {
    *err = cudaErrorInvalidConfiguration;
    return 0;
  }
  const int ntiles = (Vp + v.tv - 1) / v.tv;
  const int slots = per_sm * sms;
  return (ntiles + slots - 1) / slots;
}

// A TMA map of a row-major (rows, d) bf16 matrix, boxes of 64 columns by
// box_rows rows with the 128-byte swizzle; reads past its edges give zeros.
// A (d, Vp) head is mapped as rows = d of width Vp, in boxes of 64 vocab
// columns by 64 k rows.
cudaError_t tensor_map(CUtensorMap* map, const void* base, int rows, int d, int box_rows) {
  static PFN_cuTensorMapEncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * sizeof(__nv_bfloat16)};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box,
      unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
#ifdef SAMPLE_PROBE_NO_L2_PROMOTION
      CU_TENSOR_MAP_L2_PROMOTION_NONE,
#else
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
#endif
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

// Blocks along the vocab for (B, Vp) on this device, the tiles each walks
// and the vocab rows of a tile (block k takes rows [k tiles tile_rows,
// (k + 1) tiles tile_rows)); the wrapper sizes the partials (blocks, B) with
// it. Returns a CUDA error code.
REPRO_EXPORT int fused_sample_grid(int B, int Vp, int cols, int device, int* blocks,
                                   int* tiles, int* tile_rows) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Variant v = pick(B, cols != 0);
  *tiles = tiles_for(v, Vp, device, &err);
  if (err != cudaSuccess) return err;
  const int ntiles = (Vp + v.tv - 1) / v.tv;
  *blocks = (ntiles + *tiles - 1) / *tiles;
  *tile_rows = v.tv;
  return cudaSuccess;
}

// head: 16-byte aligned, as (Vp, d) rows with d % 8 == 0 (cols == 0: the
// tied embedding as it lies) or as (d, Vp) with Vp % 8 == 0 (cols != 0: an
// untied lm_head as it lies). part (blocks, B) float4 and part_idx (blocks, B)
// int32 are the wrapper's scratch for the blocks' partials; ticket is one
// uint32, zero between launches (the last block of a launch leaves it at
// zero). A vocab shard of a larger head: col_offset is the global index of
// its first column (the hash positions and the indices are global; vocab
// counts the shard's own sampled columns), and a non-null state (B) float4
// with state_idx (B) int32 takes the merged state (max, sum of exp, best
// score, its logit; best index) in place of tok and lp.
REPRO_EXPORT int fused_sample_fwd(const void* h, const void* head, const void* seeds,
                                  const void* inv_temp, void* part, void* part_idx, void* ticket,
                                  void* tok, void* lp, int B, int d, int Vp, int vocab, int cols,
                                  int blocks, int tiles, void* state, void* state_idx,
                                  int col_offset, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Variant v = pick(B, cols != 0);
  CUtensorMap tm_head, tm_h;
  err = cols ? tensor_map(&tm_head, head, d, Vp, 64) : tensor_map(&tm_head, head, Vp, d, v.tv);
  if (err != cudaSuccess) return err;
  err = tensor_map(&tm_h, h, B, d, v.nb);
  if (err != cudaSuccess) return err;
  err = repro::allow_smem(v.kernel, v.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(blocks, (B + kMaxRowsB - 1) / kMaxRowsB);
  v.kernel<<<grid, v.threads, v.smem, static_cast<cudaStream_t>(stream)>>>(
      tm_head, tm_h, static_cast<const int*>(seeds), static_cast<const float*>(inv_temp),
      static_cast<float4*>(part), static_cast<int*>(part_idx),
      static_cast<unsigned int*>(ticket), static_cast<int*>(tok), static_cast<float*>(lp), B, d,
      Vp, vocab, tiles, static_cast<float4*>(state), static_cast<int*>(state_idx), col_offset);
  return cudaGetLastError();
}
