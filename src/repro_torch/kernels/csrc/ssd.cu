// Mamba2 SSD (state-space dual) chunked scan: x (B,S,NH,P) bf16, dt (B,S,NH)
// f32, A and D (NH,) f32, Bm and Cm (B,S,G,N) bf16, head h reading group
// h / (NH/G). Returns y (B,S,NH,P) bf16 and the final state (B,NH,P,N) f32.
// Per chunk of L positions, in fp32:
//   a = dt A,  a_cum its inclusive running sum,  a_tot = a_cum[L-1]
//   y[i] = sum_{j<=i} (C_i . B_j) exp(a_cum[i] - a_cum[j]) dt_j x_j
//          + exp(a_cum[i]) C_i . h  +  D x_i
//   h <- exp(a_tot) h + sum_l x_l^T (B_l dt_l exp(a_tot - a_cum[l]))
//
// Replaces the TPU kernel src/repro/kernels/ssd.py:ssd (_kernel), which walked
// a (B, NH, NC) grid with the chunk axis minor and carried h (P x N, fp32) in
// VMEM scratch from one chunk's grid step to the next.
//
// What bounds it on an H100: at the mamba2-2.7b prefill (B=8, S=128, 80 heads
// of P=64, one group of N=128, L=128) it moves ~43 MB (x and y in bf16, the
// fp32 state out; dt, B and C are small), 12.8 us at 3.35 TB/s, and does
// ~4.7 GFLOP (L(L+1)/2 (2N + 2P) for the causal products and 4 L N P for
// the state's, per head and chunk), 4.8 us at the bf16 tensor-core peak: the
// bytes bound it once the products run on the tensor cores.
//
// What the design does about it:
// - Chunk-parallel: one block per (head, chunk, row), in any order. One
//   chunk (S == L, every prefill of the serving path) is one launch that
//   writes y and the state. S > L takes three: every chunk's own state from
//   a zero start (ssd_state_kernel), the recurrence h <- exp(a_tot) h + s_c
//   over the chunks in order in fp32 (ssd_pass_kernel, in the order of
//   kernels/ref.py's ssd_chunked; it leaves the state entering each chunk in
//   the workspace), then every chunk's y (ssd_y_kernel). No atomics: two
//   launches give the same bits.
// - Warps by role: 4 warps compute y, 4 the state (the one-chunk kernel has
//   both, side by side, 8 warps; the S > L kernels one role each).
// - B, C and x come in as bf16 tiles through 16-byte cp.async (rows padded
//   by 16 bytes, so ldmatrix's 8 rows hit 32 different banks); dt and the
//   running sums stay fp32. At the mamba2 shapes that is 88 KB of shared
//   memory (55 KB without C, for the state kernel), and at most 128
//   registers a thread: two 8-warp blocks fit on an SM. The chunk is padded
//   to a multiple of 16 positions with zeros (dt = 0), which changes no real
//   output.
// - All four products are mma.sync.m16n8k16 with fp32 sums. S = C_i B_j^T
//   takes the bf16 inputs as stored (its products are exact). The other
//   three each have one fp32 operand, G, h or W, split into bf16 hi + lo
//   (two products, ~16 bits): one bf16 pass misses the scan's tolerances
//   (ref.ssd_chunked_tiles is this decomposition in plain torch).
// - Intra-chunk, causal linear attention with a multiplicative gate: each y
//   warp owns 16-row tiles of the chunk (two at L = 128, a heavy one with a
//   light one) and walks the key tiles j <= i, S of tile j + 1 in flight
//   while tile j's G x runs. The gate exp(a_cum[i] - a_cum[j]) dt_j is
//   applied to S in registers; above the diagonal it is a select, never a
//   multiply by a 0 mask (that exp may overflow, and inf x 0 is NaN). G goes
//   from the score registers to A fragments, as p does in
//   flash_attention.cu; x_j comes in through ldmatrix.trans.
// - Inter-chunk: C_i h^T (C's fragments are those S used; ssd_pass_kernel
//   leaves h^T's split fragments in the workspace), the rows then scaled by
//   exp(a_cum[i]); the intra products accumulate on top.
// - State: s = x^T W, W's fragments built in registers: B through
//   ldmatrix.trans, each position scaled by dt_l exp(a_tot - a_cum[l]), split.
// - y and the state leave straight from the accumulators in 8-byte stores
//   that fill whole 32-byte sectors (y after one exchange in each lane
//   pair; as 4-byte pairs it would fill half a sector of a row a store).
// - Every exp is ex2.approx of its argument times log2(e) (2 ulp; results
//   below 2^-126 flushed to 0).
#include "mma.cuh"

namespace {

using namespace repro::mma;
using repro::bf2_to_f2;
using repro::f2_to_bf2;
using repro::kLog2e;

// Probe builds (src/repro_torch/tools/attn_probe.py) set these; the port's
// build sets neither. SSD_PROBE_COPIES_ONLY: the tiles are loaded and y and
// the state written (y = D x, the state 0), the products dropped.
// SSD_PROBE_PRODUCTS_ONLY: nothing is copied into the tiles (the products
// run on whatever shared memory holds). Neither probe build computes the scan.

constexpr int kWarps = 4;  // warps of each role

__host__ __device__ inline int padded_chunk(int L) { return (L + 15) & ~15; }

template <int N, int P>
struct Tiles {
  static constexpr int LDN = N + 8;  // row stride of the B and C tiles (bf16)
  static constexpr int LDP = P + 8;  // ... of the x tile
  // B, C (with y only), x, then three fp32 arrays of Lp
  static size_t bytes(int Lp, bool with_c) {
    return (static_cast<size_t>(with_c ? 2 : 1) * Lp * LDN + static_cast<size_t>(Lp) * LDP) * 2 +
           3 * static_cast<size_t>(Lp) * 4;
  }
};

struct Params {
  const __nv_bfloat16* x;
  const float* dt;
  const float* A;
  const __nv_bfloat16* Bm;
  const __nv_bfloat16* Cm;
  const float* D;
  __nv_bfloat16* y;
  float* state;  // one chunk: the final state (B,NH,P,N); else the workspace
                 // (B,NH,NC,P,N): each chunk's own state, then (ssd_pass_kernel)
                 // the state entering each chunk, as ssd_y_kernel's fragments
  float* a_tot;  // S > L: a_tot of each (row, head, chunk), (B,NH,NC)
  int S, NH, G, L, NC;
};

// 2^x (ex2.approx.ftz: 2 ulp, results below 2^-126 flushed to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// two fp32 values as bf16 pairs: hi (rounded) and lo (the rest, rounded)
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  hi = f2_to_bf2(a, b);
  const float2 h = bf2_to_f2(hi);
  lo = f2_to_bf2(a - h.x, b - h.y);
}

// One (head, chunk, row): y (kY, warps 0..3) and this chunk's own state
// (kState: the next 4 warps, or warps 0..3 without y).
template <int N, int P, bool kY, bool kState>
__device__ __forceinline__ void chunk(const Params& p) {
  using T = Tiles<N, P>;
  constexpr int LDN = T::LDN, LDP = T::LDP, CN = N / 8, CP = P / 8;
  constexpr int kThreads = 32 * kWarps * (kY + kState);
  const int hd = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = hd / (p.NH / p.G), L = p.L, Lp = padded_chunk(L);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [Lp][LDN]
  __nv_bfloat16* Cs = Bs + Lp * LDN;                                 // [Lp][LDN], y only
  __nv_bfloat16* xs = Cs + (kY ? Lp * LDN : 0);                      // [Lp][LDP]
  float* acum = reinterpret_cast<float*>(xs + Lp * LDP);             // [Lp]
  float* dts = acum + Lp;                                            // [Lp]
  float* wsc = dts + Lp;  // [Lp] dt_l exp(a_tot - a_cum[l]), the state's weights

  const long t0 = static_cast<long>(b) * p.S + static_cast<long>(c) * L;  // row of position 0
  const long x_row = static_cast<long>(p.NH) * P, bc_row = static_cast<long>(p.G) * N;
  const long x_at = t0 * x_row + static_cast<long>(hd) * P;
  const long bc_at = t0 * bc_row + static_cast<long>(g) * N;

  // ---- the chunk's tiles, 16 bytes a copy (a thread keeps one column of
  // 16-byte pieces); padded positions are zero ----
#ifndef SSD_PROBE_PRODUCTS_ONLY
  {
    const int k = tid % CN;
    for (int l = tid / CN; l < Lp; l += kThreads / CN) {
      const bool ok = l < L;
      const long at = ok ? bc_at + l * bc_row + k * 8 : 0;
      cp_async16(Bs + l * LDN + k * 8, p.Bm + at, ok);
      if (kY) cp_async16(Cs + l * LDN + k * 8, p.Cm + at, ok);
    }
  }
  {
    const int k = tid % CP;
    for (int l = tid / CP; l < Lp; l += kThreads / CP) {
      const bool ok = l < L;
      cp_async16(xs + l * LDP + k * 8, p.x + (ok ? x_at + l * x_row + k * 8 : 0), ok);
    }
  }
#endif
  cp_async_commit();

  // ---- dt and a_cum, by warp 0 while the copies are in flight (a lane's
  // dt loads four at a time) ----
  if (warp == 0) {
    const float a_coef = p.A[hd];
    const int per = (Lp + 31) / 32;
    float run = 0.f;
    for (int k0 = 0; k0 < per; k0 += 4) {
      float d[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int l = lane * per + k0 + u;
        d[u] = k0 + u < per && l < L ? p.dt[(t0 + l) * p.NH + hd] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int l = lane * per + k0 + u;
        if (k0 + u < per && l < Lp) {
          dts[l] = d[u];
          run += d[u] * a_coef;
          acum[l] = run;
        }
      }
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += u;
    }
    for (int k = 0; k < per; ++k) {
      const int l = lane * per + k;
      if (l < Lp) acum[l] += incl - run;
    }
    __syncwarp();
    if (kState) {
      const float a_tot = acum[L - 1];
      for (int l = lane; l < Lp; l += 32) wsc[l] = dts[l] * ex2((a_tot - acum[l]) * kLog2e);
      if (p.NC > 1 && lane == 0)
        p.a_tot[(static_cast<long>(b) * p.NH + hd) * p.NC + c] = a_tot;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  if (kY && warp < kWarps) {
    // ---- y, one 16-row tile at a time; the row tiles go to the y warps in
    // a snake (0..3, then 7..4), so that their causal work is even ----
    const float d_coef = p.D[hd];
    const float* h_in = p.state + ((static_cast<long>(b) * p.NH + hd) * p.NC + c) * P * N;
    const int rtiles = Lp / 16;
    uint32_t cf[N / 16][4];  // C of the row tile as A fragments, k over the state dim
    // S = C_i B_j^T of key tile jt over the state dim, in two chains (even
    // and odd k-steps) that are then added
    auto scores = [&](int jt, float (&s)[2][4]) {
      float t[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = t[n][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < N / 16; ++kd) {
        uint32_t bk[4];
        ldmatrix_x4(bk, Bs + (jt * 16 + (lane >> 4) * 8 + (lane & 7)) * LDN + kd * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16((kd & 1) ? t[0] : s[0], cf[kd], bk[0], bk[1]);
        mma_bf16((kd & 1) ? t[1] : s[1], cf[kd], bk[2], bk[3]);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] += t[n][e];
    };
    for (int base = 0, k = 0; base < rtiles; base += kWarps, ++k) {
      const int rt = base + ((k & 1) ? kWarps - 1 - warp : warp);
      if (rt >= rtiles) continue;
#pragma unroll
      for (int kd = 0; kd < N / 16; ++kd)
        ldmatrix_x4(cf[kd], Cs + (rt * 16 + (lane & 15)) * LDN + kd * 16 + (lane >> 4) * 8);
      const int i0 = rt * 16;
      const int ra = i0 + (lane >> 2), rb = ra + 8;  // this thread's two rows
      const float ca = acum[ra], cb = acum[rb];
      float acc[P / 8][4];
#pragma unroll
      for (int n = 0; n < P / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

#ifndef SSD_PROBE_COPIES_ONLY
      if (!kState && c > 0) {
        // inter-chunk: C_i h^T with h = hi + lo (ssd_pass_kernel left each
        // lane's B fragments of h^T, hi then lo, where the lane reads them),
        // then the rows' exp(a_cum[i])
#pragma unroll
        for (int kd = 0; kd < N / 16; ++kd)
#pragma unroll
          for (int n = 0; n < P / 8; ++n) {
            const float* hp = h_in + (n * 8 + (lane >> 2)) * N + kd * 16 + (lane & 3) * 2;
            const uint2 hi = __ldg(reinterpret_cast<const uint2*>(hp));
            const uint2 lo = __ldg(reinterpret_cast<const uint2*>(hp + 8));
            mma_bf16(acc[n], cf[kd], hi.x, hi.y);
            mma_bf16(acc[n], cf[kd], lo.x, lo.y);
          }
        const float ea = ex2(ca * kLog2e), eb = ex2(cb * kLog2e);
#pragma unroll
        for (int n = 0; n < P / 8; ++n) {
          acc[n][0] *= ea;
          acc[n][1] *= ea;
          acc[n][2] *= eb;
          acc[n][3] *= eb;
        }
      }

      // intra-chunk: the key tiles j <= i; S of tile jt + 1 is computed while
      // tile jt's G x runs
      auto gate_and_gx = [&](int jt, float (&s)[2][4]) {
        // the gate, in registers (c0, c1: row ra; c2, c3: row rb); a select
        // above the diagonal
        const bool diag = jt == rt;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int j = jt * 16 + n * 8 + (lane & 3) * 2;
          const float2 aj = *reinterpret_cast<const float2*>(acum + j);
          const float2 dj = *reinterpret_cast<const float2*>(dts + j);
          s[n][0] = !diag || j <= ra ? s[n][0] * ex2((ca - aj.x) * kLog2e) * dj.x : 0.f;
          s[n][1] = !diag || j + 1 <= ra ? s[n][1] * ex2((ca - aj.y) * kLog2e) * dj.y : 0.f;
          s[n][2] = !diag || j <= rb ? s[n][2] * ex2((cb - aj.x) * kLog2e) * dj.x : 0.f;
          s[n][3] = !diag || j + 1 <= rb ? s[n][3] * ex2((cb - aj.y) * kLog2e) * dj.y : 0.f;
        }
        uint32_t ghi[4], glo[4];  // G as hi + lo A fragments, k over the keys
        split2(s[0][0], s[0][1], ghi[0], glo[0]);
        split2(s[0][2], s[0][3], ghi[1], glo[1]);
        split2(s[1][0], s[1][1], ghi[2], glo[2]);
        split2(s[1][2], s[1][3], ghi[3], glo[3]);
#pragma unroll
        for (int d2 = 0; d2 < P / 16; ++d2) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, xs + (jt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDP +
                                    d2 * 16 + (lane >> 4) * 8);
          mma_bf16(acc[2 * d2], ghi, bv[0], bv[1]);
          mma_bf16(acc[2 * d2 + 1], ghi, bv[2], bv[3]);
          mma_bf16(acc[2 * d2], glo, bv[0], bv[1]);
          mma_bf16(acc[2 * d2 + 1], glo, bv[2], bv[3]);
        }
      };
      float s[2][4], s_next[2][4];
      scores(0, s);
      for (int jt = 0; jt < rt; ++jt) {
        scores(jt + 1, s_next);
        gate_and_gx(jt, s);
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = s_next[n][e];
      }
      gate_and_gx(rt, s);
#endif

      // y = acc + D x as bf16 pairs, then one exchange in each lane pair so
      // that a lane holds 4 columns of one n-tile: a quad's four 8-byte
      // stores fill 32 bytes (n-tiles 2m and 2m + 1) of each of its rows
      const bool odd = lane & 1;
#pragma unroll
      for (int m = 0; m < P / 16; ++m) {
        uint32_t wa[2], wb[2];  // rows ra, rb; n-tiles 2m, 2m + 1
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = 2 * m + h, col = n * 8 + (lane & 3) * 2;
          const float2 xa = bf2_to_f2(*reinterpret_cast<const uint32_t*>(xs + ra * LDP + col));
          const float2 xb = bf2_to_f2(*reinterpret_cast<const uint32_t*>(xs + rb * LDP + col));
          wa[h] = f2_to_bf2(acc[n][0] + d_coef * xa.x, acc[n][1] + d_coef * xa.y);
          wb[h] = f2_to_bf2(acc[n][2] + d_coef * xb.x, acc[n][3] + d_coef * xb.y);
        }
        const uint32_t ra_in = __shfl_xor_sync(0xffffffffu, odd ? wa[0] : wa[1], 1);
        const uint32_t rb_in = __shfl_xor_sync(0xffffffffu, odd ? wb[0] : wb[1], 1);
        // even lane t: n-tile 2m, columns 2t..2t+3; odd lane: n-tile 2m+1, 2(t-1)..2t+1
        const int col = (2 * m + odd) * 8 + ((lane & 3) - odd) * 2;
        if (ra < L)
          *reinterpret_cast<uint2*>(p.y + x_at + ra * x_row + col) =
              odd ? make_uint2(ra_in, wa[1]) : make_uint2(wa[0], ra_in);
        if (rb < L)
          *reinterpret_cast<uint2*>(p.y + x_at + rb * x_row + col) =
              odd ? make_uint2(rb_in, wb[1]) : make_uint2(wb[0], rb_in);
      }
    }
  }

  if (kState && warp >= (kY ? kWarps : 0)) {
    // ---- this chunk's state from a zero start, s = x^T W over the chunk's
    // positions: m-tiles of 16 head rows (A: x^T through ldmatrix.trans),
    // n-tiles of 8 state columns (B: W through ldmatrix.trans, each position
    // scaled by wsc[l] and split). A warp takes kNP pairs of n-tiles and kMW
    // m-tiles: at N < 16 kWarps the warps of one pair share out the m-tiles ----
    constexpr int MT = P / 16, NP = N / 16;
    constexpr int kShare = NP >= kWarps ? 1 : kWarps / NP;
    constexpr int kNP = NP >= kWarps ? NP / kWarps : 1;
    constexpr int kMW = MT / kShare;
    static_assert((NP % kWarps == 0 || kWarps % NP == 0) && MT % kShare == 0, "state tiles");
    float* out = p.state + ((static_cast<long>(b) * p.NH + hd) * p.NC + c) * P * N;
    const int sw = warp - (kY ? kWarps : 0);  // the warp among the state warps
    const int m0 = (sw % kShare) * kMW;
    auto n_pair = [&](int i) { return sw / kShare + i * (kWarps / kShare); };
    float acc[kMW][2 * kNP][4];
#pragma unroll
    for (int m = 0; m < kMW; ++m)
#pragma unroll
      for (int n = 0; n < 2 * kNP; ++n)
        acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.f;
#ifndef SSD_PROBE_COPIES_ONLY
    for (int kl = 0; kl < Lp / 16; ++kl) {
      uint32_t xa[kMW][4];  // x^T's A fragments over this k-step
#pragma unroll
      for (int m = 0; m < kMW; ++m)
        ldmatrix_x4_trans(xa[m], xs + (kl * 16 + (lane & 7) + (lane >> 4) * 8) * LDP +
                                     (m0 + m) * 16 + ((lane >> 3) & 1) * 8);
      const int l0 = kl * 16 + (lane & 3) * 2;
      const float2 w0 = *reinterpret_cast<const float2*>(wsc + l0);
      const float2 w1 = *reinterpret_cast<const float2*>(wsc + l0 + 8);
#pragma unroll
      for (int i = 0; i < kNP; ++i) {
        // W's B fragments of the pair's two n-tiles (b0 at l = 2t, 2t+1; b1 at + 8)
        uint32_t bw[4];
        ldmatrix_x4_trans(bw, Bs + (kl * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDN +
                                  n_pair(i) * 16 + (lane >> 4) * 8);
        uint32_t whi[4], wlo[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 f = bf2_to_f2(bw[q]);
          const float2 wq = (q & 1) ? w1 : w0;
          split2(f.x * wq.x, f.y * wq.y, whi[q], wlo[q]);
        }
#pragma unroll
        for (int m = 0; m < kMW; ++m) {
          mma_bf16(acc[m][2 * i], xa[m], whi[0], whi[1]);
          mma_bf16(acc[m][2 * i + 1], xa[m], whi[2], whi[3]);
          mma_bf16(acc[m][2 * i], xa[m], wlo[0], wlo[1]);
          mma_bf16(acc[m][2 * i + 1], xa[m], wlo[2], wlo[3]);
        }
      }
    }
#endif
    // acc[m][n][e] = s[p][k], p = 16 (m0 + m) + g + 8 (e >> 1), k = 8 (2 n_pair(n / 2) +
    // n % 2) + 2t + (e & 1): 8-byte stores, a quad's filling 32 bytes of a row
#pragma unroll
    for (int m = 0; m < kMW; ++m)
#pragma unroll
      for (int n = 0; n < 2 * kNP; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(out + ((m0 + m) * 16 + (lane >> 2) + 8 * h) * N +
                                     (2 * n_pair(n / 2) + n % 2) * 8 + (lane & 3) * 2) =
              make_float2(acc[m][n][2 * h], acc[m][n][2 * h + 1]);
  }
}

// one chunk: y and the final state, 8 warps
template <int N, int P>
__global__ void __launch_bounds__(256, 2) ssd_chunk_kernel(const Params p) {
  chunk<N, P, true, true>(p);
}

// S > L: each chunk's own state, into the workspace
template <int N, int P>
__global__ void __launch_bounds__(128, 4) ssd_state_kernel(const Params p) {
  chunk<N, P, false, true>(p);
}

// S > L: each chunk's y, from the state entering it
template <int N, int P>
__global__ void __launch_bounds__(128, 2) ssd_y_kernel(const Params p) {
  chunk<N, P, true, false>(p);
}

// S > L: h <- exp(a_tot_c) h + s_c over the chunks in order. A thread owns
// h[p][n0, n0 + 1, n0 + 8, n0 + 9], n0 = 16 kd + 2t: the h^T values of one
// lane's B fragments (b0, b1) in ssd_y_kernel's product C_i h^T. In chunk
// c >= 1 of the workspace it leaves the state entering the chunk as those
// fragments, split: (b0, b1) hi where n0, n0 + 1 were, (b0, b1) lo where
// n0 + 8, n0 + 9 were (its own 16 bytes, so in place). The last h goes to
// hout as fp32.
__global__ void __launch_bounds__(256)
    ssd_pass_kernel(float* __restrict__ ws, const float* __restrict__ a_tot,
                    float* __restrict__ hout, int N, int PN, int NC) {
  const long bh = blockIdx.y;
  const int i = blockIdx.x * 256 + threadIdx.x;  // a thread per 4 values
  if (i * 4 >= PN) return;
  const int q = i % (N / 4);
  const int at = (i / (N / 4)) * N + (q / 4) * 16 + (q % 4) * 2;  // p N + n0
  float* w = ws + bh * NC * PN + at;
  float2 h0 = make_float2(0.f, 0.f), h1 = h0;  // (n0, n0 + 1), (n0 + 8, n0 + 9)
  float2 n0 = *reinterpret_cast<const float2*>(w), n1 = *reinterpret_cast<const float2*>(w + 8);
  for (int c = 0; c < NC; ++c) {
    float* wc = w + static_cast<long>(c) * PN;
    const float2 s0 = n0, s1 = n1;
    if (c + 1 < NC) {  // the next chunk's, in flight during this one's stores
      n0 = *reinterpret_cast<const float2*>(wc + PN);
      n1 = *reinterpret_cast<const float2*>(wc + PN + 8);
    }
    if (c > 0) {
      uint32_t hi0, lo0, hi1, lo1;
      split2(h0.x, h0.y, hi0, lo0);
      split2(h1.x, h1.y, hi1, lo1);
      *reinterpret_cast<uint2*>(wc) = make_uint2(hi0, hi1);
      *reinterpret_cast<uint2*>(wc + 8) = make_uint2(lo0, lo1);
    }
    const float d = expf(a_tot[bh * NC + c]);
    h0 = make_float2(__fadd_rn(__fmul_rn(d, h0.x), s0.x), __fadd_rn(__fmul_rn(d, h0.y), s0.y));
    h1 = make_float2(__fadd_rn(__fmul_rn(d, h1.x), s1.x), __fadd_rn(__fmul_rn(d, h1.y), s1.y));
  }
  *reinterpret_cast<float2*>(hout + bh * PN + at) = h0;
  *reinterpret_cast<float2*>(hout + bh * PN + at + 8) = h1;
}

template <int N, int P>
cudaError_t run(Params p, float* hout, int B, cudaStream_t stream) {
  const int Lp = padded_chunk(p.L);
  const size_t with_c = Tiles<N, P>::bytes(Lp, true), no_c = Tiles<N, P>::bytes(Lp, false);
  const dim3 grid(p.NH, p.NC, B);
  cudaError_t err;
  if (p.NC == 1) {
    p.state = hout;
    if ((err = repro::allow_smem(ssd_chunk_kernel<N, P>, with_c)) != cudaSuccess) return err;
    ssd_chunk_kernel<N, P><<<grid, 256, with_c, stream>>>(p);
    return cudaGetLastError();
  }
  if ((err = repro::allow_smem(ssd_state_kernel<N, P>, no_c)) != cudaSuccess) return err;
  if ((err = repro::allow_smem(ssd_y_kernel<N, P>, with_c)) != cudaSuccess) return err;
  ssd_state_kernel<N, P><<<grid, 128, no_c, stream>>>(p);
  constexpr int PN = P * N;
  ssd_pass_kernel<<<dim3((PN / 4 + 255) / 256, B * p.NH), 256, 0, stream>>>(p.state, p.a_tot,
                                                                           hout, N, PN, p.NC);
  ssd_y_kernel<N, P><<<grid, 128, with_c, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// ws (B,NH,S/L,P,N) and a_tot (B,NH,S/L) f32 are scratch for S > L (null
// when S == L). P must be 64, N one of 16, 32, 64, 128.
REPRO_EXPORT int ssd_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                         const void* Cm, const void* D, void* y, void* hout, void* ws,
                         void* a_tot, int B, int S, int NH, int G, int P, int N, int L,
                         int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (L <= 0 || S % L != 0 || G <= 0 || NH % G != 0 || P != 64) return cudaErrorInvalidValue;
  if (S / L > 1 && (ws == nullptr || a_tot == nullptr)) return cudaErrorInvalidValue;
  if (B == 0 || S == 0) return cudaSuccess;
  const Params p{static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt),
                 static_cast<const float*>(A), static_cast<const __nv_bfloat16*>(Bm),
                 static_cast<const __nv_bfloat16*>(Cm), static_cast<const float*>(D),
                 static_cast<__nv_bfloat16*>(y), static_cast<float*>(ws),
                 static_cast<float*>(a_tot), S, NH, G, L, S / L};
  float* h = static_cast<float*>(hout);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 16: return run<16, 64>(p, h, B, s);
    case 32: return run<32, 64>(p, h, B, s);
    case 64: return run<64, 64>(p, h, B, s);
    case 128: return run<128, 64>(p, h, B, s);
    default: return cudaErrorInvalidValue;
  }
}
