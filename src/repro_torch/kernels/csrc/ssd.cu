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
// the state's, per head and chunk): 0.07 ms at the 67 TFLOP/s fp32
// CUDA-core peak, 4.8 us at the bf16 tensor-core peak. This version does
// its products with fp32 FMAs on the CUDA cores, so the arithmetic bounds
// it.
//
// What the design does about it: Hopper's blocks run in no order, so the
// TPU's carry across grid steps becomes a loop over the chunks inside one
// block per (head, row); the state stays in shared memory for the whole
// sequence and is written once at the end. Per chunk the block stages in
// shared memory B and C (bf16, transposed: n-major, so a thread reads 8
// consecutive positions as one 16-byte load), x (fp32), the running sums and
// the gated scores G[j][i] = (C_i . B_j) exp(a_cum[i] - a_cum[j]) dt_j, built
// only for j <= i in 8 x 8 register tiles: above the diagonal a_cum[i] -
// a_cum[j] > 0 and its exp may overflow, so those entries are never computed
// (a select, never a multiply by a 0 mask, which would give inf x 0 = NaN).
// The buffer of G then holds the state update's weights. At the mamba2
// shapes that is 201,728 bytes of the 227 KB a block may have; the chunk is
// padded to a multiple of 8 positions with dt = 0, x = B = C = 0, which
// changes no real output.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__host__ __device__ inline int padded_chunk(int L) { return (L + 7) & ~7; }

__host__ __device__ inline size_t smem_bytes(int L, int N, int P) {
  const int Lp = padded_chunk(L), Ls = Lp + 8;
  const int gw = Lp > N ? Lp : N;
  return 2 * static_cast<size_t>(N) * Ls * 2 +
         (static_cast<size_t>(Lp) * P + static_cast<size_t>(N) * P +
          static_cast<size_t>(Lp) * gw + 2 * Lp) * 4;
}

__device__ __forceinline__ void unpack8(uint4 w, float* f) {
  float2 t;
  t = repro::bf2_to_f2(w.x); f[0] = t.x; f[1] = t.y;
  t = repro::bf2_to_f2(w.y); f[2] = t.x; f[3] = t.y;
  t = repro::bf2_to_f2(w.z); f[4] = t.x; f[5] = t.y;
  t = repro::bf2_to_f2(w.w); f[6] = t.x; f[7] = t.y;
}

__global__ void __launch_bounds__(kThreads)
    ssd_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const __nv_bfloat16* __restrict__ Bm,
               const __nv_bfloat16* __restrict__ Cm, const float* __restrict__ Dp,
               __nv_bfloat16* __restrict__ y, float* __restrict__ hout, int S, int NH, int G,
               int P, int N, int L) {
  const int hi = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int g = hi / (NH / G);
  const int Lp = padded_chunk(L), Ls = Lp + 8;  // Ls: row stride of Ct/Bt
  const int gw = Lp > N ? Lp : N;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ct = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [N][Ls]
  __nv_bfloat16* Bt = Ct + N * Ls;                                  // [N][Ls]
  float* xs = reinterpret_cast<float*>(Bt + N * Ls);                // [Lp][P]
  float* ht = xs + Lp * P;                                          // [N][P] the state
  float* Gs = ht + N * P;  // [Lp][Lp] scores G[j][i], then [Lp][N] state weights
  float* acum = Gs + Lp * gw;                                       // [Lp]
  float* dts = acum + Lp;                                           // [Lp]

  const float a_coef = A[hi], d_coef = Dp[hi];
  const long x_row = static_cast<long>(NH) * P;   // elements from t to t+1 in x, y
  const long bc_row = static_cast<long>(G) * N;   // ... in Bm, Cm
  const int nt = Lp / 8;       // 8-position tiles of the chunk
  const int npq = P / 4;       // 4-wide column groups of P
  const int nnq = N / 4;       // ... of N
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  for (int i = tid; i < N * P; i += kThreads) ht[i] = 0.f;

  for (int c = 0; c < S / L; ++c) {
    const long t0 = static_cast<long>(b) * S + static_cast<long>(c) * L;  // global row of position 0
    __syncthreads();  // the previous chunk is done with every buffer

    // ---- stage the chunk: B, C transposed; x; dt (padded rows are 0) ----
    for (int i = tid; i < Lp * N; i += kThreads) {
      const int l = i / N, n = i % N;
      __nv_bfloat16 bv = zero, cv = zero;
      if (l < L) {
        const long at = (t0 + l) * bc_row + static_cast<long>(g) * N + n;
        bv = Bm[at];
        cv = Cm[at];
      }
      Bt[n * Ls + l] = bv;
      Ct[n * Ls + l] = cv;
    }
    for (int i = tid; i < Lp * P; i += kThreads) {
      const int l = i / P, p = i % P;
      xs[i] = l < L ? __bfloat162float(x[(t0 + l) * x_row + static_cast<long>(hi) * P + p]) : 0.f;
    }
    for (int l = tid; l < Lp; l += kThreads) dts[l] = l < L ? dt[(t0 + l) * NH + hi] : 0.f;
    __syncthreads();

    // ---- a_cum: inclusive running sum of dt A, by warp 0 ----
    if (tid < 32) {
      const int per = (Lp + 31) / 32;
      float run = 0.f;
      for (int k = 0; k < per; ++k) {
        const int l = tid * per + k;
        if (l < Lp) {
          run += dts[l] * a_coef;
          acum[l] = run;
        }
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += u;
      }
      const float offset = incl - run;
      for (int k = 0; k < per; ++k) {
        const int l = tid * per + k;
        if (l < Lp) acum[l] += offset;
      }
    }
    __syncthreads();

    // ---- gated scores G[j][i] for j <= i, 8 x 8 tiles on and below the diagonal ----
    for (int t = tid; t < nt * (nt + 1) / 2; t += kThreads) {
      int ti = static_cast<int>((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
      while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
      while (ti * (ti + 1) / 2 > t) --ti;
      const int tj = t - ti * (ti + 1) / 2;
      float acc[8][8];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[a][e] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cf[8], bf[8];
        unpack8(*reinterpret_cast<const uint4*>(Ct + n * Ls + ti * 8), cf);
        unpack8(*reinterpret_cast<const uint4*>(Bt + n * Ls + tj * 8), bf);
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[a][e] = fmaf(cf[a], bf[e], acc[a][e]);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int j = tj * 8 + e;
        float col[8];
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          const int i = ti * 8 + a;
          col[a] = j <= i ? acc[a][e] * expf(acum[i] - acum[j]) * dts[j] : 0.f;
        }
        float4* dst = reinterpret_cast<float4*>(Gs + j * Lp + ti * 8);
        dst[0] = make_float4(col[0], col[1], col[2], col[3]);
        dst[1] = make_float4(col[4], col[5], col[6], col[7]);
      }
    }
    __syncthreads();

    // ---- y: 8 positions x 4 columns of P per thread tile ----
    for (int t = tid; t < nt * npq; t += kThreads) {
      const int i0 = (t / npq) * 8, p0 = (t % npq) * 4;
      float acc[8][4], inter[8][4];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[a][q] = inter[a][q] = 0.f;
      for (int j = 0; j < i0 + 8; ++j) {  // G[j][i] is 0 for j > i
        const float4 g0 = *reinterpret_cast<const float4*>(Gs + j * Lp + i0);
        const float4 g1 = *reinterpret_cast<const float4*>(Gs + j * Lp + i0 + 4);
        const float4 xv = *reinterpret_cast<const float4*>(xs + j * P + p0);
        const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
        const float xq[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[a][q] = fmaf(gv[a], xq[q], acc[a][q]);
      }
      for (int n = 0; n < N; ++n) {  // C_i . h, the state entering the chunk
        float cf[8];
        unpack8(*reinterpret_cast<const uint4*>(Ct + n * Ls + i0), cf);
        const float4 hv = *reinterpret_cast<const float4*>(ht + n * P + p0);
        const float hq[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int q = 0; q < 4; ++q) inter[a][q] = fmaf(cf[a], hq[q], inter[a][q]);
      }
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int i = i0 + a;
        if (i >= L) continue;
        const float e = expf(acum[i]);
        const float* xi = xs + i * P + p0;
        float out[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) out[q] = acc[a][q] + e * inter[a][q] + d_coef * xi[q];
        uint2* dst = reinterpret_cast<uint2*>(y + (t0 + i) * x_row + static_cast<long>(hi) * P + p0);
        *dst = make_uint2(repro::f2_to_bf2(out[0], out[1]), repro::f2_to_bf2(out[2], out[3]));
      }
    }
    __syncthreads();  // every read of G and of the entering state is done

    // ---- the state update: W[l][n] = B[l][n] dt_l exp(a_tot - a_cum[l]) ----
    const float a_tot = acum[L - 1];
    for (int i = tid; i < Lp * N; i += kThreads) {
      const int l = i / N, n = i % N;
      float w = 0.f;
      if (l < L)
        w = __bfloat162float(Bm[(t0 + l) * bc_row + static_cast<long>(g) * N + n]) * dts[l] *
            expf(a_tot - acum[l]);
      Gs[i] = w;
    }
    __syncthreads();
    const float decay = expf(a_tot);
    for (int t = tid; t < npq * nnq; t += kThreads) {
      const int p0 = (t / nnq) * 4, n0 = (t % nnq) * 4;
      float acc[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int m = 0; m < 4; ++m) acc[q][m] = 0.f;
      for (int l = 0; l < L; ++l) {
        const float4 xv = *reinterpret_cast<const float4*>(xs + l * P + p0);
        const float4 wv = *reinterpret_cast<const float4*>(Gs + l * N + n0);
        const float xq[4] = {xv.x, xv.y, xv.z, xv.w};
        const float wm[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int m = 0; m < 4; ++m) acc[q][m] = fmaf(xq[q], wm[m], acc[q][m]);
      }
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float& hs = ht[(n0 + m) * P + p0 + q];
          hs = decay * hs + acc[q][m];
        }
    }
  }
  __syncthreads();
  float* hb = hout + (static_cast<long>(b) * NH + hi) * P * N;
  for (int i = tid; i < P * N; i += kThreads) hb[i] = ht[(i % N) * P + i / N];
}

}  // namespace

REPRO_EXPORT int ssd_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                         const void* Cm, const void* D, void* y, void* hout, int B, int S, int NH,
                         int G, int P, int N, int L, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (L <= 0 || S % L != 0 || NH % G != 0 || P % 4 != 0 || N % 4 != 0)
    return cudaErrorInvalidValue;
  if (B == 0 || S == 0) return cudaSuccess;
  const size_t smem = smem_bytes(L, N, P);
  err = repro::allow_smem(ssd_kernel, smem);
  if (err != cudaSuccess) return err;
  ssd_kernel<<<dim3(NH, B), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const __nv_bfloat16*>(Bm),
      static_cast<const __nv_bfloat16*>(Cm), static_cast<const float*>(D),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(hout), S, NH, G, P, N, L);
  return cudaGetLastError();
}
