// Tensor-core and asynchronous-copy primitives for sm_90a, as inline PTX:
//   cp_async16         16 bytes from device memory to shared memory, in
//                      flight while the thread goes on (zero-filled when the
//                      predicate is false: nothing is read then);
//   ldmatrix_x4(_trans) four 8 x 8 bf16 matrices from shared memory into
//                      the fragment layout of mma.m16n8k16 (lane l gives the
//                      address of row l % 8 of matrix l / 8);
//   mma_bf16           D (16 x 8 fp32) += A (16 x 16 bf16) * B (16 x 8 bf16).
// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A a0 (row g, cols 2t, 2t+1)  a1 (row g+8, same)  a2 (row g, cols 2t+8, +9)
//     a3 (row g+8, cols 2t+8, +9);  B b0 (rows 2t, 2t+1, col g)  b1 (rows
//     2t+8, +9, col g);  C c0, c1 (row g, cols 2t, 2t+1)  c2, c3 (row g+8).
// Used by flash_attention.cu and split_kv.cuh.
#pragma once

#include "common.cuh"

namespace repro {
namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// S (16 x 16 keys, two n-tiles of the accumulator) as bf16 A fragments of
// the value product: p is rounded to v's type straight from the registers.
__device__ __forceinline__ void scores_to_a(uint32_t (&a)[4], const float (&s0)[4],
                                            const float (&s1)[4]) {
  a[0] = f2_to_bf2(s0[0], s0[1]);
  a[1] = f2_to_bf2(s0[2], s0[3]);
  a[2] = f2_to_bf2(s1[0], s1[1]);
  a[3] = f2_to_bf2(s1[2], s1[3]);
}

// Max and sum over the four lanes of a quad (the lanes that share a row of
// an mma fragment).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace mma
}  // namespace repro
