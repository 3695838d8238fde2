// Building blocks of the port's Ampere-style tensor-core code (swa_bwd.cu,
// and the 3xTF32 main loop of normal_matvec.cu and rf_map.cu):
// asynchronous global-to-shared copies, ldmatrix fragment loads, the
// warp-level bf16 mma.sync product and the split of fp32 into TF32 parts,
// as thin inline PTX.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16" and
// "mma.m16n8k8"), with g = lane / 4 and t = lane % 4:
//   m16n8k16 bf16  A (16 x 16): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g,
//                  2t+8..), a3 (g+8, 2t+8..); B (16 x 8): b0 (2t..2t+1, g),
//                  b1 (2t+8.., g); two bf16 per 32-bit register, the lower
//                  column (or row) in the low half.
//   m16n8k8 tf32   A (16 x 8): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3
//                  (g+8, t+4), as wgmma's TF32 A takes it from registers
//                  (wgmma_tf32.cuh).
//   C (16 x 8, fp32): c0, c1 (g, 2t..2t+1), c2, c3 (g+8, ..).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; only the first `bytes` (0..16) are read, the
// rest of the 16 are filled with zeros. Both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

// 4 bytes global -> shared, or 4 zero bytes when `bytes` is 0.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and r[i] receives this lane's two elements of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// the same, each matrix transposed on the way
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a b, a 16 x 16 bf16, b 16 x 8 bf16, c 16 x 8 fp32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as one register of two bf16, lo in the low half (rounded to
// nearest)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The 3xTF32 split: x = hi + lo exactly, hi = x with its 13 low mantissa
// bits cleared (a TF32 value), lo = tf32(x - hi) the same way. Then
// a b ~ a_hi b_hi + a_hi b_lo + a_lo b_hi, dropping a_lo b_lo (2^-22
// relative) and the truncation of the lo parts (2^-22 relative).
constexpr uint32_t TF32_MASK = 0xffffe000u;
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & TF32_MASK;
  lo = __float_as_uint(x - __uint_as_float(hi)) & TF32_MASK;
}

}  // namespace tc
