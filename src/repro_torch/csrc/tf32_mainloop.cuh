// The 3xTF32 wgmma main loop that normal_matvec.cu and rf_map.cu share:
// C (128 x N) = A B over a reduction walked in 32-deep stages, A from a
// row-major fp32 or bf16 matrix, B^T fp32 laid out in 32-deep K-major tiles.
//
// Arithmetic (see tc_mma.cuh split_tf32): x = hi + lo with hi the TF32
// truncation of x and lo that of x - hi, and a b ~ a_lo b_hi + a_hi b_lo +
// a_hi b_hi, which keeps fp32-level error where one-pass TF32 misses the
// port's 1e-5 .. 3e-5 tolerances. A bf16 A is exact in TF32 and takes two
// products. The products are Hopper's warpgroup wgmma.mma_async m64nNk8,
// A from registers (split there) and B from shared memory (split there once
// per block: hi in place, lo beside it).
//
// Pieces, in the order a stage uses them:
//   load_tile  the A tile, by cp.async (16-byte copies where rows are
//              16-byte aligned, else 4-byte copies or plain loads);
//   load_b     the B^T tile, one 16-byte cp.async per core-matrix row;
//   split_b    B^T landed -> hi and lo parts in shared memory;
//   load_a     a stage's A fragments, split, into one of two register
//              buffers (the products of one stage read one while the next
//              stage's are loaded into the other);
//   mma_stage  the stage's products into `part`, whose first product
//              overwrites it: the caller adds `part` into fp32 registers
//              after every stage, since the tensor cores' sums truncate
//              instead of rounding and the bias grows with the chain.
// B is K-major in shared memory, as TF32 wgmma requires, unswizzled: 8 x
// 16-byte core matrices, the 8 of one 8-row group along K side by side.
// A block is two warpgroups over 128 rows, each 64.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_mma.cuh"
#include "wgmma_tf32.cuh"

namespace tf32 {

constexpr int BM = 128;          // output rows of a block
constexpr int BK = 32;           // reduction depth of one stage
constexpr int KG = BK / 4;       // 16-byte core-matrix columns of a stage
constexpr int THREADS = 256;     // two warpgroups

__device__ __forceinline__ float as_f32(float v) { return v; }
__device__ __forceinline__ float as_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// rows [r0, r0 + ROWS) x columns [c0, c0 + COLS) of a row-major matrix
// with leading dimension ld into a shared tile with row stride SLD;
// elements at or past (r_end, c_end) read as zero.
template <typename T, int ROWS, int COLS, int SLD>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ g,
                                          int64_t ld, int64_t r0,
                                          int64_t r_end, int64_t c0,
                                          int64_t c_end, bool vec,
                                          int tid) {
  constexpr int E = 16 / sizeof(T);   // elements of a 16-byte chunk
  if (vec) {
    constexpr int CPR = COLS / E;
#pragma unroll
    for (int i = 0; i < ROWS * CPR / THREADS; ++i) {
      const int e = tid + THREADS * i;
      const int r = e / CPR;
      const int cc = (e % CPR) * E;
      const int64_t gr = r0 + r;
      const int64_t gc = c0 + cc;
      int64_t n = gr < r_end ? c_end - gc : 0;
      n = n < 0 ? 0 : (n > E ? E : n);
      tc::cp_async16(tc::smem_u32(dst + r * SLD + cc),
                     n ? g + gr * ld + gc : g, (int)n * (int)sizeof(T));
    }
    return;
  }
#pragma unroll 4
  for (int i = 0; i < ROWS * COLS / THREADS; ++i) {
    const int e = tid + THREADS * i;
    const int r = e / COLS;
    const int c = e % COLS;
    const int64_t gr = r0 + r;
    const int64_t gc = c0 + c;
    const bool ok = gr < r_end && gc < c_end;
    if constexpr (sizeof(T) == 4) {
      tc::cp_async4(tc::smem_u32(dst + r * SLD + c),
                    ok ? g + gr * ld + gc : g, ok ? 4 : 0);
    } else {
      dst[r * SLD + c] = ok ? g[gr * ld + gc] : __float2bfloat16(0.f);
    }
  }
}

// shared-memory descriptor of a K-major, unswizzled operand whose 8 x
// 16-byte core matrices lie 128 bytes apart along K and KG * 128 bytes
// apart along N (PTX ISA "Matrix Descriptor Format")
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  constexpr uint64_t LBO = 128 >> 4;
  constexpr uint64_t SBO = (KG * 128) >> 4;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (LBO << 16) | (SBO << 32);
}

// Shared memory of one stage. A as cp.async lands it: X[m][k] as
// [BM][BK + pad] (kXT false) or X[k][m] as [BK][BM + 8] (kXT true); the
// pads put the fragment loads of a warp in 32 distinct banks. B^T: 8 NT
// rows (n) x BK (k) fp32 as core matrices, hi and lo parts. Four stages
// where they fit in the 227 KB a block may have (N <= 152 in fp32), else
// three.
template <typename T, bool kXT, int NT>
struct Layout {
  static constexpr int A_ROWS = kXT ? BK : BM;
  static constexpr int A_COLS = kXT ? BM : BK;
  static constexpr int A_LD = A_COLS + (kXT ? 8 : 16 / (int)sizeof(T));
  static constexpr int A_BYTES = A_ROWS * A_LD * (int)sizeof(T);
  static constexpr int B_BYTES = 8 * NT * BK * 4;
  static constexpr int STAGE_BYTES = A_BYTES + 2 * B_BYTES;
  static constexpr int STAGES = 4 * STAGE_BYTES <= 232448 ? 4 : 3;
  static constexpr size_t BYTES = (size_t)STAGES * STAGE_BYTES;
};

template <int B>
struct Buf {
  static constexpr int value = B;
};

// The B^T tile of [k0, k0 + BK) and columns [c0, c0 + 8 NT) into `dst`:
// B^T is fp32 in BK-deep tiles, element (col, k) at bt[(k / BK) ldt BK +
// col BK + k % BK]. Row c0 + n is 128 contiguous bytes, its 16-byte chunk
// kc goes to core matrix (n / 8, kc), row n % 8. Eight consecutive
// threads take the chunk kc of eight consecutive rows: one 128-byte line
// of shared memory, no bank conflict. k at or past k_end reads as zero.
template <int NT>
__device__ __forceinline__ void load_b(float* dst,
                                       const float* __restrict__ bt,
                                       int64_t ldt, int64_t c0, int64_t k0,
                                       int64_t k_end, int tid) {
  const float* src = bt + (k0 / BK) * ldt * BK + c0 * BK;
  for (int e = tid; e < 8 * NT * KG; e += THREADS) {
    const int n = (e >> 6) * 8 + (e & 7);
    const int kc = ((e >> 5) & 1) * 4 + ((e >> 3) & 3);
    const int64_t gk = k0 + 4 * kc;
    int64_t bytes = (k_end - gk) * 4;
    bytes = bytes < 0 ? 0 : (bytes > 16 ? 16 : bytes);
    tc::cp_async16(
        tc::smem_u32(dst + ((n >> 3) * KG + kc) * 32 + (n & 7) * 4),
        bytes ? src + n * BK + 4 * kc : bt, (int)bytes);
  }
}

// B^T of a stage, landed at `hi`: hi part in place, lo part 8 NT BK floats
// beyond it
template <int NT>
__device__ __forceinline__ void split_b(float* hi_base, int tid) {
  float4* hi = reinterpret_cast<float4*>(hi_base);
  float4* lo = reinterpret_cast<float4*>(hi_base + 8 * NT * BK);
  for (int e = tid; e < 8 * NT * KG; e += THREADS) {
    const float4 v = hi[e];
    uint32_t h[4], l[4];
    tc::split_tf32(v.x, h[0], l[0]);
    tc::split_tf32(v.y, h[1], l[1]);
    tc::split_tf32(v.z, h[2], l[2]);
    tc::split_tf32(v.w, h[3], l[3]);
    hi[e] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                        __uint_as_float(h[2]), __uint_as_float(h[3]));
    lo[e] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                        __uint_as_float(l[2]), __uint_as_float(l[3]));
  }
  // generic-proxy writes, read next by wgmma (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The A fragments of a stage's four 8-deep steps into register buffer B,
// split (fp32) or as they are (bf16, exact in TF32); `row` is this
// thread's first A row in the tile, t = lane % 4.
template <typename T, bool kXT, int NT, int B>
__device__ __forceinline__ void load_a(const T* a, int row, int t,
                                       uint32_t (&ah)[2][BK / 8][4],
                                       uint32_t (&al)[2][BK / 8][4]) {
  constexpr int LD = Layout<T, kXT, NT>::A_LD;
#pragma unroll
  for (int ks = 0; ks < BK / 8; ++ks)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row + (e & 1) * 8;
      const int kk = ks * 8 + t + (e >> 1) * 4;
      const float v = as_f32(kXT ? a[kk * LD + r] : a[r * LD + kk]);
      if constexpr (sizeof(T) == 4)
        tc::split_tf32(v, ah[B][ks][e], al[B][ks][e]);
      else
        ah[B][ks][e] = __float_as_uint(v);
    }
}

// The products of one stage, A from register buffer B and B^T's hi and lo
// parts at the given shared addresses, into `part`, started from zero
// (small terms first); issued and committed, not waited for. A B exact in
// TF32 (kSplitB false: gram.cu's bf16 route) takes its hi part alone.
template <int NT, bool kSplitA, int B, bool kSplitB = true>
__device__ __forceinline__ void mma_stage(float (&part)[4 * NT],
                                          const uint32_t (&ah)[2][BK / 8][4],
                                          const uint32_t (&al)[2][BK / 8][4],
                                          uint32_t hi_addr,
                                          uint32_t lo_addr) {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int ks = 0; ks < BK / 8; ++ks) {
    // an 8-deep step reads two core-matrix columns
    const uint64_t dh = kmajor_desc(hi_addr + ks * 256);
    if constexpr (kSplitA)
      tc::wgmma_tf32<NT>(part, al[B][ks], dh, ks > 0);
    if constexpr (kSplitB)
      tc::wgmma_tf32<NT>(part, ah[B][ks], kmajor_desc(lo_addr + ks * 256),
                         kSplitA || ks > 0);
    tc::wgmma_tf32<NT>(part, ah[B][ks], dh, kSplitA || kSplitB || ks > 0);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void mma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// wt = w^T in BK-deep tiles (element (col, k) at (k / BK) ldt BK + col BK +
// k % BK) from w (d, c) row-major, zero at columns past c and rows past d:
// the B of a launch whose B is w
__global__ void transpose_tiles_kernel(const float* __restrict__ w,
                                       float* __restrict__ wt, int64_t d,
                                       int64_t c, int64_t ldt,
                                       int64_t size) {
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       e < size; e += (int64_t)gridDim.x * blockDim.x) {
    const int64_t k = e / (ldt * BK) * BK + e % BK;
    const int64_t col = e / BK % ldt;
    wt[e] = col < c && k < d ? w[k * c + col] : 0.f;
  }
}

inline bool aligned16(const void* p, int64_t ld_bytes) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld_bytes % 16 == 0;
}

}  // namespace tf32
