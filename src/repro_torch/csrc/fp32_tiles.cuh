// Shared building blocks of the port's three fp32 matrix-product kernels
// (gram.cu, normal_matvec.cu, rf_map.cu).
//
// One block computes a 128 x 128 tile of an fp32 output with 256 threads;
// each thread owns an 8 x 8 register tile, split into four 4 x 4 quadrants
// (rows ty*4 and 64+ty*4, columns tx*4 and 64+tx*4) so that the float4
// reads of the shared panels are free of bank conflicts. The reduction
// axis is walked inside the block in steps of BK = 16, one panel of each
// operand staged in shared memory per step.
//
// Arithmetic is IEEE fp32 FMA throughout (no tensor cores, so no TF32):
// the port's tolerances against the fp32 reference are 1e-5 .. 3e-5.
// bf16 operands are widened to fp32 as they are loaded, as the TPU kernels
// do with .astype(float32).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fp32_tiles {

constexpr int BM = 128;      // output tile rows
constexpr int BN = 128;      // output tile columns
constexpr int BK = 16;       // reduction step staged in shared memory
constexpr int PAD = 4;       // keeps float4 alignment, spreads banks
constexpr int THREADS = 256;

typedef float Panel[BK][BM + PAD];

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// s[r][c] = m[k0 + r][c0 + c] for a row-major matrix with leading
// dimension ld; rows at or past k_end and columns at or past cols read
// as zero (zero rows add nothing to a product over the reduction axis).
// A warp reads 32 consecutive columns of one row: coalesced.
template <typename T>
__device__ __forceinline__ void load_rows(Panel& s, const T* __restrict__ m,
                                          int64_t ld, int64_t k0,
                                          int64_t k_end, int64_t c0,
                                          int64_t cols, int tid) {
  const int c = tid & 127;
  const int r0 = tid >> 7;
  const int64_t gc = c0 + c;
#pragma unroll
  for (int q = 0; q < BK / 2; ++q) {
    const int r = r0 + 2 * q;
    const int64_t gr = k0 + r;
    float v = 0.f;
    if (gr < k_end && gc < cols) v = to_f32(m[gr * ld + gc]);
    s[r][c] = v;
  }
}

// s[kk][r] = m[r0 + r][k0 + kk]: a 128-row, BK-column slice of a
// row-major matrix, stored transposed so the product loop reads it like
// load_rows' panels. Sixteen threads read one row's BK contiguous values.
template <typename T>
__device__ __forceinline__ void load_cols(Panel& s, const T* __restrict__ m,
                                          int64_t ld, int64_t r0,
                                          int64_t rows, int64_t k0,
                                          int64_t k_end, int tid) {
#pragma unroll
  for (int q = 0; q < (BM * BK) / THREADS; ++q) {
    const int e = tid + THREADS * q;
    const int kk = e & (BK - 1);
    const int r = e >> 4;
    const int64_t gr = r0 + r;
    const int64_t gk = k0 + kk;
    float v = 0.f;
    if (gr < rows && gk < k_end) v = to_f32(m[gr * ld + gk]);
    s[kk][r] = v;
  }
}

// acc[i][j] += sum_kk a[kk][row(i)] * b[kk][col(j)]
__device__ __forceinline__ void mma_panel(const Panel& a, const Panel& b,
                                          float (&acc)[8][8], int tx,
                                          int ty) {
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(&a[kk][ty * 4]);
    const float4 a1 = *reinterpret_cast<const float4*>(&a[kk][64 + ty * 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&b[kk][tx * 4]);
    const float4 b1 = *reinterpret_cast<const float4*>(&b[kk][64 + tx * 4]);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// Tile-local row / column of register acc[i][*] / acc[*][j].
__device__ __forceinline__ int tile_row(int i, int ty) {
  return (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
}
__device__ __forceinline__ int tile_col(int j, int tx) {
  return (j < 4 ? 0 : 64) + tx * 4 + (j & 3);
}

// C[M x N] = A^T B over reduction rows [k_begin, k_end), A (K x M) and
// B (K x N) row-major: both operands are read as row panels. The slab of
// blockIdx.z writes its own partial sum at out + z * M * N, so a split
// reduction is summed afterwards in a fixed order (sum_slabs), never by
// atomics. With symmetric (A == B, M == N) only tiles on or above the
// diagonal compute, and write their mirror image too.
template <typename TA, typename TB, bool kSymmetric>
__global__ void __launch_bounds__(THREADS)
    gemm_tn_kernel(const TA* __restrict__ a, const TB* __restrict__ b,
                   float* __restrict__ out, int64_t K, int64_t M, int64_t N,
                   int64_t slab_rows) {
  const int bi = blockIdx.y;       // output row tile
  const int bj = blockIdx.x;       // output column tile
  if (kSymmetric && bi > bj) return;
  __shared__ __align__(16) Panel as;
  __shared__ __align__(16) Panel bs;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int64_t m0 = (int64_t)bi * BM;
  const int64_t n0 = (int64_t)bj * BN;
  const int64_t k_begin = (int64_t)blockIdx.z * slab_rows;
  const int64_t k_end = k_begin + slab_rows < K ? k_begin + slab_rows : K;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int64_t k0 = k_begin; k0 < k_end; k0 += BK) {
    load_rows(as, a, M, k0, k_end, m0, M, tid);
    load_rows(bs, b, N, k0, k_end, n0, N, tid);
    __syncthreads();
    mma_panel(as, bs, acc, tx, ty);
    __syncthreads();
  }

  float* o = out + (int64_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t r = m0 + tile_row(i, ty);
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int64_t c = n0 + tile_col(j, tx);
      if (c >= N) continue;
      o[r * N + c] = acc[i][j];
      if (kSymmetric && bi != bj) o[c * N + r] = acc[i][j];
    }
  }
}

// out[e] = sum over s of part[s][e], s in increasing order: the fixed-order
// second pass of a split reduction, so results repeat bit for bit.
__global__ void sum_slabs_kernel(const float* __restrict__ part,
                                 float* __restrict__ out, int64_t size,
                                 int slabs) {
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < size;
       e += (int64_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < slabs; ++z) s += part[(int64_t)z * size + e];
    out[e] = s;
  }
}

// C[M x N] = A B with A (M x K) and B (K x N) row-major, the whole
// reduction inside the block. With kCos the epilogue applies
// scale * cos(acc + bias[col]) in registers before the one write of C.
template <typename TA, typename TB, bool kCos>
__global__ void __launch_bounds__(THREADS)
    gemm_nn_kernel(const TA* __restrict__ a, const TB* __restrict__ b,
                   const float* __restrict__ bias, float* __restrict__ out,
                   int64_t M, int64_t K, int64_t N, float scale) {
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int64_t n0 = (int64_t)blockIdx.y * BN;
  __shared__ __align__(16) Panel as;
  __shared__ __align__(16) Panel bs;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int64_t k0 = 0; k0 < K; k0 += BK) {
    load_cols(as, a, K, m0, M, k0, K, tid);
    load_rows(bs, b, N, k0, K, n0, N, tid);
    __syncthreads();
    mma_panel(as, bs, acc, tx, ty);
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int64_t c = n0 + tile_col(j, tx);
    if (c >= N) continue;
    const float bc = kCos ? bias[c] : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int64_t r = m0 + tile_row(i, ty);
      if (r >= M) continue;
      out[r * N + c] = kCos ? scale * cosf(acc[i][j] + bc) : acc[i][j];
    }
  }
}

inline int sum_slabs_blocks(int64_t size) {
  const int64_t blocks = (size + 255) / 256;
  return (int)(blocks < 4096 ? (blocks > 0 ? blocks : 1) : 4096);
}

inline int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

}  // namespace fp32_tiles
