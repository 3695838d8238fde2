// w -> X^T (X w), fp32 accumulation. X (n, d) fp32 or bf16 row-major,
// w (d, c) fp32, result (d, c) fp32. Any d: there is no cap and no other
// path on the card.
//
// Replaces the TPU kernel
// src/repro/kernels/normal_matvec/normal_matvec.py::normal_matvec_pallas
// (_nm_kernel): the CG iteration of skylark.cg_solve.
//
// Bound on the H100: operations. Each call does 4 n d c flops against the
// n d elements of X; at c = 147 that is 147 flops per fp32 byte, seven
// times the card's fp32 balance point (67 TFLOP/s over 3.35 TB/s), so the
// CUDA-core fp32 rate bounds it, not HBM.
//
// Design: the TPU kernel held one (bm, d) row band in VMEM and did both
// products on it, accumulating the (d, c) result across a grid that ran
// in order. A block here cannot hold a (d, c) accumulator at d = 10,000
// (5.9 MB), so the two products are two launches, and X is read twice:
//   1. t = X w        (n, c): 128 x 128 tiles, the d-reduction inside the
//                      block (gemm_nn_kernel);
//   2. out = X^T t    (d, c): 128 x 128 tiles, the n-reduction split into
//                      `slabs` fixed row slabs (d = 10,000 and c = 147
//                      give only 158 tiles; no slab exceeds 65,536 rows,
//                      which bounds fp32 rounding), each slab writing a
//                      partial that a third kernel sums in slab order.
//                      No atomics.
#include "fp32_tiles.cuh"

using namespace fp32_tiles;

template <typename T>
static void launch(const void* x, const float* w, float* t, float* part,
                   float* out, int64_t n, int64_t d, int64_t c, int slabs,
                   cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  dim3 grid_t((unsigned)ceil_div(n, BM), (unsigned)ceil_div(c, BN), 1);
  gemm_nn_kernel<T, float, false><<<grid_t, THREADS, 0, stream>>>(
      xp, w, nullptr, t, n, d, c, 1.f);
  const int64_t slab_rows = ceil_div(ceil_div(n, slabs), BK) * BK;
  dim3 grid_o((unsigned)ceil_div(c, BN), (unsigned)ceil_div(d, BM),
              (unsigned)slabs);
  float* dst = slabs == 1 ? out : part;
  gemm_tn_kernel<T, float, false><<<grid_o, THREADS, 0, stream>>>(
      xp, t, dst, n, d, c, slab_rows);
  if (slabs > 1)
    sum_slabs_kernel<<<sum_slabs_blocks(d * c), 256, 0, stream>>>(
        part, out, d * c, slabs);
}

// dtype of x: 0 = float32, 1 = bfloat16. t holds n * c floats, part
// slabs * d * c floats when slabs > 1 (unused otherwise).
// Returns cudaGetLastError().
extern "C" int normal_matvec_launch(int dtype, const void* x, const void* w,
                                    void* t, void* part, void* out,
                                    int64_t n, int64_t d, int64_t c,
                                    int slabs, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wp = static_cast<const float*>(w);
  float* tp = static_cast<float*>(t);
  float* pp = static_cast<float*>(part);
  float* op = static_cast<float*>(out);
  if (dtype == 0)
    launch<float>(x, wp, tp, pp, op, n, d, c, slabs, s);
  else
    launch<__nv_bfloat16>(x, wp, tp, pp, op, n, d, c, slabs, s);
  return (int)cudaGetLastError();
}
