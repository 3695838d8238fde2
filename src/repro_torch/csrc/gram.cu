// G = A^T A, fp32 accumulation, A (n, d) fp32 or bf16 row-major.
//
// Replaces the TPU kernel src/repro/kernels/gram/gram.py::gram_pallas
// (_gram_kernel), used by elemental.gram and elemental.gram_svd.
//
// Bound on the H100: operations. 2 n d^2 FMA-flops (half of them with the
// symmetry used here) against n d reads; at d = 8,096 that is ~4,000 flops
// per byte, far above the card's fp32 balance point (67 TFLOP/s over
// 3.35 TB/s = 20 flops per byte). Without TF32 the rate to beat is the
// CUDA-core fp32 peak.
//
// Design: the TPU grid walked the row axis in order and accumulated into a
// resident tile. Here one block owns a 128 x 128 output tile and walks the
// rows itself (fp32_tiles.cuh); only tiles on or above the diagonal run,
// each writing its mirror. The wrapper splits the rows into `slabs` fixed
// slabs when those tiles cannot fill the card (d = 440 gives 10), and in
// any case so that no slab exceeds 65,536 rows: one fp32 accumulator over
// 1,048,576 rows of a growing diagonal rounds past the tolerance. Each
// slab writes its own partial Gram and a second kernel sums them in slab
// order, so results repeat bit for bit (no atomics).
#include "fp32_tiles.cuh"

using namespace fp32_tiles;

template <typename T>
static void launch(const void* a, float* part, float* out, int64_t n,
                   int64_t d, int slabs, cudaStream_t stream) {
  const int64_t tiles = ceil_div(d, BM);
  const int64_t slab_rows = ceil_div(ceil_div(n, slabs), BK) * BK;
  dim3 grid((unsigned)tiles, (unsigned)tiles, (unsigned)slabs);
  float* dst = slabs == 1 ? out : part;
  gemm_tn_kernel<T, T, true><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(a), dst, n, d, d,
      slab_rows);
  if (slabs > 1)
    sum_slabs_kernel<<<sum_slabs_blocks(d * d), 256, 0, stream>>>(
        part, out, d * d, slabs);
}

// dtype: 0 = float32, 1 = bfloat16. part holds slabs * d * d floats when
// slabs > 1 (unused otherwise). Returns cudaGetLastError().
extern "C" int gram_launch(int dtype, const void* a, void* part, void* out,
                           int64_t n, int64_t d, int slabs, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch<float>(a, static_cast<float*>(part), static_cast<float*>(out), n,
                  d, slabs, s);
  else
    launch<__nv_bfloat16>(a, static_cast<float*>(part),
                          static_cast<float*>(out), n, d, slabs, s);
  return (int)cudaGetLastError();
}
