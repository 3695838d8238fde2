// Z = sqrt(2/D) cos(X W + b), X (n, d) fp32 or bf16 row-major, W (d, D)
// fp32 row-major, b (D,) fp32, Z (n, D) fp32.
//
// Replaces the TPU kernel src/repro/kernels/rf_map/rf_map.py::rf_map_pallas
// (_rf_kernel). In the port it is the random-feature expansion of
// skylark.cg_solve (rf_dim > 0) and skylark.random_features.
//
// Bound on the H100: operations. 2 n d D flops (plus n D cosines) against
// writing the n D outputs once; at d = 440 that is 220 flops per fp32
// byte written, eleven times the card's fp32 balance point, so the
// CUDA-core fp32 rate bounds it.
//
// Design: one block owns a 128 x 128 tile of Z and walks the whole
// d-reduction itself (gemm_nn_kernel), where the TPU grid revisited the
// tile across an in-order k axis. The epilogue adds b, takes cosf (the
// accurate one: fast-math __cosf is wrong at the |XW + b| of tens these
// features reach) and scales by sqrt(2/D) of the true D, in registers, so
// Z is written once and never read back.
#include "fp32_tiles.cuh"

using namespace fp32_tiles;

template <typename T>
static void launch(const void* x, const float* w, const float* b, float* z,
                   int64_t n, int64_t d, int64_t dd, float scale,
                   cudaStream_t stream) {
  dim3 grid((unsigned)ceil_div(n, BM), (unsigned)ceil_div(dd, BN), 1);
  gemm_nn_kernel<T, float, true><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), w, b, z, n, d, dd, scale);
}

// dtype of x: 0 = float32, 1 = bfloat16. Returns cudaGetLastError().
extern "C" int rf_map_launch(int dtype, const void* x, const void* w,
                             const void* b, void* z, int64_t n, int64_t d,
                             int64_t dd, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wp = static_cast<const float*>(w);
  const float* bp = static_cast<const float*>(b);
  float* zp = static_cast<float*>(z);
  if (dtype == 0)
    launch<float>(x, wp, bp, zp, n, d, dd, scale, s);
  else
    launch<__nv_bfloat16>(x, wp, bp, zp, n, d, dd, scale, s);
  return (int)cudaGetLastError();
}
