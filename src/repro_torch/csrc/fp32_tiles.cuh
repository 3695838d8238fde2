// Helpers the port's kernels share: bf16 widening (to_f32), ceil_div, and
// the fixed-order sum of a split reduction's partials (gram.cu,
// normal_matvec.cu), so that results repeat bit for bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fp32_tiles {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
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

inline int sum_slabs_blocks(int64_t size) {
  const int64_t blocks = (size + 255) / 256;
  return (int)(blocks < 4096 ? (blocks > 0 ? blocks : 1) : 4096);
}

inline int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

}  // namespace fp32_tiles
