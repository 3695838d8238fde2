// Gated linear recurrence h_t = a_t * h_{t-1} + b_t with an h0 carry:
// a, b (B, S, W) fp32 or bf16 row-major (both the same type), h0 (B, W)
// fp32, out (B, S, W) fp32 holding every state.
//
// Replaces the TPU kernel
// src/repro/kernels/lru_scan/lru_scan.py::lru_scan_pallas (_lru_kernel).
// In the port it is the prefill recurrence of every RG-LRU layer
// (repro_torch/nn/rglru.py), which the JAX package computes with
// jax.lax.associative_scan.
//
// Bound on the H100: bytes. One multiply-add per element against reading
// a and b and writing h (12 bytes per element in fp32): the card's memory
// rate bounds it by three orders of magnitude.
//
// Design: one thread per (batch, channel) walks time in order with the
// carry in a register, where the TPU grid walked time in (bt, bw) tiles
// with the carry in VMEM scratch. Neighbouring threads own neighbouring
// channels, so every read and write of a warp is one contiguous run of
// W. Time goes in steps of UNROLL: the loads of a step are all issued
// before the first multiply-add needs them, so each thread keeps
// 2 * UNROLL loads in flight; with one warp per 32 channels that is what
// hides the memory latency, since B * W threads are few for the card
// (16,384 at the main path's 4 x 4,096). Any S and W: the ragged ends are
// guarded, no divisor search.
#include "fp32_tiles.cuh"

using fp32_tiles::ceil_div;
using fp32_tiles::to_f32;

namespace {

constexpr int THREADS = 64;
constexpr int UNROLL = 16;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    lru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                    const float* __restrict__ h0, float* __restrict__ out,
                    int64_t s, int64_t w) {
  const int64_t c = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (c >= w) return;
  const int64_t base = (int64_t)blockIdx.y * s * w + c;
  const T* ap = a + base;
  const T* bp = b + base;
  float* op = out + base;
  float h = h0[(int64_t)blockIdx.y * w + c];
  for (int64_t t0 = 0; t0 < s; t0 += UNROLL) {
    float av[UNROLL], bv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t t = t0 + u;
      av[u] = 0.f;
      bv[u] = 0.f;
      if (t < s) {
        av[u] = to_f32(ap[t * w]);
        bv[u] = to_f32(bp[t * w]);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t t = t0 + u;
      if (t < s) {
        h = fmaf(av[u], h, bv[u]);
        op[t * w] = h;
      }
    }
  }
}

template <typename T>
void launch(const void* a, const void* b, const float* h0, float* out,
            int64_t batch, int64_t s, int64_t w, cudaStream_t stream) {
  dim3 grid((unsigned)ceil_div(w, THREADS), (unsigned)batch, 1);
  lru_scan_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), h0, out, s, w);
}

}  // namespace

// dtype of a and b: 0 = float32, 1 = bfloat16. batch <= 65,535 (the
// wrapper checks). Returns cudaGetLastError().
extern "C" int lru_scan_launch(int dtype, const void* a, const void* b,
                               const void* h0, void* out, int64_t batch,
                               int64_t s, int64_t w, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* hp = static_cast<const float*>(h0);
  float* op = static_cast<float*>(out);
  if (dtype == 0)
    launch<float>(a, b, hp, op, batch, s, w, st);
  else
    launch<__nv_bfloat16>(a, b, hp, op, batch, s, w, st);
  return (int)cudaGetLastError();
}
