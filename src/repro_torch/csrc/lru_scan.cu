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
// rate bounds it by three orders of magnitude, 0.24 ms at the main path's
// 4 x 4,096 x 4,096.
//
// The kernel this replaces gave each thread one channel and let it issue
// its own loads 16 steps ahead: B * W threads are few for the card (16,384
// at the main shape, about four warps an SM), and their 2 MB in flight
// left it at 42 % of the byte bound. This one keeps the arithmetic (one
// thread per (batch, channel) walks time with h = fmaf(a, h, b), so its
// results are the same bits) and feeds it from shared memory:
//   * a block owns 32 channels of one batch row: warp 0 scans them, warp 1
//     fills a ring of STAGES tiles of T_STEPS steps x 32 channels of a and
//     b with cp.async.bulk copies (one per row of a tile: 128 contiguous
//     bytes in fp32) that complete on the stage's `full` mbarrier; the
//     scan releases a stage on its `empty` mbarrier. 48 KB a block, four
//     blocks an SM, so each SM keeps about 150 KB of reads in flight;
//   * each step of the scan reads its a and b from shared memory (32
//     consecutive words) and writes the warp's 128 contiguous bytes of h;
//   * bulk copies need 16-byte aligned rows (W * element size a multiple
//     of 16 and 16-byte aligned a and b); otherwise the producer warp
//     copies element by element into the same ring. Any S and W: a short
//     last tile and a short last channel group are guarded.
// At the main shape it runs 0.28 ms, 85 % of the byte bound, where a
// torch.add that moves the same 12 bytes an element takes 0.26 ms
// (NVIDIA H100 80GB HBM3, 700 W).
//
// Reverse (the `REVERSE` template flag, the autograd backward's launch):
// time runs from S - 1 down to 0 and the ring fetches tiles last-first,
// computing out_t = a_{t+1} out_{t+1} + b_t with the carry h0 entering
// the last step unscaled (out_{S-1} = h0 + b_{S-1}). With b the gradient
// of the states and h0 zero that is the adjoint of the forward scan,
// lambda_t = g_t + a_{t+1} lambda_{t+1}: the step multiplies by the a it
// read one step before, so a needs no shifted or flipped copy. It is the
// counterpart of JAX differentiating jax.lax.associative_scan (the JAX
// package has no backward kernel). Full tiles are unrolled in both
// directions: rolled, the reverse scan took 11.8 ms at 2 x 4,096 x 4,096,
// unrolled 0.26 ms, where a torch.add moving the same bytes takes 0.13 ms
// (NVIDIA H100 80GB HBM3, 700 W; 256 blocks at B = 2).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_mma.cuh"

namespace {

constexpr int CH = 32;          // channels of a block: one scanning warp
constexpr int T_STEPS = 32;     // time steps of a ring tile
constexpr int STAGES = 6;
constexpr int THREADS = 64;     // warp 0 scans, warp 1 fills the ring

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 st;\n"
      "mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(bar)
      : "memory");
}

// arrive, and expect `bytes` more of asynchronous copies in this phase
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 st;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// `bytes` (a multiple of 16) global -> shared, completing on `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// one time step r of a ring tile: forward h = a_r h + b_r; reverse h =
// a_{r+1} h + b_r, with a_{r+1} kept in `ap` from the step before
template <bool REVERSE, typename T>
__device__ __forceinline__ void step(int r, const T* ta, const T* tb,
                                     float* o, int64_t w, float& h,
                                     float& ap) {
  if (REVERSE) {
    h = fmaf(ap, h, to_f32(tb[r * CH]));
    ap = to_f32(ta[r * CH]);
  } else {
    h = fmaf(to_f32(ta[r * CH]), h, to_f32(tb[r * CH]));
  }
  o[r * w] = h;
}

template <typename T, bool REVERSE>
__global__ void __launch_bounds__(THREADS)
    lru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                    const float* __restrict__ h0, float* __restrict__ out,
                    int64_t s, int64_t w, bool bulk) {
  // ring stage i: a tile [T_STEPS][CH], then b's
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  constexpr int TILE = T_STEPS * CH;
  T* ring = reinterpret_cast<T*>(smem);

  const int lane = threadIdx.x & 31;
  const int64_t c0 = (int64_t)blockIdx.x * CH;
  const int nch = (int)(w - c0 < CH ? w - c0 : CH);
  const int64_t base = (int64_t)blockIdx.y * s * w + c0;
  const int64_t tiles = (s + T_STEPS - 1) / T_STEPS;

  if (threadIdx.x < STAGES) {
    mbar_init(tc::smem_u32(&full[threadIdx.x]), 32);
    mbar_init(tc::smem_u32(&empty[threadIdx.x]), 32);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  if (threadIdx.x >= 32) {
    // the producer: the i-th tile of the scan's order (tile i, or tile
    // tiles - 1 - i in reverse) into stage i % STAGES once the scan
    // released it
    int st = 0;
    uint32_t phase = 0;
    for (int64_t i = 0; i < tiles; ++i) {
      if (i >= STAGES) mbar_wait(tc::smem_u32(&empty[st]), phase ^ 1);
      const int64_t ti = REVERSE ? tiles - 1 - i : i;
      const int rows = (int)(s - ti * T_STEPS < T_STEPS ? s - ti * T_STEPS
                                                         : T_STEPS);
      T* dst = ring + (int64_t)st * 2 * TILE;
      const int64_t src0 = base + ti * T_STEPS * w;
      const uint32_t bar = tc::smem_u32(&full[st]);
      if (bulk) {
        // a's rows, then b's: lane l copies rows l, l + 32, ... of the
        // 2 * rows
        const uint32_t row_bytes = (uint32_t)(nch * sizeof(T));
        const int mine = (2 * rows - lane + 31) / 32;
        if (mine)
          mbar_arrive_tx(bar, mine * row_bytes);
        else
          mbar_arrive(bar);
        for (int r = lane; r < 2 * rows; r += 32) {
          const int tr = r % rows;
          const T* src = (r < rows ? a : b) + src0 + tr * w;
          bulk_copy(tc::smem_u32(dst + (r < rows ? 0 : TILE) + tr * CH),
                    src, row_bytes, bar);
        }
      } else {
        for (int e = lane; e < 2 * rows * nch; e += 32) {
          const int r = e / nch;
          const int tr = r % rows;
          const int c = e % nch;
          dst[(r < rows ? 0 : TILE) + tr * CH + c] =
              (r < rows ? a : b)[src0 + tr * w + c];
        }
        mbar_arrive(bar);
      }
      if (++st == STAGES) {
        st = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // the scan: one thread per channel, time in order (or reversed)
  const bool live = lane < nch;
  float h = live ? h0[(int64_t)blockIdx.y * w + c0 + lane] : 0.f;
  float ap = 1.f;   // reverse: the a of the step after this one
  float* op = out + base + lane;
  int st = 0;
  uint32_t phase = 0;
  for (int64_t i = 0; i < tiles; ++i) {
    mbar_wait(tc::smem_u32(&full[st]), phase);
    const int64_t ti = REVERSE ? tiles - 1 - i : i;
    const T* ta = ring + (int64_t)st * 2 * TILE + lane;
    const T* tb = ta + TILE;
    float* o = op + ti * T_STEPS * w;
    if (live) {
      const int rows = (int)(s - ti * T_STEPS < T_STEPS ? s - ti * T_STEPS
                                                         : T_STEPS);
      // a full tile unrolled (its 64 shared loads issue ahead of the
      // multiply-add chain), a short last one rolled
      if (rows == T_STEPS) {
#pragma unroll
        for (int k = 0; k < T_STEPS; ++k)
          step<REVERSE>(REVERSE ? T_STEPS - 1 - k : k, ta, tb, o, w, h, ap);
      } else {
        for (int k = 0; k < rows; ++k)
          step<REVERSE>(REVERSE ? rows - 1 - k : k, ta, tb, o, w, h, ap);
      }
    }
    mbar_arrive(tc::smem_u32(&empty[st]));
    if (++st == STAGES) {
      st = 0;
      phase ^= 1;
    }
  }
}

template <typename T, bool REVERSE>
int launch(const void* a, const void* b, const float* h0, float* out,
           int64_t batch, int64_t s, int64_t w, cudaStream_t stream) {
  const size_t bytes = (size_t)STAGES * 2 * T_STEPS * CH * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      lru_scan_kernel<T, REVERSE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const bool bulk = reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
                    (w * (int64_t)sizeof(T)) % 16 == 0;
  dim3 grid((unsigned)((w + CH - 1) / CH), (unsigned)batch, 1);
  lru_scan_kernel<T, REVERSE><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), h0, out, s, w,
      bulk);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype of a and b: 0 = float32, 1 = bfloat16. reverse: 0 runs time
// forward, 1 backward (see the top). batch <= 65,535 (the wrapper
// checks). Returns a cudaError_t.
extern "C" int lru_scan_launch(int dtype, int reverse, const void* a,
                               const void* b, const void* h0, void* out,
                               int64_t batch, int64_t s, int64_t w,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* hp = static_cast<const float*>(h0);
  float* op = static_cast<float*>(out);
  if (dtype == 0)
    return reverse ? launch<float, true>(a, b, hp, op, batch, s, w, st)
                   : launch<float, false>(a, b, hp, op, batch, s, w, st);
  return reverse
             ? launch<__nv_bfloat16, true>(a, b, hp, op, batch, s, w, st)
             : launch<__nv_bfloat16, false>(a, b, hp, op, batch, s, w, st);
}
