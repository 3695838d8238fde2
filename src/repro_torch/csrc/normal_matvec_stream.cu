// w -> X^T (X w) for one column w, in one pass over X. X (n, d) fp32 or
// bf16 row-major with d <= 8,192, w (d, 1) fp32, result (d, 1) fp32.
// normal_matvec.cu takes every other call.
//
// Replaces no TPU kernel. The JAX package computes the Lanczos operator
// of elemental.truncated_svd with XLA's two products
// (src/repro/core/backends/jax_backend.py _gram_matvec), and the port did
// the same with two cuBLAS GEMVs a step: X read twice. This route was
// added so that a step reads X once.
//
// Bound on the H100: bytes. A call reads X once (n d elements) and does
// 4 n d c flops on the CUDA cores: at c = 1, 2 flops per fp32 byte
// against the card's 20 (67 TFLOP/s over 3.35 TB/s), so X's bytes bound
// it up to c ~ 20 (10 in bf16). At the Lanczos cell's 2,059,195 x 8,096 x
// 1 that is 19.9 ms of bytes against 1 ms of FMAs; cuBLAS's two passes,
// each at 92 % of HBM, took 43.4 ms.
//
// The sum a block carries is d x c fp32, and it lives in registers
// beside the thread's share of w. That, not the operations, sets the top
// c. A row of up to 8,192 is spread over 256 consumer threads, K = 32
// columns each: w's columns, the running sums and the current group's
// sums (see below) take K c registers each. A block of nine warps puts
// three on one of the SM's four 16,384-register quarters, so a thread
// holds at most 168 registers: 3 K c = 96 at c = 1 fits with addresses
// and loop state; a first design that held the row's K values too
// spilled 92-108 bytes at K c = 64. At the Lanczos cell's d = 8,096, c =
// 2 would need 192: c = 1 is the top. (Rows of at most 4,096 would hold
// c = 2, but no caller has it: Lanczos steps on one column, CG on 147.)
//
// Design (the hopper-kernels guide's shape for a bytes-bound kernel):
//   * one block to an SM (a ring of up to 192 KB); grid = row slabs, each
//     a contiguous range of at most 65,536 rows (kernels/device.py
//     MAX_SLAB_ROWS: the partials' fp32 row chains stay short), as many
//     as fill whole waves (132 at the cell's shape, 15,600 rows each);
//   * one producer warp lands a stage of whole rows, about 32 KB and one
//     range of bytes, with a 1-D bulk copy (cp.async.bulk, TMA) into a
//     ring of up to 8 stages (6 of one row at d = 8,096), completing on
//     the stage's `full` mbarrier; rows whose bytes are not 16-byte
//     aligned (fp32 d % 4, bf16 d % 8, or a base off 16 bytes) are copied
//     by the warp's lanes instead, each row padded with zeros to a
//     multiple of 16 bytes;
//   * eight consumer warps hold w and the sums, and read every row
//     together: each thread its 16-byte chunks, 32 columns' worth (a
//     narrower row leaves the upper chunks off). Each thread forms its
//     chunks' partial dot x_r . w, the warp adds them by an xor butterfly
//     (every lane ends with the same bits), the block adds its warps'
//     sums through shared memory in warp order behind a named barrier;
//     then y_r x_r, the row read again from shared memory, joins the
//     thread's group sums, which join its running sums every GROUP_ROWS =
//     128 rows. With one running sum over a slab's 15,600 rows the
//     Lanczos cell's v_err and eig_res read 2.5 x what cuBLAS's two passes
//     gave (v_err 6.6e-6 to 7.8e-6 against a limit of 1.1e-5): the chain's
//     rounding grows with its length, and groups cut it to about 128 +
//     122 additions. A stage is released on its `empty` mbarrier by each
//     consumer warp;
//   * each block writes its sum as one partial; sum_slabs_kernel adds the
//     partials in order. No atomics: a result repeats bit for bit;
//   * fp32 FMAs on the CUDA cores throughout: no TF32 (the callers state
//     fp32 with TF32 off, and one-pass TF32 misses the 3e-5 tolerance).
#include "fp32_tiles.cuh"
#include "hopper_bf16.cuh"

namespace {

constexpr int CONSUMERS = 8;                    // consumer warps
constexpr int THREADS = 32 * (CONSUMERS + 1);   // and one producer warp
constexpr int K = 32;                           // columns a thread
constexpr int64_t MAX_D = (int64_t)K * 32 * CONSUMERS;
constexpr int GROUP_ROWS = 128;                 // rows a group sum holds
constexpr int MAX_STAGES = 8;
constexpr int64_t STAGE_BYTES = 32 * 1024;
constexpr int64_t RING_BYTES = 192 * 1024;

__device__ __forceinline__ void load16(const float* p, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

// a bf16 is the top half of the fp32 of the same value: element 2 i sits
// in the low half of word i
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* v) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const uint32_t h[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(h[i] << 16);
    v[2 * i + 1] = __uint_as_float(h[i] & 0xffff0000u);
  }
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() {
  return 0.f;
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from device
// memory into shared memory, completing on the mbarrier `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Slab blockIdx.x is rows [blockIdx.x slab_rows, +slab_rows) of X, and
// writes partial blockIdx.x. A thread holds CH = K / V 16-byte chunks of
// a row. pitch: a row's elements in shared memory (d rounded up to 16
// bytes).
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    nm_stream_kernel(const T* __restrict__ x, const float* __restrict__ w,
                     float* __restrict__ part, int64_t n, int64_t d,
                     int64_t pitch, int64_t slab_rows, int rows_per_stage,
                     int stages, bool bulk) {
  constexpr int V = 16 / sizeof(T);
  constexpr int CH = K / V;
  constexpr int TEAM_THREADS = 32 * CONSUMERS;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES], empty[MAX_STAGES];
  __shared__ float red[2][CONSUMERS];
  T* ring = reinterpret_cast<T*>(smem);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t row_begin = (int64_t)blockIdx.x * slab_rows;
  const int64_t row_end = row_begin + slab_rows < n ? row_begin + slab_rows
                                                    : n;
  const int64_t steps =
      row_end > row_begin ? (row_end - row_begin + rows_per_stage - 1) /
                                rows_per_stage
                          : 0;
  const int64_t stage_elems = (int64_t)rows_per_stage * pitch;

  if (threadIdx.x < stages) {
    hop::mbar_init(hop::smem_u32(&full[threadIdx.x]), 32);
    hop::mbar_init(hop::smem_u32(&empty[threadIdx.x]), CONSUMERS);
  }
  hop::fence_mbar_init();
  __syncthreads();

  if (warp == CONSUMERS) {
    // the producer: stage `it` into slot it % stages once it is released
    int st = 0;
    uint32_t phase = 0;
    for (int64_t it = 0; it < steps; ++it) {
      if (it >= stages) hop::mbar_wait(hop::smem_u32(&empty[st]), phase ^ 1);
      const int64_t r0 = row_begin + it * rows_per_stage;
      const int64_t rows = row_end - r0 < rows_per_stage ? row_end - r0
                                                         : rows_per_stage;
      T* dst = ring + st * stage_elems;
      const uint32_t bar = hop::smem_u32(&full[st]);
      if (bulk) {
        // pitch == d here
        if (lane == 0) {
          const uint32_t bytes = (uint32_t)(rows * d * sizeof(T));
          hop::mbar_expect_tx(bar, bytes);
          bulk_load(hop::smem_u32(dst), x + r0 * d, bytes, bar);
        } else {
          hop::mbar_arrive(bar);
        }
      } else {
        for (int64_t e = lane; e < rows * pitch; e += 32) {
          const int64_t r = e / pitch, col = e % pitch;
          dst[e] = col < d ? x[(r0 + r) * d + col] : zero<T>();
        }
        hop::mbar_arrive(bar);
      }
      if (++st == stages) {
        st = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // this consumer thread, 0 .. 255, written from warp and lane: taken as
  // threadIdx.x the bf16 kernel read 6.8 ms in place of 5.6 at 1,029,598 x
  // 8,096 on the H100 (fp32 unchanged)
  const int lt = (warp % CONSUMERS) * 32 + lane;
  // chunk i of a row holds columns (i TEAM_THREADS + lt) V .. + V - 1
  // w's columns, the running sums and the sums of the current group of
  // GROUP_ROWS rows, which join the running sums when the group is full
  float q[K], acc[K], grp[K];
#pragma unroll
  for (int i = 0; i < CH; ++i)
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int64_t col = ((int64_t)i * TEAM_THREADS + lt) * V + e;
      q[i * V + e] = col < d ? w[col] : 0.f;
      acc[i * V + e] = grp[i * V + e] = 0.f;
    }

  int st = 0, rb = 0, grouped = 0;
  uint32_t phase = 0;
  for (int64_t it = 0; it < steps; ++it) {
    hop::mbar_wait(hop::smem_u32(&full[st]), phase);
    const int64_t r0 = row_begin + it * rows_per_stage;
    const int rows = (int)(row_end - r0 < rows_per_stage ? row_end - r0
                                                         : rows_per_stage);
    const T* stage = ring + st * stage_elems;
    for (int r = 0; r < rows; ++r) {
      const T* row = stage + r * pitch;
      float y = 0.f;
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const int64_t col0 = ((int64_t)i * TEAM_THREADS + lt) * V;
        if (col0 < pitch) {
          float xv[V];
          load16(row + col0, xv);
#pragma unroll
          for (int e = 0; e < V; ++e) y = fmaf(xv[e], q[i * V + e], y);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        y += __shfl_xor_sync(0xffffffffu, y, off);
      if (lane == 0) red[rb][warp] = y;
      hop::bar_sync(1, TEAM_THREADS);
      y = red[rb][0];
#pragma unroll
      for (int v = 1; v < CONSUMERS; ++v) y += red[rb][v];
      rb ^= 1;
      // y_r x_r joins the group's sums, the row read again from shared
      // memory (holding it beside three sets of K registers would spill)
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const int64_t col0 = ((int64_t)i * TEAM_THREADS + lt) * V;
        if (col0 < pitch) {
          float xv[V];
          load16(row + col0, xv);
#pragma unroll
          for (int e = 0; e < V; ++e)
            grp[i * V + e] = fmaf(y, xv[e], grp[i * V + e]);
        }
      }
      if (++grouped == GROUP_ROWS) {
        grouped = 0;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          acc[k] += grp[k];
          grp[k] = 0.f;
        }
      }
    }
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(hop::smem_u32(&empty[st]));
    if (++st == stages) {
      st = 0;
      phase ^= 1;
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] += grp[k];

  float* out = part + (int64_t)blockIdx.x * d;
#pragma unroll
  for (int i = 0; i < CH; ++i)
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int64_t col = ((int64_t)i * TEAM_THREADS + lt) * V + e;
      if (col < d) out[col] = acc[i * V + e];
    }
}

// The ring: stages of as many whole rows as fit STAGE_BYTES (at least
// one), as many stages as fit RING_BYTES (at most MAX_STAGES; at least 6,
// since a row is at most 32 KB).
template <typename T>
int launch(const T* x, const float* w, float* part, float* out, int64_t n,
           int64_t d, int64_t slab_rows, int slabs, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (n < 1 || d < 1 || d > MAX_D || slabs < 1 || slab_rows < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t pitch = fp32_tiles::ceil_div(d, V) * V;
  const int64_t row_bytes = pitch * (int64_t)sizeof(T);
  const int64_t per_stage =
      STAGE_BYTES / row_bytes > 1 ? STAGE_BYTES / row_bytes : 1;
  const int64_t stages = RING_BYTES / (per_stage * row_bytes) < MAX_STAGES
                             ? RING_BYTES / (per_stage * row_bytes)
                             : MAX_STAGES;
  const size_t bytes = (size_t)(stages * per_stage * row_bytes);
  const bool bulk = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    (d * (int64_t)sizeof(T)) % 16 == 0;
  cudaError_t err = cudaFuncSetAttribute(
      nm_stream_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  float* dst = slabs == 1 ? out : part;
  nm_stream_kernel<T><<<slabs, THREADS, bytes, stream>>>(
      x, w, dst, n, d, pitch, slab_rows, (int)per_stage, (int)stages, bulk);
  err = cudaGetLastError();
  if (err != cudaSuccess || slabs == 1) return (int)err;
  fp32_tiles::sum_slabs_kernel<<<fp32_tiles::sum_slabs_blocks(d), 256, 0,
                                 stream>>>(part, out, d, slabs);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype of x: 0 = float32, 1 = bfloat16. c must be 1 and d at most 8,192.
// Slabs of slab_rows rows (the last may be shorter). part: slabs d floats
// of scratch when slabs > 1 (unused otherwise). Returns a cudaError_t;
// cudaErrorInvalidValue (1), launching nothing, for a shape it does not
// take.
extern "C" int normal_matvec_stream_launch(int dtype, const void* x,
                                           const void* w, void* part,
                                           void* out, int64_t n, int64_t d,
                                           int64_t c, int64_t slab_rows,
                                           int slabs, void* stream) {
  if (c != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wp = static_cast<const float*>(w);
  float* pp = static_cast<float*>(part);
  float* op = static_cast<float*>(out);
  if (dtype == 0)
    return launch<float>(static_cast<const float*>(x), wp, pp, op, n, d,
                         slab_rows, slabs, s);
  return launch<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(x), wp, pp,
                               op, n, d, slab_rows, slabs, s);
}
