// w -> X^T (X w), fp32 accumulation. X (n, d) fp32 or bf16 row-major,
// w (d, c) fp32, result (d, c) fp32. Any n, d and c: there is no cap and
// no other path on the card.
//
// Replaces the TPU kernel
// src/repro/kernels/normal_matvec/normal_matvec.py::normal_matvec_pallas
// (_nm_kernel): the CG iteration of skylark.cg_solve.
//
// Bound on the H100: operations. Each call does 4 n d c flops against the
// n d elements of X; at c = 147 that is 147 flops per fp32 byte. In fp32
// on the CUDA cores that is 92 ms at the main path's 1,048,576 x 10,000 x
// 147 (67 TFLOP/s); on the tensor cores in 3xTF32 (three TF32 products
// per product, see below) 37 ms (495 TFLOP/s / 3). Reading X twice,
// 84 GB, takes 25 ms: still below the operations.
//
// The kernel this replaces used 128 x 128 fp32 CUDA-core tiles for both
// products: at c = 147 it computed 256 columns to keep 147 (43 % of its
// FMAs on padding) and ran at 33 % of the fp32 bound, slower than cuBLAS's
// two fp32 products. This one:
//   * runs on the tensor cores with the 3xTF32 split: x = hi + lo with hi
//     the TF32 truncation of x and lo that of x - hi, and a b ~ a_hi b_hi +
//     a_hi b_lo + a_lo b_hi, which keeps fp32-level error (the tolerance
//     is 3e-5; one-pass TF32 misses it). A bf16 X is exact in TF32 and
//     takes two products, x b_hi + x b_lo;
//   * issues Hopper's warpgroup products (wgmma.mma_async m64nNk8, A from
//     registers, B from shared memory) and not mma.sync, whose TF32 rate
//     on the H100 is well below wgmma's: a version on mma.sync, where
//     every fragment is a shared load and three split instructions per
//     warp, ran no faster than cuBLAS;
//   * covers c with N = 8 ceil(c / 8) columns (152 at c = 147, 3 %
//     padding) in one instruction per product, one instantiation per N;
//     above 160 columns (the registers of a block), c splits into as few
//     near-equal column tiles as fit;
//   * makes the next stage ready while one stage's products run: its B
//     tile, landed raw by cp.async, is split in shared memory (hi in
//     place, lo beside it) and its A fragments are loaded and split into
//     the second of two register buffers. Splitting B once per block in
//     shared memory beat loading w^T and t^T pre-split from device memory
//     (twice B's bytes: slower on the card);
//   * adds the tensor cores' sums of each 32-deep stage into fp32
//     registers of its own; each stage's first product overwrites the
//     tensor-core sums instead of adding to them. Those sums truncate
//     instead of rounding, and the bias grows with the chain: with no such
//     step a 65,536-row slab (whose X^T X diagonal term grows with the
//     rows) missed the 3e-5 tolerance several times over on the card, and
//     with one every 8 stages the operator's error was 6x cuBLAS's and
//     CG's 20-iteration residual in chip_smoke.py 3x the CUDA-core
//     kernel's. Every stage costs no time: the next stage's split and
//     loads cover the wait;
//   * loads through a four-stage cp.async ring (three where four do not
//     fit, N = 160) of 16-byte copies (4-byte copies or plain loads where
//     X's rows are not 16-byte aligned). w^T and t^T are laid out in
//     32-deep tiles, so a stage's B is 8 N x 128 contiguous bytes and not
//     N rows from N pages, which had made the X^T t launch 1.5x slower.
// The main loop's pieces are shared with rf_map.cu (tf32_mainloop.cuh).
// B is K-major in shared memory, as TF32 wgmma requires: w and t are kept
// transposed, w^T written by transpose_tiles_kernel and t^T by the first
// launch. No swizzle: 8 x 16-byte core matrices, the 8 of one 8-row group
// along K side by side. Block: two warpgroups over a 128-row x N-column
// output tile, each 64 rows; one block per SM (224 KB of shared memory
// at N = 152).
//
// The two products are two launches, as the TPU kernel's VMEM-resident
// (d, c) accumulator has no counterpart in a block (5.9 MB at d = 10,000):
//   1. t^T = (X w)^T  (ldt, n): 128-row tiles of X, the d-reduction inside
//                      the block; t's columns past c come out as zeros;
//   2. out = X^T t    (d, c): 128-row tiles of d, the n-reduction split
//                      into `slabs` fixed row slabs of at most 65,536 rows
//                      (kernels/device.py), each slab writing a partial
//                      that sum_slabs_kernel adds in slab order. No
//                      atomics: results repeat bit for bit.
#include "fp32_tiles.cuh"
#include "tf32_mainloop.cuh"

namespace {

using tf32::BK;
using tf32::BM;
using tf32::Buf;
using tf32::Layout;
using tf32::THREADS;

constexpr int NT_MAX = 20;       // 8-column tiles of a block (160)

// C (M x N) [+ z M ldo] = A B over k in this slab, k_begin a multiple of
// BK. A(m, k) = X[m][k] (kXT false) or X[k][m] (kXT true). B^T is fp32 in
// BK-deep tiles: element (col, k) at bt[(k / BK) ldt BK + col BK + k % BK],
// zero at columns past the valid ones. kXT false writes C^T in the same
// tiled form (ldt columns); kXT true writes out[m * ldo + col] for
// columns below n_out.
template <typename T, bool kXT, int NT>
__global__ void __launch_bounds__(THREADS, 1)
    nm_wgmma_kernel(const T* __restrict__ x, const float* __restrict__ bt,
                    float* __restrict__ out, int64_t M, int64_t K,
                    int64_t ldx, int64_t ldt, int64_t ldo, int64_t n_out,
                    int64_t slab_rows, bool vec_a) {
  using L = Layout<T, kXT, NT>;
  constexpr int STAGES = L::STAGES;
  constexpr bool kSplitA = sizeof(T) == 4;
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int t = lane & 3;
  const int row = (tid >> 5) * 16 + (lane >> 2);   // this thread's A row
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int64_t c0 = (int64_t)blockIdx.y * 8 * NT;
  const int64_t k_begin = (int64_t)blockIdx.z * slab_rows;
  const int64_t k_end = k_begin + slab_rows < K ? k_begin + slab_rows : K;
  const int steps = (int)((k_end - k_begin + BK - 1) / BK);

  auto a_tile = [&](int s) {
    return reinterpret_cast<T*>(smem + s * L::STAGE_BYTES);
  };
  auto b_hi = [&](int s) {
    return reinterpret_cast<float*>(smem + s * L::STAGE_BYTES + L::A_BYTES);
  };

  auto load_stage = [&](int s, int64_t k0) {
    if (kXT)
      tf32::load_tile<T, L::A_ROWS, L::A_COLS, L::A_LD>(
          a_tile(s), x, ldx, k0, k_end, m0, M, vec_a, tid);
    else
      tf32::load_tile<T, L::A_ROWS, L::A_COLS, L::A_LD>(
          a_tile(s), x, ldx, m0, M, k0, k_end, vec_a, tid);
    tf32::load_b<NT>(b_hi(s), bt, ldt, c0, k0, k_end, tid);
  };

  // A fragments in two register buffers: the products of one stage read
  // theirs while the next stage's are loaded
  uint32_t ah[2][BK / 8][4], al[2][BK / 8][4];
  float acc[4 * NT];
  float part[4 * NT];
#pragma unroll
  for (int i = 0; i < 4 * NT; ++i) acc[i] = part[i] = 0.f;

  // the products of stage `it` (A buffer `buf`) into `part`; while they
  // run, the next stage's loads, split and A fragments; then `part` joins
  // `acc`
  auto step = [&](int it, auto buf) {
    constexpr int B = decltype(buf)::value;
    const int s = it % STAGES;
    const uint32_t hi_addr = tc::smem_u32(b_hi(s));
    tf32::mma_stage<NT, kSplitA, B>(part, ah, al, hi_addr,
                                    hi_addr + L::B_BYTES);
    // both warpgroups waited for their products of stage it - 1 at the end
    // of the last step: its shared memory and A buffer are free
    __syncthreads();
    const int nxt = it + STAGES - 1;
    if (nxt < steps)
      load_stage(nxt % STAGES, k_begin + (int64_t)nxt * BK);
    tc::cp_async_commit();
    if (it + 1 < steps) {
      tc::cp_async_wait<STAGES - 2>();
      __syncthreads();
      tf32::split_b<NT>(b_hi((it + 1) % STAGES), tid);
      tf32::load_a<T, kXT, NT, 1 - B>(a_tile((it + 1) % STAGES), row, t,
                                      ah, al);
    }
    tf32::mma_wait();
#pragma unroll
    for (int i = 0; i < 4 * NT; ++i) acc[i] += part[i];
    __syncthreads();   // the split of it + 1 is visible to every warp
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load_stage(s, k_begin + (int64_t)s * BK);
    tc::cp_async_commit();
  }
  tc::cp_async_wait<STAGES - 2>();
  __syncthreads();
  if (steps > 0) {
    tf32::split_b<NT>(b_hi(0), tid);
    tf32::load_a<T, kXT, NT, 0>(a_tile(0), row, t, ah, al);
  }
  __syncthreads();
  for (int it = 0; it < steps; it += 2) {
    step(it, Buf<0>{});
    if (it + 1 < steps) step(it + 1, Buf<1>{});
  }
  tc::cp_async_wait<0>();

  if (kXT) {
    float* o = out + (int64_t)blockIdx.z * M * ldo;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t r = m0 + row + (e >> 1) * 8;
        const int64_t c = c0 + 8 * j + 2 * t + (e & 1);
        if (r < M && c < n_out) o[r * ldo + c] = acc[4 * j + e];
      }
  } else {
    // C^T in BK-deep tiles, the B of the X^T t launch
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t r = m0 + row + (e >> 1) * 8;
        const int64_t c = c0 + 8 * j + 2 * t + (e & 1);
        if (r < M)
          out[(r / BK) * ldt * BK + c * BK + r % BK] = acc[4 * j + e];
      }
  }
}

template <typename T, bool kXT, int NT>
cudaError_t launch_pass(dim3 grid, const T* x, const float* bt, float* out,
                        int64_t M, int64_t K, int64_t ldx, int64_t ldt,
                        int64_t ldo, int64_t n_out, int64_t slab_rows,
                        cudaStream_t stream) {
  constexpr size_t bytes = Layout<T, kXT, NT>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      nm_wgmma_kernel<T, kXT, NT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  nm_wgmma_kernel<T, kXT, NT><<<grid, THREADS, bytes, stream>>>(
      x, bt, out, M, K, ldx, ldt, ldo, n_out, slab_rows,
      tf32::aligned16(x, ldx * (int64_t)sizeof(T)));
  return cudaGetLastError();
}

template <typename T, int NT>
int launch(const T* x, const float* w, float* wt, float* tt, float* part,
           float* out, int64_t n, int64_t d, int64_t c, int slabs,
           cudaStream_t stream) {
  using fp32_tiles::ceil_div;
  const int64_t col_tiles = ceil_div(c, 8 * (int64_t)NT);
  const int64_t ldt = col_tiles * 8 * NT;
  const int64_t wt_size = ceil_div(d, BK) * BK * ldt;
  tf32::transpose_tiles_kernel<<<fp32_tiles::sum_slabs_blocks(wt_size),
                                 256, 0, stream>>>(w, wt, d, c, ldt,
                                                   wt_size);
  cudaError_t err = launch_pass<T, false, NT>(
      dim3((unsigned)ceil_div(n, BM), (unsigned)col_tiles, 1), x, wt, tt, n,
      d, d, ldt, 0, ldt, d, stream);
  if (err != cudaSuccess) return (int)err;
  const int64_t slab_rows = ceil_div(ceil_div(n, slabs), BK) * BK;
  float* dst = slabs == 1 ? out : part;
  err = launch_pass<T, true, NT>(
      dim3((unsigned)ceil_div(d, BM), (unsigned)col_tiles, (unsigned)slabs),
      x, tt, dst, d, n, d, ldt, c, c, slab_rows, stream);
  if (err != cudaSuccess) return (int)err;
  if (slabs > 1)
    fp32_tiles::sum_slabs_kernel<<<fp32_tiles::sum_slabs_blocks(d * c), 256,
                                   0, stream>>>(part, out, d * c, slabs);
  return (int)cudaGetLastError();
}

template <typename T, int NT = 1>
int by_tiles(int nt, const T* x, const float* w, float* wt, float* tt,
             float* part, float* out, int64_t n, int64_t d, int64_t c,
             int slabs, cudaStream_t stream) {
  if constexpr (NT > NT_MAX) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (nt == NT)
      return launch<T, NT>(x, w, wt, tt, part, out, n, d, c, slabs, stream);
    return by_tiles<T, NT + 1>(nt, x, w, wt, tt, part, out, n, d, c, slabs,
                               stream);
  }
}

}  // namespace

// dtype of x: 0 = float32, 1 = bfloat16. nt: 8-column tiles of one column
// tile, 1 to 20 (repro_torch's column_tiles); c is covered by
// ceil(c / (8 nt)) column tiles of ldt = 8 nt times that many columns
// together. Scratch: wt holds ldt * round32(d) floats, tt ldt * round32(n)
// (round32: up to a multiple of 32), part slabs * d * c floats when
// slabs > 1 (unused otherwise). Returns a cudaError_t.
extern "C" int normal_matvec_launch(int dtype, const void* x, const void* w,
                                    void* wt, void* tt, void* part,
                                    void* out, int64_t n, int64_t d,
                                    int64_t c, int nt, int slabs,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w32 = static_cast<const float*>(w);
  float* wtp = static_cast<float*>(wt);
  float* ttp = static_cast<float*>(tt);
  float* pp = static_cast<float*>(part);
  float* op = static_cast<float*>(out);
  if (dtype == 0)
    return by_tiles<float>(nt, static_cast<const float*>(x), w32, wtp, ttp,
                           pp, op, n, d, c, slabs, s);
  return by_tiles<__nv_bfloat16>(nt, static_cast<const __nv_bfloat16*>(x),
                                 w32, wtp, ttp, pp, op, n, d, c, slabs, s);
}
