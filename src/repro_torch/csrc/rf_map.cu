// Z = sqrt(2/D) cos(X W + b), X (n, d) fp32 or bf16 row-major, W (d, D)
// fp32 row-major, b (D,) fp32, Z (n, D) fp32. Any n, d and D.
//
// Replaces the TPU kernel src/repro/kernels/rf_map/rf_map.py::rf_map_pallas
// (_rf_kernel). In the port it is the random-feature expansion of
// skylark.cg_solve (rf_dim > 0) and skylark.random_features.
//
// Bound on the H100: operations. 2 n d D flops (plus n D cosines) against
// reading X once and writing Z once; at d = 440 that is 220 flops per fp32
// byte of Z. On the tensor cores in 3xTF32 (three TF32 products per
// product) the main path's 1,048,576 x 440 -> 10,000 takes at least
// 3 x 9.23 TFLOP / 495 TFLOP/s = 56 ms; its 43.8 GB of bytes, nearly all
// the one write of Z, 13 ms. The CUDA-core fp32 kernel this replaces
// (a 128 x 128 register-tiled GEMM with the same epilogue, 404 ms on an
// NVIDIA H100 80GB HBM3 at 700 W) was slower than cuBLAS's SGEMM followed
// by three elementwise passes.
//
// Design:
//   * the t = X w pass of normal_matvec.cu on the same pieces
//     (tf32_mainloop.cuh): 3xTF32 wgmma.mma_async m64n160k8, A (X) from
//     registers split there, B (W^T in 32-deep K-major tiles, written by
//     transpose_tiles_kernel) from shared memory split there, a cp.async
//     ring (three stages in fp32, four for a bf16 X), and the tensor cores'
//     truncating sums moved into fp32 registers after every 32-deep stage
//     (K = 440 is 14 of them);
//   * output tiles of 128 rows x 160 columns: each stage pays a fixed cost
//     (its A fragments, three block barriers, the wait for its products)
//     whatever the width, so the widest tile the registers hold runs
//     fastest (255 registers; 160 columns ran 4 % faster than 128);
//   * persistent blocks, one per SM, each walking tiles in the order
//     column tiles fastest, so the SMs work on one or two 128-row blocks
//     of X at a time: X streams from device memory about once (1.85 GB at
//     the main shape) and W^T (18 MB) stays in the 50 MB L2. Nothing here
//     is bound by that traffic yet: a row-fastest order, which reads X
//     once per column tile (63 times), ran 1 % faster;
//   * the reduction is short (14 stages), so the ring runs on across tiles:
//     the next tile's first stages are in flight while this tile's epilogue
//     runs;
//   * the epilogue stages each warp's 16 rows in the ring stage the
//     products just freed, 32 columns at a time, then adds b, takes cosf
//     (the accurate one: fast-math __cosf is wrong at the |XW + b| of tens
//     these features reach) and scales by sqrt(2/D) of the true D on the
//     way out, 8 lanes a row storing 128 contiguous bytes (4-byte stores
//     where Z's rows are not 16-byte aligned), with an evict-first hint: Z
//     is written once and never read back here.
// Where the time goes at the main shape (NVIDIA H100 80GB HBM3, 700 W;
// python -m repro_torch.launch.rf_map_variants): 183 ms, of which 153 ms
// in the main loop (37 % of the TF32 rate) and 30 ms in the epilogue,
// which runs while the tensor cores wait.
#include "fp32_tiles.cuh"
#include "tf32_mainloop.cuh"

namespace {

using tf32::BK;
using tf32::BM;
using tf32::Buf;
using tf32::THREADS;

constexpr int NT = 20;              // 8-column tiles of an output tile
constexpr int BN = 8 * NT;          // output tile columns
constexpr int CHUNK = 32;           // columns a warp stages at a time
constexpr int ZLD = CHUNK + 8;      // their row stride: the float2 stores
                                    // of 16 lanes fall in 32 banks

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    rf_wgmma_kernel(const T* __restrict__ x, const float* __restrict__ wt,
                    const float* __restrict__ bias, float* __restrict__ z,
                    int64_t n, int64_t d, int64_t dd, int64_t ldt,
                    int64_t col_tiles, int64_t tiles, float scale,
                    bool vec_a, bool vec_z) {
  using L = tf32::Layout<T, false, NT>;
  constexpr int STAGES = L::STAGES;
  constexpr bool kSplitA = sizeof(T) == 4;
  static_assert(BN % CHUNK == 0 && THREADS / 32 * 16 * ZLD * 4 <=
                L::STAGE_BYTES, "the staged output must fit one ring stage");
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;           // rows 16 warp .. + 15 of a tile
  const int lane = tid & 31;
  const int t = lane & 3;
  const int row = warp * 16 + (lane >> 2);   // this thread's A row
  // this block's tiles are blockIdx.x + i gridDim.x; a unit is one
  // 32-deep stage of one of them
  const int ks = (int)((d + BK - 1) / BK);
  const int64_t mine =
      blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int64_t units = mine * ks;

  auto a_tile = [&](int s) {
    return reinterpret_cast<T*>(smem + s * L::STAGE_BYTES);
  };
  auto b_hi = [&](int s) {
    return reinterpret_cast<float*>(smem + s * L::STAGE_BYTES + L::A_BYTES);
  };
  // Units are loaded and finished in order, so two cursors walk them with
  // no division per unit: (tile, stage) of the next unit to load, and the
  // tile whose units the products are on.
  int64_t ld_tile = blockIdx.x, ld_m0 = 0, ld_c0 = 0;
  int ld_k = 0, ld_s = 0;
  auto origin = [&](int64_t tile, int64_t& m0, int64_t& c0) {
    m0 = tile / col_tiles * BM;
    c0 = tile % col_tiles * BN;
  };
  origin(ld_tile, ld_m0, ld_c0);
  auto load_next = [&]() {
    const int64_t k0 = (int64_t)ld_k * BK;
    tf32::load_tile<T, BM, BK, L::A_LD>(a_tile(ld_s), x, d, ld_m0, n, k0, d,
                                        vec_a, tid);
    tf32::load_b<NT>(b_hi(ld_s), wt, ldt, ld_c0, k0, d, tid);
    ld_s = ld_s + 1 == STAGES ? 0 : ld_s + 1;
    if (++ld_k == ks) {
      ld_k = 0;
      ld_tile += gridDim.x;
      origin(ld_tile, ld_m0, ld_c0);
    }
  };
  int64_t mma_tile = blockIdx.x;
  int mma_k = 0;

  uint32_t ah[2][BK / 8][4], al[2][BK / 8][4];
  float acc[4 * NT];
  float part[4 * NT];
#pragma unroll
  for (int i = 0; i < 4 * NT; ++i) acc[i] = part[i] = 0.f;

  // Z rows m0 + 16 warp .. + 15, columns [c0, c0 + BN) from acc, through
  // this warp's share of ring stage s, CHUNK columns at a time: a lane
  // writes its fragment pairs, then reads back 4 columns of four rows
  // (8 lanes a row: 128 contiguous bytes of Z) and stores them.
  auto epilogue = [&](int s, int64_t m0, int64_t c0) {
    float* st = reinterpret_cast<float*>(smem + s * L::STAGE_BYTES) +
                warp * 16 * ZLD;
    const int cc = 4 * (lane & 7);      // this lane's columns in a chunk
#pragma unroll
    for (int h = 0; h < BN / CHUNK; ++h) {
#pragma unroll
      for (int j = 0; j < CHUNK / 8; ++j) {
        const int jj = h * (CHUNK / 8) + j;
        float* p = st + (lane >> 2) * ZLD + 8 * j + 2 * t;
        *reinterpret_cast<float2*>(p) = make_float2(acc[4 * jj],
                                                    acc[4 * jj + 1]);
        *reinterpret_cast<float2*>(p + 8 * ZLD) =
            make_float2(acc[4 * jj + 2], acc[4 * jj + 3]);
      }
      __syncwarp();
      const int64_t gc = c0 + h * CHUNK + cc;
      if (gc < dd) {
        float bv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          bv[q] = gc + q < dd ? __ldg(bias + gc + q) : 0.f;
        // not unrolled: every inlined cosf is a long body with its slow
        // path, and five chunks of sixteen made the kernel 31 % slower
#pragma unroll 1
        for (int i = 0; i < 4; ++i) {
          const int r = 4 * i + (lane >> 3);
          const int64_t gr = m0 + warp * 16 + r;
          if (gr >= n) break;
          const float4 v4 =
              *reinterpret_cast<const float4*>(st + r * ZLD + cc);
          const float v[4] = {scale * cosf(v4.x + bv[0]),
                              scale * cosf(v4.y + bv[1]),
                              scale * cosf(v4.z + bv[2]),
                              scale * cosf(v4.w + bv[3])};
          float* zp = z + gr * dd + gc;
          if (vec_z) {
            __stcs(reinterpret_cast<float4*>(zp),
                   make_float4(v[0], v[1], v[2], v[3]));
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (gc + q < dd) __stcs(zp + q, v[q]);
          }
        }
      }
      __syncwarp();
    }
  };

  // the products of unit u (A buffer `buf`) into `part`; while they run,
  // the loads of unit u + STAGES - 1 (maybe the next tile's) and the split
  // and A fragments of unit u + 1; then `part` joins `acc`, and after a
  // tile's last unit the epilogue empties `acc` through the stage whose
  // products just finished
  auto step = [&](int64_t u, int s, auto buf) {
    constexpr int B = decltype(buf)::value;
    const uint32_t hi_addr = tc::smem_u32(b_hi(s));
    tf32::mma_stage<NT, kSplitA, B>(part, ah, al, hi_addr,
                                    hi_addr + L::B_BYTES);
    // both warpgroups waited for their products of unit u - 1 at the end
    // of the last step, and the epilogue of its tile is done: its stage
    // and A buffer are free
    __syncthreads();
    if (u + STAGES - 1 < units) load_next();
    tc::cp_async_commit();
    if (u + 1 < units) {
      const int s1 = s + 1 == STAGES ? 0 : s + 1;
      tc::cp_async_wait<STAGES - 2>();
      __syncthreads();
      tf32::split_b<NT>(b_hi(s1), tid);
      tf32::load_a<T, false, NT, 1 - B>(a_tile(s1), row, t, ah, al);
    }
    tf32::mma_wait();
#pragma unroll
    for (int i = 0; i < 4 * NT; ++i) acc[i] += part[i];
    // the split of u + 1 is visible to every warp, and no warp still
    // reads stage s
    __syncthreads();
    if (++mma_k == ks) {
      int64_t m0, c0;
      origin(mma_tile, m0, c0);
      epilogue(s, m0, c0);
#pragma unroll
      for (int i = 0; i < 4 * NT; ++i) acc[i] = 0.f;
      mma_k = 0;
      mma_tile += gridDim.x;
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < units) load_next();
    tc::cp_async_commit();
  }
  tc::cp_async_wait<STAGES - 2>();
  __syncthreads();
  if (units > 0) {
    tf32::split_b<NT>(b_hi(0), tid);
    tf32::load_a<T, false, NT, 0>(a_tile(0), row, t, ah, al);
  }
  __syncthreads();
  // units in pairs, so each one's A buffer is known when it compiles
  int s = 0;
  for (int64_t u = 0; u < units; u += 2) {
    step(u, s, Buf<0>{});
    s = s + 1 == STAGES ? 0 : s + 1;
    if (u + 1 < units) step(u + 1, s, Buf<1>{});
    s = s + 1 == STAGES ? 0 : s + 1;
  }
  tc::cp_async_wait<0>();
}

template <typename T>
int launch(const T* x, const float* w, const float* b, float* wt, float* z,
           int64_t n, int64_t d, int64_t dd, float scale, int blocks,
           cudaStream_t stream) {
  using fp32_tiles::ceil_div;
  const int64_t col_tiles = ceil_div(dd, BN);
  const int64_t ldt = col_tiles * BN;
  const int64_t wt_size = ceil_div(d, BK) * BK * ldt;
  tf32::transpose_tiles_kernel<<<fp32_tiles::sum_slabs_blocks(wt_size),
                                 256, 0, stream>>>(w, wt, d, dd, ldt,
                                                   wt_size);
  const int64_t tiles = ceil_div(n, BM) * col_tiles;
  const unsigned grid = (unsigned)(tiles < blocks ? tiles : blocks);
  constexpr size_t bytes = tf32::Layout<T, false, NT>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      rf_wgmma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  rf_wgmma_kernel<T><<<grid, THREADS, bytes, stream>>>(
      x, wt, b, z, n, d, dd, ldt, col_tiles, tiles, scale,
      tf32::aligned16(x, d * (int64_t)sizeof(T)),
      tf32::aligned16(z, dd * 4));
  return (int)cudaGetLastError();
}

}  // namespace

// dtype of x: 0 = float32, 1 = bfloat16. Scratch: wt holds
// round32(d) * ldt floats (round32: up to a multiple of 32; ldt: D up to
// a multiple of 128). blocks: the persistent blocks to launch, one per SM.
// Returns a cudaError_t.
extern "C" int rf_map_launch(int dtype, const void* x, const void* w,
                             const void* b, void* wt, void* z, int64_t n,
                             int64_t d, int64_t dd, float scale, int blocks,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wp = static_cast<const float*>(w);
  const float* bp = static_cast<const float*>(b);
  float* wtp = static_cast<float*>(wt);
  float* zp = static_cast<float*>(z);
  if (dtype == 0)
    return launch<float>(static_cast<const float*>(x), wp, bp, wtp, zp, n,
                         d, dd, scale, blocks, s);
  return launch<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(x), wp, bp,
                               wtp, zp, n, d, dd, scale, blocks, s);
}
