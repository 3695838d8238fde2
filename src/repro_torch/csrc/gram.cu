// G = A^T A, fp32 accumulation, A (n, d) fp32 or bf16 row-major. Any
// n, d >= 1: there is no cap and no other path on the card.
//
// Replaces the TPU kernel src/repro/kernels/gram/gram.py::gram_pallas
// (_gram_kernel), used by elemental.gram and elemental.gram_svd.
//
// Bound on the H100: operations. Only tiles on or above the diagonal
// compute, n d (d + 1) flops against n d reads: ~4,000 flops a byte at
// d = 8,096, far above the card's balance point. In 3xTF32 (three TF32
// products for each product, below) on the tensor cores that is 416.6 ms
// at gram_svd's 1,048,576 x 8,096 (495 TFLOP/s / 3). A bf16 A is exact in
// TF32 and takes one product (139 ms at that rate); the card's bound for
// bf16 operands is its bf16 rate, 989 TFLOP/s (69.5 ms).
//
// The kernel this replaces ran 128 x 128 fp32 register tiles on the CUDA
// cores, fed by synchronous 4-byte loads, and wrote each mirror tile by
// columns: 56 % of the CUDA-core bound, a quarter of the tensor-core
// route of normal_matvec and rf_map, and 1.7 x slower than torch.mm at
// 8,192 x 512. This one:
//   * runs on the tensor cores in 3xTF32, as tf32_mainloop.cuh does for
//     normal_matvec and rf_map: x = hi + lo with hi the TF32 truncation of
//     x and lo that of x - hi, a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi,
//     which keeps fp32-level error (the tolerance is 2e-5; one-pass TF32
//     misses it, tests/test_torch_precision.py). Each 32-deep stage's
//     products start from zero and are added into fp32 registers of their
//     own, since the tensor cores' sums truncate. A bf16 A, and so its B,
//     is exact in TF32: one product a stage;
//   * is warp-specialised: a producer warpgroup (its registers lowered by
//     setmaxnreg) keeps a ring of TMA loads in flight, the 32 x 128 row
//     panels of A under the tile's rows and columns (one panel on a
//     diagonal tile), landed with a 128-byte swizzle; two consumer
//     warpgroups, each owning 64 output rows (232 registers), issue
//     Hopper's wgmma.mma_async m64n128k8 in turns on named barriers,
//     consumer 1 half a stage behind consumer 0, so that one's fold and
//     next issue overlap the other's products (2-5 % faster than both
//     issuing together at 1,048,576 x 8,096 fp32 on an H100, 2-3 %
//     slower for a bf16 A: PERF.md section 6);
//   * reads A (of the product) from registers and B from shared memory.
//     TF32 wgmma reads B from shared memory only K-major, and a row panel
//     lands MN-major: the consumers transpose a stage's B panel into
//     K-major core matrices while splitting it into hi and lo, as
//     tf32_mainloop.cuh's split_b does, and load and split their A
//     fragments from the other panel into registers, both while the last
//     stage's products run (three B^T buffers, so that neither consumer
//     overwrites one the other still reads). The reduction rows within
//     each 8-row group are taken in the order 0, 2, 4, 6, 1, 3, 5, 7 (the
//     sum does not care): with the swizzle, a warp's A fragment loads and
//     the transposing pass then touch 32 distinct banks;
//   * stages the finished tile through shared memory, so that the tile
//     and its mirror are both written by rows, 128 bytes a warp; a
//     diagonal tile writes each element below the diagonal from its
//     mirror above it, so G is exactly symmetric;
//   * walks the upper tiles in 8 x 8 squares taken row by row, so the
//     132 blocks running at once read a few dozen panels of A from L2;
//   * splits the rows into fixed slabs (kernels/gram/gram.py gram_slabs:
//     at most 65,536 rows each, since one fp32 accumulator over 1,048,576
//     rows of a growing diagonal rounds past the tolerance; more where the
//     upper tiles cannot fill the card's SMs, one block each). Each slab
//     writes its own partial Gram and sum_slabs_kernel adds them in slab
//     order: no atomics, results repeat bit for bit;
//   * takes any d and row stride. TMA needs rows of a multiple of 16 bytes
//     on a 16-byte aligned base (fp32 d % 4 == 0, bf16 d % 8 == 0); for
//     other shapes the producer warpgroup loads the panels itself into the
//     same swizzled layout. Columns past d and rows past n read as zeros.
#include <atomic>
#include <cstring>

#include "fp32_tiles.cuh"
#include "hopper_bf16.cuh"
#include "tf32_mainloop.cuh"

namespace {

using tf32::BK;                    // rows of A a stage takes
using tf32::Buf;

constexpr int BT = 128;            // output tile: BT x BT
constexpr int WG = 128;            // threads of a warpgroup
constexpr int THREADS = 3 * WG;    // producer, consumer 0, consumer 1
constexpr int CONSUMERS = 2 * WG;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;   // 128 x 40 + 256 x 232 <= 65,536
constexpr int READY_BAR = 1;         // both consumers: a stage's B^T is in
constexpr int TURN_BAR = 2;          // 2, 3: consumer 0's, 1's turn to
                                     // issue
constexpr int NBUF = 3;              // B^T buffers
constexpr int GROUP = 8;             // raster squares of GROUP x GROUP tiles
constexpr int SLD = BT + 1;          // row stride of the staged tile (floats)

// Shared memory: a ring of raw stages (panel i, then panel j), 128 KB;
// three buffers of a stage's B^T, K-major (hi part, then lo part for
// fp32); the stages' full and empty barriers. The finished tile is staged
// in the ring. Every offset below is a multiple of 1,024 bytes.
template <typename T>
struct Smem {
  static constexpr int BOX_COLS = 128 / (int)sizeof(T);   // a swizzle row
  static constexpr int BOXES = BT / BOX_COLS;
  static constexpr int BOX_BYTES = BK * 128;
  static constexpr int PANEL_BYTES = BOXES * BOX_BYTES;
  static constexpr int STAGE_BYTES = 2 * PANEL_BYTES;
  static constexpr int STAGES = 128 * 1024 / STAGE_BYTES;   // 4, bf16 8
  static constexpr bool SPLIT = sizeof(T) == 4;
  static constexpr int B_BYTES = BT * BK * 4;               // one part
  static constexpr int BBUF_BYTES = (SPLIT ? 2 : 1) * B_BYTES;
  static constexpr int B_OFF = STAGES * STAGE_BYTES;
  static constexpr int BAR_OFF = B_OFF + NBUF * BBUF_BYTES;
  // and the slack that aligns the tiles to 1,024 bytes
  static constexpr size_t BYTES = BAR_OFF + 16 * STAGES + 1024;
  static_assert(BT * SLD * 4 <= B_OFF, "the staged tile fits the ring");
};

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

// Byte offset of element (row k, column m) of a panel as TMA lands it:
// 128-byte-wide boxes one after the other, and in each the 16-byte chunk
// c of row k at chunk c ^ (k % 8).
template <typename T>
__device__ __forceinline__ int panel_off(int k, int m) {
  constexpr int BC = Smem<T>::BOX_COLS;
  const int b = (m % BC) * (int)sizeof(T);
  return (m / BC) * Smem<T>::BOX_BYTES + k * 128 +
         ((((b >> 4) ^ k) & 7) << 4) + (b & 15);
}

// The q-th tile on or above the diagonal of a tiles x tiles grid, in
// GROUP x GROUP squares taken row by row, the tiles of a square row by
// row.
__device__ __forceinline__ void upper_tile(int q, int tiles, int& ti,
                                           int& tj) {
  const int squares = (tiles + GROUP - 1) / GROUP;
  for (int si = 0; si < squares; ++si) {
    const int ri = min(GROUP, tiles - si * GROUP);
    for (int sj = si; sj < squares; ++sj) {
      const int cj = min(GROUP, tiles - sj * GROUP);
      const int cnt = si == sj ? ri * (ri + 1) / 2 : ri * cj;
      if (q >= cnt) {
        q -= cnt;
        continue;
      }
      if (si == sj) {
        int r = 0;
        while (q >= ri - r) q -= ri - r++;
        ti = si * GROUP + r;
        tj = ti + q;
      } else {
        ti = si * GROUP + q / cj;
        tj = sj * GROUP + q % cj;
      }
      return;
    }
  }
  ti = tj = 0;
}

// Register buffer R <- this thread's A fragments of a stage, read from
// panel i and split (fp32) or as they are (bf16). m is the thread's first
// A row (its output row in the tile), t = lane % 4. Logical reduction row
// ks * 8 + t (+ 4) is panel row ks * 8 + 2 t (+ 1).
template <typename T, int R>
__device__ __forceinline__ void load_a(const unsigned char* panel, int m,
                                       int t, uint32_t (&ah)[2][BK / 8][4],
                                       uint32_t (&al)[2][BK / 8][4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const unsigned char* p =
        panel + panel_off<T>(2 * t + (e >> 1), m + 8 * (e & 1));
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
      const float v =
          tf32::as_f32(*reinterpret_cast<const T*>(p + ks * 8 * 128));
      if constexpr (sizeof(T) == 4)
        tc::split_tf32(v, ah[R][ks][e], al[R][ks][e]);
      else
        ah[R][ks][e] = __float_as_uint(v);
    }
  }
}

// dst <- B^T of a stage from panel j, as K-major core matrices (8 columns
// x 4 reduction rows of 16 bytes; tf32_mainloop.cuh's layout): the hi part,
// and for fp32 the lo part B_BYTES beyond it. Consumer thread ct takes
// column n = ct % 128 at core-matrix columns kc = ct / 128 + 2 i, whose
// logical rows 4 kc + q are panel rows 8 i + 2 q + ct / 128. A warp reads
// 32 neighbouring columns of one row and writes whole 128-byte lines.
template <typename T>
__device__ __forceinline__ void split_b(const unsigned char* panel,
                                        float* dst, int ct) {
  const int n = ct & (BT - 1);
  const int c0 = ct >> 7;
#pragma unroll
  for (int i = 0; i < BK / 8; ++i) {
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      v[q] = tf32::as_f32(*reinterpret_cast<const T*>(
          panel + panel_off<T>(2 * q + c0, n) + i * 8 * 128));
    float4* hi = reinterpret_cast<float4*>(
        dst + ((n >> 3) * tf32::KG + c0 + 2 * i) * 32 + (n & 7) * 4);
    if constexpr (Smem<T>::SPLIT) {
      uint32_t h[4], l[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) tc::split_tf32(v[q], h[q], l[q]);
      *hi = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                        __uint_as_float(h[2]), __uint_as_float(h[3]));
      hi[Smem<T>::B_BYTES / 16] =
          make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                      __uint_as_float(l[2]), __uint_as_float(l[3]));
    } else {
      *hi = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  // generic-proxy writes, read next by wgmma (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One block: the upper tile (ti, tj) of G over the rows of one slab, into
// that slab's d x d partial at out + slab d d (G itself when there is one
// slab), the tile and its mirror.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    gram_wgmma_kernel(const __grid_constant__ CUtensorMap map,
                      const T* __restrict__ a, float* __restrict__ out,
                      int64_t n, int64_t d, int64_t slab_rows, int tiles,
                      bool tma) {
  using S = Smem<T>;
  constexpr int STAGES = S::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024u - (hop::smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = hop::smem_u32(smem);
  auto full = [&](int s) { return base + S::BAR_OFF + 8 * s; };
  auto empty = [&](int s) { return base + S::BAR_OFF + 8 * (STAGES + s); };

  const int64_t per_slab = (int64_t)tiles * (tiles + 1) / 2;
  const int64_t slab = blockIdx.x / per_slab;
  int ti, tj;
  upper_tile((int)(blockIdx.x % per_slab), tiles, ti, tj);
  const bool diag = ti == tj;
  const int64_t i0 = (int64_t)ti * BT;
  const int64_t j0 = (int64_t)tj * BT;
  const int64_t k_begin = slab * slab_rows;
  const int64_t k_end = k_begin + slab_rows < n ? k_begin + slab_rows : n;
  const int steps =
      k_end > k_begin ? (int)((k_end - k_begin + BK - 1) / BK) : 0;

  const int tid = threadIdx.x;
  // warp-uniform, so that what derives from it stays in uniform registers
  const int wg = __shfl_sync(0xffffffffu, tid / WG, 0);
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // TMA: the producer's expect_tx; else lane 0 of each producer warp
      hop::mbar_init(full(s), tma ? 1 : 4);
      // lane 0 of each of the consumers' eight warps
      hop::mbar_init(empty(s), 8);
    }
    hop::fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    hop::setmaxnreg_dec<PRODUCER_REGS>();
    if (tma) {
      if (tid != 0) return;
      // boxes wholly past column d are not loaded (what lands there is
      // read only into rows and columns past d, which are not stored)
      auto live = [&](int64_t c0) {
        const int64_t b = (d - c0 + S::BOX_COLS - 1) / S::BOX_COLS;
        return (int)(b < S::BOXES ? b : S::BOXES);
      };
      const int live_i = live(i0);
      const int live_j = diag ? 0 : live(j0);
      const uint32_t bytes = (uint32_t)(live_i + live_j) * S::BOX_BYTES;
      for (int it = 0; it < steps; ++it) {
        const int s = it % STAGES;
        // the stage's previous use released (its first use passes)
        hop::mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);
        hop::mbar_expect_tx(full(s), bytes);
        const uint32_t dst = base + s * S::STAGE_BYTES;
        const int row = (int)(k_begin + (int64_t)it * BK);
        for (int b = 0; b < live_i; ++b)
          hop::tma_load_2d(dst + b * S::BOX_BYTES, &map, full(s),
                           (int)i0 + b * S::BOX_COLS, row);
        for (int b = 0; b < live_j; ++b)
          hop::tma_load_2d(dst + S::PANEL_BYTES + b * S::BOX_BYTES, &map,
                           full(s), (int)j0 + b * S::BOX_COLS, row);
      }
    } else {
      // rows TMA cannot describe: thread tid loads column tid of both
      // panels, a warp 32 neighbouring elements of one row
      for (int it = 0; it < steps; ++it) {
        const int s = it % STAGES;
        hop::mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);
        unsigned char* dst = smem + s * S::STAGE_BYTES;
        const int64_t k0 = k_begin + (int64_t)it * BK;
        for (int p = 0; p < (diag ? 1 : 2); ++p) {
          const int64_t gc = (p ? j0 : i0) + tid;
#pragma unroll 4
          for (int r = 0; r < BK; ++r) {
            const int64_t gr = k0 + r;
            *reinterpret_cast<T*>(dst + p * S::PANEL_BYTES +
                                  panel_off<T>(r, tid)) =
                gr < k_end && gc < d ? a[gr * d + gc] : zero<T>();
          }
        }
        __syncwarp();
        if ((tid & 31) == 0) hop::mbar_arrive(full(s));
      }
    }
    return;
  }

  hop::setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = wg - 1;                   // consumer 0 or 1
  const int ct = tid - WG;                 // 0 .. 255
  const int lane = tid & 31;
  const int t = lane & 3;
  // this thread's first output row in the tile: each consumer owns 64
  const int m = 64 * cw + 16 * ((ct >> 5) & 3) + (lane >> 2);
  const int jo = diag ? 0 : S::PANEL_BYTES;   // panel j in a stage

  uint32_t ah[2][BK / 8][4], al[2][BK / 8][4];
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;

  auto bbuf = [&](int it) {
    return reinterpret_cast<float*>(smem + S::B_OFF +
                                    it % NBUF * S::BBUF_BYTES);
  };
  // stage it, landed: its B^T into its B buffer (both consumers, half
  // each), its A fragments into register buffer R; then the raw stage is
  // released to the producer, and the consumers meet: the B^T is whole
  auto prepare = [&](int it, auto rb) {
    constexpr int R = decltype(rb)::value;
    const int s = it % STAGES;
    hop::mbar_wait(full(s), (it / STAGES) & 1);
    const unsigned char* raw = smem + s * S::STAGE_BYTES;
    split_b<T>(raw + jo, bbuf(it), ct);
    load_a<T, R>(raw, m, t, ah, al);
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(empty(s));
    hop::bar_sync(READY_BAR, CONSUMERS);
  };
  // The products of stage it (register buffer R) into `part`, issued in
  // turns: consumer 1's half a stage behind consumer 0's, so that one
  // consumer's fold into `acc` and next issue overlap the other's
  // products; while they run, the next stage's preparation. Three B^T
  // buffers: a consumer writes stage it + 2's only once both have passed
  // stage it + 1's, and so waited for their products of stage it - 1.
  auto step = [&](int it, auto rb) {
    constexpr int R = decltype(rb)::value;
    const uint32_t hi = hop::smem_u32(bbuf(it));
    hop::bar_sync(TURN_BAR + cw, CONSUMERS);
    tf32::mma_stage<16, S::SPLIT, R, S::SPLIT>(part, ah, al, hi,
                                              hi + S::B_BYTES);
    hop::bar_arrive(TURN_BAR + 1 - cw, CONSUMERS);
    if (it + 1 < steps) prepare(it + 1, Buf<1 - R>{});
    tf32::mma_wait();
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
  };

  // consumer 0 issues first
  if (cw == 1) hop::bar_arrive(TURN_BAR, CONSUMERS);
  if (steps > 0) prepare(0, Buf<0>{});
  for (int it = 0; it < steps; it += 2) {
    step(it, Buf<0>{});
    if (it + 1 < steps) step(it + 1, Buf<1>{});
  }
  // consumer 1's last turn given to consumer 0 is taken
  if (cw == 0) hop::bar_sync(TURN_BAR, CONSUMERS);

  // the tile through shared memory (the ring: every stage has landed and
  // been read), then out by rows; d[4 j + e] is at row m + 8 (e / 2),
  // column 8 j + 2 t + e % 2
  float* st = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      st[(m + 8 * (e >> 1)) * SLD + 8 * j + 2 * t + (e & 1)] = acc[4 * j + e];
  hop::bar_sync(READY_BAR, CONSUMERS);
  float* o = out + slab * d * d;
  const int cwarp = ct >> 5;               // 0 .. 7
  for (int r = cwarp; r < BT && i0 + r < d; r += 8)
#pragma unroll
    for (int q = 0; q < BT / 32; ++q) {
      const int c = 32 * q + lane;
      if (j0 + c < d)
        o[(i0 + r) * d + j0 + c] =
            diag && c < r ? st[c * SLD + r] : st[r * SLD + c];
    }
  if (diag) return;
  for (int c = cwarp; c < BT && j0 + c < d; c += 8)
#pragma unroll
    for (int q = 0; q < BT / 32; ++q) {
      const int r = 32 * q + lane;
      if (i0 + r < d) o[(j0 + c) * d + i0 + r] = st[r * SLD + c];
    }
}

template <typename T>
int launch(const T* a, float* part, float* out, int64_t n, int64_t d,
           int64_t slab_rows, cudaStream_t stream) {
  using S = Smem<T>;
  // a TMA stage loads BK rows unmasked: a slab must end on a stage
  if (n < 1 || d < 1 || slab_rows <= 0 || slab_rows % BK)
    return (int)cudaErrorInvalidValue;
  const int64_t tiles = fp32_tiles::ceil_div(d, BT);
  const int64_t slabs = fp32_tiles::ceil_div(n, slab_rows);
  const bool tma = tf32::aligned16(a, d * (int64_t)sizeof(T));
  // the device's primary context current on this thread: the driver's
  // tensor-map encoder needs one, and a thread that has made no runtime
  // call yet (an engine worker) has none
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaSetDevice(dev);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap map;
  std::memset(&map, 0, sizeof(map));
  if (tma) {
    const int status = hop::encode_rows(&map, a, S::SPLIT, d, n, d,
                                        S::BOX_COLS, BK);
    if (status) return status;
  }
  // the kernel's shared memory, raised once per device (a bit each for
  // the first 64)
  static std::atomic<uint64_t> raised{0};
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;
  if (!(raised.load() & bit)) {
    err = cudaFuncSetAttribute(gram_wgmma_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)S::BYTES);
    if (err != cudaSuccess) return (int)err;
    raised.fetch_or(bit);
  }
  float* dst = slabs == 1 ? out : part;
  gram_wgmma_kernel<T>
      <<<(unsigned)(slabs * tiles * (tiles + 1) / 2), THREADS, S::BYTES,
         stream>>>(map, a, dst, n, d, slab_rows, (int)tiles, tma);
  err = cudaGetLastError();
  if (err != cudaSuccess || slabs == 1) return (int)err;
  fp32_tiles::sum_slabs_kernel<<<fp32_tiles::sum_slabs_blocks(d * d), 256,
                                 0, stream>>>(part, out, d * d, (int)slabs);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. slab_rows: the rows of one slab, a
// positive multiple of 32 (kernels/gram/gram.py slab_rows; anything else
// returns cudaErrorInvalidValue and launches nothing); part holds
// ceil(n / slab_rows) * d * d floats when that is above 1 (unused
// otherwise). Returns a cudaError_t, or a tensor map the driver could not
// make (hopper_bf16.cuh ENCODE_MISSING and above).
extern "C" int gram_launch(int dtype, const void* a, void* part, void* out,
                           int64_t n, int64_t d, int64_t slab_rows,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  float* o = static_cast<float*>(out);
  if (dtype == 0)
    return launch(static_cast<const float*>(a), p, o, n, d, slab_rows, s);
  return launch(static_cast<const __nv_bfloat16*>(a), p, o, n, d,
                slab_rows, s);
}
