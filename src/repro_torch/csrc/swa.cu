// Sliding-window causal attention with an optional bidirectional prefix:
// out[b, h, i] = softmax_j(q_i . k_j * D^-0.5) v_j over the keys j that
// are visible to query i,
//
//   (j <= i || (j < P && i < P)) && j > i - window && j < S,
//
// for q (B, H, S, D) and k, v (B, K, S, D), H a multiple of K (GQA: head h
// reads kv head h / (H / K), never a repeated copy). P = 0 is causal
// attention over the window; 0 < P <= S makes the first P positions attend
// to each other in both directions (a prefix-LM's image patches); P = S
// with window = S is bidirectional attention (an encoder). fp32 or bf16 in
// (all three the same type), out in the input type.
//
// Replaces the TPU kernel src/repro/kernels/swa/swa.py::swa_pallas
// (_swa_kernel). In the port it is the prefill of every local-attention
// layer of RecurrentGemma, of every global layer (window = S) of the
// decoder-only families, of PaliGemma's prefix-LM layers (prefix 256) and
// of Whisper's encoder (prefix = window = S) (repro_torch/nn/attention.py),
// which the JAX package computes with a masked softmax in XLA.
//
// Bound on the H100: operations. 4 D flops per (query, visible key) pair,
// about 0.41 TFLOP of bf16 products at RecurrentGemma's B 4, H 16, S 4,096,
// D 256, window 2,048, against 285 MB moved: 0.42 ms at the card's bf16
// tensor-core rate (989 TFLOP/s), 6.2 ms at the fp32 CUDA-core rate.
//
// Layout: the tensors are addressed by strides (batch, head, position, in
// elements) with D contiguous, so the model passes (B, S, H, D) buffers
// viewed as (B, H, S, D) without a copy.
//
// Two routes, picked by the input type, with no fallback between them:
//
// bf16 (the serving and training path): a warp-specialised flash-attention
// kernel built from Hopper's own parts (hopper_bf16.cuh), swa_wgmma_kernel:
//   * a block of three warpgroups takes 128 queries of one (batch, head):
//     a producer warpgroup, its registers lowered to 40 by setmaxnreg, in
//     which one thread issues TMA loads (cp.async.bulk.tensor) of the q
//     tile and of a ring of K and V tiles (2 stages at D >= 128, 3 below),
//     each stage guarded by full and empty mbarriers; and two consumer
//     warpgroups at 232 registers, each owning 64 query rows, which share
//     the K and V tiles. Tiles land 128-byte swizzled (64-byte at D = 32)
//     in column blocks of 64 elements; a key tile is BK = 128 keys (64 at
//     D = 256, where the 64 x 256 fp32 output takes 128 registers a
//     thread): 56-192 KB of shared memory, one block an SM;
//   * S = Q K^T is a wgmma with both operands in shared memory, K-major as
//     they lie; O += P V a wgmma with P from registers, where the score
//     accumulator's layout is already P's A fragment, and V MN-major
//     through the descriptor's transpose bit;
//   * the precision plan: P is rounded once to fp16 (3 more bits than
//     bf16) and V is taken to fp16 after a power-of-two scale 2^e per
//     (batch, kv head) that puts max |v| in [2^14, 2^15): bf16 values stay
//     exact inside fp16's range whatever their magnitude, and P V is one
//     fp16 product. Two small kernels run first (swa_v_absmax, then
//     swa_v_half, on the launch's stream, no host sync) and write that fp16
//     copy of V to a scratch the wrapper allocates; the output is scaled
//     back by 2^-e. The row sum keeps the fp32 probabilities. Rounding P to
//     bf16 instead would put the output 2.8 x over the main shape's limit
//     (chip_smoke.py's SWA_RTOL / SWA_ATOL_RMS). Training's forward, which
//     also writes o32, splits P into fp16 hi + lo (P_lo V + P_hi V, half
//     again the products): the backward reads D = rowsum(dO o32), and over
//     near-uniform attention P rounded once moved dQ a third further from
//     the exact gradients. tests/test_torch_precision.py emulates both and
//     holds them at every shape they take;
//   * the online softmax works on the score accumulator in registers, in
//     base 2: the row max of the raw scores, scaled once, then each p =
//     2^(s scale log2 e - max) is one FFMA and one ex2.approx.ftz; a row
//     with no visible key yet subtracts 0, so its probabilities stay 0.
//     The mask is a template flag: tiles that need none run no mask
//     instruction (predicated into every tile, it cost 400 issue slots a
//     tile);
//   * the two consumer warpgroups ping-pong on two named barriers (FA3's
//     schedule): one issues its products (S of this tile, then P V of the
//     one before) while the other runs its softmax;
//   * a block walks only the key tiles of its band, and a block that
//     starts inside the prefix also the keys up to P - 1; masks are
//     evaluated only on tiles that cross a warpgroup's diagonal (unless
//     its queries and the tile's keys all lie inside the prefix), the
//     window's lower edge, or the end of S, as a per-row interval of
//     visible keys. Keys past S arrive as zeros from TMA's out-of-bounds
//     fill, and are masked;
//   * blocks run longest first: the grid is (B H, query tiles) with the
//     last query tile first, so the tiles with the most keys start first
//     and the short ones fill the tail (with a prefix the first tiles
//     read P keys each; at P = S every tile reads all S);
//   * the output, lse and o32 are written from registers with plain
//     stores.
// What bounds it (clock stamps of one block on an H100, 128 x 128 tiles
// at D = 128): not the loads (a variant that loads nothing after its first
// stages runs as fast) but each consumer's chain per key tile: issuing its
// products blocks until the tensor cores take them (about 450 + 420
// cycles, a lone warpgroup's dependent 64 x 128 x 16 products running at
// half the card's rate), then 1,450-1,780 cycles of softmax (1,130 with
// the other warpgroup idle: 64 MUFU.EX2 a thread plus the max and sum
// chains of one warp), then ~350 to pack P and meet the other warpgroup:
// ~3,300 cycles a tile against the 2,048 the products need at the peak
// rate. The softmax does not hide under the other warpgroup's products,
// and a block's 128 queries cost a full tile even where the band is
// shorter. Tried and dropped (same card): three consumer warpgroups on
// 64-key tiles, S and P V issued interleaved, each product split into two
// accumulator halves, 3 stages at D = 128, a consumer register limit of
// 240, skipping or moving the output's rescale: none ran faster. Without
// the ping-pong barriers it runs the same.
//
// fp32 (the JAX tests' 2e-5 tolerance rules out rounding P to bf16):
// swa_kernel on the CUDA cores, every product, the softmax and the sums
// in fp32. One block per (batch * head, 64-query block), 256 threads as
// 16 x 16; thread (ty, tx) owns query rows ty + 16 i (i < 4), score
// columns tx + 16 j (j < 4) and output columns tx + 16 jj (jj < D / 16).
// The q tile and each k tile sit in shared memory transposed (d-major,
// rows padded to 65) and the v tile row-major; the 64 x 64 probabilities
// go through shared memory for the P V product: 215 KB at D = 256.
//
// Both: keys outside the band and the prefix, and the ragged tail past S,
// get probability 0; the launcher raises the block's dynamic shared-memory
// limit above the 48 KB default (up to 227 KB on the H100); head dims 32,
// 64, 128 and 256. Given an lse buffer (fp32, contiguous (B, H, S)), both
// also write each row's natural log-sum-exp of its scaled, masked scores,
// lse_i = log sum_j exp(q_i . k_j * D^-0.5), from the running max and sum
// they already keep (the Pallas kernel's m / l scratch): the backward
// (swa_bwd.cu) rebuilds P = exp(S * scale - lse) from it without a second
// softmax pass. Serving passes none and writes nothing more. Training's
// bf16 forward also passes an fp32 (B, H, S, D) buffer, o32, that
// receives the output before it is rounded: the backward's D =
// rowsum(dO o) reads it, since a bf16 o loses the gradient of attention
// that is near uniform (an encoder's), where dP - D nearly cancels.
#include <math.h>

#include "fp32_tiles.cuh"
#include "hopper_bf16.cuh"

using fp32_tiles::ceil_div;
using fp32_tiles::to_f32;

namespace {

// ---------------------------------------------------------------------------
// bf16: the warp-specialised wgmma kernel
// ---------------------------------------------------------------------------
namespace wgr {

using bf16 = __nv_bfloat16;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
// max |v| of a (batch, kv head) is scaled into [2^V16_TOP, 2^(V16_TOP + 1))
constexpr int V16_TOP = 14;
constexpr int WG = 128;            // threads of a warpgroup
constexpr int BQ = 128;            // queries of a block: 64 a consumer
constexpr int THREADS = 3 * WG;    // producer, consumer 0, consumer 1
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;   // 128 x 40 + 256 x 232 <= 65,536
constexpr int SCHED_BAR = 1;       // named barriers 1, 2: consumer 0's, 1's
                                   // turn to issue its products

template <int D>
struct Tile {
  static constexpr int BK = D == 256 ? 64 : 128;   // keys of a step
  static constexpr int COL = D < 64 ? D : 64;      // elements of an atom row
  static constexpr int SW = 2 * COL;               // its bytes: the swizzle
  static constexpr int NCOL = D / COL;             // column blocks of a tile
  static constexpr int STAGES = D <= 64 ? 3 : 2;
  static constexpr uint32_t Q_BYTES = BQ * D * 2;
  static constexpr uint32_t KV_BYTES = BK * D * 2;
  static constexpr uint32_t K_OFF = Q_BYTES;
  static constexpr uint32_t V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr uint32_t BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // barriers: q full, then k full, v full, k empty, v empty per stage; and
  // the slack that aligns the tiles to 1,024 bytes
  static constexpr size_t SMEM = BAR_OFF + 8 * (1 + 4 * STAGES) + 1024;
};

// the power-of-two exponent e of a (batch, kv head) from the bits of its
// max |v|: e = V16_TOP + 127 - (biased exponent), clamped so that 2^e and
// 2^-e are normal fp32 values
__device__ __forceinline__ int v_exponent(uint32_t amax_bits) {
  const int e = V16_TOP + 127 - (int)((amax_bits >> 23) & 0xFF);
  return e < -126 ? -126 : (e > 126 ? 126 : e);
}
__device__ __forceinline__ float pow2(int e) {   // e in [-126, 127]
  return __int_as_float((127 + e) << 23);
}

constexpr int PREP_THREADS = 256;
constexpr int PREP_ELEMS = 8192;   // elements of v a prep block reads

// max |v| over each (batch, kv head) of v (B, K, S, D): each block a slab
// of rows, reduced to one atomicMax on the bits of a non-negative float
// (their order is the values'); amax is zeroed by the launcher
template <int D>
__global__ void __launch_bounds__(PREP_THREADS)
    swa_v_absmax(const bf16* __restrict__ v, uint32_t* __restrict__ amax,
                 int kv_heads, int s, int64_t sb, int64_t sh, int64_t ss) {
  constexpr int CH = D / 8;                  // 16-byte chunks of a row
  constexpr int ROWS = PREP_ELEMS / D;
  const int bk = blockIdx.y;
  const bf16* vb = v + (bk / kv_heads) * sb + (bk % kv_heads) * sh;
  const int r0 = blockIdx.x * ROWS;
  uint32_t mx = 0;
  for (int e = threadIdx.x; e < ROWS * CH; e += PREP_THREADS) {
    const int r = r0 + e / CH;
    if (r >= s) break;
    const uint4 w = *reinterpret_cast<const uint4*>(vb + (int64_t)r * ss +
                                                     (e % CH) * 8);
    const uint32_t xs[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      mx = max(mx, max(xs[i] & 0x7FFFu, (xs[i] >> 16) & 0x7FFFu));
  }
  mx = __reduce_max_sync(0xffffffffu, mx);
  __shared__ uint32_t part[PREP_THREADS / 32];
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = mx;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < PREP_THREADS / 32; ++w) mx = max(mx, part[w]);
    // a bf16's bits are the high half of the float's
    if (mx) atomicMax(amax + bk, mx << 16);
  }
}

// v16 (B, K, S, D) contiguous fp16 = v 2^e, e from each (batch, kv head)'s
// max |v|: exact for every bf16 value of v down to 2^-27 of the max
template <int D>
__global__ void __launch_bounds__(PREP_THREADS)
    swa_v_half(const bf16* __restrict__ v, const uint32_t* __restrict__ amax,
               __half* __restrict__ v16, int kv_heads, int s, int64_t sb,
               int64_t sh, int64_t ss) {
  constexpr int CH = D / 8;
  constexpr int ROWS = PREP_ELEMS / D;
  const int bk = blockIdx.y;
  const bf16* vb = v + (bk / kv_heads) * sb + (bk % kv_heads) * sh;
  __half* out = v16 + (int64_t)bk * s * D;
  const float scale = pow2(v_exponent(amax[bk]));
  const int r0 = blockIdx.x * ROWS;
  for (int e = threadIdx.x; e < ROWS * CH; e += PREP_THREADS) {
    const int r = r0 + e / CH;
    if (r >= s) break;
    const int c = (e % CH) * 8;
    const uint4 w = *reinterpret_cast<const uint4*>(vb + (int64_t)r * ss + c);
    const uint32_t xs[4] = {w.x, w.y, w.z, w.w};
    uint32_t ys[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(&xs[i]);
      ys[i] = hop::pack_half2(__low2float(p) * scale, __high2float(p) * scale);
    }
    *reinterpret_cast<uint4*>(out + (int64_t)r * D + c) =
        make_uint4(ys[0], ys[1], ys[2], ys[3]);
  }
}

// S (64 x BK) = Q K^T of this warpgroup's 64 queries, issued and committed
template <int D>
__device__ __forceinline__ void issue_s(float (&sc)[Tile<D>::BK / 2],
                                        uint32_t q_wg, uint32_t k_st) {
  using T = Tile<D>;
  hop::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // column block of this 16-deep step, and its byte offset in the row
    const uint32_t c = kk * 16 / T::COL;
    const uint32_t in_row = (kk * 16 % T::COL) * 2;
    const uint64_t a = hop::smem_desc<T::SW>(q_wg + c * BQ * T::SW + in_row,
                                             16, 8 * T::SW);
    const uint64_t b = hop::smem_desc<T::SW>(
        k_st + c * T::BK * T::SW + in_row, 16, 8 * T::SW);
    hop::wgmma_ss_bf16<T::BK>(sc, a, b, kk > 0);
  }
  hop::wgmma_commit();
}

// O (64 x D) += P V, P from registers (with SPLIT, P_lo V + P_hi V),
// issued and committed
template <int D, bool SPLIT>
__device__ __forceinline__ void issue_pv(
    float (&acc)[D / 2], const uint32_t (&pa)[Tile<D>::BK / 16][4],
    const uint32_t (&pl)[SPLIT ? Tile<D>::BK / 16 : 1][4], uint32_t v_st) {
  using T = Tile<D>;
  hop::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < T::BK / 16; ++kk) {
    const uint64_t b = hop::smem_desc<T::SW>(v_st + kk * 16 * T::SW,
                                             T::BK * T::SW, 8 * T::SW);
    if constexpr (SPLIT) hop::wgmma_rs_f16<D>(acc, pl[kk], b, 1);
    hop::wgmma_rs_f16<D>(acc, pa[kk], b, 1);
  }
  hop::wgmma_commit();
}

// A consumer thread's two query rows: r0 (its lane's row g of the warp's
// 16) and r1 = r0 + 8, each with the keys it sees, [lo, hi]: from the
// window's lower edge (or 0) to its diagonal, or to the prefix's last key
// for a row inside the prefix ((j <= i || (j < P && i < P)) is j <=
// last(i), as P - 1 >= i there), never past S - 1; and their online
// softmax state in base 2: running max m (of the scaled scores), this
// thread's share of the row sum l, and alpha, the factor the output must
// take before the next P V.
struct Rows {
  int lo0, hi0, lo1, hi1;
  float m0, m1, l0, l1, alpha0, alpha1;
};

// The softmax of one key tile at k0 on the raw scores in `sc`: with MASK
// (a tile that crosses a row's diagonal, the window's lower edge or S)
// scores outside [lo, hi] become -inf; the row max is taken on the raw
// scores and scaled once, and p = 2^(x scale log2 e - max) is one FFMA
// and one MUFU.EX2. sc receives p (fp32: the row sums take them). A tile
// without MASK runs no mask instruction at all.
template <int BK, bool MASK>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2], Rows& r,
                                             int k0, int t,
                                             float scale_log2) {
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[4 * j + e];
      if (MASK) {
        const int kj = k0 + 8 * j + 2 * t + (e & 1);
        if (kj < (e < 2 ? r.lo0 : r.lo1) || kj > (e < 2 ? r.hi0 : r.hi1))
          x = -INFINITY;
        sc[4 * j + e] = x;
      }
      if (e < 2)
        mx0 = fmaxf(mx0, x);
      else
        mx1 = fmaxf(mx1, x);
    }
  // the four threads of a row are lanes 4g .. 4g + 3
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  // scale_log2 > 0: the max of the scaled scores is the scaled max
  const float mn0 = fmaxf(r.m0, mx0 * scale_log2);
  const float mn1 = fmaxf(r.m1, mx1 * scale_log2);
  // a row with no visible key yet keeps max -inf: subtract 0 instead,
  // so its probabilities stay 2^-inf = 0
  const float base0 = mn0 == -INFINITY ? 0.f : mn0;
  const float base1 = mn1 == -INFINITY ? 0.f : mn1;
  r.alpha0 = hop::ex2(r.m0 - base0);
  r.alpha1 = hop::ex2(r.m1 - base1);
  r.m0 = mn0;
  r.m1 = mn1;
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = hop::ex2(
          fmaf(sc[4 * j + e], scale_log2, e < 2 ? -base0 : -base1));
      sc[4 * j + e] = p;
      if (e < 2)
        s0 += p;
      else
        s1 += p;
    }
  r.l0 = r.l0 * r.alpha0 + s0;
  r.l1 = r.l1 * r.alpha1 + s1;
}

// P (fp32 in the score layout) as the fp16 A fragments of P V: rounded
// once, or with SPLIT as hi and lo parts
template <int BK, bool SPLIT>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BK / 16][4],
                                       uint32_t (&pl)[SPLIT ? BK / 16 : 1][4],
                                       const float (&sc)[BK / 2]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (SPLIT)
        hop::split_half2(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1],
                         pa[kk][i], pl[kk][i]);
      else
        pa[kk][i] =
            hop::pack_half2(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
    }
}

template <int N>
__device__ __forceinline__ void rescale(float (&acc)[N], float a0,
                                        float a1) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] *= (i & 3) < 2 ? a0 : a1;
}

template <int D, bool SPLIT>
__global__ void __launch_bounds__(THREADS, 1)
    swa_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     bf16* __restrict__ o,
                     const uint32_t* __restrict__ vmax, int heads,
                     int group, int kv_heads, int s, int64_t o_sb,
                     int64_t o_sh, int64_t o_ss, int window, int prefix,
                     float scale_log2, float* __restrict__ lse,
                     float* __restrict__ o32) {
  using T = Tile<D>;
  constexpr int BK = T::BK;
  constexpr int STAGES = T::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hop::smem_u32(smem_raw);
  const uint32_t q_s = (raw + 1023u) & ~1023u;
  const uint32_t k_s = q_s + T::K_OFF;
  const uint32_t v_s = q_s + T::V_OFF;
  const uint32_t q_full = q_s + T::BAR_OFF;
  // stage i's barriers
  auto k_full = [&](int i) { return q_full + 8 * (1 + i); };
  auto v_full = [&](int i) { return q_full + 8 * (1 + STAGES + i); };
  auto k_empty = [&](int i) { return q_full + 8 * (1 + 2 * STAGES + i); };
  auto v_empty = [&](int i) { return q_full + 8 * (1 + 3 * STAGES + i); };

  const int tid = threadIdx.x;
  // the warpgroup as a warp-uniform value (a shuffle from lane 0), so the
  // descriptors derived from it stay in uniform registers: computed per
  // thread, they took 8-12 % more time on an H100
  const int wg = __shfl_sync(0xffffffffu, tid / WG, 0);
  const int bh = blockIdx.x;
  const int bi = bh / heads;
  const int hi = bh % heads;
  const int kvh = hi / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int q_last = q0 + BQ - 1 < s ? q0 + BQ - 1 : s - 1;
  // the last key any query of the block sees: its own diagonal, or the
  // end of the prefix for a block that starts inside it
  const int k_last = q0 < prefix && prefix - 1 > q_last ? prefix - 1
                                                         : q_last;
  const int lo = q0 - window + 1 > 0 ? q0 - window + 1 : 0;
  const int k_begin = lo / BK * BK;
  const int n_tiles = (k_last - k_begin) / BK + 1;

  if (tid == 0) {
    hop::mbar_init(q_full, 1);
    for (int i = 0; i < STAGES; ++i) {
      hop::mbar_init(k_full(i), 1);
      hop::mbar_init(v_full(i), 1);
      // released by lane 0 of each of the consumers' eight warps
      hop::mbar_init(k_empty(i), 8);
      hop::mbar_init(v_empty(i), 8);
    }
    hop::fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // the producer: one thread issues every load
    hop::setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == 0) {
      hop::mbar_expect_tx(q_full, T::Q_BYTES);
      for (int c = 0; c < T::NCOL; ++c)
        hop::tma_load_4d(q_s + c * BQ * T::SW, &q_map, q_full, c * T::COL,
                         q0, hi, bi);
      for (int n = 0; n < n_tiles; ++n) {
        const int st = n % STAGES;
        // the stage's previous use released (its first use passes)
        const uint32_t par = ((n / STAGES) & 1) ^ 1;
        const int k0 = k_begin + n * BK;
        const uint32_t ks = k_s + st * T::KV_BYTES;
        const uint32_t vs = v_s + st * T::KV_BYTES;
        hop::mbar_wait(k_empty(st), par);
        hop::mbar_expect_tx(k_full(st), T::KV_BYTES);
        for (int c = 0; c < T::NCOL; ++c)
          hop::tma_load_4d(ks + c * BK * T::SW, &k_map, k_full(st),
                           c * T::COL, k0, kvh, bi);
        hop::mbar_wait(v_empty(st), par);
        hop::mbar_expect_tx(v_full(st), T::KV_BYTES);
        for (int c = 0; c < T::NCOL; ++c)
          hop::tma_load_4d(vs + c * BK * T::SW, &v_map, v_full(st),
                           c * T::COL, k0, kvh, bi);
      }
    }
  } else {
    // the consumers: 64 query rows each
    hop::setmaxnreg_inc<CONSUMER_REGS>();
    const int cw = wg - 1;
    const int ctid = tid - WG * wg;
    const int warp = ctid >> 5;
    const int lane = ctid & 31;
    const int t = lane & 3;
    const int qw0 = q0 + 64 * cw;
    const bool wg_in_prefix = qw0 + 64 <= prefix;
    const uint32_t q_wg = q_s + 64 * cw * T::SW;
    const int r0 = qw0 + 16 * warp + (lane >> 2);
    const int r1 = r0 + 8;
    Rows r;
    r.lo0 = r0 - window + 1 > 0 ? r0 - window + 1 : 0;
    r.lo1 = r1 - window + 1 > 0 ? r1 - window + 1 : 0;
    r.hi0 = min(r0 < prefix ? prefix - 1 : r0, s - 1);
    r.hi1 = min(r1 < prefix ? prefix - 1 : r1, s - 1);
    r.m0 = r.m1 = -INFINITY;
    r.l0 = r.l1 = 0.f;
    r.alpha0 = r.alpha1 = 1.f;
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float sc[BK / 2];
    uint32_t pa[BK / 16][4];
    uint32_t pl[SPLIT ? BK / 16 : 1][4];   // P's lo part (SPLIT only)
    // the key tile at k0 needs the mask where it crosses this warpgroup's
    // diagonal (unless keys and queries all lie inside the prefix: a
    // block wholly below the diagonal is visible whatever P is), the
    // window's lower edge or the end of S
    auto softmax = [&](int k0) {
      if ((k0 + BK - 1 > qw0 && !(wg_in_prefix && k0 + BK <= prefix)) ||
          k0 <= qw0 + 63 - window || k0 + BK > s)
        softmax_tile<BK, true>(sc, r, k0, t, scale_log2);
      else
        softmax_tile<BK, false>(sc, r, k0, t, scale_log2);
    };

    // consumer 0 issues first
    if (cw == 1) hop::bar_arrive(SCHED_BAR, 2 * WG);
    hop::mbar_wait(q_full, 0);

    // tile 0: S alone
    int k0 = k_begin;
    hop::mbar_wait(k_full(0), 0);
    hop::bar_sync(SCHED_BAR + cw, 2 * WG);
    issue_s<D>(sc, q_wg, k_s);
    hop::bar_arrive(SCHED_BAR + 1 - cw, 2 * WG);
    hop::wgmma_wait<0>();
    hop::fence_regs(sc);
    if (lane == 0) hop::mbar_arrive(k_empty(0));
    softmax(k0);
    pack_p<BK, SPLIT>(pa, pl, sc);
    // tile n: S of tile n, then P V of tile n - 1, issued together; the
    // softmax of tile n runs while P V does
    for (int n = 1; n < n_tiles; ++n) {
      const int st = n % STAGES;
      const int ps = (n - 1) % STAGES;
      k0 += BK;
      hop::mbar_wait(k_full(st), (n / STAGES) & 1);
      hop::bar_sync(SCHED_BAR + cw, 2 * WG);
      issue_s<D>(sc, q_wg, k_s + st * T::KV_BYTES);
      rescale(acc, r.alpha0, r.alpha1);
      hop::mbar_wait(v_full(ps), ((n - 1) / STAGES) & 1);
      issue_pv<D, SPLIT>(acc, pa, pl, v_s + ps * T::KV_BYTES);
      hop::bar_arrive(SCHED_BAR + 1 - cw, 2 * WG);
      hop::wgmma_wait<1>();
      hop::fence_regs(sc);
      if (lane == 0) hop::mbar_arrive(k_empty(st));
      softmax(k0);
      hop::wgmma_wait<0>();
      hop::fence_regs(acc);
      hop::fence_regs(sc);   // P's registers are rewritten after P V read them
      if (lane == 0) hop::mbar_arrive(v_empty(ps));
      pack_p<BK, SPLIT>(pa, pl, sc);
    }
    // P V of the last tile
    const int ls = (n_tiles - 1) % STAGES;
    rescale(acc, r.alpha0, r.alpha1);
    hop::mbar_wait(v_full(ls), ((n_tiles - 1) / STAGES) & 1);
    issue_pv<D, SPLIT>(acc, pa, pl, v_s + ls * T::KV_BYTES);
    hop::wgmma_wait<0>();
    hop::fence_regs(acc);
    // consumer 1 arrived once more on consumer 0's barrier than consumer
    // 0 waited: close that phase before the block ends
    if (cw == 0) hop::bar_sync(SCHED_BAR, 2 * WG);

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      r.l0 += __shfl_xor_sync(0xffffffffu, r.l0, off);
      r.l1 += __shfl_xor_sync(0xffffffffu, r.l1, off);
    }
    // l >= 1 for a row before S: its diagonal key is visible. The output
    // takes 1 / l and 2^-e, undoing v's scale
    const float inv0 = 1.f / r.l0;
    const float inv1 = 1.f / r.l1;
    const float unscale =
        pow2(-v_exponent(vmax[(int64_t)bi * kv_heads + kvh]));
    if (lse != nullptr && t == 0) {
      // m is in base 2 (scores times scale * log2 e): lse = (m + log2 l) ln 2
      if (r0 < s) lse[(int64_t)bh * s + r0] = (r.m0 + log2f(r.l0)) * LN2;
      if (r1 < s) lse[(int64_t)bh * s + r1] = (r.m1 + log2f(r.l1)) * LN2;
    }
    bf16* ob = o + bi * o_sb + hi * o_sh;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (r0 < s)
        *reinterpret_cast<uint32_t*>(ob + r0 * o_ss + col) =
            hop::pack_bf162(acc[4 * j] * inv0 * unscale,
                            acc[4 * j + 1] * inv0 * unscale);
      if (r1 < s)
        *reinterpret_cast<uint32_t*>(ob + r1 * o_ss + col) =
            hop::pack_bf162(acc[4 * j + 2] * inv1 * unscale,
                            acc[4 * j + 3] * inv1 * unscale);
    }
    if (o32 == nullptr) return;
    // the same output unrounded, for the backward's D = rowsum(dO o)
    float* of = o32 + (int64_t)bh * s * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (r0 < s)
        *reinterpret_cast<float2*>(of + (int64_t)r0 * D + col) =
            make_float2(acc[4 * j] * inv0 * unscale,
                        acc[4 * j + 1] * inv0 * unscale);
      if (r1 < s)
        *reinterpret_cast<float2*>(of + (int64_t)r1 * D + col) =
            make_float2(acc[4 * j + 2] * inv1 * unscale,
                        acc[4 * j + 3] * inv1 * unscale);
    }
  }
}

// v's scale and fp16 copy, the three tensor maps, then the kernel, all on
// `stream`. v16: (B, K, S, D) fp16 scratch; vmax: B K uint32 scratch.
template <int D>
int launch(const void* q, const void* k, const void* v, void* o,
           int64_t batch, int64_t heads, int64_t kv_heads, int64_t s,
           const int64_t* st, int64_t window, int64_t prefix, float scale,
           void* v16, void* vmax, float* lse, float* o32,
           cudaStream_t stream) {
  using T = Tile<D>;
  uint32_t* amax = static_cast<uint32_t*>(vmax);
  cudaError_t err = cudaMemsetAsync(
      amax, 0, sizeof(uint32_t) * (size_t)(batch * kv_heads), stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 prep((unsigned)ceil_div(s, PREP_ELEMS / D),
                  (unsigned)(batch * kv_heads));
  const bf16* vb = static_cast<const bf16*>(v);
  swa_v_absmax<D><<<prep, PREP_THREADS, 0, stream>>>(
      vb, amax, (int)kv_heads, (int)s, st[6], st[7], st[8]);
  swa_v_half<D><<<prep, PREP_THREADS, 0, stream>>>(
      vb, amax, static_cast<__half*>(v16), (int)kv_heads, (int)s, st[6],
      st[7], st[8]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  CUtensorMap qm, km, vm;
  int bad = hop::encode_bsxd(&qm, q, false, D, s, heads, batch, st[2], st[1],
                             st[0], T::COL, BQ, T::SW);
  if (!bad)
    bad = hop::encode_bsxd(&km, k, false, D, s, kv_heads, batch, st[5],
                           st[4], st[3], T::COL, T::BK, T::SW);
  if (!bad)
    bad = hop::encode_bsxd(&vm, v16, true, D, s, kv_heads, batch, D, s * D,
                           kv_heads * s * D, T::COL, T::BK, T::SW);
  if (bad) return bad;
  // training's forward (o32 asked for) splits P: the backward's D =
  // rowsum(dO o32) needs o32 to fp32's accuracy
  auto kernel = o32 != nullptr ? swa_wgmma_kernel<D, true>
                               : swa_wgmma_kernel<D, false>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)T::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(batch * heads), (unsigned)ceil_div(s, BQ));
  kernel<<<grid, THREADS, T::SMEM, stream>>>(
      qm, km, vm, static_cast<bf16*>(o), amax, (int)heads,
      (int)(heads / kv_heads), (int)kv_heads, (int)s, st[9], st[10], st[11],
      (int)(window < s ? window : s), (int)prefix, scale * LOG2E, lse, o32);
  return (int)cudaGetLastError();
}

}  // namespace wgr

// ---------------------------------------------------------------------------
// fp32: the CUDA-core kernel
// ---------------------------------------------------------------------------
constexpr int BQ = 64;         // queries of a block
constexpr int BK = 64;         // keys of one step
constexpr int THREADS = 256;   // 16 x 16
constexpr int QP = BQ + 1;     // padded row of the transposed q tile
constexpr int KP = BK + 1;     // padded row of the transposed k tile / p
constexpr float NEG = -1.0e30f;

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.f; }

template <typename T, int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * BQ * KP +
         sizeof(T) * ((size_t)D * QP + (size_t)D * KP + (size_t)BK * D);
}

// One block per SM at most at D = 256 (shared memory), so the second
// bound lets a thread take up to 255 registers: no spills at D = 256.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
    swa_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o, int64_t heads,
               int64_t group, int64_t s, int64_t q_sb, int64_t q_sh,
               int64_t q_ss, int64_t k_sb, int64_t k_sh, int64_t k_ss,
               int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t o_sb,
               int64_t o_sh, int64_t o_ss, int64_t window, int64_t prefix,
               float scale, float* __restrict__ lse) {
  constexpr int DJ = D / 16;   // output columns of a thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* ps = reinterpret_cast<float*>(smem);              // [BQ][KP]
  T* qt = reinterpret_cast<T*>(ps + BQ * KP);              // [D][QP]
  T* kt = qt + D * QP;                                      // [D][KP]
  T* vs = kt + D * KP;                                      // [BK][D]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int64_t bh = blockIdx.y;
  const int64_t bi = bh / heads;
  const int64_t hi = bh % heads;
  const int64_t kvh = hi / group;
  const int64_t q0 = (int64_t)blockIdx.x * BQ;
  const T* qb = q + bi * q_sb + hi * q_sh;
  const T* kb = k + bi * k_sb + kvh * k_sh;
  const T* vb = v + bi * v_sb + kvh * v_sh;
  T* ob = o + bi * o_sb + hi * o_sh;

  // q tile, transposed; a warp reads 32 consecutive d of one row
  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D;
    const int d = e % D;
    const int64_t qi = q0 + r;
    qt[d * QP + r] = qi < s ? qb[qi * q_ss + d] : zero_of<T>();
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = 0.f;
  }

  const int64_t q_last = q0 + BQ - 1 < s ? q0 + BQ - 1 : s - 1;
  // a block that starts inside the prefix also reads the keys up to P - 1
  const int64_t k_last = q0 < prefix && prefix - 1 > q_last ? prefix - 1
                                                             : q_last;
  const int64_t lo = q0 - window + 1 > 0 ? q0 - window + 1 : 0;
  for (int64_t k0 = lo / BK * BK; k0 <= k_last; k0 += BK) {
    __syncthreads();   // the previous step is done with kt, vs and ps
    for (int e = tid; e < BK * D; e += THREADS) {
      const int r = e / D;
      const int d = e % D;
      const int64_t kj = k0 + r;
      const bool in = kj < s;
      kt[d * KP + r] = in ? kb[kj * k_ss + d] : zero_of<T>();
      vs[r * D + d] = in ? vb[kj * v_ss + d] : zero_of<T>();
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = to_f32(qt[d * QP + ty + 16 * i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = to_f32(kt[d * KP + tx + 16 * j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t qi = q0 + ty + 16 * i;
      // the last key row qi sees: its diagonal, or the prefix's last key
      const int64_t last = qi < prefix ? prefix - 1 : qi;
      bool ok[4];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t kj = k0 + tx + 16 * j;
        ok[j] = kj <= last && kj > qi - window && kj < s;
        sc[i][j] = ok[j] ? sc[i][j] * scale : NEG;
        mx = fmaxf(mx, sc[i][j]);
      }
      // the 16 threads of a row are lanes 0-15 or 16-31 of one warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(sc[i][j] - m_new) : 0.f;
        ps[(ty + 16 * i) * KP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) acc[i][jj] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * KP + c];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        const float vv = to_f32(vs[c * D + tx + 16 * jj]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(pv[i], vv, acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t qi = q0 + ty + 16 * i;
    if (qi >= s) continue;
    const float inv = 1.f / l[i];   // l >= 1: the diagonal key is visible
    if (lse != nullptr && tx == 0) lse[bh * s + qi] = m[i] + logf(l[i]);
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj)
      store_out(ob + qi * o_ss + tx + 16 * jj, acc[i][jj] * inv);
  }
}


template <int D>
int launch_simt(const void* q, const void* k, const void* v, void* o,
                int64_t batch, int64_t heads, int64_t kv_heads, int64_t s,
                const int64_t* st, int64_t window, int64_t prefix,
                float scale, float* lse, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<float, D>();
  cudaError_t err = cudaFuncSetAttribute(
      swa_kernel<float, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)ceil_div(s, BQ), (unsigned)(batch * heads), 1);
  swa_kernel<float, D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), heads,
      heads / kv_heads, s, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], window, prefix, scale, lse);
  return (int)cudaGetLastError();
}

// fp32 to the CUDA cores, bf16 to the tensor cores
template <int D>
int dispatch(int dtype, const void* q, const void* k, const void* v, void* o,
             int64_t batch, int64_t heads, int64_t kv_heads, int64_t s,
             const int64_t* st, int64_t window, int64_t prefix, float scale,
             void* v16, void* vmax, float* lse, float* o32,
             cudaStream_t stream) {
  if (dtype == 0)
    return launch_simt<D>(q, k, v, o, batch, heads, kv_heads, s, st, window,
                          prefix, scale, lse, stream);
  return wgr::launch<D>(q, k, v, o, batch, heads, kv_heads, s, st, window,
                        prefix, scale, v16, vmax, lse, o32, stream);
}

}  // namespace

// dtype of q, k, v and o: 0 = float32, 1 = bfloat16. head_dim one of 32,
// 64, 128, 256. strides: 12 element strides, (batch, head, position) of
// q, k, v and o in that order; D is contiguous. batch * heads <= 65,535
// and S < 2^31 (the wrapper checks). For bf16 every position stride is a
// multiple of 8 and every base 16-byte aligned (TMA; the wrapper checks).
// window >= 1; prefix in [0, S] (the wrapper checks). v16 and vmax (bf16
// only; null for fp32): scratch of (B, K, S, D) fp16 and B K uint32 that
// receive v's fp16 copy and its max |v| per (batch, kv head). lse: null,
// or fp32 contiguous (B, H, S) that receives each row's log-sum-exp. o32:
// null, or (bf16 only) fp32 contiguous (B, H, S, D) that receives the
// output before it is rounded to bf16 (the backward's D reads it).
// Returns a cudaError_t, or a tensor-map status (hop::ENCODE_MISSING and
// above).
extern "C" int swa_launch(int dtype, int head_dim, const void* q,
                          const void* k, const void* v, void* o,
                          int64_t batch, int64_t heads, int64_t kv_heads,
                          int64_t s, const int64_t* strides, int64_t window,
                          int64_t prefix, float scale, void* v16_out,
                          void* vmax_out, void* lse_out, void* o32_out,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_out);
  float* o32 = static_cast<float*>(o32_out);
  switch (head_dim) {
    case 32:
      return dispatch<32>(dtype, q, k, v, o, batch, heads, kv_heads, s,
                          strides, window, prefix, scale, v16_out, vmax_out,
                          lse, o32, st);
    case 64:
      return dispatch<64>(dtype, q, k, v, o, batch, heads, kv_heads, s,
                          strides, window, prefix, scale, v16_out, vmax_out,
                          lse, o32, st);
    case 128:
      return dispatch<128>(dtype, q, k, v, o, batch, heads, kv_heads, s,
                           strides, window, prefix, scale, v16_out, vmax_out,
                           lse, o32, st);
    case 256:
      return dispatch<256>(dtype, q, k, v, o, batch, heads, kv_heads, s,
                           strides, window, prefix, scale, v16_out, vmax_out,
                           lse, o32, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
