// Backward of sliding-window causal attention with an optional
// bidirectional prefix (swa.cu): given q (B, H, S, D), k, v (B, K, S, D),
// the forward's output o (B, H, S, D), its per-row log-sum-exp lse
// (B, H, S) fp32 and the output's gradient dO (B, H, S, D), compute dQ, dK
// and dV, FlashAttention-2 style:
//   P_ij  = exp(q_i . k_j * scale - lse_i)   over the keys i sees,
//           j in (i - window, last(i)], last(i) = P - 1 for i < P, else i
//           (the forward's mask: (j <= i or j, i < P) and j > i - window)
//   D_i   = sum_d dO_id o_id
//   dP_ij = dO_i . v_j
//   dS_ij = P_ij (dP_ij - D_i)
//   dQ_i  = scale sum_j dS_ij k_j
//   dK_j  = scale sum_i dS_ij q_i      (over every query head of k's head)
//   dV_j  = sum_i P_ij dO_i            (likewise)
// H a multiple of K (GQA: head h reads kv head h / (H / K)). fp32 or bf16
// in and out (q, k, v, dO and the three gradients of one type); o, lse and
// D fp32: the bf16 forward hands over its output before rounding, so D
// reads what the CPU's fp32 plain version reads (from a bf16 o, dQ at
// whisper-medium's encoder came out 13-999 % of its norm off on an NVIDIA
// H100, as attention over similar frames is near uniform and dP - D
// nearly cancels). Nothing
// is added atomically: every sum runs in a fixed order, so the result
// repeats bit for bit.
//
// The prefix (PaliGemma's 256 image patches; Whisper's encoder at prefix
// = window = S) changes which tiles a block walks, not the work per tile:
// a dQ block that starts below P walks keys up to max(q_last, P - 1), as
// the forward does; a dK/dV block whose keys start below P takes queries
// from 0 (a key j < P is seen by the queries [0, min(j + window, S))),
// where without a prefix it starts at its own first key.
//
// The TPU kernel src/repro/kernels/swa/swa.py::swa_pallas has no
// backward: the JAX package differentiates its XLA attention. The port
// routes every full forward through swa.cu, so training on the card needs
// this kernel (the "swa" autograd Function of kernels/swa/ops.py).
//
// Bound on the H100: operations. The five band products (S and dP
// recomputed, dV, dK, dQ) are 10 D flops per (query, visible key) pair:
// 0.52 TFLOP at the training shape B 2, H 16, S 4,096, D 256, window
// 2,048, 0.52 ms at the bf16 tensor-core rate. Both routes below compute
// S and dP twice, once for dQ and once for dK and dV (seven products), in
// exchange for no atomics.
//
// Two routes, picked by the input type (swa_bwd_route), with no fallback
// between them:
//
// bf16 (training's path): two warp-specialised kernels built from
// Hopper's own parts (hopper_bf16.cuh), after swa_bwd_dot writes D. Each
// block is three warpgroups: a producer, its registers lowered to 40 by
// setmaxnreg, in which one thread issues TMA loads (cp.async.bulk.tensor
// over (B, X, S, D) tensor maps) into 128-byte swizzled tiles (64-byte at
// D = 32) in column blocks of 64 elements, each stage guarded by full and
// empty mbarriers; and two consumer warpgroups at 232 registers that
// issue wgmma products on those tiles. Here:
//   * rounding: S, dP, D and every sum stay fp32; P and dS are rounded
//     once to bf16 as the A operands of their products, from registers
//     (tests/test_torch_precision.py emulates the plan), and the
//     gradients once at the store;
//   * swa_bwd_dq_wgmma: a block takes 128 queries of one (batch, head),
//     64 a consumer, and walks the key tiles of their band, last query
//     tile first. q and dO stay in shared memory; key and value tiles of
//     BK rows (64; 32 at D = 256, where q and dO for 128 queries take 128
//     KB) come through a ring of 3 stages. Per tile a consumer issues S =
//     Q K^T and dP = dO V^T (both operands K-major, the two sums' steps
//     interleaved), then dQ += dS K of the tile before, dS from registers
//     (the score accumulator's layout is the A fragment's) and K MN-major
//     through the transpose bit; dS of this tile runs while that product
//     does. At D = 256 a consumer holds 128 + 16 + 16 fp32 accumulators;
//   * swa_bwd_dkdv_wgmma: a block takes the keys of one (batch, kv head)
//     (k and v stay) and a share of the kv head's query heads, and walks
//     their 64-query tiles of the keys' band, q, dO and their lse and D
//     rows (written by a second producer warp) through a ring of 3 stages
//     (2 at D = 256). The keys are the rows of every product, so P^T and
//     dS^T come out of the accumulators in the A layout of the next
//     product. At D <= 64 (OWN) each consumer owns 64 keys of its own, 128
//     a block, and all four products: S^T = K Q^T and dP^T = V dO^T, then
//     dV += P^T dO and dK += dS^T Q. At D >= 128, where one 64 x D fp32
//     sum is 64-128 registers a thread and both would not fit, the two
//     consumers own the same 64 keys: consumer 0 computes S^T, P^T and
//     dV; consumer 1 computes dP^T, takes P^T in fp32 through a 16 KB
//     shared tile behind two named barriers, forms dS^T and dK;
//   * a dK/dV consumer runs a step's two products in order within the
//     step; issued after the next step's first, as dQ's are, the second
//     gained nothing measurable at D = 64 and, with two stages at D =
//     256, held both stages and stalled the loads
//     (launch/swa_bwd_variants.py, ahead and ahead_two_stages);
//   * MQA: a kv head's query heads are split over up to four dK/dV blocks
//     (RecurrentGemma's 16 heads to 1: 512 blocks where one per key tile
//     would give 128). With more than one split each block writes fp32
//     partial dK and dV to a scratch the wrapper allocates, 2 x splits x
//     B K S D x 4 bytes (67 MB at the training shape), and swa_bwd_reduce
//     sums the partials in split order and rounds them to bf16; with one
//     split the block writes bf16 itself and nothing more is allocated;
//   * the mask is a template flag, taken only on tiles that cross the
//     diagonal, the window's lower edge, the prefix or the end of S;
//     interior tiles run no mask instruction. Rows and keys past S arrive
//     as zeros from TMA's out-of-bounds fill and get P = 0;
//   * as the forward learned: no timeout in the mbarrier wait, fences
//     without a memory clobber, a warp-uniform warpgroup index.
// Shared memory (DqTile, KvTile; one block an SM): dQ 41, 81, 161, 225 KB
// and dK/dV 43, 83, 147, 210 KB at D = 32, 64, 128, 256.
// On an NVIDIA H100 80GB HBM3 at 700 W (backward_check --only time) it
// runs RecurrentGemma's training shape in 1.32 ms (dQ 0.57, dK/dV 0.64, D
// 0.07, the split sum 0.03), 39 % of the bound, and Whisper's encoder (4
// x 16 x 1,500 x 64, prefix = S) in 0.35 ms on the device (dQ 0.125,
// dK/dV 0.20, D 0.026), 26 %. What bounds it: each kernel reaches 35-45 %
// of the tensor-core rate on its own products, seven of them where the bound
// counts five (S and dP are computed twice, once for dQ and once for dK
// and dV, in exchange for no atomics). Not the operand reads from shared
// memory: holding the fixed A operands in registers at D = 64 (q and dO
// in dQ, k and v in dK/dV; swa_bwd_variants.py regs_a) ran no faster. At D = 256 dQ's 32-key tiles
// make S and dP m64n32 products, whose A and B reads near shared
// memory's 128 bytes a clock; larger key tiles do not fit beside q and
// dO. FlashAttention-2's backward through SDPA, five products with dQ
// summed atomically, takes 0.28 ms on the device at Whisper's encoder.
//
// fp32 (the JAX tests' 2e-5 rules out rounding P and dS to bf16): the
// first, CUDA-core kernels, every product in fp32 FMA from operands
// widened to fp32 as they are loaded, P and dS never rounded:
//   * swa_bwd_dot computes D, one warp per row (both routes use it).
//     swa_bwd_dq gives a block 32 queries of one (batch, head) and walks
//     the key tiles of their band, recomputing S and dP; swa_bwd_dkdv
//     gives a block 32 keys of one (batch, kv head) and walks, for each
//     query head of the group, the query tiles of the keys' band;
//   * a block is 256 threads as 16 x 16; thread (ty, tx) owns rows ty,
//     ty + 16 and columns tx, tx + 16 of a 32 x 32 score tile, and rows ty,
//     ty + 16 by columns tx + 16 jj (jj < D / 16) of its fp32 accumulators
//     (32 registers in dq, 64 in dkdv at D = 256). The four operand tiles
//     sit in shared memory widened to fp32 and transposed (d-major, rows
//     padded to 33 floats so that both the row-wise reads of the score
//     products and the column-wise reads of the gradient products fall in
//     distinct banks), 140-144 KB at D = 256, one block an SM;
//   * keys outside the band, and rows or keys past S, get P = 0.
// Head dims 32, 64, 128 and 256, as the forward.
#include <math.h>

#include "fp32_tiles.cuh"
#include "hopper_bf16.cuh"

using fp32_tiles::ceil_div;
using fp32_tiles::to_f32;

namespace {

// ---------------------------------------------------------------------------
// fp32: the CUDA-core kernels
// ---------------------------------------------------------------------------
constexpr int BQ = 32;         // queries of a tile
constexpr int BK = 32;         // keys of a tile
constexpr int P = 33;          // padded row of a transposed tile
constexpr int THREADS = 256;   // 16 x 16

__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }

template <int D>
constexpr size_t tiles_bytes() {
  // four transposed operand tiles, two 32 x 33 score tiles, two row vectors
  return sizeof(float) * (4 * (size_t)D * P + 2 * (size_t)BK * P + 2 * BQ);
}

// rows [r0, r0 + 32) of a (S, D) matrix with row stride ld, transposed
// into dst[d * P + r] as fp32; rows at or past s read as zeros
template <typename T, int D>
__device__ __forceinline__ void load_t(float* dst, const T* src, int64_t ld,
                                       int64_t r0, int64_t s, int tid) {
  for (int e = tid; e < 32 * D; e += THREADS) {
    const int r = e / D;
    const int d = e % D;
    const int64_t gr = r0 + r;
    dst[d * P + r] = gr < s ? to_f32(src[gr * ld + d]) : 0.f;
  }
}

// D_row = sum_d dO_row,d o_row,d: one warp per row of (B * H * S)
template <typename T>
__global__ void __launch_bounds__(THREADS)
    swa_bwd_dot(const float* __restrict__ o, const T* __restrict__ dout,
                float* __restrict__ dvec, int64_t heads, int64_t s, int d,
                int64_t o_sb, int64_t o_sh, int64_t o_ss, int64_t g_sb,
                int64_t g_sh, int64_t g_ss, int64_t rows) {
  const int64_t row = (int64_t)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int64_t i = row % s;
  const int64_t bh = row / s;
  const int64_t bi = bh / heads;
  const int64_t hi = bh % heads;
  const float* op = o + bi * o_sb + hi * o_sh + i * o_ss;
  const T* gp = dout + bi * g_sb + hi * g_sh + i * g_ss;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) acc = fmaf(op[c], to_f32(gp[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) dvec[row] = acc;
}

// strides of one operand: (batch, head, position), in elements
struct Strides {
  int64_t b, h, s;
};

// the last key query i sees: its diagonal, or the prefix's last key for a
// query inside the prefix ((j <= i or j, i < P) is j <= last(i))
template <typename I>
__device__ __forceinline__ I last_key(I i, I prefix) {
  return i < prefix ? prefix - 1 : i;
}

struct Args {
  int64_t heads, group, s, window, prefix;
  float scale;
  Strides q, k, v, dout, dq, dk, dv;
};

// dQ of 32 queries of one (batch, head): grid (ceil(S / 32), B * H)
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
    swa_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ dvec,
               T* __restrict__ dq, Args a) {
  constexpr int DJ = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qt = reinterpret_cast<float*>(smem);   // [D][P]
  float* gt = qt + D * P;                       // dO, [D][P]
  float* kt = gt + D * P;                       // [D][P]
  float* vt = kt + D * P;                       // [D][P]
  float* ds = vt + D * P;                       // [BQ][P]
  float* lse_s = ds + 2 * BK * P;               // [BQ]
  float* dv_s = lse_s + BQ;                     // [BQ]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int64_t bh = blockIdx.y;
  const int64_t bi = bh / a.heads;
  const int64_t hi = bh % a.heads;
  const int64_t kvh = hi / a.group;
  const int64_t s = a.s;
  const int64_t q0 = (int64_t)blockIdx.x * BQ;
  const T* kb = k + bi * a.k.b + kvh * a.k.h;
  const T* vb = v + bi * a.v.b + kvh * a.v.h;

  load_t<T, D>(qt, q + bi * a.q.b + hi * a.q.h, a.q.s, q0, s, tid);
  load_t<T, D>(gt, dout + bi * a.dout.b + hi * a.dout.h, a.dout.s, q0, s,
               tid);
  if (tid < BQ) {
    const int64_t qi = q0 + tid;
    lse_s[tid] = qi < s ? lse[bh * s + qi] : 0.f;
    dv_s[tid] = qi < s ? dvec[bh * s + qi] : 0.f;
  }

  float acc[2][DJ];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = 0.f;

  const int64_t q_last = q0 + BQ - 1 < s ? q0 + BQ - 1 : s - 1;
  // a block that starts inside the prefix also reads the keys up to P - 1
  const int64_t k_last = q0 < a.prefix && a.prefix - 1 > q_last
                             ? a.prefix - 1
                             : q_last;
  const int64_t lo = q0 - a.window + 1 > 0 ? q0 - a.window + 1 : 0;
  for (int64_t k0 = lo / BK * BK; k0 <= k_last; k0 += BK) {
    __syncthreads();   // the previous step is done with kt, vt and ds
    load_t<T, D>(kt, kb, a.k.s, k0, s, tid);
    load_t<T, D>(vt, vb, a.v.s, k0, s, tid);
    __syncthreads();

    float sc[2][2], dp[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float q0v = qt[d * P + ty], q1v = qt[d * P + ty + 16];
      const float g0v = gt[d * P + ty], g1v = gt[d * P + ty + 16];
      const float k0v = kt[d * P + tx], k1v = kt[d * P + tx + 16];
      const float v0v = vt[d * P + tx], v1v = vt[d * P + tx + 16];
      sc[0][0] = fmaf(q0v, k0v, sc[0][0]);
      sc[0][1] = fmaf(q0v, k1v, sc[0][1]);
      sc[1][0] = fmaf(q1v, k0v, sc[1][0]);
      sc[1][1] = fmaf(q1v, k1v, sc[1][1]);
      dp[0][0] = fmaf(g0v, v0v, dp[0][0]);
      dp[0][1] = fmaf(g0v, v1v, dp[0][1]);
      dp[1][0] = fmaf(g1v, v0v, dp[1][0]);
      dp[1][1] = fmaf(g1v, v1v, dp[1][1]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = ty + 16 * i;
      const int64_t qi = q0 + r;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = tx + 16 * j;
        const int64_t kj = k0 + c;
        const bool ok = qi < s && kj < s && kj <= last_key(qi, a.prefix) &&
                        kj > qi - a.window;
        const float p = ok ? expf(sc[i][j] * a.scale - lse_s[r]) : 0.f;
        ds[r * P + c] = p * (dp[i][j] - dv_s[r]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float d0 = ds[ty * P + c], d1 = ds[(ty + 16) * P + c];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        const float kv = kt[(tx + 16 * jj) * P + c];
        acc[0][jj] = fmaf(d0, kv, acc[0][jj]);
        acc[1][jj] = fmaf(d1, kv, acc[1][jj]);
      }
    }
  }

  T* ob = dq + bi * a.dq.b + hi * a.dq.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t qi = q0 + ty + 16 * i;
    if (qi >= s) continue;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj)
      store_as(ob + qi * a.dq.s + tx + 16 * jj, acc[i][jj] * a.scale);
  }
}

// dK and dV of 32 keys of one (batch, kv head), summed over the group's
// query heads: grid (ceil(S / 32), B * K)
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
    swa_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ dvec, T* __restrict__ dk,
                 T* __restrict__ dv, int64_t kv_heads, Args a) {
  constexpr int DJ = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* kt = reinterpret_cast<float*>(smem);   // [D][P]
  float* vt = kt + D * P;                       // [D][P]
  float* qt = vt + D * P;                       // [D][P]
  float* gt = qt + D * P;                       // dO, [D][P]
  float* pt = gt + D * P;                       // P^T, [BK][P]
  float* dst = pt + BK * P;                     // dS^T, [BK][P]
  float* lse_s = dst + BK * P;                  // [BQ]
  float* dv_s = lse_s + BQ;                     // [BQ]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int64_t bk = blockIdx.y;
  const int64_t bi = bk / kv_heads;
  const int64_t kvh = bk % kv_heads;
  const int64_t s = a.s;
  const int64_t k0 = (int64_t)blockIdx.x * BK;

  load_t<T, D>(kt, k + bi * a.k.b + kvh * a.k.h, a.k.s, k0, s, tid);
  load_t<T, D>(vt, v + bi * a.v.b + kvh * a.v.h, a.v.s, k0, s, tid);

  float acc_k[2][DJ], acc_v[2][DJ];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc_k[i][jj] = acc_v[i][jj] = 0.f;

  // queries that see a key of this tile: [k0, k0 + BK - 1 + window - 1],
  // from 0 for a tile that starts inside the prefix
  const int64_t k_last = k0 + BK - 1 < s ? k0 + BK - 1 : s - 1;
  const int64_t q_end = k_last + a.window - 1 < s - 1 ? k_last + a.window - 1
                                                      : s - 1;
  const int64_t q_begin = k0 < a.prefix ? 0 : k0 / BQ * BQ;
  for (int64_t g = 0; g < a.group; ++g) {
    const int64_t hi = kvh * a.group + g;
    const int64_t bh = bi * a.heads + hi;
    const T* qb = q + bi * a.q.b + hi * a.q.h;
    const T* gb = dout + bi * a.dout.b + hi * a.dout.h;
    for (int64_t q0 = q_begin; q0 <= q_end; q0 += BQ) {
      __syncthreads();   // the previous step is done with qt, gt, pt, dst
      load_t<T, D>(qt, qb, a.q.s, q0, s, tid);
      load_t<T, D>(gt, gb, a.dout.s, q0, s, tid);
      if (tid < BQ) {
        const int64_t qi = q0 + tid;
        lse_s[tid] = qi < s ? lse[bh * s + qi] : 0.f;
        dv_s[tid] = qi < s ? dvec[bh * s + qi] : 0.f;
      }
      __syncthreads();

      // S^T (keys x queries) and dP^T = V dO^T
      float sc[2][2], dp[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float k0v = kt[d * P + ty], k1v = kt[d * P + ty + 16];
        const float v0v = vt[d * P + ty], v1v = vt[d * P + ty + 16];
        const float q0v = qt[d * P + tx], q1v = qt[d * P + tx + 16];
        const float g0v = gt[d * P + tx], g1v = gt[d * P + tx + 16];
        sc[0][0] = fmaf(k0v, q0v, sc[0][0]);
        sc[0][1] = fmaf(k0v, q1v, sc[0][1]);
        sc[1][0] = fmaf(k1v, q0v, sc[1][0]);
        sc[1][1] = fmaf(k1v, q1v, sc[1][1]);
        dp[0][0] = fmaf(v0v, g0v, dp[0][0]);
        dp[0][1] = fmaf(v0v, g1v, dp[0][1]);
        dp[1][0] = fmaf(v1v, g0v, dp[1][0]);
        dp[1][1] = fmaf(v1v, g1v, dp[1][1]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = ty + 16 * i;
        const int64_t kj = k0 + r;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = tx + 16 * j;
          const int64_t qi = q0 + c;
          const bool ok = qi < s && kj < s &&
                          kj <= last_key(qi, a.prefix) &&
                          kj > qi - a.window;
          const float p = ok ? expf(sc[i][j] * a.scale - lse_s[c]) : 0.f;
          pt[r * P + c] = p;
          dst[r * P + c] = p * (dp[i][j] - dv_s[c]);
        }
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q
#pragma unroll 2
      for (int c = 0; c < BQ; ++c) {
        const float p0 = pt[ty * P + c], p1 = pt[(ty + 16) * P + c];
        const float d0 = dst[ty * P + c], d1 = dst[(ty + 16) * P + c];
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) {
          const float gv = gt[(tx + 16 * jj) * P + c];
          const float qv = qt[(tx + 16 * jj) * P + c];
          acc_v[0][jj] = fmaf(p0, gv, acc_v[0][jj]);
          acc_v[1][jj] = fmaf(p1, gv, acc_v[1][jj]);
          acc_k[0][jj] = fmaf(d0, qv, acc_k[0][jj]);
          acc_k[1][jj] = fmaf(d1, qv, acc_k[1][jj]);
        }
      }
    }
  }

  T* kb = dk + bi * a.dk.b + kvh * a.dk.h;
  T* vb = dv + bi * a.dv.b + kvh * a.dv.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t kj = k0 + ty + 16 * i;
    if (kj >= s) continue;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      store_as(kb + kj * a.dk.s + tx + 16 * jj, acc_k[i][jj] * a.scale);
      store_as(vb + kj * a.dv.s + tx + 16 * jj, acc_v[i][jj]);
    }
  }
}

// D = rowsum(dO o) of every row, the first launch of both routes
template <typename T>
cudaError_t launch_dot(const float* o, const T* dout, float* dvec,
                       int64_t batch, int d, const int64_t* st,
                       const Args& a, cudaStream_t stream) {
  const int64_t rows = batch * a.heads * a.s;
  swa_bwd_dot<T><<<(unsigned)ceil_div(rows, THREADS / 32), THREADS, 0,
                   stream>>>(o, dout, dvec, a.heads, a.s, d, st[9], st[10],
                             st[11], a.dout.b, a.dout.h, a.dout.s, rows);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: the warp-specialised wgmma kernels
// ---------------------------------------------------------------------------
namespace wgmma_bwd {

using bf16 = __nv_bfloat16;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int WG = 128;              // threads of a warpgroup
constexpr int THREADS = 3 * WG;      // producer, consumer 0, consumer 1
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;   // 128 x 40 + 256 x 232 <= 65,536
constexpr size_t SMEM_MAX = 232448;  // dynamic shared memory of a block
// named barriers of the dK/dV kernel's P^T tile: written (consumer 0
// arrives, consumer 1 waits), and read (the other way round)
constexpr int P_FULL_BAR = 1;
constexpr int P_EMPTY_BAR = 2;
constexpr int RED_THREADS = 256;

// a tile's column blocks: rows of 64 elements (32 at D = 32), landed by
// TMA with a swizzle of the row's bytes
template <int D>
struct Cols {
  static constexpr int COL = D < 64 ? D : 64;
  static constexpr int SW = 2 * COL;
  static constexpr int NCOL = D / COL;
};

// The dQ kernel's tiles (kernels/swa/swa.py's BWD_TILES mirrors the rows
// and stages): 128 queries a block, 64 a consumer; a ring of key and value
// tiles of BK rows. q and dO stay for the whole block.
template <int D>
struct DqTile : Cols<D> {
  static constexpr int BQ = 128;
  static constexpr int BK = D == 256 ? 32 : 64;
  static constexpr int STAGES = 3;
  static constexpr uint32_t Q_BYTES = BQ * D * 2;
  static constexpr uint32_t KV_BYTES = BK * D * 2;
  static constexpr uint32_t G_OFF = Q_BYTES;
  static constexpr uint32_t K_OFF = 2 * Q_BYTES;
  static constexpr uint32_t V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr uint32_t BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // barriers: q and dO full, then full and empty per stage; and the slack
  // that aligns the tiles to 1,024 bytes
  static constexpr size_t SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
  static_assert(SMEM <= SMEM_MAX, "dQ tiles past a block's shared memory");
};

// The dK/dV kernel's tiles: a block's keys (k and v stay), a ring of
// query steps (q, dO, their lse log2 e and D rows), and, where the
// consumers split the sums (not OWN), the fp32 P^T tile they pass between
// them. With OWN (D <= 64) each consumer owns 64 keys of its own and both
// sums, 128 keys a block; without (D >= 128, where dK and dV together
// would take 128-256 registers a thread) both own the same 64 keys.
// Steps are 64 queries.
template <int D>
struct KvTile : Cols<D> {
  static constexpr bool OWN = D <= 64;
  static constexpr int BK = OWN ? 128 : 64;
  static constexpr int BQ = 64;
  static constexpr int STAGES = D == 256 ? 2 : 3;
  static constexpr uint32_t KV_BYTES = BK * D * 2;
  static constexpr uint32_t Q_BYTES = BQ * D * 2;
  static constexpr uint32_t V_OFF = KV_BYTES;
  static constexpr uint32_t Q_OFF = 2 * KV_BYTES;
  static constexpr uint32_t G_OFF = Q_OFF + STAGES * Q_BYTES;
  static constexpr uint32_t P_BYTES = OWN ? 0 : 64 * BQ * 4;
  static constexpr uint32_t P_OFF = G_OFF + STAGES * Q_BYTES;
  static constexpr uint32_t L_OFF = P_OFF + P_BYTES;
  static constexpr uint32_t DV_OFF = L_OFF + STAGES * BQ * 4;
  static constexpr uint32_t BAR_OFF = DV_OFF + STAGES * BQ * 4;
  // barriers: k and v full, then full and empty per stage; the slack
  static constexpr size_t SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
  static_assert(SMEM <= SMEM_MAX, "dK/dV tiles past a block's shared memory");
};

struct Params {
  int heads, group, kv_heads, s, window, prefix;
  float scale, scale_log2;
};

// descriptor of a K-major operand (the reduction axis along the row) and
// of an MN-major B operand whose column blocks lie `rows` rows apart
template <int SW>
__device__ __forceinline__ uint64_t k_major(uint32_t addr) {
  return hop::smem_desc<SW>(addr, 16, 8 * SW);
}
template <int SW>
__device__ __forceinline__ uint64_t mn_major(uint32_t addr, int rows) {
  return hop::smem_desc<SW>(addr, rows * SW, 8 * SW);
}

// the accumulator columns 16 kk .. 16 kk + 15 of a 64 x N fp32 tile,
// rounded once to bf16, as the A fragment of step kk of the next product
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&pa)[N / 16][4],
                                       const float (&x)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pa[kk][i] = hop::pack_bf162(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
}

// S = Q K^T and dP = dO V^T of this warpgroup's 64 queries against the key
// tile at k_st, v_st, all four operands K-major, the two sums' steps
// interleaved; issued and committed as one group
template <int D>
__device__ __forceinline__ void issue_s_dp(float (&sc)[DqTile<D>::BK / 2],
                                           float (&dp)[DqTile<D>::BK / 2],
                                           uint32_t q_wg, uint32_t g_wg,
                                           uint32_t k_st, uint32_t v_st) {
  using T = DqTile<D>;
  hop::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // column block of this 16-deep step, and its byte offset in the row
    const uint32_t c = kk * 16 / T::COL;
    const uint32_t in_row = (kk * 16 % T::COL) * 2;
    const uint32_t qa = c * T::BQ * T::SW + in_row;
    const uint32_t kb = c * T::BK * T::SW + in_row;
    hop::wgmma_ss_bf16<T::BK>(sc, k_major<T::SW>(q_wg + qa),
                              k_major<T::SW>(k_st + kb), kk > 0);
    hop::wgmma_ss_bf16<T::BK>(dp, k_major<T::SW>(g_wg + qa),
                              k_major<T::SW>(v_st + kb), kk > 0);
  }
  hop::wgmma_commit();
}

// dQ += dS K over the key tile at k_st: dS from registers, K MN-major
// through the transpose bit; issued and committed
template <int D>
__device__ __forceinline__ void issue_dq(
    float (&acc)[D / 2], const uint32_t (&pa)[DqTile<D>::BK / 16][4],
    uint32_t k_st) {
  using T = DqTile<D>;
  hop::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < T::BK / 16; ++kk)
    hop::wgmma_rs_bf16<D>(
        acc, pa[kk], mn_major<T::SW>(k_st + kk * 16 * T::SW, T::BK), 1);
  hop::wgmma_commit();
}

// A dQ consumer thread's two query rows r0 (its lane's row g of the
// warp's 16) and r1 = r0 + 8: the keys each sees, [lo, hi] (from the
// window's lower edge or 0 to its diagonal, or to the prefix's last key
// for a row inside the prefix, never past S - 1), its lse log2 e (+inf
// past S: P = 0) and its D
struct QRows {
  int lo0, hi0, lo1, hi1;
  float l0, l1, d0, d1;
};

// dS = P (dP - D) of the key tile at k0, in place of the scores, P =
// 2^(S scale log2 e - lse log2 e) in one FFMA and one MUFU.EX2; with MASK
// (a tile that crosses a row's diagonal, the window's lower edge, the
// prefix or S) P = 0 outside each row's [lo, hi]. A tile without MASK
// runs no mask instruction.
template <int BK, bool MASK>
__device__ __forceinline__ void ds_rows(float (&sc)[BK / 2],
                                        const float (&dp)[BK / 2],
                                        const QRows& r, int k0, int t,
                                        float scale_log2) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool top = e < 2;
      float p = hop::ex2(fmaf(sc[4 * j + e], scale_log2, top ? -r.l0 : -r.l1));
      if (MASK) {
        const int kj = k0 + 8 * j + 2 * t + (e & 1);
        if (kj < (top ? r.lo0 : r.lo1) || kj > (top ? r.hi0 : r.hi1))
          p = 0.f;
      }
      sc[4 * j + e] = p * (dp[4 * j + e] - (top ? r.d0 : r.d1));
    }
}

// dQ of 128 queries of one (batch, head): grid (B H, ceil(S / 128)), the
// last query tile first (it walks the most key tiles)
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    swa_bwd_dq_wgmma(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap g_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const float* __restrict__ lse,
                     const float* __restrict__ dvec, bf16* __restrict__ dq,
                     Strides sq, Params p) {
  using T = DqTile<D>;
  constexpr int BQ = T::BQ;
  constexpr int BK = T::BK;
  constexpr int STAGES = T::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s = (hop::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t g_s = q_s + T::G_OFF;
  const uint32_t k_s = q_s + T::K_OFF;
  const uint32_t v_s = q_s + T::V_OFF;
  const uint32_t q_full = q_s + T::BAR_OFF;
  auto full = [&](int i) { return q_full + 8 * (1 + i); };
  auto empty = [&](int i) { return q_full + 8 * (1 + STAGES + i); };

  const int tid = threadIdx.x;
  // warp-uniform (a shuffle from lane 0): the descriptors derived from it
  // stay in uniform registers
  const int wg = __shfl_sync(0xffffffffu, tid / WG, 0);
  const int bh = blockIdx.x;
  const int bi = bh / p.heads;
  const int hi = bh % p.heads;
  const int kvh = hi / p.group;
  const int s = p.s;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int q_last = q0 + BQ - 1 < s ? q0 + BQ - 1 : s - 1;
  // the last key any query of the block sees: its own diagonal, or the
  // end of the prefix for a block that starts inside it
  const int k_last = q0 < p.prefix && p.prefix - 1 > q_last ? p.prefix - 1
                                                             : q_last;
  const int lo = q0 - p.window + 1 > 0 ? q0 - p.window + 1 : 0;
  const int k_begin = lo / BK * BK;
  const int n_tiles = (k_last - k_begin) / BK + 1;

  if (tid == 0) {
    hop::mbar_init(q_full, 1);
    for (int i = 0; i < STAGES; ++i) {
      hop::mbar_init(full(i), 1);
      // released by lane 0 of each of the consumers' eight warps
      hop::mbar_init(empty(i), 8);
    }
    hop::fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // the producer: one thread issues every load
    hop::setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == 0) {
      hop::mbar_expect_tx(q_full, 2 * T::Q_BYTES);
      for (int c = 0; c < T::NCOL; ++c) {
        hop::tma_load_4d(q_s + c * BQ * T::SW, &q_map, q_full, c * T::COL,
                         q0, hi, bi);
        hop::tma_load_4d(g_s + c * BQ * T::SW, &g_map, q_full, c * T::COL,
                         q0, hi, bi);
      }
      for (int n = 0; n < n_tiles; ++n) {
        const int st = n % STAGES;
        const int k0 = k_begin + n * BK;
        const uint32_t ks = k_s + st * T::KV_BYTES;
        const uint32_t vs = v_s + st * T::KV_BYTES;
        // the stage's previous use released (its first use passes)
        hop::mbar_wait(empty(st), ((n / STAGES) & 1) ^ 1);
        hop::mbar_expect_tx(full(st), 2 * T::KV_BYTES);
        for (int c = 0; c < T::NCOL; ++c) {
          hop::tma_load_4d(ks + c * BK * T::SW, &k_map, full(st),
                           c * T::COL, k0, kvh, bi);
          hop::tma_load_4d(vs + c * BK * T::SW, &v_map, full(st),
                           c * T::COL, k0, kvh, bi);
        }
      }
    }
  } else {
    // the consumers: 64 query rows each, over the same key tiles
    hop::setmaxnreg_inc<CONSUMER_REGS>();
    const int cw = wg - 1;
    const int ctid = tid - WG * wg;
    const int warp = ctid >> 5;
    const int lane = ctid & 31;
    const int t = lane & 3;
    const int qw0 = q0 + 64 * cw;
    const bool wg_in_prefix = qw0 + 64 <= p.prefix;
    const uint32_t q_wg = q_s + 64 * cw * T::SW;
    const uint32_t g_wg = g_s + 64 * cw * T::SW;
    const int r0 = qw0 + 16 * warp + (lane >> 2);
    const int r1 = r0 + 8;
    const int64_t row = (int64_t)bh * s;
    QRows r;
    r.l0 = r0 < s ? lse[row + r0] * LOG2E : INFINITY;
    r.l1 = r1 < s ? lse[row + r1] * LOG2E : INFINITY;
    r.d0 = r0 < s ? dvec[row + r0] : 0.f;
    r.d1 = r1 < s ? dvec[row + r1] : 0.f;
    r.lo0 = r0 - p.window + 1 > 0 ? r0 - p.window + 1 : 0;
    r.lo1 = r1 - p.window + 1 > 0 ? r1 - p.window + 1 : 0;
    r.hi0 = min(r0 < p.prefix ? p.prefix - 1 : r0, s - 1);
    r.hi1 = min(r1 < p.prefix ? p.prefix - 1 : r1, s - 1);
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float sc[BK / 2], dp[BK / 2];
    uint32_t pa[BK / 16][4];
    // the key tile at k0 needs the mask where it crosses this warpgroup's
    // diagonal (unless keys and queries all lie inside the prefix), the
    // window's lower edge or the end of S
    auto ds = [&](int k0) {
      if ((k0 + BK - 1 > qw0 && !(wg_in_prefix && k0 + BK <= p.prefix)) ||
          k0 <= qw0 + 63 - p.window || k0 + BK > s)
        ds_rows<BK, true>(sc, dp, r, k0, t, p.scale_log2);
      else
        ds_rows<BK, false>(sc, dp, r, k0, t, p.scale_log2);
    };

    hop::mbar_wait(q_full, 0);
    // tile 0: S and dP alone
    int k0 = k_begin;
    hop::mbar_wait(full(0), 0);
    issue_s_dp<D>(sc, dp, q_wg, g_wg, k_s, v_s);
    hop::wgmma_wait<0>();
    hop::fence_regs(sc);
    hop::fence_regs(dp);
    ds(k0);
    pack_a<BK>(pa, sc);
    // tile n: S and dP of tile n, then dQ's product of tile n - 1, issued
    // together; dS of tile n runs while that product does
    for (int n = 1; n < n_tiles; ++n) {
      const int st = n % STAGES;
      const int ps = (n - 1) % STAGES;
      k0 += BK;
      hop::mbar_wait(full(st), (n / STAGES) & 1);
      issue_s_dp<D>(sc, dp, q_wg, g_wg, k_s + st * T::KV_BYTES,
                    v_s + st * T::KV_BYTES);
      issue_dq<D>(acc, pa, k_s + ps * T::KV_BYTES);
      hop::wgmma_wait<1>();
      hop::fence_regs(sc);
      hop::fence_regs(dp);
      ds(k0);
      hop::wgmma_wait<0>();
      hop::fence_regs(acc);
      hop::fence_regs(sc);   // dS's registers are packed after dQ read pa
      if (lane == 0) hop::mbar_arrive(empty(ps));
      pack_a<BK>(pa, sc);
    }
    issue_dq<D>(acc, pa, k_s + (n_tiles - 1) % STAGES * T::KV_BYTES);
    hop::wgmma_wait<0>();
    hop::fence_regs(acc);

    bf16* ob = dq + bi * sq.b + hi * sq.h;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (r0 < s)
        *reinterpret_cast<uint32_t*>(ob + r0 * sq.s + col) =
            hop::pack_bf162(acc[4 * j] * p.scale, acc[4 * j + 1] * p.scale);
      if (r1 < s)
        *reinterpret_cast<uint32_t*>(ob + r1 * sq.s + col) =
            hop::pack_bf162(acc[4 * j + 2] * p.scale,
                            acc[4 * j + 3] * p.scale);
    }
  }
}

// the first product of a dK/dV step, keys as rows: S^T = K Q^T (consumer
// 0) or dP^T = V dO^T (consumer 1), A the block's key tile at a_s, B the
// step's query tile at b_st, both K-major; issued and committed
template <int D>
__device__ __forceinline__ void issue_t(float (&x)[KvTile<D>::BQ / 2],
                                        uint32_t a_s, uint32_t b_st) {
  using T = KvTile<D>;
  hop::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t c = kk * 16 / T::COL;
    const uint32_t in_row = (kk * 16 % T::COL) * 2;
    hop::wgmma_ss_bf16<T::BQ>(
        x, k_major<T::SW>(a_s + c * T::BK * T::SW + in_row),
        k_major<T::SW>(b_st + c * T::BQ * T::SW + in_row), kk > 0);
  }
  hop::wgmma_commit();
}

// the second: dV += P^T dO (consumer 0) or dK += dS^T Q (consumer 1), A
// from registers, B the step's dO or q tile MN-major; issued and committed
template <int D>
__device__ __forceinline__ void issue_acc(
    float (&acc)[D / 2], const uint32_t (&pa)[KvTile<D>::BQ / 16][4],
    uint32_t b_st) {
  using T = KvTile<D>;
  hop::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < T::BQ / 16; ++kk)
    hop::wgmma_rs_bf16<D>(
        acc, pa[kk], mn_major<T::SW>(b_st + kk * 16 * T::SW, T::BQ), 1);
  hop::wgmma_commit();
}

// OWN: both first products of a step, S^T = K Q^T and dP^T = V dO^T of
// this consumer's keys (the tiles at k_c, v_c), interleaved; one group
template <int D>
__device__ __forceinline__ void issue_t2(float (&sc)[KvTile<D>::BQ / 2],
                                         float (&dp)[KvTile<D>::BQ / 2],
                                         uint32_t k_c, uint32_t v_c,
                                         uint32_t q_st, uint32_t g_st) {
  using T = KvTile<D>;
  hop::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t c = kk * 16 / T::COL;
    const uint32_t in_row = (kk * 16 % T::COL) * 2;
    const uint32_t a = c * T::BK * T::SW + in_row;
    const uint32_t b = c * T::BQ * T::SW + in_row;
    hop::wgmma_ss_bf16<T::BQ>(sc, k_major<T::SW>(k_c + a),
                              k_major<T::SW>(q_st + b), kk > 0);
    hop::wgmma_ss_bf16<T::BQ>(dp, k_major<T::SW>(v_c + a),
                              k_major<T::SW>(g_st + b), kk > 0);
  }
  hop::wgmma_commit();
}

// OWN: both second products, dV += P^T dO and dK += dS^T Q, interleaved;
// one group
template <int D>
__device__ __forceinline__ void issue_acc2(
    float (&acc_v)[D / 2], const uint32_t (&pa)[KvTile<D>::BQ / 16][4],
    float (&acc_k)[D / 2], const uint32_t (&pd)[KvTile<D>::BQ / 16][4],
    uint32_t q_st, uint32_t g_st) {
  using T = KvTile<D>;
  hop::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < T::BQ / 16; ++kk) {
    hop::wgmma_rs_bf16<D>(
        acc_v, pa[kk], mn_major<T::SW>(g_st + kk * 16 * T::SW, T::BQ), 1);
    hop::wgmma_rs_bf16<D>(
        acc_k, pd[kk], mn_major<T::SW>(q_st + kk * 16 * T::SW, T::BQ), 1);
  }
  hop::wgmma_commit();
}

// dS^T = P^T (dP^T - D) in place of dP^T, D by query column (dd the
// step's D row)
template <int BQ>
__device__ __forceinline__ void ds_cols(float (&dp)[BQ / 2],
                                        const float (&pt)[BQ / 2],
                                        const float* dd, int t) {
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j) {
    const float2 d2 = *reinterpret_cast<const float2*>(dd + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dp[4 * j + e] = pt[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? d2.y : d2.x));
  }
}

// rows kj0 and kj0 + 8 of one gradient of a block's keys, acc times mul:
// bf16 at ob (row stride ld) with one split, else fp32 into the split's
// partial at pb (row stride D); rows past S are not written
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2],
                                           float mul, int kj0, int s, int t,
                                           bf16* ob, int64_t ld, float* pb) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kj = kj0 + 8 * h;
      if (kj >= s) continue;
      const float x0 = acc[4 * j + 2 * h] * mul;
      const float x1 = acc[4 * j + 2 * h + 1] * mul;
      if (pb != nullptr)
        *reinterpret_cast<float2*>(pb + (int64_t)kj * D + col) =
            make_float2(x0, x1);
      else
        *reinterpret_cast<uint32_t*>(ob + kj * ld + col) =
            hop::pack_bf162(x0, x1);
    }
  }
}

// P^T of one step in place of S^T (keys kj0 and kj0 + 8 as this thread's
// rows, queries q0 + column): p = 2^(S^T scale log2 e - lse log2 e), ls
// the step's lse log2 e by query; with MASK pairs outside the band, the
// prefix or S get 0
template <int BQ, bool MASK>
__device__ __forceinline__ void p_cols(float (&x)[BQ / 2],
                                       const float* ls, int q0, int kj0,
                                       int t, const Params& p) {
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j) {
    const int c = 8 * j + 2 * t;
    const float2 l = *reinterpret_cast<const float2*>(ls + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = hop::ex2(fmaf(x[4 * j + e], p.scale_log2,
                              (e & 1) ? -l.y : -l.x));
      if (MASK) {
        const int qi = q0 + c + (e & 1);
        const int kj = kj0 + (e < 2 ? 0 : 8);
        const int last = qi < p.prefix ? p.prefix - 1 : qi;
        if (!(kj <= last && kj > qi - p.window && qi < p.s && kj < p.s))
          v = 0.f;
      }
      x[4 * j + e] = v;
    }
  }
}

// dK and dV of 64 keys of one (batch, kv head) over one split of its query
// heads: grid (splits, B K, ceil(S / 64)), the key tile slowest, so blocks
// start in key order (without a prefix the first tiles have the most
// queries; a tile that starts below P takes its queries from 0). With one
// split the block writes dK and dV in bf16; with more, fp32 partials to
// part, (2, splits, B K, S, D): dK (scaled) then dV, which swa_bwd_reduce
// sums in split order.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    swa_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap g_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const float* __restrict__ lse,
                       const float* __restrict__ dvec,
                       bf16* __restrict__ dk, bf16* __restrict__ dv,
                       float* __restrict__ part, Strides sk, Strides sv,
                       int per_split, Params p) {
  using T = KvTile<D>;
  constexpr int BK = T::BK;
  constexpr int BQ = T::BQ;
  constexpr int STAGES = T::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hop::smem_u32(smem_raw);
  const uint32_t k_s = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (k_s - raw);
  const uint32_t v_s = k_s + T::V_OFF;
  const uint32_t q_s = k_s + T::Q_OFF;
  const uint32_t g_s = k_s + T::G_OFF;
  float* lse_s = reinterpret_cast<float*>(smem + T::L_OFF);
  float* d_s = reinterpret_cast<float*>(smem + T::DV_OFF);
  const uint32_t kv_full = k_s + T::BAR_OFF;
  auto full = [&](int i) { return kv_full + 8 * (1 + i); };
  auto empty = [&](int i) { return kv_full + 8 * (1 + STAGES + i); };

  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid / WG, 0);
  const int split = blockIdx.x;
  const int splits = gridDim.x;
  const int bk = blockIdx.y;
  const int bi = bk / p.kv_heads;
  const int kvh = bk % p.kv_heads;
  const int s = p.s;
  const int k0 = blockIdx.z * BK;
  // this split's heads and each head's query tiles: from k0, or from 0
  // for a key tile that starts inside the prefix (a key j < P is seen by
  // the queries [0, min(j + window, S)))
  const int h_lo = kvh * p.group + split * per_split;
  const int h_end = (kvh + 1) * p.group;
  const int n_heads = h_lo >= h_end ? 0 : min(h_end - h_lo, per_split);
  const int k_last = k0 + BK - 1 < s ? k0 + BK - 1 : s - 1;
  const int q_end = k_last + p.window - 1 < s - 1 ? k_last + p.window - 1
                                                  : s - 1;
  const int q_begin = k0 < p.prefix ? 0 : k0;
  const int n_q = (q_end - q_begin) / BQ + 1;
  const int n_steps = n_heads * n_q;

  if (tid == 0) {
    hop::mbar_init(kv_full, 1);
    for (int i = 0; i < STAGES; ++i) {
      // the TMA's arrival and the 32 lanes that write lse and D
      hop::mbar_init(full(i), 1 + 32);
      hop::mbar_init(empty(i), 8);
    }
    hop::fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    hop::setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == 0 && n_steps > 0) {
      // k and v once, then q and dO of every step
      hop::mbar_expect_tx(kv_full, 2 * T::KV_BYTES);
      for (int c = 0; c < T::NCOL; ++c) {
        hop::tma_load_4d(k_s + c * BK * T::SW, &k_map, kv_full, c * T::COL,
                         k0, kvh, bi);
        hop::tma_load_4d(v_s + c * BK * T::SW, &v_map, kv_full, c * T::COL,
                         k0, kvh, bi);
      }
      for (int n = 0; n < n_steps; ++n) {
        const int st = n % STAGES;
        const int hi = h_lo + n / n_q;
        const int q0 = q_begin + n % n_q * BQ;
        hop::mbar_wait(empty(st), ((n / STAGES) & 1) ^ 1);
        hop::mbar_expect_tx(full(st), 2 * T::Q_BYTES);
        for (int c = 0; c < T::NCOL; ++c) {
          hop::tma_load_4d(q_s + st * T::Q_BYTES + c * BQ * T::SW, &q_map,
                           full(st), c * T::COL, q0, hi, bi);
          hop::tma_load_4d(g_s + st * T::Q_BYTES + c * BQ * T::SW, &g_map,
                           full(st), c * T::COL, q0, hi, bi);
        }
      }
    } else if (tid >= 32 && tid < 64) {
      // warp 1: each step's lse log2 e and D rows (zeros past S)
      const int lane = tid - 32;
      for (int n = 0; n < n_steps; ++n) {
        const int st = n % STAGES;
        const int hi = h_lo + n / n_q;
        const int q0 = q_begin + n % n_q * BQ;
        const int64_t row = ((int64_t)bi * p.heads + hi) * s;
        hop::mbar_wait(empty(st), ((n / STAGES) & 1) ^ 1);
        for (int r = lane; r < BQ; r += 32) {
          const int qi = q0 + r;
          lse_s[st * BQ + r] = qi < s ? lse[row + qi] * LOG2E : 0.f;
          d_s[st * BQ + r] = qi < s ? dvec[row + qi] : 0.f;
        }
        hop::mbar_arrive(full(st));
      }
    }
  } else {
    hop::setmaxnreg_inc<CONSUMER_REGS>();
    const int cw = wg - 1;
    const int ctid = tid - WG * wg;
    const int warp = ctid >> 5;
    const int lane = ctid & 31;
    const int t = lane & 3;
    // the 64 keys this consumer's rows hold: its own (OWN), or the block's
    const int kc0 = T::OWN ? k0 + 64 * cw : k0;
    const int kj0 = kc0 + 16 * warp + (lane >> 2);
    // a step needs the mask where it crosses these keys' diagonal (unless
    // queries and keys all lie inside the prefix), the window's lower
    // edge or the end of S
    auto masked = [&](int q0) {
      return (kc0 + 63 > q0 && !(q0 + BQ <= p.prefix && kc0 + 64 <= p.prefix)) ||
             kc0 <= q0 + BQ - 1 - p.window || kc0 + 64 > s || q0 + BQ > s;
    };
    const int64_t per = (int64_t)gridDim.y * s * D;   // one split's partial
    auto partial = [&](int w) {   // 0: dK, 1: dV
      return splits == 1 ? nullptr
                         : part + (w * splits + split) * per + (int64_t)bk * s * D;
    };
    bf16* dk_b = dk + bi * sk.b + kvh * sk.h;
    bf16* dv_b = dv + bi * sv.b + kvh * sv.h;
    if (n_steps > 0) hop::mbar_wait(kv_full, 0);
    if constexpr (T::OWN) {
      // S^T and dP^T, then dV and dK, all four of this consumer's keys
      const uint32_t k_c = k_s + 64 * cw * T::SW;
      const uint32_t v_c = v_s + 64 * cw * T::SW;
      float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
      float sc[BQ / 2], dp[BQ / 2];
      uint32_t pa[BQ / 16][4], pd[BQ / 16][4];
      for (int n = 0; n < n_steps; ++n) {
        const int st = n % STAGES;
        const int q0 = q_begin + n % n_q * BQ;
        hop::mbar_wait(full(st), (n / STAGES) & 1);
        issue_t2<D>(sc, dp, k_c, v_c, q_s + st * T::Q_BYTES,
                    g_s + st * T::Q_BYTES);
        hop::wgmma_wait<0>();
        hop::fence_regs(sc);
        hop::fence_regs(dp);
        if (masked(q0))
          p_cols<BQ, true>(sc, lse_s + st * BQ, q0, kj0, t, p);
        else
          p_cols<BQ, false>(sc, lse_s + st * BQ, q0, kj0, t, p);
        ds_cols<BQ>(dp, sc, d_s + st * BQ, t);
        pack_a<BQ>(pa, sc);
        pack_a<BQ>(pd, dp);
        issue_acc2<D>(acc_v, pa, acc_k, pd, q_s + st * T::Q_BYTES,
                      g_s + st * T::Q_BYTES);
        hop::wgmma_wait<0>();
        hop::fence_regs(acc_k);
        hop::fence_regs(acc_v);
        if (lane == 0) hop::mbar_arrive(empty(st));
      }
      store_rows<D>(acc_k, p.scale, kj0, s, t, dk_b, sk.s, partial(0));
      store_rows<D>(acc_v, 1.f, kj0, s, t, dv_b, sv.s, partial(1));
    } else {
      // consumer 0: S^T, P^T, dV; consumer 1: dP^T, dS^T (P^T from
      // consumer 0 through shared memory), dK. Two products each.
      // This thread's P^T values, 128 float2 apart: the same accumulator
      // positions in both consumers, so each thread of consumer 1 reads
      // what its counterpart in consumer 0 wrote.
      float2* pt = reinterpret_cast<float2*>(smem + T::P_OFF) + ctid;
      const uint32_t a_s = cw == 0 ? k_s : v_s;
      // the second product's B: dO (consumer 0) or q of a stage
      const uint32_t b2_s = cw == 0 ? g_s : q_s;
      float acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      float x[BQ / 2];
      uint32_t pa[BQ / 16][4];
      if (n_steps > 0 && cw == 1)
        hop::bar_arrive(P_EMPTY_BAR, 2 * WG);   // the P^T tile starts free
      for (int n = 0; n < n_steps; ++n) {
        const int st = n % STAGES;
        const int q0 = q_begin + n % n_q * BQ;
        hop::mbar_wait(full(st), (n / STAGES) & 1);
        issue_t<D>(x, a_s, (cw == 0 ? q_s : g_s) + st * T::Q_BYTES);
        hop::wgmma_wait<0>();
        hop::fence_regs(x);
        if (cw == 0) {
          if (masked(q0))
            p_cols<BQ, true>(x, lse_s + st * BQ, q0, kj0, t, p);
          else
            p_cols<BQ, false>(x, lse_s + st * BQ, q0, kj0, t, p);
          hop::bar_sync(P_EMPTY_BAR, 2 * WG);
#pragma unroll
          for (int j = 0; j < BQ / 8; ++j) {
            pt[(2 * j) * WG] = make_float2(x[4 * j], x[4 * j + 1]);
            pt[(2 * j + 1) * WG] = make_float2(x[4 * j + 2], x[4 * j + 3]);
          }
          hop::bar_arrive(P_FULL_BAR, 2 * WG);
        } else {
          float pv[BQ / 2];
          hop::bar_sync(P_FULL_BAR, 2 * WG);
#pragma unroll
          for (int j = 0; j < BQ / 8; ++j) {
            const float2 p0 = pt[(2 * j) * WG];
            const float2 p1 = pt[(2 * j + 1) * WG];
            pv[4 * j] = p0.x;
            pv[4 * j + 1] = p0.y;
            pv[4 * j + 2] = p1.x;
            pv[4 * j + 3] = p1.y;
          }
          if (n + 1 < n_steps) hop::bar_arrive(P_EMPTY_BAR, 2 * WG);
          ds_cols<BQ>(x, pv, d_s + st * BQ, t);
        }
        pack_a<BQ>(pa, x);
        issue_acc<D>(acc, pa, b2_s + st * T::Q_BYTES);
        hop::wgmma_wait<0>();
        hop::fence_regs(acc);
        if (lane == 0) hop::mbar_arrive(empty(st));
      }
      // dV (consumer 0) or dK, scaled (consumer 1)
      if (cw == 0)
        store_rows<D>(acc, 1.f, kj0, s, t, dv_b, sv.s, partial(1));
      else
        store_rows<D>(acc, p.scale, kj0, s, t, dk_b, sk.s, partial(0));
    }
  }
}

// dK and dV in bf16 from the partials: each element the sum of its
// splits in split order, four elements a thread
__global__ void __launch_bounds__(RED_THREADS)
    swa_bwd_reduce(const float* __restrict__ part, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int64_t splits, int64_t kv_heads,
                   int64_t s, int d, Strides sk, Strides sv, int64_t per) {
  const int64_t e = ((int64_t)blockIdx.x * RED_THREADS + threadIdx.x) * 4;
  if (e >= per) return;
  const int64_t col = e % d;
  const int64_t row = e / d;
  const int64_t j = row % s;
  const int64_t bk = row / s;
  const int64_t bi = bk / kv_heads;
  const int64_t kvh = bk % kv_heads;
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    const float* src = part + w * splits * per + e;
    float4 sum = *reinterpret_cast<const float4*>(src);
    for (int64_t sp = 1; sp < splits; ++sp) {
      const float4 x = *reinterpret_cast<const float4*>(src + sp * per);
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    const Strides st = w == 0 ? sk : sv;
    bf16* dst = (w == 0 ? dk : dv) + bi * st.b + kvh * st.h + j * st.s + col;
    *reinterpret_cast<uint2*>(dst) = make_uint2(
        hop::pack_bf162(sum.x, sum.y), hop::pack_bf162(sum.z, sum.w));
  }
}

// D, the tensor maps, dQ, dK/dV (and with more than one split the sum of
// the partials), all on `stream`
template <int D>
int launch(const bf16* q, const bf16* k, const bf16* v, const float* o,
           const bf16* dout, const float* lse, float* dvec, bf16* dq,
           bf16* dk, bf16* dv, float* part, int64_t batch, int64_t kv_heads,
           int64_t splits, const int64_t* st, const Args& a,
           cudaStream_t stream) {
  using QT = DqTile<D>;
  using KT = KvTile<D>;
  cudaError_t err = launch_dot(o, dout, dvec, batch, D, st, a, stream);
  if (err != cudaSuccess) return (int)err;

  // (B, X, S, D) maps of q and dO (query heads) and k and v (kv heads),
  // boxes of each kernel's tile rows
  CUtensorMap dq_q, dq_g, dq_k, dq_v;
  auto map = [&](CUtensorMap* m, const void* ptr, int64_t x, int i,
                 int box_rows) {
    return hop::encode_bsxd(m, ptr, false, D, a.s, x, batch, st[i + 2],
                            st[i + 1], st[i], QT::COL, box_rows, QT::SW);
  };
  int bad = map(&dq_q, q, a.heads, 0, QT::BQ);
  if (!bad) bad = map(&dq_g, dout, a.heads, 12, QT::BQ);
  if (!bad) bad = map(&dq_k, k, kv_heads, 3, QT::BK);
  if (!bad) bad = map(&dq_v, v, kv_heads, 6, QT::BK);
  // the dK/dV kernel's: the dQ kernel's where the boxes agree
  CUtensorMap kv_q = dq_q, kv_g = dq_g, kv_k = dq_k, kv_v = dq_v;
  if (!bad && KT::BQ != QT::BQ) {
    bad = map(&kv_q, q, a.heads, 0, KT::BQ);
    if (!bad) bad = map(&kv_g, dout, a.heads, 12, KT::BQ);
  }
  if (!bad && KT::BK != QT::BK) {
    bad = map(&kv_k, k, kv_heads, 3, KT::BK);
    if (!bad) bad = map(&kv_v, v, kv_heads, 6, KT::BK);
  }
  if (bad) return bad;

  Params p;
  p.heads = (int)a.heads;
  p.group = (int)a.group;
  p.kv_heads = (int)kv_heads;
  p.s = (int)a.s;
  p.window = (int)(a.window < a.s ? a.window : a.s);
  p.prefix = (int)a.prefix;
  p.scale = a.scale;
  p.scale_log2 = a.scale * LOG2E;
  err = cudaFuncSetAttribute(swa_bwd_dq_wgmma<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)QT::SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(swa_bwd_dkdv_wgmma<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)KT::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_q((unsigned)(batch * a.heads),
                    (unsigned)ceil_div(a.s, QT::BQ));
  swa_bwd_dq_wgmma<D><<<grid_q, THREADS, QT::SMEM, stream>>>(
      dq_q, dq_g, dq_k, dq_v, lse, dvec, dq, a.dq, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_k((unsigned)splits, (unsigned)(batch * kv_heads),
                    (unsigned)ceil_div(a.s, KT::BK));
  swa_bwd_dkdv_wgmma<D><<<grid_k, THREADS, KT::SMEM, stream>>>(
      kv_q, kv_g, kv_k, kv_v, lse, dvec, dk, dv, part, a.dk, a.dv,
      (int)ceil_div(a.group, splits), p);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int64_t per = batch * kv_heads * a.s * D;
  swa_bwd_reduce<<<(unsigned)ceil_div(per / 4, RED_THREADS), RED_THREADS, 0,
                   stream>>>(part, dk, dv, splits, kv_heads, a.s, D, a.dk,
                             a.dv, per);
  return (int)cudaGetLastError();
}

}  // namespace wgmma_bwd

// fp32: the CUDA-core kernels
template <int D>
int launch_simt(const float* q, const float* k, const float* v,
                const float* o, const float* dout, const float* lse,
                float* dvec, float* dq, float* dk, float* dv, int64_t batch,
                int64_t kv_heads, const int64_t* st, Args a,
                cudaStream_t stream) {
  constexpr size_t bytes = tiles_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      swa_bwd_dq<float, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(swa_bwd_dkdv<float, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return (int)err;
  err = launch_dot(o, dout, dvec, batch, D, st, a, stream);
  if (err != cudaSuccess) return (int)err;
  dim3 grid_q((unsigned)ceil_div(a.s, BQ), (unsigned)(batch * a.heads), 1);
  swa_bwd_dq<float, D><<<grid_q, THREADS, bytes, stream>>>(
      q, k, v, dout, lse, dvec, dq, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid_k((unsigned)ceil_div(a.s, BK), (unsigned)(batch * kv_heads), 1);
  swa_bwd_dkdv<float, D><<<grid_k, THREADS, bytes, stream>>>(
      q, k, v, dout, lse, dvec, dk, dv, kv_heads, a);
  return (int)cudaGetLastError();
}

template <int D>
int launch(int route, const void* q, const void* k, const void* v,
           const float* o, const void* dout, const float* lse, float* dvec,
           void* dq, void* dk, void* dv, void* part, int64_t batch,
           int64_t kv_heads, int64_t splits, const int64_t* st, Args a,
           cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  if (route == 0)
    return launch_simt<D>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), o,
        static_cast<const float*>(dout), lse, dvec, static_cast<float*>(dq),
        static_cast<float*>(dk), static_cast<float*>(dv), batch, kv_heads,
        st, a, stream);
  return wgmma_bwd::launch<D>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), o, static_cast<const bf16*>(dout), lse,
      dvec, static_cast<bf16*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), static_cast<float*>(part), batch, kv_heads,
      splits, st, a, stream);
}

}  // namespace

// The route a dtype takes: 1 the wgmma kernels (bf16), 0 the CUDA-core
// kernels (fp32). swa_bwd_launch dispatches on it.
extern "C" int swa_bwd_route(int dtype) { return dtype == 1 ? 1 : 0; }

// dtype of q, k, v, dout, dq, dk, dv: 0 = float32, 1 = bfloat16; o is
// fp32 (the forward's output before rounding). head_dim one of 32, 64,
// 128, 256, contiguous in every tensor. strides:
// 24 element strides, (batch, head, position) of q, k, v, o, dout, dq, dk,
// dv in that order. lse: fp32 contiguous (B, H, S) from the forward;
// dvec: fp32 scratch of B * H * S. bf16 only: q, k, v, dout, dk, dv
// 16-byte aligned with batch, head and position strides multiples of 8
// elements (TMA; the wrapper checks), the query heads of a kv head split
// over `splits` (<= 65,535) dK/dV blocks, and with splits > 1 part, fp32
// scratch of 2 * splits * B * K * S * D (null with one split); fp32
// ignores both. batch * heads <= 65,535 and ceil(S / 64) <= 65,535 (the
// wrapper checks). window >= 1; prefix in [0, S]: key j visible to query
// i when (j <= i or j, i < prefix) and j > i - window. Returns a
// cudaError_t, or a tensor-map status (hop::ENCODE_MISSING and above).
extern "C" int swa_bwd_launch(int dtype, int head_dim, const void* q,
                              const void* k, const void* v, const void* o,
                              const void* dout, const void* lse, void* dvec,
                              void* dq, void* dk, void* dv, void* part,
                              int64_t batch, int64_t heads, int64_t kv_heads,
                              int64_t s, int64_t splits,
                              const int64_t* strides, int64_t window,
                              int64_t prefix, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t* x = strides;
  Args a;
  a.heads = heads;
  a.group = heads / kv_heads;
  a.s = s;
  a.window = window;
  a.prefix = prefix;
  a.scale = scale;
  a.q = {x[0], x[1], x[2]};
  a.k = {x[3], x[4], x[5]};
  a.v = {x[6], x[7], x[8]};
  a.dout = {x[12], x[13], x[14]};
  a.dq = {x[15], x[16], x[17]};
  a.dk = {x[18], x[19], x[20]};
  a.dv = {x[21], x[22], x[23]};
  const float* of = static_cast<const float*>(o);
  const float* l = static_cast<const float*>(lse);
  float* dvp = static_cast<float*>(dvec);
  const int route = swa_bwd_route(dtype);
  switch (head_dim) {
    case 32:
      return launch<32>(route, q, k, v, of, dout, l, dvp, dq, dk,
                        dv, part, batch, kv_heads, splits, strides, a,
                        st);
    case 64:
      return launch<64>(route, q, k, v, of, dout, l, dvp, dq, dk,
                        dv, part, batch, kv_heads, splits, strides, a,
                        st);
    case 128:
      return launch<128>(route, q, k, v, of, dout, l, dvp, dq, dk,
                         dv, part, batch, kv_heads, splits, strides, a,
                         st);
    case 256:
      return launch<256>(route, q, k, v, of, dout, l, dvp, dq, dk,
                         dv, part, batch, kv_heads, splits, strides, a,
                         st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
