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
// bf16 (training's path): tensor-core kernels on mma.sync m16n8k16 (bf16
// in, fp32 sums), fragments through ldmatrix (.trans where the operand is
// stored the other way round), tiles of 64 rows in shared memory padded
// by 16 bytes a row (the eight row addresses of an ldmatrix fall in
// distinct banks), brought in by cp.async with the next tile loading
// while this one computes. The CUDA-core kernel before it ran at 0.8 % of
// the bound (63.9 ms): every product was fp32 FMA from shared-memory
// operands, eight loads for eight FMAs, and its dK/dV kernel had 256
// blocks for 132 SMs at MQA. Here:
//   * rounding: S, dP, D and every sum stay fp32; P and dS are rounded
//     once to bf16 as the A operands of their products (P V's hi/lo
//     split of the forward is not needed: tests/test_torch_precision.py
//     emulates the plan), and the gradients once at the store;
//   * swa_bwd_dq_tc: a block of 8 warps takes 64 queries of one (batch,
//     head) and walks the 64-key tiles of their band, last query tile
//     first. Warp w takes 16 of the queries and 32 keys of each tile (S
//     and dP 16 fp32 a thread each, beside a 16 x D fp32 partial dQ, 128
//     at D = 256); the two key halves' partials meet in shared memory at
//     the end, in a fixed order. q and dO stay in shared memory, k and v
//     tiles are double-buffered: 198 KB at D = 256, one block an SM. dS
//     goes from the C layout of its mma straight into the A layout of
//     dS K, never through shared memory. With 4 warps of 16 queries x 64
//     keys it needed 255 registers at D = 256, spilled, and ran 2.02 ms
//     where this runs 1.51 (backward_check);
//   * swa_bwd_dkdv_tc: a block of 8 warps takes 64 keys of one (batch, kv
//     head) and a share of the kv head's query heads, and walks their
//     64-query tiles of the keys' band [j, j + window). The warps split
//     the 64 x 64 tiles S^T = K Q^T and dP^T = V dO^T (16 keys x 32
//     queries each); P^T and dS^T go through shared memory in bf16; then
//     each warp owns 32 keys x D/4 columns of both dV += P^T dO and
//     dK += dS^T Q (128 fp32 a thread at D = 256; 16 keys x D/2 at
//     D = 32), so each B fragment it loads serves two 16-key tiles: 0.375
//     ldmatrix a product where 16 keys x D/2 took 0.56, which ran the
//     kernel 7 % slower for the same bits. q, dO and their lse and D are
//     double-buffered: 217 KB at D = 256;
//   * MQA: a kv head's query heads are split over up to four blocks
//     (RecurrentGemma's 16 heads to 1: 512 dK/dV blocks where one block
//     per key tile would give 128). Each writes fp32 partial dK and dV
//     to a scratch the wrapper allocates; swa_bwd_reduce sums the
//     partials in split order and rounds them to bf16;
//   * the mask is evaluated only on tiles that cross the diagonal, the
//     window's lower edge or the end of S; interior tiles take the
//     unmasked path. Rows and keys past S read as zeros and get P = 0.
// At the training shape it ran 3.34-3.49 ms, 15-16 % of the bound, where
// SDPA's backward took 7.08-7.26 ms and the plain version 39.8 ms in the
// same calls (backward_check and chip_smoke.py, NVIDIA H100 80GB HBM3,
// 700 W): dQ 1.51 ms, dK/dV 1.71-1.72, D 0.05, the sum 0.03. What bounds it now is shared memory: every
// mma.sync operand reaches the registers by ldmatrix, 0.67 ldmatrix.x4 a
// product in dQ and 0.56 in dK/dV, because the fp32 accumulators at
// D = 256 leave room for small warp tiles only. At 128 bytes a clock per
// SM that traffic alone needs about 0.8 ms (dQ) and 0.9 ms (dK/dV) at a
// 1.98 GHz clock, counted from the instructions.
// wgmma, which reads its B operand (and A) straight from shared memory
// for 64-row tiles, is the next step.
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
#include "tc_mma.cuh"

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

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernels
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;
constexpr int TB = 64;            // rows of a tile: queries or keys
constexpr int DQ_THREADS = 256;   // 8 warps: 4 x 16 query rows, 2 key halves
constexpr int KV_THREADS = 256;   // 8 warps
constexpr int PLD = TB + 8;       // padded row of the P^T and dS^T tiles
constexpr int RED_THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
constexpr size_t dq_tc_bytes() {
  // q, dO, two k and two v tiles
  return sizeof(bf16) * 6 * (size_t)TB * (D + 8);
}

template <int D>
constexpr size_t dkdv_tc_bytes() {
  // k, v, two q and two dO tiles, P^T and dS^T, two lse and two D rows
  return sizeof(bf16) * (6 * (size_t)TB * (D + 8) + 2 * (size_t)TB * PLD) +
         sizeof(float) * 4 * TB;
}

// rows [r0, r0 + 64) of a (S, D) bf16 matrix with row stride ld into a
// shared tile of rows padded to D + 8, by cp.async; rows at or past s
// read as zeros
template <int D, int NT>
__device__ __forceinline__ void tc_load_tile(bf16* dst, const bf16* src,
                                             int64_t ld, int64_t r0,
                                             int64_t s, int tid) {
  constexpr int CH = D / 8;   // 16-byte chunks of a row
#pragma unroll
  for (int i = 0; i < TB * CH / NT; ++i) {
    const int e = tid + NT * i;
    const int r = e / CH;
    const int c = e % CH;
    const int64_t gr = r0 + r;
    const bool ok = gr < s;
    tc::cp_async16(tc::smem_u32(dst + r * (D + 8) + c * 8),
                   src + (ok ? gr : 0) * ld + c * 8, ok ? 16 : 0);
  }
}

// the four A-operand registers of a 16 x 16 slice whose two 16 x 8
// halves are the C fragments c0 and c1 of two mma tiles, rounded to bf16
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = tc::pack_bf16(c0[0], c0[1]);
  a[1] = tc::pack_bf16(c0[2], c0[3]);
  a[2] = tc::pack_bf16(c1[0], c1[1]);
  a[3] = tc::pack_bf16(c1[2], c1[3]);
}

// dQ of 64 queries of one (batch, head): grid (ceil(S / 64), B * H). Warp
// w takes query rows 16 (w % 4) .. and keys 32 (w / 4) .. of each 64-key
// tile; the two key halves' partial sums meet in shared memory at the end,
// the first half's plus the second's.
template <int D>
__global__ void __launch_bounds__(DQ_THREADS, 1)
    swa_bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ dvec, bf16* __restrict__ dq,
                  Args a) {
  constexpr int LD = D + 8;             // padded shared row, in elements
  constexpr uint32_t TILE = TB * LD * 2;   // bytes of one tile
  constexpr int NO = D / 8;             // 8-column dQ tiles of a warp
  constexpr int RLD = D + 8;            // padded row of the fp32 partials
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* gs = qs + TB * LD;              // dO
  bf16* ks = gs + TB * LD;              // two buffers
  bf16* vs = ks + 2 * TB * LD;          // two buffers

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wq = warp & 3;    // query rows 16 wq ..
  const int wk = warp >> 2;   // keys 32 wk .. of a tile
  const int64_t bh = blockIdx.y;
  const int64_t bi = bh / a.heads;
  const int64_t hi = bh % a.heads;
  const int64_t kvh = hi / a.group;
  // positions fit 32 bits (ceil(S / 64) <= 65,535); a window past S is S
  const int s = (int)a.s;
  const int win = (int)(a.window < a.s ? a.window : a.s);
  const int pre = (int)a.prefix;
  const int q0 = (int)(gridDim.x - 1 - blockIdx.x) * TB;
  const bf16* kb = k + bi * a.k.b + kvh * a.k.h;
  const bf16* vb = v + bi * a.v.b + kvh * a.v.h;
  const int q_last = q0 + TB - 1 < s ? q0 + TB - 1 : s - 1;
  // the last key any query of the block sees: its own diagonal, or the
  // end of the prefix for a block that starts inside it
  const int k_last = q0 < pre && pre - 1 > q_last ? pre - 1 : q_last;
  const int lo = q0 - win + 1 > 0 ? q0 - win + 1 : 0;
  const int k_begin = lo / TB * TB;
  // every query of the block inside the prefix
  const bool q_in_prefix = q0 + TB <= pre;

  tc_load_tile<D, DQ_THREADS>(qs, q + bi * a.q.b + hi * a.q.h, a.q.s, q0, s,
                              tid);
  tc_load_tile<D, DQ_THREADS>(gs, dout + bi * a.dout.b + hi * a.dout.h,
                              a.dout.s, q0, s, tid);
  tc_load_tile<D, DQ_THREADS>(ks, kb, a.k.s, k_begin, s, tid);
  tc_load_tile<D, DQ_THREADS>(vs, vb, a.v.s, k_begin, s, tid);
  tc::cp_async_commit();

  // this thread's two query rows; a row past S gets lse = +inf, so P = 0
  const int r0 = q0 + wq * 16 + g;
  const int r1 = r0 + 8;
  const float scale_log2 = a.scale * LOG2E;
  const float l0 = r0 < s ? lse[bh * s + r0] * LOG2E : INFINITY;
  const float l1 = r1 < s ? lse[bh * s + r1] * LOG2E : INFINITY;
  const float d0 = r0 < s ? dvec[bh * s + r0] : 0.f;
  const float d1 = r1 < s ? dvec[bh * s + r1] : 0.f;
  const int last0 = last_key(r0, pre);
  const int last1 = last_key(r1, pre);

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // ldmatrix row addresses of this lane: q and dO (A, 16 x 16 per step);
  // k and v as B of S and dP (two 8-key tiles per step, byte offsets in a
  // tile); k as B of dS K (two 8-column tiles per step, transposed)
  const uint32_t q_addr =
      tc::smem_u32(qs + (wq * 16 + (lane & 15)) * LD + (lane >> 4) * 8);
  const uint32_t g_addr =
      tc::smem_u32(gs + (wq * 16 + (lane & 15)) * LD + (lane >> 4) * 8);
  const uint32_t b_off =
      ((wk * 32 + (lane & 7) + ((lane >> 4) << 3)) * LD +
       ((lane >> 3) & 1) * 8) * 2;
  const uint32_t bt_off =
      ((wk * 32 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD +
       (lane >> 4) * 8) * 2;
  const uint32_t ks0 = tc::smem_u32(ks);
  const uint32_t vs0 = tc::smem_u32(vs);

  int buf = 0;
  for (int k0 = k_begin; k0 <= k_last; k0 += TB, buf ^= 1) {
    __syncthreads();   // every warp is done with the other buffers
    if (k0 + TB <= k_last) {
      tc_load_tile<D, DQ_THREADS>(ks + (buf ^ 1) * TB * LD, kb, a.k.s,
                                  k0 + TB, s, tid);
      tc_load_tile<D, DQ_THREADS>(vs + (buf ^ 1) * TB * LD, vb, a.v.s,
                                  k0 + TB, s, tid);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();   // this step's k and v (and q, dO) landed
    const uint32_t kt = ks0 + buf * TILE;
    const uint32_t vt = vs0 + buf * TILE;
    // the diagonal, the band and the end of S: masked only where a tile
    // crosses them; above the diagonal every pair is visible where keys
    // and queries all lie inside the prefix
    const bool masked =
        (k0 + TB - 1 > q0 && !(q_in_prefix && k0 + TB <= pre)) ||
        k0 <= q0 + TB - 1 - win || k0 + TB > s;

    float sc[4][4], dp[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ag[4];
      tc::ldsm_x4(aq, q_addr + kk * 32);
      tc::ldsm_x4(ag, g_addr + kk * 32);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        const uint32_t off = b_off + (jp * 16 * LD + kk * 16) * 2;
        uint32_t b[4];
        tc::ldsm_x4(b, kt + off);
        tc::mma_bf16(sc[2 * jp], aq, b[0], b[1]);
        tc::mma_bf16(sc[2 * jp + 1], aq, b[2], b[3]);
        tc::ldsm_x4(b, vt + off);
        tc::mma_bf16(dp[2 * jp], ag, b[0], b[1]);
        tc::mma_bf16(dp[2 * jp + 1], ag, b[2], b[3]);
      }
    }
    // dS = P (dP - D) in place of the scores
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(sc[j][e], scale_log2, e < 2 ? -l0 : -l1));
        if (masked) {
          const int kj = k0 + wk * 32 + j * 8 + 2 * t + (e & 1);
          const int qi = e < 2 ? r0 : r1;
          const int last = e < 2 ? last0 : last1;
          if (!(kj <= last && kj > qi - win && kj < s)) p = 0.f;
        }
        sc[j][e] = p * (dp[j][e] - (e < 2 ? d0 : d1));
      }
    // dQ += dS K over this warp's 32 keys, dS rounded to bf16
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t ad[4];
      c_to_a(ad, sc[2 * kk], sc[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t b[4];
        tc::ldsm_x4_trans(b, kt + bt_off + (kk * 16 * LD + np * 16) * 2);
        tc::mma_bf16(acc[2 * np], ad, b[0], b[1]);
        tc::mma_bf16(acc[2 * np + 1], ad, b[2], b[3]);
      }
    }
  }

  // the second key half's sums through shared memory (the tiles are
  // done: the last step waited for every copy), then first + second
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);   // [64][RLD]
  const int row = wq * 16 + g;
  if (wk == 1) {
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = n * 8 + 2 * t;
      *reinterpret_cast<float2*>(red + row * RLD + col) =
          make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(red + (row + 8) * RLD + col) =
          make_float2(acc[n][2], acc[n][3]);
    }
  }
  __syncthreads();
  if (wk == 1) return;
  bf16* ob = dq + bi * a.dq.b + hi * a.dq.h;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = n * 8 + 2 * t;
    const float2 x0 = *reinterpret_cast<const float2*>(red + row * RLD + col);
    const float2 x1 =
        *reinterpret_cast<const float2*>(red + (row + 8) * RLD + col);
    if (r0 < s)
      *reinterpret_cast<uint32_t*>(ob + (int64_t)r0 * a.dq.s + col) =
          tc::pack_bf16((acc[n][0] + x0.x) * a.scale,
                        (acc[n][1] + x0.y) * a.scale);
    if (r1 < s)
      *reinterpret_cast<uint32_t*>(ob + (int64_t)r1 * a.dq.s + col) =
          tc::pack_bf16((acc[n][2] + x1.x) * a.scale,
                        (acc[n][3] + x1.y) * a.scale);
  }
}

// the operands of one step of the dK/dV kernel: the q and dO tiles of
// query tile q0 of head hi, with their lse and D rows (zeros past S)
template <int D>
__device__ __forceinline__ void dkdv_load_step(
    bf16* qs, bf16* gs, float* ls, float* ds, const bf16* q,
    const bf16* dout, const float* lse, const float* dvec, int64_t bi,
    int hi, int q0, const Args& a, int tid) {
  const int64_t s = a.s;
  tc_load_tile<D, KV_THREADS>(qs, q + bi * a.q.b + hi * a.q.h, a.q.s, q0, s,
                              tid);
  tc_load_tile<D, KV_THREADS>(gs, dout + bi * a.dout.b + hi * a.dout.h,
                              a.dout.s, q0, s, tid);
  if (tid < 2 * TB) {
    const int r = tid & (TB - 1);
    const int64_t qi = q0 + r;
    const bool ok = qi < s;
    const float* src = tid < TB ? lse : dvec;
    float* dst = tid < TB ? ls : ds;
    tc::cp_async4(tc::smem_u32(dst + r),
                  src + (bi * a.heads + hi) * s + (ok ? qi : 0), ok ? 4 : 0);
  }
}

// fp32 partial dK and dV of 64 keys of one (batch, kv head) over one
// split of its query heads: grid (splits, B * K, ceil(S / 64)). The key
// tile is the grid's slowest axis, so blocks start in key order: without
// a prefix the tiles with the most queries come first (the last ones lose
// the queries past S). A tile that starts below P takes its queries from
// 0, so it has at least as many as any tile after it, and the order still
// starts the longest work first. Only among the prefix's own tiles at a
// window < S does a later tile have more (it takes the queries up to
// k0 + 63 + window - 1): both training shapes with a prefix have window =
// S, where those tiles all take every query, so the order is kept. part
// holds (2, splits, B * K, S, D): dK (scaled) then dV.
template <int D>
__global__ void __launch_bounds__(KV_THREADS, 1)
    swa_bwd_dkdv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v,
                    const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dvec,
                    float* __restrict__ part, int64_t kv_heads,
                    int64_t per_split, Args a) {
  constexpr int LD = D + 8;
  constexpr uint32_t TILE = TB * LD * 2;
  // dK and dV: warps as KG key groups x CG column groups, each warp MT
  // 16-key tiles x NT 8-column tiles of both
  constexpr int CG = D >= 64 ? 4 : 2;
  constexpr int KG = 8 / CG;
  constexpr int MT = TB / KG / 16;
  constexpr int NT = D / CG / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + TB * LD;
  bf16* qs = vs + TB * LD;              // two buffers
  bf16* gs = qs + 2 * TB * LD;          // dO, two buffers
  bf16* pts = gs + 2 * TB * LD;         // P^T [key][query]
  bf16* dss = pts + TB * PLD;           // dS^T
  float* lsb = reinterpret_cast<float*>(dss + TB * PLD);   // two buffers
  float* dvb = lsb + 2 * TB;                               // two buffers

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = warp & 3;    // S^T, dP^T: keys 16 wr .. of the tile
  const int wc = warp >> 2;   // and queries 32 wc ..
  const int kg = warp % KG;   // dK, dV: keys 16 MT kg ..
  const int cg = warp / KG;   // and columns 8 NT cg ..
  const int split = blockIdx.x;
  const int64_t bk = blockIdx.y;
  const int64_t bi = bk / kv_heads;
  const int64_t kvh = bk % kv_heads;
  // positions fit 32 bits (ceil(S / 64) <= 65,535); a window past S is S
  const int s = (int)a.s;
  const int win = (int)(a.window < a.s ? a.window : a.s);
  const int pre = (int)a.prefix;
  const int k0 = (int)blockIdx.z * TB;
  const int64_t splits = gridDim.x;

  // this split's heads and each head's query tiles [q_begin, q_end]: from
  // k0, or from 0 for a key tile that starts inside the prefix
  const int h_lo = (int)(kvh * a.group + split * per_split);
  const int h_end = (int)((kvh + 1) * a.group);
  const int n_heads = h_lo >= h_end ? 0
                      : (h_end - h_lo < per_split ? h_end - h_lo
                                                  : (int)per_split);
  const int k_last = k0 + TB - 1 < s ? k0 + TB - 1 : s - 1;
  const int q_end = k_last + win - 1 < s - 1 ? k_last + win - 1 : s - 1;
  const int q_begin = k0 < pre ? 0 : k0;
  const int n_q = (q_end - q_begin) / TB + 1;
  const int n_steps = n_heads * n_q;

  tc_load_tile<D, KV_THREADS>(ks, k + bi * a.k.b + kvh * a.k.h, a.k.s, k0,
                              s, tid);
  tc_load_tile<D, KV_THREADS>(vs, v + bi * a.v.b + kvh * a.v.h, a.v.s, k0,
                              s, tid);
  if (n_steps > 0)
    dkdv_load_step<D>(qs, gs, lsb, dvb, q, dout, lse, dvec, bi, h_lo,
                      q_begin, a, tid);
  tc::cp_async_commit();

  const float scale_log2 = a.scale * LOG2E;
  float acck[MT][NT][4], accv[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acck[m][n][e] = accv[m][n][e] = 0.f;

  // ldmatrix row addresses: k and v (A of S^T and dP^T, 16 keys x 16);
  // q and dO as B of S^T and dP^T (non-transposed, byte offsets in a
  // tile); P^T and dS^T (A of dV and dK); dO and q as B of dV and dK
  // (transposed)
  const int arow = wr * 16 + (lane & 15);
  const uint32_t k_addr = tc::smem_u32(ks + arow * LD + (lane >> 4) * 8);
  const uint32_t v_addr = tc::smem_u32(vs + arow * LD + (lane >> 4) * 8);
  const uint32_t b_off =
      ((wc * 32 + (lane & 7) + ((lane >> 4) << 3)) * LD +
       ((lane >> 3) & 1) * 8) * 2;
  const int prow = kg * MT * 16 + (lane & 15);
  const uint32_t p_addr = tc::smem_u32(pts + prow * PLD + (lane >> 4) * 8);
  const uint32_t d_addr = tc::smem_u32(dss + prow * PLD + (lane >> 4) * 8);
  const uint32_t bt_off =
      ((((lane >> 3) & 1) * 8 + (lane & 7)) * LD + cg * NT * 8 +
       (lane >> 4) * 8) * 2;
  const uint32_t qs0 = tc::smem_u32(qs);
  const uint32_t gs0 = tc::smem_u32(gs);

  // this thread's two keys in S^T
  const int kj0 = k0 + wr * 16 + g;
  const int kj1 = kj0 + 8;

  for (int step = 0; step < n_steps; ++step) {
    const int buf = step & 1;
    const int q0 = q_begin + (step % n_q) * TB;
    __syncthreads();   // every warp is done with the other buffers
    if (step + 1 < n_steps) {
      const int nb = buf ^ 1;
      dkdv_load_step<D>(qs + nb * TB * LD, gs + nb * TB * LD, lsb + nb * TB,
                        dvb + nb * TB, q, dout, lse, dvec, bi,
                        h_lo + (step + 1) / n_q,
                        q_begin + ((step + 1) % n_q) * TB, a, tid);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();   // this step's q, dO, lse and D (and k, v) landed
    const uint32_t qt = qs0 + buf * TILE;
    const uint32_t gt = gs0 + buf * TILE;
    const float* lrow = lsb + buf * TB;
    const float* drow = dvb + buf * TB;

    // S^T and dP^T: 16 keys x 32 queries of this warp
    float sc[4][4], dp[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ak[4], av[4];
      tc::ldsm_x4(ak, k_addr + kk * 32);
      tc::ldsm_x4(av, v_addr + kk * 32);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        const uint32_t off = b_off + (jp * 16 * LD + kk * 16) * 2;
        uint32_t b[4];
        tc::ldsm_x4(b, qt + off);
        tc::mma_bf16(sc[2 * jp], ak, b[0], b[1]);
        tc::mma_bf16(sc[2 * jp + 1], ak, b[2], b[3]);
        tc::ldsm_x4(b, gt + off);
        tc::mma_bf16(dp[2 * jp], av, b[0], b[1]);
        tc::mma_bf16(dp[2 * jp + 1], av, b[2], b[3]);
      }
    }
    // as dQ's: the prefix block (queries and keys below P) takes the
    // unmasked path above the diagonal
    const bool masked =
        (k0 + TB - 1 > q0 && !(q0 + TB <= pre && k0 + TB <= pre)) ||
        k0 <= q0 + TB - 1 - win || k0 + TB > s || q0 + TB > s;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = wc * 32 + j * 8 + 2 * t;   // query column of e = 0, 2
      float p[4], d[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ce = c + (e & 1);
        float x = exp2f(fmaf(sc[j][e], scale_log2, -lrow[ce] * LOG2E));
        if (masked) {
          const int qi = q0 + ce;
          const int kj = e < 2 ? kj0 : kj1;
          if (!(kj <= last_key(qi, pre) && kj > qi - win && qi < s &&
                kj < s))
            x = 0.f;
        }
        p[e] = x;
        d[e] = x * (dp[j][e] - drow[ce]);
      }
      const int r = wr * 16 + g;
      *reinterpret_cast<uint32_t*>(pts + r * PLD + c) =
          tc::pack_bf16(p[0], p[1]);
      *reinterpret_cast<uint32_t*>(pts + (r + 8) * PLD + c) =
          tc::pack_bf16(p[2], p[3]);
      *reinterpret_cast<uint32_t*>(dss + r * PLD + c) =
          tc::pack_bf16(d[0], d[1]);
      *reinterpret_cast<uint32_t*>(dss + (r + 8) * PLD + c) =
          tc::pack_bf16(d[2], d[3]);
    }
    __syncthreads();   // P^T and dS^T complete

    // dV += P^T dO and dK += dS^T Q: 16 MT keys x 8 NT columns of this
    // warp, each B fragment used for MT products
#pragma unroll
    for (int kk = 0; kk < TB / 16; ++kk) {
      uint32_t ap[MT][4], ad[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        tc::ldsm_x4(ap[m], p_addr + (m * 16 * PLD + kk * 16) * 2);
        tc::ldsm_x4(ad[m], d_addr + (m * 16 * PLD + kk * 16) * 2);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        const uint32_t off = bt_off + (kk * 16 * LD + np * 16) * 2;
        uint32_t b[4];
        tc::ldsm_x4_trans(b, gt + off);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          tc::mma_bf16(accv[m][2 * np], ap[m], b[0], b[1]);
          tc::mma_bf16(accv[m][2 * np + 1], ap[m], b[2], b[3]);
        }
        tc::ldsm_x4_trans(b, qt + off);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          tc::mma_bf16(acck[m][2 * np], ad[m], b[0], b[1]);
          tc::mma_bf16(acck[m][2 * np + 1], ad[m], b[2], b[3]);
        }
      }
    }
  }
  tc::cp_async_wait<0>();   // an empty split still loaded k and v

  // the partials: rows past S are not written
  const int64_t per = (int64_t)gridDim.y * s * D;   // one split's elements
  float* pk = part + ((int64_t)split * gridDim.y + bk) * s * D;
  float* pv = pk + splits * per;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int j0 = k0 + (kg * MT + m) * 16 + g;
    const int j1 = j0 + 8;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = cg * NT * 8 + n * 8 + 2 * t;
      if (j0 < s) {
        *reinterpret_cast<float2*>(pk + (int64_t)j0 * D + col) =
            make_float2(acck[m][n][0] * a.scale, acck[m][n][1] * a.scale);
        *reinterpret_cast<float2*>(pv + (int64_t)j0 * D + col) =
            make_float2(accv[m][n][0], accv[m][n][1]);
      }
      if (j1 < s) {
        *reinterpret_cast<float2*>(pk + (int64_t)j1 * D + col) =
            make_float2(acck[m][n][2] * a.scale, acck[m][n][3] * a.scale);
        *reinterpret_cast<float2*>(pv + (int64_t)j1 * D + col) =
            make_float2(accv[m][n][2], accv[m][n][3]);
      }
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
    *reinterpret_cast<uint2*>(dst) =
        make_uint2(tc::pack_bf16(sum.x, sum.y), tc::pack_bf16(sum.z, sum.w));
  }
}

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
  const int64_t rows = batch * a.heads * a.s;
  swa_bwd_dot<float><<<(unsigned)ceil_div(rows, THREADS / 32), THREADS, 0,
                       stream>>>(o, dout, dvec, a.heads, a.s, D, st[9],
                                 st[10], st[11], a.dout.b, a.dout.h,
                                 a.dout.s, rows);
  err = cudaGetLastError();
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

// bf16: D, dQ, the dK/dV partials of each split, their sum
template <int D>
int launch_tc(const bf16* q, const bf16* k, const bf16* v, const float* o,
              const bf16* dout, const float* lse, float* dvec, bf16* dq,
              bf16* dk, bf16* dv, float* part, int64_t batch,
              int64_t kv_heads, int64_t splits, const int64_t* st, Args a,
              cudaStream_t stream) {
  constexpr size_t q_bytes = dq_tc_bytes<D>();
  constexpr size_t kv_bytes = dkdv_tc_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      swa_bwd_dq_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)q_bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(swa_bwd_dkdv_tc<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kv_bytes);
  if (err != cudaSuccess) return (int)err;
  const int64_t rows = batch * a.heads * a.s;
  swa_bwd_dot<bf16><<<(unsigned)ceil_div(rows, THREADS / 32), THREADS, 0,
                      stream>>>(o, dout, dvec, a.heads, a.s, D, st[9],
                                st[10], st[11], a.dout.b, a.dout.h, a.dout.s,
                                rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t tiles = ceil_div(a.s, TB);
  dim3 grid_q((unsigned)tiles, (unsigned)(batch * a.heads), 1);
  swa_bwd_dq_tc<D><<<grid_q, DQ_THREADS, q_bytes, stream>>>(
      q, k, v, dout, lse, dvec, dq, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid_k((unsigned)splits, (unsigned)(batch * kv_heads),
              (unsigned)tiles);
  swa_bwd_dkdv_tc<D><<<grid_k, KV_THREADS, kv_bytes, stream>>>(
      q, k, v, dout, lse, dvec, part, kv_heads, ceil_div(a.group, splits),
      a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t per = batch * kv_heads * a.s * D;
  swa_bwd_reduce<<<(unsigned)ceil_div(per / 4, RED_THREADS), RED_THREADS, 0,
                   stream>>>(part, dk, dv, splits, kv_heads, a.s, D, a.dk,
                             a.dv, per);
  return (int)cudaGetLastError();
}

template <int D>
int launch(int route, const void* q, const void* k, const void* v,
           const float* o, const void* dout, const float* lse, float* dvec,
           void* dq, void* dk, void* dv, void* part, int64_t batch,
           int64_t kv_heads, int64_t splits, const int64_t* st, Args a,
           cudaStream_t stream) {
  if (route == 0)
    return launch_simt<D>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), o,
        static_cast<const float*>(dout), lse, dvec, static_cast<float*>(dq),
        static_cast<float*>(dk), static_cast<float*>(dv), batch, kv_heads,
        st, a, stream);
  return launch_tc<D>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), o, static_cast<const bf16*>(dout), lse,
      dvec, static_cast<bf16*>(dq),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      static_cast<float*>(part), batch, kv_heads, splits, st, a, stream);
}

}  // namespace

// The route a dtype takes: 1 the tensor-core kernels (bf16), 0 the
// CUDA-core kernels (fp32). swa_bwd_launch dispatches on it.
extern "C" int swa_bwd_route(int dtype) { return dtype == 1 ? 1 : 0; }

// dtype of q, k, v, dout, dq, dk, dv: 0 = float32, 1 = bfloat16; o is
// fp32 (the forward's output before rounding). head_dim one of 32, 64,
// 128, 256, contiguous in every tensor. strides:
// 24 element strides, (batch, head, position) of q, k, v, o, dout, dq, dk,
// dv in that order. lse: fp32 contiguous (B, H, S) from the forward;
// dvec: fp32 scratch of B * H * S. bf16 only: q, k, v, dout, dk, dv
// 16-byte aligned with batch, head and position strides multiples of 8
// elements (cp.async; the wrapper checks), and part, fp32 scratch of
// 2 * splits * B * K * S * D, the query heads of a kv head split over
// `splits` (<= 65,535) dK/dV blocks; fp32 ignores both. batch * heads <=
// 65,535 and ceil(S / 64) <= 65,535 (the wrapper checks). window >= 1;
// prefix in [0, S]: key j visible to query i when (j <= i or j, i <
// prefix) and j > i - window. Returns a cudaError_t.
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
