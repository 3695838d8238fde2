// Backward of sliding-window causal attention (swa.cu): given q (B, H, S,
// D), k, v (B, K, S, D), the forward's output o (B, H, S, D), its per-row
// log-sum-exp lse (B, H, S) fp32 and the output's gradient dO (B, H, S,
// D), compute dQ, dK and dV, FlashAttention-2 style:
//   P_ij  = exp(q_i . k_j * scale - lse_i)   over the band (i - window, i]
//   D_i   = sum_d dO_id o_id
//   dP_ij = dO_i . v_j
//   dS_ij = P_ij (dP_ij - D_i)
//   dQ_i  = scale sum_j dS_ij k_j
//   dK_j  = scale sum_i dS_ij q_i      (over every query head of k's head)
//   dV_j  = sum_i P_ij dO_i            (likewise)
// H a multiple of K (GQA: head h reads kv head h / (H / K)); under GQA and
// MQA a kv head's dK and dV sum over its H / K query heads inside one
// block, so nothing is added atomically and the result repeats bit for
// bit. fp32 or bf16 in and out (q, k, v, o, dO and the three gradients of
// one type), lse and D fp32.
//
// The TPU kernel src/repro/kernels/swa/swa.py::swa_pallas has no
// backward: the JAX package differentiates its XLA attention. The port
// routes every full forward through swa.cu, so training on the card needs
// this kernel (the "swa" autograd Function of kernels/swa/ops.py).
//
// Bound on the H100: operations. The five band products (S and dP
// recomputed, dV, dK, dQ) are 10 D flops per (query, visible key) pair:
// 0.52 TFLOP at the training shape B 2, H 16, S 4,096, D 256, window
// 2,048, 0.52 ms at the bf16 tensor-core rate. This first version is
// simple and exact, not fast:
//   * every product runs on the CUDA cores in fp32 FMA, from operands
//     widened to fp32 as they are loaded. P and dS are never rounded (the
//     forward's bf16 hi/lo split of P has no counterpart here): the only
//     roundings are fp32 sums and the final store in the input type;
//   * three kernels. swa_bwd_dot computes D, one warp per row. swa_bwd_dq
//     gives a block 32 queries of one (batch, head) and walks the key
//     tiles of their band, recomputing S and dP; swa_bwd_dkdv gives a
//     block 32 keys of one (batch, kv head) and walks, for each query head
//     of the group, the query tiles of the keys' band [j, j + window),
//     recomputing S^T and dP^T. S and dP are recomputed in both (seven
//     products where FA2 does five) in exchange for no atomics;
//   * a block is 256 threads as 16 x 16; thread (ty, tx) owns rows ty,
//     ty + 16 and columns tx, tx + 16 of a 32 x 32 score tile, and rows ty,
//     ty + 16 by columns tx + 16 jj (jj < D / 16) of its fp32 accumulators
//     (32 registers in dq, 64 in dkdv at D = 256). At D = 256 a 64-row
//     fp32 dK/dV tile pair would be 128 KB, so the tiles are 32 rows: the
//     four operand tiles sit in shared memory widened to fp32 and
//     transposed (d-major, rows padded to 33 floats so that both the
//     row-wise reads of the score products and the column-wise reads of
//     the gradient products fall in distinct banks), 140-144 KB at
//     D = 256, one block an SM;
//   * keys outside the band, and rows or keys past S, get P = 0.
// Head dims 32, 64, 128 and 256, as the forward. At the training shape it
// ran 63.9 ms, 0.8 % of the bf16 bound (NVIDIA H100 80GB HBM3, 700 W):
// slower than its plain version's cuBLAS products (39.4 ms) and than
// scaled_dot_product_attention's backward (7.2 ms). Its two products per
// eight shared-memory loads bound it; the tensor cores (mma.sync as in
// swa.cu, P and dS rounded to bf16) are the next step.
#include <math.h>

#include "fp32_tiles.cuh"

using fp32_tiles::ceil_div;
using fp32_tiles::to_f32;

namespace {

constexpr int BQ = 32;         // queries of a tile
constexpr int BK = 32;         // keys of a tile
constexpr int P = 33;          // padded row of a transposed tile
constexpr int THREADS = 256;   // 16 x 16

__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

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
    swa_bwd_dot(const T* __restrict__ o, const T* __restrict__ dout,
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
  const T* op = o + bi * o_sb + hi * o_sh + i * o_ss;
  const T* gp = dout + bi * g_sb + hi * g_sh + i * g_ss;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) acc = fmaf(to_f32(op[c]), to_f32(gp[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) dvec[row] = acc;
}

// strides of one operand: (batch, head, position), in elements
struct Strides {
  int64_t b, h, s;
};

struct Args {
  int64_t heads, group, s, window;
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
  const int64_t lo = q0 - a.window + 1 > 0 ? q0 - a.window + 1 : 0;
  for (int64_t k0 = lo / BK * BK; k0 <= q_last; k0 += BK) {
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
        const bool ok = qi < s && kj < s && kj <= qi && kj > qi - a.window;
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

  // queries that see a key of this tile: [k0, k0 + BK - 1 + window - 1]
  const int64_t k_last = k0 + BK - 1 < s ? k0 + BK - 1 : s - 1;
  const int64_t q_end = k_last + a.window - 1 < s - 1 ? k_last + a.window - 1
                                                      : s - 1;
  for (int64_t g = 0; g < a.group; ++g) {
    const int64_t hi = kvh * a.group + g;
    const int64_t bh = bi * a.heads + hi;
    const T* qb = q + bi * a.q.b + hi * a.q.h;
    const T* gb = dout + bi * a.dout.b + hi * a.dout.h;
    for (int64_t q0 = k0 / BQ * BQ; q0 <= q_end; q0 += BQ) {
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
          const bool ok =
              qi < s && kj < s && kj <= qi && kj > qi - a.window;
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

template <typename T, int D>
int launch(const T* q, const T* k, const T* v, const T* o, const T* dout,
           const float* lse, float* dvec, T* dq, T* dk, T* dv,
           int64_t batch, int64_t kv_heads, const int64_t* st, Args a,
           cudaStream_t stream) {
  constexpr size_t bytes = tiles_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      swa_bwd_dq<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(swa_bwd_dkdv<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int64_t rows = batch * a.heads * a.s;
  swa_bwd_dot<T><<<(unsigned)ceil_div(rows, THREADS / 32), THREADS, 0,
                   stream>>>(o, dout, dvec, a.heads, a.s, D, st[9], st[10],
                             st[11], a.dout.b, a.dout.h, a.dout.s, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid_q((unsigned)ceil_div(a.s, BQ), (unsigned)(batch * a.heads), 1);
  swa_bwd_dq<T, D><<<grid_q, THREADS, bytes, stream>>>(q, k, v, dout, lse,
                                                       dvec, dq, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid_k((unsigned)ceil_div(a.s, BK), (unsigned)(batch * kv_heads), 1);
  swa_bwd_dkdv<T, D><<<grid_k, THREADS, bytes, stream>>>(
      q, k, v, dout, lse, dvec, dk, dv, kv_heads, a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dim(int head_dim, const void* q, const void* k, const void* v,
               const void* o, const void* dout, const float* lse,
               float* dvec, void* dq, void* dk, void* dv, int64_t batch,
               int64_t kv_heads, const int64_t* st, Args a,
               cudaStream_t stream) {
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* to = static_cast<const T*>(o);
  const T* tg = static_cast<const T*>(dout);
  T* gq = static_cast<T*>(dq);
  T* gk = static_cast<T*>(dk);
  T* gv = static_cast<T*>(dv);
  switch (head_dim) {
    case 32:
      return launch<T, 32>(tq, tk, tv, to, tg, lse, dvec, gq, gk, gv, batch,
                           kv_heads, st, a, stream);
    case 64:
      return launch<T, 64>(tq, tk, tv, to, tg, lse, dvec, gq, gk, gv, batch,
                           kv_heads, st, a, stream);
    case 128:
      return launch<T, 128>(tq, tk, tv, to, tg, lse, dvec, gq, gk, gv, batch,
                            kv_heads, st, a, stream);
    case 256:
      return launch<T, 256>(tq, tk, tv, to, tg, lse, dvec, gq, gk, gv, batch,
                            kv_heads, st, a, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype of q, k, v, o, dout, dq, dk, dv: 0 = float32, 1 = bfloat16.
// head_dim one of 32, 64, 128, 256, contiguous in every tensor. strides:
// 24 element strides, (batch, head, position) of q, k, v, o, dout, dq, dk,
// dv in that order. lse: fp32 contiguous (B, H, S) from the forward;
// dvec: fp32 scratch of B * H * S. batch * heads <= 65,535 (the wrapper
// checks). Returns a cudaError_t.
extern "C" int swa_bwd_launch(int dtype, int head_dim, const void* q,
                              const void* k, const void* v, const void* o,
                              const void* dout, const void* lse, void* dvec,
                              void* dq, void* dk, void* dv, int64_t batch,
                              int64_t heads, int64_t kv_heads, int64_t s,
                              const int64_t* strides, int64_t window,
                              float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t* x = strides;
  Args a;
  a.heads = heads;
  a.group = heads / kv_heads;
  a.s = s;
  a.window = window;
  a.scale = scale;
  a.q = {x[0], x[1], x[2]};
  a.k = {x[3], x[4], x[5]};
  a.v = {x[6], x[7], x[8]};
  a.dout = {x[12], x[13], x[14]};
  a.dq = {x[15], x[16], x[17]};
  a.dk = {x[18], x[19], x[20]};
  a.dv = {x[21], x[22], x[23]};
  const float* l = static_cast<const float*>(lse);
  float* dvp = static_cast<float*>(dvec);
  if (dtype == 0)
    return launch_dim<float>(head_dim, q, k, v, o, dout, l, dvp, dq, dk, dv,
                             batch, kv_heads, strides, a, st);
  return launch_dim<__nv_bfloat16>(head_dim, q, k, v, o, dout, l, dvp, dq,
                                   dk, dv, batch, kv_heads, strides, a, st);
}
