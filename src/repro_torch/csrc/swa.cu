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
// about 0.41 TFLOP of bf16 products at the main path's B 4, H 16, S 4,096,
// D 256, window 2,048, against 285 MB moved: 0.42 ms at the card's bf16
// tensor-core rate (989 TFLOP/s), 6.2 ms at the fp32 CUDA-core rate.
//
// Layout: the tensors are addressed by strides (batch, head, position, in
// elements) with D contiguous, so the model passes (B, S, H, D) buffers
// viewed as (B, H, S, D) without a copy.
//
// Two routes, picked by the input type, with no fallback between them:
//
// bf16 (the serving path): a flash-attention kernel on the tensor cores,
// swa_tc_kernel. The CUDA-core kernel that came before it spent its time
// on shared-memory loads (about 3,300 per thread per 64-key step against
// 8,192 FMAs), passed the probabilities through shared memory in fp32 and
// loaded tiles element by element; it ran at 1.9 % of the bound. Here:
//   * one block of 4 warps takes 64 queries of one (batch, head); each
//     warp owns 16 query rows. q, one k tile and one v tile (64 rows each)
//     sit in shared memory in bf16, rows padded by 16 bytes so the eight
//     row addresses of an ldmatrix fall in distinct banks: 99 KB at
//     D = 256, so two blocks share an SM;
//   * S = Q K^T and O += P V run on mma.sync m16n8k16 (bf16 in, fp32
//     accumulation); fragments come through ldmatrix (.trans for V);
//   * the online softmax (row max, row sum, rescaling of the accumulator)
//     works on the score fragments in registers, in base 2 with the scale
//     folded in, and P never leaves the registers: it splits into two
//     bf16 parts, P_hi = bf16(P) and P_lo = bf16(P - P_hi), which are the
//     A operands of P V = P_lo V + P_hi V, while the row sum keeps the fp32
//     probabilities. Rounding P once to bf16 would put the output 2.8x
//     over the main shape's limit (chip_smoke.py's SWA_RTOL /
//     SWA_ATOL_RMS; tests/test_torch_precision.py emulates both plans);
//     the split costs half again the products (P V twice) and keeps P to
//     2^-17;
//   * k and v tiles arrive by cp.async: v of this step loads while S is
//     computed, k of the next step while P V is computed;
//   * each q block walks only the 64-key blocks of its band, and a q
//     block that starts inside the prefix also the keys up to P - 1; the
//     mask is evaluated only on blocks that cross the diagonal (unless
//     keys and queries all lie inside the prefix), the window's lower edge
//     or the end of S; every other block takes the unmasked path. A block
//     wholly below the diagonal is visible whatever P is (the prefix only
//     adds pairs), so a block that crosses P needs the exact test only
//     where it is above the diagonal;
//   * q blocks run last-first, so the blocks with the most keys start
//     first and the short ones fill the tail (with a prefix the first
//     blocks read P keys each: at P = S every block reads all S).
// The 16 x D output accumulator of a warp lives in registers (128 fp32
// per thread at D = 256). mma.sync and not wgmma: a first wgmma version
// (Q K^T from shared memory, P V with P from registers), its products and
// softmax one after the other, measured no faster at the main shape;
// wgmma pays only with the softmax overlapped with the products.
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
#include "tc_mma.cuh"

using fp32_tiles::ceil_div;
using fp32_tiles::to_f32;

namespace {

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;
constexpr int TC_BQ = 64;        // queries of a block
constexpr int TC_BK = 64;        // keys of one step
constexpr int TC_THREADS = 128;  // 4 warps x 16 query rows
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
constexpr size_t tc_smem_bytes() {
  return sizeof(bf16) * 3 * (size_t)TC_BQ * (D + 8);   // q, k, v tiles
}

// rows [r0, r0 + 64) of a (S, D) bf16 matrix with row stride ld into a
// shared tile of rows padded to D + 8; rows at or past s read as zeros
template <int D>
__device__ __forceinline__ void tc_load_tile(bf16* dst, const bf16* src,
                                             int64_t ld, int64_t r0,
                                             int64_t s, int tid) {
  constexpr int CH = D / 8;   // 16-byte chunks of a row
#pragma unroll
  for (int i = 0; i < TC_BQ * CH / TC_THREADS; ++i) {
    const int e = tid + TC_THREADS * i;
    const int r = e / CH;
    const int c = e % CH;
    const int64_t gr = r0 + r;
    const bool ok = gr < s;
    tc::cp_async16(tc::smem_u32(dst + r * (D + 8) + c * 8),
                   src + (ok ? gr : 0) * ld + c * 8, ok ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS, 2)
    swa_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o,
                  int64_t heads, int64_t group, int64_t s, int64_t q_sb,
                  int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh,
                  int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss,
                  int64_t o_sb, int64_t o_sh, int64_t o_ss, int64_t window,
                  int64_t prefix, float scale_log2,
                  float* __restrict__ lse, float* __restrict__ o32) {
  constexpr int LD = D + 8;   // padded shared row, in elements
  constexpr int NO = D / 8;   // 8-column output tiles of a warp
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + TC_BQ * LD;
  bf16* vs = ks + TC_BK * LD;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int64_t bh = blockIdx.y;
  const int64_t bi = bh / heads;
  const int64_t hi = bh % heads;
  const int64_t kvh = hi / group;
  const int64_t q0 = (int64_t)(gridDim.x - 1 - blockIdx.x) * TC_BQ;
  const bf16* qb = q + bi * q_sb + hi * q_sh;
  const bf16* kb = k + bi * k_sb + kvh * k_sh;
  const bf16* vb = v + bi * v_sb + kvh * v_sh;

  const int64_t q_last = q0 + TC_BQ - 1 < s ? q0 + TC_BQ - 1 : s - 1;
  // the last key any query of the block sees: its own diagonal, or the
  // end of the prefix for a block that starts inside it
  const int64_t k_last = q0 < prefix && prefix - 1 > q_last ? prefix - 1
                                                             : q_last;
  const int64_t lo = q0 - window + 1 > 0 ? q0 - window + 1 : 0;
  const int64_t k_begin = lo / TC_BK * TC_BK;
  // every query of the block inside the prefix
  const bool q_in_prefix = q0 + TC_BQ <= prefix;

  tc_load_tile<D>(qs, qb, q_ss, q0, s, tid);
  tc_load_tile<D>(ks, kb, k_ss, k_begin, s, tid);
  tc::cp_async_commit();

  // this thread's two query rows, and the last key each sees: its
  // diagonal, or the prefix's last key for a row inside the prefix
  // (j <= i || (j < P && i < P) is j <= last(i), as P - 1 >= i there)
  const int64_t r0 = q0 + warp * 16 + g;
  const int64_t r1 = r0 + 8;
  const int64_t last0 = r0 < prefix ? prefix - 1 : r0;
  const int64_t last1 = r1 < prefix ? prefix - 1 : r1;
  float m0 = -INFINITY, m1 = -INFINITY;   // running row max (base 2)
  float l0 = 0.f, l1 = 0.f;               // this thread's share of the sum
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // ldmatrix row addresses of this lane: q (A, 16 x 16 per step), k (B of
  // two 8-key tiles per step), v (B^T of two 8-column tiles per step)
  const uint32_t q_addr =
      tc::smem_u32(qs + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8);
  const uint32_t k_addr = tc::smem_u32(
      ks + ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8);
  const uint32_t v_addr = tc::smem_u32(
      vs + (((lane >> 3) & 1) * 8 + (lane & 7)) * LD + (lane >> 4) * 8);

  for (int64_t k0 = k_begin; k0 <= k_last; k0 += TC_BK) {
    tc::cp_async_wait<0>();
    __syncthreads();   // k (and q) landed; every warp is done with v
    tc_load_tile<D>(vs, vb, v_ss, k0, s, tid);
    tc::cp_async_commit();

    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      tc::ldsm_x4(a, q_addr + kk * 32);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t b[4];
        tc::ldsm_x4(b, k_addr + (jp * 16 * LD + kk * 16) * 2);
        tc::mma_bf16(sc[2 * jp], a, b[0], b[1]);
        tc::mma_bf16(sc[2 * jp + 1], a, b[2], b[3]);
      }
    }

    // the diagonal, the band and the end of S: masked only where a block
    // crosses them; above the diagonal every pair is visible where keys
    // and queries all lie inside the prefix
    const bool masked =
        (k0 + TC_BK - 1 > q0 && !(q_in_prefix && k0 + TC_BK <= prefix)) ||
        k0 <= q0 + TC_BQ - 1 - window || k0 + TC_BK > s;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[j][e] * scale_log2;
        if (masked) {
          const int64_t kj = k0 + j * 8 + 2 * t + (e & 1);
          const int64_t qi = e < 2 ? r0 : r1;
          const int64_t last = e < 2 ? last0 : last1;
          if (!(kj <= last && kj > qi - window && kj < s)) x = -INFINITY;
        }
        sc[j][e] = x;
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
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    // a row with no visible key yet keeps max -inf: subtract 0 instead,
    // so its probabilities stay exp2(-inf) = 0
    const float base0 = mn0 == -INFINITY ? 0.f : mn0;
    const float base1 = mn1 == -INFINITY ? 0.f : mn1;
    const float alpha0 = exp2f(m0 - base0);
    const float alpha1 = exp2f(m1 - base1);
    m0 = mn0;
    m1 = mn1;
    l0 *= alpha0;
    l1 *= alpha1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= alpha0;
      acc[n][1] *= alpha0;
      acc[n][2] *= alpha1;
      acc[n][3] *= alpha1;
    }

    tc::cp_async_wait<0>();
    __syncthreads();   // v landed; every warp is done with k
    if (k0 + TC_BK <= k_last) {
      tc_load_tile<D>(ks, kb, k_ss, k0 + TC_BK, s, tid);
      tc::cp_async_commit();
    }

    // 16 keys at a time: their probabilities, split into the bf16 A
    // operands P_hi and P_lo, then P_lo V + P_hi V, so only one 16-key
    // slice of P is held beside the scores and the accumulator
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ph[4], pl[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 2 * kk + h;
        const float p0 = exp2f(sc[j][0] - base0);
        const float p1 = exp2f(sc[j][1] - base0);
        const float p2 = exp2f(sc[j][2] - base1);
        const float p3 = exp2f(sc[j][3] - base1);
        l0 += p0 + p1;
        l1 += p2 + p3;
        tc::split_bf16(p0, p1, ph[2 * h], pl[2 * h]);
        tc::split_bf16(p2, p3, ph[2 * h + 1], pl[2 * h + 1]);
      }
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t b[4];
        tc::ldsm_x4_trans(b, v_addr + (kk * 16 * LD + np * 16) * 2);
        tc::mma_bf16(acc[2 * np], pl, b[0], b[1]);
        tc::mma_bf16(acc[2 * np + 1], pl, b[2], b[3]);
        tc::mma_bf16(acc[2 * np], ph, b[0], b[1]);
        tc::mma_bf16(acc[2 * np + 1], ph, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  // l >= 1 for a row before S: its diagonal key is visible
  const float inv0 = 1.f / l0;
  const float inv1 = 1.f / l1;
  bf16* ob = o + bi * o_sb + hi * o_sh;
  if (lse != nullptr && t == 0) {
    // m is in base 2 (scores times scale * log2 e): lse = (m + log2 l) ln 2
    constexpr float LN2 = 0.6931471805599453f;
    if (r0 < s) lse[bh * s + r0] = (m0 + log2f(l0)) * LN2;
    if (r1 < s) lse[bh * s + r1] = (m1 + log2f(l1)) * LN2;
  }
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = n * 8 + 2 * t;
    if (r0 < s)
      *reinterpret_cast<uint32_t*>(ob + r0 * o_ss + col) =
          tc::pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    if (r1 < s)
      *reinterpret_cast<uint32_t*>(ob + r1 * o_ss + col) =
          tc::pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
  }
  if (o32 == nullptr) return;
  // the same output unrounded, for the backward's D = rowsum(dO o)
  float* of = o32 + bh * s * D;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = n * 8 + 2 * t;
    if (r0 < s)
      *reinterpret_cast<float2*>(of + r0 * D + col) =
          make_float2(acc[n][0] * inv0, acc[n][1] * inv0);
    if (r1 < s)
      *reinterpret_cast<float2*>(of + r1 * D + col) =
          make_float2(acc[n][2] * inv1, acc[n][3] * inv1);
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* o,
              int64_t batch, int64_t heads, int64_t kv_heads, int64_t s,
              const int64_t* st, int64_t window, int64_t prefix, float scale,
              float* lse, float* o32, cudaStream_t stream) {
  constexpr size_t bytes = tc_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      swa_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)fp32_tiles::ceil_div(s, TC_BQ),
            (unsigned)(batch * heads), 1);
  swa_tc_kernel<D><<<grid, TC_THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), heads,
      heads / kv_heads, s, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], window, prefix, scale * LOG2E,
      lse, o32);
  return (int)cudaGetLastError();
}

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
int launch(int dtype, const void* q, const void* k, const void* v, void* o,
           int64_t batch, int64_t heads, int64_t kv_heads, int64_t s,
           const int64_t* st, int64_t window, int64_t prefix, float scale,
           float* lse, float* o32, cudaStream_t stream) {
  if (dtype == 0)
    return launch_simt<D>(q, k, v, o, batch, heads, kv_heads, s, st, window,
                          prefix, scale, lse, stream);
  return launch_tc<D>(q, k, v, o, batch, heads, kv_heads, s, st, window,
                      prefix, scale, lse, o32, stream);
}

}  // namespace

// dtype of q, k, v and o: 0 = float32, 1 = bfloat16. head_dim one of 32,
// 64, 128, 256. strides: 12 element strides, (batch, head, position) of
// q, k, v and o in that order; D is contiguous. batch * heads <= 65,535
// (the wrapper checks). For bf16 every position stride is a multiple of 8
// and every base 16-byte aligned (cp.async; the wrapper checks). window
// >= 1; prefix in [0, S] (the wrapper checks). lse: null, or fp32
// contiguous (B, H, S) that receives each row's log-sum-exp. o32: null,
// or (bf16 only) fp32 contiguous (B, H, S, D) that receives the output
// before it is rounded to bf16 (the backward's D reads it). Returns a
// cudaError_t.
extern "C" int swa_launch(int dtype, int head_dim, const void* q,
                          const void* k, const void* v, void* o,
                          int64_t batch, int64_t heads, int64_t kv_heads,
                          int64_t s, const int64_t* strides, int64_t window,
                          int64_t prefix, float scale, void* lse_out,
                          void* o32_out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_out);
  float* o32 = static_cast<float*>(o32_out);
  switch (head_dim) {
    case 32:
      return launch<32>(dtype, q, k, v, o, batch, heads, kv_heads, s,
                        strides, window, prefix, scale, lse, o32, st);
    case 64:
      return launch<64>(dtype, q, k, v, o, batch, heads, kv_heads, s,
                        strides, window, prefix, scale, lse, o32, st);
    case 128:
      return launch<128>(dtype, q, k, v, o, batch, heads, kv_heads, s,
                         strides, window, prefix, scale, lse, o32, st);
    case 256:
      return launch<256>(dtype, q, k, v, o, batch, heads, kv_heads, s,
                         strides, window, prefix, scale, lse, o32, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
