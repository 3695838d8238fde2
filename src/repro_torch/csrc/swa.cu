// Sliding-window causal attention: out[b, h, i] = softmax_j(q_i . k_j *
// D^-0.5) v_j over the keys j in (i - window, i], for q (B, H, S, D) and
// k, v (B, K, S, D), H a multiple of K (GQA: head h reads kv head
// h / (H / K), never a repeated copy). fp32 or bf16 in (all three the
// same type), out in the input type; every product, the softmax and the
// sums in fp32.
//
// Replaces the TPU kernel src/repro/kernels/swa/swa.py::swa_pallas
// (_swa_kernel). In the port it is the prefill of every local-attention
// layer of RecurrentGemma (repro_torch/nn/attention.py), which the JAX
// package computes with a masked softmax in XLA.
//
// Bound on the H100: operations. 4 D flops per (query, visible key) pair,
// about 0.41 TFLOP of bf16 products at the main path's B 4, H 16, S 4,096,
// D 256, window 2,048, against 285 MB moved: 0.42 ms at the card's bf16
// tensor-core rate. This kernel computes on the CUDA cores in fp32, whose
// rate alone caps it at 6.2 ms; tensor cores are a later redesign.
//
// Layout: the tensors are addressed by strides (batch, head, position, in
// elements) with D contiguous, so the model passes (B, S, H, D) buffers
// viewed as (B, H, S, D) without a copy.
//
// Design: one block per (batch * head, 64-query block) walks only the
// 64-key blocks that intersect (q0 - window, q_last], keeping the online
// softmax state (row max m, row sum l, the 64 x D accumulator) in
// registers: 256 threads as 16 x 16, thread (ty, tx) owns query rows
// ty + 16 i (i < 4), score columns tx + 16 j (j < 4) and output columns
// tx + 16 jj (jj < D / 16). The q tile and each k tile sit in shared
// memory transposed (d-major, rows padded to 65) and the v tile
// row-major, all in the input type; the 64 x 64 probabilities go through
// shared memory in fp32 for the P V product. At D = 256 that is 215 KB in
// fp32 and 116 KB in bf16, above the 48 KB default: the launcher raises
// the block's dynamic shared-memory limit (up to 227 KB on the H100).
// Row max and row sum are reduced across the 16 threads of a row with
// warp shuffles. Keys outside the band, and the ragged tail past S, get
// probability 0; accurate expf (no fast math).
#include "fp32_tiles.cuh"

using fp32_tiles::ceil_div;
using fp32_tiles::to_f32;

namespace {

constexpr int BQ = 64;         // queries of a block
constexpr int BK = 64;         // keys of one step
constexpr int THREADS = 256;   // 16 x 16
constexpr int QP = BQ + 1;     // padded row of the transposed q tile
constexpr int KP = BK + 1;     // padded row of the transposed k tile / p
constexpr float NEG = -1.0e30f;

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

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
               int64_t o_sh, int64_t o_ss, int64_t window, float scale) {
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
  const int64_t lo = q0 - window + 1 > 0 ? q0 - window + 1 : 0;
  for (int64_t k0 = lo / BK * BK; k0 <= q_last; k0 += BK) {
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
      bool ok[4];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t kj = k0 + tx + 16 * j;
        ok[j] = kj <= qi && kj > qi - window && kj < s;
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
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj)
      store_out(ob + qi * o_ss + tx + 16 * jj, acc[i][jj] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o,
           int64_t batch, int64_t heads, int64_t kv_heads, int64_t s,
           const int64_t* st, int64_t window, float scale,
           cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(
      swa_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)ceil_div(s, BQ), (unsigned)(batch * heads), 1);
  swa_kernel<T, D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), heads,
      heads / kv_heads, s, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int by_head_dim(int d, const void* q, const void* k, const void* v, void* o,
                int64_t batch, int64_t heads, int64_t kv_heads, int64_t s,
                const int64_t* st, int64_t window, float scale,
                cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, o, batch, heads, kv_heads, s, st,
                           window, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, batch, heads, kv_heads, s, st,
                           window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, batch, heads, kv_heads, s, st,
                            window, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, batch, heads, kv_heads, s, st,
                            window, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype of q, k, v and o: 0 = float32, 1 = bfloat16. head_dim one of 32,
// 64, 128, 256. strides: 12 element strides, (batch, head, position) of
// q, k, v and o in that order; D is contiguous. batch * heads <= 65,535
// (the wrapper checks). Returns a cudaError_t.
extern "C" int swa_launch(int dtype, int head_dim, const void* q,
                          const void* k, const void* v, void* o,
                          int64_t batch, int64_t heads, int64_t kv_heads,
                          int64_t s, const int64_t* strides, int64_t window,
                          float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return by_head_dim<float>(head_dim, q, k, v, o, batch, heads, kv_heads,
                              s, strides, window, scale, st);
  return by_head_dim<__nv_bfloat16>(head_dim, q, k, v, o, batch, heads,
                                    kv_heads, s, strides, window, scale, st);
}
