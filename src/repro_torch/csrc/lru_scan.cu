// Gated linear recurrence h_t = a_t * h_{t-1} + b_t with an h0 carry:
// a, b (B, S, W) fp32 or bf16 row-major (both the same type), h0 (B, W)
// fp32, out (B, S, W) fp32 holding every state.
//
// Replaces the TPU kernel
// src/repro/kernels/lru_scan/lru_scan.py::lru_scan_pallas (_lru_kernel).
// In the port it is the prefill recurrence of every RG-LRU layer
// (repro_torch/nn/rglru.py), which the JAX package computes with
// jax.lax.associative_scan.
//
// Bound on the H100: bytes. One multiply-add per element against reading
// a and b and writing h (12 bytes per element in fp32): the card's memory
// rate bounds it by three orders of magnitude, 0.120 ms at training's
// 2 x 4,096 x 4,096 and 0.240 ms at serving's 4 x 4,096 x 4,096.
//
// The kernel before this one gave a block 32 channels of one batch row and
// walked all S steps with one warp: B * W / 32 warps is all the channel
// parallelism there is, and the walk took 64-70 ns a step whatever the
// batch, so at B = 2 it ran at 46 % of the byte bound. This one splits
// time as well (a chunked scan with a chained carry):
//   * a block owns 32 channels (a lane each) of one batch row over one
//     chunk of CHUNK = ROWS * WARPS time steps; each warp loads its ROWS
//     consecutive steps of a and b into registers (one coalesced row of
//     the warp's 32 channels a load), so a and b are read once and h
//     written once: 12 bytes an element, any alignment, any S and W (a
//     short last chunk and a short last channel group are guarded);
//   * each warp folds its rows into an affine pair (A = the product of its
//     a, H = its scan from zero); warp 0 folds the warps' pairs in order
//     into the chunk's pair, takes the chunk's carry-in from the chunk
//     before it (or h0), publishes carry-out = A h_in + H at once, and
//     each warp then walks its rows from its exact carry-in (the carry-in
//     folded through the pairs of the warps before it) and writes h;
//   * the carry passes from chunk to chunk through a workspace the wrapper
//     zeroes: one 64-bit word per channel and chunk holding the carry and
//     a ready flag, stored with st.release.gpu and polled with
//     ld.acquire.gpu and __nanosleep. Blocks take chunk ids from an atomic
//     ticket in launch order, chunk-major, so a block waits only on a
//     chunk whose block has started (never on one derived from blockIdx,
//     which could wait on a block not yet scheduled);
//   * the association is fixed: the same inputs give the same bits at
//     every launch. They are not the bits of the sequential walk;
//     kernels/lru_scan/ref.py::lru_scan_chunked_ref emulates this order
//     exactly (every fmaf and product rounded once, as __fmaf_rn and
//     __fmul_rn do here).
// Chunks of 256 steps on 8 warps (ROWS = 32 rows a warp, 98 registers a
// thread in fp32) ran best of 128, 256 and 512 steps when the kernel was
// built for all three, so they are the one configuration built now:
// 0.1455 ms at training's 2 x 4,096 x 4,096 (83 % of the byte bound),
// 0.2790 ms at serving's B = 4 (86 %) and 0.2776 ms at one prompt of
// 16,384 steps (87 %), where the one-warp walk took 0.2671, 0.2871 and
// 1.0397 ms and a torch.add moving the same bytes 0.1337, 0.2636 and
// 0.2638 ms (launch/backward_check.py before and after the change, NVIDIA
// H100 80GB HBM3, 700 W). Rows are loaded and stored in time order, full
// warps without guards: walked back from the last step, the reverse held
// 162 registers and ran 0.1590 ms at training's shape.
//
// Reverse (the `REVERSE` template flag, the autograd backward's launch):
// chunks run from the last down and each chunk's steps from its last,
// computing out_t = a_{t+1} out_{t+1} + b_t with the carry h0 entering the
// last step unscaled (out_{S-1} = h0 + b_{S-1}). With b the gradient of
// the states and h0 zero that is the adjoint of the forward scan, lambda_t
// = g_t + a_{t+1} lambda_{t+1}: a lane loads a one row later than b, so
// the a scaling a chunk's carry-in is the first row of the chunk after it
// (1 past the end). It is the counterpart of JAX differentiating
// jax.lax.associative_scan (the JAX package has no backward kernel). With
// `DA` the same pass also reads the forward's states h (and its h0) and
// writes da_t = lambda_t h_{t-1} (h_{-1} = h0): 20 bytes an element for
// the whole adjoint, where a separate concatenation and multiply would
// move 20 more. At training's shape the reverse ran 0.1416 ms and the
// fused adjoint 0.2404 ms (83 % of its 0.200 ms bound), against 0.4505
// for the reverse, a concatenation and a multiply (the same sweep).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// time steps a warp holds in registers, and warps a block: a chunk is
// CHUNK = ROWS * WARPS steps (kernels/lru_scan/lru_scan.py's CHUNK, WARPS)
constexpr int ROWS = 32, WARPS = 8, CHUNK = ROWS * WARPS;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// the carry of one channel of one chunk: the flag in the high word, the
// value's bits in the low, one 64-bit store
__device__ __forceinline__ void publish(unsigned long long* slot, float v) {
  const unsigned long long word =
      (1ull << 32) | (unsigned long long)__float_as_uint(v);
  asm volatile("st.release.gpu.global.b64 [%0], %1;\n" ::"l"(slot),
               "l"(word)
               : "memory");
}

// the lane's carry once every live lane of the warp sees its flag. The
// chunk before is running or done, so the wait is microseconds; after
// 2^22 polls (seconds) it traps: a failed launch, never a hung card
__device__ __forceinline__ float wait_carry(const unsigned long long* slot,
                                            bool live) {
  unsigned long long word = 1ull << 32;
  unsigned ns = 32;
  for (unsigned polls = 0;; ++polls) {
    if (polls == (1u << 22)) __trap();
    if (live)
      asm volatile("ld.acquire.gpu.global.b64 %0, [%1];\n"
                   : "=l"(word)
                   : "l"(slot)
                   : "memory");
    if (__all_sync(0xffffffffu, (word >> 32) != 0)) break;
    __nanosleep(ns);
    if (ns < 256) ns *= 2;
  }
  return __uint_as_float((unsigned)word);
}

// a warp's rows into registers, ar and br (and with DA hp = h_{t-1})
// indexed by processing step; GUARD keeps only rows lo .. lo + mine - 1
// (a full warp takes the unguarded copy)
template <bool GUARD, bool REVERSE, bool DA, int HP, typename T>
__device__ __forceinline__ void load_rows(float (&ar)[ROWS],
                                          float (&br)[ROWS], float (&hp)[HP],
                                          const T* a, const T* b,
                                          const float* h, float h_first,
                                          int64_t at, int64_t w, int64_t t_lo,
                                          int64_t s, int lo, int mine) {
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = REVERSE ? ROWS - 1 - i : i;
    ar[r] = 1.f;
    br[r] = 0.f;
    if constexpr (DA) hp[r] = 0.f;
    if (!GUARD || (i >= lo && i < lo + mine)) {
      const int64_t e = at + i * w;
      br[r] = to_f32(b[e]);
      // the reverse step at t scales by a_{t+1}: 1 past the end
      if (!REVERSE)
        ar[r] = to_f32(a[e]);
      else if (i < ROWS - 1 || t_lo + ROWS < s)
        ar[r] = to_f32(a[e + w]);
      if constexpr (DA) hp[r] = t_lo + i > 0 ? h[e - w] : h_first;
    }
  }
}

// the walk from the warp's carry-in v, storing the rows load_rows kept
template <bool GUARD, bool REVERSE, bool DA, int HP>
__device__ __forceinline__ void walk_rows(float v, const float (&ar)[ROWS],
                                          const float (&br)[ROWS],
                                          const float (&hp)[HP], float* out,
                                          float* da, int64_t at, int64_t w,
                                          int lo, int mine) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    v = __fmaf_rn(ar[r], v, br[r]);
    const int i = REVERSE ? ROWS - 1 - r : r;
    if (!GUARD || (i >= lo && i < lo + mine)) {
      out[at + i * w] = v;
      if constexpr (DA) da[at + i * w] = __fmul_rn(v, hp[r]);
    }
  }
}

template <typename T, bool REVERSE, bool DA>
__global__ void __launch_bounds__(WARPS * 32)
    lru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                    const float* __restrict__ h0, float* __restrict__ out,
                    const float* __restrict__ h,
                    const float* __restrict__ h_init, float* __restrict__ da,
                    unsigned long long* __restrict__ carries,
                    unsigned int* __restrict__ ticket, int64_t s, int64_t w,
                    int64_t groups, int64_t chains, int64_t chunks) {
  __shared__ float pair_a[WARPS][32], pair_h[WARPS][32], carry_in[32];
  __shared__ unsigned int my_ticket;
  if (threadIdx.x == 0) my_ticket = atomicAdd(ticket, 1u);
  __syncthreads();
  // chunk k of the processing order (chunk-major, so chunk k - 1 of this
  // chain took an earlier ticket), then which batch row and channel group
  const int64_t k = my_ticket / chains;
  const int64_t chain = my_ticket % chains;
  const int64_t bi = chain / groups;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t c = (chain % groups) * 32 + lane;
  const bool live = c < w;
  const int64_t t0 = (REVERSE ? chunks - 1 - k : k) * CHUNK;
  const int len = (int)(s - t0 < CHUNK ? s - t0 : CHUNK);
  const int64_t base = bi * s * w + c;

  // the warp's rows: its ROWS steps of the processing order, `mine` of
  // them inside the chunk (fewer only in a short last chunk, or none past
  // the last channel). They are loaded and stored in time order, row i at
  // time t_lo + i, which is processing step r = i (forward) or ROWS - 1 - i
  // (reverse); a step past the chunk's end is the identity (a 1, b 0),
  // which changes no bit.
  const int first = warp * ROWS;
  const int mine = live ? max(0, min(ROWS, len - first)) : 0;
  const int lo = REVERSE ? ROWS - mine : 0;     // rows lo .. lo + mine - 1
  const int64_t t_lo = REVERSE ? t0 + len - first - ROWS : t0 + first;
  const int64_t at = base + t_lo * w;
  const float h_first = DA && live && t0 == 0 ? h_init[bi * w + c] : 0.f;
  float ar[ROWS], br[ROWS], hp[DA ? ROWS : 1];
  if (mine == ROWS)
    load_rows<false, REVERSE, DA>(ar, br, hp, a, b, h, h_first, at, w,
                                  t_lo, s, lo, mine);
  else
    load_rows<true, REVERSE, DA>(ar, br, hp, a, b, h, h_first, at, w, t_lo,
                                 s, lo, mine);

  // the warp's pair: A = a_0 a_1 ..., H = the scan of its rows from zero
  float pa = ar[0], ph = br[0];
#pragma unroll
  for (int r = 1; r < ROWS; ++r) {
    ph = __fmaf_rn(ar[r], ph, br[r]);
    pa = __fmul_rn(pa, ar[r]);
  }
  pair_a[warp][lane] = pa;
  pair_h[warp][lane] = ph;
  __syncthreads();

  if (warp == 0) {
    // the chunk's pair, folded over the warps in order, before the wait
    float ca = pair_a[0][lane], chh = pair_h[0][lane];
#pragma unroll
    for (int j = 1; j < WARPS; ++j) {
      chh = __fmaf_rn(pair_a[j][lane], chh, pair_h[j][lane]);
      ca = __fmul_rn(ca, pair_a[j][lane]);
    }
    float hin = 0.f;
    if (k == 0)
      hin = live ? h0[bi * w + c] : 0.f;
    else
      hin = wait_carry(carries + ((k - 1) * chains + chain) * 32 + lane,
                       live);
    if (k + 1 < chunks && live)
      publish(carries + (k * chains + chain) * 32 + lane,
              __fmaf_rn(ca, hin, chh));
    carry_in[lane] = hin;
  }
  __syncthreads();

  // this warp's carry-in: the chunk's, through the warps before it
  float v = carry_in[lane];
  for (int j = 0; j < warp; ++j)
    v = __fmaf_rn(pair_a[j][lane], v, pair_h[j][lane]);
  if (mine == ROWS)
    walk_rows<false, REVERSE, DA>(v, ar, br, hp, out, da, at, w, lo, mine);
  else
    walk_rows<true, REVERSE, DA>(v, ar, br, hp, out, da, at, w, lo, mine);
}

template <typename T, bool REVERSE, bool DA>
int launch(const void* a, const void* b, const float* h0, float* out,
           const float* h, const float* h_init, float* da, void* work,
           int64_t batch, int64_t s, int64_t w, cudaStream_t stream) {
  const int64_t groups = (w + 31) / 32, chains = batch * groups;
  const int64_t chunks = (s + CHUNK - 1) / CHUNK;
  // the workspace: the ticket in its first 64-bit word, then one word per
  // (chunk, chain, channel)
  unsigned int* ticket = static_cast<unsigned int*>(work);
  unsigned long long* carries = static_cast<unsigned long long*>(work) + 1;
  lru_scan_kernel<T, REVERSE, DA>
      <<<(unsigned)(chains * chunks), WARPS * 32, 0, stream>>>(
          static_cast<const T*>(a), static_cast<const T*>(b), h0, out, h,
          h_init, da, carries, ticket, s, w, groups, chains, chunks);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_kind(int reverse, const void* a, const void* b, const float* h0,
                float* out, const float* h, const float* h_init, float* da,
                void* work, int64_t batch, int64_t s, int64_t w,
                cudaStream_t st) {
  if (!reverse)
    return launch<T, false, false>(a, b, h0, out, h, h_init, da, work, batch,
                                   s, w, st);
  if (da)
    return launch<T, true, true>(a, b, h0, out, h, h_init, da, work, batch,
                                 s, w, st);
  return launch<T, true, false>(a, b, h0, out, h, h_init, da, work, batch, s,
                                w, st);
}

}  // namespace

// dtype of a and b: 0 = float32, 1 = bfloat16. reverse: 0 runs time
// forward, 1 backward (see the top); with reverse, a non-null `da` also
// reads h and h_init and writes da. `work`: the wrapper's zeroed workspace
// of 1 + batch * ceil(w / 32) * ceil(s / CHUNK) * 32 64-bit words.
// Returns a cudaError_t.
extern "C" int lru_scan_launch(int dtype, int reverse, const void* a,
                               const void* b, const void* h0, void* out,
                               const void* h, const void* h_init, void* da,
                               void* work, int64_t batch, int64_t s,
                               int64_t w, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* h0p = static_cast<const float*>(h0);
  const float* hp = static_cast<const float*>(h);
  const float* hip = static_cast<const float*>(h_init);
  float* op = static_cast<float*>(out);
  float* dap = static_cast<float*>(da);
  if (dtype == 0)
    return launch_kind<float>(reverse, a, b, h0p, op, hp, hip, dap, work,
                              batch, s, w, st);
  return launch_kind<__nv_bfloat16>(reverse, a, b, h0p, op, hp, hip, dap,
                                    work, batch, s, w, st);
}
