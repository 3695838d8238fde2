"""What swa_bwd's bf16 design choices are worth on the card: variants of
``csrc/swa_bwd.cu`` and the headers it includes, each a text substitution
of the sources in this checkout, built side by side (one nvcc each, all
at once), held to the gradient limits against the plain backward and to
a second launch's bits, and timed at ``backward_check.TIME_SHAPES`` in
turns (variant order, then reversed).

  python -m repro_torch.launch.swa_bwd_variants [--variants NAME ...]

Variants (VARIANTS):
  as_is             the sources as they are;
  split_d64         at D <= 64 the dK/dV consumers own the same 64 keys
                    and split the sums (P^T passed in fp32), as at D >= 128,
                    with 128-query steps;
  split_d64_q64     the same with 64-query steps;
  ahead             a dK/dV step's second products issued after the next
                    step's first (as dQ's), where the ring has three stages
                    (D <= 128), so they run while that step's P^T and dS^T
                    are formed;
  ahead_two_stages  the same also with two stages (D = 256);
  dq_keys128        dQ key tiles of 128 rows at D <= 64;
  regs_a            at D <= 64 the fixed A operands (q and dO in dQ, k and
                    v in dK/dV) held as register fragments, loaded once from
                    memory, in place of shared-memory tiles (RS products
                    with a K-major B).

Prints one JSON line per variant (ptxas registers and spills, the cases
checked), then per shape each variant's mean ms by CUDA events over 20
calls and its kernels' device ms a call from ``torch.profiler``, two
rounds. Exits non-zero when a variant misses a limit or repeats
differently. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys

import torch

from repro_torch.kernels import build
from repro_torch.kernels.swa.ops import swa_backward, swa_forward
from repro_torch.kernels.swa.ref import swa_backward_ref
from repro_torch.launch.backward_check import TIME_SHAPES, _grad_errs, \
    _ms, profile_bwd, ptxas_report

# (B, H, K, S, D, window, prefix): every head dim, GQA and MQA, S off the
# tiles, a window of three keys and the prefix cases
CASES = [(2, 4, 2, 128, 32, 32, 0), (2, 4, 1, 200, 64, 48, 0),
         (1, 4, 2, 70, 128, 1000, 0), (2, 16, 1, 300, 256, 100, 0),
         (2, 6, 1, 130, 64, 3, 0), (2, 8, 1, 300, 256, 300, 256),
         (2, 4, 4, 300, 64, 300, 300), (2, 8, 2, 320, 128, 320, 65),
         (2, 4, 1, 300, 64, 96, 100)]

_REGS_A = [
    ('swa_bwd.cu',
     ('  static constexpr int STAGES = 3;\n'
      '  static constexpr uint32_t Q_BYTES = BQ * D * 2;\n'),
     ('  static constexpr int STAGES = 3;\n'
      '  static constexpr bool A_REGS = D <= 64;\n'
      '  static constexpr uint32_t Q_BYTES = A_REGS ? 0 : BQ * D * 2;\n')),
    ('swa_bwd.cu',
     ('  static constexpr uint32_t KV_BYTES = BK * D * 2;\n'
      '  static constexpr uint32_t Q_BYTES = BQ * D * 2;\n'
      '  static constexpr uint32_t V_OFF = KV_BYTES;'),
     ('  static constexpr bool A_REGS = OWN;\n'
      '  static constexpr uint32_t KV_BYTES = A_REGS ? 0 : BK * D * 2;\n'
      '  static constexpr uint32_t Q_BYTES = BQ * D * 2;\n'
      '  static constexpr uint32_t V_OFF = KV_BYTES;')),
    ('swa_bwd.cu',
     ("// S = Q K^T and dP = dO V^T of this warpgroup's 64 queries "
      'against the key\n'),
     ('template <int D>\n'
      '__device__ __forceinline__ void load_a(uint32_t (&a)[D / 16][4],\n'
      '    const bf16* src, int64_t ld, int r0, int s, int t) {\n'
      '#pragma unroll\n'
      '  for (int kk = 0; kk < D / 16; ++kk)\n'
      '#pragma unroll\n'
      '    for (int i = 0; i < 4; ++i) {\n'
      '      const int r = r0 + 8 * (i & 1);\n'
      '      a[kk][i] = r < s ? *reinterpret_cast<const uint32_t*>(\n'
      '          src + r * ld + 16 * kk + 2 * t + 8 * (i >> 1)) : 0u;\n'
      '    }\n'
      '}\n'
      '\n'
      "// S = Q K^T and dP = dO V^T of this warpgroup's 64 queries "
      'against the key\n')),
    ('swa_bwd.cu',
     ('template <int D>\n'
      '__device__ __forceinline__ void issue_s_dp(float (&sc)[DqTil'
      'e<D>::BK / 2],\n'
      '                                           float (&dp)[DqTil'
      'e<D>::BK / 2],\n'
      '                                           uint32_t q_wg, ui'
      'nt32_t g_wg,\n'
      '                                           uint32_t k_st, ui'
      'nt32_t v_st) {'),
     ('template <int D>\n'
      '__device__ __forceinline__ void issue_s_dp(float (&sc)[DqTil'
      'e<D>::BK / 2],\n'
      '    float (&dp)[DqTile<D>::BK / 2],\n'
      '    const uint32_t (&qa)[DqTile<D>::A_REGS ? D / 16 : 1][4],\n'
      '    const uint32_t (&ga)[DqTile<D>::A_REGS ? D / 16 : 1][4],\n'
      '    uint32_t q_wg, uint32_t g_wg, uint32_t k_st, uint32_t v_st) {')),
    ('swa_bwd.cu',
     ('    const uint32_t qa = c * T::BQ * T::SW + in_row;\n'
      '    const uint32_t kb = c * T::BK * T::SW + in_row;\n'
      '    hop::wgmma_ss_bf16<T::BK>(sc, k_major<T::SW>(q_wg + qa),\n'
      '                              k_major<T::SW>(k_st + kb), kk > 0);\n'
      '    hop::wgmma_ss_bf16<T::BK>(dp, k_major<T::SW>(g_wg + qa),\n'
      '                              k_major<T::SW>(v_st + kb), kk > 0);'),
     ('    const uint32_t qo = c * T::BQ * T::SW + in_row;\n'
      '    const uint32_t kb = c * T::BK * T::SW + in_row;\n'
      '    if constexpr (T::A_REGS) {\n'
      '      hop::wgmma_rs_bf16_kb<T::BK>(sc, qa[kk], k_major<T::SW'
      '>(k_st + kb), kk > 0);\n'
      '      hop::wgmma_rs_bf16_kb<T::BK>(dp, ga[kk], k_major<T::SW'
      '>(v_st + kb), kk > 0);\n'
      '    } else {\n'
      '      hop::wgmma_ss_bf16<T::BK>(sc, k_major<T::SW>(q_wg + qo),\n'
      '                                k_major<T::SW>(k_st + kb), kk > 0);\n'
      '      hop::wgmma_ss_bf16<T::BK>(dp, k_major<T::SW>(g_wg + qo),\n'
      '                                k_major<T::SW>(v_st + kb), kk > 0);\n'
      '    }')),
    ('swa_bwd.cu',
     ('                     const __grid_constant__ CUtensorMap v_map,\n'
      '                     const float* __restrict__ lse,\n'
      '                     const float* __restrict__ dvec, bf16* _'
      '_restrict__ dq,'),
     ('                     const __grid_constant__ CUtensorMap v_map,\n'
      '                     const bf16* __restrict__ q, const bf16*'
      ' __restrict__ dout,\n'
      '                     Strides sqi, Strides sgi,\n'
      '                     const float* __restrict__ lse,\n'
      '                     const float* __restrict__ dvec, bf16* _'
      '_restrict__ dq,')),
    ('swa_bwd.cu',
     ('      hop::mbar_expect_tx(q_full, 2 * T::Q_BYTES);\n'
      '      for (int c = 0; c < T::NCOL; ++c) {'),
     ('      if (!T::A_REGS) hop::mbar_expect_tx(q_full, 2 * T::Q_BYTES);\n'
      '      for (int c = 0; c < (T::A_REGS ? 0 : T::NCOL); ++c) {')),
    ('swa_bwd.cu',
     ('    float sc[BK / 2], dp[BK / 2];\n'
      '    uint32_t pa[BK / 16][4];\n'),
     ('    float sc[BK / 2], dp[BK / 2];\n'
      '    uint32_t pa[BK / 16][4];\n'
      '    uint32_t qa[T::A_REGS ? D / 16 : 1][4], ga[T::A_REGS ? D'
      ' / 16 : 1][4];\n'
      '    if constexpr (T::A_REGS) {\n'
      '      load_a<D>(qa, q + bi * sqi.b + hi * sqi.h, sqi.s, r0, s, t);\n'
      '      load_a<D>(ga, dout + bi * sgi.b + hi * sgi.h, sgi.s, r0, s, t);\n'
      '    }\n')),
    ('swa_bwd.cu',
     ('    hop::mbar_wait(q_full, 0);\n'
      '    // tile 0: S and dP alone'),
     ('    if (!T::A_REGS) hop::mbar_wait(q_full, 0);\n'
      '    // tile 0: S and dP alone')),
    ('swa_bwd.cu',
     '    issue_s_dp<D>(sc, dp, q_wg, g_wg, k_s, v_s);',
     '    issue_s_dp<D>(sc, dp, qa, ga, q_wg, g_wg, k_s, v_s);'),
    ('swa_bwd.cu',
     '      issue_s_dp<D>(sc, dp, q_wg, g_wg, k_s + st * T::KV_BYTES,',
     ('      issue_s_dp<D>(sc, dp, qa, ga, q_wg, g_wg, '
      'k_s + st * T::KV_BYTES,')),
    ('swa_bwd.cu',
     ('template <int D>\n'
      '__device__ __forceinline__ void issue_t2(float (&sc)[KvTile<'
      'D>::BQ / 2],\n'
      '                                         float (&dp)[KvTile<'
      'D>::BQ / 2],\n'
      '                                         uint32_t k_c, uint32_t v_c,\n'
      '                                         uint32_t q_st, uint'
      '32_t g_st) {'),
     ('template <int D>\n'
      '__device__ __forceinline__ void issue_t2(float (&sc)[KvTile<'
      'D>::BQ / 2],\n'
      '    float (&dp)[KvTile<D>::BQ / 2],\n'
      '    const uint32_t (&ka)[KvTile<D>::A_REGS ? D / 16 : 1][4],\n'
      '    const uint32_t (&va)[KvTile<D>::A_REGS ? D / 16 : 1][4],\n'
      '    uint32_t k_c, uint32_t v_c, uint32_t q_st, uint32_t g_st) {')),
    ('swa_bwd.cu',
     ('    hop::wgmma_ss_bf16<T::BQ>(sc, k_major<T::SW>(k_c + a),\n'
      '                              k_major<T::SW>(q_st + b), kk > 0);\n'
      '    hop::wgmma_ss_bf16<T::BQ>(dp, k_major<T::SW>(v_c + a),\n'
      '                              k_major<T::SW>(g_st + b), kk > 0);'),
     ('    if constexpr (T::A_REGS) {\n'
      '      hop::wgmma_rs_bf16_kb<T::BQ>(sc, ka[kk], k_major<T::SW'
      '>(q_st + b), kk > 0);\n'
      '      hop::wgmma_rs_bf16_kb<T::BQ>(dp, va[kk], k_major<T::SW'
      '>(g_st + b), kk > 0);\n'
      '    } else {\n'
      '      hop::wgmma_ss_bf16<T::BQ>(sc, k_major<T::SW>(k_c + a),\n'
      '                                k_major<T::SW>(q_st + b), kk > 0);\n'
      '      hop::wgmma_ss_bf16<T::BQ>(dp, k_major<T::SW>(v_c + a),\n'
      '                                k_major<T::SW>(g_st + b), kk > 0);\n'
      '    }')),
    ('swa_bwd.cu',
     ('                       const __grid_constant__ CUtensorMap v_map,\n'
      '                       const float* __restrict__ lse,'),
     ('                       const __grid_constant__ CUtensorMap v_map,\n'
      '                       const bf16* __restrict__ k, const bf1'
      '6* __restrict__ v,\n'
      '                       Strides ski, Strides svi,\n'
      '                       const float* __restrict__ lse,')),
    ('swa_bwd.cu',
     ('      hop::mbar_expect_tx(kv_full, 2 * T::KV_BYTES);\n'
      '      for (int c = 0; c < T::NCOL; ++c) {'),
     ('      if (!T::A_REGS) hop::mbar_expect_tx(kv_full, 2 * T::KV_BYTES);\n'
      '      for (int c = 0; c < (T::A_REGS ? 0 : T::NCOL); ++c) {')),
    ('swa_bwd.cu',
     '    if (n_steps > 0) hop::mbar_wait(kv_full, 0);',
     '    if (n_steps > 0 && !T::A_REGS) hop::mbar_wait(kv_full, 0);'),
    ('swa_bwd.cu',
     '      const uint32_t v_c = v_s + 64 * cw * T::SW;\n',
     ('      const uint32_t v_c = v_s + 64 * cw * T::SW;\n'
      '      uint32_t ka[T::A_REGS ? D / 16 : 1][4], va[T::A_REGS ?'
      ' D / 16 : 1][4];\n'
      '      if constexpr (T::A_REGS) {\n'
      '        load_a<D>(ka, k + bi * ski.b + kvh * ski.h, ski.s, k'
      'j0, s, t);\n'
      '        load_a<D>(va, v + bi * svi.b + kvh * svi.h, svi.s, k'
      'j0, s, t);\n'
      '      }\n')),
    ('swa_bwd.cu',
     '        issue_t2<D>(sc, dp, k_c, v_c, q_s + st * T::Q_BYTES,',
     '        issue_t2<D>(sc, dp, ka, va, k_c, v_c, q_s + st * T::Q_BYTES,'),
    ('swa_bwd.cu',
     '      dq_q, dq_g, dq_k, dq_v, lse, dvec, dq, a.dq, p);',
     ('      dq_q, dq_g, dq_k, dq_v, q, dout, a.q, a.dout, lse, dve'
      'c, dq, a.dq, p);')),
    ('swa_bwd.cu',
     '      kv_q, kv_g, kv_k, kv_v, lse, dvec, dk, dv, part, a.dk, a.dv,',
     ('      kv_q, kv_g, kv_k, kv_v, k, v, a.k, a.v, lse, dvec, dk,'
      ' dv, part, a.dk, a.dv,')),
    ('hopper_bf16.cuh',
     ('// ---------------------------------------------------------'
      '------------------\n'
      '// host: tensor maps'),
     ('template <int N>\n'
      '__device__ __forceinline__ void wgmma_rs_bf16_kb(float (&d)[N / 2],\n'
      '    const uint32_t (&a)[4], uint64_t b, int scale_d);\n'
      'template <>\n'
      '__device__ __forceinline__ void wgmma_rs_bf16_kb<64>(\n'
      '    float (&d)[32], const uint32_t (&a)[4], uint64_t b, int '
      'scale_d) {\n'
      '  asm volatile(\n'
      '      "{\\n.reg .pred p;\\nsetp.ne.b32 p, %37, 0;\\n"\n'
      '      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"\n'
      '      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "\n'
      '      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "\n'
      '      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "\n'
      '      "%30, %31"\n'
      '      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\\n}\\n"\n'
      '      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),\n'
      '        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),\n'
      '        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), '
      '"+f"(d[14]),\n'
      '        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), '
      '"+f"(d[19]),\n'
      '        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), '
      '"+f"(d[24]),\n'
      '        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), '
      '"+f"(d[29]),\n'
      '        "+f"(d[30]), "+f"(d[31])\n'
      '      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),\n'
      '        "r"(scale_d));\n'
      '}\n'
      '\n'
      '// ---------------------------------------------------------'
      '------------------\n'
      '// host: tensor maps')),
]

_AHEAD = [
    ('swa_bwd.cu',
     '    const int64_t per',
     ("    // With three stages a step's second products are issued"
      ' after the next\n'
      "    // step's first and run while that step's P^T and dS^T a"
      're formed (as\n'
      "    // dQ's); with two (D = 256) they run within their own s"
      'tep, so that\n'
      "    // the next step's tiles load meanwhile.\n"
      '    constexpr bool AHEAD = STAGES >= 3;\n'
      '    const int64_t per')),
    ('swa_bwd.cu',
     ('        const int q0 = q_begin + n % n_q * BQ;\n'
      '        hop::mbar_wait(full(st), (n / STAGES) & 1);\n'
      '        issue_t2<D>(sc, dp, k_c, v_c, q_s + st * T::Q_BYTES,\n'
      '                    g_s + st * T::Q_BYTES);\n'
      '        hop::wgmma_wait<0>();\n'),
     ('        const int ps = (n + STAGES - 1) % STAGES;   // the s'
      "tep before's\n"
      '        const int q0 = q_begin + n % n_q * BQ;\n'
      '        hop::mbar_wait(full(st), (n / STAGES) & 1);\n'
      '        issue_t2<D>(sc, dp, k_c, v_c, q_s + st * T::Q_BYTES,\n'
      '                    g_s + st * T::Q_BYTES);\n'
      '        if (AHEAD && n > 0) {\n'
      '          issue_acc2<D>(acc_v, pa, acc_k, pd, q_s + ps * T::Q_BYTES,\n'
      '                        g_s + ps * T::Q_BYTES);\n'
      '          hop::wgmma_wait<1>();\n'
      '        } else {\n'
      '          hop::wgmma_wait<0>();\n'
      '        }\n')),
    ('swa_bwd.cu',
     ('        ds_cols<BQ>(dp, sc, d_s + st * BQ, t);\n'
      '        pack_a<BQ>(pa, sc);\n'
      '        pack_a<BQ>(pd, dp);\n'
      '        issue_acc2<D>(acc_v, pa, acc_k, pd, q_s + st * T::Q_BYTES,\n'
      '                      g_s + st * T::Q_BYTES);\n'
      '        hop::wgmma_wait<0>();\n'
      '        hop::fence_regs(acc_k);\n'
      '        hop::fence_regs(acc_v);\n'
      '        if (lane == 0) hop::mbar_arrive(empty(st));\n'
      '      }\n'),
     ('        ds_cols<BQ>(dp, sc, d_s + st * BQ, t);\n'
      '        if constexpr (AHEAD) {\n'
      '          if (n > 0) {\n'
      '            hop::wgmma_wait<0>();\n'
      '            hop::fence_regs(acc_k);\n'
      '            hop::fence_regs(acc_v);\n'
      '            hop::fence_regs(sc);   // packed after the produ'
      'cts read pa, pd\n'
      '            hop::fence_regs(dp);\n'
      '            if (lane == 0) hop::mbar_arrive(empty(ps));\n'
      '          }\n'
      '          pack_a<BQ>(pa, sc);\n'
      '          pack_a<BQ>(pd, dp);\n'
      '        } else {\n'
      '          pack_a<BQ>(pa, sc);\n'
      '          pack_a<BQ>(pd, dp);\n'
      '          issue_acc2<D>(acc_v, pa, acc_k, pd, q_s + st * T::Q_BYTES,\n'
      '                        g_s + st * T::Q_BYTES);\n'
      '          hop::wgmma_wait<0>();\n'
      '          hop::fence_regs(acc_k);\n'
      '          hop::fence_regs(acc_v);\n'
      '          if (lane == 0) hop::mbar_arrive(empty(st));\n'
      '        }\n'
      '      }\n'
      '      if (AHEAD && n_steps > 0) {\n'
      '        const int ls = (n_steps - 1) % STAGES;\n'
      '        issue_acc2<D>(acc_v, pa, acc_k, pd, q_s + ls * T::Q_BYTES,\n'
      '                      g_s + ls * T::Q_BYTES);\n'
      '        hop::wgmma_wait<0>();\n'
      '        hop::fence_regs(acc_k);\n'
      '        hop::fence_regs(acc_v);\n'
      '      }\n')),
    ('swa_bwd.cu',
     ('        const int q0 = q_begin + n % n_q * BQ;\n'
      '        hop::mbar_wait(full(st), (n / STAGES) & 1);\n'
      '        issue_t<D>(x, a_s, (cw == 0 ? q_s : g_s) + st * T::Q_BYTES);\n'
      '        hop::wgmma_wait<0>();\n'),
     ('        const int ps = (n + STAGES - 1) % STAGES;\n'
      '        const int q0 = q_begin + n % n_q * BQ;\n'
      '        hop::mbar_wait(full(st), (n / STAGES) & 1);\n'
      '        issue_t<D>(x, a_s, (cw == 0 ? q_s : g_s) + st * T::Q_BYTES);\n'
      '        if (AHEAD && n > 0) {\n'
      '          issue_acc<D>(acc, pa, b2_s + ps * T::Q_BYTES);\n'
      '          hop::wgmma_wait<1>();\n'
      '        } else {\n'
      '          hop::wgmma_wait<0>();\n'
      '        }\n')),
    ('swa_bwd.cu',
     ('          ds_cols<BQ>(x, pv, d_s + st * BQ, t);\n'
      '        }\n'
      '        pack_a<BQ>(pa, x);\n'
      '        issue_acc<D>(acc, pa, b2_s + st * T::Q_BYTES);\n'
      '        hop::wgmma_wait<0>();\n'
      '        hop::fence_regs(acc);\n'
      '        if (lane == 0) hop::mbar_arrive(empty(st));\n'
      '      }\n'),
     ('          ds_cols<BQ>(x, pv, d_s + st * BQ, t);\n'
      '        }\n'
      '        if constexpr (AHEAD) {\n'
      '          if (n > 0) {\n'
      '            hop::wgmma_wait<0>();\n'
      '            hop::fence_regs(acc);\n'
      '            hop::fence_regs(x);   // packed after the product read pa\n'
      '            if (lane == 0) hop::mbar_arrive(empty(ps));\n'
      '          }\n'
      '          pack_a<BQ>(pa, x);\n'
      '        } else {\n'
      '          pack_a<BQ>(pa, x);\n'
      '          issue_acc<D>(acc, pa, b2_s + st * T::Q_BYTES);\n'
      '          hop::wgmma_wait<0>();\n'
      '          hop::fence_regs(acc);\n'
      '          if (lane == 0) hop::mbar_arrive(empty(st));\n'
      '        }\n'
      '      }\n'
      '      if (AHEAD && n_steps > 0) {\n'
      '        issue_acc<D>(acc, pa, b2_s + (n_steps - 1) % STAGES '
      '* T::Q_BYTES);\n'
      '        hop::wgmma_wait<0>();\n'
      '        hop::fence_regs(acc);\n'
      '      }\n')),
]

# name -> [(file, old text, new text), ...]
VARIANTS = {
    "as_is": [],
    "split_d64": [
        ("swa_bwd.cu", "  static constexpr bool OWN = D <= 64;\n",
         "  static constexpr bool OWN = false;\n"),
        ("swa_bwd.cu",
         "  static constexpr int BQ = 64;\n"
         "  static constexpr int STAGES = D == 256 ? 2 : 3;",
         "  static constexpr int BQ = D <= 64 ? 128 : 64;\n"
         "  static constexpr int STAGES = D == 256 ? 2 : 3;")],
    "split_d64_q64": [
        ("swa_bwd.cu", "  static constexpr bool OWN = D <= 64;\n",
         "  static constexpr bool OWN = false;\n")],
    "ahead": _AHEAD,
    "ahead_two_stages": [
        (f, old, new.replace("constexpr bool AHEAD = STAGES >= 3;",
                             "constexpr bool AHEAD = true;"))
        for f, old, new in _AHEAD],
    "dq_keys128": [("swa_bwd.cu",
                    "  static constexpr int BK = D == 256 ? 32 : 64;\n",
                    "  static constexpr int BK = D == 256 ? 32 : "
                    "(D <= 64 ? 128 : 64);\n")],
    "regs_a": _REGS_A,
}


def variant_sources(name: str) -> dict:
    """{file name: text} of the csrc files a variant changes, substituted;
    raises if a substitution does not match the sources exactly once."""
    out = {}
    for fname, old, new in VARIANTS[name]:
        text = out.get(fname, (build.CSRC / fname).read_text())
        if text.count(old) != 1:
            raise ValueError(f"variant {name}: {fname} holds {old!r} "
                             f"{text.count(old)} times, not once")
        out[fname] = text.replace(old, new)
    return out


def build_variants(names) -> dict:
    """Build each variant from a copy of csrc with its substitutions, one
    nvcc each, all at once; returns {name: (library, ptxas lines)}."""
    root = build.BUILD_DIR / "swa_bwd_variants"
    procs = {}
    for name in names:
        src = root / name
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(build.CSRC, src)
        for fname, text in variant_sources(name).items():
            (src / fname).write_text(text)
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-o", str(src / "lib.so"),
               str(src / "swa_bwd.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    out = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise build.KernelBuildError(f"variant {name}:\n{log}")
        lib = ctypes.CDLL(str(root / name / "lib.so"))
        entry, argtypes = build.SIGNATURES["swa_bwd"]
        getattr(lib, entry).argtypes = argtypes
        getattr(lib, entry).restype = ctypes.c_int
        out[name] = (lib, ptxas_report(log))
    return out


def check(rn) -> int:
    """The routed library at CASES in bf16 on (B, S, H, D) views: each
    gradient within GRAD_TOL and GRAD_RMS_TOL of the plain backward on
    fp32 copies, and a second launch's bits; returns the cases that
    failed, printing each."""
    bad = 0
    for b, h, kh, s, d, w, pre in CASES:
        q, k, v, g = (rn(b, s, n, d).bfloat16().transpose(1, 2)
                      for n in (h, kh, kh, h))
        _, lse, o = swa_forward(q, k, v, w, with_lse=True, prefix=pre)
        got = swa_backward(q, k, v, o, lse, g, window=w, prefix=pre)
        again = swa_backward(q, k, v, o, lse, g, window=w, prefix=pre)
        want = swa_backward_ref(q.float(), k.float(), v.float(), o, lse,
                                g.float(), w, pre)
        rec = _grad_errs(got, want, torch.bfloat16)
        rec["same_bits"] = all(torch.equal(x, y) for x, y in zip(got, again))
        if not (rec["ok"] and rec["same_bits"]):
            bad += 1
            print(json.dumps({"case": [b, h, kh, s, d, w, pre], **rec}),
                  flush=True)
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("swa_bwd_variants needs a CUDA card")
    libs = build_variants(args.variants)
    build.build_all(("swa",))
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    failed = 0
    for name in args.variants:
        build._loaded["swa_bwd"] = libs[name][0]
        bad = check(rn)
        failed += bad
        print(json.dumps({"variant": name, "ptxas": libs[name][1],
                          "cases": len(CASES), "failed": bad}), flush=True)
    order = list(args.variants) + list(reversed(args.variants))
    for shape, b, h, kh, s, d, w, pre in TIME_SHAPES:
        q, k, v, g = (rn(b, s, n, d).bfloat16().transpose(1, 2)
                      for n in (h, kh, kh, h))
        _, lse, o = swa_forward(q, k, v, w, with_lse=True, prefix=pre)

        def call():
            return swa_backward(q, k, v, o, lse, g, window=w, prefix=pre)
        rec = {}
        for name in order:
            build._loaded["swa_bwd"] = libs[name][0]
            kernels = profile_bwd(call, 5)
            rec.setdefault(name, []).append({
                "ms": _ms(call, 20), "device_ms": sum(kernels.values()),
                "kernels_ms": {key.split("::")[-1][:28]: x
                               for key, x in kernels.items()}})
        print(json.dumps({"shape": shape, "dims": [b, h, kh, s, d, w, pre],
                          "variants": rec,
                          "device": torch.cuda.get_device_name(0)}),
              flush=True)
        del q, k, v, g, lse, o
        torch.cuda.empty_cache()
    build._loaded.pop("swa_bwd", None)
    print("ALL_OK" if failed == 0 else "FAILED", flush=True)
    return 0 if failed == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
