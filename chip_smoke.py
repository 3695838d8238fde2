#!/usr/bin/env python3
"""On-chip smoke of the PyTorch/CUDA port (``src/repro_torch``).

Builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version on the card, then drives the
paper's offload loop through the client entry point
``AlchemistContext(device="cuda")``:

  * §4.1: upload TIMIT-width speech data (d = 440, c = 147 classes), then
    ridge regression by CG over an engine-side random-feature expansion
    to D = 10,000 (``skylark.cg_solve``), 20 iterations at tol = 0;
  * §4.2: upload an ocean-like field 8,096 wide, then rank-20
    ``elemental.truncated_svd`` and ``elemental.gram_svd`` on it;

and streams the factors back. Rows are cut from the paper's 2,251,569
(TIMIT) and 6,177,583 (ocean) to 1,048,576 each so one 80 GB card holds
the work (Z = n x D fp32 is 41.9 GB). Then a chain submitted in one burst
(``G = gram(A)``, ``G^T``, ``S = G + G^T``, ``P = S S`` on the ocean field
8,096 wide, cut to 65,536 rows) runs as one task, captured into a CUDA
graph and replayed, held against the same chain unfused, and so does a
16-stage multiply chain at 512 x 512. Then the compile cache: an
odd-shaped tenant mix at the paper's widths (a TIMIT block times its
weights, the Gram of 60,000 x 4,000, a transpose, an add and a 3-stage
multiply chain) served by a cold engine and, after warmup() over the
executable index it left, by a fresh one with nothing built on the
request path; the same warm restart across two server processes sharing
a compile cache dir; and the gram chain on the ocean field padded to
8,192 columns by bucketing. Then the same loop runs through its
deployed entry point, a client ``AlchemistContext(address=...)`` talking
TCP frames to the port's server (``repro_torch.core.server``) on the
card: the same speech data and CG, whose W must equal the in-memory W bit
for bit; the ocean field at 262,144 rows with both SVDs; and the server
started as its own process (``python -m repro_torch.core.server``)
answering a small CG. Then it serves RecurrentGemma-9B
at its published widths, all 38 layers, random fp32 parameters from a
seed, through ``repro_torch.serve.ServingEngine``: 8 requests of
3,584-4,096-token prompts, 32 new tokens each, in two waves of 4, every
prefill running the swa and lru_scan kernels; and it holds the last
logits of a full forward against prefill + one decode step. Then it
trains RecurrentGemma-9B at the same widths, cut to one (rec, rec,
local) cycle: the step-0 gradient of every parameter (through the swa
and lru_scan autograd Functions, whose backward passes are the swa_bwd
kernel and lru_scan's reverse launch), a GaLore projector refresh through
the engine's randomized SVD, 8 AdamW steps at B = 2, S = 4,096, and the
offloaded linear probe on the trained trunk. Then it serves qwen3-4b at
its published widths, all 36 layers, with RecurrentGemma's traffic,
every prefill's global attention on the swa kernel at window = S, and
holds a full forward against prefill + decode; and runs each other
decoder-only family (qwen3-4b-sw, stablelm-1.6b, rwkv6-1.6b,
codeqwen1.5-7b, and yi-34b, deepseek-v2-lite-16b and deepseek-v2-236b
cut in depth to what one card holds) at its published widths through the
serving engine, one 2,048-token request each, with the same check. Then
it serves paligemma-3b (all 18 layers, every prefill's attention on the
swa kernel with its 256 image patches as a bidirectional prefix) and
whisper-medium (24 encoder layers on swa with prefix = window = S over
1,500 frames, 24 decoder layers causal, cross-attention plain) at their
published widths, 8 requests each in two waves of 4 with patch
embeddings or frames drawn per wave, with the same full-forward check.
Then it trains both at their published widths and full depth (PaliGemma
B = 4 x 768 positions, Whisper B = 4 x 448 tokens after 1,500 frames),
bf16 with remat, 4 AdamW steps each after the step-0 gradient check,
every attention layer's backward on swa_bwd (PaliGemma's with prefix 256,
Whisper's encoder's with prefix = S), beside the dry run's predicted
bytes. Before the main path it also holds the two backward kernels
against their plain versions at the JAX sweeps and the training shapes,
swa at window = S at the dense families' shapes, swa and swa_bwd with a
prefix at PaliGemma's and Whisper's encoder's shapes, the reduced
RecurrentGemma, qwen3-4b, rwkv6-1.6b, deepseek-v2-lite-16b, paligemma-3b
and whisper-medium's loss and gradients on the card against the CPU, and
the reduced paligemma-3b and whisper-medium's forward on the card against
the CPU.

Each phase prints JSON lines; a failing check raises and the script exits
non-zero. It needs one CUDA card and imports nothing of JAX or of the JAX
package.

    python3 chip_smoke.py
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import queue
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense) used for the bounds: an
# operation counts against the card's rate for the route the kernel takes,
# fp32 outside the tensor cores, TF32 or bf16 on them; bytes against HBM3
# bandwidth
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

# widths of the paper's workloads (never cut) and the cut row counts
TIMIT_D, RF_DIM, TIMIT_C = 440, 10_000, 147
OCEAN_D, SVD_K = 8_096, 20
CG_ROWS = 1_048_576            # of 2,251,569: Z must fit the card
SVD_ROWS = 1_048_576           # of 6,177,583
# the ocean field sent over the socket: a quarter of SVD_ROWS bounds the
# host generator's time
SVD_SOCKET_ROWS = 262_144
SVD_CHUNK_ROWS = 128
# how long the server process may take to print its address
SERVER_START_S = 180
CG_ITERS = 20
REF_BLOCK_ROWS = 65_536        # row blocks of the full-size references
DEVICE = "cuda"

# serving RecurrentGemma-9B (published widths, 38 layers)
LM_ARCH = "recurrentgemma-9b"
LM_REQUESTS, LM_MAX_BATCH, LM_NEW_TOKENS = 8, 4, 32
LM_PROMPT_MIN, LM_PROMPT_MAX = 3_584, 4_096
# the main path's kernel shapes: one wave of 4 prompts padded to 4,096;
# and lru_scan at one prompt of 16,384 tokens
LM_B, LM_S = LM_MAX_BATCH, LM_PROMPT_MAX
LM_LONG_S = 16_384
# prefill + decode against a full forward: 3e-2 of max |logit|
# (tests/test_models_smoke.py reads 3e-2, here relative to scale)
LM_CONSISTENCY_TOL = 3e-2

# serving qwen3-4b (published widths, 36 layers): RecurrentGemma's traffic,
# every prefill's attention on the swa kernel with window = S
DENSE_ARCH = "qwen3-4b"
# each other decoder-only family at published widths: one request of
# FAMILY_S tokens, FAMILY_NEW new tokens; at the most layers whose fp32
# parameters fit FAMILY_BUDGET_BYTES, half the card (the rest holds the
# bf16 casts, the caches and the activations)
FAMILIES = ("qwen3-4b-sw", "stablelm-1.6b", "rwkv6-1.6b", "codeqwen1.5-7b",
            "yi-34b", "deepseek-v2-lite-16b", "deepseek-v2-236b")
FAMILY_S, FAMILY_NEW = 2_048, 8
FAMILY_BUDGET_BYTES = 40e9
# swa at window = S at the dense families' shapes on the path: (arch,
# batch, sequence)
CAUSAL_SHAPES = (("qwen3-4b", LM_MAX_BATCH, LM_PROMPT_MAX),
                 ("stablelm-1.6b", 1, FAMILY_S), ("yi-34b", 1, FAMILY_S))

# serving the prefix-VLM and the encoder-decoder at published widths and
# full depth, with RecurrentGemma's waves and new tokens: (arch, shortest
# and longest text prompt). PaliGemma's prompts follow its 256 image
# patches; Whisper's decoder prompt is its start tokens plus up to 223
# tokens of previous text, after the encoder's 1,500 frames
MODAL_TRAFFIC = (("paligemma-3b", 32, 512), ("whisper-medium", 4, 224))
# swa with a bidirectional prefix at window = S on the path: (arch, batch,
# sequence, prefix): PaliGemma's 256 patches and longest prompt; Whisper's
# encoder, bidirectional over its 1,500 frames
PREFIX_SHAPES = (("paligemma-3b", LM_MAX_BATCH, 256 + 512, 256),
                 ("whisper-medium", LM_MAX_BATCH, 1_500, 1_500))

# tolerances of the JAX package's kernel tests (tests/test_kernels.py,
# tests/test_extensions.py, tests/test_lru_loss_kernels.py): rtol, and
# atol as a multiple of max|want| (rf_map's, swa's and lru_scan's atol is
# absolute)
TOL = {"gram": {"float32": 2e-5, "bfloat16": 2e-2},
       "normal_matvec": {"float32": 3e-5, "bfloat16": 3e-2},
       "rf_map": {"float32": 1e-5, "bfloat16": 2e-2},
       "swa": {"float32": 2e-5, "bfloat16": 3e-2},
       "lru_scan": {"float32": 1e-5, "bfloat16": 3e-2}}

# swa at the main shape: with D = 256 and up to 2,048 visible keys an
# output is a softmax average of v, typically sqrt(e / 2,048) ~ 0.04, so
# the tests' absolute 3e-2 would be as large as what it compares. There
# the bf16 kernel is held against the plain version on fp32 copies of its
# inputs, per element within one bf16 ulp of |want| (twice its output's
# rounding) plus SWA_ATOL_RMS times the output's RMS; and the same limit
# must reject two planted faults, a window one key short and a softmax
# scale 10 % high.
SWA_RTOL = 2.0 ** -7
SWA_ATOL_RMS = 1e-2
# launches a swa time and its library yardstick's are the mean of: at a
# tenth of a millisecond three launches are decided by noise
SWA_REPS = 20

KERNEL_META = {
    "gram": ("src/repro_torch/csrc/gram.cu",
             "src/repro/kernels/gram/gram.py:38"),
    "normal_matvec": ("src/repro_torch/csrc/normal_matvec.cu",
                      "src/repro/kernels/normal_matvec/normal_matvec.py:40"),
    "rf_map": ("src/repro_torch/csrc/rf_map.cu",
               "src/repro/kernels/rf_map/rf_map.py:42"),
    "swa": ("src/repro_torch/csrc/swa.cu",
            "src/repro/kernels/swa/swa.py:69"),
    "lru_scan": ("src/repro_torch/csrc/lru_scan.cu",
                 "src/repro/kernels/lru_scan/lru_scan.py:44"),
    # the backward halves: the TPU kernels they differentiate have no
    # backward (the JAX package differentiates XLA attention and
    # jax.lax.associative_scan)
    "swa_bwd": ("src/repro_torch/csrc/swa_bwd.cu",
                "src/repro/kernels/swa/swa.py:69"),
    "lru_scan_reverse": ("src/repro_torch/csrc/lru_scan.cu",
                         "src/repro/kernels/lru_scan/lru_scan.py:44"),
}
# what each kernel computes on
KERNEL_DESIGN = {
    "gram": "fp32 CUDA cores, 128x128 register tiles",
    "normal_matvec": "3xTF32 wgmma",
    "rf_map": "3xTF32 wgmma, persistent 128x160 tiles columns fastest, "
              "cos epilogue staged through shared memory",
    "swa": "bf16: wgmma on TMA-fed 128-byte swizzled tiles, a producer "
           "warpgroup (setmaxnreg 40) and two consumer warpgroups of 64 "
           "query rows (232) ping-ponging on named barriers; S = Q K^T "
           "from shared memory, O += P V with P from registers in fp16 "
           "against v taken to fp16 after a power-of-two scale per "
           "(batch, kv head) (two small kernels first); 128-query blocks, "
           "128-key steps (64 at D = 256), longest first. fp32: CUDA "
           "cores",
    "lru_scan": "fp32 CUDA cores; a block scans 32 channels of one batch "
                "row over a chunk of time from registers (8 warps of 32 "
                "steps), the chunks chained by a carry with release/acquire "
                "flags in launch-ticket order; a fixed association",
    "swa_bwd": "bf16 mma.sync, P and dS rounded to bf16, D from the "
               "forward's fp32 output; dQ kernel of 64 queries a block, "
               "dK/dV kernel of 64 keys a block over a quarter of the kv "
               "head's query heads, fp32 partials summed in order (no "
               "atomics); a prefix widens the tiles a block walks",
    "lru_scan_reverse": "the lru_scan kernel with time reversed (its "
                        "REVERSE template flag), writing a's gradient "
                        "da_t = lambda_t h_{t-1} in the same pass",
}
# keys a kernel's record may add to its entry in the kernels line
KERNEL_EXTRAS = ("bound_ms_fp32_cuda_cores", "library_note",
                 "copy_ceiling_ms", "train_shape", "long_prompt",
                 "causal_shapes", "prefix_shapes", "prefix_launches",
                 "unfused_ms", "device_ms",
                 "lambda_only_ms", "lambda_only_bound_ms")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_time_ms(fn, reps: int = 3) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` runs after one
    warm-up run, timed with CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def bound_ms(nbytes: float, flops: float,
             peak: float = FP32_FLOPS) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def close(name: str, got, want, dtype: str, absolute_atol: bool = False):
    """Raise unless ``got`` matches ``want`` at the JAX tests' tolerance;
    returns the max absolute error."""
    import torch
    tol = TOL[name][dtype]
    scale = 1.0 if absolute_atol else float(want.abs().max())
    err = (got - want).abs()
    limit = tol * scale + tol * want.abs()
    if not bool(torch.isfinite(got).all()) or bool((err > limit).any()):
        raise AssertionError(
            f"{name} {dtype} {tuple(got.shape)}: max abs err "
            f"{float(err.max()):.3e} exceeds rtol {tol} / atol "
            f"{tol * scale:.3e}")
    return float(err.max())


def held_scan(name: str, got, want, emulated, again, dtype: str) -> float:
    """Raise unless a scan output of ``csrc/lru_scan.cu`` is within the
    JAX tests' tolerance of its plain version and the same bits as its
    emulation (``lru_scan_chunked_ref``) and as a second launch; returns
    the max absolute error."""
    import torch
    err = close("lru_scan", got, want, dtype, absolute_atol=True)
    for what, other in (("lru_scan_chunked_ref", emulated),
                        ("a second launch", again)):
        if not torch.equal(got, other):
            raise AssertionError(
                f"{name} {dtype} {tuple(got.shape)}: not the bits of "
                f"{what} ({int((got != other).sum())} elements differ)")
    return err


# ---------------------------------------------------------------------------
# phase 1: the device
# ---------------------------------------------------------------------------
def phase_device() -> str:
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "sms": torch.cuda.get_device_properties(0).multi_processor_count})
    return smi


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------
def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build_all()
    for name in build.KERNELS:
        build.load(name)
    ptxas = {}
    for name, rec in build.build_log.items():
        ptxas[name] = [ln.strip() for ln in rec["ptxas"].splitlines()
                       if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": ptxas})


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------
def _randn(rng, shape, dtype):
    import torch
    t = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    return t.to(device=DEVICE, dtype=dtype)


def check_test_shapes() -> None:
    """The shapes, dtypes and tolerances of the JAX package's kernel
    tests, fp32 and bf16, plus the 130-row case the TPU wrapper pads."""
    import torch
    from repro_torch.kernels.gram.ops import gram
    from repro_torch.kernels.gram.ref import gram_ref
    from repro_torch.kernels.normal_matvec.ops import normal_matvec
    from repro_torch.kernels.normal_matvec.ref import normal_matvec_ref
    from repro_torch.kernels.rf_map.ops import rf_map_apply
    from repro_torch.kernels.rf_map.ref import rf_map_ref, rf_weights
    rng = np.random.default_rng(0)
    n_checked = 0
    for dt in (torch.float32, torch.bfloat16):
        dn = str(dt).removeprefix("torch.")
        for n, d in [(256, 128), (512, 256), (384, 200), (1000, 64),
                     (128, 384)]:
            a = _randn(rng, (n, d), dt)
            close("gram", gram(a), gram_ref(a), dn)
            n_checked += 1
        # the JAX tests' shapes, then the tensor-core kernel's edges: a
        # partial column tile (D 161, 10,000), a partial row tile (130,
        # 257), rows not 16-byte aligned (d 33), a short last stage (440)
        for n, d, dd in [(256, 128, 256), (300, 70, 200), (512, 440, 1024),
                         (100, 33, 77), (130, 440, 161), (257, 440, 10000),
                         (1000, 33, 10000)]:
            x = _randn(rng, (n, d), dt)
            w, b = (torch.from_numpy(v).to(DEVICE)
                    for v in rf_weights(d, dd, 2.0, 1))
            close("rf_map", rf_map_apply(x, w, b), rf_map_ref(x, w, b), dn,
                  absolute_atol=True)
            n_checked += 1
        # the JAX tests' shapes, then the tensor-core kernel's column tiles
        # (c = 147, 160; 161 takes two) at row counts off its 128-row tile
        for n, d, c in [(256, 64, 4), (300, 128, 1), (512, 440, 16),
                        (1000, 37, 3), (130, 32, 2), (1000, 200, 147),
                        (777, 256, 160), (300, 70, 161)]:
            x = _randn(rng, (n, d), dt)
            w = _randn(rng, (d, c), torch.float32)
            close("normal_matvec", normal_matvec(x, w),
                  normal_matvec_ref(x, w), dn)
            n_checked += 1
        n_checked += check_lm_test_shapes(rng, dt, dn)
    torch.cuda.synchronize()
    emit({"phase": "kernel_test_shapes", "cases": n_checked})


def _swa_case(rng, dt, dn, s, window, h, kh, d) -> None:
    """swa on (2, s, h, d) queries and (2, s, kh, d) keys and values as
    (B, S, H, D) views against its plain version (bf16 also to the main
    shape's limit), and swa_bwd from the kernel's own o and lse against
    its plain version on fp32 copies of the same operands."""
    import torch
    from repro_torch.kernels.swa.ops import swa_attention, \
        swa_backward, swa_forward
    from repro_torch.kernels.swa.ref import swa_backward_ref, \
        swa_forward_ref, swa_ref
    q = _randn(rng, (2, s, h, d), dt).transpose(1, 2)
    k, v = (_randn(rng, (2, s, kh, d), dt).transpose(1, 2)
            for _ in range(2))
    got = swa_attention(q, k, v, window=window)
    close("swa", got, swa_ref(q, k, v, window), dn, absolute_atol=True)
    if dt == torch.bfloat16:
        ratio = swa_excess(got, swa_ref(q.float(), k.float(), v.float(),
                                        window))[1]
        if not ratio <= 1.0:
            raise AssertionError(f"swa bfloat16 {tuple(q.shape)} window "
                                 f"{window}: {ratio:.3f} x the limit")
    _, lse, o32 = swa_forward(q, k, v, window, with_lse=True)
    want_lse = swa_forward_ref(q.float(), k.float(), v.float(), window)[1]
    close_grad("swa_lse", lse, want_lse, 2e-5)
    dout = _randn(rng, (2, s, h, d), dt).transpose(1, 2)
    got = swa_backward(q, k, v, o32, lse, dout, window=window)
    want = swa_backward_ref(q.float(), k.float(), v.float(), o32, lse,
                            dout.float(), window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        close_grad(f"swa_bwd {name} {dn} {tuple(q.shape)} {window}", g, w,
                   GRAD_TOL[dn], GRAD_RMS_TOL.get(dn))


def _swa_edge_case(rng, dt, dn, b, h, kh, s, d, window, prefix) -> None:
    """The forward kernel at one of its tile edges
    (``forward_check.edge_cases``: S around the 128-query and -key tiles,
    windows of 1 to S, prefixes of 1 to S, GQA groups of 1 to 16) on
    (B, S, H, D) views: the output against its plain version (bf16 also to
    the main shape's limit, as are training's output and fp32 output from
    the with-lse launch, which splits P), lse, and two launches the same
    bits."""
    import torch
    from repro_torch.kernels.swa.ops import swa_attention, swa_forward
    from repro_torch.kernels.swa.ref import swa_forward_ref, swa_ref
    q = _randn(rng, (b, s, h, d), dt).transpose(1, 2)
    k, v = (_randn(rng, (b, s, kh, d), dt).transpose(1, 2)
            for _ in range(2))
    got = swa_attention(q, k, v, window=window, prefix=prefix)
    what = f"swa {dn} {tuple(q.shape)} kv {kh} window {window} prefix " \
        f"{prefix}"
    close("swa", got, swa_ref(q, k, v, window, prefix), dn,
          absolute_atol=True)
    out, lse, o32 = swa_forward(q, k, v, window, with_lse=True,
                                prefix=prefix)
    want, want_lse = swa_forward_ref(q.float(), k.float(), v.float(),
                                     window, prefix)
    if dt == torch.bfloat16:
        # serving's output; training's, whose launch splits P, and its
        # fp32 output
        for name, t in (("out", got), ("training out", out), ("o32", o32)):
            ratio = swa_excess(t, want)[1]
            if not ratio <= 1.0:
                raise AssertionError(f"{what}: {name} {ratio:.3f} x the "
                                     "limit")
    close_grad("swa_lse", lse, want_lse, 2e-5)
    if not torch.equal(got, swa_attention(q, k, v, window=window,
                                          prefix=prefix)):
        raise AssertionError(f"{what}: two launches differ")


def _swa_prefix_case(rng, dt, dn, s, window, prefix, h, kh, d) -> None:
    """swa with a bidirectional prefix on (2, s, h, d) queries and
    (2, s, kh, d) keys and values as (B, S, H, D) views against its plain
    version (bf16 also to the main shape's limit), and swa_bwd with the
    prefix, from the forward's lse and fp32 output as training runs it,
    against its plain version on fp32 copies."""
    import torch
    from repro_torch.kernels.swa.ops import swa_attention, swa_backward, \
        swa_forward
    from repro_torch.kernels.swa.ref import swa_backward_ref, swa_ref
    q = _randn(rng, (2, s, h, d), dt).transpose(1, 2)
    k, v = (_randn(rng, (2, s, kh, d), dt).transpose(1, 2)
            for _ in range(2))
    got = swa_attention(q, k, v, window=window, prefix=prefix)
    close("swa", got, swa_ref(q, k, v, window, prefix), dn,
          absolute_atol=True)
    if dt == torch.bfloat16:
        ratio = swa_excess(got, swa_ref(q.float(), k.float(), v.float(),
                                        window, prefix))[1]
        if not ratio <= 1.0:
            raise AssertionError(f"swa bfloat16 {tuple(q.shape)} window "
                                 f"{window} prefix {prefix}: {ratio:.3f} x "
                                 "the limit")
    _, lse, o32 = swa_forward(q, k, v, window, with_lse=True, prefix=prefix)
    dout = _randn(rng, (2, s, h, d), dt).transpose(1, 2)
    got = swa_backward(q, k, v, o32, lse, dout, window=window, prefix=prefix)
    want = swa_backward_ref(q.float(), k.float(), v.float(), o32, lse,
                            dout.float(), window, prefix)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        close_grad(f"swa_bwd {name} {dn} {tuple(q.shape)} {window} prefix "
                   f"{prefix}", g, w, GRAD_TOL[dn], GRAD_RMS_TOL.get(dn))


def check_lm_test_shapes(rng, dt, dn) -> int:
    """swa and lru_scan at the JAX sweeps (tests/test_kernels.py,
    tests/test_lru_loss_kernels.py), plus S not a multiple of 64, MQA,
    window >= S, S = 300 on (B, S, H, D) views at every head dim (also
    with prefixes of 1, 100 and S, at window = S and 100), one query head
    a kv head, global attention (window >= S) at head dims 64 and 128
    with GQA groups of 1, 4 and 7, and the bf16 kernel's tile edges
    (``forward_check.edge_cases``, every head dim): fp32 through the
    CUDA-core route, bf16 through the tensor-core route, which is also
    held to the main shape's limit (swa_excess)."""
    import torch
    from repro_torch.kernels.lru_scan.lru_scan import CHUNK, WARPS
    from repro_torch.kernels.lru_scan.ops import lru_scan, lru_scan_reverse
    from repro_torch.kernels.lru_scan.ref import lru_scan_chunked_ref, \
        lru_scan_ref, lru_scan_reverse_ref
    from repro_torch.launch.forward_check import edge_cases
    n = 0
    for s, window, kh, d in [(128, 32, 2, 32), (256, 96, 2, 32),
                             (256, 256, 2, 32), (512, 128, 2, 32),
                             (200, 48, 2, 32), (192, 64, 1, 32),
                             (128, 1000, 2, 32), (300, 100, 1, 32),
                             (300, 100, 1, 64), (300, 100, 1, 128),
                             (300, 100, 1, 256), (200, 50, 4, 64)]:
        _swa_case(rng, dt, dn, s, window, 4, kh, d)
        n += 1
    # the prefix-LM's and the encoder's mask at S = 300, every head dim: a
    # prefix of one key, one off the 64-key tile, and all S
    for d in (32, 64, 128, 256):
        for prefix in (1, 100, 300):
            for window in (300, 100):
                _swa_prefix_case(rng, dt, dn, 300, window, prefix, 4, 1, d)
                n += 1
    # the bf16 kernel's tile edges at every head dim (forward only; the
    # backward's sweep is above and below)
    for case in edge_cases():
        _swa_edge_case(rng, dt, dn, *case)
        n += 1
    # global attention (window >= S), the dense families' layers: head
    # dims 64 and 128, GQA groups of 1, 4 and 7 (yi-34b's 56 heads over 8)
    for s, window, h, kh, d in [(200, 200, 4, 4, 64), (300, 300, 8, 2, 128),
                                (256, 1000, 14, 2, 128), (150, 150, 7, 1, 64),
                                (320, 320, 32, 8, 128)]:
        _swa_case(rng, dt, dn, s, window, h, kh, d)
        n += 1
    # the JAX sweep, then the chunks' edges: S = 1, S short of a chunk,
    # off a chunk's end and on it, W off the 32-channel group (33, 100)
    for b, s, w in [(2, 64, 128), (1, 100, 96), (3, 128, 512), (1, 1, 64),
                    (3, 77, 100), (2, 300, 33), (1, 512, 64), (2, 600, 40)]:
        a = torch.sigmoid(_randn(rng, (b, s, w), torch.float32)).to(dt)
        x = (0.1 * _randn(rng, (b, s, w), torch.float32)).to(dt)
        h0 = _randn(rng, (b, w), torch.float32)
        hs = lru_scan(a, x, h0)
        held_scan("lru_scan", hs, lru_scan_ref(a, x, h0),
                  lru_scan_chunked_ref(a, x, h0, CHUNK, WARPS),
                  lru_scan(a, x, h0), dn)
        # B5b: the reverse launch from the carry h0, with da
        got = lru_scan_reverse(a, x, h0, h=hs, h_init=h0)
        for name, g, want, emul, again in zip(
                ("lambda", "da"), got,
                lru_scan_reverse_ref(a, x, h0, hs, h0),
                lru_scan_chunked_ref(a, x, h0, CHUNK, WARPS, reverse=True,
                                     h=hs, h_init=h0),
                lru_scan_reverse(a, x, h0, h=hs, h_init=h0)):
            held_scan(f"lru_scan_reverse {name}", g, want, emul, again, dn)
        n += 1
    return n


# the backward kernels against their plain versions: max |got - want|
# within GRAD_TOL of max |want| (the JAX package's kernel tolerances: its
# swa fp32 test's 2e-5, and 3e-2 in bf16, where each gradient is rounded
# to bf16 once)
GRAD_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# and in bf16 RMS(got - want) within GRAD_RMS_TOL of RMS(want), per
# gradient. The max rule alone passes a mask one key short at the training
# window. The tensor-core plan (P and dS rounded to bf16 once, gradients
# at the store) reads 2.2-2.4e-3 at every sweep shape, and a window one
# key short 7e-3 to 9e-3 at the training window of 2,048 keys, more at
# shorter windows (tests/test_torch_precision.py emulates both)
GRAD_RMS_TOL = {"bfloat16": 5e-3}


def grad_rms_ratio(got, want) -> float:
    """RMS(got - want) / RMS(want), in float64."""
    err = got.double() - want.double()
    return float(err.pow(2).mean().sqrt()
                 / want.double().pow(2).mean().sqrt().clamp_min(1e-300))


def close_grad(name: str, got, want, tol: float,
               rms_tol: Optional[float] = None) -> float:
    """Raise unless ``got`` is finite and within ``tol`` of max |want|
    and, given ``rms_tol``, within ``rms_tol`` of RMS(want) in RMS;
    returns the max absolute error."""
    import torch
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.abs().max())
    if not bool(torch.isfinite(got).all()) or not err <= tol * scale:
        raise AssertionError(f"{name} {tuple(got.shape)}: max abs err "
                             f"{err:.3e} exceeds {tol} x max |want| "
                             f"{scale:.3e}")
    if rms_tol is not None:
        ratio = grad_rms_ratio(got, want)
        if not ratio <= rms_tol:
            raise AssertionError(f"{name} {tuple(got.shape)}: RMS err over "
                                 f"RMS want {ratio:.3e} exceeds {rms_tol}")
    return err


def swa_excess(got, want) -> tuple[float, float]:
    """(max |got - want|, max of |got - want| over the swa main-shape
    limit) for a bf16 output ``got`` and its fp32 plain version."""
    import torch
    err = (got.float() - want).abs()
    atol = SWA_ATOL_RMS * float(want.pow(2).mean().sqrt())
    ratio = err / (atol + SWA_RTOL * want.abs())
    if not bool(torch.isfinite(got).all()):
        return math.inf, math.inf
    return float(err.max()), float(ratio.max())


def _randn_on_card(shape, seed):
    """Standard normal fp32 made on the card from ``seed``: a 40 GB host
    draw and copy would take minutes."""
    import torch
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    return torch.randn(shape, generator=g, device=DEVICE)


def blocked(fn, x, *args):
    """``fn`` (a linear plain version: gram_ref, normal_matvec_ref) over
    each REF_BLOCK_ROWS-row block of ``x``, the block results summed in
    float64. The same function as ``fn(x, *args)``, but no fp32
    accumulator runs over more than one block, so the reference's own
    rounding stays far below the tolerance at a million rows."""
    total = None
    for lo in range(0, x.shape[0], REF_BLOCK_ROWS):
        part = fn(x[lo:lo + REF_BLOCK_ROWS], *args).double()
        total = part if total is None else total.add_(part)
    return total


def check_main_shapes() -> dict:
    """Each kernel at the shape the main path gives it, fp32: agreement
    with the plain version, and the times of kernel, plain version, one
    library call (where one computes the same function) and the card's
    bound for the same work."""
    import torch
    from repro_torch.kernels.gram.ops import gram
    from repro_torch.kernels.gram.ref import gram_ref
    from repro_torch.kernels.normal_matvec.ops import normal_matvec
    from repro_torch.kernels.normal_matvec.ref import normal_matvec_ref
    from repro_torch.kernels.rf_map.ops import rf_map_apply
    from repro_torch.kernels.rf_map.ref import rf_map_ref, rf_weights
    out = {}

    # gram_svd's A: 1,048,576 x 8,096 (34 GB)
    n, d = SVD_ROWS, OCEAN_D
    a = _randn_on_card((n, d), 1)
    err = close("gram", gram(a), blocked(gram_ref, a), "float32")
    bound, by = bound_ms(4.0 * (n * d + d * d), n * d * (d + 1.0))
    out["gram"] = {"shape": [n, d], "max_abs_err": err,
                   "kernel_ms": cuda_time_ms(lambda: gram(a)),
                   "plain_ms": cuda_time_ms(lambda: gram_ref(a)),
                   "library_ms": cuda_time_ms(lambda: torch.mm(a.T, a)),
                   "bound_ms": bound, "bound_by": by}
    del a
    torch.cuda.empty_cache()

    # a CG iteration's Z: 1,048,576 x 10,000 (41.9 GB), w 10,000 x 147
    n, d, c = CG_ROWS, RF_DIM, TIMIT_C
    x = _randn_on_card((n, d), 2)
    w = _randn_on_card((d, c), 3)
    err = close("normal_matvec", normal_matvec(x, w),
                blocked(normal_matvec_ref, x, w), "float32")
    # 3xTF32: three TF32 products for each product on the tensor cores
    nbytes, flops = 4.0 * (n * d + 2 * d * c), 4.0 * n * d * c
    bound, by = bound_ms(nbytes, 3 * flops, TF32_FLOPS)
    out["normal_matvec"] = {
        "shape": [n, d, c], "max_abs_err": err,
        "bound_ms_fp32_cuda_cores": bound_ms(nbytes, flops)[0],
        "kernel_ms": cuda_time_ms(lambda: normal_matvec(x, w)),
        "plain_ms": cuda_time_ms(lambda: normal_matvec_ref(x, w)),
        "library_ms": cuda_time_ms(
            lambda: torch.linalg.multi_dot([x.T, x, w])),
        "bound_ms": bound, "bound_by": by}
    del x, w
    torch.cuda.empty_cache()

    # the CG expansion: X 1,048,576 x 440 -> Z 1,048,576 x 10,000. Z and
    # its plain version do not fit side by side: compare in row blocks
    n, d, dd = CG_ROWS, TIMIT_D, RF_DIM
    x = _randn_on_card((n, d), 4)
    wn, bn = rf_weights(TIMIT_D, RF_DIM, math.sqrt(TIMIT_D), 0)
    w, b = torch.from_numpy(wn).to(DEVICE), torch.from_numpy(bn).to(DEVICE)
    z = rf_map_apply(x, w, b)
    err = 0.0
    for lo in range(0, n, REF_BLOCK_ROWS):
        hi = lo + REF_BLOCK_ROWS
        err = max(err, close("rf_map", z[lo:hi], rf_map_ref(x[lo:hi], w, b),
                             "float32", absolute_atol=True))
    del z
    torch.cuda.empty_cache()
    # 3xTF32: three TF32 products for each product on the tensor cores
    nbytes, flops = 4.0 * (n * d + d * dd + dd + n * dd), 2.0 * n * d * dd
    bound, by = bound_ms(nbytes, 3 * flops, TF32_FLOPS)
    out["rf_map"] = {
        "shape": [n, d, dd], "max_abs_err": err,
        "bound_ms_fp32_cuda_cores": bound_ms(nbytes, flops)[0],
        "kernel_ms": cuda_time_ms(lambda: rf_map_apply(x, w, b)),
        "plain_ms": cuda_time_ms(lambda: rf_map_ref(x, w, b)),
        "library_ms": cuda_time_ms(lambda: torch.addmm(b, x, w)),
        "library_note": "torch.addmm(b, x, w): the product and bias only, "
                        "without cos and scale; any unfused route costs at "
                        "least this",
        "bound_ms": bound, "bound_by": by}
    del x, w, b
    torch.cuda.empty_cache()
    out.update(check_lm_main_shapes())
    for name, rec in out.items():
        emit({"phase": "kernel_main_shape", "kernel": name, **rec})
    emit({"phase": "kernel_checks", "passed": sorted(out)})
    return out


def check_lm_main_shapes() -> dict:
    """swa and lru_scan at the shapes a prefill wave of the served
    RecurrentGemma-9B gives them: q (4, 16, 4,096, 256) and k, v
    (4, 1, 4,096, 256) bf16 as (B, S, H, D) views, window 2,048 (held to
    the SWA_RTOL / SWA_ATOL_RMS limit); a and b (4, 4,096, 4,096) fp32,
    and (1, 16,384, 4,096) as one long prompt (held to the plain version,
    and to its emulation and a second launch bit for bit)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels.lru_scan.lru_scan import CHUNK, WARPS
    from repro_torch.kernels.lru_scan.ops import lru_scan
    from repro_torch.kernels.lru_scan.ref import lru_scan_chunked_ref, \
        lru_scan_ref
    from repro_torch.kernels.swa.ops import swa_attention
    from repro_torch.kernels.swa.ref import swa_ref
    from repro_torch.launch.forward_check import kernels_ms
    cfg = get_config(LM_ARCH)
    out = {}

    b, s, h, kh = LM_B, LM_S, cfg.num_heads, cfg.num_kv_heads
    d, win = cfg.resolved_head_dim, cfg.sliding_window
    q = _randn_on_card((b, s, h, d), 5).bfloat16().transpose(1, 2)
    k = _randn_on_card((b, s, kh, d), 6).bfloat16().transpose(1, 2)
    v = _randn_on_card((b, s, kh, d), 7).bfloat16().transpose(1, 2)
    qf, kf, vf = (t.float() for t in (q, k, v))
    want = swa_ref(qf, kf, vf, win)
    err, ratio = swa_excess(swa_attention(q, k, v, window=win), want)
    faults = {"window_minus_1": swa_excess(
                  swa_ref(qf, kf, vf, win - 1).bfloat16(), want)[1],
              "scale_x1.1": swa_excess(
                  swa_ref(qf * 1.1, kf, vf, win).bfloat16(), want)[1]}
    del qf, kf, vf, want
    if not ratio <= 1.0:
        raise AssertionError(f"swa bfloat16 {tuple(q.shape)}: max abs err "
                             f"{err:.3e}, {ratio:.3f} x the limit")
    if not all(r > 1.0 for r in faults.values()):
        raise AssertionError(f"swa's limit passes a planted fault: {faults}")
    pos = torch.arange(s, device=DEVICE)
    band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None]
                                              - win)
    kx, vx = (t.expand(b, h, s, d) for t in (k, v))
    visible = sum(min(i + 1, win) for i in range(s))
    nbytes = 2.0 * 2 * (b * h * s * d + b * kh * s * d)
    flops = 4.0 * b * h * d * visible
    bound, by = bound_ms(nbytes, flops, BF16_FLOPS)
    out["swa"] = {
        "shape": [b, h, kh, s, d, win], "dtype": "bfloat16",
        "max_abs_err": err, "err_over_limit": ratio,
        "planted_faults_over_limit": faults,
        "bound_ms_fp32_cuda_cores": bound_ms(nbytes, flops)[0],
        "kernel_ms": cuda_time_ms(lambda: swa_attention(q, k, v,
                                                        window=win),
                                  SWA_REPS),
        "device_ms": kernels_ms(lambda: swa_attention(q, k, v, window=win)),
        "plain_ms": cuda_time_ms(lambda: swa_ref(q, k, v, win)),
        "library_ms": cuda_time_ms(lambda: F.scaled_dot_product_attention(
            q, kx, vx, attn_mask=band), SWA_REPS),
        "bound_ms": bound, "bound_by": by}
    del q, k, v, kx, vx, band
    torch.cuda.empty_cache()

    w = cfg.lru_width
    a = torch.sigmoid(_randn_on_card((b, s, w), 8))
    x = 0.1 * _randn_on_card((b, s, w), 9)
    h0 = _randn_on_card((b, w), 10)
    err = held_scan("lru_scan", lru_scan(a, x, h0), lru_scan_ref(a, x, h0),
                    lru_scan_chunked_ref(a, x, h0, CHUNK, WARPS),
                    lru_scan(a, x, h0), "float32")
    bound, by = bound_ms(4.0 * (3 * b * s * w + b * w), 2.0 * b * s * w)
    o = torch.empty_like(a)
    out["lru_scan"] = {
        "shape": [b, s, w], "dtype": "float32", "max_abs_err": err,
        "kernel_ms": cuda_time_ms(lambda: lru_scan(a, x, h0), 20),
        "plain_ms": cuda_time_ms(lambda: lru_scan_ref(a, x, h0)),
        # what the card delivers for the same 12 bytes an element (read
        # two, write one), beside the data-sheet bound; not a library
        # counterpart of the scan
        "copy_ceiling_ms": cuda_time_ms(lambda: torch.add(a, x, out=o), 20),
        "library_ms": None, "bound_ms": bound, "bound_by": by}
    del a, x, h0, o
    torch.cuda.empty_cache()
    # one prompt of LM_LONG_S tokens: a chain of 64 chunks on 128 blocks
    # of channels, where walking time in one warp left 77 % of the bound
    # unused
    b, s = 1, LM_LONG_S
    a = torch.sigmoid(_randn_on_card((b, s, w), 11))
    x = 0.1 * _randn_on_card((b, s, w), 12)
    h0 = _randn_on_card((b, w), 13)
    err = held_scan("lru_scan", lru_scan(a, x, h0), lru_scan_ref(a, x, h0),
                    lru_scan_chunked_ref(a, x, h0, CHUNK, WARPS),
                    lru_scan(a, x, h0), "float32")
    o = torch.empty_like(a)
    out["lru_scan"]["long_prompt"] = {
        "shape": [b, s, w], "max_abs_err": err,
        "ms": cuda_time_ms(lambda: lru_scan(a, x, h0), 20),
        "bound_ms": bound_ms(4.0 * (3 * b * s * w + b * w),
                             2.0 * b * s * w)[0],
        "copy_ceiling_ms": cuda_time_ms(lambda: torch.add(a, x, out=o), 20)}
    del a, x, h0, o
    torch.cuda.empty_cache()
    out["swa"]["causal_shapes"] = check_causal_shapes()
    # the backward's records go to swa_bwd's entry (main)
    out["swa"]["prefix_shapes"], out["swa"]["prefix_backward"] = \
        check_prefix_shapes()
    return out


def check_causal_shapes() -> list:
    """swa with window = S, the route of the dense families' global
    layers, at CAUSAL_SHAPES: qwen3-4b's served 4 x 32 x 4,096 x 128 over
    8 kv heads, stablelm-1.6b's D = 64 over 32 kv heads and yi-34b's 56
    heads over 8 (a group of 7), bf16 (B, S, H, D) views. Each held to the
    SWA_RTOL / SWA_ATOL_RMS limit against the plain version on fp32
    copies (which must reject a softmax scale 10 % high), and timed beside
    the plain version, one causal ``scaled_dot_product_attention`` call
    (k, v repeated to the query heads beforehand) and the bound: 4 B H D
    S (S + 1) / 2 operations at the bf16 rate."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels.swa.ops import swa_attention
    from repro_torch.kernels.swa.ref import swa_ref
    from repro_torch.launch.forward_check import kernels_ms
    out = []
    for n, (arch, b, s) in enumerate(CAUSAL_SHAPES):
        t0 = time.perf_counter()
        cfg = get_config(arch)
        h, kh, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        q, k, v = (_randn_on_card((b, s, heads, d), 40 + 3 * n + i)
                   .bfloat16().transpose(1, 2)
                   for i, heads in enumerate((h, kh, kh)))
        qf, kf, vf = (t.float() for t in (q, k, v))
        want = swa_ref(qf, kf, vf, s)
        err, ratio = swa_excess(swa_attention(q, k, v, window=s), want)
        fault = swa_excess(swa_ref(qf * 1.1, kf, vf, s).bfloat16(), want)[1]
        del qf, kf, vf, want
        if not ratio <= 1.0:
            raise AssertionError(f"swa bfloat16 {tuple(q.shape)} window {s}:"
                                 f" max abs err {err:.3e}, {ratio:.3f} x "
                                 "the limit")
        if not fault > 1.0:
            raise AssertionError(f"swa's limit passes a scale 10 % high at "
                                 f"{arch}'s shape: {fault:.3f}")
        kx, vx = (t.repeat_interleave(h // kh, dim=1) for t in (k, v))
        nbytes = 2.0 * 2 * (b * h * s * d + b * kh * s * d)
        bound, by = bound_ms(nbytes, 4.0 * b * h * d * s * (s + 1) / 2,
                             BF16_FLOPS)
        out.append({
            "arch": arch, "shape": [b, h, kh, s, d, s], "dtype": "bfloat16",
            "max_abs_err": err, "err_over_limit": ratio,
            "scale_fault_over_limit": fault,
            "kernel_ms": cuda_time_ms(lambda: swa_attention(q, k, v,
                                                            window=s),
                                      SWA_REPS),
            "device_ms": kernels_ms(lambda: swa_attention(q, k, v,
                                                          window=s)),
            "plain_ms": cuda_time_ms(lambda: swa_ref(q, k, v, s)),
            "library_ms": cuda_time_ms(
                lambda: F.scaled_dot_product_attention(q, kx, vx,
                                                       is_causal=True),
                SWA_REPS),
            "bound_ms": bound, "bound_by": by,
            "seconds": time.perf_counter() - t0})
        del q, k, v, kx, vx
        torch.cuda.empty_cache()
    return out


def visible_pairs(s: int, prefix: int) -> int:
    """(query, key) pairs the prefix mask shows at window = S: the P x P
    prefix block, then each later query its causal keys."""
    return prefix * prefix + (s * (s + 1) - prefix * (prefix + 1)) // 2


def check_prefix_shapes() -> tuple[list, list]:
    """swa and swa_bwd with a bidirectional prefix at window = S, the
    routes of the prefix-LM and the encoder in serving and training, at
    PREFIX_SHAPES: PaliGemma's 4 x 8 x 768 x 256 over 1 kv head with
    prefix 256, and Whisper's encoder, 4 x 16 x 1,500 x 64 with prefix =
    S; bf16 (B, S, H, D) views. The forward is held to the SWA_RTOL /
    SWA_ATOL_RMS limit against the plain version on fp32 copies, the
    backward (from the forward's lse and fp32 output, as training runs
    it) to GRAD_TOL and GRAD_RMS_TOL against the plain backward on fp32
    copies; each limit must reject two planted faults, a prefix one key
    short and no prefix. Each is timed (the forward also as training
    runs it, with lse and its fp32 output) beside its plain version, one
    ``scaled_dot_product_attention`` call or its backward (the prefix mask
    as a bool mask, k and v repeated to the query heads; non-causal
    without a mask for the encoder) and the bound at the bf16 rate: 4 B H
    D (forward) or 10 B H D (backward: five products) times the visible
    pairs, P^2 + sum_{q=P}^{S-1} (q + 1). Returns (the forward's records,
    the backward's)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels.swa.ops import swa_attention, swa_backward, \
        swa_forward
    from repro_torch.kernels.swa.ref import swa_backward_ref, swa_ref
    from repro_torch.launch.forward_check import kernels_ms
    out, bwd = [], []
    for n, (arch, b, s, prefix) in enumerate(PREFIX_SHAPES):
        t0 = time.perf_counter()
        cfg = get_config(arch)
        if cfg.is_encdec:     # the encoder: every head its own kv head
            h = kh = cfg.num_heads
            d = cfg.encoder_d_model // cfg.num_heads
        else:
            h, kh, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        q, k, v = (_randn_on_card((b, s, heads, d), 60 + 3 * n + i)
                   .bfloat16().transpose(1, 2)
                   for i, heads in enumerate((h, kh, kh)))
        qf, kf, vf = (t.float() for t in (q, k, v))
        want = swa_ref(qf, kf, vf, s, prefix)
        err, ratio = swa_excess(swa_attention(q, k, v, window=s,
                                              prefix=prefix), want)
        faults = {f"prefix_{p}": swa_excess(
            swa_ref(qf, kf, vf, s, p).bfloat16(), want)[1]
            for p in (prefix - 1, 0)}
        del qf, kf, vf, want
        if not ratio <= 1.0:
            raise AssertionError(f"swa bfloat16 {tuple(q.shape)} prefix "
                                 f"{prefix}: max abs err {err:.3e}, "
                                 f"{ratio:.3f} x the limit")
        if not all(r > 1.0 for r in faults.values()):
            raise AssertionError(f"swa's limit passes a planted fault at "
                                 f"{arch}'s shape: {faults}")
        kx, vx = (t.repeat_interleave(h // kh, dim=1) for t in (k, v))
        pos = torch.arange(s, device=DEVICE)
        mask = (pos[None, :] <= pos[:, None]) | (
            (pos[None, :] < prefix) & (pos[:, None] < prefix))
        if prefix == s:
            def library():
                return F.scaled_dot_product_attention(q, kx, vx)
        else:
            def library():
                return F.scaled_dot_product_attention(q, kx, vx,
                                                      attn_mask=mask)
        nbytes = 2.0 * 2 * (b * h * s * d + b * kh * s * d)
        bound, by = bound_ms(nbytes, 4.0 * b * h * d
                             * visible_pairs(s, prefix), BF16_FLOPS)
        out.append({
            "arch": arch, "shape": [b, h, kh, s, d, s], "prefix": prefix,
            "dtype": "bfloat16", "max_abs_err": err,
            "err_over_limit": ratio, "planted_faults_over_limit": faults,
            "kernel_ms": cuda_time_ms(lambda: swa_attention(
                q, k, v, window=s, prefix=prefix), SWA_REPS),
            "device_ms": kernels_ms(lambda: swa_attention(
                q, k, v, window=s, prefix=prefix)),
            # training's forward: lse and the fp32 output written too
            "with_lse_ms": cuda_time_ms(lambda: swa_forward(
                q, k, v, s, with_lse=True, prefix=prefix), SWA_REPS),
            "plain_ms": cuda_time_ms(lambda: swa_ref(q, k, v, s, prefix)),
            "library_ms": cuda_time_ms(library, SWA_REPS),
            "library_note": "scaled_dot_product_attention, non-causal"
                            if prefix == s else
                            "scaled_dot_product_attention, the prefix mask "
                            "as a bool mask",
            "bound_ms": bound, "bound_by": by,
            "seconds": time.perf_counter() - t0})
        t0 = time.perf_counter()
        _, lse, o32 = swa_forward(q, k, v, s, with_lse=True, prefix=prefix)
        dout = _randn_on_card((b, s, h, d), 70 + n).bfloat16().transpose(1, 2)
        qf, kf, vf, gf = (t.float() for t in (q, k, v, dout))
        got = swa_backward(q, k, v, o32, lse, dout, window=s, prefix=prefix)
        want = swa_backward_ref(qf, kf, vf, o32, lse, gf, s, prefix)
        names = ("dq", "dk", "dv")
        errs = {nm: close_grad(f"swa_bwd {nm} {arch} prefix {prefix}", g, w,
                               GRAD_TOL["bfloat16"],
                               GRAD_RMS_TOL["bfloat16"])
                for nm, g, w in zip(names, got, want)}
        rms = {nm: grad_rms_ratio(g, w) for nm, g, w in zip(names, got, want)}
        del got
        faults = {f"prefix_{p}": max(
            grad_rms_ratio(g, w) for g, w in zip(swa_backward_ref(
                qf, kf, vf, o32, lse, gf, s, p), want))
            for p in (prefix - 1, 0)}
        del qf, kf, vf, gf, want
        if not all(r > GRAD_RMS_TOL["bfloat16"] for r in faults.values()):
            raise AssertionError(f"GRAD_RMS_TOL passes a planted prefix "
                                 f"fault at {arch}'s shape: {faults}")
        ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
        kxl, vxl = (t.repeat_interleave(h // kh, dim=1) for t in (kl, vl))
        lib_out = F.scaled_dot_product_attention(
            ql, kxl, vxl, attn_mask=None if prefix == s else mask)
        # read q, k, v, the fp32 o, dO and lse once; write dq, dk, dv
        nbytes = 2.0 * (3 * b * h * s * d + 2 * b * kh * s * d) \
            + 4.0 * (b * h * s * d + b * h * s)
        bound, by = bound_ms(nbytes, 10.0 * b * h * d
                             * visible_pairs(s, prefix), BF16_FLOPS)
        bwd.append({
            "arch": arch, "shape": [b, h, kh, s, d, s], "prefix": prefix,
            "dtype": "bfloat16", "max_abs_err": max(errs.values()),
            "rms_err_over_rms": rms, "planted_faults_rms": faults,
            "kernel_ms": cuda_time_ms(lambda: swa_backward(
                q, k, v, o32, lse, dout, window=s, prefix=prefix)),
            "plain_ms": cuda_time_ms(lambda: swa_backward_ref(
                q, k, v, o32, lse, dout, s, prefix)),
            "library_ms": cuda_time_ms(lambda: torch.autograd.grad(
                lib_out, (ql, kl, vl), dout, retain_graph=True)),
            "library_note": "the backward of scaled_dot_product_attention, "
                            + ("non-causal" if prefix == s else
                               "the prefix mask as a bool mask"),
            "bound_ms": bound, "bound_by": by,
            "seconds": time.perf_counter() - t0})
        del q, k, v, kx, vx, mask, dout, lse, o32, ql, kl, vl, kxl, vxl, \
            lib_out
        torch.cuda.empty_cache()
    return out, bwd


# ---------------------------------------------------------------------------
# phase 4: §4.1 CG with random features
# ---------------------------------------------------------------------------
def make_speech_like(n, d=440, classes=32, seed=0):
    """Synthetic classification data with class-dependent means (stands in
    for the TIMIT preprocessing pipeline output). The class means are a
    fixed property of the 'task' (seed-independent); `seed` only draws the
    samples, so train/test splits share the same classes."""
    means = np.random.RandomState(12345).randn(classes, d)
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, classes, n)
    x = means[labels] + 0.8 * rng.randn(n, d)
    y = np.eye(classes, dtype=np.float32)[labels]
    return x.astype(np.float32), y, labels


def small_cg_check(ac) -> tuple:
    """A CG solve on the card against numpy's direct solve: (max abs
    error, W)."""
    rng = np.random.RandomState(0)
    x = rng.randn(256, 24).astype(np.float32)
    y = rng.randn(256, 2).astype(np.float32)
    res = ac.call("skylark", "cg_solve", X=ac.send_matrix(x),
                  Y=ac.send_matrix(y), lam=1e-3, max_iters=300, tol=1e-10)
    w = ac.wrap(res["W"]).to_numpy()
    want = np.linalg.solve(x.T @ x + 256 * 1e-3 * np.eye(24), x.T @ y)
    err = float(np.abs(w - want).max())
    if not err <= 1e-4:
        raise AssertionError(f"small CG differs from np.linalg.solve: {err}")
    return err, w


def true_residual(x, y, w_cg, lam, bandwidth, seed, rows=65_536) -> float:
    """max over classes of ||Z^T y - (Z^T Z + n lam I) W|| / ||Z^T y||,
    recomputed with plain torch.matmul over row blocks of Z."""
    import torch
    from repro_torch.kernels.rf_map.ref import rf_map_ref, rf_weights
    wn, bn = rf_weights(x.shape[1], RF_DIM, bandwidth, seed)
    wr, br = torch.from_numpy(wn).to(DEVICE), torch.from_numpy(bn).to(DEVICE)
    w = torch.from_numpy(w_cg).to(DEVICE)
    n = x.shape[0]
    rhs = torch.zeros_like(w)
    zzw = torch.zeros_like(w)
    for lo in range(0, n, rows):
        xb = torch.from_numpy(x[lo:lo + rows]).to(DEVICE)
        yb = torch.from_numpy(y[lo:lo + rows]).to(DEVICE)
        z = rf_map_ref(xb, wr, br)
        rhs += z.T @ yb
        zzw += z.T @ (z @ w)
    r = rhs - (zzw + float(np.float32(n * lam)) * w)
    return float((torch.linalg.norm(r, dim=0)
                  / torch.linalg.norm(rhs, dim=0)).max())


# CG's 20th residual against the last bits of Z: the same solve on the
# plain version's Z, scaled elementwise by 1 + CG_PERTURB N(0, 1) (about
# one ulp of fp32) under these seeds
CG_PERTURB = 1e-7
CG_PERTURB_SEEDS = (1, 2, 3)


def cg_rounding_spread(x, y, lam, bandwidth) -> dict:
    """The 20-iteration relative residual of the torch backend's CG
    (rf_dim = 0, tol = 0) on the plain version's Z, and on that Z with its
    last bits perturbed under CG_PERTURB_SEEDS. CG on this ill-conditioned
    system follows its rounding: the spread is how far a kernel whose Z
    differs from the plain version's in the last bits can move the
    residual, whatever its accuracy."""
    import torch
    from repro_torch.core.backends.torch_backend import _cg_solve
    from repro_torch.kernels.rf_map.ref import rf_map_ref, rf_weights
    wn, bn = rf_weights(x.shape[1], RF_DIM, bandwidth, 0)
    w, b = torch.from_numpy(wn).to(DEVICE), torch.from_numpy(bn).to(DEVICE)
    xd, yd = torch.from_numpy(x).to(DEVICE), torch.from_numpy(y).to(DEVICE)
    out = {"plain_z": None, "perturbed_z": []}
    for seed in (None, *CG_PERTURB_SEEDS):
        z = rf_map_ref(xd, w, b)
        if seed is not None:
            g = torch.Generator(device=DEVICE).manual_seed(seed)
            for lo in range(0, z.shape[0], REF_BLOCK_ROWS):
                # no named view of z: one would keep its 42 GB alive
                rows = min(REF_BLOCK_ROWS, z.shape[0] - lo)
                z[lo:lo + rows].mul_(1 + CG_PERTURB * torch.randn(
                    (rows, z.shape[1]), generator=g, device=DEVICE))
        res = _cg_solve(z, yd, lam=lam, max_iters=CG_ITERS,
                        tol=0.0)["relative_residual"]
        del z
        if seed is None:
            out["plain_z"] = res
        else:
            out["perturbed_z"].append(res)
    return out


def phase_cg(ac, counters) -> tuple:
    """Returns (the launch counts of the solve, what the socket phase
    repeats: x, y, W and the upload rate)."""
    from repro_torch.core.libraries import skylark
    ac.register_library("skylark", skylark)
    small_err, _ = small_cg_check(ac)

    t0 = time.perf_counter()
    x, y, _ = make_speech_like(CG_ROWS, d=TIMIT_D, classes=TIMIT_C)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    al_x = ac.send_matrix(x, dedup=False)
    al_y = ac.send_matrix(y, dedup=False)
    upload_s = time.perf_counter() - t0
    lam, bandwidth = 1e-5, math.sqrt(TIMIT_D)
    sky = ac.library("skylark")

    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    W = sky.cg_solve(X=al_x, Y=al_y, lam=lam, rf_dim=RF_DIM,
                     bandwidth=bandwidth, max_iters=CG_ITERS, tol=0.0)
    stats = W.stats()
    solve_s = time.perf_counter() - t0
    launches = {k: c.value for k, c in counters.items()}
    if launches["rf_map"] < 1 or launches["normal_matvec"] < CG_ITERS:
        raise AssertionError(f"CG did not run through the kernels: "
                             f"{launches}")
    if stats["iterations"] != CG_ITERS:
        raise AssertionError(f"CG ran {stats['iterations']} iterations")

    t0 = time.perf_counter()
    w = W.to_numpy()
    fetch_s = time.perf_counter() - t0
    if w.shape != (RF_DIM, TIMIT_C) or not np.isfinite(w).all():
        raise AssertionError(f"CG returned W {w.shape}, finite="
                             f"{bool(np.isfinite(w).all())}")

    # the expansion and b = Z^T y without iterations: the difference is
    # what the 20 iterations took
    base = sky.cg_solve(X=al_x, Y=al_y, lam=lam, rf_dim=RF_DIM,
                        bandwidth=bandwidth, max_iters=0, tol=0.0)
    base_stats = base.stats()
    per_iter_ms = (stats["_elapsed"] - base_stats["_elapsed"]) / CG_ITERS \
        * 1e3

    reported = stats["relative_residual"]
    recomputed = true_residual(x, y, w, lam, bandwidth, 0)
    # fp32 CG's recursive residual drifts from the true one; allow a tenth
    if not abs(recomputed - reported) <= 0.1 * reported + 1e-4:
        raise AssertionError(f"reported relative residual {reported} vs "
                             f"recomputed {recomputed}")
    for h in (al_x, al_y, W, base):
        h.free()
    spread = cg_rounding_spread(x, y, lam, bandwidth)
    rec = {"phase": "cg", "rows": CG_ROWS, "d": TIMIT_D, "rf_dim": RF_DIM,
           "classes": TIMIT_C, "iterations": CG_ITERS,
           "small_cg_max_err": small_err, "generate_s": gen_s,
           "upload_s": upload_s, "solve_s": solve_s,
           "engine_solve_s": stats["_elapsed"],
           "expand_and_rhs_s": base_stats["_elapsed"],
           "per_iteration_ms": per_iter_ms, "fetch_w_s": fetch_s,
           "relative_residual": reported,
           "recomputed_relative_residual": recomputed,
           "relative_residual_plain_z": spread["plain_z"],
           "relative_residual_perturbed_plain_z": spread["perturbed_z"],
           "residual_history": stats["residual_history"],
           "launches": launches}
    emit(rec)
    return launches, {"x": x, "y": y, "w": w,
                      "upload_gb_per_s": (x.nbytes + y.nbytes) / upload_s
                      / 1e9}


# ---------------------------------------------------------------------------
# phase 5: §4.2 truncated SVD and Gram SVD
# ---------------------------------------------------------------------------
OCEAN_MODES = 24
OCEAN_PART_ROWS = 16_384


def ocean_like(n, d, seed=0):
    """A lazily generated ocean-like field after benchmarks/table5_svd.py:
    seasonal harmonics with decaying amplitudes times random spatial
    patterns, plus small noise; each partition is made from (seed,
    partition index) when the upload pulls it, never the whole matrix at
    once. 24 modes keep the top-20 spectrum well separated. Returns the
    RowMatrix and a dict whose "seconds" sums the host time spent
    generating partitions, so an upload can tell generation from the
    bridge."""
    from repro_torch.frontend.rdd import RDD
    from repro_torch.frontend.rowmatrix import RowMatrix
    spatial = np.random.default_rng(seed).standard_normal(
        (OCEAN_MODES, d)).astype(np.float32)
    amp = (1.0 / (1.0 + 0.5 * np.arange(OCEAN_MODES))).astype(np.float32)
    periods = (67 * 30.0) / (np.arange(OCEAN_MODES) + 1.0)
    parts = -(-n // OCEAN_PART_ROWS)
    bounds = [min(n, i * OCEAN_PART_ROWS) for i in range(parts + 1)]

    spent = {"seconds": 0.0}

    def compute(i):
        t0 = time.perf_counter()
        lo, hi = bounds[i], bounds[i + 1]
        t = np.linspace(0, 67 * 30, n)[lo:hi, None]
        modes = (np.sin(2 * np.pi * t / periods) * amp).astype(np.float32)
        rng = np.random.default_rng(seed + 7919 * (i + 1))
        noise = rng.standard_normal((hi - lo, d), dtype=np.float32)
        noise *= np.float32(0.05)
        noise += modes @ spatial
        spent["seconds"] += time.perf_counter() - t0
        return noise

    rdd = RDD.from_generator(parts, compute, name="ocean")
    return RowMatrix(rdd, n, d, bounds, dtype=np.float32), spent


def small_svd_check(ac) -> float:
    """Both SVDs on the card against numpy's SVD of a small matrix."""
    rng = np.random.RandomState(0)
    a = rng.randn(300, 40).astype(np.float32)
    want = np.linalg.svd(a.astype(np.float64), compute_uv=False)[:5]
    al = ac.send_matrix(a)
    worst = 0.0
    for routine in ("truncated_svd", "gram_svd"):
        res = ac.call("elemental", routine, A=al, k=5)
        s = ac.wrap(res["S"]).to_numpy().ravel()
        rel = float(np.abs(s - want).max() / want.max())
        if not rel <= 1e-4:
            raise AssertionError(f"small {routine}: sigma rel err {rel}")
        worst = max(worst, rel)
    return worst


def phase_svd(ac, counters) -> dict:
    from repro_torch.core.libraries import elemental
    ac.register_library("elemental", elemental)
    small_err = small_svd_check(ac)
    el = ac.library("elemental")

    field, generation = ocean_like(SVD_ROWS, OCEAN_D)
    t0 = time.perf_counter()
    al_a = ac.send_matrix(field, dedup=False, chunk_rows=128)
    upload_s = time.perf_counter() - t0
    generate_s = generation["seconds"]

    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    U1, S1, V1 = el.truncated_svd(A=al_a, k=SVD_K)
    s1 = S1.to_numpy().ravel()
    trunc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    U2, S2, V2 = el.gram_svd(A=al_a, k=SVD_K)
    s2 = S2.to_numpy().ravel()
    gram_s = time.perf_counter() - t0
    launches = {k: c.value for k, c in counters.items()}
    if launches["gram"] < 1:
        raise AssertionError(f"gram_svd did not run through the gram "
                             f"kernel: {launches}")
    np.testing.assert_allclose(s1, s2, rtol=1e-3)

    t0 = time.perf_counter()
    factors = {"U_trunc": U1.to_numpy(), "V_trunc": V1.to_numpy(),
               "U_gram": U2.to_numpy(), "V_gram": V2.to_numpy()}
    fetch_s = time.perf_counter() - t0
    for name, f in factors.items():
        rows = SVD_ROWS if name.startswith("U") else OCEAN_D
        if f.shape != (rows, SVD_K) or not np.isfinite(f).all():
            raise AssertionError(f"{name} {f.shape} finite="
                                 f"{bool(np.isfinite(f).all())}")
    rec = {"phase": "svd", "rows": SVD_ROWS, "d": OCEAN_D, "k": SVD_K,
           "small_svd_max_rel_err": small_err, "upload_s": upload_s,
           "upload_generate_s": generate_s,
           "upload_bridge_s": upload_s - generate_s,
           "truncated_svd_s": trunc_s,
           "truncated_svd_engine_s": S1.stats()["_elapsed"],
           "lanczos_iters": S1.stats()["lanczos_iters"],
           "gram_svd_s": gram_s, "gram_svd_engine_s": S2.stats()["_elapsed"],
           "fetch_factors_s": fetch_s,
           "sigma_truncated": s1.tolist(), "sigma_gram": s2.tolist(),
           "sigma_max_rel_diff": float(np.max(np.abs(s1 - s2) / s2)),
           "launches": launches}
    emit(rec)
    return launches


# ---------------------------------------------------------------------------
# phase 5b: chain fusion — a burst-submitted chain runs as one task and
# replays from one CUDA graph
# ---------------------------------------------------------------------------
# the ocean field at the §4.2 width, cut from 1,048,576 rows to 65,536
# (2.1 GB fp32 each) so that the phase takes seconds, not minutes
FUSED_ROWS = 65_536
# benchmarks/backend_fusion.py's chain: 16 multiplies at 512 x 512, where
# launch overhead, not arithmetic, sets the time
FUSED_STAGES, FUSED_SMALL = 16, 512
FUSED_REPS = 5
# rows of G held against a float64 Gram
FUSED_REF_ROWS = 512


def _burst_gram_chain(engine, ac, al) -> tuple:
    """G = gram(A), Gt = G^T, S = G + Gt, P = S S submitted in one burst
    with the scheduler paused. Returns the wall seconds to P, the four
    outputs on the card and the task log's change."""
    el = ac.library("elemental")
    before = engine.task_log.stats()
    t0 = time.perf_counter()
    engine.scheduler.pause()
    g = el.gram(A=al)
    gt = el.transpose(A=g)
    s = el.add(A=g, B=gt)
    p = el.multiply(A=s, B=s)
    engine.scheduler.resume()
    p.result()
    seconds = time.perf_counter() - t0
    after = engine.task_log.stats()
    outs = [engine._resolve(x.handle, session=ac.session)[0]
            for x in (g, gt, s, p)]
    delta = {k: after[k] - before[k]
             for k in ("dispatched", "fused_tasks", "fused_ops")}
    # the engine's seconds of the four steps (a fused task splits its
    # program's seconds over them)
    delta["engine_s"] = sum(x.stats()["_elapsed"] for x in (g, gt, s, p))
    return seconds, outs, delta


def _burst_multiply_chain(engine, ac, al) -> tuple:
    el = ac.library("elemental")
    before = engine.task_log.stats()
    t0 = time.perf_counter()
    engine.scheduler.pause()
    xs = [al]
    for _ in range(FUSED_STAGES):
        xs.append(el.multiply(A=xs[-1], B=al))
    engine.scheduler.resume()
    xs[-1].result()
    seconds = time.perf_counter() - t0
    after = engine.task_log.stats()
    out = engine._resolve(xs[-1].handle, session=ac.session)[0]
    delta = {k: after[k] - before[k]
             for k in ("dispatched", "fused_tasks", "fused_ops")}
    delta["engine_s"] = sum(x.stats()["_elapsed"] for x in xs[1:])
    return seconds, out, delta


def _one_task(delta, ops, what):
    got = {k: delta[k] for k in ("dispatched", "fused_tasks", "fused_ops")}
    if got != {"dispatched": 1, "fused_tasks": 1, "fused_ops": ops}:
        raise AssertionError(f"{what}: not one fused task of {ops} ops: "
                             f"{delta}")


def _median_s(fn, reps=FUSED_REPS) -> float:
    return float(np.median([fn() for _ in range(reps)]))


def phase_fused(counters) -> tuple:
    """A burst chain as one task, replayed from a CUDA graph: three runs of
    the gram chain (capture; replay after the input's contents were
    replaced at the same address; a second resident matrix, a second
    capture), each held against the same chain unfused, then the
    16-stage multiply chain. Returns the launch counts of the engine's
    runs and what phase_warmup compares with: the second field on the
    host and the gram chain's median replay seconds."""
    import torch
    from repro_torch.core import AlchemistContext, AlchemistEngine
    from repro_torch.core.libraries import elemental
    from repro_torch.kernels.gram import ops as gram_ops

    # no run may be served from the result cache. Unbucketed, so that the
    # chains run at their exact shapes as they did before the engine had
    # a program cache: the 65,536 x 8,096 inputs are large slots, read in
    # place, one capture per input address (phase_warmup runs the same
    # chain bucketed)
    engine = AlchemistEngine(device=DEVICE, cache_entries=0,
                             bucketing=False)
    engine.load_library("elemental", elemental)
    ac = AlchemistContext(engine=engine)
    backend = engine.backends["torch"]
    fields = []
    t0 = time.perf_counter()
    for seed in (1, 2):
        field, _ = ocean_like(FUSED_ROWS, OCEAN_D, seed=seed)
        fields.append(ac.send_matrix(field, dedup=False))
    second_field = field
    upload_s = time.perf_counter() - t0
    a1, a2 = (engine._resolve(al.handle, session=ac.session)[0]
              for al in fields)

    for c in counters.values():
        c.reset()
    gram_runs = []

    def counted(run, what):
        before = counters["gram"].value
        got = run()
        if counters["gram"].value - before != 1:
            raise AssertionError(f"{what}: gram launched "
                                 f"{counters['gram'].value - before} times")
        return got

    # 1: capture (the eager warm-up answers this call)
    s1, run1, d1 = counted(
        lambda: _burst_gram_chain(engine, ac, fields[0]), "capture")
    _one_task(d1, 4, "capture")
    kept1 = [t.clone() for t in run1]
    # 2: replay after new contents at the same address. engine.overwrite
    # is copy-on-write (a new tensor, a new address), so the resident
    # tensor is written in place
    ptr = a1.data_ptr()
    a1.copy_(a2)
    if engine._resolve(fields[0].handle, session=ac.session)[0] \
            .data_ptr() != ptr:
        raise AssertionError("the resident matrix moved")
    s2, run2, d2 = counted(
        lambda: _burst_gram_chain(engine, ac, fields[0]), "replay")
    _one_task(d2, 4, "replay")
    intact = all(bool(torch.equal(a, b)) for a, b in zip(run1, kept1))
    if not intact:
        raise AssertionError("a replay overwrote an earlier run's outputs")
    # the chain's program (signature-keyed, no graph of its own) and the
    # one capture for this input's address
    if backend.graphs() != 1 or \
            backend.program_cache_info()["programs"] != 2:
        raise AssertionError(f"replay captured anew: {backend.graphs()} "
                             f"graphs, {backend.program_cache_info()}")
    # 3: the second resident matrix, a second capture
    s3, run3, d3 = counted(
        lambda: _burst_gram_chain(engine, ac, fields[1]), "second capture")
    _one_task(d3, 4, "second capture")
    if backend.graphs() != 2 or backend.capture_failures:
        raise AssertionError(f"graphs {backend.graphs()}, capture "
                             f"failures {backend.capture_failures}")

    # the same chain unfused, on the same engine
    ac.configure(fusion=False)
    su, unfused, du = counted(
        lambda: _burst_gram_chain(engine, ac, fields[1]), "unfused")
    if {k: du[k] for k in ("dispatched", "fused_tasks", "fused_ops")} != \
            {"dispatched": 4, "fused_tasks": 0, "fused_ops": 0}:
        raise AssertionError(f"unfused chain: {du}")
    ac.configure(fusion=True)
    names = ("G", "Gt", "S", "P")
    max_err, bits = {}, {}
    for run, outs in (("replay", run2), ("second_capture", run3)):
        for name, got, want in zip(names, outs, unfused):
            err = close("gram", got, want, "float32")
            max_err[f"{run}_{name}"] = err
            bits[f"{run}_{name}"] = bool(torch.equal(got, want))
    # G against a float64 Gram of its first rows
    lead = run3[0][:FUSED_REF_ROWS]
    want = None
    for lo in range(0, FUSED_ROWS, 8_192):
        blk = a2[lo:lo + 8_192].double()
        part = blk[:, :FUSED_REF_ROWS].T @ blk
        want = part if want is None else want.add_(part)
    g64_err = close("gram", lead, want.float(), "float32")
    launches = {k: c.value for k, c in counters.items()}

    # eager: the plain calls on the card, no engine
    def eager_gram_chain():
        torch.cuda.synchronize()
        t = time.perf_counter()
        g = gram_ops.gram(a2)
        s = g + g.T
        s @ s
        torch.cuda.synchronize()
        return time.perf_counter() - t
    eager_s = _median_s(eager_gram_chain, 3)
    replays = [_burst_gram_chain(engine, ac, fields[1]) for _ in range(3)]
    replay_s = float(np.median([r[0] for r in replays]))
    replay_engine_s = float(np.median([r[2]["engine_s"] for r in replays]))
    del replays
    for al in fields:
        al.free()
    del a1, a2, run1, run2, run3, kept1, unfused, lead, want
    gc.collect()

    # the 16-stage multiply chain
    g = torch.Generator().manual_seed(4)
    q = torch.linalg.qr(torch.randn(FUSED_SMALL, FUSED_SMALL,
                                    dtype=torch.float64, generator=g))[0]
    small = ac.send_matrix(q.float().numpy(), dedup=False)
    sc, out_c, dc = _burst_multiply_chain(engine, ac, small)
    _one_task(dc, FUSED_STAGES, "multiply chain capture")
    chain_replays, chain_replay_engine = [], []
    for _ in range(FUSED_REPS):
        sr, out_r, dr = _burst_multiply_chain(engine, ac, small)
        _one_task(dr, FUSED_STAGES, "multiply chain replay")
        chain_replays.append(sr)
        chain_replay_engine.append(dr["engine_s"])
    ac.configure(fusion=False)
    chain_unfused, chain_unfused_engine = [], []
    for _ in range(3):
        sx, out_u, dx = _burst_multiply_chain(engine, ac, small)
        chain_unfused.append(sx)
        chain_unfused_engine.append(dx["engine_s"])
    ac.configure(fusion=True)
    small_err = close("gram", out_r, out_u, "float32")
    small_bits = bool(torch.equal(out_r, out_u))
    a_small = engine._resolve(small.handle, session=ac.session)[0]

    def eager_multiply_chain():
        torch.cuda.synchronize()
        t = time.perf_counter()
        x = a_small
        for _ in range(FUSED_STAGES):
            x = x @ a_small
        torch.cuda.synchronize()
        return time.perf_counter() - t
    chain_eager_s = _median_s(eager_multiply_chain)
    # the multiply chain's program alone, from this (warm) thread: its
    # replay and output copies on the host's clock, its graph on the
    # device's
    program = next(reversed(backend._programs.values()))

    # (its input is a small slot: a static buffer it copies into first)
    program_inputs = {slot: a_small for slot in program.buffers}

    def replay_alone():
        torch.cuda.current_stream().synchronize()
        t = time.perf_counter()
        program.replay(program_inputs)
        torch.cuda.current_stream().synchronize()
        return time.perf_counter() - t
    chain_replay_alone_s = _median_s(replay_alone)
    chain_graph_ms = cuda_time_ms(program.graph.replay, reps=FUSED_REPS)
    del program, program_inputs
    # two gram-chain captures, the gram chain's program, the multiply
    # chain's captured program
    if backend.graphs() != 3 or \
            backend.program_cache_info()["programs"] != 4 or \
            backend.capture_failures:
        raise AssertionError(f"{backend.graphs()} graphs, "
                             f"{backend.program_cache_info()}, capture "
                             f"failures {backend.capture_failures}")

    # device memory the live programs hold: their graphs' pools
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    alloc, reserved = torch.cuda.memory_allocated(), \
        torch.cuda.memory_reserved()
    held_counted = backend.held_bytes()
    backend.release()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held_alloc = alloc - torch.cuda.memory_allocated()
    held_reserved = reserved - torch.cuda.memory_reserved()
    ac.stop()
    engine.shutdown()
    emit({"phase": "fused", "rows": FUSED_ROWS, "d": OCEAN_D,
          "cut": "ocean field 1,048,576 -> 65,536 rows, two resident "
                 "matrices", "upload_s": upload_s,
          "gram_chain": {
              "ops": 4, "capture_run_s": s1, "replay_run_s": s2,
              "second_capture_run_s": s3,
              "fused_replay_median_s": replay_s,
              "fused_replay_engine_median_s": replay_engine_s,
              "capture_run_engine_s": d1["engine_s"],
              "unfused_s": su, "unfused_engine_s": du["engine_s"],
              "eager_s": eager_s, "tasks_per_run": 1,
              "earlier_outputs_intact": intact,
              "max_abs_err_vs_unfused": max_err,
              "bits_match_unfused": bits,
              "g_rows_vs_float64_max_abs_err": g64_err},
          "multiply_chain": {
              "stages": FUSED_STAGES, "n": FUSED_SMALL,
              "capture_run_s": sc,
              "fused_replay_median_s": float(np.median(chain_replays)),
              "fused_replay_engine_median_s":
                  float(np.median(chain_replay_engine)),
              "unfused_median_s": float(np.median(chain_unfused)),
              "unfused_engine_median_s":
                  float(np.median(chain_unfused_engine)),
              "eager_median_s": chain_eager_s,
              "replay_and_copies_alone_median_s": chain_replay_alone_s,
              "graph_replay_device_ms": chain_graph_ms,
              "max_abs_err_vs_unfused": small_err,
              "bits_match_unfused": small_bits},
          "programs": 4, "graphs": 3,
          "capture_failures": backend.capture_failures,
          "capture_s": backend.capture_seconds,
          "held_by_programs_allocated_bytes": held_alloc,
          "held_by_programs_reserved_bytes": held_reserved,
          "held_bytes_counted": held_counted,
          "launches": launches})
    return launches, {"field": second_field, "replay_s": replay_s}


# ---------------------------------------------------------------------------
# phase 5c: the compile cache — warmup, cold against warm first calls, the
# warm restart across two server processes, bucketing at the ocean width
# ---------------------------------------------------------------------------
# an odd-shaped tenant mix at widths of the paper's workloads: a block of
# 3,000 TIMIT rows (440 features) times a 440 x 147 weight, the Gram of
# 60,000 x 4,000, a transpose and an add off the bucket grid, and
# benchmarks/compile_warmup.py's 3-stage multiply chain at 19 x 19
WARM_MIX = [
    ("multiply", {"A": (3_000, TIMIT_D), "B": (TIMIT_D, TIMIT_C)}),
    ("gram", {"A": (60_000, 4_000)}),
    ("transpose", {"A": (1_000, 300)}),
    ("add", {"A": (700, 500), "B": (700, 500)}),
]
WARM_CHAIN_N, WARM_CHAIN_STAGES = 19, 3
# the warmup grid: under the default bucket grid the mix's single ops land
# in multiply (4,096 x 512) @ (512 x 256) and transpose and add at 1,024 x
# 512, all inside it; the gram's 60,000 rows lie beyond the bucket grid
# and pass unpadded, so it is warmed, with the chain, from the executable
# index the cold engine wrote
WARM_GRID = (256, 512, 1024, 4096)
# tests/test_compilecache.py's tolerances (1e-4 for a bucketed op against
# the reference, 1e-3 for the 3-stage chain), here against float64 and
# with atol relative to the result's largest entry
WARM_RTOL = {"single": 1e-4, "chain3": 1e-3}


def _warm_mix_data(seed: int = 31) -> tuple:
    rng = np.random.default_rng(seed)
    arrays = {(routine, name): rng.standard_normal(shape, dtype=np.float32)
              for routine, shapes in WARM_MIX
              for name, shape in shapes.items()}
    chain = rng.standard_normal((WARM_CHAIN_N, WARM_CHAIN_N),
                                dtype=np.float32) / np.float32(4.0)
    return arrays, chain


def _warm_mix_want(arrays, chain) -> dict:
    """The mix's results in float64, on the card."""
    import torch

    def on_card(a):
        return torch.from_numpy(a).to(DEVICE, torch.float64)
    a = {k: on_card(v) for k, v in arrays.items()}
    x = c = on_card(chain)
    for _ in range(WARM_CHAIN_STAGES):
        x = x @ c
    g = a[("gram", "A")]
    return {"multiply": a[("multiply", "A")] @ a[("multiply", "B")],
            "gram": g.T @ g, "transpose": a[("transpose", "A")].T,
            "add": a[("add", "A")] + a[("add", "B")], "chain3": x}


def _send_mix(ac, arrays, chain) -> dict:
    handles = {routine: {name: ac.send_matrix(arrays[(routine, name)],
                                              dedup=False)
                         for name in shapes}
               for routine, shapes in WARM_MIX}
    handles["chain3"] = ac.send_matrix(chain, dedup=False)
    return handles


# Over TCP a client cannot pause the engine's scheduler, and a worker that
# picks up a chain's head at once runs it alone. There the chain's head
# waits on a CG solve of WARM_CG_ITERS host-synchronised iterations (not
# fusible) while its three multiplies arrive, so the engine claims them as
# one chain in both server processes; its input is then W (19 x 19).
WARM_CG_ROWS, WARM_CG_ITERS = 4_096, 200


def _mix_once(ac, handles, over_tcp: bool = False) -> tuple:
    """Each mix item once, timed on the host clock to its fetched result;
    returns (seconds, results) by item, and W when ``over_tcp``."""
    seconds, outs = {}, {}
    for routine, _ in WARM_MIX:
        t0 = time.perf_counter()
        res = ac.call("elemental", routine, **handles[routine])
        [out] = [v for v in res.values() if hasattr(v, "shape")]
        outs[routine] = ac.wrap(out).to_numpy()
        seconds[routine] = time.perf_counter() - t0
    el = ac.library("elemental")
    al = handles["chain3"]
    t0 = time.perf_counter()
    if over_tcp:
        x = w = ac.library("skylark").cg_solve(
            X=handles["cg"][0], Y=handles["cg"][1], lam=1e-3,
            max_iters=WARM_CG_ITERS, tol=0.0)
    else:
        ac.engine.scheduler.pause()
        x = al
    for _ in range(WARM_CHAIN_STAGES):
        x = el.multiply(A=x, B=al)
    if not over_tcp:
        ac.engine.scheduler.resume()
    outs["chain3"] = x.to_numpy()
    seconds["chain3"] = time.perf_counter() - t0
    return seconds, outs, (w.to_numpy() if over_tcp else None)


def _check_mix(outs, want, what) -> dict:
    """Raise unless every result is within its tolerance of float64;
    returns the max abs errors."""
    import torch
    errs = {}
    for k, w in want.items():
        got = torch.from_numpy(outs[k]).to(DEVICE, torch.float64)
        tol = WARM_RTOL["chain3" if k == "chain3" else "single"]
        err = (got - w).abs()
        limit = tol * float(w.abs().max()) + tol * w.abs()
        if tuple(got.shape) != tuple(w.shape) or \
                not bool(torch.isfinite(got).all()) or \
                bool((err > limit).any()):
            raise AssertionError(f"{what} {k}: {tuple(got.shape)}, max abs "
                                 f"err {float(err.max()):.3e} over rtol "
                                 f"{tol}")
        errs[k] = float(err.max())
    return errs


def _warm_server_run(cache_dir, arrays, chain, want, run) -> dict:
    """One server process with --warmup on ``cache_dir``: the mix over
    TCP, its compile accounting read over the wire, then SIGINT."""
    import re
    import torch
    from repro_torch.core import AlchemistContext
    from repro_torch.core.libraries import elemental, skylark
    rng = np.random.default_rng(37)
    cg = [rng.standard_normal((WARM_CG_ROWS, WARM_CHAIN_N),
                              dtype=np.float32) for _ in range(2)]
    proc, address, seen, start_s = _start_server(
        "--warmup", "--compile-cache-dir", cache_dir)
    try:
        warm_line = next(ln for ln in seen if ln.startswith("warmup:"))
        replayed = int(re.search(r"(\d+) replayed", warm_line).group(1))
        with AlchemistContext(address=address) as ac:
            ac.register_library("elemental", elemental)
            ac.register_library("skylark", skylark)
            handles = _send_mix(ac, arrays, chain)
            handles["cg"] = [ac.send_matrix(a, dedup=False) for a in cg]
            first, outs, w = _mix_once(ac, handles, over_tcp=True)
            stats = ac.call("_engine", "compile_stats")["engine"]
            later, _, _ = _mix_once(ac, handles, over_tcp=True)
    finally:
        rc = _stop_server(proc)
    x = torch.from_numpy(w).to(DEVICE, torch.float64)
    c64 = torch.from_numpy(chain).to(DEVICE, torch.float64)
    for _ in range(WARM_CHAIN_STAGES):
        x = x @ c64
    errs = _check_mix(outs, {**want, "chain3": x},
                      f"server process {run}")
    if rc != 0:
        raise AssertionError(f"server process {run} exited with {rc}")
    return {"start_s": start_s, "warmup_line": warm_line,
            "replayed": replayed, "first_call_s": first,
            "first_call_total_s": sum(first.values()),
            "later_call_s": later,
            "request_compiles": stats["request_compiles"],
            "bucketed_request_compiles":
                stats["bucketed_request_compiles"],
            "executable_index": stats["executable_index"],
            "max_abs_err_vs_float64": errs}


def phase_warmup(counters, fused) -> dict:
    """The compile cache on the card. (b) a cold engine serves an
    odd-shaped mix (first call and a later call of each item), writing the
    executable index in a temporary compile cache dir; (a) a fresh engine
    on that dir warms up at WARM_GRID (the index, then the catalog) and
    (b) serves the same mix with no request-path compile and no new
    capture; (c) the warm restart through the deployed form, two server
    processes on one dir; (d) phase_fused's gram chain on the 65,536 x
    8,096 field with bucketing on: padded to 8,192 columns, a large slot.
    Returns the launch counts of the phase."""
    import shutil
    import tempfile
    import torch
    from repro_torch.core import AlchemistContext, AlchemistEngine
    from repro_torch.core.libraries import elemental
    t_phase = time.perf_counter()
    arrays, chain = _warm_mix_data()
    want = _warm_mix_want(arrays, chain)
    for c in counters.values():
        c.reset()
    cache_dir = tempfile.mkdtemp(prefix="chip-smoke-ccache-")
    server_dir = tempfile.mkdtemp(prefix="chip-smoke-server-ccache-")
    try:
        def engine_on(cdir):
            eng = AlchemistEngine(device=DEVICE, cache_entries=0,
                                  compile_cache_dir=cdir)
            eng.load_library("elemental", elemental)
            return eng, eng.backends["torch"]

        # (b) cold: each first call builds its program on the request path
        engine, backend = engine_on(cache_dir)
        ac = AlchemistContext(engine=engine)
        handles = _send_mix(ac, arrays, chain)
        cold_first, outs, _ = _mix_once(ac, handles)
        cold_errs = _check_mix(outs, want, "cold first call")
        cold_later, outs, _ = _mix_once(ac, handles)
        _check_mix(outs, want, "cold later call")
        cold_log = engine.compile_log.stats()
        cold_capture_s = backend.capture_seconds
        ac.stop()
        engine.shutdown()
        if cold_log["request_compiles"] < len(WARM_MIX) + 1:
            raise AssertionError(f"the cold engine compiled less than the "
                                 f"mix: {cold_log}")

        # (a) warmup on a fresh engine over the cold engine's index
        engine, backend = engine_on(cache_dir)
        torch.cuda.current_stream().synchronize()
        allocated = torch.cuda.memory_allocated()
        warm = engine.warmup(grid=WARM_GRID)
        torch.cuda.current_stream().synchronize()
        warm_rec = {
            "grid": list(WARM_GRID), **warm,
            "programs": backend.program_cache_info()["programs"],
            "graphs": backend.graphs(),
            "capture_s": backend.capture_seconds,
            "capture_failures": backend.capture_failures,
            "held_bytes_counted": backend.held_bytes(),
            "allocated_growth_bytes":
                torch.cuda.memory_allocated() - allocated,
            # the LRU's bounds (count, and bytes: a share of the card) and
            # what it holds
            "program_cache_info": backend.program_cache_info()}
        if warm["skipped"] or warm["replayed"] < len(WARM_MIX) + 1 or \
                backend.capture_failures:
            raise AssertionError(f"warmup: {warm_rec}")
        # (b) warm: the same mix, nothing built on the request path
        captured, graphs = backend.capture_seconds, backend.graphs()
        ac = AlchemistContext(engine=engine)
        handles = _send_mix(ac, arrays, chain)
        warm_first, outs, _ = _mix_once(ac, handles)
        warm_errs = _check_mix(outs, want, "warm first call")
        warm_log = engine.compile_log.stats()
        after = (backend.capture_seconds, backend.graphs(),
                 backend.capture_failures)
        ac.stop()
        engine.shutdown()
        if warm_log["request_compiles"] or \
                warm_log["bucketed_request_compiles"] or \
                after != (captured, graphs, 0):
            raise AssertionError(
                f"the warmed engine built on the request path: {warm_log}, "
                f"capture s {captured} -> {after[0]}, graphs {graphs} -> "
                f"{after[1]}, capture failures {after[2]}")

        # what warmup at the default grid leaves held
        engine = AlchemistEngine(device=DEVICE, cache_entries=0)
        default = engine.warmup()
        default_held = engine.backends["torch"].held_bytes()
        engine.shutdown()

        # (c) the warm restart across two server processes on one dir
        servers = [_warm_server_run(server_dir, arrays, chain, want, run)
                   for run in range(2)]
        if servers[1]["replayed"] < len(WARM_MIX) + 1 or \
                servers[1]["request_compiles"] or \
                servers[1]["bucketed_request_compiles"]:
            raise AssertionError(f"the restarted server built on the "
                                 f"request path: {servers[1]}")
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)
        shutil.rmtree(server_dir, ignore_errors=True)

    # (d) bucketing at the ocean width: the padded field is a large slot,
    # a fresh tensor at every run, captured per address
    engine = AlchemistEngine(device=DEVICE, cache_entries=0)
    engine.load_library("elemental", elemental)
    backend = engine.backends["torch"]
    ac = AlchemistContext(engine=engine)
    al = ac.send_matrix(fused["field"], dedup=False)
    bucketed = []
    for run in range(3):
        graphs = backend.graphs()
        seconds, outs, delta = _burst_gram_chain(engine, ac, al)
        _one_task(delta, 4, f"bucketed gram chain run {run + 1}")
        bucketed.append({"seconds": seconds,
                         "engine_s": delta["engine_s"],
                         "captured": backend.graphs() > graphs})
    ac.configure(bucketing=False)
    _burst_gram_chain(engine, ac, al)                  # its capture
    exact_s, exact, delta = _burst_gram_chain(engine, ac, al)
    _one_task(delta, 4, "unbucketed gram chain")
    names = ("G", "Gt", "S", "P")
    bits = {n: bool(torch.equal(a, b)) for n, a, b in zip(names, outs, exact)}
    errs = {n: close("gram", a, b, "float32")
            for n, a, b in zip(names, outs, exact)}
    ocean = {"rows": FUSED_ROWS, "d": OCEAN_D,
             "padded_d": engine.bucket_policy.bucket_dim(OCEAN_D),
             "runs": bucketed,
             "captures": sum(r["captured"] for r in bucketed),
             "graphs": backend.graphs(),
             "capture_failures": backend.capture_failures,
             "unbucketed_replay_s": exact_s,
             "program_cache_info": backend.program_cache_info(),
             "phase_fused_unbucketed_replay_median_s": fused["replay_s"],
             "bits_match_unbucketed": bits,
             "max_abs_err_vs_unbucketed": errs}
    del outs, exact
    al.free()
    ac.stop()
    engine.shutdown()
    if ocean["capture_failures"]:
        raise AssertionError(f"bucketed ocean chain: {ocean}")
    launches = {k: c.value for k, c in counters.items()}
    emit({"phase": "warmup", "mix": {r: {k: list(v) for k, v in sh.items()}
                                     for r, sh in WARM_MIX},
          "chain": [WARM_CHAIN_N, WARM_CHAIN_STAGES],
          "warmup": warm_rec,
          "cold_first_call_s": cold_first, "cold_later_call_s": cold_later,
          "warm_first_call_s": warm_first,
          "cold_first_call_total_s": sum(cold_first.values()),
          "warm_first_call_total_s": sum(warm_first.values()),
          "first_call_speedup": sum(cold_first.values())
          / sum(warm_first.values()),
          "cold_compile_log": cold_log, "cold_capture_s": cold_capture_s,
          "warm_compile_log": warm_log,
          "cold_max_abs_err_vs_float64": cold_errs,
          "warm_max_abs_err_vs_float64": warm_errs,
          "default_grid_warmup": {**default,
                                  "held_bytes_counted": default_held},
          "servers": servers, "ocean_bucketed": ocean,
          "launches": launches,
          "seconds": time.perf_counter() - t_phase})
    return launches


# ---------------------------------------------------------------------------
# phase 6: the offload loop over TCP, through the port's server
# ---------------------------------------------------------------------------
def wire_bytes(bridge, server, endpoint: str) -> dict:
    """Frames and bytes of ``endpoint`` as the client put them on the
    socket and as the server took them off."""
    c, s = bridge.wire_log.stat(endpoint), server.wire_log.stat(endpoint)
    return {"client_frames_out": c.frames_out, "client_bytes_out":
            c.bytes_out, "client_frames_in": c.frames_in,
            "client_bytes_in": c.bytes_in, "server_frames_in": s.frames_in,
            "server_bytes_in": s.bytes_in, "server_frames_out":
            s.frames_out, "server_bytes_out": s.bytes_out}


def phase_cg_socket(cg, counters) -> tuple:
    """phase_cg's x and y sent through a client on TCP to an in-process
    AlchemistServer on the card, the same CG solved there and W fetched:
    W must equal phase_cg's bit for bit. Returns (the launch counts of
    the solve, the small CG's W through this server)."""
    from repro_torch.core import AlchemistContext
    from repro_torch.core.libraries import skylark
    from repro_torch.core.server import AlchemistServer
    x, y = cg["x"], cg["y"]
    t_phase = time.perf_counter()
    srv = AlchemistServer(device=DEVICE).start()    # owns its engine
    try:
        ac = AlchemistContext(address=srv.address)
        ac.register_library("skylark", skylark)
        _, small_w = small_cg_check(ac)
        t0 = time.perf_counter()
        al_x = ac.send_matrix(x, dedup=False)
        al_y = ac.send_matrix(y, dedup=False)
        upload_s = time.perf_counter() - t0
        recs = [al_x.last_transfer, al_y.last_transfer]
        sky = ac.library("skylark")

        for c in counters.values():
            c.reset()
        t0 = time.perf_counter()
        W = sky.cg_solve(X=al_x, Y=al_y, lam=1e-5,
                         rf_dim=RF_DIM, bandwidth=math.sqrt(TIMIT_D),
                         max_iters=CG_ITERS, tol=0.0)
        stats = W.stats()
        solve_s = time.perf_counter() - t0
        launches = {k: c.value for k, c in counters.items()}
        fetched = ac.engine.wire_log.stat("fetch").bytes_in
        t0 = time.perf_counter()
        w = W.to_numpy()
        fetch_s = time.perf_counter() - t0
        fetched = ac.engine.wire_log.stat("fetch").bytes_in - fetched
        # the same fetch again: what of the first is a one-time cost
        t0 = time.perf_counter()
        W.to_numpy()
        fetch_again_s = time.perf_counter() - t0
        ac.stop()
    finally:
        srv.stop()
    # read once the server is stopped: it logs a frame after sending it
    wire = wire_bytes(ac.engine, srv, "upload")

    same_bits = w.dtype == cg["w"].dtype and w.shape == cg["w"].shape \
        and np.array_equal(w.view(np.uint32), cg["w"].view(np.uint32))
    payload = x.nbytes + y.nbytes
    rec = {"phase": "cg_socket", "rows": CG_ROWS, "d": TIMIT_D,
           "rf_dim": RF_DIM, "classes": TIMIT_C,
           "iterations": stats["iterations"],
           "upload_s": upload_s, "upload_gb_per_s": payload / upload_s / 1e9,
           "inmemory_upload_gb_per_s": cg["upload_gb_per_s"],
           "payload_bytes": payload,
           "record_wire_bytes": sum(r.wire_nbytes for r in recs),
           "chunks": sum(r.num_chunks for r in recs),
           "upload_wire": wire, "solve_s": solve_s,
           "engine_solve_s": stats["_elapsed"], "fetch_w_s": fetch_s,
           "fetch_w_again_s": fetch_again_s, "fetch_w_bytes": w.nbytes,
           "fetch_w_wire_bytes": fetched,
           "w_equals_inmemory_bits": bool(same_bits),
           "w_max_abs_diff": float(np.abs(w - cg["w"]).max()),
           "relative_residual": stats["relative_residual"],
           "seconds": time.perf_counter() - t_phase, "launches": launches}
    emit(rec)
    if not same_bits:
        raise AssertionError("W over the socket differs from the in-memory "
                             "W: the upload path changed the bytes")
    if stats["iterations"] != CG_ITERS:
        raise AssertionError(f"CG ran {stats['iterations']} iterations")
    if launches["rf_map"] < 1 or launches["normal_matvec"] < CG_ITERS:
        raise AssertionError(f"the socket CG did not run through the "
                             f"kernels: {launches}")
    return launches, small_w


def phase_svd_socket(counters) -> dict:
    """The ocean field at SVD_SOCKET_ROWS sent in SVD_CHUNK_ROWS-row
    chunks over TCP to an in-process server on the card, both SVDs there,
    and the factors fetched."""
    from repro_torch.core import AlchemistContext
    from repro_torch.core.libraries import elemental
    from repro_torch.core.server import AlchemistServer
    t_phase = time.perf_counter()
    srv = AlchemistServer(device=DEVICE).start()    # owns its engine
    try:
        ac = AlchemistContext(address=srv.address)
        ac.register_library("elemental", elemental)
        el = ac.library("elemental")
        field, generation = ocean_like(SVD_SOCKET_ROWS, OCEAN_D)
        t0 = time.perf_counter()
        al_a = ac.send_matrix(field, dedup=False, chunk_rows=SVD_CHUNK_ROWS)
        upload_s = time.perf_counter() - t0
        up = al_a.last_transfer

        for c in counters.values():
            c.reset()
        t0 = time.perf_counter()
        U1, S1, V1 = el.truncated_svd(A=al_a, k=SVD_K)
        s1 = S1.to_numpy().ravel()
        trunc_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        U2, S2, V2 = el.gram_svd(A=al_a, k=SVD_K)
        s2 = S2.to_numpy().ravel()
        gram_s = time.perf_counter() - t0
        launches = {k: c.value for k, c in counters.items()}
        t0 = time.perf_counter()
        factors = {"U_trunc": U1.to_numpy(), "V_trunc": V1.to_numpy(),
                   "U_gram": U2.to_numpy(), "V_gram": V2.to_numpy()}
        fetch_s = time.perf_counter() - t0
        trunc_engine_s = S1.stats()["_elapsed"]
        gram_engine_s = S2.stats()["_elapsed"]
        ac.stop()
    finally:
        srv.stop()
    wire = wire_bytes(ac.engine, srv, "upload")
    fetch_wire = wire_bytes(ac.engine, srv, "fetch")

    rec = {"phase": "svd_socket", "rows": SVD_SOCKET_ROWS, "d": OCEAN_D,
           "k": SVD_K, "chunk_rows": SVD_CHUNK_ROWS, "upload_s": upload_s,
           "upload_generate_s": generation["seconds"],
           "upload_bridge_s": upload_s - generation["seconds"],
           "payload_bytes": up.nbytes, "record_wire_bytes": up.wire_nbytes,
           "chunks": up.num_chunks,
           "payload_bytes_per_chunk": up.nbytes / up.num_chunks,
           "wire_bytes_per_chunk": up.wire_nbytes / up.num_chunks,
           "upload_wire": wire, "truncated_svd_s": trunc_s,
           "truncated_svd_engine_s": trunc_engine_s, "gram_svd_s": gram_s,
           "gram_svd_engine_s": gram_engine_s, "fetch_factors_s": fetch_s,
           "fetch_factor_bytes": sum(f.nbytes for f in factors.values()),
           "fetch_wire": fetch_wire,
           "sigma_truncated": s1.tolist(), "sigma_gram": s2.tolist(),
           "sigma_max_rel_diff": float(np.max(np.abs(s1 - s2) / s2)),
           "seconds": time.perf_counter() - t_phase, "launches": launches}
    emit(rec)
    if launches["gram"] < 1:
        raise AssertionError(f"gram_svd over the socket did not run "
                             f"through the gram kernel: {launches}")
    np.testing.assert_allclose(s1, s2, rtol=1e-3)
    for name, f in factors.items():
        rows = SVD_SOCKET_ROWS if name.startswith("U") else OCEAN_D
        if f.shape != (rows, SVD_K) or not np.isfinite(f).all():
            raise AssertionError(f"{name} {f.shape} finite="
                                 f"{bool(np.isfinite(f).all())}")
    return launches


def _src_env(**extra) -> dict:
    """This process's environment with the checkout's ``src`` first on
    ``PYTHONPATH``, and ``extra``."""
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src")] + [p for p in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if p]), **extra)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_server(*args) -> tuple:
    """``python -m repro_torch.core.server --device cuda`` with ``args``,
    as its own process, as the README deploys it. Waits for its startup
    line; returns (the process, its address, the lines it printed, the
    seconds to its address). The caller stops it (``_stop_server``)."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.core.server", "--device",
         DEVICE, "--port", str(_free_port()), *args], env=_src_env(),
        cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines: "queue.Queue" = queue.Queue()
    seen: list = []

    def read():
        for line in proc.stdout:
            lines.put(line)
        lines.put(None)

    threading.Thread(target=read, daemon=True).start()
    try:
        deadline = time.monotonic() + SERVER_START_S
        address = None
        while address is None:
            try:
                line = lines.get(timeout=max(0.1, deadline -
                                             time.monotonic()))
            except queue.Empty:
                raise AssertionError(
                    f"the server printed no address in {SERVER_START_S} s: "
                    f"{seen}") from None
            if line is None:
                raise AssertionError(f"the server exited with "
                                     f"{proc.wait()} before serving: {seen}")
            seen.append(line.rstrip())
            if "serving on" in line:
                address = line.split("serving on ")[1].split()[0]
    except BaseException:
        _stop_server(proc, interrupt=False)
        raise
    return proc, address, seen, time.perf_counter() - t0


def _stop_server(proc, interrupt: bool = True) -> Optional[int]:
    """Interrupt the server and return its exit code (killed when it does
    not stop in two minutes, or when ``interrupt`` is false: None)."""
    rc = None
    try:
        if interrupt and proc.poll() is None:
            proc.send_signal(signal.SIGINT)
            rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return rc


def phase_server_cli(want_small_w) -> dict:
    """The server as its own process: drive small_cg_check's problem and
    its fetch through it, compare W with the in-process server's, then
    interrupt it and check that it exits 0."""
    from repro_torch.core import AlchemistContext
    from repro_torch.core.libraries import skylark
    t_phase = time.perf_counter()
    proc, address, seen, start_s = _start_server()
    try:
        with AlchemistContext(address=address) as ac:
            ac.register_library("skylark", skylark)
            err, w = small_cg_check(ac)
    finally:
        rc = _stop_server(proc)
    same_bits = np.array_equal(w.view(np.uint32),
                               want_small_w.view(np.uint32))
    diff = float(np.abs(w - want_small_w).max())
    rec = {"phase": "server_cli", "address": address, "startup_line":
           seen[-1], "start_s": start_s, "small_cg_max_err": err,
           "w_equals_in_process_bits": bool(same_bits),
           "w_max_abs_diff_in_process": diff, "exit_code": rc,
           "seconds": time.perf_counter() - t_phase}
    emit(rec)
    if rc != 0:
        raise AssertionError(f"the server process exited with {rc}")
    if not diff <= 1e-6 * float(np.abs(want_small_w).max()):
        raise AssertionError(f"the server process's W differs from the "
                             f"in-process server's by {diff}")
    return rec


# ---------------------------------------------------------------------------
# phase 7: serve RecurrentGemma-9B
# ---------------------------------------------------------------------------
def phase_serve(counters, arch: str = LM_ARCH) -> tuple:
    """Build ``arch`` (RecurrentGemma-9B; qwen3-4b) at its published widths
    on the card, serve LM_REQUESTS requests through the port's
    ServingEngine, and check what came out: each prefill launches swa once
    per attention layer (window = S on global layers) and lru_scan once
    per recurrent layer, decode launches nothing. Returns (model, the
    launch counts of the serving run)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import DecoderLM
    from repro_torch.serve.engine import Request, ServingEngine
    t_phase = time.perf_counter()
    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = DecoderLM(cfg, device=DEVICE,
                      generator=torch.Generator(DEVICE).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    kinds = [layer.kind.value for layer in model.layers]

    rng = np.random.default_rng(0)
    lens = rng.integers(LM_PROMPT_MIN, LM_PROMPT_MAX + 1, LM_REQUESTS)
    engine = ServingEngine(model, max_batch=LM_MAX_BATCH)
    for n in lens:
        engine.submit(Request(
            prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
            max_new_tokens=LM_NEW_TOKENS))
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    done = engine.run()
    serve_s = time.perf_counter() - t0
    launches = {k: c.value for k, c in counters.items()}

    waves = engine.stats["prefills"]
    want = {"swa": waves * (kinds.count("local_attn")
                            + kinds.count("attention")),
            "lru_scan": waves * kinds.count("recurrent")}
    if {k: launches[k] for k in want} != want or \
            any(launches[k] for k in launches if k not in want):
        raise AssertionError(f"serving launched {launches}, want {want}")
    toks = [r.out_tokens for r in done]
    if any(len(t) != LM_NEW_TOKENS for t in toks) or \
            not all(0 <= x < cfg.vocab_size for t in toks for x in t):
        raise AssertionError(f"served tokens out of shape or range: {toks}")
    if waves != 2 or \
            engine.stats["decode_steps"] != 2 * (LM_NEW_TOKENS - 1):
        raise AssertionError(f"serving stats {engine.stats}")
    new_tokens = sum(len(t) for t in toks)
    steps = engine.stats["decode_steps"]
    emit({"phase": "serve", "arch": arch, "layers": len(kinds),
          "kinds": {k: kinds.count(k) for k in sorted(set(kinds))},
          "params": n_params, "param_bytes": 4 * n_params,
          "init_s": init_s, "requests": len(done),
          "prompt_lens": lens.tolist(), "new_tokens": new_tokens,
          "waves": engine.waves,
          "prefill_s_per_wave": [w["prefill_s"] for w in engine.waves],
          "decode_ms_per_step": engine.stats["decode_s"] / steps * 1e3,
          "serve_s": serve_s,
          "new_tokens_per_s": new_tokens / serve_s,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "first_tokens": [t[:4] for t in toks],
          "launches": launches, "seconds": time.perf_counter() - t_phase})
    return model, launches


@contextlib.contextmanager
def moe_without_drops(model):
    """``model``'s MoE layers, for the duration, with room in every
    expert for every token (capacity factor E / k). With the published
    factor a full forward drops (token, expert) pairs past an expert's
    capacity in token order, the last token's first, and a decode step of
    one token never drops one: the two paths compute different functions
    by design, the JAX package's too. Yields the factor (None without MoE
    layers)."""
    import dataclasses
    from repro_torch.nn.moe import MoE
    layers = [m for m in model.modules() if isinstance(m, MoE)]
    if not layers:
        yield None
        return
    cfg = layers[0].cfg
    factor = cfg.moe.num_experts / cfg.moe.top_k
    roomy = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=factor))
    try:
        for m in layers:
            m.cfg = roomy
        yield factor
    finally:
        for m in layers:
            m.cfg = cfg


def _full_vs_decode(model, toks, extras) -> tuple:
    """(max |full - decode|, max |full|, argmax full, argmax decode) of the
    last position's logits: a full forward of ``toks`` (1, S) against
    prefill(S - 1) and one decode step, ``extras`` (a prefix-LM's patch
    embeddings, an encoder-decoder's frames) given to both."""
    import torch
    with torch.inference_mode():
        x, _ = model(toks, **extras)
        full = model.unembed(x[:, -1:])[:, 0].float()
        del x
        _, state = model.prefill(
            toks[:, :-1], seq_len=toks.shape[1] + model.cfg.prefix_len,
            **extras)
        step, _ = model.decode_step(state, toks[:, -1:])
        step = step.float()
    del state
    if not (bool(torch.isfinite(full).all()) and
            bool(torch.isfinite(step).all())):
        raise AssertionError("non-finite logits")
    return (float((full - step).abs().max()), float(full.abs().max()),
            int(full.argmax()), int(step.argmax()))


def phase_consistency(model, seq: int = LM_S) -> dict:
    """One request of ``seq`` tokens (behind a prefix-LM's patches, or
    with an encoder-decoder's frames): the last-position logits of a full
    forward (every attention and recurrent layer through the kernels)
    against prefill(seq - 1) and one decode step (the last token through
    the plain cache attention, MLA's absorbed decode, the single
    recurrence step, the cross cache), within LM_CONSISTENCY_TOL of max
    |logit| and the same argmax. A model with MoE layers is compared without capacity
    drops (:func:`moe_without_drops`): in its bf16 compute within the
    limit, and again in fp32 compute within the limit and with the same
    argmax. In bf16 the router's logits for the last token, a product
    over ``seq`` rows in the full forward and over one in decode, could
    round a near tie of two experts either way, a discrete choice the two
    paths may make apart; the bf16 argmaxes are reported."""
    import torch
    from repro_torch.models.io import stub_extras
    cfg = model.cfg
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, seq)))
    toks = toks.to(DEVICE)
    extras = {k: torch.from_numpy(v).to(DEVICE) for k, v in stub_extras(
        cfg, 1, np.random.RandomState(1)).items()}
    rec = {"phase": "consistency", "arch": cfg.name, "seq": seq,
           "layers": cfg.num_layers}
    fails = []
    with moe_without_drops(model) as factor:
        if factor is not None:
            rec["moe_capacity_factor"] = factor
            err, scale, top_full, top_step = _full_vs_decode(model, toks, extras)
            rec.update({"bf16_max_abs_diff": err,
                        "bf16_max_abs_logit": scale,
                        "bf16_limit": LM_CONSISTENCY_TOL * scale,
                        "bf16_argmax_full": top_full,
                        "bf16_argmax_decode": top_step})
            fails.append(not err <= LM_CONSISTENCY_TOL * scale)
            model.compute_dtype = torch.float32
            rec["compute"] = "float32"
        try:
            err, scale, top_full, top_step = _full_vs_decode(model, toks, extras)
        finally:
            model.compute_dtype = getattr(torch, cfg.dtype)
    rec.update({"max_abs_logit": scale, "max_abs_diff": err,
                "limit": LM_CONSISTENCY_TOL * scale,
                "argmax_full": top_full, "argmax_decode": top_step})
    emit(rec)
    if any(fails) or not (err <= LM_CONSISTENCY_TOL * scale
                          and top_full == top_step):
        raise AssertionError(f"prefill + decode disagrees with the full "
                             f"forward: {rec}")
    return rec


def layer_bytes(cfg) -> list:
    """fp32 bytes of ``cfg``'s parameters outside its layers, then of each
    layer, from its blocks built on the meta device (nothing
    allocated)."""
    import torch
    from repro_torch.models.blocks import make_block, uses_moe
    per_block = {}
    out = [4 * (cfg.d_model * (2 if cfg.use_layernorm else 1)    # final norm
                + cfg.vocab_size * cfg.d_model
                * (1 if cfg.tie_embeddings else 2))]
    for n, kind in enumerate(cfg.block_kinds()):
        key = (kind, uses_moe(cfg, n))
        if key not in per_block:
            block = make_block(cfg, kind, generator=torch.Generator(),
                               device="meta", use_moe=key[1])
            per_block[key] = 4 * sum(p.numel() for p in block.parameters())
        out.append(per_block[key])
    return out


def phase_families(counters) -> tuple:
    """Each other decoder-only family at its published widths: the fp32
    parameter bytes worked out before building, the depth the most layers
    that fit FAMILY_BUDGET_BYTES (MoE models keep their dense first
    layers), the model built from a seed, one request of FAMILY_S tokens
    with FAMILY_NEW new tokens through ServingEngine (its prefill launches
    swa once per attention layer, RWKV and MLA layers no kernel, decode
    none), the full-forward check, and the model freed. Returns (the
    launch counts of the serving runs, the records)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import DecoderLM
    from repro_torch.serve.engine import Request, ServingEngine
    t_phase = time.perf_counter()
    total = {k: 0 for k in counters}
    recs = []
    for arch in FAMILIES:
        t_arch = time.perf_counter()
        full = get_config(arch)
        sizes = np.cumsum(layer_bytes(full))
        layers = int(np.searchsorted(sizes, FAMILY_BUDGET_BYTES,
                                     side="right")) - 1
        if layers <= (full.moe.first_dense_layers if full.moe else 0):
            raise AssertionError(f"{arch}: {layers} layers fit "
                                 f"{FAMILY_BUDGET_BYTES:.0f} bytes")
        cfg = dataclasses.replace(full, num_layers=layers)
        full_bytes, nbytes = int(sizes[-1]), int(sizes[layers])
        emit({"phase": "family_cut", "arch": arch,
              "published_layers": full.num_layers,
              "published_param_bytes": full_bytes, "layers": layers,
              "param_bytes": nbytes,
              "kinds": sorted({k.value for k in cfg.block_kinds()}),
              "moe_layers": (layers - cfg.moe.first_dense_layers
                             if cfg.moe else 0)})
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = DecoderLM(cfg, device=DEVICE,
                          generator=torch.Generator(DEVICE).manual_seed(0))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        kinds = [layer.kind.value for layer in model.layers]
        rng = np.random.default_rng(2)
        engine = ServingEngine(model, max_batch=1)
        engine.submit(Request(
            prompt=rng.integers(0, cfg.vocab_size, FAMILY_S).astype(
                np.int32), max_new_tokens=FAMILY_NEW))
        for c in counters.values():
            c.reset()
        t0 = time.perf_counter()
        done = engine.run()
        serve_s = time.perf_counter() - t0
        launches = {k: c.value for k, c in counters.items()}
        want = {"swa": kinds.count("attention") + kinds.count("local_attn")}
        if {k: launches[k] for k in want} != want or \
                any(launches[k] for k in launches if k not in want):
            raise AssertionError(f"{arch} serving launched {launches}, "
                                 f"want {want}")
        toks = done[0].out_tokens
        if len(toks) != FAMILY_NEW or \
                not all(0 <= x < cfg.vocab_size for x in toks):
            raise AssertionError(f"{arch} served {toks}")
        for k, v in launches.items():
            total[k] += v
        wave = engine.waves[0]
        rec = {"phase": "family", "arch": arch, "layers": layers,
               "params": nbytes // 4, "init_s": init_s,
               "prefill_s": wave["prefill_s"],
               "decode_ms_per_step": wave["decode_s"]
               / max(wave["decode_steps"], 1) * 1e3,
               "serve_s": serve_s, "tokens": toks, "launches": launches,
               "max_memory_allocated": torch.cuda.max_memory_allocated()}
        rec["consistency"] = phase_consistency(model, FAMILY_S)
        rec["seconds"] = time.perf_counter() - t_arch
        emit(rec)
        recs.append(rec)
        del model, engine, done
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "families", "launches": total,
          "seconds": time.perf_counter() - t_phase})
    return total, recs


def phase_modalities(counters) -> tuple:
    """Serve the prefix-VLM and the encoder-decoder at their published
    widths and full depth through ServingEngine, per MODAL_TRAFFIC:
    LM_REQUESTS requests in waves of LM_MAX_BATCH, LM_NEW_TOKENS new
    tokens each, random fp32 parameters from a generator seeded 0, bf16
    compute, each wave's patch embeddings or frames drawn by
    ``extras_fn`` (numpy, seed 0, x 0.02). Checks: each prefill launches
    swa once per attention layer (PaliGemma's 18 with prefix 256; Whisper's
    24 encoder layers with prefix = S and 24 decoder layers causal),
    nothing else launches and decode launches nothing (the counts are
    exact per wave); tokens in range; the full forward against prefill +
    decode with the extras given. Whisper's prefill is split into the
    encoder's seconds and the decoder's. Returns (the launch counts of
    the serving runs, the records)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.io import stub_extras
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import Request, ServingEngine
    t_phase = time.perf_counter()
    total = {k: 0 for k in counters}
    recs = []
    for arch, lo, hi in MODAL_TRAFFIC:
        t_arch = time.perf_counter()
        cfg = get_config(arch)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = build_model(cfg, device=DEVICE,
                            generator=torch.Generator(DEVICE).manual_seed(0))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.parameters())
        encode_s = []
        if cfg.is_encdec:
            encode = model.encode

            def timed_encode(*args, **kwargs):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = encode(*args, **kwargs)
                torch.cuda.synchronize()
                encode_s.append(time.perf_counter() - t)
                return out
            model.encode = timed_encode
        rng = np.random.default_rng(0)
        lens = rng.integers(lo, hi + 1, LM_REQUESTS)
        engine = ServingEngine(model, max_batch=LM_MAX_BATCH)
        for n in lens:
            engine.submit(Request(
                prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                max_new_tokens=LM_NEW_TOKENS))
        xrng = np.random.RandomState(0)
        for c in counters.values():
            c.reset()
        t0 = time.perf_counter()
        done = engine.run(extras_fn=lambda n: stub_extras(cfg, n, xrng))
        serve_s = time.perf_counter() - t0
        launches = {k: c.value for k, c in counters.items()}
        if cfg.is_encdec:
            del model.encode
        waves = engine.stats["prefills"]
        want = {"swa": waves * (cfg.num_layers + cfg.encoder_layers)}
        if {k: launches[k] for k in want} != want or \
                any(launches[k] for k in launches if k not in want):
            raise AssertionError(f"{arch} serving launched {launches}, "
                                 f"want {want}")
        toks = [r.out_tokens for r in done]
        if any(len(t) != LM_NEW_TOKENS for t in toks) or \
                not all(0 <= x < cfg.vocab_size for t in toks for x in t):
            raise AssertionError(f"{arch} served tokens out of shape or "
                                 f"range: {toks}")
        if waves != 2 or \
                engine.stats["decode_steps"] != 2 * (LM_NEW_TOKENS - 1):
            raise AssertionError(f"{arch} serving stats {engine.stats}")
        for k, v in launches.items():
            total[k] += v
        new_tokens = sum(len(t) for t in toks)
        prefill_s = [w["prefill_s"] for w in engine.waves]
        rec = {"phase": "modality_serve", "arch": arch,
               "layers": cfg.num_layers,
               "encoder_layers": cfg.encoder_layers,
               "prefix_len": cfg.prefix_len, "params": n_params,
               "param_bytes": 4 * n_params, "init_s": init_s,
               "requests": len(done), "prompt_lens": lens.tolist(),
               "new_tokens": new_tokens, "waves": engine.waves,
               "prefill_s_per_wave": prefill_s,
               "decode_ms_per_step": engine.stats["decode_s"]
               / engine.stats["decode_steps"] * 1e3,
               "serve_s": serve_s, "new_tokens_per_s": new_tokens / serve_s,
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               "first_tokens": [t[:4] for t in toks], "launches": launches}
        if cfg.is_encdec:
            rec["encode_s_per_wave"] = encode_s
            rec["decoder_prefill_s_per_wave"] = [
                p - e for p, e in zip(prefill_s, encode_s)]
        rec["consistency"] = phase_consistency(model, hi)
        rec["seconds"] = time.perf_counter() - t_arch
        emit(rec)
        recs.append(rec)
        del model, engine, done
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "modalities", "launches": total,
          "seconds": time.perf_counter() - t_phase})
    return total, recs


def check_modalities_on_card() -> dict:
    """The reduced paligemma-3b and whisper-medium, forward only, on the
    card and on the CPU from the same parameters, tokens and extras, fp32
    and bf16: the logits within TRAIN_CONSISTENCY_TOL of max |logit| (the
    card's through the swa kernel with its prefix, the CPU's through the
    plain version)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.models.io import stub_extras
    from repro_torch.models.model import build_model
    t_phase = time.perf_counter()
    out = {}
    for arch, _, _ in MODAL_TRAFFIC:
        out[arch] = {}
        for dn, tol in TRAIN_CONSISTENCY_TOL.items():
            cfg = dataclasses.replace(get_reduced(arch), dtype=dn)
            model = build_model(cfg, device="cpu",
                                generator=torch.Generator().manual_seed(7))
            rng = np.random.RandomState(4)
            toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 40)))
            extras = {k: torch.from_numpy(v)
                      for k, v in stub_extras(cfg, 2, rng).items()}
            logits = {}
            for dev in ("cpu", DEVICE):
                model.to(dev)
                with torch.inference_mode():
                    x, _ = model(toks.to(dev), **{
                        k: v.to(dev) for k, v in extras.items()})
                    logits[dev] = model.unembed(x).float().cpu()
            scale = float(logits["cpu"].abs().max())
            err = float((logits[DEVICE] - logits["cpu"]).abs().max())
            rec = {"max_abs_diff": err, "max_abs_logit": scale,
                   "tol": tol, "positions": int(x.shape[1])}
            if not err <= tol * scale:
                raise AssertionError(f"{arch} on the card disagrees with "
                                     f"the CPU in {dn}: {rec}")
            out[arch][dn] = rec
    emit({"phase": "modalities_on_card", **out,
          "seconds": time.perf_counter() - t_phase})
    return out


# ---------------------------------------------------------------------------
# phase 8: train RecurrentGemma-9B at its published widths, cut in depth
# ---------------------------------------------------------------------------
#: one (rec, rec, local) cycle of the 38 layers: the fp32 masters,
#: gradients and AdamW states of all 38 would need ~150 GB
TRAIN_LAYERS = 3
TRAIN_B, TRAIN_S = 2, 4_096
TRAIN_STEPS, TRAIN_LR, TRAIN_WARMUP = 8, 3e-3, 2
TRAIN_LOSS_CHUNK = 512
TRAIN_BIGRAM_Q = 0.9
GALORE_RANK = 128
PROBE_BATCHES, PROBE_CLASSES = 16, 8
# the reduced model's loss and gradients on the card against the CPU: the
# tests' tolerances against the JAX package (tests/test_torch_train.py)
TRAIN_CONSISTENCY_TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def train_config():
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(LM_ARCH), num_layers=TRAIN_LAYERS,
                               remat="full", loss_chunk=TRAIN_LOSS_CHUNK)


def check_train_main_shapes() -> dict:
    """The two backward kernels at the training shapes: swa_bwd on q
    (2, 16, 4,096, 256) and k, v (2, 1, 4,096, 256) bf16 views, window
    2,048, from the forward kernel's lse and fp32 o, as training runs
    it; lru_scan forward and its
    reverse launch with da (the fused adjoint) on a, b and the states'
    gradient (2, 4,096, 4,096) fp32, the scans also bit for bit against
    their emulation and a second launch. Each against its plain version
    (fp32 copies), with its time, the plain version's, one library call's
    (or the copy ceiling and the unfused adjoint) and the card's bound.
    The forward comes back as ``lru_scan_train``, an extra of lru_scan's
    record."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels.lru_scan.lru_scan import CHUNK, WARPS
    from repro_torch.kernels.lru_scan.ops import lru_scan, lru_scan_reverse
    from repro_torch.kernels.lru_scan.ref import lru_scan_chunked_ref, \
        lru_scan_ref, lru_scan_reverse_ref
    from repro_torch.kernels.swa.ops import swa_backward, swa_forward
    from repro_torch.kernels.swa.ref import swa_backward_ref
    cfg = get_config(LM_ARCH)
    out = {}
    b, s, h, kh = TRAIN_B, TRAIN_S, cfg.num_heads, cfg.num_kv_heads
    d, win = cfg.resolved_head_dim, cfg.sliding_window
    q = _randn_on_card((b, s, h, d), 11).bfloat16().transpose(1, 2)
    k = _randn_on_card((b, s, kh, d), 12).bfloat16().transpose(1, 2)
    v = _randn_on_card((b, s, kh, d), 13).bfloat16().transpose(1, 2)
    dout = _randn_on_card((b, s, h, d), 14).bfloat16().transpose(1, 2)
    _, lse, o = swa_forward(q, k, v, win, with_lse=True)
    got = swa_backward(q, k, v, o, lse, dout, window=win)
    want = swa_backward_ref(q.float(), k.float(), v.float(), o, lse,
                            dout.float(), win)
    errs = {n: close_grad(f"swa_bwd {n}", g, w, GRAD_TOL["bfloat16"],
                          GRAD_RMS_TOL["bfloat16"])
            for n, g, w in zip(("dq", "dk", "dv"), got, want)}
    rel = {n: errs[n] / float(w.abs().max())
           for n, w in zip(("dq", "dk", "dv"), want)}
    rms = {n: grad_rms_ratio(g, w)
           for n, g, w in zip(("dq", "dk", "dv"), got, want)}
    del got
    # the RMS limit must see a mask fault: the plain version with a window
    # one key short is past it in some gradient
    short = swa_backward_ref(q.float(), k.float(), v.float(), o, lse,
                             dout.float(), win - 1)
    short_rms = {n: grad_rms_ratio(g, w)
                 for n, g, w in zip(("dq", "dk", "dv"), short, want)}
    if not max(short_rms.values()) > GRAD_RMS_TOL["bfloat16"]:
        raise AssertionError(f"GRAD_RMS_TOL passes a window one key short: "
                             f"{short_rms}")
    del want, short
    torch.cuda.empty_cache()
    visible = sum(min(i + 1, win) for i in range(s))
    # read q, k, v, dO, the fp32 o and lse once; write dq, dk, dv
    nbytes = 2.0 * (2 * b * h * s * d + 2 * b * kh * s * d) \
        + 4.0 * (b * h * s * d + b * h * s) \
        + 2.0 * (b * h * s * d + 2 * b * kh * s * d)
    # five band products of 2 D flops per (query, visible key) pair
    flops = 10.0 * b * h * d * visible
    bound, by = bound_ms(nbytes, flops, BF16_FLOPS)
    pos = torch.arange(s, device=DEVICE)
    band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None]
                                              - win)
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(
        ql, kl.expand(b, h, s, d), vl.expand(b, h, s, d), attn_mask=band)
    out["swa_bwd"] = {
        "shape": [b, h, kh, s, d, win], "dtype": "bfloat16",
        "max_abs_err": max(errs.values()), "err_over_max": rel,
        "rms_err_over_rms": rms, "window_short_rms": short_rms,
        "kernel_ms": cuda_time_ms(lambda: swa_backward(
            q, k, v, o, lse, dout, window=win)),
        "plain_ms": cuda_time_ms(lambda: swa_backward_ref(
            q, k, v, o, lse, dout, win)),
        "library_ms": cuda_time_ms(lambda: torch.autograd.grad(
            lib_out, (ql, kl, vl), dout, retain_graph=True)),
        "library_note": "the backward of scaled_dot_product_attention with "
                        "the band as a bool mask, bf16 (k and v expanded "
                        "to the 16 heads)",
        "bound_ms": bound, "bound_by": by}
    del q, k, v, dout, o, lse, ql, kl, vl, lib_out, band
    torch.cuda.empty_cache()

    w = cfg.lru_width
    a = torch.sigmoid(_randn_on_card((b, s, w), 15))
    x = 0.1 * _randn_on_card((b, s, w), 16)
    h0 = _randn_on_card((b, w), 17)
    hs = lru_scan(a, x, h0)
    err = held_scan("lru_scan", hs, lru_scan_ref(a, x, h0),
                    lru_scan_chunked_ref(a, x, h0, CHUNK, WARPS),
                    lru_scan(a, x, h0), "float32")
    scan_bytes = 4.0 * (3 * b * s * w + b * w)
    copy_out = torch.empty_like(a)
    # the forward at the training shape: an extra of lru_scan's record
    out["lru_scan_train"] = {
        "shape": [b, s, w], "max_abs_err": err,
        "ms": cuda_time_ms(lambda: lru_scan(a, x, h0), 20),
        "bound_ms": bound_ms(scan_bytes, 2.0 * b * s * w)[0],
        "copy_ceiling_ms": cuda_time_ms(
            lambda: torch.add(a, x, out=copy_out), 20)}
    # the adjoint as the backward runs it: the states' gradient g, a zero
    # carry, the forward's states and h0; lambda and da in one pass
    g = _randn_on_card((b, s, w), 18)
    zero = torch.zeros((b, w), device=DEVICE)
    got = lru_scan_reverse(a, g, zero, h=hs, h_init=h0)
    errs = [held_scan(f"lru_scan_reverse {n}", gg, want, emul, again,
                      "float32")
            for n, gg, want, emul, again in zip(
                ("lambda", "da"), got,
                lru_scan_reverse_ref(a, g, zero, hs, h0),
                lru_scan_chunked_ref(a, g, zero, CHUNK, WARPS, reverse=True,
                                     h=hs, h_init=h0),
                lru_scan_reverse(a, g, zero, h=hs, h_init=h0))]
    del got

    def unfused():
        lam = lru_scan_reverse(a, g, zero)
        return lam * torch.cat([h0[:, None], hs[:, :-1]], dim=1)

    # read a, g and h, write lambda and da (20 bytes an element), plus the
    # two carries; one multiply-add and one multiply an element
    bound, by = bound_ms(4.0 * (5 * b * s * w + 2 * b * w),
                         3.0 * b * s * w)
    out["lru_scan_reverse"] = {
        "shape": [b, s, w], "dtype": "float32", "max_abs_err": max(errs),
        "kernel_ms": cuda_time_ms(
            lambda: lru_scan_reverse(a, g, zero, h=hs, h_init=h0), 20),
        "plain_ms": cuda_time_ms(
            lambda: lru_scan_reverse_ref(a, g, zero, hs, h0)),
        # the yardstick the fused pass replaces, never the port's path: the
        # reverse for lambda alone, then a concatenation and a multiply
        "unfused_ms": cuda_time_ms(unfused, 20),
        "lambda_only_ms": cuda_time_ms(
            lambda: lru_scan_reverse(a, g, zero), 20),
        "lambda_only_bound_ms": bound_ms(scan_bytes, 2.0 * b * s * w)[0],
        "copy_ceiling_ms": cuda_time_ms(
            lambda: torch.add(a, g, out=copy_out), 20),
        "library_ms": None, "bound_ms": bound, "bound_by": by}
    del a, x, g, h0, hs, zero, copy_out
    torch.cuda.empty_cache()
    for name, rec in out.items():
        emit({"phase": "kernel_train_shape", "kernel": name, **rec})
    return out


#: the reduced models held on the card against the CPU, with the
#: sequence of their batch: RecurrentGemma's, and one dense, the
#: RWKV and an MLA + MoE family (160 tokens: one RWKV chunk and 32 steps),
#: the prefix-VLM (its 8 patches in the 100) and the encoder-decoder (100
#: decoder tokens after its 16 frames): swa_bwd with a prefix
TRAIN_CONSISTENCY_ARCHS = (("recurrentgemma-9b", 100), ("qwen3-4b", 160),
                           ("rwkv6-1.6b", 160),
                           ("deepseek-v2-lite-16b", 160),
                           ("paligemma-3b", 100), ("whisper-medium", 100))


def check_train_consistency() -> dict:
    """Each reduced model of TRAIN_CONSISTENCY_ARCHS on the card and on
    the CPU from the same parameters and batch, fp32 and bf16: the loss
    (and the MoE aux, non-zero on both) and every parameter's gradient
    (the card's through swa, swa_bwd with and without a prefix, lru_scan
    and its reverse launch), within the tests' tolerances of the
    gradient's norm."""
    import dataclasses
    import torch
    from repro_torch.common.config import ShapeConfig
    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import SyntheticLM, to_device
    from repro_torch.models.model import build_model
    from repro_torch.train.loop import value_and_grad
    from repro_torch.train.optim import master_params
    t_phase = time.perf_counter()
    out = {}
    for arch, seq in TRAIN_CONSISTENCY_ARCHS:
        out[arch] = {}
        for dn, tol in TRAIN_CONSISTENCY_TOL.items():
            cfg = dataclasses.replace(get_reduced(arch), dtype=dn)
            batch = SyntheticLM(cfg, ShapeConfig("t", seq, 2, "train"),
                                seed=3).batch(0)
            res = {}
            for dev in ("cpu", DEVICE):
                model = build_model(cfg, device="cpu",
                                    generator=torch.Generator().manual_seed(7))
                model.to(dev)
                res[dev] = value_and_grad(model, master_params(model),
                                          to_device(batch, dev),
                                          cast_params=True)
            (lc, mc, g_cpu), (lg, mg, g_card) = res["cpu"], res[DEVICE]
            # each parameter's gradient by its norm (a gradient that
            # nearly cancels over the batch carries each device's
            # rounding); the worst element over its tensor's max is
            # reported beside it
            worst = max(float(torch.linalg.norm(g_card[k].cpu() - g)
                              / torch.linalg.norm(g))
                        for k, g in g_cpu.items())
            worst_max = max(float((g_card[k].cpu() - g).abs().max()
                                  / g.abs().max()) for k, g in g_cpu.items())
            aux = (float(mc["aux"]), float(mg["aux"]))
            rec = {"loss_cpu": float(lc), "loss_card": float(lg),
                   "aux_cpu": aux[0], "aux_card": aux[1],
                   "worst_grad_err_over_norm": worst,
                   "worst_grad_err_over_max": worst_max,
                   "params": len(g_cpu), "seq": seq, "tol": tol}
            if not (abs(float(lc) - float(lg)) <= tol * abs(float(lc))
                    and abs(aux[0] - aux[1]) <= tol * abs(aux[0])
                    and (min(aux) > 0) == (cfg.moe is not None)
                    and worst <= tol):
                raise AssertionError(f"training {arch} on the card "
                                     f"disagrees with the CPU in {dn}: "
                                     f"{rec}")
            out[arch][dn] = rec
    emit({"phase": "train_consistency", **out,
          "seconds": time.perf_counter() - t_phase})
    return out


def phase_train(counters) -> tuple:
    """Train RecurrentGemma-9B at its published widths, cut to one
    (rec, rec, local) cycle, from random fp32 masters (seed 0) in bf16
    compute with remat and the chunked loss: the step-0 gradient (every
    parameter's must be finite and not all zero: ROADMAP C11 on the card),
    a GaLore projector refresh through the engine's randomized SVD,
    TRAIN_STEPS AdamW steps with the projection on SyntheticLM batches,
    then the offloaded linear probe (CG on the engine) on the trained
    trunk's features. Returns (the launch counts of the phase, record)."""
    import torch
    from repro_torch.common.config import ShapeConfig, TrainConfig
    from repro_torch.core import AlchemistContext
    from repro_torch.core.libraries import elemental, skylark
    from repro_torch.data.pipeline import SyntheticLM, to_device
    from repro_torch.models.model import DecoderLM
    from repro_torch.train.loop import make_train_step, value_and_grad
    from repro_torch.train.offload import extract_features, \
        fit_linear_head_cg, head_accuracy
    from repro_torch.train.optim import adamw_init, master_params, \
        refresh_projectors
    t_phase = time.perf_counter()
    cfg = train_config()
    torch.cuda.reset_peak_memory_stats()
    model = DecoderLM(cfg, device=DEVICE,
                      generator=torch.Generator(DEVICE).manual_seed(0))
    params = master_params(model)
    n_params = sum(p.numel() for p in params.values())
    shape = ShapeConfig("train", seq_len=TRAIN_S, global_batch=TRAIN_B,
                        mode="train")
    data = SyntheticLM(cfg, shape, seed=0, bigram_q=TRAIN_BIGRAM_Q)
    tc = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                     total_steps=TRAIN_STEPS, galore_rank=GALORE_RANK)
    batches = [to_device(data.batch(i), DEVICE) for i in range(TRAIN_STEPS)]
    torch.cuda.synchronize()

    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    loss0, _, grads = value_and_grad(model, params, batches[0],
                                     cast_params=True)
    torch.cuda.synchronize()
    grad0_s = time.perf_counter() - t0
    bad = [k for k, g in grads.items()
           if not bool(torch.isfinite(g).all()) or not bool(g.any())]
    if bad:
        raise AssertionError(f"step-0 gradients None, all zero or not "
                             f"finite on the card (C11): {bad}")
    grad0_launches = {k: c.value for k, c in counters.items()}

    ac = AlchemistContext(device=DEVICE)
    ac.register_library("elemental", elemental)
    ac.register_library("skylark", skylark)
    t0 = time.perf_counter()
    gal = refresh_projectors(ac, grads, rank=GALORE_RANK)
    torch.cuda.synchronize()
    refresh_s = time.perf_counter() - t0
    del grads

    opt = adamw_init(params)
    step_fn = make_train_step(model, tc, galore_state=gal)
    losses, step_s = [], []
    for batch in batches:
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    peak = torch.cuda.max_memory_allocated()
    del opt, batches, step_fn

    probe = SyntheticLM(cfg, shape, seed=1, bigram_q=1.0)
    t0 = time.perf_counter()
    feats, labels = extract_features(
        model, probe.batches(PROBE_BATCHES, DEVICE),
        max_batches=PROBE_BATCHES)
    labels = labels % PROBE_CLASSES
    w, res = fit_linear_head_cg(ac, feats, labels,
                                num_classes=PROBE_CLASSES, lam=1e-4)
    acc = head_accuracy(w, feats, labels)
    probe_s = time.perf_counter() - t0
    launches = {k: c.value for k, c in counters.items()}
    ac.stop()
    ac.engine.shutdown()

    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
    rec = {"phase": "train", "arch": LM_ARCH, "layers": cfg.num_layers,
           "kinds": [k.value for k in cfg.block_kinds()],
           "params": n_params, "batch": TRAIN_B, "seq": TRAIN_S,
           "tokens_per_step": TRAIN_B * TRAIN_S, "remat": cfg.remat,
           "loss_chunk": cfg.loss_chunk, "galore_rank": GALORE_RANK,
           "projectors": len(gal.projectors),
           "galore_refresh_s": refresh_s, "grad0_s": grad0_s,
           "loss0": float(loss0), "losses": losses, "step_s": step_s,
           "median_step_s_after_first": steady,
           "tokens_per_s": TRAIN_B * TRAIN_S / steady,
           "max_memory_allocated": peak,
           "probe": {"rows": int(feats.shape[0]), "accuracy": acc,
                     "chance": 1 / PROBE_CLASSES,
                     "cg_iterations": int(res["iterations"]),
                     "seconds": probe_s},
           "grad0_launches": grad0_launches, "launches": launches,
           "seconds": time.perf_counter() - t_phase}
    emit(rec)
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    if not acc > 1.5 / PROBE_CLASSES:
        raise AssertionError(f"the probe does not beat 1.5 / "
                             f"{PROBE_CLASSES}: {acc}")
    want = ("swa", "swa_bwd", "lru_scan", "lru_scan_reverse",
            "normal_matvec")
    if not all(launches[k] > 0 for k in want):
        raise AssertionError(f"training launched {launches}")
    del model, params, gal
    return launches, rec


# ---------------------------------------------------------------------------
# phase 8b: train the prefix-VLM and the encoder-decoder at full size
# ---------------------------------------------------------------------------
#: (arch, batch, sequence) at published widths and full depth, bf16,
#: remat: PaliGemma's 256 patches and 512 text tokens (3.04 B parameters:
#: 48.6 GB of fp32 masters, gradients and AdamW states); Whisper's 1,500
#: frames and its 448-token text context (0.81 B, 13 GB)
MODAL_TRAIN = (("paligemma-3b", 4, 256 + 512), ("whisper-medium", 4, 448))
MODAL_TRAIN_STEPS = 4


def modal_train_config(arch: str):
    """``arch`` at its published widths and depth with remat; the chunked
    loss for the decoder-only prefix-VLM (the encoder-decoder's loss, as
    the JAX package's ``EncDecLM.loss``, has no chunked variant)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch), remat="full")
    if not cfg.is_encdec:
        cfg = dataclasses.replace(cfg, loss_chunk=TRAIN_LOSS_CHUNK)
    return cfg


def phase_train_modalities(counters) -> tuple:
    """Train paligemma-3b and whisper-medium per MODAL_TRAIN from random
    fp32 masters (seed 0) in bf16 compute: first the dry run's resident
    bytes of each step (``launch/dryrun.py`` on the meta device), on a
    line of their own; then for each model the step-0 gradient (every
    parameter's finite and not all zero) and MODAL_TRAIN_STEPS AdamW
    steps on SyntheticLM batches, whose loss must fall; tokens/s counts
    text tokens (PaliGemma's patches go to positions/s). Every attention
    layer's backward is swa_bwd, PaliGemma's with prefix 256 and
    Whisper's encoder's with prefix = S, and its forward is swa twice a
    backward (once more in remat's recomputation): the launches are
    exact, counted with the prefix launches beside them
    (``BWD_PREFIX_LAUNCHES``). Then
    one more loss and backward under ``torch.profiler`` (not counted):
    the device's busy seconds and idle share, and the kernels by device
    time. Returns (the launch counts of the phase, the records)."""
    import torch
    from repro_torch.common.config import ShapeConfig, TrainConfig
    from repro_torch.data.pipeline import SyntheticLM, to_device
    from repro_torch.kernels.swa import ops as swa_ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.profile_serve import busy_us, kernel_spans
    from repro_torch.models.io import text_len
    from repro_torch.models.model import build_model
    from repro_torch.train.loop import make_train_step, value_and_grad
    from repro_torch.train.optim import adamw_init, master_params
    from torch.profiler import ProfilerActivity, profile
    t_phase = time.perf_counter()
    shapes = {arch: ShapeConfig("train", seq_len=seq, global_batch=b,
                                mode="train")
              for arch, b, seq in MODAL_TRAIN}
    predicted = {}
    for arch, _, _ in MODAL_TRAIN:
        cfg = modal_train_config(arch)
        predicted[arch] = dryrun.train_record(
            build_model(cfg, device="meta"), cfg, shapes[arch])[
                "resident_bytes"]
    emit({"phase": "train_modalities_dryrun",
          "predicted_resident_bytes": predicted})
    total = {k: 0 for k in counters}
    recs = []
    for arch, b, seq in MODAL_TRAIN:
        t_arch = time.perf_counter()
        cfg = modal_train_config(arch)
        torch.cuda.reset_peak_memory_stats()
        model = build_model(cfg, device=DEVICE,
                            generator=torch.Generator(DEVICE).manual_seed(0))
        params = master_params(model)
        n_params = sum(p.numel() for p in params.values())
        data = SyntheticLM(cfg, shapes[arch], seed=0,
                           bigram_q=TRAIN_BIGRAM_Q)
        batches = [to_device(data.batch(i), DEVICE)
                   for i in range(MODAL_TRAIN_STEPS)]
        tc = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                         total_steps=MODAL_TRAIN_STEPS)
        torch.cuda.synchronize()
        for c in counters.values():
            c.reset()
        swa_ops.BWD_PREFIX_LAUNCHES.reset()
        t0 = time.perf_counter()
        loss0, _, grads = value_and_grad(model, params, batches[0],
                                         cast_params=True)
        torch.cuda.synchronize()
        grad0_s = time.perf_counter() - t0
        bad = [k for k, g in grads.items()
               if not bool(torch.isfinite(g).all()) or not bool(g.any())]
        if bad:
            raise AssertionError(f"{arch}: step-0 gradients all zero or not "
                                 f"finite on the card: {bad}")
        del grads
        opt = adamw_init(params)
        step_fn = make_train_step(model, tc)
        losses, step_s = [], []
        for batch in batches:
            t0 = time.perf_counter()
            params, opt, metrics = step_fn(params, opt, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
        peak = torch.cuda.max_memory_allocated()
        launches = {k: c.value for k, c in counters.items()}
        prefix_launches = swa_ops.BWD_PREFIX_LAUNCHES.value
        steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            value_and_grad(model, params, batches[0], cast_params=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        spans = kernel_spans(prof)
        by_name: dict = {}
        for name, _, dur in spans:
            by_name[name[:80]] = by_name.get(name[:80], 0.0) + dur / 1e3
        busy = busy_us(spans) / 1e6
        profiled = {"wall_s": wall, "device_busy_s": busy,
                    "device_idle_share": 1.0 - busy / wall,
                    "kernels": len(spans),
                    "top_kernels_ms": sorted(by_name.items(),
                                             key=lambda kv: -kv[1])[:8]}
        del prof, spans
        backwards = 1 + MODAL_TRAIN_STEPS
        prefix_layers = cfg.encoder_layers or cfg.num_layers
        rec = {"phase": "train_modality", "arch": arch,
               "layers": cfg.num_layers,
               "encoder_layers": cfg.encoder_layers,
               "prefix_len": cfg.prefix_len or cfg.encoder_seq,
               "params": n_params, "batch": b, "seq": seq,
               "frames": cfg.encoder_seq, "remat": cfg.remat,
               "loss_chunk": cfg.loss_chunk, "grad0_s": grad0_s,
               "loss0": float(loss0), "losses": losses, "step_s": step_s,
               "median_step_s_after_first": steady,
               "tokens_per_step": b * text_len(cfg, seq),
               "tokens_per_s": b * text_len(cfg, seq) / steady,
               "positions_per_s": b * seq / steady,
               "frames_per_s": b * cfg.encoder_seq / steady,
               "max_memory_allocated": peak,
               "dryrun_resident_bytes": predicted[arch],
               "launches": launches, "prefix_launches": prefix_launches,
               "profiled_grad": profiled,
               "seconds": time.perf_counter() - t_arch}
        emit(rec)
        recs.append(rec)
        if not losses[-1] < losses[0]:
            raise AssertionError(f"{arch}: the loss did not fall: {losses}")
        attn_layers = cfg.num_layers + cfg.encoder_layers
        # remat="full": each backward recomputes every layer's forward
        if launches["swa"] != 2 * backwards * attn_layers or \
                launches["swa_bwd"] != backwards * attn_layers or \
                prefix_launches != backwards * prefix_layers or \
                any(v for k, v in launches.items()
                    if k not in ("swa", "swa_bwd")):
            raise AssertionError(f"{arch}: training launched {launches}, "
                                 f"{prefix_launches} with a prefix; want "
                                 f"{2 * backwards * attn_layers} swa, "
                                 f"{backwards * attn_layers} swa_bwd, "
                                 f"{backwards * prefix_layers} of them "
                                 "with a prefix")
        for k, v in launches.items():
            total[k] += v
        del model, params, opt, step_fn, batches, data, metrics
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "train_modalities", "launches": total,
          "seconds": time.perf_counter() - t_phase})
    return total, recs


# ---------------------------------------------------------------------------
# phase 9: the invariant gate on the card
# ---------------------------------------------------------------------------
#: the traced drive's bound and the explorer's sweep on the card
GATE_TIMEOUT_S = 300
GATE_SWEEP = ("disconnect_vs_midtask", 20)
#: locks the traced drive must take on the card: the capture and replay
#: locks exist only where CUDA does (kernels.settle guards the plain
#: versions, on the CPU only)
GATE_LOCKS = ("backend.capture", "backend.programs", "backend.program",
              "kernels.build", "kernels.launches")


def _run_module(args, env=None, what="") -> subprocess.CompletedProcess:
    """``python -m <args>`` from the checkout; raises with its output when
    it times out."""
    try:
        return subprocess.run([sys.executable, "-m", *args], cwd=str(REPO),
                              env=env or _src_env(), capture_output=True,
                              text=True, timeout=GATE_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        raise AssertionError(f"{what or args[0]} ran past "
                             f"{GATE_TIMEOUT_S} s: {e.stdout}") from None


def _sync_free_checks() -> tuple:
    """Each capture-safe routine's body and each kernel wrapper once, at
    small shapes on the card, under ``set_sync_debug_mode("error")``: any
    host sync inside raises. A planted ``.item()`` must raise too (the
    mode works). Runs with no engine alive; restores the mode. Returns
    the names checked and the planted call's error."""
    import torch
    from repro_torch.core.backends.torch_backend import (CAPTURE_SAFE,
                                                         TorchBackend)
    from repro_torch.kernels.gram import ops as gram_ops
    from repro_torch.kernels.lru_scan import ops as lru_ops
    from repro_torch.kernels.normal_matvec import ops as nm_ops
    from repro_torch.kernels.rf_map import ops as rf_ops
    from repro_torch.kernels.swa import ops as swa_ops
    dev = DEVICE
    g = torch.Generator(device="cpu").manual_seed(5)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(dev, dtype)

    a, b = rnd(128, 64), rnd(64, 96)
    be = TorchBackend()
    args = {"multiply": {"A": a, "B": b}, "add": {"A": a, "B": a},
            "transpose": {"A": a}, "gram": {"A": a},
            "replicate_cols": {"A": a, "times": 3}}
    calls = [(f"{lib}.{rt}@capture",
              lambda rt=rt, lib=lib: be.routine_impl(lib, rt).fn(**args[rt]))
             for lib, rt in sorted(CAPTURE_SAFE)]
    x, w = rnd(256, 96), rnd(96, 40)
    wr, br = rnd(96, 160), torch.rand(160, generator=g).to(dev)
    q = rnd(1, 4, 128, 64, dtype=torch.bfloat16)
    kv = rnd(1, 2, 128, 64, dtype=torch.bfloat16)
    la, lb, h0 = rnd(2, 64, 96), rnd(2, 64, 96), rnd(2, 96)
    _, lse, o32 = swa_ops.swa_forward(q, kv, kv, 32, with_lse=True)
    calls += [
        ("gram", lambda: gram_ops.gram(x)),
        ("normal_matvec", lambda: nm_ops.normal_matvec(x, w)),
        ("rf_map", lambda: rf_ops.rf_map(x, 160, bandwidth=2.0, seed=3)),
        ("rf_map_apply", lambda: rf_ops.rf_map_apply(x, wr, br)),
        ("swa", lambda: swa_ops.swa_attention(q, kv, kv, window=32)),
        ("swa_with_lse", lambda: swa_ops.swa_forward(q, kv, kv, 32, True)),
        ("swa_bwd", lambda: swa_ops.swa_backward(q, kv, kv, o32, lse, q,
                                                 window=32)),
        ("lru_scan", lambda: lru_ops.lru_scan(la, lb, h0)),
        ("lru_scan_reverse", lambda: lru_ops.lru_scan_reverse(la, lb, h0)),
        ("lru_scan_adjoint", lambda: lru_ops.lru_scan_reverse(
            la, lb, h0, h=lb, h_init=h0)),
    ]
    torch.cuda.synchronize()
    done, planted = [], None
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for name, fn in calls:
            fn()
            done.append(name)
        try:
            torch.ones(1, device=dev).sum().item()
        except RuntimeError as e:
            planted = str(e).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()
    if planted is None:
        raise AssertionError("a planted .item() did not raise under "
                             "set_sync_debug_mode('error')")
    return done, planted


def phase_gate(smi: str) -> dict:
    """The port's invariant gate (ROADMAP A10) on the card: (a) the static
    rules, clean with an empty baseline; (b) the engine driven under the
    lock tracer and the lifecycle monitor with captures, replays, a
    warmup thread, evictions and spills
    (``repro_torch.analysis.tracedrive``), its lock report gated by
    ``--check-lock-report``, and the explorer's sweep of one engine
    scenario on the card; (c) every capture-safe body and kernel wrapper
    free of host syncs under the sync debug mode."""
    t_phase = time.perf_counter()
    # (a) the static gate
    r = _run_module(["repro_torch.analysis", "--json"], what="static gate")
    static = json.loads(r.stdout) if r.stdout.strip() else {}
    if r.returncode != 0 or not static.get("ok") or static["findings"] \
            or static["suppressed"]:
        raise AssertionError(f"static gate (rc {r.returncode}): "
                             f"{r.stdout}{r.stderr}")
    t_static = time.perf_counter() - t_phase
    # (b) the traced drive and its lock report
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip-smoke-gate-")
    report_path = os.path.join(tmp, "locks.json")
    t0 = time.perf_counter()
    r = _run_module(["repro_torch.analysis.tracedrive", "--device", DEVICE],
                    env=_src_env(REPRO_LOCK_TRACE="1",
                                 REPRO_LOCK_TRACE_OUT=report_path,
                                 REPRO_STM_TRACE="1"), what="traced drive")
    lines = r.stdout.strip().splitlines()
    drive = json.loads(lines[-1]) if lines else {}
    if r.returncode != 0:
        raise AssertionError(f"traced drive (rc {r.returncode}): "
                             f"{r.stdout}{r.stderr}")
    t_drive = time.perf_counter() - t0
    r = _run_module(["repro_torch.analysis", "--check-lock-report",
                     report_path, "--json"], what="lock-report gate")
    report = json.loads(r.stdout) if r.stdout.strip() else {}
    if r.returncode != 0 or not report.get("ok"):
        raise AssertionError(f"lock-report gate (rc {r.returncode}): "
                             f"{r.stdout}{r.stderr}")
    missing = [n for n in GATE_LOCKS if n not in report["locks"]]
    if missing:
        raise AssertionError(f"the traced drive never took {missing}: "
                             f"{report['locks']}")
    if not drive["launches"].get("gram"):
        raise AssertionError(f"the traced drive launched no gram kernel: "
                             f"{drive['launches']}")
    scenario, schedules = GATE_SWEEP
    t0 = time.perf_counter()
    r = _run_module(["repro_torch.analysis.explore", "--scenario", scenario,
                     "--schedules", str(schedules), "--device", DEVICE],
                    what="explorer sweep")
    if r.returncode != 0:
        raise AssertionError(f"explorer sweep (rc {r.returncode}): "
                             f"{r.stdout}{r.stderr}")
    sweep = r.stdout.strip().splitlines()[0]
    t_sweep = time.perf_counter() - t0
    # (c) host syncs, dynamically
    t0 = time.perf_counter()
    sync_free, planted = _sync_free_checks()
    rec = {
        "phase": "gate", "nvidia_smi": smi,
        "static": {"findings": len(static["findings"]),
                   "suppressed": len(static["suppressed"]),
                   "seconds": t_static},
        "drive": {k: drive[k] for k in (
            "evictions", "programs", "held_bytes", "max_program_bytes",
            "capture_failures", "spills", "reloads", "warmup_compiled",
            "launches", "transitions", "longest_holds")},
        "monitor_violations": len(drive["violations"]),
        "drive_seconds": t_drive,
        "lock_report": {
            "locks": len(report["locks"]), "edges": len(report["edges"]),
            "waits_under_lock": len(report["waits_under_lock"]),
            "cycles": len(report["cycles"]),
            "rank_inversions": len(report["rank_inversions"]),
            "lock_names": report["locks"],
            "edge_list": [f"{e['from']} -> {e['to']} x{e['count']}"
                          for e in report["edges"]],
            "waits": [f"{w['wait_on']} under {w['held']} x{w['count']}"
                      for w in report["waits_under_lock"]],
            "long_holds_past_50ms": len(report["long_holds"])},
        "sweep": sweep, "sweep_seconds": t_sweep,
        "sync_free": sync_free, "planted_item_raised": planted,
        "sync_seconds": time.perf_counter() - t0,
        "seconds": time.perf_counter() - t_phase}
    emit({"gate": rec})
    return rec


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() "
              "is false); nothing to measure", file=sys.stderr)
        return 2
    from repro_torch.core import AlchemistContext
    from repro_torch.kernels import launch_counters

    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    check_test_shapes()
    kernels = check_main_shapes()
    kernels.update(check_train_main_shapes())
    kernels["lru_scan"]["train_shape"] = kernels.pop("lru_scan_train")
    kernels["swa_bwd"]["prefix_shapes"] = kernels["swa"].pop(
        "prefix_backward")
    check_train_consistency()
    check_modalities_on_card()
    counters = launch_counters()

    ac = AlchemistContext(device=DEVICE)
    launches, cg = phase_cg(ac, counters)
    ac.stop()
    torch.cuda.empty_cache()
    ac2 = AlchemistContext(engine=ac.engine)
    svd_launches = phase_svd(ac2, counters)
    ac2.stop()
    ac.engine.shutdown()
    for k, v in svd_launches.items():
        launches[k] += v
    del ac, ac2
    gc.collect()
    torch.cuda.empty_cache()

    # a burst chain as one task, replayed from one CUDA graph
    fused_launches, fused = phase_fused(counters)
    for k, v in fused_launches.items():
        launches[k] += v
    gc.collect()
    torch.cuda.empty_cache()
    # the compile cache: warmup, the warm restart, bucketing
    for k, v in phase_warmup(counters, fused).items():
        launches[k] += v
    del fused
    gc.collect()
    torch.cuda.empty_cache()

    # the same loop over TCP, through the port's server
    cg_launches, small_w = phase_cg_socket(cg, counters)
    del cg
    gc.collect()
    torch.cuda.empty_cache()
    svd_socket_launches = phase_svd_socket(counters)
    gc.collect()
    torch.cuda.empty_cache()
    for got in (cg_launches, svd_socket_launches):
        for k, v in got.items():
            launches[k] += v
    phase_server_cli(small_w)

    model, lm_launches = phase_serve(counters)
    phase_consistency(model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    for k, v in lm_launches.items():
        launches[k] += v

    # training at the published widths, one cycle deep
    train_launches, _ = phase_train(counters)
    gc.collect()
    torch.cuda.empty_cache()
    for k, v in train_launches.items():
        launches[k] += v

    # serving qwen3-4b at its published widths, every prefill's attention
    # on swa at window = S; then each other decoder-only family
    model, dense_launches = phase_serve(counters, DENSE_ARCH)
    phase_consistency(model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    family_launches, _ = phase_families(counters)
    gc.collect()
    torch.cuda.empty_cache()
    # the prefix-VLM and the encoder-decoder at full width and depth:
    # serving, then training
    modal_launches, _ = phase_modalities(counters)
    gc.collect()
    torch.cuda.empty_cache()
    modal_train_launches, modal_train = phase_train_modalities(counters)
    kernels["swa_bwd"]["prefix_launches"] = sum(
        r["prefix_launches"] for r in modal_train)
    gc.collect()
    torch.cuda.empty_cache()
    for got in (dense_launches, family_launches, modal_launches,
                modal_train_launches):
        for k, v in got.items():
            launches[k] += v

    # the invariant gate: static rules, the traced drive, sync freedom
    phase_gate(smi)

    if any(m == "jax" or m.startswith(("jax.", "repro."))
           or m == "repro" for m in sys.modules):
        raise AssertionError("the port loaded jax or the JAX package")
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_META[name][0],
         "replaces": KERNEL_META[name][1], "launches": launches[name],
         "max_abs_err": kernels[name]["max_abs_err"],
         "ms": kernels[name]["kernel_ms"],
         "plain_ms": kernels[name]["plain_ms"],
         "bound_ms": kernels[name]["bound_ms"],
         "bound_by": kernels[name]["bound_by"],
         "library_ms": kernels[name]["library_ms"],
         "design": KERNEL_DESIGN[name],
         **{k: kernels[name][k] for k in KERNEL_EXTRAS
            if k in kernels[name]}}
        for name in sorted(kernels)]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
