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
the work (Z = n x D fp32 is 41.9 GB). Each phase prints JSON lines; a
failing check raises and the script exits non-zero. It needs one CUDA
card and imports nothing of JAX or of the JAX package.

    python3 chip_smoke.py
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO / "src"))

# H100 SXM peaks (NVIDIA data sheet) used for the bounds: fp32 outside the
# tensor cores (the kernels use no TF32) and HBM3 bandwidth
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

# widths of the paper's workloads (never cut) and the cut row counts
TIMIT_D, RF_DIM, TIMIT_C = 440, 10_000, 147
OCEAN_D, SVD_K = 8_096, 20
CG_ROWS = 1_048_576            # of 2,251,569: Z must fit the card
SVD_ROWS = 1_048_576           # of 6,177,583
CG_ITERS = 20
REF_BLOCK_ROWS = 65_536        # row blocks of the full-size references
DEVICE = "cuda"

# tolerances of the JAX package's kernel tests (tests/test_kernels.py,
# tests/test_extensions.py): rtol, and atol as a multiple of max|want|
# (rf_map's atol is absolute)
TOL = {"gram": {"float32": 2e-5, "bfloat16": 2e-2},
       "normal_matvec": {"float32": 3e-5, "bfloat16": 3e-2},
       "rf_map": {"float32": 1e-5, "bfloat16": 2e-2}}

KERNEL_META = {
    "gram": ("src/repro_torch/csrc/gram.cu",
             "src/repro/kernels/gram/gram.py:38"),
    "normal_matvec": ("src/repro_torch/csrc/normal_matvec.cu",
                      "src/repro/kernels/normal_matvec/normal_matvec.py:40"),
    "rf_map": ("src/repro_torch/csrc/rf_map.cu",
               "src/repro/kernels/rf_map/rf_map.py:42"),
}


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


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
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
        for n, d, dd in [(256, 128, 256), (300, 70, 200), (512, 440, 1024),
                         (100, 33, 77)]:
            x = _randn(rng, (n, d), dt)
            w, b = (torch.from_numpy(v).to(DEVICE)
                    for v in rf_weights(d, dd, 2.0, 1))
            close("rf_map", rf_map_apply(x, w, b), rf_map_ref(x, w, b), dn,
                  absolute_atol=True)
            n_checked += 1
        for n, d, c in [(256, 64, 4), (300, 128, 1), (512, 440, 16),
                        (1000, 37, 3), (130, 32, 2)]:
            x = _randn(rng, (n, d), dt)
            w = _randn(rng, (d, c), torch.float32)
            close("normal_matvec", normal_matvec(x, w),
                  normal_matvec_ref(x, w), dn)
            n_checked += 1
    torch.cuda.synchronize()
    emit({"phase": "kernel_test_shapes", "cases": n_checked})


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
    bound, by = bound_ms(4.0 * (n * d + 2 * d * c), 4.0 * n * d * c)
    out["normal_matvec"] = {
        "shape": [n, d, c], "max_abs_err": err,
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
    bound, by = bound_ms(4.0 * (n * d + d * dd + dd + n * dd),
                         2.0 * n * d * dd)
    out["rf_map"] = {
        "shape": [n, d, dd], "max_abs_err": err,
        "kernel_ms": cuda_time_ms(lambda: rf_map_apply(x, w, b)),
        "plain_ms": cuda_time_ms(lambda: rf_map_ref(x, w, b)),
        "library_ms": None, "bound_ms": bound, "bound_by": by}
    del x, w, b
    torch.cuda.empty_cache()
    for name, rec in out.items():
        emit({"phase": "kernel_main_shape", "kernel": name, **rec})
    emit({"phase": "kernel_checks", "passed": sorted(out)})
    return out


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


def small_cg_check(ac) -> float:
    """A CG solve on the card against numpy's direct solve."""
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
    return err


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


def phase_cg(ac, counters) -> dict:
    from repro_torch.core.libraries import skylark
    ac.register_library("skylark", skylark)
    small_err = small_cg_check(ac)

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
    rec = {"phase": "cg", "rows": CG_ROWS, "d": TIMIT_D, "rf_dim": RF_DIM,
           "classes": TIMIT_C, "iterations": CG_ITERS,
           "small_cg_max_err": small_err, "generate_s": gen_s,
           "upload_s": upload_s, "solve_s": solve_s,
           "engine_solve_s": stats["_elapsed"],
           "expand_and_rhs_s": base_stats["_elapsed"],
           "per_iteration_ms": per_iter_ms, "fetch_w_s": fetch_s,
           "relative_residual": reported,
           "recomputed_relative_residual": recomputed,
           "residual_history": stats["residual_history"],
           "launches": launches}
    emit(rec)
    return launches


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
    counters = launch_counters()

    ac = AlchemistContext(device=DEVICE)
    launches = phase_cg(ac, counters)
    ac.stop()
    torch.cuda.empty_cache()
    ac2 = AlchemistContext(engine=ac.engine)
    svd_launches = phase_svd(ac2, counters)
    ac2.stop()
    ac.engine.shutdown()
    for k, v in svd_launches.items():
        launches[k] += v

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
         "library_ms": kernels[name]["library_ms"]}
        for name in sorted(kernels)]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
