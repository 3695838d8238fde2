"""normal_matvec at narrow w on the card, quickly: build the kernels, hold
the wrapper against X^T (X w) in float64 over the stream route's edges,
and time it at the Lanczos cell's shape (2,059,195 x 8,096, w one column)
beside cuBLAS's two passes ``x.T @ (x @ q)`` (what ``truncated_svd``
computed before it called normal_matvec), the plain version and the
bound. A run of a few minutes on the card for work on
``csrc/normal_matvec_stream.cu``, where ``chip_smoke.py`` takes twelve.

  python -m repro_torch.launch.normal_matvec_check [--only sweep|time]
      [--reps N] [--shapes lanczos,bf16_half]

Prints the card's name and power limit, the ptxas report of each kernel
built, one JSON line per failed sweep case and a count (each case: the
error over the limit against the float64 product, whether two calls gave
the same bits, which route ran), and one JSON line per timed shape (mean
milliseconds over ``--reps`` calls after a warm-up, by CUDA events, for
the wrapper, cuBLAS's two passes (and their error beside the wrapper's)
and the plain version; the wrapper's
device ms per kernel from ``torch.profiler``; the bound, X read once over
3.35 TB/s or the flops over the fp32 CUDA cores' 67 TFLOP/s, the larger).
Exits non-zero when a case is past its limit or not repeatable.

The limit is fp32's (``kernels/limits.py``, 3e-5 of max |want| plus as
much of |want|) for both dtypes: a bf16 X is exact in fp32 and the stream
route's arithmetic is fp32. The script calls the package's public
functions only, so it also times an older tree of the package put first
on PYTHONPATH (a parent commit, in turns with the change; there every
call takes the tensor-core route): ``PYTHONPATH=_check/parent/src python
src/repro_torch/launch/normal_matvec_check.py --only time``."""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

import repro_torch
from repro_torch.common.config import H100
from repro_torch.common.device import explicit_device
from repro_torch.kernels import build
from repro_torch.kernels.limits import TOL, blocked
from repro_torch.kernels.normal_matvec import ops as nm_ops
from repro_torch.kernels.normal_matvec.ref import normal_matvec_ref
from repro_torch.launch.forward_check import _ms, host_us, kernels_ms
from repro_torch.launch.gram_check import ptxas_report

#: (n, d, c, offset) at the stream route's edges: ragged n (off every
#: stage and slab), one row, d off 16 bytes (fp32 d % 4, bf16 d % 8: the
#: lanes' copies), a base off 16 bytes (offset elements into a larger
#: buffer), short rows (most of a thread's chunks off), d at 8,096 and at
#: the widest the route takes, many ring turns a slab; c = 1 and past it
#: (the tensor-core route)
SWEEP_CASES = ((4133, 37, 1, 0), (4133, 37, 2, 0), (1, 8096, 1, 0),
               (5000, 8096, 1, 0), (5000, 8096, 2, 0), (777, 8192, 1, 0),
               (1111, 4096, 2, 0), (3001, 3000, 1, 0), (2000, 1000, 2, 0),
               (700, 1000, 1, 0), (300_000, 64, 1, 0), (10, 130, 1, 0),
               (999, 512, 2, 1), (999, 512, 1, 1), (1000, 8096, 1, 1),
               (513, 4000, 3, 0))
#: (name, n, d, c, dtype): the Lanczos cell's step, and bf16 at half the
#: rows
TIME_SHAPES = (("lanczos", 2_059_195, 8_096, 1, torch.float32),
               ("bf16_half", 1_029_598, 8_096, 1, torch.bfloat16))


def bound_ms(n: int, d: int, c: int, dtype=torch.float32) -> dict:
    """The least time the H100 could take for X^T (X w): X read once and
    w, the result moved once, over HBM, or the 4 n d c flops on the fp32
    CUDA cores (no TF32: the callers state fp32), the larger."""
    t_bytes = (n * d * dtype.itemsize + 8.0 * d * c) / H100.hbm_bw * 1e3
    t_ops = 4.0 * n * d * c / H100.fp32_flops * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _launches() -> dict:
    """The wrapper's launch counts by route (the stream route's counter
    is absent from older trees)."""
    stream = getattr(nm_ops, "STREAM_LAUNCHES", None)
    return {"wgmma": nm_ops.LAUNCHES.value,
            "stream": stream.value if stream is not None else 0}


def check(got: torch.Tensor, again: torch.Tensor,
          want: torch.Tensor) -> dict:
    """The error over the fp32 limit against the float64 ``want``, and
    the bits of a second call."""
    tol = TOL["normal_matvec"]["float32"]
    err = (got.double() - want).abs()
    limit = tol * float(want.abs().max()) + tol * want.abs()
    over = float((err / limit.clamp_min(1e-300)).max()) \
        if bool(torch.isfinite(got).all()) else float("inf")
    rec = {"max_abs_err": float(err.max()), "over_limit": over,
           "same_bits": bool(torch.equal(got, again))}
    rec["ok"] = over <= 1.0 and rec["same_bits"]
    return rec


def _routed(fn) -> tuple:
    """fn's result and the route its call took."""
    before = _launches()
    out = fn()
    after = _launches()
    ran = [k for k in after if after[k] > before[k]]
    return out, ",".join(ran)


def check_case(rn, dtype, n: int, d: int, c: int, offset: int) -> dict:
    """normal_matvec at (n, d, c), x starting ``offset`` elements into its
    buffer, against the float64 product; repeatable."""
    x = rn(n * d + offset).to(dtype)[offset:].view(n, d)
    w = rn(d, c)
    got, ran = _routed(lambda: nm_ops.normal_matvec(x, w))
    want = x.double().T @ (x.double() @ w.double())
    rec = {"dtype": str(dtype).removeprefix("torch."),
           "shape": [n, d, c, offset], "route": ran}
    rec.update(check(got, nm_ops.normal_matvec(x, w), want))
    return rec


def _randn_rows(gen, n: int, d: int, dtype, dev) -> torch.Tensor:
    """A normal (n, d) matrix made in row blocks straight into ``dtype``
    (a bf16 X never needs its fp32 copy beside it)."""
    x = torch.empty(n, d, dtype=dtype, device=dev)
    for lo in range(0, n, 65_536):
        hi = min(n, lo + 65_536)
        x[lo:hi] = torch.randn(hi - lo, d, generator=gen, device=dev)
    return x


def time_shape(x: torch.Tensor, name: str, c: int, reps: int,
               gen) -> dict:
    """The wrapper, cuBLAS's two passes and the plain version at one
    shape, with the check above against the blocked float64 reference."""
    n, d = x.shape
    w = torch.randn(d, c, generator=gen, device=x.device)
    q = w[:, 0].contiguous()
    got, ran = _routed(lambda: nm_ops.normal_matvec(x, w))
    want = blocked(normal_matvec_ref, x, w)
    rec = {"shape": name, "dims": [n, d, c],
           "dtype": str(x.dtype).removeprefix("torch."), "route": ran}
    rec.update(check(got, nm_ops.normal_matvec(x, w), want))
    rec["ms"] = _ms(lambda: nm_ops.normal_matvec(x, w), reps)
    rec["device_ms"] = kernels_ms(lambda: nm_ops.normal_matvec(x, w), 3)
    if x.dtype == torch.float32:
        rec["cublas_max_abs_err"] = float(
            ((x.T @ (x @ q)).double() - want[:, 0]).abs().max())
        rec["cublas_two_passes_ms"] = _ms(lambda: x.T @ (x @ q), reps)
        rec["cublas_device_ms"] = kernels_ms(lambda: x.T @ (x @ q), 3)
    rec["plain_ms"] = _ms(lambda: normal_matvec_ref(x, w), reps)
    rec["host_us"] = host_us(lambda: nm_ops.normal_matvec(x, w), 3)
    rec.update(bound_ms(n, d, c, x.dtype))
    rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
    rec["hbm_TBps"] = x.numel() * x.element_size() / rec["ms"] / 1e9
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--only", choices=("sweep", "time"))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--shapes", help="comma-separated TIME_SHAPES names "
                    "(default: all)")
    args = ap.parse_args(argv)
    dev = explicit_device(args.device,
                          "repro_torch.launch.normal_matvec_check")
    if dev.type != "cuda":
        raise SystemExit("normal_matvec_check runs the kernels: it needs "
                         "cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    names = [k for k in build.KERNELS if k.startswith("normal_matvec")]
    t0 = time.perf_counter()
    build.build_all(names)
    print(json.dumps({"package": repro_torch.__file__, "nvidia_smi": smi,
                      "build_s": time.perf_counter() - t0,
                      "device": torch.cuda.get_device_name(dev),
                      "build_seconds": {k: build.build_log.get(
                          k, {}).get("seconds") for k in names},
                      "ptxas": {k: ptxas_report(build.build_log.get(
                          k, {}).get("ptxas", "")) for k in names}}),
          flush=True)
    gen = torch.Generator(dev).manual_seed(0)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    ok = True
    if args.only != "time":
        n_cases, bad = 0, 0
        for dt in (torch.float32, torch.bfloat16):
            for case in SWEEP_CASES:
                rec = check_case(rn, dt, *case)
                n_cases += 1
                if not rec["ok"]:
                    bad += 1
                    print(json.dumps(rec), flush=True)
        print(json.dumps({"sweep_cases": n_cases, "failed": bad}),
              flush=True)
        ok &= bad == 0
    if args.only != "sweep":
        want = args.shapes.split(",") if args.shapes else \
            [t[0] for t in TIME_SHAPES]
        x, made = None, None
        for name, n, d, c, dt in (t for t in TIME_SHAPES if t[0] in want):
            if made != (n, d, dt):
                x = None
                torch.cuda.empty_cache()
                x, made = _randn_rows(gen, n, d, dt, dev), (n, d, dt)
            rec = time_shape(x, name, c, args.reps, gen)
            ok &= rec["ok"]
            print(json.dumps(rec), flush=True)
        del x
        torch.cuda.empty_cache()
    print("ALL_OK" if ok else "FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
