"""gram on the card, quickly: build the kernel alone, hold it against the
plain version over its edges, and time it at the five shapes the port
gives it, beside one ``torch.mm(a.T, a)`` call and the bound. A chip call
of a few minutes for work on ``csrc/gram.cu``, where ``chip_smoke.py``
takes twelve.

  python -m repro_torch.launch.gram_check [--only sweep|time] [--reps N]
      [--shapes gram_svd,fused_chain,kernel_bench,gram_svd_bf16,light_tenant]

Prints the card's name and power limit, the ptxas report of each kernel
it built (registers, spills), one JSON line per sweep case (fp32 and bf16:
the max error over the limit, whether G is exactly symmetric and whether
two launches gave the same bits) and one per timed shape (mean
milliseconds over ``--reps`` launches after a warm-up, by CUDA events,
with the library call's, the card's bound for the dtype, the bound on the
fp32 CUDA cores and, for bf16, on the kernel's one TF32 product, and the
host microseconds a call takes to enqueue; below a millisecond also each
call's device time from ``torch.profiler``). Exits non-zero when a case
is past its limit, not symmetric or not repeatable.

The limit is chip_smoke.py's (``kernels/limits.py``): 2e-5 (fp32) and
2e-2 (bf16) of max |want| plus as much of |want|, against the plain
version summed over row blocks of 65,536 in float64. The script calls
the package's public functions only, so it also times an older tree of
the package put first on PYTHONPATH (a parent commit, in turns with the
change; one that holds ``kernels/limits.py`` and ``H100.tf32_flops``):
``PYTHONPATH=_check/parent/src python src/repro_torch/launch/gram_check.py
--only time``."""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time

import torch

import repro_torch
from repro_torch.common.config import H100
from repro_torch.common.device import explicit_device
from repro_torch.kernels import build
from repro_torch.kernels.gram.ops import gram
from repro_torch.kernels.gram.ref import gram_ref
from repro_torch.kernels.limits import TOL, blocked
from repro_torch.launch.forward_check import _ms, host_us, kernels_ms

#: (n, d) of the JAX tests' gram cases
TEST_SHAPES = ((256, 128), (512, 256), (384, 200), (1000, 64), (128, 384))
#: (n, d) at the kernel's edges: rows not 16-byte aligned (d = 33, 130),
#: ragged last tiles (130, 200, 8,096: a last tile of 32 columns), one row,
#: rows not a multiple of the 32-row stage, many slabs with a short last
#: one (4,133 rows over 3 upper tiles)
EDGE_SHAPES = ((100, 33), (257, 130), (77, 8096), (1, 64), (1, 33),
               (333, 256), (4133, 200))
#: (name, n, d, dtype): gram_svd's A, phase_fused's chain, kernel_bench,
#: gram_svd's A in bf16, a light tenant's request
TIME_SHAPES = (("gram_svd", 1_048_576, 8_096, torch.float32),
               ("fused_chain", 65_536, 8_096, torch.float32),
               ("kernel_bench", 8_192, 512, torch.float32),
               ("gram_svd_bf16", 1_048_576, 8_096, torch.bfloat16),
               ("light_tenant", 128, 32, torch.float32))


def bound_ms(n: int, d: int, dtype=torch.float32) -> dict:
    """The least time the H100 could take for G = A^T A (the upper
    triangle's n d (d + 1) flops; A read once, G written once): fp32 at
    three TF32 products a product (3xTF32, the fastest route that meets
    fp32's tolerance), bf16 at the card's bf16 rate; beside it the fp32
    CUDA cores' and, for bf16, the kernel's own route, one TF32 product (a
    bf16 A is exact in TF32)."""
    def at(flops_per_s: float) -> float:
        return max(flops / flops_per_s * 1e3, t_bytes)
    flops = n * d * (d + 1.0)
    t_bytes = (n * d * (4 if dtype == torch.float32 else 2)
               + 4.0 * d * d) / H100.hbm_bw * 1e3
    t_ops = (3 * flops / H100.tf32_flops if dtype == torch.float32
             else flops / H100.peak_flops) * 1e3
    rec = {"bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "bound_ms_fp32_cuda_cores": at(H100.fp32_flops)}
    if dtype == torch.bfloat16:
        rec["bound_ms_one_tf32_product"] = at(H100.tf32_flops)
    return rec


def check(got: torch.Tensor, again: torch.Tensor, want: torch.Tensor,
          dtype) -> dict:
    """The error over chip_smoke.close's limit, exact symmetry, and the
    bits of a second launch."""
    tol = TOL["gram"][str(dtype).removeprefix("torch.")]
    err = (got.double() - want).abs()
    limit = tol * float(want.abs().max()) + tol * want.abs()
    over = float((err / limit.clamp_min(1e-300)).max()) \
        if bool(torch.isfinite(got).all()) else float("inf")
    rec = {"max_abs_err": float(err.max()), "over_limit": over,
           "symmetric": bool(torch.equal(got, got.T)),
           "same_bits": bool(torch.equal(got, again))}
    rec["ok"] = over <= 1.0 and rec["symmetric"] and rec["same_bits"]
    return rec


def check_case(rn, dtype, n: int, d: int) -> dict:
    """gram at (n, d) against the plain version, symmetric, repeatable."""
    a = rn(n, d).to(dtype)
    got = gram(a)
    rec = {"dtype": str(dtype).removeprefix("torch."), "shape": [n, d]}
    rec.update(check(got, gram(a), blocked(gram_ref, a), dtype))
    return rec


def time_shape(rn, name: str, n: int, d: int, dtype, reps: int) -> dict:
    """gram and torch.mm(a.T, a) at one shape, with the check above."""
    a = rn(n, d).to(dtype)
    rec = {"shape": name, "dims": [n, d],
           "dtype": str(dtype).removeprefix("torch.")}
    rec.update(check(gram(a), gram(a), blocked(gram_ref, a), dtype))
    rec["ms"] = _ms(lambda: gram(a), reps)
    rec["library_ms"] = _ms(lambda: torch.mm(a.T, a), reps)
    if rec["ms"] < 1:
        # events over back-to-back calls may measure the host here: the
        # kernels' own device time, and the host's time a call
        rec["device_ms"] = sum(kernels_ms(lambda: gram(a)).values())
        rec["library_device_ms"] = sum(kernels_ms(
            lambda: torch.mm(a.T, a)).values())
    rec["host_us"] = host_us(lambda: gram(a), 20 if rec["ms"] < 1 else 3)
    rec.update(bound_ms(n, d, dtype))
    rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
    return rec


def ptxas_report(log: str) -> dict:
    """kernel -> "N registers[, S bytes spill stores]" from ptxas's -v
    output, gram's instantiations told apart by element type."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            raw = m.group(1)
            base = re.search(r"(gram_wgmma_kernel|gemm_tn_kernel|"
                             r"sum_slabs_kernel)", raw)
            name = base.group(1) if base else raw
            if "bfloat16" in raw:
                name += "<bf16>"
            elif base and base.group(1) != "sum_slabs_kernel":
                name += "<float>"
            out[name] = []
        elif name and "spill stores" in ln:
            out[name].append(ln.strip().split(", ")[1])
        elif name and "Used" in ln and "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            out[name].insert(0, f"{regs} registers")
    return {k: ", ".join(v) for k, v in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--only", choices=("sweep", "time"))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--shapes", help="comma-separated TIME_SHAPES names "
                    "(default: all)")
    args = ap.parse_args(argv)
    dev = explicit_device(args.device, "repro_torch.launch.gram_check")
    if dev.type != "cuda":
        raise SystemExit("gram_check runs the kernel: it needs cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    t0 = time.perf_counter()
    build.build_all(("gram",))
    print(json.dumps({"package": repro_torch.__file__, "nvidia_smi": smi,
                      "build_s": time.perf_counter() - t0,
                      "device": torch.cuda.get_device_name(dev),
                      "gram_ptxas": ptxas_report(build.build_log.get(
                          "gram", {}).get("ptxas", ""))}), flush=True)
    gen = torch.Generator(dev).manual_seed(0)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    ok = True
    if args.only != "time":
        n_cases, bad = 0, 0
        for dt in (torch.float32, torch.bfloat16):
            for n, d in TEST_SHAPES + EDGE_SHAPES:
                rec = check_case(rn, dt, n, d)
                n_cases += 1
                if not rec["ok"]:
                    bad += 1
                    print(json.dumps(rec), flush=True)
        print(json.dumps({"sweep_cases": n_cases, "failed": bad}),
              flush=True)
        ok &= bad == 0
    if args.only != "sweep":
        names = args.shapes.split(",") if args.shapes else \
            [t[0] for t in TIME_SHAPES]
        for name, n, d, dt in (t for t in TIME_SHAPES if t[0] in names):
            rec = time_shape(rn, name, n, d, dt, args.reps)
            ok &= rec["ok"]
            print(json.dumps(rec), flush=True)
            torch.cuda.empty_cache()
    print("ALL_OK" if ok else "FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
