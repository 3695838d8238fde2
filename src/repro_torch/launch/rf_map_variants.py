"""What rf_map's design choices are worth on the card: variants of
``csrc/rf_map.cu`` and the headers it includes, each a text substitution
of the sources in this checkout, built side by side, checked against the
plain version and timed at the main path's shape (X 1,048,576 x 440 ->
10,000 fp32) beside the kernel as it is and ``torch.addmm(b, x, w)``.

  python -m repro_torch.launch.rf_map_variants

Variants (VARIANTS):
  as_is          the sources as they are;
  tile128        128-column output tiles instead of 160;
  rows_fastest   tiles walked rows fastest, so X is read from device
                 memory once per column tile;
  cos_unrolled   the epilogue's cos loop unrolled (more inlined cosf);
  rn_split       TF32 parts rounded to nearest instead of truncated;
  products_only  the epilogue replaced by a sum of the tile: the main
                 loop's time (its output is not Z, so it is not checked).

Prints one JSON line per variant (its ptxas registers and spills, whether
it passed the checks, its max and rms error against float64 on the first
131,072 rows), then one line of mean milliseconds per variant, two rounds
in turn. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import shutil
import subprocess

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rf_map import rf_map as rf_launcher
from repro_torch.kernels.rf_map.ops import rf_map_apply
from repro_torch.kernels.rf_map.ref import rf_map_ref, rf_weights

D_IN, D_OUT = 440, 10_000
ERR_ROWS = 131_072
REPS = 3

_EPILOGUE = "  auto epilogue = [&](int s, int64_t m0, int64_t c0) {\n"
# name -> ([(file, old text, new text), ...], column tile, checked)
VARIANTS = {
    "as_is": ([], 160, True),
    "tile128": ([("rf_map.cu", "constexpr int NT = 20;",
                  "constexpr int NT = 16;")], 128, True),
    "rows_fastest": ([("rf_map.cu",
                       "    m0 = tile / col_tiles * BM;\n"
                       "    c0 = tile % col_tiles * BN;",
                       "    m0 = tile % ((n + BM - 1) / BM) * BM;\n"
                       "    c0 = tile / ((n + BM - 1) / BM) * BN;")],
                     160, True),
    "cos_unrolled": ([("rf_map.cu",
                       "#pragma unroll 1\n"
                       "        for (int i = 0; i < 4; ++i) {",
                       "#pragma unroll\n"
                       "        for (int i = 0; i < 4; ++i) {")], 160, True),
    "rn_split": ([("tc_mma.cuh",
                   "  hi = __float_as_uint(x) & TF32_MASK;\n"
                   "  lo = __float_as_uint(x - __uint_as_float(hi)) & "
                   "TF32_MASK;",
                   '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));\n'
                   '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo)\n'
                   '      : "f"(x - __uint_as_float(hi)));')], 160, True),
    "products_only": ([("rf_map.cu", _EPILOGUE,
                        _EPILOGUE + "    {\n      float sum = 0.f;\n"
                        "#pragma unroll\n"
                        "      for (int i = 0; i < 4 * NT; ++i) "
                        "sum += acc[i];\n"
                        "      if (sum == 1234.5f) z[m0 + c0] = sum;\n"
                        "      return;\n    }\n")], 160, False),
}


def variant_sources(name: str) -> dict:
    """{file name: text} of the csrc files a variant changes, substituted;
    raises if a substitution no longer matches the sources."""
    out = {}
    for fname, old, new in VARIANTS[name][0]:
        text = out.get(fname, (build.CSRC / fname).read_text())
        if old not in text:
            raise ValueError(f"variant {name}: {fname} no longer holds "
                             f"{old!r}")
        out[fname] = text.replace(old, new)
    return out


def build_variants(names) -> dict:
    """Build each variant from a copy of csrc with its substitutions, one
    nvcc each, all at once; returns {name: (library, ptxas lines)}."""
    root = build.BUILD_DIR / "variants"
    procs = {}
    for name in names:
        src = root / name
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(build.CSRC, src)
        for fname, text in variant_sources(name).items():
            (src / fname).write_text(text)
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-o", str(src / "lib.so"),
               str(src / "rf_map.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    out = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise build.KernelBuildError(f"variant {name}:\n{log}")
        lib = ctypes.CDLL(str(root / name / "lib.so"))
        entry, argtypes = build.SIGNATURES["rf_map"]
        getattr(lib, entry).argtypes = argtypes
        getattr(lib, entry).restype = ctypes.c_int
        ptxas = sorted({ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill stores" in ln})
        out[name] = (lib, ptxas)
    return out


def use(name: str, libs: dict) -> None:
    """Route the rf_map wrapper to a variant's library."""
    build._loaded["rf_map"] = libs[name][0]
    rf_launcher.COLUMN_TILE = VARIANTS[name][1]


def time_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / REPS


def check(gen) -> None:
    """The kernel against the plain version at small shapes, fp32 and
    bf16, within the JAX tests' rule |got - want| <= tol (1 + |want|)."""
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        for n, d, dd in ((512, 440, 1024), (100, 33, 77), (257, 440, 10_000)):
            x = torch.randn(n, d, generator=gen).to("cuda", dtype)
            w, b = (torch.from_numpy(v).cuda()
                    for v in rf_weights(d, dd, 2.0, 1))
            want = rf_map_ref(x, w, b)
            err = (rf_map_apply(x, w, b) - want).abs()
            if not bool((err <= tol * (1 + want.abs())).all()):
                raise AssertionError(f"{dtype} {(n, d, dd)}: max err "
                                     f"{float(err.max()):.3e}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1_048_576)
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("rf_map_variants needs a CUDA card")
    libs = build_variants(args.variants)
    mine = build.load("rf_map")
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn((args.rows, D_IN), generator=gen, device="cuda")
    wn, bn = rf_weights(D_IN, D_OUT, math.sqrt(D_IN), 0)
    w, b = torch.from_numpy(wn).cuda(), torch.from_numpy(bn).cuda()
    rows = min(args.rows, ERR_ROWS)
    want = torch.cos(x[:rows].double() @ w.double() + b.double()) * \
        math.sqrt(2.0 / D_OUT)
    plain = rf_map_ref(x[:rows], w, b).double() - want
    print(json.dumps({"variant": "plain version (cuBLAS SGEMM + cos)",
                      "float64_max_err": float(plain.abs().max()),
                      "float64_rms_err": float(plain.pow(2).mean().sqrt())}),
          flush=True)
    del plain
    for name in args.variants:
        use(name, libs)
        rec = {"variant": name, "ptxas": libs[name][1]}
        if VARIANTS[name][2]:
            check(torch.Generator().manual_seed(0))
            e = rf_map_apply(x[:rows], w, b).double() - want
            rec.update(checked=True, float64_max_err=float(e.abs().max()),
                       float64_rms_err=float(e.pow(2).mean().sqrt()))
            del e
        print(json.dumps(rec), flush=True)
    del want
    torch.cuda.empty_cache()
    times = {}
    for _ in range(2):
        for name in args.variants:
            use(name, libs)
            times.setdefault(name, []).append(
                time_ms(lambda: rf_map_apply(x, w, b)))
        times.setdefault("addmm", []).append(
            time_ms(lambda: torch.addmm(b, x, w)))
    build._loaded["rf_map"] = mine
    rf_launcher.COLUMN_TILE = VARIANTS["as_is"][1]
    print(json.dumps({"shape": [args.rows, D_IN, D_OUT], "ms": times,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
