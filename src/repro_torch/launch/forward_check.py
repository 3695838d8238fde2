"""swa's forward on the card, quickly: build the kernel alone, hold its
bf16 route against the plain version over the tile edges, and time it at
the six shapes the main path gives it, beside one
``scaled_dot_product_attention`` call and the bound. A chip call of one
to two minutes for work on ``csrc/swa.cu``, where ``chip_smoke.py`` takes
ten.

  python -m repro_torch.launch.forward_check [--only sweep|time] [--reps N]

Prints the ptxas report of each instantiation it built (registers,
spills), one JSON line per sweep case (bf16 and fp32 on (B, S, H, D)
views: the worst error over the bf16 limit, lse's and the fp32 output's
max error, whether two launches gave the same bits) and one per timed
shape (mean milliseconds over ``--reps`` launches after a warm-up, with
the library call's, the bound, each kernel's device milliseconds a call
from ``torch.profiler`` (the v preparation kernels apart from the
attention kernel) and the host microseconds a call takes to enqueue). Exits non-zero when a case is past its limit or two
launches differ.

The limit is chip_smoke.py's: bf16 within LIMIT_RTOL of |want| plus
LIMIT_ATOL_RMS of the output's RMS (its SWA_RTOL and SWA_ATOL_RMS), fp32
within 2e-5 of max |want|, lse within 2e-5 of max |lse|. The script uses the
package's public functions only, so it also times an older tree of the
package put first on PYTHONPATH (a parent commit, in turns with the
change)."""
from __future__ import annotations

import argparse
import json
import re
import sys
import time

import torch

from repro_torch.common.config import H100
from repro_torch.common.device import explicit_device
from repro_torch.kernels import build
from repro_torch.kernels.swa.ops import swa_attention, swa_forward
from repro_torch.kernels.swa.ref import swa_forward_ref, swa_ref

LIMIT_RTOL = 2.0 ** -7     # chip_smoke.SWA_RTOL
LIMIT_ATOL_RMS = 1e-2      # chip_smoke.SWA_ATOL_RMS
FP32_TOL = 2e-5
# H100 SXM bf16 dense tensor-core peak and HBM3 rate
BF16_FLOPS, HBM_BYTES_PER_S = H100.peak_flops, H100.hbm_bw
HEAD_DIMS = (32, 64, 128, 256)


def edge_cases() -> list[tuple]:
    """(B, H, K, S, D, window, prefix) at every head dim: S around the
    128-query and 128-key tiles (1, 127, 128, 129, 300) at windows around
    them (1, 63, 127, 129, S); prefixes of 1, 127, 129 and S at S = 300,
    window S and 63; GQA groups of 1, 4, 7 and 16 at S = 300."""
    out = []
    for d in HEAD_DIMS:
        for s in (1, 127, 128, 129, 300):
            for w in (1, 63, 127, 129, s):
                out.append((2, 8, 2, s, d, w, 0))
        for prefix in (1, 127, 129, 300):
            for w in (300, 63):
                out.append((2, 4, 1, 300, d, w, prefix))
        for h, kh in ((4, 4), (8, 2), (14, 2), (16, 1)):
            out.append((1, h, kh, 300, d, 300, 0))
    return out


# (name, B, H, K, S, D, window, prefix): the main path's shapes
MAIN_SHAPES = (
    ("recurrentgemma-9b", 4, 16, 1, 4096, 256, 2048, 0),
    ("qwen3-4b", 4, 32, 8, 4096, 128, 4096, 0),
    ("stablelm-1.6b", 1, 32, 32, 2048, 64, 2048, 0),
    ("yi-34b", 1, 56, 8, 2048, 128, 2048, 0),
    ("paligemma-3b", 4, 8, 1, 768, 256, 768, 256),
    ("whisper-medium-encoder", 4, 16, 16, 1500, 64, 1500, 1500),
)


def limit_ratio(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over the bf16 limit (chip_smoke.swa_excess)."""
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    err = (got.float() - want).abs()
    atol = LIMIT_ATOL_RMS * float(want.pow(2).mean().sqrt())
    return float((err / (atol + LIMIT_RTOL * want.abs())).max())


def visible_pairs(s: int, window: int, prefix: int) -> int:
    """(query, key) pairs the mask shows."""
    pos = torch.arange(s)
    key, query = pos[None, :], pos[:, None]
    ok = (key <= query) | ((key < prefix) & (query < prefix))
    return int((ok & (key > query - window)).sum())


def entry_name(mangled: str) -> str:
    """``kernel<D>`` of a mangled kernel name in a namespace, D its
    head-dim template argument (a type argument before it dropped, a bool
    after it kept: ``kernel<D, true>``)."""
    i, names = 3, []
    while mangled.startswith("_ZN") and i < len(mangled) and \
            mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        names.append(mangled[j:j + int(mangled[i:j])])
        i = j + int(mangled[i:j])
    if not names:
        return mangled
    arg = re.match(r"I(?:f|13__nv_bfloat16)?Li(\d+)E(?:Lb([01])E)?",
                   mangled[i:])
    if not arg:
        return names[-1]
    flag = {"0": ", false", "1": ", true", None: ""}[arg.group(2)]
    return f"{names[-1]}<{arg.group(1)}{flag}>"


def ptxas_report(log: str) -> dict:
    """``kernel<D>`` -> "N registers[, S bytes spill stores]" from ptxas's
    -v output, one entry per instantiation."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = entry_name(m.group(1))
            out[name] = []
        elif name and "spill stores" in ln:
            out[name].append(ln.strip().split(", ")[1])
        elif name and "Used" in ln and "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            out[name].insert(0, f"{regs} registers")
    return {k: ", ".join(v) for k, v in out.items()}


def _ms(fn, reps: int) -> float:
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


def host_us(fn, reps: int = 20) -> float:
    """Host microseconds a call of ``fn`` takes to enqueue its work (the
    launches return before the card runs them); where it passes the
    card's time a call, event timings of back-to-back calls measure the
    host."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def kernels_ms(fn, reps: int = 5) -> dict:
    """Device milliseconds a call of each CUDA kernel ``fn`` launches,
    from ``torch.profiler`` over ``reps`` calls after a warm-up."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = ev.cuda_time_total
        if us > 0:
            out[ev.key[:60]] = us / 1e3 / reps
    return out


def check_case(rn, dt, b, h, kh, s, d, window, prefix) -> dict:
    """One sweep case on (B, S, H, D) views: the output of serving's
    launch and of training's (with lse and the fp32 output, where the bf16
    kernel splits P) against the plain version on fp32 copies, lse (its
    max error over max |lse|), and a second launch's bits."""
    q = rn(b, s, h, d).to(dt).transpose(1, 2)
    k, v = (rn(b, s, kh, d).to(dt).transpose(1, 2) for _ in range(2))
    got = swa_attention(q, k, v, window=window, prefix=prefix)
    again = swa_attention(q, k, v, window=window, prefix=prefix)
    out, lse, o32 = swa_forward(q, k, v, window, with_lse=True,
                                prefix=prefix)
    want, want_lse = swa_forward_ref(q.float(), k.float(), v.float(),
                                     window, prefix)
    rec = {"dtype": str(dt).removeprefix("torch."),
           "shape": [b, h, kh, s, d, window, prefix],
           "lse_err": float((lse - want_lse).abs().max()
                            / want_lse.abs().max().clamp_min(1e-30)),
           "o32_err": float((o32 - want).abs().max()),
           "same_bits": bool(torch.equal(got, again))}
    if dt == torch.bfloat16:
        # serving's output, and training's (P split in two parts) with its
        # fp32 output
        rec["over_limit"] = max(limit_ratio(t, want) for t in (got, out,
                                                               o32))
        ok = rec["over_limit"] <= 1.0
    else:
        rec["err"] = float((got - want).abs().max())
        ok = rec["err"] <= FP32_TOL * float(want.abs().max())
    rec["ok"] = bool(ok and rec["lse_err"] <= FP32_TOL and rec["same_bits"])
    return rec


def time_shape(rn, name, b, h, kh, s, d, window, prefix, reps) -> dict:
    """swa and its library yardstick at one main-path shape, bf16 (B, S,
    H, D) views: SDPA causal (k, v repeated to the query heads) at window
    = S without a prefix, non-causal at prefix = S, else with the mask as
    a bool mask."""
    F = torch.nn.functional
    q = rn(b, s, h, d).bfloat16().transpose(1, 2)
    k, v = (rn(b, s, kh, d).bfloat16().transpose(1, 2) for _ in range(2))
    want = swa_ref(q.float(), k.float(), v.float(), window, prefix).float()
    ratio = limit_ratio(swa_attention(q, k, v, window=window,
                                      prefix=prefix), want)
    del want
    kx, vx = (t.repeat_interleave(h // kh, dim=1) for t in (k, v))
    if prefix == s:
        def library():
            return F.scaled_dot_product_attention(q, kx, vx)
    elif prefix == 0 and window >= s:
        def library():
            return F.scaled_dot_product_attention(q, kx, vx, is_causal=True)
    else:
        pos = torch.arange(s, device=q.device)
        key, query = pos[None, :], pos[:, None]
        mask = ((key <= query) | ((key < prefix) & (query < prefix))) & \
            (key > query - window)

        def library():
            return F.scaled_dot_product_attention(q, kx, vx, attn_mask=mask)
    flops = 4.0 * b * h * d * visible_pairs(s, window, prefix)
    nbytes = 2.0 * 2 * (b * h * s * d + b * kh * s * d)
    return {
        "shape": name, "dims": [b, h, kh, s, d, window, prefix],
        "over_limit": ratio,
        "ms": _ms(lambda: swa_attention(q, k, v, window=window,
                                        prefix=prefix), reps),
        "with_lse_ms": _ms(lambda: swa_forward(q, k, v, window, True,
                                               prefix), reps),
        "library_ms": _ms(library, reps),
        "host_us": host_us(lambda: swa_attention(q, k, v, window=window,
                                                 prefix=prefix)),
        "library_host_us": host_us(library),
        "bound_ms": max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3,
        "kernels_ms": kernels_ms(lambda: swa_attention(
            q, k, v, window=window, prefix=prefix))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--only", choices=("sweep", "time"))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    dev = explicit_device(args.device, "repro_torch.launch.forward_check")
    if dev.type != "cuda":
        raise SystemExit("forward_check runs the kernels: it needs cuda")
    t0 = time.perf_counter()
    build.build_all(("swa",))
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "device": torch.cuda.get_device_name(dev),
                      "swa_ptxas": ptxas_report(build.build_log.get(
                          "swa", {}).get("ptxas", ""))}), flush=True)
    gen = torch.Generator(dev).manual_seed(0)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    ok = True
    if args.only != "time":
        n, bad = 0, 0
        for dt in (torch.bfloat16, torch.float32):
            for case in edge_cases():
                rec = check_case(rn, dt, *case)
                n += 1
                if not rec["ok"]:
                    bad += 1
                    print(json.dumps(rec), flush=True)
        print(json.dumps({"sweep_cases": n, "failed": bad}), flush=True)
        ok &= bad == 0
    if args.only != "sweep":
        for shape in MAIN_SHAPES:
            rec = time_shape(rn, *shape, reps=args.reps)
            ok &= rec["over_limit"] <= 1.0
            print(json.dumps(rec), flush=True)
            torch.cuda.empty_cache()
    print("ALL_OK" if ok else "FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
