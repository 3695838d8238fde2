"""The backward kernels' quick card check: build the port's kernels, hold
``swa_bwd`` (with the forward's lse) and the reverse ``lru_scan`` against
their plain versions at the JAX kernel tests' sweep shapes and at the
training shapes of ``chip_smoke.py``'s ``phase_train``, and time both
there. A chip call of about two minutes for work on these two kernels,
where ``chip_smoke.py`` takes ten.

  python -m repro_torch.launch.backward_check          # needs a CUDA card

Prints swa_bwd's ptxas report (registers and spills of each kernel
instantiation), one JSON line per
case (the worst error over max |want| of each gradient, in bf16 also
RMS(err) over RMS(want), the lse error) and one line of mean milliseconds
at the training shapes, with scaled_dot_product_attention's backward on
the same operands (the yardstick, never the port's path) and swa_bwd's
bound, swa_bwd's time with a kv head's query heads split over 1, 2, 4
and 8 dK/dV blocks (the wrapper's ``KV_SPLITS``, 4), and each of
swa_bwd's kernels' device milliseconds a call, from ``torch.profiler``;
exits non-zero when a case is past its tolerance (2e-5 of max
|want| in fp32; in bf16 3e-2 of max |want| and 5e-3 of RMS(want), as
``chip_smoke.py``'s GRAD_TOL and GRAD_RMS_TOL; lru_scan's reverse 1e-5
absolute plus relative).
"""
from __future__ import annotations

import argparse
import json
import re
import sys
import time

import torch

from repro_torch.common.device import explicit_device
from repro_torch.kernels import build
from repro_torch.kernels.lru_scan.ops import lru_scan, lru_scan_reverse
from repro_torch.kernels.lru_scan.ref import lru_scan_reverse_ref
from repro_torch.kernels.swa import swa as swa_launcher
from repro_torch.kernels.swa.ops import swa_backward, swa_forward
from repro_torch.kernels.swa.ref import swa_backward_ref, swa_forward_ref

SWA_CASES = [  # (B, H, K, S, D, window): the JAX sweep, edges, training
    (2, 4, 2, 128, 32, 32), (2, 4, 2, 256, 32, 96), (2, 4, 2, 200, 32, 48),
    (2, 4, 1, 192, 32, 64), (2, 4, 2, 128, 32, 1000), (2, 4, 1, 300, 64, 100),
    (2, 4, 1, 300, 128, 100), (2, 4, 1, 300, 256, 100),
    # the bf16 dK/dV kernel's head splits (16 heads in 4, 6 in 3, one
    # head a kv head), S off the 64-row tile, a window of three keys
    (2, 16, 1, 300, 256, 100), (2, 6, 1, 130, 64, 3), (1, 4, 2, 70, 128, 1000),
    (2, 2, 2, 200, 64, 50),
    (1, 16, 1, 4096, 256, 2048)]
LRU_CASES = [(2, 64, 128), (1, 100, 96), (3, 128, 512), (1, 1, 64),
             (3, 77, 100), (2, 300, 33), (2, 4096, 4096)]
TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
RMS_TOL = {torch.bfloat16: 5e-3}
# H100 SXM bf16 dense tensor-core peak and HBM3 rate, for swa_bwd's bound
BF16_FLOPS, HBM_BYTES_PER_S = 989e12, 3.35e12


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


def ptxas_report(log: str) -> dict:
    """``kernel<args>`` -> "N registers[, S bytes spill stores]" from
    ptxas's -v output, one entry per instantiation."""
    out, name = {}, None
    types = {"13__nv_bfloat16": "bf16", "f": "float"}
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            # <len>swa_bwd_name, then I <type>? (Li<D>E)? E for a template
            t = re.search(r"\d+(swa_bwd_[a-z_]+)(I(13__nv_bfloat16|f)?"
                          r"(?:Li(\d+)E)?E)?", m.group(1))
            args = [types.get(a, a) for a in (t.group(3), t.group(4))
                    if a] if t else []
            name = (t.group(1) if t else m.group(1)) + (
                "<" + ", ".join(args) + ">" if args else "")
            out[name] = []
        elif name and "spill stores" in ln:
            out[name].append(ln.strip().split(", ")[1])
        elif name and "Used" in ln and "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            out[name].insert(0, f"{regs} registers")
    return {k: ", ".join(v) for k, v in out.items()}


def profile_bwd(fn, reps: int = 3) -> dict:
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = explicit_device(ap.parse_args(argv).device,
                          "repro_torch.launch.backward_check")
    if dev.type != "cuda":
        raise SystemExit("backward_check times kernels: it needs cuda")
    t0 = time.perf_counter()
    build.build_all()
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    if "swa_bwd" in build.build_log:
        print(json.dumps({"swa_bwd_ptxas": ptxas_report(
            build.build_log["swa_bwd"]["ptxas"])}), flush=True)
    gen = torch.Generator(dev).manual_seed(0)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def rel(got, want):
        return float((got.float() - want.float()).abs().max()
                     / want.float().abs().max().clamp_min(1e-30))

    def rms(got, want):
        err = got.double() - want.double()
        return float(err.pow(2).mean().sqrt()
                     / want.double().pow(2).mean().sqrt().clamp_min(1e-300))

    ok = True
    for dt in (torch.float32, torch.bfloat16):
        for b, h, kh, s, d, w in SWA_CASES:
            q, k, v, dout = (rn(b, s, n, d).to(dt).transpose(1, 2)
                             for n in (h, kh, kh, h))
            o, lse = swa_forward(q, k, v, w, with_lse=True)
            want_lse = swa_forward_ref(q.float(), k.float(), v.float(),
                                       w)[1]
            got = swa_backward(q, k, v, o, lse, dout, window=w)
            want = swa_backward_ref(q.float(), k.float(), v.float(),
                                    o.float(), lse, dout.float(), w)
            rec = {"kernel": "swa_bwd", "dtype": str(dt),
                   "shape": [b, h, kh, s, d, w],
                   "lse": float((lse - want_lse).abs().max()),
                   **{n: rel(g, x) for n, g, x in
                      zip(("dq", "dk", "dv"), got, want)}}
            rec["ok"] = all(rec[n] <= TOL[dt] for n in ("dq", "dk", "dv"))
            if dt in RMS_TOL:
                rec.update({f"rms_{n}": rms(g, x) for n, g, x in
                            zip(("dq", "dk", "dv"), got, want)})
                rec["ok"] &= all(rec[f"rms_{n}"] <= RMS_TOL[dt]
                                 for n in ("dq", "dk", "dv"))
            ok &= rec["ok"]
            print(json.dumps(rec), flush=True)
        for b, s, w in LRU_CASES:
            a = torch.sigmoid(rn(b, s, w)).to(dt)
            x = (0.1 * rn(b, s, w)).to(dt)
            h0 = rn(b, w)
            got, want = lru_scan_reverse(a, x, h0), \
                lru_scan_reverse_ref(a, x, h0)
            err = float((got - want).abs().max())
            rec = {"kernel": "lru_scan_reverse", "dtype": str(dt),
                   "shape": [b, s, w], "max_abs_err": err,
                   "ok": err <= 1e-5 * (1 + float(want.abs().max()))}
            ok &= rec["ok"]
            print(json.dumps(rec), flush=True)

    b, h, kh, s, d, w = 2, 16, 1, 4096, 256, 2048
    q, k, v, dout = (rn(b, s, n, d).bfloat16().transpose(1, 2)
                     for n in (h, kh, kh, h))
    o, lse = swa_forward(q, k, v, w, with_lse=True)
    pos = torch.arange(s, device=dev)
    band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - w)
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
    lib_out = torch.nn.functional.scaled_dot_product_attention(
        ql, kl.expand(b, h, s, d), vl.expand(b, h, s, d), attn_mask=band)
    # five band products of 2 D flops per (query, visible key) pair,
    # against reading q, k, v, o, dO, lse and writing dq, dk, dv once
    visible = sum(min(i + 1, w) for i in range(s))
    nbytes = 2.0 * (3 * b * h * s * d + 2 * b * kh * s * d) + 4.0 * b * h * s \
        + 2.0 * (b * h * s * d + 2 * b * kh * s * d)
    bound = max(10.0 * b * h * d * visible / BF16_FLOPS,
                nbytes / HBM_BYTES_PER_S) * 1e3
    a = torch.sigmoid(rn(2, 4096, 4096))
    g = rn(2, 4096, 4096)
    zero = torch.zeros(2, 4096, device=dev)
    print(json.dumps({
        "swa_bwd_ms": _ms(lambda: swa_backward(q, k, v, o, lse, dout,
                                               window=w), 3),
        "sdpa_bwd_ms": _ms(lambda: torch.autograd.grad(
            lib_out, (ql, kl, vl), dout, retain_graph=True), 3),
        "swa_bwd_bound_ms": bound,
        "swa_fwd_with_lse_ms": _ms(lambda: swa_forward(q, k, v, w, True), 3),
        "lru_scan_reverse_ms": _ms(lambda: lru_scan_reverse(a, g, zero), 20),
        "lru_scan_ms": _ms(lambda: lru_scan(a, g, zero), 20),
        "device": torch.cuda.get_device_name(dev)}), flush=True)
    by_splits = {}
    chosen = swa_launcher.KV_SPLITS
    try:
        for n in (1, 2, 4, 8):
            swa_launcher.KV_SPLITS = n
            by_splits[n] = _ms(lambda: swa_backward(q, k, v, o, lse, dout,
                                                    window=w), 5)
    finally:
        swa_launcher.KV_SPLITS = chosen
    print(json.dumps({"swa_bwd_ms_by_kv_splits": by_splits}), flush=True)
    print(json.dumps({"swa_bwd_kernels_ms": profile_bwd(
        lambda: swa_backward(q, k, v, o, lse, dout, window=w))}), flush=True)
    print("ALL_OK" if ok else "FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
