"""The backward kernels' quick card check: build the port's kernels, hold
``swa_bwd`` (with the forward's lse) and the reverse ``lru_scan`` against
their plain versions at the JAX kernel tests' sweep shapes and at the
training shapes of ``chip_smoke.py``'s ``phase_train``, and time both
there. A chip call of about two minutes for work on these two kernels,
where ``chip_smoke.py`` takes ten.

  python -m repro_torch.launch.backward_check          # needs a CUDA card

Prints one JSON line per case (the worst error over max |want| of each
gradient, the lse error) and one line of mean milliseconds at the
training shapes; exits non-zero when a case is past its tolerance (2e-5
of max |want| in fp32, 3e-2 in bf16; lru_scan's reverse 1e-5 absolute
plus relative).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from repro_torch.common.device import explicit_device
from repro_torch.kernels import build
from repro_torch.kernels.lru_scan.ops import lru_scan, lru_scan_reverse
from repro_torch.kernels.lru_scan.ref import lru_scan_reverse_ref
from repro_torch.kernels.swa.ops import swa_backward, swa_forward
from repro_torch.kernels.swa.ref import swa_backward_ref, swa_forward_ref

SWA_CASES = [  # (B, H, K, S, D, window): the JAX sweep, edges, training
    (2, 4, 2, 128, 32, 32), (2, 4, 2, 256, 32, 96), (2, 4, 2, 200, 32, 48),
    (2, 4, 1, 192, 32, 64), (2, 4, 2, 128, 32, 1000), (2, 4, 1, 300, 64, 100),
    (2, 4, 1, 300, 128, 100), (2, 4, 1, 300, 256, 100),
    (1, 16, 1, 4096, 256, 2048)]
LRU_CASES = [(2, 64, 128), (1, 100, 96), (3, 128, 512), (1, 1, 64),
             (3, 77, 100), (2, 300, 33), (2, 4096, 4096)]
TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


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
    gen = torch.Generator(dev).manual_seed(0)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def rel(got, want):
        return float((got.float() - want.float()).abs().max()
                     / want.float().abs().max().clamp_min(1e-30))

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
    a = torch.sigmoid(rn(2, 4096, 4096))
    g = rn(2, 4096, 4096)
    zero = torch.zeros(2, 4096, device=dev)
    print(json.dumps({
        "swa_bwd_ms": _ms(lambda: swa_backward(q, k, v, o, lse, dout,
                                               window=w), 3),
        "swa_fwd_with_lse_ms": _ms(lambda: swa_forward(q, k, v, w, True), 3),
        "lru_scan_reverse_ms": _ms(lambda: lru_scan_reverse(a, g, zero), 20),
        "lru_scan_ms": _ms(lambda: lru_scan(a, g, zero), 20),
        "device": torch.cuda.get_device_name(dev)}), flush=True)
    print("ALL_OK" if ok else "FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
