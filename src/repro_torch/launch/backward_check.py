"""The backward kernels' quick card check: build the kernels it checks,
hold ``swa_bwd`` (with the forward's lse and fp32 output) and
``lru_scan`` (both directions, the reverse with its fused da) against
their plain versions at the JAX kernel tests' sweep shapes and at the
training shapes of ``chip_smoke.py``'s ``phase_train``, and time both
there. A chip call of about two minutes for work on these two kernels,
where ``chip_smoke.py`` takes ten; ``--only`` checks one of them alone.

  python -m repro_torch.launch.backward_check [--only swa_bwd|lru_scan|prefix|time]

Prints the ptxas report of each kernel it built (registers and spills of
each instantiation), one JSON line per case (for swa_bwd the worst error
over max |want| of each gradient, in bf16 also RMS(err) over RMS(want),
the lse error; for lru_scan each output's max error and whether its bits
equal ``lru_scan_chunked_ref``'s and a second launch's), the scan's sweep
(``LRU_SWEEP``: each direction, the fused adjoint and the unfused
yardstick beside their byte bounds and the copy ceiling), one line of
mean milliseconds at the
training shapes, with scaled_dot_product_attention's backward on the same
operands (the yardstick, never the port's path) and swa_bwd's bound,
swa_bwd's time with a kv head's query heads split over 1, 2, 4 and 8
dK/dV blocks (the wrapper's ``KV_SPLITS``, 4), and each of swa_bwd's
kernels' device milliseconds a call, from ``torch.profiler``; exits
non-zero when a case is past its tolerance (2e-5 of max |want| in fp32;
in bf16 3e-2 of max |want| and 5e-3 of RMS(want), as ``chip_smoke.py``'s
GRAD_TOL and GRAD_RMS_TOL; lru_scan 1e-5 (fp32) or 3e-2 (bf16) absolute
plus relative) or its bits differ.

``--only time`` times swa_bwd at ``TIME_SHAPES``, the five shapes that
training gives it (``time_shape``: bf16, each against the plain backward
at the GRAD_TOL and GRAD_RMS_TOL limits, with SDPA's backward, the bound,
each kernel's device milliseconds from ``torch.profiler`` and the host's
microseconds a call), and the fp32 route once with fp32 inputs at
Whisper's encoder shape. It uses the package's public functions only, so
the same file also times an older tree of the package put first on
PYTHONPATH (a parent commit, in turns with the change):

  PYTHONPATH=<parent>/src python src/repro_torch/launch/backward_check.py --only time

``--only prefix`` asks where D = rowsum(dO o) from a bf16 o would take
swa_bwd with a bidirectional prefix (ROADMAP B.7) at whisper-medium's
encoder (``d_from_bf16``): each encoder layer's q, k, v and output
gradient from one step of the full model (seed 0, bf16), the kernel's
dQ, dK, dV from the bf16 o (widened to fp32 here) and from the fp32 o
that training passes, each by its distance from the fp32 plain backward
over the gradient's norm. The prefix sweep is the card test
``test_cuda_swa_backward_with_a_prefix_matches_its_plain_version``; the
training shapes' times are ``chip_smoke.py``'s ``check_prefix_shapes``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import re
import sys
import time

import torch

from repro_torch.common.config import H100
from repro_torch.common.device import explicit_device
from repro_torch.kernels import build
from repro_torch.kernels.lru_scan.lru_scan import CHUNK, WARPS
from repro_torch.kernels.lru_scan.ops import lru_scan, lru_scan_reverse
from repro_torch.kernels.lru_scan.ref import lru_scan_chunked_ref, \
    lru_scan_ref, lru_scan_reverse_ref
from repro_torch.kernels.swa import swa as swa_launcher
from repro_torch.kernels.swa.ops import swa_backward, swa_forward
from repro_torch.kernels.swa.ref import swa_backward_ref, swa_forward_ref
from repro_torch.launch.forward_check import visible_pairs

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
# the scan's timing sweep, fp32: batch at the model's width and S = 4,096
# (serving's B = 4, training's B = 2), and one long prompt
LRU_SWEEP = [(1, 4096, 4096), (2, 4096, 4096), (4, 4096, 4096),
             (8, 4096, 4096), (1, 16384, 4096)]
# (name, B, H, K, S, D, window, prefix): swa_bwd's shapes in training
TIME_SHAPES = (
    ("recurrentgemma-train", 2, 16, 1, 4096, 256, 2048, 0),
    ("paligemma-prefix", 4, 8, 1, 768, 256, 768, 256),
    ("whisper-encoder", 4, 16, 16, 1500, 64, 1500, 1500),
    ("lm-100m-example", 8, 12, 12, 256, 64, 256, 0),
    ("whisper-decoder-self", 4, 16, 16, 448, 64, 448, 0),
)
TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
RMS_TOL = {torch.bfloat16: 5e-3}
# H100 SXM bf16 dense tensor-core and fp32 CUDA-core peaks and HBM3 rate,
# for swa_bwd's bound
BF16_FLOPS, FP32_FLOPS, HBM_BYTES_PER_S = H100.peak_flops, \
    H100.fp32_flops, H100.hbm_bw

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


def _host_us(fn, reps: int = 20) -> float:
    """Host microseconds a call of ``fn`` takes to enqueue its work (the
    launches return before the card runs them); where it passes the
    card's time a call, event timings measure the host."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def ptxas_report(log: str) -> dict:
    """``kernel<args>`` -> "N registers[, S bytes spill stores]" from
    ptxas's -v output, one entry per instantiation."""
    out, name = {}, None
    types = {"13__nv_bfloat16": "bf16", "f": "float"}
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            # <len>swa_bwd_name, then I <type>? (Li<D>E)? E for a template
            t = re.search(r"\d+(swa_bwd_[a-z_]+)(I((?:13__nv_bfloat16|f)*)"
                          r"(?:Li(\d+)E)?E)?", m.group(1))
            args = re.findall(r"13__nv_bfloat16|f", t.group(3) or "") + \
                [t.group(4)] if t else []
            args = [types.get(a, a) for a in args if a]
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


def lru_case(a, x, h0) -> dict:
    """Both directions of the scan on one input: the forward and the
    reverse (with da from the forward's states) against their plain
    versions, within 1e-5 (fp32) or 3e-2 (bf16) absolute plus relative;
    the same bits as ``lru_scan_chunked_ref`` at the launcher's CHUNK and
    WARPS; and the same bits from a second launch."""
    tol = 1e-5 if a.dtype == torch.float32 else 3e-2
    hs = lru_scan(a, x, h0)
    lam, da = lru_scan_reverse(a, x, h0, h=hs, h_init=h0)
    got = {"h": hs, "lambda": lam, "da": da}
    want = dict(zip(("lambda", "da"),
                    lru_scan_reverse_ref(a, x, h0, hs, h0)))
    want["h"] = lru_scan_ref(a, x, h0)
    emul = dict(zip(("lambda", "da"), lru_scan_chunked_ref(
        a, x, h0, CHUNK, WARPS, reverse=True, h=hs, h_init=h0)))
    emul["h"] = lru_scan_chunked_ref(a, x, h0, CHUNK, WARPS)
    again = (lru_scan(a, x, h0),) + lru_scan_reverse(a, x, h0, h=hs,
                                                      h_init=h0)
    rec = {"dtype": str(a.dtype), "shape": list(a.shape), "ok": True}
    for (n, g), second in zip(got.items(), again):
        w = want[n]
        err = float((g - w).abs().max())
        rec[n] = {"max_abs_err": err,
                  "emulated_bits": bool(torch.equal(g, emul[n])),
                  "repeat_bits": bool(torch.equal(g, second))}
        rec["ok"] &= (err <= tol * (1 + float(w.abs().max()))
                      and rec[n]["emulated_bits"] and rec[n]["repeat_bits"])
    return rec


def lru_sweep(rn) -> list[dict]:
    """The scan at ``LRU_SWEEP``'s fp32 shapes, mean ms over 20 launches:
    the forward and the reverse, each with its rate and share of the byte
    bound (12 bytes an element: a and b read, the states written); the
    fused adjoint (the reverse that also reads h and writes da, 20 bytes
    an element) and, beside it, the unfused yardstick (the reverse, then
    a concatenation and a multiply); and the copy ceiling, a
    ``torch.add`` that moves the scan's 12 bytes an element. Each with
    the host's microseconds a call and, but for the unfused yardstick,
    the longest kernel's device ms from ``torch.profiler``."""
    out = []
    for b, s, w in LRU_SWEEP:
        a = torch.sigmoid(rn(b, s, w))
        g = rn(b, s, w)
        h0 = torch.zeros(b, w, device=a.device)
        hs = lru_scan(a, g, h0)
        o = torch.empty_like(a)
        scan_bytes = 4.0 * (3 * b * s * w + b * w)
        adj_bytes = 4.0 * (5 * b * s * w + 2 * b * w)

        def unfused():
            lam = lru_scan_reverse(a, g, h0)
            return lam * torch.cat([h0[:, None], hs[:, :-1]], dim=1)

        rec = {"lru_sweep": [b, s, w]}
        for name, fn, nbytes in (
                ("lru_scan", lambda: lru_scan(a, g, h0), scan_bytes),
                ("lru_scan_reverse", lambda: lru_scan_reverse(a, g, h0),
                 scan_bytes),
                ("adjoint", lambda: lru_scan_reverse(a, g, h0, h=hs,
                                                     h_init=h0), adj_bytes),
                ("unfused_adjoint", unfused, adj_bytes),
                ("copy_ceiling", lambda: torch.add(a, g, out=o),
                 scan_bytes)):
            ms = _ms(fn, 20)
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            rec[name] = {"ms": ms, "bound_ms": bound,
                         "GB_s": nbytes / ms / 1e6, "share": bound / ms,
                         "host_us": _host_us(fn)}
            if name != "unfused_adjoint":
                # the kernel's own device time, without the host's gaps
                rec[name]["device_ms"] = max(profile_bwd(fn).values())
        out.append(rec)
        print(json.dumps(rec), flush=True)
        del a, g, h0, hs, o
        torch.cuda.empty_cache()
    return out


def _rel_norm(got, want) -> float:
    """||got - want|| / ||want||, in float64."""
    want = want.double()
    return float(torch.linalg.norm(got.double() - want)
                 / torch.linalg.norm(want).clamp_min(1e-300))


def d_from_bf16(dev) -> dict:
    """Where D = rowsum(dO o) from the bf16 output takes the gradients at
    whisper-medium's encoder: one loss and backward of the full model
    (seed 0, bf16, B = 4, 1,500 frames, 448 tokens, no remat) records each
    encoder layer's q, k, v (4 x 16 x 1,500 x 64) and its output's
    gradient; then, per layer, the kernel's dQ, dK, dV from the bf16 o
    and from the fp32 o, each as its distance from the fp32 plain
    backward (fp32 copies of the same q, k, v, dO) over the gradient's
    norm. Prints one line: each plan's worst over the layers, and every
    layer's."""
    from repro_torch.common.config import ShapeConfig
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM, to_device
    from repro_torch.models.model import build_model
    from repro_torch.nn import attention as attention_mod
    from repro_torch.train.loop import value_and_grad
    from repro_torch.train.optim import master_params
    cfg = dataclasses.replace(get_config("whisper-medium"), remat="none")
    model = build_model(cfg, device=dev,
                        generator=torch.Generator(dev).manual_seed(0))
    batch = to_device(SyntheticLM(cfg, ShapeConfig("t", 448, 4, "train"),
                                  seed=0).batch(0), dev)
    seen = []
    real = attention_mod.swa_attention

    def record(q, k, v, *, window, prefix):
        out = real(q, k, v, window=window, prefix=prefix)
        if prefix == q.shape[2] and out.requires_grad:
            rec = {"q": q.detach(), "k": k.detach(), "v": v.detach()}
            out.register_hook(lambda g: rec.update(dout=g.detach()))
            seen.append(rec)
        return out
    attention_mod.swa_attention = record
    try:
        value_and_grad(model, master_params(model), batch, cast_params=True)
    finally:
        attention_mod.swa_attention = real
    del model, batch
    torch.cuda.empty_cache()
    layers = []
    for rec in seen:
        q, k, v, dout = rec["q"], rec["k"], rec["v"], rec["dout"]
        s = q.shape[2]
        qf, kf, vf = q.float(), k.float(), v.float()
        of, lf = swa_forward_ref(qf, kf, vf, s, s)
        want = swa_backward_ref(qf, kf, vf, of, lf, dout.float(), s, s)
        o, lse, o32 = swa_forward(q, k, v, s, True, s)
        layer = {}
        for plan, out in (("bf16_o", o.float()), ("fp32_o", o32)):
            got = swa_backward(q, k, v, out, lse, dout, window=s, prefix=s)
            layer[plan] = {n: _rel_norm(g, w) for n, g, w in
                           zip(("dq", "dk", "dv"), got, want)}
        layers.append(layer)
        del qf, kf, vf, of, lf, want, got
        torch.cuda.empty_cache()
    worst = {plan: {n: max(x[plan][n] for x in layers)
                    for n in ("dq", "dk", "dv")}
             for plan in ("bf16_o", "fp32_o")}
    rec = {"d_from_bf16": {"shape": list(seen[0]["q"].shape),
                           "layers": len(layers), "worst": worst,
                           "per_layer": layers},
           "device": torch.cuda.get_device_name(dev)}
    print(json.dumps(rec), flush=True)
    return rec


def _grad_errs(got, want, dt) -> dict:
    """Each gradient's max error over max |want| and, in bf16, RMS error
    over RMS(want), with ``ok`` at the module's limits."""
    rec = {}
    ok = True
    for n, g, w in zip(("dq", "dk", "dv"), got, want):
        rec[n] = float((g.float() - w).abs().max()
                       / w.abs().max().clamp_min(1e-30))
        ok &= bool(torch.isfinite(g).all()) and rec[n] <= TOL[dt]
        if dt in RMS_TOL:
            err = g.double() - w.double()
            rec[f"rms_{n}"] = float(err.pow(2).mean().sqrt() / w.double().pow(
                2).mean().sqrt().clamp_min(1e-300))
            ok &= rec[f"rms_{n}"] <= RMS_TOL[dt]
    rec["ok"] = ok
    return rec


def time_shape(rn, name, b, h, kh, s, d, window, prefix, reps: int = 20,
               dt=torch.bfloat16) -> dict:
    """swa_bwd at one shape on (B, S, H, D) views: its gradients against
    the plain backward on fp32 copies, its mean ms over ``reps`` calls
    (CUDA events), each kernel's device ms a call (``torch.profiler``)
    and the host µs a call takes to enqueue; beside it, in bf16, the
    backward of one scaled_dot_product_attention call on the same
    operands (k and v repeated to the query heads; causal at window = S
    without a prefix, none at prefix = S, else the mask as a bool mask),
    by events, host µs and the device ms of its kernels,
    and the bound: five band products of 2 D flops per visible pair at
    the bf16 rate (fp32: the CUDA cores' 67 TFLOP/s), or reading q, k, v,
    the fp32 o, dO and lse and writing the three gradients once."""
    F = torch.nn.functional
    q, k, v, dout = (rn(b, s, n, d).to(dt).transpose(1, 2)
                     for n in (h, kh, kh, h))
    _, lse, o = swa_forward(q, k, v, window, with_lse=True, prefix=prefix)
    got = swa_backward(q, k, v, o, lse, dout, window=window, prefix=prefix)
    want = swa_backward_ref(q.float(), k.float(), v.float(), o, lse,
                            dout.float(), window, prefix)
    rec = {"shape": name, "dims": [b, h, kh, s, d, window, prefix],
           "dtype": str(dt).removeprefix("torch."),
           "err": _grad_errs(got, want, dt)}
    del got, want

    def call():
        return swa_backward(q, k, v, o, lse, dout, window=window,
                            prefix=prefix)
    rec["ms"] = _ms(call, reps)
    rec["host_us"] = _host_us(call)
    rec["kernels_ms"] = profile_bwd(call)
    rec["device_ms"] = sum(rec["kernels_ms"].values())
    item = 2 if dt == torch.bfloat16 else 4
    nbytes = item * (3 * b * h * s * d + 4 * b * kh * s * d) \
        + 4.0 * (b * h * s * d + b * h * s)
    flops = 10.0 * b * h * d * visible_pairs(s, window, prefix)
    rate = BF16_FLOPS if dt == torch.bfloat16 else FP32_FLOPS
    rec["bound_ms"] = max(flops / rate, nbytes / HBM_BYTES_PER_S) * 1e3
    rec["share"] = rec["bound_ms"] / rec["ms"]
    if dt == torch.bfloat16:
        ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
        kx, vx = (t.repeat_interleave(h // kh, dim=1) for t in (kl, vl))
        if prefix == s:
            out = F.scaled_dot_product_attention(ql, kx, vx)
        elif prefix == 0 and window >= s:
            out = F.scaled_dot_product_attention(ql, kx, vx, is_causal=True)
        else:
            pos = torch.arange(s, device=q.device)
            key, query = pos[None, :], pos[:, None]
            mask = ((key <= query) | ((key < prefix) & (query < prefix))) \
                & (key > query - window)
            out = F.scaled_dot_product_attention(ql, kx, vx, attn_mask=mask)

        def library():
            return torch.autograd.grad(out, (ql, kl, vl), dout,
                                       retain_graph=True)
        rec["sdpa_bwd_ms"] = _ms(library, reps)
        rec["sdpa_bwd_host_us"] = _host_us(library)
        # its kernels' device time: autograd's host work a call passes the
        # device's at every shape but the longest
        rec["sdpa_bwd_device_ms"] = sum(profile_bwd(library).values())
    rec["device"] = torch.cuda.get_device_name(q.device)
    return rec


def time_shapes(rn, reps: int) -> list[dict]:
    """``time_shape`` at every shape of TIME_SHAPES in bf16, and at
    Whisper's encoder in fp32 (the CUDA-core route), one JSON line
    each."""
    out = []
    for shape in TIME_SHAPES:
        out.append(time_shape(rn, *shape, reps=reps))
        print(json.dumps(out[-1]), flush=True)
        torch.cuda.empty_cache()
    enc = next(x for x in TIME_SHAPES if x[0] == "whisper-encoder")
    out.append(time_shape(rn, *enc, reps=3, dt=torch.float32))
    print(json.dumps(out[-1]), flush=True)
    torch.cuda.empty_cache()
    return out


def time_all(dev, reps: int) -> int:
    """``--only time``: build swa and swa_bwd, print swa_bwd's ptxas
    report (registers and spills of every instantiation, and any line
    that names a serialised wgmma), then ``time_shapes``."""
    t0 = time.perf_counter()
    build.build_all(("swa", "swa_bwd"))
    log = build.build_log.get("swa_bwd", {}).get("ptxas", "")
    print(json.dumps({
        "build_s": time.perf_counter() - t0,
        "device": torch.cuda.get_device_name(dev),
        "swa_bwd_ptxas": ptxas_report(log),
        "ptxas_warnings": [ln.strip() for ln in log.splitlines()
                           if "warning" in ln.lower()]}), flush=True)
    gen = torch.Generator(dev).manual_seed(0)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)
    ok = all(rec["err"]["ok"] for rec in time_shapes(rn, reps))
    print("ALL_OK" if ok else "FAILED", flush=True)
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--only", choices=("swa_bwd", "lru_scan", "prefix",
                                       "time"),
                    help="check and time one kernel family alone, "
                         "measure D from the bf16 o at whisper-medium's "
                         "encoder, or time swa_bwd at TIME_SHAPES alone")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    dev = explicit_device(args.device, "repro_torch.launch.backward_check")
    if dev.type != "cuda":
        raise SystemExit("backward_check times kernels: it needs cuda")
    if args.only == "time":
        return time_all(dev, args.reps)
    if args.only == "prefix":
        t0 = time.perf_counter()
        build.build_all(("swa", "swa_bwd"))
        print(json.dumps({"build_s": time.perf_counter() - t0,
                          "swa_bwd_ptxas": ptxas_report(
                              build.build_log.get("swa_bwd", {}).get(
                                  "ptxas", ""))}), flush=True)
        d_from_bf16(dev)
        return 0
    swa_on, lru_on = args.only != "lru_scan", args.only != "swa_bwd"
    t0 = time.perf_counter()
    build.build_all(("swa", "swa_bwd") * swa_on + ("lru_scan",) * lru_on)
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    for name in ("swa_bwd", "lru_scan"):
        if name in build.build_log:
            print(json.dumps({f"{name}_ptxas": ptxas_report(
                build.build_log[name]["ptxas"])}), flush=True)
    gen = torch.Generator(dev).manual_seed(0)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    ok = True
    for dt in (torch.float32, torch.bfloat16):
        for b, h, kh, s, d, w in SWA_CASES * swa_on:
            q, k, v, dout = (rn(b, s, n, d).to(dt).transpose(1, 2)
                             for n in (h, kh, kh, h))
            _, lse, o = swa_forward(q, k, v, w, with_lse=True)
            want_lse = swa_forward_ref(q.float(), k.float(), v.float(),
                                       w)[1]
            got = swa_backward(q, k, v, o, lse, dout, window=w)
            want = swa_backward_ref(q.float(), k.float(), v.float(),
                                    o, lse, dout.float(), w)
            rec = {"kernel": "swa_bwd", "dtype": str(dt),
                   "shape": [b, h, kh, s, d, w],
                   "lse": float((lse - want_lse).abs().max()),
                   **_grad_errs(got, want, dt)}
            ok &= rec["ok"]
            print(json.dumps(rec), flush=True)
        for b, s, w in LRU_CASES * lru_on:
            rec = {"kernel": "lru_scan", **lru_case(
                torch.sigmoid(rn(b, s, w)).to(dt),
                (0.1 * rn(b, s, w)).to(dt), rn(b, w))}
            ok &= rec["ok"]
            print(json.dumps(rec), flush=True)

    if lru_on:
        lru_sweep(rn)
    if not swa_on:
        print("ALL_OK" if ok else "FAILED", flush=True)
        return 0 if ok else 1
    ok &= all(rec["err"]["ok"] for rec in time_shapes(rn, args.reps))
    # the dK/dV kernel's head splits at the training shape
    b, h, kh, s, d, w = TIME_SHAPES[0][1:7]
    q, k, v, dout = (rn(b, s, n, d).bfloat16().transpose(1, 2)
                     for n in (h, kh, kh, h))
    _, lse, o = swa_forward(q, k, v, w, with_lse=True)
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
    print("ALL_OK" if ok else "FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
