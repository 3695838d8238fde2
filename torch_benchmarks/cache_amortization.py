"""Cache amortization: the repeated-tenant regime the content cache is for,
in the PyTorch port.

The paper's economics are about amortization — keep matrices engine-side
so repeated routines avoid re-crossing the bridge (§3.2); the Cray
deployment report (Rothauge et al., 2019) shows transfer dominating
whenever data re-crosses. This benchmark reproduces the *repeated-tenant*
case one level up: N clients submit the same overlapping SVD + CG + Gram
workload on content-identical matrices (think: a shared dataset, many
analysts).

* tenant 0 runs **cold**: full upload stream, every routine computed;
* tenants 1..N-1 run **warm**: their uploads content-dedup to handle
  aliases (zero-byte modeled crossings) and their routine calls hit the
  content-addressed cache (DONE-on-submit, no task minted).

Reported: cold vs warm per-tenant aggregate latency and the speedup,
dedup'd bytes, modeled socket seconds avoided, and the engine's cache
hit/miss accounting. The smoke configuration *asserts* the acceptance
bar — warm aggregate latency >= 5x better than cold, and the dedup
re-upload logging zero modeled socket bytes — and exits nonzero if
either fails, so CI catches a cache regression as a red build.

The engine's programs are built on same-shape, different-content
matrices first, so "cold" measures computation, not first-call builds —
the speedup claimed is the cache's.

Run: ``PYTHONPATH=src:. python torch_benchmarks/cache_amortization.py``
(``--device cpu`` on the CPU; ``--smoke`` for the CI-sized configuration;
``--bridge socket`` over TCP).
"""
from __future__ import annotations

import sys
import time

import numpy as np

from torch_benchmarks.common import header, parser, row
from repro_torch.core import AlchemistContext, AlchemistEngine
from repro_torch.core.libraries import elemental, skylark
from repro_torch.core.server import AlchemistServer

MIN_SPEEDUP = 5.0


def _tenant_workload(ac: AlchemistContext, x: np.ndarray, y: np.ndarray,
                     k: int) -> dict:
    """One tenant's session: upload the shared dataset, then the
    overlapping SVD / CG / Gram mix. Returns wall time and per-call
    cache observations."""
    t0 = time.perf_counter()
    al_x = ac.send_matrix(x)
    al_y = ac.send_matrix(y)
    svd = ac.call("elemental", "truncated_svd", A=al_x, k=k, oversample=8)
    cg = ac.call("skylark", "cg_solve", X=al_x, Y=al_y, lam=1e-3,
                 max_iters=60, tol=1e-8)
    gram = ac.call("elemental", "gram", A=al_x)
    wall = time.perf_counter() - t0
    return {
        "wall_s": wall,
        "hits": sum(r["_cache_hit"] for r in (svd, cg, gram)),
        "saved_s": sum(r["_saved_s"] for r in (svd, cg, gram)),
        "upload_recs": (al_x.last_transfer, al_y.last_transfer),
    }


def run(num_tenants: int, shape, k: int, smoke: bool,
        bridge: str = "inmemory", device: str = "cuda") -> dict:
    """Returns the measured figures and, under "ok", whether every smoke
    check held (True without ``smoke``)."""
    header("cache amortization: cold vs warm repeated-tenant workload")
    engine = AlchemistEngine(device=device)
    engine.load_library("elemental", elemental)
    engine.load_library("skylark", skylark)
    server = (AlchemistServer(engine=engine).start()
              if bridge == "socket" else None)

    def _ctx(name: str) -> AlchemistContext:
        if server is not None:
            return AlchemistContext(address=server.address,
                                    client_name=name)
        return AlchemistContext(engine=engine, client_name=name)

    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32)
    y = rng.randn(shape[0], 4).astype(np.float32)

    # build the engine's programs on different content (same shapes) so
    # the cold tenant below measures compute, not first-call builds
    warmup = _ctx("warmup")
    _tenant_workload(warmup, rng.randn(*shape).astype(np.float32),
                     rng.randn(shape[0], 4).astype(np.float32), k)

    cold_ac = _ctx("tenant-0")
    cold = _tenant_workload(cold_ac, x, y, k)
    # warm tenants' uploads must dedup: over the socket that means zero
    # further upload frames — only tiny alias-lookup probes cross
    upload_frames_cold = (server.wire_log.stat("upload").frames_in
                          if server else 0)
    warms = []
    for i in range(1, num_tenants):
        ac = _ctx(f"tenant-{i}")
        warms.append((ac, _tenant_workload(ac, x, y, k)))

    warm_walls = [w["wall_s"] for _, w in warms]
    warm_mean = float(np.mean(warm_walls)) if warm_walls else float("nan")
    speedup = cold["wall_s"] / warm_mean if warm_walls else float("nan")

    print(f"workload: truncated_svd(k={k}) + cg_solve + gram on "
          f"{shape[0]}x{shape[1]} f32, shared across {num_tenants} "
          f"tenants; bridge = {bridge}; device = {device}")
    row("cache/cold_tenant_s", cold["wall_s"] * 1e6,
        f"hits={cold['hits']} (must be 0)")
    row("cache/warm_tenant_mean_s", warm_mean * 1e6,
        f"tenants={len(warms)} "
        f"p_worst={max(warm_walls) * 1e6:.0f}us" if warm_walls else "")
    row("cache/warm_speedup", speedup,
        "cold aggregate / warm mean aggregate (x)")

    summary = engine.cache_log.summary()
    row("cache/hits", summary["hits"],
        f"misses={summary['misses']} hit_rate={summary['hit_rate']:.2f}")
    row("cache/saved_modeled_exec_s", summary["saved_s"] * 1e6,
        "execute seconds tenants did not wait for")
    row("cache/dedup_bytes_saved", summary["bytes_saved"],
        f"dedup_uploads={summary['dedup_uploads']}")

    # dedup proof: every warm upload logged a zero-byte, zero-second
    # modeled crossing
    dedup_ok = bool(warms)
    for ac, w in warms:
        for rec in w["upload_recs"]:
            if not (rec.dedup and rec.nbytes == 0
                    and rec.modeled_socket_s == 0.0
                    and rec.logical_nbytes > 0):
                dedup_ok = False
        tsum = engine.transfer_log.session_summary(ac.session)
        if tsum["to_engine_bytes"] != 0:
            dedup_ok = False
    warm_upload_bytes = sum(
        engine.transfer_log.session_summary(ac.session)["to_engine_bytes"]
        for ac, _ in warms)
    row("cache/warm_upload_modeled_bytes", warm_upload_bytes,
        "must be 0: every warm upload dedup'd")

    warm_upload_frames = 0
    if server is not None:
        warm_upload_frames = (server.wire_log.stat("upload").frames_in
                              - upload_frames_cold)
        row("cache/warm_upload_wire_frames", warm_upload_frames,
            "must be 0: dedup'd uploads never stream over TCP")
        row("cache/wire_bytes_total", server.wire_log.total_bytes,
            "all measured traffic, both directions")

    ok = True
    if smoke:
        if not (cold["hits"] == 0):
            print("FAIL: cold tenant unexpectedly hit the cache")
            ok = False
        if not all(w["hits"] == 3 for _, w in warms):
            print("FAIL: a warm tenant missed the cache")
            ok = False
        if not dedup_ok:
            print("FAIL: a warm upload was not a zero-byte dedup")
            ok = False
        if server is not None and warm_upload_frames != 0:
            print(f"FAIL: warm tenants put {warm_upload_frames} upload "
                  "frames on the wire; dedup should have sent none")
            ok = False
        if not speedup >= MIN_SPEEDUP:
            print(f"FAIL: warm speedup {speedup:.1f}x < {MIN_SPEEDUP}x")
            ok = False
        if ok:
            print(f"smoke OK: {speedup:.1f}x warm speedup, "
                  f"{summary['bytes_saved']} bytes never crossed")
    report = {"ok": ok, "bridge": bridge, "tenants": num_tenants,
              "shape": list(shape), "cold_s": cold["wall_s"],
              "warm_mean_s": warm_mean, "speedup": speedup,
              "cold_hits": cold["hits"],
              "warm_hits": [w["hits"] for _, w in warms],
              "warm_upload_bytes": warm_upload_bytes,
              "warm_upload_wire_frames": warm_upload_frames,
              "bytes_saved": summary["bytes_saved"]}

    for ac, _ in warms:
        ac.stop()
    cold_ac.stop()
    warmup.stop()
    if server is not None:
        server.stop()
    engine.shutdown()
    return report


def main() -> None:
    p = parser(__doc__.splitlines()[0])
    p.add_argument("--tenants", type=int, default=8)
    p.add_argument("--rows", type=int, default=2048)
    p.add_argument("--cols", type=int, default=256)
    p.add_argument("--k", type=int, default=16)
    p.add_argument("--bridge", choices=["inmemory", "socket"],
                   default="inmemory",
                   help="transport between tenants and the engine: "
                        "in-process calls, or real TCP through "
                        "core/server.py")
    args = p.parse_args()
    if args.smoke:
        res = run(3, (512, 128), k=8, smoke=True, bridge=args.bridge,
                  device=args.device)
        sys.exit(0 if res["ok"] else 1)
    run(args.tenants, (args.rows, args.cols), k=args.k, smoke=False,
        bridge=args.bridge, device=args.device)


if __name__ == "__main__":
    main()
