"""Multi-client throughput: the concurrency regime the scheduler exists for,
in the PyTorch port.

The paper's Alchemist "can serve several Spark applications at a time"
(§3.1.1) and the Cray deployment report (Rothauge et al., 2019) makes
request overlap the deciding regime for bridge deployments. The failure
mode of serialized dispatch is *head-of-line blocking*: one tenant's
long-running Lanczos SVD makes every other tenant's milliseconds-cheap
multiply wait behind it. This benchmark reproduces exactly that mix —

* client 0 is the **heavy tenant**: repeated ``truncated_svd`` calls on a
  large matrix;
* clients 1..N-1 are **light tenants**: multiply / gram / qr on small
  matrices;

— and time-boxes each configuration, counting completed calls, against

* the **serialized baseline** — an engine with ``scheduler_workers=1``,
  one-at-a-time FIFO dispatch (same ordering and hazard guarantees, zero
  overlap), and
* the **async scheduler** — ``scheduler_workers=W`` so different
  sessions' tasks overlap on the worker pool and light calls slip past
  the in-flight SVD.

Reported per client count: aggregate throughput (ops/s) for both engines,
speedup, light-tenant p50/p99 latency under both, and the engine-side
queue-wait vs execute split from the per-task accounting
(``engine.task_log``) — head-of-line blocking is visible there as
wait-time inflation with unchanged execute time.

Run: ``PYTHONPATH=src:. python torch_benchmarks/multiclient_throughput.py``
(``--device cpu`` on the CPU; ``--smoke`` for the CI-sized configuration;
``--qos --smoke`` asserts that the quota engages and, on a card, the
light tenants' p99 within 2x of solo — on the CPU, where the tenants
share the test run's loaded cores, that ratio is printed).

On the CPU each torch op runs on one intra-op thread for the length of a
run (``torch.set_num_threads(1)``, restored after): one op = one core,
like one Alchemist MPI rank per core in the paper — the *scheduler's*
worker pool, not the library's internal threading, is what exploits the
host's cores. On a card the worker pool overlaps the tenants' kernels on
the device.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time

import numpy as np
import torch

from torch_benchmarks.common import header, parser, row
from repro_torch.core import AlchemistBusyError, AlchemistContext, \
    AlchemistEngine
from repro_torch.core.costmodel import percentile
from repro_torch.core.libraries import elemental, skylark
from repro_torch.core.server import AlchemistServer

HEAVY_SHAPE = (2048, 512)             # the paper's offloaded regime
LIGHT_SHAPE = (128, 32)               # the interactive tenant
# the light tenants' p99 bound of the QoS smoke: 2x solo, with a floor
# that absorbs single-digit-ms timer noise
QOS_P99_RATIO = 2.0
QOS_P99_FLOOR_S = 0.05


@contextlib.contextmanager
def _one_thread_per_op(device: str):
    """On the CPU, one intra-op thread for the block (restored after); on
    a card nothing changes."""
    if device != "cpu":
        yield
        return
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _heavy_loop(ac, al, k, deadline, latencies):
    while time.perf_counter() < deadline:
        t0 = time.perf_counter()
        ac.call("elemental", "truncated_svd", A=al, k=k, oversample=8)
        latencies.append(time.perf_counter() - t0)


def _light_loop(ac, mats, deadline, latencies):
    a, b = mats
    i = 0
    while time.perf_counter() < deadline:
        t0 = time.perf_counter()
        kind = i % 3
        if kind == 0:
            ac.call("elemental", "multiply", A=a, B=b)
        elif kind == 1:
            ac.call("elemental", "gram", A=a)
        else:
            ac.call("elemental", "qr", A=a)
        latencies.append(time.perf_counter() - t0)
        i += 1


def _run_threads(threads) -> float:
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return time.perf_counter() - t0


def _run_config(num_clients: int, duration_s: float, k: int,
                workers: int, bridge: str = "inmemory",
                device: str = "cuda") -> dict:
    """1 heavy + (num_clients-1) light tenants against a fresh engine.

    The routine cache is disabled: every tenant here repeats identical
    calls on its resident matrices, which the content-addressed cache
    would short-circuit entirely — this benchmark measures *dispatch*
    (FIFO vs worker pool); ``cache_amortization.py`` measures the cache.

    ``bridge="socket"`` runs the same mix over real TCP: the engine is
    fronted by a ``core/server.py`` instance and every tenant is its own
    socket connection — dispatch overlap now has to survive framing,
    per-connection handler threads, and the kernel's loopback stack."""
    engine = AlchemistEngine(device=device, scheduler_workers=workers,
                             cache_entries=0)
    engine.load_library("elemental", elemental)
    server = (AlchemistServer(engine=engine).start()
              if bridge == "socket" else None)

    def _ctx(name: str) -> AlchemistContext:
        if server is not None:
            return AlchemistContext(address=server.address,
                                    client_name=name)
        return AlchemistContext(engine=engine, client_name=name)

    rng = np.random.RandomState(0)

    heavy_ac = _ctx("heavy")
    heavy_al = heavy_ac.send_matrix(
        rng.randn(*HEAVY_SHAPE).astype(np.float32))
    light = []
    for i in range(num_clients - 1):
        ac = _ctx(f"light-{i}")
        a = ac.send_matrix(rng.randn(*LIGHT_SHAPE).astype(np.float32))
        b = ac.send_matrix(rng.randn(
            LIGHT_SHAPE[1], LIGHT_SHAPE[1]).astype(np.float32))
        light.append((ac, (a, b)))

    heavy_lat: list[float] = []
    light_lats: list[list[float]] = [[] for _ in light]
    deadline = time.perf_counter() + duration_s
    threads = [threading.Thread(
        target=_heavy_loop,
        args=(heavy_ac, heavy_al, k, deadline, heavy_lat))]
    threads += [threading.Thread(
        target=_light_loop, args=(ac, mats, deadline, lat))
        for (ac, mats), lat in zip(light, light_lats)]
    wall = _run_threads(threads)

    all_light = [x for sub in light_lats for x in sub]
    ctxs = [heavy_ac] + [ac for ac, _ in light]
    summaries = [engine.task_log.session_summary(ac.session)
                 for ac in ctxs]
    out = {
        "wall_s": wall,
        "ops": len(heavy_lat) + len(all_light),
        "heavy_ops": len(heavy_lat),
        "light_ops": len(all_light),
        "throughput": (len(heavy_lat) + len(all_light)) / wall,
        "light_p50_s": percentile(all_light, 50),
        "light_p99_s": percentile(all_light, 99),
        "wait_s": sum(s["wait_s"] for s in summaries),
        "exec_s": sum(s["exec_s"] for s in summaries),
        "max_running": engine.scheduler.max_running_observed,
        "bridge_bytes": sum(
            engine.transfer_log.session_summary(ac.session)
            ["to_engine_bytes"] for ac in ctxs),
        "wire_frames": server.wire_log.total_frames if server else 0,
        "wire_bytes": server.wire_log.total_bytes if server else 0,
    }
    for ac in ctxs:
        ac.stop()
    if server is not None:
        server.stop()
    engine.shutdown()
    return out


def run(clients_sweep, duration_s: float, k: int, workers: int,
        reps: int = 3, bridge: str = "inmemory",
        device: str = "cuda") -> dict:
    """Returns {client count: {"serial": median-throughput run, "async":
    median-throughput run, "serial_ops_s", "async_ops_s"}}."""
    header("multi-client throughput: serialized FIFO vs async scheduler")
    print(f"mix: 1 heavy tenant (truncated_svd k={k} on "
          f"{HEAVY_SHAPE[0]}x{HEAVY_SHAPE[1]}) + N-1 light tenants "
          f"(multiply/gram/qr on {LIGHT_SHAPE[0]}x{LIGHT_SHAPE[1]}); "
          f"{duration_s:.0f}s time-box; pool = {workers} workers "
          f"(host has {os.cpu_count()} cores); median of {reps} "
          f"interleaved serial/async reps; bridge = {bridge}; "
          f"device = {device}")
    results = {}
    with _one_thread_per_op(device):
        # warm every program cache so the sweep measures dispatch, not
        # first-call builds
        _run_config(2, min(duration_s, 2.0), k, workers, bridge=bridge,
                    device=device)

        print("clients,serial_ops_s,async_ops_s,speedup,"
              "light_p50_ms_serial,light_p50_ms_async,"
              "light_p99_ms_serial,light_p99_ms_async,"
              "async_wait_s,async_exec_s,max_running")
        for n in clients_sweep:
            # alternate the two engines so slow host drift hits both
            serials, concs = [], []
            for _ in range(reps):
                serials.append(_run_config(n, duration_s, k, workers=1,
                                           bridge=bridge, device=device))
                concs.append(_run_config(n, duration_s, k, workers=workers,
                                         bridge=bridge, device=device))
            s_tput = float(np.median([r["throughput"] for r in serials]))
            c_tput = float(np.median([r["throughput"] for r in concs]))
            serial = serials[int(np.argsort(
                [r["throughput"] for r in serials])[len(serials) // 2])]
            conc = concs[int(np.argsort(
                [r["throughput"] for r in concs])[len(concs) // 2])]
            print(f"{n},{s_tput:.1f},{c_tput:.1f},"
                  f"{c_tput / max(s_tput, 1e-9):.2f}x,"
                  f"{serial['light_p50_s'] * 1e3:.1f},"
                  f"{conc['light_p50_s'] * 1e3:.1f},"
                  f"{serial['light_p99_s'] * 1e3:.1f},"
                  f"{conc['light_p99_s'] * 1e3:.1f},"
                  f"{conc['wait_s']:.2f},{conc['exec_s']:.2f},"
                  f"{conc['max_running']}")
            if n > 1:
                row("multiclient/overlap_observed", conc["max_running"],
                    f"clients={n} (must exceed 1 for real concurrency)")
            if bridge == "socket":
                row("multiclient/wire_frames", conc["wire_frames"],
                    f"clients={n} measured TCP frames (server side)")
                row("multiclient/wire_bytes", conc["wire_bytes"],
                    f"clients={n} measured bytes on the wire")
            results[n] = {"serial": serial, "async": conc,
                          "serial_ops_s": s_tput, "async_ops_s": c_tput}
    return results


# =====================================================================
# QoS fairness mode (--qos): fair share + admission vs unprotected FIFO
# =====================================================================
QOS_BURST = 3                         # async SVDs the heavy tenant stacks


def _light_cg_loop(ac, mats, deadline, latencies):
    x, y = mats
    while time.perf_counter() < deadline:
        t0 = time.perf_counter()
        ac.call("skylark", "cg_solve", X=x, Y=y, lam=1e-4, max_iters=8)
        latencies.append(time.perf_counter() - t0)


def _heavy_burst_loop(ac, al, k, deadline, latencies, busy):
    """The anti-social tenant: stack QOS_BURST async SVDs at a time.
    Admission denials (QoS on, after the client's own backoff gives up)
    are counted and honored — the cooperative half of backpressure."""
    while time.perf_counter() < deadline:
        t0 = time.perf_counter()
        futs = []
        for _ in range(QOS_BURST):
            try:
                futs.append(ac.call_async(
                    "elemental", "truncated_svd", A=al, k=k, oversample=8))
            except AlchemistBusyError as e:
                busy[0] += 1
                time.sleep(min(max(e.retry_after_s, 0.01), 0.2))
        for f in futs:
            f.result()
        if futs:
            latencies.append((time.perf_counter() - t0) / len(futs))


def _run_qos_config(num_light: int, duration_s: float, k: int,
                    workers: int, mode: str, bridge: str = "inmemory",
                    device: str = "cuda") -> dict:
    """One time-boxed tenant mix. ``mode``:

    * ``"solo"`` — the light CG tenants alone: the fairness baseline;
    * ``"off"``  — plus the heavy SVD tenant, QoS disabled (plain FIFO:
      the burst parks in front of every light call);
    * ``"on"``   — same mix, ``qos=True``: the heavy tenant is capped at
      one in-flight task (admission quota), weighted 1 against the light
      tenants' 4, and its SVD yields at iteration boundaries.
    """
    qos_on = mode == "on"
    engine = AlchemistEngine(device=device, scheduler_workers=workers,
                             cache_entries=0, qos=qos_on)
    engine.load_library("elemental", elemental)
    engine.load_library("skylark", skylark)
    server = (AlchemistServer(engine=engine).start()
              if bridge == "socket" else None)

    def _ctx(name: str, **kw) -> AlchemistContext:
        if server is not None:
            return AlchemistContext(address=server.address,
                                    client_name=name, **kw)
        return AlchemistContext(engine=engine, client_name=name, **kw)

    rng = np.random.RandomState(0)
    light = []
    for i in range(num_light):
        ac = _ctx(f"light-{i}")
        if qos_on:
            ac.configure(weight=4.0)
        x = ac.send_matrix(rng.randn(*LIGHT_SHAPE).astype(np.float32))
        y = ac.send_matrix(rng.randn(
            LIGHT_SHAPE[0], 1).astype(np.float32))
        light.append((ac, (x, y)))

    heavy_ac = None
    heavy_lat: list[float] = []
    busy = [0]
    threads = []
    deadline = time.perf_counter() + duration_s
    if mode != "solo":
        heavy_ac = _ctx("heavy", busy_retries=1)
        if qos_on:
            heavy_ac.configure(weight=1.0,
                               quotas={"max_queue_depth": 1})
        heavy_al = heavy_ac.send_matrix(
            rng.randn(*HEAVY_SHAPE).astype(np.float32))
        threads.append(threading.Thread(
            target=_heavy_burst_loop,
            args=(heavy_ac, heavy_al, k, deadline, heavy_lat, busy)))

    light_lats: list[list[float]] = [[] for _ in light]
    threads += [threading.Thread(
        target=_light_cg_loop, args=(ac, mats, deadline, lat))
        for (ac, mats), lat in zip(light, light_lats)]
    _run_threads(threads)

    all_light = [x for sub in light_lats for x in sub]
    qstats = engine.qos_stats()
    out = {
        "mode": mode,
        "light_ops": len(all_light),
        "heavy_ops": len(heavy_lat) * QOS_BURST,
        "light_p50_s": percentile(all_light, 50),
        "light_p99_s": percentile(all_light, 99),
        "client_busy_giveups": busy[0],
        "rejected": qstats["rejected"],
        "throttled": qstats["throttled"],
        "preempted": qstats["preempted"],
    }
    for ac, _ in light:
        ac.stop()
    if heavy_ac is not None:
        heavy_ac.stop()
    if server is not None:
        server.stop()
    engine.shutdown()
    return out


def run_qos(duration_s: float, k: int, workers: int, num_light: int = 3,
            smoke: bool = False, bridge: str = "inmemory",
            json_path: str = None, device: str = "cuda") -> dict:
    """Light-tenant p99 with and without QoS under a saturating heavy
    SVD tenant, against the solo (unshared-engine) baseline. With
    ``smoke`` the claim is asserted: the quota must engage, and on a card
    fair share + admission must hold the light p99 within 2x of solo (on
    the CPU that ratio is printed)."""
    header("multi-tenant QoS: light-tenant latency under a heavy SVD")
    print(f"mix: {num_light} light CG tenants "
          f"({LIGHT_SHAPE[0]}x{LIGHT_SHAPE[1]}, 8 iters) vs 1 heavy "
          f"tenant bursting {QOS_BURST} async truncated_svd k={k} on "
          f"{HEAVY_SHAPE[0]}x{HEAVY_SHAPE[1]}; {duration_s:.0f}s "
          f"time-box; {workers} workers; bridge = {bridge}; "
          f"device = {device}")

    with _one_thread_per_op(device):
        # warm the program caches so p99 measures dispatch, not builds
        _run_qos_config(num_light, min(duration_s, 2.0), k, workers,
                        mode="off", bridge=bridge, device=device)
        results = {m: _run_qos_config(num_light, duration_s, k, workers,
                                      mode=m, bridge=bridge, device=device)
                   for m in ("solo", "off", "on")}
    print("mode,light_ops,heavy_ops,light_p50_ms,light_p99_ms,"
          "rejected,preempted,client_busy_giveups")
    for m, r in results.items():
        print(f"{m},{r['light_ops']},{r['heavy_ops']},"
              f"{r['light_p50_s'] * 1e3:.1f},"
              f"{r['light_p99_s'] * 1e3:.1f},"
              f"{r['rejected']},{r['preempted']},"
              f"{r['client_busy_giveups']}")
    solo99 = results["solo"]["light_p99_s"]
    on99 = results["on"]["light_p99_s"]
    off99 = results["off"]["light_p99_s"]
    row("qos/light_p99_ratio_on", on99 / max(solo99, 1e-9),
        "light p99 with QoS on / solo baseline (claim: <= 2x)")
    row("qos/light_p99_ratio_off", off99 / max(solo99, 1e-9),
        "light p99 unprotected / solo baseline")
    if json_path:
        with open(json_path, "w") as f:
            json.dump(results, f, indent=2, sort_keys=True)
        print(f"wrote {json_path}")
    if smoke:
        assert results["on"]["rejected"] > 0, (
            "the heavy tenant's burst was never admission-denied — the "
            "quota did not engage")
        # the fairness claim (a small absolute floor absorbs
        # single-digit-ms timer noise)
        bound = max(QOS_P99_RATIO * solo99, QOS_P99_FLOOR_S)
        if device == "cpu":
            print(f"# qos-on light p99 {on99 * 1e3:.1f}ms against bound "
                  f"{bound * 1e3:.1f}ms on the CPU (solo "
                  f"{solo99 * 1e3:.1f}ms, unprotected {off99 * 1e3:.1f}ms;"
                  f" asserted <= {QOS_P99_RATIO}x solo on a card only)")
        else:
            assert on99 <= bound, (
                f"light-tenant p99 {on99 * 1e3:.1f}ms with QoS on exceeds "
                f"2x the solo baseline ({solo99 * 1e3:.1f}ms)")
            print(f"smoke OK: qos-on light p99 {on99 * 1e3:.1f}ms <= bound "
                  f"{bound * 1e3:.1f}ms (solo {solo99 * 1e3:.1f}ms, "
                  f"unprotected {off99 * 1e3:.1f}ms)")
    return results


def main() -> None:
    p = parser(__doc__.splitlines()[0])
    p.add_argument("--clients", default="1,2,4,8,16",
                   help="comma-separated client counts to sweep")
    p.add_argument("--duration", type=float, default=4.0,
                   help="seconds per timed configuration")
    p.add_argument("--k", type=int, default=8, help="truncated_svd rank")
    p.add_argument("--workers", type=int,
                   default=max(2, min(8, os.cpu_count() or 2)))
    p.add_argument("--bridge", choices=["inmemory", "socket"],
                   default="inmemory",
                   help="transport between tenants and the engine: "
                        "in-process calls, or real TCP through "
                        "core/server.py")
    p.add_argument("--qos", action="store_true",
                   help="fairness mode: light-tenant p99 with/without "
                        "multi-tenant QoS under a saturating heavy SVD "
                        "(with --smoke, asserts the claim)")
    p.add_argument("--json", default=None,
                   help="with --qos: also write results to this path")
    args = p.parse_args()
    if args.qos:
        run_qos(duration_s=2.0 if args.smoke else args.duration,
                k=args.k, workers=2 if args.smoke else args.workers,
                smoke=args.smoke, bridge=args.bridge,
                json_path=args.json, device=args.device)
    elif args.smoke:
        run([1, 2, 4], duration_s=2.0, k=8, workers=2, reps=3,
            bridge=args.bridge, device=args.device)
    else:
        clients = [int(c) for c in args.clients.split(",")]
        run(clients, duration_s=args.duration, k=args.k,
            workers=args.workers, bridge=args.bridge, device=args.device)


if __name__ == "__main__":
    main()
