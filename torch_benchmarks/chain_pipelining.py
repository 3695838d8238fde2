"""Chain pipelining: lazy AlMatrix expressions vs the eager call() loop, in
the PyTorch port.

The paper's §3.3.2 keeps matrices engine-resident so chained routines
never re-cross the bridge; the lazy expression layer (``core/expr.py``)
removes the remaining per-stage cost — the *client round trip*. An eager
loop pays two protocol crossings per stage (submit + blocking wait),
serialized on the client; a lazy chain submits every stage up front
(exactly one ``submit`` crossing each, deferred outputs becoming
engine-side dependency edges) and pays a single wait at the end.

This benchmark builds an N-stage ``multiply`` chain both ways on the
same engine and reports, per N:

* measured client wall seconds, eager vs lazy;
* protocol crossings, counted by the engine per wire endpoint
  (``engine.endpoint_counts``) — the lazy chain is asserted to make
  exactly 1 submit per stage, 1 final wait, and 0 intermediate fetches;
* modeled cluster-scale seconds saved: each avoided crossing is one
  client<->engine message pair priced at the Table-3 calibrated
  per-message latency (``costmodel.CHUNK_LATENCY_S`` each way) — on a
  real deployment the client and the engine run on separate hosts, so
  every eager wait is a network round trip the lazy chain never makes.

Run: ``PYTHONPATH=src:. python torch_benchmarks/chain_pipelining.py``
(``--device cpu`` on the CPU; ``--smoke`` for the CI-sized run, which
also asserts that both idioms compute the same chain).
"""
from __future__ import annotations

import time

import numpy as np

from torch_benchmarks.common import header, parser
from repro_torch.core import AlchemistContext, AlchemistEngine
from repro_torch.core.costmodel import CHUNK_LATENCY_S
from repro_torch.core.libraries import elemental

# one protocol crossing = request + reply, each priced at the calibrated
# per-message socket latency
ROUND_TRIP_S = 2 * CHUNK_LATENCY_S
DIM = 128


def _fresh_context(device: str) -> AlchemistContext:
    # cache off: both paths would otherwise hit the content-addressed
    # cache on every repeated stage, and this benchmark measures the
    # dispatch pattern, not memoization (see cache_amortization.py)
    engine = AlchemistEngine(device=device, cache_entries=0)
    engine.load_library("elemental", elemental)
    return AlchemistContext(engine=engine)


def run_eager(ac: AlchemistContext, a, stages: int):
    """The pre-façade idiom: one blocking call() per stage."""
    al = ac.send_matrix(a)
    before = dict(ac.engine.endpoint_counts)
    t0 = time.perf_counter()
    x = al
    for _ in range(stages):
        x = ac.wrap(ac.call("elemental", "multiply", A=x, B=al)["C"])
    wall = time.perf_counter() - t0
    return wall, _delta(ac, before), x


def run_lazy(ac: AlchemistContext, a, stages: int):
    """The façade idiom: chain deferred proxies, force once."""
    el = ac.library("elemental")
    al = ac.send_matrix(a)
    before = dict(ac.engine.endpoint_counts)
    t0 = time.perf_counter()
    x = al
    for _ in range(stages):
        x = el.multiply(A=x, B=al)
    submit_done = time.perf_counter() - t0
    mid = _delta(ac, before)
    x.result()
    wall = time.perf_counter() - t0
    return wall, submit_done, mid, _delta(ac, before), x


def _delta(ac, before) -> dict:
    return {k: ac.engine.endpoint_counts[k] - before.get(k, 0)
            for k in ("submit", "task_op")}


def run(stage_sweep, smoke: bool = False, device: str = "cuda") -> dict:
    """Returns {stages: {"eager_s", "lazy_s", "lazy_submit_s",
    "eager_crossings", "lazy_crossings"}}; raises where the crossing
    contract breaks."""
    header("chain pipelining: lazy expression chain vs eager call() loop")
    print(f"{DIM}x{DIM} multiply chain on {device}; modeled round trip "
          f"{ROUND_TRIP_S * 1e3:.2f}ms/crossing (Table-3 calibrated "
          "per-message latency, both directions)")
    rng = np.random.RandomState(0)
    # scale to keep chained powers finite
    a = (rng.randn(DIM, DIM) / np.sqrt(DIM)).astype(np.float32)

    print("stages,eager_s,lazy_s,lazy_submit_s,eager_crossings,"
          "lazy_crossings,crossings_saved,modeled_saved_s")
    results = {}
    for stages in stage_sweep:
        ac_e = _fresh_context(device)
        eager_wall, eager_x, eager_out = run_eager(ac_e, a, stages)
        ac_l = _fresh_context(device)
        lazy_wall, submit_s, mid, lazy_x, out = run_lazy(ac_l, a, stages)

        eager_n = sum(eager_x.values())
        lazy_n = sum(lazy_x.values())
        saved = eager_n - lazy_n
        print(f"{stages},{eager_wall:.3f},{lazy_wall:.3f},{submit_s:.4f},"
              f"{eager_n},{lazy_n},{saved},{saved * ROUND_TRIP_S:.3f}")

        # the lazy chain's contract (what the façade exists for):
        # exactly one submit crossing per stage, zero crossings of any
        # other kind until the final force, which is exactly one wait
        assert mid["submit"] == stages, mid
        assert mid["task_op"] == 0, mid
        assert lazy_x == {"submit": stages, "task_op": 1}, lazy_x
        # the eager loop pays the extra per-stage wait crossing
        assert eager_x == {"submit": stages, "task_op": stages}, eager_x
        # and no matrix crossed the bridge mid-chain either way
        assert all(r.direction == "to_engine"
                   for r in ac_l.engine.transfer_log.records)

        if smoke:
            # both idioms compute the same chain
            np.testing.assert_allclose(out.to_numpy(),
                                       eager_out.to_numpy(), rtol=1e-4)
        results[stages] = {"eager_s": eager_wall, "lazy_s": lazy_wall,
                           "lazy_submit_s": submit_s,
                           "eager_crossings": eager_n,
                           "lazy_crossings": lazy_n}
        ac_e.stop()
        ac_l.stop()
        ac_e.engine.shutdown()
        ac_l.engine.shutdown()
    return results


def main() -> None:
    p = parser(__doc__.splitlines()[0])
    p.add_argument("--stages", default="4,16,64",
                   help="comma-separated chain lengths")
    args = p.parse_args()
    if args.smoke:
        run([4, 16], smoke=True, device=args.device)
        print("chain_pipelining --smoke OK: lazy chain = 1 submit/stage, "
              "0 intermediate round trips, 1 final wait")
    else:
        run([int(s) for s in args.stages.split(",")], device=args.device)


if __name__ == "__main__":
    main()
