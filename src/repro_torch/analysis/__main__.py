"""``python -m repro_torch.analysis`` — the port's invariant gate.

Default mode runs every static rule against the imported tree, applies
the committed baseline (``analysis-baseline-torch.json`` at the repo root)
and exits non-zero on any *new* finding — the hard gate. Stale
suppressions (baselined findings that no longer fire) are reported so
the baseline only ever shrinks.

``--json`` emits the machine-readable result (findings + gate verdict)
so benchmarks and future PRs can diff findings across revisions.

``--check-lock-report <path>`` gates a dynamic lock-trace report
instead: a run under ``REPRO_LOCK_TRACE=1 REPRO_LOCK_TRACE_OUT=<path>``
(``chip_smoke.py``'s gate phase drives the engine on a card so) then
asks this mode to verify the recorded lock-order graph is acyclic and
free of rank inversions.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.analysis import findings as F
from repro_torch.analysis import run_all_rules


def _run_static(args) -> int:
    found = run_all_rules()
    baseline = F.load_baseline(args.baseline)
    gate = F.apply_baseline(found, baseline,
                            allow_stale=args.allow_stale)

    if args.write_baseline:
        path = F.write_baseline(found, args.baseline)
        print(f"wrote {len(found)} suppression(s) to {path}")
        return 0

    if args.json:
        print(json.dumps({
            "ok": gate.ok,
            "findings": [f.to_dict() for f in found],
            "new": [f.fingerprint() for f in gate.new],
            "suppressed": [f.fingerprint() for f in gate.suppressed],
            "stale_suppressions": gate.stale,
        }, indent=2))
        return 0 if gate.ok else 1

    for f in gate.new:
        print(f.render())
    for f in gate.suppressed:
        print(f"{f.render()}  [baselined: "
              f"{baseline.get(f.fingerprint(), '')}]")
    for fp in gate.stale:
        print(f"stale suppression (no longer fires — delete it): {fp}")
    n_rules = len({f.rule for f in gate.new})
    if gate.ok:
        print(f"repro_torch.analysis: clean "
              f"({len(gate.suppressed)} baselined, "
              f"{len(gate.stale)} stale suppression(s))")
        return 0
    if gate.new:
        print(f"repro_torch.analysis: {len(gate.new)} new finding(s) "
              f"across {n_rules} rule(s) — fix them or baseline with "
              "--write-baseline (and justify each suppression)")
    else:
        print(f"repro_torch.analysis: {len(gate.stale)} stale "
              "suppression(s) — delete the dead rows from "
              "analysis-baseline-torch.json (or pass --allow-stale "
              "locally)")
    return 1


def _check_lock_report(path: str, as_json: bool) -> int:
    try:
        with open(path, "rb") as f:
            report = json.load(f)
    except OSError as e:
        print(f"cannot read lock report {path}: {e}", file=sys.stderr)
        return 2
    cycles = report.get("cycles", [])
    inversions = report.get("rank_inversions", [])
    ok = not cycles and not inversions
    if as_json:
        print(json.dumps({"ok": ok, "cycles": cycles,
                          "rank_inversions": inversions,
                          "locks": report.get("locks", []),
                          "edges": report.get("edges", []),
                          "waits_under_lock":
                              report.get("waits_under_lock", []),
                          "long_holds": report.get("long_holds", [])},
                         indent=2))
        return 0 if ok else 1
    print(f"lock trace: {len(report.get('locks', []))} lock(s), "
          f"{len(report.get('edges', []))} order edge(s)")
    for e in report.get("edges", []):
        print(f"  {e['from']} -> {e['to']}  x{e['count']}  "
              f"first at {e.get('site', '?')}")
    for w in report.get("waits_under_lock", []):
        print(f"  wait on {w['wait_on']} while holding {w['held']}  "
              f"x{w['count']}  at {w.get('site', '?')}")
    for h in report.get("long_holds", []):
        print(f"  long hold: {h['name']}  max {h['max_s'] * 1e3:.1f}ms "
              f"x{h['count']}  at {h.get('site', '?')}")
    if cycles:
        print("CYCLES (potential deadlocks):")
        for c in cycles:
            print("  " + " -> ".join(c))
    if inversions:
        print("RANK INVERSIONS (against the documented lock order):")
        for i in inversions:
            print(f"  acquired {i['acquired']} while holding "
                  f"{i['held']}  x{i['count']}  at {i.get('site', '?')}")
    print("lock trace: " + ("clean (acyclic, rank-consistent)" if ok
                            else "VIOLATIONS FOUND"))
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static invariant lint + dynamic lock-trace gate "
                    "for the repro_torch offload stack")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output (exit code unchanged)")
    ap.add_argument("--baseline", default=None,
                    help="baseline file (default: "
                    "analysis-baseline-torch.json at the repo root)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="suppress every current finding into the "
                    "baseline file (adoption escape hatch — justify "
                    "each entry afterwards)")
    ap.add_argument("--allow-stale", action="store_true",
                    help="do not fail on stale baseline suppressions "
                    "(local escape hatch; the gate runs without it, so a "
                    "fixed finding must take its suppression row "
                    "with it)")
    ap.add_argument("--check-lock-report", metavar="PATH", default=None,
                    help="gate a REPRO_LOCK_TRACE_OUT report instead of "
                    "running the static rules")
    args = ap.parse_args(argv)
    if args.check_lock_report:
        return _check_lock_report(args.check_lock_report, args.json)
    return _run_static(args)


if __name__ == "__main__":
    raise SystemExit(main())
