"""The port's invariant checker (``repro_torch.analysis``), against its
own conformance suite: every test of ``tests/test_analysis.py``, pointed
at the port, plus what the port adds.

* every static rule family (CAT/WIRE/BRG/TRC/PKL/LCK/STM/CFG) is proven
  with a fixture that violates exactly it and proven quiet on the real
  tree. The fixtures are the JAX suite's where the rule is the same
  (``tests/fixtures/analysis_violations.py``, ``stm_violations.py``, the
  fake registries, the crafted frame tables); TRC001 has the port's own
  meaning (what a CUDA graph captures and what launches a kernel) and its
  own fixtures (``tests/fixtures/torch_trace_violations.py``,
  ``torch_launch_violations.cu``);
* cross-package parity: both packages' rule functions on the same
  inputs give the same ``(rule, symbol)`` sets;
* the repairs the gate forced: the program LRU bounded in bytes, every
  lock of ``core`` and ``kernels`` built through ``locktrace`` and
  ranked, and the traced engine's lock graph acyclic and rank-consistent
  (in process, and through ``repro_torch.analysis.tracedrive``).
"""
import json
import os
import subprocess
import sys
import threading
import types

import numpy as np
import pytest
import torch

from repro.analysis import rules_catalog as ref_catalog
from repro.analysis import rules_config as ref_config
from repro.analysis import rules_source as ref_source
from repro.analysis import rules_stm as ref_stm
from repro.analysis import rules_wire as ref_wire
from repro.core.backends.base import ExecutionBackend as RefExecutionBackend
from repro_torch.analysis import locktrace, run_all_rules
from repro_torch.analysis import findings as F
from repro_torch.analysis import rules_source
from repro_torch.analysis.__main__ import main as analysis_main
from repro_torch.analysis.rules_catalog import check_catalog_parity
from repro_torch.analysis.rules_config import check_config_surface
from repro_torch.analysis.rules_source import (
    check_lock_discipline, check_lock_ranks, check_no_pickle,
    check_trace_purity)
from repro_torch.analysis.rules_stm import check_statemachines
from repro_torch.analysis.rules_wire import (
    check_bridge_parity, check_wire_exhaustiveness)
from repro_torch.analysis.statemachine import Edge, Machine, Obligation
from repro_torch.core.backends.base import ExecutionBackend
from repro_torch.core.wire import FrameSpec

TESTS = os.path.dirname(__file__)
REPO = os.path.dirname(TESTS)
FIXTURE = os.path.join(TESTS, "fixtures", "analysis_violations.py")
TORCH_FIXTURE = os.path.join(TESTS, "fixtures", "torch_trace_violations.py")
CU_FIXTURE = os.path.join(TESTS, "fixtures", "torch_launch_violations.cu")
DOC = os.path.join(REPO, "docs", "torch_architecture.md")


def _by_rule(findings, rule):
    return [f for f in findings if f.rule == rule]


def _keys(findings):
    return sorted({(f.rule, f.symbol) for f in findings})


# =====================================================================
# CAT — catalog parity, against a deliberately drifted fake registry
# =====================================================================
def _spec_fn_mul(engine, A, B):
    raise NotImplementedError


def _spec_fn_solo(engine, A):
    raise NotImplementedError


def _fake(base, name):
    return type(f"_Fake{name[-1].upper()}", (base,), {
        "name": name, "to_native": lambda self, array: array,
        "is_array": lambda self, value: False})


# the JAX suite's fake registries, once on the port's ABI and once on the
# JAX package's, registering the very same functions
_FakeA, _FakeB = _fake(ExecutionBackend, "fake-a"), \
    _fake(ExecutionBackend, "fake-b")
_RefFakeA, _RefFakeB = _fake(RefExecutionBackend, "fake-a"), \
    _fake(RefExecutionBackend, "fake-b")


# CAT004: bucketable without a shape rule (and fusible=True for CAT003)
def _a_mul(A=None, B=None):
    return {"C": A}


# CAT005: spec declares output "X", the impl only ever returns "Y"
def _a_solo(A=None):
    return {"Y": A}


# CAT002: registered under the cataloged library, never declared
def _a_orphan(A=None):
    return {"Z": A}


# CAT003: fusible drifts from _FakeA's registration of the same routine
def _b_mul(A=None, B=None):
    return {"C": A}
# CAT001: _FakeB never registers fakelib.solo


for _A, _B in ((_FakeA, _FakeB), (_RefFakeA, _RefFakeB)):
    _A.register("fakelib", "mul", fusible=True, bucketable=True)(_a_mul)
    _A.register("fakelib", "solo")(_a_solo)
    _A.register("fakelib", "orphan")(_a_orphan)
    _B.register("fakelib", "mul", fusible=False)(_b_mul)


def _fake_module(**routines):
    spec = types.SimpleNamespace
    return spec(__file__=__file__, ROUTINES={
        "mul": spec(fn=_spec_fn_mul, outputs=("C",)),
        "solo": spec(fn=_spec_fn_solo, outputs=("X",)),
    } if not routines else routines)


@pytest.fixture()
def fake_catalog():
    return {"fakelib": _fake_module()}, [_FakeA(), _FakeB()]


def test_cat_rules_fire_on_drifted_registry(fake_catalog):
    libraries, backends = fake_catalog
    found = check_catalog_parity(libraries=libraries, backends=backends)

    missing = _by_rule(found, "CAT001")
    assert [f.symbol for f in missing] == ["fakelib.solo@fake-b"]

    orphans = _by_rule(found, "CAT002")
    assert [f.symbol for f in orphans] == ["fakelib.orphan@fake-a"]

    drift = _by_rule(found, "CAT003")
    assert [f.symbol for f in drift] == ["fakelib.mul"]
    assert "fusible" in drift[0].message
    assert "bucketable" in drift[0].message     # True on A, False on B

    bucket = _by_rule(found, "CAT004")
    assert [f.symbol for f in bucket] == ["fakelib.mul@fake-a"]

    arity = _by_rule(found, "CAT005")
    assert [f.symbol for f in arity] == ["fakelib.solo@fake-a"]
    assert "X" in arity[0].message


def test_cat_quiet_when_registry_agrees():
    spec = types.SimpleNamespace
    module = spec(__file__=__file__,
                  ROUTINES={"mul": spec(fn=_spec_fn_mul,
                                        outputs=("C",))})
    # only _FakeB (no orphan, fusible=False everywhere): nothing drifts
    assert check_catalog_parity(libraries={"fakelib": module},
                                backends=[_FakeB()]) == []


# =====================================================================
# WIRE/BRG — frame-table exhaustiveness on crafted registries
# =====================================================================
_WIRE001_SPECS = (
    FrameSpec("A", 0x01, "request", "handshake", ("RESULT",)),
    FrameSpec("B", 0x01, "request", "submit", ("RESULT",)),
    FrameSpec("C", 0x02, "request", "", ()),
    FrameSpec("RESULT", 0x10, "reply"),
    FrameSpec("D", 0x03, "request", "describe", ("GHOST",)),
    FrameSpec("E", 0x04, "reply", endpoint="submit"),
)
_WIRE002_SPECS = (
    FrameSpec("BOGUS", 0x44, "request", "bogus_endpoint", ("RESULT",)),
    FrameSpec("RESULT", 0x10, "reply"),
)
# endpoint resolves on the engine (WIRE002 quiet) but SocketBridge's
# source never references FRAME_GHOSTCALL
_WIRE003_SPECS = (
    FrameSpec("GHOSTCALL", 0x45, "request", "describe", ("RESULT",)),
    FrameSpec("RESULT", 0x10, "reply"),
)


class _NotABridge:            # no submit/handshake/fetch/...
    def close(self):
        pass


def test_wire001_registry_integrity():
    syms = {f.symbol for f in
            _by_rule(check_wire_exhaustiveness(frame_specs=_WIRE001_SPECS),
                     "WIRE001")}
    assert "0x01" in syms          # duplicate code
    assert "C" in syms             # request without an endpoint
    assert "D->GHOST" in syms      # reply naming an unregistered frame
    assert "E" in syms             # non-request declaring an endpoint


def test_wire002_unhandled_request_frame():
    found = _by_rule(check_wire_exhaustiveness(frame_specs=_WIRE002_SPECS),
                     "WIRE002")
    assert [f.symbol for f in found] == ["BOGUS"]
    assert "bogus_endpoint" in found[0].message


def test_wire003_frame_the_client_never_sends():
    found = check_wire_exhaustiveness(frame_specs=_WIRE003_SPECS)
    assert [f.symbol for f in _by_rule(found, "WIRE002")] == []
    assert [f.symbol for f in _by_rule(found, "WIRE003")] == \
        ["GHOSTCALL"]


def test_brg001_bridge_missing_consumer_surface():
    found = _by_rule(check_bridge_parity(bridge_cls=_NotABridge),
                     "BRG001")
    syms = {f.symbol for f in found}
    assert "submit" in syms       # context.py calls .submit() on bridges
    assert all("_NotABridge does not provide it" in f.message
               for f in found)


def test_wire_rules_quiet_on_real_registry():
    assert check_wire_exhaustiveness() == []
    assert check_bridge_parity() == []


# =====================================================================
# TRC/PKL/LCK — AST rules against the violating fixture modules
# =====================================================================
def test_trc001_fires_on_every_impurity_in_fixture():
    """The port's TRC001 reads every function of a wrapper or launch
    module: each banned call of ``impure_launch`` fires once, on its own
    line, and ``clean_launch`` (``LaunchCounter.add`` included) is
    quiet."""
    found = check_trace_purity(paths=[TORCH_FIXTURE], cu_paths=[],
                               include_capture_safe=False)
    assert all(f.rule == "TRC001" for f in found)
    assert {f.symbol for f in found} == \
        {"torch_trace_violations.py:impure_launch"}
    whats = sorted(f.message.split(" inside ")[0] for f in found)
    assert whats == sorted([
        ".item()", ".tolist()", ".cpu()", ".numpy()", ".synchronize()",
        "torch.from_numpy()", "torch.tensor()", "np.asarray()",
        "np.array()", "print()", "open()", "time.perf_counter()",
        ".acquire()", ".release()", "with _lock: (lock held in a capture "
        "or launch)"])
    assert len({f.line for f in found}) == len(found) == 15


def test_trc001_fires_on_blocking_cuda_calls_in_a_launcher():
    found = check_trace_purity(paths=[], cu_paths=[CU_FIXTURE],
                               include_capture_safe=False)
    assert {f.symbol for f in found} == \
        {"torch_launch_violations.cu:bad_launch"}
    calls = sorted(f.message.split(" in CUDA launcher")[0] for f in found)
    assert calls == sorted(["cudaMalloc", "cudaMemcpy",
                            "cudaDeviceSynchronize",
                            "cudaStreamSynchronize", "cudaFree"])
    with open(CU_FIXTURE) as f:
        lines = f.read().splitlines()
    for finding in found:         # each anchored on its own call's line
        call = finding.message.split(" in CUDA launcher")[0]
        assert call in lines[finding.line - 1]


def test_trc001_reads_the_capture_safe_registry(monkeypatch):
    """A host sync planted in a capture-safe body fires as
    ``<lib>.<routine>@capture``; the fusible routines that are never
    captured (``qr``: host LAPACK info) stay outside the scope."""
    import dataclasses
    from repro_torch.core.backends.torch_backend import TorchBackend

    def planted_multiply(A, B):
        scale = float(A.abs().max().item())
        return {"C": (A @ B) / scale}

    real = TorchBackend.routine_impl

    def routine_impl(self, library, routine, fallback=None):
        impl = real(self, library, routine, fallback)
        if (library, routine) == ("elemental", "multiply"):
            return dataclasses.replace(impl, fn=planted_multiply)
        return impl

    monkeypatch.setattr(TorchBackend, "routine_impl", routine_impl)
    found = check_trace_purity(paths=[], cu_paths=[])
    assert _keys(found) == [("TRC001", "elemental.multiply@capture")]
    assert found[0].message.startswith(".item()")


def test_pkl001_fires_on_pickle_in_fixture():
    found = check_no_pickle(paths=[FIXTURE])
    assert [f.rule for f in found] == ["PKL001", "PKL001"]
    syms = {f.symbol for f in found}
    assert "analysis_violations.py:import-pickle" in syms
    assert "analysis_violations.py:pickle.loads" in syms


def test_lck001_fires_on_raw_lock_in_fixture():
    found = check_lock_discipline(paths=[FIXTURE])
    assert [f.symbol for f in found] == \
        ["analysis_violations.py:threading.Lock"]


def test_source_rules_quiet_on_real_tree():
    assert check_trace_purity() == []
    assert check_no_pickle() == []
    assert check_lock_discipline() == []


# =====================================================================
# STM — state-machine conformance, against a crafted spec + fixture
# =====================================================================
_FX_MACHINE = Machine(
    name="fx", subject="fixture row",
    modules=("stm_violations.py",),
    guarded=("_rows",),
    states=("OPEN", "CLOSED"), initial="OPEN", terminal=("CLOSED",),
    lock="fx.lock", lockattr="_lk",
    mint_sites=("open_row",),
    edges=(Edge("OPEN", "CLOSED", "close_row"),),
    extra_sites=("ghost_site",),            # STM002: does not exist
    obligations=(Obligation("close_row", ("unhook",),
                            "closed rows must unhook their watchers"),),
)


def test_stm_rules_fire_on_violating_fixture():
    found = check_statemachines(machines=(_FX_MACHINE,),
                                root=os.path.dirname(FIXTURE))
    by_rule = {}
    for f in found:
        by_rule.setdefault(f.rule, []).append(f.symbol)
    assert by_rule["STM001"] == ["fx.rogue_drop._rows"]
    assert by_rule["STM002"] == ["fx.ghost_site"]
    assert by_rule["STM003"] == ["fx.close_row._rows"]
    assert by_rule["STM004"] == ["fx.close_row.unhook"]
    assert len(found) == 4                  # open_row is clean


def test_stm_quiet_on_real_tree():
    """Includes the port's reload site: the store machine's SPILLED ->
    LIVE edge is declared at ``_resolve``, where the port reloads (the
    JAX engine reloads in ``get``), so STM001 no longer fires there."""
    assert check_statemachines() == []


# =====================================================================
# CFG001 — configure-surface parity, against crafted drifted surfaces
# =====================================================================
def _drifted_config_surfaces(tmp_path) -> dict:
    (tmp_path / "engine.py").write_text(
        "class E:\n"
        "    def configure(self, opts):\n"
        "        allowed = {'warmup'}      # literal set, not the registry\n"
        "        return allowed\n")
    (tmp_path / "protocol.py").write_text(
        "class Configure:\n"
        "    '''Session configure frame. Mentions no options at all.'''\n")
    (tmp_path / "context.py").write_text(
        "class C:\n"
        "    def configure(self, warmup=None, bogus=None):\n"
        "        pass\n")
    (tmp_path / "server.py").write_text(
        "def build_parser(ap):\n"
        "    return ap                     # defines no flags\n")
    return dict(
        options=[types.SimpleNamespace(name="warmup", cli="--warmup")],
        engine_path=str(tmp_path / "engine.py"),
        protocol_path=str(tmp_path / "protocol.py"),
        context_path=str(tmp_path / "context.py"),
        server_path=str(tmp_path / "server.py"))


def test_cfg001_fires_on_every_drifted_surface(tmp_path):
    found = check_config_surface(**_drifted_config_surfaces(tmp_path))
    assert all(f.rule == "CFG001" for f in found)
    syms = {f.symbol for f in found}
    assert syms == {
        "engine.configure:SUPPORTED",       # no registry reference
        "engine.configure:QOS_OPTIONS",     # no QoS gating reference
        "protocol.Configure:warmup",        # docstring omits the option
        "context.configure:bogus",          # unregistered client kwarg
        "server.cli:warmup",                # declared flag undefined
    }


def test_cfg001_quiet_on_real_tree():
    assert check_config_surface() == []


# =====================================================================
# LCK002 — rank uniqueness + docs<->code rank-table parity
# =====================================================================
def _rank_doc(tmp_path, rows):
    doc = tmp_path / "torch_architecture.md"
    table = "\n".join(f"| {r} | `{n}` | prose |" for n, r in rows)
    doc.write_text("intro\n\n<!-- LOCK_RANK_TABLE_BEGIN -->\n"
                   "| rank | lock | held by |\n|---|---|---|\n"
                   + table + "\n<!-- LOCK_RANK_TABLE_END -->\n")
    return str(doc)


def test_lck002_duplicate_ranks(tmp_path):
    doc = _rank_doc(tmp_path, [("a.x", 10), ("b.y", 10)])
    found = check_lock_ranks(ranks={"a.x": 10, "b.y": 10}, doc_path=doc)
    assert [f.symbol for f in found] == ["rank-dup:10"]
    assert "total order" in found[0].message


def test_lck002_docs_drift_stale_and_missing_rows(tmp_path):
    doc = _rank_doc(tmp_path, [("a.x", 11), ("c.z", 30)])
    found = check_lock_ranks(ranks={"a.x": 10, "b.y": 20}, doc_path=doc)
    assert {f.symbol for f in found} == {
        "docs:undocumented:b.y",            # in code, not in docs
        "docs:stale:c.z",                   # in docs, not in code
        "docs:rank-drift:a.x",              # 11 documented != 10 coded
    }


def test_lck002_missing_markers_and_missing_doc(tmp_path):
    bare = tmp_path / "bare.md"
    bare.write_text("no table here\n")
    found = check_lock_ranks(ranks={"a.x": 10}, doc_path=str(bare))
    assert [f.symbol for f in found] == ["docs:rank-table-markers"]
    found = check_lock_ranks(ranks={"a.x": 10},
                             doc_path=str(tmp_path / "absent.md"))
    assert [f.symbol for f in found] == ["docs:missing"]


def test_lck002_quiet_on_real_tree():
    assert check_lock_ranks() == []


# =====================================================================
# the gate: all rules + baseline mechanics + CLI exit codes
# =====================================================================
def test_run_all_rules_clean_on_real_tree():
    assert run_all_rules() == []


def test_fingerprints_are_line_independent():
    a = F.Finding("CAT001", "/x/src/repro_torch/core/a.py", 10, "s.r", "m")
    b = F.Finding("CAT001", "/y/src/repro_torch/core/a.py", 99, "s.r", "m2")
    assert a.fingerprint() == b.fingerprint() == \
        "CAT001:src/repro_torch/core/a.py:s.r"


def test_baseline_suppresses_and_ratchets(tmp_path):
    live = F.Finding("CAT001", "src/repro_torch/core/a.py", 1, "lib.rt",
                     "m")
    path = str(tmp_path / "baseline.json")
    F.write_baseline([live], path, reason="known drift")
    baseline = F.load_baseline(path)
    assert baseline == {live.fingerprint(): "known drift"}

    gate = F.apply_baseline([live], baseline)
    assert gate.ok and [f.fingerprint() for f in gate.suppressed] == \
        [live.fingerprint()] and gate.stale == []

    # the finding stops firing -> its suppression turns stale, which is
    # a HARD failure (the ratchet's teeth): the fixed finding must take
    # its baseline row with it
    gate = F.apply_baseline([], baseline)
    assert not gate.ok and gate.stale == [live.fingerprint()]
    # ... unless the local escape hatch is explicit
    assert F.apply_baseline([], baseline, allow_stale=True).ok

    # a new, unbaselined finding fails the gate
    fresh = F.Finding("CAT002", "src/repro_torch/core/b.py", 2, "o.r", "m")
    assert not F.apply_baseline([fresh], baseline).ok


def test_cli_static_gate_is_clean(capsys):
    """The default baseline is the port's own, committed empty."""
    assert F.baseline_path().endswith("analysis-baseline-torch.json")
    assert F.load_baseline() == {}
    assert analysis_main([]) == 0
    assert "repro_torch.analysis: clean" in capsys.readouterr().out


def test_cli_stale_suppression_hard_fails_without_allow_stale(
        tmp_path, capsys):
    """The real tree is clean, so any baselined fingerprint is stale:
    the gate must fail on it, name it, and pass with --allow-stale."""
    dead = F.Finding("CAT001", "src/repro_torch/core/a.py", 1, "gone.r",
                     "m")
    path = str(tmp_path / "baseline.json")
    F.write_baseline([dead], path, reason="fixed long ago")

    assert analysis_main(["--baseline", path]) == 1
    out = capsys.readouterr().out
    assert "stale suppression" in out and dead.fingerprint() in out
    assert "--allow-stale" in out        # the message names the hatch

    assert analysis_main(["--baseline", path, "--allow-stale"]) == 0
    assert "1 stale suppression(s)" in capsys.readouterr().out

    assert analysis_main(["--baseline", path, "--json"]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert payload["ok"] is False and payload["new"] == []
    assert payload["stale_suppressions"] == [dead.fingerprint()]


def test_cli_json_mode(capsys):
    assert analysis_main(["--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["ok"] is True and payload["new"] == []
    assert payload["findings"] == [] and payload["suppressed"] == []


def test_cli_lock_report_gate(tmp_path, capsys):
    clean = tmp_path / "clean.json"
    clean.write_text(json.dumps(
        {"locks": ["a", "b"], "edges": [
            {"from": "a", "to": "b", "count": 3, "site": "x.py:1"}],
         "cycles": [], "rank_inversions": []}))
    assert analysis_main(["--check-lock-report", str(clean)]) == 0
    assert "clean" in capsys.readouterr().out

    dirty = tmp_path / "dirty.json"
    dirty.write_text(json.dumps(
        {"locks": ["a", "b"], "edges": [],
         "cycles": [["a", "b", "a"]],
         "rank_inversions": [{"held": "b", "acquired": "a", "count": 1,
                              "site": "x.py:2"}]}))
    assert analysis_main(["--check-lock-report", str(dirty)]) == 1
    assert "VIOLATIONS" in capsys.readouterr().out

    assert analysis_main(["--check-lock-report",
                          str(tmp_path / "missing.json")]) == 2


# =====================================================================
# locktrace — the dynamic detector, unit level
# =====================================================================
def test_locktrace_detects_ab_ba_cycle():
    tr = locktrace.LockTrace()
    a = locktrace.TracedLock("t.A", trace=tr)
    b = locktrace.TracedLock("t.B", trace=tr)

    with a:
        with b:
            pass
    with b:
        with a:                   # the classic AB/BA inversion
            pass

    assert tr.cycles() == [["t.A", "t.B", "t.A"]]
    with pytest.raises(AssertionError, match="lock-order violations"):
        tr.assert_clean()


def test_locktrace_flags_rank_inversion_before_any_cycle():
    tr = locktrace.LockTrace()
    hi = locktrace.TracedLock("t.hi", rank=20, trace=tr)
    lo = locktrace.TracedLock("t.lo", rank=10, trace=tr)
    with hi:
        with lo:                  # lower rank acquired under higher
            pass
    p = tr.problems()
    assert p["cycles"] == []      # one-sided: no cycle yet
    assert [(i["held"], i["acquired"]) for i in p["rank_inversions"]] \
        == [("t.hi", "t.lo")]


def test_locktrace_records_wait_under_lock():
    tr = locktrace.LockTrace()
    outer = locktrace.TracedLock("t.outer", trace=tr)
    cv = locktrace.TracedCondition("t.cv", trace=tr)
    with outer:
        with cv:
            cv.wait(timeout=0.01)   # sleeps while still holding t.outer
    report = tr.report()
    assert [(w["held"], w["wait_on"])
            for w in report["waits_under_lock"]] == [("t.outer", "t.cv")]
    assert not report["cycles"] and not report["rank_inversions"]


def test_locktrace_ignores_rlock_reentry_and_clean_nesting():
    tr = locktrace.LockTrace()
    r = locktrace.TracedLock("t.R", inner=threading.RLock(), trace=tr)
    inner = locktrace.TracedLock("t.inner", trace=tr)
    with r:
        with r:                   # reentry: no self-edge
            with inner:
                pass
    assert ("t.R", "t.R") not in tr.edges
    assert ("t.R", "t.inner") in tr.edges
    tr.assert_clean()


def test_factories_are_plain_primitives_when_disabled(monkeypatch):
    monkeypatch.delenv(locktrace.ENV_FLAG, raising=False)
    assert not locktrace.enabled()
    lk = locktrace.make_lock("off.lock")
    assert type(lk) is type(threading.Lock())      # zero overhead
    assert isinstance(locktrace.make_condition("off.cv"),
                      threading.Condition)


def test_factories_are_traced_when_enabled(monkeypatch):
    monkeypatch.setenv(locktrace.ENV_FLAG, "1")
    lk = locktrace.make_lock("on.lock")
    cv = locktrace.make_condition("on.cv")
    assert isinstance(lk, locktrace.TracedLock)
    assert isinstance(cv, locktrace.TracedCondition)
    assert lk.rank is None        # unknown names are rank-exempt
    assert locktrace.make_rlock("engine.state").rank == \
        locktrace.LOCK_RANKS["engine.state"]


def test_documented_rank_table_names_every_core_lock():
    """Every dotted name ``core`` and ``kernels`` construct a lock under
    must carry a rank (else the inversion check silently skips it)."""
    import re
    used = set()
    for pkg in ("core", "kernels"):
        root = os.path.join(REPO, "src", "repro_torch", pkg)
        for dirpath, _dirs, files in os.walk(root):
            for fname in files:
                if not fname.endswith(".py"):
                    continue
                with open(os.path.join(dirpath, fname)) as f:
                    used.update(re.findall(
                        r"locktrace\.make_(?:r?lock|condition)\(\s*"
                        r"['\"]([\w.]+)['\"]", f.read()))
    assert used, "core stopped using the locktrace factories?"
    assert {"backend.capture", "backend.program", "kernels.build",
            "kernels.settle", "kernels.launches"} <= used
    assert used <= set(locktrace.LOCK_RANKS), \
        f"locks missing from LOCK_RANKS: {used - set(locktrace.LOCK_RANKS)}"


# =====================================================================
# the stress run: a fully traced engine + TCP server under real load
# =====================================================================
def test_stress_traced_engine_lock_graph_is_acyclic(monkeypatch):
    """Multi-thread multi-session chains over an engine whose every lock
    is instrumented, plus a socket client exercising the server and
    bridge locks — then the recorded acquisition graph must be acyclic
    and consistent with the documented rank order."""
    monkeypatch.setenv(locktrace.ENV_FLAG, "1")
    locktrace.TRACE.reset()

    # construct AFTER the flag is set: factories read it at build time
    from repro_torch.core import AlchemistContext, AlchemistEngine
    from repro_torch.core.libraries import elemental
    from repro_torch.core.server import AlchemistServer

    engine = AlchemistEngine(device="cpu", scheduler_workers=4)
    engine.load_library("elemental", elemental)
    srv = AlchemistServer(engine=engine).start()
    errors = []

    def chains(ac, seed):
        try:
            for c in range(2):
                f1 = ac.call_async("elemental", "random_matrix",
                                   rows=24, cols=6, seed=seed + c)
                f2 = ac.call_async("elemental", "gram", A=f1["A"])
                f3 = ac.call_async("elemental", "multiply", A=f1["A"],
                                   B=f2["G"])
                assert f3.result()["C"].shape == (24, 6)
        except Exception as e:                  # pragma: no cover
            errors.append(e)

    try:
        ctxs = [AlchemistContext(engine=engine, client_name=f"t{i}",
                                 device="cpu") for i in range(3)]
        ctxs.append(AlchemistContext(address=srv.address,
                                     client_name="socket"))
        threads = [threading.Thread(target=chains, args=(ac, 31 * i))
                   for i, ac in enumerate(ctxs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for ac in ctxs:
            ac.stop()
    finally:
        srv.stop()
        engine.shutdown()

    assert not errors
    # tracing saw the real locks on the engine, backend and transport paths
    assert {"engine.state", "scheduler.cv"} <= locktrace.TRACE.names
    assert {"backend.capture", "backend.programs"} <= locktrace.TRACE.names
    assert "wire.bridge" in locktrace.TRACE.names
    assert locktrace.TRACE.edges      # nesting actually happened
    # ... and the graph it recorded is deadlock-free and rank-ordered
    locktrace.TRACE.assert_clean()
    report = locktrace.TRACE.report()
    assert report["cycles"] == [] and report["rank_inversions"] == []

    locktrace.TRACE.reset()           # leave nothing for atexit to dump


# =====================================================================
# cross-package parity: same inputs, same (rule, symbol) sets
# =====================================================================
def _stm_violations_dir():
    return os.path.dirname(FIXTURE)


_PARITY = {
    "cat": lambda tmp: (
        ref_catalog.check_catalog_parity(
            libraries={"fakelib": _fake_module()},
            backends=[_RefFakeA(), _RefFakeB()]),
        check_catalog_parity(libraries={"fakelib": _fake_module()},
                             backends=[_FakeA(), _FakeB()])),
    "cat-cross-abi": lambda tmp: (
        ref_catalog.check_catalog_parity(
            libraries={"fakelib": _fake_module()},
            backends=[_FakeA(), _FakeB()]),
        check_catalog_parity(libraries={"fakelib": _fake_module()},
                             backends=[_RefFakeA(), _RefFakeB()])),
    "wire001": lambda tmp: (
        ref_wire.check_wire_exhaustiveness(frame_specs=_WIRE001_SPECS),
        check_wire_exhaustiveness(frame_specs=_WIRE001_SPECS)),
    "wire002": lambda tmp: (
        ref_wire.check_wire_exhaustiveness(frame_specs=_WIRE002_SPECS),
        check_wire_exhaustiveness(frame_specs=_WIRE002_SPECS)),
    "wire003": lambda tmp: (
        ref_wire.check_wire_exhaustiveness(frame_specs=_WIRE003_SPECS),
        check_wire_exhaustiveness(frame_specs=_WIRE003_SPECS)),
    "brg001": lambda tmp: (
        ref_wire.check_bridge_parity(bridge_cls=_NotABridge),
        check_bridge_parity(bridge_cls=_NotABridge)),
    "wire-real": lambda tmp: (
        ref_wire.check_wire_exhaustiveness()
        + ref_wire.check_bridge_parity(),
        check_wire_exhaustiveness() + check_bridge_parity()),
    "pkl001": lambda tmp: (ref_source.check_no_pickle(paths=[FIXTURE]),
                           check_no_pickle(paths=[FIXTURE])),
    "lck001": lambda tmp: (
        ref_source.check_lock_discipline(paths=[FIXTURE]),
        check_lock_discipline(paths=[FIXTURE])),
    "lck002-dup": lambda tmp: (
        ref_source.check_lock_ranks(
            ranks={"a.x": 10, "b.y": 10},
            doc_path=_rank_doc(tmp, [("a.x", 10), ("b.y", 10)])),
        check_lock_ranks(
            ranks={"a.x": 10, "b.y": 10},
            doc_path=_rank_doc(tmp, [("a.x", 10), ("b.y", 10)]))),
    "lck002-drift": lambda tmp: (
        ref_source.check_lock_ranks(
            ranks={"a.x": 10, "b.y": 20},
            doc_path=_rank_doc(tmp, [("a.x", 11), ("c.z", 30)])),
        check_lock_ranks(
            ranks={"a.x": 10, "b.y": 20},
            doc_path=_rank_doc(tmp, [("a.x", 11), ("c.z", 30)]))),
    "lck002-markers": lambda tmp: (
        ref_source.check_lock_ranks(ranks={"a.x": 10},
                                    doc_path=str(tmp / "absent.md")),
        check_lock_ranks(ranks={"a.x": 10},
                         doc_path=str(tmp / "absent.md"))),
    "stm": lambda tmp: (
        ref_stm.check_statemachines(machines=(_FX_MACHINE,),
                                    root=_stm_violations_dir()),
        check_statemachines(machines=(_FX_MACHINE,),
                            root=_stm_violations_dir())),
    "cfg001": lambda tmp: (
        ref_config.check_config_surface(**_drifted_config_surfaces(tmp)),
        check_config_surface(**_drifted_config_surfaces(tmp))),
}


@pytest.mark.parametrize("case", sorted(_PARITY))
def test_rule_parity_across_packages(case, tmp_path):
    ref, port = _PARITY[case](tmp_path)
    assert _keys(ref) == _keys(port)
    if case not in ("wire-real",):
        assert port, "the shared fixture violates nothing?"


# =====================================================================
# repairs the gate forced
# =====================================================================
class _StubProgram:
    """A program as the LRU sees it: the device bytes it holds and a
    release."""

    def __init__(self, nbytes):
        self.nbytes = nbytes
        self.released = False

    def release(self):
        self.released = True


def test_program_lru_bounds_count_and_bytes_oldest_first():
    """The LRU drops the oldest programs while more than ``max_programs``
    are live *or* they hold more than ``max_program_bytes``; the newest
    always stays, even alone past the byte bound."""
    from repro_torch.core.backends.torch_backend import TorchBackend
    be = TorchBackend(max_programs=3, max_program_bytes=100)
    p = {k: _StubProgram(n) for k, n in
         (("a", 40), ("b", 40), ("c", 10), ("d", 30), ("e", 50),
          ("f", 200))}
    assert [be._cache_put(k, p[k]) for k in "abc"] == [0, 0, 0]
    assert be.held_bytes() == 90
    assert be._cache_get("a") is p["a"]           # a is now the newest
    # the count bound drops b, the oldest; 80 bytes are within the bound
    assert be._cache_put("d", p["d"]) == 1
    assert p["b"].released and not p["a"].released
    # the count bound drops c; 120 bytes: the byte bound drops a
    assert be._cache_put("e", p["e"]) == 2
    assert p["c"].released and p["a"].released
    assert list(be._programs) == ["d", "e"] and be.held_bytes() == 80
    # a program past the byte bound on its own evicts all the others
    assert be._cache_put("f", p["f"]) == 2
    assert list(be._programs) == ["f"] and not p["f"].released
    assert be.program_cache_info() == {
        "programs": 1, "max_programs": 3, "held_bytes": 200,
        "max_program_bytes": 100, "evictions": 5}


def test_program_byte_bound_defaults_to_a_share_of_the_card(monkeypatch):
    """Unset, the byte bound is PROGRAM_MEMORY_SHARE of the device's
    memory on a card, and none on the CPU (programs there hold no device
    bytes, so CPU behaviour is unchanged)."""
    from repro_torch.core.backends import torch_backend as tb
    be = tb.TorchBackend()
    assert be.program_bytes_bound() is None
    assert be.program_cache_info()["max_program_bytes"] is None
    assert tb.PROGRAM_MEMORY_SHARE == 0.25
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(
                            total_memory=80 * 2 ** 30))
    be.device = torch.device("cuda", 0)
    assert be.program_bytes_bound() == 20 * 2 ** 30
    be.max_program_bytes = 12345
    assert be.program_bytes_bound() == 12345


def test_lck001_scope_covers_core_and_kernels(monkeypatch, tmp_path):
    """The port's LCK001 reads ``kernels/`` as well as ``core/``: a raw
    lock in either is a finding, and the real tree has none in either."""
    for pkg in ("core", "kernels"):
        d = tmp_path / "repro_torch" / pkg / "sub"
        d.mkdir(parents=True)
        (d / f"{pkg}_mod.py").write_text(
            "import threading\n_lock = threading.Lock()\n")
    monkeypatch.setattr(rules_source, "_repo_src", lambda: str(tmp_path))
    assert {f.symbol for f in check_lock_discipline()} == \
        {"core_mod.py:threading.Lock", "kernels_mod.py:threading.Lock"}
    monkeypatch.undo()
    paths = rules_source._py_files(rules_source._pkg_path("kernels"))
    assert {os.path.basename(p) for p in paths} >= {"build.py",
                                                    "device.py"}
    assert check_lock_discipline() == []


def test_every_ranked_lock_is_documented_in_rank_order():
    """Every name in the port's LOCK_RANKS stands in
    docs/torch_architecture.md, and the backend and kernel locks rank in
    the order the code takes them: capture, the program table, one
    program, then the kernels' leaves."""
    with open(DOC) as f:
        doc = f.read()
    for name in locktrace.LOCK_RANKS:
        assert f"`{name}`" in doc, name
    r = locktrace.LOCK_RANKS
    assert r["backend.capture"] < r["scheduler.cv"] \
        < r["backend.programs"] < r["backend.program"]
    assert min(r["kernels.build"], r["kernels.settle"],
               r["kernels.launches"]) > max(
        v for k, v in r.items() if not k.startswith("kernels."))


def test_rf_map_weights_are_the_host_draw():
    """rf_map's wrapper takes its weights from ``rf_weight_tensors``
    (the host draw, uploaded without blocking on a card): on the CPU the
    same values as ``rf_weights``."""
    from repro_torch.kernels.rf_map.ref import rf_weight_tensors, rf_weights
    w, b = rf_weight_tensors(7, 12, 1.5, 3, "cpu")
    wn, bn = rf_weights(7, 12, 1.5, 3)
    assert np.array_equal(w.numpy(), wn) and np.array_equal(b.numpy(), bn)


def test_traced_drive_lock_report_passes_the_gate(tmp_path):
    """The gate's dynamic half at a CPU size: the engine driven by two
    in-memory clients, a TCP client and a warmup thread under both
    tracers (set before the process imports anything, so the kernels'
    module-level locks are traced too), with evictions, spills and
    reloads; its lock report passes ``--check-lock-report``."""
    out = tmp_path / "locks.json"
    env = dict(os.environ, REPRO_LOCK_TRACE="1",
               REPRO_LOCK_TRACE_OUT=str(out), REPRO_STM_TRACE="1",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(REPO, "src")] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.tracedrive",
         "--device", "cpu", "--rounds", "4", "--warmup-grid", "32,64"],
        env=env, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr
    summary = json.loads(r.stdout.strip().splitlines()[-1])
    assert summary["violations"] == [] and summary["errors"] == []
    assert summary["evictions"] > 0
    assert summary["spills"] > 0 and summary["reloads"] > 0
    assert analysis_main(["--check-lock-report", str(out)]) == 0
    report = json.loads(out.read_text())
    assert {"engine.state", "scheduler.cv", "wire.bridge",
            "backend.capture", "backend.programs",
            "kernels.settle"} <= set(report["locks"])
    edges = {(e["from"], e["to"]) for e in report["edges"]}
    assert ("backend.capture", "backend.programs") in edges
    assert ("backend.capture", "kernels.settle") in edges


def test_traced_drive_refuses_to_run_untraced(monkeypatch, capsys):
    from repro_torch.analysis import statemachine, tracedrive
    monkeypatch.delenv(locktrace.ENV_FLAG, raising=False)
    monkeypatch.delenv(statemachine.ENV_FLAG, raising=False)
    assert tracedrive.main(["--device", "cpu"]) == 2
    assert locktrace.ENV_FLAG in capsys.readouterr().err
