"""The port's lifecycle state-machine spec + runtime monitor
(``repro_torch.analysis.statemachine``): every test of
``tests/test_statemachine.py``, pointed at the port, plus the port's own
reload site and its parity with the JAX package's machines.

Three halves:

* the declarative spec (``statemachine.MACHINES``) is internally
  consistent and the docs tables render from it verbatim;
* the runtime monitor (``StmTrace``) yields the right verdict for every
  violation class — illegal edge, remint, orphan, dead-scope activity,
  terminal-scope obligation — on crafted transition streams, and stays
  silent on legal ones;
* the env-gated plumbing (``tracer()``/``enabled()``) is zero-cost off.

The monitor's *integration* (instrumented engine/scheduler/server under
real load) is exercised by the ``stm_monitor`` fixture of
``tests/torch_bridge.py`` over the port's fault and QoS suites, and
driven through adversarial interleavings by ``test_torch_explore.py``.
"""
import os

import numpy as np
import pytest

from repro.analysis import statemachine as ref_statemachine
from repro_torch.analysis import statemachine
from repro_torch.analysis.statemachine import (
    Edge, Machine, MACHINES, MACHINES_BY_NAME, Obligation, ScopeCheck,
    StmTrace, render_tables, validate_machines)


# =====================================================================
# the spec itself
# =====================================================================
def test_real_machines_are_internally_consistent():
    assert validate_machines() == []


def test_every_machine_terminal_is_reachable():
    for m in MACHINES:
        dsts = {e.dst for e in m.edges}
        for t in m.terminal:
            assert t in dsts or t == m.initial, \
                f"{m.name}: terminal {t} unreachable via declared edges"


def test_validate_catches_crafted_inconsistencies():
    bad = Machine(
        name="bad", subject="x", modules=("m.py",),
        guarded=("_g",), states=("A", "B"),
        initial="ZZZ",                          # not a state
        terminal=("B", "GONE"),                 # GONE not a state
        lock=None, lockattr=None,
        mint_sites=("mk",),
        edges=(Edge("A", "NOPE", "step"),),     # NOPE not a state
        obligations=(Obligation("ghost", ("x",), "r"),),  # undeclared site
        caller_locked=("phantom",),             # undeclared site
        scope_checks=(ScopeCheck("unknown", ("A",), "r"),),
    )
    problems = validate_machines((bad,))
    text = "\n".join(problems)
    assert "initial 'ZZZ'" in text
    assert "terminal 'GONE'" in text
    assert "unknown state 'NOPE'" in text
    assert "obligation on undeclared site 'ghost'" in text
    assert "caller_locked names undeclared site 'phantom'" in text
    assert "unknown machine 'unknown'" in text


def test_session_scope_checks_cover_the_interacting_machines():
    """The cross-machine teardown contract is declared, not implied:
    a forgotten session must have drained tasks, aborted uploads, and
    released reservations."""
    sc = {c.machine: c for c in MACHINES_BY_NAME["session"].scope_checks}
    assert set(sc) == {"task", "upload", "reservation"}
    assert set(sc["task"].bad_states) == {"QUEUED", "RUNNING"}
    assert sc["upload"].bad_states == ("OPEN",)
    assert sc["reservation"].bad_states == ("ACTIVE",)
    for c in sc.values():                   # bulk shutdown is exempt
        assert "shutdown" in c.exempt_sites


def test_docs_tables_match_the_spec():
    """docs/torch_architecture.md embeds render_tables() between markers;
    the two must be byte-identical or the docs have drifted from the
    code."""
    doc = os.path.join(os.path.dirname(__file__), "..", "docs",
                       "torch_architecture.md")
    with open(doc) as f:
        text = f.read()
    begin, end = "<!-- STM_TABLES_BEGIN -->\n", "<!-- STM_TABLES_END -->"
    assert begin in text and end in text, "STM table markers missing"
    embedded = text.split(begin, 1)[1].split(end, 1)[0]
    assert embedded == render_tables(), (
        "docs/torch_architecture.md state-machine tables differ from "
        "statemachine.render_tables() — re-render the block between the "
        "STM_TABLES markers")


# =====================================================================
# the runtime monitor, verdict by verdict
# =====================================================================
D = "dom"           # a fake engine domain


def test_legal_task_lifecycle_is_clean():
    tr = StmTrace()
    tr.mint("task", (D, 1), site="submit", scope=(D, 7))
    tr.note("task", (D, 1), "RUNNING", site="_worker")
    tr.note("task", (D, 1), "DONE", site="_finish")
    tr.note("task", (D, 1), "RELEASED", site="release")
    tr.assert_clean()
    assert tr.state_of("task", (D, 1)) == "RELEASED"
    assert tr.report()["transitions"] == 4
    assert tr.report()["live"] == {}        # terminal rows are not live


def test_illegal_edge_is_recorded_not_raised():
    tr = StmTrace()
    tr.mint("task", (D, 1), site="submit")
    tr.note("task", (D, 1), "RELEASED", site="release")  # QUEUED->RELEASED
    [v] = tr.violations()
    assert v["kind"] == "illegal-edge" and v["machine"] == "task"
    assert "QUEUED -> RELEASED" in v["detail"]
    with pytest.raises(AssertionError, match="illegal-edge"):
        tr.assert_clean()


def test_remint_of_a_live_subject():
    tr = StmTrace()
    tr.mint("task", (D, 1), site="submit")
    tr.mint("task", (D, 1), site="submit")          # still QUEUED
    assert [v["kind"] for v in tr.violations()] == ["remint"]


def test_remint_after_terminal_is_legal():
    """Key reuse after RELEASED is a fresh subject, not a violation
    (task ids are monotonic in practice, but the monitor must not
    depend on that)."""
    tr = StmTrace()
    tr.mint("task", (D, 1), site="submit")
    tr.note("task", (D, 1), "FAILED", site="_finish")
    tr.note("task", (D, 1), "RELEASED", site="release")
    tr.mint("task", (D, 1), site="submit")
    tr.assert_clean()


def test_orphan_transition():
    tr = StmTrace()
    tr.note("task", (D, 99), "RUNNING", site="_worker")
    [v] = tr.violations()
    assert v["kind"] == "orphan" and "never minted" in v["detail"]


def test_terminal_scope_obligation_fires_on_undrained_session():
    """Session reaches FORGOTTEN while a task scoped to it is still
    RUNNING — exactly the teardown contract disconnect must uphold."""
    tr = StmTrace()
    tr.mint("session", (D, 5), site="connect")
    tr.mint("task", (D, 1), site="submit", scope=(D, 5))
    tr.note("task", (D, 1), "RUNNING", site="_worker")
    tr.note("session", (D, 5), "DRAINING", site="disconnect")
    tr.note("session", (D, 5), "FORGOTTEN", site="disconnect")
    kinds = [v["kind"] for v in tr.violations()]
    assert kinds == ["obligation"]
    assert "still RUNNING" in tr.violations()[0]["detail"]


def test_terminal_scope_obligation_exempt_for_bulk_shutdown():
    tr = StmTrace()
    tr.mint("session", (D, 5), site="connect")
    tr.mint("task", (D, 1), site="submit", scope=(D, 5))
    tr.note("task", (D, 1), "RUNNING", site="_worker")
    tr.note("session", (D, 5), "FORGOTTEN", site="shutdown")
    assert tr.violations() == []            # shutdown is exempt


def test_dead_scope_mint_and_activity():
    """Nothing may be minted into, or move non-terminally inside, a
    forgotten session — the invariant the submit-vs-disconnect fix
    protects."""
    tr = StmTrace()
    tr.mint("session", (D, 5), site="connect")
    tr.mint("task", (D, 1), site="submit", scope=(D, 5))
    tr.note("task", (D, 1), "FAILED", site="_finish")   # QUEUED->FAILED ok
    tr.note("session", (D, 5), "FORGOTTEN", site="shutdown")
    tr.mint("task", (D, 2), site="submit", scope=(D, 5))
    tr.note("task", (D, 2), "RUNNING", site="_worker")
    tr.note("task", (D, 2), "DONE", site="_finish")
    tr.note("task", (D, 2), "RELEASED", site="release")  # terminal: allowed
    kinds = [v["kind"] for v in tr.violations()]
    assert kinds == ["dead-scope", "dead-scope", "dead-scope"]


def test_reset_clears_everything():
    tr = StmTrace()
    tr.mint("task", (D, 1), site="submit")
    tr.note("task", (D, 1), "RELEASED", site="release")  # violation
    assert tr.violations()
    tr.reset()
    assert tr.violations() == [] and tr.report()["transitions"] == 0
    assert tr.state_of("task", (D, 1)) is None


def test_report_counts_live_subjects_per_machine():
    tr = StmTrace()
    tr.mint("session", (D, 1), site="connect")
    tr.mint("task", (D, 1), site="submit")
    tr.mint("task", (D, 2), site="submit")
    rep = tr.report()
    assert rep["live"] == {"session": 1, "task": 2}
    assert rep["violations"] == []


# =====================================================================
# the env gate
# =====================================================================
def test_tracer_is_null_when_disabled(monkeypatch):
    monkeypatch.delenv(statemachine.ENV_FLAG, raising=False)
    assert not statemachine.enabled()
    t = statemachine.tracer()
    assert t.enabled is False
    t.mint("task", (D, 1), site="submit")   # all no-ops
    t.note("task", (D, 1), "RUNNING", site="_worker")
    assert statemachine.TRACE.state_of("task", (D, 1)) is None


def test_tracer_is_live_monitor_when_enabled(monkeypatch):
    monkeypatch.setenv(statemachine.ENV_FLAG, "1")
    assert statemachine.tracer() is statemachine.TRACE
    assert statemachine.TRACE.enabled is True
    monkeypatch.setenv(statemachine.ENV_FLAG, "0")
    assert not statemachine.enabled()       # "0" counts as off


def test_engine_binds_monitor_at_construction(monkeypatch):
    """An engine built with the flag set actually records transitions:
    connect/disconnect walks the session machine end to end."""
    monkeypatch.setenv(statemachine.ENV_FLAG, "1")
    statemachine.TRACE.reset()
    from repro_torch.core.engine import AlchemistEngine
    eng = AlchemistEngine(device="cpu", scheduler_workers=1,
                          cache_entries=0)
    try:
        sess = eng.connect("probe")
        dom = eng._stm_dom
        assert statemachine.TRACE.state_of(
            "session", (dom, sess.id)) == "ACTIVE"
        eng.disconnect(sess.id)
        assert statemachine.TRACE.state_of(
            "session", (dom, sess.id)) == "FORGOTTEN"
        eng.disconnect(sess.id)             # idempotent: no re-notes
    finally:
        eng.shutdown()
    statemachine.TRACE.assert_clean()
    statemachine.TRACE.reset()


# =====================================================================
# the port's reload site, and parity with the JAX package's machines
# =====================================================================
def test_store_reload_is_declared_where_the_port_reloads():
    """The port reloads a spilled store in ``_resolve`` (its ``get``,
    ``SessionView.get``, argument materialization and the server's fetch
    all go through it); the JAX engine reloads in ``get``. Each spec
    declares its own engine's site, and nothing else differs."""
    port = {(e.src, e.dst, e.site) for e in MACHINES_BY_NAME["store"].edges}
    ref = {(e.src, e.dst, e.site)
           for e in ref_statemachine.MACHINES_BY_NAME["store"].edges}
    assert ("SPILLED", "LIVE", "_resolve") in port
    assert ("SPILLED", "LIVE", "get") in ref
    assert port - ref == {("SPILLED", "LIVE", "_resolve")}
    assert ref - port == {("SPILLED", "LIVE", "get")}
    assert render_tables().replace("| SPILLED | LIVE | `_resolve` |",
                                   "| SPILLED | LIVE | `get` |") == \
        ref_statemachine.render_tables()


def test_spill_and_reload_under_the_armed_monitor(monkeypatch):
    """A store budget too small for three stores spills the oldest; a
    read reloads it through ``_resolve``, and the monitor sees the
    declared LIVE -> SPILLED -> LIVE edges and no violation."""
    monkeypatch.setenv(statemachine.ENV_FLAG, "1")
    statemachine.TRACE.reset()
    from repro_torch.core.engine import AlchemistEngine
    arr = np.arange(64 * 64, dtype=np.float32).reshape(64, 64)
    eng = AlchemistEngine(device="cpu", scheduler_workers=1,
                          cache_entries=0,
                          memory_budget_bytes=2 * arr.nbytes)
    try:
        sess = eng.connect("spiller")
        first = eng.put(arr, session=sess.id)
        for k in (1, 2):
            eng.put(arr + k, session=sess.id)
        assert eng.is_spilled(first)
        store = eng._entries[first.id].store
        key = (eng._stm_dom, store)
        assert statemachine.TRACE.state_of("store", key) == "SPILLED"
        got = eng.get(first, session=sess.id)
        assert not eng.is_spilled(first)
        assert np.array_equal(got.numpy(), arr)
        assert statemachine.TRACE.state_of("store", key) == "LIVE"
        eng.disconnect(sess.id)
    finally:
        eng.shutdown()
    statemachine.TRACE.assert_clean()
    statemachine.TRACE.reset()
