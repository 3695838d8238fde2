"""repro_torch.analysis — machine-checked invariants for the port's
offload stack, the counterpart of the JAX package's ``repro.analysis``.

Two halves:

* a **static lint pass** (``python -m repro_torch.analysis``) of
  repo-specific AST/introspection rules: catalog parity between the
  spec-only library catalog and the port's backends (``rules_catalog``),
  wire-frame exhaustiveness and bridge surface parity (``rules_wire``),
  capture and launch purity, no-pickle-on-wire, raw-lock discipline over
  ``core`` and ``kernels`` and the rank table (``rules_source``), the
  lifecycle machines (``rules_stm``) and the configure surface
  (``rules_config``). Each rule emits stable finding IDs with file:line
  anchors, gated against a committed baseline
  (``analysis-baseline-torch.json``, ``findings``) so the suite ratchets.

* the **runtime halves**: the lock-order race detector (``locktrace``)
  and the lifecycle state-machine monitor (``statemachine``), which the
  engine, scheduler, server, backend and kernels construct their locks
  and monitors through — no-ops unless ``REPRO_LOCK_TRACE`` /
  ``REPRO_STM_TRACE`` is set — and the interleaving explorer
  (``explore``) that drives the monitor through seeded schedules.

This module must stay import-light: ``repro_torch.core`` and
``repro_torch.kernels`` import ``repro_torch.analysis.locktrace`` for
their lock factories, while the rule modules import ``repro_torch.core``
— keeping the rules out of this namespace at import time is what makes
that non-circular.
"""

__all__ = ["locktrace", "statemachine", "findings", "run_all_rules"]


def run_all_rules(**overrides):
    """Run every static rule against the real tree (lazy import — see
    module docstring). Returns a list of :class:`findings.Finding`."""
    from repro_torch.analysis import (rules_catalog, rules_config,
                                      rules_source, rules_stm, rules_wire)
    out = []
    out.extend(rules_catalog.check_catalog_parity(**{
        k: v for k, v in overrides.items()
        if k in ("libraries", "backends")}))
    out.extend(rules_wire.check_wire_exhaustiveness())
    out.extend(rules_wire.check_bridge_parity())
    out.extend(rules_source.check_trace_purity())
    out.extend(rules_source.check_no_pickle())
    out.extend(rules_source.check_lock_discipline())
    out.extend(rules_source.check_lock_ranks())
    out.extend(rules_stm.check_statemachines())
    out.extend(rules_config.check_config_surface())
    return out
